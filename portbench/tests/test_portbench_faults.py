"""The check sees a broken timed path: each fault the cells can have,
planted in the program under a run at a size the CPU runs in seconds,
makes ``correct`` false (the harness's look for a chip skipped)."""
import pytest
import torch

from portbench import faults
from portbench.run import run_cell
from portbench.tests.tiny import tiny_checkout

CELLS = ("distill-fusion", "train-f32", "distill-bootstrap",
         "distill-fusion-bf16")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault):
    r = run_cell(cell, 23, 0.2, False, device="cpu", root=tiny,
                 bench_dir=tiny / "portbench",
                 around_program=faults.planted(fault))
    assert not r["correct"], r["checks"]


def test_fault_is_taken_out_again():
    from sparsefusion_tpu_torch.distill.loop import SceneSteps

    before = (torch.optim.Adam.step, SceneSteps._mean)
    for name in faults.FAULTS:
        with faults.planted(name):
            pass
    assert (torch.optim.Adam.step, SceneSteps._mean) == before
