"""On the card only (marked ``cuda``; they skip without one): the
control, the reference in TF32 in the program's place, fails the check
at a small size, and a traced run reads its per-layer metrics."""
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from portbench.tests.tiny import tiny_checkout

    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["distill-fusion", "train-f32"])
def test_control_is_not_correct(card, tiny, cell):
    from portbench import spec
    from portbench.control import control_readings

    limits = spec.find_cell(cell, tiny, tiny / "portbench").traffic["limits"]
    readings = control_readings(cell, 5, "cuda", tiny,
                                tiny / "portbench")["all"]
    assert any(readings[k] > limits[k] for k in limits), readings


@pytest.mark.cuda
def test_traced_run_reads_its_metrics(card, tiny):
    from portbench.run import run_cell

    r = run_cell("distill-bootstrap", 3, 1.0, True, root=tiny,
                 bench_dir=tiny / "portbench")
    assert r["correct"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["metrics"]) >= {"idle_pct.distill", "mfu.distill"}
