"""Each cell through the harness at a size the CPU runs in seconds, the
reference against itself, and a cell, traffic and metric found by name
from files added to a copy."""
import json

import pytest
import torch

from portbench import spec
from portbench.run import run_cell
from portbench.tests.tiny import run_tiny, tiny_checkout
from portbench.trace import Trace

CELLS = ("distill-fusion", "train-f32", "distill-bootstrap",
         "distill-fusion-bf16")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(tiny, cell):
    r = run_tiny(tiny, cell, 2 ** 31 + 7)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = {m for m in r["metrics"]}
    assert "setup_s" in names and "peak_gib" in names
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]


def _follow(tiny, cell, seed):
    from portbench.control import control_readings

    # the control on the CPU: TF32 has no effect there, so it is the f32
    # reference against itself
    return control_readings(cell, seed, "cpu", tiny, tiny / "portbench")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_against_itself(tiny, cell):
    limits = spec.find_cell(cell, tiny, tiny / "portbench").traffic["limits"]
    for seed in (3, 2 ** 32 + 5):
        assert _follow(tiny, cell, seed) == {"all": dict.fromkeys(limits,
                                                                  0.0)}


def test_window_is_a_count_of_units():
    """The window's iterations or steps follow from ``--seconds`` and the
    traffic alone, in whole blocks; a traced run holds its profiler's
    attempts."""
    from portbench.trace import ATTEMPTS

    t = {"window_units_per_s": 5.6, "trace_skip": 4, "trace_warm": 4,
         "trace_units": 8}
    assert spec.window_units(t, 30, False, 4) == 168
    assert spec.window_units(t, 0.1, False, 4) == 4
    assert spec.window_units(t, 1, True, 4) == ATTEMPTS * 16
    f = {"window_units_per_s": 1.22, "trace_skip": 1, "trace_warm": 1,
         "trace_units": 3}
    assert spec.window_units(f, 30, False) == 37
    assert spec.window_units(f, 30, True) == 37


def test_train_plan_is_prefix_stable():
    """A shorter plan is the start of a longer one, so the control and
    the run follow the same steps; every block holds each size once."""
    from portbench.drivers.train import plan_steps

    traffic = {"context_sizes": [2, 3, 4, 5], "scenes": 8}
    long = plan_steps(traffic, 2 ** 31 + 3, 8 + 40, 10)
    assert plan_steps(traffic, 2 ** 31 + 3, 8, 10) == long[:8]
    sizes = [len(c) for _, _, c in long]
    assert sizes[:8] == [2, 2, 3, 3, 4, 4, 5, 5]
    for b in range(8, 48, 4):
        assert sorted(sizes[b:b + 4]) == [2, 3, 4, 5]


def test_seed_makes_the_inputs(tiny):
    from portbench import scenes

    a = scenes.blob_scene(spec.sub_seed(9, 0), 2, 16, "cpu")
    b = scenes.blob_scene(spec.sub_seed(9, 0), 2, 16, "cpu")
    c = scenes.blob_scene(spec.sub_seed(10, 0), 2, 16, "cpu")
    assert (a.images == b.images).all() and not (a.images == c.images).all()
    assert spec.sub_seed(2 ** 31 + 1) != spec.sub_seed(1)


def test_added_files_are_found_by_name(tiny, tmp_path):
    """A cell on a new traffic mix and a new per-layer metric, added as
    files and entries only."""
    import shutil

    root = tmp_path
    shutil.copytree(tiny / "portbench", root / "portbench")
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (root / "portbench/traffic/distill-bootstrap.json").read_text())
    traffic["setup_iterations"] = traffic["follow_iterations"] = 2
    (root / "portbench/traffic/dummy.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/dummy_share.py").write_text(
        "def read(ctx):\n"
        "    tr = ctx['trace']\n"
        "    return None if tr is None else 100.0 * tr.busy_s / tr.window_s\n")
    bench["workloads"].append({"name": "distill-dummy", "config": "sf-distill",
                               "traffic": "dummy", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "dummy_share", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "distill_it_per_s", "workloads": ["distill-dummy"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "distill-fusion" in m["workloads"]:
            m["workloads"].append("distill-dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("distill-dummy", root, root / "portbench")
    assert cell.traffic["setup_iterations"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy_share"]
    read = spec.metric_reader("dummy_share", root / "portbench")
    tr = Trace(2.0, 1.5, {}, {}, [], [])
    assert read({"trace": tr}) == 75.0 and read({"trace": None}) is None
    r = run_cell("distill-dummy", 11, 0.2, False, device="cpu", root=root,
                 bench_dir=root / "portbench")
    assert r["correct"] and r["attempted"] > 0


def test_readers_leave_out_what_they_cannot_read():
    from portbench.readers import idle_pct, mfu_pct, roofline_pct

    empty = {"trace": None, "config": {"precision": "float32"}}
    assert idle_pct(empty) is None and mfu_pct(empty) is None
    tr = Trace(1.0, 0.9, {"grid_encode_fwd_kernel<2>": 0.01}, {}, [],
               [{"ops": 6.7e12, "k1_s": 0.005}])
    ctx = {"trace": tr, "config": {"precision": "float32", "tf32": False}}
    assert idle_pct(ctx) == pytest.approx(10.0)
    assert mfu_pct(ctx) == pytest.approx(10.0)
    assert roofline_pct(ctx, "k1_s", "grid_encode_fwd") == pytest.approx(50)
    # no K1 kernel in the window: nothing read, not a share of 0
    assert roofline_pct(ctx, "k1_s", "no_such_kernel") is None
