"""The span recorder (``utils/spans.py``), the loops' spans, and the
benchmark's span metrics (``portbench/metrics``) on a synthetic record.

On the CPU: nesting and self time, counters, the bounded ring, nothing
recorded while off, the host clock against ``torch.profiler``'s, the
spans of a fused fusion iteration and of a train step, each reader.  On
a CUDA device (``cuda`` marker): every replay of a captured graph leaves
its own stamps, and over one profiled window the spans' device ms agree
with the profiler's kernel time between the same stamps.
"""
import collections
import importlib.util
import pathlib
import time
import types

import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
from sparsefusion_tpu_torch.diffusion.plms import host_schedule
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.distill.fused import FusedIterations
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig
from sparsefusion_tpu_torch.train import trainer
from sparsefusion_tpu_torch.train.fused import FusedTrainStep
from sparsefusion_tpu_torch.utils import spans
from sparsefusion_tpu_torch.utils.graphs import GraphRunner

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def recording():
    spans.enable()
    yield spans
    spans.disable()


def _since(mark):
    return spans.snapshot(mark)


def _children(snap, parent):
    return [s for s in snap if s["parent"] == parent["id"]]


# ---- the recorder --------------------------------------------------------

def test_nesting_and_self_time(recording):
    mark = spans.mark()
    with spans.unit("distill/iteration", 7):
        with spans.span("outer"):
            time.sleep(0.004)
            with spans.span("inner"):
                time.sleep(0.006)
    snap = _since(mark)
    unit, outer, inner = (next(s for s in snap if s["name"] == n)
                          for n in ("distill/iteration", "outer", "inner"))
    assert unit["kind"] == "unit" and unit["parent"] is None
    assert outer["parent"] == unit["id"] and inner["parent"] == outer["id"]
    assert {s["unit"] for s in snap} == {7}
    assert unit["t0"] <= outer["t0"] <= inner["t0"] <= inner["t1"] \
        <= outer["t1"] <= unit["t1"]
    self_ns = (outer["t1"] - outer["t0"]) - (inner["t1"] - inner["t0"])
    # sleeps overshoot on a loaded host, so only their floors hold
    assert self_ns >= 3e6 and inner["t1"] - inner["t0"] >= 6e6
    # on the CPU no span has device times
    assert all(s["d0"] is None and s["d1"] is None for s in snap)


def test_counters_go_to_the_open_span(recording):
    mark = spans.mark()
    spans.count("k1_points", 5)                 # nothing open: dropped
    with spans.unit("train/step", 0):
        with spans.span("render", k1_points=1):
            spans.count("k1_points", 10)
            with spans.span("render_bwd"):
                spans.count("k1_points", 100)
                spans.count("unet_batch", 7)
            spans.count("k1_points", 1000)
    snap = {s["name"]: s for s in _since(mark)}
    assert snap["render"]["counts"] == {"k1_points": 1011}
    assert snap["render_bwd"]["counts"] == {"k1_points": 100,
                                            "unet_batch": 7}
    assert snap["train/step"]["counts"] == {}


def test_the_ring_is_bounded(recording, monkeypatch):
    monkeypatch.setattr(spans.recorder(), "spans",
                        collections.deque(maxlen=16))
    mark = spans.mark()
    for i in range(50):
        with spans.unit("train/step", i):
            with spans.span("adam"):
                pass
    snap = _since(mark)
    assert len(snap) == 16
    assert all(s["unit"] >= 42 for s in snap)


def test_nothing_is_recorded_while_off():
    mark = spans.mark()
    assert not spans.recorder().enabled
    with spans.unit("distill/iteration", 0):
        assert spans.span("render") is spans.span("unet")   # the no-op
        with spans.span("render"):
            spans.count("k1_points", 3)
        with spans.setup_span("capture/x"):
            pass
    snap = _since(mark)
    # only the set-up span, which is always recorded
    assert [s["name"] for s in snap] == ["capture/x"]
    assert snap[0]["kind"] == "setup" and snap[0]["counts"] == {}


def test_loss_reads_read_the_stamps_only_when_needed(recording,
                                                    monkeypatch):
    """A loss read (``sync_point``) reads the device's stamps only to
    report a line, or when the oldest unread stamp lies half the ring
    back: a traced window's loss reads cost what they cost without the
    recorder."""
    r = spans.recorder()
    drains = []
    monkeypatch.setattr(r, "drain", lambda calibrations=0: drains.append(
        calibrations))
    monkeypatch.setattr(r, "pending", [])
    monkeypatch.setattr(r, "cursor", 10 * spans.SLOTS)
    sp = spans.Span(0, "render", "span", None, 0, True)
    sp.s0, sp.s1 = r.cursor - 100, r.cursor - 99
    r.pend(sp)
    spans.sync_point()
    assert drains == []
    r.cursor += spans.SLOTS // 2
    spans.sync_point()
    assert drains == [0]
    r.cursor -= spans.SLOTS // 2
    monkeypatch.setattr(r, "reporter", lambda line: None)
    spans.sync_point()
    assert drains == [0, 0]


def test_the_operators_lines(recording):
    """``enable(report)``: at each loss read a line of the set-up spans
    finished since the last, and one of the units': the host's own ms
    apart from its graph launches and loss reads, the UNet's
    evaluations and their batch."""
    lines = []
    spans.enable(report=lines.append)
    with spans.setup_span("phase_a"):
        pass
    for key in ("a", "b"):
        with spans.setup_span("capture/" + key):
            pass
    for i in range(2):
        with spans.unit("distill/iteration", i):
            with spans.span("graph/x"):
                with spans.span("unet", unet_batch=4):
                    time.sleep(0.002)
            if i == 1:
                with spans.span("loss_read"):
                    spans.sync_point()
    assert len(lines) == 2
    assert lines[0].startswith("spans set-up: phase_a ")
    assert "capture 2 x " in lines[0]
    assert lines[1].startswith("spans: 1 x distill/iteration; host ")
    assert "in graph launches" in lines[1]
    assert "unet 1.00/unit at batch 4" in lines[1]
    with spans.unit("distill/iteration", 2):
        with spans.span("loss_read"):
            spans.sync_point()
    # the unit of the first line's read, finished after it
    assert lines[2].startswith("spans: 1 x distill/iteration")


def test_device_clock_follows_the_calibrations(monkeypatch):
    """A stamp converts to the host clock by the offset interpolated
    between the calibrations on either side of it, the nearest one's
    outside them; the error is the widest calibration's."""
    r = spans.recorder()
    monkeypatch.setattr(r, "points", collections.deque(
        [(1_000, 100, 20), (11_000, 200, 30)]))
    host = r.host_clock()
    assert [host(g) for g in (0, 1_000, 6_000, 11_000, 20_000)] == \
        [-100, 900, 5_850, 10_800, 19_800]
    assert spans.clock()["error_ns"] == 30
    monkeypatch.setattr(r, "points", collections.deque())
    assert r.host_clock() is None and spans.clock()["error_ns"] is None


def test_host_clock_is_the_profilers():
    """Spans outside a unit record under a profiler and are its
    ``record_function`` ranges; their host times on the profiler's clock
    agree within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    mark = spans.mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("clock"):           # the first range's set-up
            pass
        for i in range(5):
            with spans.span(f"clock/{i}"):
                time.sleep(0.002)
    ours = {s["name"]: s for s in _since(mark)}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock/")]
    assert len(events) == 5
    for e in events:
        s = ours[e.name()]
        assert s["profiled"]
        assert abs(e.start_ns() - s["t0"]) < 50_000
        assert abs(e.start_ns() + e.duration_ns() - s["t1"]) < 50_000


# ---- the loops' spans on the CPU ----------------------------------------

NGP_KW = dict(num_levels=4, log2_hashmap_size=10)
HW, IMAGE_SIZE = 16, 32


def _programs():
    models = build_models(torch.Generator().manual_seed(0), "cpu",
                          **narrow_model_configs())
    cfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), num_steps=8,
                              upsample_steps=8, max_ray_batch=128,
                              plms_steps=4)
    scene = make_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=0)
    field = NGPField(cfg.ngp)
    steps = tloop.make_scene_step_fns(
        field, cfg, tloop.make_ngp_optimizer(cfg, field), HW, IMAGE_SIZE,
        models=models)
    vox = tcam.get_relative_cameras(
        tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                            scene.image_size), [0], center_at_origin=False)
    rng = np.random.RandomState(3)
    cache = {"cameras_vox": tcam.get_camera_slice(vox, [1]),
             "features": torch.tensor(rng.randn(1, 256, 4, 4)
                                      .astype(np.float32)),
             "eft_images": torch.tensor(rng.rand(1, IMAGE_SIZE, IMAGE_SIZE, 3)
                                        .astype(np.float32))}
    prog = FusedIterations(steps, torch.Generator().manual_seed(5), vox,
                           torch.tensor(scene.images),
                           torch.tensor(scene.masks), cache)
    vc = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                              max_ray_batch=128)
    return prog, vc


@pytest.mark.parametrize("max_thres", [0.6, 0.3])
def test_a_fusion_iteration_holds_its_layers(recording, max_thres):
    """A fused fusion iteration on the CPU: 1 + n_steps ``unet`` spans
    (at batch 1), one ``vae_encode``, one ``vae_decode``, the input
    step's and the fusion step's ``render``, ``render_bwd`` and
    ``ngp_adam``, each under its program's ``graph/<key>``."""
    prog, vc = _programs()
    _, n_steps, _ = host_schedule(max_thres, 4)
    mark = spans.mark()
    with spans.unit("distill/iteration", 3):
        prog.iteration(3, vc, 1, 0, max_thres, fusion=True)
    snap = _since(mark)
    names = collections.Counter(s["name"] for s in snap)
    assert names["unet"] == 1 + n_steps
    assert names["vae_encode"] == names["vae_decode"] == 1
    assert names["render"] == names["render_bwd"] == 2
    assert names["ngp_adam"] == 2 and names["distill/draws"] == 1
    byid = {s["id"]: s for s in snap}
    parents = collections.Counter(byid[s["parent"]]["name"] for s in snap
                                  if s["name"] == "unet")
    assert parents == {"graph/step0": 2,
                       **({"graph/tail/1": 1} if n_steps > 1 else {}),
                       **({"graph/tail/2": 1} if n_steps > 2 else {}),
                       **({"graph/tail/3": n_steps - 3}
                          if n_steps > 3 else {})}
    assert all(s["counts"] == {"unet_batch": 1} for s in snap
               if s["name"] == "unet")
    assert {s["unit"] for s in snap} == {3}


def _train_step():
    from tests.test_torch_train_step import DBS, LATENT, _port_models, \
        _scenes

    models = _port_models()
    cfg = trainer.TrainConfig(latent_size=LATENT, context_size=3,
                              diffusion_batch_size=DBS)
    unet_opt, eft_opt = trainer.make_optimizers(cfg, models)
    step = trainer.make_train_step(models, cfg, unet_opt, eft_opt)
    return step, _scenes(1)[1]


@pytest.mark.parametrize("ctx", [[1, 2], [1, 2, 3]])
def test_a_train_step_holds_its_layers(recording, ctx):
    """A fused train step on the CPU: the unit ``train/step`` holds
    ``train/pack`` and ``graph/step/<size>``, under which ``eft``,
    ``vae_encode``, ``unet_loss``, the backward split into
    ``unet_loss_bwd`` and ``eft_bwd``, ``guard`` and ``adam``."""
    step, scenes = _train_step()
    fused = FusedTrainStep(step, torch.Generator().manual_seed(7))
    mark = spans.mark()
    fused(trainer.prepare_scene_batch([scenes[0]], [0], [ctx]))
    snap = _since(mark)
    unit = next(s for s in snap if s["kind"] == "unit")
    assert unit["name"] == "train/step" and unit["unit"] == 0
    graph = next(s for s in snap if s["name"].startswith("graph/"))
    assert graph["name"] == f"graph/step/{len(ctx)}"
    assert [s["name"] for s in _children(snap, unit)] == \
        ["train/pack", graph["name"]]
    inside = [s["name"] for s in sorted(_children(snap, graph),
                                        key=lambda s: s["t0"])]
    assert inside == ["eft", "vae_encode", "unet_loss", "unet_loss_bwd",
                      "eft_bwd", "guard", "adam"]
    bwd = {s["name"]: s for s in snap}
    assert bwd["unet_loss_bwd"]["t1"] <= bwd["eft_bwd"]["t0"]
    # the batch, built before the call, is the step's too
    assert bwd["train/batch"]["unit"] == 0
    assert bwd["train/batch"]["parent"] is None


# ---- the benchmark's readers on a synthetic record -----------------------

def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _record(kind, units, layers, start=100, before=0):
    """A synthetic snapshot: ``units`` units of ``kind`` (the first one
    outside the profiler), each 10 ms of host time with a 1 ms graph
    launch, a 2 ms loss read and the ``layers`` {name: (device ms,
    counts)} under the graph's span, and a span of ``before`` host ms
    before it that the recorder gave it; set-up spans first."""
    snap = [dict(id=0, name="phase_a", kind="setup", parent=None,
                 unit=None, t0=0, t1=7_500_000_000, d0=None, d1=None,
                 counts={}, profiled=False),
            dict(id=1, name="capture/front/two_phase", kind="setup",
                 parent=None, unit=None, t0=8_000_000_000,
                 t1=8_250_000_000, d0=None, d1=None, counts={},
                 profiled=False),
            dict(id=2, name="capture/back/two_phase", kind="setup",
                 parent=None, unit=None, t0=8_300_000_000,
                 t1=8_550_000_000, d0=None, d1=None, counts={},
                 profiled=False)]
    sid = start
    for k in range(units + 1):
        t = 10_000_000_000 + k * 20_000_000
        if before:
            snap.append(dict(id=sid, name="train/batch", kind="span",
                             parent=None, unit=k, t0=t - int(before * 1e6),
                             t1=t, d0=None, d1=None, counts={},
                             profiled=k > 0))
            sid += 1
        u = dict(id=sid, name=kind, kind="unit", parent=None, unit=k,
                 t0=t, t1=t + 10_000_000, d0=t, d1=t + 15_000_000,
                 counts={}, profiled=k > 0)
        g = dict(id=sid + 1, name="graph/x", kind="span", parent=sid,
                 unit=k, t0=t + 1_000_000, t1=t + 2_000_000, d0=t,
                 d1=t + 14_000_000, counts={}, profiled=k > 0)
        lr = dict(id=sid + 2, name="loss_read", kind="span", parent=sid,
                  unit=k, t0=t + 7_000_000, t1=t + 9_000_000, d0=None,
                  d1=None, counts={}, profiled=k > 0)
        snap += [u, g, lr]
        sid += 3
        d = t
        for name, (ms, counts) in layers.items():
            snap.append(dict(id=sid, name=name, kind="span", parent=g["id"],
                             unit=k, t0=None, t1=None, d0=d,
                             d1=d + int(ms * 1e6), counts=dict(counts),
                             profiled=k > 0))
            d += int(ms * 1e6)
            sid += 1
    return snap


def _ctx(config, snap, unit_work):
    trace = types.SimpleNamespace(units=unit_work)
    return {"trace": trace, "config": config, "cell": "x", "spans": snap}


def _config(name):
    import json

    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


DISTILL = {"unet": (2.0, {"unet_batch": 1}), "vae_encode": (1.0, {}),
           "vae_decode": (3.0, {}), "render": (1.5, {"k1_points": 100}),
           "render_bwd": (2.5, {"k1_points": 50})}


def _distill_ctx(n_evals):
    from portbench import spans as bspans

    config = _config("sf-distill")
    c = bspans.distill_counts(config)
    ops = c["renders"] + c["vae"] + n_evals * c["unet"]
    snap = _record("distill/iteration", 3, DISTILL)
    return _ctx(config, snap, [{"ops": ops, "k1_s": 0.0}] * 3), c


@pytest.mark.parametrize("name,want", [
    ("unet_ms_per_eval.fusion", 2.0 / 4),
    ("vae_ms_per_it.fusion", 4.0),
    ("render_ms_per_it.distill", 4.0),
    ("host_ms_per_it.distill", 7.0),
    ("phase_a_s", 7.5),
    ("capture_s", 0.5),
])
def test_distill_readers(name, want):
    """Each distillation reader on three traced iterations of a
    synthetic record (one unet span an iteration against the benchmark's
    four evaluations)."""
    ctx, _ = _distill_ctx(4)
    assert _reader(name)(ctx) == pytest.approx(want, rel=1e-6)


def test_k1_recompute_reader():
    ctx, c = _distill_ctx(4)
    need = c["k1_points"] * 3
    assert _reader("k1_recompute_pct")(ctx) == pytest.approx(
        100.0 * 150 / (need + 150))


@pytest.mark.parametrize("name", ["eft_ms_per_step.train",
                                  "adam_roofline_pct.train",
                                  "host_ms_per_step.train", "capture_s"])
def test_train_readers(name):
    from portbench import adam
    from portbench.flops import PEAK_BYTES

    config = _config("sf-train")
    snap = _record("train/step", 4, {"eft": (5.0, {}), "eft_bwd": (7.0, {}),
                                     "adam": (20.0, {})}, before=3.0)
    ctx = _ctx(config, snap, [{"ops": 1.0}] * 4)
    want = {"eft_ms_per_step.train": 12.0,
            "adam_roofline_pct.train":
                100.0 * adam.step_bytes(config) / PEAK_BYTES / 0.020,
            "host_ms_per_step.train": 10.0, "capture_s": 0.5}[name]
    assert _reader(name)(ctx) == pytest.approx(want, rel=1e-6)
    assert adam.trained_params(config) > 4e8


@pytest.mark.parametrize("name", [
    "unet_ms_per_eval.fusion", "vae_ms_per_it.fusion",
    "render_ms_per_it.distill", "k1_recompute_pct",
    "host_ms_per_it.distill", "eft_ms_per_step.train",
    "adam_roofline_pct.train", "host_ms_per_step.train", "phase_a_s",
    "capture_s"])
def test_readers_give_none_without_the_recorder(name):
    """A program without the recorder (``spans`` None), or a window the
    recorder did not see: no reading, and no exception."""
    config = _config("sf-train" if "train" in name else "sf-distill")
    assert _reader(name)(_ctx(config, None, [{"ops": 1.0}])) is None
    snap = _record("distill/iteration", 0, {})
    units = [{"ops": 1.0, "k1_s": 0.0}] * 5
    got = _reader(name)(_ctx(config, snap, units))
    assert got is None or name in ("phase_a_s", "capture_s")


# ---- on a CUDA device ----------------------------------------------------

def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamp kernel has no CPU mode")


@pytest.mark.cuda
def test_every_replay_leaves_its_stamps(recording):
    """A program of two nested spans captured once and replayed four
    times: each replay's ``graph/<key>`` and its spans have device times
    of their own, in order, the children inside their graph's."""
    _needs_cuda()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(512, 512, device=dev)
    out = torch.zeros_like(x)

    def program():
        with spans.span("outer"):
            y = x @ x
            with spans.span("inner"):
                out.copy_(torch.relu(y @ x))

    runner = GraphRunner(dev, gen, [])
    mark = spans.mark()
    for i in range(5):
        with spans.unit("train/step", i):
            runner.run(("k",), program, i)
    snap = _since(mark)
    # the second run captures and replays, later runs replay
    assert (runner.warmups, len(runner.captures), runner.replays) == \
        (1, 1, 4)
    graphs = [s for s in snap if s["name"] == "graph/k"]
    assert [g["unit"] for g in graphs] == [1, 2, 3, 4]
    assert spans.clock()["error_ns"] is not None
    last = 0
    for g in graphs:
        kids = {s["name"]: s for s in _children(snap, g)}
        assert set(kids) == {"outer"}
        inner = _children(snap, kids["outer"])
        assert [s["name"] for s in inner] == ["inner"]
        for s in (g, kids["outer"], inner[0]):
            assert s["d0"] is not None and s["d0"] < s["d1"]
        assert last <= g["d0"] <= kids["outer"]["d0"] <= inner[0]["d0"] \
            <= inner[0]["d1"] <= kids["outer"]["d1"] <= g["d1"]
        last = g["d1"]
    assert {"capture/k", "warmup/k"} <= {s["name"] for s in snap}


@pytest.mark.cuda
def test_span_device_time_matches_the_profiler(recording):
    """Over one profiled window of a small fused loop, each span name's
    device ms (summed) agree with the profiler's kernel seconds between
    the same stamps within 5%; the stamps, converted to the host clock,
    sit at one offset from the profiler's records of the stamp kernel
    (kineto's conversion against ours), the same for each within 10 us."""
    _needs_cuda()
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2048, 2048, device=dev) / 45
    out = torch.zeros_like(x)

    def program():
        with spans.span("big"):
            y = x
            for _ in range(8):
                y = torch.tanh(y @ x)
        with spans.span("small"):
            out.copy_(y @ x + y)

    runner = GraphRunner(dev, gen, [])
    for i in range(3):
        runner.run(("k",), program, i)
    torch.cuda.synchronize()
    mark = spans.mark()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(6):
            with spans.unit("train/step", i):
                runner.run(("k",), program, i)
        torch.cuda.synchronize()
    snap = _since(mark)
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and e.duration_ns() > 0)
    stamps = [k for k in kernels if "span_stamp_kernel" in k[2]]
    work = [k for k in kernels if "span_stamp_kernel" not in k[2]]
    # the window's stamps in the order the device ran them, against the
    # profiler's records of the stamp kernel, one for one
    edges = sorted((slot, s[key]) for s in snap if s["d0"] is not None
                   for slot, key in zip(s["slots"], ("d0", "d1")))
    assert len(edges) == len(stamps) == 6 * 8
    at = {slot: k for (slot, _), k in zip(edges, stamps)}
    offsets = [k[0] - t for (_, t), k in zip(edges, stamps)]
    mid = sorted(offsets)[len(offsets) // 2]
    # one clock: the profiler's device times and the converted stamps
    # differ by one offset (kineto's own conversion and ours, within
    # ``clock()['error_ns']``), the same for every stamp within 10 us
    assert abs(mid) < 1_000_000
    assert max(abs(o - mid) for o in offsets) < 10_000
    for name in ("big", "small"):
        sel = [s for s in snap if s["name"] == name]
        assert len(sel) == 6
        ours = sum(s["d1"] - s["d0"] for s in sel)
        theirs = 0
        for s in sel:
            a, b = at[s["slots"][0]][1], at[s["slots"][1]][0]
            theirs += sum(min(k1, b) - max(k0, a) for k0, k1, _ in work
                          if k0 < b and k1 > a)
        assert ours == pytest.approx(theirs, rel=0.05), name
