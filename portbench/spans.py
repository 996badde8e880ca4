"""The arithmetic that the span metrics' readers share.

The readers read the program's span recorder
(``sparsefusion_tpu_torch/utils/spans.py``) in the measured process,
after the run: each unit of work (a distillation iteration, a train
step) is a span, and the layers' spans inside it carry device times
taken inside the replayed CUDA graphs.  The traced window's units are
the last ``len(trace.units)`` units that the recorder took while the
profiler recorded.  A program without the recorder, or a window the
recorder did not see, gives None, and the metric is left out of the
line.  Counts in a denominator (UNet evaluations, K1's needed points,
Adam's bytes) are the benchmark's own, from the configuration and
``portbench/flops.py``, never the program's.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def snapshot(ctx) -> Optional[List[dict]]:
    """The recorder's spans, read once per run (None without it)."""
    if "spans" not in ctx:
        try:
            from sparsefusion_tpu_torch.utils import spans
        except ImportError:
            ctx["spans"] = None
        else:
            ctx["spans"] = spans.snapshot()
    return ctx["spans"]


def window(ctx) -> Optional[List[tuple]]:
    """[(unit span, its spans)] of the traced window's units, or None.
    A unit's spans are those recorded after the unit before it that
    carry its index: the spans inside it and, since the recorder gives
    the spans between two units to the next, those before it (the batch
    a train step's caller builds, a loss read between steps)."""
    tr = ctx.get("trace")
    snap = snapshot(ctx)
    if tr is None or not tr.units or not snap:
        return None
    every = [s for s in snap if s["kind"] == "unit"]
    units = [s for s in every if s["profiled"]]
    n = len(tr.units)
    if len(units) < n:
        return None
    ids = [s["id"] for s in every]
    at = {i: k for k, i in enumerate(ids)}
    out = []
    for u in units[-n:]:
        k = at[u["id"]]
        lo = ids[k - 1] if k > 0 else -1
        hi = ids[k + 1] if k + 1 < len(ids) else float("inf")
        out.append((u, [s for s in snap if lo < s["id"] < hi
                         and s["id"] != u["id"]
                         and s["unit"] == u["unit"]]))
    return out


def device_ms(spans: List[dict], names) -> Optional[float]:
    """Device ms of the spans named, summed; None where one has no
    device time, or none is there."""
    sel = [s for s in spans if s["name"] in names]
    if not sel or any(s["d0"] is None or s["d1"] is None for s in sel):
        return None
    return sum(s["d1"] - s["d0"] for s in sel) * 1e-6


def window_device_ms(ctx, names) -> Optional[tuple]:
    """(device ms of the spans named over the window, its units)."""
    win = window(ctx)
    if win is None:
        return None
    per = [device_ms(spans, names) for _, spans in win]
    if any(v is None for v in per):
        return None
    return sum(per), len(win)


def per_unit_device_ms(ctx, names) -> Optional[float]:
    got = window_device_ms(ctx, names)
    return None if got is None else got[0] / got[1]


def _host_ns(s: dict) -> int:
    return s["t1"] - s["t0"] if s["t0"] is not None \
        and s["t1"] is not None else 0


def host_ms_per_unit(ctx) -> Optional[float]:
    """The host's own ms a unit over the window: the unit's host time
    and that of the spans before it, less its loss reads (``loss_read``:
    waits for the device) and its graph launches (``graph/<key>``: a
    launch waits there for room in the device's queue once the host is
    ahead, so its time reads the device's pace)."""
    win = window(ctx)
    if win is None:
        return None
    total = 0
    for u, spans in win:
        total += _host_ns(u) + sum(
            _host_ns(s) for s in spans if s["parent"] is None) - sum(
            _host_ns(s) for s in spans if s["name"] == "loss_read"
            or s["name"].startswith("graph/"))
    return total * 1e-6 / len(win)


def counted(spans: List[dict], names, counter: str) -> int:
    return sum(s["counts"].get(counter, 0) for s in spans
               if s["name"] in names)


def setup_seconds(ctx, match) -> Optional[float]:
    """Host seconds of the set-up spans whose name ``match`` accepts,
    summed (None where there is none)."""
    snap = snapshot(ctx)
    if not snap:
        return None
    sel = [s for s in snap if s["kind"] == "setup" and match(s["name"])]
    if not sel:
        return None
    return sum(s["t1"] - s["t0"] for s in sel) * 1e-9


def distill_counts(config: dict) -> Dict[str, float]:
    """The benchmark's counts of a distillation iteration: its two
    renders' operations, the VAE's and one batch-1 UNet evaluation's
    (``drivers/distill.py``), and the K1 forward points that the two
    renders need (each ``render_hw^2`` rays at ``num_steps`` and then
    ``upsample_steps`` samples)."""
    import json

    from portbench.drivers.distill import _counts

    r_ops, _, vae, unet = _counts(json.dumps(config, sort_keys=True))
    d = config["distill"]
    rays = (config["image_size"] // d["hw_scale"]) ** 2
    return {"renders": 2 * r_ops, "vae": vae, "unet": unet,
            "k1_points": 2 * rays * (d["num_steps"] + d["upsample_steps"])}


def unet_evals(ctx) -> Optional[int]:
    """The traced units' UNet evaluations by the benchmark's count: each
    unit's operations (``drivers/distill.py::iteration_work``) less its
    renders' and VAE's, over one evaluation's."""
    tr = ctx.get("trace")
    if tr is None or not tr.units:
        return None
    c = distill_counts(ctx["config"])
    n = sum(round((u["ops"] - c["renders"] - c["vae"]) / c["unet"])
            for u in tr.units if u["ops"] > c["renders"])
    return n or None
