"""The arithmetic that the per-layer metrics' readers share.

Each reader takes the run's context (``trace``: the traced window of
:mod:`portbench.trace`, whose ``units`` are the run loops' records of the
work traced; ``config``: the configuration file) and returns a number,
or None where the window holds nothing it reads, so that the metric is
left out of the run's line.  No share is ever returned as 0 for want of
a reading.
"""
from __future__ import annotations

from typing import Optional

from portbench.flops import peak_ops


def idle_pct(ctx) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_pct(ctx) -> Optional[float]:
    """Model operations of the traced units over the window's seconds at
    the configuration's peak, in percent."""
    tr = ctx["trace"]
    if tr is None or not tr.units:
        return None
    ops = sum(u["ops"] for u in tr.units)
    return 100.0 * ops / (tr.window_s * peak_ops(ctx["config"]))


def roofline_pct(ctx, key: str, *kernel_names: str) -> Optional[float]:
    """The least seconds the traced units' work ``key`` needs over the
    device seconds of the kernels named, in percent."""
    tr = ctx["trace"]
    if tr is None:
        return None
    seconds = tr.named_s(*kernel_names)
    least = sum(u.get(key, 0.0) for u in tr.units)
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
