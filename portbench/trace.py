"""The traced window: device activity by ``torch.profiler``.

The window arithmetic is the port's ``tools/profiling.py``'s, copied so
that the yardstick does not move with the program: the tracer starts,
the device is synchronised, a few milliseconds pass before the traced
calls, and the window ends in a synchronise; a window whose profile
holds no device time is taken again, up to five times.  Here the window
is opened and closed by the run loops around whole iterations or steps
(:class:`TraceWindow`), and read from the raw trace: the device's busy
time (the union of its kernels, copies and sets), each kernel class's
time, each named kernel's time, and the longest idle gaps with what the
host was doing in each.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

ATTEMPTS = 5
MARK = "portbench/window"

# kernel classes of the breakdown, first match wins
CLASSES = (
    ("K1", re.compile(r"grid_encode")),
    ("K2", re.compile(r"imagen_attention")),
    ("copy", re.compile(r"memcpy|memset|copy|Memcpy|Memset|CatArray",
                        re.I)),
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|implicit|winograd|"
                               r"fft", re.I)),
    ("matmul", re.compile(r"gemm|gemv|cutlass|cublas|matmul|xmma", re.I)),
    ("normalisation", re.compile(r"norm|welford|moments|fusedparams|"
                                 r"gammabeta", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|reduce|foreach|"
                               r"fused_adam|multi_tensor", re.I)),
)


def kernel_class(name: str) -> str:
    for cls, pattern in CLASSES:
        if pattern.search(name):
            return cls
    return "other"


@dataclasses.dataclass
class Trace:
    """What one traced window read."""
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # by kernel name
    class_s: Dict[str, float]           # by kernel class
    gaps: List[Tuple[str, float]]       # longest idle gaps, host activity
    units: List[dict]                   # the run loops' records of the work

    def named_s(self, *parts: str) -> float:
        """Seconds of the kernels whose name holds any of ``parts``."""
        return sum(t for n, t in self.kernel_s.items()
                   if any(p in n for p in parts))

    def save(self, path: str) -> None:
        """The window's kernels by device seconds, as JSON."""
        import json

        with open(path, "w") as f:
            json.dump({"window_s": self.window_s, "busy_s": self.busy_s,
                       "class_s": self.class_s, "gaps": self.gaps,
                       "kernels": sorted(self.kernel_s.items(),
                                         key=lambda kv: -kv[1])}, f,
                      indent=0)

    def breakdown(self) -> dict:
        ops = sorted(self.class_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(prof, units: List[dict]) -> Optional[Trace]:
    """The window of a finished profile, or None where it recorded no
    device time."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    mark = [e for e in events
            if e.name() == MARK and e.device_type() != cuda]
    if not mark:
        return None
    w0 = mark[0].start_ns()
    w1 = w0 + mark[0].duration_ns()
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events
            if e.device_type() != cuda and e.name() != MARK
            and e.duration_ns() > 0]
    host_names = {name for name, _, _ in host} | {MARK}
    # the device's own activity: kernels, copies and sets, not the
    # annotations that mirror the host's ranges on the device's timeline
    device = [(e.name(), max(e.start_ns(), w0),
               min(e.start_ns() + e.duration_ns(), w1))
              for e in events
              if e.device_type() == cuda and e.name() not in host_names]
    device = [d for d in device if d[2] > d[1]]
    if not device:
        return None
    kernel_s: Dict[str, float] = {}
    class_s: Dict[str, float] = {}
    for name, a, b in device:
        s = (b - a) * 1e-9
        kernel_s[name] = kernel_s.get(name, 0.0) + s
        cls = kernel_class(name)
        class_s[cls] = class_s.get(cls, 0.0) + s
    busy = _merge([(a, b) for _, a, b in device])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle.sort(key=lambda ab: ab[0] - ab[1])
    gaps = []
    for a, b in idle[:10]:
        best, most = "host python (no traced call)", 0
        for name, ha, hb in host:
            overlap = min(b, hb) - max(a, ha)
            if overlap > most:
                best, most = name, overlap
        gaps.append((best, (b - a) * 1e-9))
    return Trace((w1 - w0) * 1e-9, busy_s, kernel_s, class_s, gaps, units)


class TraceWindow:
    """A profiler window over whole units of work (iterations, steps).

    The run loop calls :meth:`step` after each unit it runs, with the
    unit's record of its work.  The tracer starts ``skip`` units in; its
    first ``warm`` units run traced but outside the window, so that the
    window holds replays of graphs already replayed under the tracer;
    then the window opens (a synchronise, a few milliseconds) over
    ``units`` units and closes in a synchronise.  A window that
    recorded no device time is dropped and another is taken, up to
    ``ATTEMPTS`` in all; :attr:`trace` is the one read."""

    def __init__(self, skip: int, warm: int, units: int):
        self.skip, self.warm, self.units = skip, warm, units
        self.trace: Optional[Trace] = None
        self.attempts = 0
        self._seen = 0
        self._prof = None
        self._mark = None
        self._units: List[dict] = []

    @property
    def open(self) -> bool:
        return self._prof is not None

    def step(self, unit: dict) -> None:
        """Count one unit just run (its ``ops`` and other work)."""
        self._seen += 1
        if self._prof is None:
            if self.trace is None and self.attempts < ATTEMPTS \
                    and self._seen >= self.skip:
                self._start()
            return
        if self._mark is None:
            self._warmed += 1
            if self._warmed >= self.warm:
                self._open_window()
            return
        self._units.append(unit)
        if len(self._units) >= self.units:
            self._stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.attempts += 1
        self._units, self._warmed = [], 0
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        if self.warm == 0:
            self._open_window()

    def _open_window(self) -> None:
        import torch
        from torch.autograd.profiler import record_function

        torch.cuda.synchronize()
        time.sleep(0.005)
        self._mark = record_function(MARK)
        self._mark.__enter__()

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        prof, self._prof, self._mark = self._prof, None, None
        self.trace = read_trace(prof, self._units)
