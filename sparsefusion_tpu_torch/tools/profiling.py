"""Device time by ``torch.profiler``: the reads that ``chip_smoke.py`` and
``tools/gather_micro.py`` share.

:func:`profile_window` records one window of calls and returns each
kernel's device ms per call; a window whose profile holds no device time
(the tracer now and then returns none) is taken again.  :func:`device_ms`
warms a call up and profiles ``iters`` of it; :func:`named_ms` picks the
kernels whose name holds a given string; :func:`event_ms` times calls by
CUDA events.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple, Union


def kernel_ms(prof, n_calls: int) -> Dict[str, float]:
    """{kernel name: device ms per call} from a finished torch.profiler
    run over n_calls calls: each kernel's mean duration times its
    launches per call, so a record the profiler drops does not count as
    a call without the kernel."""
    by_name = {}
    for e in prof.key_averages():
        us = max(getattr(e, a, 0) or 0 for a in (
            "self_device_time_total", "device_time_total",
            "self_cuda_time_total", "cuda_time_total"))
        if us > 0 and e.count > 0:
            if e.count % n_calls:
                print(f"  (profiler: {e.count} records of {e.key[:60]} "
                      f"over {n_calls} calls)")
            per_call = max(1, round(e.count / n_calls))
            by_name[e.key] = by_name.get(e.key, 0.0) \
                + us / 1e3 / e.count * per_call
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time")
    return by_name


def profile_window(run: Callable[[], None], n_calls: int,
                   reset: Optional[Callable[[], None]] = None,
                   attempts: int = 5):
    """torch.profiler's device activity over ``run()``, which makes
    ``n_calls`` calls: (kernel name -> device ms per call, the profile,
    host ms per call).  The window ends in a synchronise.  ``reset()``
    runs before each attempt.  A window whose profile recorded no device
    time is taken again, up to ``attempts`` times; each starts its calls
    a few milliseconds after the tracer, since windows of ten launches
    of a few microseconds each lost every record now and then."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        if reset is not None:
            reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.005)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / n_calls
        try:
            return kernel_ms(prof, n_calls), prof, host_ms
        except RuntimeError:
            if attempt == attempts - 1:
                raise
            print(f"  (profiler: no device time recorded, attempt "
                  f"{attempt + 1} of {attempts})")


def device_ms(fn: Callable[[], object], iters: int) -> Dict[str, float]:
    """Device time of one fn() call, over ``iters`` calls after 2 warm
    ones: {kernel name: ms per call}, summed over the call's launches of
    that kernel."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    return profile_window(run, iters)[0]


def event_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean ms of fn() over ``iters`` back-to-back calls after 2 warm
    ones, by CUDA events: at a few microseconds a call this is the host's
    enqueue rate, not the device's time."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def named_ms(by_name: Dict[str, float],
             kernel: Union[str, Tuple[str, ...]]) -> float:
    """The device ms of the kernels whose name holds ``kernel`` (or any of
    the strings of a tuple: the bodies of one kernel)."""
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    ms = [t for name, t in by_name.items() if any(k in name for k in kernels)]
    if not ms:
        raise RuntimeError(f"{kernel} not among the profiled kernels "
                           f"{sorted(by_name)}")
    return sum(ms)
