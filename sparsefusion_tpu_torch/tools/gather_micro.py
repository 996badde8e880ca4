"""Row-gather micro-benchmark: the port's counterpart of the entry point
of ``benchmarks/pallas_gather_micro.py``.

    python -m sparsefusion_tpu_torch.tools.gather_micro [N_points] \
        [--device cuda|cpu]

For each R in {8192, 16384, 32768}: a (R, 128) table drawn by
``torch.randn`` in f32 from seed 0 and cast to bf16, ``n_chunks = max(1,
N // R)`` and ``n_chunks * R`` indices drawn by ``torch.randint(0, R)``
(N defaults to 131072, as in the JAX micro).  On the card (the default)
it runs the hand-written row gather (K3, ``ops/row_gather.py``), checks
it bit-equal to the plain version (a gather is exact), and times it
against one ``torch.index_select`` call on the same inputs (the plain
version and the library yardstick at once) by ``torch.profiler`` device
time, with CUDA-event times beside them.  Each timed call writes a fresh
output block (the outputs held alive span four L2s), so the output
reaches memory as the bound counts it.  Each line also gives the bytes
bound (indices, table and output at 3.35 TB/s), the kernel's share of
it, and the 32-byte sectors per second the kernel moved.  ``--device
cpu`` runs the plain version only, checked against numpy, and times it
on the host clock.  Without a card ``--device cuda`` raises.
"""
from __future__ import annotations

import argparse
import collections
import math
import time
from typing import Dict

import numpy as np
import torch

from sparsefusion_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from sparsefusion_tpu_torch.tools.profiling import (
    device_ms,
    event_ms,
    named_ms,
)

TABLE_ROWS = (8192, 16384, 32768)
WIDTH = 128
N_POINTS = 131072
# NVIDIA H100 SXM data sheet: memory rate
HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32
ITERS = 20
# the outputs alive at a timed call span this many L2s (the H100's 50 MB
# where the device properties do not say)
L2_SPAN = 4
L2_BYTES = 50 * 2 ** 20


def make_inputs(table_rows: int, n_points: int, device="cpu",
                dtype=torch.bfloat16):
    """The micro's (R, 128) table in ``dtype`` and its ``max(1, N // R) *
    R`` int32 indices in [0, R), drawn from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    n_chunks = max(1, n_points // table_rows)
    table = torch.randn(table_rows, WIDTH, generator=gen, device=device,
                        dtype=torch.float32).to(dtype)
    idx = torch.randint(0, table_rows, (n_chunks * table_rows,),
                        generator=gen, device=device, dtype=torch.int32)
    return table, idx


def bound_ms(n_rows: int, table: torch.Tensor) -> float:
    """The least time for one gather of ``n_rows`` rows: the indices and
    the table read once, the output written once, at the memory rate."""
    row_bytes = table.shape[1] * table.element_size()
    n_bytes = n_rows * (4 + row_bytes) + table.numel() * table.element_size()
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _rotating(fn, out_bytes: int):
    """fn() with its output held for the next calls: the outputs alive at
    a call total at least ``L2_SPAN`` times the card's L2, so the caching
    allocator hands each call a block that no recent call wrote, and the
    output a call writes has to leave L2 for memory, as its bound counts.
    (Handed the same block each time, an output smaller than L2 could stay
    dirty in L2 from call to call and never reach memory in the timed
    window.)  The table and the indices are the same in every call and may
    stay in L2; the bound counts them once at the memory rate."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    l2_bytes = getattr(props, "L2_cache_size", 0) or L2_BYTES
    held = collections.deque(maxlen=max(1, math.ceil(
        L2_SPAN * l2_bytes / out_bytes)))
    return lambda: held.append(fn())


def _mrows(rows: int, ms: float) -> float:
    return rows / ms * 1e3 / 1e6


def _case_cuda(table, idx) -> Dict:
    rows = idx.shape[0]
    out = row_gather(table, idx)
    ref = row_gather_plain(table, idx)
    correct = bool(torch.equal(out, ref))
    err = (out.float() - ref.float()).abs().max().item() if rows else 0.0
    row_bytes = table.shape[1] * table.element_size()
    kernel = _rotating(lambda: row_gather(table, idx), rows * row_bytes)
    library = _rotating(lambda: torch.index_select(table, 0, idx),
                        rows * row_bytes)
    k_ms = named_ms(device_ms(kernel, ITERS), "row_gather_kernel")
    lib_ms = sum(device_ms(library, ITERS).values())
    bound = bound_ms(rows, table)
    sectors = rows * row_bytes // SECTOR_BYTES
    return {
        "rows": rows, "dtype": str(table.dtype).replace("torch.", ""),
        "ms": k_ms, "event_ms": event_ms(kernel, ITERS),
        "mrows_per_s": _mrows(rows, k_ms),
        "index_select_ms": lib_ms,
        "index_select_event_ms": event_ms(library, ITERS),
        "index_select_mrows_per_s": _mrows(rows, lib_ms),
        "bound_ms": bound, "bound_by": "bytes", "bound_share": bound / k_ms,
        "sectors": sectors, "sectors_per_s": sectors / k_ms * 1e3,
        "max_abs_err": err, "correct": correct}


def _case_cpu(table, idx) -> Dict:
    rows = idx.shape[0]
    out = row_gather_plain(table, idx)
    want = table.float().numpy()[idx.numpy()]
    correct = bool(np.array_equal(out.float().numpy(), want))
    t0 = time.perf_counter()
    for _ in range(3):
        row_gather_plain(table, idx)
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    return {"rows": rows, "dtype": str(table.dtype).replace("torch.", ""),
            "host_ms_cpu": host_ms, "mrows_per_s_cpu": _mrows(rows, host_ms),
            "correct": correct}


def run(n_points: int = N_POINTS, device="cuda", dtype=torch.bfloat16,
        table_rows=TABLE_ROWS) -> Dict[int, Dict]:
    """One line per table size; returns {R: the line's numbers}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the plain version")
    results = {}
    for r in table_rows:
        table, idx = make_inputs(r, n_points, device, dtype)
        if device.type == "cuda":
            res = _case_cuda(table, idx)
            line = (f"R={r} rows={res['rows']}: kernel {res['ms']:.4f} ms "
                    f"({res['mrows_per_s']:.0f} Mrows/s) vs index_select "
                    f"{res['index_select_ms']:.4f} ms "
                    f"({res['index_select_mrows_per_s']:.0f} Mrows/s) "
                    f"correct={res['correct']} ({res['dtype']}; bound "
                    f"{res['bound_ms']:.4f} ms, {res['bound_share']:.0%} of "
                    f"it; "
                    f"{res['sectors_per_s'] / 1e9:.1f} G sectors/s)")
        else:
            res = _case_cpu(table, idx)
            line = (f"R={r} rows={res['rows']}: plain index_select "
                    f"{res['host_ms_cpu']:.3f} host ms on the CPU "
                    f"({res['mrows_per_s_cpu']:.0f} Mrows/s) "
                    f"correct={res['correct']} ({res['dtype']})")
        print(line, flush=True)
        results[r] = res
    return results


def main(argv=None) -> Dict[int, Dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_points", nargs="?", type=int, default=N_POINTS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    results = run(args.n_points, args.device)
    if not all(r["correct"] for r in results.values()):
        raise SystemExit("row gather disagrees with its reference")
    return results


if __name__ == "__main__":
    main()
