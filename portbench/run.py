"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic, run module
and per-layer metrics are found by name (``portbench/spec.py``).  The
run builds its inputs and weights from ``--seed``, warms up every
program the cell replays (that is ``setup_s``), times a window of the
count of iterations or steps that the cell's traffic fixes for
``--seconds`` (``spec.window_units``), and then checks what the timed
path produced against the plain reference (``portbench/reference``): the reference follows the
program's first steps, which set-up drove through the window's own call,
and each number compared is printed beside its limit, last on standard
error and last in the result's line.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics; with ``--trace 1`` the per-layer ones, read
from a profiler window over a few steady units inside the measured
window), ``device`` and, traced, ``breakdown``, then ``checks``.

It exits non-zero with no result without a CUDA device, or with fewer
than the cell asks for, and if JAX or the JAX package is loaded in the
process once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sparsefusion_tpu")


def _env_defaults() -> None:
    """No JAX from any library.  (The port builds its kernels in the
    checkout's ``build/kernels/`` by itself.)"""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(n: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": n,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved())}


def worst(values) -> float:
    """The largest of ``values``; infinite where any is not finite."""
    values = list(values)
    if not all(map(math.isfinite, values)):
        return math.inf
    return max(values)


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared, each {value, limit}: the widest relative gap
    of the followed steps' losses; the worst leaf's gap between the
    program's and the reference's norms of the first moment after the
    first update (the first gradient as the optimizer got it) and of the
    change of the parameters over the followed steps, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger.  Leaves whose reference moment is under a thousandth of the
    median leaf's move by round-off alone and are left out of the
    change.  Where ``limits`` name ``target_gap``: the relative distance
    (L2) between the program's and the reference's sampler outputs of the
    followed fusion steps, taken together (a low-noise step's small
    output weighs as little as it measures)."""
    from statistics import median

    loss = worst(abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    m_ref = ref["moment"]
    med_m = median(m_ref.values())
    grad = worst(abs(prog["moment"].get(n, 0.0) - v) / max(v, med_m)
                 for n, v in m_ref.items())
    moved = [n for n, v in m_ref.items() if v >= 1e-3 * med_m]
    c_ref = ref["change"]
    med_c = median(c_ref[n] for n in moved)
    change = worst(abs(prog["change"].get(n, 0.0) - c_ref[n])
                   / max(c_ref[n], med_c) for n in moved)
    values = {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
    if "target_gap" in limits:
        p_t, r_t = prog.get("targets", []), ref["targets"]
        values["target_gap"] = math.inf
        if r_t and len(p_t) == len(r_t):
            import torch

            p_all = torch.cat([t.flatten() for t in p_t])
            r_all = torch.cat([t.flatten() for t in r_t])
            values["target_gap"] = worst(
                [float((p_all - r_all).norm() / r_all.norm())])
    out = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    out["change_gap"]["leaves"] = len(moved)
    out["change_gap"]["left_out"] = sorted(set(m_ref) - set(moved))
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root=None, bench_dir=None,
             around_program=None) -> dict:
    """One run of a cell: the result's fields (without printing).
    ``around_program``: a context manager entered around the program's
    part of the run only (set-up and window), as the check's tests plant
    a fault."""
    import contextlib
    import pathlib

    import torch

    from portbench import spec

    root = pathlib.Path(root) if root else spec.ROOT
    bench_dir = pathlib.Path(bench_dir) if bench_dir else spec.HERE
    cell = spec.find_cell(workload, root, bench_dir)
    with around_program or contextlib.nullcontext():
        outcome = cell.driver(cell, seed=seed, seconds=seconds, trace=trace,
                              device=torch.device(device), t0=T0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the measured process: {found}")
    dev = device_info(1)
    metrics = {}
    breakdown = None
    if trace:
        tr = outcome["trace"]
        if tr is None:
            raise RuntimeError("the profiler recorded no device time")
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        ctx = {"trace": tr, "config": cell.config, "cell": cell.name}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tr.breakdown()
        tmp = os.environ.get("TMPDIR")
        if tmp and os.path.isdir(tmp):
            tr.save(os.path.join(tmp, f"portbench_{workload}_{seed}.json"))
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome["metrics"][m["name"]],
                                  "unit": m["unit"]}
    program = outcome["program"]
    follow = outcome["reference"]
    setup_marks = outcome["setup_marks"]
    del outcome
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = follow()
    program["change"] = ref.pop("program_change")
    checks = compare(program, ref, cell.traffic["limits"])
    for c in checks.values():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": program["attempted"],
              "failed": program["failed"], "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_marks_s"] = setup_marks
    left_out = checks["change_gap"].pop("left_out")
    result["change_leaves"] = {
        "compared": checks["change_gap"].pop("leaves"),
        "left_out": len(left_out), "left_out_first": left_out[:5]}
    result["reference_s"] = time.perf_counter() - t_ref
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from portbench import spec

    _env_defaults()
    import torch

    bench = spec.load_benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print("a CUDA device is needed (found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f", the cell asks for {chips[args.workload]})", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
