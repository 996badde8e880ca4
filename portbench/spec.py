"""What a run reads from ``BENCHMARK.json`` and the files it names.

A cell is found by its name: its configuration file
(``configs/<config>.json``, whose ``kind`` names the module
``drivers/<kind>.py``), its traffic (``traffic/<traffic>.json``) and the
per-layer metrics that list it (``metrics/<metric>.py``, each a small
reader).  Adding a configuration, a traffic mix or a metric is adding
files and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]   # the cell's per-layer metrics
    driver: Callable        # drivers/<kind>.py's run(cell, run_args)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, root: pathlib.Path = ROOT,
              bench_dir: pathlib.Path = HERE) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    driver = _load_file(bench_dir / "drivers" / f"{config['kind']}.py",
                        f"portbench_driver_{config['kind']}").run
    return Cell(name, config, traffic, e2e, per_layer, driver)


def _load_file(path: pathlib.Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: pathlib.Path = HERE) -> Callable:
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or None
    where the trace holds nothing it reads."""
    path = bench_dir / "metrics" / f"{name}.py"
    return _load_file(path, "portbench_metric_" + name.replace(".", "_")).read


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one use of the run's seed (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *path]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def window_units(traffic: dict, seconds: float, trace: bool,
                 block: int = 1) -> int:
    """The iterations or steps a run's window times: the traffic's
    ``window_units_per_s`` for each second of ``--seconds``, rounded up to
    whole blocks of ``block`` units; a traced run's at least what its
    profiler's attempts need.  A count and not a clock, so that every run
    of a cell, whatever the program's speed, times the same work."""
    import math

    from portbench.trace import ATTEMPTS

    n = math.ceil(seconds * traffic["window_units_per_s"] - 1e-9)
    if trace:
        n = max(n, ATTEMPTS * (traffic["trace_skip"] + traffic["trace_warm"]
                               + traffic["trace_units"]))
    return max(block, -(-n // block) * block)


# the uses of the run's seed
SEED_SCENE, SEED_WEIGHTS, SEED_LOOP, SEED_TRAFFIC = range(4)


def program_sizes(config: dict) -> Dict[str, dict]:
    """The configuration's model sizes as keyword arguments, lists made
    tuples (the config dataclasses' fields)."""
    def fix(d: dict) -> dict:
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}
    return {k: fix(config[k]) for k in ("unet", "vae", "eft", "ddpm")
            if k in config}
