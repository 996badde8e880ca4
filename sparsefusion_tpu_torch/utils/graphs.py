"""What the CUDA graphs of the distillation loop (``distill/fused.py``)
and of the train step (``train/fused.py``) share.

* :class:`GraphRunner` runs programs under static keys: on a CUDA device
  a key's first run is eager, on a side stream (the work itself, and the
  warm-up that builds the kernels, the optimizer's state and the
  libraries' handles); its second run captures the program into a
  ``torch.cuda.CUDAGraph`` (the caller's generator registered with the
  graph, so that every replay draws fresh numbers, in the order the
  eager runs draw them) and replays it; later runs replay.  Each graph
  has a memory pool of its own: nothing outside a graph writes its
  memory.  A capture or replay that fails raises: there is no eager
  fallback.  Elsewhere (the CPU) every run is eager.
* :func:`launch_counters`: the kernels' launch counters and the UNet
  evaluations count in Python, so each graph records what its capture
  counted and adds it at each replay.
* The span recorder (``utils/spans.py``): each key's first run is the
  set-up span ``warmup/<key>``, its capture ``capture/<key>``, which
  records the graph's span template (the spans opened inside it, their
  counters and their captured device stamps) and calibrates the device
  clock against the host's; each later run is the
  span ``graph/<key>`` (on the CPU, every run), whose replay's stamps
  the recorder ties to the running unit.
* :class:`TensorStepLR`: a learning-rate staircase ticked by device
  operations, so that a captured optimizer update ticks it at each
  replay; its tick can be masked by a device flag (the non-finite guard).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sparsefusion_tpu_torch.utils import spans


def launch_counters(models=None) -> List[Tuple[object, str]]:
    """The Python counts that a replayed graph must advance: the kernels'
    launch counters and, with ``models``, its UNet evaluations."""
    from sparsefusion_tpu_torch.kernels import attention, grid_encode
    from sparsefusion_tpu_torch.kernels import row_gather

    counters = [(grid_encode.grid_encode_cuda, a)
                for a in ("launches", "scenes", "launches_bf16")]
    counters += [(grid_encode.grid_encode_cuda_backward, a)
                 for a in ("launches", "scenes")]
    counters += [(attention.imagen_attention_cuda, a) for a in (
        "launches", "launches_bf16", "launches_bf16_wgmma")]
    counters.append((row_gather.row_gather_cuda, "launches"))
    if models is not None:
        counters.append((models, "unet_evals"))
    return counters


def key_name(key: tuple) -> str:
    """A static key as a span's name: its parts joined by "/", a render
    config as its mode ("two_phase" or "march")."""
    return "/".join(("march" if k.march_steps else "two_phase")
                    if hasattr(k, "march_steps") else str(k) for k in key)


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class GraphRunner:
    """Runs programs under static keys: on a CUDA device eagerly the first
    time, captured into a CUDA graph the second, replayed from then on;
    on any other device eagerly every time.  ``captures`` lists each
    capture's key and the caller's ``itr``; its host seconds are the
    recorder's ``capture/<key>`` span."""

    def __init__(self, device: torch.device, generator: torch.Generator,
                 counters: List[Tuple[object, str]]):
        self.graphs = device.type == "cuda"
        self.device = device
        self.generator = generator
        self.counters = counters
        self._captured: Dict[tuple, tuple] = {}
        self._names: Dict[tuple, str] = {}
        self._warm = set()
        self.warmups = 0
        self.replays = 0
        self.captures: List[dict] = []
        if self.graphs:
            self._stream = torch.cuda.Stream(device)
            spans.use_device(device)

    def _read(self) -> list:
        return [getattr(o, a) for o, a in self.counters]

    def _name(self, key: tuple) -> str:
        name = self._names.get(key)
        if name is None:
            name = self._names[key] = key_name(key)
        return name

    def run(self, key: tuple, program, itr: int) -> None:
        if not self.graphs:
            with spans.span("graph/" + self._name(key)):
                program()
            return
        entry = self._captured.get(key)
        if entry is None:
            if key not in self._warm:
                self._warm.add(key)
                self.warmups += 1
                current = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(current)
                with spans.setup_span("warmup/" + self._name(key)), \
                        torch.cuda.stream(self._stream):
                    program()
                current.wait_stream(self._stream)
                return
            entry = self._capture(key, program, itr)
        graph, counted, template = entry
        with spans.replay(template):
            graph.replay()
        for (owner, attr), n in zip(self.counters, counted):
            setattr(owner, attr, getattr(owner, attr) + n)
        self.replays += 1

    def _capture(self, key, program, itr):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = self._read()
        current = torch.cuda.current_stream(self.device)
        name = self._name(key)
        with spans.setup_span("capture/" + name):
            torch.cuda.synchronize(self.device)
            try:
                with torch.cuda.graph(graph, stream=self._stream), \
                        spans.capture("graph/" + name) as template:
                    program()
            except BaseException:
                # a failed capture's exit leaves the capture stream current
                torch.cuda.set_stream(current)
                raise
            torch.cuda.synchronize(self.device)
        spans.calibrate()
        after = self._read()
        # the capture launched nothing; each replay adds what it counted
        for (owner, attr), n in zip(self.counters, before):
            setattr(owner, attr, n)
        entry = (graph, [a - b for a, b in zip(after, before)], template)
        self._captured[key] = entry
        self.captures.append({"key": key, "itr": itr})
        return entry


class TensorStepLR:
    """``StepLR``'s staircase on 0-d float32 learning-rate tensors
    (``lrs``, one a base rate): every :meth:`step` moves the rates to
    ``base * gamma ** (n // step_size)`` after n counted steps, with
    device operations only (a counter, a division and a gather from a
    table of the staircase's values), so that a CUDA graph holding an
    optimizer update replays the tick too.  The table holds the values
    ``StepLR`` chains in double precision from the float bases, rounded
    to float32, until they reach 0 or infinity there (or at once for
    ``gamma`` 1); later steps stay on the last one."""

    MAX_LEVELS = 4096

    def __init__(self, bases, step_size: int, gamma: float, device=None):
        self.step_size = int(step_size)
        columns = []
        for value in map(float, bases):
            col = []
            while len(col) < self.MAX_LEVELS:
                col.append(value)
                if gamma == 1.0 or not 0 < abs(np.float32(value)) < np.inf:
                    break
                value *= gamma
            columns.append(col)
        levels = max(len(c) for c in columns)
        self.table = torch.tensor(
            [c + [c[-1]] * (levels - len(c)) for c in columns],
            dtype=torch.float32, device=device)          # (groups, levels)
        self.lrs = [self.table[g, 0].clone() for g in range(len(columns))]
        self.count = torch.zeros((1,), dtype=torch.int64, device=device)

    def step(self, skip: Optional[torch.Tensor] = None) -> None:
        """Count a step; with ``skip``, a one-element float flag on the
        device (1: the update was skipped), count ``1 - skip`` of one."""
        if skip is None:
            self.count += 1
        else:
            self.count += 1 - skip.reshape(1).to(torch.int64)
        self._set_rates()

    def _set_rates(self) -> None:
        level = torch.clamp(torch.div(self.count, self.step_size,
                                      rounding_mode="floor"),
                            max=self.table.shape[1] - 1)
        rates = self.table.index_select(1, level)
        for g, lr in enumerate(self.lrs):
            lr.copy_(rates[g, 0])

    @property
    def last_epoch(self) -> int:
        """The steps counted (a host read), ``StepLR``'s name for it."""
        return int(self.count)

    def state_dict(self) -> Dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state: Dict) -> None:
        """Set the count (``StepLR``'s state dicts load too) and the
        rates, in place."""
        self.count.fill_(int(state["last_epoch"]))
        self._set_rates()
