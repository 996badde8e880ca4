"""The train step as one captured program a step: a CUDA graph for each
context size.

Counterpart of the JAX train step's dispatch: ``jax.jit(train_step)``
(``sparsefusion_tpu/train/trainer.py``) is one program per input shape,
which holds the EFT render, the VAE encode, the masked eps loss through
the UNet, the backward and the guarded Adam update, and computes the
depth range from the context cameras inside it.  Here that program is
:meth:`TrainStep.program` (no host read), run by
``utils/graphs.py::GraphRunner`` under the batch's context size, the
one shape that changes between steps (``--context_size 0`` draws 2-5
views), as XLA compiles once per shape: on a CUDA device the first step
of a size runs eagerly, the second captures and replays, later ones
replay; on the CPU every step runs eagerly through the same program,
which is how the tests hold it against the eager step and the JAX step.

Each size has static input buffers: the host batch (images, valid
region, cameras) is packed into one pinned host tensor and copied into
them with one ``copy_(..., non_blocking=True)``.  The parameters, the
Adam state, the learning rates and the guard's counts are the models'
and optimizers' own tensors, updated in place by the graphs (a resume's
``load_state_dict`` copies into them before the first capture; nothing
rebinds them after).  The step's generator is registered with each
graph, so replays draw what the eager steps draw, in their order.  A
step's losses land in a static
(3,) buffer that the next step of its size overwrites: the caller copies
them out, into a :class:`LossRing` that it reads in one transfer.

Each call is the span recorder's unit ``train/step`` (its index the
call's), which holds the batch's packing (``train/pack``) and the
program's run (``graph/step/<size>``, with the step's own spans under
it); the ring's read is ``loss_read``, where the recorder also reads its
device stamps (``utils/spans.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import torch

from sparsefusion_tpu_torch.core.cameras import Cameras
from sparsefusion_tpu_torch.utils import spans
from sparsefusion_tpu_torch.utils.graphs import GraphRunner, launch_counters

_IMAGES = ("query_rgb", "query_valid", "context_rgb")
_CAMERAS = ("query_cam", "context_cams")


def _host_parts(batch: Dict) -> List[torch.Tensor]:
    """The batch's tensors in the static buffers' order: the images, then
    each scene's query and context camera fields."""
    parts = [batch[k] for k in _IMAGES]
    for key in _CAMERAS:
        for cams in batch[key]:
            parts += [getattr(cams, f.name)
                      for f in dataclasses.fields(Cameras)]
    return parts


class LossRing:
    """Rows of a step's device values (its losses) kept on the device and
    read in one transfer: :meth:`push` copies a row in with no host read;
    :meth:`read` returns the rows pushed since the last read."""

    def __init__(self, width: int, device, rows: int = 64):
        self.buf = torch.zeros((rows, width), device=device)
        self.n = 0

    def push(self, row: torch.Tensor) -> None:
        if self.n == self.buf.shape[0]:
            self.buf = torch.cat([self.buf, torch.zeros_like(self.buf)])
        self.buf[self.n].copy_(row)
        self.n += 1

    def read(self) -> List[List[float]]:
        with spans.span("loss_read"):
            rows = self.buf[:self.n].tolist()
            spans.sync_point()
        self.n = 0
        return rows


class FusedTrainStep:
    """``fused(batch) -> (3,)`` device losses (loss, d_loss, color_loss)
    of one step of ``step`` (a :class:`TrainStep` outside DDP) on a host
    batch of ``prepare_scene_batch`` (its host depth range unused), valid
    until the next step of the same context size; ``step.draws`` then
    holds that step's draws."""

    def __init__(self, step, generator: torch.Generator):
        if step.ddp_modules:
            raise ValueError("the captured step runs one process; under "
                             "DDP the step stays eager")
        self.step = step
        self.generator = generator
        self.device = next(step.models.unet.parameters()).device
        self.runner = GraphRunner(self.device, generator,
                                  launch_counters(step.models))
        # context size -> (shapes, flat buffer, static batch, losses), and
        # the draws of its program's last Python run (a graph's own
        # tensors once captured: each replay rewrites them)
        self._static: Dict[int, tuple] = {}
        self._draws: Dict[int, list] = {}
        self.calls = 0

    def _make_static(self, parts: List[torch.Tensor], batch: Dict) -> tuple:
        flat = torch.zeros(sum(p.numel() for p in parts), device=self.device)
        views, at = [], 0
        for p in parts:
            views.append(flat[at:at + p.numel()].view(p.shape))
            at += p.numel()
        static = dict(zip(_IMAGES, views))
        fields = len(dataclasses.fields(Cameras))
        rest = iter(views[len(_IMAGES):])
        for key in _CAMERAS:
            static[key] = [Cameras(*(next(rest) for _ in range(fields)))
                           for _ in batch[key]]
        shapes = [p.shape for p in parts]
        return shapes, flat, static, torch.zeros(3, device=self.device)

    def __call__(self, batch: Dict) -> torch.Tensor:
        with spans.unit("train/step", self.calls):
            parts = _host_parts(batch)
            size = batch["context_rgb"].shape[1]
            if size not in self._static:
                self._static[size] = self._make_static(parts, batch)
            shapes, flat, static, losses = self._static[size]
            if [p.shape for p in parts] != shapes:
                raise ValueError("a batch's shapes changed under one "
                                 "context size")
            with spans.span("train/pack"):
                host = torch.empty(flat.shape, pin_memory=self.runner.graphs)
                torch.cat([p.reshape(-1) for p in parts], out=host)
                flat.copy_(host, non_blocking=True)
            self.runner.run(("step", size),
                            functools.partial(self._program, size),
                            self.calls)
        self.calls += 1
        self.step.draws = self._draws[size]
        return losses

    def _program(self, size: int) -> None:
        _, _, static, losses = self._static[size]
        losses.copy_(self.step.program(static, self.generator))
        self._draws[size] = self.step.draws

    def stats(self) -> dict:
        """Warm-ups, captures (context size, call), replays; the captures'
        seconds are the recorder's ``capture/step/<size>`` spans."""
        r = self.runner
        return {"graphs": r.graphs, "warmups": r.warmups,
                "captures": [dict(c, key=c["key"][1]) for c in r.captures],
                "replays": r.replays}
