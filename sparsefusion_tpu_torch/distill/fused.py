"""The distillation loops' iteration programs, captured as CUDA graphs.

Counterpart of the fused dispatch of ``sparsefusion_tpu/distill/loop.py``
(``DistillConfig.fused_steps``), which turns an iteration into a few
jitted programs, and of the scene-batched loop's per-step programs
(``sparsefusion_tpu/distill/batched.py:297-392``: each step one jitted
program over a leading scene axis).  Here each program is a Python
function over static buffers, captured once per static key into a
``torch.cuda.CUDAGraph`` and replayed; the programs, as the JAX
package's:

* ``input_iter``: the input step (the NGP-only loop's iteration);
* ``boot_iter``: the input step, then the bootstrap step;
* a fusion iteration: ``fusion_front`` (the input step, the fusion
  step's full render, the VAE encode and the sampler's q-sample), PLMS
  ``step0``, ``n_steps - 1`` replays of a ``tail`` step (one per
  Adams-Bashforth order: 1, 2, then 3 for every later step), and
  ``fusion_back`` (clip, VAE decode, the fusion step's gradient and
  update).  The JAX package renders twice with one key, once in each of
  its front and back programs; here the back graph's backward runs
  through the front graph's render, whose autograd graph (built at the
  front's capture) stays alive with its saved tensors in the shared
  pool, so a fusion iteration renders once, as the eager step does.
  With ``fusion_rays`` the gradient step renders its ray subset in the
  back program, as in the eager step.

The same programs run one scene (``distill/loop.py``) or S scenes in
lockstep on an ``NGPFieldStack`` (``distill/batched.py``): then the
cameras carry a (S, N) lead, the images, masks and the cache a leading
S, the index buffers and the losses one entry a scene, the sampler's
buffers a leading S at UNet batch S (one K1 launch for all S tables,
K2 at batch S), and ``max_thres`` one value for the batch, which keeps
one PLMS step count, as in the JAX batched loop.

The static key is the program, the render config (two-phase or
marching) and the tail's order; the arm, ``subsample_fusion`` and the
sampler's dtype are fixed for a loop.  Each iteration's inputs reach the
graphs through the loop's index buffers (the input view, the cached
camera: the host draws copied in one transfer from pinned memory),
``max_thres`` and the bitfield; the programs gather the cameras, targets
and features from the scene's and the cache's tensors on the device
(with a scene axis, scene s's row ``bi[s]`` / ``ci[s]``: the JAX batched
loop's ``_pick_cam``).  The sampler's state (latents, the ring of the
three last epsilons, the times from ``max_thres``, the step index, the
fusion weight) lives in buffers made at a program's first run, which is
eager.

The graphs run through ``utils/graphs.py::GraphRunner``, which the
train step's graphs share.  On a CUDA device a key's first run is
eager, on a side stream: it is the iteration's real work and the
warm-up that builds the kernels, the optimizer's state and the
libraries' handles.  Its second run captures
(the loop's generator registered with the graph, so that every replay
draws fresh numbers, in the order the eager steps draw them) and then
replays; later runs replay.  Each graph has a memory pool of its own:
with one pool shared by all graphs, an eager warm-up run between the
front program's replay and the back program's overwrote the front's
render, which the back graph reads (PyTorch 2.11 on an H100); with a
pool a graph, nothing outside a graph writes its memory.  A capture or
replay that fails raises: there is no eager fallback.  The
kernels' launch counters and the UNet evaluations count in Python, so
each graph records what its capture counted and adds it at each
replay.  Elsewhere (the CPU) every run is eager, which is how the
tests hold the fused structure against the unfused loops.  Each
program's run is the span recorder's ``graph/<key>`` span, with the
models', renders' and optimizer's spans under it; as a graph, those are
captured once as its template and their device stamps replayed
(``utils/spans.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import Cameras, pick_per_scene
from sparsefusion_tpu_torch.diffusion.plms import (
    eps_fn,
    host_schedule,
    plms_prologue,
    plms_schedule,
    plms_step0,
    plms_tail_step,
)
from sparsefusion_tpu_torch.utils import spans
from sparsefusion_tpu_torch.utils.graphs import (
    GraphRunner,
    capturing,
    key_name,
    launch_counters,
)


class FusedIterations:
    """The fused programs of one scene's loop, or of S scenes' in lockstep
    (``SceneSteps`` of one scene or of an ``NGPFieldStack``, its
    generator, the scene's relative cameras, images and masks, the Phase A
    cache or None, the loop's bitfield buffer or None).  The cache's
    ``cameras_vox`` is one ``Cameras`` with an (M,) lead.  With a scene
    axis the cameras have a (S, N) lead and the cache's a (S, M) lead
    (``core/cameras.py::stack_cameras``), the images, masks and the
    cache's tensors a leading S, and each program gathers scene s's row
    ``bi[s]`` / ``ci[s]``."""

    def __init__(self, steps, generator: torch.Generator, scene_vox: Cameras,
                 scene_rgb: torch.Tensor, scene_mask: Optional[torch.Tensor],
                 feature_cache=None, bitfield: Optional[torch.Tensor] = None):
        self.steps = steps
        self.cfg = steps.cfg
        self.models = steps.models
        self.scene_axis = steps.scene_axis
        self.generator = generator
        self.scene_vox, self.scene_rgb = scene_vox, scene_rgb
        self.scene_mask = scene_mask
        self.bitfield = bitfield
        dev = scene_rgb.device
        self.runner = GraphRunner(dev, generator,
                                  launch_counters(self.models))
        # the iteration's host draws as device indices, one a scene (the
        # input view, the cached camera), and one float64 noise level
        n = self.scene_axis[0] if self.scene_axis else 1
        self.draws = torch.zeros((2, n), dtype=torch.int64, device=dev)
        self.bi, self.ci = self.draws
        self.mt = torch.zeros((), dtype=torch.float64, device=dev)
        self.loss = torch.zeros(self.scene_axis, device=dev)
        self.floss = torch.zeros(self.scene_axis, device=dev)
        self.buffers: Dict[object, torch.Tensor] = {}
        # the front program's render (image, silhouette) with its autograd
        # graph, by render config, for the back program
        self.rendered: Dict[object, tuple] = {}
        if feature_cache is not None:
            self.cams_f = feature_cache["cameras_vox"]
            self.features = feature_cache["features"]
            self.eft_images = feature_cache["eft_images"]
            if self.cfg.sampler_bf16:
                # the sampler's bf16 UNet is made before any capture
                self.models.unet_half()

    def _pick(self, a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Row ``idx`` of ``a`` as a batch of one; with a scene axis, row
        ``idx[s]`` of ``a[s]`` for each scene: (S, ...)."""
        if self.scene_axis:
            return pick_per_scene(a, idx)
        return a.index_select(0, idx)

    def _cams(self, cams: Cameras, idx: torch.Tensor) -> Cameras:
        return Cameras(*(self._pick(getattr(cams, f.name), idx)
                         for f in dataclasses.fields(Cameras)))

    def _image(self, a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return self.steps._unbatch(self._pick(a, idx))

    def _buffer(self, name, like: torch.Tensor) -> torch.Tensor:
        """The static buffer ``name``, made like ``like`` at the first
        (eager) run of the program that writes it."""
        buf = self.buffers.get(name)
        if buf is None:
            if capturing():
                raise RuntimeError(f"buffer {name!r} first made inside a "
                                   "capture")
            buf = self.buffers[name] = torch.zeros_like(like)
        return buf

    def _randn(self, like: torch.Tensor) -> torch.Tensor:
        return torch.randn(like.shape, generator=self.generator,
                           dtype=like.dtype, device=like.device)

    # ---- the programs: each reads and writes static buffers only -------

    def _input(self, vc, draws=None) -> None:
        gt_mask = None if self.scene_mask is None else \
            self._image(self.scene_mask, self.bi)
        self.loss.copy_(self.steps.input_step(
            vc, self._cams(self.scene_vox, self.bi),
            self._image(self.scene_rgb, self.bi), gt_mask, self.generator,
            draws, self.bitfield))

    def input_iter(self, vc, draws=None) -> None:
        self._input(vc, draws)

    def boot_iter(self, vc, draws=None, boot_draws=None) -> None:
        self._input(vc, draws)
        self.floss.copy_(self.steps.bootstrap_step(
            vc, self._cams(self.cams_f, self.ci),
            self._image(self.eft_images, self.ci), self.generator,
            boot_draws, self.bitfield))

    def _eps(self):
        cfg, models = self.cfg, self.models
        return eps_fn(models.ddpm,
                      functools.partial(models.denoise_fn,
                                        bf16=cfg.sampler_bf16),
                      self.buffers["cond"], cfg.cond_scale)

    def fusion_front(self, vc, draws=None, fusion_draws=None) -> None:
        """The input step; the fusion step's render of the cached camera
        (with gradient, after the update's ``zero_grad``, as the eager
        step takes it; without, when the gradient step takes a ray
        subset); the VAE encode and the sampler's q-sample.
        ``fusion_draws``: the render's ``jitter`` / ``u`` and the
        sampler's ``init_noise``, from the generator where absent."""
        self._input(vc, draws)
        steps, models, fd = self.steps, self.models, fusion_draws or {}
        cam_f = self._cams(self.cams_f, self.ci)
        if steps.subsample_fusion:
            with torch.no_grad():
                img, _ = steps.render_up(vc, cam_f, self.generator, fd,
                                         self.bitfield)
        else:
            steps.optimizer.zero_grad()
            img, sil = steps.render_up(vc, cam_f, self.generator, fd,
                                       self.bitfield)
            # the back program's loss continues this render's autograd
            # graph (in a capture, the graph's saved tensors stay in the
            # pool for the back graph's backward)
            self.rendered[vc] = (img, sil)
        with torch.no_grad():
            latents = models.vae_encode(steps._batch(img.detach()))
            full_start, times = plms_schedule(self.mt, self.cfg.plms_steps)
            noise = fd["init_noise"] if "init_noise" in fd else \
                self._randn(latents)
            x0, _, log_snr = plms_prologue(models.ddpm, latents, self.mt,
                                           full_start, noise)
            cond = self._pick(self.features, self.ci)
            weight = steps._unbatch(1.0 - torch.sigmoid(log_snr))
            for name, value in (("x", x0), ("times", times), ("cond", cond),
                                ("weight", weight)):
                self._buffer(name, value).copy_(value)
            self._buffer("idx", self.bi[:1]).fill_(1)

    @torch.no_grad()
    def step0(self, noises=None) -> None:
        x, times = self.buffers["x"], self.buffers["times"]
        n1, n2 = noises if noises is not None else (self._randn(x),
                                                    self._randn(x))
        x_new, e_t = plms_step0(self.models.ddpm, self._eps(), x, times[0],
                                times[1], n1, n2)
        x.copy_(x_new)
        for k in range(3):
            self._buffer(("hist", k), e_t)
        self.buffers[("hist", 0)].copy_(e_t)

    @torch.no_grad()
    def tail(self, order: int, noise=None) -> None:
        """One later step at the step index buffer's times, of the
        Adams-Bashforth order ``order`` (1, 2, or 3 for AB4)."""
        x, times, idx = (self.buffers[k] for k in ("x", "times", "idx"))
        hist = [self.buffers[("hist", k)] for k in range(3)]
        t = times.index_select(0, idx).reshape(())
        t_next = times.index_select(0, idx + 1).reshape(())
        x_new, e_t = plms_tail_step(
            self.models.ddpm, self._eps(), x, t, t_next, hist[:order],
            noise if noise is not None else self._randn(x))
        x.copy_(x_new)
        hist[2].copy_(hist[1])
        hist[1].copy_(hist[0])
        hist[0].copy_(e_t)
        idx.add_(1)

    def fusion_back(self, vc, draws=None) -> None:
        """The clip, the VAE decode and the fusion step's gradient and
        update: through the front's render, or, with a ray subset, on
        ``fusion_rays`` rays rendered here (``draws``: their
        ``fusion_ray_idx``, ``fusion_jitter``, ``fusion_u``, from the
        generator where absent)."""
        steps, ddpm = self.steps, self.models.ddpm
        with torch.no_grad():
            x = self.buffers["x"]
            if ddpm.config.clip_output:
                x = torch.clamp(x, -ddpm.config.clip_value,
                                ddpm.config.clip_value)
            pred_img = steps._unbatch(self.models.vae_decode(x))
        weight = self.buffers["weight"]
        if steps.subsample_fusion:
            loss = steps.update(steps.fusion_subset_losses, vc,
                                self._cams(self.cams_f, self.ci), pred_img,
                                weight, self.generator, draws, self.bitfield)
        else:
            img, sil = self.rendered[vc]
            # a captured backward keeps the render's graph: its replays
            # read the saved tensors that the front graph's replays write
            loss = steps.apply_update(
                steps.fusion_full_losses(img, sil, pred_img, weight),
                retain_graph=capturing())
        self.floss.copy_(loss)

    # ---- one iteration --------------------------------------------------

    def iteration(self, itr: int, vc, bi, ci=None,
                  mt: Optional[float] = None, fusion: bool = False):
        """Run iteration ``itr`` on the input view ``bi`` and, with the
        diffusion arm, the cached camera ``ci`` and noise level ``mt``;
        returns the loss buffers (the second None without the arm).  With
        a scene axis ``bi`` and ``ci`` hold one index a scene and the
        losses one value a scene; ``mt`` is the batch's.  The buffers hold
        the values until the next iteration."""
        self._load_draws(bi, ci, mt if fusion else None)
        run = self.runner.run
        if ci is None:
            run(("input", vc), functools.partial(self.input_iter, vc), itr)
            return self.loss, None
        if not fusion:
            run(("boot", vc), functools.partial(self.boot_iter, vc), itr)
            return self.loss, self.floss
        _, n_steps, _ = host_schedule(mt, self.cfg.plms_steps)
        run(("front", vc), functools.partial(self.fusion_front, vc), itr)
        if n_steps > 0:
            run(("step0",), self.step0, itr)
        for i in range(1, n_steps):
            order = min(i, 3)
            run(("tail", order), functools.partial(self.tail, order), itr)
        run(("back", vc), functools.partial(self.fusion_back, vc), itr)
        return self.loss, self.floss

    def _load_draws(self, bi, ci, mt=None) -> None:
        """The host draws into the index buffers, in one copy (from pinned
        memory on a CUDA device: no synchronisation), and a fusion
        iteration's noise level into its buffer; the span
        ``distill/draws``."""
        with spans.span("distill/draws"):
            if mt is not None:
                self.mt.fill_(float(mt))
            rows = np.zeros(tuple(self.draws.shape), np.int64)
            rows[0] = bi
            if ci is not None:
                rows[1] = ci
            host = torch.from_numpy(rows)
            if self.runner.graphs:
                host = host.pin_memory()
            self.draws.copy_(host, non_blocking=True)

    def stats(self) -> dict:
        """Warm-ups, captures (key, iteration) and replays; the captures'
        seconds are the recorder's ``capture/<key>`` spans."""
        r = self.runner
        return {"graphs": r.graphs, "warmups": r.warmups,
                "captures": [dict(c, key=key_name(c["key"]))
                             for c in r.captures],
                "replays": r.replays}
