"""Faults planted in the program under test, for the check's own tests:
with one planted, a run of the cell has to come out not correct.

* ``unchanged``: every optimizer step returns the state unchanged
  (``torch.optim.Adam.step`` does nothing);
* ``half_batch``: half of the batch left out and the mean taken over the
  rest: in training, the DDPM loss over the first half of the diffusion
  batch; in distillation, every loss's mean over the first half of its
  rays (``SceneSteps._mean``).

The cells run on one chip and serve no tokens or answers, so the faults
of an exchange between chips and of an altered answer have no place.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch")


@contextlib.contextmanager
def planted(name: str):
    import torch

    from sparsefusion_tpu_torch.diffusion.ddpm import DDPM
    from sparsefusion_tpu_torch.distill.loop import SceneSteps

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif name == "half_batch":
        p_losses = DDPM.p_losses

        def half_p_losses(self, denoise_fn, x_start, times, *args, **kw):
            h = x_start.shape[0] // 2
            for key in ("cond_images", "loss_mask", "noise", "keep_mask"):
                if kw.get(key) is not None:
                    kw[key] = kw[key][:h]
            return p_losses(self, denoise_fn, x_start[:h], times[:h],
                            *args, **kw)

        def half_mean(self, x):
            flat = x.reshape(-1)
            return flat[:max(1, flat.numel() // 2)].mean()

        patch(DDPM, "p_losses", half_p_losses)
        patch(SceneSteps, "_mean", half_mean)
    else:
        raise ValueError(f"no fault {name!r} ({FAULTS})")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
