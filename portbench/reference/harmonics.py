"""Harmonic (positional) embeddings.

Frozen copy of the port's ``core/harmonics.py`` (the JAX ``sparsefusion_tpu/core/harmonics.py``'s counterpart): log-spaced
frequencies, the sin block, then the cos block, then the input.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def harmonic_frequencies(n_harmonic_functions: int = 6, omega_0: float = 1.0,
                         logspace: bool = True) -> np.ndarray:
    if logspace:
        freqs = 2.0 ** np.arange(n_harmonic_functions, dtype=np.float32)
    else:
        freqs = np.linspace(1.0, 2.0 ** (n_harmonic_functions - 1),
                            n_harmonic_functions, dtype=np.float32)
    return freqs * omega_0


def harmonic_embedding(x: torch.Tensor, frequencies,
                       append_input: bool = True) -> torch.Tensor:
    """Embed ``x`` (..., D) -> (..., D * (2 * n_freqs + append_input)):
    [sin(f_i * x_d) interleaved per input dim, then cos, then x].
    ``frequencies``: an array, or a tensor (used as it is where it has
    ``x``'s device and dtype)."""
    if not isinstance(frequencies, torch.Tensor):
        frequencies = torch.as_tensor(np.asarray(frequencies))
    freqs = frequencies.to(dtype=x.dtype, device=x.device)
    embed = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    parts = [embed.sin(), embed.cos()]
    if append_input:
        parts.append(x)
    return torch.cat(parts, dim=-1)


@dataclasses.dataclass(frozen=True)
class HarmonicEmbedding:
    """(..., D) -> (..., D * (2 * n_harmonic_functions + append_input)).
    The frequencies are made once for each device and dtype: a copy from
    the host on every call could not be captured in a CUDA graph."""

    n_harmonic_functions: int = 6
    omega_0: float = 1.0
    logspace: bool = True
    append_input: bool = True
    _freqs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        key = (x.device, x.dtype)
        if key not in self._freqs:
            self._freqs[key] = torch.as_tensor(
                harmonic_frequencies(self.n_harmonic_functions,
                                     self.omega_0, self.logspace),
                dtype=x.dtype, device=x.device)
        return harmonic_embedding(x, self._freqs[key], self.append_input)
