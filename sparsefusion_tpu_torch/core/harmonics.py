"""Harmonic (positional) embeddings.

Counterpart of ``sparsefusion_tpu/core/harmonics.py``: log-spaced
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
    [sin(f_i * x_d) interleaved per input dim, then cos, then x]."""
    freqs = torch.as_tensor(np.asarray(frequencies), dtype=x.dtype,
                            device=x.device)
    embed = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    parts = [embed.sin(), embed.cos()]
    if append_input:
        parts.append(x)
    return torch.cat(parts, dim=-1)


@dataclasses.dataclass(frozen=True)
class HarmonicEmbedding:
    """(..., D) -> (..., D * (2 * n_harmonic_functions + append_input))."""

    n_harmonic_functions: int = 6
    omega_0: float = 1.0
    logspace: bool = True
    append_input: bool = True

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return harmonic_embedding(
            x, harmonic_frequencies(self.n_harmonic_functions, self.omega_0,
                                    self.logspace), self.append_input)
