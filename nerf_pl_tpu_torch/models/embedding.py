"""Sinusoidal positional encoding gamma(x) = (x, sin(2^k x), cos(2^k x), ...).

Port of nerf_pl_tpu/models/embedding.py: the same channel order
[x, sin f0 x, cos f0 x, sin f1 x, ...] with each term of width C, so the
weights of the two packages line up row for row.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    """Embedding hyperparameters."""
    in_channels: int = 3
    N_freqs: int = 10
    logscale: bool = True

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 * self.N_freqs + 1)

    def freq_bands(self) -> np.ndarray:
        if self.logscale:
            return 2.0 ** np.linspace(0, self.N_freqs - 1, self.N_freqs)
        return np.linspace(1, 2.0 ** (self.N_freqs - 1), self.N_freqs)


@functools.lru_cache(maxsize=None)
def _freqs(cfg: EmbeddingConfig, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """The frequency bands on `device`, copied there once: a CUDA graph
    cannot capture a copy from the host, and reads this tensor's address
    on every replay."""
    return torch.as_tensor(cfg.freq_bands(), dtype=dtype, device=device)


def embed(x: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    """Embed x (..., C) -> (..., C * (2*N_freqs + 1))."""
    freqs = _freqs(cfg, x.dtype, x.device)
    xb = x[..., None, :] * freqs[:, None]                 # (..., F, C)
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., F, 2, C)
    sc = sc.reshape(*x.shape[:-1], 2 * cfg.N_freqs * cfg.in_channels)
    return torch.cat([x, sc], dim=-1)
