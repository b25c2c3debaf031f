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


# ------------------------------------------------ mip-NeRF 360's encoding
#
# A sample of mip-NeRF 360 is a conical frustum along a ray o + t d (d not
# normalised), between t0 and t1, of base radius r (the pixel's radius at
# t = 1). Its Gaussian (mip-NeRF's eq. 7, the stable form) has the mean
# o + mu_t d and the covariance sigma_t^2 d d^T + sigma_r^2 (I - d d^T /
# |d|^2). The scene is contracted into a ball of radius 2, the Gaussian
# linearised through the contraction (mean contract(mu), covariance
# J Sigma J^T, J its Jacobian at mu), and its axis-aligned integrated
# positional encoding taken over degrees [min_deg, max_deg). Everything
# here is float32 and carries no gradient in training (the samples'
# positions are stop-gradient).

def frustum_moments(t0: torch.Tensor, t1: torch.Tensor,
                    radii: torch.Tensor):
    """(mu_t, sigma_t^2, sigma_r^2) of the frustums [t0, t1] (..., S) of
    rays of base radius `radii` (..., 1)."""
    mu = 0.5 * (t0 + t1)
    hw = 0.5 * (t1 - t0)
    mu2, hw2 = mu * mu, hw * hw
    den = 3 * mu2 + hw2
    t_mean = mu + (2 * mu * hw2) / den
    t_var = hw2 / 3 - (4.0 / 15.0) * (hw2 * hw2 * (12 * mu2 - hw2)) / (
        den * den)
    r_var = radii * radii * (mu2 / 4 + (5.0 / 12.0) * hw2
                             - (4.0 / 15.0) * (hw2 * hw2) / den)
    return t_mean, t_var, r_var


def contract(x: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360's contraction: x inside the unit ball, else
    (2 - 1/|x|) x/|x| (the L2 norm)."""
    eps = torch.finfo(torch.float32).eps
    m2 = torch.clamp((x * x).sum(-1, keepdim=True), min=eps)
    return torch.where(m2 <= 1, x, ((2 * torch.sqrt(m2) - 1) / m2) * x)


def contract_jacobian(x: torch.Tensor) -> torch.Tensor:
    """The contraction's Jacobian at x (..., 3): I inside the unit ball,
    else b I + (a - b) x^ x^T with a = 1/|x|^2 and b = (2 - 1/|x|)/|x|."""
    eps = torch.finfo(torch.float32).eps
    m2 = torch.clamp((x * x).sum(-1, keepdim=True), min=eps)
    r = torch.sqrt(m2)
    xh = x / r
    a, b = 1 / m2, (2 - 1 / r) / r
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    outside = (b[..., None] * eye + (a - b)[..., None]
               * xh[..., :, None] * xh[..., None, :])
    return torch.where((m2 <= 1)[..., None], eye.expand_as(outside),
                       outside)


def contracted_gaussian(o: torch.Tensor, d: torch.Tensor,
                        t_mean: torch.Tensor, t_var: torch.Tensor,
                        r_var: torch.Tensor):
    """The frustum Gaussians of rays (o, d) (..., 3), pushed through the
    contraction: (contract(mean) (..., S, 3), diag(J Sigma J^T) (..., S,
    3)). Sigma = r_var I + (t_var - r_var / |d|^2) d d^T, so with J = b I +
    (a - b) x^ x^T the diagonal is closed-form: no 3x3 is formed."""
    eps = torch.finfo(torch.float32).eps
    d = d[..., None, :]
    mean = o[..., None, :] + d * t_mean[..., None]
    dd = torch.clamp((d * d).sum(-1), min=1e-10)
    beta = t_var - r_var / dd                     # Sigma's d d^T weight
    m2 = torch.clamp((mean * mean).sum(-1), min=eps)
    r = torch.sqrt(m2)
    xh = mean / r[..., None]
    a, b = 1 / m2, (2 - 1 / r) / r
    inside = m2 <= 1
    a = torch.where(inside, torch.ones_like(a), a)
    b = torch.where(inside, torch.ones_like(b), b)
    c = a - b
    # v = Sigma x^, q = x^T Sigma x^
    dx = (d * xh).sum(-1)
    v = r_var[..., None] * xh + (beta * dx)[..., None] * d
    q = r_var + beta * dx * dx
    diag_sigma = r_var[..., None] + beta[..., None] * d * d
    var = (b * b)[..., None] * diag_sigma \
        + (2 * b * c)[..., None] * v * xh + (c * c * q)[..., None] * xh * xh
    mean_c = torch.where(inside[..., None], mean,
                         ((2 * r - 1) / m2)[..., None] * mean)
    return mean_c, var


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                       max_deg: int) -> torch.Tensor:
    """Axis-aligned IPE: [sin(2^l mean) exp(-4^l var / 2), then the cos
    terms], each block ordered degree-major, coordinate-minor (multinerf's
    order); 2 * 3 * (max_deg - min_deg) wide."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    sm = (mean[..., None, :] * scales[:, None]).reshape(shape)
    sv = (var[..., None, :] * (scales * scales)[:, None]).reshape(shape)
    damp = torch.exp(-0.5 * sv)
    return torch.cat([damp * torch.sin(sm), damp * torch.cos(sm)], dim=-1)


def pos_enc(x: torch.Tensor, deg: int) -> torch.Tensor:
    """[x, sin(2^l x), then the cos terms] over degrees [0, deg), each block
    degree-major (multinerf's order with its identity): 3 + 6 deg wide."""
    scales = 2.0 ** torch.arange(0, deg, dtype=x.dtype, device=x.device)
    sx = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(sx), torch.cos(sx)], dim=-1)
