"""Hierarchical (inverse-CDF) importance sampling.

Port of nerf_pl_tpu/ops/sample_pdf.py, which is plain XLA and no kernel.
The JAX version brackets u with a comparison matrix because a branchy
search is the wrong shape for a TPU; here `torch.searchsorted` (side
'right') finds the same bracket, since the cdf is non-decreasing.

Semantics kept: weights += eps, an exclusive-zero-padded cdf, u from
linspace (det) or a generator or an explicit override, the clamp to the
last entry when u >= cdf[-1], and denom < eps -> 1.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_pdf(bins: torch.Tensor,
               weights: torch.Tensor,
               N_importance: int,
               det: bool,
               generator: Optional[torch.Generator] = None,
               eps: float = 1e-5,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw N_importance samples per ray from the piecewise-constant pdf.

    Args:
      bins: (N_rays, N_bins+1) bin edges.
      weights: (N_rays, N_bins) unnormalized bin weights.
      det: evenly spaced u (linspace(0, 1)) instead of uniform draws.
      generator: drives the uniform draws when det is False.
      u: optional explicit (N_rays, N_importance) CDF positions, overriding
        det and generator.

    Returns: (N_rays, N_importance) sample positions, without gradient.
    """
    N_rays, N_bins = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (R, B+1)

    if u is not None:
        u = u.to(cdf.dtype).expand(N_rays, N_importance)
    elif det:
        u = torch.linspace(0.0, 1.0, N_importance, dtype=cdf.dtype,
                           device=cdf.device).expand(N_rays, N_importance)
    else:
        u = torch.rand((N_rays, N_importance), generator=generator,
                       dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()

    # inds = count of cdf entries <= u, in [1, B+1] because cdf[0] = 0.
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=N_bins)      # none above -> the last entry
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    bins_b = torch.gather(bins, 1, below)
    bins_a = torch.gather(bins, 1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return (bins_b + (u - cdf_b) / denom * (bins_a - bins_b)).detach()
