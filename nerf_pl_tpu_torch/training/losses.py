"""Training losses. Port of nerf_pl_tpu/training/losses.py: mean-squared
error on the coarse rgb plus, when the hierarchical pass runs, the fine
rgb, summed; and mip-NeRF 360's three losses (no JAX counterpart)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def mse_loss(results: Dict[str, torch.Tensor],
             rgbs: torch.Tensor) -> torch.Tensor:
    loss = torch.mean((results["rgb_coarse"] - rgbs) ** 2)
    if "rgb_fine" in results:
        loss = loss + torch.mean((results["rgb_fine"] - rgbs) ** 2)
    return loss


loss_dict = {"mse": mse_loss}


# ------------------------------------------------ mip-NeRF 360's losses
#
# multinerf's train_utils.py, with its means: the Charbonnier colour loss
# on the NeRF level (the proposal levels have no colour), the interlevel
# loss against each proposal level with the NeRF level's (s, w)
# stop-gradient, and the distortion loss on the NeRF level.

F32_EPS = 1.1920928955078125e-07   # np.finfo(np.float32).eps


def charbonnier(rgb: torch.Tensor, target: torch.Tensor,
                padding: float) -> torch.Tensor:
    """mean sqrt((c - c*)^2 + padding^2) over rays and channels."""
    return torch.mean(torch.sqrt((rgb - target) ** 2 + padding * padding))


def interlevel_bound(s: torch.Tensor, s_env: torch.Tensor,
                     w_env: torch.Tensor) -> torch.Tensor:
    """For each interval [s_i, s_{i+1}] of s (R, N + 1), the sum of the
    weights w_env (R, M) of the intervals of s_env (R, M + 1) that overlap
    it (stepfun.inner_outer's outer measure): intervals lo(s_i) to
    hi(s_{i+1}) - 1 by searchsorted, summed over that 0/1 span, whose
    backward is deterministic (a gather's is a scatter of atomic adds,
    which a bitwise replay cannot keep)."""
    m = s_env.shape[-1]
    idx = torch.searchsorted(s_env.contiguous(), s.contiguous(), right=True)
    lo = torch.clamp(idx - 1, min=0)[..., :-1, None]
    hi = torch.clamp(idx, max=m - 1)[..., 1:, None]
    j = torch.arange(m - 1, device=s.device)
    span = (j >= lo) & (j < hi)                            # (R, N, M)
    return torch.sum(span * w_env[..., None, :], dim=-1)


def interlevel_loss(s: torch.Tensor, w: torch.Tensor, s_env: torch.Tensor,
                    w_env: torch.Tensor) -> torch.Tensor:
    """mean over rays and intervals of max(0, w - bound)^2 / (w + eps),
    (s, w) the NeRF level's (held fixed), (s_env, w_env) a proposal
    level's."""
    s, w = s.detach(), w.detach()
    bound = interlevel_bound(s, s_env, w_env)
    return torch.mean(torch.clamp(w - bound, min=0) ** 2 / (w + F32_EPS))


def distortion_loss(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """mean over rays of sum_ij w_i w_j |m_i - m_j| + sum_i w_i^2 (s_{i+1}
    - s_i) / 3, m the intervals' midpoints, the double sum in its O(N)
    form: 2 sum_i w_i (m_i W_<i - (w m)_<i), the midpoints ascending."""
    m = 0.5 * (s[..., 1:] + s[..., :-1])
    wm = w * m
    w_before = torch.cumsum(w, dim=-1) - w
    wm_before = torch.cumsum(wm, dim=-1) - wm
    inter = 2 * torch.sum(w * (m * w_before - wm_before), dim=-1)
    intra = torch.sum(w * w * (s[..., 1:] - s[..., :-1]), dim=-1) / 3
    return torch.mean(inter + intra)


def mip360_loss(out: Dict, rgbs: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {data, interlevel, distortion}) of render_levels' output
    against the target colours, at the configuration's weights."""
    s, w = out["sdist"], out["weights"]
    data = charbonnier(out["rgb"], rgbs, cfg.charb_padding)
    inter = sum(interlevel_loss(s[-1], w[-1], se, we)
                for se, we in zip(s[:-1], w[:-1]))
    dist = distortion_loss(s[-1], w[-1])
    total = data + cfg.interlevel_mult * inter + cfg.distortion_mult * dist
    return total, {"data": data, "interlevel": inter, "distortion": dist}
