"""mip-NeRF 360's sampler and volume rendering: three levels along each
ray, in normalised s-space.

Depths live in s in [0, 1], with t = g^-1(s g(far) + (1 - s) g(near)) and
g(t) = 1/t (multinerf's `construct_ray_warps` with raydist_fn
reciprocal), near and far each ray's own (rays[:, 6:8]). Level 0 starts from the single interval [0, 1] of weight 1;
each level draws its samples by the inverse CDF of the previous level's
step function (interval i holding mass w_i), with one jitter a ray
(single jitter; a test-time render takes the deterministic centres), and
its new endpoints are the midpoints of adjacent samples, the outer two
extrapolated and clamped to [0, 1] (`stepfun.sample_intervals`). The
endpoints are stop-gradient. Levels 0 and 1 run the proposal MLP (64
samples each), level 2 the NeRF MLP (32). A level's interval i has
delta_i = (t_{i+1} - t_i) |d|, alpha = 1 - exp(-density delta) with the
last delta infinite (an opaque background), and weights alpha times the
transmittance exp(-cumsum) (no cumprod: nothing reads back to the host,
so a CUDA graph captures it).

The training render's phases are marks of utils/profiling.py: `prop0`
(level 0's samples, encoding and proposal forward), `resample1` (the
inverse CDF), `prop1`, `resample2`, `nerf` (the encoding, the NeRF MLP's
forward and the quadrature).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models.embedding import (contracted_gaussian, frustum_moments,
                                integrated_pos_enc, pos_enc)
from ..models.mipnerf360 import MipConfig, nerf_apply, prop_apply
from ..utils import profiling as P

EPS = float(np.finfo(np.float32).eps)


@dataclasses.dataclass
class MipDraws:
    """The random draws of one training step: jitter (R, 3) uniform in
    [0, 1), one a ray for each level's samples."""
    jitter: Optional[torch.Tensor] = None


def s_to_t(s: torch.Tensor, near: torch.Tensor, far: torch.Tensor
           ) -> torch.Tensor:
    """Metric distance along the ray of normalised s (near, far (R, 1))."""
    s_near, s_far = 1.0 / near, 1.0 / far
    return 1.0 / (s * s_far + (1 - s) * s_near)


def _interp(u: torch.Tensor, cw: torch.Tensor, s: torch.Tensor
            ) -> torch.Tensor:
    """Piecewise-linear interpolation of (cw, s) at u (cw ascending; u
    past either end takes the end's value)."""
    idx = torch.searchsorted(cw, u.contiguous(), right=True)
    hi = torch.clamp(idx, max=cw.shape[-1] - 1)
    lo = torch.clamp(idx - 1, min=0)
    c0, c1 = torch.gather(cw, -1, lo), torch.gather(cw, -1, hi)
    s0, s1 = torch.gather(s, -1, lo), torch.gather(s, -1, hi)
    off = torch.nan_to_num((u - c0) / (c1 - c0), 0.0).clamp(0, 1)
    return s0 + off * (s1 - s0)


def resample(sdist: torch.Tensor, weights: torch.Tensor, n: int,
             jitter: Optional[torch.Tensor]) -> torch.Tensor:
    """n new intervals (R, n + 1 endpoints) by the inverse CDF of the step
    function (sdist (R, K + 1), weights (R, K)): `jitter` (R, 1) uniform
    in [0, 1) moves all of a ray's samples together; None takes the
    centres. Stop-gradient."""
    sdist, weights = sdist.detach(), weights.detach()
    R = sdist.shape[0]
    dev = sdist.device
    w = weights / weights.sum(-1, keepdim=True)
    cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
    cw = torch.cat([torch.zeros_like(w[..., :1]), cw,
                    torch.ones_like(w[..., :1])], dim=-1)
    if jitter is None:
        pad = 1.0 / (2 * n)
        u = torch.linspace(pad, 1.0 - pad - EPS, n, device=dev).expand(R, n)
    else:
        u_max = EPS + (1 - EPS) / n
        max_jitter = (1 - u_max) / (n - 1) - EPS
        u = torch.linspace(0.0, 1 - u_max, n, device=dev) \
            + jitter * max_jitter
    centers = _interp(u, cw, sdist)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=0.0)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=1.0)
    return torch.cat([first, mid, last], dim=-1)


def alpha_weights(density: torch.Tensor, tdist: torch.Tensor,
                  dir_norm: torch.Tensor) -> torch.Tensor:
    """The quadrature's weights (R, S) of densities over intervals tdist
    (R, S + 1), the last interval infinite."""
    delta = (tdist[..., 1:] - tdist[..., :-1]) * dir_norm
    dd = density * delta
    dd = torch.cat([dd[..., :-1], torch.full_like(dd[..., -1:],
                                                  float("inf"))], dim=-1)
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]),
                                  torch.cumsum(dd[..., :-1], dim=-1)],
                                 dim=-1))
    return alpha * trans


def encode(rays: torch.Tensor, radii: torch.Tensor, sdist: torch.Tensor,
           cfg: MipConfig) -> torch.Tensor:
    """The IPE (R * S, 72) of the intervals sdist (R, S + 1) of rays (R,
    8) with pixel radii (R,), and their metric endpoints (R, S + 1)."""
    tdist = s_to_t(sdist, rays[:, 6:7], rays[:, 7:8])
    t_mean, t_var, r_var = frustum_moments(tdist[..., :-1], tdist[..., 1:],
                                           radii[:, None])
    mean, var = contracted_gaussian(rays[:, 0:3], rays[:, 3:6], t_mean,
                                    t_var, r_var)
    enc = integrated_pos_enc(mean, var, cfg.min_deg_point,
                             cfg.max_deg_point)
    return enc.reshape(-1, enc.shape[-1]), tdist


def render_levels(params, rays: torch.Tensor, radii: torch.Tensor,
                  cfg: MipConfig, jitter: Optional[torch.Tensor] = None
                  ) -> Dict[str, object]:
    """The three levels over rays (R, 8) with radii (R,): jitter (R, 3)
    uniform in [0, 1) (training; None: the deterministic centres).
    Returns {sdist: [3 x (R, S + 1)], weights: [3 x (R, S)], rgb (R, 3),
    distance (R,)} (rgb and distance of the NeRF level; distance the
    weights' mean of the intervals' metric midpoints)."""
    R, dev = rays.shape[0], rays.device
    dir_norm = torch.linalg.norm(rays[:, 3:6], dim=-1, keepdim=True)

    sdist = torch.cat([torch.zeros((R, 1), device=dev),
                       torch.ones((R, 1), device=dev)], dim=-1)
    weights = torch.ones((R, 1), device=dev)
    out: Dict[str, object] = {"sdist": [], "weights": []}
    counts = list(cfg.num_prop_samples) + [cfg.num_nerf_samples]
    for level, n in enumerate(counts):
        j = None if jitter is None else jitter[:, level:level + 1]
        last = level == len(counts) - 1
        if level:
            with P.phase(f"resample{level}", dev):
                sdist = resample(sdist, weights, n, j)
        with P.phase("nerf" if last else f"prop{level}", dev):
            if not level:
                sdist = resample(sdist, weights, n, j)
            enc, tdist = encode(rays, radii, sdist, cfg)
            if not last:
                density = prop_apply(params["prop_mlp"], enc, cfg)
                weights = alpha_weights(density.reshape(R, n), tdist,
                                        dir_norm)
            else:
                d_enc = pos_enc(rays[:, 3:6] / dir_norm, cfg.deg_view)
                d_enc = d_enc[:, None, :].expand(R, n, d_enc.shape[-1])
                density, rgb = nerf_apply(params["nerf_mlp"], enc,
                                          d_enc.reshape(R * n, -1), cfg)
                weights = alpha_weights(density.reshape(R, n), tdist,
                                        dir_norm)
                acc = weights.sum(-1, keepdim=True)
                # an opaque background: acc is 1 but for rounding
                out["rgb"] = (weights[..., None] * rgb.reshape(R, n, 3)
                              ).sum(-2) + torch.clamp(1 - acc, min=0)
                t_mid = 0.5 * (tdist[..., 1:] + tdist[..., :-1])
                out["distance"] = (weights * t_mid).sum(-1)
        out["sdist"].append(sdist)
        out["weights"].append(weights)
    return out


def render_chunked(params, rays: torch.Tensor, radii: torch.Tensor,
                   cfg: MipConfig, chunk: int) -> Dict[str, torch.Tensor]:
    """A test-time render (the deterministic centres, no gradient) in
    chunks of rays: {rgb_fine, depth_fine} (the NeRF level, the finest,
    under the names the NeRF CLIs read)."""
    outs = []
    with torch.no_grad():
        for s in range(0, rays.shape[0], chunk):
            o = render_levels(params, rays[s:s + chunk], radii[s:s + chunk],
                              cfg)
            outs.append({"rgb_fine": o["rgb"], "depth_fine": o["distance"]})
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def make_render_fn(cfg: MipConfig, chunk: int, device: torch.device):
    """render(params, rays, radii) -> numpy {rgb_fine, depth_fine} of a
    whole image on `device`, as parallel/render.make_render_fn's NeRF
    renderer returns them."""
    def render(params, rays, radii):
        p = {m: {l: {k: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
                     for k, v in leaf.items()}
                 for l, leaf in layers.items()}
             for m, layers in params.items()}
        out = render_chunked(
            p, torch.as_tensor(np.asarray(rays), dtype=torch.float32,
                               device=device),
            torch.as_tensor(np.asarray(radii), dtype=torch.float32,
                            device=device), cfg, chunk)
        return {k: v.cpu().numpy() for k, v in out.items()}
    return render
