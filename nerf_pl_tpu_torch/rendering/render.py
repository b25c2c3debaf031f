"""Volume rendering at test time: stratified depths, quadrature, hierarchical
resampling.

Port of nerf_pl_tpu/rendering/render.py for the configuration the eval
path uses: `test_time=True, perturb=0, noise_std=0`, with the coarse pass
sigma-only. Both branches are here:
  * fused (`cfg.fused`): `fused_sigma_render` -> `sample_pdf` ->
    `fused_render_eval`, the two CUDA kernels on a GPU;
  * unfused: embed + `nerf_apply` + `volume_quadrature`, plain PyTorch.
Training (perturb, sigma noise, the fused training kernels) and occupancy
placement are not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch

from ..models.embedding import EmbeddingConfig, embed
from ..models.nerf import NeRFConfig, nerf_apply
from ..ops.fused_render import fused_render_eval, fused_sigma_render
from ..ops.sample_pdf import sample_pdf

_TRAINING_ITEM = ("training renders (perturb, noise_std, fused_train, "
                  "fused_loss, occupancy placement) are ROADMAP items A2-A5")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model-family config: MLP architecture + both embeddings."""
    nerf: NeRFConfig = NeRFConfig()
    emb_xyz: EmbeddingConfig = EmbeddingConfig(3, 10)
    emb_dir: EmbeddingConfig = EmbeddingConfig(3, 4)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering config; the same fields as the JAX package's."""
    N_samples: int = 64
    N_importance: int = 0
    use_disp: bool = False
    perturb: float = 0.0
    noise_std: float = 0.0
    white_back: bool = False
    test_time: bool = False
    compute_dtype: Any = torch.float32
    fused: bool = False
    fused_train: bool = False
    fused_loss: bool = False
    occ_keepalive: float = 0.0


def volume_quadrature(sigmas: torch.Tensor,
                      z_vals: torch.Tensor,
                      dir_norms: torch.Tensor,
                      noise: Optional[torch.Tensor],
                      rgbs: Optional[torch.Tensor],
                      white_back: bool) -> Dict[str, torch.Tensor]:
    """Quadrature of the volume-rendering integral along each ray: deltas
    with an infinite last interval scaled by the direction norm, alpha =
    1 - exp(-delta * relu(sigma + noise)), transmittance by the exclusive
    cumprod of (1 - alpha + 1e-10), weighted rgb/depth sums, optional white
    background.

    Returns 'weights' (R, S) and 'opacity' (R,), plus 'rgb' (R, 3) and
    'depth' (R,) when rgbs (R, S, 3) is given."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)],
                       dim=-1) * dir_norms
    if noise is not None:
        sigmas = sigmas + noise
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas + 1e-10], dim=-1)
    transmittance = torch.cumprod(shifted, dim=-1)[:, :-1]
    weights = alphas * transmittance
    opacity = weights.sum(dim=-1)

    out = {"weights": weights, "opacity": opacity}
    if rgbs is not None:
        rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
        out["depth"] = torch.sum(weights * z_vals, dim=-1)
        if white_back:
            rgb = rgb + (1.0 - opacity[..., None])
        out["rgb"] = rgb
    return out


def _check_ported(cfg: RenderConfig):
    if (not cfg.test_time or cfg.perturb > 0 or cfg.noise_std > 0
            or cfg.fused_train or cfg.fused_loss):
        raise NotImplementedError(
            f"only test-time rendering (test_time=True, perturb=0, "
            f"noise_std=0) is ported; {_TRAINING_ITEM}")


def coarse_z_vals(rays: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(R, N_samples) stratified depths, linear in depth or disparity."""
    near, far = rays[:, 6:7], rays[:, 7:8]
    z_steps = torch.linspace(0.0, 1.0, cfg.N_samples, dtype=rays.dtype,
                             device=rays.device)
    if not cfg.use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    return z_vals.expand(rays.shape[0], cfg.N_samples)


def _fine_z_vals(z_vals, weights, cfg: RenderConfig) -> torch.Tensor:
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, weights[:, 1:-1], cfg.N_importance, det=True)
    return torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values


def render_rays(params: Mapping[str, Any],
                rays: torch.Tensor,
                cfg: RenderConfig,
                mcfg: ModelConfig = ModelConfig()) -> Dict[str, torch.Tensor]:
    """Render a batch of rays through the coarse (+fine) NeRF at test time.

    Args:
      params: {'nerf_coarse': MLP, 'nerf_fine': MLP (iff N_importance > 0)},
        each a {layer: {w, b}} dict or, on the fused branch, a PackedMLP.
      rays: (R, 8) = [origin(3), direction(3), near(1), far(1)].

    Returns opacity_coarse, and rgb_fine/depth_fine/opacity_fine when
    N_importance > 0, keyed like the JAX package.
    """
    _check_ported(cfg)
    z_vals = coarse_z_vals(rays, cfg).contiguous()

    if cfg.fused:
        weights_c, opacity_c = fused_sigma_render(params["nerf_coarse"],
                                                  rays, z_vals)
        result = {"opacity_coarse": opacity_c}
        if cfg.N_importance > 0:
            z_all = _fine_z_vals(z_vals, weights_c, cfg).contiguous()
            fine = fused_render_eval(params["nerf_fine"], rays, z_all,
                                     white_back=cfg.white_back)
            result["rgb_fine"] = fine["rgb"]
            result["depth_fine"] = fine["depth"]
            result["opacity_fine"] = fine["opacity"]
        return result

    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    dir_norms = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    sigma = nerf_apply(params["nerf_coarse"], embed(xyz, mcfg.emb_xyz),
                       None, mcfg.nerf, sigma_only=True,
                       compute_dtype=cfg.compute_dtype)
    coarse = volume_quadrature(sigma[..., 0], z_vals, dir_norms, None, None,
                               cfg.white_back)
    result = {"opacity_coarse": coarse["opacity"]}
    if cfg.N_importance > 0:
        z_all = _fine_z_vals(z_vals, coarse["weights"], cfg)
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
        dir_emb = embed(rays_d, mcfg.emb_dir)
        rgbs, sigma = nerf_apply(params["nerf_fine"], embed(xyz, mcfg.emb_xyz),
                                 dir_emb[:, None, :], mcfg.nerf,
                                 sigma_only=False,
                                 compute_dtype=cfg.compute_dtype)
        fine = volume_quadrature(sigma[..., 0], z_all, dir_norms, None, rgbs,
                                 cfg.white_back)
        result["rgb_fine"] = fine["rgb"]
        result["depth_fine"] = fine["depth"]
        result["opacity_fine"] = fine["opacity"]
    return result


def render_rays_chunked(params: Mapping[str, Any],
                        rays: torch.Tensor,
                        cfg: RenderConfig,
                        mcfg: ModelConfig = ModelConfig(),
                        chunk: int = 4096) -> Dict[str, torch.Tensor]:
    """Render any number of rays in fixed-size chunks; the last chunk is
    padded with zero rays, and the padding is sliced off the outputs."""
    R = rays.shape[0]
    n_chunks = -(-R // chunk)
    pad = n_chunks * chunk - R
    rays_p = torch.cat([rays, rays.new_zeros((pad, rays.shape[1]))])
    outs = [render_rays(params, rays_p[i * chunk:(i + 1) * chunk], cfg, mcfg)
            for i in range(n_chunks)]
    return {k: torch.cat([o[k] for o in outs])[:R] for k in outs[0]}
