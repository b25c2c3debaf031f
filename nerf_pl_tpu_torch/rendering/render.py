"""Volume rendering: stratified depths, quadrature, hierarchical
resampling, at test time and at train time.

Port of nerf_pl_tpu/rendering/render.py:
  * test time, fused, no perturb and no noise: `fused_sigma_render` ->
    `sample_pdf` -> `fused_render_eval`, the two render kernels on a GPU;
  * everything else goes through `_evaluate_field` per pass and the plain,
    differentiable `volume_quadrature`. With `cfg.fused` the MLP is the
    fused point MLP (`nerf_apply_fused`, its forward and backward kernels on
    a GPU, differentiable by autograd; `nerf_sigma_fused` for a sigma-only
    test-time coarse pass); without it, embed + `nerf_apply`, plain
    PyTorch, the reference for the training step as a whole;
  * train time with `cfg.fused_train`: one `fused_train_render` per pass
    (its forward kernel on a GPU, and its backward kernel when autograd
    differentiates the step), for any loss;
  * `fused_mse_train_step`: the loss-fused training step, one
    `fused_mse_render` (the training kernel on a GPU) per pass, gradients
    out of the kernel instead of autograd.
With a per-ray segment mask (`occm`, `n_seg`: occupancy-tightened
training) the coarse depths come from `occupied_z_vals` instead of
stratified sampling, on every branch.

torch cannot reproduce JAX's random streams, so where JAX splits a key
into (perturb, coarse noise, importance u, fine noise), these functions
take a `torch.Generator` and optional explicit draws (`TrainDraws`): the
perturb uniforms, the standard-normal sigma noise of each pass and the
importance `u`. A draw that is not given comes from the generator, in that
order, on the rays' device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional

import torch

from ..models.embedding import EmbeddingConfig, embed
from ..models.nerf import NeRFConfig, nerf_apply
from ..ops.fused_mlp import (nerf_apply_fused, nerf_sigma_fused, pack_params,
                             unpack_grads)
from ..ops.fused_render import fused_render_eval, fused_sigma_render
from ..ops.fused_train import fused_mse_render, fused_train_render
from ..ops.sample_pdf import sample_pdf


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


@dataclasses.dataclass
class TrainDraws:
    """Explicit random draws of one render (each optional):
    perturb (R, N_samples) and u (R, N_importance) uniform in [0, 1);
    noise_coarse (R, N_samples) and noise_fine (R, N_samples +
    N_importance) standard normal (scaled by cfg.noise_std here)."""
    perturb: Optional[torch.Tensor] = None
    noise_coarse: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    noise_fine: Optional[torch.Tensor] = None

    def take(self, name: str, shape, generator, device) -> torch.Tensor:
        given = getattr(self, name)
        if given is not None:
            return given.to(device=device, dtype=torch.float32)
        draw = torch.rand if name in ("perturb", "u") else torch.randn
        return draw(shape, generator=generator, device=device)


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


def coarse_z_vals(rays: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(R, N_samples) stratified depths, linear in depth or disparity."""
    near, far = rays[:, 6:7], rays[:, 7:8]
    # jnp.linspace's rounding, i * f32(1 / (N - 1)) and an exact 1 at the
    # end: torch.linspace rounds otherwise, and the 2^9 embedding
    # frequencies see one ulp of depth
    N = cfg.N_samples
    z_steps = torch.arange(N, dtype=rays.dtype, device=rays.device) * (
        1.0 / max(N - 1, 1))
    if N > 1:
        z_steps[-1] = 1.0
    if not cfg.use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    return z_vals.expand(rays.shape[0], cfg.N_samples)


def occupied_z_vals(rays: torch.Tensor, occm: torch.Tensor, n_seg: int,
                    N_samples: int, perturb: float,
                    uniform: Optional[torch.Tensor],
                    keepalive: float = 0.0) -> torch.Tensor:
    """Coarse depths concentrated in occupied space: each ray's [near, far]
    is split into ``n_seg`` equal segments, and the depths are a
    stratified inverse CDF over the density "occupied = 1, empty = eps"
    that the bit mask ``occm`` (occupancy.py ray_box_segment_bits) gives.
    The strata ascend, so the depths come out sorted.

    perturb = 0 takes the strata's midpoints; perturb > 0 moves each by
    ``uniform`` ((R, N_samples) in [0, 1), the "perturb" draw).
    ``keepalive`` in [0, 1) spreads that share of the mass over ALL
    segments (weight (1 - k) * bit / n_occ + k / n_seg), so interior gaps
    stay supervised.

    Returns (R, N_samples) ascending depths in [near, far]."""
    from .occupancy import unpack_segment_bits
    R = rays.shape[0]
    near, far = rays[:, 6:7], rays[:, 7:8]
    seg = torch.arange(n_seg + 1, dtype=rays.dtype,
                       device=rays.device) / n_seg
    edges = near * (1.0 - seg) + far * seg             # (R, n_seg + 1)
    bits = unpack_segment_bits(occm, n_seg)            # (R, n_seg)
    if keepalive > 0.0:
        n_occ = torch.clamp(bits.sum(dim=-1, keepdim=True), min=1.0)
        bits = (1.0 - keepalive) * bits / n_occ + keepalive / n_seg
    j = torch.arange(N_samples, dtype=rays.dtype, device=rays.device)
    if perturb > 0:
        xi = perturb * uniform + (1.0 - perturb) * 0.5
    else:
        xi = torch.full((R, N_samples), 0.5, dtype=rays.dtype,
                        device=rays.device)
    u = (j + xi) / N_samples
    return sample_pdf(edges, bits, N_samples, det=True, u=u).contiguous()


def _bin_bounds(z_vals):
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
    lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
    return lower, upper


def _fine_z_vals(z_vals, weights, cfg: RenderConfig,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse and importance depths, sorted; det=True unless u is given."""
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, weights[:, 1:-1].detach(), cfg.N_importance,
                        det=True, u=u)
    return torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values


def _evaluate_field(params, xyz, rays_d, dir_emb, z_vals, dir_norms, noise,
                    cfg: RenderConfig, mcfg: ModelConfig, sigma_only: bool):
    """Run the MLP on the sampled points (the fused point MLP on raw
    points, or embed + nerf_apply), then integrate."""
    if cfg.fused and not sigma_only:
        rgbs, sigma = nerf_apply_fused(params, xyz, rays_d[:, None, :])
    elif cfg.fused:
        sigma = nerf_sigma_fused(params, xyz)
        rgbs = None
    elif sigma_only:
        xyz_emb = embed(xyz, mcfg.emb_xyz)
        sigma = nerf_apply(params, xyz_emb, None, mcfg.nerf, sigma_only=True,
                           compute_dtype=cfg.compute_dtype)
        rgbs = None
    else:
        xyz_emb = embed(xyz, mcfg.emb_xyz)
        rgbs, sigma = nerf_apply(params, xyz_emb, dir_emb[:, None, :],
                                 mcfg.nerf, sigma_only=False,
                                 compute_dtype=cfg.compute_dtype)
    return volume_quadrature(sigma[..., 0], z_vals, dir_norms, noise, rgbs,
                             cfg.white_back)


def render_rays(params: Mapping[str, Any],
                rays: torch.Tensor,
                cfg: RenderConfig,
                mcfg: ModelConfig = ModelConfig(),
                generator: Optional[torch.Generator] = None,
                draws: Optional[TrainDraws] = None,
                occm: Optional[torch.Tensor] = None,
                n_seg: int = 0) -> Dict[str, torch.Tensor]:
    """Render a batch of rays through the coarse (+fine) NeRF.

    Args:
      params: {'nerf_coarse': MLP, 'nerf_fine': MLP (iff N_importance > 0)},
        each a {layer: {w, b}} dict or, with cfg.fused, a PackedMLP
        (inference only: autograd reaches the weights through the dict).
      rays: (R, 8) = [origin(3), direction(3), near(1), far(1)].
      generator, draws: the random draws of perturb and sigma noise (see
        the module docstring); unused when perturb = noise_std = 0.
      occm, n_seg: an optional (R,) int64 occupied-segment mask and its
        segment count: the coarse depths then come from occupied_z_vals.

    Returns rgb_coarse/depth_coarse/opacity_coarse (opacity only at test
    time), and rgb_fine/depth_fine/opacity_fine when N_importance > 0,
    keyed like the JAX package. Differentiable in dict params, except
    through the test-time render kernels and the sigma-only fused pass.
    """
    rng = functools.partial((draws or TrainDraws()).take,
                            generator=generator, device=rays.device)
    if occm is not None:
        z_vals = _occupied_z_vals(rays, occm, n_seg, cfg, rng)
    else:
        z_vals = coarse_z_vals(rays, cfg)
        if cfg.perturb > 0:
            lower, upper = _bin_bounds(z_vals)
            z_vals = lower + (upper - lower) * (
                cfg.perturb * rng("perturb", z_vals.shape))
        z_vals = z_vals.contiguous()

    if (cfg.fused and cfg.test_time and cfg.perturb == 0
            and cfg.noise_std == 0):
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

    if cfg.fused_train and not cfg.test_time:
        return _render_fused_train(params, rays, z_vals, cfg, rng)

    def noise(name, shape):
        if cfg.noise_std > 0:
            return cfg.noise_std * rng(name, shape)
        return None

    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    dir_norms = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = embed(rays_d, mcfg.emb_dir)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    coarse = _evaluate_field(params["nerf_coarse"], xyz, rays_d, dir_emb,
                             z_vals, dir_norms,
                             noise("noise_coarse", z_vals.shape), cfg, mcfg,
                             sigma_only=cfg.test_time)
    if cfg.test_time:
        result = {"opacity_coarse": coarse["opacity"]}
    else:
        result = {"rgb_coarse": coarse["rgb"],
                  "depth_coarse": coarse["depth"],
                  "opacity_coarse": coarse["opacity"]}
    if cfg.N_importance > 0:
        u = (rng("u", (rays.shape[0], cfg.N_importance))
             if cfg.perturb > 0 else None)
        z_all = _fine_z_vals(z_vals, coarse["weights"], cfg, u)
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
        fine = _evaluate_field(params["nerf_fine"], xyz, rays_d, dir_emb,
                               z_all, dir_norms,
                               noise("noise_fine", z_all.shape), cfg, mcfg,
                               sigma_only=False)
        result["rgb_fine"] = fine["rgb"]
        result["depth_fine"] = fine["depth"]
        result["opacity_fine"] = fine["opacity"]
    return result


def _occupied_z_vals(rays, occm, n_seg, cfg: RenderConfig, rng):
    uniform = (rng("perturb", (rays.shape[0], cfg.N_samples))
               if cfg.perturb > 0 else None)
    return occupied_z_vals(rays, occm, n_seg, cfg.N_samples, cfg.perturb,
                           uniform, keepalive=cfg.occ_keepalive)


def _kernel_noise(cfg: RenderConfig, rng, name: str, shape, device):
    """The sigma noise of one training-kernel pass: zeros when noise_std
    is 0 (the kernels always add it)."""
    if cfg.noise_std > 0:
        return (cfg.noise_std * rng(name, shape)).contiguous()
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _render_fused_train(params, rays, z_vals, cfg: RenderConfig, rng):
    """Both passes through `fused_train_render` (the JAX render_rays'
    fused_train branch): one forward kernel per pass, and its backward when
    autograd differentiates the result. The fine depths follow the detached
    coarse weights."""
    def noise(name, shape):
        return _kernel_noise(cfg, rng, name, shape, rays.device)

    out_c, weights_c = fused_train_render(
        pack_params(params["nerf_coarse"]), rays, z_vals,
        noise("noise_coarse", z_vals.shape), cfg.white_back)
    result = {"rgb_coarse": out_c[:, 0:3], "depth_coarse": out_c[:, 3],
              "opacity_coarse": out_c[:, 4]}
    if cfg.N_importance > 0:
        u = (rng("u", (rays.shape[0], cfg.N_importance))
             if cfg.perturb > 0 else None)
        z_all = _fine_z_vals(z_vals, weights_c, cfg, u).contiguous()
        out_f, _ = fused_train_render(
            pack_params(params["nerf_fine"]), rays, z_all,
            noise("noise_fine", z_all.shape), cfg.white_back)
        result["rgb_fine"] = out_f[:, 0:3]
        result["depth_fine"] = out_f[:, 3]
        result["opacity_fine"] = out_f[:, 4]
    return result


def fused_mse_train_step(params: Mapping[str, Any],
                         rays: torch.Tensor,
                         rgbs: torch.Tensor,
                         cfg: RenderConfig,
                         global_batch: int,
                         mcfg: ModelConfig = ModelConfig(),
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[TrainDraws] = None,
                         occm: Optional[torch.Tensor] = None,
                         n_seg: int = 0):
    """Loss-fused training step: loss, render outputs and parameter
    gradients from one `fused_mse_render` per pass (no autograd).

    Valid exactly for the reference MSE loss (the sum of the per-pass
    means). Args as `render_rays`, plus rgbs (R, 3) ground truth and
    global_batch, the ray count of the whole step (cotangent scale
    1 / (global_batch * 3)).

    Returns (loss_sum, result dict, grads like params): loss_sum is the
    SUM over rays of the per-ray squared-error means; divide it by
    global_batch for the loss.
    """
    rng = functools.partial((draws or TrainDraws()).take,
                            generator=generator, device=rays.device)
    if occm is not None:
        z_vals = _occupied_z_vals(rays, occm, n_seg, cfg, rng)
    else:
        z_vals = coarse_z_vals(rays, cfg)
        if cfg.perturb > 0:
            lower, upper = _bin_bounds(z_vals)
            z_vals = lower + (upper - lower) * cfg.perturb * \
                rng("perturb", z_vals.shape)
        z_vals = z_vals.contiguous()

    def noise(name, shape):
        return _kernel_noise(cfg, rng, name, shape, rays.device)

    scale = 1.0 / (global_batch * 3)
    out_c, weights_c, g_c = fused_mse_render(
        params["nerf_coarse"], rays, z_vals,
        noise("noise_coarse", z_vals.shape), rgbs, cfg.white_back, scale)
    result = {"rgb_coarse": out_c[:, 0:3], "depth_coarse": out_c[:, 3],
              "opacity_coarse": out_c[:, 4]}
    loss_sum = torch.sum((out_c[:, 0:3] - rgbs) ** 2) / 3.0
    grads = {"nerf_coarse": unpack_grads(g_c)}

    if cfg.N_importance > 0:
        u = (rng("u", (rays.shape[0], cfg.N_importance))
             if cfg.perturb > 0 else None)
        z_all = _fine_z_vals(z_vals, weights_c, cfg, u).contiguous()
        out_f, _, g_f = fused_mse_render(
            params["nerf_fine"], rays, z_all,
            noise("noise_fine", z_all.shape), rgbs, cfg.white_back, scale)
        result["rgb_fine"] = out_f[:, 0:3]
        result["depth_fine"] = out_f[:, 3]
        result["opacity_fine"] = out_f[:, 4]
        loss_sum = loss_sum + torch.sum((out_f[:, 0:3] - rgbs) ** 2) / 3.0
        grads["nerf_fine"] = unpack_grads(g_f)
    return loss_sum, result, grads


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
