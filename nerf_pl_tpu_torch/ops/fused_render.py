"""Fused test-time render: ray -> points -> MLP -> quadrature per ray.

Port of nerf_pl_tpu/ops/fused_render.py. Each function dispatches on the
device of `rays`:
  * a CPU tensor goes to its plain PyTorch version
    (`fused_sigma_render_reference`, `fused_render_eval_reference`);
  * a CUDA tensor launches the hand-written kernel in
    `csrc/fused_render.cu` (built on first use by `_build.py`) or raises.
There is no fallback from the kernel to the plain version. Each launch adds
one to `sigma_render_launches` / `render_eval_launches`.

The plain versions follow the TPU kernels, not `volume_quadrature`:
transmittance is exp(-exclusive sum of delta * relu(sigma)) with no
+1e-10, and the MLP runs as `fused_mlp.forward_body` (bf16 operands, f32
sums). On a GPU they need TF32 off for their f32 products
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default).

The JAX wrappers pad a ragged ray count to the TPU's 8-row tile by
repeating the last ray; the CUDA kernel masks the ragged edge instead, and
its tile size is its own, so `points_per_tile` is not taken here.
"""
from __future__ import annotations

from typing import Optional

import torch

from .fused_mlp import (IN_P, MLPArg, PackedMLP, _as_packed, _raise_on,
                        forward_body, trunk_body)

# Launch counts of the two kernels (plain ints; set them to 0 to start a
# count).
sigma_render_launches = 0
render_eval_launches = 0

MAX_SAMPLES = 1024      # per-ray samples the kernels' shared memory holds


# --------------------------------------------------------------- plain ----

def _points(rays: torch.Tensor, z: torch.Tensor):
    """rays (R, 8), z (R, S) -> p8, d8 (R*S, IN_P) and ‖d‖ (R, 1)."""
    R, S = z.shape
    o, d = rays[:, 0:3], rays[:, 3:6]
    p = o[:, None, :] + d[:, None, :] * z[..., None]             # (R, S, 3)
    zero = torch.zeros((R * S, IN_P - 3), dtype=z.dtype, device=z.device)
    p8 = torch.cat([p.reshape(R * S, 3), zero], dim=-1)
    d8 = torch.cat([d[:, None, :].expand(R, S, 3).reshape(R * S, 3), zero],
                   dim=-1)
    dir_norm = torch.sqrt(torch.sum(d ** 2, dim=-1, keepdim=True))
    return p8, d8, dir_norm


def quadrature(sigmas: torch.Tensor, rgbs: Optional[torch.Tensor],
               z: torch.Tensor, dir_norm: torch.Tensor, white_back: bool):
    """The kernels' quadrature. sigmas (R, S), rgbs (R, S, 3) or None.
    Returns (weights, opacity, rgb or None, depth or None)."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                       dim=-1) * dir_norm
    optical = deltas * torch.clamp(sigmas, min=0.0)
    alphas = 1.0 - torch.exp(-optical)
    # exclusive prefix sum, without subtracting the 1e10-scale last term
    csum = torch.cat([torch.zeros_like(optical[:, :1]),
                      torch.cumsum(optical[:, :-1], dim=-1)], dim=-1)
    weights = alphas * torch.exp(-csum)
    opacity = weights.sum(dim=-1)
    if rgbs is None:
        return weights, opacity, None, None
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth = torch.sum(weights * z, dim=-1)
    if white_back:
        rgb = rgb + (1.0 - opacity[:, None])
    return weights, opacity, rgb, depth


def fused_sigma_render_reference(params: MLPArg, rays: torch.Tensor,
                                 z_vals: torch.Tensor):
    """Plain PyTorch `fused_sigma_render`, on any device."""
    mlp = _as_packed(params, rays.device)
    R, S = z_vals.shape
    p8, _, dir_norm = _points(rays, z_vals)
    sigma, _ = trunk_body(p8, mlp.packed)
    weights, opacity, _, _ = quadrature(sigma.reshape(R, S), None, z_vals,
                                        dir_norm, False)
    return weights, opacity


def fused_render_eval_reference(params: MLPArg, rays: torch.Tensor,
                                z_vals: torch.Tensor, white_back: bool):
    """Plain PyTorch `fused_render_eval`, on any device."""
    mlp = _as_packed(params, rays.device)
    R, S = z_vals.shape
    p8, d8, dir_norm = _points(rays, z_vals)
    sigma, rgb = forward_body(p8, d8, mlp.packed)
    _, opacity, rgb, depth = quadrature(sigma.reshape(R, S),
                                        rgb.reshape(R, S, 3), z_vals,
                                        dir_norm, white_back)
    return {"rgb": rgb, "depth": depth, "opacity": opacity}


# ---------------------------------------------------------------- CUDA ----

def _check_inputs(mlp: PackedMLP, rays: torch.Tensor, z: torch.Tensor):
    if mlp.kernel is None:
        raise ValueError("weights were packed for the CPU, not for a GPU")
    if z.dim() != 2 or rays.shape != (z.shape[0], 8):
        raise ValueError(f"want rays (R, 8) and z (R, S); got "
                         f"{tuple(rays.shape)} and {tuple(z.shape)}")
    if not 0 < z.shape[1] <= MAX_SAMPLES:
        raise ValueError(f"S = {z.shape[1]} outside 1..{MAX_SAMPLES}")
    for name, t in (("rays", rays), ("z_vals", z)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    for name, t in mlp.kernel.items():
        if t.device != rays.device or not t.is_contiguous():
            raise ValueError(f"weight buffer {name} is not a contiguous "
                             f"tensor on {rays.device}")
    if z.device != rays.device:
        raise ValueError("rays and z_vals are on different devices")


def _sigma_render_cuda(mlp: PackedMLP, rays, z):
    global sigma_render_launches
    from ._build import load_library
    _check_inputs(mlp, rays, z)
    R, S = z.shape
    weights = torch.empty((R, S), dtype=torch.float32, device=rays.device)
    opacity = torch.empty((R,), dtype=torch.float32, device=rays.device)
    if R == 0:
        return weights, opacity
    k = mlp.kernel
    lib = load_library()
    with torch.cuda.device(rays.device):
        err = lib.nerf_sigma_render(
            rays.data_ptr(), z.data_ptr(), R, S,
            *(k[n].data_ptr() for n in ("w0", "wt", "wsk", "bt", "ws", "bs")),
            weights.data_ptr(), opacity.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sigma_render")
    sigma_render_launches += 1
    return weights, opacity


def _render_eval_cuda(mlp: PackedMLP, rays, z, white_back: bool):
    global render_eval_launches
    from ._build import load_library
    _check_inputs(mlp, rays, z)
    R, S = z.shape
    rgb = torch.empty((R, 3), dtype=torch.float32, device=rays.device)
    depth = torch.empty((R,), dtype=torch.float32, device=rays.device)
    opacity = torch.empty((R,), dtype=torch.float32, device=rays.device)
    if R == 0:
        return {"rgb": rgb, "depth": depth, "opacity": opacity}
    k = mlp.kernel
    lib = load_library()
    with torch.cuda.device(rays.device):
        err = lib.nerf_render_eval(
            rays.data_ptr(), z.data_ptr(), R, S,
            *(k[n].data_ptr() for n in ("w0", "wt", "wsk", "bt", "ws", "bs",
                                        "wf", "bf", "wdf", "wdd", "bd", "wr",
                                        "br")),
            int(bool(white_back)), rgb.data_ptr(), depth.data_ptr(),
            opacity.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "render_eval")
    render_eval_launches += 1
    return {"rgb": rgb, "depth": depth, "opacity": opacity}


# ------------------------------------------------------------ dispatch ----

def fused_render_eval(params: MLPArg, rays: torch.Tensor,
                      z_vals: torch.Tensor, white_back: bool):
    """Fused full-path inference render.

    Args:
      params: one MLP's {layer: {w, b}}, or a PackedMLP from `pack_mlp`.
      rays: (R, 8) [o, d, near, far]. z_vals: (R, S) sorted sample depths.

    Returns dict rgb (R, 3), depth (R,), opacity (R,).
    """
    if rays.device.type == "cpu":
        return fused_render_eval_reference(params, rays, z_vals, white_back)
    if rays.device.type != "cuda":
        raise ValueError(f"no render_eval kernel for device {rays.device}")
    return _render_eval_cuda(_as_packed(params, rays.device), rays, z_vals,
                             white_back)


def fused_sigma_render(params: MLPArg, rays: torch.Tensor,
                       z_vals: torch.Tensor):
    """Fused sigma-only inference: per-ray quadrature weights + opacity.

    Returns (weights (R, S), opacity (R,))."""
    if rays.device.type == "cpu":
        return fused_sigma_render_reference(params, rays, z_vals)
    if rays.device.type != "cuda":
        raise ValueError(f"no sigma_render kernel for device {rays.device}")
    return _sigma_render_cuda(_as_packed(params, rays.device), rays, z_vals)
