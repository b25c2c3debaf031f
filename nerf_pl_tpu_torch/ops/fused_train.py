"""Loss-fused training render: forward, MSE cotangent and the whole backward
of one NeRF MLP over a ray batch, with the gradients as outputs.

Port of `fused_mse_render` in nerf_pl_tpu/ops/fused_train.py (kernel
`_mse_fwdbwd_kernel`). `fused_mse_render` dispatches on the device of
`rays`:
  * a CPU tensor goes to the plain PyTorch version,
    `fused_mse_render_reference`;
  * a CUDA tensor launches the hand-written kernels of
    `csrc/fused_train.cu` (built on first use by `_build.py`) or raises.
There is no path from the kernel to the plain version. Each launch adds one
to `mse_render_launches`.

The plain version follows the TPU kernel step by step: points `o + d*z`,
the MLP forward with bf16 products and f32 sums keeping its activations
(`fused_mlp.forward_body`), the training quadrature with sigma noise
(`quad_forward`: transmittance is exp of the exclusive prefix sum, with no
+1e-10, as the port's test-time `quadrature`), the cotangent
2 * scale * (rgb - gt), the analytic quadrature VJP (`quad_vjp`) and the
weight gradients (`fused_mlp.mlp_grads`). Rays, z and noise get no
gradients: z is detached by the hierarchical sampler and the rest is data.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .fused_mlp import (GRAD_FLOATS, MLPArg, PackedMLP, _as_packed,
                        _checked_library, _pack_layout_grads, _raise_on,
                        _train_weights, forward_body, mlp_grads)
from .fused_render import MAX_SAMPLES, _points

# Launches of the kernel (a plain int; set it to 0 to start a count).
mse_render_launches = 0


class Quad(NamedTuple):
    """The training quadrature of a ray batch and what its VJP reuses."""
    deltas: torch.Tensor       # (R, S) z steps times |d|, last 1e10 |d|
    s_eff: torch.Tensor        # (R, S) sigma + noise
    exp_neg: torch.Tensor      # (R, S) exp(-delta * relu(s_eff))
    trans: torch.Tensor        # (R, S) transmittance T
    weights: torch.Tensor      # (R, S)
    opacity: torch.Tensor      # (R,)
    rgb: torch.Tensor          # (R, 3), white background added
    depth: torch.Tensor        # (R,)


def quad_forward(z: torch.Tensor, dir_norm: torch.Tensor,
                 sigmas: torch.Tensor, noise: torch.Tensor,
                 rgbs: torch.Tensor, white_back: bool) -> Quad:
    """The TPU kernel's `_quad_forward`. sigmas, noise (R, S), rgbs
    (R, S, 3), dir_norm (R, 1)."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                       dim=-1) * dir_norm
    s_eff = sigmas + noise
    optical = deltas * torch.clamp(s_eff, min=0.0)
    exp_neg = torch.exp(-optical)
    # exclusive prefix sum, without subtracting the 1e10-scale last term
    csum = torch.cat([torch.zeros_like(optical[:, :1]),
                      torch.cumsum(optical[:, :-1], dim=-1)], dim=-1)
    trans = torch.exp(-csum)
    weights = (1.0 - exp_neg) * trans
    opacity = weights.sum(dim=-1)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth = torch.sum(weights * z, dim=-1)
    if white_back:
        rgb = rgb + (1.0 - opacity[:, None])
    return Quad(deltas, s_eff, exp_neg, trans, weights, opacity, rgb, depth)


def quad_vjp(q: Quad, rgbs: torch.Tensor, g_rgb: torch.Tensor,
             white_back: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cotangent g_rgb (R, 3) on the rendered rgb -> (dL/dsigma (R, S),
    dL/drgb per point (R, S, 3)).

    dL/do_k = a_k T_k exp(-o_k) - sum_{i>k} a_i w_i, with a_k = dL/dw_k.
    Never a_k (T_k - w_k): that difference cancels for saturated samples
    and the 1e10 last delta then amplifies the error. The suffix sum is a
    true exclusive suffix sum (a reversed cumsum), not total - prefix."""
    a = g_rgb[:, None, 0] * rgbs[..., 0]
    for c in (1, 2):
        a = a + g_rgb[:, None, c] * rgbs[..., c]
    if white_back:
        a = a - (g_rgb[:, 0:1] + g_rgb[:, 1:2] + g_rgb[:, 2:3])
    aw = a * q.weights
    suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(aw[:, 1:], [1]),
                                                dim=-1), [1]),
                        torch.zeros_like(aw[:, :1])], dim=-1)
    d_optical = a * q.trans * q.exp_neg - suffix
    d_sigma = torch.where(q.s_eff > 0, d_optical * q.deltas, 0.0)
    return d_sigma, q.weights[..., None] * g_rgb[:, None, :]


def _out8(q: Quad) -> torch.Tensor:
    R = q.rgb.shape[0]
    return torch.cat([q.rgb, q.depth[:, None], q.opacity[:, None],
                      q.rgb.new_zeros((R, 3))], dim=-1)


def fused_mse_render_reference(params: MLPArg, rays: torch.Tensor,
                               z_vals: torch.Tensor, noise: torch.Tensor,
                               gt: torch.Tensor, white_back: bool,
                               scale: float):
    """Plain PyTorch `fused_mse_render`, on any device."""
    mlp = _as_packed(params, rays.device)
    R, S = z_vals.shape
    p8, d8, dir_norm = _points(rays, z_vals)
    sigma, rgb, acts = forward_body(p8, d8, mlp.packed, keep_acts=True)
    rgbs = rgb.reshape(R, S, 3)
    q = quad_forward(z_vals, dir_norm, sigma.reshape(R, S), noise, rgbs,
                     white_back)
    g_rgb = (2.0 * scale) * (q.rgb - gt[:, :3])
    d_sigma, g_pts = quad_vjp(q, rgbs, g_rgb, white_back)
    grads = mlp_grads(p8, d8, mlp.packed, acts, g_pts.reshape(R * S, 3),
                      d_sigma.reshape(R * S))
    return _out8(q), q.weights, grads


# ---------------------------------------------------------------- CUDA ----

def _check_inputs(mlp: PackedMLP, rays, z, noise, gt):
    if mlp.kernel is None:
        raise ValueError("weights were packed for the CPU, not for a GPU")
    R = z.shape[0] if z.dim() == 2 else -1
    if (z.dim() != 2 or rays.shape != (R, 8) or noise.shape != z.shape
            or gt.dim() != 2 or gt.shape[0] != R or gt.shape[1] < 3):
        raise ValueError(f"want rays (R, 8), z and noise (R, S), gt (R, >=3);"
                         f" got {tuple(rays.shape)}, {tuple(z.shape)}, "
                         f"{tuple(noise.shape)}, {tuple(gt.shape)}")
    if not 0 < z.shape[1] <= MAX_SAMPLES:
        raise ValueError(f"S = {z.shape[1]} outside 1..{MAX_SAMPLES}")
    for name, t in (("rays", rays), ("z_vals", z), ("noise", noise),
                    ("gt", gt)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != rays.device:
            raise ValueError(f"{name} is not on {rays.device}")
    for name, t in mlp.kernel.items():
        if t.device != rays.device or not t.is_contiguous():
            raise ValueError(f"weight buffer {name} is not a contiguous "
                             f"tensor on {rays.device}")


def _mse_render_cuda(mlp: PackedMLP, rays, z, noise, gt, white_back: bool,
                     scale: float):
    global mse_render_launches
    gt3 = gt[:, :3].contiguous()
    _check_inputs(mlp, rays, z, noise, gt3)
    R, S = z.shape
    dev = rays.device
    out8 = torch.empty((R, 8), dtype=torch.float32, device=dev)
    weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    if R == 0:
        return (out8.zero_(), weights,
                _pack_layout_grads(torch.zeros((GRAD_FLOATS,), device=dev)))
    grad = torch.empty((GRAD_FLOATS,), dtype=torch.float32, device=dev)
    lib = _checked_library()
    workspace = torch.empty((lib.nerf_mse_workspace_bytes(R, S),),
                            dtype=torch.uint8, device=dev)
    k = _train_weights(mlp)
    with torch.cuda.device(dev):
        err = lib.nerf_mse_render(
            rays.data_ptr(), z.data_ptr(), noise.data_ptr(), gt3.data_ptr(),
            R, S,
            *(k[n].data_ptr() for n in ("w0", "wt", "wsk", "bt", "ws", "bs",
                                        "wf", "bf", "wdf", "wdd", "bd", "wr",
                                        "br", "wdfT", "wfT", "wtT")),
            int(bool(white_back)), float(scale), out8.data_ptr(),
            weights.data_ptr(), workspace.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mse_render")
    mse_render_launches += 1
    return out8, weights, _pack_layout_grads(grad)


def fused_mse_render(params: MLPArg, rays: torch.Tensor,
                     z_vals: torch.Tensor, noise: torch.Tensor,
                     gt: torch.Tensor, white_back: bool, scale: float):
    """Forward, MSE cotangent and backward of ONE NeRF MLP on a ray batch.

    Args:
      params: one MLP's {layer: {w, b}}, or a PackedMLP from `pack_mlp`.
      rays: (R, 8). z_vals: (R, S) sorted depths. noise: (R, S) sigma noise.
      gt: (R, >=3) ground-truth rgb in cols 0..2.
      scale: cotangent scale, 1 / (global batch * 3) for a mean over the
        batch and the rgb channels.

    Returns (out8 (R, 8) [rgb, depth, opacity, 0, 0, 0], weights (R, S),
    17 f32 gradient buffers in the `pack_params` layout; `unpack_grads`
    maps them onto the params dict). Not differentiable: the gradients are
    the output.
    """
    if rays.device.type == "cpu":
        return fused_mse_render_reference(params, rays, z_vals, noise, gt,
                                          white_back, scale)
    if rays.device.type != "cuda":
        raise ValueError(f"no mse_render kernel for device {rays.device}")
    return _mse_render_cuda(_as_packed(params, rays.device), rays, z_vals,
                            noise, gt, white_back, scale)

