"""Fused training render of one NeRF MLP over a ray batch.

Port of nerf_pl_tpu/ops/fused_train.py, both of its entry points:
  * `fused_mse_render` (kernel `_mse_fwdbwd_kernel`): forward, MSE
    cotangent and the whole backward, with the gradients as outputs (the
    loss-fused step);
  * `fused_train_render` (kernels `_train_fwd_kernel` and
    `_train_bwd_kernel`, its custom VJP): out8 and the (R, S) weights,
    differentiable in the 17 packed weight buffers through a
    `torch.autograd.Function`, for any loss.
Each pass dispatches on the device of `rays`:
  * a CPU tensor goes to the plain PyTorch version
    (`fused_mse_render_reference`, `fused_train_render_reference`,
    `fused_train_render_backward_reference`);
  * a CUDA tensor launches the hand-written kernels of
    `csrc/fused_train.cu` (mse_render, train_fwd, train_bwd; built on first
    use by `_build.py`) or raises.
There is no path from a kernel to its plain version. Each launch adds one
to `mse_render_launches`, `train_fwd_launches` or `train_bwd_launches`.

The plain versions follow the TPU kernels step by step: points `o + d*z`,
the MLP forward with bf16 products and f32 sums keeping its activations
(`fused_mlp.forward_body`), the training quadrature with sigma noise
(`quad_forward`: transmittance is exp of the exclusive prefix sum, with no
+1e-10, as the port's test-time `quadrature`), the cotangent (2 * scale *
(rgb - gt), or the given g8 and gw), the analytic quadrature VJP
(`quad_vjp`) and the weight gradients (`fused_mlp.mlp_grads`). Rays, z and
noise get no gradients: z is detached by the hierarchical sampler and the
rest is data.

The TPU wrappers refuse a ray count that is not a multiple of 8; the
kernels mask a ragged R and the plain versions take any R (the train CLI
keeps the rule, `config.validate_hparams`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .fused_mlp import (_FULL, GRAD_FLOATS, Acts, MLPArg, PackedMLP,
                        _as_packed, _checked_library, _on, _pack_layout_grads,
                        _raise_on, _train_weights, forward_body, mlp_grads,
                        packed_for)
from .fused_render import MAX_SAMPLES, _points

# Launches of the three kernels (plain ints; set them to 0 to start a
# count).
mse_render_launches = 0
train_fwd_launches = 0
train_bwd_launches = 0


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
             white_back: bool, base: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cotangent g_rgb (R, 3) on the rendered rgb, and `base` (R, S) =
    gw_k + g_depth z_k + g_op from the cotangents on the weights, depth and
    opacity (`cotangent_base`; None for the MSE cotangent, which has only
    g_rgb) -> (dL/dsigma (R, S), dL/drgb per point (R, S, 3)).

    a_k = dL/dw_k = base_k + sum_c g_rgb_c c_k - white_back sum_c g_rgb_c,
    the rgb terms summed first, as in the kernels (so that a zero base
    gives the MSE cotangent's a_k exactly). dL/do_k = a_k T_k exp(-o_k) -
    sum_{i>k} a_i w_i. Never a_k (T_k - w_k): that difference cancels for
    saturated samples and the 1e10 last delta then amplifies the error. The
    suffix sum is a true exclusive suffix sum (a reversed cumsum), not
    total - prefix."""
    a = g_rgb[:, None, 0] * rgbs[..., 0]
    for c in (1, 2):
        a = a + g_rgb[:, None, c] * rgbs[..., c]
    if base is not None:
        a = base + a
    if white_back:
        a = a - (g_rgb[:, 0:1] + g_rgb[:, 1:2] + g_rgb[:, 2:3])
    aw = a * q.weights
    suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(aw[:, 1:], [1]),
                                                dim=-1), [1]),
                        torch.zeros_like(aw[:, :1])], dim=-1)
    d_optical = a * q.trans * q.exp_neg - suffix
    d_sigma = torch.where(q.s_eff > 0, d_optical * q.deltas, 0.0)
    return d_sigma, q.weights[..., None] * g_rgb[:, None, :]


def cotangent_base(z: torch.Tensor, g8: torch.Tensor,
                   gw: Optional[torch.Tensor]) -> torch.Tensor:
    """The part of a_k = dL/dw_k that does not come from the rgb: gw_k +
    g_depth z_k + g_op (g_depth, g_op in columns 3 and 4 of g8; gw None
    reads as zero)."""
    base = g8[:, 3:4] * z
    if gw is not None:
        base = gw + base
    return base + g8[:, 4:5]


def _out8(q: Quad) -> torch.Tensor:
    R = q.rgb.shape[0]
    return torch.cat([q.rgb, q.depth[:, None], q.opacity[:, None],
                      q.rgb.new_zeros((R, 3))], dim=-1)


class _Forward(NamedTuple):
    """The plain forward of a ray batch and what its backward reuses."""
    q: Quad
    rgbs: torch.Tensor         # (R, S, 3) per-point rgb
    p8: torch.Tensor           # (R * S, 8) points
    d8: torch.Tensor           # (R * S, 8) directions
    packed: tuple              # the bf16 weights
    acts: Optional[Acts]       # the MLP's activations (keep_acts only)


def _forward(params: MLPArg, rays: torch.Tensor, z_vals: torch.Tensor,
             noise: torch.Tensor, white_back: bool,
             keep_acts: bool = False) -> _Forward:
    """Points, the MLP forward (with its activations when `keep_acts`) and
    the training quadrature: the forward shared by the three plain
    versions."""
    mlp = _as_packed(params, rays.device)
    R, S = z_vals.shape
    p8, d8, dir_norm = _points(rays, z_vals)
    sigma, rgb, *acts = forward_body(p8, d8, mlp.packed, keep_acts=keep_acts)
    rgbs = rgb.reshape(R, S, 3)
    q = quad_forward(z_vals, dir_norm, sigma.reshape(R, S), noise, rgbs,
                     white_back)
    return _Forward(q, rgbs, p8, d8, mlp.packed, acts[0] if acts else None)


def _backward(f: _Forward, g_rgb: torch.Tensor, white_back: bool,
              base: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The quadrature VJP (`quad_vjp`) and the weight gradients of a
    `_forward` kept with its activations."""
    d_sigma, g_pts = quad_vjp(f.q, f.rgbs, g_rgb, white_back, base)
    return mlp_grads(f.p8, f.d8, f.packed, f.acts, g_pts.reshape(-1, 3),
                     d_sigma.reshape(-1))


def fused_mse_render_reference(params: MLPArg, rays: torch.Tensor,
                               z_vals: torch.Tensor, noise: torch.Tensor,
                               gt: torch.Tensor, white_back: bool,
                               scale: float):
    """Plain PyTorch `fused_mse_render`, on any device."""
    f = _forward(params, rays, z_vals, noise, white_back, keep_acts=True)
    g_rgb = (2.0 * scale) * (f.q.rgb - gt[:, :3])
    return _out8(f.q), f.q.weights, _backward(f, g_rgb, white_back, None)


def fused_train_render_reference(params: MLPArg, rays: torch.Tensor,
                                 z_vals: torch.Tensor, noise: torch.Tensor,
                                 white_back: bool):
    """Plain PyTorch forward of `fused_train_render`, on any device:
    (out8 (R, 8), weights (R, S))."""
    q = _forward(params, rays, z_vals, noise, white_back).q
    return _out8(q), q.weights


def fused_train_render_backward_reference(
        params: MLPArg, rays: torch.Tensor, z_vals: torch.Tensor,
        noise: torch.Tensor, white_back: bool, g8: torch.Tensor,
        gw: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward of `fused_train_render`, on any device: the
    forward again with its activations, the quadrature VJP for the
    cotangents g8 (R, 8) on out8 and gw (R, S) on the weights (None: zero),
    then the weight gradients (17 f32 buffers in the `pack_params`
    layout)."""
    f = _forward(params, rays, z_vals, noise, white_back, keep_acts=True)
    return _backward(f, g8[:, 0:3], white_back,
                     cotangent_base(z_vals, g8, gw))


# ---------------------------------------------------------------- CUDA ----

def _check_inputs(mlp: PackedMLP, rays, z, noise, **per_ray):
    """rays (R, 8), z and noise (R, S), and per_ray: gt (R, 3), g8 (R, 8)
    or gw (R, S); all contiguous f32 on the rays' device."""
    if mlp.kernel is None:
        raise ValueError("weights were packed for the CPU, not for a GPU")
    R, S = z.shape if z.dim() == 2 else (-1, -1)
    want = {"rays": (R, 8), "z_vals": (R, S), "noise": (R, S), "gt": (R, 3),
            "g8": (R, 8), "gw": (R, S)}
    tensors = {"rays": rays, "z_vals": z, "noise": noise, **per_ray}
    if z.dim() != 2 or any(t.shape != want[n] for n, t in tensors.items()):
        raise ValueError("want rays (R, 8), z_vals and noise (R, S), gt "
                         "(R, 3), g8 (R, 8), gw (R, S); got " + ", ".join(
                             f"{n} {tuple(t.shape)}"
                             for n, t in tensors.items()))
    if not 0 < S <= MAX_SAMPLES:
        raise ValueError(f"S = {S} outside 1..{MAX_SAMPLES}")
    for name, t in tensors.items():
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
    _check_inputs(mlp, rays, z, noise, gt=gt3)
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
            R, S, *(k[n].data_ptr() for n in _FULL + ("wdfT", "wfT", "wtT")),
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


def _train_fwd_cuda(mlp: PackedMLP, rays, z, noise, white_back: bool):
    global train_fwd_launches
    _check_inputs(mlp, rays, z, noise)
    R, S = z.shape
    out8 = torch.empty((R, 8), dtype=torch.float32, device=rays.device)
    weights = torch.empty((R, S), dtype=torch.float32, device=rays.device)
    if R == 0:
        return out8, weights
    lib, k = _checked_library(), mlp.kernel
    with torch.cuda.device(rays.device):
        err = lib.nerf_train_fwd(
            rays.data_ptr(), z.data_ptr(), noise.data_ptr(), R, S,
            *(k[n].data_ptr() for n in _FULL), int(bool(white_back)),
            out8.data_ptr(), weights.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "train_fwd")
    train_fwd_launches += 1
    return out8, weights


def _train_bwd_cuda(mlp: PackedMLP, rays, z, noise, white_back: bool, g8,
                    gw):
    global train_bwd_launches
    per_ray = {"g8": g8} if gw is None else {"g8": g8, "gw": gw}
    _check_inputs(mlp, rays, z, noise, **per_ray)
    R, S = z.shape
    dev = rays.device
    if R == 0:
        return _pack_layout_grads(torch.zeros((GRAD_FLOATS,), device=dev))
    grad = torch.empty((GRAD_FLOATS,), dtype=torch.float32, device=dev)
    lib = _checked_library()
    workspace = torch.empty((lib.nerf_mse_workspace_bytes(R, S),),
                            dtype=torch.uint8, device=dev)
    k = _train_weights(mlp)
    with torch.cuda.device(dev):
        err = lib.nerf_train_bwd(
            rays.data_ptr(), z.data_ptr(), noise.data_ptr(), g8.data_ptr(),
            None if gw is None else gw.data_ptr(), R, S,
            *(k[n].data_ptr() for n in _FULL + ("wdfT", "wfT", "wtT")),
            int(bool(white_back)), workspace.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "train_bwd")
    train_bwd_launches += 1
    return _pack_layout_grads(grad)


# ------------------------------------------------------------ dispatch ----

def train_forward(mlp: PackedMLP, rays: torch.Tensor, z_vals: torch.Tensor,
                  noise: torch.Tensor, white_back: bool):
    """The forward of `fused_train_render` on packed weights: (out8 (R, 8),
    weights (R, S))."""
    if _on("train_fwd", rays):
        return _train_fwd_cuda(mlp, rays, z_vals, noise, white_back)
    return fused_train_render_reference(mlp, rays, z_vals, noise, white_back)


def train_backward(mlp: PackedMLP, rays: torch.Tensor, z_vals: torch.Tensor,
                   noise: torch.Tensor, white_back: bool, g8: torch.Tensor,
                   gw: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The backward of `fused_train_render` on packed weights: 17 f32
    gradient buffers in the `pack_params` layout for the cotangents g8
    (R, 8) on out8 and gw (R, S) on the weights (None: zero)."""
    if _on("train_bwd", rays):
        return _train_bwd_cuda(mlp, rays, z_vals, noise, white_back, g8, gw)
    return fused_train_render_backward_reference(mlp, rays, z_vals, noise,
                                                 white_back, g8, gw)


class _FusedTrainRender(torch.autograd.Function):
    """`fused_train_render` with its custom VJP. The primal weights are the
    17 f32 `pack_params` buffers and the bf16 cast happens in here, so the
    gradients come back in f32, as from the JAX custom VJP. Rays, z and
    noise get no gradients. A cotangent autograd does not produce (the
    weights of a pass whose depths feed only the detached resampling) comes
    in as None and reaches the kernel as a null gw, read as zero."""

    @staticmethod
    def forward(ctx, rays, z_vals, noise, white_back, *packed):
        ctx.set_materialize_grads(False)
        ctx.mlp = packed_for(packed, rays.device)
        ctx.white_back = white_back
        ctx.save_for_backward(rays, z_vals, noise)
        return train_forward(ctx.mlp, rays, z_vals, noise, white_back)

    @staticmethod
    def backward(ctx, g8, gw):
        rays, z_vals, noise = ctx.saved_tensors
        g8 = rays.new_zeros((rays.shape[0], 8)) if g8 is None else \
            g8.contiguous()
        gw = None if gw is None else gw.contiguous()
        grads = train_backward(ctx.mlp, rays, z_vals, noise, ctx.white_back,
                               g8, gw)
        return (None, None, None, None, *grads)


def fused_train_render(packed: Tuple[torch.Tensor, ...], rays: torch.Tensor,
                       z_vals: torch.Tensor, noise: torch.Tensor,
                       white_back: bool, fwd_points_per_tile: int = 8192,
                       bwd_points_per_tile: int = 4096):
    """Fused train-time render of a ray batch through ONE NeRF model,
    differentiable in `packed`.

    Args:
      packed: the 17 f32 buffers of `pack_params(params)`.
      rays: (R, 8). z_vals: (R, S) sorted sample depths.
      noise: (R, S) sigma noise (zeros when noise_std == 0).
      fwd_points_per_tile, bwd_points_per_tile: accepted for the JAX
        signature and not used: the kernels' tiles are their own and a
        ragged R is masked.

    Returns (out8 (R, 8) [rgb (3), depth, opacity, 0, 0, 0], weights
    (R, S)).
    """
    return _FusedTrainRender.apply(rays, z_vals, noise, bool(white_back),
                                   *packed)
