"""The fused NeRF point MLP: packing, plain bodies and the three point-MLP
kernels.

Port of nerf_pl_tpu/ops/fused_mlp.py. The layout half: `pack_params`
keeps its 17-buffer layout, `unpack_grads` maps gradients in that layout
back onto the {layer: {w, b}} dict, `forward_body` / `trunk_body` compute
what its Pallas `_forward_body` / `_sigma_kernel` compute, and `mlp_grads`
what its `_mlp_grads` computes from the activations
`forward_body(keep_acts=True)` returns. `pack_mlp` packs one MLP once for
many kernel calls (`PackedMLP`), and the training kernels' gradient
buffer maps onto the 17 buffers here too (`_pack_layout_grads`).

The kernel half: `fused_nerf_mlp` (the point MLP with its custom VJP, a
`torch.autograd.Function`; `nerf_apply_fused` is its drop-in for embed +
nerf_apply) and `nerf_sigma_fused`. Each pass dispatches on the device of
the points:
  * a CPU tensor goes to the plain version (`mlp_forward_reference`,
    `mlp_backward_reference`, `sigma_forward_reference`);
  * a CUDA tensor launches the hand-written kernels of `csrc/fused_mlp.cu`
    (mlp_fwd, mlp_bwd, sigma_fwd; built on first use by `_build.py`) or
    raises. There is no path from a kernel to its plain version. Each launch
    adds one to `mlp_fwd_launches`, `mlp_bwd_launches` or
    `sigma_fwd_launches`.

Numerics of `forward_body`, as in the TPU kernel:
  * every MLP product takes bf16 operands and sums in f32, emulated as
    a.bfloat16().float() @ w.bfloat16().float() (exact products, f32 sums);
  * activations are stored in bf16 after each ReLU (and the linear feature
    layer);
  * the phase x * 2^k is exact in f32 and the cos columns are
    sin(t + pi/2), so the embedding is one sin() over the phase block.
Numerics of `mlp_grads`, as in the TPU kernel's `_dot` / `_dot_t`: every
weight-gradient and data-gradient product is written out (no autograd) and
casts both operands to bf16 with f32 sums; bias gradients sum the f32
cotangents; the ReLU masks compare the bf16 activations; the sigmoid
derivative uses the f32 rgb.
The f32 products need TF32 off on a GPU
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

# Fixed architecture of the fused kernels (the default NeRF config).
D = 8
W = 256
WD = 128            # view-branch width
SKIP_LAYER = 4      # trunk layer receiving the x skip
IN_P = 8            # packed raw-point width (3 used)
FX = 10             # xyz frequencies  -> 60 sin/cos cols (64 padded)
FD = 4              # dir frequencies  -> 24 sin/cos cols (32 padded)
EX = 64             # padded xyz sin/cos width
ED = 32             # padded dir sin/cos width
N_PACKED = 17       # number of packed weight buffers

# Indices of the matmul-weight buffers in the packed tuple (bf16 operands);
# biases and the placeholder stay f32.
MATMUL_IDX = frozenset({0, 1, 2, 3, 4, 6, 8, 9, 10, 12, 14})

# Launch counts of the three kernels (plain ints; set them to 0 to start a
# count).
mlp_fwd_launches = 0
mlp_bwd_launches = 0
sigma_fwd_launches = 0


def phase_consts(n_freqs: int, padded: int) -> Tuple[np.ndarray, np.ndarray]:
    """(IN_P, padded) frequency matrix + (1, padded) phase offset.

    Column layout per frequency k: [sin(f_k x), sin(f_k y), sin(f_k z),
    cos(f_k x), cos(f_k y), cos(f_k z)]; cos columns carry a +pi/2 offset.
    Columns past 6 * n_freqs are zero."""
    F = np.zeros((IN_P, padded), np.float32)
    off = np.zeros((1, padded), np.float32)
    for k in range(n_freqs):
        f = 2.0 ** k
        for c in range(3):
            F[c, k * 6 + c] = f
            F[c, k * 6 + 3 + c] = f
            off[0, k * 6 + 3 + c] = np.pi / 2
    return F, off


def embed_sincos(p8: torch.Tensor, n_freqs: int, padded: int) -> torch.Tensor:
    """(T, IN_P) raw points -> (T, padded) sin/cos block in f32.

    The phase is taken column by column (one channel times 2^k, exact in
    f32) rather than as a matmul, so it cannot pick up TF32 rounding."""
    F, off = phase_consts(n_freqs, padded)
    chan = torch.as_tensor(F.argmax(axis=0), device=p8.device)
    scale = torch.as_tensor(F.max(axis=0), device=p8.device)
    phase = p8[:, chan] * scale
    return torch.sin(phase + torch.as_tensor(off[0], device=p8.device))


def pack_params(params: Mapping[str, Mapping[str, torch.Tensor]]
                ) -> Tuple[torch.Tensor, ...]:
    """One NeRF MLP's dict -> the kernels' 17 padded f32 buffers:
    (w0r, w0e, wskr, wske, wt, bt, wf, bf, wdf, wddr, wdde, bd,
     ws, bs, wr, br, placeholder)."""
    def f32(t):
        return torch.as_tensor(t).float()

    def pad_rows(w, rows):
        out = torch.zeros((rows, w.shape[1]), dtype=torch.float32,
                          device=w.device)
        out[:w.shape[0]] = w
        return out

    def pad_cols(w, cols):
        out = torch.zeros((w.shape[0], cols), dtype=torch.float32,
                          device=w.device)
        out[:, :w.shape[1]] = w
        return out

    def split_x(w):  # (63, n) -> raw (IN_P, n) + sincos (EX, n)
        return pad_rows(w[:3], IN_P), pad_rows(w[3:], EX)

    p = {k: {leaf: f32(v) for leaf, v in d.items()} for k, d in params.items()}
    w0r, w0e = split_x(p["xyz_0"]["w"])
    wskip = p[f"xyz_{SKIP_LAYER}"]["w"]            # (63+W, W), x part first
    wskr, wske = split_x(wskip[:63])
    trunk = [wskip[63:] if i == SKIP_LAYER else p[f"xyz_{i}"]["w"]
             for i in range(1, D)]
    wt = torch.stack(trunk)                       # (7, W, W)
    bt = torch.stack([p[f"xyz_{i}"]["b"] for i in range(D)])  # (8, W)

    wf = p["xyz_final"]["w"]
    bf = p["xyz_final"]["b"][None]
    wdir = p["dir"]["w"]                          # (W+27, WD), feat first
    wdf = wdir[:W]
    wddr = pad_rows(wdir[W:W + 3], IN_P)
    wdde = pad_rows(wdir[W + 3:], ED)
    bd = p["dir"]["b"][None]
    ws = pad_cols(p["sigma"]["w"], 8)             # (W, 8)
    bs = pad_cols(p["sigma"]["b"][None], 8)
    wr = pad_cols(p["rgb"]["w"], 8)               # (WD, 8)
    br = pad_cols(p["rgb"]["b"][None], 8)
    return (w0r, w0e, wskr, wske, wt, bt, wf, bf, wdf, wddr, wdde, bd,
            ws, bs, wr, br,
            torch.zeros((1, 1), dtype=torch.float32, device=w0r.device))


def precast(packed: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """The matmul buffers rounded to bf16 (stored as bf16), biases f32."""
    return tuple(w.to(torch.bfloat16) if i in MATMUL_IDX else w
                 for i, w in enumerate(packed))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back to f32."""
    return x.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 sums."""
    return _bf16(a) @ _bf16(b)


class Acts(NamedTuple):
    """What the backward needs of one forward (bf16 values held in f32):
    the eight trunk activations, the feature and view activations, both
    sin/cos blocks, and the f32 rgb after the sigmoid (T, 3)."""
    trunk: List[torch.Tensor]
    feat: torch.Tensor
    hd: torch.Tensor
    ex: torch.Tensor
    ed: torch.Tensor
    rgb: torch.Tensor


def _trunk(p8: torch.Tensor, packed):
    (w0r, w0e, wskr, wske, wt, bt, _wf, _bf, _wdf, _wddr, _wdde, _bd,
     ws, bs, *_rest) = packed
    ex = _bf16(embed_sincos(p8, FX, EX))
    h = _bf16(torch.relu(_dot(p8, w0r) + _dot(ex, w0e) + bt[0][None]))
    trunk = [h]
    for i in range(1, D):
        t = _dot(h, wt[i - 1]) + bt[i][None]
        if i == SKIP_LAYER:
            t = t + _dot(p8, wskr) + _dot(ex, wske)
        h = _bf16(torch.relu(t))
        trunk.append(h)
    sigma = (_dot(h, ws) + bs)[:, 0]
    return sigma, trunk, ex


def trunk_body(p8: torch.Tensor, packed) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density trunk: (T, IN_P) raw points -> (raw sigma (T,), last trunk
    activation (T, W) with bf16 values)."""
    sigma, trunk, _ = _trunk(p8, packed)
    return sigma, trunk[-1]


def forward_body(p8: torch.Tensor, d8: torch.Tensor, packed,
                 keep_acts: bool = False):
    """Full MLP: (T, IN_P) raw points and directions -> (raw sigma (T,),
    rgb (T, 3) after the sigmoid), plus `Acts` with keep_acts."""
    (_w0r, _w0e, _wskr, _wske, _wt, _bt, wf, bf, wdf, wddr, wdde, bd,
     _ws, _bs, wr, br, _) = packed
    sigma, trunk, ex = _trunk(p8, packed)
    feat = _bf16(_dot(trunk[-1], wf) + bf)        # linear
    ed = _bf16(embed_sincos(d8, FD, ED))
    hd = _bf16(torch.relu(_dot(feat, wdf) + _dot(d8, wddr) + _dot(ed, wdde)
                          + bd))
    rgb = torch.sigmoid(_dot(hd, wr) + br)[:, :3]
    if keep_acts:
        return sigma, rgb, Acts(trunk, feat, hd, ex, ed, rgb)
    return sigma, rgb


def _dot_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b over the point axis: bf16 operands, f32 sums."""
    return _bf16(a).T @ _bf16(b)


def _pad_cols(w: torch.Tensor, cols: int) -> torch.Tensor:
    out = w.new_zeros((w.shape[0], cols))
    out[:, :w.shape[1]] = w
    return out


def mlp_grads(p8: torch.Tensor, d8: torch.Tensor, packed, acts: Acts,
              g_rgb: torch.Tensor, g_sigma: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """Weight gradients of one MLP for per-point cotangents, in the
    `pack_params` layout (17 f32 buffers).

    Args:
      p8, d8: (T, IN_P) raw points and directions.
      packed: the 17 buffers the forward ran with.
      acts: forward_body(..., keep_acts=True)[2].
      g_rgb: (T, 3) cotangent on the rgb after the sigmoid.
      g_sigma: (T,) cotangent on the raw sigma.
    """
    (w0r, w0e, wskr, wske, wt, bt, wf, bf, wdf, wddr, wdde, bd, ws, bs,
     wr, br, _) = packed
    trunk, feat, hd, ex, ed, rgb = acts
    gs = g_sigma[:, None]                                   # (T, 1)

    dz_r = g_rgb * rgb * (1.0 - rgb)                        # rgb head
    g_wr = _pad_cols(_dot_t(hd, dz_r), wr.shape[1])
    g_br = _pad_cols(dz_r.sum(0, keepdim=True), br.shape[1])
    d_hd = _dot(dz_r, wr[:, :3].T)

    dz_d = torch.where(hd > 0, d_hd, 0.0)                   # view layer
    g_wdf, g_wddr, g_wdde = (_dot_t(feat, dz_d), _dot_t(d8, dz_d),
                             _dot_t(ed, dz_d))
    g_bd = dz_d.sum(0, keepdim=True)
    d_feat = _dot(dz_d, wdf.T)

    h_last = trunk[-1]                                      # feature layer
    g_wf = _dot_t(h_last, d_feat)
    g_bf = d_feat.sum(0, keepdim=True)
    d_h = _dot(d_feat, wf.T)

    g_ws = _pad_cols(_dot_t(h_last, gs), ws.shape[1])       # sigma head
    g_bs = _pad_cols(gs.sum(0, keepdim=True), bs.shape[1])
    d_h = d_h + _dot(gs, ws[:, :1].T)

    g_wt = [None] * (D - 1)
    g_bt = [None] * D
    for i in range(D - 1, 0, -1):                           # trunk 7 .. 1
        dz = torch.where(trunk[i] > 0, d_h, 0.0)
        g_wt[i - 1] = _dot_t(trunk[i - 1], dz)
        g_bt[i] = dz.sum(0)
        d_h = _dot(dz, wt[i - 1].T)
        if i == SKIP_LAYER:
            g_wskr, g_wske = _dot_t(p8, dz), _dot_t(ex, dz)
    dz0 = torch.where(trunk[0] > 0, d_h, 0.0)
    g_w0r, g_w0e = _dot_t(p8, dz0), _dot_t(ex, dz0)
    g_bt[0] = dz0.sum(0)
    return (g_w0r, g_w0e, g_wskr, g_wske, torch.stack(g_wt),
            torch.stack(g_bt), g_wf, g_bf, g_wdf, g_wddr, g_wdde, g_bd,
            g_ws, g_bs, g_wr, g_br, g_bs.new_zeros((1, 1)))


def unpack_grads(grads: Tuple[torch.Tensor, ...]
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Gradients in the `pack_params` layout -> the {layer: {w, b}} dict."""
    (gw0r, gw0e, gwskr, gwske, gwt, gbt, gwf, gbf, gwdf, gwddr, gwdde,
     gbd, gws, gbs, gwr, gbr, _) = grads

    def join_x(gr, ge):  # -> (63, n)
        return torch.cat([gr[:3], ge[:60]])

    out = {}
    for i in range(D):
        if i == 0:
            gw = join_x(gw0r, gw0e)
        elif i == SKIP_LAYER:
            gw = torch.cat([join_x(gwskr, gwske), gwt[i - 1]])
        else:
            gw = gwt[i - 1]
        out[f"xyz_{i}"] = {"w": gw, "b": gbt[i]}
    out["xyz_final"] = {"w": gwf, "b": gbf[0]}
    out["dir"] = {"w": torch.cat([gwdf, gwddr[:3], gwdde[:24]]),
                  "b": gbd[0]}
    out["sigma"] = {"w": gws[:, :1], "b": gbs[0, :1]}
    out["rgb"] = {"w": gwr[:, :3], "b": gbr[0, :3]}
    return out


# ------------------------------------------------------------- packing ----

@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """One MLP packed once for many kernel calls: the 17 `pack_params`
    buffers (matmul buffers in bf16) and, on a GPU, the kernels' layout."""
    packed: Tuple[torch.Tensor, ...]
    kernel: Optional[Dict[str, torch.Tensor]]


def kernel_layout(packed: Tuple[torch.Tensor, ...]) -> Dict[str, torch.Tensor]:
    """The kernels' buffers from the precast 17-buffer pack.

    The raw-input rows (8) and the sin/cos rows of layer 0, of the layer-4
    skip and of the view layer are stacked into one K dimension with 8
    zero rows between them, so every product has a depth that is a
    multiple of 16: [raw (8) | zero (8) | sin/cos]."""
    (w0r, w0e, wskr, wske, wt, bt, wf, bf, wdf, wddr, wdde, bd,
     ws, bs, wr, br, _) = packed

    def x_rows(raw, sincos):
        return torch.cat([raw, torch.zeros_like(raw), sincos]).contiguous()

    return {"w0": x_rows(w0r, w0e), "wt": wt.contiguous(),
            "wsk": x_rows(wskr, wske), "bt": bt.contiguous(),
            "ws": ws[:, 0].contiguous(), "bs": bs[0, :1].contiguous(),
            "wf": wf.contiguous(), "bf": bf[0].contiguous(),
            "wdf": wdf.contiguous(), "wdd": x_rows(wddr, wdde),
            "bd": bd[0].contiguous(), "wr": wr[:, :4].contiguous(),
            "br": br[0, :4].contiguous()}


def packed_for(packed: Tuple[torch.Tensor, ...],
               device: torch.device | str) -> PackedMLP:
    """The 17 f32 `pack_params` buffers, precast, for the kernels on
    `device`."""
    device = torch.device(device)
    bufs = tuple(t.to(device) for t in precast(packed))
    return PackedMLP(bufs, kernel_layout(bufs) if device.type == "cuda"
                     else None)


def pack_mlp(params: Mapping[str, Mapping[str, torch.Tensor]],
             device: torch.device | str) -> PackedMLP:
    """Pack one MLP's {layer: {w, b}} for the kernels on `device`."""
    return packed_for(pack_params(params), device)


MLPArg = Union[PackedMLP, Mapping[str, Mapping[str, torch.Tensor]]]


def _as_packed(params: MLPArg, device: torch.device) -> PackedMLP:
    if isinstance(params, PackedMLP):
        return params
    return pack_mlp(params, device)


# Gradient buffer of the training kernels (mse_render, mlp_bwd): the weight
# gradients in the kernels' layout (`kernel_layout`), one block per product
# act^T @ dz, then the bias gradients. Mirrors csrc/mlp_grad.cuh.
_W_BLOCKS = (("w0", (80, W)), ("wt", (D - 1, W, W)), ("wsk", (80, W)),
             ("wf", (W, W)), ("wdf", (W, WD)), ("wdd", (48, WD)),
             ("ws16", (W, 16)), ("wr16", (WD, 16)))
_B_BLOCKS = (("bt", (D, W)), ("bf", (W,)), ("bd", (WD,)), ("br", (3,)),
             ("bs", (1,)))


GRAD_FLOATS = sum(math.prod(s) for _, s in _W_BLOCKS + _B_BLOCKS)


def _split_grad(g: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, o = {}, 0
    for name, shape in _W_BLOCKS + _B_BLOCKS:
        n = math.prod(shape)
        out[name] = g[o:o + n].view(shape)
        o += n
    return out


def _pack_layout_grads(g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """A kernel's gradient buffer -> 17 buffers in the `pack_params`
    layout. The x and dir blocks are [raw (8) | zero (8) | sin/cos]; the
    sigma and rgb heads were computed 16 columns wide (col 3 = sigma,
    cols 0..2 = rgb) and land in their 8-wide padded buffers."""
    b = _split_grad(g)
    ws = g.new_zeros((W, 8))
    ws[:, 0] = b["ws16"][:, 3]
    wr = g.new_zeros((WD, 8))
    wr[:, :3] = b["wr16"][:, :3]
    bs = g.new_zeros((1, 8))
    bs[0, :1] = b["bs"]
    br = g.new_zeros((1, 8))
    br[0, :3] = b["br"]
    return (b["w0"][:IN_P], b["w0"][2 * IN_P:], b["wsk"][:IN_P],
            b["wsk"][2 * IN_P:], b["wt"], b["bt"], b["wf"], b["bf"][None],
            b["wdf"], b["wdd"][:IN_P], b["wdd"][2 * IN_P:], b["bd"][None],
            ws, bs, wr, br, g.new_zeros((1, 1)))


# ---------------------------------------------------------------- plain ----

def mlp_forward_reference(packed, x8: torch.Tensor,
                          d8: torch.Tensor) -> torch.Tensor:
    """Plain `fused_nerf_mlp` forward on precast buffers: (P, 8)
    [rgb (3), raw sigma, 0, 0, 0, 0]."""
    sigma, rgb = forward_body(x8, d8, packed)
    return torch.cat([rgb, sigma[:, None], rgb.new_zeros((rgb.shape[0], 4))],
                     dim=-1)


def mlp_backward_reference(packed, x8: torch.Tensor, d8: torch.Tensor,
                           g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain `fused_nerf_mlp` backward: recompute the forward, then the
    weight gradients for the cotangent g (P, 8) = [d rgb (3), d sigma, ...]
    (17 f32 buffers in the `pack_params` layout)."""
    _, _, acts = forward_body(x8, d8, packed, keep_acts=True)
    return mlp_grads(x8, d8, packed, acts, g[:, 0:3], g[:, 3])


def sigma_forward_reference(packed, x8: torch.Tensor) -> torch.Tensor:
    """Plain `nerf_sigma_fused` on precast buffers: raw sigma (P,)."""
    return trunk_body(x8, packed)[0]


# ---------------------------------------------------------------- CUDA ----

_FULL = ("w0", "wt", "wsk", "bt", "ws", "bs", "wf", "bf", "wdf", "wdd", "bd",
         "wr", "br")
_MAX_POINTS = 2 ** 31 - 1       # the kernels index points with an int


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _checked_library():
    """The kernels' library, its gradient layout checked against ours."""
    from ._build import load_library
    lib = load_library()
    n = lib.nerf_grad_floats()
    if n != GRAD_FLOATS:
        raise RuntimeError(f"gradient layout mismatch: kernel {n} floats, "
                           f"wrapper {GRAD_FLOATS}")
    return lib


def _check_points(mlp: PackedMLP, **points: torch.Tensor):
    if mlp.kernel is None:
        raise ValueError("weights were packed for the CPU, not for a GPU")
    first = next(iter(points.values()))
    for name, t in points.items():
        if t.dim() != 2 or t.shape != (first.shape[0], IN_P):
            raise ValueError(f"want {', '.join(points)} of shape (P, {IN_P});"
                             f" got {name} {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != first.device:
            raise ValueError(f"{name} is not on {first.device}")
    if first.shape[0] > _MAX_POINTS:
        raise ValueError(f"P = {first.shape[0]} above {_MAX_POINTS}")
    for name, t in mlp.kernel.items():
        if t.device != first.device or not t.is_contiguous():
            raise ValueError(f"weight buffer {name} is not a contiguous "
                             f"tensor on {first.device}")


def _mlp_fwd_cuda(mlp: PackedMLP, x8, d8):
    global mlp_fwd_launches
    _check_points(mlp, x8=x8, d8=d8)
    P = x8.shape[0]
    out = torch.empty((P, 8), dtype=torch.float32, device=x8.device)
    if P == 0:
        return out
    from ._build import load_library
    lib, k = load_library(), mlp.kernel
    with torch.cuda.device(x8.device):
        err = lib.nerf_mlp_fwd(x8.data_ptr(), d8.data_ptr(), P,
                               *(k[n].data_ptr() for n in _FULL),
                               out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mlp_fwd")
    mlp_fwd_launches += 1
    return out


def _sigma_fwd_cuda(mlp: PackedMLP, x8):
    global sigma_fwd_launches
    _check_points(mlp, x8=x8)
    P = x8.shape[0]
    sigma = torch.empty((P,), dtype=torch.float32, device=x8.device)
    if P == 0:
        return sigma
    from ._build import load_library
    lib, k = load_library(), mlp.kernel
    with torch.cuda.device(x8.device):
        err = lib.nerf_sigma_fwd(x8.data_ptr(), P,
                                 *(k[n].data_ptr() for n in _FULL[:6]),
                                 sigma.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sigma_fwd")
    sigma_fwd_launches += 1
    return sigma


def _mlp_bwd_cuda(mlp: PackedMLP, x8, d8, g):
    global mlp_bwd_launches
    _check_points(mlp, x8=x8, d8=d8, g=g)
    P, dev = x8.shape[0], x8.device
    if P == 0:
        return _pack_layout_grads(torch.zeros((GRAD_FLOATS,), device=dev))
    lib = _checked_library()
    workspace = torch.empty((lib.nerf_mlp_workspace_bytes(P),),
                            dtype=torch.uint8, device=dev)
    grad = torch.empty((GRAD_FLOATS,), dtype=torch.float32, device=dev)
    k = mlp.kernel
    with torch.cuda.device(dev):
        err = lib.nerf_mlp_bwd(
            x8.data_ptr(), d8.data_ptr(), g.data_ptr(), P,
            *(k[n].data_ptr() for n in _FULL),
            workspace.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mlp_bwd")
    mlp_bwd_launches += 1
    return _pack_layout_grads(grad)


# ------------------------------------------------------------ dispatch ----

def _on(kernel: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {kernel} kernel for device {t.device}")
    return t.device.type == "cuda"


def mlp_forward(mlp: PackedMLP, x8: torch.Tensor,
                d8: torch.Tensor) -> torch.Tensor:
    """The point-MLP forward on packed weights: (P, 8) raw points and
    directions -> (P, 8) [rgb (3), raw sigma, 0, 0, 0, 0]."""
    if _on("mlp_fwd", x8):
        return _mlp_fwd_cuda(mlp, x8, d8)
    return mlp_forward_reference(mlp.packed, x8, d8)


def mlp_backward(mlp: PackedMLP, x8: torch.Tensor, d8: torch.Tensor,
                 g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The weight gradients of the point MLP for the cotangent g (P, 8) of
    its output: 17 f32 buffers in the `pack_params` layout."""
    if _on("mlp_bwd", x8):
        return _mlp_bwd_cuda(mlp, x8, d8, g)
    return mlp_backward_reference(mlp.packed, x8, d8, g)


def sigma_forward(mlp: PackedMLP, x8: torch.Tensor) -> torch.Tensor:
    """The sigma-only point MLP on packed weights: raw sigma (P,)."""
    if _on("sigma_fwd", x8):
        return _sigma_fwd_cuda(mlp, x8)
    return sigma_forward_reference(mlp.packed, x8)


class _FusedNeRFMLP(torch.autograd.Function):
    """`fused_nerf_mlp` with its custom VJP. The primal weights are the 17
    f32 `pack_params` buffers and the bf16 cast happens in here, so the
    gradients come back in f32, as from the JAX custom VJP, whose primal
    is the f32 pack. The points get no gradients."""

    @staticmethod
    def forward(ctx, x8, d8, *packed):
        ctx.mlp = packed_for(packed, x8.device)
        ctx.save_for_backward(x8, d8)
        return mlp_forward(ctx.mlp, x8, d8)

    @staticmethod
    def backward(ctx, g):
        x8, d8 = ctx.saved_tensors
        grads = mlp_backward(ctx.mlp, x8, d8, g.contiguous())
        return (None, None, *grads)


def fused_nerf_mlp(packed: Tuple[torch.Tensor, ...], x8: torch.Tensor,
                   d8: torch.Tensor, tile: int = 1024) -> torch.Tensor:
    """Fused NeRF MLP on packed raw points, differentiable in `packed`.

    Args:
      packed: the 17 f32 buffers of `pack_params`.
      x8, d8: (P, IN_P) raw positions and view directions in cols 0..2.
      tile: accepted for the JAX signature and not used: the kernel's tile
        is its own and a ragged P is masked, not padded.

    Returns (P, 8): cols 0..2 rgb (after the sigmoid), col 3 raw sigma.
    """
    return _FusedNeRFMLP.apply(x8, d8, *packed)


def _rows8(v: torch.Tensor) -> torch.Tensor:
    """(P, 3) -> (P, IN_P) f32 with zero columns 3.."""
    v = v.float()
    return torch.cat([v, v.new_zeros((v.shape[0], IN_P - 3))], dim=-1)


def nerf_apply_fused(params: MLPArg, xyz: torch.Tensor, dirs: torch.Tensor,
                     tile: int = 1024):
    """Drop-in fused replacement for embed + models.nerf.nerf_apply.

    Args:
      params: one MLP's {layer: {w, b}} (differentiable through
        `pack_params` and `fused_nerf_mlp`), or a PackedMLP from
        `pack_mlp` (inference).
      xyz: (..., 3) RAW sample positions (not embedded).
      dirs: raw view directions broadcastable to xyz's batch shape.
      tile: accepted for the JAX signature and not used.

    Returns (rgb (..., 3), sigma (..., 1)) like nerf_apply.
    """
    batch_shape = xyz.shape[:-1]
    x8 = _rows8(xyz.reshape(-1, 3))
    d8 = _rows8(torch.broadcast_to(dirs, batch_shape + (3,)).reshape(-1, 3))
    if isinstance(params, PackedMLP):
        out = mlp_forward(params, x8, d8)
    else:
        out = fused_nerf_mlp(pack_params(params), x8, d8)
    rgb = out[:, 0:3].reshape(*batch_shape, 3)
    sigma = out[:, 3:4].reshape(*batch_shape, 1)
    return rgb, sigma


def nerf_sigma_fused(params: MLPArg, xyz: torch.Tensor, tile: int = 1024):
    """Fused sigma-only inference: raw xyz (..., 3) -> sigma (..., 1).

    No gradient flows back (the JAX kernel defines none either); `tile` is
    accepted for the JAX signature and not used."""
    batch_shape = xyz.shape[:-1]
    x8 = _rows8(xyz.reshape(-1, 3))
    with torch.no_grad():
        sigma = sigma_forward(_as_packed(params, x8.device), x8)
    return sigma.reshape(*batch_shape, 1)
