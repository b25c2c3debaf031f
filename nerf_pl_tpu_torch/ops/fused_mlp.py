"""Packing of one NeRF MLP for the fused kernels, and the plain forward body.

Port of the layout half of nerf_pl_tpu/ops/fused_mlp.py: `pack_params`
keeps its 17-buffer layout, `unpack_grads` maps gradients in that layout
back onto the {layer: {w, b}} dict, `forward_body` computes what its Pallas
`_forward_body` computes, and `mlp_grads` what its `_mlp_grads` computes
from the activations `forward_body(keep_acts=True)` returns. The point-MLP
kernels themselves (`fused_nerf_mlp`, `nerf_sigma_fused`) are not ported
yet.

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

from typing import Dict, List, Mapping, NamedTuple, Tuple

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
