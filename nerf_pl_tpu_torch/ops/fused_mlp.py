"""Packing of one NeRF MLP for the fused kernels, and the plain forward body.

Port of the layout half of nerf_pl_tpu/ops/fused_mlp.py: `pack_params`
keeps its 17-buffer layout, and `forward_body` computes what its Pallas
`_forward_body` computes. The point-MLP kernels themselves
(`fused_nerf_mlp`, `nerf_sigma_fused`) are not ported yet.

Numerics of `forward_body`, as in the TPU kernel:
  * every MLP product takes bf16 operands and sums in f32, emulated as
    a.bfloat16().float() @ w.bfloat16().float() (exact products, f32 sums);
  * activations are stored in bf16 after each ReLU (and the linear feature
    layer);
  * the phase x * 2^k is exact in f32 and the cos columns are
    sin(t + pi/2), so the embedding is one sin() over the phase block.
The f32 products need TF32 off on a GPU
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default).
"""
from __future__ import annotations

from typing import Mapping, Tuple

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


def trunk_body(p8: torch.Tensor, packed) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density trunk: (T, IN_P) raw points -> (raw sigma (T,), last trunk
    activation (T, W) with bf16 values)."""
    (w0r, w0e, wskr, wske, wt, bt, _wf, _bf, _wdf, _wddr, _wdde, _bd,
     ws, bs, *_rest) = packed
    ex = _bf16(embed_sincos(p8, FX, EX))
    h = _bf16(torch.relu(_dot(p8, w0r) + _dot(ex, w0e) + bt[0][None]))
    for i in range(1, D):
        t = _dot(h, wt[i - 1]) + bt[i][None]
        if i == SKIP_LAYER:
            t = t + _dot(p8, wskr) + _dot(ex, wske)
        h = _bf16(torch.relu(t))
    sigma = (_dot(h, ws) + bs)[:, 0]
    return sigma, h


def forward_body(p8: torch.Tensor, d8: torch.Tensor, packed
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MLP: (T, IN_P) raw points and directions -> (raw sigma (T,),
    rgb (T, 3) after the sigmoid)."""
    (_w0r, _w0e, _wskr, _wske, _wt, _bt, wf, bf, wdf, wddr, wdde, bd,
     _ws, _bs, wr, br, _) = packed
    sigma, h = trunk_body(p8, packed)
    feat = _bf16(_dot(h, wf) + bf)                # linear
    ed = _bf16(embed_sincos(d8, FD, ED))
    hd = _bf16(torch.relu(_dot(feat, wdf) + _dot(d8, wddr) + _dot(ed, wdde)
                          + bd))
    rgb = torch.sigmoid(_dot(hd, wr) + br)[:, :3]
    return sigma, rgb
