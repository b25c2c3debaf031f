"""mip-NeRF 360's two MLPs over {layer: {w, b}} parameter dicts.

Barron et al., "Mip-NeRF 360: Unbounded Anti-Aliased Neural Radiance
Fields" (CVPR 2022), at google-research/multinerf's configs/360.gin:

  * the proposal MLP `prop_mlp`: the IPE (72 wide) -> 4 x 256 (ReLU) ->
    density; one set of weights serves both proposal levels;
  * the NeRF MLP `nerf_mlp`: the IPE -> 8 x 1024 (ReLU), the IPE
    concatenated to the output of layer 4 (multinerf's skip_layer 4: layer
    5 takes 1024 + 72), density from the trunk, a 256-wide bottleneck with
    no activation, the bottleneck with gamma(d) (27 wide) into one 128-wide
    view layer (ReLU), rgb;
  * density = softplus(raw - 1); rgb = sigmoid(raw) (1 + 2 * 0.001) - 0.001.

Weights are stored (fan_in, fan_out), as the NeRF MLPs' are, so
checkpoints and the Adam kernel's table take them as they are: 10 leaves
for the proposal MLP and 24 for the NeRF MLP. The init is multinerf's:
He-uniform weights, zero biases.

`MipConfig.precision` is the products' operand precision: "bfloat16" runs
each hidden layer as one cuBLAS product on bf16 operands with f32
accumulation, the bias and the ReLU applied in its epilogue
(`_DenseReLU`), its output the next layer's bf16 operand; the heads whose
outputs leave the MLP (density and rgb) keep their f32 sums
(`_HeadProduct`: a bf16 rounding of raw density near 8 is 3% of it).
Products whose output or input width is not a multiple of 8 (the heads'
1 and 3 columns, the view layer's 256 + 27 inputs) are padded with zero
columns so that cuBLAS takes its Hopper kernels, not its unaligned ones.
"float32" runs everything in float32 (the CPU's tests against the plain
reference). Master weights are float32 either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.relu_bgrad import relu_bgrad

Params = Dict[str, Dict[str, torch.Tensor]]
MLPS = ("prop_mlp", "nerf_mlp")


@dataclasses.dataclass(frozen=True)
class MipConfig:
    """The model, its sampler and its losses (configs/360.gin's values)."""
    prop_depth: int = 4
    prop_width: int = 256
    nerf_depth: int = 8
    nerf_width: int = 1024
    skip_layer: int = 4
    bottleneck_width: int = 256
    view_width: int = 128
    min_deg_point: int = 0
    max_deg_point: int = 12
    deg_view: int = 4
    density_bias: float = -1.0
    rgb_padding: float = 0.001
    num_prop_samples: Tuple[int, ...] = (64, 64)
    num_nerf_samples: int = 32
    charb_padding: float = 0.001
    interlevel_mult: float = 1.0
    distortion_mult: float = 0.01
    precision: str = "bfloat16"

    @property
    def enc_width(self) -> int:
        return 6 * (self.max_deg_point - self.min_deg_point)

    @property
    def view_enc_width(self) -> int:
        return 3 + 6 * self.deg_view

    def layer_dims(self) -> Dict[str, Dict[str, Tuple[int, int]]]:
        """{mlp: {layer: (fan_in, fan_out)}} in init order."""
        k, w = self.enc_width, self.prop_width
        prop = {f"layer_{i}": (k if i == 0 else w, w)
                for i in range(self.prop_depth)}
        prop["density"] = (w, 1)
        w = self.nerf_width
        nerf = {}
        for i in range(self.nerf_depth):
            fi = k if i == 0 else (w + k if self._skip_before(i) else w)
            nerf[f"layer_{i}"] = (fi, w)
        nerf["density"] = (w, 1)
        nerf["bottleneck"] = (w, self.bottleneck_width)
        nerf["view"] = (self.bottleneck_width + self.view_enc_width,
                        self.view_width)
        nerf["rgb"] = (self.view_width, 3)
        return {"prop_mlp": prop, "nerf_mlp": nerf}

    def _skip_before(self, i: int) -> bool:
        """Whether layer i takes the encoding concatenated to its input
        (multinerf concatenates after layer j when j % skip == 0, j > 0)."""
        return i > 1 and (i - 1) % self.skip_layer == 0


def init_mip_params(generator: torch.Generator, cfg: MipConfig,
                    device: torch.device | str = "cpu") -> Params:
    """Both MLPs: He-uniform weights U(-sqrt(6 / fan_in), sqrt(6 /
    fan_in)) drawn from `generator` on the CPU, zero biases."""
    params = {}
    for mlp, dims in cfg.layer_dims().items():
        params[mlp] = {}
        for name, (fi, fo) in dims.items():
            bound = math.sqrt(6.0 / fi)
            w = torch.rand((fi, fo), generator=generator)
            params[mlp][name] = {"w": ((2 * w - 1) * bound).to(device),
                                 "b": torch.zeros(fo, device=device)}
    return params


class _DenseReLU(torch.autograd.Function):
    """relu(x @ w + b) on bf16 operands (the float32 master w and b
    rounded) with f32 sums, the bias and the ReLU in cuBLAS's epilogue: the
    one rounding to bf16 of relu(acc + b), as addmm then relu rounds it,
    with no pass of its own. The backward is addmm's and relu's: the
    ReLU's mask from the output and the bias's float32 column sums in one
    pass (ops/relu_bgrad.py: one launch pair on CUDA), then the data
    gradient in bf16 (none for an input that needs none) and the weight's
    sums widened to float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        wb = w.to(torch.bfloat16)
        y = torch._addmm_activation(b.to(torch.bfloat16), x, wb)
        ctx.save_for_backward(x, wb, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, wb, y = ctx.saved_tensors
        g, db = relu_bgrad(grad, y)
        gx = g @ wb.t() if ctx.needs_input_grad[0] else None
        return gx, (x.t() @ g).float(), db


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor, precision: str,
           relu: bool) -> torch.Tensor:
    """x @ w + b (then ReLU): one product on bf16 operands with f32 sums,
    the result in bf16, or in float32 throughout."""
    if precision == "bfloat16":
        x = x.to(torch.bfloat16)
        if relu:
            return _DenseReLU.apply(x, p["w"], p["b"])
        return torch.addmm(p["b"].to(torch.bfloat16), x,
                           p["w"].to(torch.bfloat16))
    y = torch.addmm(p["b"], x, p["w"])
    return torch.relu(y) if relu else y


def _pad8(n: int) -> int:
    return -n % 8


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with the float32 sums kept (cuBLAS's float32
    output on CUDA; the operands widened, exactly, on the CPU)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _HeadProduct(torch.autograd.Function):
    """x (bf16) @ w (float32 master, rounded to a bf16 operand) with a
    float32 result, w's columns padded with zeros to a multiple of 8; the
    backward's products take the same operands: the data gradient in
    bf16, the weight gradient's sums in float32."""

    @staticmethod
    def forward(ctx, x, w):
        n = w.shape[1]
        wb = F.pad(w.to(torch.bfloat16), (0, _pad8(n)))
        ctx.save_for_backward(x, wb)
        return _mm_f32(x, wb)[:, :n]

    @staticmethod
    def backward(ctx, grad):
        x, wb = ctx.saved_tensors
        n = grad.shape[1]
        gb = F.pad(grad.to(torch.bfloat16), (0, wb.shape[1] - n))
        return gb @ wb.t(), _mm_f32(x.t(), gb)[:, :n]


def _head(p: Dict[str, torch.Tensor], x: torch.Tensor,
          precision: str) -> torch.Tensor:
    """x @ w + b of a head whose output leaves the MLP, in float32."""
    if precision == "bfloat16":
        return _HeadProduct.apply(x.to(torch.bfloat16), p["w"]) + p["b"]
    return torch.addmm(p["b"], x, p["w"])


def prop_apply(p: Params, x_enc: torch.Tensor, cfg: MipConfig
               ) -> torch.Tensor:
    """The proposal MLP's density (P,) at encoded points (P, 72)."""
    x = x_enc
    for i in range(cfg.prop_depth):
        x = _dense(p[f"layer_{i}"], x, cfg.precision, True)
    raw = _head(p["density"], x, cfg.precision)[:, 0]
    return F.softplus(raw + cfg.density_bias)


def nerf_apply(p: Params, x_enc: torch.Tensor, d_enc: torch.Tensor,
               cfg: MipConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density (P,), rgb (P, 3)) of the NeRF MLP at encoded points (P,
    72), under view encodings (P, 27)."""
    prec = cfg.precision
    if prec == "bfloat16":
        x_enc, d_enc = x_enc.to(torch.bfloat16), d_enc.to(torch.bfloat16)
    x = x_enc
    for i in range(cfg.nerf_depth):
        if cfg._skip_before(i):
            x = torch.cat([x, x_enc], dim=-1)
        x = _dense(p[f"layer_{i}"], x, prec, True)
    raw = _head(p["density"], x, prec)[:, 0]
    density = F.softplus(raw + cfg.density_bias)
    bottleneck = _dense(p["bottleneck"], x, prec, False)
    pad = _pad8(p["view"]["w"].shape[0]) if prec == "bfloat16" else 0
    view = {"w": F.pad(p["view"]["w"], (0, 0, 0, pad)), "b": p["view"]["b"]}
    x = _dense(view, torch.cat([bottleneck, F.pad(d_enc, (0, pad))], dim=-1),
               prec, True)
    rgb = torch.sigmoid(_head(p["rgb"], x, prec))
    return density, rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding
