"""The NeRF MLP over a {layer: {w, b}} parameter dict.

Port of nerf_pl_tpu/models/nerf.py. Weights are stored (fan_in, fan_out),
the JAX layout, so a checkpoint's arrays load with no transposes and the
fused kernels' packing (ops/fused_mlp.py) reads them as they are.
`nerf_apply` is a plain function of a nested dict of tensors; `NeRF` is an
nn.Module holding the same dict as parameters. Given a tensor parallel
layout (`parallel/mesh.py::TensorParallel`), `nerf_apply` runs the
Megatron MLP on this rank's blocks of the weights, as GSPMD partitions
the JAX MLP from its PartitionSpecs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Params = Mapping[str, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """NeRF MLP hyperparameters (the JAX package's defaults)."""
    D: int = 8
    W: int = 256
    in_channels_xyz: int = 63   # 3 + 3*10*2
    in_channels_dir: int = 27   # 3 + 3*4*2
    skips: Tuple[int, ...] = (4,)

    def layer_dims(self):
        """[(in, out)] for the D trunk layers."""
        dims = []
        for i in range(self.D):
            if i == 0:
                dims.append((self.in_channels_xyz, self.W))
            elif i in self.skips:
                dims.append((self.W + self.in_channels_xyz, self.W))
            else:
                dims.append((self.W, self.W))
        return dims

    def all_layer_dims(self) -> Dict[str, Tuple[int, int]]:
        """{layer name: (fan_in, fan_out)} in init order."""
        dims = {f"xyz_{i}": d for i, d in enumerate(self.layer_dims())}
        dims["xyz_final"] = (self.W, self.W)
        dims["dir"] = (self.W + self.in_channels_dir, self.W // 2)
        dims["sigma"] = (self.W, 1)
        dims["rgb"] = (self.W // 2, 3)
        return dims


def init_nerf_params(generator: torch.Generator,
                     cfg: NeRFConfig = NeRFConfig(),
                     device: torch.device | str = "cpu",
                     dtype: torch.dtype = torch.float32
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    for weight and bias, drawn from `generator` on the CPU and moved to
    `device`. Layer names match the JAX package's."""
    params = {}
    for name, (fi, fo) in cfg.all_layer_dims().items():
        bound = 1.0 / fi ** 0.5
        w = torch.rand((fi, fo), generator=generator, dtype=dtype)
        b = torch.rand((fo,), generator=generator, dtype=dtype)
        params[name] = {"w": ((2 * w - 1) * bound).to(device),
                        "b": ((2 * b - 1) * bound).to(device)}
    return params


def params_from_numpy(arrays: Mapping[str, Mapping[str, np.ndarray]],
                      device: torch.device | str = "cpu",
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's parameters (numpy arrays keyed as in its
    init_nerf_params) as the port's nested dict of tensors on `device`.
    Tensor leaves are moved (not copied when already there)."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=dtype)
        return torch.as_tensor(np.array(v), dtype=dtype, device=device)

    return {layer: {name: leaf(v) for name, v in leaves.items()}
            for layer, leaves in arrays.items()}


def _matmul(w, x, compute_dtype):
    """x @ w with operands rounded to compute_dtype and f32 sums (the JAX
    package's preferred_element_type=float32)."""
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def _linear(p, x, compute_dtype):
    return _matmul(p["w"], x, compute_dtype) + p["b"]


def _layer(params, name, x, split, compute_dtype, tp):
    """One linear layer on x, whose last dim is split over the model axis
    iff `split`: (y, whether y's is). Without tp, x @ w + b. With tp, by
    the layer's spec: a column layer copies a whole x to the model axis
    and gives its block of y; a row layer takes its block of x, reduces
    x @ w over the axis and adds b once; a whole layer takes a whole x.
    A split x is gathered, a whole one sliced, where the layer needs it."""
    p = params[name]
    kind = None if tp is None else tp.kind(name)
    if kind == "row":
        if not split:
            x = tp.scatter(x)
        return tp.reduce(_matmul(p["w"], x, compute_dtype)) + p["b"], False
    if split:
        x = tp.gather(x)
    if kind == "column":
        return _linear(p, tp.copy(x), compute_dtype), True
    return _linear(p, x, compute_dtype), False


def nerf_apply(params: Params,
               xyz_emb: torch.Tensor,
               dir_emb: Optional[torch.Tensor] = None,
               cfg: NeRFConfig = NeRFConfig(),
               sigma_only: bool = False,
               compute_dtype: torch.dtype = torch.float32,
               tp=None):
    """Apply the NeRF MLP to embedded points.

    Returns sigma (..., 1) if sigma_only else (rgb (..., 3), sigma (..., 1));
    sigma is the raw (pre-ReLU) density, rgb is post-sigmoid. dir_emb
    broadcasts against the points' batch shape. tp: None, or the
    TensorParallel layout whose blocks `params` holds; the skip concat and
    the view branch then see whole activations, and so do the outputs.
    """
    h, split = xyz_emb, False
    for i in range(cfg.D):
        if i in cfg.skips:
            h = torch.cat([xyz_emb, tp.gather(h) if split else h], dim=-1)
            split = False
        h, split = _layer(params, f"xyz_{i}", h, split, compute_dtype, tp)
        h = torch.relu(h)
    sigma, _ = _layer(params, "sigma", h, split, compute_dtype, tp)
    if sigma_only:
        return sigma

    feat, split = _layer(params, "xyz_final", h, split, compute_dtype, tp)
    if split:
        feat = tp.gather(feat)
    d = dir_emb.expand(*feat.shape[:-1], dir_emb.shape[-1])
    hdir, _ = _layer(params, "dir", torch.cat([feat, d], dim=-1), False,
                     compute_dtype, tp)
    rgb, _ = _layer(params, "rgb", torch.relu(hdir), False, compute_dtype,
                    tp)
    return torch.sigmoid(rgb), sigma


class NeRF(nn.Module):
    """The MLP as a module; `self.layers[name][leaf]` is the parameter dict
    `nerf_apply` takes."""

    def __init__(self, cfg: NeRFConfig = NeRFConfig(),
                 params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise ValueError("NeRF needs params or a generator")
            params = init_nerf_params(generator, cfg)
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({k: nn.Parameter(v.clone())
                                    for k, v in leaves.items()})
            for name, leaves in params.items()})

    def forward(self, xyz_emb, dir_emb=None, sigma_only=False,
                compute_dtype=torch.float32):
        return nerf_apply(self.layers, xyz_emb, dir_emb, self.cfg,
                          sigma_only, compute_dtype)
