"""The NeRF MLP over a {layer: {w, b}} parameter dict.

Port of nerf_pl_tpu/models/nerf.py. Weights are stored (fan_in, fan_out),
the JAX layout, so a checkpoint's arrays load with no transposes and the
fused kernels' packing (ops/fused_mlp.py) reads them as they are.
`nerf_apply` is a plain function of a nested dict of tensors; `NeRF` is an
nn.Module holding the same dict as parameters.
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


def _linear(p, x, compute_dtype):
    """x @ w + b with operands rounded to compute_dtype and f32 sums (the
    JAX package's preferred_element_type=float32)."""
    w = p["w"].to(compute_dtype).float()
    return x.to(compute_dtype).float() @ w + p["b"]


def nerf_apply(params: Params,
               xyz_emb: torch.Tensor,
               dir_emb: Optional[torch.Tensor] = None,
               cfg: NeRFConfig = NeRFConfig(),
               sigma_only: bool = False,
               compute_dtype: torch.dtype = torch.float32):
    """Apply the NeRF MLP to embedded points.

    Returns sigma (..., 1) if sigma_only else (rgb (..., 3), sigma (..., 1));
    sigma is the raw (pre-ReLU) density, rgb is post-sigmoid. dir_emb
    broadcasts against the points' batch shape.
    """
    h = xyz_emb
    for i in range(cfg.D):
        if i in cfg.skips:
            h = torch.cat([xyz_emb, h], dim=-1)
        h = torch.relu(_linear(params[f"xyz_{i}"], h, compute_dtype))
    sigma = _linear(params["sigma"], h, compute_dtype)
    if sigma_only:
        return sigma

    feat = _linear(params["xyz_final"], h, compute_dtype)
    d = dir_emb.expand(*feat.shape[:-1], dir_emb.shape[-1])
    hdir = torch.relu(_linear(params["dir"], torch.cat([feat, d], dim=-1),
                              compute_dtype))
    rgb = torch.sigmoid(_linear(params["rgb"], hdir, compute_dtype))
    return rgb, sigma


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
