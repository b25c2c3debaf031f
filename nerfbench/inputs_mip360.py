"""What a run of the mip-NeRF 360 configuration feeds the program and the
reference, made from `--seed` with `inputs.stream_seed`'s streams: the ray
store, both MLPs' weights and a training step's draws. Nothing here
imports the program.

The store is shaped like a mip-NeRF 360 outdoor capture at factor 4:
`views` cameras of `img_wh` pixels at `focal` pixels, each on the unit
sphere around the scene's centre and looking at it (+z up), a ray from
one camera through one pixel (both uniform), its direction the camera's
((i - W/2)/f, -(j - H/2)/f, -1) rotated to the world and not normalised,
its pixel radius |d(i + 1, j) - d(i, j)| 2 / sqrt(12) = 2 / (f sqrt(12)),
near and far the configuration's; colours uniform in [0, 1).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .inputs import _gen, stream_seed
from .work_mip360 import layer_dims


def make_store(cfg: Dict, n: int, seed: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rays (n, 8), rgbs (n, 3), radii (n,)) on the device."""
    st = cfg["store"]
    W, H = st["img_wh"]
    f = float(st["focal"])
    g = _gen(device, stream_seed(seed, "store"))
    cam = torch.randn((st["views"], 3), generator=g, device=device)
    pos = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=device).expand_as(pos)
    z = pos                                # the camera looks down -z
    x = torch.linalg.cross(up, z)
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                        min=1e-6)
    y = torch.linalg.cross(z, x)
    rot = torch.stack([x, y, z], dim=-1)   # (views, 3, 3): columns x y z
    which = torch.randint(0, st["views"], (n,), generator=g, device=device)
    px = torch.rand((n, 2), generator=g, device=device)
    i = torch.floor(px[:, 0] * W)
    j = torch.floor(px[:, 1] * H)
    dirs = torch.stack([(i - W / 2) / f, -(j - H / 2) / f,
                        -torch.ones_like(i)], dim=-1)
    d = torch.einsum("nij,nj->ni", rot[which], dirs)
    nf = torch.tensor([st["near"], st["far"]], device=device).expand(n, 2)
    rays = torch.cat([pos[which], d, nf], dim=1).contiguous()
    rgbs = torch.rand((n, 3), generator=g, device=device)
    radii = torch.full((n,), 2.0 / (f * math.sqrt(12.0)), device=device)
    return rays, rgbs, radii


def make_params(model: Dict, seed: int, device: torch.device
                ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Both MLPs' weights, multinerf's init: He-uniform U(-sqrt(6 / fan
    in), sqrt(6 / fan in)) in (fan_in, fan_out) layout from one draw of
    uniforms on the device, and zero biases."""
    dims = layer_dims(model)
    sizes = [fi * fo for layers in dims.values() for fi, fo in
             layers.values()]
    g = _gen(device, stream_seed(seed, "params"))
    u = torch.rand((sum(sizes),), generator=g, device=device)
    params, o = {}, 0
    for mlp, layers in dims.items():
        params[mlp] = {}
        for name, (fi, fo) in layers.items():
            w = u[o:o + fi * fo].reshape(fi, fo)
            params[mlp][name] = {
                "w": ((2 * w - 1) * math.sqrt(6.0 / fi)).contiguous(),
                "b": torch.zeros(fo, device=device)}
            o += fi * fo
    return params


def step_draws(cfg: Dict, R: int, seed: int, step: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Step `step`'s draws as the program's Trainer makes them from
    `seed` (one device, data index 0): jitter (R, levels) uniform, from a
    generator seeded with seed_for(seed, step)."""
    g = _gen(device, stream_seed(seed, step))
    levels = len(cfg["render"]["num_prop_samples"]) + 1
    jitter = torch.empty((R, levels), device=device)
    jitter.uniform_(generator=g)
    return {"jitter": jitter}
