"""Everything a run feeds the program, made from `--seed`: the ray store,
the MLPs' weights, the draws of a training step and the cameras of a
render path. The program and the reference get the same inputs; nothing
here imports the program.

Streams: the store, the weights and the render cameras each take a
generator of their own, seeded by `stream_seed(seed, name)`, on the
device the run uses, in a few large calls.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .work import layer_dims

MLPS = ("nerf_coarse", "nerf_fine")


def stream_seed(seed: int, *counters) -> int:
    """A 63-bit generator seed that is a pure function of (seed,
    counters); the same derivation as the program's `seed_for`, which
    the draws of a training step follow (`step_draws`)."""
    ints = [int(c) if not isinstance(c, str) else
            int.from_bytes(c.encode(), "little") for c in counters]
    state = np.random.SeedSequence([int(seed), *ints]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_store(n: int, seed: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training store, bench.py's synthetic one on the device: (n, 8)
    rays [origin ~ N(0, 1), direction ~ N(0, 1) normalised, near 2, far 6]
    and (n, 3) colours uniform in [0, 1)."""
    g = _gen(device, stream_seed(seed, "store"))
    od = torch.randn((n, 6), generator=g, device=device)
    d = od[:, 3:6] / torch.linalg.norm(od[:, 3:6], dim=-1, keepdim=True)
    nf = torch.tensor([2.0, 6.0], device=device).expand(n, 2)
    rays = torch.cat([od[:, 0:3], d, nf], dim=1)
    rgbs = torch.rand((n, 3), generator=g, device=device)
    return rays, rgbs


def make_params(model: Dict, seed: int, device: torch.device,
                sigma_abs_scale: Optional[float] = None
                ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Both MLPs' weights and biases, torch.nn.Linear's init U(-1/sqrt(fan
    in), 1/sqrt(fan in)) in (fan_in, fan_out) layout, from one draw of
    uniforms on the device.

    With `sigma_abs_scale` the density head's weights are their absolute
    values times it and its bias 0: the density is then positive
    everywhere (the trunk's outputs are ReLUs), a fog with structure. At
    the init's own scale a frame is all but empty (opacity under 1e-3),
    and a field whose density crosses 0 at a ray's last sample, whose
    interval is 1e10, flips that ray's opacity between ~0.3 and 1 on one
    rounding, which no comparison of two precisions can hold."""
    dims = layer_dims(model)
    sizes = [fi * fo + fo for fi, fo in dims.values()]
    g = _gen(device, stream_seed(seed, "params"))
    u = torch.rand((len(MLPS), sum(sizes)), generator=g, device=device)
    params = {}
    for m, name in enumerate(MLPS):
        mlp, o = {}, 0
        for layer, (fi, fo) in dims.items():
            bound = 1.0 / math.sqrt(fi)
            w = u[m, o:o + fi * fo].reshape(fi, fo)
            b = u[m, o + fi * fo:o + fi * fo + fo]
            w, b = (2 * w - 1) * bound, (2 * b - 1) * bound
            if layer == "sigma" and sigma_abs_scale is not None:
                w, b = sigma_abs_scale * w.abs(), torch.zeros_like(b)
            mlp[layer] = {"w": w.contiguous(), "b": b.contiguous()}
            o += fi * fo + fo
        params[name] = mlp
    return params


def draw_specs(render: Dict, R: int):
    """(name, shape, uniform) of a training step's draws, in the order the
    program's Trainer takes them (its `_draw_specs`)."""
    S, S_imp = render["N_samples"], render["N_importance"]
    specs = []
    if render["perturb"] > 0:
        specs.append(("perturb", (R, S), True))
    if render["noise_std"] > 0:
        specs.append(("noise_coarse", (R, S), False))
    if S_imp > 0 and render["perturb"] > 0:
        specs.append(("u", (R, S_imp), True))
    if S_imp > 0 and render["noise_std"] > 0:
        specs.append(("noise_fine", (R, S + S_imp), False))
    return specs


def step_draws(render: Dict, R: int, seed: int, step: int, data_index: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """The random draws of training step `step` on data index
    `data_index`, as the program's Trainer makes them from `seed`: a
    generator on the device seeded with seed_for(seed, step) (data index
    0) or seed_for(seed, step, data_index), filled in order."""
    s = (stream_seed(seed, step) if data_index == 0
         else stream_seed(seed, step, data_index))
    g = _gen(device, s)
    out = {}
    for name, shape, uniform in draw_specs(render, R):
        buf = torch.empty(shape, device=device)
        if uniform:
            buf.uniform_(generator=g)
        else:
            buf.normal_(generator=g)
        out[name] = buf
    return out


def shard_rows(n: int, global_batch: int, world: int) -> int:
    """Rows of one shard of the program's `set_data` layout: the store
    padded to whole global batches, split into `world` shards."""
    return (n + (-n) % global_batch) // world


def store_order(n: int, shuffle_seed: int, global_batch: int,
                world: int) -> Tuple[np.ndarray, int]:
    """The program's `set_data` layout: the store's rows permuted by
    default_rng(shuffle_seed), padded to whole global batches by repeating
    the head, and split into `world` contiguous shards. Returns (the
    original row of each padded row, the rows of one shard)."""
    perm = np.random.default_rng(shuffle_seed).permutation(n)
    pad = (-n) % global_batch
    if pad:
        perm = np.concatenate([perm, perm[np.arange(pad) % n]])
    return perm, shard_rows(n, global_batch, world)


def sphere_pose(theta: float, phi: float, radius: float) -> torch.Tensor:
    """(3, 4) c2w of a camera at azimuth theta, elevation phi, on a sphere
    of `radius`, looking at the origin with +z up."""
    pos = torch.tensor([math.cos(theta) * math.cos(phi),
                        math.sin(theta) * math.cos(phi),
                        math.sin(phi)], dtype=torch.float64) * radius
    z = pos / torch.linalg.norm(pos)
    x = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                           z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z, pos], dim=1)


def frame_rays(ev: Dict, pose: int, device: torch.device) -> torch.Tensor:
    """(H*W, 8) rays of view `pose` of the render path: `poses` cameras
    evenly around the sphere, a blender camera (focal from
    camera_angle_x), directions ((i - W/2)/f, -(j - H/2)/f, -1) rotated
    to the world and normalised, near and far as given."""
    W, H = ev["img_wh"]
    focal = 0.5 * W / math.tan(0.5 * ev["camera_angle_x"])
    c2w = sphere_pose(2 * math.pi * pose / ev["poses"], ev["elevation"],
                      ev["radius"]).to(torch.float32).to(device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    dirs = torch.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                        -torch.ones_like(i)], dim=-1).reshape(-1, 3)
    d = dirs @ c2w[:, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = c2w[:, 3].expand(d.shape)
    nf = torch.tensor([ev["near"], ev["far"]], device=device).expand(
        d.shape[0], 2)
    return torch.cat([o, d, nf], dim=1).contiguous()
