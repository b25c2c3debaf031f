"""Full-image renderer: pad, tile, render, gather, slice.

Port of `Trainer.render_fn` (nerf_pl_tpu/parallel/spmd.py:598-654). The
JAX version pads the rays to whole groups of `n_data * chunk`, shards the
tiles over the mesh's `data` axis and maps `render_rays` over each
device's tiles. Here each rank of a torch.distributed group renders its
contiguous block of tiles in a Python loop, and the blocks are gathered on
every rank (`dist.gather_rows`); without a group one device renders them
all.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from .. import dist as pdist
from ..rendering.render import (ModelConfig, RenderConfig, prepare_params,
                                render_rays)
from ..utils import profiling as P


def make_render_fn(rcfg: RenderConfig, chunk: int,
                   device: torch.device | str,
                   mcfg: ModelConfig = ModelConfig(),
                   device_out: bool = False, group=None) -> Callable:
    """Returns render(params, rays) -> dict of per-ray outputs.

    `rays` (R, 8), numpy or tensor, is padded to whole groups of
    world * chunk rays with zero rays whose far is 1 (near < far keeps
    their depths sane; their direction is 0, so their weights are 0),
    rendered chunk by chunk, each rank of `group` its contiguous block of
    chunks, and the padding is sliced off. Every rank of the group must
    call it with the same rays; each gets the whole output. With
    rcfg.fused both MLPs are packed to the kernels' bf16 device buffers
    once per call, not once per chunk: the render kernels take them at
    test time, the point-MLP forward kernel otherwise (the validation
    config). With device_out the outputs stay tensors on `device`;
    otherwise they are numpy arrays.

    A call's phases (utils/profiling.py: a span each, with its mark on
    CUDA, while a profiler records) are `frame.pad`, `frame.pack`, each
    tile's `coarse_z`, `coarse`, `fine_z` and `fine` (render_rays),
    `frame.gather`, `frame.to_host` (the copies to the host), then the
    mark `end`.
    """
    device = torch.device(device)
    world, rank = pdist.world_of(group), pdist.rank_of(group)

    @torch.no_grad()
    def render(params: Mapping[str, Any], rays) -> Dict[str, Any]:
        with P.phase("frame.pad", device):
            rays_t = torch.as_tensor(rays, dtype=torch.float32,
                                     device=device)
            R = rays_t.shape[0]
            pad = (-R) % (world * chunk)
            if pad:
                pad_rows = torch.zeros((pad, 8), dtype=rays_t.dtype,
                                       device=device)
                pad_rows[:, 7] = 1.0
                rays_t = torch.cat([rays_t, pad_rows])
        with P.phase("frame.pack", device):
            model = prepare_params(params, rcfg, device)
        tiles = rays_t.split(chunk)
        per = len(tiles) // world
        outs = [render_rays(model, tile, rcfg, mcfg)
                for tile in tiles[rank * per:(rank + 1) * per]]
        with P.phase("frame.gather", device):
            out = pdist.gather_rows(
                {k: torch.cat([o[k] for o in outs]) for k in outs[0]}, group)
            out = {k: v[:R] for k, v in out.items()}
        if not device_out:
            with P.phase("frame.to_host", device):
                out = {k: v.cpu().numpy() for k, v in out.items()}
        P.mark("end", device)
        return out

    return render
