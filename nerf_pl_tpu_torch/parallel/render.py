"""Full-image renderer: pad, chunk, render, slice.

Port of `Trainer.render_fn` (nerf_pl_tpu/parallel/spmd.py) for one device.
The JAX version maps `render_rays` over fixed tiles sharded across a mesh;
here the tiles run in a Python loop on one device. Sharding across GPUs
is ROADMAP item A10.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from ..models.nerf import params_from_numpy
from ..ops.fused_render import pack_mlp
from ..rendering.render import ModelConfig, RenderConfig, render_rays


def make_render_fn(rcfg: RenderConfig, chunk: int,
                   device: torch.device | str,
                   mcfg: ModelConfig = ModelConfig(),
                   device_out: bool = False) -> Callable:
    """Returns render(params, rays) -> dict of per-ray outputs.

    `rays` (R, 8), numpy or tensor, is padded to whole chunks with zero
    rays whose far is 1 (near < far keeps their depths sane; their
    direction is 0, so their weights are 0), rendered chunk by chunk, and
    the padding is sliced off. On the fused path both MLPs are packed to
    the kernels' bf16 device buffers once per call, not once per chunk.
    With device_out the outputs stay tensors on `device`; otherwise they
    are numpy arrays.
    """
    device = torch.device(device)

    def prepare(params: Mapping[str, Any]) -> Dict[str, Any]:
        model = {name: params_from_numpy(mlp, device)
                 for name, mlp in params.items()}
        if rcfg.fused:
            return {name: pack_mlp(mlp, device) for name, mlp in model.items()}
        return model

    @torch.no_grad()
    def render(params: Mapping[str, Any], rays) -> Dict[str, Any]:
        rays_t = torch.as_tensor(rays, dtype=torch.float32, device=device)
        R = rays_t.shape[0]
        pad = (-R) % chunk
        if pad:
            pad_rows = torch.zeros((pad, 8), dtype=rays_t.dtype, device=device)
            pad_rows[:, 7] = 1.0
            rays_t = torch.cat([rays_t, pad_rows])
        model = prepare(params)
        outs = [render_rays(model, tile, rcfg, mcfg)
                for tile in rays_t.split(chunk)]
        out = {k: torch.cat([o[k] for o in outs])[:R] for k in outs[0]}
        if device_out:
            return out
        return {k: v.cpu().numpy() for k, v in out.items()}

    return render
