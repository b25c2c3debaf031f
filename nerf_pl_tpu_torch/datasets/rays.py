"""Camera rays and sphere poses, built in torch on any device.

Counterpart of `get_ray_directions` / `get_rays` in
nerf_pl_tpu/datasets/ray_utils.py (OpenGL camera looking down -z, no +0.5
pixel centering) and of `look_at_pose` in nerf_pl_tpu/utils/synthetic.py.
The dataset classes (`blender`, `llff`) build their rays in numpy; this
module lets a caller build cameras on the device without them.
"""
from __future__ import annotations

import math

import torch


def get_ray_directions(H: int, W: int, focal: float,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """(H, W, 3) camera-frame directions ((i - W/2)/f, -(j - H/2)/f, -1)."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                        -torch.ones_like(i)], dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """World rays of one camera: origins and unit directions, (H*W, 3) each.
    c2w: (3, 4) camera-to-world [R | t]."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=directions.device)
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3).contiguous(), rays_d.reshape(-1, 3).contiguous()


def sphere_pose(theta: float, phi: float, radius: float) -> torch.Tensor:
    """(3, 4) float64 c2w of a camera at azimuth theta and elevation phi on
    a sphere of `radius`, looking at the origin with +z up."""
    pos = torch.tensor([math.cos(theta) * math.cos(phi),
                        math.sin(theta) * math.cos(phi),
                        math.sin(phi)], dtype=torch.float64) * radius
    z = pos / torch.linalg.norm(pos)
    x = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                           z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z, pos], dim=1)


def frame_rays(c2w: torch.Tensor, H: int, W: int, focal: float, near: float,
               far: float, device: torch.device | str = "cpu") -> torch.Tensor:
    """(H*W, 8) rays [o, d, near, far] of one camera."""
    rays_o, rays_d = get_rays(get_ray_directions(H, W, focal, device), c2w)
    n = rays_o.shape[0]
    bounds = torch.tensor([near, far], dtype=torch.float32,
                          device=rays_o.device).expand(n, 2)
    return torch.cat([rays_o, rays_d, bounds], dim=-1)
