"""Ray geometry: pixel grid -> camera rays -> world rays -> NDC rays.

The port's own copy of nerf_pl_tpu/datasets/ray_utils.py, unchanged.

Host-side numpy implementations (rays are pre-baked once per scene and shipped
to device HBM as flat arrays, so this math is not on the hot path). Conventions
match the reference (datasets/ray_utils.py:5-94 in kwea123/nerf_pl):
OpenGL-style camera (x right, y up, z backward / looking down -z), and NO +0.5
pixel centering (reference ray_utils.py:19-22).
"""
from __future__ import annotations

import numpy as np


def get_ray_directions(H: int, W: int, focal: float) -> np.ndarray:
    """Per-pixel ray directions in the camera frame.

    Parity: reference datasets/ray_utils.py:5-24.

    Returns: (H, W, 3) float32, direction = ((i-W/2)/f, -(j-H/2)/f, -1)
    where i is the column (x) and j the row (y) pixel index.
    """
    j, i = np.meshgrid(
        np.arange(H, dtype=np.float32),
        np.arange(W, dtype=np.float32),
        indexing="ij",
    )
    directions = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], axis=-1
    )
    return directions.astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-space ray origins and *normalized* directions for one camera.

    Parity: reference datasets/ray_utils.py:27-50.

    Args:
      directions: (H, W, 3) camera-space directions from get_ray_directions.
      c2w: (3, 4) camera-to-world matrix [R|t].

    Returns: rays_o (H*W, 3), rays_d (H*W, 3) — d normalized to unit length.
    """
    c2w = np.asarray(c2w, dtype=np.float32)
    rays_d = directions @ c2w[:, :3].T  # (H, W, 3)
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return (
        np.ascontiguousarray(rays_o.reshape(-1, 3), dtype=np.float32),
        np.ascontiguousarray(rays_d.reshape(-1, 3), dtype=np.float32),
    )


def get_ndc_rays(H: int, W: int, focal: float, near: float,
                 rays_o: np.ndarray, rays_d: np.ndarray):
    """Warp world rays into the [-1,1]^3 NDC cube (forward-facing scenes).

    Parity: reference datasets/ray_utils.py:53-94 (shift to near plane, then
    the projective transform from the original NeRF NDC derivation).

    Args:
      rays_o, rays_d: (N, 3). Returns the transformed (N, 3) pair.
    """
    rays_o = np.asarray(rays_o, dtype=np.float32)
    rays_d = np.asarray(rays_d, dtype=np.float32)

    # Shift ray origins onto the near plane (z = -near).
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    rays_o = np.stack([o0, o1, o2], axis=-1).astype(np.float32)
    rays_d = np.stack([d0, d1, d2], axis=-1).astype(np.float32)
    return rays_o, rays_d
