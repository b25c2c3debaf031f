"""Camera-pose utilities for real (COLMAP/LLFF) scenes.

The port's own copy of nerf_pl_tpu/datasets/pose_utils.py, unchanged.

Pose centering, average-pose computation, and synthetic render paths
(spiral for forward-facing scenes, downward-tilted circle for 360 captures).
Behavioral parity: reference datasets/llff.py:12-156 — the output pose
arrays are numerically identical (goldens in tests/test_ray_utils.py),
but the construction here is vectorized over the whole path and builds
every camera from one orthonormal-frame helper instead of per-pose
rotation/translation matrix chains.
"""
from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frames_from_z(z_dir: np.ndarray, y_hint: np.ndarray,
                   center: np.ndarray) -> np.ndarray:
    """Camera-to-world pose(s) from a viewing direction and an up hint.

    Gram-Schmidt with the LLFF column convention (x right, y up, z back
    after the loader's axis fix): x = normalize(y_hint x z), y = z x x.
    Broadcasts over leading axes; returns (..., 3, 4) with columns
    [x, y, z, center].
    """
    z = normalize(z_dir)
    y_hint = np.broadcast_to(y_hint, z.shape)
    x = normalize(np.cross(y_hint, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], axis=-1)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average camera pose of (N, 3, 4) c2w matrices.

    Center = mean camera center; z = normalized mean z axis; the mean y
    axis serves as the up hint. Parity: reference llff.py:17-53.
    """
    return _frames_from_z(poses[..., 2].mean(0), poses[..., 1].mean(0),
                          poses[..., 3].mean(0))


def center_poses(poses: np.ndarray):
    """Re-express all poses relative to the average pose.

    Parity: reference llff.py:56-80.

    Returns: (poses_centered (N,3,4), inv_avg_homo (4,4)).
    """
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_poses(poses)
    last_row = np.broadcast_to([0, 0, 0, 1.0], (len(poses), 1, 4))
    poses_homo = np.concatenate([poses, last_row], axis=1)  # (N, 4, 4)
    inv = np.linalg.inv(pose_avg_homo)
    poses_centered = (inv @ poses_homo)[:, :3]
    return poses_centered, inv


def create_spiral_poses(radii: np.ndarray, focus_depth: float,
                        n_poses: int = 120) -> np.ndarray:
    """Spiral path for forward-facing scene flythroughs (2 turns of 2*pi).

    Camera centers trace (cos t, -sin t, -sin t/2) * radii; every camera
    looks from its center toward the focus point (0, 0, -focus_depth),
    world-up as the hint. Parity: reference llff.py:83-115.
    """
    t = np.linspace(0, 4 * np.pi, n_poses + 1)[:-1, None]
    centers = np.concatenate(
        [np.cos(t), -np.sin(t), -np.sin(0.5 * t)], axis=1) * radii
    return _frames_from_z(centers - [0, 0, -focus_depth],
                          np.array([0, 1.0, 0]), centers)


def create_spheric_poses(radius: float, n_poses: int = 120) -> np.ndarray:
    """Circle of poses around +z looking 36 degrees downward (360 captures).

    Closed form of the reference's rot_theta @ rot_phi @ trans chain
    (llff.py:118-156) with elevation phi = -pi/5 and the fixed offset
    translation (0, -0.9r, r): the camera orbits at ring radius
    r*(cos phi - 0.9 sin phi) and height r*(-0.9 cos phi - sin phi),
    x axis tangent to the ring, z axis tilted by phi from horizontal.
    Output poses are numerically identical to the reference path.
    """
    phi = -np.pi / 5
    sp, cp = np.sin(phi), np.cos(phi)
    theta = np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
    s, c = np.sin(theta), np.cos(theta)
    o, i = np.zeros_like(s), np.ones_like(s)
    x_axis = np.stack([-c, s, o], axis=-1)
    y_axis = np.stack([s * sp, c * sp, cp * i], axis=-1)
    z_axis = np.stack([s * cp, c * cp, -sp * i], axis=-1)
    centers = radius * np.stack(
        [(cp - 0.9 * sp) * s, (cp - 0.9 * sp) * c,
         (-0.9 * cp - sp) * i], axis=-1)
    return np.stack([x_axis, y_axis, z_axis, centers], axis=-1)
