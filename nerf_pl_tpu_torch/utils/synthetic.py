"""Synthetic analytically-ray-traced scenes for tests and benchmarks.

The port's own copy of the sphere scenes of nerf_pl_tpu/utils/synthetic.py
(the same numpy line for line; PIL is imported where a PNG is written). Its
"hard" multi-object scene, which the port does not use, is not copied.

Generates tiny Blender-format and LLFF-format datasets on disk: a shaded
colored sphere, rendered in closed form with numpy. Used by the test suite
(no real NeRF data is shipped) and by bench.py to exercise the exact training
path with ground-truth-fittable images.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..datasets.ray_utils import get_ray_directions


def look_at_pose(cam_pos, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """OpenGL-style c2w [x y z t]: camera looks down -z toward target."""
    cam_pos = np.asarray(cam_pos, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    z = cam_pos - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, cam_pos], axis=1)  # (3, 4)


def render_sphere_rgba(c2w, H, W, focal, radius=1.0,
                       base_color=(0.8, 0.3, 0.2),
                       light_dir=(0.5, 0.5, 1.0)):
    """Analytic render of a lambertian sphere at the origin. RGBA float (H,W,4).

    Alpha=1 on the sphere, 0 elsewhere (so Blender-style white blending is
    exercised exactly like real data).
    """
    dirs = get_ray_directions(H, W, focal).reshape(-1, 3)
    R, t = np.asarray(c2w)[:, :3], np.asarray(c2w)[:, 3]
    d = dirs @ R.T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(t, d.shape)

    # |o + s d|^2 = r^2
    b = 2.0 * np.sum(o * d, -1)
    c = np.sum(o * o, -1) - radius ** 2
    disc = b * b - 4 * c
    hit = disc > 0
    s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2.0, 0.0)
    hit &= s > 0

    p = o + s[:, None] * d
    n = p / radius
    l = np.asarray(light_dir, dtype=np.float64)
    l = l / np.linalg.norm(l)
    shade = 0.35 + 0.65 * np.maximum(0.0, n @ l)

    rgb = np.clip(shade[:, None] * np.asarray(base_color), 0, 1)
    rgba = np.zeros((H * W, 4), dtype=np.float32)
    rgba[hit, :3] = rgb[hit]
    rgba[hit, 3] = 1.0
    return rgba.reshape(H, W, 4)


def make_blender_scene(root: str, n_train=6, n_val=2, n_test=2,
                       wh=(40, 40), cam_dist=4.0,
                       camera_angle_x=0.8575560450553894,
                       render_fn=None):
    """Write a Blender-format scene dir: transforms_{split}.json + PNGs.

    Camera distance 4 keeps the sphere inside the reference's fixed
    near/far = 2/6 Blender bounds.
    """
    from PIL import Image
    if render_fn is None:
        render_fn = render_sphere_rgba
    W, H = wh
    focal_native = 0.5 * 800 / np.tan(0.5 * camera_angle_x)
    focal = focal_native * W / 800
    os.makedirs(root, exist_ok=True)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    rng = np.random.default_rng(0)
    for split, n in counts.items():
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            theta = 2 * np.pi * (i / max(n, 1)) + (0.1 if split != "train" else 0)
            phi = np.pi / 5 + 0.2 * rng.standard_normal() * (split == "train")
            pos = cam_dist * np.array([
                np.cos(theta) * np.cos(phi),
                np.sin(theta) * np.cos(phi),
                np.sin(phi)])
            c2w = look_at_pose(pos)
            rgba = render_fn(c2w, H, W, focal)
            img = (rgba * 255).astype(np.uint8)
            Image.fromarray(img, "RGBA").save(
                os.path.join(root, split, f"r_{i}.png"))
            c2w_homo = np.eye(4)
            c2w_homo[:3] = c2w
            frames.append({"file_path": f"./{split}/r_{i}",
                           "rotation": 0.0,
                           "transform_matrix": c2w_homo.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    return root


def make_llff_scene(root: str, n_images=5, wh=(40, 30), cam_dist=4.0,
                    render_fn=None, cam_pos_fn=None, up=(0, 1, 0),
                    scene_radius=1.5):
    """Write an LLFF-format scene dir: poses_bounds.npy + images/*.png.

    Forward-facing cameras with small lateral offsets looking at the sphere.
    poses_bounds rows use the COLMAP/LLFF "down right back" axis convention
    that the loader re-fixes (reference llff.py:196-199) plus the (H, W, f)
    last column.
    """
    from PIL import Image
    if render_fn is None:
        render_fn = render_sphere_rgba
    if cam_pos_fn is None:
        def cam_pos_fn(off):
            return np.array([off, 0.25 * off, cam_dist + 0.2 * off])
    W, H = wh
    focal = 1.2 * W
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rows = []
    for i in range(n_images):
        off = 0.4 * (i - (n_images - 1) / 2) / max(n_images - 1, 1)
        pos = cam_pos_fn(off)
        c2w = look_at_pose(pos, target=(0, 0, 0), up=up)
        rgba = render_fn(c2w, H, W, focal)
        rgb = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
        Image.fromarray((rgb * 255).astype(np.uint8), "RGB").save(
            os.path.join(root, "images", f"img_{i:03d}.png"))

        # invert the loader's fix: stored = [-y, x, z, t] + (H, W, f) col
        x, y, z, t = c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3]
        stored = np.stack([-y, x, z, t], axis=1)  # (3, 4)
        hwf = np.array([[H], [W], [focal]], dtype=np.float64)
        near = cam_dist - scene_radius
        far = cam_dist + scene_radius
        rows.append(np.concatenate(
            [np.concatenate([stored, hwf], 1).reshape(-1), [near, far]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return root
