"""Synthetic analytically-ray-traced scenes for tests and benchmarks.

The port's own copy of nerf_pl_tpu/utils/synthetic.py: the sphere scenes
and the "hard" multi-object scene (`render_hard_scene_rgba`, which
`make_hard_datasets` renders), the same numpy line for line; PIL is
imported where a PNG is written.

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


# ---------------------------------------------------------------------------
# "Hard" procedural scene: reference-difficulty accuracy target.
#
# The lambertian sphere above is trivially fittable (35+ dB in minutes); it
# validates plumbing, not accuracy at reference difficulty. This scene is
# built to stress exactly what lego/fern stress (reference README.md:161
# benchmarks):
#   * high-frequency procedural textures (checker + fine sinusoid bands)
#     -> exercises the 10-frequency positional embedding;
#   * thin occluders (a picket fence of 3cm-thick slats + rods)
#     -> exercises hierarchical sampling: uniform 64-sample spacing at
#        near/far 2/6 is ~6 cm, so slats are only resolved by the fine pass;
#   * multiple mutually-occluding objects + hard cast shadows;
#   * Blinn-Phong specular lobes -> exercises the view-direction branch.
# Everything is analytically ray-traced in numpy (2x2 supersampling), so
# ground truth is exact and self-contained (no external data enters the
# image; dataset provenance = this file).
# ---------------------------------------------------------------------------

def _sphere_hit(o, d, center, radius):
    """Nearest positive hit param for each ray; +inf where missed."""
    oc = o - center
    b = 2.0 * np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - radius ** 2
    disc = b * b - 4 * c
    ok = disc > 0
    sq = np.sqrt(np.maximum(disc, 0))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t = np.where(t0 > 1e-4, t0, t1)
    return np.where(ok & (t > 1e-4), t, np.inf)


def _box_hit(o, d, lo, hi):
    """Axis-aligned slab test; +inf where missed."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t_lo = (lo - o) * inv
        t_hi = (hi - o) * inv
    t_near = np.minimum(t_lo, t_hi).max(-1)
    t_far = np.maximum(t_lo, t_hi).min(-1)
    ok = (t_far > np.maximum(t_near, 1e-4))
    t = np.where(t_near > 1e-4, t_near, t_far)
    return np.where(ok & (t > 1e-4), t, np.inf)


def _disk_hit(o, d, z0, radius):
    """Horizontal disk at height z0; +inf where missed."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (z0 - o[:, 2]) / d[:, 2]
    p = o + t[:, None] * d
    ok = (t > 1e-4) & (p[:, 0] ** 2 + p[:, 1] ** 2 < radius ** 2)
    return np.where(ok, t, np.inf)


def _box_normal(p, lo, hi):
    """Outward normal of the nearest box face at hit point p."""
    mid = (lo + hi) / 2
    half = (hi - lo) / 2
    rel = (p - mid) / half
    n = np.zeros_like(p)
    ax = np.argmax(np.abs(rel), axis=-1)
    n[np.arange(len(p)), ax] = np.sign(rel[np.arange(len(p)), ax])
    return n


_HARD_SPHERES = [  # (center, radius, texture id)
    (np.array([0.0, 0.0, 0.05]), 0.55, 0),
    (np.array([0.85, 0.45, -0.12]), 0.22, 1),
    (np.array([-0.75, 0.55, -0.16]), 0.18, 2),
    (np.array([0.15, -0.9, -0.19]), 0.15, 1),
]
_HARD_BOXES = []  # picket fence along an arc + two thin rods
for _i in range(9):
    _a = np.pi * (0.15 + 0.7 * _i / 8)
    _cx, _cy = 1.25 * np.cos(_a), -1.25 * np.sin(_a)
    _HARD_BOXES.append((np.array([_cx - 0.05, _cy - 0.015, -0.35]),
                        np.array([_cx + 0.05, _cy + 0.015, 0.25])))
_HARD_BOXES.append((np.array([-1.3, -0.015, 0.28]),
                    np.array([1.3, 0.015, 0.31])))
_HARD_BOXES.append((np.array([-0.015, -1.3, 0.40]),
                    np.array([0.015, 1.3, 0.43])))
_HARD_DISK = (-0.35, 1.6)  # (z, radius)
_LIGHT = np.array([0.45, 0.35, 0.82])
_LIGHT2 = np.array([-0.6, -0.5, 0.3])


def _hard_texture(obj_kind, tex, p, n):
    """Procedural albedo per object. High-frequency on purpose."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    if obj_kind == "disk":
        # 12x12 checker + fine concentric rings
        checker = ((np.floor(x * 4) + np.floor(y * 4)) % 2)
        rings = 0.5 + 0.5 * np.sin(28.0 * np.sqrt(x * x + y * y))
        base = np.stack([0.15 + 0.7 * checker,
                         0.25 + 0.5 * rings,
                         0.55 - 0.35 * checker], -1)
        return base
    if obj_kind == "box":
        stripes = 0.5 + 0.5 * np.sin(40.0 * (x + y + 2.1 * z))
        return np.stack([0.75 + 0.2 * stripes, 0.55 * stripes + 0.2,
                         0.25 + 0.1 * stripes], -1)
    # spheres by texture id
    if tex == 0:
        # 3-D sinusoid product grid (the "lego stud" analog)
        v = (np.sin(24.0 * x) * np.sin(24.0 * y) * np.sin(24.0 * z))
        hi = (v > 0).astype(np.float64)
        return np.stack([0.2 + 0.65 * hi, 0.45 - 0.25 * hi,
                         0.30 + 0.45 * (1 - hi)], -1)
    if tex == 1:
        phi = np.arctan2(n[:, 1], n[:, 0])
        s = 0.5 + 0.5 * np.sign(np.sin(18.0 * phi))
        return np.stack([0.8 * s + 0.1, 0.3 + 0.4 * (1 - s),
                         0.2 + 0.6 * (1 - s)], -1)
    marble = 0.5 + 0.5 * np.sin(10.0 * x + 4.0 * np.sin(6.0 * y) + 8.0 * z)
    return np.stack([0.3 + 0.5 * marble, 0.6 * marble + 0.25,
                     0.75 - 0.3 * marble], -1)


def _hard_trace(o, d):
    """Nearest-hit trace over the whole object set.

    Returns (t, hit_mask, point, normal, albedo, spec_weight)."""
    n_rays = o.shape[0]
    best_t = np.full(n_rays, np.inf)
    obj_id = np.full(n_rays, -1, np.int64)

    objs = []
    for ci, (c, r, tex) in enumerate(_HARD_SPHERES):
        objs.append(("sphere", ci))
        t = _sphere_hit(o, d, c, r)
        m = t < best_t
        best_t = np.where(m, t, best_t)
        obj_id = np.where(m, len(objs) - 1, obj_id)
    for bi, (lo, hi) in enumerate(_HARD_BOXES):
        objs.append(("box", bi))
        t = _box_hit(o, d, lo, hi)
        m = t < best_t
        best_t = np.where(m, t, best_t)
        obj_id = np.where(m, len(objs) - 1, obj_id)
    objs.append(("disk", 0))
    t = _disk_hit(o, d, *_HARD_DISK)
    m = t < best_t
    best_t = np.where(m, t, best_t)
    obj_id = np.where(m, len(objs) - 1, obj_id)

    hit = np.isfinite(best_t)
    t_safe = np.where(hit, best_t, 0.0)
    p = o + t_safe[:, None] * d

    normal = np.zeros_like(p)
    albedo = np.zeros((n_rays, 3))
    spec = np.zeros(n_rays)
    for oi, (kind, idx) in enumerate(objs):
        m = hit & (obj_id == oi)
        if not m.any():
            continue
        if kind == "sphere":
            c, r, tex = _HARD_SPHERES[idx]
            nrm = (p[m] - c) / r
            spec[m] = 0.9 if tex == 0 else 0.35
        elif kind == "box":
            lo, hi = _HARD_BOXES[idx]
            nrm = _box_normal(p[m], lo, hi)
            tex = -1
            spec[m] = 0.15
        else:
            nrm = np.broadcast_to([0.0, 0.0, 1.0], p[m].shape)
            tex = -1
            spec[m] = 0.25
        normal[m] = nrm
        albedo[m] = _hard_texture(kind, tex, p[m], nrm)
    return best_t, hit, p, normal, albedo, spec


def _hard_shadow(p, hit):
    """1 where the primary light is visible from p, else 0.35 (soft-ish)."""
    l = _LIGHT / np.linalg.norm(_LIGHT)
    n_rays = p.shape[0]
    lit = np.ones(n_rays)
    if not hit.any():
        return lit
    o = p[hit] + 1e-3 * l
    d = np.broadcast_to(l, o.shape)
    t_block = np.full(o.shape[0], np.inf)
    for c, r, _ in _HARD_SPHERES:
        t_block = np.minimum(t_block, _sphere_hit(o, d, c, r))
    for lo, hi in _HARD_BOXES:
        t_block = np.minimum(t_block, _box_hit(o, d, lo, hi))
    lit_h = np.where(np.isfinite(t_block), 0.35, 1.0)
    lit[hit] = lit_h
    return lit


def render_hard_scene_rgba(c2w, H, W, focal, ss=2):
    """Analytic render of the hard multi-object scene. RGBA float (H,W,4).

    ss: supersampling factor per axis (anti-aliases the high-frequency
    textures so ground truth is the properly prefiltered image)."""
    dirs = get_ray_directions(H * ss, W * ss, focal * ss).reshape(-1, 3)
    R, t = np.asarray(c2w)[:, :3], np.asarray(c2w)[:, 3]
    d = dirs @ R.T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(t, d.shape)

    _, hit, p, n, albedo, spec = _hard_trace(o, d)
    lit = _hard_shadow(p, hit)

    l1 = _LIGHT / np.linalg.norm(_LIGHT)
    l2 = _LIGHT2 / np.linalg.norm(_LIGHT2)
    diff = (0.55 * np.maximum(0.0, n @ l1) * lit
            + 0.25 * np.maximum(0.0, n @ l2))
    # Blinn-Phong specular on the primary light (view-dependent)
    h1 = l1 - d
    h1 = h1 / (np.linalg.norm(h1, axis=-1, keepdims=True) + 1e-12)
    sp = spec * np.maximum(0.0, np.sum(n * h1, -1)) ** 32
    rgb = np.clip(albedo * (0.22 + diff)[:, None] + sp[:, None], 0, 1)

    rgba = np.zeros((H * ss * W * ss, 4), dtype=np.float32)
    rgba[hit, :3] = rgb[hit]
    rgba[hit, 3] = 1.0
    # box-filter the supersampled grid
    rgba = rgba.reshape(H, ss, W, ss, 4).mean(axis=(1, 3))
    return rgba


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
