"""Blender synthetic-360 dataset (NeRF synthetic scenes).

The port's own copy of nerf_pl_tpu/datasets/blender.py, the same numpy
line for line; PIL is imported where an image is read, so importing the
module needs no PIL.

Parity: reference datasets/blender.py:11-108 — transforms_{split}.json parsing,
focal rescale from the 800px reference resolution, fixed near/far = 2/6,
RGBA->RGB white blending, and the train split pre-baking every ray of every
image into flat arrays.

TPU-first: everything is host numpy; the training loop ships all_rays/all_rgbs
to device HBM once and samples batches *on device* (parallel/spmd.py), so
there is no per-step host->device traffic and no DataLoader worker pool.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .ray_utils import get_ray_directions, get_rays


def _load_image_rgba(path: str, wh) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    img = img.resize(wh, Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0  # (H, W, C)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.ones_like(arr)], -1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
    return arr.reshape(-1, 4)  # (H*W, 4)


class BlenderDataset:
    """Synthetic 360-degree scenes with white background.

    Attributes (train split): all_rays (N*H*W, 8) f32, all_rgbs (N*H*W, 3) f32.
    val/test: index to get per-image dicts {'rays','rgbs','c2w','valid_mask'}.
    """

    white_back = True

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(800, 800)):
        assert img_wh[0] == img_wh[1], "image width must equal image height!"
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self._read_meta()

    def _read_meta(self):
        with open(os.path.join(self.root_dir,
                               f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)

        w, h = self.img_wh
        # Focal from the 800px reference resolution, rescaled to img_wh
        # (reference blender.py:28-31).
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800

        self.near, self.far = 2.0, 6.0
        self.bounds = np.array([self.near, self.far])
        self.directions = get_ray_directions(h, w, self.focal)  # (h, w, 3)

        if self.split == "train":
            self.image_paths = []
            self.poses = []
            all_rays, all_rgbs = [], []
            for frame in self.meta["frames"]:
                pose = np.array(frame["transform_matrix"],
                                dtype=np.float32)[:3, :4]
                self.poses.append(pose)
                path = os.path.join(self.root_dir,
                                    f"{frame['file_path']}.png")
                self.image_paths.append(path)

                img = _load_image_rgba(path, self.img_wh)
                rgb = img[:, :3] * img[:, 3:] + (1.0 - img[:, 3:])
                all_rgbs.append(rgb)

                rays_o, rays_d = get_rays(self.directions, pose)
                near = np.full_like(rays_o[:, :1], self.near)
                far = np.full_like(rays_o[:, :1], self.far)
                all_rays.append(
                    np.concatenate([rays_o, rays_d, near, far], 1))

            self.all_rays = np.concatenate(all_rays, 0).astype(np.float32)
            self.all_rgbs = np.concatenate(all_rgbs, 0).astype(np.float32)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            # Keep the reference's small fixed val set (blender.py:78); with a
            # sharded val render the per-device replication hack is gone.
            return min(8, len(self.meta["frames"]))
        return len(self.meta["frames"])

    def __getitem__(self, idx: int):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}

        frame = self.meta["frames"][idx]
        c2w = np.array(frame["transform_matrix"], dtype=np.float32)[:3, :4]
        img = _load_image_rgba(
            os.path.join(self.root_dir, f"{frame['file_path']}.png"),
            self.img_wh)
        valid_mask = img[:, 3] > 0
        rgbs = img[:, :3] * img[:, 3:] + (1.0 - img[:, 3:])

        rays_o, rays_d = get_rays(self.directions, c2w)
        near = np.full_like(rays_o[:, :1], self.near)
        far = np.full_like(rays_o[:, :1], self.far)
        rays = np.concatenate([rays_o, rays_d, near, far], 1)
        return {"rays": rays.astype(np.float32),
                "rgbs": rgbs.astype(np.float32),
                "c2w": c2w,
                "valid_mask": valid_mask}
