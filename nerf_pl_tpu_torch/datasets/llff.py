"""LLFF / real-scene dataset (COLMAP poses_bounds.npy).

The port's own copy of nerf_pl_tpu/datasets/llff.py, the same numpy line
for line; PIL is imported where an image is read, so importing the
module needs no PIL.

Parity: reference datasets/llff.py:159-318 — pose axis-convention fix
("down right back" -> "right up back"), centering around the average pose,
near-plane scale normalization (nearest depth ~ 1.33), nearest-to-center
image as the val image, NDC rays for forward-facing captures, raw rays with
near=min bound / far=min(8*near, max) for spheric captures, and synthetic
spiral / spheric test paths.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .pose_utils import center_poses, create_spheric_poses, create_spiral_poses
from .ray_utils import get_ndc_rays, get_ray_directions, get_rays


def _load_image_rgb(path: str, wh) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    assert img.size[1] * wh[0] == img.size[0] * wh[1], (
        f"{path} has different aspect ratio than img_wh, "
        "please check your data!")
    img = img.resize(wh, Image.LANCZOS)
    return (np.asarray(img, dtype=np.float32) / 255.0).reshape(-1, 3)


class LLFFDataset:
    """Real scenes. Forward-facing (NDC) by default; --spheric_poses for 360.

    val_num: number of DISTINCT nearest-to-center views held out for
    validation. The reference (llff.py:160-170) replicated ONE val image
    val_num times purely so each DDP rank had an item; sharded validation
    needs no replication, so the same knob buys genuinely novel held-out
    views instead (val_num=1 reproduces the reference split exactly).
    """

    white_back = False

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(504, 378), spheric_poses: bool = False,
                 val_num: int = 1):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.spheric_poses = spheric_poses
        self.val_num = max(1, val_num)
        self._read_meta()

    # -- pose/bounds preprocessing (reference llff.py:176-222) --------------
    def _read_meta(self):
        poses_bounds = np.load(
            os.path.join(self.root_dir, "poses_bounds.npy"))  # (N, 17)
        self.image_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "images/*")))
        if self.split in ["train", "val"]:
            assert len(poses_bounds) == len(self.image_paths), (
                "Mismatch between number of images and number of poses! "
                "Please rerun COLMAP!")

        poses = poses_bounds[:, :15].reshape(-1, 3, 5)  # (N, 3, 5)
        self.bounds = poses_bounds[:, -2:]              # (N, 2)

        H, W, self.focal = poses[0, :, -1]
        assert H * self.img_wh[0] == W * self.img_wh[1], (
            f"You must set @img_wh to have the same aspect ratio as "
            f"({W}, {H}) !")
        self.focal *= self.img_wh[0] / W

        # "down right back" -> "right up back" (reference llff.py:196-199).
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)
        distances = np.linalg.norm(self.poses[..., 3], axis=1)
        # argsort is stable, so val_idxs[0] == argmin(distances): the
        # reference's single val view (llff.py:201-203) is always held out
        # first; val_num > 1 extends the holdout to the next-nearest views.
        self.val_idxs = [int(i) for i in np.argsort(distances)
                         [:min(self.val_num, len(distances))]]

        # Scale so the nearest depth sits at ~1.33 (reference llff.py:205-211).
        near_original = self.bounds.min()
        scale_factor = near_original * 0.75
        self.bounds /= scale_factor
        self.poses[..., 3] /= scale_factor

        self.directions = get_ray_directions(
            self.img_wh[1], self.img_wh[0], self.focal)

        if self.split == "train":
            val_set = set(self.val_idxs)
            all_rays, all_rgbs = [], []
            for i, image_path in enumerate(self.image_paths):
                if i in val_set:
                    continue
                all_rgbs.append(_load_image_rgb(image_path, self.img_wh))
                all_rays.append(self._rays_for_pose(self.poses[i]))
            self.all_rays = np.concatenate(all_rays, 0).astype(np.float32)
            self.all_rgbs = np.concatenate(all_rgbs, 0).astype(np.float32)

        elif self.split == "val":
            self.c2w_vals = [self.poses[i] for i in self.val_idxs]
            self.image_paths_val = [self.image_paths[i]
                                    for i in self.val_idxs]

        else:  # test: a parametric render path (reference llff.py:260-271)
            if self.split.endswith("train"):
                self.poses_test = self.poses
            elif not self.spheric_poses:
                focus_depth = 3.5
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                self.poses_test = create_spiral_poses(radii, focus_depth)
            else:
                radius = 1.1 * self.bounds.min()
                self.poses_test = create_spheric_poses(radius)

    def _rays_for_pose(self, c2w: np.ndarray) -> np.ndarray:
        rays_o, rays_d = get_rays(self.directions, c2w)
        if not self.spheric_poses:
            near, far = 0.0, 1.0
            rays_o, rays_d = get_ndc_rays(
                self.img_wh[1], self.img_wh[0], self.focal, 1.0,
                rays_o, rays_d)  # near plane always at 1.0 in world
        else:
            near = self.bounds.min()
            far = min(8 * near, self.bounds.max())
        return np.concatenate(
            [rays_o, rays_d,
             np.full_like(rays_o[:, :1], near),
             np.full_like(rays_o[:, :1], far)], 1).astype(np.float32)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return len(self.val_idxs)
        return len(self.poses_test)

    def __getitem__(self, idx: int):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}

        if self.split == "val":
            c2w = self.c2w_vals[idx]
        else:
            c2w = self.poses_test[idx]

        sample = {"rays": self._rays_for_pose(c2w),
                  "c2w": c2w.astype(np.float32)}
        if self.split == "val":
            sample["rgbs"] = _load_image_rgb(self.image_paths_val[idx],
                                             self.img_wh)
        elif self.split == "test_train" and idx < len(self.image_paths):
            # test_train poses ARE the capture poses, so ground truth
            # exists; attaching it lets eval.py score the split directly
            # (the reference leaves test_train GT-less and can only score
            # splits that carry 'rgbs', eval.py:140-143)
            sample["rgbs"] = _load_image_rgb(self.image_paths[idx],
                                             self.img_wh)
        return sample


class LLFF360Dataset(LLFFDataset):
    """The LLFF scene in mip-NeRF 360's layout (`--model mipnerf360`; no
    JAX counterpart): no NDC, the camera positions scaled into
    [-1, 1]^3 around the average pose's centre, directions as the camera
    gives them (d = R ((i - W/2)/f, -(j - H/2)/f, -1), not normalised),
    every ray's near and far the given ones, and each pixel's radius
    |d(i + 1, j) - d(i, j)| 2 / sqrt(12) (multinerf's radii; the last
    column repeats its neighbour's). Training adds `all_radii` (N,); a
    val or test sample adds `radii`."""

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(504, 378), val_num: int = 1, near: float = 0.2,
                 far: float = 1e6):
        self.near, self.far = near, far
        super().__init__(root_dir, split, img_wh, spheric_poses=True,
                         val_num=val_num)
        if split == "train":
            n_img = len(self.all_rays) // len(self.pixel_radii)
            self.all_radii = np.tile(self.pixel_radii, n_img)

    @property
    def pixel_radii(self) -> np.ndarray:
        """(H * W,) float32 radii of one image's pixels."""
        d = self.directions
        dx = np.linalg.norm(d[:, 1:] - d[:, :-1], axis=-1)
        dx = np.concatenate([dx, dx[:, -1:]], axis=1)
        return (dx * 2 / np.sqrt(12)).reshape(-1).astype(np.float32)

    def _rays_for_pose(self, c2w: np.ndarray) -> np.ndarray:
        scale = 1.0 / np.abs(self.poses[..., 3]).max()
        c2w = np.asarray(c2w, dtype=np.float32)
        rays_d = self.directions.reshape(-1, 3) @ c2w[:, :3].T
        rays_o = np.broadcast_to(c2w[:, 3] * scale, rays_d.shape)
        return np.concatenate(
            [rays_o, rays_d, np.full_like(rays_o[:, :1], self.near),
             np.full_like(rays_o[:, :1], self.far)], 1).astype(np.float32)

    def __getitem__(self, idx: int):
        sample = super().__getitem__(idx)
        if self.split == "train":
            sample["radii"] = self.all_radii[idx]
        else:
            sample["radii"] = self.pixel_radii
        return sample
