"""Generate the 'hard' procedural accuracy datasets with the port alone.

    python -m nerf_pl_tpu_torch.make_hard_datasets [--out data]

Port of scripts/make_hard_datasets.py, with its flags, through the port's
copy of the scene generator (utils/synthetic.py: render_hard_scene_rgba
for the scene spec; numpy, and PIL to write the PNGs).

Outputs (gitignored; regenerate with this module):
  data/hard_blender  : Blender format, 400x400, 100 train / 8 val / 25 test
  data/hard_llff     : LLFF format, 504x378, 30 forward-facing views
  data/hard_llff_sph : LLFF format, 504x378, 33 views on a full 360-degree
                       circle (train with --spheric_poses --val_num 3 so
                       three distinct views are held out for novel-view
                       scoring; reference llff.py:243-245, 299-301)
Deterministic: re-running reproduces byte-identical images.
"""
import argparse
import os
import time

import numpy as np

from .utils.synthetic import (make_blender_scene, make_llff_scene,
                              render_hard_scene_rgba)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "data"))
    ap.add_argument("--blender_wh", type=int, nargs=2, default=[400, 400])
    ap.add_argument("--llff_wh", type=int, nargs=2, default=[504, 378])
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--skip_blender", action="store_true")
    ap.add_argument("--skip_llff", action="store_true")
    ap.add_argument("--skip_spheric", action="store_true")
    ap.add_argument("--n_sph", type=int, default=33,
                    help="spheric ring camera count (denser rings probe "
                         "whether the novel-view gap is view sparsity)")
    ap.add_argument("--sph_dir", type=str, default="hard_llff_sph",
                    help="output dir name for the spheric scene")
    args = ap.parse_args(argv)

    if not args.skip_blender:
        t0 = time.time()
        root = make_blender_scene(
            os.path.join(args.out, "hard_blender"),
            n_train=args.n_train, n_val=8, n_test=25,
            wh=tuple(args.blender_wh), cam_dist=4.0,
            render_fn=render_hard_scene_rgba)
        print(f"blender scene -> {root} ({time.time() - t0:.0f}s)",
              flush=True)

    if not args.skip_llff:
        t0 = time.time()

        def cam_pos_fn(off):
            # side-on forward-facing arc: cameras on the -y side looking at
            # the origin with z-up, so the fence/spheres are seen face-on
            return np.array([1.5 * off, -4.0 - 0.3 * abs(off),
                             0.8 + 0.4 * off])

        root = make_llff_scene(
            os.path.join(args.out, "hard_llff"),
            n_images=30, wh=tuple(args.llff_wh), cam_dist=4.0,
            render_fn=render_hard_scene_rgba, cam_pos_fn=cam_pos_fn,
            up=(0, 0, 1), scene_radius=1.8)
        print(f"llff scene -> {root} ({time.time() - t0:.0f}s)", flush=True)

    if not args.skip_spheric:
        t0 = time.time()

        def sph_pos_fn(off):
            # full 360-degree circle at ~30-degree elevation: off spans
            # [-0.2, 0.2] (make_llff_scene's lateral-offset parameter),
            # remapped to azimuth in [0, 2*pi)
            theta = 2.0 * np.pi * (off / 0.4 + 0.5)
            return np.array([3.5 * np.cos(theta), 3.5 * np.sin(theta), 2.0])

        root = make_llff_scene(
            os.path.join(args.out, args.sph_dir),
            n_images=args.n_sph, wh=tuple(args.llff_wh),
            cam_dist=float(np.hypot(3.5, 2.0)),
            render_fn=render_hard_scene_rgba, cam_pos_fn=sph_pos_fn,
            up=(0, 0, 1), scene_radius=1.8)
        print(f"llff spheric scene -> {root} ({time.time() - t0:.0f}s)",
              flush=True)


if __name__ == "__main__":
    main()
