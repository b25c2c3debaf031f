"""Render one pose from a checkpoint: PSNR, a depth map and secs/frame.

    python -m nerf_pl_tpu_torch.render_image --root_dir <scene> \
        --dataset_name blender --split test --idx 0 --img_wh 800 800 \
        --N_importance 64 --ckpt_path ckpts/exp/last.ckpt --fused_mlp \
        [--occ_grid --occ_mode weight --occ_tighten --occ_budgets \
         --occ_segments 32]

Port of scripts/render_image.py, with its flags and defaults. The first
render builds the kernels; the second is timed, from a
torch.cuda.synchronize to the next. With --occ_grid the frame renders
through the occupancy-culled renderer (its grid built from this frame's
rays, or loaded from the cache beside the checkpoint) and prints how many
rays were culled. It renders on cuda:0 and raises without CUDA; only a
caller of main(device="cpu") renders on the CPU. Writes
render_NNN.png and depth_NNN.png into --out_dir.
"""
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True)
    parser.add_argument('--dataset_name', type=str, default='blender',
                        choices=['blender', 'llff'])
    parser.add_argument('--split', type=str, default='test')
    parser.add_argument('--idx', type=int, default=0,
                        help='dataset item to render')
    parser.add_argument('--img_wh', nargs='+', type=int, default=[800, 800])
    parser.add_argument('--spheric_poses', default=False, action='store_true')
    parser.add_argument('--N_samples', type=int, default=64)
    parser.add_argument('--N_importance', type=int, default=64)
    parser.add_argument('--use_disp', default=False, action='store_true')
    parser.add_argument('--chunk', type=int, default=32 * 1024)
    parser.add_argument('--culled_chunk', type=int, default=None,
                        help='base ray tile of the occupancy-culled path '
                             '(default: min(--chunk, '
                             'CulledRenderer.DEFAULT_CHUNK=8192))')
    parser.add_argument('--ckpt_path', type=str, required=True)
    parser.add_argument('--fused_mlp', default=False, action='store_true')
    parser.add_argument('--occ_grid', default=False, action='store_true',
                        help='build an occupancy grid and skip empty-space '
                             'rays (they keep the analytic background)')
    parser.add_argument('--occ_threshold', type=float, default=1.0,
                        help='sigma above which a grid cell is occupied')
    parser.add_argument('--occ_mode', type=str, default='sigma',
                        choices=['sigma', 'weight'],
                        help="cell criterion: sigma = raw density "
                             "threshold; weight = visibility-pruned (keep "
                             "a cell only if this frame's rays deposit "
                             "quadrature weight on it)")
    parser.add_argument('--occ_range', nargs='+', type=float, default=None,
                        help='grid world extent: 2 values (symmetric lo hi)'
                             ' or 6 (box corners); omit to auto-derive')
    parser.add_argument('--occ_N', type=int, default=128,
                        help='occupancy grid resolution per axis')
    parser.add_argument('--occ_tighten', default=False, action='store_true',
                        help='also clip each surviving ray to its occupied '
                             'interval')
    parser.add_argument('--occ_budgets', default=False, action='store_true',
                        help='with tightening: short-span rays rendered '
                             'with proportionally fewer samples')
    parser.add_argument('--occ_segments', type=int, default=0,
                        help='per-ray occupied-segment mask bits (<=32); '
                             '0 = off')
    parser.add_argument('--occ_bucket_fracs', nargs='+', type=float,
                        default=None,
                        help='budgeted span-bucket sample fractions '
                             '(ascending, must end at 1.0)')
    parser.add_argument('--out_dir', type=str, default='.')
    return parser


def main(argv=None, device=None):
    """Returns the timed render's seconds."""
    from PIL import Image

    from .datasets import dataset_dict
    from .device import resolve_device
    from .eval import culled_renderer
    from .models import params_from_numpy
    from .parallel import make_render_fn
    from .rendering import (ModelConfig, RenderConfig, load_or_build_grid,
                            rays_aabb)
    from .training.families import NeRFFamily
    from .training.metrics import psnr as psnr_fn
    from .utils.visualization import visualize_depth

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    w, h = args.img_wh
    kwargs = {'root_dir': args.root_dir, 'split': args.split,
              'img_wh': tuple(args.img_wh)}
    if args.dataset_name == 'llff':
        kwargs['spheric_poses'] = args.spheric_poses
    dataset = dataset_dict[args.dataset_name](**kwargs)
    sample = dataset[args.idx]

    mcfg = ModelConfig()
    rcfg = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance,
        use_disp=args.use_disp, white_back=dataset.white_back,
        test_time=True, fused=args.fused_mlp)
    params = {k: params_from_numpy(v, device) for k, v in
              NeRFFamily(mcfg, rcfg).load_params(args.ckpt_path).items()}

    if args.occ_grid:
        t0 = time.perf_counter()
        occ = load_or_build_grid(
            args.ckpt_path,
            params["nerf_fine" if args.N_importance > 0 else "nerf_coarse"],
            mcfg, N=args.occ_N, occ_range=args.occ_range,
            sigma_threshold=args.occ_threshold,
            aabb=rays_aabb(sample['rays']), mode=args.occ_mode,
            vis_rays=(sample['rays'] if args.occ_mode == 'weight'
                      else None))
        print(f"occupancy grid: {occ.n_boxes} boxes, "
              f"{occ.occupied_fraction * 100:.1f}% blocks occupied "
              f"({time.perf_counter() - t0:.1f}s build/load)")
        cr = culled_renderer(args, occ, rcfg, mcfg, device)

        def render(params, rays):
            out, stats = cr(params, rays, return_stats=True)
            msg = (f"  culled {stats['n_rays'] - stats['n_survivors']}"
                   f"/{stats['n_rays']} rays")
            if "bucket_counts" in stats:
                msg += (f"; buckets {stats['bucket_counts']}"
                        f" (fracs {list(cr._BUCKET_FRACS)}),"
                        f" rendered {stats['n_rendered']}")
            print(msg)
            return out
    else:
        render = make_render_fn(rcfg, args.chunk, device, mcfg,
                                device_out=True)

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    typ = "fine" if args.N_importance > 0 else "coarse"
    rays = torch.as_tensor(sample['rays'], dtype=torch.float32, device=device)
    render(params, rays)                 # builds the kernels
    sync()
    t0 = time.perf_counter()
    results = render(params, rays)
    sync()
    dt = time.perf_counter() - t0

    img_pred = np.clip(results[f'rgb_{typ}'].cpu().numpy().reshape(h, w, 3),
                       0, 1)
    os.makedirs(args.out_dir, exist_ok=True)
    Image.fromarray((img_pred * 255).astype(np.uint8)).save(
        os.path.join(args.out_dir, f'render_{args.idx:03d}.png'))
    depth = visualize_depth(
        results[f'depth_{typ}'].cpu().numpy().reshape(h, w))
    Image.fromarray((depth.transpose(1, 2, 0) * 255).astype(np.uint8)).save(
        os.path.join(args.out_dir, f'depth_{args.idx:03d}.png'))

    print(f"secs/frame ({w}x{h}) on {device}: {dt:.3f}")
    if 'rgbs' in sample:
        gt = np.asarray(sample['rgbs']).reshape(h, w, 3)
        score = psnr_fn(torch.from_numpy(img_pred), torch.from_numpy(gt))
        print(f"PSNR: {float(score):.2f}")
    return dt


if __name__ == "__main__":
    main()
