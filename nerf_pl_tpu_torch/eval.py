"""Render a test split from a trained checkpoint with the PyTorch port.

    python -m nerf_pl_tpu_torch.eval --root_dir ... --ckpt_path ... [--fused_mlp]

Port of the repository's eval.py: the same flags and defaults, and the same
outputs (per-frame NNN.png, an animated GIF, PFM or raw depth, optional
ground-truth PNGs and a --metrics_out JSON), and it prints the mean PSNR
and SSIM when ground truth exists. It renders on cuda:0 and raises when
there is no CUDA device; only a caller of main(device="cpu") renders on
the CPU. `--fused_mlp` takes the fused render kernels.

Flags of later slices are rejected: the occupancy-culled renderer
(--occ_grid and its siblings, ROADMAP item A8) and more than one device
(--num_chips > 1, ROADMAP item A10). --compile_cache is accepted and does
nothing: PyTorch runs eagerly and the kernels are cached under build/.

The dataset classes are the port's copies of the JAX package's (numpy;
PIL where an image is read).
"""
import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from .config import COMPILE_CACHE_DEFAULT

OCC_FLAGS = ("occ_grid", "occ_threshold", "occ_mode", "occ_range", "occ_N",
             "occ_tighten", "occ_budgets", "occ_segments", "occ_bucket_fracs",
             "culled_chunk")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True,
                        help='path to the scene data directory')
    parser.add_argument('--dataset_name', type=str, default='blender',
                        choices=['blender', 'llff'],
                        help='dataset family (blender or llff)')
    parser.add_argument('--scene_name', type=str, default='test',
                        help='output folder name for this scene')
    parser.add_argument('--split', type=str, default='test',
                        help='split to render: test (novel path), '
                             'test_train (training poses), or val '
                             '(held-out views with ground truth)')
    parser.add_argument('--val_num', type=int, default=1,
                        help='llff --split val: number of distinct '
                             'nearest-center held-out views')
    parser.add_argument('--img_wh', nargs="+", type=int, default=[800, 800],
                        help='image resolution as WIDTH HEIGHT')
    parser.add_argument('--spheric_poses', default=False, action="store_true",
                        help='llff scene captured on a 360-degree path')
    parser.add_argument('--N_samples', type=int, default=64,
                        help='stratified samples per ray for the coarse pass')
    parser.add_argument('--N_importance', type=int, default=128,
                        help='extra importance samples per ray (fine pass)')
    parser.add_argument('--use_disp', default=False, action="store_true",
                        help='sample linearly in disparity instead of depth')
    parser.add_argument('--chunk', type=int, default=32 * 1024,
                        help='rays per render tile')
    parser.add_argument('--culled_chunk', type=int, default=None,
                        help='occupancy-culled renderer tile (not ported: '
                             'ROADMAP A8)')
    parser.add_argument('--ckpt_path', type=str, required=True,
                        help='trained checkpoint to render from')
    parser.add_argument('--save_depth', default=False, action="store_true",
                        help='also export per-frame depth maps')
    parser.add_argument('--depth_format', type=str, default='pfm',
                        choices=['pfm', 'bytes'],
                        help='depth export format')
    parser.add_argument('--num_chips', type=int, default=1,
                        help='devices to render on (only 1 is ported)')
    parser.add_argument('--precision', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='operand precision of the unfused MLP')
    parser.add_argument('--out_dir', type=str, default='results',
                        help='output root directory')
    parser.add_argument('--fused_mlp', default=False, action='store_true',
                        help='use the fused render kernels')
    parser.add_argument('--occ_grid', default=False, action='store_true',
                        help='occupancy-grid culling (not ported: ROADMAP A8)')
    parser.add_argument('--occ_threshold', type=float, default=1.0,
                        help='with --occ_grid (not ported)')
    parser.add_argument('--occ_mode', type=str, default='sigma',
                        choices=['sigma', 'weight'],
                        help='with --occ_grid (not ported)')
    parser.add_argument('--occ_range', nargs='+', type=float, default=None,
                        help='with --occ_grid (not ported)')
    parser.add_argument('--occ_N', type=int, default=128,
                        help='with --occ_grid (not ported)')
    parser.add_argument('--occ_tighten', default=False, action='store_true',
                        help='with --occ_grid (not ported)')
    parser.add_argument('--occ_budgets', default=False, action='store_true',
                        help='with --occ_grid (not ported)')
    parser.add_argument('--occ_segments', type=int, default=0,
                        help='with --occ_grid (not ported)')
    parser.add_argument('--occ_bucket_fracs', nargs='+', type=float,
                        default=None,
                        help='with --occ_grid (not ported)')
    parser.add_argument('--metrics_out', type=str, default=None,
                        help='write per-view PSNR/SSIM + the flag set as '
                             'JSON to this path')
    parser.add_argument('--save_gt', default=False, action='store_true',
                        help='also save ground-truth PNGs (gt_###.png)')
    parser.add_argument('--frames_per_dispatch', type=int, default=4,
                        help='frames whose rays are rendered in one call')
    parser.add_argument('--compile_cache', type=str,
                        default=COMPILE_CACHE_DEFAULT,
                        help='accepted for flag parity; does nothing here')
    return parser


def get_opts(argv=None):
    return build_parser().parse_args(argv)


def check_ported(args, parser):
    """Reject the flags of slices that are not ported yet."""
    for name in OCC_FLAGS:
        if getattr(args, name) != parser.get_default(name):
            parser.error(f"--{name}: the occupancy-culled renderer is not "
                         f"ported yet (ROADMAP item A8)")
    if args.num_chips != 1:
        parser.error("--num_chips: rendering on more than one device is not "
                     "ported yet (ROADMAP item A10)")


def save_gif(path, frames, fps=30):
    try:
        import imageio
        imageio.mimsave(path, frames, duration=1000.0 / fps, loop=0)
    except (ImportError, TypeError):
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)


def main(argv=None, device=None):
    from PIL import Image

    from .datasets import dataset_dict
    from .datasets.depth_utils import save_pfm
    from .device import resolve_device
    from .models import init_nerf_params
    from .parallel import make_render_fn
    from .rendering import ModelConfig, RenderConfig
    from .training.checkpoints import load_ckpt
    from .training.metrics import psnr as psnr_fn
    from .training.metrics import ssim as ssim_fn

    parser = build_parser()
    args = parser.parse_args(argv)
    check_ported(args, parser)
    w, h = args.img_wh
    device = resolve_device(device)
    print(f"[eval] device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    kwargs = {'root_dir': args.root_dir, 'split': args.split,
              'img_wh': tuple(args.img_wh)}
    if args.dataset_name == 'llff':
        kwargs['spheric_poses'] = args.spheric_poses
        kwargs['val_num'] = args.val_num
    dataset = dataset_dict[args.dataset_name](**kwargs)

    mcfg = ModelConfig()
    gen = torch.Generator().manual_seed(0)
    params = {"nerf_coarse": init_nerf_params(gen, mcfg.nerf),
              "nerf_fine": init_nerf_params(gen, mcfg.nerf)}
    params = load_ckpt(params, args.ckpt_path, "nerf_coarse")
    if args.N_importance > 0:
        # a coarse-only checkpoint raises here rather than rendering from
        # random fine weights
        params = load_ckpt(params, args.ckpt_path, "nerf_fine")

    rcfg = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance,
        use_disp=args.use_disp, perturb=0.0, noise_std=0.0,
        white_back=dataset.white_back, test_time=True,
        compute_dtype=(torch.bfloat16 if args.precision == "bfloat16"
                       else torch.float32),
        fused=args.fused_mlp)
    render = make_render_fn(rcfg, args.chunk, device, mcfg)

    typ = "fine" if args.N_importance > 0 else "coarse"
    dir_name = os.path.join(args.out_dir, args.dataset_name, args.scene_name)
    os.makedirs(dir_name, exist_ok=True)

    imgs, psnrs, ssims, view_ids = [], [], [], []
    px = h * w
    fpd = max(1, args.frames_per_dispatch)
    dispatch_times = []
    for start in range(0, len(dataset), fpd):
        idxs = list(range(start, min(start + fpd, len(dataset))))
        samples = [dataset[i] for i in idxs]
        rays_all = np.concatenate([s['rays'] for s in samples], 0)
        t0 = time.perf_counter()
        results = render(params, rays_all)
        dispatch_times.append((time.perf_counter() - t0, len(idxs)))

        for j, (i, sample) in enumerate(zip(idxs, samples)):
            img_pred = results[f'rgb_{typ}'][j * px:(j + 1) * px] \
                .reshape(h, w, 3)
            if args.save_depth:
                depth_pred = np.nan_to_num(
                    results[f'depth_{typ}'][j * px:(j + 1) * px]
                    .reshape(h, w))
                if args.depth_format == 'pfm':
                    save_pfm(os.path.join(dir_name, f'depth_{i:03d}.pfm'),
                             depth_pred.astype(np.float32))
                else:
                    with open(os.path.join(dir_name, f'depth_{i:03d}'),
                              'wb') as f:
                        f.write(depth_pred.tobytes())

            img_pred_ = (np.clip(img_pred, 0, 1) * 255).astype(np.uint8)
            imgs.append(img_pred_)
            Image.fromarray(img_pred_).save(
                os.path.join(dir_name, f'{i:03d}.png'))

            if 'rgbs' in sample:
                gt = np.asarray(sample['rgbs']).reshape(h, w, 3)
                pred_t = torch.from_numpy(np.ascontiguousarray(img_pred))
                gt_t = torch.from_numpy(np.ascontiguousarray(gt))
                view_ids.append(i)
                psnrs.append(float(psnr_fn(pred_t, gt_t)))
                ssims.append(float(ssim_fn(pred_t.permute(2, 0, 1),
                                           gt_t.permute(2, 0, 1))))
                if args.save_gt:
                    Image.fromarray(
                        (np.clip(gt, 0, 1) * 255).astype(np.uint8)).save(
                        os.path.join(dir_name, f'gt_{i:03d}.png'))
        print(f"[eval] frame {idxs[-1] + 1}/{len(dataset)}", flush=True)

    save_gif(os.path.join(dir_name, f'{args.scene_name}.gif'), imgs, fps=30)

    n_f = len(dataset)
    render_time = sum(t for t, _ in dispatch_times)
    first_t, first_n = dispatch_times[0]
    steady_n = n_f - first_n
    steady = ((render_time - first_t) / steady_n if steady_n
              else float("nan"))
    print(f"[eval] {n_f} frames rendered in {render_time:.3f} s on "
          f"{device}: first dispatch ({first_n} frames, kernel build "
          f"included) {first_t:.3f} s; steady state {steady:.4f} s/frame "
          f"over the other {steady_n} frames")
    if psnrs:
        print(f'Mean PSNR : {np.mean(psnrs):.2f}')
        print(f'Mean SSIM : {np.mean(ssims):.4f}')
    if args.metrics_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.metrics_out)),
                    exist_ok=True)
        payload = {
            "flags": {k: v for k, v in sorted(vars(args).items())},
            "device": str(device),
            "n_views": n_f,
            "per_view": [{"view": v, "psnr": round(p, 4),
                          "ssim": round(s, 6)}
                         for v, p, s in zip(view_ids, psnrs, ssims)],
            "mean_psnr": round(float(np.mean(psnrs)), 4) if psnrs else None,
            "min_psnr": round(float(np.min(psnrs)), 4) if psnrs else None,
            "mean_ssim": round(float(np.mean(ssims)), 6) if ssims else None,
            "render_secs_total": round(render_time, 2),
            "render_secs_first_dispatch": round(first_t, 3),
            "render_secs_per_frame_steady": (round(steady, 4) if steady_n
                                             else None),
        }
        with open(args.metrics_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[eval] metrics written to {args.metrics_out}")
    return np.mean(psnrs) if psnrs else None


if __name__ == "__main__":
    main()
