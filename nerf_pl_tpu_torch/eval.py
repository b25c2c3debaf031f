"""Render a test split from a trained checkpoint with the PyTorch port.

    python -m nerf_pl_tpu_torch.eval --root_dir ... --ckpt_path ... [--fused_mlp]

Port of the repository's eval.py: the same flags and defaults, and the same
outputs (per-frame NNN.png, an animated GIF, PFM or raw depth, optional
ground-truth PNGs and a --metrics_out JSON), and it prints the mean PSNR
and SSIM when ground truth exists. It renders on cuda:0 and raises when
there is no CUDA device; only a caller of main(device="cpu") renders on
the CPU. `--fused_mlp` takes the fused render kernels.

`--occ_grid` (with `--occ_mode`, `--occ_tighten`, `--occ_budgets`,
`--occ_segments`, `--occ_bucket_fracs`, `--culled_chunk`) renders through
the occupancy-culled renderer (`rendering.CulledRenderer`), its grid
cached beside the checkpoint, as eval.py does; like eval.py it pads the
last group of --frames_per_dispatch frames with copies of its last frame,
since the cull sorts and tiles the rays of a whole dispatch.

`--num_chips N` renders data parallel, one process a rank
(`dist.py`): on the card over min(N, the cards there are) ranks,
one card each, over NCCL, as eval.py takes min(--num_chips,
len(jax.devices())); with main(device="cpu") over N gloo ranks on the
CPU. Each rank renders its share of every dispatch's tiles, dense
(`make_render_fn`) or culled (`CulledRenderer`, the grid built or loaded
on rank 0 and broadcast), and rank 0 writes the images, depth maps, GIF
and metrics and prints the PSNR. --compile_cache is accepted and does
nothing: PyTorch runs eagerly and the kernels are cached under build/.

`--model mipnerf360` renders a mip-NeRF 360 checkpoint (the train CLI's
`--model mipnerf360` and its `--mip_*` widths and samples) from an llff
scene in the 360 layout, through its family (`training/families.py`), on
one device; the NeRF paths' flags (--fused_mlp, --occ_grid, --num_chips
> 1) are refused at parse time.

The dataset classes are the port's copies of the JAX package's (numpy;
PIL where an image is read).
"""
import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from .config import COMPILE_CACHE_DEFAULT, add_mip_flags, model_config


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
                        help='base ray tile of the occupancy-culled '
                             'renderer (default: min(--chunk, '
                             'CulledRenderer.DEFAULT_CHUNK=8192))')
    parser.add_argument('--ckpt_path', type=str, required=True,
                        help='trained checkpoint to render from')
    parser.add_argument('--save_depth', default=False, action="store_true",
                        help='also export per-frame depth maps')
    parser.add_argument('--depth_format', type=str, default='pfm',
                        choices=['pfm', 'bytes'],
                        help='depth export format')
    parser.add_argument('--num_chips', type=int, default=1,
                        help='devices to render on, one process each')
    parser.add_argument('--precision', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='operand precision of the unfused MLP')
    parser.add_argument('--out_dir', type=str, default='results',
                        help='output root directory')
    parser.add_argument('--fused_mlp', default=False, action='store_true',
                        help='use the fused render kernels')
    parser.add_argument('--occ_grid', default=False, action='store_true',
                        help='occupancy-grid empty-space skipping (rays '
                             'that miss every box keep the analytic '
                             'background; grid cached next to the '
                             'checkpoint)')
    parser.add_argument('--occ_threshold', type=float, default=1.0,
                        help='sigma above which a grid cell is occupied')
    parser.add_argument('--occ_mode', type=str, default='sigma',
                        choices=['sigma', 'weight'],
                        help='cell criterion: sigma = raw density '
                             'threshold; weight = visibility-pruned (a '
                             'cell is kept only if some eval ray deposits '
                             'quadrature weight on it)')
    parser.add_argument('--occ_range', nargs='+', type=float, default=None,
                        help='grid world extent: 2 values (symmetric lo hi)'
                             ' or 6 (lox loy loz hix hiy hiz); omit to '
                             'auto-derive from the model + cameras')
    parser.add_argument('--occ_N', type=int, default=128,
                        help='occupancy grid resolution per axis')
    parser.add_argument('--occ_tighten', default=False, action='store_true',
                        help='clip surviving rays to their occupied interval')
    parser.add_argument('--occ_budgets', default=False, action='store_true',
                        help='with --occ_tighten: render short-span rays '
                             'with proportionally fewer samples')
    parser.add_argument('--occ_segments', type=int, default=0,
                        help='per-ray occupied-segment mask bits (<=32): '
                             'samples concentrate in occupied segments of '
                             'the tightened interval; with --occ_budgets, '
                             'buckets key on occupied length. 0 = off')
    parser.add_argument('--occ_bucket_fracs', nargs='+', type=float,
                        default=None,
                        help='budgeted span-bucket sample fractions '
                             '(ascending, must end at 1.0)')
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
    add_mip_flags(parser)
    return parser


def get_opts(argv=None):
    args = build_parser().parse_args(argv)
    if args.model == "mipnerf360":
        bad = [f for f, on in (("--fused_mlp", args.fused_mlp),
                               ("--occ_grid", args.occ_grid),
                               (f"--num_chips {args.num_chips}",
                                args.num_chips > 1),
                               (f"--dataset_name {args.dataset_name}",
                                args.dataset_name != "llff")) if on]
        if bad:
            raise ValueError(f"--model mipnerf360 does not take "
                             f"{', '.join(bad)}: it renders an llff scene "
                             "in the 360 layout on one device, unfused")
    return args


def save_gif(path, frames, fps=30):
    try:
        import imageio
        imageio.mimsave(path, frames, duration=1000.0 / fps, loop=0)
    except (ImportError, TypeError):
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)


def culled_renderer(args, occ, rcfg, mcfg, device, group=None):
    """The CLIs' CulledRenderer from their --occ_* flags, over `group`'s
    ranks when given. The base tile is min(--chunk, DEFAULT_CHUNK) unless
    --culled_chunk gives it (0 raises there); tightening is on with any of
    --occ_tighten, --occ_budgets and --occ_segments."""
    from .rendering import CulledRenderer

    return CulledRenderer(
        occ, rcfg, mcfg,
        chunk=(args.culled_chunk if args.culled_chunk is not None else
               min(args.chunk, CulledRenderer.DEFAULT_CHUNK)),
        tighten=(args.occ_tighten or args.occ_budgets
                 or args.occ_segments > 0),
        budgets=args.occ_budgets, segments=args.occ_segments,
        bucket_fracs=(tuple(args.occ_bucket_fracs)
                      if args.occ_bucket_fracs else None),
        device=device, group=group)


def culled_render_fn(args, dataset, params, rcfg, mcfg, device, group=None):
    """The --occ_grid renderer of eval.py: the grid built (or loaded from
    its cache) on the fine MLP, the aabb from every len//8-th pose and, in
    weight mode, the visibility rays from every len//32-th; returns
    render(params, samples) -> numpy outputs of the samples' rays. In a
    group rank 0 builds or loads the grid and broadcasts it, and the ranks
    render together."""
    from . import dist as pdist

    occ = None
    if pdist.is_main(group):
        occ = _culled_grid(args, dataset, params, mcfg, device)
    occ = pdist.broadcast_object(occ, group)
    cr = culled_renderer(args, occ, rcfg, mcfg, device, group)

    def render(params, samples):
        rays = np.concatenate([s['rays'] for s in samples])
        return {k: v.cpu().numpy() for k, v in cr(params, rays).items()}
    return render


def _culled_grid(args, dataset, params, mcfg, device):
    from .models import params_from_numpy
    from .rendering import load_or_build_grid, rays_aabb

    n = len(dataset)
    aabb_rays = np.concatenate(
        [dataset[i]['rays'] for i in range(0, n, max(1, n // 8))], 0)
    vis_rays = None
    if args.occ_mode == "weight":
        # the poses about to be rendered: a cell is culled only if no eval
        # ray can visibly reach it
        vis_rays = np.concatenate(
            [dataset[i]['rays'] for i in range(0, n, max(1, n // 32))], 0)
    grid_mlp = params["nerf_fine" if args.N_importance > 0 else "nerf_coarse"]
    occ = load_or_build_grid(
        args.ckpt_path, params_from_numpy(grid_mlp, device), mcfg,
        N=args.occ_N, occ_range=args.occ_range,
        sigma_threshold=args.occ_threshold, aabb=rays_aabb(aabb_rays),
        mode=args.occ_mode, vis_rays=vis_rays)
    print(f"[occ] {occ.n_boxes} boxes, "
          f"{occ.occupied_fraction * 100:.1f}% blocks occupied")
    return occ


def main(argv=None, device=None):
    """Parse eval.py's flags and render; returns the mean PSNR (None
    without ground truth). --num_chips > 1 spawns the ranks."""
    from . import dist as pdist

    args = get_opts(argv)
    kind, world = pdist.plan_world(args.num_chips, device)
    if world == 1:
        return _eval(args, device)
    return pdist.launch(_eval_rank, world, args, device=kind)[0]


def _eval_rank(group, device, args):
    """One rank of a data parallel render (spawned by `dist.launch`)."""
    return _eval(args, device, group)


def _eval(args, device, group=None):
    from PIL import Image

    from .datasets.depth_utils import save_pfm
    from .device import resolve_device
    from . import dist as pdist
    from .rendering import RenderConfig
    from .training.families import family_for
    from .training.metrics import psnr as psnr_fn
    from .training.metrics import ssim as ssim_fn

    w, h = args.img_wh
    device = resolve_device(device)
    main_rank = pdist.is_main(group)
    if main_rank:
        print(f"[eval] device {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else "")
              + f"; world {pdist.world_of(group)}")

    # N_importance names the NeRF's MLPs
    family = family_for(model_config(args),
                        RenderConfig(N_importance=args.N_importance))
    dataset = family.dataset(args, args.split)
    params = family.load_params(args.ckpt_path)
    rcfg = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance,
        use_disp=args.use_disp, white_back=dataset.white_back,
        test_time=True,
        compute_dtype=(torch.bfloat16 if args.precision == "bfloat16"
                       else torch.float32),
        fused=args.fused_mlp)
    render = (culled_render_fn(args, dataset, params, rcfg, family.mcfg,
                               device, group) if args.occ_grid else
              family.render_fn(rcfg, args.chunk, device, group))
    dir_name = os.path.join(args.out_dir, args.dataset_name, args.scene_name)
    if main_rank:
        os.makedirs(dir_name, exist_ok=True)

    imgs, psnrs, ssims, view_ids = [], [], [], []
    px = h * w
    fpd = max(1, args.frames_per_dispatch)
    dispatch_times = []
    for start in range(0, len(dataset), fpd):
        idxs = list(range(start, min(start + fpd, len(dataset))))
        samples = [dataset[i] for i in idxs]
        # the culled path pads the last group to a whole dispatch, as
        # eval.py does: the cull sorts and tiles a dispatch's rays together
        n_pad_frames = fpd - len(idxs) if (start and args.occ_grid) else 0
        t0 = time.perf_counter()
        results = render(params, samples + samples[-1:] * n_pad_frames)
        typ = "fine" if "rgb_fine" in results else "coarse"
        dispatch_times.append((time.perf_counter() - t0, len(idxs)))
        if not main_rank:
            continue

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

    if not main_rank:
        return None
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
