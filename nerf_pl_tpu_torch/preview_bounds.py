"""Interactive bounds search for mesh extraction, as a CLI of the port.

    python -m nerf_pl_tpu_torch.preview_bounds --ckpt_path \
        ckpts/exp/last.ckpt --N_grid 128 --sigma_threshold 20 \
        --out_dir bounds_preview --preview_mesh preview.dae

Port of scripts/preview_bounds.py (the reference's extract_mesh.ipynb
cells 2-5, "Search for tight bounds of the object"), with its flags:
query a low-resolution sigma grid from a trained checkpoint, then

  * write slice-mosaic PNGs of the sigma field along each axis with the
    occupancy contour at --sigma_threshold overlaid,
  * print occupancy statistics and a SUGGESTED tight bound box (the bbox of
    occupied cells plus a margin) to paste into extract_color_mesh's flags,
  * optionally export a quick colorless preview mesh (--preview_mesh).

`get_opts`, `slice_mosaic` and `suggest_bounds` are the script's, line for
line. The grid query runs on cuda:0 through mesh.extract.query_grid (f32,
the plain MLP) and raises when there is no CUDA device; only a caller of
main(device="cpu") runs it on the CPU.
"""
import os
from argparse import ArgumentParser

import numpy as np


def get_opts(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--ckpt_path', type=str, required=True,
                        help='trained checkpoint to inspect')
    parser.add_argument('--model_name', type=str, default='nerf_fine',
                        help='which model to query (nerf_fine / nerf_coarse)')
    parser.add_argument('--N_grid', type=int, default=128,
                        help='sigma-grid resolution per axis (keep small '
                             'while searching)')
    parser.add_argument('--x_range', nargs=2, type=float, default=[-1.2, 1.2],
                        help='object bounding range on x')
    parser.add_argument('--y_range', nargs=2, type=float, default=[-1.2, 1.2],
                        help='object bounding range on y')
    parser.add_argument('--z_range', nargs=2, type=float, default=[-1.2, 1.2],
                        help='object bounding range on z')
    parser.add_argument('--sigma_threshold', type=float, default=20.0,
                        help='sigma above which a cell counts as occupied')
    parser.add_argument('--chunk', type=int, default=64 * 1024,
                        help='max points in flight per forward pass')
    parser.add_argument('--n_slices', type=int, default=8,
                        help='slices per axis in each mosaic image')
    parser.add_argument('--margin', type=float, default=0.05,
                        help='relative margin added to the suggested bounds')
    parser.add_argument('--preview_mesh', type=str, default=None,
                        help='also export a colorless preview mesh to this '
                             'path (.ply or .dae)')
    parser.add_argument('--out_dir', type=str, default='bounds_preview',
                        help='output directory for slice images')
    return parser.parse_args(argv)


def slice_mosaic(sigma: np.ndarray, axis: int, n_slices: int,
                 threshold: float) -> np.ndarray:
    """(N,N,N) sigma -> (H, W, 3) uint8 mosaic of n_slices JET slices with
    the occupancy mask burned in as white contours."""
    from .utils.visualization import visualize_depth
    N = sigma.shape[0]
    idxs = np.linspace(0, N - 1, n_slices).round().astype(int)
    tiles = []
    for i in idxs:
        sl = np.take(sigma, i, axis=axis)
        img = visualize_depth(np.log1p(np.maximum(sl, 0)))  # (3, N, N)
        img = np.transpose(img, (1, 2, 0))
        occ = sl > threshold
        # burn the occupancy boundary (occupied cells with an empty
        # 4-neighbor) in white
        interior = (occ & np.roll(occ, 1, 0) & np.roll(occ, -1, 0)
                    & np.roll(occ, 1, 1) & np.roll(occ, -1, 1))
        img[occ & ~interior] = 1.0
        tiles.append(img)
    cols = int(np.ceil(np.sqrt(n_slices)))
    rows = int(np.ceil(n_slices / cols))
    mosaic = np.zeros((rows * N, cols * N, 3), np.float32)
    for k, t in enumerate(tiles):
        r, c = divmod(k, cols)
        mosaic[r * N:(r + 1) * N, c * N:(c + 1) * N] = t
    return (mosaic * 255).astype(np.uint8)


def suggest_bounds(occ: np.ndarray, ranges, margin: float):
    """Tight world-space bbox of occupied cells + a relative margin.

    `occ` is the (N,N,N) occupancy grid laid out by make_grid (meshgrid 'xy'
    indexing: axis 0 <-> y, axis 1 <-> x, axis 2 <-> z)."""
    N = occ.shape[0]
    x_range, y_range, z_range = ranges
    axis_for = {"x": 1, "y": 0, "z": 2}
    spans = {"x": x_range, "y": y_range, "z": z_range}
    out = {}
    for name, ax in axis_for.items():
        other = tuple(a for a in range(3) if a != ax)
        hit = occ.any(axis=other)
        if not hit.any():
            out[name] = tuple(spans[name])
            continue
        lo_i, hi_i = np.argmax(hit), N - 1 - np.argmax(hit[::-1])
        lo, hi = np.array(spans[name])[0], np.array(spans[name])[1]
        cell = (hi - lo) / (N - 1)
        pad = margin * (hi - lo)
        out[name] = (max(lo, lo + lo_i * cell - pad),
                     min(hi, lo + hi_i * cell + pad))
    return out


def main(argv=None, device=None):
    import torch
    from PIL import Image

    from .device import resolve_device
    from .mesh.extract import grid_to_world, make_grid, query_grid
    from .mesh.native import marching_cubes
    from .models import init_nerf_params
    from .rendering import ModelConfig
    from .training.checkpoints import load_ckpt

    args = get_opts(argv)
    dev = resolve_device(device)
    os.makedirs(args.out_dir, exist_ok=True)

    mcfg = ModelConfig()
    gen = torch.Generator().manual_seed(0)
    params = {args.model_name: init_nerf_params(gen, mcfg.nerf, dev)}
    params = load_ckpt(params, args.ckpt_path, args.model_name)

    N = args.N_grid
    xyz = make_grid(N, args.x_range, args.y_range, args.z_range)
    sigma = np.maximum(
        query_grid(params[args.model_name], xyz, mcfg, args.chunk), 0
    ).reshape(N, N, N)

    occ = sigma > args.sigma_threshold
    frac = occ.mean()
    print(f"[preview] sigma: max={sigma.max():.1f} "
          f"mean={sigma.mean():.2f}; occupied "
          f"{frac * 100:.2f}% of cells at threshold "
          f"{args.sigma_threshold}")
    if frac == 0:
        print("[preview] nothing above threshold — lower --sigma_threshold "
              "or widen the ranges")
    elif frac > 0.5:
        print("[preview] more than half the grid is 'occupied' — raise "
              "--sigma_threshold (likely fog/noise)")

    for name, axis in (("y", 0), ("x", 1), ("z", 2)):
        mosaic = slice_mosaic(sigma, axis, args.n_slices,
                              args.sigma_threshold)
        out = os.path.join(args.out_dir, f"slices_{name}.png")
        Image.fromarray(mosaic).save(out)
        print(f"[preview] wrote {out}")

    bounds = suggest_bounds(occ, (args.x_range, args.y_range, args.z_range),
                            args.margin)
    print("[preview] suggested tight bounds "
          f"(margin {args.margin * 100:.0f}%):")
    print(f"  --x_range {bounds['x'][0]:.3f} {bounds['x'][1]:.3f} "
          f"--y_range {bounds['y'][0]:.3f} {bounds['y'][1]:.3f} "
          f"--z_range {bounds['z'][0]:.3f} {bounds['z'][1]:.3f}")

    if args.preview_mesh:
        from .mesh import write_dae, write_ply
        vertices, triangles = marching_cubes(sigma, args.sigma_threshold)
        if len(triangles) == 0:
            print("[preview] no surface at this threshold; skipping mesh")
        else:
            vw = grid_to_world(vertices, N, args.x_range, args.y_range,
                               args.z_range)
            writer = (write_dae if args.preview_mesh.endswith(".dae")
                      else write_ply)
            writer(args.preview_mesh, vw, triangles)
            print(f"[preview] wrote {args.preview_mesh} "
                  f"({len(vertices)} verts, {len(triangles)} tris)")
    return bounds


if __name__ == "__main__":
    main()
