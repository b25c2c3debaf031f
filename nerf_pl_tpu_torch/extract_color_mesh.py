"""Extract a colored mesh (PLY or COLLADA) from a trained NeRF with the
PyTorch port.

    python -m nerf_pl_tpu_torch.extract_color_mesh --root_dir ... \
        --ckpt_path ... [--use_vertex_normal] [--export_vol]

Port of the repository's extract_color_mesh.py: the same flags, dests and
defaults, and the same pipeline: sigma grid -> marching cubes at
--sigma_threshold -> largest-cluster noise removal -> per-vertex color by
projection + occlusion fusion (default) or by rendering along the vertex
normals (--use_vertex_normal, coarse + fine at test time) -> .ply or .dae,
and with --export_vol the Unity .vol packed volume. The grid query and the
renders run on cuda:0, in f32 through the plain MLP (no fused kernel, as in
the JAX package), and raise when there is no CUDA device; only a caller of
main(device="cpu") runs them on the CPU. --compile_cache is accepted and
does nothing. The marching-cubes library is built with g++ on first use
(mesh/native.py).
"""
import os
from argparse import ArgumentParser

import numpy as np
import torch

from .config import COMPILE_CACHE_DEFAULT


def get_opts(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True,
                        help='path to the scene data directory')
    parser.add_argument('--dataset_name', type=str, default='blender',
                        choices=['blender', 'llff'],
                        help='dataset family (blender or llff)')
    parser.add_argument('--scene_name', type=str, default='test',
                        help='name used for the output .ply file')
    parser.add_argument('--img_wh', nargs="+", type=int, default=[800, 800],
                        help='image resolution as WIDTH HEIGHT')

    parser.add_argument('--N_samples', type=int, default=64,
                        help='coarse samples per occlusion-test ray')
    parser.add_argument('--chunk', type=int, default=32 * 1024,
                        help='max points/rays in flight per forward pass (memory bound)')
    parser.add_argument('--ckpt_path', type=str, required=True,
                        help='trained checkpoint to extract from')

    parser.add_argument('--N_grid', type=int, default=256,
                        help='sigma-grid resolution per axis (larger = finer mesh)')
    parser.add_argument('--x_range', nargs="+", type=float, default=[-1.0, 1.0],
                        help='object bounding range on x')
    parser.add_argument('--y_range', nargs="+", type=float, default=[-1.0, 1.0],
                        help='object bounding range on y')
    parser.add_argument('--z_range', nargs="+", type=float, default=[-1.0, 1.0],
                        help='object bounding range on z')
    parser.add_argument('--sigma_threshold', type=float, default=20.0,
                        help='sigma above which a grid cell counts as occupied')
    parser.add_argument('--occ_threshold', type=float, default=0.2,
                        help='''threshold to consider a vertex is occluded.
                                larger=fewer occluded pixels''')

    #### method using vertex normals ####
    parser.add_argument('--use_vertex_normal', action="store_true",
                        help='color vertices by rendering along vertex normals instead of projecting into training views')
    parser.add_argument('--N_importance', type=int, default=64,
                        help='fine samples per occlusion-test ray')
    parser.add_argument('--near_t', type=float, default=1.0,
                        help='fraction of the camera-to-vertex distance at which occlusion rays start')

    parser.add_argument('--export_vol', action="store_true",
                        help='also export a Unity .vol packed RGBA volume')
    parser.add_argument('--mesh_format', type=str, default='ply',
                        choices=['ply', 'dae'],
                        help='output mesh format (dae covers the reference '
                             'notebook\'s COLLADA export)')
    parser.add_argument('--out_dir', type=str, default='.',
                        help='output directory')
    parser.add_argument('--compile_cache', type=str,
                        default=COMPILE_CACHE_DEFAULT,
                        help='accepted for the JAX CLI\'s flag set; the '
                             'port caches no compiled programs')
    return parser.parse_args(argv)


def main(argv=None, device=None):
    from .datasets import dataset_dict
    from .device import resolve_device
    from .mesh import write_dae, write_ply
    from .mesh.extract import (compute_vertex_normals, export_vol,
                               fuse_colors_by_projection, grid_to_world,
                               make_grid, query_grid)
    from .mesh.native import keep_largest_cluster, marching_cubes
    from .models import init_nerf_params
    from .rendering import ModelConfig, RenderConfig, render_rays_chunked
    from .training.checkpoints import load_ckpt, model_names
    from .training.metrics import no_tf32

    args = get_opts(argv)
    if "nerf_mlp" in model_names(args.ckpt_path):
        raise ValueError(f"{args.ckpt_path} is a mip-NeRF 360 checkpoint: "
                         "mesh extraction takes a NeRF's (nerf_coarse, "
                         "nerf_fine)")
    dev = resolve_device(device)

    kwargs = {'root_dir': args.root_dir, 'img_wh': tuple(args.img_wh)}
    if args.dataset_name == 'llff':
        kwargs['spheric_poses'] = True
        kwargs['split'] = 'test'
    else:
        kwargs['split'] = 'train'
    dataset = dataset_dict[args.dataset_name](**kwargs)

    mcfg = ModelConfig()
    gen = torch.Generator().manual_seed(0)
    params = {"nerf_coarse": init_nerf_params(gen, mcfg.nerf, dev),
              "nerf_fine": init_nerf_params(gen, mcfg.nerf, dev)}
    params = load_ckpt(params, args.ckpt_path, "nerf_fine")
    params_fine = params["nerf_fine"]

    # Step 1: dense sigma grid + marching cubes
    print('Predicting occupancy ...', flush=True)
    N = args.N_grid
    xyz = make_grid(N, args.x_range, args.y_range, args.z_range)
    need_rgb = args.export_vol
    out = query_grid(params_fine, xyz, mcfg, args.chunk, with_rgb=need_rgb)
    if need_rgb:
        rgbsigma = out
        sigma = np.maximum(out[:, 3], 0).reshape(N, N, N)
    else:
        sigma = np.maximum(out, 0).reshape(N, N, N)

    print('Extracting mesh ...', flush=True)
    vertices, triangles = marching_cubes(sigma, args.sigma_threshold)
    if len(triangles) == 0:
        raise SystemExit(
            "no surface found: lower --sigma_threshold or check ranges")

    print('Removing noise ...', flush=True)
    vertices, triangles = keep_largest_cluster(vertices, triangles)
    print(f'Mesh has {len(vertices) / 1e6:.2f} M vertices and '
          f'{len(triangles) / 1e6:.2f} M faces.', flush=True)

    vertices_world = grid_to_world(vertices, N, args.x_range, args.y_range,
                                   args.z_range)

    # Step 2: per-vertex color
    if args.use_vertex_normal:
        # Rays along (negated-offset) vertex normals through the full
        # coarse+fine renderer (reference extract_color_mesh.py:187-204).
        params = load_ckpt(params, args.ckpt_path, "nerf_coarse")
        normals = compute_vertex_normals(vertices_world, triangles)
        near = dataset.bounds.min() * np.ones((len(vertices_world), 1),
                                              np.float32)
        far = dataset.bounds.max() * np.ones_like(near)
        rays_o = vertices_world - normals * near * args.near_t
        rays = np.concatenate(
            [rays_o, normals, near, far], 1).astype(np.float32)
        rcfg = RenderConfig(N_samples=args.N_samples,
                            N_importance=args.N_importance,
                            white_back=dataset.white_back, test_time=True)
        with torch.no_grad(), no_tf32():
            out = render_rays_chunked(params, torch.from_numpy(rays).to(dev),
                                      rcfg, mcfg, chunk=args.chunk)
        v_colors = (np.clip(out["rgb_fine"].cpu().numpy(), 0, 1)
                    * 255).astype(np.uint8)
    else:
        print('Fusing colors ...', flush=True)
        v_colors = fuse_colors_by_projection(
            params_fine, vertices_world, dataset, tuple(args.img_wh),
            args.N_samples, args.chunk, args.occ_threshold, mcfg)

    out_mesh = os.path.join(args.out_dir,
                            f'{args.scene_name}.{args.mesh_format}')
    writer = write_dae if args.mesh_format == 'dae' else write_ply
    writer(out_mesh, vertices_world, triangles, v_colors)
    print(f'Done! {out_mesh}', flush=True)

    if args.export_vol:
        out_vol = os.path.join(args.out_dir, f'{args.scene_name}.vol')
        export_vol(out_vol, rgbsigma, N, args.x_range)
        print(f'Exported {out_vol}', flush=True)


if __name__ == "__main__":
    main()
