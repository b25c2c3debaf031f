"""Mesh extraction pipeline: sigma-grid query, colored-mesh fusion, and the
Unity .vol volume export.

Port of nerf_pl_tpu/mesh/extract.py. `make_grid`, `grid_to_world`,
`bilinear_sample`, `compute_vertex_normals`, `export_vol` and the host
side of `fuse_colors_by_projection` (projection, Lanczos resize, bilinear
sampling, weighting; float64 where the JAX package's is) are its numpy,
line for line. On the device of the weights:
  * `query_grid` runs the plain f32 `nerf_apply` over make_grid's points,
    in its order, in chunks (the JAX package's tiled lax.map);
  * `occlusion_opacity` renders camera->vertex rays through the plain
    `render_rays_chunked`, as the JAX package does with its default
    RenderConfig (no fused kernel).
Both run with TF32 off: --sigma_threshold and --occ_threshold are hard
cut-offs, and a TF32 or bf16 sigma moves cells and vertices across them.
Marching cubes and the connected-component cleanup run in the native C++
library (mesh/native.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.embedding import embed
from ..models.nerf import nerf_apply
from ..rendering.render import ModelConfig, RenderConfig, render_rays_chunked
from ..training.metrics import no_tf32


def make_grid(N: int, x_range, y_range, z_range) -> np.ndarray:
    """Dense query grid, same ordering as the reference (np.meshgrid 'xy'
    indexing then reshape, extract_color_mesh.py:119-123) so the
    un-normalization xy-swap (:148-155) stays identical."""
    x = np.linspace(x_range[0], x_range[1], N)
    y = np.linspace(y_range[0], y_range[1], N)
    z = np.linspace(z_range[0], z_range[1], N)
    return np.stack(np.meshgrid(x, y, z), -1).reshape(-1, 3).astype(np.float32)


def _params_device(params: Dict) -> torch.device:
    return params["sigma"]["w"].device


def query_grid(params: Dict, xyz: np.ndarray,
               mcfg: ModelConfig = ModelConfig(),
               chunk: int = 64 * 1024,
               with_rgb: bool = False) -> np.ndarray:
    """Evaluate the MLP on a flat point list, `chunk` points at a time on
    the device of `params` (a {layer: {w, b}} dict of tensors).

    Returns sigma (N,) or rgbsigma (N, 4) when with_rgb (rgb queried with
    direction 0, like extract_color_mesh.py:124-137), as numpy."""
    dev = _params_device(params)
    pts = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(dev)
    n = pts.shape[0]
    out = torch.empty((n, 4 if with_rgb else 1), dtype=torch.float32,
                      device=dev)
    with torch.no_grad(), no_tf32():
        zero_dir_emb = embed(torch.zeros((1, 3), device=dev), mcfg.emb_dir)
        for start in range(0, n, chunk):
            x_emb = embed(pts[start:start + chunk], mcfg.emb_xyz)
            if with_rgb:
                rgb, sigma = nerf_apply(params, x_emb, zero_dir_emb,
                                        mcfg.nerf)
                out[start:start + chunk] = torch.cat([rgb, sigma], -1)
            else:
                out[start:start + chunk] = nerf_apply(
                    params, x_emb, None, mcfg.nerf, sigma_only=True)
    out = out.cpu().numpy()
    return out if with_rgb else out[:, 0]


def sigma_grid(params: Dict, N: int, x_range, y_range, z_range,
               mcfg: ModelConfig = ModelConfig(),
               chunk: int = 64 * 1024) -> np.ndarray:
    """relu'd sigma on the N^3 grid, shaped (N, N, N) in meshgrid order."""
    xyz = make_grid(N, x_range, y_range, z_range)
    sigma = query_grid(params, xyz, mcfg, chunk)
    return np.maximum(sigma, 0).reshape(N, N, N)


def grid_to_world(vertices: np.ndarray, N: int, x_range, y_range,
                  z_range) -> np.ndarray:
    """Grid-index vertices -> world, with the reference's xy swap
    (extract_color_mesh.py:148-155)."""
    v = vertices / N
    out = np.empty_like(v)
    out[:, 0] = (y_range[1] - y_range[0]) * v[:, 1] + y_range[0]
    out[:, 1] = (x_range[1] - x_range[0]) * v[:, 0] + x_range[0]
    out[:, 2] = (z_range[1] - z_range[0]) * v[:, 2] + z_range[0]
    return out.astype(np.float32)


def bilinear_sample(image: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Sample (H, W, C) image at float pixel coords uv=(x, y), (N, 2)."""
    H, W = image.shape[:2]
    x = np.clip(uv[:, 0], 0, W - 1)
    y = np.clip(uv[:, 1], 0, H - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    img = image.reshape(H * W, -1).astype(np.float64)
    v00 = img[y0 * W + x0]
    v01 = img[y0 * W + x1]
    v10 = img[y1 * W + x0]
    v11 = img[y1 * W + x1]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def compute_vertex_normals(vertices: np.ndarray,
                           triangles: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (replaces open3d's
    compute_vertex_normals for the --use_vertex_normal path)."""
    p = vertices[triangles]  # (T, 3, 3)
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])  # area-weighted
    vn = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(vn, triangles[:, c], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def occlusion_opacity(params_fine: Dict, rays: np.ndarray,
                      N_samples: int, chunk: int,
                      mcfg: ModelConfig = ModelConfig(),
                      white_back: bool = False) -> np.ndarray:
    """Accumulated opacity along camera->vertex rays (test_time sigma-only
    coarse pass on the FINE model, reference extract_color_mesh.py:263-269),
    on the device of `params_fine`, as numpy."""
    rcfg = RenderConfig(N_samples=N_samples, N_importance=0, perturb=0.0,
                        noise_std=0.0, white_back=white_back, test_time=True)
    dev = _params_device(params_fine)
    rays_t = torch.from_numpy(np.ascontiguousarray(rays, np.float32)).to(dev)
    with torch.no_grad(), no_tf32():
        out = render_rays_chunked({"nerf_coarse": params_fine}, rays_t,
                                  rcfg, mcfg, chunk=chunk)
    return out["opacity_coarse"].cpu().numpy()


def fuse_colors_by_projection(params_fine: Dict,
                              vertices_world: np.ndarray,
                              dataset,
                              img_wh: Tuple[int, int],
                              N_samples: int,
                              chunk: int,
                              occ_threshold: float,
                              mcfg: ModelConfig = ModelConfig(),
                              progress: bool = True) -> np.ndarray:
    """Default color method: project vertices into every training image,
    bilinear-sample colors, weight by occlusion test + inverse depth
    (reference extract_color_mesh.py:206-277)."""
    from PIL import Image

    W, H = img_wh
    K = np.array([[dataset.focal, 0, W / 2],
                  [0, dataset.focal, H / 2],
                  [0, 0, 1]], dtype=np.float32)
    N_vertices = len(vertices_world)
    vertices_homo = np.concatenate(
        [vertices_world, np.ones((N_vertices, 1))], 1)

    non_occluded_sum = np.zeros((N_vertices, 1))
    v_color_sum = np.zeros((N_vertices, 3))

    for idx in range(len(dataset.image_paths)):
        image = Image.open(dataset.image_paths[idx]).convert("RGB")
        image = image.resize(img_wh, Image.LANCZOS)
        image = np.array(image)

        P_c2w = np.concatenate(
            [dataset.poses[idx], np.array([[0, 0, 0, 1.0]])], 0)
        P_w2c = np.linalg.inv(P_c2w)[:3]
        vertices_cam = P_w2c @ vertices_homo.T        # "right up back"
        vertices_cam[1:] *= -1                        # "right down forward"
        vertices_image = (K @ vertices_cam).T         # (N, 3)
        depth = vertices_image[:, -1:] + 1e-5
        uv = vertices_image[:, :2] / depth
        uv[:, 0] = np.clip(uv[:, 0], 0, W - 1)
        uv[:, 1] = np.clip(uv[:, 1], 0, H - 1)
        colors = bilinear_sample(image, uv)           # (N, 3) in 0..255

        rays_o = np.broadcast_to(dataset.poses[idx][:, -1],
                                 (N_vertices, 3)).astype(np.float32)
        rays_d = vertices_world - rays_o
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        near = np.full((N_vertices, 1), dataset.bounds.min(), np.float32)
        far = depth.astype(np.float32)  # opacity accumulated up to the vertex
        rays = np.concatenate([rays_o, rays_d, near, far], 1)

        opacity = occlusion_opacity(params_fine, rays, N_samples, chunk,
                                    mcfg)[:, None]
        opacity = np.nan_to_num(opacity, nan=1.0)

        non_occluded = np.ones_like(non_occluded_sum) * 0.1 / depth
        non_occluded += opacity < occ_threshold
        v_color_sum += colors * non_occluded
        non_occluded_sum += non_occluded
        if progress:
            print(f"[mesh] fused view {idx + 1}/{len(dataset.image_paths)}",
                  flush=True)

    return (v_color_sum / non_occluded_sum).astype(np.uint8)


def export_vol(path: str, rgbsigma: np.ndarray, N: int, x_range):
    """Unity real-time volume-rendering export (reference
    extract_mesh.ipynb cell 7): for each voxel with alpha > 0, a pair of
    uint32 (flat index, r<<24|g<<16|b<<8|alpha*255)."""
    sigma = np.maximum(rgbsigma[:, 3], 0)
    a = 1 - np.exp(-(x_range[1] - x_range[0]) / N * sigma)
    rgb = (np.clip(rgbsigma[:, :3], 0, 1) * 255).astype(np.uint32)
    i = np.where(a > 0)[0]
    s = (rgb[i].dot(np.array([1 << 24, 1 << 16, 1 << 8], dtype=np.uint64))
         + (a[i] * 255).astype(np.uint64)).astype(np.uint32)
    res = np.stack([i.astype(np.uint32), s], -1).flatten()
    with open(path, "wb") as f:
        f.write(res.tobytes())
