"""Occupancy: the σ-grid build, its cache, the ray-box tests that tighten
the training store, and the occupancy-culled renderer of eval.

Port of nerf_pl_tpu/rendering/occupancy.py, plain PyTorch (the JAX module
is plain XLA and holds no kernel):
  * the grid build: the σ field of the plain f32 σ-only MLP at the cell
    centres of an N^3 grid, thresholded (or, in weight mode, marched by
    the training rays and kept where some ray deposits quadrature weight),
    dilated by one cell, reduced to a block map and merged into
    world-space boxes (`build_occupancy_grid`);
  * the grid cache beside the checkpoint (`load_or_build_grid`), keyed as
    the JAX package keys it, under a file suffix of the port's own;
  * the ray-box slab tests: `ray_box_hits` (hit flag and the union
    interval of a ray's box overlaps) and `ray_box_segment_bits` (a
    per-ray mask of the equal z segments some box overlaps), and the mask
    helpers;
  * `CulledRenderer`: the cull pass (`cull_rays`) and tiles of
    `render_rays` over the surviving rays, scattered into a background
    image.
Everything runs on the device of its inputs. `_blocks_to_boxes`,
`rays_aabb`, `_boundary_occupied` and `_grid_cache_key` are numpy and are
copies of the JAX package's, line for line.

The segment masks are int64 tensors holding the 32 bits of the JAX
package's uint32 masks: torch's uint32 has no shifts or ORs on CUDA, and
bit 31 (`--occ_segments 32`, the default) must survive.

The slab tests loop over boxes in Python, on chunks of RAY_CHUNK rays, so
that a store of millions of rays holds one chunk's (C, n_seg) temporaries
at a time. Each step is one elementwise op, so the CPU and a GPU give the
same bits.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
import warnings
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import dist as pdist
from ..device import resolve_device
from ..models.embedding import embed
from ..models.nerf import nerf_apply
from ..utils import profiling as P
from .render import ModelConfig, RenderConfig, prepare_params, render_rays

RAY_CHUNK = 1 << 20


# --------------------------------------------------------------------- build

def pick_block(N: int, target_blocks: int = 16) -> int:
    """Largest divisor of N giving at least ``target_blocks`` blocks per
    edge."""
    best = 1
    for b in range(1, max(N // target_blocks, 1) + 1):
        if N % b == 0:
            best = b
    return best


def _params_device(params: Dict) -> torch.device:
    return params["sigma"]["w"].device


def _sigma_grid(params: Dict, mcfg: ModelConfig, N: int, lo, hi,
                chunk: int) -> torch.Tensor:
    """Raw σ at the N^3 cell centres, (N^3,) f32 on the params' device, in
    chunks of `chunk` points. The flat index is ix * N^2 + iy * N + iz."""
    dev = _params_device(params)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    cell = (hi - lo) / N
    n_pts = N * N * N
    sigma = torch.empty(n_pts, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for start in range(0, n_pts, chunk):
            flat = torch.arange(start, min(start + chunk, n_pts), device=dev)
            ijk = torch.stack([flat // (N * N), (flat // N) % N, flat % N],
                              dim=-1).to(torch.float32)
            xyz = lo + (ijk + 0.5) * cell
            sigma[start:start + len(flat)] = nerf_apply(
                params, embed(xyz, mcfg.emb_xyz), None, mcfg.nerf,
                sigma_only=True)[:, 0]
    return sigma


def _dilate_to_blocks(occ: torch.Tensor, N: int, block: int) -> torch.Tensor:
    """One-cell dilation of an (N^3,) bool grid by rolls (the wrap only
    adds occupancy), then a per-block any: (B, B, B) uint8, B = N //
    block."""
    dil = occ.reshape(N, N, N)
    for axis in range(3):
        dil = dil | torch.roll(dil, 1, axis) | torch.roll(dil, -1, axis)
    B = N // block
    return dil.reshape(B, block, B, block, B, block).to(torch.uint8).amax(
        dim=(1, 3, 5))


def _sigma_block_map(params: Dict, mcfg: ModelConfig, N: int, block: int,
                     lo, hi, sigma_threshold: float,
                     chunk: int) -> torch.Tensor:
    """(B, B, B) uint8 block occupancy on the params' device: σ above the
    threshold, dilated by one cell."""
    sigma = _sigma_grid(params, mcfg, N, lo, hi, chunk)
    return _dilate_to_blocks(sigma > sigma_threshold, N, block)


def weight_block_map_from_sigma(sigma_flat: torch.Tensor, N: int, block: int,
                                lo, hi, rays: torch.Tensor,
                                sigma_threshold: float, n_steps: int = 256,
                                ray_chunk: int = 8192) -> torch.Tensor:
    """Visibility-pruned (B, B, B) block map from a raw σ grid: the rays
    march the grid (nearest cell, n_steps equal steps over [near, far]),
    and a cell is kept iff some ray deposits a quadrature weight alpha * T
    >= 1 - exp(-sigma_threshold * delta) there; then the one-cell dilation.
    For unoccluded cells (T ~ 1) that is the plain σ threshold; occluded
    junk density (T ~ 0) prunes away. Only the marched rays' visibility
    counts, so pass the rays about to be rendered or trained on."""
    dev = sigma_flat.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    cell = (hi - lo) / N
    sigma_flat = torch.relu(sigma_flat)
    s = (torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5) \
        / n_steps
    rmap = torch.zeros(N * N * N, dtype=torch.float32, device=dev)
    for start in range(0, rays.shape[0], ray_chunk):
        r = rays[start:start + ray_chunk]
        o, d = r[:, 0:3], r[:, 3:6]
        near, far = r[:, 6], r[:, 7]
        t = near[:, None] + (far - near)[:, None] * s[None, :]   # (C, S)
        # world-space step: delta_z * |d|, as the quadrature scales it
        dn = torch.linalg.norm(d, dim=-1)
        delta = ((far - near) / n_steps * dn)[:, None]
        xyz = o[:, None, :] + d[:, None, :] * t[..., None]       # (C, S, 3)
        ijk = torch.floor((xyz - lo) / cell).to(torch.int64)
        inb = ((ijk >= 0) & (ijk < N)).all(dim=-1)
        ijk = ijk.clamp(0, N - 1)
        idxf = (ijk[..., 0] * N + ijk[..., 1]) * N + ijk[..., 2]
        sig = torch.where(inb, sigma_flat[idxf], 0.0)
        alpha = 1.0 - torch.exp(-sig * delta)
        trans = torch.cumprod(torch.cat(
            [torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=1),
            dim=1)[:, :-1]
        a_t = 1.0 - torch.exp(-sigma_threshold * delta)
        ratio = alpha * trans / torch.clamp(a_t, min=1e-12)
        rmap.scatter_reduce_(0, idxf.reshape(-1), ratio.reshape(-1), "amax")
    return _dilate_to_blocks(rmap >= 1.0, N, block)


def _blocks_to_boxes(block_map: np.ndarray, lo: np.ndarray,
                     hi: np.ndarray) -> np.ndarray:
    """(B,B,B) bool -> (K, 6) world AABBs [lo_xyz, hi_xyz].

    Boxes are z-run-length merged per (x, y) block column, then adjacent
    boxes with identical (x-range, z-range) merge along y — typically a few
    dozen to a few hundred boxes for an object-centric scene."""
    B = block_map.shape[0]
    size = (hi - lo) / B
    raw = []  # (ix0, ix1, iy0, iy1, iz0, iz1) exclusive-hi in block units
    occ = block_map.astype(bool)
    for ix in range(B):
        for iy in range(B):
            col = occ[ix, iy]
            iz = 0
            while iz < B:
                if col[iz]:
                    z0 = iz
                    while iz < B and col[iz]:
                        iz += 1
                    raw.append([ix, ix + 1, iy, iy + 1, z0, iz])
                else:
                    iz += 1
    # merge along y: same ix-range and z-range, contiguous iy
    raw.sort(key=lambda b: (b[0], b[4], b[5], b[2]))
    merged = []
    for b in raw:
        if (merged and merged[-1][0] == b[0] and merged[-1][1] == b[1]
                and merged[-1][4] == b[4] and merged[-1][5] == b[5]
                and merged[-1][3] == b[2]):
            merged[-1][3] = b[3]
        else:
            merged.append(list(b))
    # merge along x: same iy-range and z-range, contiguous ix
    merged.sort(key=lambda b: (b[2], b[3], b[4], b[5], b[0]))
    out = []
    for b in merged:
        if (out and out[-1][2] == b[2] and out[-1][3] == b[3]
                and out[-1][4] == b[4] and out[-1][5] == b[5]
                and out[-1][1] == b[0]):
            out[-1][1] = b[1]
        else:
            out.append(list(b))
    if not out:
        return np.zeros((0, 6), np.float32)
    idx = np.asarray(out, np.float32)                  # (K, 6)
    boxes = np.empty((len(out), 6), np.float32)
    boxes[:, 0:3] = lo + idx[:, 0::2] * size           # lo corners
    boxes[:, 3:6] = lo + idx[:, 1::2] * size           # hi corners
    return boxes


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """World-space AABB decomposition of a trained model's occupied set."""
    boxes: np.ndarray          # (K, 6) [lo_xyz, hi_xyz]
    block_map: np.ndarray      # (B, B, B) uint8 (kept for previews/tests)
    lo: np.ndarray             # (3,) world min corner of the grid
    hi: np.ndarray             # (3,) world max corner

    @property
    def n_boxes(self) -> int:
        return len(self.boxes)

    @property
    def occupied_fraction(self) -> float:
        return float(self.block_map.astype(np.float64).mean())


def rays_aabb(rays: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World AABB of a ray set's viewing volume: the hull of every ray's
    near and far endpoint (o + d*near, o + d*far). Works in whatever
    coordinates the rays live in (world or NDC)."""
    rays = np.asarray(rays)
    o, d = rays[:, 0:3], rays[:, 3:6]
    p_near = o + d * rays[:, 6:7]
    p_far = o + d * rays[:, 7:8]
    lo = np.minimum(p_near.min(0), p_far.min(0)).astype(np.float32)
    hi = np.maximum(p_near.max(0), p_far.max(0)).astype(np.float32)
    return lo, hi


def auto_ranges(params: Dict, mcfg: ModelConfig,
                aabb: Tuple[np.ndarray, np.ndarray],
                sigma_threshold: float = 1.0,
                probe_N: int = 64,
                pad_frac: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """Tight grid ranges from the model itself: probe the σ field over the
    whole viewing volume at probe_N^3, then refit the box to the occupied
    cells (+2 probe cells and ``pad_frac`` padding), clamped to the
    viewing volume, where every ray sample lies."""
    lo, hi = (np.asarray(aabb[0], np.float32), np.asarray(aabb[1],
                                                          np.float32))
    occ = _sigma_block_map(params, mcfg, probe_N, 1, lo, hi,
                           float(sigma_threshold), 128 * 1024)
    occ = occ.cpu().numpy().astype(bool)
    if not occ.any():
        return lo, hi
    cell = (hi - lo) / probe_N
    idx = np.stack(np.nonzero(occ), axis=-1)            # (M, 3)
    lo_fit = lo + (idx.min(0) - 2) * cell
    hi_fit = lo + (idx.max(0) + 3) * cell
    pad = (hi_fit - lo_fit) * pad_frac
    return (np.maximum(lo_fit - pad, lo).astype(np.float32),
            np.minimum(hi_fit + pad, hi).astype(np.float32))


def resolve_ranges(occ_range, params: Dict, mcfg: ModelConfig,
                   aabb: Tuple[np.ndarray, np.ndarray],
                   sigma_threshold: float = 1.0):
    """An explicit symmetric (lo, hi) pair or a 6-value (lox loy loz hix
    hiy hiz) box passes through; None / 'auto' derives the box from the
    model and the viewing volume."""
    if occ_range is None or (isinstance(occ_range, str)
                             and occ_range == "auto"):
        return auto_ranges(params, mcfg, aabb,
                           sigma_threshold=sigma_threshold)
    occ_range = tuple(occ_range)
    if len(occ_range) == 6:
        return (np.asarray(occ_range[:3], np.float32),
                np.asarray(occ_range[3:], np.float32))
    if len(occ_range) != 2:
        raise ValueError(
            f"--occ_range takes 2 values (symmetric lo hi) or 6 "
            f"(lox loy loz hix hiy hiz); got {len(occ_range)}")
    return occ_range


def _boundary_occupied(block_map: np.ndarray) -> int:
    boundary = np.zeros_like(block_map, bool)
    boundary[[0, -1], :, :] = boundary[:, [0, -1], :] = True
    boundary[:, :, [0, -1]] = True
    return int(np.count_nonzero(block_map.astype(bool) & boundary))


def build_occupancy_grid(params: Dict, mcfg: ModelConfig = ModelConfig(),
                         N: int = 128, block: int = 8,
                         ranges: Tuple[float, float] = (-1.5, 1.5),
                         sigma_threshold: float = 1.0,
                         chunk: int = 128 * 1024,
                         max_boxes: int = 512,
                         auto_widen: int = 2,
                         max_ranges=None,
                         mode: str = "sigma",
                         vis_rays=None,
                         vis_steps: int = 256,
                         max_vis_rays: int = 200_000,
                         vis_offset: int = 0) -> OccupancyGrid:
    """The culling structure of one model's (normally nerf_fine's) σ field,
    computed on the params' device.

    Args as the JAX package's:
      ranges: symmetric world extent (lo, hi) on every axis, or a
        ((lo3), (hi3)) pair (auto_ranges returns the latter).
      sigma_threshold: occupancy cut on raw σ (weight mode: its quadrature
        weight equivalent).
      block: fine cells per block edge; boxes are block-resolution.
      auto_widen: occupied blocks on the grid's boundary widen the box
        1.3x about its centre and rebuild, up to this many times (space
        outside the grid counts as empty); a warning remains.
      max_ranges: optional (lo3, hi3) cap for the widening, normally the
        viewing volume (rays_aabb).
      mode: "sigma" thresholds raw density; "weight" keeps only cells some
        ray of `vis_rays` visibly reaches (weight_block_map_from_sigma).
      vis_rays: (R, 8) rays (numpy or a tensor) for mode="weight", strided
        down to at most max_vis_rays rows from phase vis_offset % stride
        (vary it across rebuilds so a thin structure missed by one phase
        is recovered by the next).
      max_boxes: past it, the block map coarsens by its smallest factor.
    """
    if mode not in ("sigma", "weight"):
        raise ValueError(f"mode={mode!r} must be 'sigma' or 'weight'")
    if mode == "weight" and vis_rays is None:
        raise ValueError("mode='weight' needs vis_rays (the ray set whose "
                         "visibility defines the occupied cells)")
    if np.ndim(ranges[0]) == 0:
        lo = np.full(3, ranges[0], np.float32)
        hi = np.full(3, ranges[1], np.float32)
    else:
        lo = np.asarray(ranges[0], np.float32)
        hi = np.asarray(ranges[1], np.float32)
    if N % block:
        raise ValueError(f"N={N} must be divisible by block={block}")

    if max_ranges is not None:
        cap_lo = np.asarray(max_ranges[0], np.float32)
        cap_hi = np.asarray(max_ranges[1], np.float32)
        lo, hi = np.maximum(lo, cap_lo), np.minimum(hi, cap_hi)

    if mode == "weight":
        vis = torch.as_tensor(vis_rays, dtype=torch.float32)
        stride = max(1, len(vis) // max_vis_rays)
        vis = vis[vis_offset % stride::stride].to(_params_device(params))

        def fn(lo, hi):
            sig = _sigma_grid(params, mcfg, N, lo, hi, chunk)
            return weight_block_map_from_sigma(
                sig, N, block, lo, hi, vis, float(sigma_threshold),
                vis_steps, 8192)
    else:
        def fn(lo, hi):
            return _sigma_block_map(params, mcfg, N, block, lo, hi,
                                    float(sigma_threshold), chunk)
    for attempt in range(auto_widen + 1):
        block_map = fn(lo, hi).cpu().numpy()
        n_edge = _boundary_occupied(block_map)
        at_cap = max_ranges is not None and \
            np.allclose(lo, cap_lo, atol=1e-5) and \
            np.allclose(hi, cap_hi, atol=1e-5)
        if not n_edge or attempt == auto_widen or at_cap:
            break
        center = 0.5 * (lo + hi)
        lo = center + (lo - center) * 1.3
        hi = center + (hi - center) * 1.3
        if max_ranges is not None:
            lo, hi = np.maximum(lo, cap_lo), np.minimum(hi, cap_hi)
    if n_edge and not at_cap:
        warnings.warn(
            f"occupancy grid: {n_edge} occupied blocks touch the grid "
            f"boundary after {auto_widen} auto-widen attempts — the scene "
            f"reaches the edge of [{lo}, {hi}]; rays through out-of-grid "
            "geometry will be culled. Widen `ranges` (--occ_range).",
            stacklevel=2)

    boxes = _blocks_to_boxes(block_map, lo, hi)
    while len(boxes) > max_boxes and block_map.shape[0] > 1:
        # coarsen by the smallest factor of the edge count, so the reshape
        # stays exact for any N that pick_block accepts
        B_old = block_map.shape[0]
        s = next(f for f in range(2, B_old + 1) if B_old % f == 0)
        B = B_old // s
        block_map = block_map.reshape(
            B, s, B, s, B, s).any(axis=(1, 3, 5)).astype(np.uint8)
        boxes = _blocks_to_boxes(block_map, lo, hi)
    return OccupancyGrid(boxes=boxes, block_map=block_map, lo=lo, hi=hi)


# ------------------------------------------------------------------ caching

# The port's cache files are <ckpt>.torch_occ.<hash>.npz. The JAX package
# writes <ckpt>.occ.<hash>.npz (and once wrote a keyless <ckpt>.occ.npz),
# and its prune sweep deletes every file of its own pattern whose key is
# stale: neither package's glob matches the other's files, so each leaves
# the other's caches alone.
CACHE_SUFFIX = ".torch_occ"


def grid_cache_path(ckpt_path: str, key: str) -> str:
    """Cache file of one grid build: per key (a hash suffix), so that
    alternating settings (occ_N sweeps) keep their grids. Follows
    nerf_pl_tpu/rendering/occupancy.py:494 (grid_cache_path), without its
    keyless legacy path."""
    h = hashlib.sha1(key.encode()).hexdigest()[:10]
    return f"{ckpt_path}{CACHE_SUFFIX}.{h}.npz"


def _grid_cache_key(ckpt_path: str, N: int, occ_range, threshold: float,
                    mode: str = "sigma", vis_rays=None, aabb=None) -> str:
    """The JAX package's key (occupancy.py:506), line for line: checkpoint
    mtime_ns:size, N, the range spec (with the viewing-volume AABB when
    the ranges are automatic), the threshold, and in weight mode the
    visibility rays' count and moments."""
    st = os.stat(ckpt_path)
    rng_s = "auto" if (occ_range is None or occ_range == "auto") \
        else ",".join(f"{float(v):.6g}" for v in occ_range)
    if rng_s == "auto" and aabb is not None:
        # auto ranges are capped by the caller's viewing-volume AABB: a
        # grid auto-built for one pose set must not be reused for another
        rng_s += "@" + ",".join(
            f"{float(v):.5g}" for part in aabb for v in np.ravel(part))
    key = f"{st.st_mtime_ns}:{st.st_size}:{N}:{rng_s}:{threshold:.6g}"
    if mode != "sigma":
        # fingerprint the visibility ray set (shape and moments) so that
        # another pose set rebuilds instead of reusing a stale grid
        v = np.asarray(vis_rays, np.float32)
        key += (f":{mode}:{v.shape[0]}:{float(v[:, :6].mean()):.5g}"
                f":{float(v[:, :6].std()):.5g}")
    return key


def load_or_build_grid(ckpt_path: str, params: Dict,
                       mcfg: ModelConfig = ModelConfig(),
                       N: int = 128,
                       occ_range=None,
                       sigma_threshold: float = 1.0,
                       aabb: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                       verbose: bool = True,
                       mode: str = "sigma",
                       vis_rays=None) -> OccupancyGrid:
    """Grid build with a cache file next to the checkpoint
    (nerf_pl_tpu/rendering/occupancy.py:528). The build runs on the
    params' device; `vis_rays` (weight mode) may be numpy or a tensor.

    The key embeds the checkpoint's mtime and size, so a retrained
    checkpoint rebuilds; a build then deletes the port's caches of this
    checkpoint whose key is stale, and keeps its live siblings."""
    if isinstance(vis_rays, torch.Tensor):
        vis_rays = vis_rays.cpu().numpy()
    key = _grid_cache_key(ckpt_path, N, occ_range, sigma_threshold,
                          mode=mode, vis_rays=vis_rays, aabb=aabb)
    path = grid_cache_path(ckpt_path, key)
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    if verbose:
                        print(f"[occ] loaded cached grid from {path}")
                    return OccupancyGrid(boxes=z["boxes"],
                                         block_map=z["block_map"],
                                         lo=z["lo"], hi=z["hi"])
        except (KeyError, ValueError, OSError):
            pass
    auto = occ_range is None or occ_range == "auto"
    if auto and aabb is None:
        raise ValueError("auto occupancy ranges need the dataset rays' "
                         "AABB (pass aabb=rays_aabb(...)) or an explicit "
                         "--occ_range")
    ranges = resolve_ranges(occ_range, params, mcfg, aabb=aabb,
                            sigma_threshold=sigma_threshold)
    occ = build_occupancy_grid(params, mcfg, N=N, block=pick_block(N),
                               ranges=ranges,
                               sigma_threshold=sigma_threshold,
                               max_ranges=aabb if auto else None,
                               mode=mode, vis_rays=vis_rays)
    np.savez(path, key=key, boxes=occ.boxes, block_map=occ.block_map,
             lo=occ.lo, hi=occ.hi)
    # prune this checkpoint's stale caches: every key embeds the
    # checkpoint's mtime_ns:size, so the files of an earlier train can
    # never match again. glob.escape: a checkpoint path with glob
    # metacharacters ('sweep[lr].ckpt') must match only itself.
    st = os.stat(ckpt_path)
    live_prefix = f"{st.st_mtime_ns}:{st.st_size}:"
    for p in glob.glob(glob.escape(ckpt_path) + CACHE_SUFFIX + ".*.npz"):
        if os.path.abspath(p) == os.path.abspath(path):
            continue
        try:
            with np.load(p, allow_pickle=False) as z:
                stale = not str(z["key"]).startswith(live_prefix)
        except (KeyError, ValueError, OSError):
            stale = True
        if stale:
            try:
                os.remove(p)
            except OSError:
                pass
    if verbose:
        print(f"[occ] built grid ({occ.n_boxes} boxes, "
              f"{occ.occupied_fraction * 100:.1f}% occupied), cached to "
              f"{path}")
    return occ


# ------------------------------------------------------------------ ray-box

def _inv_dirs(d: torch.Tensor) -> torch.Tensor:
    eps = 1e-12
    return torch.reciprocal(torch.where(
        d.abs() < eps, torch.where(d < 0, -eps, eps), d))


def _box_slab(box, o, inv, near, far):
    """One box's slab test against all rays: (valid, tmin, tmax), each
    (R,)."""
    t1 = (box[0:3] - o) * inv
    t2 = (box[3:6] - o) * inv
    tmin = torch.maximum(torch.minimum(t1, t2).amax(dim=-1), near)
    tmax = torch.minimum(torch.maximum(t1, t2).amin(dim=-1), far)
    return tmax >= tmin, tmin, tmax


def ray_box_hits(boxes: torch.Tensor, rays: torch.Tensor,
                 chunk: int = RAY_CHUNK):
    """Slab-test every ray against every AABB.

    Args: boxes (K, 6) and rays (R, 8) on one device.

    Returns (hit (R,) bool, t_lo (R,), t_hi (R,)): whether any box overlaps
    the ray's [near, far], and the union interval of all overlaps (clamped
    to [near, far]; t_lo > t_hi when no hit)."""
    R = rays.shape[0]
    hit = torch.zeros(R, dtype=torch.bool, device=rays.device)
    t_lo = torch.full((R,), torch.inf, device=rays.device)
    t_hi = torch.full((R,), -torch.inf, device=rays.device)
    for start in range(0, R, chunk):
        r = rays[start:start + chunk]
        o, inv = r[:, 0:3], _inv_dirs(r[:, 3:6])
        near, far = r[:, 6], r[:, 7]
        h, lo, hi = (hit[start:start + chunk], t_lo[start:start + chunk],
                     t_hi[start:start + chunk])
        for box in boxes:
            valid, tmin, tmax = _box_slab(box, o, inv, near, far)
            h = h | valid
            lo = torch.where(valid, torch.minimum(lo, tmin), lo)
            hi = torch.where(valid, torch.maximum(hi, tmax), hi)
        hit[start:start + chunk] = h
        t_lo[start:start + chunk] = lo
        t_hi[start:start + chunk] = hi
    return hit, t_lo, t_hi


def ray_box_segment_bits(boxes: torch.Tensor, rays: torch.Tensor,
                         n_seg: int, chunk: int = RAY_CHUNK) -> torch.Tensor:
    """Per-ray occupancy bitmask over ``n_seg`` equal z segments of each
    ray's current [near, far] (normally already tightened): bit s is set
    iff some box's overlap interval intersects segment s. Rays that miss
    every box get all n_seg bits (uniform placement).

    Returns (R,) int64 holding the bits (n_seg <= 32)."""
    if not 1 <= n_seg <= 32:
        raise ValueError(f"n_seg={n_seg} must fit 32 bits")
    dev = rays.device
    seg = torch.arange(n_seg, dtype=rays.dtype, device=dev)
    shifts = torch.arange(n_seg, device=dev)
    n_seg_t = torch.tensor(float(n_seg), device=dev)
    out = torch.empty(rays.shape[0], dtype=torch.int64, device=dev)
    for start in range(0, rays.shape[0], chunk):
        r = rays[start:start + chunk]
        o, inv = r[:, 0:3], _inv_dirs(r[:, 3:6])
        near, far = r[:, 6], r[:, 7]
        # a tensor divisor: a GPU divides by a host scalar as a product
        # with its reciprocal, which can round otherwise
        h = (far - near) / n_seg_t
        seg_start = near[:, None] + seg * h[:, None]         # (C, n_seg)
        seg_end = seg_start + h[:, None]
        bits = torch.zeros((r.shape[0], n_seg), dtype=torch.bool,
                           device=dev)
        for box in boxes:
            valid, tmin, tmax = _box_slab(box, o, inv, near, far)
            bits |= ((tmin[:, None] < seg_end) & (tmax[:, None] > seg_start)
                     & valid[:, None])
        bits |= ~bits.any(dim=-1, keepdim=True)
        out[start:start + chunk] = (bits.to(torch.int64) << shifts).sum(-1)
    return out


def unpack_segment_bits(mask: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(R,) int64 bits -> (R, n_seg) float32 in {0, 1}."""
    shifts = torch.arange(n_seg, device=mask.device)
    return ((mask[:, None] >> shifts) & 1).to(torch.float32)


def dilate_segment_bits(mask: torch.Tensor, n_seg: int,
                        k: int = 1) -> torch.Tensor:
    """Widen each occupied run by ``k`` segments on both sides."""
    valid = (1 << n_seg) - 1
    for _ in range(k):
        mask = mask | ((mask << 1) & valid) | (mask >> 1)
    return mask


def tighten_intervals(near0: torch.Tensor, far0: torch.Tensor,
                      hit: torch.Tensor, t_lo: torch.Tensor,
                      t_hi: torch.Tensor, margin: float):
    """Each hit ray's [near, far] clipped to the union of its box overlaps
    widened by `margin` (a missing ray keeps its own), with far >= near +
    1e-4: (near, far), each (R,). The tighten step of the JAX package's
    cull pass and of its Trainer.tighten_store (occupancy.py:894-898)."""
    near = torch.where(hit, torch.maximum(near0, t_lo - margin), near0)
    far = torch.where(hit, torch.minimum(far0, t_hi + margin), far0)
    return near, torch.maximum(far, near + 1e-4)


# ------------------------------------------------------------------ culling

class Cull(NamedTuple):
    """The cull pass's outputs: the rays (tightened when asked) and their
    segment masks in sorted order, survivors first (budget buckets in
    order, then the misses), each padded by pad_rows copies of the last
    sorted row; `order`, the input row of each sorted row (R for a padded
    row); and the survivor count of each bucket (one count without
    budgets)."""
    rays: torch.Tensor        # (R + pad_rows, 8)
    occm: torch.Tensor        # (R + pad_rows,) int64 holding the bits
    order: torch.Tensor       # (R + pad_rows,) int64
    counts: torch.Tensor      # (n_buckets,) int64


def cull_rays(boxes: torch.Tensor, rays: torch.Tensor, tighten: bool = False,
              margin: float = 0.05,
              fracs: Optional[Tuple[float, ...]] = None, n_seg: int = 0,
              dilate: int = 1, pad_rows: int = 0) -> Cull:
    """The cull pass of `CulledRenderer`
    (nerf_pl_tpu/rendering/occupancy.py:877, `_cull_fn`), on the rays'
    device.

    Hit test; with `tighten` each hit ray's interval clipped to its box
    overlaps (`tighten_intervals`); with n_seg > 0 the segment masks of
    the (tightened) rays, dilated by `dilate`. With budget `fracs` (they
    need `tighten`; ascending, ending at 1.0) a hit ray's bucket is the
    count of fracs[:-1] below the ratio of its tightened span to its
    original one (times its occupied share of segments with n_seg > 0),
    and a miss's is len(fracs); without, survivors take key 0 and misses
    1. A stable sort on the key orders the rays: the JAX package's
    stable_counting_argsort is a TPU stand-in for the same permutation.
    """
    hit, t_lo, t_hi = ray_box_hits(boxes, rays)
    near0, far0 = rays[:, 6], rays[:, 7]
    near, far = near0, far0
    if tighten:
        near, far = tighten_intervals(near0, far0, hit, t_lo, t_hi, margin)
        rays = torch.cat([rays[:, :6], near[:, None], far[:, None]], dim=1)
    R, dev = rays.shape[0], rays.device
    if n_seg > 0:
        occm = dilate_segment_bits(ray_box_segment_bits(boxes, rays, n_seg),
                                   n_seg, dilate)
    else:
        occm = torch.zeros(R, dtype=torch.int64, device=dev)
    if fracs is not None:
        # the smallest bucket b with occupied length / full span <=
        # fracs[b]: the sample density per unit length never drops below
        # the dense render's. Tensor divisors throughout: a GPU divides by
        # a host scalar as a product with its reciprocal.
        ratio = (far - near) / torch.clamp(far0 - near0, min=1e-12)
        if n_seg > 0:
            popcount = unpack_segment_bits(occm, n_seg).sum(dim=-1)
            ratio = ratio * (popcount / torch.tensor(float(n_seg),
                                                     device=dev))
        key = torch.zeros(R, dtype=torch.int64, device=dev)
        for f in fracs[:-1]:
            key = key + (ratio > f).to(torch.int64)
        key = torch.where(hit, key, len(fracs))
        counts = torch.bincount(key, minlength=len(fracs) + 1)[:len(fracs)]
    else:
        key = (~hit).to(torch.int64)
        counts = hit.sum()[None]
    order = torch.argsort(key, stable=True)
    rays_sorted, occm_sorted = rays[order], occm[order]
    if pad_rows:
        rays_sorted = torch.cat(
            [rays_sorted, rays_sorted[-1:].expand(pad_rows, 8)])
        occm_sorted = torch.cat(
            [occm_sorted, occm_sorted[-1:].expand(pad_rows)])
        order = torch.cat([order, order.new_full((pad_rows,), R)])
    return Cull(rays_sorted, occm_sorted, order, counts)


class CulledRenderer:
    """Full-image renderer with occupancy culling
    (nerf_pl_tpu/rendering/occupancy.py:779, one device).

      1. The cull pass (`cull_rays`) sorts the survivors first; the host
         reads back the bucket counts, its one sync before the render.
      2. Fixed-size tiles of `render_rays` over the sorted rays, scattered
         into a background image: culled rays keep the analytic background
         (rgb 1 or 0, depth 0, opacity 0).

    Without budgets the tiles cover the first n_tiles * chunk sorted rows,
    so the misses that fall into the last tile are rendered too (the JAX
    package's near-parity quirk, kept: `n_rendered` and the outputs equal
    its own). With `budgets` each bucket renders with its own sample
    counts (`_rcfg_for_frac`) in its own cost-capped tiles
    (`_chunk_for_bucket`); rows of a tile past the bucket's count go to
    a dump row R, sliced off at the end.

    tighten: clip each surviving ray to its occupied interval ± margin.
    budgets (needs tighten): fewer samples for short-span rays.
    segments (needs tighten): occupied-segment placement of the coarse
      samples (render.py `occupied_z_vals`); with budgets the bucket key
      becomes the occupied length.
    device: where the boxes live and the tiles render (cuda:0 unless
      given; the rays and params are moved there).
    group: a torch.distributed process group, the JAX package's `mesh=`:
      every rank culls the same rays, each renders its contiguous share
      of each run's tiles, and the tile outputs are gathered on every
      rank before the scatter. The world plays the part of the mesh's
      `data` size in the tile sizing (`_chunk_for`, `_round_tiles` and
      the worst-case padding), so `n_rendered` and `bucket_counts` are
      the JAX renderer's with a mesh of that size. Every rank must call
      it with the same rays, and each gets the whole image.

    A call's phases (utils/profiling.py: a span each, with its mark on
    CUDA, while a profiler records) are `cull` (the cull pass up to its
    counts on the host, the call's one readback), `frame.pack`, one
    `bucket` per run of tiles (each tile's render_rays phases inside it,
    then `frame.gather`, the tiles' outputs scattered into the image),
    then the mark `end`.
    """

    _BUCKET_FRACS = (0.25, 0.5, 1.0)   # sample fraction per span bucket

    # Default base ray tile, tuned on the TPU by the JAX package (its
    # round-5 base-tile descent); the base tile decides which misses spill
    # into a rendered tile, so it stays as it is for parity.
    DEFAULT_CHUNK = 8192

    # Per-tile point-work cap, in units of chunk rays x samples: a bucket
    # whose rays cost more than 32 samples renders in proportionally
    # smaller tiles (the JAX package's measured rule: cap, not normalize).
    _TILE_COST_REF = 32

    def __init__(self, occ: OccupancyGrid, rcfg: RenderConfig,
                 mcfg: ModelConfig = ModelConfig(),
                 chunk: int = DEFAULT_CHUNK, tighten: bool = False,
                 tighten_margin: float = 0.05, budgets: bool = False,
                 segments: int = 0, segment_dilate: int = 1,
                 bucket_fracs: Optional[Tuple[float, ...]] = None,
                 device: Optional[torch.device | str] = None, group=None):
        if occ.n_boxes == 0:
            raise ValueError("occupancy grid is empty — threshold too high?")
        if budgets and not tighten:
            raise ValueError("budgets=True requires tighten=True (budgets "
                             "are derived from the tightened spans)")
        if segments and not tighten:
            raise ValueError("segments>0 requires tighten=True (masks are "
                             "computed over the tightened interval)")
        if not 0 <= segments <= 32:
            raise ValueError(f"segments={segments} must be in [0, 32]")
        if chunk < 8:
            raise ValueError(f"chunk={chunk} must be >= 8 (ray tiles are "
                             "8-row-aligned; 0 does not mean 'default')")
        if bucket_fracs is not None:
            if not budgets:
                raise ValueError("bucket_fracs is only meaningful with "
                                 "budgets=True (it parameterizes the "
                                 "budgeted span buckets)")
            # input order is irrelevant (sorted ascending); a duplicate
            # would make a bucket that is always empty
            fracs = tuple(sorted({float(f) for f in bucket_fracs}))
            if not fracs or fracs[-1] != 1.0 or fracs[0] <= 0:
                raise ValueError(
                    f"bucket_fracs={bucket_fracs} must be positive and end "
                    "at 1.0 (the full-span bucket)")
            self._BUCKET_FRACS = fracs
        self.device = resolve_device(device)
        self.boxes = torch.as_tensor(np.asarray(occ.boxes, np.float32),
                                     device=self.device)
        self.rcfg = rcfg
        self.mcfg = mcfg
        self.chunk = chunk
        self.tighten = tighten
        self.margin = tighten_margin
        self.budgets = budgets
        self.segments = segments
        self.segment_dilate = segment_dilate
        self.group = group
        self.n_data = pdist.world_of(group)

    def _cull(self, rays: torch.Tensor, pad_rows: int) -> Cull:
        return cull_rays(self.boxes, rays, tighten=self.tighten,
                         margin=self.margin,
                         fracs=self._BUCKET_FRACS if self.budgets else None,
                         n_seg=self.segments, dilate=self.segment_dilate,
                         pad_rows=pad_rows)

    def _chunk_for(self, R: int) -> int:
        """Effective tile: never larger than a rank's share of the image
        needs, a multiple of 8."""
        per = -(-R // self.n_data)
        return min(self.chunk, -(-per // 8) * 8)

    def _bucket_cost(self, frac: float) -> int:
        """Per-ray point evaluations of a span bucket."""
        r = self._rcfg_for_frac(frac)
        return r.N_samples + max(r.N_importance, 0)

    def _chunk_for_bucket(self, chunk: int, frac: float) -> int:
        """Cost-capped ray tile of a span bucket: a multiple of 8, at
        least 2048, never above the base chunk."""
        c = chunk * self._TILE_COST_REF // max(self._bucket_cost(frac), 1)
        return min(chunk, max(-(-c // 8) * 8, 2048))

    def _rcfg_for_frac(self, frac: float) -> RenderConfig:
        """Scaled sample counts of a span bucket, floored at 8: a ray is
        in bucket `frac` only when its occupied length is at most frac of
        its span, so its sample density per occupied unit stays at least
        the dense render's."""
        if frac >= 1.0:
            return self.rcfg
        N_s = max(int(self.rcfg.N_samples * frac), 8)
        N_i = self.rcfg.N_importance
        if N_i > 0:
            N_i = max(int(N_i * frac), 8)
        return dataclasses.replace(self.rcfg, N_samples=N_s,
                                   N_importance=N_i)

    def _round_tiles(self, n: int, cap_tiles: int, chunk: int) -> int:
        """Tiles for n rows, at least 1, at most cap_tiles, both rounded
        up to a whole number of tiles a rank."""
        gran = self.n_data
        n_tiles = max(1, -(-n // chunk))
        return min(-(-n_tiles // gran) * gran, -(-cap_tiles // gran) * gran)

    def _background(self, rows: int) -> Dict[str, torch.Tensor]:
        """All-background outputs of the last pass, `rows` rows."""
        typ = "fine" if self.rcfg.N_importance > 0 else "coarse"
        bg_rgb = 1.0 if self.rcfg.white_back else 0.0
        dev = self.device
        return {
            f"rgb_{typ}": torch.full((rows, 3), bg_rgb, device=dev),
            f"depth_{typ}": torch.zeros((rows,), device=dev),
            f"opacity_{typ}": torch.zeros((rows,), device=dev),
        }

    def _tile_plan(self, R: int, counts):
        """The tiles of one call on R rays with these survivor counts:
        (bucket frac, first sorted row, tiles, rows a tile, valid rows) of
        each run of tiles. Without budgets one run covers the survivors
        at frac 1.0; every row of its tiles is scattered, so a miss that
        falls in the last tile is rendered too, and padded rows (order R)
        go to the dump row. With budgets each non-empty bucket has its own
        run, and its rows past the bucket's count go to the dump row."""
        chunk = self._chunk_for(R)
        if not self.budgets:
            n_tiles = self._round_tiles(max(sum(counts), 1), -(-R // chunk),
                                        chunk)
            return [(1.0, 0, n_tiles, chunk, n_tiles * chunk)]
        plan, start = [], 0
        for n_b, frac in zip(counts, self._BUCKET_FRACS):
            if n_b:
                chunk_b = self._chunk_for_bucket(chunk, frac)
                plan.append((frac, start,
                             self._round_tiles(n_b, -(-R // chunk_b),
                                               chunk_b), chunk_b, n_b))
            start += n_b
        return plan

    def _render_tiles(self, model, cull: Cull, start: int, n_tiles: int,
                      chunk: int, rcfg: RenderConfig, n_valid: int,
                      img: Dict[str, torch.Tensor], written: torch.Tensor):
        """Render n_tiles tiles of `chunk` sorted rows from `start`, this
        rank its contiguous share of them, gather the tiles' outputs and
        scatter them into img, whose last row R is the dump row: a tile
        row at or past n_valid, or a padded row (order R), goes there.
        `written` counts the writes into each row."""
        R = written.shape[0] - 1
        n_seg = self.segments
        per = n_tiles // self.n_data
        rank = pdist.rank_of(self.group)
        outs = []
        for t in range(rank * per, (rank + 1) * per):
            lo = start + t * chunk
            tile = cull.rays[lo:lo + chunk]
            if tile.shape[0] != chunk:
                raise AssertionError(f"tile at row {lo} has {tile.shape[0]} "
                                     f"rows, not {chunk}: pad_rows too small")
            outs.append(render_rays(
                model, tile, rcfg, self.mcfg,
                occm=cull.occm[lo:lo + chunk] if n_seg else None,
                n_seg=n_seg))
        with P.phase("frame.gather", self.device):
            out = pdist.gather_rows({k: torch.cat([o[k] for o in outs])
                                     for k in img if k in outs[0]},
                                    self.group)
            rows = torch.arange(chunk, device=self.device)
            for t in range(n_tiles):
                lo = start + t * chunk
                idx = torch.where(rows < n_valid - t * chunk,
                                  cull.order[lo:lo + chunk], R)
                written.index_add_(0, idx, torch.ones_like(idx))
                for k, v in out.items():
                    img[k][idx] = v[t * chunk:(t + 1) * chunk]

    @torch.no_grad()
    def __call__(self, params: Mapping[str, Any], rays,
                 return_stats: bool = False):
        """Render (R, 8) rays (numpy or a tensor) -> dict of (R, ...)
        tensors on the renderer's device (and the stats with
        return_stats). `params` holds the MLPs as `make_render_fn` takes
        them; with rcfg.fused they are packed once per call."""
        dev = self.device
        with P.phase("cull", dev):
            rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
            R = rays.shape[0]
            chunk = self._chunk_for(R)
            cap_tiles = -(-R // chunk)                  # all rays survive
            # worst case: every ray survives, and its tiles round up to
            # whole tiles a rank (with budgets a bucket's tiles round past
            # the image)
            gran = max(2, self.n_data) if self.budgets else self.n_data
            pad_rows = (-(-cap_tiles // gran) * gran) * chunk
            cull = self._cull(rays, pad_rows)
            counts = cull.counts.tolist()               # the one readback
        with P.phase("frame.pack", dev):
            model = prepare_params(params, self.rcfg, dev)
            written = torch.zeros(R + 1, dtype=torch.int64, device=dev)
            img = self._background(R + 1)       # row R: the dump row
            plan = self._tile_plan(R, counts)
        for frac, start, n_tiles, chunk_b, n_valid in plan:
            with P.phase("bucket", dev):
                self._render_tiles(model, cull, start, n_tiles, chunk_b,
                                   self._rcfg_for_frac(frac), n_valid, img,
                                   written)
        if int(written[:R].max()) > 1:
            raise AssertionError("a ray was written by two tiles")
        img = {k: v[:R] for k, v in img.items()}
        P.mark("end", dev)
        if not return_stats:
            return img
        stats = {"n_rays": R, "n_survivors": sum(counts),
                 "n_rendered": sum(p[2] * p[3] for p in plan),
                 "n_boxes": self.boxes.shape[0]}
        if self.budgets:
            stats["bucket_counts"] = counts
        return img, stats
