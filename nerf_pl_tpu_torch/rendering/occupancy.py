"""Occupancy: the σ-grid build and the ray-box tests that tighten the
training store.

Port of the training side of nerf_pl_tpu/rendering/occupancy.py, plain
PyTorch (the JAX module is plain XLA and holds no kernel):
  * the grid build: the σ field of the plain f32 σ-only MLP at the cell
    centres of an N^3 grid, thresholded (or, in weight mode, marched by
    the training rays and kept where some ray deposits quadrature weight),
    dilated by one cell, reduced to a block map and merged into
    world-space boxes (`build_occupancy_grid`);
  * the ray-box slab tests: `ray_box_hits` (hit flag and the union
    interval of a ray's box overlaps) and `ray_box_segment_bits` (a
    per-ray mask of the equal z segments some box overlaps), and the mask
    helpers.
Everything runs on the device of its inputs. `_blocks_to_boxes`,
`rays_aabb` and `_boundary_occupied` are numpy and are copies of the JAX
package's, line for line. The eval side (`CulledRenderer`, the grid
caches) is ROADMAP item A8.

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
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.embedding import embed
from ..models.nerf import nerf_apply
from .render import ModelConfig

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
