"""The port's occupancy functions against the JAX package's, on the CPU.

The ray-box slab tests, the segment masks and their dilation, and the
block-map-to-box merge are held bit for bit (the masks as np.uint32). The
σ grid of the plain f32 σ-only MLP is held within 1e-4 x max |σ| of
JAX's; its block maps must be equal except where a cell's σ lies within
that tolerance of the threshold (such cells are counted and printed), and
the boxes equal whenever the block maps are. `occupied_z_vals` agrees
within 1e-6 with JAX's uniforms passed in as the "perturb" draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import occupancy as jocc
from nerf_pl_tpu.rendering.render import occupied_z_vals as jplace
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.rendering import ModelConfig
from nerf_pl_tpu_torch.rendering import occupancy as tocc
from nerf_pl_tpu_torch.rendering.render import occupied_z_vals

GRID_TOL = 1e-4      # x max |sigma|


def _rays(R, seed, zero_frac=0.1):
    """Rays from a sphere of radius 4 towards points of [-1.5, 1.5]^3, with
    direction norms in [0.5, 1.5] and a share of the direction components
    set to +-0."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3))
    o *= 4.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (R, 3)) - o
    d *= rng.uniform(0.5, 1.5, (R, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    d[rng.random((R, 3)) < zero_frac] = 0.0
    d[rng.random((R, 3)) < zero_frac / 2] = -0.0
    near = rng.uniform(0.5, 2.5, (R, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 6.0, (R, 1)).astype(np.float32)
    return np.concatenate([o, d, near, far], 1)


def _boxes(K, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.5, 1.0, (K, 3)).astype(np.float32)
    return np.concatenate(
        [lo, lo + rng.uniform(0.05, 0.8, (K, 3)).astype(np.float32)], 1)


@pytest.mark.parametrize("K", [1, 7, 70])
def test_ray_box_hits_match_jax(K):
    """70 boxes run past JAX's 64-box bucket of tighten_store; the chunk
    of 1000 rays splits the port's loop."""
    rays, boxes = _rays(3000, seed=K), _boxes(K, seed=K)
    ref = jocc.ray_box_hits(jnp.asarray(boxes), jnp.asarray(rays))
    ours = tocc.ray_box_hits(torch.from_numpy(boxes), torch.from_numpy(rays),
                             chunk=1000)
    assert 0.0 < np.asarray(ref[0]).mean() < 1.0
    for name, a, b in zip(("hit", "t_lo", "t_hi"), ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("n_seg", [1, 16, 31, 32])
def test_segment_bits_match_jax(n_seg):
    rays, boxes = _rays(3000, seed=40 + n_seg), _boxes(9, seed=n_seg)
    ref = np.asarray(jocc.ray_box_segment_bits(
        jnp.asarray(boxes), jnp.asarray(rays), n_seg))
    ours = tocc.ray_box_segment_bits(torch.from_numpy(boxes),
                                     torch.from_numpy(rays), n_seg,
                                     chunk=1000).numpy()
    assert ours.dtype == np.int64 and ours.min() >= 0
    np.testing.assert_array_equal(ours.astype(np.uint32), ref)
    hit = np.asarray(jocc.ray_box_hits(jnp.asarray(boxes),
                                       jnp.asarray(rays))[0])
    full = (1 << n_seg) - 1
    assert (ours[~hit] == full).all() and hit.any() and not hit.all()
    assert n_seg == 1 or (ours[hit] != full).any()   # masks with gaps
    if n_seg == 32:
        assert ((ours[hit] >> 31) & 1).any()


@pytest.mark.parametrize("n_seg", [16, 32])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_dilate_segment_bits_match_jax(n_seg, k):
    rng = np.random.default_rng(k + n_seg)
    mask = rng.integers(0, 1 << n_seg, 500, dtype=np.uint64)
    mask[:8] = [0, 1, 1 << (n_seg - 1), (1 << n_seg) - 1, 0x5, 0x90, 3, 6]
    ref = np.asarray(jocc.dilate_segment_bits(
        jnp.asarray(mask.astype(np.uint32)), n_seg, k))
    ours = tocc.dilate_segment_bits(torch.from_numpy(mask.astype(np.int64)),
                                    n_seg, k).numpy()
    np.testing.assert_array_equal(ours.astype(np.uint32), ref)
    assert ours.max() < 1 << n_seg
    bits = tocc.unpack_segment_bits(torch.from_numpy(ours), n_seg).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jocc.unpack_segment_bits(jnp.asarray(ref), n_seg)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blocks_to_boxes_match_jax(seed):
    rng = np.random.default_rng(seed)
    B = (4, 8, 6)[seed]
    bmap = (rng.random((B, B, B)) < (0.1, 0.4, 0.8)[seed]).astype(np.uint8)
    lo = np.asarray([-1.5, -1.0, -2.0], np.float32)
    hi = np.asarray([1.5, 2.0, 1.0], np.float32)
    np.testing.assert_array_equal(tocc._blocks_to_boxes(bmap, lo, hi),
                                  jocc._blocks_to_boxes(bmap, lo, hi))


def _dense_np(key, scale=10.0, shift=1.0):
    p = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(key)))
    p["sigma"]["w"] = p["sigma"]["w"] * scale
    p["sigma"]["b"] = p["sigma"]["b"] + shift
    return p


@pytest.fixture(scope="module")
def grid_params():
    """A smooth σ field: the first layer and the skip read only the raw
    position (no sinusoids). σ spans 1.1-1.8 over [-1.5, 1.5]^3, and about
    half the 4^3-cell blocks of a 32^3 grid hold a cell past 1.6."""
    p = {k: {n: np.array(v) for n, v in leaves.items()}
         for k, leaves in _dense_np(3, scale=100.0).items()}
    p["xyz_0"]["w"][3:] = 0.0
    p["xyz_4"]["w"][3:63] = 0.0
    return p


def _tie_blocks(sigma, threshold, tol, N, block):
    """Blocks a cell whose σ lies within tol of the threshold can reach
    through the one-cell dilation: the only blocks where the two
    packages' maps may differ."""
    ties = torch.from_numpy(np.abs(sigma - threshold) <= tol)
    return tocc._dilate_to_blocks(ties, N, block).numpy().astype(bool), \
        int(ties.sum())


@pytest.mark.filterwarnings("ignore:occupancy grid")
@pytest.mark.parametrize("mode", ["sigma", "weight"])
@pytest.mark.parametrize("widen", [0, 2])
def test_build_occupancy_grid_matches_jax(grid_params, mode, widen):
    """N 32, block 4: the σ grid, the block map and the boxes. With
    widen 2 the box starts at +-1, so occupied blocks touch its boundary
    and both packages widen it (their final ranges must agree)."""
    N, block, thr = 32, 4, 1.6
    ranges = (-1.0, 1.0) if widen else (-1.5, 1.5)
    vis = _rays(2000, seed=9, zero_frac=0.0) if mode == "weight" else None
    kw = dict(N=N, block=block, ranges=ranges, sigma_threshold=thr,
              chunk=8192, auto_widen=widen, mode=mode, vis_rays=vis,
              vis_steps=64)
    ref = jocc.build_occupancy_grid(grid_params, JModelConfig(), **kw)
    ours = tocc.build_occupancy_grid(params_from_numpy(grid_params),
                                     ModelConfig(), **kw)
    np.testing.assert_array_equal(ours.lo, ref.lo)
    np.testing.assert_array_equal(ours.hi, ref.hi)
    if widen:
        assert (ours.hi > 1.2).all()

    sig_ref = np.asarray(jocc._sigma_grid(
        grid_params, JModelConfig(), N, jnp.asarray(ref.lo),
        jnp.asarray(ref.hi), 8192))
    sig = tocc._sigma_grid(params_from_numpy(grid_params), ModelConfig(), N,
                           ours.lo, ours.hi, 8192).numpy()
    tol = GRID_TOL * np.abs(sig_ref).max()
    assert np.abs(sig - sig_ref).max() <= tol
    tie_blocks, n_ties = _tie_blocks(sig_ref, thr, tol, N, block)
    differ = ours.block_map != ref.block_map
    print(f"{mode} widen {widen}: {n_ties} cells within {tol:.2e} of the "
          f"threshold, {int(differ.sum())} blocks differ, "
          f"{ref.n_boxes} boxes, {ref.occupied_fraction:.3f} occupied")
    assert not (differ & ~tie_blocks).any()
    assert 0.05 < ref.occupied_fraction < 0.95
    if not differ.any():
        np.testing.assert_array_equal(ours.boxes, ref.boxes)


def test_helpers_match_jax(grid_params):
    """pick_block, rays_aabb, resolve_ranges (explicit, 6 values and
    auto) and _boundary_occupied."""
    for N in (16, 32, 100, 128, 7):
        assert tocc.pick_block(N) == jocc.pick_block(N)
    rays = _rays(500, seed=3, zero_frac=0.0)
    for a, b in zip(tocc.rays_aabb(rays), jocc.rays_aabb(rays)):
        np.testing.assert_array_equal(a, b)
    aabb = jocc.rays_aabb(rays)
    for rng_ in ((-1.0, 1.0), (-1, -2, -3, 1, 2, 3)):
        for a, b in zip(tocc.resolve_ranges(rng_, None, None, aabb),
                        jocc.resolve_ranges(rng_, None, None, aabb)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="2 values"):
        tocc.resolve_ranges((1, 2, 3), None, None, aabb)
    auto = tocc.resolve_ranges(None, params_from_numpy(grid_params),
                               ModelConfig(), aabb)
    ref = jocc.resolve_ranges(None, grid_params, JModelConfig(), aabb)
    for a, b in zip(auto, ref):
        np.testing.assert_allclose(a, b, atol=1e-5)
    bmap = np.zeros((4, 4, 4), np.uint8)
    bmap[1:3, 1:3, 1:3] = 1
    bmap[0, 2, 2] = bmap[3, 3, 3] = 1
    assert tocc._boundary_occupied(bmap) == jocc._boundary_occupied(bmap) == 2


def _cdf_ties(occm, n_seg, keepalive, u, tol=1e-6):
    """Samples whose u lies within tol of a knot of the placement's cdf
    (float64): at such a u the inverse CDF may jump across an empty
    segment, and which side either package takes is a matter of rounding."""
    bits = ((occm[:, None] >> np.arange(n_seg)) & 1).astype(np.float64)
    if keepalive > 0:
        n_occ = np.maximum(bits.sum(-1, keepdims=True), 1.0)
        bits = (1.0 - keepalive) * bits / n_occ + keepalive / n_seg
    w = bits + 1e-5
    cdf = np.cumsum(w / w.sum(-1, keepdims=True), -1)
    return (np.abs(u[:, :, None] - cdf[:, None, :]) < tol).any(-1)


@pytest.mark.parametrize("perturb", [0.0, 1.0])
@pytest.mark.parametrize("keepalive", [0.0, 0.3])
def test_occupied_z_vals_match_jax(perturb, keepalive):
    """Within 1e-5 (the depths span 0.5-9, where an f32 ulp is up to 9.5e-7,
    and the two cdfs, cumulated in different orders, differ by a few ulps,
    which the inverse CDF scales by segment width / segment mass, up to
    ~16 with keepalive 0.3; measured <= 6.2e-6), except at counted ties of
    u with a cdf knot, where the inverse CDF jumps across an empty
    segment (perturb 0's stratum midpoints meet them; at most 2%)."""
    R, n_seg, S = 64, 32, 24
    rays = _rays(R, seed=11, zero_frac=0.0)
    rng = np.random.default_rng(12)
    occm = rng.integers(0, 1 << 32, R, dtype=np.uint64)
    occm[:4] = [1, 1 << 31, (1 << 32) - 1, 0x0F0000F0]
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jplace(jnp.asarray(rays),
                            jnp.asarray(occm.astype(np.uint32)), n_seg, S,
                            perturb, key, keepalive=keepalive))
    uniform = np.array(jax.random.uniform(key, (R, S)))
    ours = occupied_z_vals(torch.from_numpy(rays),
                           torch.from_numpy(occm.astype(np.int64)), n_seg, S,
                           perturb, torch.from_numpy(uniform) if perturb
                           else None, keepalive).numpy()
    xi = perturb * uniform + (1.0 - perturb) * 0.5
    ties = _cdf_ties(occm.astype(np.int64), n_seg, keepalive,
                     (np.arange(S) + xi.astype(np.float64)) / S)
    err = np.abs(ours - ref)
    print(f"perturb {perturb} keepalive {keepalive}: {int(ties.sum())} "
          f"ties of {ties.size}; max error {err[~ties].max():.3e} off them, "
          f"{err.max():.3e} on all")
    assert ties.mean() <= 0.02
    assert err[~ties].max() <= 1e-5
    assert (np.diff(ours, axis=-1) >= 0).all()
    lo, hi = rays[:, 6:7], rays[:, 7:8]
    assert ((ours >= lo - 1e-5) & (ours <= hi + 1e-5)).all()
