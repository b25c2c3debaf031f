"""The port's occupancy-culled renderer against the JAX package's, on the
CPU.

The cull pass (sorted rays, segment masks, order, bucket counts) is held
bit for bit; the stats (`n_survivors`, `n_rendered`, `bucket_counts`)
exactly; the outputs within 2e-2 on every row (the bar of
tests/test_torch_render.py), spilled misses included; rows that no tile
renders exactly background. The unfused renders take the small model of
tests/test_occupancy.py; the fused ones the full model, JAX's Pallas
kernels in interpret mode against the port's plain bf16 versions.
tests/test_torch_grid_cache.py holds the grid cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_occupancy import _boxes, _rays

from nerf_pl_tpu.models import EmbeddingConfig as JEmbeddingConfig
from nerf_pl_tpu.models import NeRFConfig as JNeRFConfig
from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.rendering import CulledRenderer as JCulledRenderer
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import occupancy as jocc
from nerf_pl_tpu_torch.models import EmbeddingConfig, NeRFConfig
from nerf_pl_tpu_torch.rendering import (CulledRenderer, ModelConfig,
                                         OccupancyGrid, RenderConfig)

OUT_TOL = 2e-2


def _mcfgs():
    """tests/test_occupancy.py's small model, in both packages."""
    j = JModelConfig(nerf=JNeRFConfig(D=2, W=32, in_channels_xyz=27,
                                      in_channels_dir=15, skips=(1,)),
                     emb_xyz=JEmbeddingConfig(3, 4),
                     emb_dir=JEmbeddingConfig(3, 2))
    t = ModelConfig(nerf=NeRFConfig(D=2, W=32, in_channels_xyz=27,
                                    in_channels_dir=15, skips=(1,)),
                    emb_xyz=EmbeddingConfig(3, 4),
                    emb_dir=EmbeddingConfig(3, 2))
    return j, t


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grid(boxes):
    return dict(boxes=np.asarray(boxes, np.float32),
                block_map=np.ones((2, 2, 2), np.uint8),
                lo=np.full(3, -2, np.float32), hi=np.full(3, 2.4, np.float32))


SLAB_BOXES = [[-0.2, -0.2, -0.2, 0.2, 0.2, 0.2], [-2, -2, 2.0, 2, 2, 2.4]]


def _slab_rays(R=800, misses=True):
    """tests/test_occupancy.py TestBudgetedRenderer's rays: +z rays through
    a small box and a far slab (short occupied spans), rays through the
    slab only, and (with misses) rays that miss both."""
    rng = np.random.default_rng(1)
    o = np.zeros((R, 3), np.float32)
    o[:, 2] = -5.0
    d = np.zeros((R, 3), np.float32)
    d[:, 2] = 1.0
    o[rng.random(R) < 0.3, 0] = 1.0
    miss = rng.random(R) < 0.2
    o[miss, 0] = 5.0
    rays = np.concatenate([o, d, np.full((R, 1), 0.1, np.float32),
                           np.full((R, 1), 10.0, np.float32)], 1)
    return rays if misses else rays[~miss]


CONFIGS = {
    "cull": {},
    "tighten": dict(tighten=True),
    "segments32": dict(tighten=True, segments=32),
    "budgets": dict(tighten=True, budgets=True),
    "budgets_seg8": dict(tighten=True, budgets=True, segments=8),
    "budgets_seg32": dict(tighten=True, budgets=True, segments=32),
    "fracs": dict(tighten=True, budgets=True,
                  bucket_fracs=(0.125, 0.25, 0.5, 1.0)),
}


def _pair(boxes, rcfg_kw, chunk, mcfgs=None, **cfg):
    jm, tm = mcfgs or (JModelConfig(), ModelConfig())
    grid = _grid(boxes)
    return (JCulledRenderer(jocc.OccupancyGrid(**grid),
                            JRenderConfig(**rcfg_kw), jm, chunk=chunk, **cfg),
            CulledRenderer(OccupancyGrid(**grid), RenderConfig(**rcfg_kw), tm,
                           chunk=chunk, device="cpu", **cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cull_pass_matches_jax_bitwise(name):
    """Random rays (some direction components +-0) against 40 random boxes,
    padded by 700 rows: every output of the cull pass bit for bit."""
    rays, boxes = _rays(3000, seed=5), _boxes(40, seed=5)
    jcr, tcr = _pair(boxes, dict(N_samples=16, test_time=True), 1024,
                     **CONFIGS[name])
    ref = jcr._cull_fn()(jcr.boxes, jnp.asarray(rays), pad_rows=700)
    ours = tcr._cull(torch.from_numpy(rays), 700)
    hit = np.asarray(jocc.ray_box_hits(jcr.boxes, jnp.asarray(rays))[0])
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(ours.rays.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours.occm.numpy().astype(np.uint32),
                                  np.asarray(ref[1]))
    np.testing.assert_array_equal(ours.order.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref[3]))
    if tcr.budgets:
        assert (ours.counts > 0).sum() >= 2      # rays in several buckets


def _rendered_rows(tcr, rays, stats):
    """Input rows some tile renders and scatters: the first n_rendered
    sorted rows, or with budgets each bucket's own rows."""
    cull = tcr._cull(torch.from_numpy(rays), 0)
    if not tcr.budgets:
        return cull.order[:min(stats["n_rendered"], len(rays))].numpy()
    return cull.order[:stats["n_survivors"]].numpy()


@pytest.mark.parametrize("rays_name", ["slab", "all_hit"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_render_matches_jax(name, rays_name):
    """The small model, unfused, chunk 100: stats exactly, every output
    row within OUT_TOL, rows no tile renders exactly background. "slab"
    has misses (the uniform path renders some in its last tile); "all_hit"
    has none and 650 rows, so a bucket's tiles run past R into the padded
    rows."""
    jm, tm = _mcfgs()
    p = _np(jinit(jax.random.PRNGKey(2), jm.nerf))
    params = {"nerf_coarse": p, "nerf_fine": p}
    rays = _slab_rays(misses=rays_name == "slab")
    rcfg_kw = dict(N_samples=64, N_importance=32, test_time=True)
    jcr, tcr = _pair(SLAB_BOXES, rcfg_kw, 100, (jm, tm), **CONFIGS[name])
    ref, ref_stats = jcr(params, jnp.asarray(rays), return_stats=True)
    out, stats = tcr(params, rays, return_stats=True)
    assert stats == ref_stats
    assert set(out) == set(ref) == {"rgb_fine", "depth_fine", "opacity_fine"}
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=OUT_TOL, err_msg=k)
    rendered = np.zeros(len(rays), bool)
    rendered[_rendered_rows(tcr, rays, stats)] = True
    for k in out:
        assert not out[k][~rendered].any(), k   # background 0 (black)
    hit = np.asarray(jocc.ray_box_hits(jcr.boxes, jnp.asarray(rays))[0])
    if rays_name == "slab":
        assert stats["n_survivors"] == hit.sum() < len(rays)
        if not tcr.budgets:     # spilled misses are rendered
            assert stats["n_rendered"] > stats["n_survivors"]
            assert (rendered & ~hit).any()
            assert out["opacity_fine"][rendered & ~hit].numpy().max() > 0
    else:
        assert hit.all()
        if tcr.budgets:     # the last bucket's tiles end past R
            counts = stats["bucket_counts"]
            b = max(i for i, c in enumerate(counts) if c)
            chunk_b = tcr._chunk_for_bucket(100, tcr._BUCKET_FRACS[b])
            assert sum(counts[:b]) + -(-counts[b] // chunk_b) * chunk_b \
                > len(rays)


@pytest.mark.parametrize("name", ["cull", "budgets_seg8"])
def test_fused_render_matches_jax(name):
    """The full model with dense random weights (sigma head x50, +2) and
    the fused kernels' configs: JAX's Pallas render kernels in interpret
    mode against the port's plain bf16 versions, 256 random rays, 60
    boxes, chunk 64, 16 + 8 samples."""
    def dense(k):
        p = _np(jinit(jax.random.PRNGKey(k)))
        p["sigma"]["w"] = p["sigma"]["w"] * 50
        p["sigma"]["b"] = p["sigma"]["b"] + 2.0
        return p

    params = {"nerf_coarse": dense(0), "nerf_fine": dense(1)}
    rays, boxes = _rays(256, seed=3), _boxes(60, seed=3)
    rcfg_kw = dict(N_samples=16, N_importance=8, test_time=True,
                   white_back=True, fused=True)
    jcr, tcr = _pair(boxes, rcfg_kw, 64, **CONFIGS[name])
    ref, ref_stats = jcr(params, jnp.asarray(rays), return_stats=True)
    out, stats = tcr(params, rays, return_stats=True)
    assert stats == ref_stats and stats["n_survivors"] > 64
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=OUT_TOL, err_msg=k)
    rendered = np.zeros(len(rays), bool)
    rendered[_rendered_rows(tcr, rays, stats)] = True
    assert (out["rgb_fine"][~rendered] == 1.0).all()   # white background
    assert not out["depth_fine"][~rendered].any()
    assert not out["opacity_fine"][~rendered].any()


def test_tile_sizing_matches_jax():
    """_chunk_for, _bucket_cost, _chunk_for_bucket and _rcfg_for_frac
    against the JAX package's at several base tiles and sample counts."""
    boxes = SLAB_BOXES
    for N_s, N_i in ((64, 128), (64, 64), (32, 0), (12, 6)):
        kw = dict(N_samples=N_s, N_importance=N_i, test_time=True)
        for fracs in (None, (0.125, 0.25, 0.5, 1.0)):
            jcr, tcr = _pair(boxes, kw, 8192, tighten=True, budgets=True,
                             bucket_fracs=fracs)
            assert tcr._BUCKET_FRACS == jcr._BUCKET_FRACS
            for frac in tcr._BUCKET_FRACS:
                assert tcr._bucket_cost(frac) == jcr._bucket_cost(frac)
                r, jr = tcr._rcfg_for_frac(frac), jcr._rcfg_for_frac(frac)
                assert (r.N_samples, r.N_importance) == (jr.N_samples,
                                                         jr.N_importance)
                for chunk in (1000, 4096, 8192, 16384, 32768, 40960):
                    assert tcr._chunk_for_bucket(chunk, frac) == \
                        jcr._chunk_for_bucket(chunk, frac)
    for R in (1, 7, 100, 8193, 640000, 2560000):
        assert tcr._chunk_for(R) == jcr._chunk_for(R)
    # eval's defaults at base 8192: the 3 buckets' tiles
    _, tcr = _pair(boxes, dict(N_samples=64, N_importance=128,
                               test_time=True), 8192, tighten=True,
                   budgets=True)
    assert [tcr._chunk_for_bucket(8192, f) for f in tcr._BUCKET_FRACS] == \
        [5464, 2736, 2048]
    _, tcr = _pair(boxes, dict(N_samples=64, N_importance=128,
                               test_time=True), 8192, tighten=True,
                   budgets=True, bucket_fracs=(0.5, 1.0, 0.5, 0.25))
    assert tcr._BUCKET_FRACS == (0.25, 0.5, 1.0)


@pytest.mark.parametrize("kw,match", [
    (dict(empty=True), "empty"),
    (dict(budgets=True), "tighten"),
    (dict(segments=32), "tighten"),
    (dict(tighten=True, segments=33), "segments"),
    (dict(chunk=0), "chunk"),
    (dict(tighten=True, bucket_fracs=(0.25, 0.5, 1.0)), "budgets"),
    (dict(tighten=True, budgets=True, bucket_fracs=(0.25, 0.5)),
     "bucket_fracs"),
    (dict(tighten=True, budgets=True, bucket_fracs=(0.0, 1.0)),
     "bucket_fracs"),
], ids=["empty", "budgets", "segments", "segments33", "chunk0",
        "fracs_need_budgets", "fracs_end", "fracs_positive"])
def test_constructor_errors_match_jax(kw, match):
    kw = dict(kw)
    boxes = np.zeros((0, 6), np.float32) if kw.pop("empty", False) \
        else SLAB_BOXES
    grid = _grid(boxes)
    rcfg_kw = dict(N_samples=16, test_time=True)
    with pytest.raises(ValueError, match=match):
        JCulledRenderer(jocc.OccupancyGrid(**grid), JRenderConfig(**rcfg_kw),
                        **kw)
    with pytest.raises(ValueError, match=match):
        CulledRenderer(OccupancyGrid(**grid), RenderConfig(**rcfg_kw),
                       device="cpu", **kw)
