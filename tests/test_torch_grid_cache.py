"""The port's occupancy-grid cache (`load_or_build_grid`) against the JAX
package's, on the CPU: a round trip, rebuilds on a new N, threshold or
checkpoint mtime, the prune of stale siblings, a checkpoint path with
glob metacharacters, and both packages' caches on one checkpoint, each
surviving the other's builds and prunes."""
import glob
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_occupancy import _rays

from nerf_pl_tpu.models import EmbeddingConfig as JEmbeddingConfig
from nerf_pl_tpu.models import NeRFConfig as JNeRFConfig
from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import load_or_build_grid as jload_or_build
from nerf_pl_tpu.rendering import occupancy as jocc
from nerf_pl_tpu_torch.models import (EmbeddingConfig, NeRFConfig,
                                      params_from_numpy)
from nerf_pl_tpu_torch.rendering import ModelConfig, load_or_build_grid
from nerf_pl_tpu_torch.rendering import occupancy as tocc


@pytest.fixture(scope="module")
def grid_params():
    """tests/test_occupancy.py's small model, its sigma bias +50: every
    cell occupied."""
    jm = JModelConfig(nerf=JNeRFConfig(D=2, W=32, in_channels_xyz=27,
                                       in_channels_dir=15, skips=(1,)),
                      emb_xyz=JEmbeddingConfig(3, 4),
                      emb_dir=JEmbeddingConfig(3, 2))
    tm = ModelConfig(nerf=NeRFConfig(D=2, W=32, in_channels_xyz=27,
                                     in_channels_dir=15, skips=(1,)),
                     emb_xyz=EmbeddingConfig(3, 4),
                     emb_dir=EmbeddingConfig(3, 2))
    p = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0),
                                                 jm.nerf))
    p["sigma"]["b"] = p["sigma"]["b"] + 50.0
    return p, jm, tm


def _ckpt(tmp_path, name="model.ckpt"):
    path = tmp_path / name
    path.write_bytes(b"fake")
    return str(path)


def _retrain(ckpt):
    st = os.stat(ckpt)
    os.utime(ckpt, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))


def _caches(ckpt, suffix):
    return sorted(glob.glob(glob.escape(ckpt) + suffix + ".*.npz"))


KW = dict(occ_range=(-1.0, 1.0), sigma_threshold=0.5, verbose=False)


def test_grid_cache_round_trip_and_rebuilds(grid_params, tmp_path):
    """A second call loads the cache file (not rewritten); a new N or
    threshold is another file beside it; a retrained checkpoint rebuilds
    and prunes both stale files."""
    p, _, tm = grid_params
    tp = params_from_numpy(p)
    ckpt = _ckpt(tmp_path)
    occ1 = load_or_build_grid(ckpt, tp, tm, N=8, **KW)
    (cache,) = _caches(ckpt, ".torch_occ")
    mtime = os.stat(cache).st_mtime_ns
    occ2 = load_or_build_grid(ckpt, tp, tm, N=8, **KW)
    assert os.stat(cache).st_mtime_ns == mtime
    for f in ("boxes", "block_map", "lo", "hi"):
        np.testing.assert_array_equal(getattr(occ1, f), getattr(occ2, f))
    occ3 = load_or_build_grid(ckpt, tp, tm, N=16, **KW)
    assert occ3.block_map.shape != occ1.block_map.shape
    load_or_build_grid(ckpt, tp, tm, N=8, **dict(KW, sigma_threshold=0.7))
    assert len(_caches(ckpt, ".torch_occ")) == 3
    _retrain(ckpt)
    load_or_build_grid(ckpt, tp, tm, N=8, **KW)
    (left,) = _caches(ckpt, ".torch_occ")
    st = os.stat(ckpt)
    with np.load(left) as z:
        assert str(z["key"]).startswith(f"{st.st_mtime_ns}:{st.st_size}:")
    # the grid equals the JAX package's build of the same weights
    ref = jload_or_build(ckpt, p, grid_params[1], N=8, **KW)
    np.testing.assert_array_equal(occ1.boxes, ref.boxes)


def test_grid_cache_glob_metachar_path(grid_params, tmp_path):
    """A checkpoint named 'sweep[lr].ckpt' prunes only its own caches: an
    unescaped glob would match (and delete) sweepl.ckpt's."""
    p, _, tm = grid_params
    tp = params_from_numpy(p)
    victim = _ckpt(tmp_path, "sweepl.ckpt")
    load_or_build_grid(victim, tp, tm, N=8, **KW)
    (vcache,) = _caches(victim, ".torch_occ")
    meta = _ckpt(tmp_path, "sweep[lr].ckpt")
    load_or_build_grid(meta, tp, tm, N=8, **KW)
    _retrain(meta)
    load_or_build_grid(meta, tp, tm, N=8, **KW)
    assert os.path.exists(vcache)
    assert len(_caches(meta, ".torch_occ")) == 1


@pytest.mark.parametrize("mode", ["sigma", "weight"])
def test_grid_caches_of_both_packages_coexist(grid_params, tmp_path, mode):
    """One checkpoint, both packages: the keys are equal (the port's
    visibility rays given as a tensor), the files differ, each package's
    retrain prune leaves the other's caches (live or stale, and JAX's
    legacy keyless file) alone, and each loads its own file."""
    p, jm, tm = grid_params
    tp = params_from_numpy(p)
    ckpt = _ckpt(tmp_path)
    vis = _rays(500, seed=2) if mode == "weight" else None
    aabb = tocc.rays_aabb(_rays(500, seed=2))
    kw = dict(occ_range=None, sigma_threshold=0.5, verbose=False,
              mode=mode, aabb=aabb)
    assert tocc._grid_cache_key(ckpt, 8, None, 0.5, mode=mode,
                                vis_rays=vis, aabb=aabb) == \
        jocc._grid_cache_key(ckpt, 8, None, 0.5, mode=mode, vis_rays=vis,
                             aabb=aabb)
    legacy = jocc.grid_cache_path(ckpt)
    np.savez(legacy, key="0:0:dead", boxes=np.zeros((1, 6), np.float32),
             block_map=np.zeros((2, 2, 2), np.uint8),
             lo=np.zeros(3, np.float32), hi=np.ones(3, np.float32))
    tvis = None if vis is None else torch.from_numpy(vis)
    load_or_build_grid(ckpt, tp, tm, N=8, vis_rays=tvis, **kw)
    assert os.path.exists(legacy)            # the port leaves it alone
    os.remove(legacy)
    jload_or_build(ckpt, p, jm, N=8, vis_rays=vis, **kw)
    (t_live,), (j_live,) = _caches(ckpt, ".torch_occ"), _caches(ckpt, ".occ")
    assert os.path.basename(t_live) != os.path.basename(j_live)
    _retrain(ckpt)                            # both files now stale
    jload_or_build(ckpt, p, jm, N=8, vis_rays=vis, **kw)
    assert _caches(ckpt, ".torch_occ") == [t_live]
    (j_new,) = _caches(ckpt, ".occ")
    load_or_build_grid(ckpt, tp, tm, N=8, vis_rays=tvis, **kw)
    assert _caches(ckpt, ".occ") == [j_new]   # JAX's live cache survives
    (t_new,) = _caches(ckpt, ".torch_occ")
    assert t_new != t_live
    with np.load(t_new) as zt, np.load(j_new) as zj:
        assert str(zt["key"]) == str(zj["key"])
        np.testing.assert_array_equal(zt["boxes"], zj["boxes"])
