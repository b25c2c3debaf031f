"""The port's embedding and NeRF MLP against the JAX package's, on the same
numpy inputs and the same JAX-initialised weights. Both run in f32; the
tolerances (embed 1e-6, MLP 1e-5) leave room for sums taken in another
order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.models import EmbeddingConfig as JEmb
from nerf_pl_tpu.models import NeRFConfig as JCfg
from nerf_pl_tpu.models import embed as jembed
from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.models import nerf_apply as japply
from nerf_pl_tpu_torch.models import (EmbeddingConfig, NeRF, NeRFConfig,
                                      embed, init_nerf_params, nerf_apply,
                                      params_from_numpy)


def _np_params(cfg, key=0):
    return jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(key), JCfg(**cfg)))


@pytest.mark.parametrize("n_freqs,logscale", [(10, True), (4, True),
                                              (6, False)])
def test_embed_matches_jax(rng, n_freqs, logscale):
    x = rng.normal(size=(7, 5, 3)).astype(np.float32)
    ours = embed(torch.from_numpy(x), EmbeddingConfig(3, n_freqs, logscale))
    ref = jembed(jnp.asarray(x), JEmb(3, n_freqs, logscale))
    assert ours.shape == ref.shape == (7, 5, 3 * (2 * n_freqs + 1))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("cfg", [dict(D=4, W=32, skips=(2,)), dict()],
                         ids=["narrow", "full"])
def test_nerf_apply_matches_jax(rng, cfg):
    p = _np_params(cfg)
    xyz = rng.normal(size=(6, 9, 3)).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    xe, de = jembed(jnp.asarray(xyz), JEmb(3, 10)), jembed(jnp.asarray(d),
                                                           JEmb(3, 4))
    rgb_j, sig_j = japply(p, xe, de[:, None, :], JCfg(**cfg))
    sig_only_j = japply(p, xe, None, JCfg(**cfg), sigma_only=True)

    tp = params_from_numpy(p)
    xe_t, de_t = torch.from_numpy(np.array(xe)), torch.from_numpy(
        np.array(de))
    rgb_t, sig_t = nerf_apply(tp, xe_t, de_t[:, None, :], NeRFConfig(**cfg))
    sig_only_t = nerf_apply(tp, xe_t, None, NeRFConfig(**cfg),
                            sigma_only=True)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=1e-5)
    np.testing.assert_allclose(sig_only_t.numpy(), np.asarray(sig_only_j),
                               atol=1e-5)


def test_nerf_apply_bf16_matches_jax(rng):
    """compute_dtype=bfloat16: operands rounded to bf16, f32 sums."""
    p = _np_params({})
    xe = jembed(jnp.asarray(rng.normal(size=(32, 3)).astype(np.float32)),
                JEmb(3, 10))
    ref = japply(p, xe, None, JCfg(), sigma_only=True,
                 compute_dtype=jnp.bfloat16)
    ours = nerf_apply(params_from_numpy(p), torch.from_numpy(np.array(xe)),
                      None, NeRFConfig(), sigma_only=True,
                      compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_init_layout_matches_jax():
    """Same layer names, (fan_in, fan_out) shapes and init bounds."""
    cfg = NeRFConfig()
    ours = init_nerf_params(torch.Generator().manual_seed(0), cfg)
    ref = _np_params({})
    assert set(ours) == set(ref)
    for name in ref:
        for leaf in ("w", "b"):
            assert tuple(ours[name][leaf].shape) == ref[name][leaf].shape
            bound = 1.0 / ref[name]["w"].shape[0] ** 0.5
            assert ours[name][leaf].abs().max() <= bound


def test_init_is_seeded():
    a = init_nerf_params(torch.Generator().manual_seed(3))
    b = init_nerf_params(torch.Generator().manual_seed(3))
    c = init_nerf_params(torch.Generator().manual_seed(4))
    assert torch.equal(a["xyz_5"]["w"], b["xyz_5"]["w"])
    assert not torch.equal(a["xyz_5"]["w"], c["xyz_5"]["w"])


def test_module_holds_the_same_function(rng):
    p = params_from_numpy(_np_params({}))
    model = NeRF(params=p)
    xe = embed(torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32)),
               EmbeddingConfig(3, 10))
    de = embed(torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32)),
               EmbeddingConfig(3, 4))
    with torch.no_grad():
        rgb_m, sig_m = model(xe, de)
    rgb_f, sig_f = nerf_apply(p, xe, de)
    assert torch.equal(rgb_m, rgb_f) and torch.equal(sig_m, sig_f)
    assert sum(t.numel() for t in model.parameters()) == \
        sum(v.numel() for d in p.values() for v in d.values())
