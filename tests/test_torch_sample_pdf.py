"""The port's sample_pdf (torch.searchsorted) against the JAX package's
comparison-matrix version, on the same numpy inputs. Tolerance 1e-5: the
two cumsums may round differently in the last place."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.ops import sample_pdf as jsample
from nerf_pl_tpu_torch.ops.sample_pdf import sample_pdf


def _bins_weights(rng, R=6, B=15, all_eps=False):
    bins = np.sort(rng.uniform(2, 6, size=(R, B + 1)), -1).astype(np.float32)
    w = rng.random((R, B)).astype(np.float32)
    w[1] = 0.0                      # one all-eps row among the others
    w[2, :5] = 0.0                  # zero-weight bins inside a row
    if all_eps:
        w[:] = 0.0
    return bins, w


@pytest.mark.parametrize("all_eps", [False, True])
@pytest.mark.parametrize("M", [8, 33])
def test_det_matches_jax(rng, M, all_eps):
    bins, w = _bins_weights(rng, all_eps=all_eps)
    ref = jsample(jnp.asarray(bins), jnp.asarray(w), M, det=True)
    ours = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), M,
                      det=True)
    assert ours.shape == (6, M)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("all_eps", [False, True])
def test_explicit_u_matches_jax(rng, all_eps):
    bins, w = _bins_weights(rng, all_eps=all_eps)
    u = np.sort(rng.random((6, 12)), -1).astype(np.float32)
    u[0, -1] = 1.0                  # u >= cdf[-1]: clamp to the last edge
    ref = jsample(jnp.asarray(bins), jnp.asarray(w), 12, det=False,
                  u=jnp.asarray(u))
    ours = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 12,
                      det=False, u=torch.from_numpy(u))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_generator_draws_follow_the_pdf():
    bins = torch.linspace(0, 1, 5)[None]
    w = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    s = sample_pdf(bins, w, 20000, det=False,
                   generator=torch.Generator().manual_seed(0))
    hist = np.histogram(s.numpy(), bins=np.linspace(0, 1, 5))[0]
    np.testing.assert_allclose(hist / 20000, np.array([1, 2, 3, 4]) / 10,
                               atol=0.02)
