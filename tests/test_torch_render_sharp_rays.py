"""The rays of chip_smoke.py's `--fused_mlp` validation render that jump,
held against the JAX package on the CPU.

chip_smoke renders one 400x400 frame (sphere pose theta 0.7, radius 4,
near 2, far 6) at 64 + 64 samples in the validation config (fused point
MLP on both passes, test time off) with random dense weights
(torch.Generator seeds 30 and 31, sigma head x50, +2), and holds 4096 of
its rays (every 39th pixel or so) against the unfused f32 path at the
99.5th percentile. Three of them jump: rays 458, 1287 and 3229 of the
4096, by up to 0.2024 in rgb_fine, where the fine samples placed from the
bf16 coarse weights land on the other side of a sharp feature of the
field. Here those three and 200 others of the same frame go through the
port's fused path (its plain bf16 version on the CPU), the JAX package's
fused render (Pallas in interpret mode, as its own tests run it) and both
packages' unfused renders:

  * the port's fused render equals JAX's within the render bar 2e-2
    (tests/test_fused.py) on every ray, the three included;
  * JAX's fused render jumps past the bar on exactly the rays where the
    port's does, the three of chip_smoke: bf16 near a sharp feature, not a
    fault of the port, so the percentile rule of chip_smoke stands.

chip_smoke's perturbed, noisy test-time render of the same 4096 rays
(perturb 1, sigma noise 1: sigma_fwd on the coarse pass, mlp_fwd on the
fine) has a ray or so that jumps the same way; its draws come from a CUDA
generator, which the CPU cannot replay. On the JAX package's draws,
injected into the port, both packages jump on the same rays: over all
4096 rays with jax.random.PRNGKey(12), rays 1367, 1899, 1945, 2127 and
3468, by up to 0.6628 in depth_fine in each, with the port's fused render
within 1.3e-3 of JAX's on every ray. The test holds the same on every
16th ray (256) with PRNGKey(23), where ray 1040 jumps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_train import _step_draws

from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import render_rays as jrender
from nerf_pl_tpu_torch.datasets.rays import frame_rays, sphere_pose
from nerf_pl_tpu_torch.models import init_nerf_params
from nerf_pl_tpu_torch.parallel import make_render_fn
from nerf_pl_tpu_torch.rendering import RenderConfig, render_rays

IMG, N_RAYS = 400, 4096
CAMERA_ANGLE_X = 0.8575560450553894
JUMPS = (458, 1287, 3229)          # of chip_smoke's 4096 validation rays
OTHERS = tuple(i for i in range(0, N_RAYS, 20) if i not in JUMPS)[:200]
BAR = 2e-2
KEYS = ("rgb_coarse", "rgb_fine", "depth_fine", "opacity_fine")
# perturbed test time on every 16th ray with JAX's draws of PRNGKey(23)
PERTURBED_RAYS, PERTURBED_KEY = tuple(range(0, N_RAYS, 16)), 23
PERTURBED_JUMPS = (1040,)
PERTURBED_KEYS = {"rgb_fine": BAR, "opacity_fine": BAR, "depth_fine": 5e-2}


def dense_params(seed):
    p = init_nerf_params(torch.Generator().manual_seed(seed), device="cpu")
    p["sigma"]["w"] = p["sigma"]["w"] * 50
    p["sigma"]["b"] = p["sigma"]["b"] + 2.0
    return p


def _rays_and_params(which):
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * IMG / 800
    frame = frame_rays(sphere_pose(0.7, np.pi / 5, 4.0), IMG, IMG, focal,
                       2.0, 6.0, "cpu")
    idx = torch.linspace(0, IMG * IMG - 1, N_RAYS).long()
    rays = frame[idx][list(which)].contiguous()
    params = {"nerf_coarse": dense_params(30), "nerf_fine": dense_params(31)}
    jparams = {m: {layer: {leaf: v.numpy() for leaf, v in leaves.items()}
                   for layer, leaves in mlp.items()}
               for m, mlp in params.items()}
    return rays, params, jparams


@pytest.fixture(scope="module")
def renders():
    rays, params, jparams = _rays_and_params(JUMPS + OTHERS)
    base = dict(N_samples=64, N_importance=64, white_back=True)
    out = {}
    with torch.no_grad():
        for name, fused in (("port fused", True), ("port unfused", False)):
            render = make_render_fn(RenderConfig(**base, fused=fused), 1024,
                                    "cpu", device_out=True)
            out[name] = {k: v.numpy() for k, v in
                         render(params, rays).items()}
    for name, fused in (("jax fused", True), ("jax unfused", False)):
        ref = jrender(jparams, jnp.asarray(rays.numpy()),
                      jax.random.PRNGKey(0), JRenderConfig(**base,
                                                           fused=fused))
        out[name] = {k: np.asarray(v) for k, v in ref.items()}
    return out


def ray_err(a, b):
    return np.abs(a - b).reshape(a.shape[0], -1).max(-1)


def test_port_fused_render_matches_jax_on_every_ray(renders):
    for k in KEYS:
        e = ray_err(renders["port fused"][k], renders["jax fused"][k])
        assert e.max() <= BAR, (k, int(e.argmax()), float(e.max()))
        e = ray_err(renders["port unfused"][k], renders["jax unfused"][k])
        assert e.max() <= BAR, (k, int(e.argmax()), float(e.max()))


def test_jax_jumps_on_the_same_rays(renders):
    """A ray jumps where its fused render is past the bar from its unfused
    one; both packages jump on chip_smoke's three rays and on no other."""
    for pkg in ("port", "jax"):
        err = np.max([ray_err(renders[f"{pkg} fused"][k],
                              renders[f"{pkg} unfused"][k]) for k in KEYS],
                     axis=0)
        jumped = [(JUMPS + OTHERS)[i] for i in np.flatnonzero(err > BAR)]
        assert jumped == list(JUMPS), (pkg, jumped)
        assert err[:len(JUMPS)].min() > 0.1, (pkg, err[:len(JUMPS)])


def test_perturbed_test_time_jumps_with_jax():
    """Perturb 1 and sigma noise 1 at test time (the port's sigma_fwd and
    mlp_fwd plain versions; JAX's nerf_sigma_fused and fused MLP in
    interpret mode) on JAX's draws: both packages jump on the same ray,
    by more than 0.1 in depth_fine, and on no other; the two fused
    renders agree within the render bars (depth 5e-2) on every ray."""
    which = PERTURBED_RAYS
    rays, params, jparams = _rays_and_params(which)
    base = dict(N_samples=64, N_importance=64, white_back=True,
                test_time=True, perturb=1.0, noise_std=1.0)
    key = jax.random.PRNGKey(PERTURBED_KEY)
    out = {}
    with torch.no_grad():
        for name, fused in (("port fused", True), ("port unfused", False)):
            cfg = RenderConfig(**base, fused=fused)
            out[name] = {k: v.numpy() for k, v in render_rays(
                params, rays, cfg,
                draws=_step_draws(key, len(which), cfg)).items()}
    for name, fused in (("jax fused", True), ("jax unfused", False)):
        ref = jrender(jparams, jnp.asarray(rays.numpy()), key,
                      JRenderConfig(**base, fused=fused))
        out[name] = {k: np.asarray(v) for k, v in ref.items()}
    for k, bar in PERTURBED_KEYS.items():
        e = ray_err(out["port fused"][k], out["jax fused"][k])
        assert e.max() <= bar, (k, which[int(e.argmax())], float(e.max()))
    for pkg in ("port", "jax"):
        err = np.max([ray_err(out[f"{pkg} fused"][k],
                              out[f"{pkg} unfused"][k]) / bar
                      for k, bar in PERTURBED_KEYS.items()], axis=0)
        jumped = [which[i] for i in np.flatnonzero(err > 1.0)]
        assert jumped == list(PERTURBED_JUMPS), (pkg, jumped)
        depth = ray_err(out[f"{pkg} fused"]["depth_fine"],
                        out[f"{pkg} unfused"]["depth_fine"])
        jump_rows = [which.index(i) for i in PERTURBED_JUMPS]
        assert depth[jump_rows].min() > 0.1, (pkg, depth[jump_rows])
