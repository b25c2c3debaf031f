"""The port's training step as `run_steps` runs it (the function a CUDA
graph captures on the card), its last optimizers and bf16 master weights,
against the loop it replaced and against the JAX package.

  * run_steps equals the eager loop it replaced bit for bit on the CPU
    (params, opt_state, loss, psnr and lr): the step's draws made before
    the step, the batch offset from a device step counter with the packed
    wrap, the lr from the device step; and a step takes no draw but
    perturb, noise_coarse, u and noise_fine. On the loss-fused, culled32
    (packed, segment masks), fused_train and --fused_mlp routes, and with
    ranger on bf16 masters.
  * One Trainer step with bf16 master weights (Adam), on the loss-fused
    step and on --fused_mlp autograd, against the JAX Trainer with
    master_dtype=bfloat16, on the same weights, store and batch (no
    perturb and no noise, so neither needs the other's random stream):
    each param leaf within 2^-7 of its largest value where the two
    gradients agree in sign and Adam's step is lr * sign(g) (see the
    test), the moments at the whole-step gradient bar and the counts
    equal. JAX on
    the CPU runs a bf16 chain in f32 inside a fusion and rounds at its
    outputs, torch after every op, so the two are not bitwise.
  * radam, ranger (with weight decay: the shifted chain) and bf16-master
    train states load in both packages, in both directions, key for key.
  * The profiler-side launch count (ops.kernel_events) names each
    kernel's __global__ function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.parallel import Trainer as JTrainer
from nerf_pl_tpu.parallel import make_mesh
from nerf_pl_tpu.parallel.spmd import TrainState as JTrainState
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import render_rays as jrender
from nerf_pl_tpu.training import get_lr_schedule as jsched
from nerf_pl_tpu.training import get_optimizer as jopt
from nerf_pl_tpu.training import loss_dict as jloss
from nerf_pl_tpu.training.checkpoints import flatten_with_paths as jflat
from nerf_pl_tpu.training.checkpoints import load_checkpoint as jload
from nerf_pl_tpu.training.checkpoints import save_checkpoint as jsave
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.parallel import Trainer, TrainState
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.checkpoints import (flatten_with_paths,
                                                    load_checkpoint,
                                                    save_checkpoint)
from nerf_pl_tpu_torch.training.optimizers import (apply_updates,
                                                   tree_leaves,
                                                   tree_unflatten)

SCHED = dict(lr_scheduler="steplr", lr=1e-3, num_epochs=4,
             steps_per_epoch=5, decay_step=[1], decay_gamma=0.5)
BF16_PARAM_TOL = 2.0 ** -7
BOX = [[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the steps here run thousands of small ops,
    which more threads only slow down when the lane's other workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _store(n, seed):
    """Rays from a sphere of radius 4 at points of [-1.5, 1.5]^3 (near 2,
    far 6), and colours."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= 4.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)],
                          1).astype(np.float32)
    return rays, rng.random((n, 3)).astype(np.float32)


def _trainer(rcfg, batch, optimizer="adam"):
    sched = get_lr_schedule(**SCHED)
    return Trainer(ModelConfig(), rcfg, get_optimizer(optimizer, sched),
                   sched, loss_dict["mse"], batch, "cpu")


def _eager_loop(tr, state, seed, n_steps):
    """The loop run_steps replaced: a host step, the batch sliced at a host
    offset, each draw taken from the step's generator as the render asks
    for it, the lr from the host step."""
    params, opt_state = state.params, state.opt_state
    losses, psnrs, lrs = [], [], []
    b = tr.batch_size
    for i in range(n_steps):
        s = state.step + i
        off = (s % tr.steps_per_epoch) * b
        if tr.all_nsurv is not None:
            off %= max(tr.all_nsurv // b, 1) * b
        occm = None if tr.all_occm is None else tr.all_occm[off:off + b]
        lrs.append(tr.lr_schedule(s))
        loss, mse, grads = tr.family.loss_and_grads(
            params, tr.all_rays[off:off + b], tr.all_rgbs[off:off + b],
            tr.step_generator(seed, s), occm=occm)
        grads = tree_unflatten(params, [g.to(p.dtype) for g, p in zip(
            tree_leaves(grads, params), tree_leaves(params))])
        updates, opt_state = tr.optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
        psnrs.append(-10.0 * torch.log10(torch.clamp(mse, min=1e-10)))
    return (TrainState(params, opt_state, state.step + n_steps),
            {"loss": torch.stack(losses), "psnr": torch.stack(psnrs),
             "lr": torch.stack(lrs)})


BASE = dict(N_samples=8, N_importance=4, perturb=1.0, noise_std=1.0,
            white_back=True)
ROUTES = {
    "loss_fused": (dict(fused_train=True, fused_loss=True), "adam", None),
    "culled_packed": (dict(fused_train=True, fused_loss=True), "adam",
                      dict(boxes=BOX, margin=0.1, n_seg=16, dilate=1,
                           pack=True)),
    "fused_train": (dict(fused_train=True), "adam", None),
    "fused_mlp": (dict(fused=True), "adam", None),
    "ranger_bf16": (dict(fused_train=True, fused_loss=True), "ranger", None),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_run_steps_equals_the_eager_loop(route):
    """Two segments (5 steps, the epoch's reshuffle, 3 steps) of run_steps
    against the eager loop it replaced, bit for bit. The packed store
    holds 3 survivor batches of an epoch's 5, so its offset wraps."""
    extra, optimizer, tighten = ROUTES[route]
    rcfg = RenderConfig(**BASE, **extra)
    rays, rgbs = _store(320, seed=3)
    runs = []
    for run in (Trainer.run_steps, _eager_loop):
        tr = _trainer(rcfg, 64, optimizer)
        tr.set_data(rays, rgbs)
        if tighten:
            tr.tighten_store(**tighten)
            assert tr.all_nsurv // 64 == 3 and tr.steps_per_epoch == 5
        state = tr.init_state(torch.Generator().manual_seed(0),
                              master_dtype=(torch.bfloat16
                                            if route == "ranger_bf16"
                                            else None))
        metrics = []
        for n in (5, 3):
            state, m = run(tr, state, 9, n)
            metrics.append(m)
            tr.reshuffle(100 + state.step)
        runs.append((state, metrics))
        if run is _eager_loop:
            continue
        # every draw of a step is made beforehand: the step takes none
        g = tr.step_generator(9, 0)
        before = g.get_state()
        rays_b, rgbs_b, *occm = tr._sample_batch(0)
        tr.family.loss_and_grads(state.params, rays_b, rgbs_b, g,
                                 tr.step_draws(9, 0),
                                 occm=occm[0] if occm else None)
        assert torch.equal(g.get_state(), before)
    (s1, m1), (s2, m2) = runs
    assert s1.step == s2.step == 8
    f1 = flatten_with_paths({"params": s1.params, "opt_state": s1.opt_state})
    f2 = flatten_with_paths({"params": s2.params, "opt_state": s2.opt_state})
    assert set(f1) == set(f2)
    for k in f1:
        np.testing.assert_array_equal(f1[k], f2[k], err_msg=k)
    for a, b in zip(m1, m2):
        for k in ("loss", "psnr", "lr"):
            assert torch.equal(a[k], b[k]), k


def _jax_params():
    return {m: jax.tree_util.tree_map(np.asarray,
                                      jinit(jax.random.PRNGKey(k)))
            for k, m in enumerate(("nerf_coarse", "nerf_fine"))}


def _cos_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    nb = np.linalg.norm(b)
    return a @ b / (np.linalg.norm(a) * nb), np.linalg.norm(a - b) / nb


def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
                   - 7)


@pytest.mark.parametrize("route", ["loss_fused", "fused_mlp"])
def test_bf16_master_step_matches_jax(route):
    """One Adam step on bf16 masters, the port's Trainer against JAX's, on
    the same JAX-initialised weights, store and batch (JAX's Pallas
    kernels in interpret mode, the port's plain versions). Loss-fused: the
    JAX Trainer itself (init_state(master_dtype=bfloat16), run_steps). On
    --fused_mlp the JAX Trainer cannot take this step: fused_nerf_mlp's
    custom VJP returns float32 cotangents for bfloat16 weights and
    jax.value_and_grad rejects them, so the reference is that Trainer's
    step composed by hand: jax.grad of its render_rays at the bf16 weights
    widened to f32, the gradients cast to bf16 (as its _one_step casts
    them), then jitted optax adam on the bf16 weights.

    Adam's first step moves a weight by lr * g / (|g| + eps), several bf16
    ulps here: lr * sign(g) within 1% where |g| >= 100 eps. Where the two
    gradients agree in sign and |g| >= 100 eps, each param leaf is within
    2^-7 of its largest value (one bf16 ulp at the leaf's top binade).
    Elsewhere the step depends on the gradient itself: a weight whose
    gradient changes sign between the packages (its |g| within the
    gradient bar, 0.03 of its leaf's largest) moves the other way; any
    such weight is at most 2 lr and an ulp from JAX's. The moments:
    cosine >= 0.999 and relative L2 <= 0.05 per leaf
    (test_torch_fused_train.py's whole-step gradient bar: with 32
    rays one flipped bf16 rounding or ReLU mask moves a leaf's largest
    entries; nu, a square, 0.1); the counts equal."""
    extra = (dict(fused_train=True, fused_loss=True) if route == "loss_fused"
             else dict(fused=True))
    base = dict(N_samples=8, N_importance=4, white_back=True, **extra)
    rays, rgbs = _store(64, seed=5)
    params = _jax_params()
    sched = jsched(**SCHED)
    tr = _trainer(RenderConfig(**base), 32)
    tr.set_data(rays, rgbs)
    p = {k: params_from_numpy(v, dtype=torch.bfloat16)
         for k, v in params.items()}
    state, _ = tr.run_steps(TrainState(p, tr.optimizer.init(p), 0), 1, 1)

    opt = jopt("adam", sched)
    pj = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                params)
    if route == "loss_fused":
        jt = JTrainer(make_mesh(num_data=1), JModelConfig(),
                      JRenderConfig(**base), opt, sched, jloss["mse"], 32)
        jt.set_data(rays, rgbs)
        js = jt.init_state(jax.random.PRNGKey(0), init_params=params,
                           master_dtype=jnp.bfloat16)
        js, _ = jt.run_steps(js, jax.random.PRNGKey(1), 1)
        ref = {"params": js.params, "opt_state": js.opt_state}
    else:
        rays_b, rgbs_b = (jnp.asarray(t.numpy()) for t in tr._sample_batch(0))

        def loss_of(p32):
            out = jrender(p32, rays_b, jax.random.PRNGKey(1),
                          JRenderConfig(**base))
            return jloss["mse"](out, rgbs_b)

        g = jax.grad(loss_of)(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), pj))
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), g)
        upd, st = jax.jit(opt.update)(g, opt.init(pj), pj)
        ref = {"params": optax.apply_updates(pj, upd), "opt_state": st}

    fj = jflat(ref)
    ft = flatten_with_paths({"params": state.params,
                             "opt_state": state.opt_state})
    assert set(fj) == set(ft)
    assert all(t.dtype == torch.bfloat16
               for t in tree_leaves(state.opt_state[0]["mu"]))
    lr, moved, n = float(sched(0)), 0, 0
    for k in fj:
        if k.endswith("count"):
            assert ft[k] == fj[k], k
        elif k.startswith("params"):
            mu = "opt_state/0/mu/" + k[len("params/"):]
            agree = np.sign(ft[mu]) == np.sign(fj[mu])
            assert np.all(np.abs(fj[mu][~agree])
                          <= 0.03 * np.abs(fj[mu]).max()), k
            # |g| >= 100 eps: Adam's first step is lr * sign(g) within 1%
            firm = agree & (np.abs(fj[mu]) >= (1 - 0.9) * 100 * 1e-8)
            gap = np.abs(ft[k] - fj[k])
            assert np.all(gap[firm] <= BF16_PARAM_TOL * np.abs(fj[k]).max()
                          ), k
            ulp = _bf16_ulp(np.maximum(np.abs(ft[k]), np.abs(fj[k])))
            assert np.all(gap <= 2 * lr + ulp), k
            model, layer, leaf = k.split("/")[1:]
            init = torch.tensor(params[model][layer][leaf]).to(
                torch.bfloat16).float().numpy()
            moved += int((ft[k] != init).sum())
            n += init.size
        elif not np.any(fj[k]):
            assert not np.any(ft[k]), k
        else:
            cos, l2 = _cos_l2(ft[k], fj[k])
            assert cos >= 0.999 and l2 <= (0.1 if "/nu/" in k else 0.05), (
                k, cos, l2)
    assert moved > 0.3 * n      # the step moves many weights by bf16 ulps


def _jax_state(name, master_dtype, weight_decay, steps=7):
    """A JAX train state after `steps` optax updates on fixed gradients:
    past radam's switch at count 7 and ranger's sync at step 6."""
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    params = {"nerf_coarse": jinit(kc), "nerf_fine": jinit(kf)}
    if master_dtype is not None:
        params = jax.tree_util.tree_map(lambda x: x.astype(master_dtype),
                                        params)
    opt = jopt(name, jsched(**SCHED), weight_decay=weight_decay)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda p: 0.01 * p + 1e-3, params)
    for _ in range(steps):
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
    return JTrainState(params, state, jnp.asarray(steps, jnp.int32))


@pytest.mark.parametrize("name,bf16,weight_decay",
                         [("radam", False, 0.0), ("ranger", False, 1e-2),
                          ("ranger", True, 0.0)])
def test_optimizer_checkpoints_load_in_both_packages(tmp_path, name, bf16,
                                                     weight_decay):
    js = _jax_state(name, jnp.bfloat16 if bf16 else None, weight_decay)
    path = str(tmp_path / "jax.ckpt")
    jsave(path, js, {"step": 7})
    sched = get_lr_schedule(**SCHED)
    tr = Trainer(ModelConfig(), RenderConfig(N_samples=8, N_importance=8),
                 get_optimizer(name, sched, weight_decay=weight_decay),
                 sched, loss_dict["mse"], 8, "cpu")
    template = tr.init_state(torch.Generator().manual_seed(0),
                             master_dtype=torch.bfloat16 if bf16 else None)
    ported, meta = load_checkpoint(path, template)
    assert meta == {"step": 7} and ported.step == 7
    want = torch.bfloat16 if bf16 else torch.float32
    assert all(t.dtype == want for t in tree_leaves(ported.params))
    fj, ft = jflat(js), flatten_with_paths(ported)
    assert set(fj) == set(ft)
    for k in fj:
        assert ft[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)

    back = str(tmp_path / "torch.ckpt")
    save_checkpoint(back, ported, {"step": 7})
    restored, _ = jload(back, _jax_state(name, jnp.bfloat16 if bf16
                                         else None, weight_decay, steps=0))
    fr = jflat(restored)
    assert jax.tree_util.tree_leaves(restored.params)[0].dtype == (
        jnp.bfloat16 if bf16 else jnp.float32)
    for k in fj:
        np.testing.assert_array_equal(fr[k], fj[k], err_msg=k)


def test_kernel_events_count_each_kernel_by_name():
    """The device-side launch count chip_smoke holds against the wrappers'
    (a replayed graph's launches are inferred): each kernel's __global__
    function is one in csrc/, and kernel_events finds it by whole name in
    profiler keys (point_fwdbwd_kernel is not fwdbwd_kernel)."""
    import collections
    import pathlib
    import re

    from nerf_pl_tpu_torch import ops
    csrc = "".join(p.read_text() for p in (pathlib.Path(ops.__file__).parent
                                           .parent / "csrc").iterdir())
    for sym in ops.KERNEL_SYMBOLS.values():
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s*"
                         rf"{sym}\(", csrc), sym
    assert set(ops.KERNEL_SYMBOLS) == set(ops.LAUNCH_COUNTERS)
    Ev = collections.namedtuple("Ev", "key count")
    events = [Ev("void fwdbwd_kernel<false>(WeightMaps, ScratchMaps, "
                 "TrainArgs, int)", 20),
              Ev("void point_fwdbwd_kernel(WeightMaps, ScratchMaps, "
                 "PointArgs, int)", 10),
              Ev("void mlp_fwd_kernel(WeightMaps, PointArgs, int)", 10),
              Ev("void wgrad_kernel(ScratchMaps, GJobs, int, int, float*)",
                 30),
              Ev("aten::mul", 7)]
    launches = {k: 0 for k in ops.LAUNCH_COUNTERS}
    launches.update(mse_render=2, mlp_fwd=1, mlp_bwd=1)
    assert ops.kernel_events(events) == ops.by_symbol(
        {k: n * 10 for k, n in launches.items()})
