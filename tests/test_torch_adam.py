"""Adam's one-launch update (ops/adam.py, csrc/adam.cu): the wrapper's pure
Python part and the optimizer's routes, on the CPU.

  * the leaf table of the dense recipe's 48 leaves, with the strided
    gradient views unpack_grads gives, covers every element of every leaf
    exactly once, and reads each gradient element where it lies (the
    kernel's block search and indexing, simulated);
  * a leaf list over the table's limit raises, and so does a CPU leaf;
  * the table holds the leaves' addresses and the scalars as torch rounds
    them;
  * CPU leaves, bf16 leaves, sgd, radam and ranger take the foreach chain,
    with update + apply_updates' results bit for bit;
  * the kernel's route through the optimizer (the counts, the schedule's
    lr, the state tree, the writes in place), with a plain stand-in for
    the launch, gives the chain's state bit for bit;
  * the in-place flag gives the out-of-place values on the plain path.
The kernel itself is held against the chain on the card
(tests/test_torch_cuda.py).
"""
import bisect
import ctypes

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from nerf_pl_tpu_torch.models import init_nerf_params
from nerf_pl_tpu_torch.ops import adam as A
from nerf_pl_tpu_torch.ops import fused_mlp as fm
from nerf_pl_tpu_torch.training.checkpoints import flatten_with_paths
from nerf_pl_tpu_torch.training.lr_schedule import get_lr_schedule
from nerf_pl_tpu_torch.training.optimizers import (_decay_pow, apply_updates,
                                                   clip_scale, get_optimizer,
                                                   optimizer_step,
                                                   tree_leaves)

SCHED = dict(lr_scheduler="steplr", lr=1e-2, num_epochs=4, steps_per_epoch=2,
             decay_step=[1, 2], decay_gamma=0.5)


def dense_leaves():
    """The dense recipe's params (both MLPs, 48 leaves) and gradients as
    the loss-fused step gives them (unpack_grads of the kernels' packed
    buffer: strided views among them), the gradient values unique within
    a leaf."""
    params = {m: init_nerf_params(torch.Generator().manual_seed(i))
              for i, m in enumerate(("nerf_coarse", "nerf_fine"))}
    grads = {m: fm.unpack_grads(fm._pack_layout_grads(
        torch.arange(fm.GRAD_FLOATS, dtype=torch.float32)))
        for m in params}
    return params, grads


def leaf_at(layout, block):
    """The kernel's binary search: the last leaf that starts at or before
    `block`."""
    return bisect.bisect_right([s.first_block for s in layout], block) - 1


def test_leaf_table_covers_every_element_once():
    params, grads = dense_leaves()
    p, g = tree_leaves(params), tree_leaves(grads, params)
    assert len(p) == 48 and sum(t.numel() for t in p) == 1_191_688
    assert any(not t.is_contiguous() for t in g)
    layout, blocks = A.leaf_layout(p, g)
    seen = [np.zeros(t.numel(), np.int64) for t in p]
    for b in range(blocks):
        i = leaf_at(layout, b)
        s = layout[i]
        e = (b - s.first_block) * A.BLOCK_ELEMS + np.arange(A.BLOCK_ELEMS)
        assert (e < s.rows * s.cols).any(), b       # no block is idle
        np.add.at(seen[i], e[e < s.rows * s.cols], 1)
    for i, (t, grad, s) in enumerate(zip(p, g, layout)):
        assert (seen[i] == 1).all(), i
        assert s.rows * s.cols == t.numel() and s.cols == t.shape[-1]
        # element e's gradient at row * g_stride + column from g's start
        e = np.arange(t.numel())
        idx = torch.as_tensor((e // s.cols) * s.g_stride + e % s.cols)
        span = (s.rows - 1) * s.g_stride + s.cols
        where = grad.as_strided((span,), (1,))[idx]
        assert torch.equal(where, grad.contiguous().reshape(-1)), i
    assert blocks == sum(A.blocks_of(t.numel()) for t in p)
    assert {s.g_stride != s.cols for s in layout} == {True, False}


def test_leaf_list_over_the_limit_raises():
    leaves = [torch.zeros(3) for _ in range(A.MAX_LEAVES + 1)]
    with pytest.raises(ValueError, match="1 to 56 leaves"):
        A.leaf_layout(leaves, leaves)
    A.leaf_layout(leaves[:-1], leaves[:-1])
    with pytest.raises(ValueError, match="leaves; got 0"):
        A.leaf_layout([], [])
    with pytest.raises(ValueError, match="CUDA"):    # no fallback
        A.adam_step(leaves[:2], leaves[:2], leaves[:2], leaves[:2],
                    torch.ones((), dtype=torch.int32), 1e-3, b1=0.9,
                    b2=0.999, eps=1e-8)


def test_table_holds_the_leaves_and_the_scalars():
    params, grads = dense_leaves()
    p, g = tree_leaves(params), tree_leaves(grads, params)
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    outs = [[torch.empty_like(t) for t in p] for _ in range(3)]
    layout, _ = A.leaf_layout(p, g)
    count = torch.ones((), dtype=torch.int32)
    lr = torch.full((), 5e-4)
    t = A.make_table(p, g, mu, nu, list(zip(*outs)), layout, count, lr,
                     b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    assert ctypes.sizeof(t) == 4088 <= 4096
    assert ctypes.sizeof(A._Leaf) == 72
    assert t.count == count.data_ptr() and t.lr == lr.data_ptr()
    assert t.clip_scale is None     # no clip: a null pointer
    assert t.n_leaves == 48 and t.decay == 1
    for name, want in (("b1", 0.9), ("b2", 0.999), ("eps", 1e-8),
                       ("weight_decay", 1e-2), ("one_minus_b1", 1 - 0.9),
                       ("one_minus_b2", 1 - 0.999)):
        assert getattr(t, name) == float(np.float32(want)), name
    for leaf, s, *ts in zip(t.leaves, layout, p, g, mu, nu, *outs):
        assert [leaf.p, leaf.g, leaf.mu, leaf.nu, leaf.p_out, leaf.mu_out,
                leaf.nu_out] == [x.data_ptr() for x in ts]
        assert (leaf.rows, leaf.cols, leaf.g_stride,
                leaf.first_block) == tuple(s)
    t = A.make_table(p, g, mu, nu, list(zip(*outs)), layout, count, lr,
                     b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    assert t.decay == 0 and t.weight_decay == 0.0
    scale = torch.full((), 0.5)
    t = A.make_table(p, g, mu, nu, list(zip(*outs)), layout, count, lr,
                     b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0,
                     clip_scale=scale)
    assert t.clip_scale == scale.data_ptr()


def _tree(rng, dtype=torch.float32):
    return {m: {"xyz_0": {"w": torch.from_numpy(
        rng.normal(size=(5, 4)).astype(np.float32)).to(dtype),
        "b": torch.from_numpy(rng.normal(size=(4,)).astype(
            np.float32)).to(dtype)}}
        for m in ("nerf_coarse", "nerf_fine")}


def _chain_run(opt, params, grads_list, via_step, inplace=False):
    """The flattened state after the steps: through optimizer_step, or
    update + apply_updates (with the clip's factor where opt clips)."""
    state = opt.init(params)
    for grads in grads_list:
        if via_step:
            params, state = optimizer_step(opt, grads, state, params,
                                           inplace)
        else:
            scale = ((clip_scale(tree_leaves(grads, params), opt.clip_norm),)
                     if opt.clip_norm > 0 else ())
            upd, state = opt.update(grads, state, params, *scale)
            params = apply_updates(params, upd)
    return _flat({"params": params, "opt_state": state})


def _flat(tree):
    """A train state's checkpoint keys and its leaf tensors, in order."""
    return sorted(flatten_with_paths(tree)), pytree.tree_leaves(tree)


def _assert_same(a, b):
    """Two _flat states: the same keys, and leaves bit for bit."""
    assert a[0] == b[0]
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name,dtype", [("adam", torch.float32),
                                        ("adam", torch.bfloat16),
                                        ("sgd", torch.float32),
                                        ("radam", torch.float32),
                                        ("ranger", torch.float32)])
def test_other_routes_take_the_foreach_chain(name, dtype, monkeypatch):
    """CPU leaves, bf16 leaves, sgd, radam and ranger never reach the
    kernel, and optimizer_step gives update + apply_updates bit for
    bit."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was asked for")

    monkeypatch.setattr(A, "adam_step", refuse)
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    grads = [_tree(rng, dtype) for _ in range(7)]
    opt = get_optimizer(name, get_lr_schedule(**SCHED), weight_decay=1e-2)
    assert (opt.apply is not None) == (name == "adam")
    _assert_same(_chain_run(opt, params, grads, True),
                 _chain_run(opt, params, grads, False))


def _plain_adam_step(params, grads, mu, nu, count, lr, *, b1, b2, eps,
                     weight_decay=0.0, inplace=False, clip_scale=None):
    """adam_step's arithmetic in plain torch (the chain's operations,
    leaf by leaf), with its contract: writes into the given tensors in
    place, else new ones; the gradients scaled by clip_scale first."""
    corr1 = 1 - _decay_pow(b1, count)
    corr2 = 1 - _decay_pow(b2, count)
    assert lr.dtype == torch.float32 and lr.dim() == 0   # the kernel's lr
    step_size = -lr
    outs = ([], [], [])
    for p, g, m, v in zip(params, grads, mu, nu):
        if clip_scale is not None:
            g = g * clip_scale
        if weight_decay > 0:
            g = g + p * weight_decay
        m2 = m * b1 + g * (1 - b1)
        v2 = v * b2 + (g * g) * (1 - b2)
        u = (m2 / corr1) / (torch.sqrt(v2 / corr2) + eps)
        p2 = p + u * step_size
        for out, old, new in zip(outs, (p, m, v), (p2, m2, v2)):
            out.append(old.copy_(new) if inplace else new)
    return outs


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("scheduled", [True, False])
@pytest.mark.parametrize("inplace", [False, True])
def test_kernel_route_keeps_the_chain_state(weight_decay, scheduled,
                                            inplace, monkeypatch):
    """The kernel's route with a plain stand-in for the launch: the counts
    incremented, the lr the schedule's at the lr stage's count, the state
    tree optax's key for key and the values the chain's bit for bit; in
    place, the given tensors are the ones returned, written."""
    monkeypatch.setattr(A, "takes_kernel", lambda *leaves: True)
    monkeypatch.setattr(A, "adam_step", _plain_adam_step)
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    lr = get_lr_schedule(**SCHED) if scheduled else 1e-2
    opt = get_optimizer("adam", lr, weight_decay=weight_decay)
    ref = _chain_run(opt, params, grads, False)
    state = opt.init(params)
    p = {m: {k: {n: t.clone() for n, t in d.items()} for k, d in v.items()}
         for m, v in params.items()}
    for g in grads:
        before = pytree.tree_leaves((p, state))
        p2, state2 = optimizer_step(opt, g, state, p, inplace)
        after = pytree.tree_leaves((p2, state2))
        assert [a is b for a, b in zip(before, after)] == \
            [inplace] * len(before)
        p, state = p2, state2
    _assert_same(_flat({"params": p, "opt_state": state}), ref)


def test_inplace_flag_gives_the_same_values_on_the_plain_path():
    """On CPU leaves (the foreach chain) inplace changes nothing: the same
    values, new tensors, the given ones untouched."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = _tree(rng)
    opt = get_optimizer("adam", get_lr_schedule(**SCHED), weight_decay=1e-2)
    state = opt.init(params)
    keep = [t.clone() for t in pytree.tree_leaves((params, state))]
    a = optimizer_step(opt, grads, state, params, inplace=False)
    b = optimizer_step(opt, grads, state, params, inplace=True)
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert torch.equal(x, y) and x is not y
    for t, k in zip(pytree.tree_leaves((params, state)), keep):
        assert torch.equal(t, k)


def test_takes_kernel_wants_float32_on_one_cuda_device():
    """The route's test reads only each leaf's device and dtype."""
    from types import SimpleNamespace as Leaf
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    f32 = Leaf(device=cuda0, dtype=torch.float32)
    assert A.takes_kernel(f32, f32)
    assert not A.takes_kernel(f32, Leaf(device=cuda0, dtype=torch.bfloat16))
    assert not A.takes_kernel(f32, Leaf(device=cuda1, dtype=torch.float32))
    assert not A.takes_kernel(torch.zeros(2), torch.zeros(2))


@pytest.mark.parametrize("inplace", [False, True])
def test_clipped_kernel_route_equals_the_clipped_chain(inplace, monkeypatch):
    """With a global-norm clip (mip-NeRF 360's), the kernel's route with
    the plain stand-in (the factor handed to the launch) gives the clipped
    chain's state bit for bit; the clip does bite (the gradients' norm is
    over it) and adds nothing to the state tree."""
    monkeypatch.setattr(A, "takes_kernel", lambda *leaves: True)
    monkeypatch.setattr(A, "adam_step", _plain_adam_step)
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    assert float(clip_scale(tree_leaves(grads[0], params), 1e-3)) < 1e-3
    opt = get_optimizer("adam", get_lr_schedule(**SCHED), eps=1e-6,
                        clip_norm=1e-3)
    plain = get_optimizer("adam", get_lr_schedule(**SCHED), eps=1e-6)
    copy = {m: {k: {n: t.clone() for n, t in d.items()}
                for k, d in v.items()} for m, v in params.items()}
    got = _chain_run(opt, copy, grads, True, inplace)
    _assert_same(got, _chain_run(opt, params, grads, False))
    assert got[0] == _chain_run(plain, params, grads, False)[0]
    assert not all(torch.equal(a, b) for a, b in zip(
        got[1], _chain_run(plain, params, grads, False)[1]))


@pytest.mark.parametrize("name", ["sgd", "radam", "ranger"])
def test_only_adam_takes_a_clip(name):
    """The global-norm clip is mip-NeRF 360's Adam's: every other
    optimizer refuses it, and takes none by default."""
    with pytest.raises(ValueError, match="no global-norm clip"):
        get_optimizer(name, 1e-3, clip_norm=1e-3)
    assert get_optimizer(name, 1e-3).clip_norm == 0
