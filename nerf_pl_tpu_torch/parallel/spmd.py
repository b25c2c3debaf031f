"""The trainer: the ray store on the device, contiguous batch reads, the
step of the model config's family (`training/families.py`: its params,
store columns, draws, loss and gradients), K steps at a time, and the
occupancy tightening of the store; on one device, or over a
torch.distributed group (`dist.py`), one process a rank, laid out as a
(data, model) mesh (`mesh.py`).

Port of `Trainer` in nerf_pl_tpu/parallel/spmd.py. The JAX Trainer shards
the store and the batch over the mesh's `data` axis; here each rank holds
its data index's shard of the store, the contiguous block P("data") gives
it, and the psums of the JAX Trainer are all-reduces over the data group:
the loss-fused step's gradients, loss and squared error
(`spmd.py:521-533`), the autograd step's gradients of the local mean
scaled by batch_local / batch_size (what GSPMD computes for the global
mean), and the counts of `tighten_store` and `_partition_store`
(`spmd.py:299-302, 370-374`). Without a group nothing is reduced and the
code is the one-device trainer's.

With `tensor_parallel` and a model axis of more than one rank, each rank
holds its blocks of the MLPs (`mesh.model_pspecs`, the JAX rules) and of
their optimizer moments, and the step runs the Megatron MLP
(`models/nerf.py`) or, on the fused routes, gathers the whole weights for
the kernels. The ranks of a model group hold the same store shard and
draw the same numbers. The loss-fused step shards rays only and rejects a
model axis, as in JAX (`spmd.py:512-520`).

`run_steps` runs K steps of one function, `_step`, whose inputs are all on
the device: the params and optimizer state, a 0-dim step counter (the
batch offset and the logged lr follow from it, as JAX's dynamic_slice and
metrics do) and the step's random draws, made beforehand from the host
generator of (seed, step). On the CPU it loops over eager steps. On CUDA
it is the port's counterpart of the JAX Trainer's lax.scan: the step is
captured once as a CUDA graph (`_StepGraph`) and replayed K times; a step
that cannot be captured raises, with no eager fallback. The graph reads
and writes fixed addresses: the state lives in static buffers that a
segment loads from the caller's state and returns clones of; the store is
permuted in place, and a new store (set_data, tighten_store) or a new
state structure captures the step anew.

Occupancy (`tighten_store`) clips every stored ray's [near, far] to its
occupancy-box overlaps, stores a per-ray occupied-segment mask for the
coarse placement, and with `pack` keeps the store survivors-first so that
batches read only rays that hit a box. It runs on the store's device; the
host reads back only the counts it prints.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import dist as pdist
from ..ops import (LAUNCH_COUNTERS, WORK_COUNTERS, add_launches,
                   launch_counts)
from ..rendering.occupancy import (dilate_segment_bits, ray_box_hits,
                                   ray_box_segment_bits, tighten_intervals)
from ..rendering.render import ModelConfig, RenderConfig
from ..training import families
from ..training.checkpoints import map_with_paths
from ..training.optimizers import Optimizer, optimizer_step, tree_leaves, \
    tree_unflatten
from ..utils import profiling as P
from .mesh import make_mesh


class TrainState(NamedTuple):
    params: Any       # {'nerf_coarse': {layer: {w, b}}, 'nerf_fine': ...}
    opt_state: Any    # the optimizer's tree (training/optimizers.py)
    step: int         # global step; a host int, for bookkeeping (the
                      # step itself reads a device counter, run_steps)


def seed_for(seed: int, *counters: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, counters):
    restarts and segment boundaries leave the random stream unchanged."""
    state = np.random.SeedSequence([seed, *counters]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), with no int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser: a bijection of [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash32(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """A counter-based hash of (seed, idx) for int64 idx in [0, 2^32): a
    bijection of idx for each seed, so distinct labels never tie."""
    return _fmix32(_fmix32(idx ^ (seed & _M32)) ^ ((seed >> 32) & _M32))


class Trainer:
    """Args as the JAX Trainer's, with a process group and the model
    axis's size for the mesh:
      mcfg, rcfg_train: model and training render config.
      optimizer: from training.optimizers.get_optimizer.
      lr_schedule: step -> lr (logged beside the metrics).
      loss_fn: results dict, rgbs -> scalar (the NeRF's autograd route).
      batch_size: the GLOBAL rays per step; each data index takes
        batch_size // num_data of them.
      device: where this rank's store, the params and the step live.
      group: a torch.distributed process group, or None (one device, no
        collective).
      num_model: ranks of the mesh's model axis (`mesh.make_mesh`); the
        data axis takes the rest of the group.
      tensor_parallel: split the MLPs over the model axis.
    """

    def __init__(self, mcfg: ModelConfig, rcfg_train: RenderConfig,
                 optimizer: Optimizer, lr_schedule: Callable,
                 loss_fn: Callable, batch_size: int,
                 device: torch.device | str, group=None, num_model: int = 1,
                 tensor_parallel: bool = False):
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.group = group
        self.mesh = make_mesh(group, num_model)
        self.num_data = self.mesh.num_data
        self.data_index = self.mesh.data_index
        if batch_size % self.num_data:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"the data axis of {self.num_data} ranks")
        self.batch_size = batch_size
        self.batch_local = batch_size // self.num_data
        self.family = families.family_for(mcfg, rcfg_train, loss_fn,
                                          batch_size, self.mesh,
                                          tensor_parallel)
        if not self.family.parallel and (group is not None or tensor_parallel):
            raise ValueError(f"{self.family.name} trains on one device: no "
                             "process group, no tensor parallelism")
        self.tp = self.family.tp
        self.device = torch.device(device)
        self.all_rays = None
        self.all_rgbs = None
        self.all_radii = None
        self._graph = None       # the captured step (CUDA only)
        self.captures = 0        # how many times the step was captured

    # ---------------------------------------------------------------- data
    def set_data(self, all_rays: np.ndarray, all_rgbs: np.ndarray,
                 shuffle_seed: int = 0,
                 all_radii: Optional[np.ndarray] = None):
        """Shuffle the whole store once on the host (the JAX Trainer's
        numpy permutation, the same on every rank), pad it to whole global
        batches by repeating head rays modulo n, and move this rank's
        contiguous shard (P("data")'s block) to the device. Step i of an
        epoch then reads the shard's contiguous block i. `all_radii` (N,),
        the rays' pixel radii (a family's `radii` column), go with them."""
        if ("radii" in self.family.columns) != (all_radii is not None):
            raise ValueError(f"a {self.family.name} store takes "
                             f"{self.family.columns} beside rays and rgbs")
        n = all_rays.shape[0]
        perm = np.random.default_rng(shuffle_seed).permutation(n)
        arrays = [a[perm] for a in (all_rays, all_rgbs, all_radii)
                  if a is not None]
        pad = (-n) % self.batch_size
        if pad:
            idx = np.arange(pad) % n
            arrays = [np.concatenate([a, a[idx]], 0) for a in arrays]
        self.n_rays_local = arrays[0].shape[0] // self.num_data
        lo = self.data_index * self.n_rays_local
        shard = slice(lo, lo + self.n_rays_local)
        self.all_rays, self.all_rgbs, *radii = [
            torch.as_tensor(a[shard], dtype=torch.float32,
                            device=self.device) for a in arrays]
        self.all_radii = radii[0] if radii else None
        # steps of one pass over a shard (the JAX steps_per_epoch_local)
        self.steps_per_epoch = max(1, self.n_rays_local // self.batch_local)
        # Occupancy state, set by tighten_store: the original [near, far]
        # (re-tightening always starts from it), the (R,) int64 segment
        # masks and their count, and with packing the hit flags, the
        # survivor count and total / survivors.
        self.all_nf0 = None
        self.all_occm = None
        self.family.n_seg = 0
        self.all_hit = None
        self.all_nsurv = None
        self.pack_expand = 1.0
        # stable identity labels, carried through every permutation
        self.all_idx = self._make_idx()

    def _make_idx(self) -> torch.Tensor:
        """Global labels: data index d's shard holds d * n_local +
        arange."""
        return self.data_index * self.n_rays_local + torch.arange(
            self.n_rays_local, device=self.device)

    def _rank_seed(self, *counters: int) -> int:
        """A generator seed of (counters) that folds in the data index, as
        JAX's fold_in(key, axis_index("data")): each data index's stream
        differs, a model group's ranks share theirs, and data index 0's is
        the one-device trainer's, seed_for(*counters) (a reshuffle's seed
        when given alone)."""
        if self.data_index == 0:
            return counters[0] if len(counters) == 1 else seed_for(*counters)
        return seed_for(*counters, self.data_index)

    def _store_named(self):
        """(name, array) of the store's row-aligned arrays."""
        named = [("all_rays", self.all_rays), ("all_rgbs", self.all_rgbs),
                 ("all_radii", self.all_radii), ("all_nf0", self.all_nf0),
                 ("all_occm", self.all_occm),
                 ("all_hit", self.all_hit), ("all_idx", self.all_idx)]
        return [(n, a) for n, a in named if a is not None]

    def _permute(self, order: torch.Tensor):
        """Reorder every store array in place, so that a captured step's
        addresses stay valid across the per-epoch reshuffles."""
        for _, arr in self._store_named():
            arr.copy_(arr[order])

    def reshuffle(self, seed: int):
        """Per-epoch re-permutation of the store on the device, from a
        generator seeded by `seed` (a function of (seed, epoch)).

        With survivor packing the order is canonical instead
        (`_reshuffle_canonical`): a pure function of (hit, seed, identity),
        whatever the store's current order, with survivors first."""
        if self.all_hit is not None:
            self._reshuffle_canonical(seed)
            return
        g = torch.Generator(device=self.device).manual_seed(
            self._rank_seed(seed))
        self._permute(torch.randperm(self.all_rays.shape[0], generator=g,
                                     device=self.device))

    def _reshuffle_canonical(self, seed: int):
        """One stable sort on miss * 2^32 + hash32(seed, identity): the
        keys are distinct, so the order depends on nothing else (a resumed
        run rebuilds the live layout from the grid and the last seed)."""
        key = ((~self.all_hit).to(torch.int64) << 32) | hash32(self.all_idx,
                                                                 seed)
        self._permute(torch.argsort(key, stable=True))

    def tighten_store(self, boxes: np.ndarray, margin: float = 0.1,
                      n_seg: int = 0, dilate: int = 0, pack: bool = False):
        """Occupancy-tighten the [near, far] of every ray in the store to
        the union of its box overlaps, widened by `margin` (rays that miss
        every box keep theirs). Always derives from the original intervals,
        so a refresh with a new grid can widen them again.

        n_seg > 0 also stores each ray's occupied-segment mask over its
        tightened interval (dilated by `dilate` segments a side), which
        the step's coarse placement reads. pack=True keeps the store
        survivors-first (`_partition_store`); batches then read survivors
        only.

        The boxes are not padded to a multiple of 64 as in the JAX Trainer,
        whose compiled program is keyed on the box count: the loops here
        run eagerly, and a padded box, which no ray reaches, changes no
        result.

        Returns {"hit_frac", "shrink"} and, with pack, {"miss_mse",
        "expand"}: over the whole store, summed across the data axis."""
        if not self.family.occupancy:
            raise ValueError(f"{self.family.name} takes no occupancy "
                             "tightening")
        if self.all_nf0 is None:
            self.all_nf0 = self.all_rays[:, 6:8].clone()
        boxes = torch.as_tensor(np.asarray(boxes, np.float32),
                                device=self.device)
        rays = self.all_rays
        hit, t_lo, t_hi = ray_box_hits(
            boxes, torch.cat([rays[:, :6], self.all_nf0], dim=1))
        near0, far0 = self.all_nf0[:, 0], self.all_nf0[:, 1]
        near, far = tighten_intervals(near0, far0, hit, t_lo, t_hi, margin)
        self.all_rays = torch.cat([rays[:, :6], near[:, None], far[:, None]],
                                  dim=1)
        n = self.n_rays_local * self.num_data
        shrink = (1.0 - (far - near) / (far0 - near0)).double().sum()
        n_hit, shrink = pdist.all_reduce_sum(
            [torch.stack([hit.sum().double(), shrink])],
            self.mesh.data_group)[0].tolist()
        stats = {"hit_frac": n_hit / n, "shrink": shrink / n}
        if n_seg > 0:
            occm = ray_box_segment_bits(boxes, self.all_rays, n_seg)
            if dilate > 0:
                occm = dilate_segment_bits(occm, n_seg, dilate)
            self.all_occm, self.family.n_seg = occm, n_seg
        if pack:
            self.all_hit = hit
            stats.update(self._partition_store())
        return stats

    def _partition_store(self):
        """Stable survivors-first order of the shard (the current order
        kept within each class), its survivor count, and the loss the
        packed-out rays of the whole store leave as they are: the mean
        (background - gt)^2. `expand` is the whole store's total over its
        survivors."""
        miss = ~self.all_hit
        bg = 1.0 if self.family.rcfg.white_back else 0.0
        sse = (((self.all_rgbs - bg) ** 2) * miss[:, None]).double().sum()
        n_miss_local = miss.sum()
        self._permute(torch.argsort(miss.to(torch.uint8), stable=True))
        sse, n_miss = pdist.all_reduce_sum(
            [torch.stack([sse, n_miss_local.double()])],
            self.mesh.data_group)[0].tolist()
        self.all_nsurv = self.n_rays_local - int(n_miss_local)
        n_total = self.n_rays_local * self.num_data
        self.pack_expand = n_total / max(n_total - int(n_miss), 1)
        return {"miss_mse": sse / max(n_miss * 3.0, 1e-9),
                "expand": self.pack_expand}

    # --------------------------------------------------------------- state
    def init_state(self, generator: torch.Generator,
                   master_dtype: Optional[torch.dtype] = None) -> TrainState:
        """Params drawn from `generator` (torch.nn.Linear's init), on the
        device, and the optimizer's state at step 0. In a group every rank
        takes rank 0's params, and under tensor parallelism keeps its
        blocks of them; the optimizer's state is made on what the rank
        keeps (every optimizer here is elementwise). master_dtype (e.g.
        torch.bfloat16) casts the stored (master) weights, and the
        optimizer's moments follow them; the kernels run bf16 products
        either way, so it moves only where the update rounds."""
        params = pdist.broadcast_tree(
            self.family.init_params(generator, self.device), self.group)
        if self.tp is not None:
            params = map_with_paths(self.tp.shard_leaf, params)
        if master_dtype is not None:
            params = tree_unflatten(params, [p.to(master_dtype) for p in
                                             tree_leaves(params)])
        return TrainState(params, self.optimizer.init(params), 0)

    # --------------------------------------------------------------- train
    def _columns(self) -> List[str]:
        """A batch's columns: rays, rgbs, the family's, then occm if any."""
        return ["rays", "rgbs", *self.family.columns] + (
            ["occm"] if self.all_occm is not None else [])

    def _sample_batch(self, step):
        """Contiguous block `step % steps_per_epoch` of the store, its
        `_columns`. `step` is an int or a 0-dim integer tensor on the
        store's device (the offset is then computed there, as JAX's
        dynamic_slice takes it). With survivor packing the offset wraps
        over the survivor region [0, K), K = max(nsurv // batch, 1) *
        batch, so an epoch keeps its step count and cycles through the
        survivors."""
        b = self.batch_local
        off = (step % self.steps_per_epoch) * b
        if self.all_nsurv is not None:
            off = off % (max(self.all_nsurv // b, 1) * b)
        idx = off + torch.arange(b, device=self.device)
        return tuple(getattr(self, f"all_{c}").index_select(0, idx)
                     for c in self._columns())

    def _step(self, params, opt_state, step: torch.Tensor, draws,
              inplace: bool = False):
        """One optimizer step on device inputs only: the batch at the
        device step, the given draws, the gradients cast to the master
        dtype (the kernels accumulate f32), the update, and the metrics
        loss, psnr and lr (the schedule at the device step). No host sync,
        so a CUDA graph can capture it. Its phases' marks (`batch` to
        `tail`, profiling.MARKS) launch at each phase's start; the caller
        ends the step with `end`. `inplace` (the step graph's body) lets
        the optimizer write the new state into the given tensors."""
        dev = self.device
        with P.phase("batch", dev):
            batch = dict(zip(self._columns(), self._sample_batch(step)))
        loss, mse, grads = self.family.loss_and_grads(params, draws=draws,
                                                      **batch)
        params, opt_state = optimizer_step(self.optimizer, grads, opt_state,
                                           params, inplace)
        with P.phase("tail", dev):
            # clamp: mse == 0 would give an infinite psnr
            psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
            lr = self.lr_schedule(step)
        return params, opt_state, {"loss": loss, "psnr": psnr, "lr": lr}

    def step_generator(self, seed: int, step: int) -> torch.Generator:
        """The draws of global step `step` on this rank: a function of
        (seed, step, data index), data index 0's of (seed, step) alone."""
        return torch.Generator(device=self.device).manual_seed(
            self._rank_seed(seed, step))

    def _draw_into(self, draws, seed: int, step: int):
        """Fill `draws` in place with step `step`'s draws (in-place
        uniform_ / normal_ give torch.rand's / torch.randn's numbers)."""
        g = self.step_generator(seed, step)
        for name, _, uniform in self.family.draw_specs():
            buf = getattr(draws, name)
            if uniform:
                buf.uniform_(generator=g)
            else:
                buf.normal_(generator=g)

    def step_draws(self, seed: int, step: int):
        """Every random draw of global step `step`: the family's Draws."""
        draws = self.family.Draws(**{
            name: torch.empty(shape, device=self.device)
            for name, shape, _ in self.family.draw_specs()})
        self._draw_into(draws, seed, step)
        return draws

    def run_steps(self, state: TrainState, seed: int, n_steps: int,
                  eager: bool = False
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """n_steps optimizer steps; returns the new state and (n_steps,)
        metric tensors loss, psnr and lr on the device. On CUDA the steps
        replay a captured graph, unless `eager` (a comparison's switch);
        on the CPU they run eagerly. A gloo group's collectives cannot be
        captured, so on CUDA such a group needs `eager`; NCCL's (the data
        and the model group's) are captured with the step. The caller's
        state is never written."""
        if self.device.type == "cuda" and not eager:
            if self.group is not None and \
                    pdist.backend_of(self.group) != "nccl":
                raise RuntimeError(
                    f"run_steps: a {pdist.backend_of(self.group)} group's "
                    "collectives cannot be captured in a CUDA graph; pass "
                    "eager=True to run the steps eagerly")
            return self._run_graph(state, seed, n_steps)
        params, opt_state = state.params, state.opt_state
        metrics: Dict[str, List[torch.Tensor]] = {"loss": [], "psnr": [],
                                                  "lr": []}
        for i in range(n_steps):
            s = state.step + i
            with P.phase("draws", self.device):
                draws = self.step_draws(seed, s)
                counter = torch.full((), s, dtype=torch.int64,
                                     device=self.device)
            params, opt_state, m = self._step(params, opt_state, counter,
                                              draws)
            P.mark("end", self.device)
            for k, v in m.items():
                metrics[k].append(v)
        return (TrainState(params, opt_state, state.step + n_steps),
                {k: torch.stack(v) for k, v in metrics.items()})

    # --------------------------------------------------------- CUDA graph
    def _graph_key(self, state: TrainState):
        """What a captured step has baked in: the store's addresses and
        layout, the state's structure, shapes and dtypes, and the groups
        whose collectives it launches."""
        store = tuple((n, a.data_ptr(), tuple(a.shape))
                      for n, a in self._store_named())
        leaves, spec = pytree.tree_flatten((state.params, state.opt_state))
        return (store, self.family.n_seg, self.all_nsurv, self.steps_per_epoch,
                str(spec), tuple((tuple(t.shape), t.dtype) for t in leaves),
                id(self.mesh.data_group), id(self.mesh.model_group))

    def _run_graph(self, state: TrainState, seed: int, n_steps: int):
        key = self._graph_key(state)
        g = self._graph
        if g is None or g.key != key or g.capacity < n_steps:
            capacity = max(n_steps, _StepGraph.MIN_ROWS,
                           g.capacity if g is not None else 0)
            self._graph = g = None    # free the old graph's pool first
            g = self._graph = _StepGraph(self, state, key, capacity)
            self.captures += 1
        g.load(state)
        replay = (functools.partial(g.traced.replay, self.device)
                  if P.tracing() else g.graph.replay)
        for i in range(n_steps):
            with P.phase("draws", self.device):
                self._draw_into(g.draws, seed, state.step + i)
            replay()
        add_launches({**g.launches, **g.work}, times=n_steps)
        params, opt_state = g.state()
        return (TrainState(params, opt_state, state.step + n_steps),
                {k: v[:n_steps].clone() for k, v in g.metrics.items()})


class _StepGraph:
    """`Trainer._step` captured as a CUDA graph over static buffers: the
    params and optimizer state (the step updates them in place where the
    optimizer can, and the graph copies the rest of each step's new state
    back into them), the device step counter, the metric rows' index, the
    draws and the (capacity,) metric rows. Warm-up steps (the nvcc build at
    first use, autograd's and the allocator's first passes) run on a side
    stream before capture, on these buffers, before any caller's state is
    loaded. Capture runs nothing; it records each kernel wrapper's launch
    once, and those counts (`launches`, and the training kernels' points
    and tile rows, `work`) are taken back and added per replay.

    The step is captured once, with its phases' marks
    (utils/profiling.py): `traced` is its executable with them, replayed
    while a profiler records, and `graph` the same capture with the marks
    taken out, replayed otherwise. So an unprofiled replay runs no mark,
    and a profiled window captures nothing. The warm-up steps launch marks
    only while a profiler records."""

    WARMUP_STEPS = 3
    MIN_ROWS = 1024     # metric rows: segments up to this long share a graph

    def __init__(self, trainer: Trainer, state: TrainState, key,
                 capacity: int):
        dev = trainer.device
        self.key, self.capacity = key, capacity
        leaves, self.spec = pytree.tree_flatten((state.params,
                                                 state.opt_state))
        self.static = [t.detach().clone() for t in leaves]
        # one _foreach_copy_ per dtype: a list that mixes dtypes (the int32
        # counts among f32 leaves) takes the slow path, a copy per tensor
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        self.groups = list(by_dtype.values())
        params, opt_state = pytree.tree_unflatten(self.static, self.spec)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.row = torch.zeros((), dtype=torch.int64, device=dev)
        self.draws = trainer.step_draws(0, 0)
        self.metrics = {k: torch.zeros((capacity,), device=dev)
                        for k in ("loss", "psnr", "lr")}

        def body():
            p, o, m = trainer._step(params, opt_state, self.step,
                                    self.draws, inplace=True)
            self._copy_in(pytree.tree_leaves((p, o)))
            for k, v in m.items():
                self.metrics[k].index_copy_(0, self.row.view(1),
                                            v.detach().float().view(1))
            self.step.add_(1)
            self.row.add_(1)
            P.mark("end", dev)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP_STEPS):
                body()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.row.zero_()
        before = launch_counts(work=True)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with P.recording_marks() as marks, torch.cuda.graph(self.graph):
                body()
        finally:
            recorded = launch_counts(work=True)
            add_launches({k: before[k] - n for k, n in recorded.items()})
        counted = {k: n - before[k] for k, n in recorded.items()
                   if n != before[k]}
        self.launches = {k: n for k, n in counted.items()
                         if k in LAUNCH_COUNTERS}
        self.work = {k: n for k, n in counted.items() if k in WORK_COUNTERS}
        self.traced = P.MarkedGraph(self.graph, marks)
        self.graph.instantiate()

    def _copy_in(self, leaves: List[torch.Tensor]):
        """leaves into the static buffers, but for those that are them."""
        for idx in self.groups:
            idx = [i for i in idx if leaves[i] is not self.static[i]]
            if idx:
                torch._foreach_copy_([self.static[i] for i in idx],
                                     [leaves[i] for i in idx])

    def load(self, state: TrainState):
        """The caller's state into the static buffers, the step counter
        at its step, the metric rows from 0."""
        self._copy_in(pytree.tree_leaves((state.params, state.opt_state)))
        self.step.fill_(state.step)
        self.row.zero_()

    def state(self):
        """Clones of the static (params, opt_state)."""
        return pytree.tree_unflatten([t.clone() for t in self.static],
                                     self.spec)
