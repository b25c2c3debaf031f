"""Data parallel over torch.distributed: one process per rank.

The port's counterpart of the JAX package's `make_mesh`
(nerf_pl_tpu/parallel/mesh.py) for its `data` axis. Where the JAX package
runs one process over a mesh and lets `shard_map` and `psum` move the data,
the port runs one process per rank, and a process group carries the
reductions. The mesh's `model` axis (tensor parallelism) is laid over
the same world by `parallel/mesh.py`.

  * `plan_world`: the world a CLI asks for. On the card it is
    min(requested, torch.cuda.device_count()), one card per rank over
    NCCL, as the JAX package takes min(--num_gpus, len(jax.devices())); on
    the CPU it is the requested count of gloo ranks.
  * `launch`: starts the ranks with torch.multiprocessing (start method
    spawn), which meet at a `file://` rendezvous in a temporary directory,
    so that concurrent launches cannot collide on a port. Ranks share the
    cards round-robin when there are more ranks than cards, and then talk
    over gloo (NCCL rejects two ranks on one card). A rank that raises or
    exits makes the launcher raise with its traceback. A launch waits for
    its ranks with no deadline unless the caller gives one (`timeout`),
    since a training run may take hours; a rank stuck in a collective
    fails after `GROUP_TIMEOUT`, and so ends the launch. The kernels are
    built in the launching process first, so the ranks only load them.
  * `all_reduce_tree`, `broadcast_tree`, `gather_rows`: the collectives
    over trees of tensors, one collective per dtype (the leaves of a dtype
    go through one flat buffer).

Everything here takes `group=None` as a world of one and then runs no
collective at all, so the single-device code paths are unchanged.
"""
from __future__ import annotations

import datetime
import glob
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

GROUP_TIMEOUT = 900.0       # seconds a group's rendezvous and collectives
RANK_THREADS = 2            # intra-op threads of a rank on the CPU


# ------------------------------------------------------------- the world

def world_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def is_main(group) -> bool:
    return rank_of(group) == 0


def backend_of(group) -> Optional[str]:
    return None if group is None else dist.get_backend(group)


def plan_world(requested: int, device: Optional[torch.device | str] = None
               ) -> Tuple[str, int]:
    """(device kind, world) of a CLI's --num_gpus / --num_chips: on the
    card (no device given, or a CUDA one) min(requested, device count),
    raising without CUDA; on the CPU (device="cpu") the requested count."""
    kind = "cuda" if device is None else torch.device(device).type
    requested = max(int(requested), 1)
    if kind == "cpu":
        return "cpu", requested
    if kind != "cuda":
        raise ValueError(f"no data parallel world on a {kind} device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false. Pass device='cpu' to run on the CPU.")
    return "cuda", min(requested, torch.cuda.device_count())


def rank_plan(kind: str, world: int) -> Tuple[str, List[torch.device]]:
    """(backend, the device of each rank): gloo on the CPU; on the card
    NCCL with a card a rank, or gloo when ranks must share cards
    (round-robin)."""
    if kind == "cpu":
        return "gloo", [torch.device("cpu")] * world
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for a CUDA launch")
    devices = [torch.device("cuda", r % n) for r in range(world)]
    return ("nccl" if world <= n else "gloo"), devices


def init_group(rank: int, world: int, init_method: str, backend: str,
               device: torch.device):
    """Join the default process group as `rank` of `world`; returns it.
    NCCL ranks name their card, so that the communicator is bound to it."""
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT), **kw)
    return dist.group.WORLD


def barrier(group) -> None:
    if group is None:
        return
    if backend_of(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


# ---------------------------------------------------------- collectives

def _reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    """Half-width floats are summed in f32 (gloo may lack them)."""
    return torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[Any, List[int]]:
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return groups


def _flat_collective(tensors: Sequence[torch.Tensor], op: Callable
                     ) -> List[torch.Tensor]:
    """op(flat buffer) on one flat buffer per dtype (and device); the
    tensors come back in their shapes and dtypes."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for (dtype, _), idx in _by_dtype(tensors).items():
        flat = torch.cat([tensors[i].reshape(-1).to(_reduce_dtype(dtype))
                          for i in idx])
        op(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape).to(dtype)
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], group
                   ) -> List[torch.Tensor]:
    """The sum across ranks of each tensor (new tensors); without a group
    the tensors themselves."""
    if group is None:
        return list(tensors)
    return _flat_collective(
        tensors, lambda flat: dist.all_reduce(flat, dist.ReduceOp.SUM,
                                              group=group))


def all_reduce_tree(tree, group):
    """all_reduce_sum over every tensor leaf of a tree (dicts, tuples,
    NamedTuples, lists)."""
    if group is None:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(all_reduce_sum(leaves, group), spec)


def broadcast_tree(tree, group, src: int = 0):
    """Rank src's tensor leaves on every rank (new tensors)."""
    if group is None:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    src_global = dist.get_global_rank(group, src)
    return pytree.tree_unflatten(_flat_collective(
        leaves, lambda flat: dist.broadcast(flat, src_global, group=group)),
        spec)


def broadcast_object(obj, group, src: int = 0):
    """Rank src's picklable object on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]


def gather_rows(local: Dict[str, torch.Tensor], group
                ) -> Dict[str, torch.Tensor]:
    """Every rank's rows of each tensor, concatenated in rank order, on
    every rank. Each rank writes its block into a zero buffer and the
    buffers are summed (a block plus zeros is the block, bit for bit), so
    the one code path serves NCCL and gloo, on the card and on the CPU.
    Every rank must give the same keys and row counts."""
    if group is None:
        return dict(local)
    world, rank = world_of(group), rank_of(group)
    keys = list(local)
    bufs = []
    for k in keys:
        t = local[k]
        n = t.shape[0]
        buf = t.new_zeros((world * n,) + tuple(t.shape[1:]))
        buf[rank * n:(rank + 1) * n] = t
        bufs.append(buf)
    return dict(zip(keys, all_reduce_sum(bufs, group)))


# ------------------------------------------------------------- launcher

def _rank_main(rank: int, fn: Callable, world: int, init_method: str,
               backend: str, devices: List[torch.device], out_dir: str,
               args: Tuple) -> None:
    """The body of one spawned rank: join the group, run
    fn(group, device, *args), save what it returns, leave the group. A
    failure leaves its time and traceback in error.<rank>.txt."""
    try:
        device = devices[rank]
        if device.type == "cpu":
            torch.set_num_threads(RANK_THREADS)
        else:
            torch.cuda.set_device(device)
        group = init_group(rank, world, init_method, backend, device)
        try:
            result = fn(group, device, *args)
            torch.save(result, os.path.join(out_dir, f"result.{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error.{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise


def _rank_errors(out_dir: str) -> str:
    """The ranks' tracebacks, the first failure first: a rank whose peer
    died fails too, in a collective, after it."""
    errors = []
    for path in glob.glob(os.path.join(out_dir, "error.*.txt")):
        with open(path) as f:
            when, tb = f.read().split("\n", 1)
        errors.append((float(when), path.split(".")[-2], tb))
    return "\n".join(f"-- rank {rank} failed:\n{tb}"
                     for _, rank, tb in sorted(errors))


def launch(fn: Callable, world: int, *args, device: str = "cpu",
           timeout: Optional[float] = None) -> List[Any]:
    """Run fn(group, device, *args) in `world` spawned ranks; returns what
    each rank's fn returned, by rank (loaded onto the CPU). `fn` must be
    importable by its module's name (spawn pickles it by reference), and
    so must what it returns. device: "cpu" (gloo ranks) or "cuda"
    (`rank_plan`). Raises if a rank raises or exits, with its traceback,
    or, given a `timeout`, when that many seconds pass (None: no
    deadline); no rank outlives the call."""
    import torch.multiprocessing as mp

    backend, devices = rank_plan(device, world)
    if device == "cuda":
        from .ops import _build
        _build.build()      # once, before the ranks load it
    with tempfile.TemporaryDirectory(prefix="nerf_dist_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, init, backend, devices, tmp, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        failure = None
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks of {fn.__name__} did not finish in "
                        f"{timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            failure = e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        if failure is not None:
            raise RuntimeError(
                f"{fn.__name__} failed in its ranks:\n"
                f"{_rank_errors(tmp) or failure}") from failure
        return [torch.load(os.path.join(tmp, f"result.{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
