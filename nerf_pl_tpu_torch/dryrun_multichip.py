"""A dry run of multi-device training and rendering over N ranks.

    python -m nerf_pl_tpu_torch.dryrun_multichip N [--device cpu|cuda]

Port of `dryrun_multichip` (__graft_entry__.py:52-264). It starts N ranks
(`dist.launch`) on the card (cuda, the default; without a CUDA device it
raises) or, with --device cpu, as gloo ranks on the CPU. On the card a
rank takes a card over NCCL, or, with more ranks than cards, ranks share
the cards over gloo, whose steps then run eagerly (a gloo collective
cannot be captured in a CUDA graph). The phases are the JAX dry run's, at
its tiny shapes (8 coarse samples, 16 rays a data index a step), on the
flagship model. As in JAX, phases 1 and 4 run on a dp x tp = (N/2, 2)
mesh with the MLPs split over its model axis when N >= 4 and N is even,
and data parallel over N otherwise; phases 2, 3 and 5 are data parallel
over N:

  1. one plain step (autograd over the unfused render);
  2. one loss-fused step at 8 + 8 samples with occ_keepalive 0.1;
  3. the store tightened to one box (pack, 32 segments, dilate 1), a
     reshuffle and a loss-fused step;
  4. a resume: 2 steps, a checkpoint rank 0 writes (the state gathered
     over the model axis), a fresh trainer that loads it (each rank its
     blocks) and 2 more steps give the loss stream of 4 uninterrupted
     steps;
  5. the sharded full-image render against one process's render of the
     same rays, and the culled renderer sharded against one process's, on
     the rays that hit its box.

Rank 0 prints one `[dryrun_multichip] ... ok` line a phase; a phase that
fails raises in its rank, and the command fails.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from . import dist as pdist

BOX = [[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]]
TIMEOUT = 300.0     # seconds the ranks may take together


def _store(n: int):
    rng = np.random.default_rng(0)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0, np.float32),
                           np.full((n, 1), 6.0, np.float32)], 1)
    return rays, rng.random((n, 3)).astype(np.float32)


def _dryrun_rank(group, device):
    from .parallel import Trainer, make_render_fn
    from .rendering import (CulledRenderer, ModelConfig, OccupancyGrid,
                            RenderConfig, render_rays_chunked)
    from .rendering.occupancy import ray_box_hits
    from .training import get_lr_schedule, get_optimizer, loss_dict
    from .training.checkpoints import (gather_state, load_checkpoint,
                                       save_checkpoint)

    world = pdist.world_of(group)
    num_model = 2 if world >= 4 and world % 2 == 0 else 1
    tp = num_model > 1
    main = pdist.is_main(group)
    backend = pdist.backend_of(group)
    eager = device.type == "cuda" and backend != "nccl"

    def say(msg):
        if main:
            print(f"[dryrun_multichip] {msg}", flush=True)

    def finite(x, what):
        if not np.isfinite(x):
            raise AssertionError(f"non-finite {what} {x}")
        return x

    mcfg = ModelConfig()
    sched = get_lr_schedule("steplr", 5e-4, 2, 4, decay_step=[2])
    opt = get_optimizer("adam", sched)
    rays, rgbs = _store(64 * (world // num_model))   # JAX's 64 * n_data

    def trainer(rcfg, mesh_model=1):
        """Over the world: dp, or dp x tp with a model axis of 2; 16 rays
        a data index a step."""
        tr = Trainer(mcfg, rcfg, opt, sched, loss_dict["mse"],
                     16 * (world // mesh_model), device, group=group,
                     num_model=mesh_model, tensor_parallel=mesh_model > 1)
        tr.set_data(rays, rgbs)
        return tr

    def run(tr, state, seed, n):
        state, m = tr.run_steps(state, seed, n, eager=eager)
        return state, m["loss"].cpu().numpy()

    # 1: a plain step
    rcfg = RenderConfig(N_samples=8, N_importance=4, perturb=1.0,
                        noise_std=1.0, white_back=True)
    tr = trainer(rcfg, num_model)
    state = tr.init_state(torch.Generator().manual_seed(0))
    _, losses = run(tr, state, 1, 1)
    say(f"n={world} mesh={tr.mesh.shape} tp={tp} {backend} on {device} "
        f"(steps {'eager' if eager or device.type == 'cpu' else 'graph'}) "
        f"loss={finite(losses[-1], 'loss'):.4f} ok")

    # 2: the loss-fused step
    rcfg_f = RenderConfig(N_samples=8, N_importance=8, perturb=1.0,
                          noise_std=1.0, white_back=True, fused_train=True,
                          fused_loss=True, occ_keepalive=0.1)
    tr_f = trainer(rcfg_f)
    state_f = tr_f.init_state(torch.Generator().manual_seed(2))
    state_f, losses = run(tr_f, state_f, 3, 1)
    say(f"fused_loss dp={world} loss={finite(losses[-1], 'loss'):.4f} ok")

    # 3: tighten, reshuffle, a step
    st = tr_f.tighten_store(np.asarray(BOX, np.float32), margin=0.1,
                            n_seg=32, dilate=1, pack=True)
    if tr_f.all_occm is None:
        raise AssertionError("tighten_store kept no segment masks")
    tr_f.reshuffle(5)
    state_f, losses = run(tr_f, state_f, 6, 1)
    say(f"occ_tighten dp={world} hit={st['hit_frac']:.2f} "
        f"shrink={st['shrink']:.2f} loss={finite(losses[-1], 'loss'):.4f} "
        "ok")

    # 4: a resume continues the stream of an uninterrupted run
    ckpt_dir = pdist.broadcast_object(
        tempfile.mkdtemp(prefix="dryrun_") if main else None, group)
    ckpt = os.path.join(ckpt_dir, "mid.ckpt")

    def segments(splits, save=False, restore=False):
        tr_r = trainer(rcfg, num_model)
        state_r = tr_r.init_state(torch.Generator().manual_seed(7))
        if restore:
            state_r, _ = load_checkpoint(ckpt, state_r, tp=tr_r.tp)
        out = []
        for k in splits:
            state_r, losses = run(tr_r, state_r, 8, k)
            out.extend(losses.tolist())
        if save:
            whole = gather_state(state_r, tr_r.tp)
            if main:
                save_checkpoint(ckpt, whole, {"step": state_r.step})
            pdist.barrier(group)
        return out, state_r

    full, _ = segments([4])
    head, _ = segments([2], save=True)
    tail, resumed = segments([2], restore=True)
    pdist.barrier(group)
    if main:
        os.remove(ckpt)
        os.rmdir(ckpt_dir)
    np.testing.assert_allclose(head + tail, full, rtol=1e-5)
    if resumed.step != 4:
        raise AssertionError(f"resumed at step {resumed.step}, not 4")
    say(f"resume dp={tr.mesh.num_data} mesh={tr.mesh.shape} tp={tp} "
        f"continued-stream == uninterrupted ({[round(v, 4) for v in full]}) "
        "ok")

    # 5: sharded renders against one process's
    rcfg_eval = RenderConfig(N_samples=8, N_importance=4, test_time=True,
                             white_back=True)
    params = state_f.params
    rays_t = torch.from_numpy(rays).to(device)
    out_m = make_render_fn(rcfg_eval, 16, device, mcfg, device_out=True,
                           group=group)(params, rays_t)
    out_1 = render_rays_chunked(params, rays_t, rcfg_eval, mcfg, chunk=16)
    err = float((out_m["rgb_fine"] - out_1["rgb_fine"]).abs().max())
    if err > 1e-4:
        raise AssertionError(f"sharded render differs by {err}")
    mse = float(((out_m["rgb_fine"] - out_1["rgb_fine"]) ** 2).mean())
    occ = OccupancyGrid(boxes=np.asarray(BOX, np.float32),
                        block_map=np.ones((1, 1, 1), np.uint8),
                        lo=np.full(3, -1.5, np.float32),
                        hi=np.full(3, 1.5, np.float32))
    out_c, st_c = CulledRenderer(occ, rcfg_eval, mcfg, chunk=16,
                                 device=device, group=group)(
        params, rays_t, return_stats=True)
    out_c1, st_c1 = CulledRenderer(occ, rcfg_eval, mcfg, chunk=16,
                                   device=device)(params, rays_t,
                                                  return_stats=True)
    if st_c["n_survivors"] != st_c1["n_survivors"]:
        raise AssertionError(f"survivors {st_c} against {st_c1}")
    # on the rays that hit the box: culled rays may or may not fall in a
    # tile's rounding spill, as in the JAX dry run
    hit = ray_box_hits(torch.as_tensor(occ.boxes, device=device), rays_t)[0]
    np.testing.assert_allclose(out_c["rgb_fine"][hit].cpu().numpy(),
                               out_c1["rgb_fine"][hit].cpu().numpy(),
                               atol=5e-3, rtol=5e-3)
    say(f"eval/render dp={world} sharded==single (mse={mse:.2e}); culled "
        f"dp={world} survivors={st_c['n_survivors']}/{st_c['n_rays']} ok")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", choices=("cpu", "cuda"),
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    kind, _ = pdist.plan_world(args.n, args.device)    # raises without CUDA
    pdist.launch(_dryrun_rank, args.n, device=kind, timeout=TIMEOUT)


if __name__ == "__main__":
    main()
