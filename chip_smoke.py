#!/usr/bin/env python
"""Smoke run of the PyTorch port (nerf_pl_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py

1. Prints the card (torch and nvidia-smi); without a CUDA device it fails.
2. Builds the kernels from csrc/ (first use; one nvcc per source, all at
   once) and prints the seconds and ptxas's registers and spills.
3. Eval path. Holds each render kernel against its plain PyTorch version
   on the card, at ragged R = 4099 and KERNEL_S (the dense passes' S = 64,
   128, 192 and the culled renderer's buckets: sigma_render 16 and 32,
   render_eval 32, 48 and 96), with the JAX kernels' test bars (weights
   5e-3, rgb and opacity 1e-2, depth 5e-2), and render_eval against
   train_fwd on a zero noise tensor at every one of those S, white
   background on and off: rgb, depth and opacity bit for bit
   out8[:, 0:5] (render_eval is train_fwd's forward tile loop and
   quadrature with no noise); likewise sigma_render's weights and opacity
   bit for bit train_fwd's weights and out8[:, 4] (sigma_render is
   train_fwd's trunk and the weight part of its quadrature; the max
   difference is printed). Times both render kernels at the main
   path's tile (32768 rays) with CUDA events, and each alone at a culled
   tile of 8192 rays and its buckets' S. Then drives the eval path:
   random weights from a torch.Generator seed are written as a checkpoint
   with the JAX package's keys, loaded back with load_ckpt, and 2 frames
   of 400x400 at 64 + 64 samples and 2 of 800x800 at 64 + 128 (eval.py's
   defaults; the first of each a warm-up) are rendered from sphere poses
   (radius 4, near 2, far 6) through make_render_fn, the renderer of the
   eval CLI, and the s/frame of both printed. Every output must be finite,
   opacity within [0, 1 + 1e-4], both kernels must have launched, and
   4096 rays of the first frame of each size must agree with the plain
   unfused path on the card within 2e-2.
4. Train path. Holds the training kernel (mse_render) against its plain
   version at TRAIN_SHAPES (R = 8, 1024, 4104 at S = 64, 128, 192 and at
   culled32's S = 32 and 96; R, S = 5, 400 and 3, 1024): out8 and
   weights at the same bars, each gradient leaf within a relative max
   error of GRAD_TOL = 0.03 (the bar of tests/test_fused_train.py::
   TestGradientParity: a flipped bf16 rounding or ReLU mask moves every
   product downstream of it), and two launches bit-identical. Times both
   at R = 1024, S = 32, 64, 96 and 128 (the coarse and fine passes of the
   dense and culled32 configs), each line with the kernel's padding share
   (1 - R S over launch A's tile rows, nerf_ray_tile_rows) and its share of
   the bound's rate. Then a
   teacher (fixed random weights) renders 4 frames of 400x400 through the
   fused eval path, and a Trainer at the dense bench config (64 + 64,
   batch 1024, perturb 1, noise 1, white background, adam 5e-4, steplr
   decay [2, 4, 8] x 0.5) fits that 640,000-ray store: 50 warm-up steps,
   then three timed segments of 100 steps, each ending in a sync on a
   parameter (run_steps replays the captured step, 9). Requires finite
   metrics, a mean loss over the last 50 steps below the first 50,
   exactly 2 mse_render launches and 1 adam launch per step launched, and
   on one
   batch gradients of the fused step pointing the way the plain autograd
   step's do with the same draws (cosine >= 0.95 per leaf, the bar of
   test_grad_direction_vs_f32_reference, the cosine taken in float64)
   at the final parameters. Prints train rays/s.
   Occupancy: the grid build of --occ_train at occ_N 128 on the teacher's
   fine weights (auto ranges in the store's viewing volume), in sigma
   mode and in weight mode with the store as the visibility rays (boxes,
   occupied share, seconds), then tighten_store of the culled recipe with
   the weight-mode boxes on the card and on a CPU copy of the store: the
   masks, hit flags, tightened near/far and partition order must agree
   for every ray. Then culled32, bench's default recipe: a Trainer at 32 +
   64 samples (otherwise the dense config) on the store tightened as
   bench.py tightens it (the box [-1.5, 1.5]^3, margin 0.1, 32 segments,
   dilate 1, survivor-packed; hit, shrink and expand printed) trains the
   same 350 steps under the same checks, with the segment masks in the
   gradient comparison, which takes the parameters after the warm-up
   (by the end its loss is ~5e-6, and its coarse gradient is what bf16
   rounding leaves of terms that cancel). Prints rays/s and the effective
   rate.
   Adam ([adam]): the one-launch update (csrc/adam.cu) against the
   foreach chain it replaces (update, then apply_updates) on the dense
   recipe's 48 leaves, 1,191,688 parameters, with unpack_grads' strided
   gradients: 5 steplr steps out of place and 5 in place, every leaf of
   the params, moments and counts bit for bit; then the device ms a step
   of each over 50 profiled steps (the kernel's launch alone, and with
   the schedule's and counts' scalar ops), each step after a write of
   256 MB that leaves none of its 33.4 MB in the 50 MB L2, as a training
   step's kernels leave it (the write's own time not counted); beside
   them, for the kernels line's library_ms only, torch._fused_adam_'s one
   call over the same leaves (contiguous gradients), which the port does
   not call: its rounding is not optax's order. The kernels line's adam
   launches are the loss-fused train path's, its max_abs_err the largest
   |kernel - chain| over the compared leaves. Then the same on mip-NeRF
   360's 34 leaves at published widths (init_mip_params, ~8.0 M
   parameters; the 1- and 3-column heads' gradients column slices of
   8-column ones, as its step gives them) with its global-norm clip of
   1e-3 and eps 1e-6: the kernel reading the clip's factor from the
   device against the clipped chain, bit for bit out of place and in
   place, its ms and its [bound] line (28 bytes a parameter).
   mip-NeRF 360's ReLU backward ([relu_bgrad]): the one launch pair of
   csrc/relu_bgrad.cu at the cell's four shapes (524,288 x 1024, the
   same with the gradient a 1024-column view of 1096-wide rows, 524,288 x
   128 and a proposal level's 1,048,576 x 256), on a gradient of mean 1
   (so that a column's |sum g| is near its sum |g|): g bit for bit
   threshold_backward's and db within 1e-5 of sum |g| of a float64
   column sum, per column, a bar that db rounded to bf16 must fail; then
   the kernel's ms (10 launches an event pair, so the wrapper's host time
   hides behind the device's), its bound (6 bytes a value), its share,
   the plain version's ms and, as library_ms, threshold_backward +
   sum(0), which the port no longer calls; and the sum over a step's 17
   layers. Then mip-NeRF 360's training step ([mip]): the benchmark's
   mipnerf360_outdoor.train16k at published widths and its batch of
   16,384 rays (its store cut to 262,144 rays) through Trainer.run_steps,
   3 steps in one capture and its replays, the counts zeroed just before:
   a finite loss and 17 relu_bgrad launch pairs and one adam launch a
   step, no other kernel. The kernels line's relu_bgrad launches are this
   run's.
5. Point-MLP path (`--fused_mlp` training). Holds the three point-MLP
   kernels against their plain versions at ragged P = 300, 4099 and
   131,075 with the weights of dense_params and of plain init: rgb within
   5e-3, raw sigma within 5e-3 x max(1, max |sigma|) (the x50 sigma head
   scales it), sigma_fwd's sigma bit for bit mlp_fwd's out8[:, 3] (the
   same trunk tile loop; the max difference is printed), each mlp_bwd
   gradient leaf within GRAD_TOL and two launches bit-identical. Times
   mlp_fwd and mlp_bwd at P = 65,536 and 131,072 (a dense step's coarse
   and fine pass) and sigma_fwd at 32768 x 64 points.
   Then a Trainer at the dense bench config with fused=True and no
   fused_train (autograd through fused_nerf_mlp) fits the same store as in
   4 for the same 350 steps: exactly 2 mlp_fwd and 2 mlp_bwd launches per
   step and no other kernel, the loss falling, and the gradient cosine >=
   0.95 per leaf against the plain autograd step. Prints train rays/s.
6. The validation config of --fused_mlp (make_render_fn with fused and
   test_time off, as NeRFSystem validates) renders one 400x400 frame at
   64 + 64 through mlp_fwd alone; rgb_coarse and rgb_fine finite and within
   2e-2 of the plain unfused path on 4096 of its rays. A test-time render
   with perturb 1 and sigma noise 1 (explicit draws) on those rays launches
   sigma_fwd (coarse) and mlp_fwd (fine) once each and agrees within 2e-2
   (depth 5e-2) with the unfused path on the same draws. Both are held at
   the 99.5th percentile over rays, with at most 4 of the 4096 rays past
   the bar and none past a loose cap (0.25, depth 1.0): a ray
   whose importance samples move past a sharp feature of the random dense
   field (or, with noise, past a coarse depth, which shifts the noise
   slots) can jump between two implementations that differ in one bf16
   rounding; the plain bf16 version on the CPU jumps on the same rays.
7. The train CLI with --fused_mlp alone, in a process of its own as a user
   runs it, on the 40x40 synthetic scene (12 views, 32 + 16 samples,
   batch 1024, lr 5e-4, 10 epochs, in a temporary directory): val/psnr past
   20 dB by epoch 10, `last.ckpt` written, and a second process resumes
   from it for one more epoch. On that checkpoint (a field with empty
   space around the sphere), the occupancy-culled renderer ([culled]): 4
   frames of 800x800 at 64 + 128 from sphere poses in one dispatch, the
   weight-mode grid at occ_N 128 built on their rays and then loaded from
   the port's cache file, and the ladder dense (make_render_fn, chunk
   32768), cull, +tighten, +budgets, +segments 32 (base tile 8192), each
   timed over 2 dispatches after a warm-up; prints s/frame, the survivor,
   rendered and bucket counts, the split of one more dispatch (a
   torch.profiler window read by nerfbench/metrics/_spans.py: each phase's
   device ms, busy and idle, and the cull and bucket host spans) and the
   launches, and holds: finite outputs, opacity
   in [0, 1 + 1e-4], one sigma_render and one render_eval launch a tile
   rendered, rows no tile renders exactly white background, 4096 rays of
   frame 1 rendered again through the same renderer with the render
   kernels' plain versions, on their survivors (ray_errors' rule; the
   unfused f32 path's distance from both is printed), and the cull rung
   against dense (its rendered rows within the kernel bars, the image
   within mse 1e-4, the bar of tests/test_occupancy.py); the other rungs'
   PSNR against dense is printed. Then the eval CLI on the scene's test
   split, each run in a process of its own: dense (--fused_mlp), the
   culled stack (--occ_grid --occ_mode weight --occ_tighten --occ_budgets
   --occ_segments 32) twice, the first building the grid and the second
   loading it, past 20 dB, and --occ_grid alone within 0.05 dB of dense.
   Then mesh extraction on that checkpoint ([mesh]; the plain f32 MLP, no
   kernel, as in the JAX package): the mesh CLI at N_grid 256 over +-1.3
   at --sigma_threshold MESH_SIGMA, in a process of its own, with the
   default fusion and --export_vol, and with --use_vertex_normal
   --mesh_format dae: each mesh read back with triangles, finite vertices
   and colours, its median vertex radius in [0.8, 1.2], the .vol
   non-empty. In-process on the card, each timed from a sync to a sync:
   make_grid and query_grid (16.8 M points), marching cubes + the largest
   cluster, the fusion over the 12 views (and one view's occlusion render
   alone) and the vertex-normal render at 64 + 64; none of the eight
   kernels may launch. Card against CPU at N_grid 64: sigma within 1e-4
   of max(1, max |sigma|), the same triangles with vertices within 0.01
   cells, and occlusion opacity on 2048 vertex rays of one view within
   1e-3 (flips at 0.2 printed).
   Then the same train recipe with --fused_train,
   dense and with the culled stack (--occ_train --occ_warmup_epochs 2
   --occ_refresh_epochs 2 --occ_segments 32 --occ_dilate 1 --occ_pack
   --occ_mode weight): the culled run's [occ] lines (a packed one among
   them) and val/psnr past 20 dB by epoch 10, beside the dense run's.
8. Two-kernel fused training render (`fused_train` without the loss-fused
   step: autograd through fused_train_render). Holds train_fwd and
   train_bwd against their plain versions at TRAIN_SHAPES (those of 4;
   at R, S = 5, 400 and 3, 1024 launch A's ring drops to two stages):
   out8 and weights at
   TOL, and every train_bwd gradient leaf within GRAD_TOL under four
   cotangent mixes (the rgb MSE on a white background, depth^2 + 0.3
   opacity and mean(weights^2) on black, and the sum of the three on
   white; the leaves whose terms cancel, TERMS_HELD, are held to GRAD_TOL
   of their largest sum of |terms|: layer 0's sin/cos rows under
   mean(weights^2) at R, S = 1024, 32 and the sigma head's weight and bias
   under the rgb MSE at R = 8, S = 32 and 96; the noise and ground truth
   of every case come from a CPU generator),
   two launches of each bit-identical, train_fwd's out8 and
   weights bit for bit equal to mse_render's (the same forward and
   quadrature; the max difference is printed), and train_bwd on the MSE
   cotangent within 1e-3 relative of mse_render's gradients (the same
   launch A; printed whether bit for bit). Times both and their
   plain versions at R = 1024, S = 64 and 128. Then a Trainer at the dense
   bench config with RenderConfig(fused_train=True) fits the store of 4
   for the same 350 steps: exactly 2 train_fwd and 2 train_bwd launches
   per step and no other kernel, the loss falling, and the gradient cosine
   >= 0.95 per leaf against the plain autograd step. Prints train rays/s.
9. The step as a CUDA graph (Trainer.run_steps on the card replays one
   captured step). On the four training paths (loss-fused, culled32
   packed, fused_train, --fused_mlp), two trainers from one initial state
   on a store of 40 batches (the teacher store's first rays) run a
   segment of one epoch, the epoch's reshuffle and 12 steps more, one
   replayed, one eager (run_steps(eager=True)), on the same draws:
   params, Adam state and metrics must be bit-identical, the graph
   captured once across the in-place reshuffle, culled32's survivors
   fewer batches than an epoch (its offset wraps), and the launches those
   of the steps run (a capture's 3 warm-up steps among them). Then each
   runs 100 steps eager, graph, graph, eager, and 10 profiled steps a
   mode: wall ms/step, rays/s, device ms/step and the idle share, with
   the card's name and power limit; in the profiled steps the device's
   own count of each kernel's launches must equal the wrappers' count
   (under the graph, the capture's launches times the replays). In 4, 5 and 8 (run_steps replayed)
   the launch checks count each capture's warm-up steps the same way. A
   ranger run and an Adam run on bf16 master weights, 60 replayed
   loss-fused steps each, must descend (masters still bf16), and in a
   process of its own a step that reads a value back to the host under
   capture must make run_steps raise, not fall back to eager steps.
   Data parallel ([dp], after the descent runs): two ranks share cuda:0
   over gloo (the kernels built once, before they start): the dry run's
   five phases (python -m nerf_pl_tpu_torch.dryrun_multichip 2 --device
   cuda); 20 eager loss-fused steps at the dense bench config (global
   batch 1024, 512 a rank), each step's all-reduced gradients held
   against the sum of the two shards' one-process kernel gradients (bit
   for bit expected; else each leaf within GRAD_TOL of its largest sum
   of |terms|, the gap printed), 2 mse_render launches a step a rank, the
   params and losses of both ranks bit for bit at the end; a 400x400
   frame at 64 + 64 rendered sharded, dense (chunk 32768) and culled
   (tighten, budgets, 32 segments, base tile 8192, the box of bench's
   culled recipes), one sigma_render and one render_eval launch a tile a
   rank, against one process's render (bit for bit expected, else within
   the kernel bars; the culled on the rays that hit the box, with the
   same survivors). Then one rank in an NCCL group: its replayed graph,
   the all-reduce captured in it, bit for bit the no-group graph's over
   an epoch, its reshuffle and 12 steps more, one capture each, and 100
   replayed steps of each timed in turns. Two ranks on one card say
   nothing of scaling; the wall times printed are labelled so.
   Tensor parallel ([tp]): two gloo ranks share cuda:0 as a dp x tp =
   (1, 2) mesh (Trainer(num_model=2, tensor_parallel=True), eager steps,
   TF32 off): 5 plain (unfused) steps at the dense bench config held
   against the one-process trainer with no model axis (losses within
   rtol 2e-4, the final xyz_0.w within atol 2e-5: the bars of
   tests/test_spmd.py::test_tp_matches_dp_numerics); one step each on the
   `fused` (mlp_fwd, mlp_bwd) and `fused_train` (train_fwd, train_bwd)
   routes, 2 launches of each kernel a rank, the gathered gradients held
   to GRAD_TOL per leaf against the one-process step on the same batch
   and draws (bit for bit expected: every rank runs the kernels on the
   gathered whole weights); each rank's blocks equal the slices of the
   gathered params, after init and after the steps. Then the dry run over
   4 gloo ranks sharing the card (python -m
   nerf_pl_tpu_torch.dryrun_multichip 4 --device cuda): five ok lines,
   phases 1 and 4 on the (2, 2) mesh with tp=True.
   The bench ([bench]): python -m nerf_pl_tpu_torch.bench's main, at its
   full size (the 16,000,000-ray store, a 400-step warm-up segment and
   three timed ones, best of 3), for --config dense, culled48 and
   culled32, and culled32 with --precision bfloat16: each one's JSON
   line, its spread and the card's name and power limit printed, finite
   losses, and exactly 2 mse_render launches a step (the capture's 3
   warm-up steps among them).
10. Prints one JSON line about the kernels (each with its launches on its
   paths, sigma_render's and render_eval's on the eval path and the
   [culled] ladder together, its error, its ms and its plain version's at
   the main shape, its
   bound: the larger of the bytes it must move over 3.35 TB/s and its
   bf16 operations over 989 TFLOP/s (nerfbench/work.py's
   flops_per_point); adam's is its
   28 bytes a parameter, its plain version the foreach chain; relu_bgrad's
   its 6 bytes a value at (524,288, 1024), its launches the [mip] step's),
   and
   library_ms, null: no single PyTorch call computes a fused NeRF MLP with
   its quadrature or its gradients, and the port uses no fused optimizer
   of PyTorch's; adam's torch._fused_adam_, relu_bgrad's threshold_backward
   + sum(0)), mse_render's [bound] lines at culled32's (1024, 32) and
   (1024, 96), the nvidia-smi line, and last {"ok": true, "device": ...}.
Any failure raises, and the script exits non-zero without those lines.
"""
import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nerf_pl_tpu_torch.datasets import dataset_dict  # noqa: E402
from nerf_pl_tpu_torch.datasets.rays import frame_rays, sphere_pose  # noqa: E402
from nerf_pl_tpu_torch.mesh.dae import read_dae  # noqa: E402
from nerf_pl_tpu_torch.mesh.extract import (  # noqa: E402
    compute_vertex_normals, fuse_colors_by_projection, grid_to_world,
    make_grid, occlusion_opacity, query_grid)
from nerf_pl_tpu_torch.mesh.native import (keep_largest_cluster,  # noqa: E402
                                           marching_cubes)
from nerf_pl_tpu_torch.mesh.ply import read_ply  # noqa: E402
from nerf_pl_tpu_torch.models import (init_nerf_params,  # noqa: E402
                                      params_from_numpy)
from nerf_pl_tpu_torch.models.mipnerf360 import (  # noqa: E402
    MipConfig, init_mip_params)
from nerf_pl_tpu_torch.ops import _build  # noqa: E402
from nerf_pl_tpu_torch.ops import (add_launches, by_symbol,  # noqa: E402
                                   device_events, device_ms,
                                   kernel_events, launch_counts)
from nerf_pl_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_render as fr  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_train as ft  # noqa: E402
from nerf_pl_tpu_torch import bench  # noqa: E402
from nerf_pl_tpu_torch import dist as pdist  # noqa: E402
from nerf_pl_tpu_torch import dryrun_multichip  # noqa: E402
from nerf_pl_tpu_torch.parallel import Trainer, make_render_fn  # noqa: E402
from nerf_pl_tpu_torch.parallel.spmd import _StepGraph, seed_for  # noqa: E402
from nerf_pl_tpu_torch.rendering import (CulledRenderer,  # noqa: E402
                                         ModelConfig, OccupancyGrid,
                                         RenderConfig,
                                         TrainDraws, load_or_build_grid,
                                         render_rays, render_rays_chunked)
from nerf_pl_tpu_torch.rendering import render as rr  # noqa: E402
from nerf_pl_tpu_torch.rendering.occupancy import (  # noqa: E402
    build_occupancy_grid, pick_block, ray_box_hits, rays_aabb,
    resolve_ranges)
from nerf_pl_tpu_torch.training import (get_lr_schedule,  # noqa: E402
                                        get_optimizer, loss_dict)
from nerf_pl_tpu_torch.training.checkpoints import (  # noqa: E402
    gather_state, load_ckpt, map_with_paths)
from nerf_pl_tpu_torch.training.optimizers import (  # noqa: E402
    B1, B2, apply_updates, clip_scale, optimizer_step, tree_leaves,
    tree_unflatten)
from nerf_pl_tpu_torch.training.families import NeRFFamily  # noqa: E402
from nerf_pl_tpu_torch.utils.profiling import cuda_event_ms  # noqa: E402
from nerfbench.work import flops_per_point  # noqa: E402

TOL = {"weights": 5e-3, "rgb": 1e-2, "opacity": 1e-2, "depth": 5e-2}
MAIN_PATH_TOL = 2e-2
RAYS_PAST_BAR = 4        # of the 4096 rays held at the 99.5th pct
RAY_CAP = {"rgb": 0.25, "depth": 1.0}   # no such ray may pass these
CHUNK = 32768            # eval.py's default --chunk: the kernels' main R
IMG = 400
N_SAMPLES, N_IMPORTANCE = 64, 64
BIG_IMG, BIG_IMPORTANCE = 800, 128     # eval.py's defaults
CAMERA_ANGLE_X = 0.8575560450553894   # blender scenes' field of view
KERNELS = {   # name: (TPU kernel it replaces, source of the port's)
    "sigma_render": ("nerf_pl_tpu/ops/fused_render.py:194",
                     "nerf_pl_tpu_torch/csrc/fused_render.cu"),
    "render_eval": ("nerf_pl_tpu/ops/fused_render.py:153",
                    "nerf_pl_tpu_torch/csrc/fused_render.cu"),
    "mse_render": ("nerf_pl_tpu/ops/fused_train.py:362",
                   "nerf_pl_tpu_torch/csrc/fused_train.cu"),
    "mlp_fwd": ("nerf_pl_tpu/ops/fused_mlp.py:351",
                "nerf_pl_tpu_torch/csrc/fused_mlp.cu"),
    "mlp_bwd": ("nerf_pl_tpu/ops/fused_mlp.py:382",
                "nerf_pl_tpu_torch/csrc/fused_mlp.cu"),
    "sigma_fwd": ("nerf_pl_tpu/ops/fused_mlp.py:465",
                  "nerf_pl_tpu_torch/csrc/fused_mlp.cu"),
    "train_fwd": ("nerf_pl_tpu/ops/fused_train.py:220",
                  "nerf_pl_tpu_torch/csrc/fused_train.cu"),
    "train_bwd": ("nerf_pl_tpu/ops/fused_train.py:250",
                  "nerf_pl_tpu_torch/csrc/fused_train.cu"),
    "adam": ("none: optax's Adam chain, which XLA fuses",
             "nerf_pl_tpu_torch/csrc/adam.cu"),
    "relu_bgrad": ("none: the JAX package has no mip-NeRF 360",
                   "nerf_pl_tpu_torch/csrc/relu_bgrad.cu"),
}
GRAD_TOL = 0.03
COS_BAR = 0.95
POINT_TOL = 5e-3         # point-MLP rgb; raw sigma x max(1, max |sigma|)
TRAIN_BATCH = 1024
TRAIN_SEED = 7
WARMUP_STEPS, SEGMENTS, SEGMENT_STEPS = 50, 3, 100
CLI_EPOCHS, CLI_PSNR_BAR = 10, 20.0
CLI_CULL_DB = 0.05       # cull-only eval against dense (test_occupancy.py)
CULLED_THETAS = (0.3, 1.9, 3.5, 5.1)   # the [culled] dispatch's 4 poses
CULLED_LADDER = (("cull", {}), ("tighten", dict(tighten=True)),
                 ("budgets", dict(tighten=True, budgets=True)),
                 ("segments", dict(tighten=True, budgets=True, segments=32)))
CULL_MSE_BAR = 1e-4      # cull against dense (tests/test_occupancy.py:288)
OCC_N = 128              # the train CLI's default --occ_N
TEACHER_SEEDS = (20, 21)   # dense_params seeds of the teacher's two MLPs
CULLED_SAMPLES = 32      # bench's culled32: 32 coarse + 64 fine samples
# bench.py's culled recipes tighten the store with one synthetic box
CULLED_TIGHTEN = dict(boxes=[[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]], margin=0.1,
                      n_seg=32, dilate=1, pack=True)
MSE_VS_TRAIN_TOL = 1e-3  # train_bwd on the MSE cotangent vs mse_render
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
ADAM_BYTES = 28          # a parameter's p, g, mu, nu read, p, mu, nu written
ADAM_STEPS, ADAM_PROFILED = 5, 50
MIP_CLIP = 1e-3          # mip-NeRF 360's global-norm clip
RELU_BYTES = 6           # a value's grad and y read, g written
# mip-NeRF 360's ReLU layers at the cell's 16,384 rays: (points, width, the
# gradient's row stride where it is a view, launches of that shape a step;
# the proposal MLP runs once a level, 64 samples a ray each)
RELU_SHAPES = ((524288, 1024, None, 7), (524288, 1024, 1096, 1),
               (524288, 128, None, 1), (1048576, 256, None, 8))
RELU_TIMED = 10          # launches an event pair: the host's part hidden
RELU_DB_TOL = 1e-5       # db against a float64 sum, of the column's sum |g|
MIP_STORE, MIP_STEPS = 262144, 3  # the [mip] step's store of rays, its steps
# a mip-NeRF 360 step's launches: the 17 ReLU layers' backward and Adam
MIP_PER_STEP = {"relu_bgrad": 17, "adam": 1}
L2_FLUSH_BYTES = 256 << 20
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores, same source


def reset_counts():
    add_launches({k: -n for k, n in launch_counts().items()})


def read_counts():
    return launch_counts()


def load_mlps(ckpt):
    """Both MLPs of a checkpoint as CPU tensors."""
    return NeRFFamily(ModelConfig(), RenderConfig(
        N_importance=N_IMPORTANCE)).load_params(ckpt)


def dense_params(seed, device):
    """Random weights with the sigma head x50, +2, so the field is opaque in
    places and the quadrature weights are not trivial."""
    p = init_nerf_params(torch.Generator().manual_seed(seed), device=device)
    p["sigma"]["w"] = p["sigma"]["w"] * 50
    p["sigma"]["b"] = p["sigma"]["b"] + 2.0
    return p


def rays_z(R, S, device, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((R, 1), 2, np.float32),
                           np.full((R, 1), 6, np.float32)], 1)
    z = np.sort(rng.uniform(2.0, 6.0, size=(R, S)), -1).astype(np.float32)
    return (torch.from_numpy(rays).to(device),
            torch.from_numpy(z).to(device))


def median_ms(fn, reps=10, warmup=2):
    return statistics.median(cuda_event_ms(fn, reps, warmup))


def batched_ms(fn, n=RELU_TIMED):
    """ms a call of fn, n calls between two events: the host's time a
    call hides behind the device's."""
    def calls():
        for _ in range(n):
            fn()
    return median_ms(calls, reps=5, warmup=1) / n


def max_err(a, b):
    return float((a - b).abs().max().item())


def rel_errs(got, ref):
    """Relative max error of each gradient leaf against its plain version
    (a zero plain leaf: 0 if the kernel's is zero too, else 1)."""
    return [((a - b).abs().max() / b.abs().max()).item()
            if b.abs().max() > 0 else float(a.abs().max() > 0)
            for a, b in zip(got, ref)]


def check_train_kernel(what, got, ref, terms=None):
    """A training kernel's (out8, weights, gradients) against its plain
    version's: prints the errors and raises past TOL or GRAD_TOL. A leaf i
    of `terms` ({leaf: its sum of |terms|}) is held to GRAD_TOL relative to
    the largest sum of |terms| of its elements instead of its own largest
    value (a leaf whose terms cancel). Returns (max abs errors of out8 and
    weights, max abs gradient error, the relative gradient errors held)."""
    (out8, w, grads), (ref8, ref_w, ref_g) = got, ref
    errs = {"rgb": max_err(out8[:, 0:3], ref8[:, 0:3]),
            "depth": max_err(out8[:, 3], ref8[:, 3]),
            "opacity": max_err(out8[:, 4], ref8[:, 4]),
            "weights": max_err(w, ref_w)}
    rels = rel_errs(grads, ref_g)
    held = {i: max_err(grads[i], ref_g[i]) / t.abs().max().item()
            for i, t in (terms or {}).items()}
    e_g = max(max_err(a, b) for a, b in zip(grads, ref_g))
    note = "".join(f"; leaf {i}: {rels[i]:.3e} of its largest value, "
                   f"{v:.3e} of its largest sum of |terms| (held)"
                   for i, v in held.items())
    rels = [held.get(i, v) for i, v in enumerate(rels)]
    print(f"[compare] {what}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; grad abs {e_g:.3e}, rel max {max(rels):.3e} (tol "
          f"{GRAD_TOL}){note}; bit-identical twice")
    if out8[:, 5:].any():
        raise AssertionError(f"{what}: out8 columns 5..7 not zero")
    for k, v in errs.items():
        if not v <= TOL[k]:
            raise AssertionError(f"{what} {k}: max abs error {v}")
    for i, v in enumerate(rels):
        if not v <= GRAD_TOL:
            raise AssertionError(f"{what} grad {i}: relative error {v}")
    return errs, e_g, rels


def grad_terms(mlp, rays, z, noise, white, g8, gw):
    """Each gradient leaf's sum of |terms|, in the pack_params layout: the
    plain backward with every weight product a^T dz taken over |a| and
    |dz|, and for the sigma bias (leaf 13) the sum of |dL/dsigma| over the
    points. The other bias leaves stay signed sums."""
    dot_t = fm._dot_t
    fm._dot_t = lambda a, b: fm._bf16(a).abs().T @ fm._bf16(b).abs()
    try:
        terms = list(ft.fused_train_render_backward_reference(
            mlp, rays, z, noise, white, g8, gw))
    finally:
        fm._dot_t = dot_t
    f = ft._forward(mlp, rays, z, noise, white)
    d_sigma, _ = ft.quad_vjp(f.q, f.rgbs, g8[:, 0:3], white,
                             ft.cotangent_base(z, g8, gw))
    terms[13] = d_sigma.abs().sum().reshape(1, 1)
    return terms


# S of the render kernels' checks at R = 4099: the dense passes (64, 128,
# 192) and the culled renderer's buckets at eval's defaults (64 + 128:
# sigma_render 16, 32, 64; render_eval 48, 96, 192) and at 64 + 64 (16,
# 32, 64; 32, 64, 128). S = 16 and 48 leave a 128-point tile part filled.
KERNEL_S = {"sigma_render": (16, 32, 64, 128, 192),
            "render_eval": (32, 48, 64, 96, 128, 192)}
# (kernel, S) timed at a culled tile of 8192 rays: eval's defaults' buckets
CULLED_TILE = 8192
CULLED_TIMED = (("sigma_render", (16, 32, 64)),
                ("render_eval", (48, 96, 192)))


def compare_kernels(mlp, dev):
    """Kernel vs plain at R = 4099 and KERNEL_S; returns {kernel: max abs
    error}."""
    errs = {"sigma_render": 0.0, "render_eval": 0.0}
    for S in sorted(set(KERNEL_S["sigma_render"] + KERNEL_S["render_eval"])):
        rays, z = rays_z(4099, S, dev, seed=S)
        got = {}
        if S in KERNEL_S["sigma_render"]:
            w_k, op_k = fr.fused_sigma_render(mlp, rays, z)
            w_p, op_p = fr.fused_sigma_render_reference(mlp, rays, z)
            got["sigma_render"] = {"weights": max_err(w_k, w_p),
                                   "opacity": max_err(op_k, op_p)}
        if S in KERNEL_S["render_eval"]:
            out_k = fr.fused_render_eval(mlp, rays, z, white_back=True)
            out_p = fr.fused_render_eval_reference(mlp, rays, z, True)
            got["render_eval"] = {k: max_err(out_k[k], out_p[k])
                                  for k in ("rgb", "depth", "opacity")}
        torch.cuda.synchronize()
        for name, per in got.items():
            print(f"[compare] {name} R=4099 S={S}: "
                  + ", ".join(f"{k} {v:.3e} (tol {TOL[k]})"
                              for k, v in per.items()))
            for k, v in per.items():
                if not v <= TOL[k]:
                    raise AssertionError(f"{name} S={S} {k}: max abs error "
                                         f"{v} > {TOL[k]}")
            errs[name] = max(errs[name], *per.values())
    return errs


def compare_eval_to_train_fwd(mlp, dev):
    """render_eval and sigma_render against train_fwd with zero noise at
    every S of KERNEL_S, white background on and off: render_eval's
    rgb, depth and opacity must equal out8[:, 0:5], and sigma_render's
    weights and opacity train_fwd's weights and out8[:, 4], bit for bit."""
    for S in sorted(set(KERNEL_S["sigma_render"] + KERNEL_S["render_eval"])):
        rays, z = rays_z(4099, S, dev, seed=S)
        zero = torch.zeros_like(z)
        w, op = fr.fused_sigma_render(mlp, rays, z)
        for white in (True, False):
            out = fr.fused_render_eval(mlp, rays, z, white_back=white)
            f8, fw = ft.train_forward(mlp, rays, z, zero, white)
            torch.cuda.synchronize()
            pairs = {"render_eval": (torch.cat(
                [out["rgb"], out["depth"][:, None], out["opacity"][:, None]],
                1), f8[:, 0:5]),
                "sigma_render": (torch.cat([w, op[:, None]], 1),
                                 torch.cat([fw, f8[:, 4:5]], 1))}
            for name, (got, want) in pairs.items():
                diff = max_err(got, want)
                same = torch.equal(got, want)
                print(f"[compare] {name} vs train_fwd (zero noise) R=4099 "
                      f"S={S} white={white}: max difference {diff:.3e}, "
                      f"bit-identical: {same}")
                if not same:
                    raise AssertionError(f"{name} S={S} white={white}: "
                                         f"differs from train_fwd by {diff}")


def time_kernels(mlp, dev):
    """Median ms of kernel and plain version at R = CHUNK rays (the dense
    path's tile), and of each kernel alone at CULLED_TILE rays and the
    culled buckets' S."""
    def pairs(rays, z):
        return {
            "sigma_render": (lambda: fr.fused_sigma_render(mlp, rays, z),
                             lambda: fr.fused_sigma_render_reference(
                                 mlp, rays, z)),
            "render_eval": (lambda: fr.fused_render_eval(mlp, rays, z, True),
                            lambda: fr.fused_render_eval_reference(
                                mlp, rays, z, True)),
        }

    times = {}
    for S in (64, 128, 192):
        rays, z = rays_z(CHUNK, S, dev, seed=1000 + S)
        for name, (kern, plain) in pairs(rays, z).items():
            t_k, t_p = median_ms(kern), median_ms(plain, reps=5, warmup=1)
            times[(name, S)] = (t_k, t_p)
            print(f"[time] {name} R={CHUNK} S={S}: kernel {t_k:.3f} ms, "
                  f"plain {t_p:.3f} ms ({t_p / t_k:.2f}x)")
        del rays, z
        torch.cuda.empty_cache()
    for name, S_all in CULLED_TIMED:
        for S in S_all:
            rays, z = rays_z(CULLED_TILE, S, dev, seed=6000 + S)
            t_k = median_ms(pairs(rays, z)[name][0])
            print(f"[time] {name} R={CULLED_TILE} S={S} (a culled tile): "
                  f"kernel {t_k:.3f} ms, {1e3 * t_k / CULLED_TILE:.3f} us "
                  f"a ray")
    return times


def write_jax_keyed_ckpt(path, params):
    """np.savez with the JAX package's flattened train-state keys."""
    flat = {f"params/{m}/{layer}/{leaf}": v.detach().cpu().numpy()
            for m, mlp in params.items()
            for layer, leaves in mlp.items() for leaf, v in leaves.items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def main_path(dev):
    params = {"nerf_coarse": dense_params(10, dev),
              "nerf_fine": dense_params(11, dev)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.ckpt")
        write_jax_keyed_ckpt(path, params)
        g = torch.Generator().manual_seed(0)
        loaded = {"nerf_coarse": init_nerf_params(g, device=dev),
                  "nerf_fine": init_nerf_params(g, device=dev)}
        for m in ("nerf_coarse", "nerf_fine"):
            loaded = load_ckpt(loaded, path, m)
    for m, mlp in params.items():
        for layer, leaves in mlp.items():
            for leaf, v in leaves.items():
                if not torch.equal(loaded[m][layer][leaf], v):
                    raise AssertionError(f"checkpoint round trip: {m}/{layer}")

    reset_counts()
    secs = {}
    for img, n_imp in ((IMG, N_IMPORTANCE), (BIG_IMG, BIG_IMPORTANCE)):
        secs[img] = eval_frames(dev, loaded, img, n_imp)
    launches = {"sigma_render": fr.sigma_render_launches,
                "render_eval": fr.render_eval_launches}
    print(f"[main] launches {launches}; {IMG}x{IMG} at {N_SAMPLES}+"
          f"{N_IMPORTANCE}: {secs[IMG][1]:.4f} s/frame; {BIG_IMG}x{BIG_IMG} "
          f"at {N_SAMPLES}+{BIG_IMPORTANCE}: {secs[BIG_IMG][1]:.4f} s/frame")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    return launches, secs


def eval_frames(dev, params, img, n_imp):
    """Two frames of img x img at N_SAMPLES + n_imp through the eval CLI's
    renderer, the first a warm-up; checks both and 4096 rays of the first
    against the plain unfused path. Returns the seconds of each."""
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * img / 800
    frames = [frame_rays(sphere_pose(theta, np.pi / 5, 4.0), img, img, focal,
                         2.0, 6.0, dev) for theta in (0.3, 1.9)]
    base = dict(N_samples=N_SAMPLES, N_importance=n_imp, test_time=True,
                white_back=True)
    render = make_render_fn(RenderConfig(**base, fused=True), CHUNK, dev,
                            device_out=True)
    outs, secs = [], []
    for rays in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(render(params, rays))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    what = f"{img}x{img}, {N_SAMPLES}+{n_imp} samples, chunk {CHUNK}"
    print(f"[main] 2 frames {what}: frame 1 {secs[0]:.4f} s (first "
          f"dispatch), frame 2 {secs[1]:.4f} s/frame")
    for i, out in enumerate(outs):
        for k, v in out.items():
            if v.shape[0] != img * img or not torch.isfinite(v).all():
                raise AssertionError(f"{img}x{img} frame {i}: {k} not finite"
                                     f" or misshapen {tuple(v.shape)}")
        for k in ("opacity_coarse", "opacity_fine"):
            lo, hi = out[k].min().item(), out[k].max().item()
            if lo < 0.0 or hi > 1.0 + 1e-4:
                raise AssertionError(f"{img}x{img} frame {i}: {k} in "
                                     f"[{lo}, {hi}]")
    rgb = outs[0]["rgb_fine"]
    print(f"[main] {img}x{img} frame 1 rgb mean {rgb.mean().item():.4f} std "
          f"{rgb.std().item():.4f}, opacity_fine mean "
          f"{outs[0]['opacity_fine'].mean().item():.4f}")

    idx = torch.linspace(0, img * img - 1, 4096, device=dev).long()
    plain = make_render_fn(RenderConfig(**base), 4096, dev,
                           device_out=True)(params, frames[0][idx])
    errs = {k: max_err(outs[0][k][idx], v) for k, v in plain.items()}
    print(f"[main] {what}: fused vs plain unfused path, 4096 rays of frame "
          f"1: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {MAIN_PATH_TOL})")
    for k, v in errs.items():
        if not v <= MAIN_PATH_TOL:
            raise AssertionError(f"main path {img}x{img} {k}: {v} > "
                                 f"{MAIN_PATH_TOL}")
    return secs


def mse_inputs(R, S, dev, seed):
    """rays_z's rays and depths, and sigma noise and ground truth from a
    CPU torch.Generator: the same inputs on any machine (a CPU test holds
    the JAX package on them)."""
    rays, z = rays_z(R, S, dev, seed)
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((R, S), generator=g).to(dev)
    gt = torch.rand((R, 3), generator=g).to(dev)
    return rays, z, noise, gt


def compare_mse(mlp, dev):
    """mse_render vs plain; returns (max abs error of out8 and weights,
    max relative gradient error)."""
    worst_abs, worst_rel = 0.0, 0.0
    for R, S in TRAIN_SHAPES:
        white = S != 128
        args = (*mse_inputs(R, S, dev, seed=R + S), white, 1.0 / (R * 3))
        k1 = ft.fused_mse_render(mlp, *args)
        k2 = ft.fused_mse_render(mlp, *args)
        ref8, ref_w, ref_g = ft.fused_mse_render_reference(mlp, *args)
        torch.cuda.synchronize()
        same = (torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])
                and all(torch.equal(a, b) for a, b in zip(k1[2], k2[2])))
        if not same:
            raise AssertionError(f"mse_render R={R} S={S}: two launches "
                                 f"differ")
        errs, _, rels = check_train_kernel(
            f"mse_render R={R} S={S} white={white}", k1,
            (ref8, ref_w, ref_g))
        worst_abs = max(worst_abs, *errs.values())
        worst_rel = max(worst_rel, *rels)
        del k1, k2, ref8, ref_w, ref_g
        torch.cuda.empty_cache()
    return worst_abs, worst_rel


def padding_and_bound(name, R, S, ms, mlp):
    """The padding share of a training kernel's launch A at (R, S) and its
    share of the bound's rate at `ms`, as a line's tail."""
    rows = _build.load_library().nerf_ray_tile_rows(R, S)
    bound_ms, _ = bound(name, (R, S), mlp)
    return (f"; padding {1 - R * S / rows:.3f} of {rows} tile rows, "
            f"{100 * bound_ms / ms:.1f}% of the bound's rate")


def time_mse(mlp, dev):
    """Median ms of mse_render and its plain version at the batch's R, at
    the dense passes' S (64, 128) and culled32's (32, 96)."""
    times = {}
    for S in (CULLED_SAMPLES, 64, CULLED_SAMPLES + N_IMPORTANCE, 128):
        args = (*mse_inputs(TRAIN_BATCH, S, dev, seed=2000 + S), True,
                1.0 / (TRAIN_BATCH * 3))
        t_k = median_ms(lambda: ft.fused_mse_render(mlp, *args))
        t_p = median_ms(lambda: ft.fused_mse_render_reference(mlp, *args),
                        reps=5, warmup=1)
        times[S] = (t_k, t_p)
        print(f"[time] mse_render R={TRAIN_BATCH} S={S}: kernel {t_k:.3f} "
              f"ms, plain {t_p:.3f} ms ({t_p / t_k:.2f}x)"
              + padding_and_bound("mse_render", TRAIN_BATCH, S, t_k, mlp))
    return times


def teacher_store(dev):
    """A teacher (fixed random weights) renders 4 frames of 400x400 through
    the fused eval path: the ray store every training path fits."""
    teacher = {"nerf_coarse": dense_params(TEACHER_SEEDS[0], dev),
               "nerf_fine": dense_params(TEACHER_SEEDS[1], dev)}
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * IMG / 800
    render = make_render_fn(RenderConfig(
        N_samples=N_SAMPLES, N_importance=N_IMPORTANCE, test_time=True,
        white_back=True, fused=True), CHUNK, dev, device_out=True)
    frames = [frame_rays(sphere_pose(theta, np.pi / 5, 4.0), IMG, IMG, focal,
                         2.0, 6.0, dev) for theta in (0.3, 1.9, 3.5, 5.1)]
    rgbs = torch.cat([render(teacher, f)["rgb_fine"] for f in frames])
    return torch.cat(frames), rgbs


def train_path(dev, store, name, rcfg, per_step, tighten=None,
               compare_after_warmup=False):
    """A Trainer at a bench config on `rcfg`'s kernel path fits the
    teacher's store, tightened first by tighten_store(**tighten) when it is
    given. per_step: the launches of each kernel per step; no other kernel
    may launch. The one-batch gradient comparison takes the parameters at
    the end, or after the warm-up steps with compare_after_warmup (where a
    fit that drives the loss to ~1e-6 still has a gradient that is more
    than the rounding left of terms that cancel). Returns (launch counts,
    rays/s per timed segment)."""
    rays, rgbs = store
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                 loss_dict["mse"], TRAIN_BATCH, dev)
    tr.set_data(rays.cpu().numpy(), rgbs.cpu().numpy())
    if tighten:
        t0 = time.perf_counter()
        st = tr.tighten_store(**tighten)
        print(f"[train] {name}: tighten_store {tighten} in "
              f"{time.perf_counter() - t0:.3f} s: hit {st['hit_frac']:.4f}, "
              f"shrink {st['shrink']:.4f}, expand x{st['expand']:.4f}, "
              f"{tr.all_nsurv} of {tr.n_rays_local} rays survive")
    state = tr.init_state(torch.Generator().manual_seed(0))
    probe = state.params["nerf_coarse"]["xyz_0"]["w"]
    torch.cuda.synchronize()

    reset_counts()
    state, m = tr.run_steps(state, TRAIN_SEED, WARMUP_STEPS)
    # run_steps returns clones of the captured step's static buffers, so a
    # TrainState kept from before later segments stays as it was
    warm = state
    losses, rates = [m["loss"]], []
    for _ in range(SEGMENTS):
        float(state.params["nerf_coarse"]["xyz_0"]["w"][0, 0])
        t0 = time.perf_counter()
        state, m = tr.run_steps(state, TRAIN_SEED, SEGMENT_STEPS)
        float(state.params["nerf_coarse"]["xyz_0"]["w"][0, 0])  # sync
        rates.append(SEGMENT_STEPS * TRAIN_BATCH
                     / (time.perf_counter() - t0))
        losses.append(m["loss"])
        for k in ("loss", "psnr", "lr"):
            if not torch.isfinite(m[k]).all():
                raise AssertionError(f"train metric {k} not finite")
    launches = read_counts()
    n_steps = WARMUP_STEPS + SEGMENTS * SEGMENT_STEPS
    # each capture first runs its warm-up steps, which launch eagerly
    n_launched = n_steps + _StepGraph.WARMUP_STEPS * tr.captures
    losses = torch.cat(losses).cpu()
    first, last = losses[:50].mean().item(), losses[-50:].mean().item()
    print(f"[train] {name}: {n_steps} steps at batch {TRAIN_BATCH}, "
          f"{rcfg.N_samples}+{rcfg.N_importance} samples, store of "
          f"{rays.shape[0]} rays, {tr.captures} graph captures "
          f"({n_launched} steps launched): launches {launches}; mean loss "
          f"first 50 "
          f"{first:.5f}, last 50 {last:.5f}; final psnr "
          f"{m['psnr'][-1].item():.2f}")
    eff = (f"; x{tr.pack_expand:.4f} packed = "
           f"{[round(r * tr.pack_expand, 1) for r in rates]} effective"
           if tr.all_nsurv is not None else "")
    print(f"[train] {name}: rays/s per segment "
          f"{[round(r, 1) for r in rates]}; best {max(rates):.1f}{eff}")
    for k, n in launches.items():
        if n != per_step.get(k, 0) * n_launched:
            raise AssertionError(f"{name}: {k} launched {n} times in "
                                 f"{n_launched} steps, not "
                                 f"{per_step.get(k, 0)} per step")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if torch.equal(probe, state.params["nerf_coarse"]["xyz_0"]["w"]):
        raise AssertionError("parameters did not change")

    # one batch, same draws (and segment masks): the kernel path's step
    # vs plain autograd
    if compare_after_warmup:
        state = warm
    rays_b, rgbs_b, *occm = tr._sample_batch(state.step)
    occm = occm[0] if occm else None
    g = torch.Generator(device=dev).manual_seed(11)
    R, S, S_imp = TRAIN_BATCH, rcfg.N_samples, rcfg.N_importance
    draws = TrainDraws(
        perturb=torch.rand((R, S), generator=g, device=dev),
        noise_coarse=torch.randn((R, S), generator=g, device=dev),
        u=torch.rand((R, S_imp), generator=g, device=dev),
        noise_fine=torch.randn((R, S + S_imp), generator=g, device=dev))
    plain_tr = Trainer(ModelConfig(), dataclasses.replace(
        rcfg, fused=False, fused_train=False, fused_loss=False),
        tr.optimizer, sched, loss_dict["mse"], TRAIN_BATCH, dev)
    plain_tr.family.n_seg = tr.family.n_seg
    loss_f, _, g_f = tr.family.loss_and_grads(state.params, rays_b, rgbs_b,
                                              None, draws, occm=occm)
    loss_p, _, g_p = plain_tr.family.loss_and_grads(
        state.params, rays_b, rgbs_b, None, draws, occm=occm)
    cos = [cosine(a, b) for a, b in zip(tree_leaves(g_f),
                                        tree_leaves(g_p, g_f))]
    print(f"[train] {name}: one batch at step {state.step} vs plain autograd"
          f" step: loss {loss_f.item():.6e} vs {loss_p.item():.6e}; "
          f"gradient cosine per leaf min {min(cos):.5f} (bar {COS_BAR})")
    if not min(cos) >= COS_BAR:
        raise AssertionError(f"gradient direction: cosine {min(cos)}")
    return launches, rates


GRAPH_EPOCH = 40          # steps an epoch of the graph phase's store
GRAPH_SEGMENTS = (GRAPH_EPOCH, 12)   # an epoch, its reshuffle, 12 more
GRAPH_TIMED, GRAPH_PROFILED = 100, 10


def step_device_ms(tag, tr, state, eager, n=GRAPH_PROFILED):
    """Device time a step over n profiled steps, and the state after them.
    The device's own count of each kernel's launches in those steps must
    equal the wrappers' (under the graph: the capture's recorded launches
    times n replays, which no wrapper sees)."""
    before = read_counts()
    (state, _), events = device_events(
        lambda: tr.run_steps(state, TRAIN_SEED + 1, n, eager=eager))
    inferred = {k: c - before[k] for k, c in read_counts().items()}
    if not eager and inferred != {k: tr._graph.launches.get(k, 0) * n
                                  for k in inferred}:
        raise AssertionError(f"graph launches {inferred}: not the "
                             f"capture's {tr._graph.launches} x {n}")
    seen = kernel_events(events)
    print(f"[graph] {tag}: {n} profiled steps: kernel launches the device "
          f"ran {seen}, the wrappers' count {by_symbol(inferred)}")
    if seen != by_symbol(inferred):
        raise AssertionError(f"{tag}: the device ran {seen} launches, the "
                             f"wrappers counted {by_symbol(inferred)}")
    return device_ms(events) / n, state


def graph_path(dev, store, smi):
    """Trainer.run_steps replayed from its captured CUDA graph against the
    same steps launched eagerly, on the four training paths, each from the
    same initial state and draws on a store of GRAPH_EPOCH batches (the
    teacher store's first rays): a segment of one epoch, the epoch's
    reshuffle (the store permuted in place), a segment of 12 more; culled32
    tightened and packed as in 4, so its offset wraps past the survivors.
    Params and optimizer state must be bit-identical, and the graph
    captured once. Then each trainer in each mode runs GRAPH_TIMED steps,
    eager, graph, graph, eager, timed on the host clock between syncs on a
    parameter, and GRAPH_PROFILED profiled steps for the device time and
    the device's count of each kernel's launches, which must equal the
    wrappers': wall ms/step, rays/s and the idle share 1 - device / wall
    of each. The device time is the profiled steps' and the wall the
    unprofiled ones', so the profiler's own cost on the device (a few %)
    bounds how small an idle share this resolves.
    Returns {path: (launches of the graph run, steps launched)}."""
    rays, rgbs = (t[:GRAPH_EPOCH * TRAIN_BATCH].cpu().numpy() for t in store)
    base = dict(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE, perturb=1.0,
                noise_std=1.0, white_back=True)
    paths = (("loss-fused", RenderConfig(**base, fused_train=True,
                                         fused_loss=True), None),
             ("culled32", RenderConfig(**dict(base, N_samples=CULLED_SAMPLES),
                                       fused_train=True, fused_loss=True),
              CULLED_TIGHTEN),
             ("fused_train", RenderConfig(**base, fused_train=True), None),
             ("fused_mlp", RenderConfig(**base, fused=True), None))
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    out = {}
    for name, rcfg, tighten in paths:
        trainers, finals = {}, {}
        for mode in ("eager", "graph"):
            tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched),
                         sched, loss_dict["mse"], TRAIN_BATCH, dev)
            tr.set_data(rays, rgbs)
            if tighten:
                tr.tighten_store(**tighten)
                if not tr.all_nsurv // TRAIN_BATCH < GRAPH_EPOCH:
                    raise AssertionError(f"{name}: no packed wrap")
            state = tr.init_state(torch.Generator().manual_seed(0))
            reset_counts()
            for n in GRAPH_SEGMENTS:
                state, m = tr.run_steps(state, TRAIN_SEED, n,
                                        eager=mode == "eager")
                if state.step % tr.steps_per_epoch == 0:
                    tr.reshuffle(seed_for(TRAIN_SEED, state.step))
            counts = read_counts()
            trainers[mode], finals[mode] = [tr, state], (state, m, counts)
        (se, me, _), (sg, mg, counts) = finals["eager"], finals["graph"]
        leaves_e = tree_leaves(se.params) + tree_leaves(se.opt_state[0])
        leaves_g = tree_leaves(sg.params) + tree_leaves(sg.opt_state[0])
        same = all(torch.equal(a, b) for a, b in zip(leaves_e, leaves_g))
        same_m = all(torch.equal(me[k], mg[k]) for k in me)
        tr_g = trainers["graph"][0]
        n_steps = sum(GRAPH_SEGMENTS)
        n_launched = n_steps + _StepGraph.WARMUP_STEPS * tr_g.captures
        wrap = (f"; {tr_g.all_nsurv} survivors = "
                f"{tr_g.all_nsurv // TRAIN_BATCH} batches of an epoch's "
                f"{tr_g.steps_per_epoch}" if tighten else "")
        print(f"[graph] {name}: {n_steps} steps over an epoch boundary and "
              f"its reshuffle{wrap}: params and Adam state bit-identical "
              f"eager vs graph: {same}; metrics: {same_m}; captures "
              f"{tr_g.captures}; launches {counts} for {n_launched} steps "
              f"launched")
        if not (same and same_m):
            worst = max(max_err(a.float(), b.float())
                        for a, b in zip(leaves_e, leaves_g))
            raise AssertionError(f"{name}: graph steps differ from eager "
                                 f"ones (max abs {worst})")
        if tr_g.captures != 1:
            raise AssertionError(f"{name}: {tr_g.captures} captures")
        out[name] = (counts, n_launched)

        wall = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            tr, state = trainers[mode]
            float(tree_leaves(state.params)[0][0, 0])
            t0 = time.perf_counter()
            state, _ = tr.run_steps(state, TRAIN_SEED + 1, GRAPH_TIMED,
                                    eager=mode == "eager")
            float(tree_leaves(state.params)[0][0, 0])   # sync
            wall[mode].append((time.perf_counter() - t0) / GRAPH_TIMED * 1e3)
            trainers[mode][1] = state
        for mode in ("eager", "graph"):
            tr, state = trainers[mode]
            dev_ms, trainers[mode][1] = step_device_ms(
                f"{name} {mode}", tr, state, mode == "eager")
            walls = wall[mode]
            print(f"[graph] {name} {mode}: wall "
                  f"{', '.join(f'{w:.3f}' for w in walls)} ms/step = "
                  f"{', '.join(f'{TRAIN_BATCH / w * 1e3:.1f}' for w in walls)}"
                  f" rays/s; device {dev_ms:.3f} ms/step; idle share "
                  f"{', '.join(f'{1 - dev_ms / w:.4f}' for w in walls)}"
                  f" ({smi})")
        del trainers, finals
        torch.cuda.empty_cache()
    return out


DESCENT_STEPS = 60


def descent_path(dev, store):
    """A short ranger run, and an Adam run on bf16 master weights, on the
    loss-fused path through the graph (the train CLI's --optimizer ranger
    and --precision bfloat16 --fused_train): DESCENT_STEPS steps each from
    one initial state; the mean loss of the last 20 steps must be below
    the first 20, and bf16 masters must stay bf16."""
    rays, rgbs = (t.cpu().numpy() for t in store)
    rcfg = RenderConfig(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                        perturb=1.0, noise_std=1.0, white_back=True,
                        fused_train=True, fused_loss=True)
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    for name, opt, master in (("ranger", "ranger", None),
                              ("adam, bf16 masters", "adam", torch.bfloat16)):
        tr = Trainer(ModelConfig(), rcfg, get_optimizer(opt, sched), sched,
                     loss_dict["mse"], TRAIN_BATCH, dev)
        tr.set_data(rays, rgbs)
        state = tr.init_state(torch.Generator().manual_seed(0),
                              master_dtype=master)
        state, m = tr.run_steps(state, TRAIN_SEED, DESCENT_STEPS)
        losses = m["loss"].cpu()
        first, last = losses[:20].mean().item(), losses[-20:].mean().item()
        dtypes = {t.dtype for t in tree_leaves(state.params)}
        print(f"[descent] {name}: {DESCENT_STEPS} replayed steps "
              f"({tr.captures} capture), loss first 20 {first:.5f}, last 20 "
              f"{last:.5f}; master dtypes {dtypes}")
        if not (last < first and torch.isfinite(losses).all()):
            raise AssertionError(f"{name}: loss did not fall: {first} -> "
                                 f"{last}")
        if dtypes != {master or torch.float32}:
            raise AssertionError(f"{name}: master dtypes {dtypes}")
        del tr, state
        torch.cuda.empty_cache()


DP_WORLD = 2             # ranks of the [dp] phase, both on cuda:0 (gloo)
DP_STEPS = 20            # eager loss-fused steps, each held against 1 rank
DP_CULLED = dict(tighten=True, budgets=True, segments=32)


def flat_leaves(tree):
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def dp_trainer(dev, group):
    """A loss-fused Trainer at the dense bench config over `group`."""
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    rcfg = RenderConfig(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                        perturb=1.0, noise_std=1.0, white_back=True,
                        fused_train=True, fused_loss=True)
    return Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                   loss_dict["mse"], TRAIN_BATCH, dev, group=group)


def dp_frame_rays(dev):
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * IMG / 800
    return frame_rays(sphere_pose(0.3, np.pi / 5, 4.0), IMG, IMG, focal, 2.0,
                      6.0, dev)


def dp_renders(dev, group):
    """One 400x400 frame of the teacher at 64 + 64 (fused, test time)
    through make_render_fn and the culled renderer (tighten, budgets, 32
    segments, base tile 8192; the box of bench's culled recipes as its
    grid), over `group`: (dense outputs, culled outputs, culled stats,
    tiles this rank renders of each)."""
    teacher = {"nerf_coarse": dense_params(TEACHER_SEEDS[0], dev),
               "nerf_fine": dense_params(TEACHER_SEEDS[1], dev)}
    rays = dp_frame_rays(dev)
    rcfg = RenderConfig(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                        test_time=True, white_back=True, fused=True)
    world = pdist.world_of(group)
    dense = make_render_fn(rcfg, CHUNK, dev, device_out=True,
                           group=group)(teacher, rays)
    box = np.asarray(CULLED_TIGHTEN["boxes"], np.float32)
    occ = OccupancyGrid(boxes=box, block_map=np.ones((1, 1, 1), np.uint8),
                        lo=box[0, :3], hi=box[0, 3:])
    cr = CulledRenderer(occ, rcfg, ModelConfig(), chunk=CULLED_TILE,
                        device=dev, group=group, **DP_CULLED)
    culled, stats = cr(teacher, rays, return_stats=True)
    plan = cr._tile_plan(len(rays), stats["bucket_counts"])
    tiles = {"dense": -(-len(rays) // (world * CHUNK)),
             "culled": sum(p[2] for p in plan) // world}
    return dense, culled, stats, tiles


def dp_rank(group, dev, rays, rgbs):
    """One rank of the [dp] phase (spawned by dist.launch). DP_STEPS
    eager loss-fused steps of the global batch; before each, the step's
    all-reduced gradients against the sum of the ranks' own kernel
    gradients on their shards, with no collective (gathered to every
    rank), each leaf's gap relative to its largest sum of |terms| (the
    two shards' gradients). Then the sharded renders of dp_renders."""
    tr = dp_trainer(dev, group)
    tr.set_data(rays, rgbs)
    state = tr.init_state(torch.Generator().manual_seed(0))
    checks, launches, losses = [], 0, []
    t_steps = 0.0
    for s in range(DP_STEPS):
        batch = tr._sample_batch(s)
        draws = tr.step_draws(TRAIN_SEED, s)
        g_dp = tree_leaves(tr.family.loss_and_grads(state.params, *batch,
                                                    None, draws)[2])
        g_one = tree_leaves(rr.fused_mse_train_step(
            state.params, *batch, tr.family.rcfg, TRAIN_BATCH,
            draws=draws)[2])
        ones = pdist.gather_rows({i: g[None] for i, g in enumerate(g_one)},
                                 group)
        gaps, rels = [], []
        for i, g in enumerate(g_dp):
            gap = (g.float() - ones[i].sum(0).float()).abs().max().item()
            terms = ones[i].float().abs().sum(0).max().item()
            gaps.append(gap)
            rel = gap / terms if terms > 0 else (0.0 if gap == 0 else
                                                 math.inf)
            rels.append(rel if rel == rel else math.inf)    # NaN: off
        checks.append((max(rels) == 0.0, max(gaps), max(rels)))
        before = ft.mse_render_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = tr.run_steps(state, TRAIN_SEED, 1, eager=True)
        losses.append(float(m["loss"][0]))
        t_steps += time.perf_counter() - t0
        launches += ft.mse_render_launches - before
    reset_counts()
    dense, culled, stats, tiles = dp_renders(dev, group)
    counts = read_counts()
    return {"checks": checks, "mse_render": launches, "losses": losses,
            "params": flat_leaves(state.params).cpu(), "step_s": t_steps,
            "dense": {k: v.cpu() for k, v in dense.items()},
            "culled": {k: v.cpu() for k, v in culled.items()},
            "stats": stats, "tiles": tiles,
            "render_launches": {k: counts[k] for k in ("sigma_render",
                                                       "render_eval")}}


def dp_check_render(what, got, ref, rows=None):
    """got against ref on rows (all by default): bit for bit expected,
    else within the kernels' bars, the max difference printed."""
    errs = {}
    for k, v in ref.items():
        a, b = got[k], v.cpu()
        if rows is not None:
            a, b = a[rows], b[rows]
        errs[k] = (torch.equal(a, b), max_err(a, b))
    print(f"[dp] {what}, 2 ranks against one process: " + ", ".join(
        f"{k} {'bit for bit' if same else f'max diff {e:.3e}'}"
        for k, (same, e) in errs.items()))
    for k, (same, e) in errs.items():
        bar = TOL[k.split("_")[0]]
        if not same and not e <= bar:
            raise AssertionError(f"[dp] {what} {k}: {e} > {bar}")


def dp_path(dev, store, smi):
    """Data parallel on the card ([dp]). Two ranks share cuda:0 over gloo
    (NCCL takes one rank a card), built once here: the dry run's phases
    (dryrun_multichip 2 --device cuda); DP_STEPS eager loss-fused steps at
    the dense bench config (global batch 1024, 512 a rank), each step's
    gradients held against the sum of the two shards' one-process kernel
    gradients (bit for bit expected; else each leaf within GRAD_TOL of
    its largest sum of |terms|, the gap printed) and the params equal on both ranks at
    the end; a 400x400 frame rendered sharded, dense and culled, against
    one process's render of it (dp_check_render; the culled on the rays
    that hit its box). Then one rank in an NCCL group on cuda:0: its
    replayed graph, the all-reduce captured in it, bit for bit the
    no-group graph's over GRAPH_SEGMENTS steps, one capture each. Two
    ranks on one card say nothing of scaling: the wall times printed are
    of this arrangement only."""
    t0 = time.perf_counter()
    dryrun_multichip.main([str(DP_WORLD), "--device", "cuda"])
    t_dry = time.perf_counter() - t0
    rays, rgbs = (t[:GRAPH_EPOCH * TRAIN_BATCH].cpu().numpy() for t in store)
    t0 = time.perf_counter()
    res = pdist.launch(dp_rank, DP_WORLD, rays, rgbs, device="cuda",
                       timeout=600)
    t_launch = time.perf_counter() - t0
    for r, out in enumerate(res):
        same = sum(c[0] for c in out["checks"])
        worst = max(c[2] for c in out["checks"])
        print(f"[dp] rank {r}: {DP_STEPS} eager loss-fused steps, "
              f"all-reduced gradients bit for bit the sum of the shards' "
              f"one-process kernel gradients on {same}/{DP_STEPS} steps "
              f"(largest gap {max(c[1] for c in out['checks']):.3e}, "
              f"{worst:.3e} of its leaf's largest sum of |terms|); launches "
              f"mse_render {out['mse_render']} ({out['mse_render'] / DP_STEPS}"
              f" a step), sigma_render "
              f"{out['render_launches']['sigma_render']} and render_eval "
              f"{out['render_launches']['render_eval']} for "
              f"{out['tiles']['dense']} dense + {out['tiles']['culled']} "
              f"culled tiles; loss {out['losses'][0]:.5f} -> "
              f"{out['losses'][-1]:.5f}")
        if not worst <= GRAD_TOL:
            raise AssertionError(f"[dp] rank {r}: gradients {worst} off")
        if out["mse_render"] != 2 * DP_STEPS:
            raise AssertionError(f"[dp] rank {r}: {out['mse_render']} "
                                 f"mse_render launches")
        n_tiles = out["tiles"]["dense"] + out["tiles"]["culled"]
        if out["render_launches"] != {"sigma_render": n_tiles,
                                      "render_eval": n_tiles}:
            raise AssertionError(f"[dp] rank {r}: render launches "
                                 f"{out['render_launches']}, {n_tiles} tiles")
        if not np.isfinite(out["losses"]).all():
            raise AssertionError(f"[dp] rank {r}: losses {out['losses']}")
    a, b = res
    if not (torch.equal(a["params"], b["params"])
            and a["losses"] == b["losses"]):
        raise AssertionError("[dp] the ranks' params or losses differ: "
                             f"{max_err(a['params'], b['params'])}")
    print(f"[dp] params and losses of the two ranks bit-identical after "
          f"{DP_STEPS} steps")
    dense, culled, stats, _ = dp_renders(dev, None)
    dp_check_render("dense 400x400 frame", a["dense"], dense)
    hit = ray_box_hits(torch.as_tensor(CULLED_TIGHTEN["boxes"], device=dev),
                       dp_frame_rays(dev))[0].cpu()
    dp_check_render(f"culled frame ({int(hit.sum())} rays hit the box)",
                    a["culled"], culled, hit)
    if a["stats"]["n_survivors"] != stats["n_survivors"]:
        raise AssertionError(f"[dp] survivors {a['stats']} vs {stats}")
    print(f"[dp] culled stats 2 ranks {a['stats']}, one process {stats}")
    dp_nccl_path(dev, rays, rgbs, smi)
    print(f"[dp] wall: dry run {t_dry:.1f} s; the 2-rank launch "
          f"{t_launch:.1f} s (spawn, steps, renders), steps "
          f"{a['step_s'] / DP_STEPS * 1e3:.2f} ms each eager with the gloo "
          f"all-reduce through the host; 2 ranks sharing one card, not a "
          f"scaling figure ({smi})")


def dp_nccl_path(dev, rays, rgbs, smi):
    """One rank in an NCCL group on cuda:0 against no group: the epoch of
    GRAPH_SEGMENTS, its reshuffle and 12 steps more, replayed from each
    trainer's captured graph; params, Adam state and metrics bit for bit,
    one capture each. Then GRAPH_TIMED replayed steps of each, in turns
    (group, none, none, group), timed between syncs on a parameter: what
    the captured one-rank all-reduce adds to a step."""
    finals, trainers = {}, {}
    wall = {"nccl": [], "none": []}
    with tempfile.TemporaryDirectory() as tmp:
        group = pdist.init_group(0, 1, "file://" + os.path.join(tmp, "rdv"),
                                 "nccl", dev)
        try:
            for tag, g in (("nccl", group), ("none", None)):
                tr = dp_trainer(dev, g)
                tr.set_data(rays, rgbs)
                state = tr.init_state(torch.Generator().manual_seed(0))
                reset_counts()
                for n in GRAPH_SEGMENTS:
                    state, m = tr.run_steps(state, TRAIN_SEED, n)
                    if state.step % tr.steps_per_epoch == 0:
                        tr.reshuffle(seed_for(TRAIN_SEED, state.step))
                finals[tag] = (state, m, tr.captures,
                               read_counts()["mse_render"])
                trainers[tag] = [tr, state]
            for tag in ("nccl", "none", "none", "nccl"):
                tr, state = trainers[tag]
                float(tree_leaves(state.params)[0][0, 0])
                t0 = time.perf_counter()
                state, _ = tr.run_steps(state, TRAIN_SEED + 1, GRAPH_TIMED)
                float(tree_leaves(state.params)[0][0, 0])
                wall[tag].append((time.perf_counter() - t0) / GRAPH_TIMED
                                 * 1e3)
                trainers[tag][1] = state
        finally:
            torch.distributed.destroy_process_group()
    print(f"[dp] {GRAPH_TIMED} replayed loss-fused steps a turn: one rank "
          f"in an NCCL group {', '.join(f'{w:.3f}' for w in wall['nccl'])}"
          f" ms/step, no group {', '.join(f'{w:.3f}' for w in wall['none'])}"
          f" ms/step ({smi})")
    (sn, mn, cn, ln), (s0, m0, c0, l0) = finals["nccl"], finals["none"]
    leaves_n = tree_leaves(sn.params) + tree_leaves(sn.opt_state[0])
    leaves_0 = tree_leaves(s0.params) + tree_leaves(s0.opt_state[0])
    same = all(torch.equal(x, y) for x, y in zip(leaves_n, leaves_0))
    same_m = all(torch.equal(mn[k], m0[k]) for k in m0)
    print(f"[dp] one rank in an NCCL group, {sum(GRAPH_SEGMENTS)} replayed "
          f"steps over an epoch boundary: params and Adam state bit for bit "
          f"the no-group graph's: {same}; metrics: {same_m}; captures "
          f"{cn} and {c0}; mse_render launches {ln} and {l0}")
    if not (same and same_m and cn == c0 == 1 and ln == l0):
        raise AssertionError("[dp] the NCCL group's graph differs from the "
                             "no-group graph's")


TP_WORLD = 2             # ranks of the [tp] phase's (1, 2) mesh, on cuda:0
TP_STEPS = 5             # plain steps held against one process
TP_LOSS_RTOL, TP_W_ATOL = 2e-4, 2e-5   # tests/test_spmd.py's TP bars
TP_ROUTES = (("fused", dict(fused=True), ("mlp_fwd", "mlp_bwd")),
             ("fused_train", dict(fused_train=True),
              ("train_fwd", "train_bwd")))


def tp_trainer(dev, group, route=None, num_model=TP_WORLD):
    """A Trainer at the dense bench config, unfused or on a kernel route,
    over `group` with a model axis of num_model (tensor parallel when it
    is more than 1)."""
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    rcfg = RenderConfig(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                        perturb=1.0, noise_std=1.0, white_back=True,
                        **(route or {}))
    return Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                   loss_dict["mse"], TRAIN_BATCH, dev, group=group,
                   num_model=num_model, tensor_parallel=num_model > 1)


def blocks_are_slices(tr, params):
    """Whether this rank's blocks equal the slices of the gathered whole
    params, bit for bit (collective over the model group)."""
    whole = gather_state(params, tr.tp)
    again = map_with_paths(tr.tp.shard_leaf, whole)
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


def tp_rank(group, dev, rays, rgbs):
    """One rank of the [tp] phase (spawned by dist.launch): TP_STEPS eager
    plain steps on the (1, 2) mesh, then one step's gradients on each
    kernel route with the launches it made."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = tp_trainer(dev, group)
    tr.set_data(rays, rgbs)
    state = tr.init_state(torch.Generator().manual_seed(0))
    sliced = [blocks_are_slices(tr, state.params)]
    w0_block = tuple(state.params["nerf_coarse"]["xyz_0"]["w"].shape)
    t0 = time.perf_counter()
    state, m = tr.run_steps(state, TRAIN_SEED, TP_STEPS, eager=True)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TP_STEPS
    sliced.append(blocks_are_slices(tr, state.params))
    whole = gather_state(state.params, tr.tp)
    out = {"losses": m["loss"].cpu(), "sliced": sliced, "step_s": step_s,
           "w0": whole["nerf_coarse"]["xyz_0"]["w"].cpu(),
           "w0_block": w0_block, "mesh": tr.mesh.shape}
    for route, kw, _ in TP_ROUTES:
        tr = tp_trainer(dev, group, kw)
        tr.set_data(rays, rgbs)
        state = tr.init_state(torch.Generator().manual_seed(0))
        batch = tr._sample_batch(0)
        draws = tr.step_draws(TRAIN_SEED, 0)
        reset_counts()
        loss, _, grads = tr.family.loss_and_grads(state.params, *batch,
                                                  None, draws)
        torch.cuda.synchronize()
        counts = read_counts()
        out[route] = {"loss": float(loss), "counts": counts,
                      "grads": [g.cpu() for g in
                                tree_leaves(gather_state(grads, tr.tp))]}
    return out


def tp_path(dev, store, smi):
    """Tensor parallel on the card ([tp]), two gloo ranks sharing cuda:0
    as a (1, 2) mesh; see the module docstring. Returns the kernels'
    launches of both ranks' route steps."""
    rays, rgbs = (t[:GRAPH_EPOCH * TRAIN_BATCH].cpu().numpy() for t in store)
    t0 = time.perf_counter()
    res = pdist.launch(tp_rank, TP_WORLD, rays, rgbs, device="cuda",
                       timeout=600)
    t_launch = time.perf_counter() - t0
    tr = tp_trainer(dev, None, num_model=1)
    tr.set_data(rays, rgbs)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, m = tr.run_steps(state, TRAIN_SEED, TP_STEPS, eager=True)
    losses = m["loss"].cpu()
    w0 = state.params["nerf_coarse"]["xyz_0"]["w"].cpu()
    refs = {}
    for route, kw, _ in TP_ROUTES:
        t1 = tp_trainer(dev, None, kw, num_model=1)
        t1.set_data(rays, rgbs)
        st1 = t1.init_state(torch.Generator().manual_seed(0))
        loss1, _, g1 = t1.family.loss_and_grads(
            st1.params, *t1._sample_batch(0), None,
            t1.step_draws(TRAIN_SEED, 0))
        refs[route] = (float(loss1), [g.cpu() for g in tree_leaves(g1)])
    launches = {}
    for r, out in enumerate(res):
        loss_err = ((out["losses"] - losses).abs() / losses.abs()).max()
        w_err = max_err(out["w0"], w0)
        print(f"[tp] rank {r} of a {out['mesh']} mesh (xyz_0.w block "
              f"{out['w0_block']}): {TP_STEPS} eager plain steps, losses "
              f"{[round(float(v), 5) for v in out['losses']]} against one "
              f"process's {[round(float(v), 5) for v in losses]} (largest "
              f"relative gap {float(loss_err):.3e}), final xyz_0.w within "
              f"{w_err:.3e}; blocks the slices of the gathered params after "
              f"init and the steps: {out['sliced']}; "
              f"{out['step_s'] * 1e3:.1f} ms a step, 2 ranks sharing one "
              f"card over gloo ({smi})")
        if not (loss_err <= TP_LOSS_RTOL and w_err <= TP_W_ATOL
                and all(out["sliced"]) and out["w0_block"] == (63, 128)):
            raise AssertionError(f"[tp] rank {r}: plain steps off")
        for route, _, kernels in TP_ROUTES:
            got = out[route]
            loss1, ref = refs[route]
            rels = rel_errs(got["grads"], ref)
            same = all(torch.equal(a, b) for a, b in zip(got["grads"], ref))
            counts = {k: got["counts"][k] for k in kernels}
            others = {k: n for k, n in got["counts"].items()
                      if n and k not in kernels}
            print(f"[tp] rank {r} {route} step on the gathered weights: "
                  f"launches {counts}, loss {got['loss']:.6f} against "
                  f"{loss1:.6f}, gradients bit for bit one "
                  f"process's: {same} (largest relative gap "
                  f"{max(rels):.3e})")
            if counts != {k: 2 for k in kernels} or others:
                raise AssertionError(f"[tp] {route}: launches "
                                     f"{got['counts']}")
            if not max(rels) <= GRAD_TOL:
                raise AssertionError(f"[tp] {route}: gradients {rels}")
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
    out, secs = run_cli(["-m", "nerf_pl_tpu_torch.dryrun_multichip", "4",
                         "--device", "cuda"], "dryrun_multichip 4",
                        os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in out.splitlines()
             if ln.startswith("[dryrun_multichip]")]
    for ln in lines:
        print(f"[tp] {ln}")
    mesh = "mesh={'data': 2, 'model': 2} tp=True"
    if not (len(lines) == 5 and all(ln.endswith(" ok") for ln in lines)
            and mesh in lines[0] and mesh in lines[3]):
        raise AssertionError(f"[tp] dryrun_multichip 4:\n{out}")
    print(f"[tp] wall: the 2-rank launch {t_launch:.1f} s, dryrun_multichip "
          f"4 (4 gloo ranks on one card) {secs:.1f} s")
    return launches


BENCH_RUNS = (["--config", "dense"], ["--config", "culled48"],
              ["--config", "culled32"],
              ["--config", "culled32", "--precision", "bfloat16"])


def bench_path(smi):
    """The bench at full size ([bench]), each config in turn with the
    counts set to 0 before it; returns its mse_render launches."""
    total = 0
    for argv in BENCH_RUNS:
        reset_counts()
        line = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(line):
            out = bench.main(argv)
        secs = time.perf_counter() - t0
        n = read_counts()["mse_render"]
        per_step = out["steps"] + _StepGraph.WARMUP_STEPS * out["captures"]
        print(f"[bench] {' '.join(argv)}: {line.getvalue().strip()}; "
              f"segments {[round(v, 1) for v in out['spread']]} rays/s; "
              f"mse_render {n} launches over {per_step} steps; "
              f"{out['captures']} capture; {secs:.1f} s in all "
              f"({bench.N_RAYS} rays, {bench.STEPS}-step segments; {smi})")
        if n != 2 * per_step or out["captures"] != 1:
            raise AssertionError(f"[bench] {argv}: {n} launches")
        if not np.isfinite(out["losses"]).all():
            raise AssertionError(f"[bench] {argv}: non-finite losses")
        total += n
        torch.cuda.empty_cache()
    return total


CAPTURE_FAILURE = """
import sys, torch
from nerf_pl_tpu_torch.parallel import Trainer
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig
from nerf_pl_tpu_torch.training import get_optimizer, loss_dict
import chip_smoke as cs


def checked_mse(out, rgbs):   # a check that reads a value back each step
    loss = loss_dict["mse"](out, rgbs)
    if not torch.isfinite(loss).item():
        raise FloatingPointError("loss is not finite")
    return loss


dev = torch.device("cuda", 0)
rays, _ = cs.rays_z(4 * cs.TRAIN_BATCH, 1, dev, seed=3)
tr = Trainer(ModelConfig(), RenderConfig(N_samples=16, N_importance=16,
             fused=True), get_optimizer("adam", 5e-4), lambda s: s * 0.0,
             checked_mse, cs.TRAIN_BATCH, dev)
tr.set_data(rays.cpu().numpy(), rays[:, :3].abs().cpu().numpy() % 1.0)
state = tr.init_state(torch.Generator().manual_seed(0))
try:
    tr.run_steps(state, 1, 4)
except Exception as e:
    print(f"raised {type(e).__name__}: {str(e).splitlines()[0][:200]}")
    sys.exit(0)
print("run_steps returned: the capture did not fail, or fell back")
sys.exit(1)
"""


def capture_failure_path():
    """A step that cannot be captured (its loss reads a value back to the
    host every step) must make run_steps raise, not fall back to eager
    steps; in a process of its own, since a failed capture leaves its
    stream's capture invalidated."""
    out, secs = run_cli(["-c", CAPTURE_FAILURE], "capture failure",
                        os.path.dirname(os.path.abspath(__file__)))
    print(f"[graph] a step that syncs with the host under capture, "
          f"{secs:.1f} s: run_steps {out.strip()}")


def cosine(a, b):
    """Cosine of two gradient leaves in float64, unclamped (a leaf's norm
    can be far below cosine_similarity's eps of 1e-8 near a minimum)."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    na, nb = a.norm().item(), b.norm().item()
    if na == 0.0 or nb == 0.0:
        return 1.0 if na == nb else 0.0
    return (a @ b).item() / (na * nb)


def occ_path(dev, store):
    """The grid build of --occ_train at OCC_N on the teacher's fine weights
    (auto ranges in the store's viewing volume, as NeRFSystem._occ_tighten
    derives them), in sigma mode and in weight mode with the store as the
    visibility rays; then tighten_store of the culled recipe (margin 0.1,
    32 segments, dilate 1, packed) with the weight-mode boxes on the card
    and on a CPU copy of the store: the masks, hit flags and tightened
    near/far must agree bit for bit."""
    rays, rgbs = store
    rays_np, rgbs_np = rays.cpu().numpy(), rgbs.cpu().numpy()
    fine = dense_params(TEACHER_SEEDS[1], dev)
    aabb = rays_aabb(rays_np)
    t0 = time.perf_counter()
    ranges = resolve_ranges(None, fine, ModelConfig(), aabb)
    print(f"[occ] auto ranges {[r.tolist() for r in ranges]} within the "
          f"store's viewing volume, {time.perf_counter() - t0:.3f} s")
    grids = {}
    for mode in ("sigma", "weight"):
        t0 = time.perf_counter()
        grid = build_occupancy_grid(
            fine, ModelConfig(), N=OCC_N, block=pick_block(OCC_N),
            ranges=ranges, max_ranges=aabb, mode=mode,
            vis_rays=rays if mode == "weight" else None)
        secs = time.perf_counter() - t0
        print(f"[occ] {mode} grid at N={OCC_N} ({OCC_N ** 3} points, block "
              f"{pick_block(OCC_N)}): {grid.n_boxes} boxes, "
              f"{100 * grid.occupied_fraction:.2f}% of blocks occupied, "
              f"{secs:.3f} s")
        if not 0 < grid.n_boxes <= 512:
            raise AssertionError(f"{mode} grid: {grid.n_boxes} boxes")
        grids[mode] = grid
    tighten = dict(CULLED_TIGHTEN, boxes=grids["weight"].boxes)
    rcfg = RenderConfig(N_samples=CULLED_SAMPLES, N_importance=N_IMPORTANCE,
                        white_back=True)
    trainers = []
    for where in (dev, torch.device("cpu")):
        tr = Trainer(ModelConfig(), rcfg, None, None, None, TRAIN_BATCH,
                     where)
        tr.set_data(rays_np, rgbs_np)
        t0 = time.perf_counter()
        st = tr.tighten_store(**tighten)
        print(f"[occ] tighten_store on {where}, {tr.n_rays_local} rays x "
              f"{grids['weight'].n_boxes} boxes: "
              f"{time.perf_counter() - t0:.3f} s; hit {st['hit_frac']:.4f}, "
              f"shrink {st['shrink']:.4f}, expand x{st['expand']:.4f}")
        trainers.append(tr)
    gpu, cpu = trainers
    differ = ((gpu.all_occm.cpu() != cpu.all_occm)
              | (gpu.all_hit.cpu() != cpu.all_hit)
              | (gpu.all_rays[:, 6:8].cpu() != cpu.all_rays[:, 6:8]).any(1)
              | (gpu.all_idx.cpu() != cpu.all_idx))
    n_diff = int(differ.sum())
    print(f"[occ] card vs CPU: {n_diff} of {differ.numel()} rays differ in "
          f"mask, hit flag, near/far or partition order")
    if n_diff:
        raise AssertionError(f"tighten_store: {n_diff} rays differ between "
                             f"the card and the CPU")


def ray_errors(out, plain, keys):
    """{key: (99.5th percentile, max, rays past the bar, bar, cap)} of the
    per-ray max abs error of out against plain. Rays whose importance
    samples move past a sharp feature of the fine field can jump between
    two implementations that differ in a bf16 rounding (the plain bf16
    version on the CPU shows the same rays), so a path is held at the
    99.5th percentile over rays, at most RAYS_PAST_BAR rays past the bar,
    and every ray within a loose cap that a wrong tile would break. Depth
    (scene units, up to 6) takes the kernels' depth bar."""
    errs = {}
    for k in keys:
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{k} not finite")
        kind = "depth" if k.startswith("depth") else "rgb"
        bar = TOL["depth"] if kind == "depth" else MAIN_PATH_TOL
        e = (out[k] - plain[k]).abs().reshape(out[k].shape[0], -1)
        e = e.max(dim=-1).values
        errs[k] = (torch.quantile(e, 0.995).item(), e.max().item(),
                   int((e > bar).sum()), bar, RAY_CAP[kind])
    return errs


def check_ray_errors(what, errs, against="plain unfused path"):
    print(f"[{what}] vs {against} (99.5th pct, max, rays past "
          f"the bar, bar, cap; at most {RAYS_PAST_BAR} rays past): "
          + ", ".join(f"{k} {q:.3e} {m:.3e} {n} {b} {c}"
                      for k, (q, m, n, b, c) in errs.items()))
    for k, (q, m, n, bar, cap) in errs.items():
        if not (q <= bar and n <= RAYS_PAST_BAR and m <= cap):
            raise AssertionError(f"{what} {k}: 99.5th pct {q} (bar {bar}), "
                                 f"{n} rays past the bar, max {m} (cap "
                                 f"{cap})")


def point_inputs(P, dev, seed):
    """(P, 8) raw points and unit directions, and a cotangent on
    [rgb, sigma] of size ~1 / P (a mean over points)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x8 = torch.zeros((P, 8), device=dev)
    x8[:, :3] = 2 * torch.randn((P, 3), generator=g, device=dev)
    d8 = torch.zeros((P, 8), device=dev)
    d8[:, :3] = torch.nn.functional.normalize(
        torch.randn((P, 3), generator=g, device=dev), dim=-1)
    cot = torch.zeros((P, 8), device=dev)
    cot[:, :4] = torch.randn((P, 4), generator=g, device=dev) / P
    return x8, d8, cot


def compare_point_mlp(dev):
    """The point-MLP kernels vs their plain versions; returns {kernel: max
    abs error} (for mlp_bwd over the gradient leaves) and prints the
    gradients' worst relative error."""
    errs = {"mlp_fwd": 0.0, "sigma_fwd": 0.0, "mlp_bwd": 0.0}
    worst_rel = 0.0
    for weights in ("dense", "init"):
        params = (dense_params(0, dev) if weights == "dense" else
                  init_nerf_params(torch.Generator().manual_seed(5),
                                   device=dev))
        mlp = fm.pack_mlp(params, dev)
        for P in (300, 4099, 131075):
            x8, d8, cot = point_inputs(P, dev, seed=P)
            out = fm.mlp_forward(mlp, x8, d8)
            sigma = fm.sigma_forward(mlp, x8)
            g1 = fm.mlp_backward(mlp, x8, d8, cot)
            g2 = fm.mlp_backward(mlp, x8, d8, cot)
            ref = fm.mlp_forward_reference(mlp.packed, x8, d8)
            ref_sigma = fm.sigma_forward_reference(mlp.packed, x8)
            ref_g = fm.mlp_backward_reference(mlp.packed, x8, d8, cot)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
                raise AssertionError(f"mlp_bwd P={P}: two launches differ")
            if not (torch.isfinite(out).all() and not out[:, 4:].any()):
                raise AssertionError(f"mlp_fwd P={P}: bad output")
            sig_tol = POINT_TOL * max(1.0, ref[:, 3].abs().max().item())
            e_rgb = max_err(out[:, :3], ref[:, :3])
            e_sig = max_err(out[:, 3], ref[:, 3])
            e_sfwd = max_err(sigma, ref_sigma)
            e_g = max(max_err(a, b) for a, b in zip(g1, ref_g))
            rels = rel_errs(g1, ref_g)
            same = torch.equal(sigma, out[:, 3])
            print(f"[compare] point MLP {weights} P={P}: mlp_fwd rgb "
                  f"{e_rgb:.3e} (tol {POINT_TOL}), sigma {e_sig:.3e}; "
                  f"sigma_fwd {e_sfwd:.3e} (tol {sig_tol:.3e}), against "
                  f"mlp_fwd's sigma max difference "
                  f"{max_err(sigma, out[:, 3]):.3e}, bit-identical: {same}; "
                  f"mlp_bwd grad abs {e_g:.3e}, rel max {max(rels):.3e} "
                  f"(tol {GRAD_TOL}); bit-identical twice")
            if not same:
                raise AssertionError(f"sigma_fwd {weights} P={P}: differs "
                                     f"from mlp_fwd's sigma")
            if not (e_rgb <= POINT_TOL and e_sig <= sig_tol
                    and e_sfwd <= sig_tol):
                raise AssertionError(f"point MLP {weights} P={P}: forward "
                                     f"error {e_rgb}, {e_sig}, {e_sfwd}")
            for i, v in enumerate(rels):
                if not v <= GRAD_TOL:
                    raise AssertionError(f"mlp_bwd {weights} P={P} grad {i}:"
                                         f" relative error {v}")
            errs["mlp_fwd"] = max(errs["mlp_fwd"], e_rgb, e_sig)
            errs["sigma_fwd"] = max(errs["sigma_fwd"], e_sfwd)
            errs["mlp_bwd"] = max(errs["mlp_bwd"], e_g)
            worst_rel = max(worst_rel, *rels)
            del out, sigma, g1, g2, ref, ref_sigma, ref_g
            torch.cuda.empty_cache()
    print(f"[compare] mlp_bwd worst gradient relative error {worst_rel:.3e}")
    return errs


def time_point_mlp(mlp, dev):
    """Median ms of the point-MLP kernels and their plain versions at the
    main path's point counts."""
    times = {}
    for P in (65536, 131072):
        x8, d8, cot = point_inputs(P, dev, seed=3000 + P)
        pairs = {
            "mlp_fwd": (lambda: fm.mlp_forward(mlp, x8, d8),
                        lambda: fm.mlp_forward_reference(mlp.packed, x8,
                                                         d8)),
            "mlp_bwd": (lambda: fm.mlp_backward(mlp, x8, d8, cot),
                        lambda: fm.mlp_backward_reference(mlp.packed, x8,
                                                          d8, cot)),
        }
        for name, (kern, plain) in pairs.items():
            t_k, t_p = median_ms(kern), median_ms(plain, reps=5, warmup=1)
            times[(name, P)] = (t_k, t_p)
            print(f"[time] {name} P={P}: kernel {t_k:.3f} ms, plain "
                  f"{t_p:.3f} ms ({t_p / t_k:.2f}x)")
    P = CHUNK * N_SAMPLES
    x8, _, _ = point_inputs(P, dev, seed=4000)
    t_k = median_ms(lambda: fm.sigma_forward(mlp, x8))
    t_p = median_ms(lambda: fm.sigma_forward_reference(mlp.packed, x8),
                    reps=3, warmup=1)
    times[("sigma_fwd", P)] = (t_k, t_p)
    print(f"[time] sigma_fwd P={P}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms "
          f"({t_p / t_k:.2f}x)")
    return times


# (cotangent mix, white background): the last puts every term of a_k, the
# white background's among them, into one backward
TRAIN_MIXES = (("rgb", True), ("depth_opacity", False), ("weights", False),
               ("all", True))
# (R, S) of the training kernels' checks: small, main and large batches at
# the coarse and fine sample counts, rays longer than ~390 samples (launch
# A's ring takes two stages; train_fwd's at S = 1024 too), and culled32's
# passes: 32 coarse samples (4 rays a 128-point tile) and 32 + 64 (4 rays
# in 3 tiles)
TRAIN_SHAPES = ([(R, S) for R in (8, 1024, 4104) for S in (64, 128, 192)]
                + [(5, 400), (3, 1024)]
                + [(R, S) for S in (32, 96) for R in (8, 1024, 4104)])
# (R, S, mix): gradient leaves held to GRAD_TOL of their largest sum of
# |terms| (check_train_kernel), leaves whose terms cancel, where the JAX
# package's fused_train_render VJP and the port's plain version, two bf16
# implementations, part by more than the kernel and the plain version do
# (tests/test_torch_fused_train_render.py::
# test_cancelling_leaves_against_jax, on these inputs): layer 0's sin/cos
# rows (leaf 1) under mean(weights^2) at (1024, 32), ROADMAP Queue C; the
# sigma head's weight and bias (leaves 12, 13) under the rgb MSE on white
# at R = 8 with S = 32 and 96, sums over 256 and 768 points.
TERMS_HELD = {(1024, 32, "weights"): (1,), (8, 32, "rgb"): (12, 13),
              (8, 96, "rgb"): (12, 13)}


def train_cotangent(mix, out8, w, gt):
    """(g8, gw) of a mean loss over the batch: the rgb MSE, depth^2 + 0.3
    opacity, mean(weights^2), or "all", their sum (gw None where the loss
    has no weights term, as autograd gives it)."""
    R, S = w.shape
    g8, gw = torch.zeros_like(out8), None
    if mix in ("rgb", "all"):
        g8[:, 0:3] = 2.0 * (out8[:, 0:3] - gt) / (R * 3)
    if mix in ("depth_opacity", "all"):
        g8[:, 3] = 2.0 * out8[:, 3] / R
        g8[:, 4] = 0.3 / R
    if mix in ("weights", "all"):
        gw = 2.0 * w / (R * S)
    return g8, gw


def compare_train(mlp, dev):
    """train_fwd and train_bwd vs their plain versions, relaunches, and
    train_bwd vs mse_render; returns {kernel: max abs error} (train_bwd's
    over the gradient leaves)."""
    errs = {"train_fwd": 0.0, "train_bwd": 0.0}
    worst_rel = worst_fwd = 0.0
    for R, S in TRAIN_SHAPES:
        rays, z, noise, gt = mse_inputs(R, S, dev, seed=7 * R + S)
        for mix, white in TRAIN_MIXES:
            f1 = ft.train_forward(mlp, rays, z, noise, white)
            f2 = ft.train_forward(mlp, rays, z, noise, white)
            ref8, ref_w = ft.fused_train_render_reference(
                mlp, rays, z, noise, white)
            g8, gw = train_cotangent(mix, ref8, ref_w, gt)
            b1 = ft.train_backward(mlp, rays, z, noise, white, g8, gw)
            b2 = ft.train_backward(mlp, rays, z, noise, white, g8, gw)
            ref_g = ft.fused_train_render_backward_reference(
                mlp, rays, z, noise, white, g8, gw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(f1 + b1,
                                                         f2 + b2)):
                raise AssertionError(f"train kernels R={R} S={S} {mix}:"
                                     f" two launches differ")
            held = TERMS_HELD.get((R, S, mix), ())
            terms = (grad_terms(mlp, rays, z, noise, white, g8, gw)
                     if held else None)
            fe, e_g, rels = check_train_kernel(
                f"train_fwd + train_bwd R={R} S={S} {mix} white={white}",
                (*f1, b1), (ref8, ref_w, ref_g),
                {i: terms[i] for i in held})
            errs["train_fwd"] = max(errs["train_fwd"], *fe.values())
            errs["train_bwd"] = max(errs["train_bwd"], e_g)
            worst_rel = max(worst_rel, *rels)
        scale = 1.0 / (R * 3)
        m8, m_w, m_g = ft.fused_mse_render(mlp, rays, z, noise, gt, True,
                                           scale)
        f8, f_w = ft.train_forward(mlp, rays, z, noise, True)
        g8 = torch.zeros_like(m8)
        g8[:, 0:3] = 2.0 * scale * (m8[:, 0:3] - gt)
        t_g = ft.train_backward(mlp, rays, z, noise, True, g8, None)
        torch.cuda.synchronize()
        rel = max(rel_errs(t_g, m_g))
        bitwise = all(torch.equal(a, b) for a, b in zip(t_g, m_g))
        # train_fwd runs mse_render's forward and quadrature: bit for
        # bit the same out8 and weights
        fwd_same = torch.equal(f8, m8) and torch.equal(f_w, m_w)
        fwd_diff = max(max_err(f8, m8), max_err(f_w, m_w))
        worst_fwd = max(worst_fwd, fwd_diff)
        print(f"[compare] train_bwd vs mse_render R={R} S={S}: grad rel "
              f"max {rel:.3e} (tol {MSE_VS_TRAIN_TOL}), bit-identical: "
              f"{bitwise}; train_fwd vs mse_render's out8 and weights: "
              f"max difference {fwd_diff:.3e}, bit-identical: {fwd_same}")
        if not rel <= MSE_VS_TRAIN_TOL:
            raise AssertionError(f"train_bwd vs mse_render R={R} S={S}:"
                                 f" {rel}")
        if not fwd_same:
            raise AssertionError(f"train_fwd R={R} S={S}: out8 or "
                                 f"weights differ from mse_render's by "
                                 f"{fwd_diff}")
        del rays, z, noise, gt, f1, f2, b1, b2, ref_g, m_g, t_g
        torch.cuda.empty_cache()
    print(f"[compare] train_bwd worst gradient relative error "
          f"{worst_rel:.3e}; train_fwd vs mse_render max difference "
          f"{worst_fwd:.3e} over {len(TRAIN_SHAPES)} shapes")
    return errs


def time_train(mlp, dev):
    """Median ms of train_fwd and train_bwd (the rgb MSE cotangent, no
    weights cotangent, as on the main path) and their plain versions at
    the batch's R."""
    times = {}
    for S in (64, 128):
        rays, z, noise, gt = mse_inputs(TRAIN_BATCH, S, dev, seed=5000 + S)
        g8, _ = train_cotangent("rgb", *ft.fused_train_render_reference(
            mlp, rays, z, noise, True), gt)
        pairs = {
            "train_fwd": (lambda: ft.train_forward(mlp, rays, z, noise, True),
                          lambda: ft.fused_train_render_reference(
                              mlp, rays, z, noise, True)),
            "train_bwd": (lambda: ft.train_backward(mlp, rays, z, noise, True,
                                                    g8, None),
                          lambda: ft.fused_train_render_backward_reference(
                              mlp, rays, z, noise, True, g8, None)),
        }
        for name, (kern, plain) in pairs.items():
            t_k, t_p = median_ms(kern), median_ms(plain, reps=5, warmup=1)
            times[(name, S)] = (t_k, t_p)
            print(f"[time] {name} R={TRAIN_BATCH} S={S}: kernel {t_k:.3f} "
                  f"ms, plain {t_p:.3f} ms ({t_p / t_k:.2f}x)"
                  + padding_and_bound(name, TRAIN_BATCH, S, t_k, mlp))
    return times


# ops/fused_mlp.py's MLP in the benchmark's model dict, for its FLOP count
# (nerfbench/work.py's mlp_layers and flops_per_point)
FM_MODEL = {"D": fm.D, "W": fm.W, "xyz_freqs": fm.FX, "dir_freqs": fm.FD,
            "skips": (fm.SKIP_LAYER,)}


def bound(name, shape, mlp):
    """(least ms, what bounds it) of one call at `shape` ((R, S) rays and
    samples, or P points): the larger of the bytes it must move (each
    input read once, each output written once) over the HBM rate and its
    bf16 operations over the tensor cores' dense peak (nerfbench/work.py's
    flops_per_point). The element-wise work (bias adds, ReLUs, the
    embeddings' sin/cos, the quadrature: a few thousand f32 operations a
    point) runs beside the tensor cores, at under a tenth of this time at
    the 67 TFLOP/s f32 rate. Adam's `shape` is its parameters, and its
    bound their bytes."""
    if name == "adam":
        return 1e3 * ADAM_BYTES * shape / HBM_BYTES_PER_S, "bytes"
    if name == "relu_bgrad":
        return 1e3 * RELU_BYTES * shape[0] * shape[1] / HBM_BYTES_PER_S, \
            "bytes"

    def wbytes(names):
        return sum(mlp.kernel[n].numel() * mlp.kernel[n].element_size()
                   for n in names)
    full, trunk = wbytes(fm._FULL), wbytes(fm._FULL[:6])
    grads = 4 * fm.GRAD_FLOATS
    f_full = flops_per_point(FM_MODEL)
    f_sig = flops_per_point(FM_MODEL, full=False)
    f_bwd = flops_per_point(FM_MODEL, train=True)
    if isinstance(shape, tuple):            # (R, S): rays and samples
        R, S = shape
        P, rays, ps = R * S, 32 * R, 4 * R * S
        ops, nbytes = {   # inputs: rays, z (, noise, gt or g8); outputs
            "sigma_render": (P * f_sig, rays + ps + trunk + ps + 4 * R),
            "render_eval": (P * f_full, rays + ps + full + 20 * R),
            "mse_render": (P * f_bwd, rays + 2 * ps + 12 * R + full
                           + 32 * R + ps + grads),
            "train_fwd": (P * f_full, rays + 2 * ps + full + 32 * R + ps),
            "train_bwd": (P * f_bwd, rays + 2 * ps + 32 * R + full
                          + grads),
        }[name]
    else:                                   # P points of 8 floats
        P = shape
        ops, nbytes = {
            "mlp_fwd": (P * f_full, 64 * P + full + 32 * P),
            "mlp_bwd": (P * f_bwd, 96 * P + full + grads),
            "sigma_fwd": (P * f_sig, 32 * P + trunk + 4 * P),
        }[name]
    t_ops, t_bytes = ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _adam_chain_step(opt, g, state, params):
    """The foreach chain's step: update (with the clip's factor where opt
    clips), then apply_updates."""
    scale = ((clip_scale(tree_leaves(g, params), opt.clip_norm),)
             if opt.clip_norm > 0 else ())
    upd, state = opt.update(g, state, params, *scale)
    return apply_updates(params, upd), state


def _adam_case(opt, params, grads, label):
    """ADAM_STEPS steps out of place and ADAM_STEPS in place through
    optimizer_step (one kernel launch each) against the chain from the
    same params, every leaf of params, moments and counts bit for bit;
    then the device ms a step of each over ADAM_PROFILED profiled steps,
    L2 flushed before each. Returns (largest |kernel - chain|, kernel ms,
    with the scalar ops ms, the chain's ms, the chain's state)."""
    from nerf_pl_tpu_torch.ops import adam as A

    def copy(tree):
        return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])

    n0, err = A.adam_launches, 0.0
    for inplace in (False, True):
        pk, sk = copy(params), opt.init(params)
        pc, sc = params, opt.init(params)
        for i in range(ADAM_STEPS):
            g = grads()
            pk, sk = optimizer_step(opt, g, sk, pk, inplace)
            pc, sc = _adam_chain_step(opt, g, sc, pc)
            got = pytree.tree_leaves((pk, sk))
            want = pytree.tree_leaves((pc, sc))
            worst = max(max_err(a.float(), b.float())
                        for a, b in zip(got, want))
            err = max(err, worst)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"[adam] {label} step {i} in place "
                                     f"{inplace}: kernel off the chain by "
                                     f"{worst}")
    launches = A.adam_launches - n0
    if launches != 2 * ADAM_STEPS:
        raise AssertionError(f"[adam] {label}: {launches} launches in "
                             f"{2 * ADAM_STEPS} steps")
    g = grads()
    flush = torch.zeros((L2_FLUSH_BYTES,), dtype=torch.uint8,
                        device=tree_leaves(params)[0].device)

    def kernel_steps():
        nonlocal pk, sk
        for _ in range(ADAM_PROFILED):
            flush.bitwise_not_()
            pk, sk = optimizer_step(opt, g, sk, pk, True)

    def chain_steps():
        nonlocal pc, sc
        for _ in range(ADAM_PROFILED):
            flush.bitwise_not_()
            pc, sc = _adam_chain_step(opt, g, sc, pc)

    kernel_steps()
    chain_steps()
    n1 = A.adam_launches
    _, ev = device_events(kernel_steps)
    if A.adam_launches - n1 != ADAM_PROFILED:
        raise AssertionError(f"[adam] {label}: {A.adam_launches - n1} "
                             f"launches in {ADAM_PROFILED} profiled steps")
    k_ms = sum(e.self_device_time_total for e in ev
               if "adam_kernel" in e.key) / 1e3 / ADAM_PROFILED
    with_scalars = _adam_step_ms(ev)
    _, ev = device_events(chain_steps)
    return err, k_ms, with_scalars, _adam_step_ms(ev), (pc, sc)


def _adam_step_ms(events):
    """Device ms a profiled step, the L2 flush and the phase marks (the
    optimizer's spans while a profiler records) left out."""
    return device_ms([e for e in events if "bitwise_not" not in e.key
                      and "nerf::mark" not in e.key]) / ADAM_PROFILED


def adam_path(dev):
    """[adam], the module docstring's Adam paragraph. Returns (the largest
    |kernel - chain| over the compared leaves, parameters, kernel ms, the
    chain's ms, torch._fused_adam_'s ms) of the dense recipe's leaves;
    prints mip-NeRF 360's clipped case and its [bound] line."""
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    opt = get_optimizer("adam", sched)
    params = {m: init_nerf_params(torch.Generator().manual_seed(i),
                                  device=dev)
              for i, m in enumerate(("nerf_coarse", "nerf_fine"))}
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)

    def grads():
        return {m: fm.unpack_grads(fm._pack_layout_grads(torch.randn(
            (fm.GRAD_FLOATS,), generator=gen, device=dev) * 1e-3))
            for m in params}

    err, k_ms, with_scalars, chain_ms, _ = _adam_case(opt, params, grads,
                                                      "dense")
    g = grads()
    flush = torch.zeros((L2_FLUSH_BYTES,), dtype=torch.uint8, device=dev)
    # the library's one call over the same leaves, timed beside the
    # kernel only: its rounding is not optax's order, and the port does
    # not call it (contiguous gradients: it reads no strided view)
    lib = [tree_leaves(t, params) for t in (
        tree_unflatten(params, [t.clone() for t in tree_leaves(params)]), g,
        opt.init(params)[0]["mu"], opt.init(params)[0]["nu"])]
    lib[1] = [t.contiguous() for t in lib[1]]
    lib_steps_t = [torch.ones((), device=dev) for _ in lib[0]]

    def library_steps():
        for _ in range(ADAM_PROFILED):
            flush.bitwise_not_()
            torch._fused_adam_(*lib, [], lib_steps_t, lr=5e-4, beta1=B1,
                               beta2=B2, weight_decay=0.0, eps=1e-8,
                               amsgrad=False, maximize=False)

    library_steps()
    _, ev = device_events(library_steps)
    lib_ms = _adam_step_ms(ev)
    print(f"[adam] {n_params} parameters in {len(tree_leaves(params))} "
          f"leaves: {ADAM_STEPS} steps out of place and {ADAM_STEPS} in "
          f"place bit for bit the foreach chain's (largest |kernel - "
          f"chain| {err}); device ms a step, L2 flushed: kernel "
          f"{k_ms:.4f}, with the scalar ops {with_scalars:.4f}, the chain "
          f"{chain_ms:.4f} ({chain_ms / with_scalars:.1f}x), "
          f"torch._fused_adam_ {lib_ms:.4f} (not called by the port)")

    # mip-NeRF 360's leaves at published widths with its clip and eps; the
    # gradients of the heads padded to 8 columns are column slices, as the
    # step's are
    mip_opt = get_optimizer("adam", sched, eps=1e-6, clip_norm=MIP_CLIP)
    mip = init_mip_params(torch.Generator().manual_seed(7), MipConfig(),
                          dev)
    n_mip = sum(t.numel() for t in tree_leaves(mip))

    def mip_grads():
        def one(t):
            if t.dim() == 2 and t.shape[1] % 8:
                wide = (t.shape[0], -(-t.shape[1] // 8) * 8)
                return (torch.randn(wide, generator=gen, device=dev)
                        * 1e-3)[:, :t.shape[1]]
            return torch.randn(t.shape, generator=gen, device=dev) * 1e-3
        return tree_unflatten(mip, [one(t) for t in tree_leaves(mip)])

    factor = float(clip_scale(tree_leaves(mip_grads(), mip), MIP_CLIP))
    if not factor < 1:
        raise AssertionError(f"[adam] mip-NeRF 360: the clip's factor "
                             f"{factor} does not bite")
    m_err, m_ms, m_scalars, m_chain, _ = _adam_case(mip_opt, mip, mip_grads,
                                                    "mip-NeRF 360")
    bound_ms, bound_by = bound("adam", n_mip, None)
    print(f"[adam] mip-NeRF 360: {n_mip} parameters in "
          f"{len(tree_leaves(mip))} leaves, global-norm clip {MIP_CLIP} "
          f"(factor {factor:.3e}), eps 1e-6: {ADAM_STEPS} steps out of "
          f"place and {ADAM_STEPS} in place bit for bit the clipped "
          f"foreach chain's (largest |kernel - chain| {m_err}); device ms a "
          f"step, L2 flushed: kernel {m_ms:.4f}, with the clip and the "
          f"scalar ops {m_scalars:.4f}, the chain {m_chain:.4f} "
          f"({m_chain / m_scalars:.1f}x)")
    print(f"[bound] adam at mip-NeRF 360's {n_mip} parameters, clipped: "
          f"{m_ms:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / m_ms:.1f}% of the bound's rate")
    return err, n_params, k_ms, chain_ms, lib_ms


def relu_bgrad_path(dev):
    """[relu_bgrad], the module docstring's paragraph. Returns (the largest
    |db - float64 sum| over sum |g| of a column, the kernel's ms, the
    plain version's ms, threshold_backward + sum(0)'s ms) at the NeRF
    trunk's (524,288, 1024)."""
    from nerf_pl_tpu_torch.ops import relu_bgrad as RB
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    worst, step, out = 0.0, [0.0, 0.0], None

    def db_err(db, want):
        return ((db.double() - want.double().sum(0)).abs()
                / want.double().abs().sum(0).clamp_min(1e-30)).max().item()
    for P, N, width, per_step in RELU_SHAPES:
        y = torch.relu(torch.randn((P, N), generator=gen, device=dev)
                       ).to(torch.bfloat16)
        # a gradient of mean 1: a column's |sum g| is near its sum |g|, so
        # db's rounding shows against the bar
        full = (torch.randn((P, width or N), generator=gen, device=dev) + 1
                ).to(torch.bfloat16)
        grad = full[:, :N]
        g, db = RB.relu_bgrad(grad, y)
        want = torch.ops.aten.threshold_backward(grad, y, 0)
        if not torch.equal(g.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"[relu_bgrad] {P} x {N}: g is not "
                                 "threshold_backward's")
        err = db_err(db, want)
        if not err <= RELU_DB_TOL:
            raise AssertionError(f"[relu_bgrad] {P} x {N}: db off a float64 "
                                 f"sum by {err:.3e} of sum |g|")
        err_bf16 = db_err(db.to(torch.bfloat16).float(), want)
        if not err_bf16 > RELU_DB_TOL:
            raise AssertionError(f"[relu_bgrad] {P} x {N}: db rounded to "
                                 f"bf16 passes the bar ({err_bf16:.3e})")
        worst = max(worst, err)
        del g, db, want
        k_ms = batched_ms(lambda: RB.relu_bgrad(grad, y))
        p_ms = batched_ms(lambda: RB.relu_bgrad_plain(grad, y))
        lib_ms = batched_ms(lambda: torch.ops.aten.threshold_backward(
            grad, y, 0).sum(0))
        bound_ms, _ = bound("relu_bgrad", (P, N), None)
        step[0] += per_step * k_ms
        step[1] += per_step * bound_ms
        print(f"[relu_bgrad] {P} x {N}"
              + (f" (grad's rows {width} apart)" if width else "")
              + f": kernel {k_ms:.4f} ms against a bound of {bound_ms:.4f} "
              f"ms (bytes), {100 * bound_ms / k_ms:.1f}% of the bound's "
              f"rate; plain {p_ms:.4f}; library_ms (threshold_backward + "
              f"sum(0), which the port no longer calls) {lib_ms:.4f}; g bit "
              f"for bit, db within {err:.2e} of sum |g| (rounded to bf16 "
              f"{err_bf16:.2e})")
        if (N, width) == (1024, None):
            out = (k_ms, p_ms, lib_ms)
        del y, full, grad
    print(f"[relu_bgrad] a 16,384-ray mip-NeRF 360 step's 17 layers: "
          f"{step[0]:.3f} ms against a bound of {step[1]:.3f} ms, "
          f"{100 * step[1] / step[0]:.1f}%")
    torch.cuda.empty_cache()
    return (worst,) + out


def mip_path(dev):
    """[mip], the module docstring's paragraph. Returns the launch counts
    of its steps."""
    import copy
    from nerf_pl_tpu_torch.parallel.spmd import TrainState
    from nerfbench import inputs_mip360 as mi
    from nerfbench import run
    from nerfbench.runners import train_mip360 as runner
    cell = copy.deepcopy(run.load_cell("mipnerf360_outdoor.train16k"))
    cell["config"]["store"]["n_rays"] = MIP_STORE
    batch = cell["traffic"]["batch_per_rank"]
    tr = runner.trainer_with_store(cell, TRAIN_SEED, dev)
    params = mi.make_params(cell["config"]["model"], TRAIN_SEED, dev)
    state = TrainState(params, tr.optimizer.init(params), 0)
    torch.cuda.synchronize()
    reset_counts()
    state, m = tr.run_steps(state, TRAIN_SEED, MIP_STEPS)
    torch.cuda.synchronize()
    launches = read_counts()
    n_launched = MIP_STEPS + _StepGraph.WARMUP_STEPS * tr.captures
    print(f"[mip] mip-NeRF 360 at published widths, batch {batch}: "
          f"{MIP_STEPS} steps, {tr.captures} graph captures ({n_launched} "
          f"steps launched): launches {launches}; loss "
          f"{[round(v, 5) for v in m['loss'].tolist()]}")
    if not torch.isfinite(m["loss"]).all():
        raise AssertionError("[mip] loss not finite")
    for k, n in launches.items():
        if n != MIP_PER_STEP.get(k, 0) * n_launched:
            raise AssertionError(f"[mip] {k} launched {n} times in "
                                 f"{n_launched} steps, not "
                                 f"{MIP_PER_STEP.get(k, 0)} per step")
    del tr, state, params
    torch.cuda.empty_cache()
    return launches


def validation_path(dev):
    """The --fused_mlp validation config through make_render_fn; returns
    the 4096 compared rays and the params for the perturbed path."""
    params = {"nerf_coarse": dense_params(30, dev),
              "nerf_fine": dense_params(31, dev)}
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * IMG / 800
    frame = frame_rays(sphere_pose(0.7, np.pi / 5, 4.0), IMG, IMG, focal,
                       2.0, 6.0, dev)
    base = dict(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                white_back=True)
    render = make_render_fn(RenderConfig(**base, fused=True), CHUNK, dev,
                            device_out=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = render(params, frame)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    n_chunks = -(-IMG * IMG // CHUNK)
    print(f"[val] validation config (fused, test_time off), 1 frame "
          f"{IMG}x{IMG}, {N_SAMPLES}+{N_IMPORTANCE}: launches {launches}; "
          f"{secs:.4f} s")
    want = {k: 2 * n_chunks if k == "mlp_fwd" else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"validation launched {launches}, not {want}")
    for k, v in out.items():
        if v.shape[0] != IMG * IMG or not torch.isfinite(v).all():
            raise AssertionError(f"validation: {k} not finite or misshapen")
    idx = torch.linspace(0, IMG * IMG - 1, 4096, device=dev).long()
    plain = make_render_fn(RenderConfig(**base), 4096, dev,
                           device_out=True)(params, frame[idx])
    check_ray_errors("val", ray_errors({k: v[idx] for k, v in out.items()},
                                       plain, ("rgb_coarse", "rgb_fine")))
    return params, frame[idx].contiguous(), secs


def perturbed_path(dev, params, rays):
    """Test time with perturb and sigma noise: sigma_fwd on the coarse
    pass, mlp_fwd on the fine, against the unfused path on the same
    draws."""
    R = rays.shape[0]
    g = torch.Generator(device=dev).manual_seed(12)
    draws = TrainDraws(
        perturb=torch.rand((R, N_SAMPLES), generator=g, device=dev),
        noise_coarse=torch.randn((R, N_SAMPLES), generator=g, device=dev),
        u=torch.rand((R, N_IMPORTANCE), generator=g, device=dev),
        noise_fine=torch.randn((R, N_SAMPLES + N_IMPORTANCE), generator=g,
                               device=dev))
    cfg = RenderConfig(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                       test_time=True, white_back=True, fused=True,
                       perturb=1.0, noise_std=1.0)
    with torch.no_grad():
        reset_counts()
        out = render_rays(params, rays, cfg, draws=draws)
        torch.cuda.synchronize()
        launches = read_counts()
        plain = render_rays(params, rays, dataclasses.replace(cfg,
                                                              fused=False),
                            draws=draws)
    print(f"[test-time] perturb 1, noise 1, {R} rays: launches {launches}")
    want = {k: 1 if k in ("sigma_fwd", "mlp_fwd") else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"perturbed test time launched {launches}")
    # the sigma noise is added by sorted sample position: a ray whose
    # importance samples move past a coarse depth also moves its noise
    check_ray_errors("test-time", ray_errors(out, plain, plain.keys()))
    return launches


CLI_FLAGS = ["--dataset_name", "blender", "--root_dir", "scene",
             "--img_wh", "40", "40", "--N_samples", "32",
             "--N_importance", "16", "--batch_size", "1024", "--lr", "5e-4",
             "--decay_step", "20", "--decay_gamma", "0.5",
             "--scan_steps", "90", "--val_chunk", "1600"]
OCC_CLI_FLAGS = ["--occ_train", "--occ_warmup_epochs", "2",
                 "--occ_refresh_epochs", "2", "--occ_segments", "32",
                 "--occ_dilate", "1", "--occ_pack", "--occ_mode", "weight"]


def run_cli(args, what, cwd):
    """python args in a process of its own in cwd; returns (stdout,
    seconds) and raises on a non-zero exit."""
    env = {**os.environ,
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def val_psnr(out):
    return {int(e): float(p) for e, p in re.findall(
        r"^\[val\] epoch (\d+) loss=\S+ psnr=(\S+)", out, re.M)}


def train_cli_path(work):
    """The train CLI with --fused_mlp alone and its resume, each in a
    process of its own, in `work` (the scene in work/scene); returns the
    resumed run's last.ckpt."""
    flags = CLI_FLAGS + ["--exp_name", "v1", "--fused_mlp"]
    run_cli(["-m", "nerf_pl_tpu_torch.datasets.synthetic", "scene"],
            "scene", work)
    out, secs = run_cli(["-m", "nerf_pl_tpu_torch.train", *flags,
                         "--num_epochs", str(CLI_EPOCHS)], "train CLI", work)
    psnr = val_psnr(out)
    print(f"[cli] train --fused_mlp, {CLI_EPOCHS} epochs, {secs:.1f} s: "
          f"val/psnr by epoch {psnr}")
    if not psnr.get(CLI_EPOCHS, 0.0) > CLI_PSNR_BAR:
        raise AssertionError(f"train CLI: val/psnr {psnr} not past "
                             f"{CLI_PSNR_BAR} dB by epoch {CLI_EPOCHS}")
    ckpt = os.path.join(work, "ckpts", "v1", "last.ckpt")
    if not os.path.isfile(ckpt):
        raise AssertionError("train CLI wrote no last.ckpt")
    out, secs = run_cli(["-m", "nerf_pl_tpu_torch.train", *flags,
                         "--num_epochs", str(CLI_EPOCHS + 1),
                         "--ckpt_path", ckpt], "train CLI resume", work)
    resumed = re.search(r"^\[resume\] full train state .*$", out, re.M)
    last = re.search(rf"^\[val\] epoch {CLI_EPOCHS + 1} .*$", out, re.M)
    if not (resumed and last):
        raise AssertionError(f"train CLI resume:\n{out[-3000:]}")
    print(f"[cli] resume, {secs:.1f} s: {resumed.group(0)}; "
          f"{last.group(0)}")
    return ckpt


def sync_secs(fn):
    """(fn(), seconds from a torch.cuda.synchronize to the next)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def psnr_db(a, b):
    return (-10.0 * torch.log10(((a - b) ** 2).mean())).item()


def culled_path(dev, ckpt):
    """The occupancy-culled renderer on the trained sphere field: 4 frames
    of 800x800 at 64 + 128 in one dispatch, the weight-mode grid at OCC_N
    built then loaded from the port's cache, and the ladder dense, cull,
    tighten, budgets, segments (CULLED_LADDER), each timed over 2
    dispatches after a warm-up one. Holds: finite outputs, opacity in [0,
    1 + 1e-4], one sigma_render and one render_eval launch a tile, rows no
    tile renders exactly background, 4096 rays of frame 1 against the
    same renderer with the render kernels' plain versions (on their
    survivors, ray_errors' rule), and the cull rung against dense
    (the rendered rows within the kernel bars, the image within
    CULL_MSE_BAR). Returns the kernels' launches over the ladder."""
    params = {k: params_from_numpy(v, dev)
              for k, v in load_mlps(ckpt).items()}
    focal = 0.5 * BIG_IMG / np.tan(0.5 * CAMERA_ANGLE_X)
    rays = torch.cat([frame_rays(sphere_pose(t, np.pi / 5, 4.0), BIG_IMG,
                                 BIG_IMG, focal, 2.0, 6.0, dev)
                      for t in CULLED_THETAS])
    R, px = rays.shape[0], BIG_IMG * BIG_IMG
    rcfg = RenderConfig(N_samples=N_SAMPLES, N_importance=BIG_IMPORTANCE,
                        test_time=True, white_back=True, fused=True)

    grid_kw = dict(N=OCC_N, aabb=rays_aabb(rays.cpu().numpy()),
                   mode="weight", vis_rays=rays)
    (occ, secs) = sync_secs(lambda: load_or_build_grid(
        ckpt, params["nerf_fine"], **grid_kw))
    caches = glob.glob(glob.escape(ckpt) + ".torch_occ.*.npz")
    stamp = [os.stat(c).st_mtime_ns for c in caches]
    (again, secs2) = sync_secs(lambda: load_or_build_grid(
        ckpt, params["nerf_fine"], **grid_kw))
    print(f"[culled] weight grid at N={OCC_N} on the 4 frames' rays: "
          f"{occ.n_boxes} boxes, {100 * occ.occupied_fraction:.2f}% of "
          f"blocks occupied; built in {secs:.3f} s, loaded from "
          f"{[os.path.basename(c) for c in caches]} in {secs2:.3f} s")
    if not (len(caches) == 1 and stamp == [os.stat(caches[0]).st_mtime_ns]
            and np.array_equal(occ.boxes, again.boxes)
            and 0 < occ.occupied_fraction < 1):
        raise AssertionError("grid cache: not one file loaded back, or the "
                             "grid holds nothing or everything")

    idx = torch.linspace(0, px - 1, 4096, device=dev).long()   # frame 1
    dense_fn = make_render_fn(rcfg, CHUNK, dev, device_out=True)
    reset_counts()
    rungs = [("dense", lambda: (dense_fn(params, rays), None), None)]
    for name, cfg in CULLED_LADDER:
        cr = CulledRenderer(occ, rcfg, chunk=CulledRenderer.DEFAULT_CHUNK,
                            device=dev, **cfg)
        rungs.append((name, lambda cr=cr: cr(params, rays,
                                             return_stats=True), cr))
    for name, fn, cr in rungs:
        fn()                                            # warm-up
        n0 = read_counts()
        (out, stats), t1 = sync_secs(fn)
        _, t2 = sync_secs(fn)
        n = {k: v - n0[k] for k, v in read_counts().items()}
        tiles = (2 * -(-R // CHUNK) if cr is None else 2 * sum(
            p[2] for p in cr._tile_plan(R, stats.get(
                "bucket_counts", [stats["n_survivors"]]))))
        want = {k: tiles if k in ("sigma_render", "render_eval") else 0
                for k in n}
        print(f"[culled] {name}: {t1 / 4:.4f}, {t2 / 4:.4f} s/frame; "
              + ("" if stats is None else
                 f"survivors {stats['n_survivors']} of {R}, rendered "
                 f"{stats['n_rendered']}, buckets "
                 f"{stats.get('bucket_counts')}; ")
              + f"launches in 2 dispatches {n} ({tiles // 2} tiles a "
              f"dispatch)")
        if n != want:
            raise AssertionError(f"culled {name}: launched {n}, not {want}")
        for k in ("rgb_fine", "depth_fine", "opacity_fine"):
            if out[k].shape[0] != R or not torch.isfinite(out[k]).all():
                raise AssertionError(f"culled {name}: {k} not finite or "
                                     f"misshapen")
        lo, hi = out["opacity_fine"].min().item(), \
            out["opacity_fine"].max().item()
        if lo < 0.0 or hi > 1.0 + 1e-4:
            raise AssertionError(f"culled {name}: opacity in [{lo}, {hi}]")
        if cr is None:
            dense = out
            continue
        print_dispatch_split(name, lambda: cr(params, rays))
        check_culled_rung(dev, name, cr, occ, params, rays, idx, out, stats,
                          dense)
    counts = read_counts()
    return {k: counts[k] for k in ("sigma_render", "render_eval")}


def print_dispatch_split(name, fn):
    """fn() (one culled dispatch) under torch.profiler, read as the
    benchmark reads the program's phases (nerfbench/metrics/_spans.py):
    each phase's device ms (busy, idle, count) and the host spans of the
    cull pass and the buckets."""
    from nerfbench import trace as T
    from nerfbench.metrics import _spans as S

    def once():
        # the window's first device events can go unrecorded (the cull
        # mark was): a kernel and a sync first, before the dispatch
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        return 1
    tr = T.traced(once, cuda=True)
    print(f"[culled] {name}: the split of one more dispatch (device ms, "
          f"busy + idle; host ms):")
    for phase, d in S.split(tr).items():
        print(f"[culled]   {phase:13s} x{d['count']:<3d} "
              f"{d['busy_ms']:8.3f} + {d['idle_ms']:7.3f}")
    for span in ("cull", "bucket"):
        print(f"[culled]   host {span}: " + ", ".join(
            f"{1e3 * (e - s):.3f}" for _, s, e in S.host_spans(tr, span)))


@contextlib.contextmanager
def plain_render_kernels():
    """render_rays with the two render kernels' plain PyTorch versions in
    their place."""
    saved = rr.fused_sigma_render, rr.fused_render_eval
    rr.fused_sigma_render = fr.fused_sigma_render_reference
    rr.fused_render_eval = fr.fused_render_eval_reference
    try:
        yield
    finally:
        rr.fused_sigma_render, rr.fused_render_eval = saved


def check_culled_rung(dev, name, cr, occ, params, rays, idx, out, stats,
                      dense):
    """One culled rung's holds (culled_path)."""
    R = rays.shape[0]
    cull = cr._cull(rays, 0)
    rendered = torch.zeros(R, dtype=torch.bool, device=dev)
    rendered[cull.order[:stats["n_survivors"] if cr.budgets
                        else min(stats["n_rendered"], R)]] = True
    bg = (out["rgb_fine"][~rendered] == 1.0).all() and not (
        out["depth_fine"][~rendered].any()
        or out["opacity_fine"][~rendered].any())
    if not bg:
        raise AssertionError(f"culled {name}: a row no tile renders is not "
                             f"background")
    # the 4096 rays again through the same renderer with the render
    # kernels' plain versions (held), and through one of the same settings
    # on the unfused f32 path (printed beside the plain versions' own
    # distance from it: bf16 against f32 on the trained surface)
    hit = ray_box_hits(cr.boxes, rays[idx])[0]
    keys = ("rgb_fine", "depth_fine", "opacity_fine")
    with plain_render_kernels():
        plain = cr(params, rays[idx])
    unfused = CulledRenderer(
        occ, dataclasses.replace(cr.rcfg, fused=False), chunk=cr.chunk,
        tighten=cr.tighten, budgets=cr.budgets, segments=cr.segments,
        device=dev)(params, rays[idx])
    fused = {k: out[k][idx][hit] for k in keys}
    plain, unfused = ({k: v[k][hit] for k in keys} for v in (plain, unfused))
    for what, a, b in (("kernels vs unfused f32", fused, unfused),
                       ("plain versions vs unfused f32", plain, unfused)):
        errs = ray_errors(a, b, keys)
        print(f"[culled] {name}: {what} on {int(hit.sum())} survivors "
              f"(printed, not held): " + ", ".join(
                  f"{k} {q:.3e} {m:.3e} {n}" for k, (q, m, n, _, _)
                  in errs.items()))
    check_ray_errors(f"culled {name}", ray_errors(fused, plain, keys),
                     "the render kernels' plain versions")
    psnr = psnr_db(out["rgb_fine"], dense["rgb_fine"])
    if name != "cull":
        print(f"[culled] {name}: PSNR against dense {psnr:.2f} dB (printed, "
              f"not held)")
        return
    diff = {k: max_err(out[k][rendered], dense[k][rendered]) for k in keys}
    mse = ((out["rgb_fine"] - dense["rgb_fine"]) ** 2).mean().item()
    print(f"[culled] cull against dense on its {int(rendered.sum())} "
          f"rendered rows: " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in diff.items())
          + f"; image mse {mse:.3e} (bar {CULL_MSE_BAR}), PSNR {psnr:.2f} dB")
    for k, v in diff.items():
        if not v <= TOL[k.split("_")[0]]:
            raise AssertionError(f"cull vs dense {k}: {v}")
    if not mse <= CULL_MSE_BAR:
        raise AssertionError(f"cull vs dense: image mse {mse}")


def eval_cli_path(work, ckpt):
    """The eval CLI on the scene's test split with `ckpt`, each run in a
    process of its own: dense (--fused_mlp), the culled stack twice (the
    grid built, then loaded from its cache; mean PSNR past CLI_PSNR_BAR)
    and --occ_grid alone (within CLI_CULL_DB of dense). Returns the mean
    PSNR of each."""
    base = ["-m", "nerf_pl_tpu_torch.eval", "--root_dir", "scene",
            "--dataset_name", "blender", "--img_wh", "40", "40",
            "--N_samples", "32", "--N_importance", "16", "--ckpt_path",
            ckpt, "--fused_mlp"]
    stack = ["--occ_grid", "--occ_mode", "weight", "--occ_tighten",
             "--occ_budgets", "--occ_segments", "32"]
    psnr = {}
    for name, extra, want in (("dense", [], None),
                              ("culled", stack, "built grid"),
                              ("culled again", stack, "loaded cached grid"),
                              ("cull only", ["--occ_grid"], "built grid")):
        metrics = os.path.join(work, f"{name.replace(' ', '_')}.json")
        out, secs = run_cli(base + extra + ["--scene_name", name.split()[0],
                                            "--metrics_out", metrics],
                            f"eval CLI {name}", work)
        with open(metrics) as f:
            psnr[name] = json.load(f)["mean_psnr"]
        occ = [ln for ln in out.splitlines() if ln.startswith("[occ]")]
        print(f"[cli] eval {' '.join(extra) or '(dense)'}, {secs:.1f} s: "
              f"mean PSNR {psnr[name]}; " + "; ".join(occ))
        if want and not any(ln.startswith(f"[occ] {want}") for ln in occ):
            raise AssertionError(f"eval CLI {name}: no '[occ] {want}' line")
    print(f"[cli] eval mean PSNR: dense {psnr['dense']}, culled stack "
          f"{psnr['culled']} and {psnr['culled again']}, cull only "
          f"{psnr['cull only']} (bars: culled past {CLI_PSNR_BAR} dB, cull "
          f"only within {CLI_CULL_DB} dB of dense)")
    if not min(psnr["culled"], psnr["culled again"]) > CLI_PSNR_BAR:
        raise AssertionError(f"culled eval CLI: {psnr}")
    if not abs(psnr["cull only"] - psnr["dense"]) <= CLI_CULL_DB:
        raise AssertionError(f"cull-only eval CLI against dense: {psnr}")
    return psnr


def culled_cli_path():
    """The train CLI with --fused_train and the culled training stack
    (OCC_CLI_FLAGS), beside the same run without --occ_*, each in a
    process of its own: the culled run's [occ] lines, its packing, and
    val/psnr past CLI_PSNR_BAR by epoch CLI_EPOCHS. Returns both runs'
    val/psnr by epoch."""
    psnr = {}
    with tempfile.TemporaryDirectory() as tmp:
        run_cli(["-m", "nerf_pl_tpu_torch.datasets.synthetic", "scene"],
                "scene", tmp)
        for name, extra in (("dense", []), ("culled", OCC_CLI_FLAGS)):
            out, secs = run_cli(
                ["-m", "nerf_pl_tpu_torch.train", *CLI_FLAGS, "--exp_name",
                 name, "--fused_train", "--num_epochs", str(CLI_EPOCHS),
                 *extra], f"train CLI {name}", tmp)
            psnr[name] = val_psnr(out)
            rates = re.findall(r"^\[train\] step \S+ .*\((.*)\)$", out,
                               re.M)
            print(f"[cli] train --fused_train {' '.join(extra)}, "
                  f"{CLI_EPOCHS} epochs, {secs:.1f} s: val/psnr by epoch "
                  f"{psnr[name]}; last rate: {rates[-1] if rates else None}")
            occ = [ln for ln in out.splitlines() if ln.startswith("[occ]")]
            for ln in occ:
                print(f"[cli] {name}: {ln}")
        if not any("packed: x" in ln for ln in occ):
            raise AssertionError("culled train CLI: no packed [occ] line:\n"
                                 + "\n".join(occ))
    print(f"[cli] val/psnr at epoch {CLI_EPOCHS}: culled "
          f"{psnr['culled'].get(CLI_EPOCHS)}, dense "
          f"{psnr['dense'].get(CLI_EPOCHS)} (bar {CLI_PSNR_BAR})")
    if not psnr["culled"].get(CLI_EPOCHS, 0.0) > CLI_PSNR_BAR:
        raise AssertionError(f"culled train CLI: val/psnr {psnr['culled']} "
                             f"not past {CLI_PSNR_BAR} dB by epoch "
                             f"{CLI_EPOCHS}")
    return psnr



MESH_N = 256             # the mesh CLI's default --N_grid
MESH_RANGE = ("-1.3", "1.3")   # the synthetic sphere: radius 1, at 0
# --sigma_threshold. The train CLI's 40x40 checkpoint peaks near sigma 7.5
# (mesh_path prints it), so the CLI's default of 20 finds no surface; at
# 1.0 the largest cluster is the shell at the sphere, while at 2 and above
# it takes in the fog inside the sphere, with several times the vertices.
MESH_SIGMA = 1.0
MESH_RADIUS = (0.8, 1.2)       # the median vertex radius must lie here
MESH_CPU_N = 64          # card against CPU: the sigma grid's N
MESH_CPU_RAYS = 2048     # and the occlusion rays of one view
MESH_SIGMA_TOL = 1e-4    # |sigma card - CPU| over max(1, max |sigma|)
MESH_VERTEX_TOL = 1e-2   # a marching-cubes vertex, in grid cells
MESH_OPACITY_TOL = 1e-3
MESH_OCC = 0.2           # the CLI's default --occ_threshold


def check_mesh_file(path, reader):
    """(vertices, triangles, colours) of a mesh the CLI wrote, held to:
    triangles present, finite vertices, colours present, and the median
    vertex radius within MESH_RADIUS."""
    v, t, c = reader(path)
    r = float(np.median(np.linalg.norm(v, axis=1))) if len(v) else 0.0
    print(f"[mesh] {os.path.basename(path)}: {len(v)} vertices, {len(t)} "
          f"triangles, median vertex radius {r:.4f} (bar {MESH_RADIUS})")
    if not (len(t) and np.isfinite(v).all() and c is not None
            and len(c) == len(v)):
        raise AssertionError(f"{path}: {len(t)} triangles, finite "
                             f"{np.isfinite(v).all()}, colours "
                             f"{None if c is None else c.shape}")
    if not MESH_RADIUS[0] <= r <= MESH_RADIUS[1]:
        raise AssertionError(f"{path}: median vertex radius {r}")
    return v, t, c


def mesh_cli_path(work, ckpt):
    """The mesh CLI on the card, in a process of its own, on `ckpt` and
    work/scene at N_grid MESH_N over +-1.3: the default fusion with
    --export_vol, then --use_vertex_normal --mesh_format dae. Each output
    read back (check_mesh_file) and the .vol non-empty."""
    os.makedirs(os.path.join(work, "mesh"), exist_ok=True)
    base = ["-m", "nerf_pl_tpu_torch.extract_color_mesh", "--root_dir",
            "scene", "--dataset_name", "blender", "--img_wh", "40", "40",
            "--ckpt_path", ckpt, "--N_grid", str(MESH_N),
            "--x_range", *MESH_RANGE, "--y_range", *MESH_RANGE,
            "--z_range", *MESH_RANGE, "--sigma_threshold", str(MESH_SIGMA),
            "--out_dir", "mesh"]
    for name, extra, ext, reader in (
            ("fused", ["--export_vol"], "ply", read_ply),
            ("normal", ["--use_vertex_normal", "--mesh_format", "dae"],
             "dae", read_dae)):
        out, secs = run_cli(base + ["--scene_name", name, *extra],
                            f"mesh CLI {name}", work)
        said = re.search(r"^Mesh has .*$", out, re.M)
        print(f"[mesh] CLI {' '.join(extra) or '(fusion)'}, {secs:.1f} s: "
              f"{said.group(0) if said else out[-500:]}")
        check_mesh_file(os.path.join(work, "mesh", f"{name}.{ext}"), reader)
    vol = os.path.getsize(os.path.join(work, "mesh", "fused.vol"))
    print(f"[mesh] fused.vol: {vol} bytes ({vol // 8} voxels)")
    if vol == 0:
        raise AssertionError("mesh CLI --export_vol wrote an empty .vol")


def vertex_rays(vertices, pose, near):
    """fuse_colors_by_projection's camera -> vertex rays of one view (far
    at the vertex's camera depth)."""
    homo = np.concatenate([vertices, np.ones((len(vertices), 1))], 1)
    w2c = np.linalg.inv(np.concatenate([pose, [[0, 0, 0, 1.0]]], 0))[:3]
    depth = -(w2c[2] @ homo.T)[:, None] + 1e-5
    o = np.broadcast_to(pose[:, -1], vertices.shape).astype(np.float32)
    d = vertices - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((len(o), 1), near, np.float32),
                           depth.astype(np.float32)], 1)


def mesh_path(dev, work, ckpt, smi):
    """The mesh pipeline's phases in-process on the card, each timed from
    a sync to a sync: the sigma grid at MESH_N (make_grid on the host,
    then query_grid), marching cubes + keep_largest_cluster, the fusion
    over the scene's 12 views (and one view's occlusion render alone),
    and the vertex-normal render (coarse + fine at test time). No kernel
    of the eight launches (the path is the plain f32 MLP, as in the JAX
    package). Then card against CPU: query_grid on the card and on a CPU
    copy of the weights at MESH_CPU_N (sigma within MESH_SIGMA_TOL of
    max(1, max |sigma|)), marching cubes on both grids (the same triangles,
    vertices within MESH_VERTEX_TOL cells) and occlusion_opacity on
    MESH_CPU_RAYS vertex rays of view 0 (within MESH_OPACITY_TOL; the
    vertices whose opacity < MESH_OCC flips printed)."""
    cpu = load_mlps(ckpt)
    params = {k: params_from_numpy(v, dev) for k, v in cpu.items()}
    fine = params["nerf_fine"]
    mcfg = ModelConfig()
    rng = tuple(map(float, MESH_RANGE))
    dataset = dataset_dict["blender"](root_dir=os.path.join(work, "scene"),
                                      img_wh=(40, 40), split="train")
    n_views = len(dataset.image_paths)

    reset_counts()
    xyz, t_grid = sync_secs(lambda: make_grid(MESH_N, rng, rng, rng))
    sigma, t_query = sync_secs(lambda: query_grid(fine, xyz, mcfg, CHUNK))
    sigma = np.maximum(sigma, 0).reshape(MESH_N, MESH_N, MESH_N)
    print(f"[mesh] sigma over the grid: 99th percentile "
          f"{np.percentile(sigma, 99):.3f}, max {sigma.max():.3f}; "
          f"{100 * (sigma > MESH_SIGMA).mean():.2f}% of points above "
          f"{MESH_SIGMA}")
    (v, t), t_mc = sync_secs(lambda: keep_largest_cluster(
        *marching_cubes(sigma, MESH_SIGMA)))
    if not len(t):
        raise AssertionError(f"[mesh] no surface at sigma {MESH_SIGMA} "
                             f"(max sigma {sigma.max()})")
    g = np.linspace(rng[0], rng[1], MESH_N, dtype=np.float32)
    ball = 1.0 - np.sqrt(sum(np.square(a) for a in np.meshgrid(
        g, g, g, indexing="ij", sparse=True)))
    print(f"[mesh] an analytic unit sphere on the same grid: "
          f"{len(marching_cubes(ball, 0.0)[0])} vertices")
    vw = grid_to_world(v, MESH_N, rng, rng, rng)
    colors, t_fuse = sync_secs(lambda: fuse_colors_by_projection(
        fine, vw, dataset, (40, 40), N_SAMPLES, CHUNK, MESH_OCC, mcfg,
        progress=False))
    rays0 = vertex_rays(vw, dataset.poses[0], dataset.bounds.min())
    _, t_occ = sync_secs(lambda: occlusion_opacity(fine, rays0, N_SAMPLES,
                                                   CHUNK, mcfg))
    normals = compute_vertex_normals(vw, t)
    near = np.full((len(vw), 1), dataset.bounds.min(), np.float32)
    nrays = np.concatenate([vw - normals * near, normals, near,
                            np.full_like(near, dataset.bounds.max())],
                           1).astype(np.float32)
    rcfg = RenderConfig(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                        white_back=True, test_time=True)

    def normal_render():
        with torch.no_grad():
            return render_rays_chunked(params, torch.from_numpy(nrays).to(
                dev), rcfg, mcfg, chunk=CHUNK)["rgb_fine"]
    rgb, t_normal = sync_secs(normal_render)
    counts = read_counts()
    print(f"[mesh] N_grid {MESH_N} ({MESH_N ** 3} points), {len(v)} "
          f"vertices, {len(t)} triangles; make_grid {t_grid:.3f} s, "
          f"query_grid {t_query:.3f} s, marching cubes + largest cluster "
          f"{t_mc:.3f} s, fusion over {n_views} views {t_fuse:.3f} s "
          f"({t_fuse / n_views:.3f} s a view; one view's occlusion render "
          f"alone {t_occ:.3f} s), vertex-normal render at {N_SAMPLES}+"
          f"{N_IMPORTANCE} {t_normal:.3f} s; {smi}")
    if not (colors.shape == vw.shape and torch.isfinite(rgb).all()):
        raise AssertionError(f"[mesh] colours {colors.shape} of {vw.shape} "
                             f"vertices, finite normal-render rgb "
                             f"{bool(torch.isfinite(rgb).all())}")
    if any(counts.values()):
        raise AssertionError(f"[mesh] the plain f32 path launched kernels: "
                             f"{counts}")

    xyz = make_grid(MESH_CPU_N, rng, rng, rng)
    fine_cpu = params_from_numpy(cpu["nerf_fine"], "cpu")
    s_card = query_grid(fine, xyz, mcfg, CHUNK)
    s_cpu = query_grid(fine_cpu, xyz, mcfg, CHUNK)
    err = float(np.abs(s_card - s_cpu).max())
    scale = max(1.0, float(np.abs(s_cpu).max()))
    (vc, tc), (vh, th) = (marching_cubes(np.maximum(s, 0).reshape(
        (MESH_CPU_N,) * 3), MESH_SIGMA) for s in (s_card, s_cpu))
    same = len(vc) == len(vh) and np.array_equal(tc, th)
    verr = float(np.abs(vc - vh).max()) if same and len(vc) else None
    vw = grid_to_world(vh, MESH_CPU_N, rng, rng, rng)[:MESH_CPU_RAYS]
    rays0 = vertex_rays(vw, dataset.poses[0], dataset.bounds.min())
    op_card, op_cpu = (np.nan_to_num(occlusion_opacity(
        p, rays0, N_SAMPLES, CHUNK, mcfg), nan=1.0)
        for p in (fine, fine_cpu))
    operr = float(np.abs(op_card - op_cpu).max())
    flips = int(((op_card < MESH_OCC) != (op_cpu < MESH_OCC)).sum())
    print(f"[mesh] card against CPU at N_grid {MESH_CPU_N}: sigma max abs "
          f"diff {err:.3e} (max |sigma| {scale:.2f}, bar "
          f"{MESH_SIGMA_TOL} x that); triangles {len(tc)} and {len(th)}, "
          f"identical {same}, vertex max diff {verr} cells (bar "
          f"{MESH_VERTEX_TOL}); opacity on {len(rays0)} vertex rays of view "
          f"0: max abs diff {operr:.3e} (bar {MESH_OPACITY_TOL}), "
          f"{flips} flips at opacity < {MESH_OCC}")
    if not err <= MESH_SIGMA_TOL * scale:
        raise AssertionError(f"[mesh] sigma card against CPU: {err}")
    if not (same and len(tc) and verr <= MESH_VERTEX_TOL):
        raise AssertionError(f"[mesh] marching cubes card against CPU: "
                             f"{len(tc)} and {len(th)} triangles, vertex "
                             f"diff {verr}")
    if not operr <= MESH_OPACITY_TOL:
        raise AssertionError(f"[mesh] occlusion opacity card against CPU: "
                             f"{operr}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; TF32 off")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    errs = compare_kernels(mlp, dev)
    compare_eval_to_train_fwd(mlp, dev)
    times = time_kernels(mlp, dev)
    launches, _ = main_path(dev)

    errs["mse_render"], _ = compare_mse(mlp, dev)
    mse_times = time_mse(mlp, dev)
    errs["adam"], n_params, adam_ms, chain_ms, adam_lib_ms = adam_path(dev)
    times[("adam", n_params)] = (adam_ms, chain_ms)
    (errs["relu_bgrad"], relu_ms, relu_plain_ms,
     relu_lib_ms) = relu_bgrad_path(dev)
    relu_launches = mip_path(dev)["relu_bgrad"]
    times[("relu_bgrad", RELU_SHAPES[0][1])] = (relu_ms, relu_plain_ms)
    store = teacher_store(dev)
    base = dict(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE, perturb=1.0,
                noise_std=1.0, white_back=True)
    counts, _ = train_path(dev, store, "loss-fused", RenderConfig(
        **base, fused_train=True, fused_loss=True),
        {"mse_render": 2, "adam": 1})
    launches["mse_render"], launches["adam"] = (counts["mse_render"],
                                                counts["adam"])
    occ_path(dev, store)
    train_path(dev, store, "culled32", RenderConfig(
        **dict(base, N_samples=CULLED_SAMPLES), fused_train=True,
        fused_loss=True), {"mse_render": 2, "adam": 1},
        tighten=CULLED_TIGHTEN, compare_after_warmup=True)

    errs.update(compare_point_mlp(dev))
    times.update(time_point_mlp(mlp, dev))
    counts, _ = train_path(dev, store, "fused_mlp",
                           RenderConfig(**base, fused=True),
                           {"mlp_fwd": 2, "mlp_bwd": 2, "adam": 1})
    launches["mlp_fwd"], launches["mlp_bwd"] = (counts["mlp_fwd"],
                                                counts["mlp_bwd"])

    errs.update(compare_train(mlp, dev))
    times.update(time_train(mlp, dev))
    counts, _ = train_path(dev, store, "fused_train",
                           RenderConfig(**base, fused_train=True),
                           {"train_fwd": 2, "train_bwd": 2, "adam": 1})
    launches["train_fwd"], launches["train_bwd"] = (counts["train_fwd"],
                                                    counts["train_bwd"])
    graph_path(dev, store, smi)
    descent_path(dev, store)
    dp_path(dev, store, smi)
    tp_launches = tp_path(dev, store, smi)
    del store
    torch.cuda.empty_cache()
    params, rays, _ = validation_path(dev)
    launches["sigma_fwd"] = perturbed_path(dev, params, rays)["sigma_fwd"]
    with tempfile.TemporaryDirectory() as work:
        ckpt = train_cli_path(work)
        culled_launches = culled_path(dev, ckpt)
        eval_cli_path(work, ckpt)
        mesh_cli_path(work, ckpt)
        mesh_path(dev, work, ckpt, smi)
    for k, n in culled_launches.items():
        launches[k] += n
    culled_cli_path()
    capture_failure_path()
    for k, n in tp_launches.items():
        launches[k] += n
    launches["mse_render"] += bench_path(smi)
    launches["relu_bgrad"] = relu_launches

    fine_S = N_SAMPLES + N_IMPORTANCE
    times[("mse_render", fine_S)] = mse_times[fine_S]
    for S in (CULLED_SAMPLES, CULLED_SAMPLES + N_IMPORTANCE):
        ms = mse_times[S][0]
        bound_ms, bound_by = bound("mse_render", (TRAIN_BATCH, S), mlp)
        print(f"[bound] mse_render at culled32's {(TRAIN_BATCH, S)}: "
              f"{ms:.3f} ms against a bound of {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of the bound's "
              f"rate")
    main_shape = {"sigma_render": (CHUNK, N_SAMPLES),
                  "render_eval": (CHUNK, fine_S),
                  "mse_render": (TRAIN_BATCH, fine_S),
                  "mlp_fwd": TRAIN_BATCH * fine_S,
                  "mlp_bwd": TRAIN_BATCH * fine_S,
                  "sigma_fwd": CHUNK * N_SAMPLES,
                  "train_fwd": (TRAIN_BATCH, fine_S),
                  "train_bwd": (TRAIN_BATCH, fine_S),
                  "adam": n_params,
                  "relu_bgrad": RELU_SHAPES[0][:2]}
    # the timings are keyed by S for a ray batch and by P for points
    time_key = {k: v[1] if isinstance(v, tuple) else v
                for k, v in main_shape.items()}
    kernels = []
    for k, (tpu, src) in KERNELS.items():
        ms, plain_ms = times[(k, time_key[k])]
        bound_ms, bound_by = bound(k, main_shape[k], mlp)
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": launches[k],
                        "max_abs_err": errs[k], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": {"adam": adam_lib_ms,
                                       "relu_bgrad": relu_lib_ms}.get(k)})
        print(f"[bound] {k} at {main_shape[k]}: {ms:.3f} ms against a "
              f"bound of {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound's rate")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
