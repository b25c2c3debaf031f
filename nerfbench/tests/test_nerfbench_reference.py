"""The plain reference against the program's plain (unfused, float32)
path at a tiny size on the CPU: the same weights, rays and draws give
the same training renders, test-time frames and gradients. The reference
imports nothing of the program or of JAX."""
import ast
from pathlib import Path

import pytest
import torch

from nerfbench import inputs
from nerfbench.references import nerf as ref
from nerfbench.tests.cut import cut_cell

BENCH = Path(__file__).resolve().parents[1]


def _program_params(params):
    return {m: {l: {k: t.clone() for k, t in leaf.items()}
                for l, leaf in mlp.items()} for m, mlp in params.items()}


@pytest.mark.parametrize("culled", [False, True])
def test_training_render_and_gradients_match_the_plain_path(culled):
    from nerf_pl_tpu_torch.rendering import (ModelConfig, RenderConfig,
                                             TrainDraws, render_rays)
    torch.manual_seed(0)
    cell = cut_cell("blender_culled32.train" if culled
                    else "blender_dense.train")
    cfg = cell["config"]
    r = cfg["render"]
    dev = torch.device("cpu")
    params = inputs.make_params(cfg["model"], 11, dev)
    rays, rgbs = inputs.make_store(256, 11, dev)
    draws = inputs.step_draws(r, 256, 11, 0, 0, dev)
    bits = None
    occm = None
    if culled:
        c = cfg["culled"]
        boxes = torch.tensor(c["boxes"])
        hit, lo, hi = ref.box_overlap(boxes, rays)
        rays = ref.tighten(rays, hit, lo, hi, c["margin"])
        bits = ref.segment_bits(boxes, rays, c["n_seg"], c["dilate"])
        occm = (bits.long() << torch.arange(c["n_seg"])).sum(-1)
    rcfg = RenderConfig(N_samples=r["N_samples"],
                        N_importance=r["N_importance"], perturb=r["perturb"],
                        noise_std=r["noise_std"], white_back=True)
    leaves = {}
    prog = _program_params(params)
    for m in prog.values():
        for leaf in m.values():
            for k in leaf:
                leaf[k].requires_grad_()
    out_p = render_rays(prog, rays, rcfg, ModelConfig(),
                        draws=TrainDraws(**draws), occm=occm,
                        n_seg=cfg["culled"]["n_seg"] if culled else 0)
    refp = _program_params(params)
    for m in refp.values():
        for leaf in m.values():
            for k in leaf:
                leaf[k].requires_grad_()
    out_r = ref.render(refp, cfg["model"], r, rays, ref.Matmul(), draws,
                       bits)
    for k in ("rgb_coarse", "rgb_fine", "depth_fine", "opacity_fine"):
        torch.testing.assert_close(out_r[k], out_p[k], rtol=1e-4, atol=1e-4)
    lp = ref.loss_fn(out_p, rgbs)
    lr = ref.loss_fn(out_r, rgbs)
    gp = torch.autograd.grad(lp, [prog[m][l][k] for m in prog
                                  for l in prog[m] for k in prog[m][l]])
    gr = torch.autograd.grad(lr, [refp[m][l][k] for m in refp
                                  for l in refp[m] for k in refp[m][l]])
    for a, b in zip(gp, gr):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-6)
    del leaves


def test_test_time_frame_matches_the_plain_path():
    from nerf_pl_tpu_torch.parallel import make_render_fn
    from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig
    cell = cut_cell("blender_dense.render400")
    cfg = cell["config"]
    ev = cfg["eval"]
    dev = torch.device("cpu")
    params = inputs.make_params(cfg["model"], 5, dev, ev["sigma_abs_scale"])
    rays = inputs.frame_rays(ev, 3, dev)
    rcfg = RenderConfig(N_samples=ev["N_samples"],
                        N_importance=ev["N_importance"], white_back=True,
                        test_time=True)
    out_p = make_render_fn(rcfg, 256, dev, ModelConfig())(params, rays)
    out_r = ref.render_frame(params, cfg["model"], ev, rays, ref.Matmul())
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "opacity_coarse"):
        torch.testing.assert_close(out_r[k], torch.as_tensor(out_p[k]),
                                   rtol=1e-4, atol=1e-4)


def test_the_yardstick_imports_nothing_of_the_program_or_jax():
    banned = ("jax", "jaxlib", "flax", "nerf_pl_tpu", "nerf_pl_tpu_torch")
    for path in ["references/nerf.py", "inputs.py", "work.py", "check.py",
                 "trace.py"]:
        tree = ast.parse((BENCH / path).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)
