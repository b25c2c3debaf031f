"""Share of the training kernels' 128-point tile rows that held no point:
1 - ray_points / ray_tile_rows, the program's counters of mse_render,
train_fwd and train_bwd (nerf_pl_tpu_torch/ops/fused_train.py; a replayed
step adds its capture's). They count every launch of this process's run,
whose shapes are the cell's at every step. None where the program keeps no
such counters or launched none, and in a run whose steps ran in other
processes (a data-parallel cell's ranks)."""
import sys


def read(tr, ctx):
    if ctx["kind"] != "train":
        return None
    mod = sys.modules.get("nerf_pl_tpu_torch.ops.fused_train")
    rows = getattr(mod, "ray_tile_rows", 0)
    if not rows:
        return None
    return 100.0 * (1.0 - mod.ray_points / rows)
