"""mip-NeRF 360's whole training step's share of the bf16 peak: both
MLPs' forward and backward work of a step's rays
(work_mip360.train_step_work) times the steps traced, over the traced
window."""
from nerfbench.metrics._common import mfu_pct


def read(tr, ctx):
    return mfu_pct(tr, ctx) if ctx["kind"] == "train_mip360" else None
