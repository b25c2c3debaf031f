"""The whole training step's share of the bf16 peak: the forward and
backward MLP work of a step's rays (work.train_step_work) times the
steps traced, over the traced window."""
from nerfbench.metrics._common import mfu_pct


def read(tr, ctx):
    return mfu_pct(tr, ctx) if ctx["kind"] == "train" else None
