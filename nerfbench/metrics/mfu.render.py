"""The whole frame's share of the bf16 peak: the coarse sigma pass and
the fine pass of a frame's rays (work.frame_work) times the frames
traced, over the traced window."""
from nerfbench.metrics._common import mfu_pct


def read(tr, ctx):
    return mfu_pct(tr, ctx) if ctx["kind"] == "render" else None
