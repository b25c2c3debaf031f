"""mse_render's share of its roofline: launch A (fwdbwd_kernel), B
(wgrad_kernel) and C (sum_slots / sum_rows) summed over a step's calls,
against the least time of the calls' work."""
import re

from nerfbench.metrics._common import roofline_pct

PATTERN = re.compile(r"\b(fwdbwd_kernel|wgrad_kernel|sum_slots|sum_rows)\b")


def read(tr, ctx):
    if ctx["kind"] != "train":
        return None
    return roofline_pct(tr, ctx, "mse_render", PATTERN)
