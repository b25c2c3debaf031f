"""sigma_render's (sigma_quad_kernel's) share of its roofline over a
frame's coarse pass."""
import re

from nerfbench.metrics._common import roofline_pct

PATTERN = re.compile(r"\bsigma_quad_kernel\b")


def read(tr, ctx):
    if ctx["kind"] != "render":
        return None
    return roofline_pct(tr, ctx, "sigma_render", PATTERN)
