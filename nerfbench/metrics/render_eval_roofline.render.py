"""render_eval's (eval_quad_kernel's) share of its roofline over a
frame's fine pass."""
import re

from nerfbench.metrics._common import roofline_pct

PATTERN = re.compile(r"\beval_quad_kernel\b")


def read(tr, ctx):
    if ctx["kind"] != "render":
        return None
    return roofline_pct(tr, ctx, "render_eval", PATTERN)
