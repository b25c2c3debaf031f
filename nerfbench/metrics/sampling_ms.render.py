"""Device ms a frame of the sampling (busy): every tile's `coarse_z` (the
stratified depths) and `fine_z` (sample_pdf and the sort) phases
(nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("coarse_z", "fine_z")) \
        if ctx["kind"] == "render" else None
