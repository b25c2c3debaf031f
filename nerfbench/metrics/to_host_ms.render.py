"""Device ms a frame of the outputs' way to the host: the whole interval
of the `frame.to_host` phase, from its mark to the frame's `end` mark,
the copies and the idle between them (nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("frame_to_host",), "interval") \
        if ctx["kind"] == "render" else None
