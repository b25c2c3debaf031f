"""Device ms a step of the optimizer (busy): the program's `optimizer`
phase, the gradients' cast to the master dtype, the update and its
application (nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("optimizer",)) if ctx["kind"] == "train" \
        else None
