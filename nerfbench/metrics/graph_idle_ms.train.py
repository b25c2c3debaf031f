"""Idle device ms a step inside the replayed step graph: the gaps between
the step's `batch` mark and its `end` mark, over its phases
(nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import STEP_GRAPH, per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, STEP_GRAPH, "idle") if ctx["kind"] == "train" \
        else None
