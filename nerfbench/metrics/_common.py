"""What the per-layer readers share: device seconds by kind of operation
and the work of one unit (a step or a frame) from `work.py`."""
from __future__ import annotations

from typing import Dict, Optional

from nerfbench import trace as T
from nerfbench.work import BF16_FLOPS_PER_S, bound_s, kernel_work


def per_unit_ms(seconds: float, tr: T.Trace) -> Optional[float]:
    return 1e3 * seconds / tr.units if tr.units else None


def plain_ops_ms(tr: T.Trace) -> Optional[float]:
    """Device ms a unit outside the hand-written kernels and the
    collectives: the optimizer, packing, sampling, sorting, copies."""
    if not tr.device:
        return None
    return per_unit_ms(T.device_s(tr.device, None,
                                  (T.HANDWRITTEN, T.COLLECTIVE)), tr)


def idle_pct(tr: T.Trace) -> Optional[float]:
    """100 x (1 - the union of device spans over the window)."""
    if not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - T.union_s(tr.device) / tr.window_s)


def mfu_pct(tr: T.Trace, ctx: Dict) -> Optional[float]:
    """The MLP work of the window's units over the window's length, as a
    share of the card's bf16 peak."""
    if not tr.device or tr.window_s <= 0:
        return None
    return (100.0 * ctx["unit"]["ops"] * tr.units
            / (tr.window_s * BF16_FLOPS_PER_S))


def roofline_pct(tr: T.Trace, ctx: Dict, kernel: str, pattern
                 ) -> Optional[float]:
    """A kernel's least time for the calls of the window's units (the work
    they need, `work.kernel_work`) over the device time of its launches
    matching `pattern`."""
    calls = ctx["unit"].get(kernel)
    spent = T.device_s(tr.device, pattern)
    if not calls or spent <= 0:
        return None
    least = sum(bound_s(*kernel_work(kernel, ctx["model"], R, S))
                for R, S in calls) * tr.units
    return 100.0 * least / spent
