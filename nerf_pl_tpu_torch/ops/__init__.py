"""Kernels of the port and their plain versions: sample_pdf, the fused
point MLP (packing and its three kernels), the fused render kernels, the
three training render kernels, Adam's update and mip-NeRF 360's ReLU
backward with its bias gradient (CUDA, built on first use).

Each kernel wrapper counts its launches in a plain int of its module,
and the training kernels count their points and tile rows too
(`WORK_COUNTERS`); `launch_counts` reads them and `add_launches` adds to
them (a replayed CUDA graph launches what its capture recorded, which no
wrapper sees). `device_events` profiles a call on the card, and `kernel_events`
counts the ten kernels' launches in what it saw, so a count the
wrappers inferred can be held against the device's own."""
from __future__ import annotations

import importlib
import re
from typing import Callable, Dict, List, Tuple

# kernel: (module of its wrapper, the wrapper's launch count)
LAUNCH_COUNTERS = {
    "sigma_render": ("fused_render", "sigma_render_launches"),
    "render_eval": ("fused_render", "render_eval_launches"),
    "mse_render": ("fused_train", "mse_render_launches"),
    "train_fwd": ("fused_train", "train_fwd_launches"),
    "train_bwd": ("fused_train", "train_bwd_launches"),
    "mlp_fwd": ("fused_mlp", "mlp_fwd_launches"),
    "mlp_bwd": ("fused_mlp", "mlp_bwd_launches"),
    "sigma_fwd": ("fused_mlp", "sigma_fwd_launches"),
    "adam": ("adam", "adam_launches"),
    "relu_bgrad": ("relu_bgrad", "relu_bgrad_launches"),
}

# what the launches on rays covered (ops/fused_train.py): counter: (module,
# its int)
WORK_COUNTERS = {
    "ray_points": ("fused_train", "ray_points"),
    "ray_tile_rows": ("fused_train", "ray_tile_rows"),
}

# kernel: the __global__ function its wrapper launches once a call
# (mse_render and train_bwd are fwdbwd_kernel<false> and <true>)
KERNEL_SYMBOLS = {
    "sigma_render": "sigma_quad_kernel",
    "render_eval": "eval_quad_kernel",
    "mse_render": "fwdbwd_kernel",
    "train_fwd": "fwd_quad_kernel",
    "train_bwd": "fwdbwd_kernel",
    "mlp_fwd": "mlp_fwd_kernel",
    "mlp_bwd": "point_fwdbwd_kernel",
    "sigma_fwd": "sigma_fwd_kernel",
    "adam": "adam_kernel",
    "relu_bgrad": "relu_bgrad_kernel",
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts(work: bool = False) -> Dict[str, int]:
    """{kernel: launches so far} of the ten kernels, and with `work` the
    WORK_COUNTERS' counts too."""
    table = {**LAUNCH_COUNTERS, **WORK_COUNTERS} if work else LAUNCH_COUNTERS
    return {k: getattr(_module(mod), attr) for k, (mod, attr) in table.items()}


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add counts[k] * times to counter k: a kernel's launch count or one of
    WORK_COUNTERS."""
    for k, n in counts.items():
        mod, attr = LAUNCH_COUNTERS.get(k) or WORK_COUNTERS[k]
        m = _module(mod)
        setattr(m, attr, getattr(m, attr) + n * times)


def by_symbol(counts: Dict[str, int]) -> Dict[str, int]:
    """Launch counts {kernel: n} summed under each kernel's __global__
    function (the keys of kernel_events)."""
    out = {sym: 0 for sym in KERNEL_SYMBOLS.values()}
    for k, n in counts.items():
        out[KERNEL_SYMBOLS[k]] += n
    return out


def device_events(fn: Callable) -> Tuple[object, List]:
    """fn() under torch.profiler, synchronised: (what fn returned, the key
    averages of the device-side events). A kernel also appears under the
    aten op that launched it, on the host side, which is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e for e in prof.key_averages()
                 if e.device_type.name == "CUDA"]


def device_ms(events: List) -> float:
    """The summed device time of events, in ms."""
    return sum(e.self_device_time_total for e in events) / 1e3


def kernel_events(events: List) -> Dict[str, int]:
    """{__global__ function: launches the device ran} of the ten kernels
    among events, by name."""
    return {sym: sum(e.count for e in events
                     if re.search(rf"\b{sym}\b", e.key))
            for sym in KERNEL_SYMBOLS.values()}
