"""The render runner: the program's full-image renderer
(`make_render_fn`, the fused test-time path: sigma_render, sample_pdf,
render_eval) serving one viewer in a closed loop.

Set-up makes the weights and the path's cameras from the seed on the
device and renders `warmup_frames` frames (the kernels' build and load).
The window then asks for the path's next pose each time the last frame's
outputs (rgb, depth and the opacities) are on the host, until `seconds`
have passed; a frame's latency is from its request to its outputs on the
host. With `trace` the window is `trace_frames` frames under the
profiler.

After the window, `checked_frames` frames drawn from the seed among the
first `frames_due` served (the last one served if none of them was) are
rendered again by the reference and compared ray by ray. Only those
frames' outputs are kept: a viewer drops a frame once it is shown.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from nerfbench import check, faults, inputs
from nerfbench import trace as T
from nerfbench.references import nerf as ref
from nerfbench.work import frame_work


def _renderer(cfg: Dict, device):
    from nerf_pl_tpu_torch.parallel import render
    from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig
    ev = cfg["eval"]
    rcfg = RenderConfig(N_samples=ev["N_samples"],
                        N_importance=ev["N_importance"], perturb=0.0,
                        noise_std=0.0, white_back=True, test_time=True,
                        fused=True)
    return render.make_render_fn(rcfg, ev["chunk"], device, ModelConfig())


def reference_frames(cell: Dict, seed: int, frames, device,
                     precision: str = "float32") -> Dict[int, Dict]:
    """The reference's outputs of the given frame indices of the path."""
    cfg = cell["config"]
    ev = cfg["eval"]
    ref.no_tf32()
    params = inputs.make_params(cfg["model"], seed, device,
                                cfg["eval"]["sigma_abs_scale"])
    return {k: ref.render_frame(params, cfg["model"], ev,
                                inputs.frame_rays(ev, k % ev["poses"],
                                                  device),
                                ref.Matmul(precision))
            for k in frames}


def run(cell: Dict, seed: int, seconds: float, trace: bool,
        start_wall: float, device="cuda", fault: Optional[str] = None
        ) -> Dict:
    """One run of a render cell: the frames' measurements and the check's
    numbers."""
    device = torch.device(device)
    with faults.planted(fault):
        res = _serve(cell, seed, seconds, trace, start_wall, device)
    outs, picked = res.pop("outs"), res["checked_frames"]
    t0 = time.perf_counter()
    refs = reference_frames(cell, seed, picked, device)
    res["numbers"] = check.worst(
        check.render_numbers({k: torch.as_tensor(v) for k, v in
                              outs[i].items()}, refs[i]) for i in picked)
    res["check_s"] = time.perf_counter() - t0
    return res


def _serve(cell, seed, seconds, trace, start_wall, device):
    cfg, mix = cell["config"], cell["traffic"]
    ev = cfg["eval"]
    params = inputs.make_params(cfg["model"], seed, device,
                                ev["sigma_abs_scale"])
    cams = [inputs.frame_rays(ev, k, device) for k in range(ev["poses"])]
    render = _renderer(cfg, device)
    for k in range(mix["warmup_frames"]):
        render(params, cams[k % len(cams)])
    t_window = time.time()

    # the frames the check reads: drawn from the seed before the window,
    # among the first `frames_due` a window holds, and the last frame
    # served (so a slower program still has one checked)
    rng = np.random.default_rng(inputs.stream_seed(seed, "check"))
    picks = set(rng.choice(mix["frames_due"], size=mix["checked_frames"],
                           replace=False).tolist())
    kept, lats = {}, []

    def window(limit_s: Optional[float], n_frames: Optional[int]) -> int:
        t0 = time.perf_counter()
        k = 0
        while True:
            t = time.perf_counter()
            out = render(params, cams[k % len(cams)])
            end = time.perf_counter()
            lats.append(end - t)
            if k - 1 not in picks:
                kept.pop(k - 1, None)
            kept[k] = out
            k += 1
            if (k >= n_frames if n_frames is not None
                    else end - t0 >= limit_s):
                return k

    res = {"traces": []}
    if trace:
        tr_ = T.traced(lambda: window(None, mix["trace_frames"]),
                       device.type == "cuda")
        res["traces"] = [tr_]
        window_s = tr_.window_s
    else:
        t0 = time.perf_counter()
        window(seconds, None)
        window_s = time.perf_counter() - t0
    n = len(lats)
    res["attempted"] = n
    res["failed"] = sum(not all(np.isfinite(v).all() for v in o.values())
                        for o in kept.values())
    res["e2e"] = {"frame_ms": 1e3 * window_s / n,
                  "frame_p95_ms": 1e3 * float(np.percentile(lats, 95)),
                  "setup_s": t_window - start_wall}
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    W, H = ev["img_wh"]
    res["ctx"] = {"kind": "render", "model": cfg["model"], "world": 1,
                  "unit": frame_work(cfg, W * H)}
    del render, cams, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    res["checked_frames"] = sorted(k for k in kept if k in picks) or [n - 1]
    res["outs"] = kept
    return res
