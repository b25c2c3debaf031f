"""The work of the mip-NeRF 360 configuration: what `mfu.mip360` and
`mlp_gemm_roofline.mip360` read. `work.py` counts the NeRF configurations
and is not this one's.

Operations are counted at the published widths of both MLPs, from the
configuration's file alone (nothing of the program): the proposal MLP
(IPE 72 -> 4 x 256 -> density) at each proposal sample of both proposal
levels, the NeRF MLP (IPE 72 -> 8 x 1024, the IPE again into layer 5,
density, a 256-wide bottleneck, the bottleneck and gamma(d) 27 wide into a
128-wide view layer, rgb) at each NeRF sample. A training point counts its
forward and backward once, as `work.py` counts them: the forward, every
weight gradient (as many operations as the forward) and the data gradient
of every product's input except the encodings (the IPE at layer 0 and at
the skip, gamma(d) at the view layer). At 16,384 rays of 64 + 64 + 32
samples that is 26.97 TFLOP a step; the products dominate so far that the
bytes are not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from nerfbench.work import BF16_FLOPS_PER_S

Layer = Tuple[int, int, int]     # fan_in, fan_out, encoding columns


def layer_dims(model: Dict) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """{mlp: {layer: (fan_in, fan_out)}} of both MLPs, in the program's
    layer names and init order (the benchmark's weights are made from
    it)."""
    return {m: {name: (fi, fo) for name, (fi, fo, _) in layers.items()}
            for m, layers in _layers(model).items()}


def _layers(model: Dict) -> Dict[str, Dict[str, Layer]]:
    k = 6 * (model["max_deg_point"] - model["min_deg_point"])
    kd = 3 + 6 * model["deg_view"]
    pr, nf = model["prop"], model["nerf"]
    prop = {f"layer_{i}": ((k, pr["width"], k) if i == 0 else
                           (pr["width"], pr["width"], 0))
            for i in range(pr["depth"])}
    prop["density"] = (pr["width"], 1, 0)
    w, nerf = nf["width"], {}
    for i in range(nf["depth"]):
        if i == 0:
            nerf[f"layer_{i}"] = (k, w, k)
        elif (i - 1) % nf["skip"] == 0 and i > 1:
            nerf[f"layer_{i}"] = (w + k, w, k)
        else:
            nerf[f"layer_{i}"] = (w, w, 0)
    nerf["density"] = (w, 1, 0)
    nerf["bottleneck"] = (w, nf["bottleneck"], 0)
    nerf["view"] = (nf["bottleneck"] + kd, nf["view_width"], kd)
    nerf["rgb"] = (nf["view_width"], 3, 0)
    return {"prop_mlp": prop, "nerf_mlp": nerf}


def flops_per_point(model: Dict, mlp: str, train: bool = True) -> int:
    """2 x the multiply-adds of one point through `mlp`, forward only or
    (train) forward, weight gradients and data gradients."""
    layers: List[Layer] = list(_layers(model)[mlp].values())
    fwd = sum(fi * fo for fi, fo, _ in layers)
    if not train:
        return 2 * fwd
    data = sum((fi - enc) * fo for fi, fo, enc in layers)
    return 2 * (fwd + fwd + data)


def n_params(model: Dict) -> int:
    return sum(fi * fo + fo for layers in layer_dims(model).values()
               for fi, fo in layers.values())


def train_step_work(cfg: Dict, rays: int) -> Dict:
    """A training step over `rays` rays: the operations of both MLPs'
    products, and the points each MLP takes."""
    r, m = cfg["render"], cfg["model"]
    prop_pts = rays * sum(r["num_prop_samples"])
    nerf_pts = rays * r["num_nerf_samples"]
    ops = (prop_pts * flops_per_point(m, "prop_mlp")
           + nerf_pts * flops_per_point(m, "nerf_mlp"))
    return {"ops": ops, "prop_points": prop_pts, "nerf_points": nerf_pts}


def least_s(ops: float) -> float:
    """The least time of the products: their operations at the bf16
    peak."""
    return ops / BF16_FLOPS_PER_S
