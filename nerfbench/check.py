"""The numbers that decide `correct`, and their limits.

Training (the first `checked_steps` steps of the object the window then
drives, against the reference's from the same weights, rows and draws):
  loss_gap    the widest |loss - ref| / ref over the steps;
  grad_gap    the first gradient as the optimizer got it (Adam's first
              moment after one step over 1 - b1), by the median leaf of
              |norm - ref norm| / max(ref norm, the median leaf's ref
              norm). Not the worst leaf: one ray whose last sample sits
              at relu's kink flips between the bf16 and f32 paths (its
              last interval is 1e10) and moves the few leaves it feeds by
              as much as the control moves them all (PERF.md, section 2);
              the worst leaf is kept as grad_gap_worst, not compared;
  change_gap  the parameters' change over the steps, the same measure,
              over the leaves whose reference gradient is at least a
              thousandth of the median leaf's (the others move under Adam
              by round-off alone).
Render (sampled frames of the window against the reference's frames):
  rgb_gap, depth_gap: the widest absolute gap over the frames' rays.
  (The render field's opacity is 1 on every ray, in the program and in
  the control alike, so it separates nothing and is not compared.)
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Tuple

import torch

Leaves = Dict[Tuple[str, str, str], torch.Tensor]
SMALL_GRAD = 1e-3


def flatten(tree: Dict) -> Leaves:
    """{mlp: {layer: {w, b}}} -> {(mlp, layer, w|b): tensor} as f32 on
    the CPU."""
    return {(m, l, k): t.detach().float().cpu()
            for m, layers in tree.items() for l, leaf in layers.items()
            for k, t in leaf.items()}


def _norms(leaves: Leaves) -> Dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in
            leaves.items()}


def leaf_gaps(prog: Leaves, ref: Leaves, names: Iterable) -> list:
    """|norm(prog) - norm(ref)| / max(norm(ref), the median leaf's
    norm(ref)), a leaf each."""
    names = list(names)
    pn, rn = _norms({n: prog[n] for n in names}), _norms(
        {n: ref[n] for n in names})
    med = statistics.median(rn.values())
    return [abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names]


def train_numbers(prog: Dict, ref: Dict, params0: Leaves) -> Dict[str, float]:
    """prog: {losses, grads0, params} of the program (leaves flattened),
    ref: the reference's train_steps result."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            torch.isfinite(torch.tensor(prog["losses"]))):
        losses.append(float("inf"))
    gref = {n: t.detach().float().cpu() for n, t in ref["grads0"].items()}
    gnorm = _norms(gref)
    med = statistics.median(gnorm.values())
    moving = [n for n in gref if gnorm[n] >= SMALL_GRAD * med]
    pref = {n: t.detach().float().cpu() for n, t in ref["params"].items()}
    dprog = {n: prog["params"][n] - params0[n] for n in moving}
    dref = {n: pref[n] - params0[n] for n in moving}
    grads = leaf_gaps(prog["grads0"], gref, gref.keys())
    return {"loss_gap": max(losses),
            "grad_gap": statistics.median(grads),
            "grad_gap_worst": max(grads),
            "change_gap": max(leaf_gaps(dprog, dref, moving))}


def render_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog, ref: {rgb_fine, depth_fine, ...} tensors over the same
    rays."""
    def gap(k):
        return float((prog[k].float().cpu() - ref[k].float().cpu()).abs()
                     .max())
    return {"rgb_gap": gap("rgb_fine"), "depth_gap": gap("depth_fine")}


def worst(numbers: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for d in numbers:
        for k, v in d.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}}). A number
    that is not finite, or a limit with no number, is not correct."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
