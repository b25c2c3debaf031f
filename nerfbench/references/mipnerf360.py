"""The plain reference of the mip-NeRF 360 configuration: the published
method (Barron et al., CVPR 2022, arXiv:2111.12077, at
google-research/multinerf's configs/360.gin) in plain PyTorch, float32,
no kernel, no cache. It imports nothing of the program.

  * rays o + t d (d as the camera gives it, not normalised) with a pixel
    radius each; depths in s in [0, 1], t = 1 / (s / far + (1 - s) /
    near);
  * three levels: from the single interval [0, 1] of weight 1, 64, 64,
    then 32 samples by the inverse CDF of the previous level's step
    function, one jitter a ray (u = linspace(0, 1 - u_max, n) + jitter
    max_jitter), the sorted samples' midpoints the new endpoints, the
    outer two extrapolated and clamped to [0, 1], held fixed (no
    gradient);
  * a sample is a conical frustum whose Gaussian is mip-NeRF's eq. 7
    (mean o + mu_t d, covariance sigma_t^2 d d^T + sigma_r^2 (I - d d^T /
    |d|^2)), pushed through the contraction x -> (2 - 1/|x|) x/|x|
    outside the unit ball: mean contract(mu), covariance J Sigma J^T with
    J the contraction's Jacobian at mu, taken here by torch.func.jacfwd;
  * the axis-aligned integrated positional encoding of its diagonal over
    degrees 0-11, [sin(2^l mu) exp(-4^l var / 2), cos(...) ...], degree
    by degree;
  * the proposal MLP (4 x 256, density) at levels 0 and 1, the NeRF MLP
    (8 x 1024, the encoding again after layer 4, density, a 256-wide
    bottleneck, with gamma(d) of 4 degrees and its identity into a
    128-wide view layer, rgb) at level 2; density softplus(raw - 1), rgb
    sigmoid(raw) 1.002 - 0.001;
  * the quadrature: delta_i = (t_{i+1} - t_i) |d|, the last infinite,
    weights alpha_i prod_{j<i} (1 - alpha_j), the colour with the
    background's 1 - opacity (white);
  * the loss: the mean Charbonnier sqrt((c - c*)^2 + 0.001^2) of the NeRF
    level's colour; the interlevel loss against each proposal level, the
    mean of max(0, w_i - bound_i)^2 / (w_i + eps), bound_i the sum of the
    proposal weights whose intervals overlap interval i (found pair by
    pair), the NeRF level's s and w held fixed, at weight 1; the
    distortion loss, the mean over rays of the double sum sum_ij w_i w_j
    |m_i - m_j| + sum_i w_i^2 (s_{i+1} - s_i) / 3, at weight 0.01;
  * Adam (b1 0.9, b2 0.999, eps 1e-6) on the gradients clipped to a
    global norm of 1e-3 (multiplied by min(1, 1e-3 / (eps + norm))), the
    lr log-linear from 2e-3 to 2e-5 over 250,000 steps with 512 steps of
    warm-up eased by a sine from 0.01.

Departures from multinerf (also in the configuration's file): the
encoding is axis-aligned (no projection onto the icosahedral basis), the
proposal weights are neither dilated nor annealed, there are no GLO
vectors and no per-image exposure.

A step runs in blocks of rays whose losses are each divided by the whole
batch's counts, so that the blocks' gradients sum to the batch's; the
clip and Adam then see the summed gradient. `Matmul` is the one place
precision enters: float32 with TF32 off, or the control's float8 (e4m3)
operands with a per-tensor scale, f32 sums.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .nerf import Matmul, no_tf32

__all__ = ["Matmul", "no_tf32", "render", "train_steps", "lr_at"]

F32_EPS = 1.1920928955078125e-07


# ---------------------------------------------------------------- geometry

def s_to_t(s, near, far):
    return 1.0 / (s / far + (1 - s) / near)


def _contract_one(x: torch.Tensor) -> torch.Tensor:
    m2 = torch.clamp(torch.sum(x * x), min=F32_EPS)
    return torch.where(m2 <= 1, x, (2 - 1 / torch.sqrt(m2))
                       * x / torch.sqrt(m2))


def gaussians(rays, radii, sdist):
    """(mean, diag of the covariance) (R, S, 3) of the contracted frustum
    Gaussians of the intervals sdist (R, S + 1)."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    t = s_to_t(sdist, rays[:, 6:7], rays[:, 7:8])
    t0, t1 = t[:, :-1], t[:, 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = hw ** 2 / 3 - (4 / 15) * (hw ** 4 * (12 * mu ** 2 - hw ** 2)) \
        / (3 * mu ** 2 + hw ** 2) ** 2
    r = radii[:, None]
    r_var = r ** 2 * (mu ** 2 / 4 + (5 / 12) * hw ** 2
                      - (4 / 15) * hw ** 4 / (3 * mu ** 2 + hw ** 2))
    mean = o[:, None, :] + t_mean[..., None] * d[:, None, :]
    dd = d[:, :, None] * d[:, None, :]                        # (R, 3, 3)
    d2 = torch.clamp(torch.sum(d * d, -1), min=1e-10)[:, None, None]
    null = torch.eye(3, device=d.device) - dd / d2
    cov = t_var[..., None, None] * dd[:, None] \
        + r_var[..., None, None] * null[:, None]              # (R, S, 3, 3)
    flat = mean.reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacfwd(_contract_one))(flat)
    cov = torch.einsum("pij,pjk,plk->pil", jac, cov.reshape(-1, 3, 3), jac)
    mean_c = torch.func.vmap(_contract_one)(flat)
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    return mean_c.reshape(mean.shape), var.reshape(mean.shape)


def ipe(mean, var, min_deg=0, max_deg=12):
    sins, coss, damps = [], [], []
    for deg in range(min_deg, max_deg):
        damps.append(torch.exp(-0.5 * 4.0 ** deg * var))
        sins.append(torch.sin(2.0 ** deg * mean))
        coss.append(torch.cos(2.0 ** deg * mean))
    damp = torch.cat(damps, -1)
    return torch.cat([damp * torch.cat(sins, -1), damp * torch.cat(coss, -1)],
                     -1)


def dir_enc(v, deg=4):
    return torch.cat([v] + [torch.sin(2.0 ** k * v) for k in range(deg)]
                     + [torch.cos(2.0 ** k * v) for k in range(deg)], -1)


# --------------------------------------------------------------------- MLPs

def _lin(p, x, mm):
    return mm(x, p["w"]) + p["b"]


def prop_mlp(p, model, x, mm):
    h = x
    for i in range(model["prop"]["depth"]):
        h = torch.relu(_lin(p[f"layer_{i}"], h, mm))
    return torch.nn.functional.softplus(
        _lin(p["density"], h, mm)[:, 0] + model["density_bias"])


def nerf_mlp(p, model, x, d, mm):
    n = model["nerf"]
    h = x
    for i in range(n["depth"]):
        h = torch.relu(_lin(p[f"layer_{i}"], h, mm))
        if i % n["skip"] == 0 and i > 0:
            h = torch.cat([h, x], -1)
    density = torch.nn.functional.softplus(
        _lin(p["density"], h, mm)[:, 0] + model["density_bias"])
    h = torch.cat([_lin(p["bottleneck"], h, mm), d], -1)
    h = torch.relu(_lin(p["view"], h, mm))
    pad = model["rgb_padding"]
    rgb = torch.sigmoid(_lin(p["rgb"], h, mm)) * (1 + 2 * pad) - pad
    return density, rgb


# ------------------------------------------------------------------ sampler

def sample_intervals(sdist, w, n, jitter):
    """n intervals (R, n + 1) by the inverse CDF of the step function
    (sdist, w); jitter (R, 1) or None (the centres)."""
    R = sdist.shape[0]
    w = w / torch.sum(w, -1, keepdim=True)
    cw = torch.cat([torch.zeros((R, 1), device=w.device),
                    torch.clamp(torch.cumsum(w[:, :-1], -1), max=1),
                    torch.ones((R, 1), device=w.device)], -1)
    if jitter is None:
        pad = 1 / (2 * n)
        u = torch.linspace(pad, 1 - pad - F32_EPS, n,
                           device=w.device).expand(R, n)
    else:
        u_max = F32_EPS + (1 - F32_EPS) / n
        u = torch.linspace(0, 1 - u_max, n, device=w.device) \
            + jitter * ((1 - u_max) / (n - 1) - F32_EPS)
    k = cw.shape[1]
    idx = torch.sum(u[:, :, None] >= cw[:, None, :], -1)     # (R, n)
    i1 = torch.clamp(idx, max=k - 1)
    i0 = torch.clamp(idx - 1, min=0)
    c0, c1 = cw.gather(1, i0), cw.gather(1, i1)
    s0, s1 = sdist.gather(1, i0), sdist.gather(1, i1)
    frac = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), 0.0), 0, 1)
    c = s0 + frac * (s1 - s0)
    mid = (c[:, 1:] + c[:, :-1]) / 2
    first = torch.clamp(2 * c[:, :1] - mid[:, :1], min=0)
    last = torch.clamp(2 * c[:, -1:] - mid[:, -1:], max=1)
    return torch.cat([first, mid, last], -1).detach()


def quadrature(density, rays, sdist):
    t = s_to_t(sdist, rays[:, 6:7], rays[:, 7:8])
    delta = (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(rays[:, 3:6], dim=-1,
                                                       keepdim=True)
    alpha = 1 - torch.exp(-density * delta)
    alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], -1)
    keep = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                    1 - alpha[:, :-1]], -1), -1)
    return alpha * keep, t


def render(params, model, render_cfg, rays, radii, mm, jitter=None):
    """{sdist, weights (a list a level), rgb, distance} of rays (R, 8)."""
    R = rays.shape[0]
    sdist = torch.tensor([[0.0, 1.0]], device=rays.device).expand(R, 2)
    w = torch.ones((R, 1), device=rays.device)
    counts = list(render_cfg["num_prop_samples"]) + [
        render_cfg["num_nerf_samples"]]
    out = {"sdist": [], "weights": []}
    for level, n in enumerate(counts):
        j = None if jitter is None else jitter[:, level:level + 1]
        sdist = sample_intervals(sdist, w, n, j)
        mean, var = gaussians(rays, radii, sdist)
        x = ipe(mean, var, model["min_deg_point"],
                model["max_deg_point"]).reshape(R * n, -1)
        if level < len(counts) - 1:
            density = prop_mlp(params["prop_mlp"], model, x, mm)
        else:
            v = rays[:, 3:6] / torch.linalg.norm(rays[:, 3:6], dim=-1,
                                                 keepdim=True)
            d = dir_enc(v, model["deg_view"])[:, None, :].expand(
                R, n, -1).reshape(R * n, -1)
            density, rgb = nerf_mlp(params["nerf_mlp"], model, x, d, mm)
        w, t = quadrature(density.reshape(R, n), rays, sdist)
        out["sdist"].append(sdist)
        out["weights"].append(w)
    rgb = torch.sum(w[..., None] * rgb.reshape(R, n, 3), 1)
    out["rgb"] = rgb + torch.clamp(1 - torch.sum(w, -1, keepdim=True), min=0)
    out["distance"] = torch.sum(w * (t[:, 1:] + t[:, :-1]) / 2, -1)
    return out


# ------------------------------------------------------------------- losses

def overlap_bound(s, s_env, w_env):
    """For each interval of s (R, N + 1), the sum of w_env over the
    intervals of s_env (R, M + 1) that overlap it: s_env[j + 1] > s[i] and
    s_env[j] <= s[i + 1] (multinerf's outer measure), pair by pair."""
    lo_ok = s_env[:, None, 1:] > s[:, :-1, None]              # (R, N, M)
    hi_ok = s_env[:, None, :-1] <= s[:, 1:, None]
    return torch.sum((lo_ok & hi_ok) * w_env[:, None, :], -1)


def loss_sums(out, rgbs, loss_cfg):
    """The batch's three loss terms as sums over this block's rays (the
    caller divides by the batch's counts)."""
    data = torch.sum(torch.sqrt((out["rgb"] - rgbs) ** 2
                                + loss_cfg["charb_padding"] ** 2))
    s, w = out["sdist"][-1].detach(), out["weights"][-1].detach()
    inter = 0.0
    for s_env, w_env in zip(out["sdist"][:-1], out["weights"][:-1]):
        bound = overlap_bound(s, s_env, w_env)
        inter = inter + torch.sum(torch.clamp(w - bound, min=0) ** 2
                                  / (w + F32_EPS))
    s, w = out["sdist"][-1], out["weights"][-1]
    m = (s[:, 1:] + s[:, :-1]) / 2
    pair = torch.sum(w[:, :, None] * w[:, None, :]
                     * torch.abs(m[:, :, None] - m[:, None, :]), (1, 2))
    dist = torch.sum(pair + torch.sum(w ** 2 * (s[:, 1:] - s[:, :-1]), -1)
                     / 3)
    return data, inter, dist


def lr_at(opt: Dict, step: int) -> float:
    """multinerf's learning_rate_decay at `step`."""
    frac = min(max(step / opt["max_steps"], 0.0), 1.0)
    lr = math.exp(frac * (math.log(opt["lr_final"])
                          - math.log(opt["lr_init"]))
                  + math.log(opt["lr_init"]))
    if opt["lr_delay_steps"] > 0:
        m = opt["lr_delay_mult"]
        lr *= m + (1 - m) * math.sin(
            0.5 * math.pi * min(max(step / opt["lr_delay_steps"], 0.0), 1.0))
    return lr


def train_steps(params0: Dict, model: Dict, render_cfg: Dict, loss_cfg: Dict,
                opt: Dict, batches: List[Dict], mm: Matmul,
                keep: Optional[slice] = None, block: int = 2048):
    """Clipped Adam steps from params0, one a batch {rays, rgbs, radii,
    draws: {jitter}}, each in blocks of `block` rays. `keep` (a fault's
    switch) trains on rows keep of each batch. Returns {losses, grads0
    (the first step's clipped gradients), clip0 (the first step's clip
    factor), params (after the last step)}, leaves keyed (mlp, layer,
    w|b)."""
    names = [(m, l, k) for m in params0 for l in params0[m]
             for k in ("w", "b")]
    p = {n: params0[n[0]][n[1]][n[2]].detach().clone().float()
         for n in names}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grads0, clip0 = [], None, None
    n_nerf = render_cfg["num_nerf_samples"]
    for i, b in enumerate(batches):
        sel = keep if keep is not None else slice(None)
        rays, rgbs = b["rays"][sel], b["rgbs"][sel]
        radii, jitter = b["radii"][sel], b["draws"]["jitter"][sel]
        R = rays.shape[0]
        g = {n: torch.zeros_like(t) for n, t in p.items()}
        loss = 0.0
        for s0 in range(0, R, block):
            sl = slice(s0, s0 + block)
            leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
            tree: Dict = {}
            for (m, l, k), t in leaves.items():
                tree.setdefault(m, {}).setdefault(l, {})[k] = t
            out = render(tree, model, render_cfg, rays[sl], radii[sl], mm,
                         jitter[sl])
            data, inter, dist = loss_sums(out, rgbs[sl], loss_cfg)
            part = (data / (R * 3) + loss_cfg["interlevel_mult"] * inter
                    / (R * n_nerf) + loss_cfg["distortion_mult"] * dist / R)
            grads = torch.autograd.grad(part, list(leaves.values()))
            for n, gn in zip(leaves, grads):
                g[n] += gn
            loss += float(part.detach())
        norm = torch.sqrt(sum(torch.sum(t.double() ** 2)
                              for t in g.values())).float()
        scale = torch.clamp(opt["grad_max_norm"] / (F32_EPS + norm), max=1)
        g = {n: t * scale for n, t in g.items()}
        if grads0 is None:
            grads0 = {n: t.detach().clone() for n, t in g.items()}
            clip0 = float(scale)
        losses.append(loss)
        t = i + 1
        lr = lr_at(opt, i)
        b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
        for n in names:
            mu[n] = b1 * mu[n] + (1 - b1) * g[n]
            nu[n] = b2 * nu[n] + (1 - b2) * g[n] * g[n]
            m_hat = mu[n] / (1 - b1 ** t)
            v_hat = nu[n] / (1 - b2 ** t)
            p[n] = (p[n] - lr * m_hat / (torch.sqrt(v_hat) + eps)).detach()
    return {"losses": losses, "grads0": grads0, "clip0": clip0, "params": p}
