"""The plain reference of the NeRF configurations: the published method
(Mildenhall et al. 2020, kwea123/nerf_pl) in plain PyTorch, float32, no
kernel, no cache, no batching tricks. It imports nothing of the program.

  * positional encoding gamma(p) = (p, sin 2^k p, cos 2^k p, ...);
  * the D-layer MLP with its skip, the raw density head, the feature
    layer, the view layer on (feature, gamma(d)) and the sigmoid colour;
  * stratified depths, perturbed within their bins; hierarchical
    sampling by the inverse CDF of the coarse weights (nerf_pl's
    sample_pdf: eps 1e-5, det u = linspace); coarse and fine depths
    sorted together;
  * the quadrature of nerf_pl: alpha = 1 - exp(-delta relu(sigma +
    noise)), transmittance the cumprod of (1 - alpha + 1e-10), white
    background added as 1 - opacity;
  * the loss: MSE of the coarse plus MSE of the fine colour; Adam.
  * the occupancy-tightened placement the culled configuration states:
    each ray's [near, far] clipped to its box overlaps widened by the
    margin, the overlap's bits over n_seg equal segments (dilated), and
    the coarse depths a stratified inverse CDF over "occupied 1, empty
    eps".

`Matmul` is the one place precision enters: float32 with TF32 off, or
the control's float8 (e4m3) operands with a per-tensor scale, f32 sums.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

EPS_PDF = 1e-5


class Matmul:
    """x @ w at a stated operand precision, f32 sums."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8_e4m3fn"):
            raise ValueError(f"no reference matmul in {precision}")
        self.precision = precision

    @staticmethod
    def _fp8(t: torch.Tensor) -> torch.Tensor:
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (q - t).detach()     # straight-through for gradients

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return x @ w
        return self._fp8(x) @ self._fp8(w)


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    out = [x]
    for k in range(n_freqs):
        out += [torch.sin(2.0 ** k * x), torch.cos(2.0 ** k * x)]
    return torch.cat(out, dim=-1)


def mlp(p: Dict, model: Dict, x_emb: torch.Tensor,
        d_emb: Optional[torch.Tensor], mm: Matmul):
    """(rgb or None, raw sigma) of points; x_emb (P, 63), d_emb (P, 27)."""
    def lin(name, x):
        return mm(x, p[name]["w"]) + p[name]["b"]

    h = x_emb
    for i in range(model["D"]):
        if i in model["skips"]:
            h = torch.cat([x_emb, h], dim=-1)
        h = torch.relu(lin(f"xyz_{i}", h))
    sigma = lin("sigma", h)[:, 0]
    if d_emb is None:
        return None, sigma
    feat = lin("xyz_final", h)
    hd = torch.relu(lin("dir", torch.cat([feat, d_emb], dim=-1)))
    return torch.sigmoid(lin("rgb", hd)), sigma


def field(p, model, rays, z, mm, with_rgb=True):
    """The MLP at the points o + d z: (rgb (R, S, 3) or None, sigma
    (R, S))."""
    R, S = z.shape
    o, d = rays[:, 0:3], rays[:, 3:6]
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    x_emb = embed(pts, model["xyz_freqs"])
    d_emb = None
    if with_rgb:
        d_emb = embed(d, model["dir_freqs"])
        d_emb = d_emb[:, None, :].expand(R, S, d_emb.shape[-1]).reshape(
            R * S, -1)
    rgb, sigma = mlp(p, model, x_emb, d_emb, mm)
    return (None if rgb is None else rgb.reshape(R, S, 3),
            sigma.reshape(R, S))


def composite(sigma, z, rays, noise, rgb, white_back):
    """nerf_pl's quadrature: weights (R, S), and rgb, depth, opacity."""
    deltas = z[:, 1:] - z[:, :-1]
    deltas = torch.cat([deltas, 1e10 * torch.ones_like(deltas[:, :1])], -1)
    deltas = deltas * torch.linalg.norm(rays[:, 3:6], dim=-1, keepdim=True)
    if noise is not None:
        sigma = sigma + noise
    alphas = 1 - torch.exp(-deltas * torch.relu(sigma))
    alphas_shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                                1 - alphas + 1e-10], -1)
    weights = alphas * torch.cumprod(alphas_shifted, -1)[:, :-1]
    opacity = weights.sum(1)
    out = {"weights": weights, "opacity": opacity}
    if rgb is not None:
        c = torch.sum(weights[..., None] * rgb, -2)
        if white_back:
            c = c + 1 - opacity[:, None]
        out["rgb"] = c
        out["depth"] = torch.sum(weights * z, -1)
    return out


def sample_pdf(bins, weights, n, u):
    """nerf_pl's inverse-CDF sampling at the given u (R, n)."""
    weights = weights + EPS_PDF
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, weights.shape[1])
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_b, bins_a = torch.gather(bins, 1, below), torch.gather(bins, 1,
                                                                above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < EPS_PDF, torch.ones_like(denom), denom)
    return (bins_b + (u - cdf_b) / denom * (bins_a - bins_b)).detach()


def stratified(rays, n, perturb: Optional[torch.Tensor]):
    """n depths linear in [near, far]; with `perturb` (R, n) uniforms each
    moved within its bin."""
    near, far = rays[:, 6:7], rays[:, 7:8]
    t = torch.linspace(0, 1, n, device=rays.device)
    z = near * (1 - t) + far * t
    if perturb is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mids], -1)
        z = lower + (upper - lower) * perturb
    return z


def occupied_depths(rays, bits, n, perturb: Optional[torch.Tensor]):
    """n ascending depths, a stratified inverse CDF over the occupied
    segments (R, n_seg) of each ray's [near, far]."""
    R, n_seg = bits.shape
    near, far = rays[:, 6:7], rays[:, 7:8]
    edges = near + (far - near) * (torch.arange(
        n_seg + 1, device=rays.device, dtype=torch.float32) / n_seg)
    xi = perturb if perturb is not None else torch.full(
        (R, n), 0.5, device=rays.device)
    u = (torch.arange(n, device=rays.device, dtype=torch.float32) + xi) / n
    return sample_pdf(edges, bits, n, u)


def render(params: Dict, model: Dict, render_cfg: Dict, rays: torch.Tensor,
           mm: Matmul, draws: Optional[Dict] = None,
           bits: Optional[torch.Tensor] = None, test_time: bool = False):
    """Coarse and fine passes over rays (R, 8). Training: the draws
    perturb, noise_coarse, u, noise_fine (scaled by noise_std here). Test
    time: no perturbation, no noise, det u, the coarse pass sigma only.
    Returns {rgb_coarse (training), rgb_fine, depth_fine, opacity_fine,
    opacity_coarse}."""
    draws = draws or {}
    S, S_imp = render_cfg["N_samples"], render_cfg["N_importance"]
    ns = render_cfg.get("noise_std", 0.0)
    pert = draws.get("perturb")
    if bits is not None:
        z = occupied_depths(rays, bits, S, pert)
    else:
        z = stratified(rays, S, pert)

    def noise(name):
        return ns * draws[name] if ns > 0 and name in draws else None

    rgb_c, sig_c = field(params["nerf_coarse"], model, rays, z, mm,
                         with_rgb=not test_time)
    coarse = composite(sig_c, z, rays, noise("noise_coarse"), rgb_c,
                       render_cfg["white_back"])
    out = {"opacity_coarse": coarse["opacity"]}
    if not test_time:
        out["rgb_coarse"] = coarse["rgb"]
    if S_imp > 0:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        u = draws.get("u")
        if u is None:
            u = torch.linspace(0, 1, S_imp, device=rays.device).expand(
                rays.shape[0], S_imp)
        z_f = sample_pdf(mids, coarse["weights"][:, 1:-1].detach(), S_imp, u)
        z_all, _ = torch.sort(torch.cat([z, z_f], -1), -1)
        rgb_f, sig_f = field(params["nerf_fine"], model, rays, z_all, mm)
        fine = composite(sig_f, z_all, rays, noise("noise_fine"), rgb_f,
                         render_cfg["white_back"])
        out.update(rgb_fine=fine["rgb"], depth_fine=fine["depth"],
                   opacity_fine=fine["opacity"])
    return out


def loss_fn(out, rgbs):
    loss = torch.mean((out["rgb_coarse"] - rgbs) ** 2)
    if "rgb_fine" in out:
        loss = loss + torch.mean((out["rgb_fine"] - rgbs) ** 2)
    return loss


def lr_at(opt: Dict, step: int, steps_per_epoch: int) -> float:
    """steplr: lr x gamma^(milestones reached by the epoch)."""
    epoch = step / steps_per_epoch
    return opt["lr"] * opt["decay_gamma"] ** sum(
        epoch >= m for m in opt["decay_step"])


def train_steps(params0: Dict, model: Dict, render_cfg: Dict, opt: Dict,
                batches: List[Dict], steps_per_epoch: int, mm: Matmul,
                keep: Optional[slice] = None):
    """Adam steps from params0, one a batch {rays, rgbs, draws, bits}.
    `keep` (a fault's switch) trains step i on rows keep of its batch.
    Returns {losses, grads0 (the first step's gradients), params (after
    the last step)}, leaves as {mlp: {layer: {w, b}}}."""
    names = [(m, l, k) for m in params0 for l in params0[m]
             for k in ("w", "b")]
    p = {n: params0[n[0]][n[1]][n[2]].detach().clone().float()
         for n in names}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grads0 = [], None
    for i, b in enumerate(batches):
        leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
        tree: Dict = {}
        for (m, l, k), t in leaves.items():
            tree.setdefault(m, {}).setdefault(l, {})[k] = t
        sel = keep if keep is not None else slice(None)
        draws = {k: v[sel] for k, v in b["draws"].items()}
        bits = b.get("bits")
        out = render(tree, model, render_cfg, b["rays"][sel], mm, draws,
                     None if bits is None else bits[sel])
        loss = loss_fn(out, b["rgbs"][sel])
        g = torch.autograd.grad(loss, list(leaves.values()))
        g = dict(zip(leaves.keys(), g))
        if grads0 is None:
            grads0 = {n: t.detach() for n, t in g.items()}
        losses.append(float(loss.detach()))
        t = i + 1
        lr = lr_at(opt, i, steps_per_epoch)
        b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
        for n in names:
            mu[n] = b1 * mu[n] + (1 - b1) * g[n]
            nu[n] = b2 * nu[n] + (1 - b2) * g[n] * g[n]
            m_hat = mu[n] / (1 - b1 ** t)
            v_hat = nu[n] / (1 - b2 ** t)
            p[n] = (p[n] - lr * m_hat / (torch.sqrt(v_hat) + eps)).detach()
    return {"losses": losses, "grads0": grads0, "params": p}


def render_frame(params: Dict, model: Dict, ev: Dict, rays: torch.Tensor,
                 mm: Matmul, block: int = 8192) -> Dict[str, torch.Tensor]:
    """A test-time frame, in blocks of rays."""
    outs = []
    with torch.no_grad():
        for s in range(0, rays.shape[0], block):
            outs.append(render(params, model, dict(ev, white_back=True),
                               rays[s:s + block], mm, test_time=True))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


# -------------------------------------------------- occupancy (culled)

def _inv(d):
    eps = 1e-12
    return 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)


def box_overlap(boxes: torch.Tensor, rays: torch.Tensor):
    """Each ray's union of box overlaps within [near, far]: (hit, t_lo,
    t_hi)."""
    o, inv = rays[:, 0:3], _inv(rays[:, 3:6])
    near, far = rays[:, 6], rays[:, 7]
    hit = torch.zeros_like(near, dtype=torch.bool)
    lo = torch.full_like(near, float("inf"))
    hi = torch.full_like(near, float("-inf"))
    for box in boxes:
        t1, t2 = (box[0:3] - o) * inv, (box[3:6] - o) * inv
        tmin = torch.maximum(torch.minimum(t1, t2).amax(-1), near)
        tmax = torch.minimum(torch.maximum(t1, t2).amin(-1), far)
        ok = tmax >= tmin
        hit |= ok
        lo = torch.where(ok, torch.minimum(lo, tmin), lo)
        hi = torch.where(ok, torch.maximum(hi, tmax), hi)
    return hit, lo, hi


def tighten(rays, hit, lo, hi, margin):
    """[near, far] clipped to the overlap widened by margin, far >= near +
    1e-4; a ray that misses keeps its own."""
    near0, far0 = rays[:, 6], rays[:, 7]
    near = torch.where(hit, torch.maximum(near0, lo - margin), near0)
    far = torch.where(hit, torch.minimum(far0, hi + margin), far0)
    far = torch.maximum(far, near + 1e-4)
    return torch.cat([rays[:, :6], near[:, None], far[:, None]], 1)


def segment_bits(boxes: torch.Tensor, rays: torch.Tensor, n_seg: int,
                 dilate: int) -> torch.Tensor:
    """(R, n_seg) 0/1: segment s of the ray's [near, far] meets a box's
    overlap (all ones for a ray that meets none), dilated by `dilate`
    segments a side."""
    o, inv = rays[:, 0:3], _inv(rays[:, 3:6])
    near, far = rays[:, 6], rays[:, 7]
    h = (far - near) / torch.tensor(float(n_seg), device=rays.device)
    s0 = near[:, None] + torch.arange(n_seg, device=rays.device,
                                      dtype=torch.float32) * h[:, None]
    s1 = s0 + h[:, None]
    bits = torch.zeros((rays.shape[0], n_seg), dtype=torch.bool,
                       device=rays.device)
    for box in boxes:
        t1, t2 = (box[0:3] - o) * inv, (box[3:6] - o) * inv
        tmin = torch.maximum(torch.minimum(t1, t2).amax(-1), near)
        tmax = torch.minimum(torch.maximum(t1, t2).amin(-1), far)
        ok = tmax >= tmin
        bits |= (tmin[:, None] < s1) & (tmax[:, None] > s0) & ok[:, None]
    bits |= ~bits.any(-1, keepdim=True)
    for _ in range(dilate):
        grown = bits.clone()
        grown[:, 1:] |= bits[:, :-1]
        grown[:, :-1] |= bits[:, 1:]
        bits = grown
    return bits.float()
