#!/usr/bin/env python
"""Hold this checkout's kernels against another checkout's build of them,
on one NVIDIA GPU, and time both:

    git archive <commit> | tar -x -C build/parent
    python tools/check_kernels_parent.py build/parent [--kernels a,b,...]

Builds every `nerf_pl_tpu_torch/csrc/*.cu` of the other checkout with this
checkout's nvcc flags into `<dir>/build/parent_kernels.so` and reads the
signature of each C entry of either build from its sources
(`_build.c_entries`, as tests/test_torch_kernel_sources.py reads them): an
entry gets its arguments by name, the weights' transposed copies (wdfT,
wfT, wtT) only where it takes them, as the kernels before their Hopper
redesign did. Both builds then run on the same rays, depths, noise,
targets, points and weights:

  * mse_render at (R, S) = (8, 64), (1024, 64), (1024, 128), (37, 192),
    and culled32's (1024, 32), (1024, 96) with a ragged (37, 96);
  * train_fwd at the same shapes (white background);
  * train_bwd (through its C entry, nerf_train_bwd) on the rgb cotangent
    2 scale (rgb - gt) at the same shapes;
  * mlp_bwd at P = 131,072;
  * mlp_fwd at P = 65,536 and 131,072 (a dense training step's coarse and
    fine pass);
  * render_eval at (R, S) = (4099, 64), (32768, 128) and (32768, 192)
    (white background; the eval chunk at 64 + 64 and 64 + 128 samples);
  * sigma_render at (R, S) = (4099, 64), (32768, 64) and (32768, 128)
    (the eval chunk's coarse pass);
  * sigma_fwd at P = 262,144 and 2,097,152 (the coarse pass of a perturbed
    test-time chunk of 4096 and of 32768 rays at 64 samples).

out8, the weights and the render kernels' outputs are held at the
kernels' bars (weights 5e-3, rgb and opacity 1e-2, depth 5e-2), mlp_fwd's
rgb within 5e-3, raw sigma (mlp_fwd's and sigma_fwd's) within 5e-3 x
max(1, max |sigma|), and each of the 17 gradient leaves within 0.03
relative max error. A kernel redesigned on wgmma sums in another order
than the WMMA products of an earlier build, so it is not bit for bit the
parent's; a kernel whose code did not change should be, and each line
says whether its outputs are bit-identical to the parent build's (the
training kernels' forward, out8 and weights, and their gradients apart:
another grouping of rays into blocks changes only the order in which the
gradients are summed). Each training kernel's launch A is also profiled
once in each build: its grid, rays a block (R over the grid, rounded up),
block threads and shared memory as the runtime recorded the launch, and
its padding share, 1 - R S over its tile rows (`nerf_ray_tile_rows`, or
for a build without that entry the whole tiles of the grid's blocks).
Both
builds are called the same way, through their C entries with outputs and
workspace allocated once (the wrappers' checks and allocations would add
host time to one side only). Prints the median ms of each build at each
shape (parent, this, this, parent in turn; 10 runs each) and the ratio
parent / this. `--kernels` runs only the named kernels (comma-separated;
default all). Exits non-zero past a bar.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from nerf_pl_tpu_torch.models import init_nerf_params  # noqa: E402
from nerf_pl_tpu_torch.ops import _build  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_mlp as fm  # noqa: E402

SHAPES = ((8, 64), (1024, 64), (1024, 128), (37, 192), (1024, 32),
          (1024, 96), (37, 96))
MLP_P = 131072
MLP_FWD_P = (65536, 131072)
EVAL_SHAPES = ((4099, 64), (32768, 128), (32768, 192))
SIGMA_SHAPES = ((4099, 64), (32768, 64), (32768, 128))
SIGMA_FWD_P = (262144, 2097152)
KERNELS = ("mse_render", "train_fwd", "train_bwd", "mlp_bwd", "mlp_fwd",
           "render_eval", "sigma_render", "sigma_fwd")
POINT_TOL = 5e-3
TOL = {"weights": 5e-3, "rgb": 1e-2, "opacity": 1e-2, "depth": 5e-2}
GRAD_TOL = 0.03
ENTRIES = ("nerf_mse_workspace_bytes", "nerf_mlp_workspace_bytes",
           "nerf_mse_render", "nerf_train_fwd", "nerf_train_bwd",
           "nerf_mlp_bwd", "nerf_mlp_fwd", "nerf_render_eval",
           "nerf_sigma_render", "nerf_sigma_fwd")


def entries_of(root: Path):
    """{name: (result, [(type, argument)])} of a checkout's C entries."""
    entries = {}
    for src in sorted((root / "nerf_pl_tpu_torch" / "csrc").glob("*.cu")):
        entries.update(_build.c_entries(src.read_text()))
    return entries


def build_other(root: Path) -> Path:
    """The other checkout's kernels as a library of their own."""
    out = root / "build" / "parent_kernels.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    srcs = sorted((root / "nerf_pl_tpu_torch" / "csrc").glob("*.cu"))
    objs = [out.parent / f"parent.{s.stem}.o" for s in srcs]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                     for s, o in zip(srcs, objs)])
    _build._run_all([[nvcc, "-shared", "-o", str(out), *map(str, objs),
                      *_build.LINK_FLAGS]])
    return out


def median_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_pair(parent, here):
    """Median ms of parent and this build, in the order parent, this,
    this, parent."""
    p1, h1, h2, p2 = (median_ms(parent), median_ms(here), median_ms(here),
                      median_ms(parent))
    return statistics.median([p1, p2]), statistics.median([h1, h2])


def same_bits(got, ref):
    """Whether every tensor of got equals its partner in ref bit for bit."""
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def rel_errs(got, ref):
    return [((a - b).abs().max() / b.abs().max()).item()
            if b.abs().max() > 0 else float(a.abs().max() > 0)
            for a, b in zip(got, ref)]


class Build:
    """One build's kernels, each called through its C entry with its
    arguments looked up by name, and outputs allocated once per shape."""

    def __init__(self, path: Path, entries, mlp):
        self.lib = ctypes.CDLL(str(path))
        self.tile_rows = None                  # a build from before it
        if "nerf_ray_tile_rows" in entries:
            self.tile_rows = self.lib.nerf_ray_tile_rows
            self.tile_rows.argtypes = [ctypes.c_int, ctypes.c_int]
            self.tile_rows.restype = ctypes.c_longlong
        self.names = {}
        for name in ENTRIES:
            result, args = entries[name]
            fn = getattr(self.lib, name)
            fn.argtypes = [_build.CTYPES[kind] for kind, _ in args]
            fn.restype = _build.CTYPES[result]
            self.names[name] = [arg for _, arg in args]
        k = mlp.kernel
        self.tensors = dict(k)                 # kept alive: the pointers
        if any({"wdfT", "wfT", "wtT"} & set(a) for a in self.names.values()):
            self.tensors.update(wdfT=k["wdf"].t().contiguous(),
                                wfT=k["wf"].t().contiguous(),
                                wtT=k["wt"].transpose(1, 2).contiguous())
        self.w = {n: t.data_ptr() for n, t in self.tensors.items()}
        self.stream = torch.cuda.current_stream().cuda_stream

    def call(self, name, **values):
        args = {**self.w, "stream": self.stream, **values}
        err = getattr(self.lib, name)(*(args[n] for n in self.names[name]))
        if err:
            raise RuntimeError(f"{name} returned {err}")

    def mse(self, rays, z, noise, gt, scale):
        R, S = z.shape
        dev = rays.device
        out8, w = torch.empty((R, 8), device=dev), torch.empty((R, S),
                                                               device=dev)
        grad = torch.empty((fm.GRAD_FLOATS,), device=dev)
        ws = torch.empty((self.lib.nerf_mse_workspace_bytes(R, S),),
                         dtype=torch.uint8, device=dev)

        def run():
            self.call("nerf_mse_render", rays=rays.data_ptr(),
                      z=z.data_ptr(), noise=noise.data_ptr(),
                      gt=gt.data_ptr(), R=R, S=S, white_back=1, scale=scale,
                      out8=out8.data_ptr(), weights=w.data_ptr(),
                      workspace=ws.data_ptr(), grad=grad.data_ptr())
            return out8, w, fm._pack_layout_grads(grad)
        return run

    def train_fwd(self, rays, z, noise):
        R, S = z.shape
        out8 = torch.empty((R, 8), device=rays.device)
        w = torch.empty((R, S), device=rays.device)

        def run():
            self.call("nerf_train_fwd", rays=rays.data_ptr(),
                      z=z.data_ptr(), noise=noise.data_ptr(), R=R, S=S,
                      white_back=1, out8=out8.data_ptr(),
                      weights=w.data_ptr())
            return out8, w
        return run

    def train_bwd(self, rays, z, noise, g8):
        R, S = z.shape
        grad = torch.empty((fm.GRAD_FLOATS,), device=rays.device)
        ws = torch.empty((self.lib.nerf_mse_workspace_bytes(R, S),),
                         dtype=torch.uint8, device=rays.device)

        def run():
            self.call("nerf_train_bwd", rays=rays.data_ptr(),
                      z=z.data_ptr(), noise=noise.data_ptr(),
                      g8=g8.data_ptr(), gw=None, R=R, S=S, white_back=1,
                      workspace=ws.data_ptr(), grad=grad.data_ptr())
            return fm._pack_layout_grads(grad)
        return run

    def mlp_bwd(self, x8, d8, cot):
        P = x8.shape[0]
        grad = torch.empty((fm.GRAD_FLOATS,), device=x8.device)
        ws = torch.empty((self.lib.nerf_mlp_workspace_bytes(P),),
                         dtype=torch.uint8, device=x8.device)

        def run():
            self.call("nerf_mlp_bwd", p8=x8.data_ptr(), d8=d8.data_ptr(),
                      g8=cot.data_ptr(), P=P, workspace=ws.data_ptr(),
                      grad=grad.data_ptr())
            return fm._pack_layout_grads(grad)
        return run

    def mlp_fwd(self, x8, d8):
        out8 = torch.empty((x8.shape[0], 8), device=x8.device)

        def run():
            self.call("nerf_mlp_fwd", p8=x8.data_ptr(), d8=d8.data_ptr(),
                      P=x8.shape[0], out8=out8.data_ptr())
            return out8
        return run

    def render_eval(self, rays, z):
        R, S = z.shape
        rgb = torch.empty((R, 3), device=rays.device)
        depth = torch.empty((R,), device=rays.device)
        opacity = torch.empty((R,), device=rays.device)

        def run():
            self.call("nerf_render_eval", rays=rays.data_ptr(),
                      z=z.data_ptr(), R=R, S=S, white_back=1,
                      rgb=rgb.data_ptr(), depth=depth.data_ptr(),
                      opacity=opacity.data_ptr())
            return {"rgb": rgb, "depth": depth, "opacity": opacity}
        return run

    def sigma_render(self, rays, z):
        R, S = z.shape
        w = torch.empty((R, S), device=rays.device)
        opacity = torch.empty((R,), device=rays.device)

        def run():
            self.call("nerf_sigma_render", rays=rays.data_ptr(),
                      z=z.data_ptr(), R=R, S=S, weights=w.data_ptr(),
                      opacity=opacity.data_ptr())
            return {"weights": w, "opacity": opacity}
        return run

    def sigma_fwd(self, x8):
        sigma = torch.empty((x8.shape[0],), device=x8.device)

        def run():
            self.call("nerf_sigma_fwd", p8=x8.data_ptr(), P=x8.shape[0],
                      sigma=sigma.data_ptr())
            return sigma
        return run


def compare(what, got, ref, out=None):
    """Prints and returns the failures of gradients `got` against `ref`
    (none if `got` is None) and, with out = ((out8, w), (ref8, ref_w)),
    of the forward's outputs."""
    bad, parts, same = [], [], []
    if out is not None:
        (o8, w), (r8, rw) = out
        errs = {"rgb": (o8[:, :3] - r8[:, :3]).abs().max().item(),
                "depth": (o8[:, 3] - r8[:, 3]).abs().max().item(),
                "opacity": (o8[:, 4] - r8[:, 4]).abs().max().item(),
                "weights": (w - rw).abs().max().item()}
        parts.append(", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        bad += [k for k, v in errs.items() if not v <= TOL[k]]
        same.append(f"out8 and weights {same_bits((o8, w), (r8, rw))}")
    if got is not None:
        rels = rel_errs(got, ref)
        parts.append("grad rel per leaf " + " ".join(f"{r:.2e}" for r in rels))
        bad += [f"grad {i}" for i, r in enumerate(rels) if not r <= GRAD_TOL]
        same.append(f"gradients {same_bits(got, ref)}")
    parts.append("bit-identical to the parent: " + ", ".join(same))
    print(f"[parent] {what}: " + "; ".join(parts)
          + (f"  FAIL {bad}" if bad else ""))
    return bad


def ray_batch(R, S, g, dev):
    """Rays (R, 8) through the unit cube, sorted depths, noise and
    targets."""
    o = torch.randn((R, 3), generator=g, device=dev)
    d = torch.nn.functional.normalize(
        torch.randn((R, 3), generator=g, device=dev), dim=-1)
    rays = torch.cat([o, d, torch.full((R, 1), 2.0, device=dev),
                      torch.full((R, 1), 6.0, device=dev)], -1)
    z = torch.sort(2 + 4 * torch.rand((R, S), generator=g, device=dev),
                   -1).values.contiguous()
    noise = torch.randn((R, S), generator=g, device=dev)
    gt = torch.rand((R, 3), generator=g, device=dev)
    return rays, z, noise, gt


def point_batch(P, g, dev):
    """(P, 8) raw points and unit directions, and a cotangent of ~1 / P."""
    x8 = torch.zeros((P, 8), device=dev)
    x8[:, :3] = 2 * torch.randn((P, 3), generator=g, device=dev)
    d8 = torch.zeros((P, 8), device=dev)
    d8[:, :3] = torch.nn.functional.normalize(
        torch.randn((P, 3), generator=g, device=dev), dim=-1)
    cot = torch.zeros((P, 8), device=dev)
    cot[:, :4] = torch.randn((P, 4), generator=g, device=dev) / P
    return x8, d8, cot


def report_time(what, parent, here):
    tp, th = timed_pair(parent, here)
    print(f"[time] {what}: parent {tp:.3f} ms, this {th:.3f} ms, "
          f"parent / this {tp / th:.2f}x")


def launch_a(fn, kernel):
    """{(grid, block, shared memory bytes)} of the launches of `kernel`
    that fn() makes, as the runtime recorded them (the profiler's trace of
    the card; a field it did not record reads None)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = REPO / "build" / "check_kernels_parent_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return {(tuple(a.get("grid") or ()), tuple(a.get("block") or ()),
             a.get("shared memory"))
            for e in events if e.get("cat") == "kernel"
            and kernel in e.get("name", "") for a in (e.get("args", {}),)}


def report_launch(what, kernel, R, S, builds):
    """Prints launch A's geometry and padding share in each build of
    builds {label: (Build, fn)}; returns whether the geometries agree."""
    seen, parts = [], []
    for label, (b, fn) in builds.items():
        launches = launch_a(fn, kernel)
        seen.append(launches)
        for grid, block, smem in sorted(launches, key=str):
            n = grid[0] if grid else None
            rpb = -(-R // n) if n else None
            rows = (b.tile_rows(R, S) if b.tile_rows is not None else
                    n * -(-rpb * S // 128) * 128 if n else None)
            pad = f"{1 - R * S / rows:.4f}" if rows else "not recorded"
            parts.append(f"{label} grid {n}, {rpb} rays a block, block "
                         f"{block[0] if block else None}, shared memory "
                         f"{smem}, tile rows {rows}, padding {pad}")
    same = len(seen) == 2 and seen[0] == seen[1]
    print(f"[launch] {what} {kernel}: " + "; ".join(parts)
          + f"; same launches: {same}")
    return same


def check_training(old, new, run, g, dev):
    """mse_render, train_fwd and train_bwd at SHAPES; returns failures."""
    failed = []
    for R, S in SHAPES:
        rays, z, noise, gt = ray_batch(R, S, g, dev)
        scale = 1.0 / (R * 3)
        here_mse = new.mse(rays, z, noise, gt, scale)
        parent_mse = old.mse(rays, z, noise, gt, scale)
        h8, hw, hg = here_mse()
        p8, pw, pg = parent_mse()
        torch.cuda.synchronize()
        pairs = {}
        if "mse_render" in run:
            failed += compare(f"mse_render R={R} S={S}", hg, pg,
                              ((h8, hw), (p8, pw)))
            pairs["mse_render"] = (parent_mse, here_mse)
        if "train_fwd" in run:
            here_tf = new.train_fwd(rays, z, noise)
            parent_tf = old.train_fwd(rays, z, noise)
            here_f, parent_f = here_tf(), parent_tf()
            torch.cuda.synchronize()
            failed += compare(f"train_fwd R={R} S={S}", None, None,
                              (here_f, parent_f))
            pairs["train_fwd"] = (parent_tf, here_tf)
        if "train_bwd" in run:
            g8 = torch.zeros_like(p8)
            g8[:, 0:3] = 2.0 * scale * (p8[:, 0:3] - gt)
            here_tb = new.train_bwd(rays, z, noise, g8)
            parent_tb = old.train_bwd(rays, z, noise, g8)
            hg, pg = here_tb(), parent_tb()
            torch.cuda.synchronize()
            failed += compare(f"train_bwd R={R} S={S}", hg, pg)
            pairs["train_bwd"] = (parent_tb, here_tb)
        for name, (p_fn, h_fn) in pairs.items():
            report_launch(f"{name} R={R} S={S}",
                          "fwd_quad_kernel" if name == "train_fwd" else
                          "fwdbwd_kernel", R, S,
                          {"parent": (old, p_fn), "this": (new, h_fn)})
            report_time(f"{name} R={R} S={S}", p_fn, h_fn)
    return failed


def check_forwards(old, new, run, g, dev):
    """mlp_fwd at MLP_FWD_P, render_eval at EVAL_SHAPES, sigma_render at
    SIGMA_SHAPES and sigma_fwd at SIGMA_FWD_P; returns failures."""
    failed = []
    for P in MLP_FWD_P if "mlp_fwd" in run else ():
        x8, d8, _ = point_batch(P, g, dev)
        here, parent = new.mlp_fwd(x8, d8), old.mlp_fwd(x8, d8)
        h, p = here(), parent()
        torch.cuda.synchronize()
        sig_tol = POINT_TOL * max(1.0, p[:, 3].abs().max().item())
        e_rgb = (h[:, :3] - p[:, :3]).abs().max().item()
        e_sig = (h[:, 3] - p[:, 3]).abs().max().item()
        bad = [k for k, e, t in (("rgb", e_rgb, POINT_TOL),
                                 ("sigma", e_sig, sig_tol)) if not e <= t]
        if h[:, 4:].any():
            bad.append("out8 columns 4..7")
        print(f"[parent] mlp_fwd P={P}: rgb {e_rgb:.3e} (tol {POINT_TOL}), "
              f"sigma {e_sig:.3e} (tol {sig_tol:.3e}); bit-identical to the "
              f"parent: {torch.equal(h, p)}"
              + (f"  FAIL {bad}" if bad else ""))
        failed += bad
        report_time(f"mlp_fwd P={P}", parent, here)
    for R, S in EVAL_SHAPES if "render_eval" in run else ():
        rays, z, _, _ = ray_batch(R, S, g, dev)
        here, parent = new.render_eval(rays, z), old.render_eval(rays, z)
        h, p = here(), parent()
        torch.cuda.synchronize()
        failed += compare_outputs(f"render_eval R={R} S={S}", h, p)
        report_time(f"render_eval R={R} S={S}", parent, here)
    for R, S in SIGMA_SHAPES if "sigma_render" in run else ():
        rays, z, _, _ = ray_batch(R, S, g, dev)
        here, parent = new.sigma_render(rays, z), old.sigma_render(rays, z)
        h, p = here(), parent()
        torch.cuda.synchronize()
        failed += compare_outputs(f"sigma_render R={R} S={S}", h, p)
        report_time(f"sigma_render R={R} S={S}", parent, here)
    for P in SIGMA_FWD_P if "sigma_fwd" in run else ():
        x8, _, _ = point_batch(P, g, dev)
        here, parent = new.sigma_fwd(x8), old.sigma_fwd(x8)
        h, p = here(), parent()
        torch.cuda.synchronize()
        sig_tol = POINT_TOL * max(1.0, p.abs().max().item())
        e_sig = (h - p).abs().max().item()
        bad = [] if e_sig <= sig_tol else ["sigma_fwd sigma"]
        print(f"[parent] sigma_fwd P={P}: sigma {e_sig:.3e} (tol "
              f"{sig_tol:.3e}); bit-identical to the parent: "
              f"{torch.equal(h, p)}" + (f"  FAIL {bad}" if bad else ""))
        failed += bad
        report_time(f"sigma_fwd P={P}", parent, here)
    return failed


def compare_outputs(what, here, parent):
    """A render kernel's outputs ({name: tensor}) against the parent's at
    TOL; prints and returns the failures."""
    errs = {k: (here[k] - parent[k]).abs().max().item() for k in here}
    bad = [f"{what} {k}" for k, e in errs.items() if not e <= TOL[k]]
    print(f"[parent] {what}: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; bit-identical to the parent: "
          f"{same_bits(here.values(), parent.values())}"
          + (f"  FAIL {bad}" if bad else ""))
    return bad


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run = set(KERNELS)
    if len(argv) == 3 and argv[1] == "--kernels":
        run = set(argv[2].split(","))
        argv = argv[:1]
    if len(argv) != 1 or not run <= set(KERNELS):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    root = Path(argv[0])
    other_lib = build_other(root)

    params = init_nerf_params(torch.Generator().manual_seed(0), device=dev)
    params["sigma"]["w"] = params["sigma"]["w"] * 50
    params["sigma"]["b"] = params["sigma"]["b"] + 2.0
    mlp = fm.pack_mlp(params, dev)
    old = Build(other_lib, entries_of(root), mlp)
    new = Build(_build.build(), entries_of(REPO), mlp)
    g = torch.Generator(device=dev).manual_seed(0)
    failed = []
    if run & {"mse_render", "train_fwd", "train_bwd"}:
        failed += check_training(old, new, run, g, dev)
    if "mlp_bwd" in run:
        x8, d8, cot = point_batch(MLP_P, g, dev)
        here_mlp = new.mlp_bwd(x8, d8, cot)
        parent_mlp = old.mlp_bwd(x8, d8, cot)
        hg, pg = here_mlp(), parent_mlp()
        torch.cuda.synchronize()
        failed += compare(f"mlp_bwd P={MLP_P}", hg, pg)
        report_time(f"mlp_bwd P={MLP_P}", parent_mlp, here_mlp)
    failed += check_forwards(old, new, run, g, dev)
    if failed:
        raise SystemExit(f"past the bars: {failed}")
    print("[parent] all within the bars")


if __name__ == "__main__":
    main()
