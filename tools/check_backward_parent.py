#!/usr/bin/env python
"""Hold this checkout's training backwards against another checkout's
build of them, on one NVIDIA GPU, and time both:

    git archive <commit> | tar -x -C build/parent
    python tools/check_backward_parent.py build/parent

Builds every `nerf_pl_tpu_torch/csrc/*.cu` of the other checkout with this
checkout's nvcc flags into `<dir>/build/parent_kernels.so`; its
`nerf_mse_render`, `nerf_train_bwd` and `nerf_mlp_bwd` must take the
weights with the three transposed matrices (wdfT, wfT, wtT) after them,
as the kernels before the Hopper redesign of the backward did. Both builds
then run on the same rays, depths, noise, targets and weights:

  * mse_render at (R, S) = (8, 64), (1024, 64), (1024, 128), (37, 192);
  * train_bwd (through its C entry, nerf_train_bwd) on the rgb cotangent
    2 scale (rgb - gt) at the same shapes;
  * mlp_bwd at P = 131,072 (it runs the shared weight-gradient launch).

out8 and the weights are held at the kernels' bars (weights 5e-3, rgb and
opacity 1e-2, depth 5e-2) and each of the 17 gradient leaves within 0.03
relative max error. Not bit for bit: wgmma sums in another order than the
WMMA products of the earlier build, so bitwise equality across the
redesign is not a property to keep. Prints the median ms of each build at
each shape (parent, this, this, parent in turn; 10 runs each) and the
ratio parent / this. Exits non-zero past a bar.
"""
import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nerf_pl_tpu_torch.models import init_nerf_params  # noqa: E402
from nerf_pl_tpu_torch.ops import _build  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_train as ft  # noqa: E402

SHAPES = ((8, 64), (1024, 64), (1024, 128), (37, 192))
MLP_P = 131072
TOL = {"weights": 5e-3, "rgb": 1e-2, "opacity": 1e-2, "depth": 5e-2}
GRAD_TOL = 0.03
OLD_WEIGHTS = fm._FULL + ("wdfT", "wfT", "wtT")


def build_other(root: Path) -> ctypes.CDLL:
    out = root / "build" / "parent_kernels.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    srcs = sorted((root / "nerf_pl_tpu_torch" / "csrc").glob("*.cu"))
    objs = [out.parent / f"parent.{s.stem}.o" for s in srcs]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                     for s, o in zip(srcs, objs)])
    _build._run_all([[nvcc, "-shared", "-o", str(out), *map(str, objs),
                      *_build.LINK_FLAGS]])
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nerf_mse_workspace_bytes.argtypes = [i32, i32]
    lib.nerf_mse_workspace_bytes.restype = ctypes.c_longlong
    lib.nerf_mlp_workspace_bytes.argtypes = [i32]
    lib.nerf_mlp_workspace_bytes.restype = ctypes.c_longlong
    lib.nerf_mse_render.argtypes = [ptr] * 4 + [i32, i32] + [ptr] * 16 + \
        [i32, ctypes.c_float] + [ptr] * 5
    lib.nerf_mse_render.restype = i32
    lib.nerf_train_bwd.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 16 + \
        [i32] + [ptr] * 3
    lib.nerf_train_bwd.restype = i32
    lib.nerf_mlp_bwd.argtypes = [ptr] * 3 + [i32] + [ptr] * 16 + [ptr] * 3
    lib.nerf_mlp_bwd.restype = i32
    return lib


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


def rel_errs(got, ref):
    return [((a - b).abs().max() / b.abs().max()).item()
            if b.abs().max() > 0 else float(a.abs().max() > 0)
            for a, b in zip(got, ref)]


class Other:
    """The other build's three backwards, with this build's outputs."""

    def __init__(self, lib, weights):
        self.lib, self.weights = lib, weights      # kept alive: the pointers
        self.w = [weights[n].data_ptr() for n in OLD_WEIGHTS]
        self.stream = torch.cuda.current_stream().cuda_stream

    def _check(self, err, what):
        if err:
            raise RuntimeError(f"other build's {what} returned {err}")

    def mse(self, rays, z, noise, gt, scale):
        R, S = z.shape
        dev = rays.device
        out8, w = torch.empty((R, 8), device=dev), torch.empty((R, S),
                                                               device=dev)
        grad = torch.empty((fm.GRAD_FLOATS,), device=dev)
        ws = torch.empty((self.lib.nerf_mse_workspace_bytes(R, S),),
                         dtype=torch.uint8, device=dev)

        def run():
            self._check(self.lib.nerf_mse_render(
                rays.data_ptr(), z.data_ptr(), noise.data_ptr(),
                gt.data_ptr(), R, S, *self.w, 1, scale, out8.data_ptr(),
                w.data_ptr(), ws.data_ptr(), grad.data_ptr(), self.stream),
                "nerf_mse_render")
            return out8, w, fm._pack_layout_grads(grad)
        return run

    def train_bwd(self, rays, z, noise, g8):
        R, S = z.shape
        grad = torch.empty((fm.GRAD_FLOATS,), device=rays.device)
        ws = torch.empty((self.lib.nerf_mse_workspace_bytes(R, S),),
                         dtype=torch.uint8, device=rays.device)

        def run():
            self._check(self.lib.nerf_train_bwd(
                rays.data_ptr(), z.data_ptr(), noise.data_ptr(),
                g8.data_ptr(), None, R, S, *self.w, 1, ws.data_ptr(),
                grad.data_ptr(), self.stream), "nerf_train_bwd")
            return fm._pack_layout_grads(grad)
        return run

    def mlp_bwd(self, x8, d8, cot):
        P = x8.shape[0]
        grad = torch.empty((fm.GRAD_FLOATS,), device=x8.device)
        ws = torch.empty((self.lib.nerf_mlp_workspace_bytes(P),),
                         dtype=torch.uint8, device=x8.device)

        def run():
            self._check(self.lib.nerf_mlp_bwd(
                x8.data_ptr(), d8.data_ptr(), cot.data_ptr(), P, *self.w,
                ws.data_ptr(), grad.data_ptr(), self.stream), "nerf_mlp_bwd")
            return fm._pack_layout_grads(grad)
        return run


def compare(what, got, ref, out=None):
    """Prints and returns the failures of gradients `got` against `ref`
    (and with out = ((out8, w), (ref8, ref_w)), the forward's too)."""
    bad = []
    msg = f"[parent] {what}:"
    if out is not None:
        (o8, w), (r8, rw) = out
        errs = {"rgb": (o8[:, :3] - r8[:, :3]).abs().max().item(),
                "depth": (o8[:, 3] - r8[:, 3]).abs().max().item(),
                "opacity": (o8[:, 4] - r8[:, 4]).abs().max().item(),
                "weights": (w - rw).abs().max().item()}
        msg += " " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + ";"
        bad += [k for k, v in errs.items() if not v <= TOL[k]]
    rels = rel_errs(got, ref)
    msg += " grad rel per leaf " + " ".join(f"{r:.2e}" for r in rels)
    bad += [f"grad {i}" for i, r in enumerate(rels) if not r <= GRAD_TOL]
    print(msg + (f"  FAIL {bad}" if bad else ""))
    return bad


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    other = build_other(Path(argv[0]))
    _build.load_library()

    params = init_nerf_params(torch.Generator().manual_seed(0), device=dev)
    params["sigma"]["w"] = params["sigma"]["w"] * 50
    params["sigma"]["b"] = params["sigma"]["b"] + 2.0
    mlp = fm.pack_mlp(params, dev)
    old = Other(other, fm._train_weights(mlp))
    g = torch.Generator(device=dev).manual_seed(0)
    failed = []
    for R, S in SHAPES:
        o = torch.randn((R, 3), generator=g, device=dev)
        d = torch.nn.functional.normalize(
            torch.randn((R, 3), generator=g, device=dev), dim=-1)
        rays = torch.cat([o, d, torch.full((R, 1), 2.0, device=dev),
                          torch.full((R, 1), 6.0, device=dev)], -1)
        z = torch.sort(2 + 4 * torch.rand((R, S), generator=g, device=dev),
                       -1).values.contiguous()
        noise = torch.randn((R, S), generator=g, device=dev)
        gt = torch.rand((R, 3), generator=g, device=dev)
        scale = 1.0 / (R * 3)

        def here_mse():
            return ft.fused_mse_render(mlp, rays, z, noise, gt, True, scale)
        parent_mse = old.mse(rays, z, noise, gt, scale)
        h8, hw, hg = here_mse()
        p8, pw, pg = parent_mse()
        torch.cuda.synchronize()
        failed += compare(f"mse_render R={R} S={S}", hg, pg,
                          ((h8, hw), (p8, pw)))
        g8 = torch.zeros_like(p8)
        g8[:, 0:3] = 2.0 * scale * (p8[:, 0:3] - gt)

        def here_tb():
            return ft.train_backward(mlp, rays, z, noise, True, g8, None)
        parent_tb = old.train_bwd(rays, z, noise, g8)
        hg, pg = here_tb(), parent_tb()
        torch.cuda.synchronize()
        failed += compare(f"train_bwd R={R} S={S}", hg, pg)
        for name, (p_fn, h_fn) in (("mse_render", (parent_mse, here_mse)),
                                   ("train_bwd", (parent_tb, here_tb))):
            tp, th = timed_pair(p_fn, h_fn)
            print(f"[time] {name} R={R} S={S}: parent {tp:.3f} ms, this "
                  f"{th:.3f} ms, parent / this {tp / th:.2f}x")

    x8 = torch.zeros((MLP_P, 8), device=dev)
    x8[:, :3] = 2 * torch.randn((MLP_P, 3), generator=g, device=dev)
    d8 = torch.zeros((MLP_P, 8), device=dev)
    d8[:, :3] = torch.nn.functional.normalize(
        torch.randn((MLP_P, 3), generator=g, device=dev), dim=-1)
    cot = torch.zeros((MLP_P, 8), device=dev)
    cot[:, :4] = torch.randn((MLP_P, 4), generator=g, device=dev) / MLP_P

    def here_mlp():
        return fm.mlp_backward(mlp, x8, d8, cot)
    parent_mlp = old.mlp_bwd(x8, d8, cot)
    hg, pg = here_mlp(), parent_mlp()
    torch.cuda.synchronize()
    failed += compare(f"mlp_bwd P={MLP_P}", hg, pg)
    tp, th = timed_pair(parent_mlp, here_mlp)
    print(f"[time] mlp_bwd P={MLP_P}: parent {tp:.3f} ms, this {th:.3f} ms, "
          f"parent / this {tp / th:.2f}x")
    if failed:
        raise SystemExit(f"past the bars: {failed}")
    print("[parent] all within the bars")


if __name__ == "__main__":
    main()
