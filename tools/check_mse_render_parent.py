#!/usr/bin/env python
"""Hold this checkout's mse_render kernel bit-for-bit against another
checkout's build of it, on one NVIDIA GPU:

    git archive <commit> | tar -x -C build/parent
    python tools/check_mse_render_parent.py build/parent

Builds every `nerf_pl_tpu_torch/csrc/*.cu` of the other checkout with this
checkout's nvcc flags into `<dir>/build/mse_parent.so` (its
`nerf_mse_render` must have the C signature this checkout loads), runs both
builds on the same rays, depths, noise, targets and weights at (R, S) =
(8, 64), (1024, 128) and (37, 192), and requires out8, the weights and all
17 gradient buffers to be equal bit for bit. Use it after a change that
moves code the loss-fused kernel compiles (csrc/mlp_grad.cuh,
csrc/nerf_mlp.cuh, csrc/fused_train.cu). Exits non-zero on any difference.
"""
import ctypes
import os
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

SHAPES = ((8, 64), (1024, 128), (37, 192))


def build_other(root: Path) -> ctypes.CDLL:
    out = root / "build" / "mse_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    srcs = sorted((root / "nerf_pl_tpu_torch" / "csrc").glob("*.cu"))
    objs = [out.parent / f"mse_parent.{s.stem}.o" for s in srcs]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                     for s, o in zip(srcs, objs)])
    _build._run_all([[nvcc, "-shared", "-o", str(out), *map(str, objs)]])
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nerf_mse_workspace_bytes.argtypes = [i32, i32]
    lib.nerf_mse_workspace_bytes.restype = ctypes.c_longlong
    lib.nerf_mse_render.argtypes = [ptr] * 4 + [i32, i32] + [ptr] * 16 + \
        [i32, ctypes.c_float] + [ptr] * 5
    lib.nerf_mse_render.restype = i32
    return lib


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
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
    weights = fm._train_weights(mlp)
    g = torch.Generator(device=dev).manual_seed(0)
    differ = []
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
        here = ft.fused_mse_render(mlp, rays, z, noise, gt, True, scale)

        out8 = torch.empty((R, 8), device=dev)
        w = torch.empty((R, S), device=dev)
        grad = torch.empty((fm.GRAD_FLOATS,), device=dev)
        ws = torch.empty((other.nerf_mse_workspace_bytes(R, S),),
                         dtype=torch.uint8, device=dev)
        err = other.nerf_mse_render(
            rays.data_ptr(), z.data_ptr(), noise.data_ptr(), gt.data_ptr(),
            R, S, *(weights[n].data_ptr()
                    for n in fm._FULL + ("wdfT", "wfT", "wtT")),
            1, scale, out8.data_ptr(), w.data_ptr(), ws.data_ptr(),
            grad.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other build's nerf_mse_render returned {err}")
        torch.cuda.synchronize()
        same = (torch.equal(here[0], out8) and torch.equal(here[1], w)
                and all(torch.equal(a, b) for a, b in
                        zip(here[2], fm._pack_layout_grads(grad))))
        print(f"mse_render R={R} S={S}: out8, weights and 17 gradients "
              f"bit-identical to {argv[0]}: {same}")
        if not same:
            differ.append((R, S))
    if differ:
        raise SystemExit(f"mse_render differs at {differ}")


if __name__ == "__main__":
    main()
