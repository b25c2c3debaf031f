"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `nerf_pl_tpu_torch/csrc/*.cu` compiles to an object, all of them at
once (one nvcc process per source), and the objects link into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c -o <src>.o csrc/<src>.cu
    nvcc -shared -o <lib>.so *.o

The library goes to `build/torch_kernels/` at the repository root, named by
a hash of the sources and flags, and is built on first use only. The
compilers' reports (registers, shared memory, spills) are kept beside it
as `<lib>.log`. `--use_fast_math` is left out on purpose: the embedding's
sin arguments reach 2^9 |x|, where the fast sine is inaccurate, and the
training quadrature's scans must stay true f32.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, else from PATH. Raises if there is none:
    the kernels have no fallback."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnerf_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; raise with the output of any that
    failed. Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                    for s, o in zip(srcs, objs)])
    tmp = out.with_name(f"{tag}.tmp.so")
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels, with their C signatures."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # rays, z, R, S, 6 trunk buffers, weights, opacity, stream
    lib.nerf_sigma_render.argtypes = [ptr, ptr, i32, i32] + [ptr] * 6 + \
        [ptr, ptr, ptr]
    lib.nerf_sigma_render.restype = i32
    # rays, z, R, S, 13 weight buffers, white_back, rgb, depth, opacity,
    # stream
    lib.nerf_render_eval.argtypes = [ptr, ptr, i32, i32] + [ptr] * 13 + \
        [i32, ptr, ptr, ptr, ptr]
    lib.nerf_render_eval.restype = i32
    lib.nerf_mse_workspace_bytes.argtypes = [i32, i32]
    lib.nerf_mse_workspace_bytes.restype = ctypes.c_longlong
    lib.nerf_grad_floats.argtypes = []
    lib.nerf_grad_floats.restype = i32
    # rays, z, noise, gt, R, S, 13 weight buffers + 3 transposed, white_back,
    # scale, out8, weights, workspace, grad, stream
    lib.nerf_mse_render.argtypes = [ptr] * 4 + [i32, i32] + [ptr] * 16 + \
        [i32, ctypes.c_float] + [ptr] * 5
    lib.nerf_mse_render.restype = i32
    # rays, z, noise, R, S, 13 weight buffers, white_back, out8, weights,
    # stream
    lib.nerf_train_fwd.argtypes = [ptr] * 3 + [i32, i32] + [ptr] * 13 + \
        [i32] + [ptr] * 3
    lib.nerf_train_fwd.restype = i32
    # rays, z, noise, g8, gw (null: zero), R, S, 13 weight buffers + 3
    # transposed, white_back, workspace, grad, stream
    lib.nerf_train_bwd.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 16 + \
        [i32] + [ptr] * 3
    lib.nerf_train_bwd.restype = i32
    # p8, d8, P, 13 weight buffers, out8, stream
    lib.nerf_mlp_fwd.argtypes = [ptr, ptr, i32] + [ptr] * 13 + [ptr, ptr]
    lib.nerf_mlp_fwd.restype = i32
    # p8, P, 6 trunk buffers, sigma, stream
    lib.nerf_sigma_fwd.argtypes = [ptr, i32] + [ptr] * 6 + [ptr, ptr]
    lib.nerf_sigma_fwd.restype = i32
    lib.nerf_mlp_workspace_bytes.argtypes = [i32]
    lib.nerf_mlp_workspace_bytes.restype = ctypes.c_longlong
    # p8, d8, g8, P, 13 weight buffers + 3 transposed, workspace, grad,
    # stream
    lib.nerf_mlp_bwd.argtypes = [ptr] * 3 + [i32] + [ptr] * 16 + [ptr] * 3
    lib.nerf_mlp_bwd.restype = i32
    return lib
