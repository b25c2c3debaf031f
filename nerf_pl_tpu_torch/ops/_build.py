"""Build the port's CUDA kernels with nvcc and load them with ctypes.

`nerf_pl_tpu_torch/csrc/*.cu` compile into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o <lib>.so csrc/*.cu

The library goes to `build/torch_kernels/` at the repository root, named by
a hash of the sources and flags, and is built on first use only. The
compiler's report (registers, shared memory, spills) is kept beside it as
`<lib>.log`. `--use_fast_math` is left out on purpose: the embedding's sin
arguments reach 2^9 |x|, where the fast sine is inaccurate.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
    return lib
