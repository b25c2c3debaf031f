"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `nerf_pl_tpu_torch/csrc/*.cu` compiles to an object, all of them at
once (one nvcc process per source), and the objects link into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c -o <src>.o csrc/<src>.cu
    nvcc -shared -o <lib>.so *.o -ldl

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
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# hopper.cuh finds the driver's TMA encoder at run time (dlopen)
LINK_FLAGS = ("-ldl",)


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs),
                      *LINK_FLAGS]])
    for o in objs:
        o.unlink()
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The library's C entries: (return type, argument types). Pointers and the
# stream are c_void_p (ctypes would cut a bare Python int to 32 bits).
SIGNATURES = {
    # rays, z, R, S, 6 trunk buffers, weights, opacity, stream
    "nerf_sigma_render": (_I, [_P, _P, _I, _I] + [_P] * 6 + [_P] * 3),
    # rays, z, R, S, 13 weight buffers, white_back, rgb, depth, opacity,
    # stream
    "nerf_render_eval": (_I, [_P, _P, _I, _I] + [_P] * 13 + [_I]
                         + [_P] * 4),
    "nerf_mse_workspace_bytes": (ctypes.c_longlong, [_I, _I]),
    "nerf_ray_tile_rows": (ctypes.c_longlong, [_I, _I]),     # R, S
    "nerf_grad_floats": (_I, []),
    # rays, z, noise, gt, R, S, 13 weight buffers, white_back, scale, out8,
    # weights, workspace, grad, stream
    "nerf_mse_render": (_I, [_P] * 4 + [_I, _I] + [_P] * 13 + [_I, _F]
                        + [_P] * 5),
    # rays, z, noise, R, S, 13 weight buffers, white_back, out8, weights,
    # stream
    "nerf_train_fwd": (_I, [_P] * 3 + [_I, _I] + [_P] * 13 + [_I]
                       + [_P] * 3),
    # rays, z, noise, g8, gw (null: zero), R, S, 13 weight buffers,
    # white_back, workspace, grad, stream
    "nerf_train_bwd": (_I, [_P] * 5 + [_I, _I] + [_P] * 13 + [_I]
                       + [_P] * 3),
    # p8, d8, P, 13 weight buffers, out8, stream
    "nerf_mlp_fwd": (_I, [_P, _P, _I] + [_P] * 13 + [_P, _P]),
    # p8, P, 6 trunk buffers, sigma, stream
    "nerf_sigma_fwd": (_I, [_P, _I] + [_P] * 6 + [_P, _P]),
    "nerf_mlp_workspace_bytes": (ctypes.c_longlong, [_I]),
    # p8, d8, g8, P, 13 weight buffers, workspace, grad, stream
    "nerf_mlp_bwd": (_I, [_P] * 3 + [_I] + [_P] * 13 + [_P] * 3),
    # marks.cu, the profiler's phase marks: phase, stream, captured node
    "nerf_mark": (_I, [_I, _P, _P]),
    # graph, mark nodes, their count, the executable with them
    "nerf_graph_split": (_I, [_P, _P, _I, _P]),
    "nerf_graph_launch": (_I, [_P, _P]),        # executable, stream
    "nerf_graph_free": (_I, [_P]),
    # adam.cu: the table's bytes, a block's elements; then the table (a
    # host copy), blocks, stream
    "nerf_adam_table_bytes": (_I, []),
    "nerf_adam_block_elems": (_I, []),
    "nerf_adam": (_I, [_P, _I, _P]),
    # relu_bgrad.cu: the blocks of rows x cols at vec; then grad, its row
    # stride, y, g, partial, db, rows, cols, vec, blocks, stream
    "nerf_relu_bgrad_blocks": (_I, [ctypes.c_longlong, _I, _I]),
    "nerf_relu_bgrad": (_I, [_P, ctypes.c_longlong] + [_P] * 4
                        + [ctypes.c_longlong, _I, _I, _I, _P]),
}

# C types of the entries' arguments and results, as c_entries spells them.
CTYPES = {"void*": _P, "int": _I, "float": _F, "long long": ctypes.c_longlong}


def c_entries(source: str) -> Dict[str, Tuple[str, List[Tuple[str, str]]]]:
    """The functions defined in the `extern "C"` blocks of a .cu source:
    name -> (return type, [(argument type, argument name)]), `const`
    dropped and a pointer's star joined to its type ("void*")."""
    code = re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", "", source,
                                           flags=re.S))
    out = {}
    for m in re.finditer(r'extern\s+"C"\s*\{', code):
        depth, end = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(code[end], 0)
            end += 1
        block = code[m.end():end - 1]
        for f in re.finditer(r"^(long long|int)\s+(\w+)\s*\(([^)]*)\)"
                             r"\s*\{", block, flags=re.M):
            args = []
            for arg in filter(None, map(str.strip, f.group(3).split(","))):
                arg = re.sub(r"\bconst\s+", "", arg)
                arg = re.sub(r"\s*\*\s*", "* ", arg)
                kind, name = arg.rsplit(None, 1)
                args.append((kind.strip(), name))
            out[f.group(2)] = (f.group(1), args)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels, with their C signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
