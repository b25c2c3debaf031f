"""The benchmark of nerf_pl_tpu_torch: one run of one cell.

    python3 nerfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (nerfbench/configs/<config>.json: the model, the recipe, its
source and cuts) and its traffic mix (nerfbench/traffic/<traffic>.json:
the parameters of a runner, nerfbench/runners/<runner>.py); its limits
are nerfbench/limits/<cell>.json, and each per-layer metric is a reader,
nerfbench/metrics/<metric>.py. A new cell, configuration, mix or metric is
new files and entries; nothing here changes for it.

With --trace 0 the last line of stdout is the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, read from one torch.profiler window.
`correct` compares what the timed path produced with the plain reference
(nerfbench/references/), and the numbers compared, each beside its limit,
are the last lines of stderr and the last key of the result.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, or if jax, jaxlib, flax or the JAX package nerf_pl_tpu
is loaded once the window has closed, in this process or in any rank of a
data-parallel run (nerfbench/nojax.py).

The kernels' build (nvcc, into build/torch_kernels/ of the checkout, on a
checkout's first run only) is part of setup_s; the line's `build` key
also gives it apart: whether this run built them and the seconds it took.
"""
from __future__ import annotations

import time

START_WALL = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from nerfbench.nojax import banned_modules, found  # noqa: E402


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell's BENCHMARK.json entry, its configuration, mix, limits
    and the benchmark's metric entries that it reports, from the checkout
    at `root`."""
    bench = _json(root / "BENCHMARK.json")
    here = root / BENCH.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cell["config"] = _json(root / conf["file"])
    cell["traffic_name"] = cell["traffic"]
    cell["traffic"] = _json(here / "traffic" / f"{cell['traffic_name']}.json")
    cell["limits"] = _json(here / "limits" / f"{name}.json")["limits"]
    cell["root"] = str(root)

    def mine(m):
        return name in m.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"] if mine(m)
                         and ("workloads" in m or m["moves"] in reported)]
    return cell


def reader(metric: str, root: Path = ROOT):
    """The per-layer metric's reader, nerfbench/metrics/<metric>.py of
    the checkout at `root`."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "nerfbench.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def per_layer(cell: Dict, res: Dict) -> Dict:
    """Each per-layer metric of the cell, averaged over the ranks' traces;
    a metric whose reader finds nothing is left out."""
    out = {}
    for m in cell["per_layer"]:
        read = reader(m["name"], Path(cell.get("root", ROOT)))
        vals = [v for v in (read(t, res["ctx"]) for t in res["traces"])
                if v is not None]
        if vals:
            out[m["name"]] = {"value": sum(vals) / len(vals),
                              "unit": m["unit"]}
    return out


def result(cell: Dict, res: Dict, trace: bool, device_info: Dict,
           build: Optional[Dict] = None) -> Dict:
    from nerfbench import check
    from nerfbench import trace as T
    correct, checks = check.judge(res["numbers"], cell["limits"])
    if trace:
        metrics = per_layer(cell, res)
        n = max(len(res["traces"]), 1)
        device_info["busy_s"] = sum(T.union_s(t.device)
                                    for t in res["traces"]) / n
        device_info["window_s"] = sum(t.window_s for t in res["traces"]) / n
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device_info["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    line = {"correct": correct and res["failed"] == 0,
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device_info}
    if trace and res["traces"]:
        line["breakdown"] = T.breakdown(res["traces"][0])
    if build is not None:
        line["build"] = build
    line["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its kernels into build/torch_kernels/ there)."""
    base = ROOT / "build" / "nerfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def _build_kernels() -> Dict:
    """The program's kernel library built now (a checkout's first run:
    nvcc) or found, and the seconds that took."""
    from nerf_pl_tpu_torch.ops import _build
    built = not _build.library_path().is_file()
    t0 = time.perf_counter()
    _build.build()
    return {"built": built, "seconds": time.perf_counter() - t0}


def main(argv=None, device: Optional[str] = None, cell: Optional[Dict] = None,
         fault: Optional[str] = None) -> Dict:
    """One run; returns the result line. `device` and `cell` (a test's
    CPU run of a cut cell) skip the look for cards; `fault` plants one of
    nerfbench/faults.py in the program."""
    args = build_parser().parse_args(argv)
    _caches()
    import torch
    cell = cell if cell is not None else load_cell(args.workload)
    chips = cell["chips"]
    if device is None:
        if not torch.cuda.is_available():
            sys.exit("nerfbench: no CUDA device (torch.cuda.is_available() "
                     "is false)")
        if torch.cuda.device_count() < chips:
            sys.exit(f"nerfbench: {args.workload} needs {chips} cards, "
                     f"{torch.cuda.device_count()} visible")
        device = "cuda"
    build = _build_kernels() if device == "cuda" else None
    runner = importlib.import_module(
        f"nerfbench.runners.{cell['traffic']['runner']}")
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     START_WALL, device=device, fault=fault)
    # named after the run: a data-parallel run's parent leaves the cards
    # to its ranks until they have ended
    info = {"platform": "gpu" if device == "cuda" else device,
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else device), "count": chips}
    # a runner whose window runs in other processes (ranks) gives what
    # each of them found under "banned"
    bad = found({"this process": banned_modules(),
                 **res.get("banned", {})})
    if bad:
        sys.exit(f"nerfbench: modules of jax or the JAX package loaded "
                 f"{bad}")
    line = result(cell, res, bool(args.trace), info, build)
    if build is not None:
        print(f"nerfbench: kernels {'built' if build['built'] else 'found'}"
              f" in {build['seconds']:.3f} s (part of setup_s)",
              file=sys.stderr)
    print(f"nerfbench: the reference check took {res['check_s']:.3f} s",
          file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
