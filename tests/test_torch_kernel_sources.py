"""Design rules of the port's hand-written CUDA kernels, read from their
sources as text (no compiler needed, so they run on the CPU):

  * no float atomics anywhere (atomicAdd, red/atom ... add.f32, or a bulk
    reduce-add): two launches on the same inputs must give bit-identical
    gradients;
  * no environment lookups and no preprocessor switch that could select
    another build of a kernel (the redesigned backward has no old copy);
  * every .cu names the function of nerf_pl_tpu/ops/*.py that it replaces;
  * the training backward's launches A (fused_train.cu) and B
    (mlp_grad.cuh) issue wgmma on operands that TMA brings in with
    mbarriers.
"""
import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "nerf_pl_tpu_torch" / "csrc"
SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
CU = sorted(CSRC.glob("*.cu"))


def code_of(path):
    """The source without its comments."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def body_of(code, name):
    """The brace-balanced body of the first function definition `name`."""
    m = re.search(r"\b" + re.escape(name) + r"\s*\([^;{]*\)\s*\{", code)
    assert m, f"no definition of {name}"
    depth, i = 0, m.end() - 1
    for j in range(i, len(code)):
        depth += {"{": 1, "}": -1}.get(code[j], 0)
        if depth == 0:
            return code[i:j + 1]
    raise AssertionError(f"unbalanced body of {name}")


def test_sources_found():
    assert {p.name for p in SOURCES} >= {
        "fused_mlp.cu", "fused_render.cu", "fused_train.cu", "hopper.cuh",
        "mlp_grad.cuh", "nerf_mlp.cuh"}


FLOAT_ATOMICS = (
    r"\batomicAdd\s*\(",
    r"\bred\.[\w.:]*add\.f(16|32|64)",
    r"\batom\.[\w.:]*add\.f(16|32|64)",
    r"cp\.reduce\.async\.bulk[^\"]*add\.f(16|32|64)",
)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_float_atomics(path):
    code = code_of(path)
    for pat in FLOAT_ATOMICS:
        assert not re.search(pat, code), (path.name, pat)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_environment_or_build_switch(path):
    code = code_of(path)
    assert "getenv" not in code, path.name
    directives = re.findall(r"^\s*#\s*(\w+)", code, flags=re.M)
    assert set(directives) <= {"include", "pragma"}, (path.name, directives)
    assert not re.search(r"(?i)\b\w*(legacy|old_|_old|use_wmma|use_wgmma)\w*",
                         code), path.name


def _jax_functions(py):
    tree = ast.parse((REPO / "nerf_pl_tpu" / "ops" / py).read_text())
    return {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("path", CU, ids=lambda p: p.name)
def test_each_cu_names_the_tpu_function_it_replaces(path):
    text = path.read_text()
    named = set(re.findall(r"nerf_pl_tpu/ops/(\w+\.py)", text))
    assert named, f"{path.name} names no nerf_pl_tpu/ops/*.py"
    words = set(re.findall(r"\b\w+\b", text))
    found = {py: _jax_functions(py) & words for py in named}
    assert any(found.values()), (path.name, named)


@pytest.mark.parametrize("kernel,path", [
    ("fwdbwd_kernel", "fused_train.cu"), ("wgrad_kernel", "mlp_grad.cuh")])
def test_backward_launches_use_wgmma_and_tma(kernel, path):
    """Launch A (through slab_mma, fed by the producer's put_slab) and
    launch B (inline) issue wgmma on TMA-loaded tiles behind mbarriers; no
    WMMA fragment is left in either."""
    code = code_of(CSRC / path)
    body = body_of(code, kernel)
    helpers = code if kernel == "fwdbwd_kernel" else body
    if kernel == "fwdbwd_kernel":
        assert "slab_mma<" in body and "produce(" in body
        helpers = body_of(code, "slab_mma") + body_of(code, "put_slab")
    assert re.search(r"wgmma_n(128|256)<", helpers)
    assert "tma_load(" in helpers and "mbar_wait(" in helpers
    assert "wmma::" not in body


def test_hopper_helpers_issue_the_ptx():
    code = code_of(CSRC / "hopper.cuh")
    for ptx in ("wgmma.mma_async.sync.aligned", "cp.async.bulk.tensor.3d",
                "mbarrier.try_wait.parity", "setmaxnreg"):
        assert ptx in code, ptx


def test_backward_c_entries_take_no_transposed_weights():
    """Kernels 7 and 8 read W^T through wgmma's transpose flag; only
    mlp_bwd's launch A' still takes the transposed copies."""
    code = code_of(CSRC / "fused_train.cu")
    for entry in ("nerf_mse_render", "nerf_train_bwd"):
        sig = re.search(r"int " + entry + r"\(([^)]*)\)", code).group(1)
        assert "wdfT" not in sig and "wtT" not in sig, entry
    assert "wdfT" in code_of(CSRC / "fused_mlp.cu")
