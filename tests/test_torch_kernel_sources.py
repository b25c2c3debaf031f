"""Design rules of the port's hand-written CUDA kernels, read from their
sources as text (no compiler needed, so they run on the CPU):

  * no float atomics anywhere (atomicAdd, red/atom ... add.f32, or a bulk
    reduce-add): two launches on the same inputs must give bit-identical
    gradients;
  * no environment lookups and no preprocessor switch that could select
    another build of a kernel (the redesigned backward has no old copy);
  * every .cu names the function of nerf_pl_tpu/ops/*.py that it replaces;
  * every kernel of the full MLP (the backwards' launches A and A',
    train_fwd, mlp_fwd and render_eval through mlp_wgmma.cuh's tile loops,
    and launch B) issues wgmma on operands that TMA brings in with
    mbarriers, and no WMMA is left in them; the WMMA code they replaced is
    gone, and nerf_mlp.cuh's WMMA tile runs the sigma trunk alone;
  * no C entry takes transposed weights, and each C entry's arguments in
    the sources match its ctypes signature in ops/_build.py.
"""
import ast
import re
from pathlib import Path

import pytest

from nerf_pl_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "nerf_pl_tpu_torch" / "csrc"
SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
CU = sorted(CSRC.glob("*.cu"))


def code_of(path):
    """The source without its comments."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def balanced(code, i):
    """The brace-balanced block that opens at code[i]."""
    depth = 0
    for j in range(i, len(code)):
        depth += {"{": 1, "}": -1}.get(code[j], 0)
        if depth == 0:
            return code[i:j + 1]
    raise AssertionError(f"unbalanced block at {i}")


def test_sources_found():
    assert {p.name for p in SOURCES} >= {
        "fused_mlp.cu", "fused_render.cu", "fused_train.cu", "hopper.cuh",
        "mlp_grad.cuh", "mlp_wgmma.cuh", "nerf_mlp.cuh", "ray_tile.cuh"}


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


KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "catch",
            "constexpr"}


def definitions():
    """{name: body} of every function defined in the sources (the first
    definition of a name; kernels, device and host functions alike)."""
    defs = {}
    for path in SOURCES:
        code = code_of(path)
        for m in re.finditer(r"\b(\w+)\s*(<[^;{()]*>)?\s*"
                             r"\((?:[^;{()]|\([^()]*\))*\)\s*(const\s*)?\{",
                             code):
            if m.group(1) not in KEYWORDS and m.group(1) not in defs:
                defs[m.group(1)] = balanced(code, m.end() - 1)
    return defs


def reach(name, defs):
    """The body of `name` and of every function of the sources that it
    calls, directly or through others."""
    seen, todo, text = set(), [name], []
    while todo:
        n = todo.pop()
        if n in seen or n not in defs:
            continue
        seen.add(n)
        text.append(defs[n])
        todo += re.findall(r"\b(\w+)\s*[<(]", defs[n])
    return "\n".join(text)


# kernel: whether a backward follows its forward tiles
WGMMA_KERNELS = {"fwdbwd_kernel": True, "fwd_quad_kernel": False,
                 "point_fwdbwd_kernel": True, "mlp_fwd_kernel": False,
                 "eval_quad_kernel": False, "wgrad_kernel": None}


@pytest.mark.parametrize("kernel", list(WGMMA_KERNELS))
def test_backward_launches_use_wgmma_and_tma(kernel):
    """Launches A of mse_render and train_bwd (fwdbwd), A' of mlp_bwd
    (point_fwdbwd), train_fwd (fwd_quad), mlp_fwd and render_eval
    (eval_quad) through mlp_wgmma.cuh's tile loops (slab_mma, fed by the
    producer's put_slab), and launch B (wgrad, inline) issue wgmma on
    TMA-loaded tiles behind mbarriers; no WMMA fragment or WMMA tile loop
    is reached from any of them."""
    defs = definitions()
    assert kernel in defs
    text = reach(kernel, defs)
    assert re.search(r"wgmma_n(128|256)<", text)
    assert "tma_load(" in text and "mbar_wait(" in text
    assert "wmma::" not in text and "mlp_tile" not in text
    backward = WGMMA_KERNELS[kernel]
    if backward is not None:
        body = defs[kernel]
        assert "forward_tile<" in body and "produce_fwd(" in body
        assert ("backward_tile(" in body) == backward


def test_render_eval_runs_the_training_quadrature():
    """render_eval integrates with quad_forward, the quadrature of
    train_fwd and the backwards (ray_tile.cuh), on blocks of rays loaded
    by the same RayBlock, so its outputs can equal train_fwd's bit for
    bit; no other quadrature of the full MLP is left."""
    defs = definitions()
    for kernel in ("eval_quad_kernel", "fwd_quad_kernel", "fwdbwd_kernel"):
        body = defs[kernel]
        assert "quad_forward(" in body and "ray_points(" in body, kernel
        assert "RayBlock" in body, kernel
    for path in SOURCES:
        assert "quad_forward(" not in code_of(path) or path.name in (
            "ray_tile.cuh", "fused_train.cu", "fused_render.cu"), path.name


def test_wmma_training_code_is_gone():
    """The WMMA launch A' of mlp_bwd, its data-gradient chain, train_fwd's
    WMMA kernel and the WMMA forwards of mlp_fwd and render_eval (the
    templates point_fwd_kernel<FULL>, render_kernel<FULL>,
    quadrature<FULL>) have no definition left, and no training kernel
    keeps a switch that could reach a WMMA tile. nerf_mlp.cuh's WMMA tile
    is the sigma trunk alone: no FULL parameter, no template on a bool,
    and none of its functions reads the feature, view or rgb weights or
    writes an rgb."""
    defs = definitions()
    for gone in ("mlp_bwd_kernel", "train_fwd_kernel", "backward_from_heads",
                 "store_grad", "ActSink", "copy_rows", "TrainLayout",
                 "point_fwd_kernel", "render_kernel", "quadrature",
                 "launch_fwd"):
        assert gone not in defs, gone
    for path in SOURCES:
        assert not re.search(r"\b(ActSink|backward_from_heads)\b",
                             code_of(path)), path.name
    code = code_of(CSRC / "nerf_mlp.cuh")
    assert "FULL" not in code
    assert not re.search(r"template\s*<\s*bool", code)
    for m in re.finditer(r"\b(\w+)\s*(<[^;{()]*>)?\s*"
                         r"\((?:[^;{()]|\([^()]*\))*\)\s*(const\s*)?\{",
                         code):
        if m.group(1) in KEYWORDS or m.group(1) == "weights_at":
            continue
        body = balanced(code, m.end() - 1)
        assert not re.search(r"\bp\.(wf|bf|wdf|wdd|bd|wr|br)\b", body), \
            m.group(1)
        assert "rgb" not in body and "sm.d" not in body, m.group(1)


def test_hopper_helpers_issue_the_ptx():
    code = code_of(CSRC / "hopper.cuh")
    for ptx in ("wgmma.mma_async.sync.aligned", "cp.async.bulk.tensor.3d",
                "mbarrier.try_wait.parity", "setmaxnreg"):
        assert ptx in code, ptx


@pytest.mark.parametrize("path", CU, ids=lambda p: p.name)
def test_backward_c_entries_take_no_transposed_weights(path):
    """Every product reads W^T through wgmma's transpose flag (the same W
    read K-major), so no C entry takes a transposed copy (wdfT, wfT, wtT)
    and no wrapper of ops/ builds one."""
    entries = _build.c_entries(path.read_text())
    assert entries
    for name, (_, args) in entries.items():
        names = {n for _, n in args}
        assert not names & {"wdfT", "wfT", "wtT"}, (path.name, name)
    for py in sorted((REPO / "nerf_pl_tpu_torch" / "ops").glob("*.py")):
        assert not re.search(r"\bw(df|f|t)T\b", py.read_text()), py.name


@pytest.mark.parametrize("path", CU, ids=lambda p: p.name)
def test_c_entries_match_their_ctypes_signatures(path):
    """Each C entry's arguments, counted and typed from the source, equal
    its argtypes (and its result its restype) in ops/_build.py: a dropped
    or added pointer fails here, not as a wild address on the card."""
    entries = _build.c_entries(path.read_text())
    assert entries
    for name, (result, args) in entries.items():
        restype, argtypes = _build.SIGNATURES[name]
        assert len(args) == len(argtypes), (name, len(args), len(argtypes))
        for i, ((kind, arg), ct) in enumerate(zip(args, argtypes)):
            assert _build.CTYPES[kind] is ct, (name, i, arg, kind, ct)
        assert _build.CTYPES[result] is restype, name


def test_every_signature_has_a_c_entry():
    found = {}
    for path in CU:
        found.update(_build.c_entries(path.read_text()))
    assert set(_build.SIGNATURES) == set(found)
