"""Design rules of the port's hand-written CUDA kernels, read from their
sources as text (no compiler needed, so they run on the CPU):

  * no float atomics anywhere (atomicAdd, red/atom ... add.f32, or a bulk
    reduce-add): two launches on the same inputs must give bit-identical
    gradients;
  * no environment lookups and no preprocessor switch that could select
    another build of a kernel (the redesigned backward has no old copy);
  * every .cu names the function of nerf_pl_tpu/ops/*.py that it
    replaces, or says in its header that it ports no TPU kernel and why it
    was added: the module of the port that launches it (marks.cu, the
    profiler's phase marks; adam.cu, Adam's update, which the JAX package
    leaves to XLA); such a source whose kernels do work also states their
    bound there (bytes, and the time they take at the HBM rate);
  * marks.cu's empty kernels name exactly the phases of
    utils/profiling.py's MARKS, in its order;
  * every kernel (the backwards' launches A and A', train_fwd, mlp_fwd
    and render_eval through mlp_wgmma.cuh's forward tile loop,
    sigma_render and sigma_fwd through its trunk alone, and launch B)
    issues wgmma on operands that TMA brings in with mbarriers; every
    sigma comes from one function, trunk_tile, which forward_tile calls;
    no source holds WMMA any more, and nerf_mlp.cuh holds no tile loop;
  * launch A's blocks hold whole rays in whole tiles by one rule on S;
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
NO_PORT = "ports no TPU kernel"


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


def header(path):
    """The comment lines that open a source, joined into one text."""
    lines = []
    for line in path.read_text().splitlines():
        if not line.startswith("//"):
            break
        lines.append(line[2:].strip())
    return " ".join(lines)


@pytest.mark.parametrize("path", CU, ids=lambda p: p.name)
def test_each_cu_names_the_tpu_function_it_replaces(path):
    """A source that ports a TPU kernel names the function of
    nerf_pl_tpu/ops/*.py that it replaces. One that ports none says so in
    its header, and why it was added: the port's module that launches its
    C entries; where its kernels do work (a __global__ function with a
    body), the header states their bound too: the bytes they move and the
    time that takes at the HBM rate."""
    text = path.read_text()
    head = header(path)
    if NO_PORT not in head:
        named = set(re.findall(r"nerf_pl_tpu/ops/(\w+\.py)", text))
        assert named, f"{path.name} names no nerf_pl_tpu/ops/*.py"
        words = set(re.findall(r"\b\w+\b", text))
        found = {py: _jax_functions(py) & words for py in named}
        assert any(found.values()), (path.name, named)
        return
    users = re.findall(r"nerf_pl_tpu_torch/[\w/]+\.py", head)
    assert users, f"{path.name} names no module of the port that needs it"
    entries = _build.c_entries(text)
    assert any(re.search(rf"\blib\.{e}\(", (REPO / u).read_text())
               for u in users for e in entries), (path.name, users)
    code = code_of(path)
    working = [m for m in re.finditer(r"__global__[^;{]*\{", code)
               if balanced(code, m.end() - 1).strip("{} \n")]
    if working:
        assert re.search(r"\d+ bytes a \w+", head), path.name
        assert re.search(r"[\d.]+ MB\b", head), path.name
        assert re.search(r"[\d.]+ (us|ms) at [\d.]+ TB/s", head), path.name


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


# kernel: whether a backward follows its forward tiles ("trunk": the
# sigma-only kernels, whose tiles run the trunk alone)
WGMMA_KERNELS = {"fwdbwd_kernel": True, "fwd_quad_kernel": False,
                 "point_fwdbwd_kernel": True, "mlp_fwd_kernel": False,
                 "eval_quad_kernel": False, "wgrad_kernel": None,
                 "sigma_quad_kernel": "trunk", "sigma_fwd_kernel": "trunk"}


@pytest.mark.parametrize("kernel", list(WGMMA_KERNELS))
def test_backward_launches_use_wgmma_and_tma(kernel):
    """Launches A of mse_render and train_bwd (fwdbwd), A' of mlp_bwd
    (point_fwdbwd), train_fwd (fwd_quad), mlp_fwd and render_eval
    (eval_quad) through mlp_wgmma.cuh's forward tile loop, sigma_render
    (sigma_quad) and sigma_fwd through its trunk alone (trunk_tile, fed by
    produce_trunk; no feature, view or rgb slab), and launch B (wgrad,
    inline) issue wgmma on TMA-loaded tiles behind mbarriers (slab_mma,
    fed by the producer's put_slab); no WMMA is reached from any of
    them."""
    defs = definitions()
    assert kernel in defs
    text = reach(kernel, defs)
    assert re.search(r"wgmma_n(128|256)<", text)
    assert "tma_load(" in text and "mbar_wait(" in text
    assert "wmma::" not in text and "mlp_tile" not in text
    backward = WGMMA_KERNELS[kernel]
    body = defs[kernel]
    if backward == "trunk":
        assert "trunk_tile<" in body and "produce_trunk(" in body
        for full in ("forward_tile", "produce_fwd", "backward_tile",
                     "WeightMaps", "epi_view"):
            assert full not in text, full
        assert "wgmma_n256<" in text
    elif backward is not None:
        assert "forward_tile<" in body and "produce_fwd(" in body
        assert ("backward_tile(" in body) == backward


def test_every_sigma_comes_from_trunk_tile():
    """forward_tile runs the trunk through trunk_tile and produce_fwd
    streams its slabs through produce_trunk, and the sigma head (the only
    epi_fwd256<..., true, ...> call) is in trunk_tile alone: every sigma of
    the port comes from one code path, which makes sigma_fwd's sigma
    mlp_fwd's, and sigma_render's weights train_fwd's, bit for bit."""
    defs = definitions()
    assert "trunk_tile<" in defs["forward_tile"]
    assert "produce_trunk(" in defs["produce_fwd"]
    heads = [name for name, body in defs.items()
             if re.search(r"epi_fwd256<\s*\w+\s*,\s*true", body)]
    assert heads == ["trunk_tile"], heads
    assert "quad_weights(" in defs["quad_forward"]
    assert "quad_weights(" in defs["sigma_quad_kernel"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_wmma_left(path):
    """No source, comments included, names the WMMA API or its header."""
    text = path.read_text()
    for gone in ("wmma::", "<mma.h>", "nvcuda"):
        assert gone not in text, (path.name, gone)


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
    """The WMMA kernels and their tile (the 64-point tile of nerf_mlp.cuh
    with its shared-memory layout, fragments, slab loads and products, the
    WMMA sigma_render and sigma_fwd, and every WMMA kernel of the full MLP
    before them) have no definition left, none of their constants or types
    is named in any source, and nerf_mlp.cuh defines no tile loop: only the
    weights' accessor, the layout's alignment and the embedding's point
    and column helpers, none with a loop, a kernel or a bool template, and
    none reading the feature, view or rgb weights."""
    defs = definitions()
    for gone in ("mlp_bwd_kernel", "train_fwd_kernel", "backward_from_heads",
                 "store_grad", "ActSink", "copy_rows", "TrainLayout",
                 "point_fwd_kernel", "render_kernel", "quadrature",
                 "launch_fwd", "sigma_point_kernel", "sigma_render_kernel",
                 "sigma_quadrature", "build_inputs", "build_point_inputs",
                 "mlp_tile", "gemm_acc", "store_relu", "load_slab",
                 "cp_async16", "smem_at", "zero", "rays_per_block",
                 "eval_rays_per_block"):
        assert gone not in defs, gone
    for path in SOURCES:
        assert not re.search(
            r"\b(ActSink|backward_from_heads|SmemLayout|Smem|FragA|FragB|"
            r"FragC|TP|NWARPS|NTHREADS|KS|PAD|LDH|LDX|LDW|PPB)\b",
            code_of(path)), path.name
    code = code_of(CSRC / "nerf_mlp.cuh")
    assert "FULL" not in code and "__global__" not in code
    assert not re.search(r"\b(for|while)\s*\(", code)
    assert not re.search(r"template\s*<\s*bool", code)
    found = []
    for m in re.finditer(r"\b(\w+)\s*(<[^;{()]*>)?\s*"
                         r"\((?:[^;{()]|\([^()]*\))*\)\s*(const\s*)?\{",
                         code):
        if m.group(1) in KEYWORDS:
            continue
        found.append(m.group(1))
        if m.group(1) == "weights_at":
            continue
        body = balanced(code, m.end() - 1)
        assert not re.search(r"\bp\.(wf|bf|wdf|wdd|bd|wr|br)\b", body), \
            m.group(1)
        assert "rgb" not in body, m.group(1)
    assert sorted(found) == ["align128", "point_coord", "sincos_col",
                             "weights_at"], found


def test_launch_a_blocks_are_whole_tiles_of_whole_rays():
    """Launch A's rays a block (fused_train.cu) come from one rule on S
    alone, which AShape applies for mse_render, train_bwd and train_fwd
    alike: the fewest whole rays that fill whole 128-point tiles, AT /
    gcd(S, AT), where their backward block fits shared memory with three
    ring stages. Nothing but S reaches the rule, so no flag or template
    argument can select another geometry, and the train args take their
    rpb from AShape."""
    rule = definitions()["a_rays_per_block"]
    assert "std::gcd(S, AT)" in rule and "FbLayout(S, whole, 3, BWD)" in rule
    code = code_of(CSRC / "fused_train.cu")
    assert re.findall(r"\ba_rays_per_block\s*\(([^)]*)\)", code) == [
        "int S", "S"]
    assert re.findall(r"\brpb\s*=[^;]*;", code) == [
        "rpb = AShape(R, S).rpb;"]


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


def test_marks_are_the_profiling_phases():
    """marks.cu declares one tag a phase of profiling.MARKS, and its table
    of empty kernels (whose index is the phase's C id) lists them in
    MARKS' order; the mark kernel does nothing."""
    from nerf_pl_tpu_torch.utils.profiling import MARKS
    code = code_of(CSRC / "marks.cu")
    tags = re.findall(r"^struct (\w+);", code, flags=re.M)
    assert tags == list(MARKS)
    table = re.search(r"MARK_FNS\[\]\s*=\s*\{(.*?)\};", code, re.S)
    assert re.findall(r"mark<span::(\w+)>", table.group(1)) == list(MARKS)
    assert re.search(r"__global__ void mark\(\)\s*\{\}", code)
    assert len(set(MARKS)) == len(MARKS)
