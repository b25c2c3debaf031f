"""The port imports neither jax, nor the JAX package, nor PIL at import: the
machine with the card has no jax, and may have no PIL, and the port keeps
its own copies of the host code it needs (config, datasets, utils). Checked
in a fresh interpreter, since this test process has all of them loaded,
and in the source, so that an import inside a function is caught too."""
import ast
import os
import pkgutil
import subprocess
import sys

import nerf_pl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "PIL", "nerf_pl_tpu")
CHECK = ("bad = sorted(k for k in sys.modules\n"
         f"             if k.split('.')[0] in {BANNED!r})\n"
         "print(len(sys.modules), bad)\n"
         "sys.exit(1 if bad else 0)\n")


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _modules():
    mods = ["nerf_pl_tpu_torch"]
    for m in pkgutil.walk_packages(nerf_pl_tpu_torch.__path__,
                                   "nerf_pl_tpu_torch."):
        mods.append(m.name)
    return mods


def test_port_imports_no_jax_and_no_pil():
    mods = _modules()
    for name in ("ops.fused_mlp", "ops.fused_render", "ops.fused_train",
                 "datasets.synthetic", "datasets.blender", "datasets.llff",
                 "parallel.spmd", "training.system", "training.optimizers",
                 "training.lr_schedule", "training.losses", "device",
                 "config", "utils.synthetic", "eval", "train"):
        assert f"nerf_pl_tpu_torch.{name}" in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n" + CHECK)
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eval_module_imports_without_jax():
    """eval parses its flags with nothing of jax, PIL or the JAX package."""
    proc = _run("import sys\n"
                "import nerf_pl_tpu_torch.eval as e\n"
                "e.build_parser().parse_args(['--root_dir', 'r', "
                "'--ckpt_path', 'c'])\n" + CHECK)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_train_cli_parses_without_jax():
    """The train CLI and the port's copy of the parser import neither jax,
    nor PIL, nor the JAX package (PIL comes in when a dataset reads an
    image)."""
    proc = _run("import sys\n"
                "import nerf_pl_tpu_torch.train\n"
                "from nerf_pl_tpu_torch.config import get_opts\n"
                "from nerf_pl_tpu_torch.training.system import unported\n"
                "assert unported(get_opts(['--fused_train'])) is None\n"
                + CHECK)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    pkg = os.path.join(REPO, "nerf_pl_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _jax_package_imports(path):
    """(line, module) of every absolute import of nerf_pl_tpu or jax."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            if n.split(".")[0] in ("nerf_pl_tpu", "jax", "jaxlib"):
                yield node.lineno, n


def test_no_source_imports_the_jax_package():
    """An ast walk over every .py of the port and chip_smoke.py: no
    `import nerf_pl_tpu...` or `from nerf_pl_tpu... import`, at module
    level or inside a function (the port's own package aside)."""
    paths = list(_sources())
    assert len(paths) > 30 and paths[-1].endswith("chip_smoke.py")
    found = [f"{os.path.relpath(p, REPO)}:{line}: {mod}"
             for p in paths for line, mod in _jax_package_imports(p)]
    assert not found, "\n".join(found)
