"""The port imports neither jax nor PIL: the machine with the card has no
jax, and may have no PIL. Checked in a fresh interpreter, since this test
process has both loaded."""
import os
import pkgutil
import subprocess
import sys

import nerf_pl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    mods = ["nerf_pl_tpu_torch"]
    for m in pkgutil.walk_packages(nerf_pl_tpu_torch.__path__,
                                   "nerf_pl_tpu_torch."):
        # the CLIs import the shared parser and datasets in main()
        if m.name not in ("nerf_pl_tpu_torch.eval", "nerf_pl_tpu_torch.train"):
            mods.append(m.name)
    return mods


def test_port_imports_no_jax_and_no_pil():
    mods = _modules()
    for name in ("ops.fused_mlp", "ops.fused_render", "ops.fused_train",
                 "datasets.synthetic", "parallel.spmd",
                 "training.system", "training.optimizers",
                 "training.lr_schedule", "training.losses", "device"):
        assert f"nerf_pl_tpu_torch.{name}" in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'PIL'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eval_module_imports_without_jax():
    """eval imports the shared datasets only inside main()."""
    code = ("import sys\n"
            "import nerf_pl_tpu_torch.eval as e\n"
            "e.build_parser()\n"
            "sys.exit(1 if any(k.split('.')[0] in ('jax', 'PIL')\n"
            "                  for k in sys.modules) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_train_cli_parses_without_jax():
    """The train CLI and the JAX package's shared parser it uses import
    neither jax nor PIL (the datasets come in with fit())."""
    code = ("import sys\n"
            "import nerf_pl_tpu_torch.train\n"
            "from nerf_pl_tpu.config import get_opts\n"
            "from nerf_pl_tpu_torch.training.system import unported\n"
            "assert unported(get_opts(['--fused_train'])) is None\n"
            "sys.exit(1 if any(k.split('.')[0] in ('jax', 'PIL')\n"
            "                  for k in sys.modules) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
