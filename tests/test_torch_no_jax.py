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
        if m.name != "nerf_pl_tpu_torch.eval":   # imports datasets in main()
            mods.append(m.name)
    return mods


def test_port_imports_no_jax_and_no_pil():
    mods = _modules()
    assert "nerf_pl_tpu_torch.ops.fused_render" in mods
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
