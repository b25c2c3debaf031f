"""The look for jax and the JAX package among a process's loaded modules.

A run makes it once its window has closed, in the process that prints
the result and in each rank of a data-parallel run (every rank is an
interpreter of its own), and exits non-zero if any of them lists one.
"""
from __future__ import annotations

import sys
from typing import Dict, List

BANNED = ("jax", "jaxlib", "flax", "nerf_pl_tpu")


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is jax,
    jaxlib, flax or the JAX package (nerf_pl_tpu_torch is not)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in BANNED)


def found(by_process: Dict[str, List[str]]) -> str:
    """'' when no process listed a module, else what each one listed."""
    return "; ".join(f"in {who}: {mods}" for who, mods in
                     by_process.items() if mods)
