"""Checkpoint loading: partial (prefix-filtered) loads of one model's params.

Port of the loading half of nerf_pl_tpu/training/checkpoints.py. The file
format is the JAX package's: one .npz with every leaf under a '/'-joined
key ("params/{model}/{layer}/{w|b}" in a full train state,
"{model}/{layer}/{w|b}" in a weights-only export) plus a JSON '__meta__'
blob, so one checkpoint loads in both packages. Saving and resume are
ROADMAP item A1.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def extract_model_state_dict(ckpt_path: str, model_name: str = "nerf_coarse",
                             prefixes_to_ignore=()) -> Dict[str, np.ndarray]:
    """One model's {'layer/leaf': array} out of any checkpoint file; keys
    starting with any of prefixes_to_ignore (relative to the model root)
    are skipped."""
    with np.load(ckpt_path) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    out = {}
    for key, arr in arrays.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if not parts or parts[0] != model_name:
            continue
        rel = "/".join(parts[1:])
        if any(rel.startswith(p) for p in prefixes_to_ignore):
            print(f"[load_ckpt] ignoring {model_name}/{rel}")
            continue
        out[rel] = arr
    if not out:
        raise KeyError(
            f"checkpoint {ckpt_path!r} contains no leaves for model "
            f"{model_name!r} (after filtering {list(prefixes_to_ignore)}); "
            f"available roots: {sorted({k.split('/')[0] for k in arrays})}")
    return out


def load_ckpt(params: Dict[str, Any], ckpt_path: str,
              model_name: str = "nerf_coarse",
              prefixes_to_ignore=()) -> Dict[str, Any]:
    """Non-strict partial load of one model's params.

    Returns a new params tree in which {model_name}'s leaves present in the
    checkpoint are replaced by tensors of the template leaf's dtype and
    device; missing leaves keep their values. Raises if nothing matched or
    a shape differs."""
    loaded = extract_model_state_dict(ckpt_path, model_name,
                                      prefixes_to_ignore)
    target = {layer: dict(leaves) for layer, leaves in
              params[model_name].items()}
    n_matched = 0
    for rel, arr in loaded.items():
        layer, leaf = rel.split("/")
        if layer in target and leaf in target[layer]:
            old = torch.as_tensor(target[layer][leaf])
            if tuple(arr.shape) != tuple(old.shape):
                raise ValueError(f"shape mismatch for {model_name}/{rel}: "
                                 f"ckpt {arr.shape} vs params "
                                 f"{tuple(old.shape)}")
            target[layer][leaf] = torch.as_tensor(arr, dtype=old.dtype,
                                                  device=old.device)
            n_matched += 1
    if n_matched == 0:
        raise KeyError(
            f"checkpoint {ckpt_path!r} has {len(loaded)} leaves for "
            f"{model_name!r} but none match the current parameter tree — "
            f"refusing a silent no-op load")
    out = dict(params)
    out[model_name] = target
    return out
