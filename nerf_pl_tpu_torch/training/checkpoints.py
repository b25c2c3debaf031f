"""Checkpoints: full train-state save and resume, top-k retention,
partial (prefix-filtered) loads of one model's params, and the
weights-only export.

Port of nerf_pl_tpu/training/checkpoints.py, with its file format: one .npz
with every leaf under a '/'-joined key path ("params/{model}/{layer}/{w|b}",
"opt_state/0/mu/...", "step" in a full train state; "{model}/{layer}/{w|b}"
in a weights-only export) plus a JSON '__meta__' blob. A state saved by
either package resumes in the other: a NamedTuple's fields, a tuple's
indices and a dict's keys make the same paths as JAX's tree paths, tensors
are stored as numpy (bf16 widened to f32) and a Python int leaf (the step)
as int32.

A tensor parallel state (parallel/mesh.py) holds this rank's blocks of the
params and moments. `gather_state` is the counterpart of JAX's
device_fetch of sharded arrays: it gathers the blocks over the model
group, so that one rank writes the whole arrays under the same keys; and
`load_checkpoint(..., tp=)` takes this rank's blocks of a whole file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of a container, or None for a leaf."""
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    return None


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _rebuild(tree, vals):
    """A container like `tree` holding `vals` in `_children`' order."""
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), vals))
    return type(tree)(vals)


def map_with_paths(fn, tree, prefix: str = ""):
    """`tree` with each leaf replaced by fn(path, leaf), where path is the
    leaf's '/'-joined key in a checkpoint."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_paths(fn, v, f"{prefix}/{k}" if prefix
                                          else k) for k, v in kids])


def gather_state(state, tp=None):
    """The whole state of a tensor parallel one: each leaf split over the
    model axis gathered from its blocks (collective: every rank of the
    model group calls it). Without tp, the state itself."""
    return state if tp is None else map_with_paths(tp.gather_leaf, state)


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'/'-joined path: numpy leaf} of a state tree."""
    kids = _children(tree)
    if kids is None:
        return {prefix: _to_numpy(tree)}
    out = {}
    for k, v in kids:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def save_checkpoint(path: str, state, meta: Optional[Dict[str, Any]] = None):
    """Save a train state (or any tree) + JSON metadata to one .npz file."""
    flat = flatten_with_paths(state)
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                     dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_meta(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        if "__meta__" not in z:
            return {}
        return json.loads(bytes(z["__meta__"].tobytes()).decode())


def load_checkpoint(path: str, template, tp=None
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Restore a tree saved by either package into `template`'s structure:
    tensor leaves take the template's dtype and device, int leaves stay
    ints. Every leaf of the template must be in the file (full resume).
    With a tensor parallel layout `tp` the template holds blocks, and
    each split leaf takes this rank's block of the file's whole array.
    Returns (restored tree, meta)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = (json.loads(bytes(z["__meta__"].tobytes()).decode())
                if "__meta__" in z.files else {})

    def build(key, tree):
        if key not in arrays:
            raise KeyError(f"checkpoint {path!r} missing leaf {key!r}")
        arr = arrays[key]
        if isinstance(tree, torch.Tensor):
            t = torch.as_tensor(np.array(arr))
            if tp is not None:
                t = tp.shard_leaf(key, t)
            if tuple(t.shape) != tuple(tree.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(t.shape)} vs template "
                                 f"{tuple(tree.shape)}")
            return t.to(device=tree.device, dtype=tree.dtype)
        if isinstance(tree, int):
            if arr.shape != ():
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs a scalar")
            return int(arr)
        return arr

    return map_with_paths(build, template), meta


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


def model_names(ckpt_path: str) -> List[str]:
    """The models a checkpoint holds: its params' first keys in a full
    train state, else its first keys (a weights-only export); nerf_coarse
    and nerf_fine, or mip-NeRF 360's prop_mlp and nerf_mlp."""
    with np.load(ckpt_path) as z:
        keys = [k.split("/") for k in z.files if k != "__meta__"]
    full = [k[1:] for k in keys if k[0] == "params"]
    return sorted({k[0] for k in (full or keys)})


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



def save_weights_only(src_ckpt: str, dst_path: str):
    """Strip a full checkpoint to bare model weights (~5 MB portable scene):
    its "params/{model}/..." leaves as "{model}/..." (the JAX package's
    weights-only format, which load_ckpt reads in both packages)."""
    with np.load(src_ckpt) as z:
        flat = {}
        for k in z.files:
            if k.startswith("params/"):
                flat[k[len("params/"):]] = z[k]
    if not flat:
        raise ValueError(f"{src_ckpt!r} contains no params/ leaves")
    with open(dst_path, "wb") as f:
        np.savez(f, **flat)

class TopKCheckpoints:
    """Keep the k best checkpoints by a monitored value (lower is better).

    The (monitored, path) bookkeeping persists in `topk.json` in the
    checkpoint directory (the JAX package's format), so a resumed run of
    either package keeps evicting relative to earlier checkpoints."""

    def __init__(self, ckpt_dir: str, k: int = 5,
                 filename: str = "epoch={epoch}.ckpt"):
        self.ckpt_dir = ckpt_dir
        self.k = k
        self.filename = filename
        self.entries: List[Tuple[float, str]] = []  # (monitored, path)
        os.makedirs(ckpt_dir, exist_ok=True)
        self._state_path = os.path.join(ckpt_dir, "topk.json")
        if os.path.exists(self._state_path):
            with open(self._state_path) as f:
                saved = json.load(f)
            # drop entries whose files were deleted out-of-band
            self.entries = [(float(m), p) for m, p in saved.get("entries", [])
                            if os.path.exists(p)]

    def _persist(self):
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"k": self.k, "entries": self.entries}, f)
        os.replace(tmp, self._state_path)

    def maybe_save(self, state, monitored: float, epoch: int,
                   meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Save if among the best k; evict the worst beyond k. Returns the
        path, or None when not saved."""
        path = os.path.join(self.ckpt_dir, self.filename.format(epoch=epoch))
        if len(self.entries) >= self.k:
            worst = max(self.entries, key=lambda e: e[0])
            if monitored >= worst[0]:
                return None
        meta = dict(meta or {})
        meta.update({"epoch": epoch, "monitored": float(monitored)})
        save_checkpoint(path, state, meta)
        # re-saving the same epoch path replaces its old entry
        self.entries = [e for e in self.entries if e[1] != path]
        self.entries.append((float(monitored), path))
        if len(self.entries) > self.k:
            worst = max(self.entries, key=lambda e: e[0])
            self.entries.remove(worst)
            if worst[1] != path and os.path.exists(worst[1]):
                os.remove(worst[1])
        self._persist()
        return path

    @property
    def best(self) -> Optional[Tuple[float, str]]:
        return min(self.entries, key=lambda e: e[0]) if self.entries else None
