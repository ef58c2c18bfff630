"""Checkpointing: tree save/restore in one `.npz` with a JSON sidecar.

Reference: src/repro/checkpoint/__init__.py (`save`, `latest_step`,
`load_meta`, `restore`), over the port's trees: nested dicts, lists,
tuples and NamedTuples whose leaves are tensors (what `repro_torch.tree_map`
walks) or numpy arrays.  The files are the reference's, so either package
reads the other's directories:

    {name}_{step:08d}.npz   one array per leaf, keyed by the leaf's path:
                            dict keys, sequence indices and NamedTuple
                            field names joined by "/"
    {name}_{step:08d}.json  the sidecar: step, num_tensors, total_params,
                            every leaf's original dtype, plus `extra`

Crash-atomic: the npz is written first and the sidecar last, each under a
`.tmp` name moved into place with `os.replace`, and `latest_step` counts
only an npz whose sidecar is there.  A save killed at any point leaves the
previous complete checkpoint or the new one, never a torn one.

bf16 leaves are stored as fp32 (npz has no bf16; fp32 holds every bf16
value, so the round trip is bitwise lossless) and recorded as "bfloat16".
`restore` validates structure, shape and dtype against a template and
raises on a mismatch, with the reference's messages, instead of casting;
each leaf lands on its template leaf's device and dtype.
"""
from __future__ import annotations

import json
import os
import re
from typing import Callable, Optional

import numpy as np
import torch

_LEAF = (torch.Tensor, np.ndarray, np.generic)


def _map_with_path(fn: Callable, tree, path: tuple = ()):
    """`tree` with every tensor or numpy leaf replaced by fn(path, leaf),
    path the tuple of the reference's `_path_part`s down to it."""
    if isinstance(tree, _LEAF):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return tree


def _dtype_name(leaf) -> str:
    """numpy's name of the leaf's dtype ("float32", "bfloat16", ...)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _leaf_dtypes(tree) -> dict:
    """{path key: original dtype name} of every leaf, copying nothing."""
    out = {}
    _map_with_path(lambda path, leaf: out.__setitem__(
        "/".join(path), _dtype_name(leaf)), tree)
    return out


def _flatten_with_paths(tree):
    """Path-keyed leaves, npz-storable: (arrays, original dtype per key)."""
    out, dtypes = {}, {}

    def one(path, leaf):
        key = "/".join(path)
        dtypes[key] = _dtype_name(leaf)
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            # npz has no native bf16; fp32 round-trips bf16 losslessly
            arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:
            arr = np.asarray(leaf)
            if dtypes[key] == "bfloat16":
                arr = arr.astype(np.float32)
        out[key] = arr
    _map_with_path(one, tree)
    return out, dtypes


def _checkpoint_path(directory: str, step: int, name: str) -> str:
    return os.path.join(directory, f"{name}_{step:08d}.npz")


def save(directory: str, step: int, params, *, extra: Optional[dict] = None,
         name: str = "ckpt") -> str:
    """Write `params` (any tree of tensors or arrays, on any device) as
    checkpoint `step` under `directory`; `extra` (JSON-able) joins the
    sidecar.  Crash-atomic: the npz, then the sidecar, each to a `.tmp`
    name and moved into place.  Returns the npz's path."""
    os.makedirs(directory, exist_ok=True)
    arrays, dtypes = _flatten_with_paths(params)
    path = _checkpoint_path(directory, step, name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    meta = {"step": step, "num_tensors": len(arrays),
            "total_params": int(sum(a.size for a in arrays.values())),
            "dtypes": dtypes}
    if extra:
        meta.update(extra)
    meta_path = path.replace(".npz", ".json")
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_path + ".tmp", meta_path)
    return path


def latest_step(directory: str, name: str = "ckpt") -> Optional[int]:
    """The newest COMPLETE checkpoint: an npz counts only once its sidecar
    (written last) is in place.  None when there is none."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for fn in os.listdir(directory):
        m = re.match(rf"{name}_(\d+)\.npz$", fn)
        if m and os.path.exists(os.path.join(
                directory, fn.replace(".npz", ".json"))):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _resolve_step(directory: str, step: Optional[int], name: str) -> int:
    if step is None:
        step = latest_step(directory, name)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def load_meta(directory: str, step: Optional[int] = None,
              name: str = "ckpt") -> dict:
    """The sidecar of checkpoint `step` (None: the latest), where runners
    keep their resume context."""
    step = _resolve_step(directory, step, name)
    with open(_checkpoint_path(directory, step, name)
              .replace(".npz", ".json")) as f:
        return json.load(f)


def restore(directory: str, template, *, step: Optional[int] = None,
            name: str = "ckpt"):
    """Checkpoint `step` (None: the latest) in the structure of `template`,
    with `step`: (tree, step).

    Keys, shapes and recorded dtypes must match the template's, or
    ValueError; a checkpoint whose sidecar records no dtypes (written
    before they were recorded) skips the dtype check.  Each leaf takes its
    template leaf's type, dtype and (for tensors) device."""
    step = _resolve_step(directory, step, name)
    want_dtypes = _leaf_dtypes(template)
    try:
        saved_dtypes = load_meta(directory, step, name).get("dtypes")
    except FileNotFoundError:
        saved_dtypes = None
    with np.load(_checkpoint_path(directory, step, name)) as data:
        missing = set(want_dtypes) - set(data.files)
        extra_keys = set(data.files) - set(want_dtypes)
        if missing or extra_keys:
            raise ValueError(f"checkpoint mismatch: missing="
                             f"{sorted(missing)[:5]} extra="
                             f"{sorted(extra_keys)[:5]}")

        def one(path, leaf):
            key = "/".join(path)
            arr = data[key]
            if arr.shape != tuple(np.shape(leaf)):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(np.shape(leaf))}")
            if saved_dtypes is not None and key in saved_dtypes \
                    and saved_dtypes[key] != want_dtypes[key]:
                raise ValueError(
                    f"{key}: checkpoint dtype {saved_dtypes[key]} != "
                    f"template dtype {want_dtypes[key]} — refusing the "
                    f"silent cast")
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype)
            return np.asarray(arr, np.asarray(leaf).dtype)
        return _map_with_path(one, template), step
