"""PyTorch port of the in-network-learning system in `src/repro/`, for an
NVIDIA H100.

The package mirrors `src/repro/` file for file; each module names the JAX
module it is held against.  It imports torch and numpy, never JAX and
nothing of `repro`.  Every Pallas kernel of the JAX package on a ported path
is a hand-written CUDA kernel here (`kernels/csrc/`), with a plain PyTorch
version beside it that CPU tensors take.

Entry points take `device=None`, which means "cuda": without a card they
raise rather than carry on on the CPU.  Pass `device="cpu"` to run the
plain versions on the CPU, as the tests do.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, with None meaning "cuda"; raises when a CUDA device is
    asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch entry points run on "
            "the card unless called with device='cpu'")
    return dev


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Apply `fn` to every tensor leaf of nested dicts, lists, tuples and
    NamedTuples, keeping the structure; with `rest`, to the leaves of
    several trees of one structure at once (fn(leaf, *rest_leaves))."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return tree


def tree_leaves(tree) -> list:
    """Every tensor leaf of `tree`, in `tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """`tree`'s structure with its tensor leaves replaced, in `tree_map`
    order, by `leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
