"""The port's shared helpers: the device rule and the tensor-tree
functions every module uses.

`repro_torch/__init__.py` exports them lazily, so that importing the
package (as a spawned cluster worker does) loads no torch.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tracing


def resolve_device(device=None) -> torch.device:
    """`device`, with None meaning "cuda"; raises when a CUDA device is
    asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch entry points run on "
            "the card unless called with device='cpu'")
    return dev


def as_generator(generator, device: torch.device) -> torch.Generator:
    """`generator`, a torch.Generator on `device`'s type, or an int seed of
    a new one there.  On the `meta` device, which draws nothing, any
    generator will do (an int seeds one on the host)."""
    if device.type == "meta":
        return generator if isinstance(generator, torch.Generator) \
            else torch.Generator().manual_seed(generator)
    if isinstance(generator, int):
        return torch.Generator(device=device).manual_seed(generator)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, the "
                         f"parameters on {device}; draw them on one device")
    return generator


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


def tree_stack(trees):
    """Trees of one structure -> one tree whose leaves stack theirs along a
    new leading axis (the J nodes or clients)."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def value_and_grad(fn: Callable[..., Any], params, *args, **kwargs):
    """fn(params, *args, **kwargs) -> (loss, aux), differentiated with
    respect to every tensor leaf of `params` (a tree, or a tuple of trees)
    and nothing else.  Returns (loss detached, aux, grads): grads has
    `params`' structure, with zeros where a leaf does not reach the loss.
    The call is a step's "forward" and "backward" phases
    (`tracing.phase`)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    device = leaves[0].device
    with torch.enable_grad():
        with tracing.phase("forward", device):
            loss, aux = fn(tree_unflatten(params, leaves), *args, **kwargs)
        with tracing.phase("backward", device):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def as_input(params, x, device=None) -> torch.Tensor:
    """`x` (a tensor or an array) as fp32 on the device of `params`' tensor
    leaves, which must be `device` (None: cuda): a predict runs where its
    parameters lie and says so when asked to run elsewhere."""
    device = resolve_device(device)
    pdev = tree_leaves(params)[0].device
    if pdev.type != device.type or device.index not in (None, pdev.index):
        raise ValueError(f"parameters lie on {pdev}, predict was asked to "
                         f"run on {device}")
    return torch.as_tensor(x, dtype=torch.float32, device=pdev)
