"""Weights made from the seed on the device, one named leaf at a time, and
the walk that names the leaves of a parameter tree.

Each leaf is drawn by its own `torch.Generator`, seeded from the run's
seed and the leaf's name, in one call on the leaf's device: the benchmark
can make the same leaf again at any time (the reference does, and so does
the change it compares) without holding a copy.  A leaf's name is its path
in the program's tree: dict keys, list indices and NamedTuple fields
joined by dots.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Iterator, Tuple

import torch


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every tensor leaf of nested dicts, lists, tuples
    and NamedTuples, in the order the program's tree functions walk them."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def draw(name: str, shape, rule, *, seed: int, device,
         dtype=torch.float32) -> torch.Tensor:
    """The leaf `name` by its rule: ("normal", std), ("ones",) or
    ("zeros",); normal draws are fp32 from the leaf's own generator, then
    cast to `dtype`."""
    kind = rule[0]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    return (torch.randn(shape, generator=gen, device=device)
            * rule[1]).to(dtype)


def fill(tree, make: Callable[[str, tuple], torch.Tensor],
         replicas: int = 0) -> None:
    """Overwrite every leaf of the program's parameter tree in place with
    make(name, shape).  replicas=J: the leaves carry a leading axis of J
    equal replicas (FL's clients), and make() draws one replica."""
    with torch.no_grad():
        for name, t in named_leaves(tree):
            shape = tuple(t.shape[1:]) if replicas else tuple(t.shape)
            v = make(name, shape)
            if replicas and t.shape[0] != replicas:
                raise ValueError(f"{name}: {replicas} replicas expected, "
                                 f"shape {tuple(t.shape)}")
            t.copy_(v.expand(t.shape) if replicas else v)
