"""Sharding rules: which block of each tensor a rank of a mesh holds.

Reference: src/repro/launch/sharding.py.  Two halves:

The scheme rounds' layouts (`scheme_batch_shardings`; the state layouts
of `Scheme.state_shardings`).  The reference places global arrays on a
mesh with NamedShardings and lets GSPMD move them; the port's ranks hold
their blocks physically, so a layout here is a slice:

    scheme_batch_shardings   this rank's index of the epoch's views
                             (K, R, J, B, ...) and labels (K, R, B): J on
                             'client', B on 'data', divisibility-guarded:
                             an axis that does not divide stays replicated
    shard_state              this rank's slice of a state tree, given a
                             spec tree (`Scheme.state_shardings`: per leaf
                             the mesh axis its leading dim lies on, or None
                             for replicated)
    gather_state             the full state back from the slices: one
                             all_gather a dtype over each axis

The LLM rules (`param_spec`, `param_shardings`, `batch_spec`,
`batch_shardings`, `wire_specs`, `cache_spec`, `cache_shardings`,
`opt_state_shardings`): Megatron-style tensor parallelism on the 'model'
axis + FSDP-style parameter sharding on the 'data' axis, as path-keyed
rules over NEGATIVE dim indices so stacked (scan) leading axes never shift
a rule:

    column weights  (…, d_in, d_out): d_out -> model, d_in -> data (FSDP)
    row weights     (…, d_in, d_out): d_in -> model, d_out -> data (FSDP)
    expert weights  (…, E, d, f):     E -> model (expert parallel), d -> data
    embeddings      (…, V, d):        V -> model, d -> data
    INL encoders    (J, …):           J -> client (paper mode)
    norms / biases / scalars:         replicated

Every rule is divisibility-guarded: a dim that does not divide by the mesh
axis size stays replicated on that axis.  A spec is a `PartitionSpec`, a
tuple with one entry a dim: a mesh axis name, a tuple of names, or None
(replicated); the rules read a mesh's `axis_names` and `shape` only, so a
`launch/mesh.AbstractMesh` of 256 or 512 chips serves as well as a `Mesh`
of ranks.  A leaf is a tensor (a `meta` one carries the shape alone) or a
(shape, dtype) pair; a path is the tuple of dict keys (str), list indices
(int) and NamedTuple fields (`Field`) down to it, and the rules read its
dict keys only, as the reference's read `DictKey`s.  `shard_shape` and
`leaf_shard_bytes` give what one rank holds under a spec tree.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import tree_leaves, tree_map, tree_unflatten


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _block(mesh, name: str, n: int) -> slice:
    """This rank's block of a length-n dim sharded over axis `name`, or
    the whole dim when the axis is absent, of size 1 or does not divide
    n."""
    size = _axis_size(mesh, name)
    if size > 1 and n % size == 0:
        return mesh.axis(name).block(n)
    return slice(None)


def scheme_batch_shardings(mesh, num_clients: int,
                           batch_size: int) -> Tuple[tuple, tuple]:
    """(views index, labels index): this rank's block of the whole-epoch
    views (K, R, J, B, ...) and labels (K, R, B) of a scheme round, J on
    'client' and B on 'data', the scan and round axes whole."""
    c = _block(mesh, "client", num_clients)
    d = _block(mesh, "data", batch_size)
    return (slice(None), slice(None), c, d), (slice(None), slice(None), d)


def shard_state(tree, specs, mesh):
    """This rank's slice of `tree`: a leaf whose spec names a mesh axis is
    cut to the rank's block of its leading dim (a copy, so the full tensor
    can be freed); a None spec keeps the leaf whole."""
    def cut(t, axis):
        if axis is None:
            return t
        return t[mesh.axis(axis).block(t.shape[0])].clone()
    return tree_map(cut, tree, specs)


def gather_state(tree, specs, mesh):
    """The full tree from every rank's slice (`shard_state`'s inverse),
    with one all_gather a dtype over each axis; every rank gets the same
    tree.  Collective: every rank of the mesh calls it."""
    leaves = tree_leaves(tree)
    spec_of = []                      # each leaf's spec, in leaf order
    tree_map(lambda t, a: spec_of.append(a), tree, specs)
    out = list(leaves)
    for name in mesh.axis_names:
        idx = [i for i, a in enumerate(spec_of) if a == name]
        if not idx:
            continue
        full = mesh.axis(name).gather_tree([leaves[i] for i in idx])
        for i, t in zip(idx, full):
            out[i] = t
    return tree_unflatten(tree, out)


# ---------------------------------------------------------------------------
# The LLM rules: trees, paths and specs
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Field(str):
    """A NamedTuple field in a path (the reference's `GetAttrKey`: no
    rule reads it)."""


def _is_pair(t) -> bool:
    return (isinstance(t, tuple) and len(t) == 2
            and isinstance(t[1], torch.dtype))


def _shape(leaf) -> tuple:
    return tuple(leaf[0]) if _is_pair(leaf) else tuple(leaf.shape)


def _dtype(leaf) -> torch.dtype:
    return leaf[1] if _is_pair(leaf) else leaf.dtype


def map_with_path(fn, tree, path: tuple = ()):
    """`tree` (dicts, lists, tuples, NamedTuples) with every leaf (a
    tensor or a (shape, dtype) pair) replaced by fn(path, leaf)."""
    if isinstance(tree, torch.Tensor) or _is_pair(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (Field(f),))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def _path_names(path) -> list:
    return [p for p in path if isinstance(p, str) and not isinstance(p, Field)]


def _assign(spec: list, axis_idx: int, mesh_axis: str, dim: int,
            mesh) -> None:
    size = _axis_size(mesh, mesh_axis)
    if size > 1 and dim % size == 0 and spec[axis_idx] is None:
        spec[axis_idx] = mesh_axis


# path-name classification
_COLUMN = {"wq", "wk", "wv", "wi", "wg", "up", "wx", "in_proj", "wq_a",
           "wq_b", "wkv_a", "wk_b", "wv_b", "unembed", "heads", "w_if",
           "mu", "logvar"}
_ROW = {"wo", "down", "out_proj", "adapter"}
_EMBED = {"embed"}
_MOE_STACK = {"moe"}
_REPLICATE = {"router", "conv", "r", "A_log", "D", "dt_bias", "norm",
              "q_norm", "kv_norm", "attn_norm", "ffn_norm", "final_norm",
              "scale", "bias", "b"}


def param_spec(path, leaf, mesh, *, fsdp: bool = True,
               client_axis: bool = False) -> PartitionSpec:
    names = _path_names(path)
    shape = _shape(leaf)
    nd = len(shape)
    spec: list = [None] * nd

    if client_axis and names and names[0] == "encoders" and nd >= 1:
        # INL: leading J axis of stacked per-node encoders
        if shape[0] % _axis_size(mesh, "client") == 0:
            spec[0] = "client"

    def done():
        return P(*spec)

    if nd == 0 or not names:
        return done()
    last = names[-1]
    parents = set(names[:-1])

    if last in _REPLICATE or nd == 1:
        return done()

    if parents & _MOE_STACK and last in {"wi", "wg", "wo"} and nd >= 3:
        _assign(spec, nd - 3, "model", shape[nd - 3], mesh)   # experts
        if fsdp:
            _assign(spec, nd - 2, "data", shape[nd - 2], mesh)
        return done()

    if last in _EMBED or names[-2:] == ["embed", "w"] or "embed" in parents:
        _assign(spec, nd - 2, "model", shape[nd - 2], mesh)    # vocab
        if fsdp:
            _assign(spec, nd - 1, "data", shape[nd - 1], mesh)
        return done()

    owner = names[-2] if last == "w" and len(names) >= 2 else last
    if owner in _COLUMN:
        _assign(spec, nd - 1, "model", shape[nd - 1], mesh)
        if fsdp:
            _assign(spec, nd - 2, "data", shape[nd - 2], mesh)
        return done()
    if owner in _ROW:
        _assign(spec, nd - 2, "model", shape[nd - 2], mesh)
        if fsdp:
            _assign(spec, nd - 1, "data", shape[nd - 1], mesh)
        return done()
    # default: FSDP the largest dim on data
    if fsdp and nd >= 2:
        big = int(np.argmax(shape))
        _assign(spec, big, "data", shape[big], mesh)
    return done()


def param_shardings(params, mesh, *, fsdp: bool = True,
                    client_axis: bool = False):
    """The spec of every leaf of `params` (tensors, meta tensors or
    (shape, dtype) pairs), in the tree's structure."""
    return map_with_path(
        lambda path, leaf: param_spec(path, leaf, mesh, fsdp=fsdp,
                                      client_axis=client_axis), params)


def _dp(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_spec(name: str, leaf, mesh) -> PartitionSpec:
    dp = _dp(mesh)
    shape = _shape(leaf)
    nd = len(shape)
    if nd == 0:
        return P()
    total = int(np.prod([_axis_size(mesh, a) for a in dp]))
    if total > 1 and shape[0] % total == 0:
        return P(dp, *([None] * (nd - 1)))
    # long_500k: batch=1 -> shard the sequence axis instead where possible
    if nd >= 2 and shape[1] % total == 0 and total > 1:
        return P(None, dp, *([None] * (nd - 2)))
    return P(*([None] * nd))


def batch_shardings(batch_specs, mesh) -> dict:
    return {k: batch_spec(k, v, mesh) for k, v in batch_specs.items()}


def wire_specs(mesh):
    """Specs of the INL cut layer's (J, B, S, d_b) latents or their
    (J, B, S, W) codeword lanes around the link: (gathered, client) —
    `client` with 'client' on the J axis (before the link: each node holds
    its own chunk), `gathered` with the client axis replicated (after
    it).  Both None when the mesh has no 'client' axis."""
    if mesh is None or "client" not in mesh.axis_names:
        return None, None
    dp = _dp(mesh)
    gathered = P(None, dp or None, None, None)
    client = P("client", dp or None, None, None)
    return gathered, client


_CACHE_BATCH_AXIS = {"k": -4, "v": -4, "c_kv": -3, "k_rope": -3,
                     "conv": -3, "ssm": -4, "C": -4, "n": -3, "m": -2,
                     "c": -3, "h": -3}
_CACHE_TIME_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}
_CACHE_HEAD_AXIS = {"k": -2, "v": -2, "ssm": -3, "C": -3, "n": -2, "m": -1,
                    "c": -2, "h": -2}


def cache_spec(path, leaf, mesh) -> PartitionSpec:
    names = _path_names(path)
    name = names[-1] if names else ""
    shape = _shape(leaf)
    dp = _dp(mesh)
    total = int(np.prod([_axis_size(mesh, a) for a in dp]))
    nd = len(shape)
    spec: list = [None] * nd
    ba = _CACHE_BATCH_AXIS.get(name)
    if ba is not None and -ba <= nd:
        if total > 1 and shape[ba] % total == 0:
            spec[ba % nd] = dp
        elif name in _CACHE_TIME_AXIS:
            # batch=1 long-context: shard the cache TIME axis over data
            ta = _CACHE_TIME_AXIS[name] % nd
            if shape[ta] % total == 0 and total > 1:
                spec[ta] = dp
    ha = _CACHE_HEAD_AXIS.get(name)
    msize = _axis_size(mesh, "model")
    if ha is not None and -ha <= nd:
        if msize > 1 and shape[ha] % msize == 0 and spec[ha % nd] is None:
            spec[ha % nd] = "model"
            return P(*spec)
    # kv heads that do not divide the model axis: shard the cache TIME
    # axis over 'model' instead (flash-decode style)
    if name in _CACHE_TIME_AXIS and msize > 1:
        ta = _CACHE_TIME_AXIS[name] % nd
        if spec[ta] is None and shape[ta] % msize == 0:
            spec[ta] = "model"
    return P(*spec)


def cache_shardings(cache, mesh):
    return map_with_path(lambda path, leaf: cache_spec(path, leaf, mesh),
                         cache)


def opt_state_shardings(opt_state, param_specs, mesh, *, zero1: bool = True):
    """m / v / master mirror the parameters' layout, the step is
    replicated.  With zero1, a still-replicated dim of a state leaf that
    divides by the free batch axes' size is sharded over them (ZeRO-1:
    the optimizer state fully partitioned).  `param_specs` is the
    reference's argument, which it does not read either: each state leaf's
    spec is its parameter's, recomputed from the path below its m / v /
    master key."""
    del param_specs

    def one(path, leaf):
        names = _path_names(path)
        shape = _shape(leaf)
        if len(shape) == 0 or (names and names[0] == "step"):
            return P()
        spec = list(param_spec(path[1:], leaf, mesh))
        if zero1:
            dp = _dp(mesh)
            used = {a for s in spec if s is not None
                    for a in (s if isinstance(s, tuple) else (s,))}
            free = tuple(a for a in dp if a not in used)
            total = int(np.prod([_axis_size(mesh, a) for a in free])) \
                if free else 1
            if total > 1:
                for ax in range(len(shape)):
                    if spec[ax] is None and shape[ax] % total == 0:
                        spec[ax] = free if len(free) > 1 else free[0]
                        break
        return P(*spec)

    return map_with_path(one, opt_state)


def shard_shape(shape, spec, mesh) -> tuple:
    """The block of a `shape` tensor one rank holds under `spec`: each dim
    divided by the sizes of the axes it lies on."""
    out = []
    for n, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for a in axes:
            n //= _axis_size(mesh, a)
        out.append(n)
    return tuple(out) + tuple(shape[len(spec):])


def leaf_shard_bytes(tree, specs, mesh) -> list:
    """The bytes one rank holds of each leaf of `tree` (tensors or (shape,
    dtype) pairs), in leaf order, under the spec tree `specs` (of the
    same structure); `sum()` of it is the rank's share of the tree."""
    out = []

    def one(path, leaf):
        spec = specs
        for p in path:
            spec = getattr(spec, p) if isinstance(p, Field) else spec[p]
        n = int(np.prod(shard_shape(_shape(leaf), spec, mesh),
                        dtype=np.int64))
        out.append(n * _dtype(leaf).itemsize)
    map_with_path(one, tree)
    return out
