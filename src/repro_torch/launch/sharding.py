"""Which block of a scheme's tensors a rank of a mesh holds.

Reference: src/repro/launch/sharding.py (`scheme_batch_shardings`; the
state layouts of `Scheme.state_shardings`).  The reference places global
arrays on a mesh with NamedShardings and lets GSPMD move them; the port's
ranks hold their blocks physically, so a layout here is a slice:

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

The pod meshes' LLM rules (parameters, caches, optimizer state over
'data'/'model') wait for ROADMAP item 6.7.
"""
from __future__ import annotations

from typing import Tuple

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
