"""Meshes: of torch.distributed ranks for the sharded rounds, and abstract
ones for the pod-scale layouts.

Reference: src/repro/launch/mesh.py (`_client_axis_size`,
`make_production_mesh`, `make_inl_mesh`, `make_inl_host_mesh`,
`make_host_mesh`, `data_axes`).  The reference runs
one process over many devices and names mesh axes for `shard_map`; the
port runs one process per rank, so a mesh axis is a process group:

    Mesh     the axes' names and sizes, this rank's coordinate on each and
             its device; `axis(name)` gives the axis as this rank sees it
    Axis     the group of the ranks that differ from this one only along
             the axis, its size and this rank's index on it, and the
             collectives over it

Ranks lie on the mesh row-major, as `jax.make_mesh` lays devices out: on a
('client', 'data') mesh of shape (c, d), rank r has client index r // d
and data index r % d.  A rank's device is cuda:(local_rank % device count),
local_rank from $LOCAL_RANK (torchrun sets it), else the global rank; on
one card every rank lands on cuda:0.  `device="cpu"` puts the mesh on the
host, as the tests do.  The caller initialises the default process group
(`torch.distributed.init_process_group`, with the backend it chooses:
NCCL for one rank a card, gloo where ranks share a card or run on the
host); nothing here picks or switches a backend.

Collectives inside a differentiated round are autograd Functions whose
backward is the reference's transpose under shard_map's check_rep=False:

    Axis.all_gather   tiled along dim 0; backward a summing reduce-scatter
                      (JAX's psum_scatter)
    Axis.psum         backward psum
    Axis.pmean        backward pmean

The raw transfers (`gather`, `reduce_scatter`, `all_reduce`, and their
`_tree` forms, which move many tensors in one flat buffer a dtype) carry
no gradient; the wire's own Functions (core/wirefmt.py) call them.  Integer
codeword lanes (torch.uint32) travel as an int32 view: neither gloo nor
NCCL has a uint32 collective.  Every call adds the bytes of this rank's
chunk (what it sends to a gather, what it receives from a reduce-scatter,
what it contributes to an all-reduce) to `Axis.traffic`; a replayed CUDA
graph runs no Python and adds nothing.

The 256- and 512-chip pod meshes (`make_production_mesh`, `make_inl_mesh`)
cannot be instantiated as ranks here, so they are `AbstractMesh`es: axis
names and sizes, no process group, as `jax.sharding.AbstractMesh` is.  The
LLM sharding rules (launch/sharding.py) and the dry-run (launch/dryrun.py)
read only `axis_names` and `shape`, which a `Mesh` exposes the same way.

The reference's `current_abstract_mesh` reads the ambient mesh that
`jax.sharding.set_mesh` installs; torch has no ambient mesh, so the port
passes it explicitly: `zoo.forward(mesh=)` / `zoo.loss_and_metrics(mesh=)`
-> `transformer.stack_apply(mesh=)` -> `moe.moe_apply_ep(mesh=)`, where the
reference calls `current_abstract_mesh()`.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# the tiled collectives' names: torch 2.13 renamed them (*_single) and
# deprecated the old ones, which the card's torch still has alone
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _client_axis_size(num_clients: int, slots: int) -> int:
    """Size of the 'client' mesh axis given `slots` devices available to it.

    The largest axis that both divides the slot count (the mesh must tile
    the devices) and divides J (every shard holds the same number of WHOLE
    encoders — a lopsided split would leave ragged stacks shard_map cannot
    express): J itself when it divides the slots, a partial-parallel axis
    (several nodes per shard) otherwise, and a replicated axis (size 1,
    with a warning) when no common divisor exists."""
    if num_clients >= 1 and slots % num_clients == 0:
        return num_clients
    client = max((k for k in range(1, min(num_clients, slots) + 1)
                  if slots % k == 0 and num_clients % k == 0), default=1)
    if client == 1 and num_clients > 1:
        warnings.warn(
            f"J={num_clients} clients share no divisor with the {slots} "
            f"available device slots; falling back to a replicated client "
            f"axis (client=1) — node-parallel INL/FL execution is "
            f"disabled, batch/data parallelism still applies.",
            stacklevel=3)
    return client


# ---------------------------------------------------------------------------
# AbstractMesh: the pod meshes, names and sizes only
# ---------------------------------------------------------------------------

class AbstractMesh:
    """Named axes and their sizes, with no ranks behind them
    (`jax.sharding.AbstractMesh(axis_sizes, axis_names)`): `axis_names`,
    `shape` (name -> size, in axis order) and `size`, the chip count."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        axis_sizes, axis_names = tuple(axis_sizes), tuple(axis_names)
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, axis_sizes))
        self.size = 1
        for n in axis_sizes:
            self.size *= n

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16x16 = 256 chips (data, model).
    Multi-pod: 2 pods x 256 = 512 chips (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_inl_mesh(num_clients: int, *, multi_pod: bool = False
                  ) -> AbstractMesh:
    """Mesh for the paper-mode (INL) trainer: a 'client' axis holds the J
    edge nodes; remaining capacity goes to data/model parallelism.
    256 (or 512) chips total, same hardware as make_production_mesh.

    When J does not divide the per-model-group chip count the client axis
    falls back to replicated (size 1, with a warning) instead of erroring —
    the scheme still runs, data-parallel only."""
    model = 16
    total = 512 if multi_pod else 256
    client = _client_axis_size(num_clients, total // model)
    data = total // (client * model)
    return AbstractMesh((client, data, model), ("client", "data", "model"))


# ---------------------------------------------------------------------------
# Axis: one mesh axis as this rank sees it
# ---------------------------------------------------------------------------

def _wire_view(t: torch.Tensor) -> torch.Tensor:
    """uint32 codeword lanes as int32 (same bytes): the collectives have no
    uint32."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


class Axis:
    """A mesh axis: `name`, the process `group` over it, its `size`,
    this rank's `index` on it and the global `ranks` of the group in axis
    order."""

    def __init__(self, name: str, group, ranks: Sequence[int], index: int):
        self.name = name
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.traffic: Dict[str, int] = {"all_gather": 0, "reduce_scatter": 0,
                                        "all_reduce": 0}

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, "
                f"index={self.index})")

    def block(self, n: int) -> slice:
        """This rank's block of an axis of length n split evenly over the
        axis (n divisible by the size)."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    # -- raw transfers (no gradient) ---------------------------------------

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 0 in axis order (a tiled
        all_gather)."""
        src = _wire_view(x.contiguous())
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _ALL_GATHER(out, src, group=self.group)
        self.traffic["all_gather"] += src.nbytes
        return out.view(x.dtype) if x.dtype != src.dtype else out

    def reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of g, split along dim 0: this rank's block
        (the transpose of `gather`)."""
        src = g.contiguous()
        out = torch.empty((src.shape[0] // self.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _REDUCE_SCATTER(out, src, op=dist.ReduceOp.SUM, group=self.group)
        self.traffic["reduce_scatter"] += out.nbytes
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the axis' ranks, as a new tensor."""
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.traffic["all_reduce"] += out.nbytes
        return out

    def all_reduce_tree(self, tensors: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """`all_reduce` of many tensors, one flat buffer a dtype: the
        same sums, elementwise, in fewer calls."""
        return _flat_apply(tensors, self.all_reduce)

    def mean_tree(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the axis' ranks of each tensor (the sum divided by
        the size: exact on an axis of one rank)."""
        return [t / self.size for t in self.all_reduce_tree(tensors)]

    def gather_tree(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """`gather` of many tensors in one call a dtype."""
        out: List[torch.Tensor] = [None] * len(tensors)
        for idx in _by_dtype(tensors).values():
            chunks = [tensors[i].reshape(-1) for i in idx]
            flat = self.gather(torch.cat(chunks)).reshape(self.size, -1)
            at = 0
            for i, c in zip(idx, chunks):
                t = tensors[i]
                part = flat[:, at:at + c.numel()]
                out[i] = part.reshape((self.size * t.shape[0],)
                                      + tuple(t.shape[1:]))
                at += c.numel()
        return out

    # -- differentiable collectives ----------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return _AllGather.apply(x, self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PSum.apply(x, self)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return _PMean.apply(x, self)


def _by_dtype(tensors) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _flat_apply(tensors, fn) -> List[torch.Tensor]:
    """fn over the concatenation of `tensors` (one buffer a dtype), split
    back into their shapes."""
    out: List[torch.Tensor] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        flat = fn(torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, torch.split(
                flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


class _AllGather(torch.autograd.Function):
    """Tiled all_gather; the backward sums the ranks' cotangents and hands
    each its own block (psum_scatter)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x) / axis.size

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g) / ctx.axis.size, None


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

class Mesh:
    """Named axes over the world's ranks.  `shape` maps each axis name to
    its size (in axis order), `axis_names` lists them, `coords` gives this
    rank's index on each, `device` its device, `backend` the process
    group's backend and `rank` its global rank."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "a Mesh spans the ranks of the default process group; call "
                "torch.distributed.init_process_group first")
        shape, axis_names = tuple(shape), tuple(axis_names)
        world, rank = dist.get_world_size(), dist.get_rank()
        size = 1
        for n in shape:
            size *= n
        if size != world:
            raise ValueError(f"mesh shape {shape} holds {size} ranks; the "
                             f"world has {world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.rank = rank
        self.backend = dist.get_backend()
        self.coords = dict(zip(axis_names, _unravel(rank, shape)))
        self.device = _rank_device(device, rank)
        self._axes = {}
        # every rank creates every group, in one order (new_group is
        # collective over the world)
        for a, name in enumerate(axis_names):
            for ranks in _axis_groups(shape, a):
                group = dist.new_group(list(ranks))
                if rank in ranks:
                    self._axes[name] = Axis(name, group, ranks,
                                            ranks.index(rank))

    def axis(self, name: str) -> Axis:
        try:
            return self._axes[name]
        except KeyError:
            raise ValueError(f"mesh has no axis {name!r}; its axes are "
                             f"{self.axis_names}") from None

    def barrier(self) -> None:
        """Wait for every rank of the world."""
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")


def _unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    coords = []
    for n in reversed(shape):
        coords.append(rank % n)
        rank //= n
    return tuple(reversed(coords))


def _axis_groups(shape: Tuple[int, ...], a: int) -> List[Tuple[int, ...]]:
    """The rank groups along axis a: for every coordinate of the other
    axes, the ranks that vary along a, in axis order."""
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    total = strides[0] * shape[0] if shape else 1
    groups = []
    for r in range(total):
        if (r // strides[a]) % shape[a] == 0:
            groups.append(tuple(r + k * strides[a] for k in range(shape[a])))
    return groups


def _rank_device(device, rank: int) -> torch.device:
    """`device`, with None or an unindexed "cuda" meaning this rank's card
    (raises without one)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_inl_host_mesh(num_clients: int, *, device=None) -> Mesh:
    """('client', 'data') mesh over the default process group's ranks, with
    the J nodes on 'client' when J divides the world size, else a
    replicated client axis (warned) and everything on 'data'.  This is the
    mesh `schemes.runner.run_scheme(mesh=)` takes."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_inl_host_mesh spans the ranks of the default process "
            "group; call torch.distributed.init_process_group first")
    n = dist.get_world_size()
    client = _client_axis_size(num_clients, n)
    return Mesh((client, n // client), ("client", "data"), device=device)


def make_host_mesh(*, device=None) -> Mesh:
    """Every rank of the default process group on one 'data' axis."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh spans the ranks of the default process group; "
            "call torch.distributed.init_process_group first")
    return Mesh((dist.get_world_size(),), ("data",), device=device)


def data_axes(mesh) -> tuple:
    """The batch-sharding axes for a mesh (everything that isn't 'model' or
    'client')."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
