"""Multi-tensor AdamW: the CUDA kernel's wrapper.

No TPU kernel: the reference's update (`adamw` in src/repro/optim) is jnp,
which XLA fuses.  `csrc/adamw.cu` updates every leaf of an AdamW state in
place: the global norm of the gradients and the clip scale
(`adamw_norm`, two launches, no atomics), then m, v, the fp32 master and
the weights (`adamw_update`, one launch), 28 bytes a parameter plus 2 for
the norm.  The plain versions are `kernels/ref.grad_norm_ref` and
`kernels/ref.adamw_update_ref_`; `kernels/ops.grad_norm` and
`kernels/ops.adamw_` dispatch between the two by the tensors' device.

The kernels read the leaves from three int64 tables on the device:
  chunks   (start, leaf | length << 32) for every CHUNK elements of every
           leaf: one block each; cached by the leaves' sizes
  leaves   m, v, master (0 without one), weight pointers, size and flags;
           cached by those pointers, which an in-place update never moves
  grads    each call's gradient pointers and flags
Each is one copy from pinned memory, queued on the stream.  The leaves
the update writes are refused where one is not contiguous or two share
memory, before the device is checked.
Flags: BF16 (the gradient's or the weight's type; fp32 otherwise), MASTER,
ALIGNED (every pointer of the entry 16-byte aligned: the vector path).

`LAUNCHES` counts the calls: "adamw_norm" (its two kernels) and
"adamw_update", one each an optimizer step whatever the number of leaves.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import build

LAUNCHES = tracing.launch_counter(("adamw_norm", "adamw_update"))

CHUNK = 65536         # elements a block: kChunk in csrc/adamw.cu
BF16, MASTER, ALIGNED = 1, 2, 4
MAX_TABLES = 8        # cached chunk and leaf tables, the newest kept

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NORM_ARGS = [_P, _P, _I, _P, _F, _I, _P, _P, _P]
_UPDATE_ARGS = [_P] * 3 + [_I] + [_P] * 4 + [_F] * 6 + [_I, _P]
_TYPES = (torch.bfloat16, torch.float32)

_chunk_tables: "collections.OrderedDict" = collections.OrderedDict()
_leaf_tables: "collections.OrderedDict" = collections.OrderedDict()
_checked: list = []                  # the library's CHUNK read


def chunk_rows(numels) -> np.ndarray:
    """The chunk table of leaves of `numels` elements: (chunks, 2) int64,
    each row (start, leaf | length << 32), CHUNK elements a chunk and the
    leaf's last one shorter."""
    rows = []
    for leaf, n in enumerate(numels):
        start = np.arange(0, n, CHUNK, dtype=np.int64)
        length = np.minimum(n - start, CHUNK)
        rows.append(np.stack([start, leaf | (length << 32)], axis=1))
    if not rows:
        return np.zeros((0, 2), dtype=np.int64)
    return np.concatenate(rows).astype(np.int64)


def _cached(cache, key, make):
    table = cache.get(key)
    if table is None:
        table = cache[key] = make()
        while len(cache) > MAX_TABLES:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return table


def _on_device(rows, width, device) -> torch.Tensor:
    """int64 `rows` as a (n, width) table on `device`: one copy from pinned
    memory, queued on the stream (a copy from pageable memory would wait
    for the stream's work, the backward, before the launch)."""
    host = torch.from_numpy(np.asarray(rows, dtype=np.int64)
                            .reshape(-1, width)).pin_memory()
    return host.to(device, non_blocking=True)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _same(a, b) -> bool:
    """Whether `a` and `b` are one memory of one type and size."""
    return a.data_ptr() == b.data_ptr() and a.dtype == b.dtype \
        and a.numel() == b.numel()


def _overlap(tensors) -> bool:
    """Whether two of `tensors` (contiguous) share a byte of memory."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tensors if t.numel())
    return any(b[0] < a[1] for a, b in zip(spans, spans[1:]))


def _chunks(numels, device) -> torch.Tensor:
    def make():
        rows = chunk_rows(numels)
        if rows.shape[0] >= 2 ** 31:
            raise ValueError(f"adamw: {rows.shape[0]} chunks, above a "
                             f"grid's 2^31 - 1 blocks")
        return _on_device(rows, 2, device)
    return _cached(_chunk_tables, (device, numels), make)


def _leaves(m, v, master, params) -> torch.Tensor:
    """The leaf table of the tensors the update writes.  Refuses a
    non-contiguous one (every call: the kernel writes numel elements on
    from data_ptr()) and, building the table, two that share memory
    (blocks of one launch would write it in no order) other than an fp32
    weight and its master, wrong types or sizes, then tensors off one CUDA
    device."""
    masters = [None] * len(params) if master is None else list(master)
    if not len(m) == len(v) == len(masters) == len(params):
        raise ValueError(f"adamw_update: {len(m)} m, {len(v)} v, "
                         f"{len(masters)} master and {len(params)} weight "
                         f"leaves")
    written = [t for t in (*m, *v, *masters, *params) if t is not None]
    if not all(t.is_contiguous() for t in written):
        raise ValueError("adamw_update writes its leaves in place from "
                         "their first element: m, v, master and the weights "
                         "must be contiguous")
    device = params[0].device
    key = (device,) + tuple(
        (a.data_ptr(), b.data_ptr(), 0 if c is None else c.data_ptr(),
         p.data_ptr(), p.numel(), p.dtype)
        for a, b, c, p in zip(m, v, masters, params))

    def make():
        rows = []
        for i, (a, b, c, p) in enumerate(zip(m, v, masters, params)):
            fp32 = [a, b] + ([] if c is None else [c])
            if any(t.dtype != torch.float32 for t in fp32) or \
                    p.dtype not in _TYPES:
                raise TypeError(f"adamw_update takes fp32 m, v and master "
                                f"and a bf16 or fp32 weight; leaf {i}: "
                                f"{[t.dtype for t in fp32 + [p]]}")
            if any(t.numel() != p.numel() for t in fp32):
                raise ValueError(f"adamw_update: leaf {i}'s sizes "
                                 f"{[t.numel() for t in fp32 + [p]]}")
            flags = (BF16 if p.dtype == torch.bfloat16 else 0) \
                | (0 if c is None else MASTER) \
                | (ALIGNED if _aligned(*fp32, p) else 0)
            rows.append([a.data_ptr(), b.data_ptr(),
                         0 if c is None else c.data_ptr(), p.data_ptr(),
                         p.numel(), flags])
        # an fp32 weight's master may be the weight itself (`init` keeps
        # one tensor): each element is then written twice by one thread
        spans = [t for a, b, c, p in zip(m, v, masters, params)
                 for t in (a, b, p) + (() if c is None or _same(c, p)
                                       else (c,))]
        if _overlap(spans):
            raise ValueError("adamw_update: two of m, v, master and the "
                             "weights share memory")
        build.check_cuda("adamw_update", written)
        if any(t.device != device for t in written):
            raise ValueError("adamw_update: the leaves lie on different "
                             "devices")
        return _on_device(rows, 6, device)
    return _cached(_leaf_tables, key, make)


def _grads(grads, numels, device) -> torch.Tensor:
    """This call's gradient table."""
    rows = []
    for i, (g, n) in enumerate(zip(grads, numels)):
        if g.dtype not in _TYPES or g.numel() != n or g.device != device:
            raise TypeError(f"adamw takes bf16 or fp32 gradients of the "
                            f"weights' sizes on {device}; leaf {i}: "
                            f"{g.dtype}, {g.numel()} for {n} on {g.device}")
        rows += [g.data_ptr(), (BF16 if g.dtype == torch.bfloat16 else 0)
                 | (ALIGNED if _aligned(g) else 0)]
    return _on_device(rows, 2, device)


def _library(fn, argtypes):
    if not _checked:
        chunk = build.c_function("adamw", "adamw_chunk_elements", [])()
        if chunk != CHUNK:
            raise RuntimeError(f"csrc/adamw.cu cuts chunks of {chunk} "
                               f"elements, the wrapper of {CHUNK}")
        _checked.append(True)
    return build.c_function("adamw", fn, argtypes)


def _contiguous(grads):
    # a gradient's layout is autograd's: a strided one is copied
    return [g if g.is_contiguous() else g.contiguous() for g in grads]


def grad_norm(grads, max_norm):
    """Launch the norm: grads a list of bf16 or fp32 tensors on one CUDA
    device.  Returns (the global norm, the clip scale min(1, max_norm /
    max(norm, 1e-9)), or 1 where max_norm is None or 0), fp32 0-dim tensors
    on that device, on the current stream."""
    name = "adamw_norm"
    grads = _contiguous(grads)
    build.check_cuda(name, grads)
    device = grads[0].device
    numels = tuple(g.numel() for g in grads)
    chunks = _chunks(numels, device)
    table = _grads(grads, numels, device)
    n = chunks.shape[0]
    partials = torch.empty(max(n, 1), dtype=torch.float64, device=device)
    norm = torch.empty((), dtype=torch.float32, device=device)
    scale = torch.empty((), dtype=torch.float32, device=device)
    fn = _library("adamw_norm_launch", _NORM_ARGS)
    build.launch(name, fn, device, table.data_ptr(), chunks.data_ptr(), n,
                 partials.data_ptr(), float(max_norm or 0.0),
                 int(bool(max_norm)), norm.data_ptr(), scale.data_ptr(),
                 what=f"{len(grads)} leaves, {n} chunks")
    LAUNCHES[name] += 1
    return norm, scale


def adamw_update(grads, m, v, master, params, scale, lr, bc1, bc2, *,
                 b1: float, b2: float, eps: float, weight_decay: float):
    """Launch the update in place: grads and params bf16 or fp32, m, v and
    master (a list, or None) fp32, leaf by leaf of one size, all contiguous
    on one CUDA device; scale, lr, bc1, bc2 fp32 0-dim tensors there.  On
    the current stream."""
    name = "adamw_update"
    leaves = _leaves(m, v, master, params)
    grads = _contiguous(grads)
    build.check_cuda(name, grads)
    device = params[0].device
    scalars = (scale, lr, bc1, bc2)
    if any(s.dtype != torch.float32 or s.numel() != 1 or s.device != device
           for s in scalars):
        raise TypeError(f"{name} takes fp32 scalars on {device} for scale, "
                        f"lr, bc1, bc2; got "
                        f"{[(s.dtype, tuple(s.shape), str(s.device)) for s in scalars]}")
    numels = tuple(p.numel() for p in params)
    chunks = _chunks(numels, device)
    table = _grads(grads, numels, device)
    n = chunks.shape[0]
    fn = _library("adamw_update_launch", _UPDATE_ARGS)
    build.launch(name, fn, device, leaves.data_ptr(), table.data_ptr(),
                 chunks.data_ptr(), n, *(s.data_ptr() for s in scalars),
                 b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
                 int(bool(weight_decay)),
                 what=f"{len(params)} leaves, {n} chunks")
    LAUNCHES[name] += 1
