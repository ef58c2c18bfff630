"""Causal flash attention, forward and backward: the CUDA kernels' wrappers.

Reference: src/repro/kernels/flash_attention.py.  The Pallas kernel and its
counterpart here, written for Hopper (`csrc/`):

    _attn_kernel -> csrc/flash_attn_fwd.cu   flash_attn_fwd

and the backward, which the reference computes in jnp (`_flash_bwd` in
src/repro/models/attention.py) and the card needs as a kernel:

    (none)       -> csrc/flash_attn_bwd.cu   flash_attn_bwd

q (B, Sq, H, Dh) and k, v (B, Sk, KV, Dh), H % KV == 0, are read in that
layout: the kernel takes the kv head h // (H / KV) by index and masks a
ragged last tile, so nothing is transposed, repeated or padded (the Pallas
wrapper's transposes and its `Sq % block_q == 0` exist for BlockSpecs).
bf16 runs on tensor cores (FlashAttention-2 on `mma.sync`, P fed to P.V as
bf16 hi + lo); fp32 runs the first, SIMT kernel, whose fp32 products the
fp32 parity checks need.  Dispatch is by dtype, never by failure.  The plain
version is `kernels/ref.attention_ref`; `kernels/ops.attention`
dispatches between the two by the tensors' device.

With `lse=True` the same launch also writes each query row's logsumexp
(fp32 (B, Sq, H), natural-log units of the scaled scores), which the
reference's custom VJP saves for its backward (`models/attention.py`'s
`blockwise_attention` reads it); o is the same bit for bit either way.

`flash_attn_bwd` computes (dq, dk, dv) from the forward's saved (q, k, v,
o, lse) and the output's gradient, in the same layout and under the same
mask, deterministically (no atomics: dq by query tile, dk and dv by key
tile with GQA's group summed in registers, the group split where the grid
would underfill the card and the splits added in order).  bf16 on tensor
cores with P and dS fed as bf16 hi + lo, fp32 on SIMT kernels.  Its plain
version is `kernels/ref.flash_bwd_ref`; `kernels/ops.attention_bwd`
dispatches between the two.

`LAUNCHES` counts kernel launches: each call that launches a kernel adds
one under its name (a backward's three launches are one call), and nothing
else does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import tracing
from repro_torch.kernels import build

LAUNCHES = tracing.launch_counter(("flash_attn_fwd", "flash_attn_bwd"))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 9 + [_F, _I, _P]
_BWD_ARGTYPES = [_P] * 12 + [_I] * 10 + [_F, _I, _P]
HEAD_DIMS = (32, 64, 80, 128, 192, 224)  # the instances both sources build
BWD_KEY_TILE = 64          # keys a block of the dk, dv launch (kTile)
# the dk, dv launch splits a kv head's group of query heads until its grid
# has this many blocks: about four waves of the ~264 that fit the card
BWD_TARGET_BLOCKS = 1024


def _scale(Dh: int, scale) -> float:
    """The softmax scale of the scores: `scale`, None meaning 1/sqrt(Dh)."""
    return 1.0 / math.sqrt(Dh) if scale is None else float(scale)


def flash_attn_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0, lse: bool = False, scale=None):
    """Launch the kernel: q (B, Sq, H, Dh), k and v (B, Sk, KV, Dh), all
    fp32 or all bf16 (16-byte aligned, as allocations are), contiguous on
    one CUDA device; Dh in HEAD_DIMS; scores scale q.k (None: 1/sqrt(Dh)).
    Returns o (B, Sq, H, Dh) in q's dtype, on the current stream, or with
    lse=True (o, lse (B, Sq, H) fp32) from the same launch."""
    name = "flash_attn_fwd"
    build.check_cuda(name, (q, k, v))
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes q, k, v all fp32 or all bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"{name} takes q (B, Sq, H, Dh) and k, v "
                         f"(B, Sk, KV, Dh) with H % KV == 0; got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name} takes a head dim in {HEAD_DIMS}; got {Dh}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"{name} takes q_offset >= 0 and window >= 0; got "
                         f"{q_offset}, {window}")
    if q.dtype == torch.bfloat16 and \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} takes 16-byte aligned bf16 tensors (its "
                         f"copies are 16 bytes); clone an offset view")
    o = torch.empty_like(q)
    lse_out = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
               if lse else None)
    fn = build.c_function(name, "flash_attn_fwd_launch", _ARGTYPES)
    build.launch(name, fn, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(),
                 None if lse_out is None else lse_out.data_ptr(),
                 B, Sq, Sk, H, KV, Dh,
                 int(causal), int(window), int(q_offset),
                 _scale(Dh, scale), int(q.dtype == torch.bfloat16),
                 what=f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} Dh={Dh}")
    LAUNCHES[name] += 1
    return o if lse_out is None else (o, lse_out)


def bwd_splits(B: int, Sk: int, KV: int, group: int) -> int:
    """How many parts the dk, dv launch splits each kv head's `group` query
    heads into: the least divisor of `group` whose grid of (b, kv head,
    part, key tile) blocks reaches BWD_TARGET_BLOCKS, else `group`.  The
    shapes alone decide it, so the order of the sums is the same on every
    run and card."""
    tiles = B * KV * -(-Sk // BWD_KEY_TILE)
    for parts in range(1, group + 1):
        if group % parts == 0 and tiles * parts >= BWD_TARGET_BLOCKS:
            return parts
    return group


def _check_bwd(name, q, k, v, out, lse, dout):
    """The backward's refusals that need no card, so that they come first:
    dtypes, shapes, the head dim, bf16 alignment."""
    ts = (q, k, v, out, dout)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != q.dtype for t in ts) or lse.dtype != torch.float32:
        raise TypeError(f"{name} takes q, k, v, out, dout all fp32 or all "
                        f"bf16 and lse fp32; got "
                        f"{[str(t.dtype) for t in (*ts, lse)]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] or out.shape != q.shape \
            or dout.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"{name} takes q, out, dout (B, Sq, H, Dh), k, v "
                         f"(B, Sk, KV, Dh) with H % KV == 0 and lse (B, Sq, "
                         f"H); got {[tuple(t.shape) for t in (*ts, lse)]}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{name} takes a head dim in {HEAD_DIMS}; got "
                         f"{q.shape[3]}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} takes 16-byte aligned bf16 tensors (its "
                         f"copies are 16 bytes); clone an offset view")


def flash_attn_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                   window: int = 0, q_offset: int = 0, scale=None):
    """Launch the backward: q, out (the forward's o) and dout (B, Sq, H,
    Dh), k and v (B, Sk, KV, Dh), all fp32 or all bf16 (16-byte aligned),
    lse (B, Sq, H) fp32 the forward's logsumexp, contiguous on one CUDA
    device; Dh in HEAD_DIMS; the mask and the scale as the forward's.
    Returns (dq, dk, dv) in the inputs' dtype, on the current stream."""
    name = "flash_attn_bwd"
    _check_bwd(name, q, k, v, out, lse, dout)
    build.check_cuda(name, (q, k, v, out, lse, dout))
    if q_offset < 0 or window < 0:
        raise ValueError(f"{name} takes q_offset >= 0 and window >= 0; got "
                         f"{q_offset}, {window}")
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    splits = bwd_splits(B, Sk, KV, H // KV)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    part = torch.empty((2, splits) + tuple(k.shape), dtype=torch.float32,
                       device=q.device)
    fn = build.c_function(name, "flash_attn_bwd_launch", _BWD_ARGTYPES)
    build.launch(name, fn, q.device, *(t.data_ptr() for t in (
                     q, k, v, out, lse, dout, dq, dk, dv, delta, part[0],
                     part[1])),
                 B, Sq, Sk, H, KV, Dh, int(causal), int(window),
                 int(q_offset), splits, _scale(Dh, scale),
                 int(q.dtype == torch.bfloat16),
                 what=f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} Dh={Dh} "
                      f"splits={splits}")
    LAUNCHES[name] += 1
    return dq, dk, dv
