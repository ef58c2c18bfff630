"""Causal flash-attention forward: the CUDA kernel's wrapper.

Reference: src/repro/kernels/flash_attention.py.  The Pallas kernel and its
counterpart here, written for Hopper (`csrc/`):

    _attn_kernel -> csrc/flash_attn_fwd.cu   flash_attn_fwd

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

`LAUNCHES` counts kernel launches: each call that launches the kernel adds
one, and nothing else does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import tracing
from repro_torch.kernels import build

LAUNCHES = tracing.launch_counter(("flash_attn_fwd",))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 9 + [_F, _I, _P]
HEAD_DIMS = (32, 64, 80, 128, 192)  # the instances flash_attn_fwd.cu builds


def flash_attn_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0, lse: bool = False):
    """Launch the kernel: q (B, Sq, H, Dh), k and v (B, Sk, KV, Dh), all
    fp32 or all bf16 (16-byte aligned, as allocations are), contiguous on
    one CUDA device; Dh in HEAD_DIMS.
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
                 1.0 / math.sqrt(Dh), int(q.dtype == torch.bfloat16),
                 what=f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} Dh={Dh}")
    LAUNCHES[name] += 1
    return o if lse_out is None else (o, lse_out)
