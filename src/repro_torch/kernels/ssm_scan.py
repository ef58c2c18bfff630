"""Chunked Mamba2 / SSD scan: the CUDA kernel's wrapper.

Reference: src/repro/kernels/ssm_scan.py.  The Pallas kernel and its
counterpart here, written for Hopper (`csrc/`):

    _ssd_kernel -> csrc/ssd_scan.cu   ssd_scan

bf16 runs on tensor cores as the SSD decomposition, chunk-parallel: C.B^T
once per (b, chunk), each chunk's own state, the state passed over the
chunks, then the output per 64-row tile and pair of heads, four launches
on the current stream with scratch allocated here; fp32 runs the first,
SIMT kernel, one block per (b, h) walking the chunks in order with the
(N, P) state on chip.  Dispatch is by dtype, never by failure.  Unlike the
Pallas kernel both return the final state, which the model's prefill keeps
in its cache (`_ssd_chunked` in src/repro/models/ssm.py returns it).  The
plain version is `kernels/ref.ssd_chunked_ref`; `kernels/ops.ssd_scan`
dispatches between the two by the tensors' device.

`LAUNCHES` counts kernel launches: each call that launches the kernel adds
one (the bf16 path's four stages are one call), and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = {"ssd_scan": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 7 + [_P, _P]
MAX_DIM = 64          # state_dim N and head_dim P
MAX_CHUNK = 8192


def ssd_scan(x, dt, a, bm, cm, dskip, *, chunk: int):
    """Launch the kernel: x (B, S, H, P) and bm, cm (B, S, N) all fp32 or
    all bf16; dt (B, S, H) post-softplus, a (H,) and dskip (H,) fp32; all
    contiguous on one CUDA device; N, P <= 64.  chunk = min(chunk, S) must
    divide S.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) fp32), on the current stream."""
    name = "ssd_scan"
    build.check_cuda(name, (x, dt, a, bm, cm, dskip))
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise TypeError(f"{name} takes x, bm, cm all fp32 or all bf16; got "
                        f"{x.dtype}, {bm.dtype}, {cm.dtype}")
    for what, t in (("dt", dt), ("a", a), ("dskip", dskip)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes fp32 {what}; got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} takes x (B, S, H, P); got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = bm.shape[-1]
    if dt.shape != (B, S, H) or a.shape != (H,) or dskip.shape != (H,) \
            or bm.shape != (B, S, N) or cm.shape != (B, S, N):
        raise ValueError(f"{name} takes x (B, S, H, P), dt (B, S, H), a and "
                         f"dskip (H,), bm and cm (B, S, N); got "
                         f"{[tuple(t.shape) for t in (x, dt, a, bm, cm, dskip)]}")
    if not (1 <= N <= MAX_DIM and 1 <= P <= MAX_DIM):
        raise ValueError(f"{name} takes N, P <= {MAX_DIM}; got N={N}, P={P}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk or chunk > MAX_CHUNK:
        raise ValueError(f"seq {S} not divisible by chunk {chunk} (or the "
                         f"chunk is above {MAX_CHUNK})")
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    nbytes = build.c_function(name, "ssd_scan_workspace_bytes", [_I] * 7,
                              restype=ctypes.c_longlong)(
        B, S, H, P, N, chunk, is_bf16)
    # freed on return: the caching allocator hands it out again only behind
    # the work already queued on this stream
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = build.c_function(name, "ssd_scan_launch", _ARGTYPES)
    build.launch(name, fn, x.device, x.data_ptr(), dt.data_ptr(),
                 a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                 dskip.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H,
                 P, N, chunk, is_bf16, workspace.data_ptr() or None,
                 what=f"B={B} S={S} H={H} P={P} N={N} chunk={chunk}")
    LAUNCHES[name] += 1
    return y, state
