"""Fused cut-layer forward: the CUDA kernel's wrapper.

Reference: src/repro/kernels/inl_bottleneck.py, `cutlayer_fused` (the
forward: `_cutlayer_call` folding the leading axes into rows, the Pallas
kernel `_cut_fwd_kernel`).  Here the kernel is `csrc/cut_fwd.cu`, written
for Hopper: one warp per row, so ragged row counts need no padding to a
block size.

    u    = Q_b(mu + exp(logvar/2) * eps)   (..., d) in mu.dtype
    rate = the per-row rate of the mode    (...,)   fp32

Dispatch is by the device of the tensors: CPU tensors take the plain
version (kernels/ref.py), CUDA tensors the kernel, which raises if it cannot
build or launch.  There is no fallback from one to the other.  Forward
only: the backward kernel (`_cut_bwd_kernel`) comes with training, so a
call that would need a gradient raises.

`LAUNCHES` counts kernel launches by kernel name: each launch adds one, and
nothing else does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

MODES = ("sample", "analytic", "none")
_MODE_ID = {"sample": 0, "analytic": 1, "none": 2}
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"cut_fwd": 0}


def _launcher():
    fn = build.load("cut_fwd").cut_fwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i,
                       ctypes.c_float, i, i, p]
        fn.restype = i
    return fn


def cut_fwd(mu, logvar, eps, *, bits: int, mode: str):
    """Launch the CUDA kernel on (R, d) rows: mu/logvar fp32 or bf16 (the
    same type), eps fp32, all contiguous on one CUDA device.  Returns
    (u (R, d) in mu.dtype, rate (R,) fp32), on the current stream."""
    if mode not in _MODE_ID:
        raise ValueError(f"unknown rate_estimator {mode!r}")
    tensors = (mu, logvar, eps)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("cut_fwd takes CUDA tensors; got devices "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("cut_fwd inputs lie on different devices")
    if mu.dtype not in _KERNEL_DTYPES or logvar.dtype != mu.dtype:
        raise TypeError(f"cut_fwd takes mu and logvar both fp32 or both "
                        f"bf16; got {mu.dtype}, {logvar.dtype}")
    if eps.dtype != torch.float32:
        raise TypeError(f"cut_fwd takes fp32 eps; got {eps.dtype}")
    if mu.dim() != 2 or logvar.shape != mu.shape or eps.shape != mu.shape:
        raise ValueError(f"cut_fwd takes three equal (R, d) shapes; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cut_fwd takes contiguous tensors")
    if bits < 1:
        raise ValueError(f"link_bits must be >= 1, got {bits}")
    R, d = mu.shape
    u = torch.empty_like(mu)
    rate = torch.empty((R,), dtype=torch.float32, device=mu.device)
    if R == 0 or d == 0:
        return u, rate.zero_()
    launch = _launcher()
    with torch.cuda.device(mu.device):
        stream = torch.cuda.current_stream(mu.device).cuda_stream
        rc = launch(
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), u.data_ptr(),
            rate.data_ptr(), R, d, int(bits), ref.QUANT_RANGE, _MODE_ID[mode],
            int(mu.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"cut_fwd launch failed with CUDA error {rc} "
                           f"(R={R}, d={d}, bits={bits}, mode={mode})")
    LAUNCHES["cut_fwd"] += 1
    return u, rate


def cutlayer_fused(mu, logvar, eps, *, link_bits: int = 32,
                   rate_estimator: str = "analytic"):
    """One fused pass over the cut layer, all J nodes in one launch.

    mu/logvar/eps: (..., d); every leading axis (J clients, batch) folds
    into the row count.  Returns (u (..., d) in mu.dtype, rate (...,)
    fp32).  link_bits >= 32 disables the quantizer."""
    if rate_estimator not in MODES:
        raise ValueError(f"unknown rate_estimator {rate_estimator!r}")
    if torch.is_grad_enabled() and (mu.requires_grad or logvar.requires_grad
                                    or eps.requires_grad):
        raise NotImplementedError(
            "the cut-layer backward kernel is not ported yet (it comes with "
            "the training slice); call under torch.no_grad()")
    shape = mu.shape
    d = shape[-1]
    R = math.prod(shape[:-1])
    mu2, lv2, eps2 = (t.reshape(R, d) for t in (mu, logvar, eps))
    devices = {t.device.type for t in (mu, logvar, eps)}
    if devices == {"cpu"}:
        u, rate = ref.cutlayer_fwd_ref(mu2, lv2, eps2, link_bits,
                                       rate_estimator)
    elif devices == {"cuda"}:
        u, rate = cut_fwd(mu2.contiguous(), lv2.contiguous(),
                          eps2.contiguous(), bits=link_bits,
                          mode=rate_estimator)
    else:
        raise ValueError(f"cutlayer_fused runs on CPU or CUDA tensors, all "
                         f"on one device; got {sorted(devices)}")
    return u.reshape(shape), rate.reshape(shape[:-1])
