"""Fused cut layer: the CUDA kernels' wrappers and the autograd Functions.

Reference: src/repro/kernels/inl_bottleneck.py.  The Pallas kernels and
their counterparts here, written for Hopper (`csrc/`):

    _cut_fwd_kernel        -> csrc/cut_fwd.cu        cut_fwd
    _cut_bwd_kernel        -> csrc/cut_bwd.cu        cut_bwd
    _cut_prior_fwd_kernel  -> csrc/cut_prior_fwd.cu  cut_prior_fwd
    _cut_prior_bwd_kernel  -> csrc/cut_prior_bwd.cu  cut_prior_bwd
    _cut_fwd_pack_kernel   -> csrc/cut_fwd_pack.cu   cut_fwd_pack
    _pack_kernel           -> csrc/pack.cu           pack
    _unpack_dequant_kernel -> csrc/unpack_dequant.cu unpack

No kernel pads ragged row counts to a block size: most take one warp per
row; `pack` and `unpack` take one thread per lane word, and
`cut_prior_bwd` spreads each node's rows over a fixed number of blocks.

    u    = Q_b(mu + exp(logvar/2) * eps)   (..., d) in mu.dtype
    rate = the per-row rate of the mode    (...,)   fp32

`cutlayer_fused` folds the leading axes into rows and runs one of two
`torch.autograd.Function`s, the counterparts of the reference's custom
VJPs: `_CutLayer` saves (mu, logvar, eps) and its backward is the eq.-(10)
split (`cut_bwd`); `_CutLayerPrior` (a learned prior, (d,) shared or (J, d)
per node) also saves u and its backward yields the prior gradients too
(`cut_prior_bwd`).  Autograd never differentiates a kernel body.

Dispatch is by the device of the tensors: CPU tensors take the plain
versions (kernels/ref.py), CUDA tensors the kernels, which raise if they
cannot build or launch.  There is no fallback from one to the other.

The packed wire's entries — `cutlayer_pack_forward` (u, the codeword lanes
and the rate from one read), `pack_values` and `unpack_dequant` — have no
gradient rule, as in the reference: core/wirefmt.py owns the autograd
Functions around them, whose backward is `cutlayer_backward`.  Lanes are
torch.uint32, 32 // b codewords each (kernels/ref.py).

`LAUNCHES` counts kernel launches by kernel name: each call of a wrapper
that launches its kernel adds one, and nothing else does.  Each wrapper
makes one launch; `cut_prior_bwd` sums its per-block partials inside that
launch, in the last block of each node to finish.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

MODES = ("sample", "analytic", "none")
PRIOR_MODES = ("sample", "analytic")
_MODE_ID = {"sample": 0, "analytic": 1, "none": 2}
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"cut_fwd": 0, "cut_bwd": 0, "cut_prior_fwd": 0,
            "cut_prior_bwd": 0, "cut_fwd_pack": 0, "pack": 0,
            "unpack_dequant": 0}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# (source, C function) -> (argtypes, restype)
_SIGNATURES = {
    ("cut_fwd", "cut_fwd_launch"): ([_P] * 5 + [_L, _I, _I, _F, _I, _I, _P],
                                    _I),
    ("cut_bwd", "cut_bwd_launch"): ([_P] * 8 + [_L, _I, _I, _F, _I, _I, _P],
                                    _I),
    ("cut_prior_fwd", "cut_prior_fwd_launch"): (
        [_P] * 7 + [_I, _L, _I, _I, _F, _I, _I, _P], _I),
    ("cut_prior_bwd", "cut_prior_bwd_launch"): (
        [_P] * 15 + [_I, _I, _L, _I, _I, _I, _P], _I),
    ("cut_fwd_pack", "cut_fwd_pack_launch"): (
        [_P] * 6 + [_L, _I, _I, _F, _I, _I, _P], _I),
    ("pack", "pack_launch"): ([_P, _P, _L, _I, _I, _F, _I, _P], _I),
    ("unpack_dequant", "unpack_dequant_launch"): (
        [_P, _P, _L, _I, _I, _F, _I, _P], _I),
}


def _c_function(source: str, name: str):
    return build.c_function(source, name, *_SIGNATURES[(source, name)])


def _check_latent_dtypes(name: str, mu, *same) -> None:
    if mu.dtype not in _KERNEL_DTYPES or any(t.dtype != mu.dtype
                                             for t in same):
        raise TypeError(f"{name} takes mu, logvar (and u, gu) all fp32 or "
                        f"all bf16; got {mu.dtype}, "
                        f"{[t.dtype for t in same]}")


def _check_fp32(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes fp32 {what}; got {t.dtype}")


def _check_mode(mode: str, allowed=MODES) -> None:
    if mode not in allowed:
        raise ValueError(f"unknown rate_estimator {mode!r} (this kernel "
                         f"takes {allowed})")


def _launch(name: str, fn, device, *args, what: str) -> None:
    build.launch(name, fn, device, *args, what=what)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Kernel wrappers: CUDA tensors only
# ---------------------------------------------------------------------------

def cut_fwd(mu, logvar, eps, *, bits: int, mode: str):
    """Launch the forward kernel on (R, d) rows: mu/logvar fp32 or bf16 (the
    same type), eps fp32, all contiguous on one CUDA device.  Returns
    (u (R, d) in mu.dtype, rate (R,) fp32), on the current stream."""
    _check_mode(mode)
    tensors = (mu, logvar, eps)
    build.check_cuda("cut_fwd", tensors)
    _check_latent_dtypes("cut_fwd", mu, logvar)
    _check_fp32("cut_fwd", eps=eps)
    if mu.dim() != 2 or logvar.shape != mu.shape or eps.shape != mu.shape:
        raise ValueError(f"cut_fwd takes three equal (R, d) shapes; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if bits < 1:
        raise ValueError(f"link_bits must be >= 1, got {bits}")
    R, d = mu.shape
    u = torch.empty_like(mu)
    rate = torch.empty((R,), dtype=torch.float32, device=mu.device)
    if R == 0 or d == 0:
        return u, rate.zero_()
    _launch("cut_fwd", _c_function("cut_fwd", "cut_fwd_launch"), mu.device,
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), u.data_ptr(),
            rate.data_ptr(), R, d, int(bits), ref.QUANT_RANGE, _MODE_ID[mode],
            int(mu.dtype == torch.bfloat16),
            what=f"R={R}, d={d}, bits={bits}, mode={mode}")
    return u, rate


def cut_bwd(mu, logvar, eps, gu, grate, *, bits: int, mode: str):
    """Launch the eq.-(10) backward kernel on (R, d) rows: mu/logvar/gu fp32
    or bf16 (one type), eps fp32, grate (R,) fp32 (not read in the "none"
    mode).  Returns (dmu, dlv, deps) in the dtypes of (mu, logvar, eps)."""
    _check_mode(mode)
    tensors = (mu, logvar, eps, gu, grate)
    build.check_cuda("cut_bwd", tensors)
    _check_latent_dtypes("cut_bwd", mu, logvar, gu)
    _check_fp32("cut_bwd", eps=eps, grate=grate)
    if (mu.dim() != 2 or any(t.shape != mu.shape for t in (logvar, eps, gu))
            or grate.shape != mu.shape[:1]):
        raise ValueError(f"cut_bwd takes four equal (R, d) shapes and an "
                         f"(R,) grate; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if bits < 1:
        raise ValueError(f"link_bits must be >= 1, got {bits}")
    R, d = mu.shape
    dmu, dlv = torch.empty_like(mu), torch.empty_like(logvar)
    deps = torch.empty_like(eps)
    if R == 0 or d == 0:
        return dmu, dlv, deps
    _launch("cut_bwd", _c_function("cut_bwd", "cut_bwd_launch"), mu.device,
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), gu.data_ptr(),
            grate.data_ptr(), dmu.data_ptr(), dlv.data_ptr(),
            deps.data_ptr(), R, d, int(bits), ref.QUANT_RANGE,
            _MODE_ID[mode], int(mu.dtype == torch.bfloat16),
            what=f"R={R}, d={d}, bits={bits}, mode={mode}")
    return dmu, dlv, deps


def _check_prior_rows(name, mu, pmu, plv) -> None:
    if mu.dim() != 3 or pmu.dim() != 2 or plv.shape != pmu.shape \
            or pmu.shape != (mu.shape[0], mu.shape[2]):
        raise ValueError(f"{name} takes (J, T, d) rows and (J, d) priors; "
                         f"got {tuple(mu.shape)}, {tuple(pmu.shape)}, "
                         f"{tuple(plv.shape)}")


def cut_prior_fwd(mu, logvar, eps, pmu, plv, *, bits: int, mode: str):
    """Launch the learned-prior forward kernel on (J, T, d) rows with (J, d)
    fp32 priors; mode "sample" or "analytic".  Returns (u (J, T, d) in
    mu.dtype, rate (J, T) fp32)."""
    _check_mode(mode, PRIOR_MODES)
    tensors = (mu, logvar, eps, pmu, plv)
    build.check_cuda("cut_prior_fwd", tensors)
    _check_latent_dtypes("cut_prior_fwd", mu, logvar)
    _check_fp32("cut_prior_fwd", eps=eps, prior_mu=pmu, prior_logvar=plv)
    _check_prior_rows("cut_prior_fwd", mu, pmu, plv)
    if logvar.shape != mu.shape or eps.shape != mu.shape:
        raise ValueError("cut_prior_fwd takes three equal (J, T, d) shapes")
    if bits < 1:
        raise ValueError(f"link_bits must be >= 1, got {bits}")
    J, T, d = mu.shape
    u = torch.empty_like(mu)
    rate = torch.empty((J, T), dtype=torch.float32, device=mu.device)
    if J * T == 0 or d == 0:
        return u, rate.zero_()
    _launch("cut_prior_fwd",
            _c_function("cut_prior_fwd", "cut_prior_fwd_launch"), mu.device,
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), pmu.data_ptr(),
            plv.data_ptr(), u.data_ptr(), rate.data_ptr(), J, T, d,
            int(bits), ref.QUANT_RANGE, _MODE_ID[mode],
            int(mu.dtype == torch.bfloat16),
            what=f"J={J}, T={T}, d={d}, bits={bits}, mode={mode}")
    return u, rate


# cut_prior_bwd's hand-off counters, one per (node, column tile): zero
# between launches (the last block of a node resets its own).  One set per
# (device, stream, count), so launches on two streams never share one, and
# none is freed while a captured CUDA graph may still point at it.
_PRIOR_BWD_TICKETS = {}


def _prior_bwd_tickets(device, n: int):
    key = (device, torch.cuda.current_stream(device).cuda_stream, n)
    tickets = _PRIOR_BWD_TICKETS.get(key)
    if tickets is None:
        tickets = torch.zeros((n,), dtype=torch.int32, device=device)
        _PRIOR_BWD_TICKETS[key] = tickets
    return tickets


def cut_prior_bwd(mu, logvar, eps, pmu, plv, u, gu, grate, *, mode: str):
    """Launch the learned-prior backward on (J, T, d) rows, (J, d) fp32
    priors, the saved forward output u, its cotangent gu (both in mu's
    dtype) and grate (J, T) fp32.  Returns (dmu, dlv, deps, dpmu, dplv),
    the prior gradients (J, d) fp32, each node's sum over its T rows in a
    fixed order (ref.cutlayer_prior_bwd_sums_ordered): two launches, or two
    replays of a captured CUDA graph, give the same bits."""
    _check_mode(mode, PRIOR_MODES)
    tensors = (mu, logvar, eps, pmu, plv, u, gu, grate)
    build.check_cuda("cut_prior_bwd", tensors)
    _check_latent_dtypes("cut_prior_bwd", mu, logvar, u, gu)
    _check_fp32("cut_prior_bwd", eps=eps, prior_mu=pmu, prior_logvar=plv,
                grate=grate)
    _check_prior_rows("cut_prior_bwd", mu, pmu, plv)
    if any(t.shape != mu.shape for t in (logvar, eps, u, gu)) \
            or grate.shape != mu.shape[:2]:
        raise ValueError("cut_prior_bwd takes five equal (J, T, d) shapes "
                         "and a (J, T) grate")
    J, T, d = mu.shape
    dmu, dlv = torch.empty_like(mu), torch.empty_like(logvar)
    deps = torch.empty_like(eps)
    dpmu, dplv = torch.empty_like(pmu), torch.empty_like(plv)
    if J * T == 0 or d == 0:
        return dmu, dlv, deps, dpmu.zero_(), dplv.zero_()
    nb = ref.prior_bwd_blocks(J, T, d)
    # per (node, block): 4 partial sums of d columns
    partial = torch.empty((J * nb * 4 * d,), dtype=torch.float32,
                          device=mu.device)
    tickets = _prior_bwd_tickets(mu.device, J * -(-d // ref.PRIOR_BWD_TILE))
    _launch("cut_prior_bwd",
            _c_function("cut_prior_bwd", "cut_prior_bwd_launch"), mu.device,
            *(t.data_ptr() for t in (mu, logvar, eps, pmu, plv, u, gu, grate,
                                     dmu, dlv, deps, dpmu, dplv, partial,
                                     tickets)),
            nb, J, T, d, _MODE_ID[mode],
            int(mu.dtype == torch.bfloat16),
            what=f"J={J}, T={T}, d={d}, mode={mode}")
    return dmu, dlv, deps, dpmu, dplv


def cut_fwd_pack(mu, logvar, eps, *, bits: int, mode: str):
    """Launch the pack-emitting forward kernel on (R, d) rows (as `cut_fwd`,
    at a packable 1 <= bits <= 16).  Returns (u (R, d) in mu.dtype, lanes
    (R, W) uint32, rate (R,) fp32); (u, rate) equal `cut_fwd`'s bit for
    bit."""
    _check_mode(mode)
    tensors = (mu, logvar, eps)
    build.check_cuda("cut_fwd_pack", tensors)
    _check_latent_dtypes("cut_fwd_pack", mu, logvar)
    _check_fp32("cut_fwd_pack", eps=eps)
    if mu.dim() != 2 or logvar.shape != mu.shape or eps.shape != mu.shape:
        raise ValueError(f"cut_fwd_pack takes three equal (R, d) shapes; "
                         f"got {[tuple(t.shape) for t in tensors]}")
    R, d = mu.shape
    # packed_width refuses a width outside 1..16
    lanes = torch.empty((R, ref.packed_width(d, bits)), dtype=torch.uint32,
                        device=mu.device)
    u = torch.empty_like(mu)
    rate = torch.empty((R,), dtype=torch.float32, device=mu.device)
    if R == 0 or d == 0:
        return u, lanes, rate.zero_()
    _launch("cut_fwd_pack", _c_function("cut_fwd_pack",
                                        "cut_fwd_pack_launch"), mu.device,
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), u.data_ptr(),
            lanes.data_ptr(), rate.data_ptr(), R, d, int(bits),
            ref.QUANT_RANGE, _MODE_ID[mode], int(mu.dtype == torch.bfloat16),
            what=f"R={R}, d={d}, bits={bits}, mode={mode}")
    return u, lanes, rate


def pack(u, *, bits: int):
    """Launch the pack kernel: (R, d) fp32 or bf16 values -> (R, W) uint32
    codeword lanes at 1 <= bits <= 16."""
    build.check_cuda("pack", (u,))
    if u.dtype not in _KERNEL_DTYPES or u.dim() != 2:
        raise TypeError(f"pack takes (R, d) fp32 or bf16 values; got "
                        f"{u.dtype} {tuple(u.shape)}")
    R, d = u.shape
    lanes = torch.empty((R, ref.packed_width(d, bits)), dtype=torch.uint32,
                        device=u.device)
    if R == 0 or d == 0:
        return lanes
    _launch("pack", _c_function("pack", "pack_launch"), u.device,
            u.data_ptr(), lanes.data_ptr(), R, d, int(bits), ref.QUANT_RANGE,
            int(u.dtype == torch.bfloat16),
            what=f"R={R}, d={d}, bits={bits}")
    return lanes


def unpack(lanes, *, d: int, bits: int, dtype=torch.float32):
    """Launch the unpack-dequantize kernel: (R, W) uint32 lanes -> (R, d)
    quantized values in `dtype` (fp32 or bf16)."""
    build.check_cuda("unpack_dequant", (lanes,))
    W = ref.packed_width(d, bits)
    if lanes.dtype != torch.uint32 or lanes.dim() != 2 or lanes.shape[1] != W:
        raise ValueError(f"unpack_dequant takes (R, {W}) uint32 lanes for "
                         f"d={d} at {bits} bits; got {lanes.dtype} "
                         f"{tuple(lanes.shape)}")
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"unpack_dequant writes fp32 or bf16, not {dtype}")
    R = lanes.shape[0]
    out = torch.empty((R, d), dtype=dtype, device=lanes.device)
    if R == 0 or d == 0:
        return out
    _launch("unpack_dequant",
            _c_function("unpack_dequant", "unpack_dequant_launch"),
            lanes.device, lanes.data_ptr(), out.data_ptr(), R, d, int(bits),
            ref.QUANT_RANGE, int(dtype == torch.bfloat16),
            what=f"R={R}, d={d}, bits={bits}")
    return out


# ---------------------------------------------------------------------------
# Autograd Functions (the reference's custom VJPs) and the public entries
# ---------------------------------------------------------------------------

class _CutLayer(torch.autograd.Function):
    """(R, d) rows -> (u, rate); backward: the eq.-(10) split."""

    @staticmethod
    def forward(ctx, mu, logvar, eps, bits, mode):
        ctx.bits, ctx.mode = bits, mode
        ctx.save_for_backward(mu, logvar, eps)
        if mu.device.type == "cpu":
            return ref.cutlayer_fwd_ref(mu, logvar, eps, bits, mode)
        return cut_fwd(mu, logvar, eps, bits=bits, mode=mode)

    @staticmethod
    def backward(ctx, gu, grate):
        mu, logvar, eps = ctx.saved_tensors
        grads = cutlayer_backward(mu, logvar, eps, gu, grate,
                                  link_bits=ctx.bits,
                                  rate_estimator=ctx.mode)
        return (*grads, None, None)


class _CutLayerPrior(torch.autograd.Function):
    """(J, T, d) rows and (J, d) fp32 priors -> (u, rate); saves u as a
    residual, as the reference's `_cutlayer_prior_fwd` does."""

    @staticmethod
    def forward(ctx, mu, logvar, eps, pmu, plv, bits, mode):
        ctx.mode = mode
        if mu.device.type == "cpu":
            u, rate = ref.cutlayer_prior_fwd_ref(mu, logvar, eps, pmu, plv,
                                                 bits, mode)
        else:
            u, rate = cut_prior_fwd(mu, logvar, eps, pmu, plv, bits=bits,
                                    mode=mode)
        ctx.save_for_backward(mu, logvar, eps, pmu, plv, u)
        return u, rate

    @staticmethod
    def backward(ctx, gu, grate):
        mu, logvar, eps, pmu, plv, u = ctx.saved_tensors
        gu, grate = gu.contiguous(), grate.contiguous()
        if mu.device.type == "cpu":
            # bits: the plain backward reads the saved u, never requantizes
            grads = ref.cutlayer_prior_bwd_ref(mu, logvar, eps, pmu, plv, u,
                                               gu, grate, 32, ctx.mode)
        else:
            grads = cut_prior_bwd(mu, logvar, eps, pmu, plv, u, gu, grate,
                                  mode=ctx.mode)
        return (*grads, None, None)


def _device_type(tensors) -> str:
    devices = {t.device.type for t in tensors}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"the cut layer runs on CPU or CUDA tensors, all "
                         f"on one device; got {sorted(devices)}")
    return devices.pop()


def cutlayer_fused(mu, logvar, eps, *, link_bits: int = 32,
                   rate_estimator: str = "analytic", prior_mu=None,
                   prior_logvar=None):
    """One fused pass over the cut layer, all J nodes in one launch, with
    the hand-written backward under autograd.

    mu/logvar/eps: (..., d); every leading axis (J clients, batch) folds
    into the row count.  Returns (u (..., d) in mu.dtype, rate (...,)
    fp32).  link_bits >= 32 disables the quantizer.  prior_mu/prior_logvar
    — (d,) shared, or (J, d) per node with mu shaped (J, ..., d) — switch
    the rate to a learned Gaussian prior (the prior kernels), whose
    gradients the backward also yields; with rate_estimator "none" the
    prior is irrelevant and ignored, as in the reference."""
    if rate_estimator not in MODES:
        raise ValueError(f"unknown rate_estimator {rate_estimator!r}")
    shape = mu.shape
    d = shape[-1]
    if prior_mu is None or rate_estimator == "none":
        _device_type((mu, logvar, eps))
        R = math.prod(shape[:-1])
        u, rate = _CutLayer.apply(
            *(t.reshape(R, d).contiguous() for t in (mu, logvar, eps)),
            link_bits, rate_estimator)
        return u.reshape(shape), rate.reshape(shape[:-1])
    _device_type((mu, logvar, eps, prior_mu, prior_logvar))
    if prior_logvar.shape != prior_mu.shape or prior_mu.shape[-1] != d:
        raise ValueError(f"prior shapes {tuple(prior_mu.shape)}, "
                         f"{tuple(prior_logvar.shape)} do not fit latents "
                         f"of width {d}")
    if prior_mu.dim() == 1:                 # shared prior: one node group
        J = 1
        pmu, plv = prior_mu[None], prior_logvar[None]
    else:                                   # per-node (J, d) priors
        J = prior_mu.shape[0]
        if shape[0] != J:
            raise ValueError(f"per-node prior J={J} vs mu leading axis "
                             f"{shape[0]}")
        pmu, plv = prior_mu, prior_logvar
    T = math.prod(shape[:-1]) // J
    # the kernels take fp32 priors; autograd casts their gradients back
    pmu, plv = (p.to(torch.float32).contiguous() for p in (pmu, plv))
    u, rate = _CutLayerPrior.apply(
        *(t.reshape(J, T, d).contiguous() for t in (mu, logvar, eps)),
        pmu, plv, link_bits, rate_estimator)
    return u.reshape(shape), rate.reshape(shape[:-1])


def cutlayer_backward(mu, logvar, eps, gu, grate, *, link_bits: int,
                      rate_estimator: str = "sample"):
    """The fused eq.-(10) backward as a plain dispatch (the kernel the
    `_CutLayer` Function runs), for callers that own their gradient.
    (..., d) tensors and (...,) grate; CPU tensors take the plain version,
    CUDA tensors the kernel.  Returns (dmu, dlv, deps)."""
    if rate_estimator not in MODES:
        raise ValueError(f"unknown rate_estimator {rate_estimator!r}")
    shape = mu.shape
    d = shape[-1]
    R = math.prod(shape[:-1])
    rows = [t.reshape(R, d).contiguous() for t in (mu, logvar, eps, gu)]
    gr = grate.reshape(R).contiguous()
    if _device_type((*rows, gr)) == "cpu":
        grads = ref.cutlayer_bwd_ref(*rows, gr, link_bits, rate_estimator)
    else:
        grads = cut_bwd(*rows, gr, bits=link_bits, mode=rate_estimator)
    return tuple(g.reshape(shape) for g in grads)


# ---------------------------------------------------------------------------
# The packed wire's entries: no gradient rule (core/wirefmt.py owns them)
# ---------------------------------------------------------------------------

def cutlayer_pack_forward(mu, logvar, eps, *, link_bits: int,
                          rate_estimator: str = "sample"):
    """Pack-emitting fused forward: (u (..., d) in mu.dtype, lanes (..., W)
    uint32, rate (...,) fp32) in one pass, every leading axis folded into
    the rows.  Bit-identical to `cutlayer_fused` on (u, rate).  No
    gradient rule: callers wrap it in an autograd Function whose backward
    is `cutlayer_backward`."""
    if rate_estimator not in MODES:
        raise ValueError(f"unknown rate_estimator {rate_estimator!r}")
    ref.vals_per_word(link_bits)            # refuses a width outside 1..16
    shape = mu.shape
    d = shape[-1]
    R = math.prod(shape[:-1])
    rows = [t.reshape(R, d).contiguous() for t in (mu, logvar, eps)]
    if _device_type(rows) == "cpu":
        u, lanes, rate = ref.cutlayer_pack_fwd_ref(*rows, link_bits,
                                                   rate_estimator)
    else:
        u, lanes, rate = cut_fwd_pack(*rows, bits=link_bits,
                                      mode=rate_estimator)
    return (u.reshape(shape), lanes.reshape(shape[:-1] + lanes.shape[-1:]),
            rate.reshape(shape[:-1]))


def pack_values(u, *, link_bits: int):
    """Quantized values -> codeword lanes, (..., d) -> (..., W) uint32;
    lossless on values on the link_bits grid.

    A value stored in bf16 holds a grid of at most 8 bits exactly; a wider
    code would decode to other values, so it is refused (pack from the
    kernel's fp32 internals with `cutlayer_pack_forward` instead)."""
    if u.element_size() < 4 and link_bits > 8:
        raise ValueError(f"cannot re-encode {u.dtype} values at "
                         f"{link_bits}-bit codes (> 8 bits exceeds the "
                         "half-precision mantissa); pack from the kernel's "
                         "fp32 internals via cutlayer_pack_forward instead")
    shape = u.shape
    d = shape[-1]
    rows = u.reshape(math.prod(shape[:-1]), d).contiguous()
    if _device_type((rows,)) == "cpu":
        lanes = ref.pack_values_ref(rows, link_bits)
    else:
        lanes = pack(rows, bits=link_bits)
    return lanes.reshape(shape[:-1] + lanes.shape[-1:])


def unpack_dequant(packed, d: int, *, link_bits: int, dtype=torch.float32):
    """Fusion-node unpack: (..., W) uint32 lanes -> (..., d) quantized
    values in `dtype`, one extract-and-dequantize pass."""
    W = ref.packed_width(d, link_bits)
    if packed.shape[-1] != W:
        raise ValueError(f"packed width {packed.shape[-1]} does not match "
                         f"d={d} at {link_bits} bits (want {W})")
    shape = packed.shape
    rows = packed.reshape(math.prod(shape[:-1]), W).contiguous()
    if _device_type((rows,)) == "cpu":
        out = ref.unpack_dequant_ref(rows, d, link_bits, dtype=dtype)
    else:
        out = unpack(rows, d=d, bits=link_bits, dtype=dtype)
    return out.reshape(shape[:-1] + (d,))
