"""The references' products, in fp32 or in an emulated lower precision.

The references compute every matrix product and convolution through `mm`,
`bmm` and `conv2d` here.  In "fp32" these are the plain fp32 products
(TF32 off).  The controls run the same reference one precision lower, as
the step a faster program would be tempted to take: "tf32" rounds each
product's operands to TF32 (10 mantissa bits, to nearest even), as the
tensor cores do with TF32 on; "fp8" scales each operand by its largest
magnitude onto float8 e4m3's range, rounds it there and scales back, as
fp8 training does.  The backward products round their operands alike.
Plain torch only; it imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "fp8")
_E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / _E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


_ROUND = {"fp32": lambda x: x, "tf32": round_tf32, "fp8": round_fp8}


class _Product(torch.autograd.Function):
    """a @ b for 2-D (N, k) @ (k, n) or batched (X, m, k) @ (X, k, n)."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.prec = prec
        ctx.save_for_backward(a, b)
        r = _ROUND[prec]
        return r(a) @ r(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = _ROUND[ctx.prec]
        g = r(g)
        ga = g @ r(b).transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = r(a).transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gb, None


class _Conv(torch.autograd.Function):
    """3x3, stride 1, padding 1 on NCHW x, with a bias."""

    @staticmethod
    def forward(ctx, x, w, b, prec):
        ctx.prec = prec
        ctx.save_for_backward(x, w)
        r = _ROUND[prec]
        return F.conv2d(r(x), r(w), b, stride=1, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        r = _ROUND[ctx.prec]
        gr = r(g)
        gx = torch.nn.grad.conv2d_input(x.shape, r(w), gr, padding=1) \
            if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv2d_weight(r(x), w.shape, gr, padding=1) \
            if ctx.needs_input_grad[1] else None
        gb = g.sum(dim=(0, 2, 3)) if ctx.needs_input_grad[2] else None
        return gx, gw, gb, None


def mm(a, b, prec: str = "fp32"):
    """(..., k) @ (k, n): the leading axes fold into rows."""
    lead = a.shape[:-1]
    out = _Product.apply(a.reshape(-1, a.shape[-1]), b, prec)
    return out.reshape(*lead, b.shape[-1])


def bmm(a, b, prec: str = "fp32"):
    return _Product.apply(a, b, prec)


def conv2d(x, w, b, prec: str = "fp32"):
    return _Conv.apply(x, w, b, prec)
