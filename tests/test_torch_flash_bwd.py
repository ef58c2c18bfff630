"""The attention backward's dispatch and wrapper (`kernels/ops.attention_bwd`,
`kernels/flash_attention.flash_attn_bwd`), with no JAX.

On the CPU: a CPU or meta tensor takes the plain version
`ref.flash_bwd_ref` (bit for bit, the kernel's counter untouched), and
autograd through `blockwise_attention` is that call; the wrapper refuses a
wrong dtype, shape, head dim or an unaligned bf16 tensor before it asks
for a card; the split of the dk, dv launch's grid; the kernel source's
names and tile.  The value and gradients against the JAX reference are in
`test_torch_flash_train.py`.

On the card (skipped here): the kernel against the plain version in bf16
and fp32 at every head dim, with GQA, a window, q_offset and a ragged S;
two launches give the same bits; one launch counted a call.  Bars: bf16
dq, dk, dv are each rounded once, as the plain version's fp32 results are,
so where the two fp32 values straddle a rounding midpoint they come one
ulp apart, up to 2^-7 of the value; the kernel's P and dS enter their
products as bf16 hi + lo (about 2^-16 of themselves) and its fp32 sums
run in another order, which moves the fp32 values far less: 2^-7 of the
value plus 2^-12 of the largest |value|.  fp32: the same fp32 terms in
another order, expf against torch's exp: 2e-5 of the largest |value|.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_common import cuda_device  # noqa: E402,F401
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

CSRC = Path(flash_attention.__file__).resolve().parent / "csrc"

# (B, Sq, Sk, H, KV, Dh, window, q_offset)
CASES = {
    "gqa g=4": (1, 48, 48, 8, 2, 16, 0, 0),
    "window": (2, 40, 40, 4, 2, 16, 8, 0),
    "q_offset": (1, 24, 40, 4, 1, 16, 0, 16),
    "ragged S": (2, 33, 33, 4, 2, 16, 0, 0),
}
CARD_CASES = {
    "Dh=32 gqa g=4": (2, 200, 200, 8, 2, 32, 0, 0),
    "Dh=64 window": (1, 300, 300, 8, 4, 64, 100, 0),
    "Dh=80 q_offset": (1, 130, 190, 4, 2, 80, 0, 60),
    "Dh=128 ragged": (1, 257, 257, 24, 2, 128, 0, 0),
    "Dh=192 mha": (1, 160, 160, 4, 4, 192, 0, 0),
    "Dh=128 window q_offset": (2, 96, 200, 6, 2, 128, 70, 104),
}
BF16_REL, BF16_ABS = 2.0 ** -7, 2.0 ** -12
FP32_ABS = 2e-5


def inputs(B, Sq, Sk, H, KV, Dh, *, seed=0, dtype=torch.float32,
           device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Sq, H, Dh, generator=g)
    k = torch.randn(B, Sk, KV, Dh, generator=g)
    v = torch.randn(B, Sk, KV, Dh, generator=g)
    do = torch.randn(B, Sq, H, Dh, generator=g)
    return [t.to(device=device, dtype=dtype) for t in (q, k, v, do)]


def plain_backward(q, k, v, do, window, q_offset):
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = ref.attention_ref(q, k, v, lse=True, **kw)
    grads = ref.flash_bwd_ref(q, k, v, out, lse, do, block_q=16,
                              block_k=16, **kw)
    return out, lse, kw, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_bwd_takes_the_plain_version_on_cpu(case):
    B, Sq, Sk, H, KV, Dh, window, q_offset = CASES[case]
    q, k, v, do = inputs(B, Sq, Sk, H, KV, Dh)
    out, lse, kw, want = plain_backward(q, k, v, do, window, q_offset)
    before = dict(flash_attention.LAUNCHES)
    got = ops.attention_bwd(q, k, v, out, lse, do, block_q=16, block_k=16,
                            **kw)
    assert flash_attention.LAUNCHES == before
    assert flash_attention.LAUNCHES["flash_attn_bwd"] == 0
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == like.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_attention_backward_is_the_dispatched_call(case):
    """Autograd through `blockwise_attention` on the CPU gives what
    `ops.attention_bwd` (the plain version) gives from the forward's own
    (out, lse), bit for bit, and launches nothing."""
    B, Sq, Sk, H, KV, Dh, window, q_offset = CASES[case]
    q, k, v, do = inputs(B, Sq, Sk, H, KV, Dh, seed=1)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = dict(flash_attention.LAUNCHES)
    o = attention.blockwise_attention(qs, ks, vs, causal=True, window=window,
                                      q_offset=q_offset, block_q=16,
                                      block_k=16)
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    out, lse, kw, want = plain_backward(q, k, v, do, window, q_offset)
    assert torch.equal(o.detach(), out)
    assert flash_attention.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_attention_bwd_propagates_shapes_on_meta():
    q, k, v, do = (t.to("meta") for t in inputs(2, 40, 40, 8, 2, 32))
    lse = torch.empty(2, 40, 8, device="meta")
    dq, dk, dv = ops.attention_bwd(q, k, v, q, lse, do)
    assert [t.device.type for t in (dq, dk, dv)] == ["meta"] * 3
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)


def _bwd_args(dtype=torch.bfloat16, Dh=32, **change):
    q, k, v, do = inputs(1, 8, 8, 4, 2, Dh, dtype=dtype)
    args = dict(q=q, k=k, v=v, out=q.clone(), lse=torch.zeros(1, 8, 4),
                dout=do)
    args.update(change)
    return args


def _unaligned(t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


REFUSALS = {
    "fp16": (TypeError, "all fp32 or all bf16", lambda: _bwd_args(
        torch.float16)),
    "mixed dtypes": (TypeError, "all fp32 or all bf16", lambda: _bwd_args(
        dout=torch.zeros(1, 8, 4, 32))),
    "bf16 lse": (TypeError, "lse fp32", lambda: _bwd_args(
        lse=torch.zeros(1, 8, 4, dtype=torch.bfloat16))),
    "out shape": (ValueError, "with H % KV == 0", lambda: _bwd_args(
        out=torch.zeros(1, 7, 4, 32, dtype=torch.bfloat16))),
    "lse shape": (ValueError, "lse \\(B, Sq, H\\)", lambda: _bwd_args(
        lse=torch.zeros(1, 8, 2))),
    "H % KV": (ValueError, "H % KV == 0", lambda: _bwd_args(
        k=torch.zeros(1, 8, 3, 32, dtype=torch.bfloat16),
        v=torch.zeros(1, 8, 3, 32, dtype=torch.bfloat16))),
    "Dh 48": (ValueError, "head dim in", lambda: _bwd_args(Dh=48)),
    "unaligned bf16": (ValueError, "16-byte aligned", lambda: {
        **_bwd_args(), "q": _unaligned(_bwd_args()["q"])}),
    "a CPU tensor": (ValueError, "takes CUDA tensors", lambda: _bwd_args()),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_flash_attn_bwd_refuses(case):
    """Each fault raises its own error; all but the last are found before
    the wrapper asks for a card, so they need none."""
    exc, match, make = REFUSALS[case]
    with pytest.raises(exc, match=match):
        flash_attention.flash_attn_bwd(**make())
    assert flash_attention.LAUNCHES["flash_attn_bwd"] == 0


@pytest.mark.parametrize("shape,want", [
    ((1, 4096, 2, 12), 12),      # the 4k train step: 128 key tiles
    ((8, 512, 2, 12), 12),       # train-512: 128 too
    ((4, 2048, 8, 4), 1),        # Llama-3.2-1B: 1,024 already
    ((1, 2048, 128, 1), 1),      # MLA: no group to split
    ((1, 1024, 1, 8), 8),        # 16 tiles: the whole group
    ((2, 2048, 4, 12), 4),       # 256 tiles: 4 parts reach 1,024 blocks
])
def test_bwd_splits(shape, want):
    B, Sk, KV, group = shape
    got = flash_attention.bwd_splits(B, Sk, KV, group)
    assert got == want and group % got == 0


def test_kernel_source_names_and_tile():
    """No kernel of the backward has a name the forward's trace readers
    count by substring, and the wrapper's key tile is the source's."""
    src = (CSRC / "flash_attn_bwd.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)", src)
    assert len(names) == 5, names
    assert not any("flash_fwd_kernel" in n or "flash_fwd_mma_kernel" in n
                   for n in names)
    tile = re.search(r"constexpr int kTile = (\d+);", src)
    assert int(tile.group(1)) == flash_attention.BWD_KEY_TILE
    for dh in flash_attention.HEAD_DIMS:
        assert f"case {dh}: return launch_mma<{dh}>" in src
    assert re.search(r"\batomic[A-Z]\w*\(", src) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_pair(case, dtype, device, seed=0):
    B, Sq, Sk, H, KV, Dh, window, q_offset = CARD_CASES[case]
    q, k, v, do = inputs(B, Sq, Sk, H, KV, Dh, seed=seed, dtype=dtype,
                         device=device)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = flash_attention.flash_attn_fwd(q, k, v, lse=True, **kw)
    return (q, k, v, out, lse, do), kw


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_flash_bwd_kernel_matches_plain_on_cuda(cuda_device, case, dtype):
    args, kw = _card_pair(case, getattr(torch, dtype), cuda_device)
    before = flash_attention.LAUNCHES["flash_attn_bwd"]
    got = flash_attention.flash_attn_bwd(*args, **kw)
    again = flash_attention.flash_attn_bwd(*args, **kw)
    want = ref.flash_bwd_ref(*args, block_q=64, block_k=64, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attn_bwd"] == before + 2
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), f"{name}: two launches differ"
        g, w = g.float(), w.float()
        top = float(w.abs().max())
        if dtype == "bfloat16":
            bar = BF16_REL * w.abs() + BF16_ABS * top
            assert bool(((g - w).abs() <= bar).all()), (
                name, float((g - w).abs().max()), top)
        else:
            assert float((g - w).abs().max()) <= FP32_ABS * top, (
                name, float((g - w).abs().max()), top)


def test_blockwise_attention_launches_the_backward_on_cuda(cuda_device):
    args, kw = _card_pair("Dh=128 ragged", torch.bfloat16, cuda_device, 3)
    q, k, v, _, _, do = args
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = flash_attention.LAUNCHES["flash_attn_bwd"]
    o = attention.blockwise_attention(qs, ks, vs, **kw)
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    want = flash_attention.flash_attn_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attn_bwd"] == before + 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert np.isfinite([float(g.float().abs().sum()) for g in got]).all()
