"""The kernels Zamba2-7B brought, with no JAX: the flash-attention forward
and backward at Dh = 224 and at a softmax scale other than 1/sqrt(Dh), and
the SSD scan with B and C in groups.

On the CPU: `ops.attention` and `ops.attention_bwd` carry a scale to the
plain versions (the backward against autograd through the forward, in
float64); both kernel sources build a Dh = 224 instance and the wrapper
takes it.

On the card (skipped here): each kernel against its plain version at
Dh = 224, with the default and Zamba2-7B's (Dh / 2)^-1/2 scale, within the
bars of `test_torch_flash_bwd.py` (the forward's: 2e-5 fp32, 2e-2 bf16, of
`test_torch_llm_kernels.py`); two backward launches give the same bits;
every earlier Dh gives the same bits with the scale passed as with the
default; the grouped `ssd_scan` against `ref.ssd_chunked_ref` relative to
the largest value (bf16 2e-2, the bar of `test_torch_llm_kernels.py`;
fp32 5e-5: each side sums a chunk's dt a in its own order, the kernel by
a warp scan, the plain version on the card by doubling, and an error of
2^-24 |cum| in an exponent, |cum| near 200 over a chunk of 256 at these
draws, is 1.2e-5 of a term; measured 2.2e-5 at Zamba2-7B's heads), G = 1
given as (B, S, 1, N) the same bits as
(B, S, N), and the bf16 scan's refusal of an odd number of heads a group.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_common import cuda_device  # noqa: E402,F401
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402

CSRC = Path(flash_attention.__file__).resolve().parent / "csrc"
TOL, BF16_TOL = 2e-5, 2e-2
SSD_TOL = 5e-5
BF16_REL, BF16_ABS = 2.0 ** -7, 2.0 ** -12
FP32_ABS = 2e-5
ZAMBA_SCALE = (224 / 2) ** -0.5


def qkv(B, Sq, Sk, H, KV, Dh, *, seed=0, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    out = [torch.randn(B, Sq, H, Dh, generator=g),
           torch.randn(B, Sk, KV, Dh, generator=g),
           torch.randn(B, Sk, KV, Dh, generator=g),
           torch.randn(B, Sq, H, Dh, generator=g)]
    return [t.to(device=device, dtype=dtype) for t in out]


def ssd_inputs(B, S, H, P, N, G, *, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return (f(rng.normal(size=(B, S, H, P))),
            f(np.log1p(np.exp(rng.normal(size=(B, S, H))))),
            f(-np.exp(0.2 * rng.normal(size=(H,)))),
            f(rng.normal(size=(B, S, G, N))), f(rng.normal(size=(B, S, G, N))),
            f(1.0 + 0.2 * rng.normal(size=(H,))))


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def test_both_sources_build_dh_224():
    assert 224 in flash_attention.HEAD_DIMS
    fwd = (CSRC / "flash_attn_fwd.cu").read_text()
    bwd = (CSRC / "flash_attn_bwd.cu").read_text()
    assert "case 224: return launch_mma<224>" in fwd
    assert "case 224: return launch<float, 14>" in fwd
    assert "case 224: return launch_mma<224>" in bwd
    assert "case 224: return launch_simt<14, 2>" in bwd
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", bwd)
    assert not any(n.startswith("flash_fwd_") for n in names)


@pytest.mark.parametrize("scale", [None, ZAMBA_SCALE, 0.3])
def test_scale_reaches_the_plain_versions(scale):
    """ops.attention and ops.attention_bwd at a scale: the forward is the
    plain version's, the backward autograd's through it (float64)."""
    q, k, v, do = qkv(1, 24, 24, 4, 2, 16, seed=1, dtype=torch.float64)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ref.attention_ref(qs, ks, vs, causal=True, scale=scale)
    want = torch.autograd.grad(out, (qs, ks, vs), do)
    got_out, lse = ops.attention(q, k, v, causal=True, return_lse=True,
                                 scale=scale)
    assert torch.equal(got_out, out.detach())
    got = ops.attention_bwd(q, k, v, got_out, lse, do, causal=True,
                            block_q=8, block_k=8, scale=scale)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())
    if scale is None:
        s = 1.0 / math.sqrt(16)
        assert torch.equal(got_out, ops.attention(q, k, v, causal=True,
                                                  scale=s))


def test_grouped_plain_scan_one_group_is_the_shared_form():
    """The plain scan runs group by group, each group through the one-group
    form: at G = 1, B and C as (B, S, N) or (B, S, 1, N), the results and
    every gradient are the one-group form's bit for bit, and two groups
    that carry the same B and C give the one-group results bit for bit."""
    x, dt, a, bm, cm, d = ssd_inputs(1, 256, 6, 64, 64, 1, seed=2)
    forms = (lambda *t: ref._ssd_chunked_group(*t[:3], t[3][:, :, 0],
                                               t[4][:, :, 0], t[5],
                                               chunk=256),
             lambda *t: ref.ssd_chunked_ref(*t, chunk=256),
             lambda *t: ref.ssd_chunked_ref(*t[:3], t[3][:, :, 0],
                                            t[4][:, :, 0], t[5], chunk=256))
    runs = []
    for form in forms:
        ins = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm, d)]
        y, s = form(*ins)
        grads = torch.autograd.grad((y * torch.cos(y)).sum() + s.sum(), ins)
        runs.append((y, s) + grads)
    for other in runs[1:]:
        assert all(torch.equal(g, w) for g, w in zip(other, runs[0]))
    two = [t.expand(-1, -1, 2, -1).contiguous() for t in (bm, cm)]
    for fn in (lambda *t: ref.ssd_chunked_ref(*t, chunk=256),
               ref.ssd_scan_ref):
        got = fn(x[:, :64], dt[:, :64], a, *(t[:, :64] for t in two), d)
        want = fn(x[:, :64], dt[:, :64], a, bm[:, :64], cm[:, :64], d)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, window, q_offset) at Dh = 224
FLASH_224 = {"mha S=4096": (1, 4096, 4096, 2, 2, 0, 0),
             "ragged gqa": (2, 200, 200, 4, 2, 0, 0),
             "window q_offset": (1, 130, 190, 4, 4, 50, 60)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scale", [None, ZAMBA_SCALE])
@pytest.mark.parametrize("case", sorted(FLASH_224))
def test_flash_224_matches_plain_on_cuda(cuda_device, case, scale, dtype):
    B, Sq, Sk, H, KV, window, q_offset = FLASH_224[case]
    dt = getattr(torch, dtype)
    q, k, v, do = qkv(B, Sq, Sk, H, KV, 224, seed=4, dtype=dt,
                      device=cuda_device)
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=scale)
    out, lse = flash_attention.flash_attn_fwd(q, k, v, lse=True, **kw)
    want, want_lse = ref.attention_ref(q, k, v, lse=True, **kw)
    got = flash_attention.flash_attn_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attention.flash_attn_bwd(q, k, v, out, lse, do, **kw)
    want_g = ref.flash_bwd_ref(q, k, v, out, lse, do, block_q=64,
                               block_k=64, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    assert err <= (TOL if dtype == "float32" else BF16_TOL), err
    assert float((lse - want_lse).abs().max()) <= 1e-4
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want_g):
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Dh", [32, 64, 80, 128, 192])
def test_earlier_head_dims_take_the_default_scale_on_cuda(cuda_device, Dh,
                                                          dtype):
    """The scale 1/sqrt(Dh) passed or left out: the same launch, the same
    bits, forward and backward."""
    q, k, v, do = qkv(1, 160, 160, 4, 2, Dh, seed=5,
                      dtype=getattr(torch, dtype), device=cuda_device)
    s = 1.0 / math.sqrt(Dh)
    o0, l0 = flash_attention.flash_attn_fwd(q, k, v, lse=True)
    o1, l1 = flash_attention.flash_attn_fwd(q, k, v, lse=True, scale=s)
    g0 = flash_attention.flash_attn_bwd(q, k, v, o0, l0, do)
    g1 = flash_attention.flash_attn_bwd(q, k, v, o0, l0, do, scale=s)
    torch.cuda.synchronize()
    assert torch.equal(o0, o1) and torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# (B, S, H, P, N, G, chunk): Zamba2-7B's heads and groups; a small case
# with a ragged 64-row tile
SSD_GROUPED = {"zamba2-7b": (1, 1024, 112, 64, 64, 2, 256),
               "ragged tile": (2, 192, 8, 16, 16, 4, 96)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(SSD_GROUPED))
def test_grouped_ssd_matches_plain_on_cuda(cuda_device, case, dtype):
    B, S, H, P, N, G, chunk = SSD_GROUPED[case]
    x, dt, a, bm, cm, d = ssd_inputs(B, S, H, P, N, G, seed=8,
                                     device=cuda_device)
    low = getattr(torch, dtype)
    x, bm, cm = x.to(low), bm.to(low), cm.to(low)
    y, state = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=chunk)
    y_ref, state_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, d, chunk=chunk)
    torch.cuda.synchronize()
    tol = SSD_TOL if dtype == "float32" else BF16_TOL

    def rel(got, want):
        got, want = got.double(), want.double()
        return float((got - want).abs().max() / want.abs().max())
    assert rel(y, y_ref) <= tol and rel(state, state_ref) <= tol


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_group_is_the_shared_launch_on_cuda(cuda_device, dtype):
    x, dt, a, bm, cm, d = ssd_inputs(2, 512, 6, 64, 64, 1, seed=9,
                                     device=cuda_device)
    low = getattr(torch, dtype)
    x, bm, cm = x.to(low), bm.to(low), cm.to(low)
    y1, s1 = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=256)
    y0, s0 = ssm_scan.ssd_scan(x, dt, a, bm[:, :, 0].contiguous(),
                               cm[:, :, 0].contiguous(), d, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y1, y0) and torch.equal(s1, s0)


def test_bf16_scan_refuses_an_odd_group_on_cuda(cuda_device):
    x, dt, a, bm, cm, d = ssd_inputs(1, 64, 6, 16, 16, 2, seed=1,
                                     device=cuda_device)
    before = dict(ssm_scan.LAUNCHES)
    with pytest.raises(ValueError, match="even number of heads"):
        ssm_scan.ssd_scan(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(),
                          d, chunk=64)
    assert ssm_scan.LAUNCHES == before


def test_the_sub_mark_on_cuda(cuda_device):
    """A sub-mark inside "backward" is summed into the eager step's
    sample under its own name, within the backward, and leaves "other"
    the unit less its three phases."""
    from repro_torch import tracing
    x = torch.randn(2048, 2048, device=cuda_device)
    since = tracing.cursor()
    for _ in range(3):
        with tracing.phase("forward", cuda_device):
            y = x @ x
        with tracing.phase("backward", cuda_device):
            with tracing.submark("ssd_backward", cuda_device):
                y = y @ x
            y = y @ x
        with tracing.phase("optimizer", cuda_device):
            y = y + 1
    torch.cuda.synchronize()
    got = [s for s in tracing.samples(since) if s.kind == "eager"]
    assert len(got) == 3
    for s in got:
        assert 0 < s.ms["ssd_backward"] < s.ms["backward"]
        assert s.ms["other"] == pytest.approx(
            s.ms["unit"] - s.ms["forward"] - s.ms["backward"]
            - s.ms["optimizer"])
