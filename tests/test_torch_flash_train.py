"""Attention's train mode in the port against the JAX package, on the CPU:
`models/attention.blockwise_attention`, the autograd Function whose
forward is `ops.attention(..., return_lse=True)` (on a CPU tensor the
plain version, `kernels/ref.attention_ref`) and whose backward is
`ops.attention_bwd` (on a CPU tensor `kernels/ref.flash_bwd_ref`, the
port of the reference's `_flash_bwd` and the plain version of the CUDA
backward `flash_attn_bwd`).

Bars:
  * the value and (dq, dk, dv) against the reference's
    `blockwise_attention` and `jax.vjp` of it, in fp32, within 1e-5 of
    the largest |value| of each (both sum the same fp32 terms in other
    orders: measured ~4e-7), over GQA at g = 1, 2 and 4, a window,
    q_offset > 0, a ragged S, blocks of 16 and a single block, and MLA's
    v padded to the qk head dim then trimmed;
  * `torch.autograd.gradcheck` of the Function in float64 (float64 runs
    through the plain forward and the backward in float64);
  * the plain version's logsumexp against the reference's
    `_flash_fwd_core` lse within 1e-5 (values ~2-5, fp32 in other orders).
The kernel's own lse (`csrc/flash_attn_fwd.cu`) and the backward kernel
(`csrc/flash_attn_bwd.cu`) are held against their plain versions on the
card by `chip_smoke.py`'s `llm train` phase and the card tests of
`test_torch_flash_bwd.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = 1e-5
LSE_TOL = 1e-5

# (B, Sq, Sk, H, KV, Dh, window, q_offset, block_q, block_k)
CASES = {
    "mha g=1": (2, 40, 40, 4, 4, 16, 0, 0, 16, 16),
    "gqa g=2": (2, 40, 40, 4, 2, 16, 0, 0, 16, 16),
    "gqa g=4": (1, 48, 48, 8, 2, 16, 0, 0, 16, 16),
    "window": (2, 40, 40, 4, 2, 16, 8, 0, 16, 16),
    "q_offset": (1, 24, 40, 4, 1, 16, 0, 16, 16, 16),
    "window and q_offset": (1, 24, 40, 4, 2, 16, 6, 16, 8, 16),
    "ragged S": (2, 33, 33, 4, 2, 16, 0, 0, 16, 16),
    "one block": (1, 33, 33, 8, 2, 32, 0, 0, 512, 512),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv(B, Sq, Sk, H, KV, Dh, seed=0, v_dim=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, v_dim or Dh)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, v_dim or Dh)).astype(np.float32)
    return q, k, v, do


def rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def port_vjp(fn, q, k, v, do):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_attention_matches_reference_vjp(case):
    B, Sq, Sk, H, KV, Dh, window, q_offset, bq, bk = CASES[case]
    q, k, v, do = qkv(B, Sq, Sk, H, KV, Dh)
    kw = dict(causal=True, window=window, q_offset=q_offset, block_q=bq,
              block_k=bk)
    out, vjp = jax.vjp(
        lambda q, k, v: jattention.blockwise_attention(q, k, v, **kw),
        q, k, v)
    want = [out] + list(vjp(jnp.asarray(do)))
    got = port_vjp(
        lambda q, k, v: attention.blockwise_attention(q, k, v, **kw),
        q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == np.shape(w), name
        assert rel(g, w) <= TOL, (case, name, rel(g, w))


def test_mla_padded_v_matches_reference_vjp():
    """MLA's layout: q, k at the qk head dim (48), v at 32 padded with
    zeros to 48 for one attention call, the output trimmed back to 32 (so
    the padded columns take no gradient), at MLA's scale 1/sqrt(48)."""
    B, S, H, Dqk, Dv = 2, 40, 4, 48, 32
    q, k, v, do = qkv(B, S, S, H, H, Dqk, seed=3, v_dim=Dv)
    scale = 1.0 / np.sqrt(Dqk)

    def jfn(q, k, v):
        vp = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, Dqk - Dv)))
        return jattention.blockwise_attention(
            q, k, vp, causal=True, scale=scale, block_q=16,
            block_k=16)[..., :Dv]

    def tfn(q, k, v):
        vp = torch.nn.functional.pad(v, (0, Dqk - Dv))
        return attention.blockwise_attention(
            q, k, vp, causal=True, scale=scale, block_q=16,
            block_k=16)[..., :Dv]
    out, vjp = jax.vjp(jfn, q, k, v)
    want = [out] + list(vjp(jnp.asarray(do)))
    got = port_vjp(tfn, q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert rel(g, w) <= TOL, (name, rel(g, w))


def test_blockwise_attention_refuses_another_scale():
    """A scale that is no softmax scale (not positive, not finite) raises;
    another positive scale is taken, as the plain attention takes it
    (Zamba2-7B's shared attention runs at (Dh / 2)^-1/2)."""
    q = torch.zeros(1, 4, 2, 16)
    for bad in (0.0, -0.5, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="scale"):
            attention.blockwise_attention(q, q, q, scale=bad)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 6, 2, 16, generator=g) for _ in range(3))
    got = attention.blockwise_attention(q, k, v, scale=0.5)
    assert torch.equal(got, ref.attention_ref(q, k, v, scale=0.5))
    assert not torch.equal(got, ref.attention_ref(q, k, v))


@pytest.mark.parametrize("window,q_offset", [(0, 0), (3, 0), (0, 2)])
def test_gradcheck_float64(window, q_offset):
    rng = np.random.default_rng(7)
    Sq, Sk = 7 - q_offset, 7
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)
               for shape in ((1, Sq, 4, 4), (1, Sk, 2, 4), (1, Sk, 2, 4)))

    def fn(q, k, v):
        return attention.blockwise_attention(
            q, k, v, causal=True, window=window, q_offset=q_offset,
            block_q=4, block_k=4)
    assert fn(q, k, v).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["gqa g=4", "window", "q_offset",
                                  "window and q_offset", "ragged S"])
def test_plain_lse_matches_reference_flash_fwd_core(case):
    B, Sq, Sk, H, KV, Dh, window, q_offset, bq, bk = CASES[case]
    q, k, v, _ = qkv(B, Sq, Sk, H, KV, Dh, seed=1)
    out, lse = jattention._flash_fwd_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=q_offset, block_q=bq, block_k=bk,
        scale=1.0 / np.sqrt(Dh))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got_o, got_lse = ref.attention_ref(*t, causal=True, window=window,
                                       q_offset=q_offset, lse=True)
    assert got_lse.shape == (B, Sq, H) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse).reshape(B, Sq, H),
                               rtol=0, atol=LSE_TOL)
    # the lse changes nothing of the output, and the dispatching wrapper
    # hands the same pair on a CPU tensor
    assert torch.equal(got_o, ref.attention_ref(
        *t, causal=True, window=window, q_offset=q_offset))
    o2, lse2 = ops.attention(*t, causal=True, window=window,
                             q_offset=q_offset, return_lse=True)
    assert torch.equal(o2, got_o) and torch.equal(lse2, got_lse)
    assert rel(got_o.numpy(), np.asarray(out).reshape(B, Sq, H, Dh)) <= TOL
