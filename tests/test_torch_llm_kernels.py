"""The port's attention and SSD scan against the JAX package.

  * `kernels/ref.attention_ref` (the flash kernel's plain version) against
    the Pallas `flash_attention` in interpret mode (causal, a window, a
    q_offset on a q slice), and against the reference's `attention_ref` and
    the model's `blockwise_attention` at a ragged S = 96, Dh = 80 and MQA;
  * `kernels/ref.ssd_chunked_ref` (the scan kernel's plain version) against
    the Pallas `ssd_scan` in interpret mode, against the model's
    `_ssd_chunked` (y and the final state) and against the sequential
    definition (the reference's and the port's `ssd_scan_ref`);
  * on the card (skipped without one): each kernel against its plain
    version on the same CUDA tensors, fp32 and bf16.

Inputs are drawn with numpy from a seed and handed to both packages.  The
bar is 2e-5 in fp32, absolute for attention and relative to the largest
|y| for the scan, the bar of tests/test_kernels.py; 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_common import cuda_device  # noqa: E402,F401
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro.kernels.ssm_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.attention import blockwise_attention  # noqa: E402
from repro.models.ssm import _ssd_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402

TOL = 2e-5
BF16_TOL = 2e-2


def qkv(B, S, H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, n, Dh)).astype(np.float32)
                 for n in (H, KV, KV))


def ssd_inputs(B, S, H, P, N, seed=0):
    """(x, dt, a, bm, cm, d) as tests/test_kernels.py draws them: dt a
    softplus of a normal, a = -exp(0.2 N(0, 1)), D around 1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    a = (-np.exp(0.2 * rng.normal(size=(H,)))).astype(np.float32)
    bm = rng.normal(size=(B, S, N)).astype(np.float32)
    cm = rng.normal(size=(B, S, N)).astype(np.float32)
    d = (1.0 + 0.2 * rng.normal(size=(H,))).astype(np.float32)
    return x, dt, a, bm, cm, d


def t(*arrays, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,q_offset", [(0, 0), (32, 0), (0, 64)])
def test_attention_ref_matches_pallas_interpret(window, q_offset):
    q, k, v = qkv(1, 128, 4, 2, 32, seed=1)
    q = q[:, q_offset:]
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, q_offset=q_offset,
                           block_q=64, block_k=64, interpret=True)
    got = ref.attention_ref(*t(q, k, v), causal=True, window=window,
                            q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("window,q_offset", [(0, 0), (40, 0), (0, 32)])
def test_attention_ref_matches_reference_ragged_mqa(window, q_offset):
    """S = 96 (not a multiple of the 64-row tiles), Dh = 80 (Zamba2's), one
    kv head for four query heads."""
    q, k, v = qkv(2, 96, 4, 1, 80, seed=2)
    q = q[:, q_offset:]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    got = ref.attention_ref(*t(q, k, v), causal=True, window=window,
                            q_offset=q_offset).numpy()
    want = jref.attention_ref(jq, jk, jv, causal=True, window=window,
                              q_offset=q_offset)
    model = blockwise_attention(jq, jk, jv, causal=True, window=window,
                                q_offset=q_offset, block_q=64, block_k=64)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(model), atol=TOL, rtol=0)


def test_ops_attention_on_cpu_is_the_plain_version():
    q, k, v = t(*qkv(1, 40, 2, 2, 16, seed=3))
    assert torch.equal(ops.attention(q, k, v, causal=True, window=8),
                       ref.attention_ref(q, k, v, causal=True, window=8))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel wrapper's launch: it raises."""
    before = (dict(fa.LAUNCHES), dict(ssm_scan.LAUNCHES))
    q, k, v = t(*qkv(1, 16, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attn_fwd(q, k, v)
    x, dt, a, bm, cm, d = t(*ssd_inputs(1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=8)
    assert (fa.LAUNCHES, ssm_scan.LAUNCHES) == before


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def test_ssd_chunked_ref_matches_pallas_interpret():
    x, dt, a, bm, cm, d = ssd_inputs(1, 64, 2, 16, 8, seed=4)
    want = jax_ssd_scan(*map(jnp.asarray, (x, dt, a, bm, cm, d)), chunk=32,
                        interpret=True)
    got, _ = ref.ssd_chunked_ref(*t(x, dt, a, bm, cm, d), chunk=32)
    assert rel_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 128, 2, 32, 16, 64),
                                             (1, 192, 2, 16, 8, 64)])
def test_ssd_chunked_ref_matches_model_and_sequential(B, S, H, P, N, chunk):
    x, dt, a, bm, cm, d = ssd_inputs(B, S, H, P, N, seed=5)
    jargs = tuple(map(jnp.asarray, (x, dt, a, bm, cm, d)))
    y, state = ref.ssd_chunked_ref(*t(x, dt, a, bm, cm, d), chunk=chunk)
    y_model, state_model = _ssd_chunked(*jargs, chunk)
    assert rel_err(y.numpy(), y_model) <= TOL
    assert rel_err(state.numpy(), state_model) <= TOL
    assert rel_err(y.numpy(), jref.ssd_scan_ref(*jargs)) <= TOL
    y_seq, state_seq = ref.ssd_scan_ref(*t(x, dt, a, bm, cm, d))
    assert rel_err(y.numpy(), y_seq.numpy()) <= TOL
    assert rel_err(state.numpy(), state_seq.numpy()) <= TOL


def test_ssd_chunked_ref_refuses_a_ragged_chunk():
    x, dt, a, bm, cm, d = t(*ssd_inputs(1, 96, 2, 8, 4))
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssd_scan(x, dt, a, bm, cm, d, chunk=64)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,Dh,window,q_offset", [
    (1, 128, 4, 4, 32, 0, 0), (2, 256, 8, 2, 64, 100, 0),
    (1, 256, 8, 1, 64, 0, 64), (2, 192, 32, 32, 80, 0, 0),
    (1, 512, 2, 2, 128, 100, 64),
    # the tensor-core kernel's tile edges: S not a multiple of 16, Sq != Sk
    # with q_offset, and Zamba2's serving shape
    (2, 200, 4, 4, 64, 0, 0), (1, 200, 4, 2, 80, 50, 72),
    (4, 512, 32, 32, 80, 0, 0),
    # Dh = 192, MLA's prefill: a ragged window case and DeepSeek-V2's
    # serving shape (H = KV = 128)
    (1, 200, 4, 4, 192, 50, 72), (4, 512, 128, 128, 192, 0, 0)])
def test_flash_kernel_matches_plain_on_cuda(cuda_device, B, S, H, KV, Dh,
                                            window, q_offset, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (x.to(dt) for x in t(*qkv(B, S, H, KV, Dh, seed=6),
                                   device=cuda_device))
    q = q[:, q_offset:].contiguous()
    got = fa.flash_attn_fwd(q, k, v, causal=True, window=window,
                            q_offset=q_offset)
    want = ref.attention_ref(q, k, v, causal=True, window=window,
                             q_offset=q_offset)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (TOL if dtype == "float32" else BF16_TOL), err


@pytest.mark.parametrize("Dh", [48, 96, 256])
def test_flash_kernel_refuses_other_head_dims_on_cuda(cuda_device, Dh):
    """No fallback: a head dim the kernel has no instance for (DeepSeek-V2's
    smoke config takes 48) raises on the card; ops.attention too."""
    q, k, v = (x.to(torch.bfloat16) for x in t(*qkv(1, 64, 4, 4, Dh),
                                               device=cuda_device))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attn_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        ops.attention(q, k, v, causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 64, 128),
    (1, 192, 2, 16, 8, 64),
    # the tensor-core stages' edges: L=96 (a ragged 64-row tile), N=8 with
    # P=16, and Zamba2's serving shape
    (1, 192, 2, 16, 8, 96), (2, 128, 3, 16, 8, 128),
    (4, 512, 80, 64, 64, 256)])
def test_ssd_kernel_matches_plain_on_cuda(cuda_device, B, S, H, P, N, chunk,
                                          dtype):
    x, dt, a, bm, cm, d = t(*ssd_inputs(B, S, H, P, N, seed=7),
                            device=cuda_device)
    low = getattr(torch, dtype)
    x, bm, cm = x.to(low), bm.to(low), cm.to(low)
    y, state = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=chunk)
    y_ref, state_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, d, chunk=chunk)
    torch.cuda.synchronize()
    tol = TOL if dtype == "float32" else BF16_TOL
    assert rel_err(y.float().cpu(), y_ref.float().cpu()) <= tol
    assert rel_err(state.cpu(), state_ref.cpu()) <= tol
