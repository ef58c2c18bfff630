"""The SSD scan's gradient in the port against the JAX package, on the CPU.

`models.ssm._ssd_chunked` is an autograd Function: its forward is
`ops.ssd_scan` (the kernel on the card, `ref.ssd_chunked_ref` here), its
backward recomputes `ref.ssd_chunked_ref` in fp32 and differentiates it.
The reference trains Mamba2 through autodiff of its jnp `_ssd_chunked`
(src/repro/models/ssm.py:87).  Bars:
  * the six gradients (x, dt, a, bm, cm, dskip), fp32, given cotangents
    of y and of the final state, over chunks {32, 64} x N {8, 16} x
    P {16, 32} at nc {1, 3}: each within FP32_GRAD_BAR = 1e-5 of its
    largest |value| (the repo's fp32 kernel-gradient bar,
    tests/test_cutlayer_vjp.py) of the exact gradient (float64 autograd
    through the sequential recurrence, the scan's definition), and
    against `jax.vjp` of the reference's `_ssd_chunked` within
    FP32_GRAD_BAR, but for a's within A_GRAD_BAR = 2 FP32_GRAD_BAR: a
    (H,) sums every position's decay term, and the reference's own fp32 a
    gradient parts from the exact one by up to 1.07e-5 of its largest on
    these cases (the port's by up to 8.5e-6), so two fp32 orders of it
    part by up to the sum of two such errors;
  * the Function == autograd through `ssd_chunked_ref` bit for bit;
  * bf16 inputs: the forward == `ops.ssd_scan`'s, bf16 gradients;
  * where dt·|A| summed over a chunk passes ~88, exp(seg) overflows above
    the diagonal: the reference's backward gives NaN there (0·inf), the
    port's, which masks before the exp, the exact gradients;
  * on the card (skipped here): the forward == the kernel's bit for bit,
    the backward == autograd through `ssd_chunked_ref` on the card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import cuda_device  # noqa: E402,F401
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

FP32_GRAD_BAR = 1e-5
A_GRAD_BAR = 2 * FP32_GRAD_BAR
NAMES = ("x", "dt", "a", "bm", "cm", "dskip")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(B, S, H, P, N, seed=0, dt_scale=1.0):
    """Seeded numpy (x, dt, a, bm, cm, dskip, gy, gstate), fp32: dt
    post-softplus in (0.01, 0.5) · dt_scale, a = -exp(N(0, 0.5))."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, S, H, P)).astype(f),
            (dt_scale * rng.uniform(0.01, 0.5, size=(B, S, H))).astype(f),
            (-np.exp(0.5 * rng.normal(size=(H,)))).astype(f),
            rng.normal(size=(B, S, N)).astype(f),
            rng.normal(size=(B, S, N)).astype(f),
            (1.0 + 0.2 * rng.normal(size=(H,))).astype(f),
            rng.normal(size=(B, S, H, P)).astype(f),
            rng.normal(size=(B, H, N, P)).astype(f))


@functools.lru_cache(maxsize=None)
def jax_vjp(chunk):
    def fn(x, dt, a, bm, cm, dskip, gy, gs):
        out, vjp = jax.vjp(lambda *t: jssm._ssd_chunked(*t, chunk), x, dt,
                           a, bm, cm, dskip)
        return out, vjp((gy, gs))
    return jax.jit(fn)


def exact_grads(arrays):
    """The six gradients of the sequential recurrence h_t = exp(dt_t a)
    h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t, in float64."""
    ins = [torch.from_numpy(a).double().requires_grad_(True)
           for a in arrays[:6]]
    x, dt, a, bm, cm, dskip = ins
    B, S, H, P = x.shape
    h = torch.zeros((B, H, bm.shape[-1], P), dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], h)
                  + dskip[:, None] * x[:, t])
    gy, gs = (torch.from_numpy(g).double() for g in arrays[6:])
    return torch.autograd.grad((torch.stack(ys, dim=1), h), ins, (gy, gs))


def port_grads(arrays, chunk, *, cotangents=(True, True)):
    """(outputs, the six gradients) of `ssm._ssd_chunked`."""
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:6]]
    outs = ssm._ssd_chunked(*ins, chunk=chunk)
    pairs = [(o, torch.from_numpy(g)) for o, g, use in
             zip(outs, arrays[6:], cotangents) if use]
    grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                [g for _, g in pairs])
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("P", [16, 32])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("chunk", [32, 64])
def test_gradients_match_jax_vjp(chunk, N, P, nc):
    arrays = inputs(2, chunk * nc, 2, P, N, seed=chunk + N + P + nc)
    (jy, jst), jgrads = jax_vjp(chunk)(*map(jnp.asarray, arrays))
    (y, st), grads = port_grads(arrays, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)
    for name, g, jg, ex in zip(NAMES, grads, jgrads, exact_grads(arrays)):
        jg, ex = np.asarray(jg), ex.numpy()
        assert g.dtype == torch.float32 and g.shape == jg.shape, name
        err = np.abs(g.numpy() - ex).max()
        assert err <= FP32_GRAD_BAR * np.abs(ex).max(), (name, err)
        bar = A_GRAD_BAR if name == "a" else FP32_GRAD_BAR
        err = np.abs(g.numpy() - jg).max()
        assert err <= bar * np.abs(jg).max(), (name, err)


@pytest.mark.parametrize("cotangents", [(True, True), (True, False),
                                        (False, True)],
                         ids=["y+state", "y", "state"])
def test_function_equals_autograd_through_the_plain_scan(cotangents):
    arrays = inputs(2, 96, 3, 16, 8, seed=7)
    (y, st), grads = port_grads(arrays, 32, cotangents=cotangents)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:6]]
    outs = ref.ssd_chunked_ref(*ins, chunk=32)
    assert torch.equal(outs[0].detach(), y)
    assert torch.equal(outs[1].detach(), st)
    pairs = [(o, torch.from_numpy(g)) for o, g, use in
             zip(outs, arrays[6:], cotangents) if use]
    want = torch.autograd.grad([o for o, _ in pairs], ins,
                               [g for _, g in pairs], allow_unused=True)
    for name, g, w, x in zip(NAMES, grads, want, ins):
        # cm reaches y only
        assert torch.equal(g, torch.zeros_like(x) if w is None else w), name


def test_bf16_forward_is_the_scan_and_gradients_keep_the_dtypes():
    arrays = inputs(1, 64, 2, 16, 8, seed=3)
    t = [torch.from_numpy(a) for a in arrays]
    bf = torch.bfloat16
    ins = [t[0].to(bf), t[1], t[2], t[3].to(bf), t[4].to(bf), t[5]]
    want = ops.ssd_scan(*ins, chunk=32)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    got = ssm._ssd_chunked(*leaves, chunk=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    grads = torch.autograd.grad(got[0], leaves, t[6].to(bf))
    assert [g.dtype for g in grads] == [x.dtype for x in ins]
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_overflowing_decay_gives_nan_in_the_reference_only():
    """dt·|A| summed over a 64-step chunk far above 88: exp(seg) is inf
    above the diagonal.  The reference masks after the exp, so its
    backward's 0·inf is NaN there (dt's and a's gradients); the port
    masks before it: the same finite y, every gradient finite and within
    FP32_GRAD_BAR of the exact one, and equal to the reference's within
    the bars wherever the reference's is finite.  a's gradient sums every
    term's exp(cum_i - cum_j), whose exponent carries the fp32 cumsum's
    rounding, about sqrt(chunk) C 2^-24 with C the largest |cum| (1.39e2
    here): that, not FP32_GRAD_BAR, is its bar against the exact one
    (measured 5.4e-5 of its largest against 6.6e-5)."""
    arrays = list(inputs(1, 64, 2, 16, 8, seed=4, dt_scale=8.0))
    arrays[2] = np.full((2,), -1.0, np.float32)          # A = -1
    assert arrays[1].sum(axis=1).min() > 88.0
    cum_bar = np.sqrt(64) * arrays[1].sum(axis=1).max() * 2.0 ** -24
    (jy, _), jgrads = jax_vjp(64)(*map(jnp.asarray, arrays))
    (y, _), grads = port_grads(arrays, 64)
    jy = np.asarray(jy)
    assert np.abs(y.numpy() - jy).max() <= FP32_GRAD_BAR * np.abs(jy).max()
    nans = 0
    for name, g, jg, ex in zip(NAMES, grads, jgrads, exact_grads(arrays)):
        jg, ex = np.asarray(jg), ex.numpy()
        assert bool(torch.isfinite(g).all()), name
        err = np.abs(g.numpy() - ex).max()
        bar = cum_bar if name == "a" else FP32_GRAD_BAR
        assert err <= bar * np.abs(ex).max(), (name, err)
        fin = np.isfinite(jg)
        nans += int((~fin).sum())
        if fin.any():
            bar = A_GRAD_BAR if name == "a" else FP32_GRAD_BAR
            err = np.abs(g.numpy()[fin] - jg[fin]).max()
            assert err <= bar * np.abs(jg[fin]).max(), (name, err)
    assert nans > 0


def test_mamba2_train_mode_runs_the_function():
    """mamba2_apply's train mode goes through `_ssd_chunked` (its
    gradient reaches A_log, D and dt_bias) and returns no state."""
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config("zamba2-2.7b")
    p = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    leaves = {k: p[k].requires_grad_(True) for k in ("A_log", "D",
                                                     "dt_bias")}
    y, state = ssm.mamba2_apply(p, cfg, x, mode="train")
    assert state is None
    with torch.no_grad():
        want, _ = ssm.mamba2_apply(p, cfg, x, mode="prefill")
    assert torch.equal(y.detach(), want)
    grads = torch.autograd.grad(y.square().sum(), list(leaves.values()))
    assert all(float(g.abs().max()) > 0 for g in grads)
    with pytest.raises(ValueError, match="train, prefill or decode"):
        ssm.mamba2_apply(p, cfg, x, mode="serve")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_on_the_card_cuda(cuda_device, dtype):
    """On the card: the forward == `ops.ssd_scan` (the kernel) bit for bit;
    in fp32 the backward == autograd through `ssd_chunked_ref` on the
    card bit for bit (deterministic algorithms); in bf16 the gradients
    from the kernel's forward within 2e-2 of the largest |gradient| of
    the plain fp32 forward's."""
    arrays = inputs(2, 192, 4, 32, 16, seed=9)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    dt_ = getattr(torch, dtype)
    ins = [t[0].to(dt_), t[1], t[2], t[3].to(dt_), t[4].to(dt_), t[5]]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        leaves = [x.clone().requires_grad_(True) for x in ins]
        got = ssm._ssd_chunked(*leaves, chunk=64)
        want = ops.ssd_scan(*ins, chunk=64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        grads = torch.autograd.grad(got, leaves, (t[6].to(dt_), t[7]))
        f32 = [x.float().requires_grad_(True) for x in ins]
        outs = ref.ssd_chunked_ref(*f32, chunk=64)
        plain = torch.autograd.grad(outs, f32, (t[6].to(dt_).float(), t[7]))
    finally:
        torch.use_deterministic_algorithms(False)
    for name, g, w in zip(NAMES, grads, plain):
        if dtype == "float32":
            assert torch.equal(g, w), name
        else:
            err = float((g.float() - w).abs().max())
            assert err <= 2e-2 * float(w.abs().max()), (name, err)
