"""bf16 decode attention in the port against the JAX package, on the CPU.

The reference's `decode_attention` rounds q * scale to the cache's dtype
before both score products and the softmax weights to v's before the PV
product, and accumulates in fp32 (preferred_element_type).  The port
rounds in the same places.

  * `decode_attention` at bf16 on Zamba2-2.7B's attention layout (B=4,
    H=KV=32, Dh=80) with no window (W=544, 300 valid entries), a window
    not yet wrapped (a ring of 256, 200 valid, the next slot excluded) and
    a wrapped ring (256 valid, one slot excluded): given the reference's
    exp, the port's output equals the reference's bit for bit (the same
    roundings, and on the CPU the scores and PV summed in XLA's order);
  * with torch's own exp, which differs from XLA's CPU exp in the last
    fp32 bit of a few percent of the weights, an output may differ only
    in a head whose bf16-rounded softmax weights differ between the two
    exps, and without a window at most one output in 10^4 differs, by at
    most one bf16 ulp;
  * fp32 stays at the parity bar of tests/test_torch_zamba2.py;
  * the bf16 Zamba2 smoke model (num_layers=4), 2 prompts, 16 tokens:
    `serve_batch`'s greedy ids equal the reference's until the first token
    where the reference's logits of the two picks lie within the bf16
    noise between the packages (2.5e-2 of the largest logit).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import zoo_weights  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import convert, tree_leaves  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402

B, H, KV, DH = 4, 32, 32, 80          # Zamba2-2.7B's shared attention
PROMPT, GEN = 128, 16
# the bf16 smoke model's logits differ from the reference's by up to this
# fraction of the largest logit (prefill and decode; two orders of fp32
# accumulation in front of the same bf16 roundings already part by 1e-2)
BF16_LOGIT_NOISE = 2.5e-2
CASES = {"no-window": (544, 300, None), "window": (256, 200, 200),
         "wrapped-ring": (256, 256, 37)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(W, dtype, seed=0):
    """(q, k_cache, v_cache, k_new, v_new) as jax arrays of `dtype` and the
    same values as torch tensors."""
    rng = np.random.default_rng(seed)
    shapes = [(B, 1, H, DH), (B, W, KV, DH), (B, W, KV, DH), (B, 1, KV, DH),
              (B, 1, KV, DH)]
    jx = [jnp.asarray(rng.standard_normal(s), dtype) for s in shapes]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name)) for x in jx]
    return jx, tx


def _decode_both(case, dtype):
    W, n_valid, excl = CASES[case]
    jx, tx = _inputs(W, dtype)
    want = jattention.decode_attention(jx[0], jx[1], jx[2], n_valid, jx[3],
                                       jx[4], exclude_slot=excl)
    got = attention.decode_attention(tx[0], tx[1], tx[2], n_valid, tx[3],
                                     tx[4], exclude_slot=excl)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def _jax_exp(x):
    return torch.from_numpy(np.array(jnp.exp(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_decode_attention_equals_the_reference_given_its_exp(
        case, monkeypatch):
    monkeypatch.setattr(attention.torch, "exp", _jax_exp)
    want, got = _decode_both(case, jnp.bfloat16)
    assert got.shape == want.shape == (B, 1, H, DH)
    np.testing.assert_array_equal(got, want)


def _weight_flips(case):
    """(B, H) bool: heads where torch's exp and XLA's give the port's own
    scores different bf16-rounded softmax weights."""
    W, n_valid, excl = CASES[case]
    _, tx = _inputs(W, jnp.bfloat16)
    q, kc, _, kn, _ = tx
    qc = (q.float() / np.sqrt(DH)).to(torch.bfloat16).reshape(B, KV, 1, DH)
    s = attention._cache_product(qc, kc.permute(0, 2, 3, 1))
    valid = torch.arange(W) < n_valid
    if excl is not None:
        valid &= torch.arange(W) != excl
    s = torch.where(valid, s, torch.full_like(s, attention.NEG_INF))
    s_new = torch.einsum("bkgd,bkd->bkg", qc.float(), kn[:, 0].float())
    x = s - torch.maximum(s.amax(-1), s_new)[..., None]
    flips = torch.exp(x).to(torch.bfloat16) != _jax_exp(x).to(torch.bfloat16)
    return flips.any(-1).reshape(B, H).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_decode_attention_differs_only_where_the_exps_do(case):
    want, got = _decode_both(case, jnp.bfloat16)
    differ = got != want
    heads = differ[:, 0].any(-1)                        # (B, H)
    assert not (heads & ~_weight_flips(case)).any(), case
    if case == "no-window":
        # the F1 bar
        assert differ.sum() * 10_000 <= got.size, int(differ.sum())
        # bf16 widened to fp32: one bf16 ulp is 1 << 16 in the fp32 bits
        ulps = np.abs(got[differ].view(np.int32).astype(np.int64)
                      - want[differ].view(np.int32)) >> 16
        assert (ulps <= 1).all(), ulps


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_decode_attention_stays_at_its_bar(case):
    want, got = _decode_both(case, jnp.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _bf16_smoke(get):
    return dataclasses.replace(get("zamba2-2.7b"), dtype="bfloat16",
                               num_layers=4)


def _reference_logits(jcfg, jp, toks, ids, k):
    """The reference's logits for generated position k of `ids` (k = 0:
    the prefill's last logits), teacher-forced on ids[:, :k]."""
    logits, cache = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    cache = jzoo.pad_cache(cache, GEN)
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    for t in range(k):
        logits, cache = decode(jp, {
            "tokens": jnp.asarray(ids[:, t:t + 1]),
            "cache_len": jnp.asarray(toks.shape[1] + t, jnp.int32)}, cache)
    return np.asarray(logits.astype(jnp.float32))


def test_bf16_smoke_model_serves_the_reference_greedy_ids():
    """The ids equal the reference's until the two packages' argmaxes part
    at a near tie: where they part, the port's pick is within the bf16
    noise of the two packages' logits (BF16_LOGIT_NOISE of the largest
    logit) of the reference's pick, on the reference's own logits."""
    jcfg, cfg = _bf16_smoke(jax_get_smoke), _bf16_smoke(get_smoke_config)
    jp, tp = zoo_weights(jcfg, cfg)
    # the reference's init keeps A_log, D and dt_bias fp32, the rest in
    # the model's dtype; the port's weights round the same values
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if getattr(path[-1], "key", None)
        in convert.FP32_LEAVES else jnp.asarray(x, jnp.bfloat16), jp)
    assert {t.dtype for t in tree_leaves(tp)} == {torch.bfloat16,
                                                  torch.float32}
    # the prompts of tests/test_torch_zamba2.py's serve test: two SSD chunks
    toks = np.random.default_rng(PROMPT).integers(
        0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    want = np.asarray(jserve.serve_batch(jcfg, jp, jnp.asarray(toks), GEN))
    got = serve.serve_batch(cfg, tp, torch.from_numpy(toks).long(),
                            GEN).numpy()
    assert got.shape == want.shape == (2, GEN)
    parted = np.nonzero((got != want).any(0))[0]
    if parted.size == 0:
        return
    k = int(parted[0])
    np.testing.assert_array_equal(got[:, :k], want[:, :k])
    logits = _reference_logits(jcfg, jp, toks, want, k)
    rows = np.arange(2)
    gap = logits[rows, want[:, k]] - logits[rows, got[:, k]]
    assert (gap <= BF16_LOGIT_NOISE * np.abs(logits).max()).all(), (k, gap)
