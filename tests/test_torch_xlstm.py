"""xLSTM-125M in the port against the JAX package, on the CPU: the mLSTM
and sLSTM blocks (`models/ssm.py`), the stack of both, and serving.

The smoke config in fp32 (one period, ("mlstm", "slstm"), d_model 128),
its weights from the reference's `zoo.init_params` through
`convert.zoo_from_jax`, with seeded noise on the leaves init leaves
constant (`_torch_common.zoo_weights`: the norm scales and the conv
bias).  Prompts of 128 and 127 tokens: a multiple of the smoke
`chunk_size` (64), where the reference's `_scan_chunked_remat` scans
checkpointed chunks, and one below it, where it falls back to the plain
scan; the port runs the steps in order for both.

Bars:
  * one cell, `_mlstm_cell` and `_slstm_cell`, chained over eight steps on
    seeded inputs with raw gates |i|, |f| up to 30, so the stabiliser's
    max takes either side: within rtol 1e-5 (atol 1e-6).  XLA's CPU code
    contracts f * C + i * (k v^T) into a fused multiply-add, and its exp,
    softplus, tanh and sigmoid differ from torch's in the last bit of some
    values, so the two are not bit for bit (ROADMAP queue 3);
  * `param_count` equal, at the smoke and the full config;
  * prefill's last logits within rtol 1e-4, atol 1e-5; every state leaf
    (C, n, m and the conv's; c, n, h, m) within 1e-5; four decode steps;
    greedy ids identical to the reference's `serve_batch`;
  * bf16: every leaf keeps the reference's dtype, and the bf16 smoke
    model's logits stay within 2.5e-2 of the largest, the bar of
    tests/test_torch_decode_bf16.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import flat, zoo_weights  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import convert, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import ssm, transformer, zoo  # noqa: E402

ARCH = "xlstm-125m"
FULL_PARAMS = 188_951_808
CELL_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = (128, 127)            # 2 smoke chunks of 64 (chunked), and not
STEPS, GEN = 4, 8
CELL_STEPS = 8
BF16_LOGIT_NOISE = 2.5e-2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(get, dtype="float32"):
    return dataclasses.replace(get(ARCH), dtype=dtype)


CFG, JCFG = smoke(get_smoke_config), smoke(jax_get_smoke)


@pytest.fixture(scope="module")
def weights():
    """(numpy params of the reference, the port's params)."""
    return zoo_weights(JCFG, CFG)


def prompts(n, length, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(n, length)).astype(np.int32)


def _gates(rng, *shape):
    """Raw gate pre-activations spread over [-30, 30]."""
    return rng.uniform(-30.0, 30.0, size=shape).astype(np.float32)


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"{what} {i}", **CELL_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mlstm_cell_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, H, dh = 2, 3, 32
    jcell = jax.jit(jssm._mlstm_cell)
    jcarry = (np.zeros((B, H, dh, dh), np.float32),
              np.zeros((B, H, dh), np.float32),
              np.full((B, H), -1e30, np.float32))
    carry = tuple(torch.from_numpy(c) for c in jcarry)
    took_i = took_f = 0
    for _ in range(CELL_STEPS):
        q, k, v = (rng.normal(size=(B, H, dh)).astype(np.float32)
                   for _ in range(3))
        i_raw, f_raw = _gates(rng, B, H), _gates(rng, B, H)
        # which side of max(log f + m, i) the stabiliser takes
        log_f = -np.logaddexp(-f_raw, 0.0)
        took_i += int((i_raw > log_f + np.asarray(jcarry[2])).sum())
        took_f += int((i_raw < log_f + np.asarray(jcarry[2])).sum())
        jcarry, jh = jcell(jcarry, (q, k, v, i_raw, f_raw))
        carry, h = ssm._mlstm_cell(carry, tuple(
            torch.from_numpy(a) for a in (q, k, v, i_raw, f_raw)))
        _close(carry, jcarry, "carry")
        _close([h], [jh], "h")
    assert took_i and took_f, (took_i, took_f)


def test_cpu_transcendentals_part_from_xla_in_the_last_bit(capsys):
    """Why the cells are not bit for bit (ROADMAP queue 3): on 10^6 draws
    from N(0, 4^2), torch's CPU softplus, tanh, exp and sigmoid give other
    last bits than XLA's on a share of them."""
    x = (np.random.default_rng(0).normal(size=10 ** 6) * 4) \
        .astype(np.float32)
    t = torch.from_numpy(x)
    pairs = {
        "softplus": (torch.nn.functional.softplus(t), jax.nn.softplus),
        "tanh": (torch.tanh(t), jnp.tanh),
        "exp": (torch.exp(t), jnp.exp),
        "sigmoid": (torch.sigmoid(t), jax.nn.sigmoid),
        "logaddexp(x, 0)": (torch.logaddexp(t, torch.zeros(())),
                            jax.nn.softplus)}
    shares = {name: float((got.numpy() != np.asarray(jax.jit(fn)(x)))
                          .mean()) for name, (got, fn) in pairs.items()}
    with capsys.disabled():
        print(f"\nshare of last bits torch's CPU != XLA's: {shares}")
    assert all(0.0 < v < 1.0 for v in shares.values()), shares


def test_xla_fuses_the_mlstm_matrix_update():
    """The jitted reference cell computes f·C + i·(k vᵀ) as fma(f, C,
    i·(k vᵀ)): an fp32 emulation of that (the product f·C unrounded)
    equals its C bit for bit, the two roundings the program writes do not
    (ROADMAP queue 3)."""
    rng = np.random.default_rng(0)
    B, H, dh = 2, 2, 128
    C = rng.normal(size=(B, H, dh, dh)).astype(np.float32)
    n = rng.normal(size=(B, H, dh)).astype(np.float32)
    m = (rng.normal(size=(B, H)) * 10).astype(np.float32)
    q, k, v = (rng.normal(size=(B, H, dh)).astype(np.float32)
               for _ in range(3))
    i_raw, f_raw = _gates(rng, B, H), _gates(rng, B, H)
    (want, _, _), _ = jax.jit(jssm._mlstm_cell)((C, n, m),
                                                (q, k, v, i_raw, f_raw))
    want = np.asarray(want)
    log_f = -np.asarray(jax.jit(jax.nn.softplus)(-f_raw))
    m_new = np.maximum(log_f + m, i_raw)
    i_g = np.asarray(jax.jit(jnp.exp)(i_raw - m_new))[..., None, None]
    f_g = np.asarray(jax.jit(jnp.exp)(log_f + m - m_new))[..., None, None]
    ikv = (i_g * (k[..., :, None] * v[..., None, :])).astype(np.float32)
    fused = (f_g.astype(np.float64) * C + ikv).astype(np.float32)
    rounded = (f_g * C).astype(np.float32) + ikv
    np.testing.assert_array_equal(fused, want)
    assert (rounded != want).sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slstm_cell_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, H, dh = 2, 3, 16
    r = (rng.normal(size=(H, dh, 4 * dh)) / np.sqrt(dh)).astype(np.float32)
    jcell = jax.jit(lambda c, g: jssm._slstm_cell(r, c, g, H, dh))
    jcarry = tuple(np.zeros((B, H, dh), np.float32) for _ in range(3)) \
        + (np.full((B, H, dh), -1e30, np.float32),)
    carry = tuple(torch.from_numpy(c) for c in jcarry)
    tr = torch.from_numpy(r)
    for _ in range(CELL_STEPS):
        g = np.concatenate([_gates(rng, B, H, 2, dh),
                            rng.normal(size=(B, H, 2, dh)).astype(np.float32)
                            * 3], axis=2).reshape(B, 4 * H * dh)
        jcarry = jcell(jcarry, g)
        carry = ssm._slstm_cell(tr, carry, torch.from_numpy(g), H, dh)
        _close(carry, jcarry, "carry")


def test_param_count_matches_jax(weights):
    jp, tp = weights
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == zoo.param_count(CFG) == jzoo.param_count(JCFG) == sum(
        np.size(x) for x in jax.tree.leaves(jp))
    full = get_config(ARCH)
    assert zoo.param_count(full) == jzoo.param_count(jax_get_config(ARCH)) \
        == FULL_PARAMS
    assert transformer.block_pattern(full) == ("mlstm", "mlstm", "mlstm",
                                               "slstm")
    assert flat(jp).keys() == flat(tp).keys()


@pytest.fixture(scope="module", params=PROMPTS)
def prefilled(request, weights):
    """Prefill of two prompts in both packages: (P, (jax logits, jax
    cache), (port logits, port cache))."""
    jp, tp = weights
    P = request.param
    toks = prompts(2, P)
    j = jax.jit(jsteps.make_prefill_step(JCFG))(jp, {"tokens":
                                                     jnp.asarray(toks)})
    t = steps.make_prefill_step(CFG)(tp, {"tokens":
                                          torch.from_numpy(toks).long()})
    return P, j, t


def test_prefill_last_logits_match_jax(prefilled):
    _, (jl, _), (tl, _) = prefilled
    assert tl.shape == (2, CFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_states_match_jax(prefilled):
    P, (_, jc), (_, tc) = prefilled
    want, got = flat(jc), flat(tc)
    assert got.keys() == want.keys() == {
        "/pattern/0/C", "/pattern/0/n", "/pattern/0/m", "/pattern/0/conv",
        "/pattern/1/c", "/pattern/1/n", "/pattern/1/h", "/pattern/1/m"}
    for path in want:
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **CACHE_TOL)
    # zoo.make_cache has the prefill's layout: zeros, m at -1e30
    made = flat(zoo.make_cache(CFG, 2, P, device="cpu"))
    jmade = flat(jzoo.make_cache(JCFG, 2, P))
    assert made.keys() == got.keys() == jmade.keys()
    for path, leaf in made.items():
        assert leaf.shape == got[path].shape == jmade[path].shape, path
        assert leaf.dtype == got[path].dtype, path
        np.testing.assert_array_equal(leaf, jmade[path], err_msg=path)


def test_decode_steps_match_jax(weights, prefilled):
    jp, tp = weights
    P, (jl, jc), (_, tc) = prefilled
    jc = jzoo.pad_cache(jc, STEPS)
    tc = zoo.pad_cache(tree_map(torch.clone, tc), STEPS)
    jdec = jax.jit(jsteps.make_decode_step(JCFG))
    tdec = steps.make_decode_step(CFG)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for t in range(STEPS):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(tok),
                             "cache_len": jnp.asarray(P + t, jnp.int32)}, jc)
        tlog, tc2 = tdec(tp, {"tokens": torch.from_numpy(tok).long(),
                              "cache_len": P + t}, tc)
        assert tc2 is tc                  # the states are updated in place
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    want, got = flat(jc), flat(tc)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, err_msg=path,
                                   **CACHE_TOL)


@pytest.mark.parametrize("prompt_len", PROMPTS)
def test_serve_batch_matches_jax_greedy_ids(weights, prompt_len):
    jp, tp = weights
    toks = prompts(2, prompt_len, seed=1)
    want = jserve.serve_batch(JCFG, jp, jnp.asarray(toks), GEN)
    got = serve.serve_batch(CFG, tp, torch.from_numpy(toks).long(), GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_main_runs_the_smoke_config_on_the_cpu(capsys):
    gen = serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                      "--prompt-len", "16", "--gen-len", "4",
                      "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert int(gen.min()) >= 0 and int(gen.max()) < CFG.vocab_size
    assert f"arch={ARCH} on cpu: served 2 requests" \
        in capsys.readouterr().out


def _by_path(tree):
    """{"/path/to/leaf": tensor} of a port tree (tensors kept as they
    are)."""
    paths = flat(tree_map(lambda t: torch.zeros(()), tree))
    return dict(zip(paths, tree_leaves(tree)))


def test_bf16_leaves_keep_the_reference_dtypes(weights):
    """Every leaf of the bf16 model is bf16, as in the reference (the
    recurrent weight r too: cast to fp32 inside each step), converted or
    drawn by the port's own init; the states are fp32 but the conv's."""
    jp, _ = weights
    cfg16, jcfg16 = smoke(get_smoke_config, "bfloat16"), \
        smoke(jax_get_smoke, "bfloat16")
    converted = _by_path(convert.zoo_from_jax(jp, cfg16, device="cpu"))
    drawn = _by_path(zoo.init_params(cfg16, 0, device="cpu"))
    jdrawn = flat(jax.tree.map(
        lambda s: np.zeros((), s.dtype), jax.eval_shape(
            lambda k: jzoo.init_params(jcfg16, k), jax.random.PRNGKey(0))))
    assert converted.keys() == drawn.keys() == jdrawn.keys()
    for path, leaf in converted.items():
        want = torch.float32 if jdrawn[path].dtype == np.float32 \
            else torch.bfloat16
        assert leaf.dtype == drawn[path].dtype == want, path
        assert leaf.shape == drawn[path].shape, path
    assert {p for p in converted if p.endswith("/r")} == {
        "/stack/pattern/1/slstm/r"}
    states = _by_path(zoo.make_cache(cfg16, 2, 8, device="cpu"))
    jstates = flat(jax.tree.map(
        lambda s: np.zeros((), s.dtype),
        jax.eval_shape(lambda: jzoo.make_cache(jcfg16, 2, 8))))
    for path, leaf in states.items():
        want = torch.float32 if jstates[path].dtype == np.float32 \
            else torch.bfloat16
        assert leaf.dtype == want, path


def test_bf16_smoke_logits_within_the_bf16_noise(weights):
    """The bf16 smoke model (weights rounded to bf16 in both packages):
    prefill's last logits and two decode steps fed the reference's tokens
    within BF16_LOGIT_NOISE of the largest logit."""
    jp, _ = weights
    cfg16, jcfg16 = smoke(get_smoke_config, "bfloat16"), \
        smoke(jax_get_smoke, "bfloat16")
    jp16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jp)
    tp16 = convert.zoo_from_jax(jp, cfg16, device="cpu")
    toks = prompts(2, 64, seed=2)
    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg16))(
        jp16, {"tokens": jnp.asarray(toks)})
    tl, tc = steps.make_prefill_step(cfg16)(
        tp16, {"tokens": torch.from_numpy(toks).long()})
    jdec = jax.jit(jsteps.make_decode_step(jcfg16))
    tdec = steps.make_decode_step(cfg16)
    for t in range(3):
        want = np.asarray(jnp.asarray(jl, jnp.float32))
        got = tl.float().numpy()
        assert np.isfinite(got).all()
        gap = np.abs(got - want).max()
        assert gap <= BF16_LOGIT_NOISE * np.abs(want).max(), (t, gap)
        if t == 2:
            break
        tok = np.argmax(want, -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp16, {"tokens": jnp.asarray(tok),
                             "cache_len": jnp.asarray(64 + t, jnp.int32)},
                      jc)
        tl, tc = tdec(tp16, {"tokens": torch.from_numpy(tok).long(),
                             "cache_len": 64 + t}, tc)


def test_block_dispatch_refuses_what_it_does_not_serve(weights):
    _, tp = weights
    x = torch.zeros(1, 4, CFG.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="mlstmx"):
        transformer.block_init(torch.Generator().manual_seed(0), CFG,
                               "mlstmx", torch.float32)
    with pytest.raises(ValueError, match="mlstmx"):
        transformer.block_make_cache(CFG, "mlstmx", 1, 4, torch.float32)
    bm = tree_map(lambda t: t[0], tp["stack"]["pattern"][0])
    bs = tree_map(lambda t: t[0], tp["stack"]["pattern"][1])
    with pytest.raises(ValueError, match="mlstmx"):
        transformer.block_apply(bm, CFG, "mlstmx", x, pos, mode="prefill")
    for kind, bp in (("mlstm", bm), ("slstm", bs)):
        with pytest.raises(ValueError, match="one token and a state"):
            transformer.block_apply(bp, CFG, kind, x, pos, mode="decode")
