"""The attention-block transformers in the port against the JAX package, on
the CPU: Llama-3.2-1B, Qwen1.5-4B, StarCoder2-3B, CodeQwen1.5-7B (dense),
Arctic-480B (MoE beside a dense residual MLP) and DeepSeek-V2-236B (MLA,
MoE with shared experts, a dense pre-layer).

Each smoke config in fp32, its weights from the reference's
`zoo.init_params` through `convert.zoo_from_jax`, with seeded noise on the
leaves init leaves constant (`_torch_common.zoo_weights`: the norm scales,
q_norm and kv_norm among them, and the QKV biases), so a dropped bias or a
swapped leaf cannot pass.  Bars, those of tests/test_torch_zamba2.py:
prefill's last logits within rtol 1e-4, atol 1e-5; every cache leaf within
1e-5; four decode steps; greedy ids identical to the reference's
`serve_batch`; `param_count` equal, also `active_only` and at the full
configs.

bf16, Llama's smoke model against the reference's intermediates on the
same bf16 inputs:
  * `rmsnorm`, rope and the activations (silu, the tanh gelu) equal the
    reference's bit for bit: jax.nn.silu rounds each of its four ops to
    bf16, and so does the port's `layers.silu` (torch's F.silu rounds once,
    which made about a third of the MLP's bf16 activations differ);
  * a bf16 `dense` parts from the reference only where the two fp32
    accumulation orders (torch's CPU GEMM, XLA's dot) round to neighbouring
    bf16 values: at most DENSE_PARTED of the outputs, by one bf16 ulp;
  * the block equals the reference's block run eagerly (on this input bit
    for bit: the dense noise did not reach it); the reference's
    jitted block feeds the FFN's norm the unrounded fp32 x + h (XLA's
    excess precision across the fusion), which the port reproduces bit for
    bit only when given that fp32 sum: a fact of the reference's compiler;
  * bf16 GQA decode attention at g = H/KV = 4: XLA's CPU dot sums the
    scores and PV of g > 1 query heads in another order than the
    sequential one the port follows (ROADMAP queue 3, F1), and a score
    that differs in its last fp32 bit can flip its weight's bf16 rounding:
    at most GQA_DECODE_PARTED of the outputs differ, by at most 2^-7 of
    the largest |output| (measured by tests/_torch_bf16_bisect.py: 20, 0
    and 12 of 8192, at most 9.8e-4 at max |o| 0.51, seeds 0-2);
  * the greedy ids of `serve_batch` equal the reference's until a parting
    at a near tie (within the bf16 noise between the packages, 2.5e-2 of
    the largest logit, the bar of tests/test_torch_decode_bf16.py).
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
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import convert, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCHS = ("llama3.2-1b", "qwen1.5-4b", "starcoder2-3b", "codeqwen1.5-7b",
         "arctic-480b", "deepseek-v2-236b")
FULL_PARAMS = {"llama3.2-1b": (1_235_814_400, 1_235_814_400),
               "qwen1.5-4b": (3_950_369_280, 3_950_369_280),
               "starcoder2-3b": (3_180_625_920, 3_180_625_920),
               "codeqwen1.5-7b": (8_190_038_016, 8_190_038_016),
               "arctic-480b": (476_850_275_328, 15_584_314_368),
               "deepseek-v2-236b": (235_741_434_880, 21_375_800_320)}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, STEPS, GEN = 32, 4, 8
BF16_LOGIT_NOISE = 2.5e-2
DENSE_PARTED = 1e-3
GQA_DECODE_PARTED = 1e-2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(get, arch, dtype="float32"):
    return dataclasses.replace(get(arch), dtype=dtype)


def prompts(cfg, n, length, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(n, length)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, jax cfg, port cfg, numpy params, port params), fp32 smoke."""
    arch = request.param
    jcfg, cfg = smoke(jax_get_smoke, arch), smoke(get_smoke_config, arch)
    jp, tp = zoo_weights(jcfg, cfg)
    return arch, jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def prefilled(model):
    """Prefill of two prompts of PROMPT in both packages:
    ((jax logits, jax cache), (port logits, port cache))."""
    _, jcfg, cfg, jp, tp = model
    toks = prompts(cfg, 2, PROMPT)
    j = jax.jit(jsteps.make_prefill_step(jcfg))(jp, {"tokens":
                                                     jnp.asarray(toks)})
    t = steps.make_prefill_step(cfg)(tp, {"tokens":
                                          torch.from_numpy(toks).long()})
    return j, t


def test_param_count_matches_jax(model):
    arch, jcfg, cfg, jp, tp = model
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == zoo.param_count(cfg) == jzoo.param_count(jcfg) == sum(
        np.size(x) for x in jax.tree.leaves(jp))
    assert zoo.param_count(cfg, active_only=True) \
        == jzoo.param_count(jcfg, active_only=True)
    full, jfull = get_config(arch), jax_get_config(arch)
    want = (jzoo.param_count(jfull), jzoo.param_count(jfull, True))
    assert (zoo.param_count(full), full.active_param_count()) == want \
        == FULL_PARAMS[arch]
    assert flat(jp).keys() == flat(tp).keys()


def _by_path(tree):
    """{"/path/to/leaf": tensor} of a port tree (`flat`'s paths, tensors
    kept as they are)."""
    paths = flat(tree_map(lambda t: torch.zeros(()), tree))
    return dict(zip(paths, tree_leaves(tree)))


def test_bf16_leaves_keep_the_reference_dtypes(model):
    """In a bf16 model the MoE router stays fp32, as the reference draws
    it, converted or drawn by the port's own init; every other leaf is
    bf16."""
    arch, jcfg, cfg, jp, _ = model
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    converted = _by_path(convert.zoo_from_jax(jp, cfg16, device="cpu"))
    drawn = _by_path(zoo.init_params(cfg16, 0, device="cpu"))
    jdrawn = flat(jax.tree.map(
        lambda s: np.zeros((), s.dtype), jax.eval_shape(
            lambda k: jzoo.init_params(
                dataclasses.replace(jcfg, dtype="bfloat16"), k),
            jax.random.PRNGKey(0))))
    assert converted.keys() == drawn.keys() == jdrawn.keys()
    for path, leaf in converted.items():
        want = torch.float32 if jdrawn[path].dtype == np.float32 \
            else torch.bfloat16
        assert leaf.dtype == drawn[path].dtype == want, path
        assert leaf.shape == drawn[path].shape, path
    assert any(p.endswith("/router/w") for p in converted) == cfg.is_moe


def test_prefill_last_logits_match_jax(model, prefilled):
    _, _, cfg, _, _ = model
    (jl, _), (tl, _) = prefilled
    assert tl.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_cache_matches_jax(model, prefilled):
    _, jcfg, cfg, _, _ = model
    (_, jc), (_, tc) = prefilled
    want, got = flat(jc), flat(tc)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **CACHE_TOL)
    # zoo.make_cache has the prefill cache's layout (zeros)
    made = flat(zoo.make_cache(cfg, 2, PROMPT, device="cpu"))
    jmade = flat(jzoo.make_cache(jcfg, 2, PROMPT))
    assert made.keys() == got.keys() == jmade.keys()
    for path, leaf in made.items():
        assert leaf.shape == got[path].shape == jmade[path].shape, path
        assert leaf.dtype == got[path].dtype and not leaf.any(), path


def test_decode_steps_match_jax(model, prefilled):
    _, jcfg, cfg, jp, tp = model
    (jl, jc), (_, tc) = prefilled
    jc = jzoo.pad_cache(jc, STEPS)
    tc = zoo.pad_cache(tree_map(torch.clone, tc), STEPS)
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    tdec = steps.make_decode_step(cfg)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for t in range(STEPS):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(tok),
                             "cache_len": jnp.asarray(PROMPT + t,
                                                      jnp.int32)}, jc)
        tlog, tc = tdec(tp, {"tokens": torch.from_numpy(tok).long(),
                             "cache_len": PROMPT + t}, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    want, got = flat(jc), flat(tc)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, err_msg=path,
                                   **CACHE_TOL)


def test_serve_batch_matches_jax_greedy_ids(model):
    _, jcfg, cfg, jp, tp = model
    toks = prompts(cfg, 2, PROMPT, seed=1)
    want = jserve.serve_batch(jcfg, jp, jnp.asarray(toks), GEN)
    got = serve.serve_batch(cfg, tp, torch.from_numpy(toks).long(), GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,argv", [
    ("llama3.2-1b", ["--requests", "1"]),
    ("deepseek-v2-236b", ["--requests", "2", "--prompt-len", "16"])])
def test_serve_main_runs_the_smoke_config_on_the_cpu(capsys, arch, argv):
    gen = serve.main(["--arch", arch, "--smoke", "--gen-len", "4",
                      "--device", "cpu"] + argv)
    n = int(argv[1])
    assert gen.shape == (n, 4)
    vocab = get_smoke_config(arch).vocab_size
    assert int(gen.min()) >= 0 and int(gen.max()) < vocab
    assert f"arch={arch} on cpu: served {n} requests" \
        in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_is_the_reference_tanh_form(dtype):
    """StarCoder2's plain 2-layer MLP with jax.nn.gelu's default (tanh)
    form: the same weights and inputs give the reference's output (fp32
    within 1e-6; bf16 bit for bit), and torch's exact-erf default would
    not."""
    rng = np.random.default_rng(3)
    jdt = getattr(jnp, dtype)
    jp = {"wi": {"w": jnp.asarray(rng.normal(size=(64, 96)) / 8, jdt)},
          "wo": {"w": jnp.asarray(rng.normal(size=(96, 64)) / 10, jdt)}}
    x = jnp.asarray(rng.normal(size=(3, 5, 64)), jdt)
    want = np.asarray(jax.jit(lambda p, x: jlayers.mlp(p, x, act="gelu"))(
        jp, x).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(tdt), jp)
    tx = torch.from_numpy(np.array(x, np.float32)).to(tdt)
    got = layers.mlp(tp, tx, act="gelu")
    assert set(layers.mlp_init(torch.Generator().manual_seed(0), 8, 16,
                               act="gelu")) == {"wi", "wo"}
    assert layers.mlp_param_count(8, 16, "gelu") == 2 * 8 * 16
    # what the activation alone gives, on the same pre-activations
    pre = torch.from_numpy(np.array(jlayers.dense(jp["wi"], x),
                                    np.float32)).to(tdt)
    want_act = np.asarray(jax.jit(jax.nn.gelu)(jlayers.dense(jp["wi"], x))
                          .astype(jnp.float32))
    got_act = layers.gelu_tanh(pre).float().numpy()
    erf = torch.nn.functional.gelu(pre.float()).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_act, want_act, rtol=1e-6, atol=1e-6)
        assert np.abs(erf - want_act).max() > 1e-4
    else:
        np.testing.assert_array_equal(got_act, want_act)


# ---------------------------------------------------------------------------
# bf16: Llama-3.2-1B's smoke model against the reference's intermediates
# ---------------------------------------------------------------------------

LLAMA = "llama3.2-1b"


def _bf16_weights():
    jcfg = smoke(jax_get_smoke, LLAMA, "bfloat16")
    cfg = smoke(get_smoke_config, LLAMA, "bfloat16")
    jp, tp = zoo_weights(jcfg, cfg)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jp)
    return jcfg, cfg, jp, tp


def _t(x):
    """A jax bf16 array as a torch bf16 tensor (through fp32, exact)."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))) \
        .to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _parted(got, want):
    """(fraction of entries that differ, their largest gap in bf16 ulps)."""
    got, want = _np(got), _np(want)
    differ = got != want
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32)) >> 16
    return differ.mean(), int(ulps.max())


def test_bf16_llama_layers_round_as_the_reference():
    jcfg, cfg, jp, tp = _bf16_weights()
    jb = jax.tree.map(lambda t: t[0], jp["stack"]["pattern"][0])
    tb = tree_map(lambda t: t[0], tp["stack"]["pattern"][0])
    B, S = 2, 32
    xj = jnp.asarray(np.random.default_rng(0).normal(
        size=(B, S, cfg.d_model)), jnp.bfloat16)
    x = _t(xj)
    pos_j = jnp.broadcast_to(jnp.arange(S), (B, S))
    pos = torch.arange(S).expand(B, S)
    # rmsnorm: bit for bit
    hj = jax.jit(lambda p, x: jlayers.rmsnorm(p, x, jcfg.norm_eps))(
        jb["attn_norm"], xj)
    np.testing.assert_array_equal(
        _np(layers.rmsnorm(tb["attn_norm"], x, cfg.norm_eps)), _np(hj))
    h = _t(hj)
    # every dense: parted only by the fp32 accumulation order, one ulp
    denses = [(tb["attn"][n], jb["attn"][n], h, hj)
              for n in ("wq", "wk", "wv")]
    aj = jlayers.dense(jb["mlp"]["wi"], hj)
    gj = jlayers.dense(jb["mlp"]["wg"], hj)
    actj = jax.nn.silu(aj) * gj
    denses += [(tb["mlp"]["wi"], jb["mlp"]["wi"], h, hj),
               (tb["mlp"]["wg"], jb["mlp"]["wg"], h, hj),
               (tb["mlp"]["wo"], jb["mlp"]["wo"], _t(actj), actj)]
    for tw, jw, xi, xij in denses:
        frac, ulps = _parted(layers.dense(tw, xi),
                             jax.jit(jlayers.dense)(jw, xij))
        assert frac <= DENSE_PARTED and ulps <= 1, (frac, ulps)
    # rope and the activation on the same inputs: bit for bit
    qj = jlayers.dense(jb["attn"]["wq"], hj).reshape(B, S, 4, 32)
    np.testing.assert_array_equal(
        _np(layers.apply_rope(_t(qj), pos, cfg.rope_theta)),
        _np(jax.jit(lambda q: jlayers.apply_rope(q, pos_j,
                                                 jcfg.rope_theta))(qj)))
    np.testing.assert_array_equal(
        _np(layers.silu(_t(aj)) * _t(gj)),
        _np(jax.jit(lambda a, g: jax.nn.silu(a) * g)(aj, gj)))
    frac_once, _ = _parted(torch.nn.functional.silu(_t(aj)) * _t(gj), actj)
    assert frac_once > 0.2          # the one-rounding silu parts widely
    # the attention (prefill) on the same input: bit for bit
    np.testing.assert_array_equal(
        _np(attention.gqa_apply(tb["attn"], cfg, h, pos, mode="prefill")[0]),
        _np(jax.jit(lambda p, x: jattention.gqa_apply(
            p, jcfg, x, pos_j, mode="prefill")[0])(jb["attn"], hj)))

    # the block: the reference's eager block, within the dense noise
    def jblock(p, x):
        return jtransformer._attn_block_apply(
            p, jcfg, x, pos_j, mode="prefill", cache=None, cache_len=None,
            use_moe=False)[0]
    got = transformer._attn_block_apply(
        tb, cfg, x, pos, mode="prefill", cache=None, cache_len=None,
        use_moe=False)[0]
    frac, ulps = _parted(got, jblock(jb, xj))
    assert frac <= DENSE_PARTED and ulps <= 1, (frac, ulps)

    # the jitted reference feeds the FFN norm the unrounded fp32 x + h
    def jffn_norm(p, x):
        hh, _ = jattention.gqa_apply(
            p["attn"], jcfg, jlayers.rmsnorm(p["attn_norm"], x,
                                             jcfg.norm_eps),
            pos_j, mode="prefill")
        return jlayers.rmsnorm(p["ffn_norm"], x + hh, jcfg.norm_eps)
    hh, _ = attention.gqa_apply(tb["attn"], cfg, h, pos, mode="prefill")
    rounded = layers.rmsnorm(tb["ffn_norm"], x + hh, cfg.norm_eps)
    unrounded = layers.rmsnorm(tb["ffn_norm"], x.float() + hh.float(),
                               cfg.norm_eps).to(torch.bfloat16)
    want_jit = jax.jit(jffn_norm)(jb, xj)
    np.testing.assert_array_equal(_np(unrounded), _np(want_jit))
    np.testing.assert_array_equal(_np(rounded), _np(jffn_norm(jb, xj)))
    assert _parted(rounded, want_jit)[0] > 0.05


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_gqa_decode_attention_meets_the_xla_order_bar(seed):
    """B=4, H=32, KV=8 (g = 4, Llama-3.2-1B's heads), Dh=64, a cache of
    544 with 300 valid entries."""
    B, H, KV, Dh, W, n = 4, 32, 8, 64, 544, 300
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.normal(size=s), jnp.bfloat16) for s in
            ((B, 1, H, Dh), (B, W, KV, Dh), (B, W, KV, Dh), (B, 1, KV, Dh),
             (B, 1, KV, Dh))]
    want = _np(jax.jit(lambda q, kc, vc, kn, vn: jattention.decode_attention(
        q, kc, vc, n, kn, vn))(*arrs))
    got = _np(attention.decode_attention(*(_t(a) for a in arrs[:3]), n,
                                         _t(arrs[3]), _t(arrs[4])))
    differ = got != want
    assert differ.mean() <= GQA_DECODE_PARTED, int(differ.sum())
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def _reference_logits(jcfg, jp, toks, ids, k):
    """The reference's logits for generated position k of `ids` (k = 0:
    the prefill's last logits), teacher-forced on ids[:, :k]."""
    logits, cache = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    cache = jzoo.pad_cache(cache, ids.shape[1])
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    for t in range(k):
        logits, cache = decode(jp, {
            "tokens": jnp.asarray(ids[:, t:t + 1]),
            "cache_len": jnp.asarray(toks.shape[1] + t, jnp.int32)}, cache)
    return np.asarray(logits.astype(jnp.float32))


def test_bf16_llama_serves_the_reference_greedy_ids():
    """2 prompts of 64, 16 tokens: the ids equal the reference's until the
    two packages' argmaxes part at a near tie, where the port's pick is
    within BF16_LOGIT_NOISE of the largest logit of the reference's pick,
    on the reference's own logits."""
    jcfg, cfg, jp, tp = _bf16_weights()
    toks = prompts(cfg, 2, 64, seed=64)
    gen = 16
    want = np.asarray(jserve.serve_batch(jcfg, jp, jnp.asarray(toks), gen))
    got = serve.serve_batch(cfg, tp, torch.from_numpy(toks).long(),
                            gen).numpy()
    assert got.shape == want.shape == (2, gen)
    parted = np.nonzero((got != want).any(0))[0]
    if parted.size == 0:
        return
    k = int(parted[0])
    np.testing.assert_array_equal(got[:, :k], want[:, :k])
    logits = _reference_logits(jcfg, jp, toks, want, k)
    rows = np.arange(2)
    gap = logits[rows, want[:, k]] - logits[rows, got[:, k]]
    assert (gap <= BF16_LOGIT_NOISE * np.abs(logits).max()).all(), (k, gap)
