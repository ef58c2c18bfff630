"""The audio and VLM front ends in the port against the JAX package, on the
CPU: MusicGen-medium (four codebook streams in, four heads out, or the
stub EnCodec front end's frame embeddings in) and InternVL2-2B (the stub
vision encoder's patch embeddings prepended to the text, then text
decode).

Each smoke config in fp32, its weights from the reference's
`zoo.init_params` through `convert.zoo_from_jax`, with seeded noise on the
leaves init leaves constant (`_torch_common.zoo_weights`).  Bars, those of
tests/test_torch_attn_models.py: `param_count` equal, at the smoke and
the full configs; prefill's last logits within rtol 1e-4, atol 1e-5
(MusicGen's (B, K, V), one row a codebook); every cache leaf within 1e-5;
four decode steps; MusicGen's greedy ids identical to the reference's
`serve_batch` (the argmax per codebook, the first codebook's kept and fed
back on all four).  In bf16 every leaf keeps the reference's dtype, and
MusicGen's four-codebook embedding sum equals the reference's bit for bit
(both sum in fp32 and round once; four bf16 additions in turn would part
on about a third of the values).
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
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import convert, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

AUDIO, VLM = "musicgen-medium", "internvl2-2b"
FULL_PARAMS = {AUDIO: 1_384_269_312, VLM: 1_889_634_304}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, STEPS, GEN = 32, 4, 8
# the batch key MusicGen's prefill reads
AUDIO_INPUTS = ("tokens_mc", "input_embeds")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(get, arch, dtype="float32"):
    return dataclasses.replace(get(arch), dtype=dtype)


@pytest.fixture(scope="module", params=(AUDIO, VLM))
def model(request):
    """(arch, jax cfg, port cfg, numpy params, port params), fp32 smoke."""
    arch = request.param
    jcfg, cfg = smoke(jax_get_smoke, arch), smoke(get_smoke_config, arch)
    jp, tp = zoo_weights(jcfg, cfg)
    return arch, jcfg, cfg, jp, tp


def _batch(cfg, kind, n, length, seed=0):
    """(jax batch, port batch) of seeded inputs: token ids, K codebook
    streams, frame embeddings, or P patch embeddings before the text."""
    rng = np.random.default_rng(seed)
    if kind == "tokens_mc":
        ids = rng.integers(0, cfg.vocab_size,
                           size=(n, length, cfg.num_codebooks))
        arrs = {kind: ids.astype(np.int32)}
    elif kind == "input_embeds":
        arrs = {kind: rng.normal(size=(n, length, cfg.d_model))
                .astype(np.float32)}
    else:
        arrs = {"tokens": rng.integers(0, cfg.vocab_size, size=(n, length))
                .astype(np.int32)}
        if kind == "patch_embeds":
            arrs[kind] = rng.normal(size=(n, cfg.num_prefix_tokens,
                                          cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v) for k, v in arrs.items()})


def _prefill_inputs(cfg):
    return AUDIO_INPUTS if cfg.modality == "audio_tokens" \
        else ("patch_embeds", "tokens")


def test_param_count_matches_jax(model):
    arch, jcfg, cfg, jp, tp = model
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == zoo.param_count(cfg) == jzoo.param_count(jcfg) == sum(
        np.size(x) for x in jax.tree.leaves(jp))
    assert zoo.param_count(get_config(arch)) \
        == jzoo.param_count(jax_get_config(arch)) == FULL_PARAMS[arch]
    assert flat(jp).keys() == flat(tp).keys()
    if cfg.modality == "audio_tokens":
        kv = cfg.num_codebooks * 256
        assert tp["embed"]["w"].shape == (kv, cfg.d_model)
        assert tp["heads"]["w"].shape == (cfg.d_model, kv)


@pytest.fixture(scope="module", params=(0, 1))
def prefilled(request, model):
    """Prefill through each of the model's inputs (MusicGen: tokens_mc,
    input_embeds; InternVL2: patch_embeds + tokens, tokens alone) of two
    sequences of PROMPT: (kind, P, (jax logits, jax cache), (port logits,
    port cache))."""
    _, jcfg, cfg, jp, tp = model
    kind = _prefill_inputs(cfg)[request.param]
    jb, tb = _batch(cfg, kind, 2, PROMPT)
    j = jax.jit(jsteps.make_prefill_step(jcfg))(jp, jb)
    t = steps.make_prefill_step(cfg)(tp, tb)
    P = PROMPT + (cfg.num_prefix_tokens if kind == "patch_embeds" else 0)
    return kind, P, j, t


def test_prefill_last_logits_match_jax(model, prefilled):
    _, _, cfg, _, _ = model
    _, _, (jl, _), (tl, _) = prefilled
    want = (2, cfg.num_codebooks, cfg.vocab_size) \
        if cfg.modality == "audio_tokens" else (2, cfg.vocab_size)
    assert tl.shape == want == np.shape(jl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_cache_matches_jax(model, prefilled):
    _, jcfg, cfg, _, _ = model
    _, P, (_, jc), (_, tc) = prefilled
    want, got = flat(jc), flat(tc)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].shape == want[path].shape, path
        assert got[path].shape[-3] == P, path          # (.., B, S, KV, Dh)
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **CACHE_TOL)
    made = flat(zoo.make_cache(cfg, 2, P, device="cpu"))
    jmade = flat(jzoo.make_cache(jcfg, 2, P))
    assert made.keys() == got.keys() == jmade.keys()
    for path, leaf in made.items():
        assert leaf.shape == got[path].shape == jmade[path].shape, path
        assert leaf.dtype == got[path].dtype and not leaf.any(), path


def _step_inputs(cfg, tok):
    """(jax, port) decode inputs of the (B,) token ids `tok`: an audio
    model's on all K codebooks."""
    if cfg.modality == "audio_tokens":
        ids = np.broadcast_to(tok[:, None, None],
                              (len(tok), 1, cfg.num_codebooks))
        ids = np.ascontiguousarray(ids)
        return ({"tokens_mc": jnp.asarray(ids)},
                {"tokens_mc": torch.from_numpy(ids).long()})
    return ({"tokens": jnp.asarray(tok[:, None])},
            {"tokens": torch.from_numpy(tok[:, None]).long()})


def test_decode_steps_match_jax(model, prefilled):
    _, jcfg, cfg, jp, tp = model
    _, P, (jl, jc), (_, tc) = prefilled
    jc = jzoo.pad_cache(jc, STEPS)
    tc = zoo.pad_cache(tree_map(torch.clone, tc), STEPS)
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    tdec = steps.make_decode_step(cfg)
    jlog = jl
    for t in range(STEPS):
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        if tok.ndim > 1:                     # audio: the first codebook
            tok = tok[:, 0]
        jb, tb = _step_inputs(cfg, tok)
        jlog, jc = jdec(jp, dict(jb, cache_len=jnp.asarray(P + t,
                                                           jnp.int32)), jc)
        tlog, tc = tdec(tp, dict(tb, cache_len=P + t), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
    want, got = flat(jc), flat(tc)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, err_msg=path,
                                   **CACHE_TOL)


def test_greedy_decode_keeps_the_first_codebook(model, prefilled):
    """greedy=True gives the reference's greedy ids: an audio model's argmax
    per codebook, codebook 0 kept."""
    _, jcfg, cfg, jp, tp = model
    _, P, (jl, jc), (_, tc) = prefilled
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    if tok.ndim > 1:
        tok = tok[:, 0]
    jb, tb = _step_inputs(cfg, tok)
    want, _ = jax.jit(jsteps.make_decode_step(jcfg, greedy=True))(
        jp, dict(jb, cache_len=jnp.asarray(P, jnp.int32)),
        jzoo.pad_cache(jc, 1))
    got, _ = steps.make_decode_step(cfg, greedy=True)(
        tp, dict(tb, cache_len=P), zoo.pad_cache(tree_map(torch.clone, tc),
                                                 1))
    assert got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_audio_serve_batch_matches_jax_greedy_ids():
    jcfg, cfg = smoke(jax_get_smoke, AUDIO), smoke(get_smoke_config, AUDIO)
    jp, tp = zoo_weights(jcfg, cfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    want = jserve.serve_batch(jcfg, jp, jnp.asarray(toks), GEN)
    got = serve.serve_batch(cfg, tp, torch.from_numpy(toks).long(), GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vlm_positions_run_over_the_patches_and_the_text():
    jcfg, cfg = smoke(jax_get_smoke, VLM), smoke(get_smoke_config, VLM)
    jp, tp = zoo_weights(jcfg, cfg)
    jb, tb = _batch(cfg, "patch_embeds", 2, 8)
    h, pos = zoo._embed_inputs(tp, cfg, tb)
    jh, jpos = jzoo._embed_inputs(jp, jcfg, jb)
    P = cfg.num_prefix_tokens
    assert h.shape == (2, P + 8, cfg.d_model)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(h[:, :P].numpy(), tb["patch_embeds"])


def test_serve_main_serves_audio_and_refuses_the_vlm(capsys):
    gen = serve.main(["--arch", AUDIO, "--smoke", "--requests", "2",
                      "--prompt-len", "16", "--gen-len", "4",
                      "--device", "cpu"])
    assert gen.shape == (2, 4)
    vocab = get_smoke_config(AUDIO).vocab_size
    assert int(gen.min()) >= 0 and int(gen.max()) < vocab
    assert f"arch={AUDIO} on cpu: served 2 requests" \
        in capsys.readouterr().out
    with pytest.raises(SystemExit, match="serve demo supports text/audio "
                                         "archs; VLM decode is exercised "
                                         "via the dry-run"):
        serve.main(["--arch", VLM, "--smoke", "--device", "cpu"])


def _by_path(tree):
    paths = flat(tree_map(lambda t: torch.zeros(()), tree))
    return dict(zip(paths, tree_leaves(tree)))


@pytest.mark.parametrize("arch", (AUDIO, VLM))
def test_bf16_leaves_keep_the_reference_dtypes(arch):
    cfg16 = smoke(get_smoke_config, arch, "bfloat16")
    jcfg16 = smoke(jax_get_smoke, arch, "bfloat16")
    jshapes = jax.eval_shape(lambda k: jzoo.init_params(jcfg16, k),
                             jax.random.PRNGKey(0))
    jdrawn = flat(jax.tree.map(lambda s: np.zeros((), s.dtype), jshapes))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jshapes)
    converted = _by_path(convert.zoo_from_jax(zeros, cfg16, device="cpu"))
    drawn = _by_path(zoo.init_params(cfg16, 0, device="cpu"))
    assert converted.keys() == drawn.keys() == jdrawn.keys()
    for path, leaf in converted.items():
        want = torch.float32 if jdrawn[path].dtype == np.float32 \
            else torch.bfloat16
        assert leaf.dtype == drawn[path].dtype == want, path
        assert leaf.shape == drawn[path].shape, path


def test_bf16_codebook_embedding_sum_equals_the_reference():
    """The four codebooks' bf16 embeddings summed: the reference's sum (jit
    and eager) and the port's are bit for bit equal; summing in turn in
    bf16 would part on about a third of the values."""
    cfg16 = smoke(get_smoke_config, AUDIO, "bfloat16")
    jcfg16 = smoke(jax_get_smoke, AUDIO, "bfloat16")
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: jzoo.init_params(jcfg16, k))(jax.random.PRNGKey(0)))
    tp = convert.zoo_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jp), cfg16,
        device="cpu")
    jb, tb = _batch(cfg16, "tokens_mc", 4, 64)
    got = zoo._embed_inputs(tp, cfg16, tb)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for fn in (jzoo._embed_inputs, jax.jit(jzoo._embed_inputs,
                                           static_argnums=1)):
        want = np.asarray(jnp.asarray(fn(jp, jcfg16, jb)[0], jnp.float32))
        differ = int((got != want).sum())
        print(f"bf16 codebook sums that differ: {differ} of {want.size}")
        assert differ == 0
    rows = tp["embed"]["w"][tb["tokens_mc"]
                            + torch.arange(4) * 256]   # (B, S, K, d)
    in_turn = rows[:, :, 0]
    for k in range(1, 4):
        in_turn = in_turn + rows[:, :, k]
    assert (in_turn.float().numpy() != want).mean() > 0.2
