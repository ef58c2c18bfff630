"""Zamba2 serving in the port against the JAX package, on the CPU.

The Zamba2-2.7B smoke config in fp32 with num_layers=4 (two periods of
("mamba", "mamba+shared_attn"), so the stacked per-period leaves and the
shared attention block's reuse are both exercised).  Weights come from the
reference's `zoo.init_params` and reach the port through
`convert.zoo_from_jax`; the leaves that init leaves constant (A_log, D,
dt_bias, the norm scales, the conv biases) get seeded numpy noise first,
so a wrong per-head broadcast or a swapped leaf cannot pass.  So do the
per-layer adapters, drawn N(0, 1/d_model) in place of init's 1e-4 scale,
so the shared attention block moves the logits as much as a Mamba2 layer.

Bars: prefill's last logits within rtol 1e-4, atol 1e-5; every cache leaf
(k, v, the SSM state, the conv state) within 1e-5; four decode steps'
logits within rtol 1e-4, atol 1e-5; greedy ids identical to the
reference's `serve_batch`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from _torch_common import flat, zamba2_weights  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import convert, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCH = "zamba2-2.7b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = 128                     # two 64-row SSD chunks
FULL_PARAMS = 2_494_759_840


def smoke(get):
    return dataclasses.replace(get(ARCH), dtype="float32", num_layers=4)


CFG, JCFG = smoke(get_smoke_config), smoke(jax_get_smoke)

@pytest.fixture(scope="module")
def weights():
    """(numpy params of the reference, the port's params)."""
    return zamba2_weights(JCFG, CFG)


def prompts(n, length, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(n, length)).astype(np.int32)


@pytest.fixture(scope="module")
def prefilled(weights):
    """Prefill of two prompts of 128 in both packages:
    ((jax logits, jax cache), (port logits, port cache))."""
    jp, tp = weights
    toks = prompts(2, PROMPT)
    j = jax.jit(jsteps.make_prefill_step(JCFG))(jp, {"tokens": jnp.asarray(toks)})
    t = steps.make_prefill_step(CFG)(tp, {"tokens": torch.from_numpy(toks).long()})
    return j, t


def test_param_count_matches_jax(weights):
    jp, tp = weights
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == zoo.param_count(CFG) == jzoo.param_count(JCFG) == sum(
        np.size(x) for x in jax.tree.leaves(jp))
    full = get_config(ARCH)
    assert zoo.param_count(full) == jzoo.param_count(jax_get_config(ARCH)) \
        == FULL_PARAMS
    # the tree maps leaf for leaf, with A_log, D and dt_bias kept fp32
    assert flat(jp).keys() == flat(tp).keys()
    bf16 = convert.zoo_from_jax(jp, CFG, device="cpu", dtype=torch.bfloat16)
    for path, leaf in zip(flat(tp), tree_leaves(bf16)):
        keep = path.rsplit("/", 1)[-1] in convert.FP32_LEAVES
        assert leaf.dtype == (torch.float32 if keep else torch.bfloat16), path


def test_prefill_last_logits_match_jax(prefilled):
    (jl, _), (tl, _) = prefilled
    assert tl.shape == (2, CFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_cache_matches_jax(prefilled):
    (_, jc), (_, tc) = prefilled
    want, got = flat(jc), flat(tc)
    assert got.keys() == want.keys()
    assert any(k.endswith("/attn/k") for k in got)
    for path in want:
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **CACHE_TOL)


def test_make_cache_has_the_prefill_cache_layout(prefilled):
    """zoo.make_cache(B, P) has the leaves, shapes and dtypes of a prefill
    cache of P tokens (zeros), as the reference's make_cache has its."""
    (_, jc), (_, tc) = prefilled
    made = flat(zoo.make_cache(CFG, 2, PROMPT, device="cpu"))
    jmade = flat(jzoo.make_cache(JCFG, 2, PROMPT))
    got = flat(tc)
    assert made.keys() == got.keys() == jmade.keys()
    for path, leaf in made.items():
        assert leaf.shape == got[path].shape == jmade[path].shape, path
        assert leaf.dtype == got[path].dtype and not leaf.any(), path


def test_decode_steps_match_jax(weights, prefilled):
    jp, tp = weights
    (jl, jc), (_, tc) = prefilled
    # decode writes the cache in place: step a copy of the fixture's
    jc, tc = jzoo.pad_cache(jc, 4), zoo.pad_cache(tree_map(torch.clone, tc), 4)
    jdec = jax.jit(jsteps.make_decode_step(JCFG))
    tdec = steps.make_decode_step(CFG)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for t in range(4):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(tok),
                             "cache_len": jnp.asarray(PROMPT + t, jnp.int32)},
                        jc)
        tlog, tc = tdec(tp, {"tokens": torch.from_numpy(tok).long(),
                             "cache_len": PROMPT + t}, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    for path, leaf in flat(jc).items():
        np.testing.assert_allclose(flat(tc)[path], leaf, err_msg=path,
                                   **CACHE_TOL)


@pytest.mark.parametrize("prompt_len", [PROMPT, 48])
def test_serve_batch_matches_jax_greedy_ids(weights, prompt_len):
    """2 requests x 8 generated tokens, after a prompt of two SSD chunks
    and one of 48 (under one chunk)."""
    jp, tp = weights
    toks = prompts(2, prompt_len, seed=prompt_len)
    want = jserve.serve_batch(JCFG, jp, jnp.asarray(toks), 8)
    got = serve.serve_batch(CFG, tp, torch.from_numpy(toks).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_main_runs_the_smoke_config_on_the_cpu(capsys):
    gen = serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                      "--prompt-len", "64", "--gen-len", "4",
                      "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert int(gen.min()) >= 0 and int(gen.max()) < CFG.vocab_size
    assert "served 2 requests" in capsys.readouterr().out


def test_device_none_means_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.init_params(CFG, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke", "--requests", "1"])


def test_unported_paths_raise_naming_their_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--arch", "paper-inl", "--device", "cpu"])
    attn = dataclasses.replace(CFG, block_pattern=("attn",), num_layers=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.init_params(attn, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.param_count(dataclasses.replace(CFG, use_mla=True))
