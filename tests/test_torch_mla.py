"""DeepSeek-V2's multi-head latent attention (MLA) in the port against the
JAX package, on the CPU.

`mla_apply` alone, its weights from the reference's `mla_init` (fp32,
through `convert.zoo_from_jax`, q_norm's and kv_norm's scales given seeded
noise), at DeepSeek-V2's smoke widths (qk head dim 48 = 32 nope + 16 rope,
v 32 padded to 48 for the prefill's one attention call, kv_lora_rank 32):
with the low-rank q (q_lora_rank 48) and the full-rank one, with no window
and with a sliding window of 16 (a ring that wraps).  Prefill's output
and compressed cache (c_kv, k_rope), then decode steps by weight
absorption against the padded cache, within rtol 1e-5, atol 1e-6 (fp32
sums in other orders).

`zoo.pad_cache` grows c_kv and k_rope along their time axis as the
reference's does; without that the first decode step would write slot P
of a cache of P slots: the reference's `dynamic_update_slice` clamps it to
slot P - 1 and overwrites the last prompt token, the port's write raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import flat  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import convert, tree_map  # noqa: E402
from repro_torch.configs.base import MLAConfig, get_smoke_config  # noqa
from repro_torch.models import attention, zoo  # noqa: E402

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=1e-5, atol=1e-6)
B, P, STEPS = 2, 24, 3
VARIANTS = {"low-rank q": dict(), "full-rank q": dict(q_lora_rank=0),
            "window 16": dict(sliding_window=16)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(variant):
    kw = dict(VARIANTS[variant])
    out = []
    for get in (jax_get_smoke, get_smoke_config):
        c = dataclasses.replace(get(ARCH), dtype="float32")
        if "q_lora_rank" in kw:
            c = dataclasses.replace(c, mla=dataclasses.replace(
                c.mla, q_lora_rank=kw["q_lora_rank"]))
        if "sliding_window" in kw:
            c = dataclasses.replace(c, sliding_window=kw["sliding_window"])
        out.append(c)
    return out


def weights(variant, seed=0):
    jcfg, cfg = cfgs(variant)
    jp = jax.tree.map(np.array, jattention.mla_init(
        jax.random.PRNGKey(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for name in ("q_norm", "kv_norm"):
        if name in jp:
            jp[name]["scale"] = (1.0 + 0.2 * rng.normal(
                size=jp[name]["scale"].shape)).astype(np.float32)
    return jcfg, cfg, jp, convert.zoo_from_jax(jp, cfg, device="cpu")


def tokens(cfg, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _pos(start, S):
    return np.broadcast_to(np.arange(start, start + S), (B, S))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_count_matches_jax(variant):
    jcfg, cfg, jp, tp = weights(variant)
    n = sum(np.size(x) for x in jax.tree.leaves(jp))
    assert attention.mla_param_count(cfg) \
        == jattention.mla_param_count(jcfg) == n
    assert flat(jp).keys() == flat(tp).keys()
    made = attention.attn_init(torch.Generator().manual_seed(0), cfg,
                               torch.float32)
    assert flat(made).keys() == flat(tp).keys()
    assert sum(t.numel() for t in made.values() for t in t.values()) == n


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    jcfg, cfg, jp, tp = weights(variant)
    x = tokens(cfg, P, 0)
    jy, jc = jax.jit(lambda p, x: jattention.mla_apply(
        p, jcfg, x, jnp.asarray(_pos(0, P)), mode="prefill"))(
        jp, jnp.asarray(x))
    y, c = attention.mla_apply(tp, cfg, torch.from_numpy(x),
                               torch.from_numpy(_pos(0, P).copy()),
                               mode="prefill")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert flat(c).keys() == flat(jc).keys() == {"/c_kv", "/k_rope"}
    for k, v in flat(jc).items():
        np.testing.assert_allclose(flat(c)[k], v, err_msg=k, **TOL)
    if not cfg.sliding_window:
        jc, c = jzoo.pad_cache(jc, STEPS), zoo.pad_cache(c, STEPS)
    jdec = jax.jit(lambda p, x, pos, c, n: jattention.mla_apply(
        p, jcfg, x, pos, mode="decode", cache=c, cache_len=n))
    for t in range(STEPS):
        xt = tokens(cfg, 1, 10 + t)
        jy, jc = jdec(jp, jnp.asarray(xt), jnp.asarray(_pos(P + t, 1)), jc,
                      jnp.asarray(P + t, jnp.int32))
        y, c = attention.mla_apply(
            tp, cfg, torch.from_numpy(xt),
            torch.from_numpy(_pos(P + t, 1).copy()), mode="decode",
            cache=c, cache_len=P + t)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for k, v in flat(jc).items():
            np.testing.assert_allclose(flat(c)[k], v, err_msg=k, **TOL)


def test_pad_cache_grows_the_compressed_cache():
    jcfg, cfg, jp, tp = weights("low-rank q")
    x = tokens(cfg, P, 1)
    _, jc = jattention.mla_apply(jp, jcfg, jnp.asarray(x),
                                 jnp.asarray(_pos(0, P)), mode="prefill")
    _, c = attention.mla_apply(tp, cfg, torch.from_numpy(x),
                               torch.from_numpy(_pos(0, P).copy()),
                               mode="prefill")
    # the zoo's cache tree: a pre-layer's and a stacked period's leaves
    tree = {"pre": [c], "pattern": [tree_map(lambda t: t[None], c)]}
    jtree = {"pre": [jc], "pattern": [jax.tree.map(lambda t: t[None], jc)]}
    grown, jgrown = zoo.pad_cache(tree, 5), jzoo.pad_cache(jtree, 5)
    m = cfg.mla
    assert grown["pre"][0]["c_kv"].shape == (B, P + 5, m.kv_lora_rank)
    assert grown["pattern"][0]["k_rope"].shape \
        == (1, B, P + 5, m.qk_rope_head_dim)
    assert flat(grown).keys() == flat(jgrown).keys()
    for k, v in flat(jgrown).items():
        assert flat(grown)[k].shape == v.shape, k
        np.testing.assert_allclose(flat(grown)[k], v, err_msg=k, **TOL)
    for name in ("c_kv", "k_rope"):
        assert torch.equal(grown["pre"][0][name][:, :P], c[name])
        assert not grown["pre"][0][name][:, P:].any()
        assert not grown["pattern"][0][name][:, :, P:].any()


def test_decode_writes_slot_p_of_the_padded_cache():
    """After a prefill of P and pad_cache(1), decode at cache_len P writes
    the new token's c_kv and k_rope into slot P and leaves slots < P as
    they were; on the unpadded cache the port's write raises where the
    reference's clamps onto slot P - 1."""
    jcfg, cfg, jp, tp = weights("low-rank q")
    x = tokens(cfg, P, 2)
    _, c = attention.mla_apply(tp, cfg, torch.from_numpy(x),
                               torch.from_numpy(_pos(0, P).copy()),
                               mode="prefill")
    before = tree_map(torch.clone, c)
    xt = tokens(cfg, 1, 3)
    pos = torch.from_numpy(_pos(P, 1).copy())
    with pytest.raises((IndexError, RuntimeError)):
        attention.mla_apply(tp, cfg, torch.from_numpy(xt), pos,
                            mode="decode", cache=tree_map(torch.clone, c),
                            cache_len=P)
    _, jc = jattention.mla_apply(jp, jcfg, jnp.asarray(x),
                                 jnp.asarray(_pos(0, P)), mode="prefill")
    _, jc_clamped = jattention.mla_apply(
        jp, jcfg, jnp.asarray(xt), jnp.asarray(_pos(P, 1)), mode="decode",
        cache=jc, cache_len=jnp.asarray(P, jnp.int32))
    assert not np.array_equal(np.asarray(jc_clamped["c_kv"][:, P - 1]),
                              np.asarray(jc["c_kv"][:, P - 1]))
    c = zoo.pad_cache(c, 1)
    _, c = attention.mla_apply(tp, cfg, torch.from_numpy(xt), pos,
                               mode="decode", cache=c, cache_len=P)
    for k in ("c_kv", "k_rope"):
        assert torch.equal(c[k][:, :P], before[k]), k
        assert c[k][:, P].abs().sum() > 0, k
    np.testing.assert_allclose(c["c_kv"][:, P].numpy(),
                               np.asarray(jc_clamped["c_kv"][:, P - 1]),
                               **TOL)


def test_mla_config_is_the_reference_field_for_field():
    from repro.configs.base import MLAConfig as JMLAConfig
    assert dataclasses.asdict(MLAConfig()) == dataclasses.asdict(JMLAConfig())
    full = get_smoke_config(ARCH)
    assert full.mla.qk_head_dim == full.head_dim == 48
