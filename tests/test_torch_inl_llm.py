"""INL over an LLM in the port (`core/inl_llm`, the wires of
`core/linkmodel`, `launch/steps.make_inl_train_step`) against the JAX
package, on the CPU.

Smoke configs in fp32, grown to (encoder_layers + 1) periods as the
reference's tests/test_inl_llm.py grows them.  The reference's weights are
seeded numpy values of the shapes of its `inl_llm.init` (traced, not run:
`jax.eval_shape`), carried into the port by `convert.inl_llm_from_jax`.
Both packages get the reference's draws: the view noise
`normal(split(fold_in(rng, 0), J)[j])` and the cut layer's eps
`normal(fold_in(rng, 1))`.  Bars:
  * the four cases of tests/test_inl_llm.py, on the port;
  * `loss_fn`'s loss within rtol 1e-5 and every gradient leaf within
    GRAD_TOL = 2e-5 of the leaf's largest |gradient| of
    `jax.value_and_grad(inl_llm.loss_fn)` (the 6.6a bar), for
    llama3.2-1b, zamba2-2.7b and deepseek-v2-236b at link_bits 32 (no
    quantizer), and for llama3.2-1b on the packed wire with learned
    priors (link_bits 4);
  * at the configs' own link_bits 16 the cut layer quantizes: the loss
    within rtol 1e-5, and the latents' codewords equal to the
    reference's but where the pre-quantization value lies within 1e-5 of
    a rounding midpoint (the two packages' mu part by a few 1e-6 in fp32
    GEMM order; a flip there moves a latent by one 16-bit step, and the
    gradients with it, ROADMAP queue 3's "quantized training parts at
    rounding midpoints");
  * `wire_concat`, forward and backward, and `packed_wire_concat`'s
    backward == the reference's bit for bit; `packed_wire_concat`'s
    forward: the codewords equal, the values within one ulp of the
    quantizer's range 4 (the reference's CPU dequantize is an fma,
    idx · (1/scale) - r, where the port and the kernels divide: ROADMAP
    queue 3);
  * one `ops.cutlayer` call a step over all J·B·S rows, the packed wire's
    pack and unpack once each.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import flat, near_midpoint  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.core import inl_llm as jinl  # noqa: E402
from repro.core import linkmodel as jlink  # noqa: E402
from repro_torch import convert, optim, tree_leaves, tree_map  # noqa: E402
from repro_torch import value_and_grad  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core import inl_llm, linkmodel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCHS = ("llama3.2-1b", "zamba2-2.7b", "deepseek-v2-236b")
GRAD_TOL = 2e-5
B, S = 2, 32


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grown(get, name, **inl):
    cfg = dataclasses.replace(get(name), dtype="float32")
    pat = transformer.block_pattern(cfg)
    need = (cfg.inl.encoder_layers + 1) * len(pat) \
        + cfg.moe.first_dense_layers
    if cfg.num_layers < need:
        cfg = dataclasses.replace(cfg, num_layers=need)
    if inl:
        cfg = dataclasses.replace(cfg, inl=dataclasses.replace(cfg.inl,
                                                               **inl))
    return cfg


def cfgs(name, **inl):
    return _grown(jax_get_smoke, name, **inl), \
        _grown(get_smoke_config, name, **inl)


# leaf name -> (around, spread) of the seeded values; other leaves
# N(0, 1/fan_in), the tables (embed, branch heads) N(0, 0.02^2)
_AROUND = {"A_log": (0.0, 0.5), "D": (1.0, 0.2), "dt_bias": (-2.0, 0.5),
           "scale": (1.0, 0.2), "b": (0.0, 0.1), "mu": (0.0, 0.1),
           "logvar": (0.0, 0.1)}


@functools.lru_cache(maxsize=None)
def weights(name, **inl):
    """(the reference's INLLLMParams of numpy leaves, the port's)."""
    jcfg, cfg = cfgs(name, **inl)
    shapes = jax.eval_shape(lambda k: jinl.init(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def fill(path, s):
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if keys[-1] in _AROUND:
            around, spread = _AROUND[keys[-1]]
            x = around + spread * rng.normal(size=s.shape)
        elif "embed" in keys or "branch_heads" in keys:
            x = 0.02 * rng.normal(size=s.shape)
        else:
            x = rng.normal(size=s.shape) / np.sqrt(s.shape[-2])
        return x.astype(np.float32)
    jp = jax.tree_util.tree_map_with_path(fill, shapes)
    return jp, convert.inl_llm_from_jax(jp, cfg, device="cpu")


def np_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    return {"tokens": toks, "labels": labels}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def reference_draws(cfg, key):
    """(noise, eps) as numpy: the reference's draws from `key`."""
    J = cfg.inl.num_nodes
    nks = jax.random.split(jax.random.fold_in(key, 0), J)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, S, cfg.d_model),
                                                   jnp.float32))
                      for k in nks])
    eps = np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1), (J, B, S, cfg.inl.d_bottleneck),
        jnp.float32))
    return noise, eps


def both_losses(name, **inl):
    """((jax loss, metrics, grads), (port loss, metrics, grads)) on one
    batch and the reference's draws."""
    jcfg, cfg = cfgs(name, **inl)
    jp, tp = weights(name, **inl)
    batch = np_batch(cfg)
    key = jax.random.PRNGKey(3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b, k: jinl.loss_fn(p, jcfg, b, k), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    noise, eps = reference_draws(cfg, key)
    tl, tm, tg = value_and_grad(
        lambda p: inl_llm.loss_fn(p, cfg, to_torch(batch),
                                  noise=torch.from_numpy(noise),
                                  eps=torch.from_numpy(eps)), tp)
    return (jl, jm, jg), (tl, tm, tg)


# ---------------------------------------------------------------------------
# The four cases of tests/test_inl_llm.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_inl_llm_loss_finite(name):
    _, cfg = cfgs(name)
    params = inl_llm.init(cfg, 0, device="cpu")
    batch = to_torch(np_batch(cfg))
    loss, metrics = inl_llm.loss_fn(params, cfg, batch,
                                    torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(loss))
    assert float(metrics["bits_per_token"]) == 2 * cfg.inl.num_nodes \
        * cfg.inl.d_bottleneck * cfg.inl.link_bits


def test_inl_llm_eq5_decoder_width():
    _, cfg = cfgs("llama3.2-1b")
    params = inl_llm.init(cfg, 0, device="cpu")
    w = params.decoder["in_proj"]["w"]
    assert w.shape[0] == cfg.inl.num_nodes * cfg.inl.d_bottleneck


def test_inl_llm_train_step_updates():
    _, cfg = cfgs("llama3.2-1b")
    params = inl_llm.init(cfg, 0, device="cpu")
    opt = optim.adam(1e-3)
    step = inl_llm.make_train_step(cfg, opt)
    p2, _, m = step(params, opt.init(params), to_torch(np_batch(cfg)),
                    torch.Generator().manual_seed(4))
    assert bool(torch.isfinite(m["loss"]))
    delta = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(params), tree_leaves(p2)))
    assert delta > 0


def test_encoder_decoder_layer_split():
    _, cfg = cfgs("zamba2-2.7b")
    e, d = inl_llm.encoder_cfg(cfg), inl_llm.decoder_cfg(cfg)
    pat = len(transformer.block_pattern(cfg))
    assert e.num_layers + d.num_layers == cfg.num_layers
    assert e.num_layers == cfg.inl.encoder_layers * pat
    with pytest.raises(ValueError, match="not enough periods"):
        inl_llm.decoder_cfg(dataclasses.replace(cfg, num_layers=2))


# ---------------------------------------------------------------------------
# The loss and its gradients against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,inl", [
    ("llama3.2-1b", dict(link_bits=32)),
    ("zamba2-2.7b", dict(link_bits=32)),
    ("deepseek-v2-236b", dict(link_bits=32)),
    ("llama3.2-1b", dict(link_bits=4, learned_prior=True))],
    ids=["llama-32", "zamba2-32", "deepseek-32", "llama-packed-wire-prior"])
def test_loss_and_grads_match_reference(name, inl):
    (jl, jm, jg), (tl, tm, tg) = both_losses(name, **inl)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want = flat(jax.tree.map(np.asarray, jg._asdict()))
    got = flat(tree_map(lambda t: t.numpy(), tg._asdict()))
    assert want.keys() == got.keys()
    if inl.get("learned_prior"):
        assert "/priors/mu" in want
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, path, err)


@pytest.mark.parametrize("name", ARCHS[:1])
def test_link16_latents_part_only_at_rounding_midpoints(name):
    """At link_bits 16 the cut layer quantizes (step 8/65535): the loss
    within rtol 1e-5, the codewords of u equal to the reference's but
    where mu + sigma eps lies within 1e-5 of a midpoint."""
    jcfg, cfg = cfgs(name)
    assert cfg.inl.link_bits == 16
    jp, tp = weights(name)
    batch = np_batch(cfg)
    key = jax.random.PRNGKey(3)
    (ju, jmu, jlv, _), (jl, _) = jax.jit(lambda p, b, k: (
        jinl.encode(p, jcfg, b["tokens"], k), jinl.loss_fn(p, jcfg, b, k)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    noise, eps = (torch.from_numpy(a) for a in reference_draws(cfg, key))
    with torch.no_grad():
        u, _, _, _ = inl_llm.encode(tp, cfg, to_torch(batch)["tokens"],
                                    noise=noise, eps=eps)
        tl, _ = inl_llm.loss_fn(tp, cfg, to_torch(batch), noise=noise,
                                eps=eps)
    codes = ref.quantize_index(u, 16).numpy()
    jcodes = ref.quantize_index(torch.from_numpy(np.asarray(ju)),
                                16).numpy()
    flips = codes != jcodes
    mid = near_midpoint(np.asarray(jmu), np.asarray(jlv), eps.numpy(), 16,
                        tol=1e-5)
    assert not (flips & ~mid).any()
    assert int(np.abs(codes.astype(np.int64) - jcodes).max()) <= 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


# ---------------------------------------------------------------------------
# The wires
# ---------------------------------------------------------------------------

def _wire_inputs(seed, J=3):
    rng = np.random.default_rng(seed)
    u = (1.5 * rng.normal(size=(J, 2, 5, 12))).astype(np.float32)
    g = rng.normal(size=(2, 5, J * 12)).astype(np.float32)
    return u, g


@pytest.mark.parametrize("wire,bits", [("int8", 8), ("packed", 1),
                                       ("packed", 3), ("packed", 4),
                                       ("packed", 7)])
def test_wires_match_reference_bit_for_bit(wire, bits):
    u, g = _wire_inputs(bits)
    if wire == "int8":
        jfn, fn = jlink.wire_concat, linkmodel.wire_concat
    else:
        def jfn(x):
            return jlink.packed_wire_concat(x, bits)

        def fn(x):
            return linkmodel.packed_wire_concat(x, bits)
    with jax.disable_jit():
        jout, vjp = jax.vjp(jfn, jnp.asarray(u))
        (jdu,) = vjp(jnp.asarray(g))
    tu = torch.from_numpy(u).requires_grad_(True)
    out = fn(tu)
    (du,) = torch.autograd.grad(out, tu, torch.from_numpy(g))
    assert out.shape == (2, 5, 3 * 12)
    np.testing.assert_array_equal(du.numpy(), np.asarray(jdu))
    got, want = out.detach().numpy(), np.asarray(jout)
    if wire == "int8":
        np.testing.assert_array_equal(got, want)
        return
    # the codewords, and the values within one ulp
    codes = ref.quantize_index(out.detach(), bits)
    np.testing.assert_array_equal(
        codes.numpy(), ref.quantize_index(torch.from_numpy(want),
                                          bits).numpy())
    assert torch.equal(ref.dequantize_index(codes, bits), out.detach())
    # one ulp of the range, the size of the operands of the last subtract
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.spacing(np.float32(ref.QUANT_RANGE)))


def test_float_concat_and_bf16_wires_keep_the_layout_and_dtype():
    u, _ = _wire_inputs(0)
    tu = torch.from_numpy(u)
    cat = linkmodel.float_concat(tu)
    for j in range(3):
        assert torch.equal(cat[..., 12 * j:12 * (j + 1)], tu[j])
    ub = tu.to(torch.bfloat16).requires_grad_(True)
    for out in (linkmodel.wire_concat(ub),
                linkmodel.packed_wire_concat(ub, 4)):
        assert out.dtype == torch.bfloat16
        (du,) = torch.autograd.grad(out.float().sum(), ub)
        assert du.dtype == torch.bfloat16


def test_transmit_is_one_fused_cut():
    mu = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(0))
    lv = torch.zeros(3, 4, 8)
    eps = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(1))
    u, rate = linkmodel.transmit(None, mu, lv, bits=4, eps=eps)
    want = ops.cutlayer(mu, lv, eps, link_bits=4)
    assert torch.equal(u, want[0]) and torch.equal(rate, want[1])


# ---------------------------------------------------------------------------
# The launches a step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 8, 4])
def test_one_cut_layer_call_over_all_rows(monkeypatch, bits):
    from repro_torch.core import bottleneck
    from repro_torch.kernels import inl_bottleneck
    _, cfg = cfgs("llama3.2-1b", link_bits=bits)
    params = inl_llm.init(cfg, 0, device="cpu")
    calls = {"cutlayer": [], "pack": 0, "unpack": 0}
    real = {"cutlayer": ops.cutlayer, "pack": inl_bottleneck.pack_values,
            "unpack": inl_bottleneck.unpack_dequant}

    def cutlayer(mu, *a, **kw):
        calls["cutlayer"].append(tuple(mu.shape))
        return real["cutlayer"](mu, *a, **kw)

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn
    monkeypatch.setattr(bottleneck.ops, "cutlayer", cutlayer)
    monkeypatch.setattr(inl_bottleneck, "pack_values", counted("pack"))
    monkeypatch.setattr(inl_bottleneck, "unpack_dequant", counted("unpack"))
    steps.make_scan_train_step(cfg, optim.adam(1e-3), scheme="inl")(
        params, optim.adam(1e-3).init(params),
        to_torch(steps.stack_batches([np_batch(cfg)])),
        torch.Generator().manual_seed(2))
    J, d_b = cfg.inl.num_nodes, cfg.inl.d_bottleneck
    assert calls["cutlayer"] == [(J, B, S, d_b)]
    packed = 1 if bits < 8 else 0
    assert (calls["pack"], calls["unpack"]) == (packed, packed)


def test_scan_step_takes_the_draws_as_data():
    """make_scan_train_step(scheme="inl") given (K, ...) stacks of noise
    and eps == K make_inl_train_step calls given each step's, bit for
    bit; a generator drawing them equals draw_noise's order."""
    _, cfg = cfgs("llama3.2-1b")
    params = inl_llm.init(cfg, 1, device="cpu")
    opt = optim.adam(1e-3)
    batches = [np_batch(cfg, seed=10 + i) for i in range(2)]
    gen = torch.Generator().manual_seed(6)
    draws = [inl_llm.draw_noise(cfg, gen, B, S) for _ in range(2)]
    noise = torch.stack([n for n, _ in draws])
    eps = torch.stack([e for _, e in draws])
    p_scan, _, m_scan = steps.make_scan_train_step(cfg, opt, scheme="inl")(
        params, opt.init(params), to_torch(steps.stack_batches(batches)),
        noise=noise, eps=eps)
    p_gen, _, m_gen = steps.make_scan_train_step(cfg, opt, scheme="inl")(
        params, opt.init(params), to_torch(steps.stack_batches(batches)),
        torch.Generator().manual_seed(6))
    step = steps.make_inl_train_step(cfg, opt)
    p, o = params, opt.init(params)
    for i, b in enumerate(batches):
        p, o, m = step(p, o, to_torch(b), noise=noise[i], eps=eps[i])
        assert torch.equal(m["loss"], m_scan["loss"][i])
    for a, b, c in zip(tree_leaves(p), tree_leaves(p_scan),
                       tree_leaves(p_gen)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(m_scan["loss"], m_gen["loss"])
    with pytest.raises(ValueError, match="together"):
        steps.make_scan_train_step(cfg, opt, scheme="inl")(
            params, opt.init(params), to_torch(steps.stack_batches(batches)),
            noise=noise)
