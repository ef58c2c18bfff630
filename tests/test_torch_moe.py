"""The port's mixture of experts (models/moe.py) against the JAX package's,
on the CPU.

The expert weights come from the reference's `moe_init` (fp32, through
`convert.zoo_from_jax`), the tokens from numpy.  Two MoE layouts: Arctic's
smoke (4 experts, top-2) and DeepSeek-V2's smoke (4 experts, top-2, one
shared expert).  A router tilted towards expert 0 (its column shifted and
the tokens given a common component) sends nearly every token there, so
expert 0 overflows its capacity and pairs are dropped; at capacity factor
2 no expert can overflow.  Bars: `moe_apply`'s y within rtol 1e-5, atol 1e-6 (fp32 sums
in two orders), lb_loss, z_loss and expert_load within 1e-6;
`moe_decode_apply` likewise.  In bf16 the combine adds a token's k
contributions in the reference's order, and y parts from the reference's
only where the expert FFN's fp32 sums round apart (at most 1 in 1000
outputs, one bf16 ulp).  `top_k` breaks ties towards the lower index, as
`lax.top_k` does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402

ARCHS = ("arctic-480b", "deepseek-v2-236b")
Y_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
B, S = 2, 24


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch):
    return (dataclasses.replace(jax_get_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def weights(arch, *, tilt: bool, seed=0):
    """(jax cfg, port cfg, numpy params, port params, tokens (B, S, d))."""
    jcfg, cfg = cfgs(arch)
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                                jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if tilt:
        jp["router"]["w"] = jp["router"]["w"].copy()
        jp["router"]["w"][:, 0] += 0.05
        x += 1.0
    tp = convert.zoo_from_jax(jp, cfg, device="cpu")
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("case", ["random", "roomy", "tilted"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, case):
    """random: the seeded router at capacity factor 1.25; roomy: the same
    at capacity factor 2, where no expert can overflow; tilted: nearly
    every token's first choice is expert 0, which overflows."""
    jcfg, cfg, jp, tp, x = weights(arch, tilt=case == "tilted")
    if case == "roomy":
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=2.0)) for c in (jcfg, cfg))
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(
        jp, jnp.asarray(x))
    y, aux = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **Y_TOL)
    assert set(aux) == set(jaux) == {"lb_loss", "z_loss", "expert_load"}
    for k in aux:
        assert aux[k].dtype == torch.float32
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   err_msg=k, **AUX_TOL)
    # an expert chosen by more pairs than its capacity drops the rest
    m = cfg.moe
    T = B * S
    C = moe.expert_capacity(T, m)
    pairs = np.rint(aux["expert_load"].numpy() * T * m.experts_per_token)
    if case == "roomy":
        assert pairs.max() <= C, (pairs, C)
    if case == "tilted":
        assert pairs[0] > C and pairs[0] == pairs.max(), (pairs, C)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_apply_matches_jax(arch):
    jcfg, cfg, jp, tp, x = weights(arch, tilt=False, seed=1)
    x = x[:, :1]                                   # one token a sequence
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_decode_apply(p, jcfg, x))(
        jp, jnp.asarray(x))
    y, aux = moe.moe_decode_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **Y_TOL)
    for k in aux:
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_ep_without_a_mesh_is_moe_apply(arch):
    _, cfg, _, tp, x = weights(arch, tilt=True)
    x = torch.from_numpy(x)
    y_ep, aux_ep = moe.moe_apply_ep(tp, cfg, x)
    y, aux = moe.moe_apply(tp, cfg, x)
    assert torch.equal(y_ep, y)
    assert all(torch.equal(aux_ep[k], aux[k]) for k in aux)
    # a mesh without a 'model' axis is moe_apply too; the abstract pod
    # meshes have no ranks to dispatch over (the mesh runs:
    # tests/test_torch_moe_ep.py)
    y_dp, _ = moe.moe_apply_ep(tp, cfg, x, mesh=mesh_lib.AbstractMesh(
        (2,), ("data",)))
    assert torch.equal(y_dp, y)
    with pytest.raises(ValueError, match="AbstractMesh"):
        moe.moe_apply_ep(tp, cfg, x,
                         mesh=mesh_lib.make_production_mesh())


def _bf16(arch, tilt):
    """The layer in bf16 in both packages (the router fp32), on the same
    bf16 tokens: (jax cfg, port cfg, jax params, port params, jax x, port
    x)."""
    jcfg, cfg, jp, _, x = weights(arch, tilt=tilt)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jp16 = {k: (v if k == "router" else
                jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v))
            for k, v in jp.items()}
    tp16 = convert.zoo_from_jax(jp, cfg, device="cpu")
    assert tp16["router"]["w"].dtype == torch.float32
    assert tp16["wi"].dtype == torch.bfloat16
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))) \
        .to(torch.bfloat16)
    return jcfg, cfg, jp16, tp16, xj, xt


def _parted(got, want):
    """(count of entries that differ, their largest gap in bf16 ulps)."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32)) >> 16
    return int((got != want).sum()), int(ulps.max())


@pytest.mark.parametrize("tilt", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_moe_rounds_as_the_reference(arch, tilt):
    """bf16, the router fp32: the slots, the drop, the combine's k adds
    one after another in bf16 (each weight rounded to bf16 first) and
    decode's one contraction over k round as the reference's do.  What
    may part is the expert FFN's fp32 accumulation order (torch's CPU
    GEMM, XLA's dot): at most 1 in 1000 outputs, by one bf16 ulp
    (measured: 1 of 6144 outputs on DeepSeek-V2's untilted layer, none on
    the other three layers or in decode)."""
    jcfg, cfg, jp, tp, xj, xt = _bf16(arch, tilt)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(jp, xj)
    y, _ = moe.moe_apply(tp, cfg, xt)
    assert y.dtype == torch.bfloat16
    n, ulps = _parted(y, jy)
    assert n * 1000 <= y.numel() and ulps <= 1, (n, ulps)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_decode_apply(p, jcfg, x))(
        jp, xj[:, :1])
    y, _ = moe.moe_decode_apply(tp, cfg, xt[:, :1])
    n, ulps = _parted(y, jy)
    assert n * 1000 <= y.numel() and ulps <= 1, (n, ulps)


def test_top_k_breaks_ties_towards_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.2, 0.2, 0.5, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tokens", [1, 7, 48, 2048])
def test_expert_capacity_and_counts_match_jax(tokens):
    for arch in ARCHS:
        jcfg, cfg = cfgs(arch)
        assert moe.expert_capacity(tokens, cfg.moe) \
            == jmoe.expert_capacity(tokens, jcfg.moe)
        assert moe.moe_param_count(cfg) == jmoe.moe_param_count(jcfg)
        assert moe.moe_active_param_count(cfg) \
            == jmoe.moe_active_param_count(jcfg)


def test_moe_init_draws_each_expert_and_keeps_the_router_fp32():
    _, cfg = cfgs("deepseek-v2-236b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     device="cpu")
    m = cfg.moe
    assert p["router"]["w"].dtype == torch.float32
    assert p["wi"].shape == (m.num_experts, cfg.d_model, m.d_ff_expert)
    assert p["wo"].shape == (m.num_experts, m.d_ff_expert, cfg.d_model)
    assert p["wi"].dtype == torch.bfloat16
    # every expert its own draw, N(0, 1/d_in)
    assert not torch.equal(p["wi"][0], p["wi"][1])
    std = float(p["wi"].float().std())
    assert abs(std * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert set(p["shared"]) == {"wi", "wg", "wo"}
    assert sum(t.numel() for t in (p["router"]["w"], p["wi"], p["wg"],
                                   p["wo"], *layers_of(p["shared"]))) \
        == moe.moe_param_count(cfg)


def layers_of(mlp):
    return [mlp[k]["w"] for k in ("wi", "wg", "wo")]


def test_silu_is_the_reference_silu():
    """jax.nn.silu's four bf16 roundings (exp, 1 + e, the reciprocal, the
    product): on 2^16 bf16 inputs the port's `layers.silu` gives the
    reference's values bit for bit, and fp32 within 1e-6."""
    x = np.linspace(-12, 12, 1 << 16).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        xj = jnp.asarray(x, jdt)
        want = np.asarray(jax.jit(jax.nn.silu)(xj).astype(jnp.float32))
        got = layers.silu(torch.from_numpy(
            np.array(xj.astype(jnp.float32))).to(tdt)).float().numpy()
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
