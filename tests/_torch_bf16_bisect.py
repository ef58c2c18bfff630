"""Where the port's bf16 roundings part from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_bf16_bisect.py

Prints, for the Llama-3.2-1B smoke model in bf16, each step of its first
attention block fed the same bf16 inputs in both packages: how many
outputs differ and by how much (rmsnorm, the denses, rope, the prefill
attention, the activation as the port computes it and as torch's one-
rounding F.silu would, the MLP, the block against the reference run
eagerly and jitted, and the FFN norm the jitted reference computes from
the unrounded x + h); bf16 GQA decode attention at g = 4 over three
seeds; the first mamba2 block of the bf16 Zamba2 smoke model stage by
stage (in_proj, conv, silu, softplus, the SSD scan's y and state, the
gate, the norm, the out_proj, the block against the reference run
eagerly and jitted, and the gate's norm fed the unrounded product as the
jitted reference feeds it); and the smoke models' prefill logits (Llama,
and Zamba2 at num_layers=4) against the reference's, with the port's
silu, with F.silu in its place, and with the block's FFN norm fed the
fp32 x + h as the jitted reference feeds it.  The bars that tests/test_torch_attn_models.py
and ROADMAP queue 3 state come from these counts.  Imports both packages,
as the tests do; the port itself imports no JAX.
"""
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from _torch_common import zoo_weights
from repro.configs import get_smoke_config as jax_get_smoke
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import convert, tree_map
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import attention, layers, ssm, transformer

BF16 = torch.bfloat16


def to_t(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(BF16)


def report(name, got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    differ = got != want
    print(f"{name:40s} {int(differ.sum()):6d} of {got.size:6d} differ, "
          f"max |diff| {np.abs(got - want).max():.3g} (max |x| "
          f"{np.abs(want).max():.3g})")


def bf16_pair(arch, **kw):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="bfloat16", **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16", **kw)
    jp, tp = zoo_weights(jcfg, cfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if convert.keeps_fp32(
            tuple(getattr(p, "key", None) for p in path))
        else jnp.asarray(x, jnp.bfloat16), jp)
    return jcfg, cfg, jp, tp


def block_steps():
    jcfg, cfg, jp, tp = bf16_pair("llama3.2-1b")
    jb = jax.tree.map(lambda t: t[0], jp["stack"]["pattern"][0])
    tb = tree_map(lambda t: t[0], tp["stack"]["pattern"][0])
    B, S = 2, 32
    xj = jnp.asarray(np.random.default_rng(0).normal(
        size=(B, S, cfg.d_model)), jnp.bfloat16)
    x = to_t(xj)
    pos_j = jnp.broadcast_to(jnp.arange(S), (B, S))
    pos = torch.arange(S).expand(B, S)
    hj = jax.jit(lambda p, x: jlayers.rmsnorm(p, x, jcfg.norm_eps))(
        jb["attn_norm"], xj)
    report("rmsnorm", layers.rmsnorm(tb["attn_norm"], x, cfg.norm_eps), hj)
    h = to_t(hj)
    for name in ("wq", "wk", "wv"):
        report(f"dense {name}", layers.dense(tb["attn"][name], h),
               jax.jit(jlayers.dense)(jb["attn"][name], hj))
    qj = jlayers.dense(jb["attn"]["wq"], hj).reshape(B, S, 4, 32)
    report("rope", layers.apply_rope(to_t(qj), pos, cfg.rope_theta),
           jax.jit(lambda q: jlayers.apply_rope(q, pos_j,
                                                jcfg.rope_theta))(qj))
    report("gqa_apply prefill",
           attention.gqa_apply(tb["attn"], cfg, h, pos, mode="prefill")[0],
           jax.jit(lambda p, x: jattention.gqa_apply(
               p, jcfg, x, pos_j, mode="prefill")[0])(jb["attn"], hj))
    aj = jlayers.dense(jb["mlp"]["wi"], hj)
    gj = jlayers.dense(jb["mlp"]["wg"], hj)
    report("dense wi", layers.dense(tb["mlp"]["wi"], h),
           jax.jit(jlayers.dense)(jb["mlp"]["wi"], hj))
    act = jax.jit(lambda a, g: jax.nn.silu(a) * g)(aj, gj)
    report("silu(a) * g, layers.silu", layers.silu(to_t(aj)) * to_t(gj), act)
    report("silu(a) * g, F.silu (one rounding)",
           F.silu(to_t(aj)) * to_t(gj), act)
    report("mlp", layers.mlp(tb["mlp"], h),
           jax.jit(lambda p, x: jlayers.mlp(p, x, act="silu"))(jb["mlp"], hj))

    def jblock(p, x):
        return jtransformer._attn_block_apply(
            p, jcfg, x, pos_j, mode="prefill", cache=None, cache_len=None,
            use_moe=False)[0]
    got = transformer._attn_block_apply(
        tb, cfg, x, pos, mode="prefill", cache=None, cache_len=None,
        use_moe=False)[0]
    report("block vs the reference run eagerly", got, jblock(jb, xj))
    report("block vs the reference jitted", got, jax.jit(jblock)(jb, xj))

    def jffn_norm(p, x):
        hh, _ = jattention.gqa_apply(
            p["attn"], jcfg, jlayers.rmsnorm(p["attn_norm"], x,
                                             jcfg.norm_eps),
            pos_j, mode="prefill")
        return jlayers.rmsnorm(p["ffn_norm"], x + hh, jcfg.norm_eps)
    hh, _ = attention.gqa_apply(tb["attn"], cfg, h, pos, mode="prefill")
    want = jax.jit(jffn_norm)(jb, xj)
    report("FFN norm of bf16(x + h) vs jitted",
           layers.rmsnorm(tb["ffn_norm"], x + hh, cfg.norm_eps), want)
    report("FFN norm of fp32 x + h vs jitted",
           layers.rmsnorm(tb["ffn_norm"], x.float() + hh.float(),
                          cfg.norm_eps).to(BF16), want)


def mamba_steps():
    """The first mamba2 block of the bf16 Zamba2 smoke model, each stage
    fed the same bf16 inputs in both packages (the reference jitted): the
    in_proj, the causal conv (fp32 shifted sums in the port, one XLA conv
    in the reference), its silu, the SSD scan's y and final state from
    the same bf16 xh, Bm, Cm and fp32 dt, the gate y * silu(z) before the
    norm, the norm, the out_proj, and the whole block."""
    jcfg, cfg, jp, tp = bf16_pair("zamba2-2.7b", num_layers=4)
    jb = jax.tree.map(lambda t: t[0], jp["stack"]["pattern"][0]["mamba"])
    tb = tree_map(lambda t: t[0], tp["stack"]["pattern"][0]["mamba"])
    s = cfg.ssm
    B, S, d = 2, 128, cfg.d_model
    d_in, H, N, P = s.d_inner(d), s.num_heads(d), s.state_dim, s.head_dim
    xj = jnp.asarray(np.random.default_rng(1).normal(size=(B, S, d)),
                     jnp.bfloat16)
    x = to_t(xj)
    zj = jax.jit(jlayers.dense)(jb["in_proj"], xj)
    report("mamba in_proj", layers.dense(tb["in_proj"], x), zj)
    zz, xbc_j, dt_raw_j = jnp.split(zj, [d_in, 2 * d_in + 2 * N], axis=-1)
    convj = jax.jit(jssm.conv1d_causal)(jb["conv"], xbc_j)
    conv = ssm.conv1d_causal(tb["conv"], to_t(xbc_j))
    report("conv1d_causal", conv, convj)
    actj = jax.jit(jax.nn.silu)(convj)
    report("silu(conv)", layers.silu(to_t(convj)), actj)
    xh_j = actj[..., :d_in].reshape(B, S, H, P)
    bm_j, cm_j = actj[..., d_in:d_in + N], actj[..., d_in + N:]
    dt_j = jax.jit(lambda r, b: jax.nn.softplus(r.astype(jnp.float32) + b))(
        dt_raw_j, jb["dt_bias"])
    a_j = -jnp.exp(jb["A_log"])
    dt = torch.from_numpy(np.array(dt_j))
    report("softplus(dt_raw + dt_bias) (fp32)",
           torch.nn.functional.softplus(to_t(dt_raw_j).float()
                                        + tb["dt_bias"]), dt_j)
    yj, finj = jax.jit(functools.partial(jssm._ssd_chunked,
                                         chunk=s.chunk_size))(
        xh_j, dt_j, a_j, bm_j, cm_j, jb["D"])
    a = torch.from_numpy(np.array(a_j))
    y, fin = ssm.ops.ssd_scan(to_t(xh_j), dt, a, to_t(bm_j), to_t(cm_j),
                              tb["D"], chunk=s.chunk_size)
    report("SSD y (the port's bf16 vs the reference's fp32)", y, yj)
    report("SSD y, the reference's rounded to bf16", y,
           yj.astype(jnp.bfloat16))
    report("SSD final state (fp32)", fin, finj)
    gate_j = jax.jit(lambda y, z: y.astype(jnp.bfloat16) * jax.nn.silu(z))(
        yj.reshape(B, S, d_in), zz)
    gate = y.reshape(B, S, d_in).to(BF16) * layers.silu(to_t(zz))
    report("gate y * silu(z)", gate, gate_j)
    normj = jax.jit(lambda p, x: jlayers.rmsnorm(p, x, jcfg.norm_eps))(
        jb["norm"], gate_j)
    report("norm", layers.rmsnorm(tb["norm"], to_t(gate_j), cfg.norm_eps),
           normj)
    report("out_proj", layers.dense(tb["out_proj"], to_t(normj)),
           jax.jit(jlayers.dense)(jb["out_proj"], normj))
    # jitted as one, XLA feeds the norm the unrounded fp32 product (the
    # excess precision of the attention block's FFN norm)
    gate_norm = jax.jit(lambda p, y, z: jlayers.rmsnorm(
        p, y.astype(jnp.bfloat16) * jax.nn.silu(z), jcfg.norm_eps))(
        jb["norm"], yj.reshape(B, S, d_in), zz)
    yb = to_t(yj.astype(jnp.bfloat16)).reshape(B, S, d_in)
    report("gate and norm vs jitted as one",
           layers.rmsnorm(tb["norm"], yb * layers.silu(to_t(zz)),
                          cfg.norm_eps), gate_norm)
    report("norm of the fp32 gate product vs jitted as one",
           layers.rmsnorm(tb["norm"], yb.float()
                          * layers.silu(to_t(zz)).float(),
                          cfg.norm_eps).to(BF16), gate_norm)
    got = ssm.mamba2_apply(tb, cfg, x, mode="prefill")[0]
    report("mamba2_apply prefill vs the reference eagerly", got,
           jssm.mamba2_apply(jb, jcfg, xj, mode="prefill")[0])
    report("mamba2_apply prefill vs the reference jitted", got,
           jax.jit(lambda p, x: jssm.mamba2_apply(p, jcfg, x,
                                                  mode="prefill")[0])(jb, xj))


def gqa_decode():
    B, H, KV, Dh, W, n = 4, 32, 8, 64, 544, 300
    for seed in range(3):
        rng = np.random.default_rng(seed)
        arrs = [jnp.asarray(rng.normal(size=s), jnp.bfloat16) for s in
                ((B, 1, H, Dh), (B, W, KV, Dh), (B, W, KV, Dh),
                 (B, 1, KV, Dh), (B, 1, KV, Dh))]
        want = jax.jit(lambda q, kc, vc, kn, vn: jattention.decode_attention(
            q, kc, vc, n, kn, vn))(*arrs)
        got = attention.decode_attention(*(to_t(a) for a in arrs[:3]), n,
                                         to_t(arrs[3]), to_t(arrs[4]))
        report(f"GQA decode g=4, seed {seed}", got, want)


def _excess_block(p, cfg, x, positions, *, mode, cache, cache_len,
                  use_moe):
    """The attention block with its FFN norm fed the fp32 x + h, as the
    jitted reference feeds it (dense MLP only)."""
    h, new_cache = attention.attn_apply(
        p["attn"], cfg, layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps),
        positions, mode=mode, cache=cache, cache_len=cache_len)
    xf = x.float() + h.float()
    hn = layers.rmsnorm(p["ffn_norm"], xf, cfg.norm_eps).to(x.dtype)
    return (xf.to(x.dtype) + layers.mlp(p["mlp"], hn, act=cfg.act),
            new_cache, transformer._zero_aux(cfg, x.device))


def model_logits():
    orig_silu, orig_block = layers.silu, transformer._attn_block_apply
    for arch, kw in (("llama3.2-1b", {}), ("zamba2-2.7b",
                                           {"num_layers": 4})):
        jcfg, cfg, jp, tp = bf16_pair(arch, **kw)
        toks = np.random.default_rng(128).integers(
            0, cfg.vocab_size, size=(2, 128)).astype(np.int32)
        want = np.asarray(jax.jit(jsteps.make_prefill_step(jcfg))(
            jp, {"tokens": jnp.asarray(toks)})[0].astype(jnp.float32))
        variants = [("the port", None), ("F.silu in place of layers.silu",
                                         "silu")]
        if arch == "llama3.2-1b":
            variants.append(("FFN norm fed the fp32 x + h", "excess"))
        for label, change in variants:
            try:
                if change == "silu":
                    layers.silu = F.silu
                    layers._ACTS["silu"] = F.silu
                if change == "excess":
                    transformer._attn_block_apply = _excess_block
                got = steps.make_prefill_step(cfg)(
                    tp, {"tokens": torch.from_numpy(toks).long()})[0]
            finally:
                layers.silu = layers._ACTS["silu"] = orig_silu
                transformer._attn_block_apply = orig_block
            got = got.float().numpy()
            print(f"{arch} prefill logits, {label}: max |diff| / max "
                  f"|logit| {np.abs(got - want).max() / np.abs(want).max():.3g}"
                  f", {int((got != want).sum())} of {got.size} differ")


if __name__ == "__main__":
    torch.set_num_threads(1)
    block_steps()
    mamba_steps()
    gqa_decode()
    model_logits()
