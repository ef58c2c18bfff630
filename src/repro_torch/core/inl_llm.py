"""In-network learning applied to the LLM architectures.

Reference: src/repro/core/inl_llm.py (`INLLLMParams`, `encoder_cfg`,
`decoder_cfg`, `init`, `encode`, `decode`, `_chunked_inl_ce`, `loss_fn`,
`make_train_step`, `input_specs`).  The paper's vertical split with the
architecture's own blocks: J edge nodes each observe a view of the token
stream (their own embedding table plus Gaussian feature noise), run
`inl.encoder_layers` periods of the block pattern and emit per-token
bottleneck latents u_j of width `inl.d_bottleneck`.  Node J+1
concatenates them (eq. 5: J d_bottleneck columns), projects them into the
rest of the stack and decodes with the LM head.  Eq. (6) applies per
token.

The encoders' parameters are stacked along a leading J axis, as the
reference stacks them for its vmap, so converted weights copy leaf for
leaf (`convert.inl_llm_from_jax`); `encode` loops over the J nodes, each
taking its parameters from one `unbind` of each stacked leaf.  The cut
layer stays ONE `ops.cutlayer` launch over all J·B·S rows.  The
reference's `moe_impl="gspmd"` selects the MoE without expert
parallelism; the port's `moe_apply` is that path.

Randomness: a step draws the view noise (J, B, S, d_model) and then the
cut layer's eps (J, B, S, d_bottleneck), both fp32 N(0, 1), from a
torch.Generator, or takes them as `noise=` and `eps=`, which is how the
parity tests feed it the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import as_generator, optim, resolve_device, value_and_grad
from repro_torch.core import bottleneck, linkmodel
from repro_torch.models import layers, transformer, zoo


class INLLLMParams(NamedTuple):
    encoders: dict      # stacked (J, ...): embed, encoder stack, norm, head
    decoder: dict       # in_proj, decoder stack, final norm, unembed
    branch_heads: dict  # {"w": (J, d_b, vocab_pad)}: per-node decoders
    priors: dict = {}   # learned (J, d_b) mean / logvar; {} = N(0, I)


def encoder_cfg(cfg):
    pat = transformer.block_pattern(cfg)
    return dataclasses.replace(
        cfg, num_layers=cfg.inl.encoder_layers * len(pat),
        moe=dataclasses.replace(cfg.moe, first_dense_layers=0),
        moe_impl="gspmd")


def decoder_cfg(cfg):
    pat = transformer.block_pattern(cfg)
    dec_periods = transformer.num_periods(cfg) - cfg.inl.encoder_layers
    if dec_periods < 1:
        raise ValueError(f"{cfg.name}: not enough periods for the INL "
                         f"split ({transformer.num_periods(cfg)} periods, "
                         f"{cfg.inl.encoder_layers} in the encoders)")
    return dataclasses.replace(
        cfg, num_layers=dec_periods * len(pat) + cfg.moe.first_dense_layers,
        moe_impl="gspmd")


def init(cfg, generator, *, device=None):
    """Random weights from `generator` (a torch.Generator on `device`'s
    type, or an int seed), in cfg.dtype on `device` (None: cuda); the
    learned priors (cfg.inl.learned_prior) in fp32."""
    device = resolve_device(device)
    gen = as_generator(generator, device)
    J = cfg.inl.num_nodes
    dtype = zoo.model_dtype(cfg)
    e_cfg, d_cfg = encoder_cfg(cfg), decoder_cfg(cfg)
    d_b = cfg.inl.d_bottleneck
    vpad = layers.pad_vocab(cfg.vocab_size)

    def one_encoder():
        return {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device),
            "stack": transformer.stack_init(gen, e_cfg, dtype, device),
            "norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
            "head": bottleneck.head_init(gen, cfg.d_model, d_b, dtype=dtype,
                                         device=device),
        }

    encoders = transformer._stacked_blocks(one_encoder, J)
    decoder = {
        "in_proj": layers.dense_init(gen, J * d_b, cfg.d_model, dtype=dtype,
                                     device=device),
        "stack": transformer.stack_init(gen, d_cfg, dtype, device),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
        "unembed": layers.dense_init(gen, cfg.d_model, vpad, dtype=dtype,
                                     device=device),
    }
    bh = torch.randn((J, d_b, vpad), generator=gen, device=device) * 0.02
    priors = bottleneck.prior_init(d_b, learned=cfg.inl.learned_prior,
                                   num_nodes=J, device=device)
    return INLLLMParams(encoders, decoder, {"w": bh.to(dtype)}, priors)


def draw_noise(cfg, generator: torch.Generator, B: int, S: int):
    """(noise (J, B, S, d_model), eps (J, B, S, d_bottleneck)), fp32 N(0, 1)
    on the generator's device, in that order: one training step's draws."""
    J = cfg.inl.num_nodes
    kw = dict(generator=generator, dtype=torch.float32,
              device=generator.device)
    noise = torch.randn((J, B, S, cfg.d_model), **kw)
    return noise, torch.randn((J, B, S, cfg.inl.d_bottleneck), **kw)


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def encode(params: INLLLMParams, cfg, tokens, *, noise, eps=None,
           train: bool = True, rate_estimator: str = "sample"):
    """tokens: (B, S).  The views differ by the node's embedding and its
    feature noise 0.1 · noise[j] (noise (J, B, S, d_model) fp32).  Returns
    (u, mu, logvar, rate): u, mu, logvar (J, B, S, d_b); rate (J, B, S)
    fp32 from the cut layer (None when train=False).

    The cut layer, sample, link quantizer and rate, is ONE fused kernel
    launch over all J·B·S rows (`bottleneck.fused_sample_rate`) with the
    hand-written eq.-(10) backward; eps (J, B, S, d_b) fp32 is its noise
    (train=False runs the deterministic cut, eps unused).  With link_bits
    <= 8 the wire in `decode` carries the quantization, so the kernel
    runs with a full-precision link."""
    J = cfg.inl.num_nodes
    e_cfg = encoder_cfg(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    mus, logvars = [], []
    for j, enc in enumerate(transformer._periods(params.encoders, J)):
        h = layers.embed(enc["embed"], tokens)
        h = h + (0.1 * noise[j]).to(h.dtype)
        h, _, _ = transformer.stack_apply(enc["stack"], e_cfg, h, positions,
                                          mode="train")
        h = layers.rmsnorm(enc["norm"], h, cfg.norm_eps)
        mu, logvar = bottleneck.head_apply(enc["head"], h)
        mus.append(mu)
        logvars.append(logvar)
    mu, logvar = torch.stack(mus), torch.stack(logvars)
    bits = cfg.inl.link_bits if cfg.inl.link_bits > 8 else 32
    if train:
        if eps is None:
            raise ValueError("a training encode takes the cut layer's eps")
        u, rate = bottleneck.fused_sample_rate(
            None, mu, logvar, link_bits=bits, rate_estimator=rate_estimator,
            prior=params.priors, eps=eps)
    else:
        # the deterministic inference cut: the same kernel, no noise
        u, _ = bottleneck.fused_sample_rate(None, mu, logvar, link_bits=bits,
                                            rate_estimator="none")
        rate = None
    return u, mu, logvar, rate


def decode(params: INLLLMParams, cfg, u):
    """u: (J, B, S, d_b) -> (h (B, S, d_model) after the final norm, the
    decoder stack's aux values).  The eq.-(5) concatenation is the
    client-to-center boundary: link_bits == 8 crosses it on the int8 wire
    (`linkmodel.wire_concat`), link_bits < 8 on the bit-packed wire
    (`linkmodel.packed_wire_concat`), wider links as floats."""
    J, B, S, _ = u.shape
    bits = cfg.inl.link_bits
    if bits < 8:
        u_cat = linkmodel.packed_wire_concat(u, bits)
    elif bits == 8:
        u_cat = linkmodel.wire_concat(u)
    else:
        u_cat = linkmodel.float_concat(u)                # eq. (5)
    h = layers.dense(params.decoder["in_proj"], u_cat)
    h, _, aux = transformer.stack_apply(
        params.decoder["stack"], decoder_cfg(cfg), h,
        _positions(B, S, u.device), mode="train")
    return layers.rmsnorm(params.decoder["final_norm"], h, cfg.norm_eps), aux


def _chunked_inl_ce(params: INLLLMParams, cfg, h, u, labels,
                    chunk: int = 512):
    """(joint CE, the J branches' CE summed, joint accuracy), chunked over
    the sequence so that the (B, S, vocab) joint logits and the (J, B, S,
    vocab) branch logits are never whole; each chunk runs under
    `torch.utils.checkpoint` and is projected again in the backward.  A
    ragged last chunk is padded with ignored labels."""
    J, B, S, _ = u.shape
    V = cfg.vocab_size
    chunk = min(chunk, S)
    nch = -(-S // chunk)
    pad = nch * chunk - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        u = F.pad(u, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)

    def body(h_c, u_c, lab_c):
        joint = layers.dense(params.decoder["unembed"], h_c)[..., :V]
        ll, n = zoo._label_nll(joint, lab_c)
        branch = torch.einsum("jbsd,jdv->jbsv", u_c,
                              params.branch_heads["w"])[..., :V]
        bl, _ = zoo._label_nll(branch, lab_c.expand(J, *lab_c.shape))
        hits = ((torch.argmax(joint, dim=-1) == lab_c)
                & (lab_c != -1)).sum()
        return ll, bl, n, hits

    z = h.new_zeros((), dtype=torch.float32)
    j_nll, b_nll, cnt = z, z, z
    hits = torch.zeros((), dtype=torch.int64, device=h.device)
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        ll, bl, n, hit = torch.utils.checkpoint.checkpoint(
            body, h[:, sl], u[:, :, sl], labels[:, sl], use_reentrant=False)
        j_nll, b_nll, cnt, hits = j_nll - ll, b_nll - bl, cnt + n, hits + hit
    cnt = torch.clamp(cnt, min=1.0)
    return j_nll / cnt, b_nll / cnt, hits / cnt


def loss_fn(params: INLLLMParams, cfg, batch, generator=None, *, noise=None,
            eps=None, rate_estimator: str = "sample"):
    """(loss, metrics) of eq. (6) per token: the joint CE + s · (the
    branches' CE summed + the J nodes' mean rates summed), plus the MoE's
    router losses for a MoE config.  The draws: `noise` and `eps` as
    given, else both from `generator` (`draw_noise`)."""
    tokens, labels = batch["tokens"], batch["labels"]
    if noise is None or eps is None:
        if generator is None:
            raise ValueError("loss_fn draws its noise from `generator`; "
                             "pass generator= or noise= and eps=")
        noise, eps = draw_noise(cfg, generator, *tokens.shape)
    J = cfg.inl.num_nodes
    u, _, _, rates = encode(params, cfg, tokens, noise=noise, eps=eps,
                            train=True, rate_estimator=rate_estimator)
    h, moe_aux = decode(params, cfg, u)
    ce_joint, ce_branch_sum, acc = _chunked_inl_ce(params, cfg, h, u, labels)
    # the rates (J, B, S) come from the cut layer, not recomputed
    rate_total = torch.mean(rates.reshape(J, -1), dim=-1).sum()
    loss = ce_joint + cfg.inl.s * (ce_branch_sum + rate_total)
    metrics = {"ce_joint": ce_joint, "ce_branch_mean": ce_branch_sum / J,
               "rate_mean": rate_total / J, "rate_total": rate_total,
               "accuracy": acc}
    if cfg.is_moe:
        loss = loss + cfg.moe.router_aux_weight * moe_aux["lb_loss"] \
            + cfg.moe.router_z_weight * moe_aux["z_loss"]
    metrics["loss"] = loss
    metrics["bits_per_token"] = torch.full(
        (), float(2 * J * cfg.inl.d_bottleneck * cfg.inl.link_bits),
        dtype=torch.float32, device=tokens.device)
    return loss, metrics


def make_train_step(cfg, optimizer):
    """(params, opt_state, batch, generator=None, *, noise=None, eps=None,
    inplace=False) -> (params, opt_state, metrics detached), "grad_norm"
    the gradients' global norm before the clip.  With inplace=True the
    optimizer's `update_` updates the params and opt_state passed in,
    which come back, and gives the norm."""
    def step(params, opt_state, batch, generator=None, *, noise=None,
             eps=None, inplace: bool = False):
        _, metrics, grads = value_and_grad(
            lambda p: loss_fn(p, cfg, batch, generator, noise=noise,
                              eps=eps), params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if inplace:
            metrics["grad_norm"] = optimizer.update_(grads, opt_state, params)
            return params, opt_state, metrics
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics["grad_norm"] = optim.global_norm(grads)
        return new_params, new_opt, metrics
    return step


def input_specs(cfg, shape_cfg):
    """{"tokens", "labels"}: (shape, dtype) of a training batch."""
    shape = (shape_cfg.global_batch, shape_cfg.seq_len)
    return {"tokens": (shape, torch.int64), "labels": (shape, torch.int64)}
