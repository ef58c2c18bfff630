"""Plain reference of one INL training step over StarCoder2's blocks
(arXiv 2402.19173 for the blocks, arXiv 2104.14929 for the split), in
fp32 (TF32 off), written from the configuration file alone.

The split: J nodes each embed the tokens with their own table, add
0.1 x their N(0, 1) view noise, run `encoder_layers` blocks, an RMS norm
and a head to (mu, log sigma^2) (clipped to [-8, 8]) of width d_b; the cut
layer sends u = mu + sigma eps over a `link_bits` link (bench/reference/
cut.py).  The fusion node concatenates the J latents (eq. 5), projects
them to d_model, runs the remaining blocks and an RMS norm, and predicts
the next token; each node's branch head predicts it from its own latent.
Eq. (6) per token: CE(joint) + s (sum_j CE(branch j) + sum_j mean rate_j).

A block, as the configuration runs it: x + o(attn(rmsnorm(x))), then
x + mlp(rmsnorm(x)); attention with biases on q, k and v, grouped kv
heads, rotary embeddings on q and k (the two halves of the head rotated),
causal softmax at 1/sqrt(head_dim); the MLP two matrices around the tanh
GELU.  AdamW as bench/reference/adamw.py with the warm-up cosine schedule.

Every block and every chunk of the loss runs under `torch.utils.checkpoint`
so that the fp32 step fits beside its optimizer state.  The weights are
the benchmark's (`make_weights`), named as the program's tree names them,
drawn in fp32 and rounded to the configuration's dtype.  As the
configuration stores its weights in that dtype and AdamW keeps an fp32
master copy, each step computes, in fp32, on the master rounded to the
dtype, and AdamW updates the master; at a warm-up learning rate of a few
1e-6 a bf16 weight stays where it is while its master moves.  The draws of a step come from the generator the benchmark hands in:
the view noise (J, B, S, d_model), then eps (J, B, S, d_b).  Imports
nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.utils.checkpoint

from bench.lib import compare
from bench.lib import weights as W
from bench.reference import cut, lowp
from bench.reference.adamw import AdamW, warmup_cosine

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CE_ROWS = 1024


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _block_shapes(m, prefix: str, lead: tuple) -> Dict[str, tuple]:
    d, H, KV, Dh, F = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["d_ff"])
    p = prefix + "stack.pattern.0."
    out = {p + "attn_norm.scale": lead + (d,),
           p + "attn.wq.w": lead + (d, H * Dh), p + "attn.wq.b": lead + (H * Dh,),
           p + "attn.wk.w": lead + (d, KV * Dh), p + "attn.wk.b": lead + (KV * Dh,),
           p + "attn.wv.w": lead + (d, KV * Dh), p + "attn.wv.b": lead + (KV * Dh,),
           p + "attn.wo.w": lead + (H * Dh, d),
           p + "ffn_norm.scale": lead + (d,),
           p + "mlp.wi.w": lead + (d, F), p + "mlp.wo.w": lead + (F, d)}
    return out


def shapes(m) -> Dict[str, tuple]:
    inl = m["inl"]
    J, e, d_b = inl["num_nodes"], inl["encoder_layers"], inl["d_bottleneck"]
    d, V = m["d_model"], m["vocab_size_padded"]
    out = {"encoders.embed.w": (J, V, d)}
    out.update(_block_shapes(m, "encoders.", (J, e)))
    out.update({"encoders.norm.scale": (J, d),
                "encoders.head.mu.w": (J, d, d_b), "encoders.head.mu.b": (J, d_b),
                "encoders.head.logvar.w": (J, d, d_b),
                "encoders.head.logvar.b": (J, d_b),
                "decoder.in_proj.w": (J * d_b, d)})
    out.update(_block_shapes(m, "decoder.", (m["num_layers"] - e,)))
    out.update({"decoder.final_norm.scale": (d,),
                "decoder.unembed.w": (d, V),
                "branch_heads.w": (J, d_b, V)})
    return out


def rule(name: str, shape: tuple):
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return ("ones",)
    if last == "b":
        return ("zeros",)
    if name in ("encoders.embed.w", "branch_heads.w"):
        return ("normal", 0.02)
    if ".head.logvar." in name:
        return ("normal", 1e-2)
    return ("normal", shape[-2] ** -0.5)


def make_weight(m, name: str, shape: tuple, seed: int, device,
                dtype=None) -> torch.Tensor:
    """One weight in the configuration's dtype (`dtype`: as such, or cast
    on to it from there)."""
    w = W.draw(name, shape, rule(name, shape), seed=seed, device=device,
               dtype=DTYPES[m["dtype"]])
    return w if dtype is None else w.to(dtype)


def make_weights(m, seed: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    return {n: make_weight(m, n, s, seed, device, dtype)
            for n, s in shapes(m).items()}


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta: float):
    """x (B, S, heads, Dh); positions 0..S-1."""
    S, Dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                       device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def block(m, prec, x, an, wq, bq, wk, bk, wv, bv, wo, fn, wi, wo2):
    B, S, d = x.shape
    H, KV, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = rmsnorm(x, an, m["norm_eps"])
    q = rope((lowp.mm(h, wq, prec) + bq).reshape(B, S, H, Dh), m["rope_theta"])
    k = rope((lowp.mm(h, wk, prec) + bk).reshape(B, S, KV, Dh), m["rope_theta"])
    v = (lowp.mm(h, wv, prec) + bv).reshape(B, S, KV, Dh)

    def heads(t):
        # query head h reads kv head h // (H / KV)
        n = t.shape[2]
        t = t[:, :, :, None, :].expand(B, S, n, H // n, Dh)
        return t.reshape(B, S, H, Dh).permute(0, 2, 1, 3).reshape(B * H, S, Dh)

    s = lowp.bmm(heads(q), heads(k).transpose(1, 2), prec) / math.sqrt(Dh)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = lowp.bmm(p, heads(v), prec).reshape(B, H, S, Dh) \
        .permute(0, 2, 1, 3).reshape(B, S, H * Dh)
    x = x + lowp.mm(o, wo, prec)
    h = rmsnorm(x, fn, m["norm_eps"])
    return x + lowp.mm(gelu_tanh(lowp.mm(h, wi, prec)), wo2, prec)


_BLOCK = ("attn_norm.scale", "attn.wq.w", "attn.wq.b", "attn.wk.w",
          "attn.wk.b", "attn.wv.w", "attn.wv.b", "attn.wo.w",
          "ffn_norm.scale", "mlp.wi.w", "mlp.wo.w")


def _remat(remat, fn, *args):
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _stack(m, prec, x, layers, remat):
    """Run the blocks whose weights `layers` lists (one tuple a block)."""
    for ws in layers:
        x = _remat(remat, block, m, prec, x, *ws)
    return x


def _nll_chunk(prec, V, h, u, wu, wb, labels, keep):
    """(joint nll sum, branch nll sum) of a chunk of rows: h (R, d), u (J,
    R, d_b), labels (R,), keep (R,) bool."""
    joint = torch.log_softmax(lowp.mm(h, wu, prec)[:, :V], dim=-1)
    nll = -(joint.gather(-1, labels[:, None])[:, 0] * keep).sum()
    br = 0.0
    for j in range(u.shape[0]):
        lp = torch.log_softmax(lowp.mm(u[j], wb[j], prec)[:, :V], dim=-1)
        br = br - (lp.gather(-1, labels[:, None])[:, 0] * keep).sum()
    return nll, br


def loss(m, w, tokens, labels, noise, eps, prec="fp32", half=False,
         remat=True):
    """Eq. (6) per token.  tokens, labels (B, S) int64; noise (J, B, S,
    d_model), eps (J, B, S, d_b) fp32.  half: the fault that leaves out
    half of the batch's tokens (the later half of the flattened rows) and
    takes every mean over the rest.  remat=False keeps every activation
    (the tests count FLOPs without the recomputation)."""
    inl = m["inl"]
    J, e = inl["num_nodes"], inl["encoder_layers"]
    B, S = tokens.shape
    V = m["vocab_size"]
    enc = {k[len("encoders."):]: v.unbind(0) for k, v in w.items()
           if k.startswith("encoders.")}
    dec = {k[len("decoder."):]: v for k, v in w.items()
           if k.startswith("decoder.")}
    pre = "stack.pattern.0."
    n = B * S
    keep = torch.arange(n, device=tokens.device) < (n // 2 if half else n)
    us, rates = [], []
    for j in range(J):
        x = enc["embed.w"][j][tokens] + 0.1 * noise[j]
        per = [enc[pre + k][j].unbind(0) for k in _BLOCK]
        x = _stack(m, prec, x, list(zip(*per)), remat)
        x = rmsnorm(x, enc["norm.scale"][j], m["norm_eps"])
        mu = lowp.mm(x, enc["head.mu.w"][j], prec) + enc["head.mu.b"][j]
        lv = torch.clamp(lowp.mm(x, enc["head.logvar.w"][j], prec)
                         + enc["head.logvar.b"][j], -8.0, 8.0)
        u, rate = cut.sample(mu, lv, eps[j], inl["link_bits"])
        us.append(u)
        rates.append((rate.reshape(-1) * keep).sum() / keep.sum())
    x = lowp.mm(torch.cat(us, dim=-1), dec["in_proj.w"], prec)
    per = [dec[pre + k].unbind(0) for k in _BLOCK]
    x = _stack(m, prec, x, list(zip(*per)), remat)
    x = rmsnorm(x, dec["final_norm.scale"], m["norm_eps"]).reshape(n, -1)
    u_rows = torch.stack(us).reshape(J, n, -1)
    lab = labels.reshape(n)
    nll = br = 0.0
    for r in range(0, n, CE_ROWS):
        sl = slice(r, r + CE_ROWS)
        a, b = _remat(remat, _nll_chunk, prec, V, x[sl], u_rows[:, sl],
                      dec["unembed.w"], w["branch_heads.w"], lab[sl],
                      keep[sl])
        nll, br = nll + a, br + b
    cnt = keep.sum()
    return nll / cnt + inl["s"] * (br / cnt + sum(rates))


def _grads(m, params, *args, **kw):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = loss(m, leaves, *args, **kw)
    gs = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, gs))


def run(m, opt_cfg: dict, seed: int, batches, gen, *, prec="fp32",
        half=False, device=None) -> dict:
    """The first len(batches) steps from the benchmark's weights for
    `seed`; batches a list of (tokens, labels) (B, S) int64 on the device.
    Returns {"losses", "grad" (the first moment after step 1 over 1 - b1,
    a norm a leaf), "change" (a norm a leaf)}."""
    inl = m["inl"]
    dtype = DTYPES[m["dtype"]]
    params = make_weights(m, seed, device, torch.float32)
    opt = AdamW(params, warmup_cosine(opt_cfg["lr"], opt_cfg["warmup"],
                                      opt_cfg["schedule_steps"]),
                weight_decay=opt_cfg["weight_decay"], clip=opt_cfg["clip"])
    losses, grad = [], None
    for tokens, labels in batches:
        J, (B, S) = inl["num_nodes"], tokens.shape
        noise = torch.randn((J, B, S, m["d_model"]), generator=gen,
                            dtype=torch.float32, device=device)
        eps = torch.randn((J, B, S, inl["d_bottleneck"]), generator=gen,
                          dtype=torch.float32, device=device)
        # the weights as the configuration stores them: the fp32 master
        # rounded to its dtype, then computed on in fp32
        stored = {k: v.to(dtype).to(torch.float32) for k, v in params.items()}
        value, g = _grads(m, stored, tokens, labels, noise, eps, prec, half)
        del noise, eps, stored
        params = opt.update(params, g)
        del g
        losses.append(value)
        if grad is None:
            grad = {k: compare.norm(v) / (1 - opt.b1)
                    for k, v in opt.m.items()}
    change = {}
    for k, s in shapes(m).items():
        w0 = make_weight(m, k, s, seed, device, torch.float32)
        change[k] = compare.norm(params[k] - w0)
        del w0
    return {"losses": losses, "grad": grad, "change": change}
