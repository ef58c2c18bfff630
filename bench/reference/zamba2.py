"""Plain reference of a training step of a stage of Zamba2-7B (arXiv
2411.15242; https://huggingface.co/Zyphra/Zamba2-7B-Instruct, config.json),
in fp32 (TF32 off), written from the configuration file and the layer
equations of `transformers`' modeling_zamba2.py alone.

The stage: the embedding e of the tokens, periods of five Mamba2 layers and
one hybrid layer, a final RMS norm and a head tied to the embedding; the
loss is the mean next-token cross entropy over every position.

    mamba    h <- h + Mamba2(RMSNorm(h))
    hybrid   (the i-th, i = the period's index; shared block b = i mod
             num_mem_blocks)
             c = RMSNorm_2d([h, e]);  a = o_b(Attn(q_b c, k_b c, v_b c)),
             causal, RoPE (the two halves of the head rotated) on q and k,
             softmax scale (Dh / 2)^-1/2;  n = RMSNorm(a);
             [g, u] = n gate_up_b + (n A_i) B_i;  t = down_b(gelu(g) u),
             gelu the exact (erf) form;  T = t L_i;
             h <- h + Mamba2(RMSNorm(h + T))
    Mamba2   [z, xBC, dt] = x W_in;  xBC = silu(causal depthwise conv of
             width 4 + bias);  [x, B, C] = xBC, B and C in G groups of N,
             head h of size P reading group h // (H / G);
             y = SSD(x, softplus(dt + dt_bias), -exp(A_log), B, C) + D x;
             out = RMSNorm over G groups of d_in / G (y * silu(z)) W_out

The SSD, chunk by chunk (chunk_size rows): within a chunk the quadratic
form y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j, cum the
in-chunk cumsum of dt A; across chunks the state S (N x P a head) enters
as exp(cum_i) C_i . S and is carried as S <- exp(cum_last) S +
sum_j B_j exp(cum_last - cum_j) dt_j x_j^T, from S = 0.

Every layer, every query block of attention and every chunk of the loss
runs under `torch.utils.checkpoint` so that the fp32 step fits beside its
optimizer state.  Weights are the benchmark's (`make_weight`), named as
the program's tree names them, drawn in fp32 and rounded to the
configuration's dtype, except A_log, D and dt_bias, which the model keeps
in fp32.  Each step computes, in fp32, on the fp32 master rounded as the
configuration stores it; AdamW (bench/reference/adamw.py) updates the
master.  Matrix products go through bench/reference/lowp.py (the controls
round their operands); the SSD's own products are fp32.  Imports nothing
of the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from bench.lib import compare
from bench.lib import weights as W
from bench.reference import lowp
from bench.reference.adamw import AdamW, warmup_cosine

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CE_ROWS = 1024
ATTN_ROWS = 1024
PERIOD = 6                      # five Mamba2 layers, then a hybrid
FP32_LEAVES = ("A_log", "D", "dt_bias")


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _dims(m):
    s = m["ssm"]
    d = m["d_model"]
    d_in = s["expand"] * d
    H = d_in // s["head_dim"]
    GN = s["ngroups"] * s["state_dim"]
    return d, d_in, H, GN


def _mamba_shapes(m, prefix: str, n: int) -> Dict[str, tuple]:
    d, d_in, H, GN = _dims(m)
    conv = d_in + 2 * GN
    return {prefix + "norm.scale": (n, d),
            prefix + "mamba.in_proj.w": (n, d, 2 * d_in + 2 * GN + H),
            prefix + "mamba.conv.w": (n, m["ssm"]["conv_width"], conv),
            prefix + "mamba.conv.b": (n, conv),
            prefix + "mamba.A_log": (n, H),
            prefix + "mamba.D": (n, H),
            prefix + "mamba.dt_bias": (n, H),
            prefix + "mamba.norm.scale": (n, d_in),
            prefix + "mamba.out_proj.w": (n, d_in, d)}


def shapes(m) -> Dict[str, tuple]:
    d, F_, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    HD = m["num_heads"] * m["head_dim"]
    n = m["num_layers"] // PERIOD
    out = {}
    for i in range(PERIOD):
        pre = f"stack.pattern.{i}."
        out.update(_mamba_shapes(m, pre, n))
        if i == PERIOD - 1:
            out.update({pre + "linear.w": (n, d, d),
                        pre + "adapter.a.w": (n, d, r),
                        pre + "adapter.b.w": (n, r, 2 * F_)})
    for b in range(m["num_mem_blocks"]):
        pre = f"stack.mem_blocks.{b}."
        out.update({pre + "norm.scale": (2 * d,),
                    pre + "attn.wq.w": (2 * d, HD),
                    pre + "attn.wk.w": (2 * d, HD),
                    pre + "attn.wv.w": (2 * d, HD),
                    pre + "attn.wo.w": (HD, d),
                    pre + "ffn_norm.scale": (d,),
                    pre + "mlp.gate_up.w": (d, 2 * F_),
                    pre + "mlp.down.w": (F_, d)})
    out.update({"final_norm.scale": (d,),
                "embed.w": (m["vocab_size_padded"], d)})
    return out


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def make_weight(m, name: str, shape: tuple, seed: int, device,
                dtype=None) -> torch.Tensor:
    """One weight as the configuration stores it (A_log, D, dt_bias in
    fp32, the rest in its dtype), or cast on to `dtype` from there."""
    last = _leaf(name)
    store = torch.float32 if last in FP32_LEAVES else DTYPES[m["dtype"]]
    if last == "scale":
        w = W.draw(name, shape, ("ones",), seed=seed, device=device)
    else:
        z = W.draw(name, shape, ("normal", 1.0), seed=seed, device=device)
        if last == "A_log":           # A = -exp(A_log) around -e
            w = 1.0 + 0.5 * z
        elif last == "dt_bias":       # softplus(dt_bias) around 0.05
            w = -3.0 + 0.5 * z
        elif last == "D":
            w = 1.0 + 0.1 * z
        elif name.endswith("conv.b"):
            w = 0.1 * z
        elif name.endswith("conv.w"):
            w = z * shape[-2] ** -0.5
        elif name == "embed.w":
            w = 0.02 * z
        else:                         # a dense (d_in, d_out) matrix
            w = z * shape[-2] ** -0.5
    w = w.to(store)
    return w if dtype is None else w.to(dtype)


def make_weights(m, seed: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    return {n: make_weight(m, n, s, seed, device, dtype)
            for n, s in shapes(m).items()}


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps, groups: int = 1):
    xs = x.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    xs = xs * torch.rsqrt(torch.mean(xs * xs, dim=-1, keepdim=True) + eps)
    return xs.reshape(x.shape) * scale


def rope(x, theta: float):
    """x (B, S, heads, Dh); positions 0..S-1; the two halves rotated."""
    S, Dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                       device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def prefix_sum(x, dim: int):
    """Inclusive prefix sums along `dim` by doubling: log2(n) adds of the
    tensor shifted by 1, 2, 4, ... (deterministic on the card, where
    torch.cumsum of floats has no deterministic path)."""
    n, step = x.shape[dim], 1
    while step < n:
        head = torch.zeros_like(x.narrow(dim, 0, step))
        x = x + torch.cat([head, x.narrow(dim, 0, n - step)], dim=dim)
        step *= 2
    return x


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm, Cm (B, S, H, N) (each
    head's group) -> y (B, S, H, P), by chunks from a zero state."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    state = x.new_zeros((Bsz, H, N, P))
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, S, L):
        xc, dtc = x[:, c0:c0 + L], dt[:, c0:c0 + L]
        Bc, Cc = Bm[:, c0:c0 + L], Cm[:, c0:c0 + L]
        cum = prefix_sum(dtc * A, 1)                         # (B, L, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # (B, i, j, H)
        decay = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                          float("-inf")))
        w = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * decay \
            * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        if c0:                        # the state entering the first is 0
            y = y + torch.einsum("bihn,bhnp->bihp", Cc, state) \
                * torch.exp(cum)[..., None]
        if c0 + L < S:                # no later chunk reads the last state
            tail = torch.exp(cum[:, -1:, :] - cum) * dtc      # (B, L, H)
            state = state * torch.exp(cum[:, -1, :])[..., None, None] \
                + torch.einsum("bjhn,bjhp->bhnp", Bc * tail[..., None], xc)
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba2(m, prec, x, w):
    """x (B, S, d) the normed input; w the layer's mamba.* weights."""
    s = m["ssm"]
    Bsz, S, _ = x.shape
    d, d_in, H, GN = _dims(m)
    G, N, P = s["ngroups"], s["state_dim"], s["head_dim"]
    zxbcdt = lowp.mm(x, w["in_proj.w"], prec)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * GN, H], dim=-1)
    K = w["conv.w"].shape[0]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = sum(xp[:, k:k + S] * w["conv.w"][k] for k in range(K)) \
        + w["conv.b"]
    xbc = silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_in, GN, GN], dim=-1)

    def heads(t):   # (B, S, G N) -> (B, S, H, N): head h reads h // (H/G)
        return t.reshape(Bsz, S, G, 1, N).expand(Bsz, S, G, H // G, N) \
            .reshape(Bsz, S, H, N)
    dt = F.softplus(dt + w["dt_bias"])
    xh = xs.reshape(Bsz, S, H, P)
    y = ssd(xh, dt, -torch.exp(w["A_log"]), heads(Bm), heads(Cm),
            s["chunk_size"])
    y = (y + w["D"][:, None] * xh).reshape(Bsz, S, d_in)
    y = rmsnorm(y * silu(z), w["norm.scale"], m["norm_eps"], G)
    return lowp.mm(y, w["out_proj.w"], prec)


def _attn_rows(m, prec, q, k, v, r0):
    """Rows r0.. of causal attention: q (B H, R, Dh), k, v (B H, S, Dh)."""
    R, S = q.shape[1], k.shape[1]
    scale = (m["head_dim"] / 2) ** -0.5
    s = lowp.bmm(q, k.transpose(1, 2), prec) * scale
    keep = torch.arange(S, device=q.device)[None, :] \
        <= (r0 + torch.arange(R, device=q.device))[:, None]
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return lowp.bmm(p, v, prec)


def shared_block(m, prec, h, e, w, adapter_a, adapter_b, remat=True):
    """t of the hybrid layer: the shared block w with the invocation's
    adapter."""
    B, S, d = h.shape
    Hh, Dh = m["num_heads"], m["head_dim"]
    c = rmsnorm(torch.cat([h, e], dim=-1), w["norm.scale"], m["norm_eps"])

    def proj(name, rot):
        t = lowp.mm(c, w[name], prec).reshape(B, S, Hh, Dh)
        t = rope(t, m["rope_theta"]) if rot else t
        return t.permute(0, 2, 1, 3).reshape(B * Hh, S, Dh)
    q, k, v = proj("attn.wq.w", True), proj("attn.wk.w", True), \
        proj("attn.wv.w", False)
    outs = [_remat(remat, _attn_rows, m, prec, q[:, r:r + ATTN_ROWS], k, v,
                   r) for r in range(0, S, ATTN_ROWS)]
    o = torch.cat(outs, dim=1).reshape(B, Hh, S, Dh).permute(0, 2, 1, 3) \
        .reshape(B, S, Hh * Dh)
    a = lowp.mm(o, w["attn.wo.w"], prec)
    n = rmsnorm(a, w["ffn_norm.scale"], m["norm_eps"])
    gu = lowp.mm(n, w["mlp.gate_up.w"], prec) \
        + lowp.mm(lowp.mm(n, adapter_a, prec), adapter_b, prec)
    g, u = torch.chunk(gu, 2, dim=-1)
    return lowp.mm(gelu(g) * u, w["mlp.down.w"], prec)


def mamba_layer(m, prec, h, w):
    return h + mamba2(m, prec, rmsnorm(h, w["norm.scale"], m["norm_eps"]),
                      {k[len("mamba."):]: v for k, v in w.items()
                       if k.startswith("mamba.")})


def hybrid_layer(m, prec, h, e, w, shared, remat=True):
    t = shared_block(m, prec, h, e, shared, w["adapter.a.w"],
                     w["adapter.b.w"], remat)
    T = lowp.mm(t, w["linear.w"], prec)
    x = rmsnorm(h + T, w["norm.scale"], m["norm_eps"])
    return h + mamba2(m, prec, x, {k[len("mamba."):]: v for k, v in w.items()
                                   if k.startswith("mamba.")})


def _remat(remat, fn, *args):
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _nll_chunk(prec, V, h, table, labels, keep):
    lp = torch.log_softmax(lowp.mm(h, table.t(), prec)[:, :V], dim=-1)
    return -(lp.gather(-1, labels[:, None])[:, 0] * keep).sum()


def loss(m, w, tokens, labels, prec="fp32", half=False, remat=True):
    """The mean next-token cross entropy.  tokens, labels (B, S) int64.
    half: the fault that leaves out half of the batch's tokens (the later
    half of the flattened rows) and takes the mean over the rest.
    remat=False keeps every activation (the tests count FLOPs without the
    recomputation)."""
    B, S = tokens.shape
    n_per = m["num_layers"] // PERIOD
    e = w["embed.w"][tokens]
    h = e
    mem = [{k[len(f"stack.mem_blocks.{b}."):]: v for k, v in w.items()
            if k.startswith(f"stack.mem_blocks.{b}.")}
           for b in range(m["num_mem_blocks"])]
    for per in range(n_per):
        for i in range(PERIOD):
            pre = f"stack.pattern.{i}."
            lw = {k[len(pre):]: v[per] for k, v in w.items()
                  if k.startswith(pre)}
            if i < PERIOD - 1:
                h = _remat(remat, mamba_layer, m, prec, h, lw)
            else:
                blk = mem[per % m["num_mem_blocks"]]
                h = _remat(remat, hybrid_layer, m, prec, h, e, lw, blk,
                           remat)
    h = rmsnorm(h, w["final_norm.scale"], m["norm_eps"]).reshape(B * S, -1)
    n = B * S
    keep = torch.arange(n, device=tokens.device) < (n // 2 if half else n)
    lab = labels.reshape(n)
    nll = 0.0
    for r in range(0, n, CE_ROWS):
        sl = slice(r, r + CE_ROWS)
        nll = nll + _remat(remat, _nll_chunk, prec, m["vocab_size"], h[sl],
                           w["embed.w"], lab[sl], keep[sl])
    return nll / keep.sum()


def _grads(m, params, *args, **kw):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = loss(m, leaves, *args, **kw)
    gs = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, gs))


def stored(m, params):
    """The fp32 master as the configuration stores it, back in fp32."""
    dtype = DTYPES[m["dtype"]]
    return {k: v if _leaf(k) in FP32_LEAVES else v.to(dtype).to(torch.float32)
            for k, v in params.items()}


def run(m, opt_cfg: dict, seed: int, batches, gen=None, *, prec="fp32",
        half=False, device=None) -> dict:
    """The first len(batches) steps from the benchmark's weights for
    `seed`; batches a list of (tokens, labels) (B, S) int64 on the device
    (`gen` is unused: the step draws nothing).  Returns {"losses", "grad"
    (the first moment after step 1 over 1 - b1, a norm a leaf), "change"
    (a norm a leaf)}."""
    params = make_weights(m, seed, device, torch.float32)
    opt = AdamW(params, warmup_cosine(opt_cfg["lr"], opt_cfg["warmup"],
                                      opt_cfg["schedule_steps"]),
                weight_decay=opt_cfg["weight_decay"], clip=opt_cfg["clip"])
    losses, grad = [], None
    for tokens, labels in batches:
        value, g = _grads(m, stored(m, params), tokens, labels, prec, half)
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
