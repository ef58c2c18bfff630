"""State-space and recurrent blocks: Mamba2 (SSD), its causal depthwise
conv, and xLSTM's mLSTM and sLSTM blocks.

Reference: src/repro/models/ssm.py (`conv1d_init`, `conv1d_causal`,
`conv1d_step`, `mamba2_init`, `mamba2_param_count`, `_ssd_chunked`,
`mamba2_make_state`, `mamba2_apply`, `_scan_chunked_remat`, `mlstm_init`,
`mlstm_param_count`, `mlstm_make_state`, `_mlstm_cell`, `mlstm_apply`,
`slstm_init`, `slstm_param_count`, `slstm_make_state`, `_slstm_cell`,
`slstm_apply`).  Mamba2's prefill and train forward run the chunked SSD
scan through `kernels/ops.ssd_scan`: the scan kernel on the card, its
plain version on the CPU (the reference's model runs the same contract
as the jnp `_ssd_chunked`).  In train mode `_ssd_chunked` is an autograd
Function whose backward recomputes the plain fp32 `ssd_chunked_ref` and
differentiates it, the function the reference differentiates.  Decode is
the one-step recurrence in plain torch.

The xLSTM recurrences are plain torch, as the reference's are jnp (it
has no kernel for them): a prefill runs the cell once a step, in order.
Train mode runs the same steps through `_scan_chunked_remat`, which
checkpoints chunks of `cfg.ssm.chunk_size` steps so that the backward
keeps one carry a chunk, not one a step.

With `cfg.ssm.ngroups` G > 1 (Zamba2-7B) B and C come in G groups, head h
reading group h // (H / G): the in-projection gives 2 d_in + 2 G N + H
columns, the conv runs over d_in + 2 G N channels, the scan takes B and C
(B, S, G, N), and the gated norm runs over G groups of d_in / G channels;
G = 1 is the layout and the arithmetic of the reference's ngroups = 1.

A_log, D and dt_bias, and every xLSTM state but the conv's, are fp32
whatever the model's dtype, as in the reference.  A decode step writes
the new states into the given state in place and returns it.

Tracing: the span "repro.ssm.scan" around a train-mode scan's forward
launch and "repro.ssm.scan_bwd" around its backward recompute, which is
also the device-timed sub-mark "ssd_backward" (`tracing.submark`) and
counts one `LAUNCHES["ssd_scan_bwd"]`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import tracing
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

LAUNCHES = tracing.launch_counter(("ssd_scan_bwd",))


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (mamba's local conv)
# ---------------------------------------------------------------------------

def conv1d_init(generator, channels: int, width: int, dtype, device=None):
    w = torch.randn((width, channels), generator=generator,
                    device=device) / math.sqrt(width)
    return {"w": w.to(dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=device)}


def conv1d_causal(p, x):
    """x: (B, S, C) -> (B, S, C), causal depthwise: out_t = sum_k w_k
    x_{t - width + 1 + k} + b, summed in fp32."""
    w = p["w"]
    width, S = w.shape[0], x.shape[1]
    xp = F.pad(x.to(w.dtype), (0, 0, width - 1, 0)).float()
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for k in range(1, width):
        out = out + xp[:, k:k + S] * wf[k]
    return out.to(w.dtype) + p["b"]


def conv1d_step(p, x_t, conv_state):
    """One decode step.  x_t: (B, C); conv_state: (B, width-1, C).
    Returns (out (B, C), the new conv state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, w, C)
    out = (window.float() * p["w"].float()).sum(dim=1).to(x_t.dtype) \
        + p["b"]
    return out, window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def _bc_width(s) -> int:
    """Columns of B (and of C) in the in-projection: ngroups * state_dim."""
    return s.ngroups * s.state_dim


def mamba2_init(generator, cfg, dtype, device=None):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    H = s.num_heads(d)
    N = _bc_width(s)
    # in_proj -> [z, x, B, C, dt]
    proj_out = 2 * d_in + 2 * N + H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": layers.dense_init(generator, d, proj_out, dtype=dtype,
                                     device=device),
        "conv": conv1d_init(generator, d_in + 2 * N, s.conv_width, dtype,
                            device),
        "A_log": torch.zeros((H,), **f32),          # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),   # softplus(-2) ~ 0.127
        "norm": layers.rmsnorm_init(d_in, dtype, device),
        "out_proj": layers.dense_init(generator, d_in, d, dtype=dtype,
                                      device=device),
    }


def mamba2_param_count(cfg) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    H = s.num_heads(d)
    N = _bc_width(s)
    n = d * (2 * d_in + 2 * N + H)                      # in_proj
    n += s.conv_width * (d_in + 2 * N) + (d_in + 2 * N)  # conv
    n += 3 * H + d_in                                   # A_log, D, dt_bias, norm
    n += d_in * d                                       # out_proj
    return n


class _SSDChunked(torch.autograd.Function):
    """The chunked SSD scan with a gradient: forward `ops.ssd_scan` (the
    kernel on the card, `ref.ssd_chunked_ref` on the CPU); backward
    recomputes `ref.ssd_chunked_ref` in fp32 from the six saved inputs
    and differentiates it, each gradient cast to its input's dtype."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, dskip, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bm, cm, dskip)
        with tracing.span("ssm.scan"):
            return ops.ssd_scan(x, dt, a, bm, cm, dskip, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        LAUNCHES["ssd_scan_bwd"] += 1
        with tracing.span("ssm.scan_bwd"), \
                tracing.submark("ssd_backward", saved[0].device), \
                torch.enable_grad():
            ins = [t.detach().float().requires_grad_(True) for t in saved]
            outs = ref.ssd_chunked_ref(*ins, chunk=ctx.chunk)
            pairs = [(o, g.float()) for o, g in zip(outs, (gy, gstate))
                     if g is not None]
            if not pairs:
                return (None,) * 7
            grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        # cm reaches y only: zero when only the state's cotangent comes
        return (*(torch.zeros_like(t) if g is None else g.to(t.dtype)
                  for g, t in zip(grads, saved)), None)


def _ssd_chunked(x, dt, a, bm, cm, dskip, chunk: int):
    """The chunked SSD scan, differentiable in all six inputs.  Shapes and
    dtypes as `ops.ssd_scan`; returns (y (B, S, H, P) in x's dtype, final
    state (B, H, N, P) fp32).  The backward holds a handful of (B, nc,
    chunk, chunk, H) fp32 intermediates of the recompute at a time."""
    return _SSDChunked.apply(x, dt, a, bm, cm, dskip, chunk)


def mamba2_make_state(cfg, batch: int, dtype, device=None):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    return {
        "ssm": torch.zeros((batch, H, s.state_dim, s.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * _bc_width(s)),
                            dtype=dtype, device=device),
    }


def mamba2_apply(p, cfg, x, *, mode: str, state=None):
    """x: (B, S, d).  Returns (y, new_state): on 'prefill' the final SSM
    state of the scan and the last width-1 rows of the pre-activation conv
    input; on 'decode' (S == 1) `state`, updated in place; on 'train' no
    state (None), the scan through `_ssd_chunked`'s gradient."""
    s = cfg.ssm
    Bsz, S, d = x.shape
    d_in = s.d_inner(d)
    H = s.num_heads(d)
    G, N = s.ngroups, s.state_dim
    GN = G * N
    P = s.head_dim

    zxbcdt = layers.dense(p["in_proj"], x)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_in + 2 * GN, H], dim=-1)
    A = -torch.exp(p["A_log"])

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode takes one token and a state")
        xbc_t, conv_state = conv1d_step(p["conv"], xbc[:, 0], state["conv"])
        xbc_t = layers.silu(xbc_t)
        xh = xbc_t[:, :d_in].reshape(Bsz, H, P)
        Bm = xbc_t[:, d_in:d_in + GN]
        Cm = xbc_t[:, d_in + GN:]
        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
        dA = torch.exp(dt * A)                           # (B, H)
        # state update: S <- S exp(dt A) + dt B x^T, group by group (the
        # heads of group g read its B and C)
        hs = [slice(g * (H // G), (g + 1) * (H // G)) for g in range(G)]
        Bm, Cm = (t.float().reshape(Bsz, G, N) for t in (Bm, Cm))
        upd = torch.cat([torch.einsum("bh,bn,bhp->bhnp", dt[:, h], Bm[:, g],
                                      xh[:, h].float())
                         for g, h in enumerate(hs)], dim=1)
        ssm_state = state["ssm"] * dA[..., None, None] + upd
        y = torch.cat([torch.einsum("bn,bhnp->bhp", Cm[:, g], ssm_state[:, h])
                       for g, h in enumerate(hs)], dim=1)
        y = y + p["D"][None, :, None] * xh.float()
        y = y.reshape(Bsz, 1, d_in)
        state["ssm"].copy_(ssm_state)
        state["conv"].copy_(conv_state)
        new_state = state
    elif mode in ("prefill", "train"):
        xbc_act = layers.silu(conv1d_causal(p["conv"], xbc))
        xh = xbc_act[..., :d_in].reshape(Bsz, S, H, P).contiguous()
        Bm = xbc_act[..., d_in:d_in + GN]
        Cm = xbc_act[..., d_in + GN:]
        if G > 1:
            Bm, Cm = (t.reshape(Bsz, S, G, N) for t in (Bm, Cm))
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
        dt = F.softplus(dt_raw.float() + p["dt_bias"]).contiguous()
        scan = ops.ssd_scan if mode == "prefill" else _ssd_chunked
        y, fin = scan(xh, dt, A.contiguous(), Bm, Cm, p["D"].contiguous(),
                      chunk=s.chunk_size)
        y = y.reshape(Bsz, S, d_in)
        new_state = None
        if mode == "prefill":
            # the conv state holds the last width-1 rows of the
            # PRE-activation conv input, zero rows in front when S < width-1
            w1 = s.conv_width - 1
            tail = F.pad(xbc, (0, 0, max(0, w1 - S), 0))[:, -w1:]
            new_state = {"ssm": fin, "conv": tail.contiguous()}
    else:
        raise ValueError(f"mamba2 mode {mode!r}: train, prefill or decode")
    y = layers.group_rmsnorm(p["norm"], y.to(x.dtype) * layers.silu(z), G,
                             cfg.norm_eps)
    return layers.dense(p["out_proj"], y), new_state


# ---------------------------------------------------------------------------
# The time scan of the xLSTM cells
# ---------------------------------------------------------------------------

def _scan_steps(cell, carry, seq):
    """Run cell once a step, in order.  seq: a tuple of (B, T, ...)
    tensors; cell: (carry, (one (B, ...) slice of each)) -> (carry, y).
    Returns (the last carry, the ys stacked on axis 1)."""
    ys = []
    for t in range(seq[0].shape[1]):
        carry, y = cell(carry, tuple(x[:, t] for x in seq))
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _scan_chunked_remat(cell, init, seq, S: int, chunk: int):
    """The time scan with chunk-level rematerialisation: the S steps run in
    chunks of `chunk`, each under a non-reentrant checkpoint, so the
    backward keeps the carry at each chunk's start and recomputes the
    chunk's steps (S/chunk carries saved, not S).  The steps and their
    values are `_scan_steps`' exactly; the plain loop runs when chunk does
    not divide S or holds it whole, as in the reference.  Inside the
    stack's period checkpoint each level recomputes once."""
    chunk = min(chunk, S)
    if S % chunk or S == chunk:
        return _scan_steps(cell, init, seq)
    carry, ys = init, []
    for lo in range(0, S, chunk):
        part = tuple(x[:, lo:lo + chunk] for x in seq)
        carry, y = torch.utils.checkpoint.checkpoint(
            _scan_steps, cell, carry, part, use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block (matrix memory)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg):
    """(d_in, H, dh): the up-projected width and its heads.  dh is
    d_in // num_heads, not cfg.head_dim."""
    d_in = cfg.ssm.expand * cfg.d_model
    return d_in, cfg.num_heads, d_in // cfg.num_heads


def mlstm_init(generator, cfg, dtype, device=None):
    d = cfg.d_model
    d_in, H, _ = _mlstm_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "up": layers.dense_init(generator, d, 2 * d_in, **kw),  # [x_m, z]
        "conv": conv1d_init(generator, d_in, cfg.ssm.conv_width, dtype,
                            device),
        "wq": layers.dense_init(generator, d_in, d_in, **kw),
        "wk": layers.dense_init(generator, d_in, d_in, **kw),
        "wv": layers.dense_init(generator, d_in, d_in, **kw),
        "w_if": layers.dense_init(generator, d_in, 2 * H, **kw),  # i, f
        "norm": layers.rmsnorm_init(d_in, dtype, device),
        "down": layers.dense_init(generator, d_in, d, **kw),
    }


def mlstm_param_count(cfg) -> int:
    d = cfg.d_model
    d_in, H, _ = _mlstm_dims(cfg)
    n = d * 2 * d_in                                     # up
    n += cfg.ssm.conv_width * d_in + d_in                # conv
    n += 3 * d_in * d_in                                 # q, k, v
    n += d_in * 2 * H                                    # gates
    n += d_in + d_in * d                                 # norm + down
    return n


def mlstm_make_state(cfg, batch: int, dtype, device=None):
    d_in, H, dh = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, dh, dh), **f32),
        "n": torch.zeros((batch, H, dh), **f32),
        "m": torch.full((batch, H), -1e30, **f32),
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, d_in),
                            dtype=dtype, device=device),
    }


def _log_sigmoid(x):
    """log sigmoid(x) as the reference writes it, -softplus(-x)."""
    return -F.softplus(-x)


def _mlstm_cell(carry, qkvif):
    """One step of the stabilised mLSTM recurrence, all fp32.  carry: (C
    (B, H, dh_k, dh_v), n (B, H, dh), m (B, H)); qkvif: q, k, v (B, H, dh)
    and the raw gates i, f (B, H).  Returns (the new carry, h (B, H,
    dh))."""
    C, n, m = carry
    q, k, v, i_raw, f_raw = qkvif
    log_f = _log_sigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C_new, q)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)).clamp(min=1.0)
    return (C_new, n_new, m_new), num / den[..., None]


def mlstm_apply(p, cfg, x, *, mode: str, state=None):
    """x: (B, S, d).  Returns (y, new_state): on 'prefill' the final (C, n,
    m) of the recurrence and the last width-1 rows of the pre-conv branch;
    on 'decode' (S == 1) `state`, updated in place; on 'train' no state
    (None), the steps through `_scan_chunked_remat`."""
    Bsz, S, _ = x.shape
    d_in, H, dh = _mlstm_dims(cfg)
    xm, z = torch.chunk(layers.dense(p["up"], x), 2, dim=-1)

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode takes one token and a state")
        xc, conv_state = conv1d_step(p["conv"], xm[:, 0], state["conv"])
        xc = layers.silu(xc)[:, None]
    elif mode in ("prefill", "train"):
        xc = layers.silu(conv1d_causal(p["conv"], xm))
    else:
        raise ValueError(f"mlstm mode {mode!r}: train, prefill or decode")

    def heads(t):
        return t.reshape(Bsz, -1, H, dh).float()

    # q and k are cast to fp32 before the scale; v comes from the
    # pre-conv branch
    q = heads(layers.dense(p["wq"], xc)) / math.sqrt(dh)
    k = heads(layers.dense(p["wk"], xc)) / math.sqrt(dh)
    v = heads(layers.dense(p["wv"], xm))
    gates = layers.dense(p["w_if"], xc).float().reshape(Bsz, -1, 2, H)
    i_raw, f_raw = gates[:, :, 0], gates[:, :, 1]        # (B, S, H)

    if mode == "decode":
        carry = (state["C"], state["n"], state["m"])
        (C, n, m), h = _mlstm_cell(carry, (q[:, 0], k[:, 0], v[:, 0],
                                           i_raw[:, 0], f_raw[:, 0]))
        h = h[:, None]                                   # (B, 1, H, dh)
        for name, t in (("C", C), ("n", n), ("m", m), ("conv", conv_state)):
            state[name].copy_(t)
        new_state = state
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        carry = (torch.zeros((Bsz, H, dh, dh), **f32),
                 torch.zeros((Bsz, H, dh), **f32),
                 torch.full((Bsz, H), -1e30, **f32))
        seq = (q, k, v, i_raw, f_raw)
        if mode == "train":
            carry, h = _scan_chunked_remat(_mlstm_cell, carry, seq, S,
                                           cfg.ssm.chunk_size)
            new_state = None
        else:
            carry, h = _scan_steps(_mlstm_cell, carry, seq)
            # the conv state holds the last width-1 rows of the raw xm,
            # zero rows in front when S < width-1
            w1 = cfg.ssm.conv_width - 1
            tail = F.pad(xm, (0, 0, max(0, w1 - S), 0))[:, -w1:]
            new_state = {"C": carry[0], "n": carry[1], "m": carry[2],
                         "conv": tail.contiguous()}

    h = h.reshape(Bsz, -1, d_in).to(x.dtype)
    h = layers.rmsnorm(p["norm"], h, cfg.norm_eps) * layers.silu(z)
    return layers.dense(p["down"], h), new_state


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (scalar memory, recurrent gates)
# ---------------------------------------------------------------------------

def _slstm_dims(cfg):
    """(H, dh, ff): heads, head width and the gated FFN's width (pf=4/3,
    rounded up to a multiple of 64)."""
    d = cfg.d_model
    H = cfg.num_heads
    return H, d // H, int(math.ceil(4 / 3 * d / 64) * 64)


def slstm_init(generator, cfg, dtype, device=None):
    d = cfg.d_model
    H, dh, ff = _slstm_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    r = torch.randn((H, dh, 4 * dh), generator=generator,
                    device=device) / math.sqrt(dh)
    return {
        "wx": layers.dense_init(generator, d, 4 * d, **kw),  # i, f, z, o
        "r": r.to(dtype),                                # block-diagonal
        "norm": layers.rmsnorm_init(d, dtype, device),
        "ffn": layers.mlp_init(generator, d, ff, act="silu", **kw),
        "ffn_norm": layers.rmsnorm_init(d, dtype, device),
    }


def slstm_param_count(cfg) -> int:
    d = cfg.d_model
    H, dh, ff = _slstm_dims(cfg)
    return d * 4 * d + H * dh * 4 * dh + 2 * d + 3 * d * ff


def slstm_make_state(cfg, batch: int, dtype, device=None):
    H, dh, _ = _slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "h": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H, dh), -1e30, **f32)}


def _slstm_cell(p_r, carry, x_gates, H, dh):
    """One step.  carry: (c, n, h, m), each (B, H, dh) fp32; x_gates: (B,
    4d) pre-activations from the input path; p_r: the recurrent weight
    (H, dh, 4 dh), in any dtype (cast to fp32 here).  Returns the new
    carry."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hde->bhe", h, p_r.float())   # (B, H, 4 dh)
    g = x_gates.reshape(-1, H, 4, dh).float() + rec.reshape(-1, H, 4, dh)
    i_raw, f_raw, z_raw, o_raw = g.unbind(dim=2)
    log_f = _log_sigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_raw)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_raw) * c_new / n_new.clamp(min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_apply(p, cfg, x, *, mode: str, state=None):
    """x: (B, S, d).  Returns (y, new_state): on 'prefill' the final (c, n,
    h, m); on 'decode' (S == 1) `state`, updated in place; on 'train' no
    state (None), the steps through `_scan_chunked_remat`.  The block's
    FFN residual sits inside it: y = h + mlp(ffn_norm(h)), h = norm(hs)."""
    Bsz, S, d = x.shape
    H, dh, _ = _slstm_dims(cfg)
    xg = layers.dense(p["wx"], x)                        # (B, S, 4d)
    r = p["r"].float()                                   # cast once

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode takes one token and a state")
        carry = _slstm_cell(r, (state["c"], state["n"], state["h"],
                                state["m"]), xg[:, 0], H, dh)
        hs = carry[2][:, None]                           # (B, 1, H, dh)
        for name, t in zip(("c", "n", "h", "m"), carry):
            state[name].copy_(t)
        new_state = state
    elif mode in ("prefill", "train"):
        f32 = dict(dtype=torch.float32, device=x.device)
        carry = (torch.zeros((Bsz, H, dh), **f32),
                 torch.zeros((Bsz, H, dh), **f32),
                 torch.zeros((Bsz, H, dh), **f32),
                 torch.full((Bsz, H, dh), -1e30, **f32))

        def step(carry, g_t):
            new = _slstm_cell(r, carry, g_t[0], H, dh)
            return new, new[2]
        if mode == "train":
            carry, hs = _scan_chunked_remat(step, carry, (xg,), S,
                                            cfg.ssm.chunk_size)
            new_state = None
        else:
            carry, hs = _scan_steps(step, carry, (xg,))  # (B, S, H, dh)
            new_state = dict(zip(("c", "n", "h", "m"), carry))
    else:
        raise ValueError(f"slstm mode {mode!r}: train, prefill or decode")

    h = layers.rmsnorm(p["norm"], hs.reshape(Bsz, -1, d).to(x.dtype),
                       cfg.norm_eps)
    out = h + layers.mlp(
        p["ffn"], layers.rmsnorm(p["ffn_norm"], h, cfg.norm_eps), act="silu")
    return out, new_state
