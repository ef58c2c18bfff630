"""State-space blocks: Mamba2 (SSD) and its causal depthwise conv.

Reference: src/repro/models/ssm.py (`conv1d_init`, `conv1d_causal`,
`conv1d_step`, `mamba2_init`, `mamba2_param_count`, `mamba2_make_state`,
`mamba2_apply`).  Prefill runs the chunked SSD scan through
`kernels/ops.ssd_scan`: the scan kernel on the card, its plain version on
the CPU (the reference's model runs the same contract as the jnp
`_ssd_chunked`).  Decode is the one-step recurrence in plain torch.  The
xLSTM blocks come with a later slice of the LLM stack.

A_log, D and dt_bias are fp32 whatever the model's dtype, as in the
reference.  The decode step writes the new SSM and conv states into the
given state in place and returns it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers


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

def mamba2_init(generator, cfg, dtype, device=None):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    H = s.num_heads(d)
    N = s.state_dim
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
    N = s.state_dim
    n = d * (2 * d_in + 2 * N + H)                      # in_proj
    n += s.conv_width * (d_in + 2 * N) + (d_in + 2 * N)  # conv
    n += 3 * H + d_in                                   # A_log, D, dt_bias, norm
    n += d_in * d                                       # out_proj
    return n


def mamba2_make_state(cfg, batch: int, dtype, device=None):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    return {
        "ssm": torch.zeros((batch, H, s.state_dim, s.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * s.state_dim),
                            dtype=dtype, device=device),
    }


def mamba2_apply(p, cfg, x, *, mode: str, state=None):
    """x: (B, S, d).  Returns (y, new_state): on 'prefill' the final SSM
    state of the scan and the last width-1 rows of the pre-activation conv
    input; on 'decode' (S == 1) `state`, updated in place."""
    s = cfg.ssm
    Bsz, S, d = x.shape
    d_in = s.d_inner(d)
    H = s.num_heads(d)
    N = s.state_dim
    P = s.head_dim

    zxbcdt = layers.dense(p["in_proj"], x)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    A = -torch.exp(p["A_log"])

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode takes one token and a state")
        xbc_t, conv_state = conv1d_step(p["conv"], xbc[:, 0], state["conv"])
        xbc_t = F.silu(xbc_t)
        xh = xbc_t[:, :d_in].reshape(Bsz, H, P)
        Bm = xbc_t[:, d_in:d_in + N]
        Cm = xbc_t[:, d_in + N:]
        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
        dA = torch.exp(dt * A)                           # (B, H)
        # state update: S <- S exp(dt A) + dt B x^T
        upd = torch.einsum("bh,bn,bhp->bhnp", dt, Bm.float(), xh.float())
        ssm_state = state["ssm"] * dA[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm.float(), ssm_state)
        y = y + p["D"][None, :, None] * xh.float()
        y = y.reshape(Bsz, 1, d_in)
        state["ssm"].copy_(ssm_state)
        state["conv"].copy_(conv_state)
        new_state = state
    elif mode == "prefill":
        xbc_act = F.silu(conv1d_causal(p["conv"], xbc))
        xh = xbc_act[..., :d_in].reshape(Bsz, S, H, P).contiguous()
        Bm = xbc_act[..., d_in:d_in + N].contiguous()
        Cm = xbc_act[..., d_in + N:].contiguous()
        dt = F.softplus(dt_raw.float() + p["dt_bias"]).contiguous()
        y, fin = ops.ssd_scan(xh, dt, A.contiguous(), Bm, Cm,
                              p["D"].contiguous(), chunk=s.chunk_size)
        y = y.reshape(Bsz, S, d_in)
        # the conv state holds the last width-1 rows of the PRE-activation
        # conv input, zero rows in front when S < width-1
        w1 = s.conv_width - 1
        tail = F.pad(xbc, (0, 0, max(0, w1 - S), 0))[:, -w1:]
        new_state = {"ssm": fin, "conv": tail.contiguous()}
    else:
        raise NotImplementedError(
            f"mamba2 mode {mode!r}: the port serves (prefill, decode); "
            "training comes with the LLM training slice (ROADMAP queue 1, "
            "item 6)")
    y = layers.rmsnorm(p["norm"], y.to(x.dtype) * F.silu(z), cfg.norm_eps)
    return layers.dense(p["out_proj"], y), new_state
