"""Primitive layers: dense, norms, embeddings, rotary, MLPs.

Reference: src/repro/models/layers.py.  Weights are stored as the reference
stores them, dense (d_in, d_out) so `y = x @ w + b`, embeddings
(vocab_padded, d), so converted JAX weights copy over unchanged.  Params
are kept in the config's dtype; the numerically sensitive steps (the norm's
mean square, rotary angles) run in fp32, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               dtype=torch.float32, device=None):
    """{"w": (d_in, d_out) N(0, scale^2), "b": zeros} in `dtype`, with
    scale defaulting to 1/sqrt(d_in); drawn in fp32 from `generator` on its
    device, then cast."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": (torch.randn((d_in, d_out), generator=generator,
                           device=device) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    """RMS norm in fp32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def group_rmsnorm(p, x, groups: int, eps: float = 1e-5):
    """RMS norm over each of `groups` equal parts of the last axis (Mamba2's
    gated norm with ngroups > 1), one scale over the whole axis; groups=1
    is `rmsnorm`, bit for bit."""
    xf = x.float().unflatten(-1, (groups, -1))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).flatten(-2)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def pad_vocab(vocab_size: int, multiple: int = 128) -> int:
    """Pad vocab so the embedding/vocab dim shards cleanly on a 16-way axis."""
    return int(-(-vocab_size // multiple) * multiple)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None):
    w = torch.randn((pad_vocab(vocab), d), generator=generator,
                    device=device) * 0.02
    return {"w": w.to(dtype)}


def embed(p, tokens):
    return p["w"][tokens]


def unembed(p, x, vocab: int):
    """Project to (padded) vocab logits with the tied table, cropped to the
    true vocab."""
    return (x @ p["w"].T)[..., :vocab]


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


# the inverse frequencies by (head_dim, theta, device), moved to the device
# once: a decode step then copies nothing from the host, so its CUDA graph
# can be captured (the first call, eager, fills the entry)
_INV_FREQ = {}


def _inv_freq(d: int, theta: float, device) -> torch.Tensor:
    key = (d, float(theta), torch.device(device))
    t = _INV_FREQ.get(key)
    if t is None:
        t = torch.from_numpy(rope_frequencies(d, theta)).to(device)
        _INV_FREQ[key] = t
    return t


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates the
    split halves (x1, x2) of the head dim, in fp32."""
    d = x.shape[-1]
    inv_freq = _inv_freq(d, theta, x.device)
    angles = positions[..., :, None].float() * inv_freq     # (..., S, D/2)
    angles = angles[..., None, :]                          # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _weak(v: float, dtype) -> float:
    """A Python constant as the reference's weak-typed constant: rounded to
    `dtype` (in bf16 0.044715 is 0.044677734375)."""
    return float(torch.tensor(v, dtype=dtype))


def silu(x):
    """jax.nn.silu as the reference computes it, x * (1 / (1 + exp(-x))),
    each op in x's dtype: in bf16 the exp, the sum, the reciprocal and the
    product each round to bf16, where torch's F.silu rounds once (and
    about a third of an MLP's bf16 activations would differ)."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def gelu_tanh(x):
    """jax.nn.gelu's default, the tanh approximation (torch's F.gelu
    defaults to the exact erf form), in the reference's ops and dtype:
    x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x (x x))))."""
    c = _weak(math.sqrt(2.0 / math.pi), x.dtype)
    a = _weak(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * (x * x)))))
    return x * cdf


def gelu_exact(x):
    """The exact GELU, x Phi(x) by erf (torch's default form)."""
    return F.gelu(x)


_ACTS = {"silu": silu, "gelu": gelu_tanh, "relu": F.relu,
         "gelu_exact": gelu_exact}


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
             act: str = "silu", dtype=torch.float32, device=None):
    """act == 'silu': the gated SwiGLU MLP (wi, wg, wo); any other act: the
    plain 2-layer MLP (wi, wo)."""
    kw = dict(dtype=dtype, device=device)
    p = {"wi": dense_init(generator, d_model, d_ff, **kw)}
    if act == "silu":
        p["wg"] = dense_init(generator, d_model, d_ff, **kw)
    p["wo"] = dense_init(generator, d_ff, d_model, **kw)
    return p


def mlp(p, x, *, act: str = "silu"):
    f = _ACTS[act]
    h = f(dense(p["wi"], x))
    if "wg" in p:
        h = h * dense(p["wg"], x)
    return dense(p["wo"], h)


def mlp_param_count(d_model: int, d_ff: int, act: str = "silu") -> int:
    return (3 if act == "silu" else 2) * d_model * d_ff


def gated_mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
                   dtype=torch.float32, device=None):
    """Zamba2's gated MLP: one (d_model, 2 d_ff) gate/up matrix, whose
    output halves are [gate, up], and the (d_ff, d_model) down matrix."""
    kw = dict(dtype=dtype, device=device)
    return {"gate_up": dense_init(generator, d_model, 2 * d_ff, **kw),
            "down": dense_init(generator, d_ff, d_model, **kw)}


def adapter_init(generator: torch.Generator, d_in: int, rank: int,
                 d_out: int, *, dtype=torch.float32, device=None):
    """A rank-`rank` adapter x A B: A drawn, B zeros (a no-op at init)."""
    kw = dict(dtype=dtype, device=device)
    return {"a": dense_init(generator, d_in, rank, **kw),
            "b": {"w": torch.zeros((rank, d_out), **kw)}}


def gated_mlp(p, x, *, act: str, adapter=None):
    """down(act(g) * u), [g, u] = x gate_up (+ x A B with an adapter)."""
    gu = dense(p["gate_up"], x)
    if adapter is not None:
        gu = gu + dense(adapter["b"], dense(adapter["a"], x))
    g, u = torch.chunk(gu, 2, dim=-1)
    return dense(p["down"], _ACTS[act](g) * u)
