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

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
             act: str = "silu", dtype=torch.float32, device=None):
    """The gated SwiGLU MLP (3 mats), act == 'silu'.  The reference's plain
    2-layer MLP for other activations comes with the configs that use it
    (a later slice of the LLM stack)."""
    if act != "silu":
        raise NotImplementedError(
            f"mlp act {act!r}: only SwiGLU is ported; the others come with "
            "a later slice of the LLM stack (ROADMAP queue 1, item 6)")
    kw = dict(dtype=dtype, device=device)
    return {"wi": dense_init(generator, d_model, d_ff, **kw),
            "wg": dense_init(generator, d_model, d_ff, **kw),
            "wo": dense_init(generator, d_ff, d_model, **kw)}


def mlp(p, x):
    return dense(p["wo"], F.silu(dense(p["wi"], x)) * dense(p["wg"], x))


def mlp_param_count(d_model: int, d_ff: int, act: str = "silu") -> int:
    return (3 if act == "silu" else 2) * d_model * d_ff
