"""Primitive layers: dense.

Reference: src/repro/models/layers.py (`dense_init`, `dense`).  Weights are
stored as the reference stores them, (d_in, d_out), so `y = x @ w + b`
and converted JAX weights copy over unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               device=None):
    """fp32 {"w": (d_in, d_out) N(0, scale^2), "b": zeros} with scale
    defaulting to 1/sqrt(d_in); drawn from `generator` on its device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": torch.randn((d_in, d_out), generator=generator,
                          device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y
