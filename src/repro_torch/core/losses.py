"""Metrics of the in-network-learning objective.

Reference: src/repro/core/losses.py (`accuracy`).  The eq.-(6) loss itself
(`inl_loss`, `xent`) comes with the training slice of the port.
"""
from __future__ import annotations

import torch


def accuracy(logits, labels):
    """Top-1 accuracy over the labels >= 0, as an fp32 scalar tensor."""
    pred = torch.argmax(logits, dim=-1)
    mask = labels >= 0
    hits = ((pred == labels) & mask).sum()
    return (hits / torch.clamp(mask.sum(), min=1)).to(torch.float32)
