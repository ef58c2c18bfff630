"""Adam with decoupled weight decay, as the references run it: b1 0.9, b2
0.95, eps 1e-8 outside the root, bias corrections on the step count, the
gradients scaled so that their global norm is at most `clip`, fp32
throughout.  `lr` is a number, or a function of the (1-based) step as an
fp32 tensor.  Plain torch, on dicts of named tensors.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def warmup_cosine(peak: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    """Linear warm-up to `peak` over `warmup` steps, then a cosine down to
    final_frac * peak at `total`."""
    def lr(step):
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * torch.where(step < warmup, warm, cos)
    return lr


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr, *, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.0, clip=1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, params, grads):
        norm = torch.sqrt(torch.stack([torch.sum(g * g)
                                       for g in grads.values()]).sum())
        scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-9), max=1.0)
        self.step += 1
        t = torch.tensor(float(self.step), device=norm.device)
        lr = self.lr(t) if callable(self.lr) else self.lr
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        out = {}
        for k in list(params):
            p, g = params[k], grads[k] * scale
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            out[k] = p - lr * upd
            del g, upd
        return out
