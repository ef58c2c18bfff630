"""Optimizers as pure functions on tensor trees: SGD (+momentum), Adam,
AdamW with decoupled weight decay, global-norm clipping and learning-rate
schedules.

Reference: src/repro/optim/__init__.py, followed exactly: `adam` is
`adamw(b2=0.95, clip_norm=1.0)` with the clip on the global norm of every
gradient, the bias corrections 1 - b**step taken in fp32 on the int32 step
counter, eps added outside the square root, and an fp32 master copy in the
state when the parameters are low precision.  Not `torch.optim.Adam`: its
b2, clipping and eps placement differ.

`init(params) -> state` and `update(grads, state, params) -> (new_params,
new_state)` build new tensors (no in-place update) under torch.no_grad();
the state is a dict of tensors on the parameters' device, the step an int32
0-dim tensor.  The ZeRO-1 sharding of the reference's optimizer state comes
with the sharded slice of the port.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params) -> (new_params, new_state)


def _tree_zeros_like(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale `grads` by min(1, max_norm / global_norm); returns (clipped,
    norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# Schedules: int step tensor -> fp32 learning-rate tensor on its device
# ---------------------------------------------------------------------------

def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, final_frac: float = 0.1):
    def sched(step):
        step = step.to(torch.float32)
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)
    return sched


def linear_schedule(peak_lr: float, warmup_steps: int, total_steps: int):
    def sched(step):
        step = step.to(torch.float32)
        warm = step / max(warmup_steps, 1)
        decay = torch.clamp(1.0 - (step - warmup_steps)
                            / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return peak_lr * torch.where(step < warmup_steps, warm, decay)
    return sched


def _as_schedule(lr):
    return lr if callable(lr) else constant_schedule(lr)


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

def sgd(lr, momentum: float = 0.0, clip_norm: Optional[float] = None):
    sched = _as_schedule(lr)

    def init(params):
        state = {"step": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}
        if momentum:
            state["mom"] = _tree_zeros_like(params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"]
        lr_t = sched(step)
        new_state = {"step": step + 1}
        if momentum:
            upd = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                           state["mom"], grads)
            new_state["mom"] = upd
        else:
            upd = tree_map(lambda g: g.to(torch.float32), grads)
        new_params = tree_map(
            lambda p, u: (p.to(torch.float32) - lr_t * u).to(p.dtype),
            params, upd)
        return new_params, new_state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adam / AdamW (with fp32 master weights when params are low precision)
# ---------------------------------------------------------------------------

def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = 1.0,
          keep_master: bool = True):
    sched = _as_schedule(lr)

    def _needs_master(params):
        return keep_master and any(x.dtype != torch.float32
                                   for x in tree_leaves(params))

    def init(params):
        state = {"step": torch.zeros((), dtype=torch.int32,
                                     device=_device(params)),
                 "m": _tree_zeros_like(params),
                 "v": _tree_zeros_like(params)}
        if _needs_master(params):
            state["master"] = tree_map(lambda x: x.to(torch.float32),
                                       params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = sched(step)
        # bias corrections in fp32 on the int32 step, as the reference
        step_f = step.to(torch.float32)
        bc1 = 1 - b1 ** step_f
        bc2 = 1 - b2 ** step_f
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.to(torch.float32)), state["v"], grads)
        base = state.get("master", params)

        def upd(p, m_, v_):
            mh = m_ / bc1
            vh = v_ / bc2
            step_ = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.to(torch.float32)
            return p.to(torch.float32) - lr_t * step_

        new_master = tree_map(upd, base, m, v)
        new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master,
                              params)
        new_state = {"step": step, "m": m, "v": v}
        if "master" in state:
            new_state["master"] = new_master
        return new_params, new_state

    return Optimizer(init, update)


def adam(lr, **kw):
    return adamw(lr, weight_decay=0.0, **kw)
