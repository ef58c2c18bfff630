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
0-dim tensor.  AdamW also has `update_(grads, state, params) -> norm`,
which updates the params and the state's tensors in place, the same
operations element by element, and returns the gradients' global norm
before the clip: one multi-tensor kernel pass on the card
(`kernels/ops.grad_norm` and `.adamw_`, csrc/adamw.cu), the plain version
on the CPU.  A caller takes it where it owns the buffers
(`launch/steps.make_scan_train_step`); its norm sums in another order than
`global_norm`, so on the card the clip scale can differ from `update`'s
by an ulp.  On a mesh (core/sharded.py) each rank updates its own shard
of the parameters and moments, the global-norm clip reading the norm the
round computed over every shard (`update(..., norm=)`); the ZeRO-1
layout of the LLM optimizer state is `launch/sharding.opt_state_shardings`
(the dry-run's per-rank bytes).  Each `update` and `update_`, its clip
included, is a step's "optimizer" phase (`tracing.phase`).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tracing, tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels import ops, ref


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params) -> (new_params, new_state)
    # (grads, state, params) -> the gradients' global norm, the state and
    # params updated in place; None: the optimizer has no in-place update
    update_: Optional[Callable] = None


def _tree_zeros_like(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _marked(update):
    """`update` as the step's "optimizer" phase."""
    @functools.wraps(update)
    def marked(grads, state, params, **kw):
        with tracing.phase("optimizer", state["step"].device):
            return update(grads, state, params, **kw)
    return marked


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32."""
    return ref.global_norm_ref(tree_leaves(tree))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale `grads` by min(1, max_norm / global_norm); returns (clipped,
    norm).  `norm` — the global norm when the caller computed it (a
    gradient tree sharded over a mesh holds only part of it)."""
    if norm is None:
        norm = global_norm(grads)
    scale = ref.clip_scale_ref(norm, max_norm)
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

    return Optimizer(init, _marked(update))


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
    def update(grads, state, params, *, norm=None):
        """norm — the gradients' global norm where `grads` is this rank's
        shard of a tree sharded over a mesh (core/sharded.py); the update
        itself is elementwise."""
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        step = state["step"] + 1
        lr_t = sched(step)
        # bias corrections in fp32 on the int32 step, as the reference
        step_f = step.to(torch.float32)
        bc1 = 1 - b1 ** step_f
        bc2 = 1 - b2 ** step_f
        base = state.get("master", params)
        new = [ref.adamw_leaf_ref(g, m_, v_, w, lr_t, bc1, bc2, b1=b1, b2=b2,
                                  eps=eps, weight_decay=weight_decay)
               for g, m_, v_, w in zip(tree_leaves(grads),
                                       tree_leaves(state["m"]),
                                       tree_leaves(state["v"]),
                                       tree_leaves(base))]
        m, v, new_master = (tree_unflatten(tree, [n[i] for n in new])
                            for i, tree in enumerate((state["m"], state["v"],
                                                      base)))
        new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master,
                              params)
        new_state = {"step": step, "m": m, "v": v}
        if "master" in state:
            new_state["master"] = new_master
        return new_params, new_state

    @torch.no_grad()
    def update_(grads, state, params):
        """`update` in place: params, m, v, the master and the step; returns
        the gradients' global norm before the clip."""
        g = tree_leaves(grads)
        norm, scale = ops.grad_norm(g, clip_norm)
        step = state["step"].add_(1)
        lr_t = sched(step).to(torch.float32)
        step_f = step.to(torch.float32)
        bc1 = 1 - b1 ** step_f
        bc2 = 1 - b2 ** step_f
        master = tree_leaves(state["master"]) if "master" in state else None
        ops.adamw_(g, tree_leaves(state["m"]), tree_leaves(state["v"]),
                   master, tree_leaves(params), scale, lr_t, bc1, bc2, b1=b1,
                   b2=b2, eps=eps, weight_decay=weight_decay)
        return norm

    return Optimizer(init, _marked(update), _marked(update_))


def adam(lr, **kw):
    return adamw(lr, weight_decay=0.0, **kw)
