"""Federated learning (FedAvg, McMahan et al. 2017), the paper's baseline.

Reference: src/repro/core/fl.py (`init`, `client_loss`, `make_local_step`,
`make_one_client`, `make_round`, `predict`; its `round_bits` is
`core/bandwidth.fl_round_bits`, which the scheme's ledgers call).  Every
client holds a copy of the ENTIRE Fig.-4 network and trains on its local
shard; after `local_steps` minibatch updates the server averages the
weights and re-broadcasts them.  Bandwidth per round: 2 N J s bits (weights down and
up, Table I).

The J client copies are STACKED along a leading axis, as in the reference,
with one optimizer state per client.  The reference runs the clients in
parallel with vmap; here an eager loop over the clients takes its place,
each client's local steps one after another.  Randomness — each client's
per-local-step dropout masks — comes in as `drop_masks[client][step]`,
which is how the parity tests feed the reference's `split` chain.

A faulty round (`faulty=True`) averages only the client uploads that
arrived (core/linkfault.client_delivery_mask); when every upload is lost
the previous global model stays.  Its mask is a host array, so the round
decides on the host which average to take (`average_plan`): an all-ones
mask takes the clean round's `torch.mean`, so a perfect network leaves the
trajectory as it was bit for bit on the CPU and on the card (where a CUDA
mean multiplies by 1/J but a division by a host scalar need not round
alike); a partial average divides by the host count n.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree_leaves, tree_map, tree_stack, value_and_grad
from repro_torch.core import losses, paper_model


def replica(tree, j: int):
    """Client j's slice of a stacked tree."""
    return tree_map(lambda t: t[j], tree)


def init(cfg, generator, *, device=None):
    """Stacked client copies of the full model (one init, broadcast).
    Returns (params, state) with a leading J axis on every leaf."""
    params, state = paper_model.fl_model_init(generator, cfg, device=device)
    J = cfg.num_clients
    return tree_stack([params] * J), tree_stack([state] * J)


def client_loss(params, state, views, labels, *, drop_masks=None,
                train: bool = True, compute_dtype: str = "fp32"):
    """views (J, B, H, W, C): all J branch inputs of this client's images.
    compute_dtype "bf16" casts the parameters and views inside the loss;
    the gradients and the FedAvg weight exchange stay fp32.  Returns
    (loss, (metrics, new_state)); new_state detached."""
    dt = paper_model.COMPUTE_DTYPES[compute_dtype]
    logits, new_state = paper_model.fl_model_apply(
        paper_model.cast_compute(params, dt), state, views.to(dt),
        train=train, drop_masks=drop_masks)
    loss = losses.xent(logits, labels)
    metrics = {"loss": loss, "accuracy": losses.accuracy(logits, labels)}
    return loss, (metrics, tree_map(torch.Tensor.detach, new_state))


def make_local_step(optimizer, *, compute_dtype: str = "fp32"):
    def local_step(params, state, opt_state, views, labels, drop_masks):
        _, (metrics, new_state), grads = value_and_grad(
            client_loss, params, state, views, labels,
            drop_masks=drop_masks, compute_dtype=compute_dtype)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_state, new_opt, metrics
    return local_step


def make_one_client(optimizer, *, compute_dtype: str = "fp32"):
    """One client's FedAvg contribution: its local steps one after another,
    returning (params, state, opt_state, the steps' mean metrics)."""
    local_step = make_local_step(optimizer, compute_dtype=compute_dtype)

    def one_client(params, state, opt_state, views_seq, labels_seq,
                   masks_seq):
        per_step = []
        for v, lab, masks in zip(views_seq, labels_seq, masks_seq):
            params, state, opt_state, m = local_step(params, state,
                                                     opt_state, v, lab, masks)
            per_step.append(m)
        means = {k: torch.stack([m[k] for m in per_step]).mean().detach()
                 for k in per_step[0]}
        return params, state, opt_state, means
    return one_client


def average_plan(mask):
    """The server's host decision for a (J,) host bool delivery mask:
    "all" (every upload arrived), "none", or ("partial", n) with n the
    number that arrived."""
    mask = np.array(mask, bool)
    n = int(mask.sum())
    if n == mask.shape[0]:
        return "all"
    return "none" if n == 0 else ("partial", n)


def masked_average(p, old, plan, w=None):
    """The server's average over the uploads that arrived: p and old are
    stacked (J, ...) trees, plan `average_plan`'s decision and w, for a
    partial plan, the (J,) bool mask as a tensor on p's device.  All
    arrived: the clean mean; none: replica 0 of the previous model; else
    sum(x * w) / n, the reference's masked average, n a Python number so
    that the quotient is today's."""
    if plan == "all":
        return tree_map(lambda x: torch.mean(x, dim=0), p)
    if plan == "none":
        return tree_map(lambda x, o: o[0].to(x.dtype), p, old)
    n = plan[1]
    w = w.to(torch.float32)

    def avg(x):
        wx = w.reshape((w.shape[0],) + (1,) * (x.dim() - 1))
        return torch.sum(x * wx, dim=0) / float(n)
    return tree_map(avg, p)


def _masked_average(p, old, mask):
    """`masked_average` on a (J,) host bool mask."""
    if mask is None:
        raise ValueError("a faulty FedAvg round takes the (J,) client "
                         "delivery mask as its last argument")
    plan = average_plan(mask)
    w = None
    if plan not in ("all", "none"):
        w = torch.as_tensor(np.array(mask, bool),
                            device=tree_leaves(p)[0].device)
    return masked_average(p, old, plan, w)


def make_round(cfg, optimizer, local_steps: int, *, faulty: bool = False):
    """One FedAvg round: round_fn(stacked_params, stacked_state,
    stacked_opt, views, labels, drop_masks) -> (params, state, opt_state,
    metrics), with views (J, local_steps, J, B, H, W, C), labels (J,
    local_steps, B) and drop_masks[j][s] the decoder's keep masks of client
    j's local step s.  Every client trains, then the server takes the plain
    parameter average and re-broadcasts it; each client keeps its own
    BatchNorm statistics and optimizer state.

    faulty=True returns a round_fn taking a trailing (J,) boolean `mask`
    (core/linkfault.client_delivery_mask, a host array): clients whose
    upload dropped are masked out of the average; when every upload is
    lost the round keeps the previous global model.  Every client still
    trains (the reference computes the round, then discards).  With
    `plan=` (`average_plan` of the mask, taken on the host) `mask` is that
    mask as a bool tensor on the device, as a captured round reads it."""
    one_client = make_one_client(
        optimizer, compute_dtype=getattr(cfg, "compute_dtype", "fp32"))

    def round_fn(stacked_params, stacked_state, stacked_opt, views, labels,
                 drop_masks, mask=None, *, plan=None):
        J = labels.shape[0]
        outs = [one_client(replica(stacked_params, j),
                           replica(stacked_state, j),
                           replica(stacked_opt, j), views[j], labels[j],
                           drop_masks[j]) for j in range(J)]
        p, s, o, m = (tree_stack([out[i] for out in outs]) for i in range(4))
        # server aggregation: parameter average, re-broadcast
        if faulty and plan is not None:
            avg = masked_average(p, stacked_params, plan, mask)
        elif faulty:
            avg = _masked_average(p, stacked_params, mask)
        else:
            avg = tree_map(lambda x: torch.mean(x, dim=0), p)
        p_new = tree_stack([avg] * J)
        return p_new, s, o, {k: v.mean() for k, v in m.items()}
    return round_fn


def predict(stacked_params, stacked_state, images):
    """FL inference is CENTRAL: the aggregated model (replica 0) on one
    image per sample, broadcast to all J branch inputs.  images (B, H, W,
    C) -> (B, C) class probabilities."""
    params = replica(stacked_params, 0)
    state = replica(stacked_state, 0)
    J = len(params["encoders"])
    views = images.expand((J,) + images.shape)
    logits, _ = paper_model.fl_model_apply(params, state, views, train=False)
    return torch.softmax(logits, dim=-1)
