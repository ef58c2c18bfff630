"""The in-network-learning loss — eq. (6) of the paper.

Reference: src/repro/core/losses.py (`xent`, `inl_loss`, `accuracy`).

    L_s = (1/n) SUM_i [ log Q_phiJ(y_i | u_1..u_J)
          + s * SUM_j ( log Q_phij(y_i | u_j)
                        - log( P_thetaj(u_j|x_j) / Q_psij(u_j) ) ) ]

maximised; returned NEGATED as a minimisation loss decomposed into its
three terms:

    loss = CE_joint + s * SUM_j ( CE_branch_j + rate_j )
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import bottleneck


def xent(logits, labels):
    """Mean -log Q(y) over the batch; labels (B,) or (B, S) int, -1 is
    ignored."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1)


def inl_loss(joint_logits, branch_logits: Sequence, labels,
             mus: Sequence, logvars: Sequence, us: Sequence,
             *, s: float, priors: Sequence = None,
             rate_estimator: str = "sample", rates: Sequence = None,
             joint_replicas: int = 1):
    """Eq. (6) as a minimisation objective.  Returns (loss, metrics).

    `rates` — optional precomputed per-row rate terms (one tensor per
    node), the second output of the fused cut layer (kernels/ops.cutlayer);
    when given, the rate is NOT recomputed and `rate_estimator`/`priors`
    are ignored for it.  `priors` — per-node prior parameters for the
    recomputed rate: a sequence of {"mu", "logvar"} dicts, or ONE stacked
    dict with (J, d) leaves.

    `joint_replicas` — on a mesh, the number of 'client' ranks that compute
    the same fusion term (core/sharded.py): the joint cross-entropy enters
    the objective divided by it, so that summing the ranks' cotangents
    restores its full weight; 1 leaves the objective as it is."""
    J = len(branch_logits)
    if isinstance(priors, dict):               # stacked (J, d) -> per node
        priors = [{k: v[j] for k, v in priors.items()} for j in range(J)] \
            if priors else [{}] * J
    priors = priors if priors is not None else [{}] * J
    ce_joint = xent(joint_logits, labels)
    ce_branches = [xent(bl, labels) for bl in branch_logits]
    if rates is not None:
        rates = [torch.mean(r) for r in rates]
    else:
        rates = []
        for j in range(J):
            if rate_estimator == "sample":
                r = bottleneck.rate_sampled(us[j], mus[j], logvars[j],
                                            priors[j])
            else:
                r = bottleneck.rate_analytic(mus[j], logvars[j], priors[j])
            rates.append(torch.mean(r))
    ce_b = torch.stack(ce_branches)
    rate_t = torch.stack(rates)
    joint = ce_joint if joint_replicas == 1 else ce_joint / joint_replicas
    loss = joint + s * (torch.sum(ce_b) + torch.sum(rate_t))
    metrics = {
        "loss": loss,
        "ce_joint": ce_joint,
        "ce_branch_mean": torch.mean(ce_b),
        "rate_mean": torch.mean(rate_t),
        "rate_total": torch.sum(rate_t),
    }
    return loss, metrics


def accuracy(logits, labels):
    """Top-1 accuracy over the labels >= 0, as an fp32 scalar tensor."""
    pred = torch.argmax(logits, dim=-1)
    mask = labels >= 0
    hits = ((pred == labels) & mask).sum()
    return (hits / torch.clamp(mask.sum(), min=1)).to(torch.float32)
