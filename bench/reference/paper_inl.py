"""Plain reference of the paper's experiment (arXiv 2104.14929 §III-IV,
Fig. 4): the INL round and the FedAvg round on J noisy views, in fp32
(TF32 off), written from the paper and the configuration file alone.

INL: J VGG-style encoders (3x3 conv, BatchNorm on the batch's statistics
with the biased two-pass variance, ReLU, 2x2 max-pool), a head to (mu,
log sigma^2) with log sigma^2 clipped to [-8, 8], the sample
u = mu + sigma eps on a link of `link_bits` (a uniform quantizer on
[-4, 4], passed straight through by the gradient; none at 32 bits), the
per-sample rate log P(u|x) - log N(u; 0, I), the concatenation of the J
latents (eq. 5) into two dense ReLU layers with inverted dropout 0.3 and a
linear classifier, one linear head a node on its own latent, and eq. (6):
CE(joint) + s (sum_j CE(branch j) + sum_j mean rate_j).  FL: every client
holds the whole network (the J branches without noise or rate, u = mu);
client j takes `local_steps` steps on its own view of its minibatches,
broadcast to all J branch inputs, then the server averages the weights.
Adam: b1 0.9, b2 0.95, eps 1e-8 outside the root, bias corrections, the
global gradient norm clipped to 1.

The weights (`make_weights`) are the benchmark's, drawn from the seed,
named as the program's tree names them.  The draws of a round come from
the generator the benchmark hands in: eps (J, B, d) N(0, 1), then one
dropout keep mask (B, units) a hidden layer, kept with p = 0.7; FL draws
its masks client after client, step after step, at the start of a round.
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from bench.lib import compare
from bench.lib import weights as W
from bench.reference import cut, lowp
from bench.reference.adamw import AdamW

DROP = 0.3


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _encoder_shapes(cfg, prefix: str, lead: tuple) -> Dict[str, tuple]:
    chans = (cfg["image_shape"][-1],) + tuple(cfg["conv_channels"])
    out = {}
    for i in range(len(cfg["conv_channels"])):
        out[f"{prefix}convs.{i}.w"] = lead + (chans[i + 1], chans[i], 3, 3)
        out[f"{prefix}convs.{i}.b"] = lead + (chans[i + 1],)
        out[f"{prefix}bns.{i}.scale"] = lead + (chans[i + 1],)
        out[f"{prefix}bns.{i}.bias"] = lead + (chans[i + 1],)
    side = cfg["image_shape"][0] // 2 ** len(cfg["conv_channels"])
    feat = side * side * cfg["conv_channels"][-1]
    for h in ("mu", "logvar"):
        out[f"{prefix}head.{h}.w"] = lead + (feat, cfg["d_bottleneck"])
        out[f"{prefix}head.{h}.b"] = lead + (cfg["d_bottleneck"],)
    return out


def _decoder_shapes(cfg) -> Dict[str, tuple]:
    J, d = cfg["num_clients"], cfg["d_bottleneck"]
    dims = (J * d,) + tuple(cfg["dense_units"]) + (cfg["num_classes"],)
    out = {}
    for i in range(len(dims) - 1):
        out[f"decoder.dense.{i}.w"] = (dims[i], dims[i + 1])
        out[f"decoder.dense.{i}.b"] = (dims[i + 1],)
    out["decoder.branch_heads.w"] = (J, d, cfg["num_classes"])
    out["decoder.branch_heads.b"] = (J, cfg["num_classes"])
    return out


def shapes(cfg, scheme: str) -> Dict[str, tuple]:
    """Every weight's name and shape: INL's J encoders stacked on a leading
    axis; FL's one model, its J branch encoders listed."""
    J = cfg["num_clients"]
    if scheme == "inl":
        out = _encoder_shapes(cfg, "encoders.", (J,))
    else:
        out = {}
        for j in range(J):
            out.update(_encoder_shapes(cfg, f"encoders.{j}.", ()))
    out.update(_decoder_shapes(cfg))
    return out


def rule(name: str, shape: tuple):
    """How a weight is drawn: He-normal convs, 1/sqrt(fan-in) denses, the
    log-variance head at 1e-2; ones and zeros for BatchNorm and biases."""
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return ("ones",)
    if last in ("b", "bias"):
        return ("zeros",)
    if ".convs." in name:
        return ("normal", (2.0 / (shape[-3] * 9)) ** 0.5)
    if ".head.logvar." in name:
        return ("normal", 1e-2)
    return ("normal", shape[-2] ** -0.5)


def make_weights(cfg, scheme: str, seed: int, device) -> Dict[str, torch.Tensor]:
    return {n: W.draw(n, s, rule(n, s), seed=seed, device=device)
            for n, s in shapes(cfg, scheme).items()}


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------

def _encoder(w, prefix, j, x, prec):
    """x (B, H, W, C) -> (mu, logvar) (B, d); j indexes stacked leaves."""
    def leaf(name):
        t = w[prefix + name]
        return t if j is None else t[j]

    h = x.permute(0, 3, 1, 2)
    i = 0
    while prefix + f"convs.{i}.w" in w:
        h = lowp.conv2d(h, leaf(f"convs.{i}.w"), leaf(f"convs.{i}.b"), prec)
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = torch.square(h - mean).mean(dim=(0, 2, 3), keepdim=True)
        h = (h - mean) * torch.rsqrt(var + 1e-5) \
            * leaf(f"bns.{i}.scale")[None, :, None, None] \
            + leaf(f"bns.{i}.bias")[None, :, None, None]
        h = F.max_pool2d(torch.relu(h), 2, 2)
        i += 1
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    mu = lowp.mm(h, leaf("head.mu.w"), prec) + leaf("head.mu.b")
    lv = lowp.mm(h, leaf("head.logvar.w"), prec) + leaf("head.logvar.b")
    return mu, torch.clamp(lv, -8.0, 8.0)


def _decoder(w, u_cat, masks, prec):
    h, i = u_cat, 0
    while f"decoder.dense.{i + 1}.w" in w:
        h = torch.relu(lowp.mm(h, w[f"decoder.dense.{i}.w"], prec)
                       + w[f"decoder.dense.{i}.b"])
        h = torch.where(masks[i], h / (1.0 - DROP), torch.zeros_like(h))
        i += 1
    return lowp.mm(h, w[f"decoder.dense.{i}.w"], prec) + w[f"decoder.dense.{i}.b"]


def _ce(logits, labels, rows):
    logp = torch.log_softmax(logits[:rows], dim=-1)
    return -logp.gather(-1, labels[:rows, None]).mean()


def inl_loss(w, cfg, views, labels, eps, masks, prec="fp32", half=False):
    """Eq. (6) of one INL round.  views (J, B, H, W, C), labels (B,), eps
    (J, B, d).  half: the fault that leaves out half of the batch and
    takes every mean over the rest."""
    J, B = views.shape[0], labels.shape[0]
    rows = B // 2 if half else B
    us, rates = [], []
    for j in range(J):
        mu, lv = _encoder(w, "encoders.", j, views[j], prec)
        u, rate = cut.sample(mu, lv, eps[j], cfg["link_bits"])
        rates.append(rate[:rows].mean())
        us.append(u)
    joint = _decoder(w, torch.cat(us, dim=-1), masks, prec)
    branch = lowp.bmm(torch.stack(us), w["decoder.branch_heads.w"], prec) \
        + w["decoder.branch_heads.b"][:, None, :]
    ce_b = sum(_ce(branch[j], labels, rows) for j in range(J))
    return _ce(joint, labels, rows) + cfg["s"] * (ce_b + sum(rates))


def fl_loss(w, cfg, view, labels, masks, prec="fp32", half=False):
    """One client's local step loss: its view (B, H, W, C) on every one of
    the J branches of the whole model, u = mu, the decoder, CE."""
    J = cfg["num_clients"]
    rows = labels.shape[0] // 2 if half else labels.shape[0]
    us = [_encoder(w, f"encoders.{j}.", None, view, prec)[0]
          for j in range(J)]
    return _ce(_decoder(w, torch.cat(us, dim=-1), masks, prec), labels, rows)


# ---------------------------------------------------------------------------
# The rounds
# ---------------------------------------------------------------------------

def _grads(loss_fn, params):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(v) if g is None else g
                         for (k, v), g in zip(leaves.items(), gs)}


def _masks(cfg, gen, B, device):
    return [torch.rand((B, u), generator=gen, device=device) < (1.0 - DROP)
            for u in cfg["dense_units"]]


def run_inl(cfg, w0, rounds, gen, *, lr, prec="fp32", half=False) -> dict:
    """The first len(rounds) INL rounds from the weights w0; rounds a list
    of (views (J, B, ...), labels (B,)).  Returns {"losses", "grad" (the
    first moment after round 1 over 1 - b1, a norm a leaf), "change" (a
    norm a leaf)}."""
    params = dict(w0)
    opt = AdamW(params, lr)
    losses, grad = [], None
    for views, labels in rounds:
        J, B = views.shape[0], labels.shape[0]
        eps = torch.randn((J, B, cfg["d_bottleneck"]), generator=gen,
                          dtype=torch.float32, device=views.device)
        masks = _masks(cfg, gen, B, views.device)
        loss, g = _grads(lambda p: inl_loss(p, cfg, views, labels, eps,
                                            masks, prec, half), params)
        params = opt.update(params, g)
        losses.append(loss)
        if grad is None:
            grad = {k: compare.norm(m / (1 - opt.b1))
                    for k, m in opt.m.items()}
    change = {k: compare.norm(params[k] - w0[k]) for k in params}
    return {"losses": losses, "grad": grad, "change": change}


def run_fl(cfg, w0, rounds, gen, *, lr, local_steps, prec="fp32",
           half=False) -> dict:
    """The first len(rounds) FedAvg rounds; rounds a list of (views (J *
    local_steps, J, B, ...), labels (J * local_steps, B)).  Client j's step
    s takes minibatch j * local_steps + s.  "grad": the clients' first
    moments after round 1 over 1 - b1, stacked over the clients, a norm a
    leaf; "change": one client's weights (all equal after the average)."""
    J = cfg["num_clients"]
    glob = dict(w0)
    opts = [AdamW(glob, lr) for _ in range(J)]
    losses, grad = [], None
    for views, labels in rounds:
        B = labels.shape[-1]
        masks = [[_masks(cfg, gen, B, views.device)
                  for _ in range(local_steps)] for _ in range(J)]
        locals_: List[dict] = []
        step_losses = []
        for j in range(J):
            p = dict(glob)
            for s in range(local_steps):
                mb = j * local_steps + s
                loss, g = _grads(lambda q: fl_loss(
                    q, cfg, views[mb, j], labels[mb], masks[j][s], prec,
                    half), p)
                p = opts[j].update(p, g)
                step_losses.append(loss)
            locals_.append(p)
        glob = {k: torch.stack([p[k] for p in locals_]).mean(dim=0)
                for k in glob}
        losses.append(sum(step_losses) / len(step_losses))
        if grad is None:
            grad = {k: compare.norm(torch.stack([o.m[k] for o in opts])
                                    / (1 - opts[0].b1)) for k in glob}
    change = {k: compare.norm(glob[k] - w0[k]) for k in glob}
    return {"losses": losses, "grad": grad, "change": change}
