"""In-network learning (INL) — the paper's architecture (§III), inference.

Reference: src/repro/core/inl.py (`INLParams`, `init`, `_encode_mu_logvar`,
`encode` on its deterministic branch, `decode`, `predict` on the star,
`evaluate`).  J edge nodes encode their views into bottleneck latents u_j;
node (J+1) concatenates them (eq. 5) and decodes.

Encoder parameters are STACKED along a leading J axis, as in the reference,
so converted JAX parameters keep their layout.  The J encoders run in a
loop; the cut layer then folds all J nodes into ONE kernel launch.

Training (`loss_fn`, the train step), learned priors, the stochastic
`encode`, delivery masks and non-star topologies come with later slices of
the port and raise NotImplementedError here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device, tree_leaves, tree_map
from repro_torch.core import bottleneck, losses, paper_model
from repro_torch.core import topology as topology_lib


class INLParams(NamedTuple):
    encoders: dict          # stacked: leading axis J
    decoder: dict
    priors: dict            # {} when standard-normal


def _generator(generator, device: torch.device) -> torch.Generator:
    if isinstance(generator, int):
        return torch.Generator(device=device).manual_seed(generator)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, the "
                         f"parameters on {device}; draw them on one device")
    return generator


def init(cfg, generator, *, device=None):
    """cfg: PaperExperimentConfig; generator: a torch.Generator on `device`
    or an int seed.  Returns (INLParams, state) on `device` (None: cuda).

    Deterministic in the generator, but not the reference's numbers: JAX's
    threefry streams cannot be reproduced in torch.  For parity, convert
    the reference's parameters with repro_torch.convert.inl_from_jax."""
    device = resolve_device(device)
    if getattr(cfg, "learned_prior", False):
        raise NotImplementedError("learned priors come with the "
                                  "learned-prior slice of the port")
    gen = _generator(generator, device)
    nodes = [paper_model.encoder_init(gen, cfg, device=device)
             for _ in range(cfg.num_clients)]
    enc_params = _stack([p for p, _ in nodes])
    enc_state = _stack([s for _, s in nodes])
    dec = paper_model.decoder_init(gen, cfg, device=device)
    return INLParams(enc_params, dec, {}), {"encoders": enc_state}


def _stack(trees):
    """Per-node trees of one structure -> one tree with a leading J axis."""
    flat = [tree_leaves(t) for t in trees]
    stacked = iter(torch.stack(ts) for ts in zip(*flat))
    return tree_map(lambda _: next(stacked), trees[0])


def params_device(params: INLParams) -> torch.device:
    return params.decoder["dense"][0]["w"].device


def _encode_mu_logvar(params: INLParams, state, views, *, train: bool):
    """All J per-node encoders: views (J, B, H, W, C) ->
    ((mu, logvar) (J, B, d), new encoder state)."""
    mus, lvs, new_states = [], [], []
    for j in range(views.shape[0]):
        node_p = tree_map(lambda t: t[j], params.encoders)
        node_s = tree_map(lambda t: t[j], state["encoders"])
        (mu, lv), ns = paper_model.encoder_apply(node_p, node_s, views[j],
                                                 train=train)
        mus.append(mu)
        lvs.append(lv)
        new_states.append(ns)
    return (torch.stack(mus), torch.stack(lvs)), _stack(new_states)


def encode(params: INLParams, state, views, *, train: bool, generator=None,
           link_bits: int = 32, sample_latent: bool = True):
    """views: (J, B, H, W, C) -> (u (J, B, d), mu, logvar, new_state).

    The deterministic path (inference, u = quantize(mu)) is the cut-layer
    kernel's no-noise "none" mode, one launch for all J nodes."""
    if sample_latent and generator is not None:
        raise NotImplementedError("the stochastic encode (sample + rate) "
                                  "comes with the training slice")
    (mu, logvar), new_state = _encode_mu_logvar(params, state, views,
                                                train=train)
    u_sent, _ = bottleneck.fused_sample_rate(
        None, mu, logvar, link_bits=link_bits, rate_estimator="none")
    return u_sent, mu, logvar, {"encoders": new_state}


def decode(params: INLParams, u, *, train: bool, u_joint=None):
    """Node (J+1): u (J, B, d) -> (joint_logits, branch_logits (J, B, C))."""
    if u_joint is None:
        u_joint = u
    joint = paper_model.decoder_apply(params.decoder, _concat(u_joint),
                                      train=train)
    branch = paper_model.branch_heads_apply(params.decoder, u)
    return joint, branch


def _concat(u):
    J, B, d = u.shape
    return u.permute(1, 0, 2).reshape(B, J * d)            # eq. (5) concat


def predict(params: INLParams, state, views, *, cfg=None, topology=None,
            delivery=None, wire: str = "dense", device=None):
    """Inference phase (§III-B): deterministic latents (u = mu, shipped
    unquantized on the star as in the reference), soft output (B, C).

    views — a tensor or array (J, B, H, W, C), moved to `device` (None:
    cuda), where the parameters must already lie."""
    device = resolve_device(device)
    pdev = params_device(params)
    if pdev.type != device.type or device.index not in (None, pdev.index):
        raise ValueError(f"parameters lie on {pdev}, predict was asked to "
                         f"run on {device}")
    if delivery is not None:
        raise NotImplementedError("delivery masks (fuse-what-arrived) come "
                                  "with the link-fault slice of the port")
    if cfg is not None and topology_lib.nontrivial(topology, cfg) is not None:
        raise NotImplementedError("non-star topologies come with the "
                                  "topology slice of the port")
    views = torch.as_tensor(views, dtype=torch.float32, device=pdev)
    with torch.no_grad():
        u, _, _, _ = encode(params, state, views, train=False,
                            sample_latent=False)
        # the branch heads of `decode` are dead code at inference (the
        # reference's jit drops them); eager PyTorch would run them
        joint = paper_model.decoder_apply(params.decoder, _concat(u),
                                          train=False)
        return torch.softmax(joint, dim=-1)


def evaluate(params: INLParams, state, views, labels, *, device=None):
    probs = predict(params, state, views, device=device)
    labels = torch.as_tensor(labels, device=probs.device)
    return losses.accuracy(torch.log(probs + 1e-30), labels)
