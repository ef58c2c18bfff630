"""In-network learning (INL) — the paper's architecture (§III).

Reference: src/repro/core/inl.py (`INLParams`, `init`, `_encode_mu_logvar`,
`encode_and_rate`, `encode`, `decode`, `loss_fn`, `make_train_step`,
`predict`, `evaluate`, and the heterogeneous-encoder variant
`init_heterogeneous` and `loss_fn_heterogeneous`).  J edge nodes encode
their views into bottleneck latents u_j; node (J+1) concatenates them
(eq. 5) and decodes.  Training optimises eq. (6) end to end: autograd
through the concatenation hands node j only its chunk delta[j] of the
decoder-input cotangent, and the cut layer's hand-written backward adds
the gradient of its own rate term (eq. 10).

Encoder parameters are STACKED along a leading J axis, as in the reference,
so converted JAX parameters keep their layout.  The J encoders run in a
loop; the cut layer then folds all J nodes into ONE kernel launch per
direction.

Randomness: JAX's threefry streams cannot be reproduced in torch.  A
training step draws its noise from a torch.Generator — eps (J, B, d) first,
then the decoder's dropout keep masks, layer by layer — or takes them as
`eps=` / `drop_masks=`, which is how the parity tests feed it the
reference's draws.

The wire (`wire=`, core/wirefmt.py): "dense", or the packed wires, whose
forward runs the pack-emitting cut kernel and the unpack ("packed" trains
bit for bit as "dense"; "packed_duplex" also quantizes the error vectors
on the way back).

Topologies (`topology=`, core/topology.py): the default star runs the
pre-topology path above; any other graph cuts each node at its first
hop's width and routes the latents through the edges' re-encoding hops
before the eq.-(5) concatenation (`topology.graph_cut_and_ship`), in
training and in `predict`.

Unreliable links (core/linkfault.py): when an edge carries a LinkModel or
cfg.edge_dropout > 0, a training step draws the round's (J,) delivery mask
on the host from its `round_key` (linkfault.round_key(seed, round)) and
the fusion center fuses what arrived (`linkfault.partial_fuse`); an
explicit `delivery=` mask (the transport-mode step, predict) overrides
the draw.  The round's own randomness (eps, dropout masks) never reads the
fault stream.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import (as_generator, as_input, resolve_device, tree_map,
                         tree_stack, value_and_grad)
from repro_torch.core import (bottleneck, linkfault, linkmodel, losses,
                              paper_model)
from repro_torch.core import topology as topology_lib
from repro_torch.core import wirefmt


ROUND_KEY_MESSAGE = ("a round over unreliable links draws its delivery mask "
                     "from round_key (linkfault.round_key(seed, round)); "
                     "pass round_key= or delivery=")


class INLParams(NamedTuple):
    encoders: dict          # stacked: leading axis J
    decoder: dict
    priors: dict            # {} when standard-normal, else (J, d) leaves


def init(cfg, generator, *, device=None):
    """cfg: PaperExperimentConfig; generator: a torch.Generator on `device`
    or an int seed.  Returns (INLParams, state) on `device` (None: cuda).

    cfg.learned_prior=True adds per-node trainable Gaussian priors ((J, d)
    mean and log-variance, starting at the standard normal); the rate then
    runs on the prior kernels.  Deterministic in the generator, but not the
    reference's numbers: for parity, convert the reference's parameters
    with repro_torch.convert.inl_from_jax."""
    device = resolve_device(device)
    gen = as_generator(generator, device)
    nodes = [paper_model.encoder_init(gen, cfg, device=device)
             for _ in range(cfg.num_clients)]
    enc_params = tree_stack([p for p, _ in nodes])
    enc_state = tree_stack([s for _, s in nodes])
    dec = paper_model.decoder_init(gen, cfg, device=device)
    priors = bottleneck.prior_init(
        cfg.d_bottleneck, learned=getattr(cfg, "learned_prior", False),
        num_nodes=cfg.num_clients, device=device)
    return INLParams(enc_params, dec, priors), {"encoders": enc_state}


def _encode_mu_logvar(params: INLParams, state, views, *, train: bool,
                      axis_name=None):
    """All J per-node encoders: views (J, B, H, W, C) ->
    ((mu, logvar) (J, B, d), new encoder state); axis_name the mesh Axis
    the batch is sharded over (global BatchNorm statistics)."""
    return paper_model.stacked_encoder_apply(params.encoders,
                                             state["encoders"], views,
                                             train=train, axis_name=axis_name)


def encode_and_rate(params: INLParams, state, views, *, train: bool,
                    generator=None, eps=None, link_bits: int = 32,
                    rate_estimator: str = "sample"):
    """The fused edge hot path: views (J, B, H, W, C) ->
    (u (J, B, d), mu, logvar, rate (J, B), new_state).

    After the per-node encoders produce (mu, logvar), ONE cut-layer launch
    (the client axis folded into the rows) yields the quantized
    transmission u and the per-sample eq.-(6) rate; learned priors
    (params.priors non-empty) ride the prior kernels.  The noise comes from
    `generator` or `eps`."""
    (mu, logvar), new_state = _encode_mu_logvar(params, state, views,
                                                train=train)
    u, rate = bottleneck.fused_sample_rate(
        generator, mu, logvar, link_bits=link_bits,
        rate_estimator=rate_estimator, prior=params.priors, eps=eps)
    return u, mu, logvar, rate, {"encoders": new_state}


def encode(params: INLParams, state, views, *, train: bool, generator=None,
           link_bits: int = 32, sample_latent: bool = True):
    """views: (J, B, H, W, C) -> (u (J, B, d), mu, logvar, new_state).

    Everything that runs AT THE EDGE; u is what crosses the links.  With a
    generator (and sample_latent) u is the stochastic sample; otherwise the
    deterministic u = quantize(mu), the cut-layer kernel's no-noise "none"
    mode.  Both are one launch for all J nodes."""
    if sample_latent and generator is not None:
        u, mu, logvar, _, new_state = encode_and_rate(
            params, state, views, train=train, generator=generator,
            link_bits=link_bits)
        return u, mu, logvar, new_state
    (mu, logvar), new_state = _encode_mu_logvar(params, state, views,
                                                train=train)
    u_sent, _ = bottleneck.fused_sample_rate(
        None, mu, logvar, link_bits=link_bits, rate_estimator="none")
    return u_sent, mu, logvar, {"encoders": new_state}


def decode(params: INLParams, u, *, train: bool, u_joint=None,
           drop_masks=None):
    """Node (J+1): u (J, B, d) -> (joint_logits, branch_logits (J, B, C)).

    u_joint — the latents as received over the wire (defaults to u); the
    fusion decoder reads it, the branch heads read u.  drop_masks — the
    decoder's dropout keep masks in training (none: no dropout)."""
    if u_joint is None:
        u_joint = u
    joint = paper_model.decoder_apply(params.decoder,
                                      paper_model.concat_latents(u_joint),
                                      train=train, drop_masks=drop_masks)
    branch = paper_model.branch_heads_apply(params.decoder, u)
    return joint, branch


def loss_fn(params: INLParams, state, views, labels, cfg, *, generator=None,
            eps=None, drop_masks=None, train: bool = True,
            rate_estimator: str = "sample", wire: str = "dense",
            topology=None, delivery=None, round_key=None, client_axis=None,
            data_axis=None, group_ids=None):
    """Full eq.-(6) loss.  Returns (loss, (metrics, new_state));
    new_state's BatchNorm statistics are detached.

    The cut layer runs the fused kernel, which also emits the per-sample
    rate; losses.inl_loss takes it instead of recomputing it.
    cfg.compute_dtype="bf16" applies the mixed-precision policy: params
    and views drop to bf16 INSIDE this function, so the gradients and the
    optimizer's parameters stay fp32.

    Noise: eps (J, B, d) fp32, else drawn from `generator`; in training,
    drop_masks (one (B, units) bool tensor per hidden decoder layer), else
    drawn from `generator` after eps (paper_model.decoder_dropout_masks).
    wire — the cut layer's wire format (core/wirefmt.cut_and_ship).

    topology — a core/topology.Topology (defaults to cfg.topology, then
    the implicit star): a non-star graph cuts each node at its first hop's
    width and routes the latents through the edges' re-encoding hops in
    topological order before the eq.-(5) concatenation
    (topology.graph_cut_and_ship), and `bits_sent` is its per-edge sum
    (topology.round_bits); the default star keeps the path above.

    Unreliable links (core/linkfault.py): when an edge carries a LinkModel
    or (in training) cfg.edge_dropout > 0, the round's (J,) delivery mask
    is drawn on the host from `round_key` (linkfault.round_key) and the
    fusion center fuses what arrived (`linkfault.partial_fuse`: mask and
    renormalise); eq.-(10) error chunks then flow back only over the
    surviving routes.  Branch heads and rate terms stay local and
    unmasked.  delivery — an explicit (J,) or (J, B) mask that replaces
    the draw (the transport-mode step).  Neither leaves the fault-free
    path bit for bit.

    On a mesh (core/sharded.py) the arguments are this rank's block:
    params, state, views and eps hold its J_local nodes, views, labels,
    eps and drop_masks its B_local rows; `client_axis` gathers the cut
    latents to the fusion decoder (the fan-in, wirefmt.cut_and_ship /
    topology.graph_cut_and_ship with the rank's `group_ids`), `data_axis`
    makes the BatchNorm statistics global, and the joint term is divided
    by the client axis' size (losses.inl_loss).  The loss and metrics are
    then the rank's own; core/sharded reduces them."""
    topo_full = topology_lib.resolve(topology, cfg)
    faulty = delivery is None and linkfault.active(topo_full, cfg,
                                                   train=train)
    if faulty and round_key is None:
        raise ValueError(ROUND_KEY_MESSAGE)
    topo = topology_lib.nontrivial(topology, cfg)
    dt = paper_model.compute_dtype(cfg)
    params_c = paper_model.cast_compute(params, dt)
    views = views.to(dt)
    if eps is None and generator is None:
        raise ValueError("loss_fn draws eps from `generator`; pass "
                         "generator= or eps=")
    (mu, logvar), new_enc = _encode_mu_logvar(params_c, state, views,
                                              train=train,
                                              axis_name=data_axis)
    if topo is None:
        u, rate, u_joint = wirefmt.cut_and_ship(
            generator if eps is None else None, mu, logvar,
            link_bits=cfg.link_bits, rate_estimator=rate_estimator,
            wire=wire, prior=params_c.priors, eps=eps,
            axis_name=client_axis)
    else:
        eps = bottleneck.cut_noise(generator if eps is None else None, mu,
                                   eps)
        u, rate, u_joint = topology_lib.graph_cut_and_ship(
            topo, cfg, mu, logvar, eps, rate_estimator=rate_estimator,
            wire=wire, prior=params_c.priors, axis_name=client_axis,
            group_ids=group_ids)
    B = labels.shape[0]
    if faulty:
        delivery = linkfault.round_delivery_mask(round_key, topo_full, cfg, B,
                                                 train=train)
    if delivery is not None:
        u_joint = linkfault.partial_fuse(u_joint, delivery)
    if train and drop_masks is None:
        if generator is None:
            raise ValueError("training draws dropout masks from "
                             "`generator`; pass generator= or drop_masks=")
        drop_masks = paper_model.decoder_dropout_masks(
            generator, cfg.dense_units, B, device=mu.device)
    joint, branch = decode(params_c, u, train=train, u_joint=u_joint,
                           drop_masks=drop_masks)
    J = u.shape[0]
    loss, metrics = losses.inl_loss(
        joint, list(branch), labels, list(mu), list(logvar), list(u),
        s=cfg.s, rate_estimator=rate_estimator, rates=list(rate),
        joint_replicas=1 if client_axis is None else client_axis.size)
    metrics["accuracy"] = losses.accuracy(joint, labels)
    # §III-C accounting: activations forward + error vectors backward
    # (per-edge payloads summed when a topology re-routes them)
    if topo is None:
        bits_sent = linkmodel.training_step_bits(B, J * cfg.d_bottleneck,
                                                 cfg.link_bits)
    else:
        bits_sent = topology_lib.round_bits(topo, cfg, B)
    metrics["bits_sent"] = torch.tensor(float(bits_sent),
                                        dtype=torch.float32)
    new_state = tree_map(torch.Tensor.detach, {"encoders": new_enc})
    return loss, (metrics, new_state)


def make_train_step(cfg, optimizer, *, rate_estimator: str = "sample",
                    wire: str = "dense", topology=None,
                    explicit_delivery: bool = False):
    """The train step closed over the experiment config and optimizer:

        step(params, state, opt_state, views, labels, generator, *,
             eps=None, drop_masks=None, round_key=None)
            -> (new_params, new_state, new_opt_state, metrics)

    One eq.-(6) loss, its gradient with respect to the parameters only
    (the BatchNorm statistics come back as new, detached state) and one
    optimizer update.  The metrics are detached tensors.  round_key — the
    round's fault key, needed where links are unreliable (`loss_fn`).

    explicit_delivery=True returns the transport-mode step, which takes
    the round's (J,) or (J, B) delivery mask as data in place of a draw:

        step(params, state, opt_state, views, labels, generator, delivery,
             *, eps=None, drop_masks=None)"""
    topology_lib.check_wires(topology_lib.nontrivial(topology, cfg), cfg,
                             wire)

    def step(params, state, opt_state, views, labels, generator, *,
             eps=None, drop_masks=None, round_key=None, delivery=None):
        _, (metrics, new_state), grads = value_and_grad(
            loss_fn, params, state, views, labels, cfg, generator=generator,
            eps=eps, drop_masks=drop_masks, train=True,
            rate_estimator=rate_estimator, wire=wire, topology=topology,
            delivery=delivery, round_key=round_key)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_params, new_state, new_opt, metrics

    if explicit_delivery:
        def step_d(params, state, opt_state, views, labels, generator,
                   delivery, *, eps=None, drop_masks=None):
            return step(params, state, opt_state, views, labels, generator,
                        eps=eps, drop_masks=drop_masks, delivery=delivery)
        return step_d
    return step


def predict(params: INLParams, state, views, *, cfg=None, topology=None,
            delivery=None, wire: str = "dense", device=None):
    """Inference phase (§III-B): deterministic latents (u = mu), soft
    output (B, C).

    views — a tensor or array (J, B, H, W, C), moved to `device` (None:
    cuda), where the parameters must already lie.

    delivery — an optional (J,) or (J, B) boolean delivery mask
    (core/linkfault.py): views whose route dropped or missed the fusion
    deadline are masked out of the concatenation and the survivors
    renormalised (fuse-what-arrived).  None is the perfect network, the
    fault-free path bit for bit.

    The star ships UNQUANTIZED latents, as in the reference, and ignores
    `wire`.  A non-star `topology` (it needs `cfg` for the edge widths)
    routes the deterministic latents through the same multi-hop
    re-encoding the training graph runs, on the edges' wires ("packed":
    the pack and unpack kernels on every hop, a lossless re-encoding, so
    the answers equal the dense wire's bit for bit) — what the fuse node
    receives.  At full-precision links every hop is the identity and a
    chain or tree predicts as the star does, bit for bit."""
    views = as_input(params, views, device)
    topo = None if cfg is None else topology_lib.nontrivial(topology, cfg)
    with torch.no_grad():
        if topo is None:
            u_fused, _, _, _ = encode(params, state, views, train=False,
                                      sample_latent=False)
        else:
            (mu, logvar), _ = _encode_mu_logvar(params, state, views,
                                                train=False)
            _, _, u_fused = topology_lib.graph_cut_and_ship(
                topo, cfg, mu, logvar,
                torch.zeros(mu.shape, dtype=torch.float32, device=mu.device),
                rate_estimator="none", wire=wire)
        if delivery is not None:
            u_fused = linkfault.partial_fuse(u_fused, delivery)
        # the branch heads of `decode` are dead code at inference (the
        # reference's jit drops them); eager PyTorch would run them
        joint = paper_model.decoder_apply(
            params.decoder, paper_model.concat_latents(u_fused), train=False)
        return torch.softmax(joint, dim=-1)


def evaluate(params: INLParams, state, views, labels, *, device=None):
    probs = predict(params, state, views, device=device)
    labels = torch.as_tensor(labels, device=probs.device)
    return losses.accuracy(torch.log(probs + 1e-30), labels)


# ---------------------------------------------------------------------------
# Heterogeneous-encoder variant (the paper: the nodes' NNs "need not be
# identical")
# ---------------------------------------------------------------------------

def init_heterogeneous(cfgs, generator, *, device=None):
    """One (possibly different) PaperExperimentConfig per node, all with
    one d_bottleneck; the decoder from cfgs[0].  Returns list-based
    (params {"encoders": [J], "decoder"}, state {"encoders": [J]}) for
    `loss_fn_heterogeneous`, on `device` (None: cuda), deterministic in
    `generator` (a torch.Generator or an int seed).  For parity, convert
    the reference's with repro_torch.convert.inl_heterogeneous_from_jax."""
    device = resolve_device(device)
    gen = as_generator(generator, device)
    encs = [paper_model.encoder_init(gen, c, device=device) for c in cfgs]
    dec = paper_model.decoder_init(gen, cfgs[0], device=device)
    return ({"encoders": [p for p, _ in encs], "decoder": dec},
            {"encoders": [st for _, st in encs]})


def loss_fn_heterogeneous(params, state, views, labels, cfg, *,
                          generator=None, eps=None, drop_masks=None,
                          train: bool = True):
    """The eq.-(6) loss with per-node encoder architectures.  Every node
    emits the same d_bottleneck, so after the encoders (one after another)
    the cut layer is still ONE fused launch over the stacked (J, B, d)
    latents, in the sample mode at cfg.link_bits.  Noise as in `loss_fn`:
    eps (J, B, d) fp32, else drawn from `generator`, then (in training)
    drop_masks, else drawn from `generator` after eps.  Returns (loss,
    (metrics, new_state)), new_state detached."""
    if eps is None and generator is None:
        raise ValueError("loss_fn_heterogeneous draws eps from `generator`; "
                         "pass generator= or eps=")
    mus, lvs, new_states = [], [], []
    for j, (ep, es) in enumerate(zip(params["encoders"], state["encoders"])):
        (mu, lv), ns = paper_model.encoder_apply(ep, es, views[j],
                                                 train=train)
        mus.append(mu)
        lvs.append(lv)
        new_states.append(ns)
    u, rate = bottleneck.fused_sample_rate(
        generator if eps is None else None, torch.stack(mus),
        torch.stack(lvs), link_bits=cfg.link_bits, rate_estimator="sample",
        eps=eps)
    if train and drop_masks is None:
        if generator is None:
            raise ValueError("training draws dropout masks from "
                             "`generator`; pass generator= or drop_masks=")
        drop_masks = paper_model.decoder_dropout_masks(
            generator, cfg.dense_units, labels.shape[0], device=u.device)
    joint, branch = decode(INLParams(None, params["decoder"], {}), u,
                           train=train, drop_masks=drop_masks)
    loss, metrics = losses.inl_loss(joint, list(branch), labels, mus, lvs,
                                    list(u), s=cfg.s, rates=list(rate))
    metrics["accuracy"] = losses.accuracy(joint, labels)
    new_state = tree_map(torch.Tensor.detach, {"encoders": new_states})
    return loss, (metrics, new_state)
