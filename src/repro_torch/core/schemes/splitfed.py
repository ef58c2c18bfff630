"""SplitFed behind the unified Scheme API (Thapa et al.'s SplitFedV1
synchronisation, recast on the paper's multi-view setting).

Reference: src/repro/core/schemes/splitfed.py (`client_cfg`,
`tree_nbytes` — here `base.tree_nbytes` —, `fedavg`, `_encode` — here
`paper_model.stacked_encoder_apply` —, `_fuse_cat` — here
`paper_model.concat_latents` —, `SplitFedScheme`:
`init`, `_loss`, `_make_step`, `make_round`, `make_transport_round`,
`_predict`, `predict`, `predict_batched`, `predict_under_faults`,
`_weight_charges`, `edge_ledger`, `bits_per_round`,
`wire_bytes_per_round`).

One round == one parallel SL-style step against a shared server decoder
PLUS one FedAvg of the client-side weights: every client encoder ships its
DETERMINISTIC cut-layer activations (the fused kernel's no-noise mode,
`wirefmt.cut_and_ship(None, ...)`, the substrate SL's boundary uses) to
the server decoder, the eq.-(10) error chunks flow back per client, one
Adam step (global-norm clipping across encoders and decoder) updates
everything, and the freshly updated client encoders are averaged and
re-broadcast.  Neither the Adam moments nor the BatchNorm statistics are
averaged.  Bandwidth per round is the INL-style cut exchange (per edge,
wire-encoded) PLUS an FL-style fp32 weight exchange of the client-side
network, both decomposed per edge in `edge_ledger`.

`cfg.cut_depth` picks how many conv blocks stay client-side (`client_cfg`
truncates the trunk); None keeps the full trunk.  Any single-sink
topology runs: a non-star graph ships the latents through
`topology.graph_cut_and_ship`.

Randomness: the server decoder's dropout keep masks are drawn from the
round's torch.Generator unless given as `drop_masks=` (the reference draws
them from the second half of `split(rng)`).  Over unreliable links the
round's (J,) delivery mask comes from its `round_key`
(core/linkfault.round_delivery_mask), and a dead route costs BOTH
exchanges: the client's activations drop out of the fusion
(`linkfault.partial_fuse`) and its weights out of the average (`fedavg`:
the stranded client keeps its local update).  A clean round averages
under an all-ones mask, the same formula, so perfect links leave the
trajectory as it was bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import (as_generator, as_input, optim, resolve_device,
                         tree_leaves, tree_map, tree_stack, value_and_grad)
from repro_torch.core import bottleneck, linkfault, losses, paper_model
from repro_torch.core import schemes as _schemes
from repro_torch.core import topology as topology_lib
from repro_torch.core import wirefmt
from repro_torch.core.schemes import base


def client_cfg(cfg):
    """The config the CLIENT-side network is built from: conv trunk
    truncated to the first `cfg.cut_depth` blocks (None = full trunk)."""
    k = getattr(cfg, "cut_depth", None)
    if k is None:
        return cfg
    k = int(k)
    if not 1 <= k <= len(cfg.conv_channels):
        raise ValueError(
            f"cut_depth must be in [1, {len(cfg.conv_channels)}] (the conv "
            f"trunk has {len(cfg.conv_channels)} blocks), got {k}")
    return dataclasses.replace(cfg, cut_depth=None,
                               conv_channels=cfg.conv_channels[:k])


def fedavg(new, mask):
    """Masked FedAvg over the stacked leading-J axis of the tree `new`:
    surviving clients (the (J,) bool `mask`, a host array or a tensor)
    receive sum(x * w) / max(n, 1), the survivors' average, a division of
    two tensors; dead routes keep their LOCAL update (they neither
    uploaded nor heard the broadcast), so a round with no survivor leaves
    every client its own.  An all-ones mask is the clean round: every
    client gets sum / J.  n is computed on the device (a sum of 0/1 fp32
    values, exact), so a captured round reads no host value."""
    device = tree_leaves(new)[0].device
    w = linkfault.mask_tensor(mask, device).to(torch.float32)
    J = w.shape[0]
    n = torch.clamp(torch.sum(w), min=1.0)

    def avg(x):
        wx = w.reshape((J,) + (1,) * (x.dim() - 1))
        a = torch.sum(x.to(torch.float32) * wx, dim=0) / n
        return torch.where(wx > 0, a.expand(x.shape).to(x.dtype), x)
    return tree_map(avg, new)


def init_clients_and_decoder(cfg, generator, *, device):
    """(params {"encoders": stacked at client_cfg(cfg), "decoder"}, state
    {"encoders": stacked BatchNorm state}) from `generator`: the J client
    encoders first, then the server decoder."""
    ccfg = client_cfg(cfg)
    nodes = [paper_model.encoder_init(generator, ccfg, device=device)
             for _ in range(cfg.num_clients)]
    params = {"encoders": tree_stack([p for p, _ in nodes]),
              "decoder": paper_model.decoder_init(generator, cfg,
                                                  device=device)}
    return params, {"encoders": tree_stack([s for _, s in nodes])}


def cut_latents(cfg, mu, logvar, *, wire: str, topo):
    """The deterministic cut (eps == 0, rate "none") of the stacked (J, B,
    d) latents at cfg.link_bits over `wire`: the star through
    `wirefmt.cut_and_ship`, a non-star graph (`topo`) through
    `topology.graph_cut_and_ship`.  Returns (u, u_joint): each client's own
    quantized latent and what the server receives."""
    if topo is None:
        u, _, u_joint = wirefmt.cut_and_ship(
            None, mu, logvar, link_bits=cfg.link_bits,
            rate_estimator="none", wire=wire)
    else:
        u, _, u_joint = topology_lib.graph_cut_and_ship(
            topo, cfg, mu, logvar,
            torch.zeros(mu.shape, dtype=torch.float32, device=mu.device),
            rate_estimator="none", wire=wire)
    return u, u_joint


def predict_latents(params, state, views, cfg, topo, wire):
    """Inference's encoders and cut: (u, u_joint).  The star ships
    UNQUANTIZED latents (INL's convention: `fused_sample_rate` at its
    default 32-bit grid); a graph routes them through its hops on
    `wire`."""
    (mu, logvar), _ = paper_model.stacked_encoder_apply(
        params["encoders"], state["encoders"], views, train=False)
    if topo is None:
        u, _ = bottleneck.fused_sample_rate(None, mu, logvar,
                                            rate_estimator="none")
        return u, u
    return cut_latents(cfg, mu, logvar, wire=wire, topo=topo)


@_schemes.register
class SplitFedScheme(base.Scheme):
    name = "splitfed"

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None):
        device = resolve_device(device)
        params, state = init_clients_and_decoder(
            cfg, as_generator(generator, device), device=device)
        return {"params": params, "state": state,
                "opt": optim.adam(lr).init(params)}

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _loss(self, params, enc_state, views, labels, cfg, *, wire, topo,
              delivery, drop_masks):
        """The server's cross-entropy on the fused cut latents.  Returns
        (loss, (metrics, new encoder state, detached))."""
        dt = paper_model.compute_dtype(cfg)
        params_c = paper_model.cast_compute(params, dt)
        (mu, logvar), new_enc = paper_model.stacked_encoder_apply(
            params_c["encoders"], enc_state["encoders"], views.to(dt),
            train=True)
        _, u_joint = cut_latents(cfg, mu, logvar, wire=wire, topo=topo)
        if delivery is not None:
            u_joint = linkfault.partial_fuse(u_joint, delivery)
        logits = paper_model.decoder_apply(
            params_c["decoder"], paper_model.concat_latents(u_joint),
            train=True, drop_masks=drop_masks)
        loss = losses.xent(logits, labels)
        metrics = {"loss": loss, "accuracy": losses.accuracy(logits, labels)}
        return loss, (metrics, tree_map(torch.Tensor.detach,
                                        {"encoders": new_enc}))

    def _make_step(self, cfg, *, lr, wire, topology):
        """step(state, views, labels, generator, delivery, drop_masks):
        views (J, B, ...), labels (B,), delivery a (J,) bool mask (a host
        array or a device tensor) or None (the clean round)."""
        opt = optim.adam(lr)
        topo = topology_lib.nontrivial(topology, cfg)
        topology_lib.check_wires(topo, cfg, wire)
        J = cfg.num_clients

        def step(state, views, labels, generator, delivery, drop_masks):
            if drop_masks is None:
                drop_masks = paper_model.decoder_dropout_masks(
                    generator, cfg.dense_units, labels.shape[0],
                    device=labels.device)
            _, (metrics, new_enc), grads = value_and_grad(
                self._loss, state["params"], state["state"], views, labels,
                cfg, wire=wire, topo=topo, delivery=delivery,
                drop_masks=drop_masks)
            params, opt_state = opt.update(grads, state["opt"],
                                           state["params"])
            # the clean round averages under an all-ones mask: the same
            # formula, so perfect links equal no links bit for bit
            mask = torch.ones((J,), dtype=torch.bool, device=labels.device) \
                if delivery is None else delivery
            params = dict(params, encoders=fedavg(params["encoders"], mask))
            metrics = {k: v.detach() for k, v in metrics.items()}
            return ({"params": params, "state": new_enc, "opt": opt_state},
                    metrics)
        return step

    def make_round_parts(self, cfg, *, lr: float = 2e-3,
                         wire: str = "dense", topology=None):
        """The round (views (1, J, B, ...), labels (1, B)): over unreliable
        links its (J,) delivery mask is drawn on the host from
        `round_key`."""
        step = self._make_step(cfg, lr=lr, wire=wire, topology=topology)
        return fault_drawing_parts(self.name, cfg, topology, step)

    def make_transport_round(self, cfg, *, lr: float = 2e-3,
                             wire: str = "dense", topology=None):
        # the (J,) outcome masks BOTH of the round's exchanges: a dead
        # route's activations leave the fusion AND its weights the average
        step = self._make_step(cfg, lr=lr, wire=wire, topology=topology)

        def round_fn(state, views, labels, generator, delivery, *,
                     drop_masks=None):
            return step(state, views[0], labels[0], generator,
                        base.host_mask(delivery), drop_masks)
        return round_fn

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def _predict(self, state, views, topology, cfg, delivery=None,
                 wire: str = "dense", device=None):
        views = as_input(state["params"], views, device)
        topo = None if cfg is None else topology_lib.nontrivial(topology,
                                                                cfg)
        with torch.no_grad():
            _, u = predict_latents(state["params"], state["state"], views,
                                   cfg, topo, wire)
            if delivery is not None:
                u = linkfault.partial_fuse(u, delivery)
            logits = paper_model.decoder_apply(
                state["params"]["decoder"], paper_model.concat_latents(u),
                train=False)
            return torch.softmax(logits, dim=-1)

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None):
        return self._predict(state, views, topology, cfg, device=device)

    def predict_batched(self, state, views, *, delivery=None, topology=None,
                        cfg=None, wire: str = "dense", device=None):
        return self._predict(state, views, topology, cfg, delivery=delivery,
                             wire=wire, device=device)

    def predict_under_faults(self, state, views, key, topology=None,
                             cfg=None, *, device=None):
        # like INL: each sample draws a (J,) route-survival mask and the
        # server fuses (renormalised) whatever arrived
        topo_full = topology_lib.resolve(topology, cfg)
        delivery = linkfault.sample_delivery_mask(key, topo_full, cfg,
                                                  views.shape[1])
        return self._predict(state, views, topology, cfg, delivery=delivery,
                             device=device)

    # ------------------------------------------------------------------
    # bandwidth
    # ------------------------------------------------------------------

    def _weight_charges(self, cfg, state):
        """(closed bits, measured bytes) ONE client's weight exchange costs
        per direction: the client-side encoder at fp32."""
        n_enc = paper_model.encoder_param_count(client_cfg(cfg))
        enc_nbytes = base.tree_nbytes(state["params"]["encoders"]) \
            / cfg.num_clients
        return 32.0 * n_enc, enc_nbytes

    def edge_ledger(self, cfg, state, batch_size: int, *,
                    wire: str = "dense", topology=None):
        # per edge: the cut exchange its payload occupies (INL's charge)
        # + the FedAvg exchange of the payload clients' encoders, fp32 both
        # directions
        topo = topology_lib.resolve(topology, cfg)
        w_bits, w_nbytes = self._weight_charges(cfg, state)
        bits = topology_lib.round_edge_bits(topo, cfg, batch_size)
        nbytes = topology_lib.round_edge_wire_bytes(topo, cfg, batch_size,
                                                    wire=wire)
        out = {}
        for e in topo.topo_edges():
            k = len(topo.payload(e))
            out[e.key] = (bits[e.key] + 2.0 * k * w_bits,
                          nbytes[e.key] + 2.0 * k * w_nbytes)
        return out

    def bits_per_round(self, cfg, state, batch_size: int, *,
                       topology=None) -> float:
        return float(sum(b for b, _ in self.edge_ledger(
            cfg, state, batch_size, topology=topology).values()))

    def wire_bytes_per_round(self, cfg, state, batch_size: int, *,
                             wire: str = "dense", topology=None) -> float:
        return float(sum(n for _, n in self.edge_ledger(
            cfg, state, batch_size, wire=wire, topology=topology).values()))


def fault_drawing_parts(name: str, cfg, topology, step):
    """The `RoundParts` of the hybrid schemes around step(state, views,
    labels, generator, delivery, drop_masks): the host part is
    `base.fusion_plan` ("clean", or "masked" with the round's (J,) mask);
    the device part hands the mask to the step as `delivery`."""
    def device_step(state, views, labels, generator, sig, mask, *,
                    drop_masks=None):
        return step(state, views[0], labels[0], generator, mask, drop_masks)
    return base.RoundParts(
        base.fusion_plan(cfg, topology,
                         f"a {name} round over unreliable links draws its "
                         "delivery mask from round_key; pass round_key="),
        device_step)
