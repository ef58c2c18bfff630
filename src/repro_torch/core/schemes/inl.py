"""In-network learning behind the unified Scheme API (wraps core/inl.py).

Reference: src/repro/core/schemes/inl.py (`INLScheme.init`, `make_round`,
`make_transport_round`, `predict`, `predict_batched`,
`predict_under_faults`, `bits_per_round`, `wire_bytes_per_round`,
`edge_ledger`).  One round == one eq.-(6) optimizer step (Adam, the
reference's b2=0.95 with global-norm clipping) on a (J, B) multi-view
batch; the cut layer is the fused kernel pair.  Bandwidth per round is the
paper's 2 b p s — activations forward, eq.-(10) error vectors back — through
the Table-I closed form, and per edge through core/topology.

INL is the scheme the network graph belongs to: `topology=` runs non-star
graphs (chains, trees, per-edge widths) through the multi-hop execution
(core/topology.graph_cut_and_ship) in `make_round`, `predict` and
`predict_batched`, and both ledgers decompose per edge (`edge_ledger`),
each edge charged for the payload it carries.

Over unreliable links (core/linkfault.py) INL degrades per VIEW: a round
fuses the views whose routes survived its fault draw (`round_key=`), the
transport round fuses the views its explicit (J,) mask says arrived, and
`predict_under_faults` draws a (J,) route-survival mask per sample; a lost
link costs one vote, not the round or the prediction.
"""
from __future__ import annotations

from repro_torch import optim
from repro_torch.core import bandwidth, inl, linkfault, paper_model, wirefmt
from repro_torch.core import schemes as _schemes
from repro_torch.core import topology as topology_lib
from repro_torch.core.schemes import base


@_schemes.register
class INLScheme(base.Scheme):
    name = "inl"

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None):
        params, state = inl.init(cfg, generator, device=device)
        return {"params": params, "state": state,
                "opt": optim.adam(lr).init(params)}

    def make_round_parts(self, cfg, *, lr: float = 2e-3,
                         wire: str = "dense", topology=None):
        step = inl.make_train_step(cfg, optim.adam(lr), wire=wire,
                                   topology=topology)

        def device_step(state, views, labels, generator, sig, mask, *,
                        eps=None, drop_masks=None):
            params, st, opt_state, metrics = step(
                state["params"], state["state"], state["opt"], views[0],
                labels[0], generator, eps=eps, drop_masks=drop_masks,
                delivery=mask)
            return ({"params": params, "state": st, "opt": opt_state},
                    metrics)
        return base.RoundParts(
            base.fusion_plan(cfg, topology, inl.ROUND_KEY_MESSAGE),
            device_step)

    def make_transport_round(self, cfg, *, lr: float = 2e-3,
                             wire: str = "dense", topology=None):
        # the (J,) outcome IS the round's delivery mask: surviving views
        # partial-fuse, lost ones cost exactly their own vote
        step = inl.make_train_step(cfg, optim.adam(lr), wire=wire,
                                   topology=topology, explicit_delivery=True)

        def round_fn(state, views, labels, generator, delivery, *, eps=None,
                     drop_masks=None):
            params, st, opt_state, metrics = step(
                state["params"], state["state"], state["opt"], views[0],
                labels[0], generator, delivery, eps=eps,
                drop_masks=drop_masks)
            return ({"params": params, "state": st, "opt": opt_state},
                    metrics)
        return round_fn

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None):
        return inl.predict(state["params"], state["state"], views, cfg=cfg,
                           topology=topology, device=device)

    def predict_batched(self, state, views, *, delivery=None, topology=None,
                        cfg=None, wire: str = "dense", device=None):
        # delivery=None reproduces `predict` bit for bit — the engine's
        # bucket-padding parity contract
        return inl.predict(state["params"], state["state"], views, cfg=cfg,
                           topology=topology, delivery=delivery, wire=wire,
                           device=device)

    def predict_under_faults(self, state, views, key, topology=None,
                             cfg=None, *, device=None):
        # per-sample partial fusion: each request draws its own (J,)
        # route-survival mask and the fusion renormalises over the arrivals
        topo_full = topology_lib.resolve(topology, cfg)
        delivery = linkfault.sample_delivery_mask(key, topo_full, cfg,
                                                  views.shape[1])
        return inl.predict(state["params"], state["state"], views, cfg=cfg,
                           topology=topology, delivery=delivery,
                           device=device)

    def bits_per_round(self, cfg, state, batch_size: int, *,
                       topology=None) -> float:
        topo = topology_lib.nontrivial(topology, cfg)
        if topo is not None:
            return topology_lib.round_bits(topo, cfg, batch_size)
        # §III-C: each of the J nodes holds q/J of the round's q = b*J
        # node-points and sends p/J = d_bottleneck values per point, both
        # directions -> 2 b p s with p = J * d_bottleneck.
        p = cfg.num_clients * cfg.d_bottleneck
        return bandwidth.inl_epoch_bits(p, batch_size * cfg.num_clients,
                                        cfg.num_clients, cfg.link_bits)

    def wire_bytes_per_round(self, cfg, state, batch_size: int, *,
                             wire: str = "dense", topology=None) -> float:
        topo = topology_lib.nontrivial(topology, cfg)
        if topo is not None:
            return topology_lib.round_wire_bytes(topo, cfg, batch_size,
                                                 wire=wire)
        # J*B latent d_b-vectors forward and their error chunks back
        return wirefmt.round_wire_bytes(
            cfg.num_clients * batch_size, cfg.d_bottleneck,
            link_bits=cfg.link_bits, wire=wire,
            dtype=paper_model.compute_dtype(cfg))["total"]

    def edge_ledger(self, cfg, state, batch_size: int, *,
                    wire: str = "dense", topology=None):
        # the star is J single-latent edges whose charges sum to the
        # Table-I totals exactly
        topo = topology_lib.resolve(topology, cfg)
        bits = topology_lib.round_edge_bits(topo, cfg, batch_size)
        nbytes = topology_lib.round_edge_wire_bytes(topo, cfg, batch_size,
                                                    wire=wire)
        return {k: (bits[k], nbytes[k]) for k in bits}
