"""Federated learning (FedAvg) behind the unified Scheme API (wraps
core/fl.py).

Reference: src/repro/core/schemes/fl.py (`_pack_exp2_views`, `FLScheme`:
`batches_per_round`, `init`, `make_round`, `make_transport_round`,
`make_sharded_round`, `state_shardings`, `predict`, `bits_per_round`,
`wire_bytes_per_round`).  One round == one
FedAvg round: each of the J
clients takes `local_steps` optimizer steps on its own minibatches, then
the server averages the weights and re-broadcasts them, so one round
consumes J * local_steps minibatches and moves 2 N J s bits (full weights
down and up, Table I).  As in the paper's Exp-2 setting, client j observes
only its own noise level: its view of the batch images is broadcast to all
J branch inputs of the full Fig.-4 model.  Inference is central: the
aggregated model on the average-quality view.

FL has no cut-layer exchange: its wire carries full fp32 weights, so
`wire` is accepted for interface parity and ignored.  A star whose edges
carry LinkModels (or cfg.edge_dropout > 0) runs the masked FedAvg: the
uploads the round's draw (`round_key=`, core/linkfault.client_delivery_mask)
or the transport round's explicit mask drops are left out of the average,
and an all-lost round keeps the previous global model.  On a mesh
(core/sharded.py) the J client replicas, their model states and optimizer
states lie on 'client' (`state_shardings`): each rank trains its own
clients and the server's average is one sum over 'client'.
"""
from __future__ import annotations

import torch

from repro_torch import (as_generator, as_input, optim, resolve_device,
                         tree_stack)
from repro_torch import tree_map
from repro_torch.core import bandwidth, fl, linkfault, paper_model, sharded
from repro_torch.core import schemes as _schemes
from repro_torch.core import topology as topology_lib
from repro_torch.core.schemes import base


def _pack_exp2_views(views, labels, J: int, ls: int):
    """(R, J, B, ...) round views -> the FedAvg packing: client j takes
    minibatches [j*ls, (j+1)*ls) and sees only ITS view of them, broadcast
    to the model's J branch inputs (paper Exp-2).  Returns ((J, ls, J, B,
    ...) views, (J, ls, B) labels)."""
    B = views.shape[2]
    v5 = views.reshape((J, ls) + tuple(views.shape[1:]))
    own = torch.stack([v5[j, :, j] for j in range(J)])     # (J, ls, B, ...)
    packed = own[:, :, None].expand((J, ls, J) + tuple(own.shape[2:]))
    return packed, labels.reshape(J, ls, B)


@_schemes.register
class FLScheme(base.Scheme):
    name = "fl"
    local_steps = 2

    def batches_per_round(self, cfg) -> int:
        return cfg.num_clients * self.local_steps

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None):
        device = resolve_device(device)
        generator = as_generator(generator, device)
        params, state = fl.init(cfg, generator, device=device)
        opt = optim.adam(lr)
        # one optimizer state per client, as the reference's vmapped init
        opt_state = tree_stack([opt.init(fl.replica(params, j))
                                for j in range(cfg.num_clients)])
        return {"params": params, "state": state, "opt": opt_state}

    def _make_round(self, cfg, lr, *, faulty, mesh=None):
        """round_fn(state, views, labels, generator, mask, *,
        drop_masks=None, plan=None); mask None on the clean round, else
        the (J,) client delivery mask (a host array, or with `plan` a
        device tensor).  On `mesh` the state is this rank's slice."""
        if mesh is None:
            round_impl = fl.make_round(cfg, optim.adam(lr), self.local_steps,
                                       faulty=faulty)
        else:
            round_impl = sharded.make_fl_sharded_round(
                cfg, mesh, optim.adam(lr), self.local_steps, faulty=faulty)
        J, ls = cfg.num_clients, self.local_steps

        def round_fn(state, views, labels, generator, mask, *,
                     drop_masks=None, plan=None):
            """views (J * local_steps, J, B, ...), labels (J * local_steps,
            B); drop_masks[j][s] for client j's local step s, drawn from
            `generator` client after client unless given."""
            packed, lab = _pack_exp2_views(views, labels, J, ls)
            if drop_masks is None:
                B = lab.shape[-1]
                drop_masks = [[paper_model.decoder_dropout_masks(
                    generator, cfg.dense_units, B, device=lab.device)
                    for _ in range(ls)] for _ in range(J)]
            params, st, opt_state, metrics = round_impl(
                state["params"], state["state"], state["opt"], packed, lab,
                drop_masks, mask, plan=plan)
            return ({"params": params, "state": st, "opt": opt_state},
                    metrics)
        return round_fn

    def make_round_parts(self, cfg, *, lr: float = 2e-3,
                         wire: str = "dense", topology=None):
        return self._parts(cfg, lr, topology, None)

    def make_sharded_round_parts(self, cfg, mesh, *, lr: float = 2e-3,
                                 wire: str = "dense", topology=None):
        return self._parts(cfg, lr, topology, mesh)

    def state_shardings(self, cfg, state, mesh):
        # every FL state leaf is a stacked per-client replica (leading J):
        # params, model state and the per-client optimizer states
        return tree_map(lambda _: "client", state)

    def _parts(self, cfg, lr, topology, mesh):
        # the weight exchange is a client <-> server star by definition; a
        # star whose edges carry LinkModels (or cfg.edge_dropout > 0) runs
        # the masked FedAvg on the round's client delivery mask
        topology_lib.require_star(topology, cfg, scheme=self.name)
        topo_full = topology_lib.resolve(topology, cfg)
        faulty = linkfault.active(topo_full, cfg, train=True)
        inner = self._make_round(cfg, lr, faulty=faulty, mesh=mesh)

        def plan(round_key, batch_size):
            # the server's average is decided on the host: over all, none
            # or n of the uploads, one graph per decision
            if not faulty:
                return "all", None
            if round_key is None:
                raise ValueError("an FL round over unreliable links "
                                 "draws its client delivery mask from "
                                 "round_key; pass round_key=")
            mask = linkfault.client_delivery_mask(round_key, topo_full, cfg,
                                                  train=True)
            sig = fl.average_plan(mask)
            return sig, (mask if isinstance(sig, tuple) else None)

        def device_step(state, views, labels, generator, sig, mask, *,
                        drop_masks=None):
            return inner(state, views, labels, generator, mask,
                         drop_masks=drop_masks,
                         plan=sig if faulty else None)
        return base.RoundParts(plan, device_step)

    def make_transport_round_parts(self, cfg, *, lr: float = 2e-3,
                                   wire: str = "dense", topology=None):
        # the (J,) verdict is the set of client uploads that ARRIVED:
        # missing clients leave the average and their round of local work
        # is lost (all lost keeps the previous global model); the average
        # over all, none or n of them is the host's decision
        topology_lib.require_star(topology, cfg, scheme=self.name)
        inner = self._make_round(cfg, lr, faulty=True)

        def plan(delivery, batch_size):
            sig = fl.average_plan(delivery)
            return sig, (delivery if isinstance(sig, tuple) else None)

        def device_step(state, views, labels, generator, sig, mask, *,
                        drop_masks=None):
            return inner(state, views, labels, generator, mask,
                         drop_masks=drop_masks, plan=sig)
        return base.RoundParts(plan, device_step)

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None):
        # FL inference is central: aggregated model, average-quality view
        views = as_input(state["params"], views, device)
        with torch.no_grad():
            return fl.predict(state["params"], state["state"],
                              views.mean(dim=0))

    def bits_per_round(self, cfg, state, batch_size: int, *,
                       topology=None) -> float:
        topology_lib.require_star(topology, cfg, scheme=self.name)
        N = paper_model.fl_param_count(cfg)
        return bandwidth.fl_round_bits(N, cfg.num_clients, cfg.link_bits)

    def wire_bytes_per_round(self, cfg, state, batch_size: int, *,
                             wire: str = "dense", topology=None) -> float:
        # weights down + weights up for every client, at the buffers'
        # actual (fp32 master) sizes: FL keeps a full-precision exchange
        # whatever the wire format (the leading J axis is per client)
        return float(2 * base.tree_nbytes(state["params"]))
