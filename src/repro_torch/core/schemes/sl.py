"""Split learning behind the unified Scheme API (wraps core/sl.py).

Reference: src/repro/core/schemes/sl.py (`SLScheme.max_link_retries`,
`init`, `_skip_failed_round` — here the host part of
`make_round_parts` —, `_make_raw_round`, `make_round`,
`make_transport_round`, `predict`, `bits_per_round`,
`epoch_overhead_bits`, `wire_bytes_per_round`,
`epoch_overhead_wire_bytes`).  One round == one
client -> server -> client exchange on a minibatch: the client's conv
branches emit deterministic cut-layer activations through the fused
kernel's no-noise mode, they cross the wire (`wire=`: dense, or packed
codeword lanes on the pack kernels), the server decoder computes the loss
and the error vector comes back through the kernel's backward.  Per §III-C
the epoch costs (2 p q + eta N J) s: the activation/error traffic accrues
per round, the J sequential client -> client weight hand-offs once per
epoch.

Over unreliable links (core/linkfault.py) SL has no partial-fusion
reading: its single client -> server uplink either works within
1 + `max_link_retries` attempts (drawn from the round's `round_key`) or the
round is SKIPPED.  A skipped round is still computed, so it draws from
the run's generator as any round does, and its result is discarded: the
state (parameters, BatchNorm statistics, both optimizer states) carries
through unchanged.  The sharded round comes with its slice of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import as_generator, as_input, optim, resolve_device
from repro_torch.core import bandwidth, linkfault, paper_model, sl, wirefmt
from repro_torch.core import schemes as _schemes
from repro_torch.core import topology as topology_lib
from repro_torch.core.schemes import base


@_schemes.register
class SLScheme(base.Scheme):
    name = "sl"
    # bounded retry on the single client -> server uplink: a round runs iff
    # one of (1 + max_link_retries) attempts survives the link's erasure
    # draw, else it is skipped; every attempt is charged as offered
    # bandwidth (linkfault.round_fault_charges)
    max_link_retries = 2

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None):
        device = resolve_device(device)
        generator = as_generator(generator, device)
        (client, server), state = sl.init(cfg, generator, device=device)
        return {"client": client, "server": server, "state": state,
                "opt_c": optim.adam(lr).init(client),
                "opt_s": optim.adam(lr).init(server)}

    def _make_raw_round(self, cfg, *, lr: float, wire: str):
        """The round's computation: raw(state, views, labels, generator, *,
        drop_masks=None) with views (1, J, B, ...), labels (1, B); the
        server decoder's dropout masks drawn from `generator` unless
        given."""
        step = sl.make_train_step(
            optim.adam(lr), optim.adam(lr), link_bits=cfg.link_bits,
            wire=wire, compute_dtype=getattr(cfg, "compute_dtype", "fp32"))

        def raw(state, views, labels, generator, *, drop_masks=None):
            B = labels.shape[1]
            if drop_masks is None:
                drop_masks = paper_model.decoder_dropout_masks(
                    generator, cfg.dense_units, B, device=labels.device)
            client, server, st, opt_c, opt_s, metrics = step(
                state["client"], state["server"], state["state"],
                state["opt_c"], state["opt_s"], views[0], labels[0],
                drop_masks)
            return ({"client": client, "server": server, "state": st,
                     "opt_c": opt_c, "opt_s": opt_s}, metrics)
        return raw

    def make_round_parts(self, cfg, *, lr: float = 2e-3,
                         wire: str = "dense", topology=None):
        # SL's cut is ONE client -> server boundary (all conv branches live
        # on the active client), so only the star has a reading here
        topology_lib.require_star(topology, cfg, scheme=self.name)
        raw = self._make_raw_round(cfg, lr=lr, wire=wire)
        topo_full = topology_lib.resolve(topology, cfg)
        faulty = linkfault.active(topo_full, cfg, train=True)
        attempts = self.max_link_retries + 1

        def plan(round_key, batch_size):
            # over unreliable links the bounded retry's survival is drawn
            # from the round's key; a perfect link always keeps the round
            if not faulty:
                return "keep", None
            if round_key is None:
                raise ValueError("an SL round over unreliable links draws "
                                 "its retries from round_key; pass "
                                 "round_key=")
            ok = linkfault.round_success(round_key, topo_full, cfg, attempts)
            return ("keep" if ok else "skip"), None

        def device_step(state, views, labels, generator, sig, mask, *,
                        drop_masks=None):
            # both variants compute the round, so the generator's later
            # draws stay in place; "skip" carries the state through
            new_state, metrics = raw(state, views, labels, generator,
                                     drop_masks=drop_masks)
            return (new_state if sig == "keep" else state), metrics
        return base.RoundParts(plan, device_step)

    def make_transport_round(self, cfg, *, lr: float = 2e-3,
                             wire: str = "dense", topology=None):
        # the round's exchange rides the single boundary, so it has no
        # partial reading: it RUNS iff every link delivered, else the state
        # carries through unchanged (the round is still computed)
        topology_lib.require_star(topology, cfg, scheme=self.name)
        raw = self._make_raw_round(cfg, lr=lr, wire=wire)

        def round_fn(state, views, labels, generator, delivery, *,
                     drop_masks=None):
            new_state, metrics = raw(state, views, labels, generator,
                                     drop_masks=drop_masks)
            ok = bool(np.all(base.host_mask(delivery)))
            return (new_state if ok else state), metrics
        return round_fn

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None):
        views = as_input(state["client"], views, device)
        with torch.no_grad():
            return sl.predict(state["client"], state["server"],
                              state["state"], views)

    def bits_per_round(self, cfg, state, batch_size: int, *,
                       topology=None) -> float:
        topology_lib.require_star(topology, cfg, scheme=self.name)
        # activation/error traffic only (eta = 0 cancels the hand-off term)
        p = cfg.num_clients * cfg.d_bottleneck
        N = paper_model.fl_param_count(cfg)
        return bandwidth.sl_epoch_bits(p, batch_size, N, cfg.num_clients,
                                       0.0, cfg.link_bits)

    def epoch_overhead_bits(self, cfg, state) -> float:
        # q = 0 isolates the eta*N*J hand-off term; eta*N == client params
        p = cfg.num_clients * cfg.d_bottleneck
        N = paper_model.fl_param_count(cfg)
        eta = self.param_count(state["client"]) / N
        return bandwidth.sl_epoch_bits(p, 0, N, cfg.num_clients, eta,
                                       cfg.link_bits)

    def wire_bytes_per_round(self, cfg, state, batch_size: int, *,
                             wire: str = "dense", topology=None) -> float:
        # J*B deterministic cut d_b-vectors to the server, error vectors
        # back: the same per-vector wire encoding as INL's exchange
        return wirefmt.round_wire_bytes(
            cfg.num_clients * batch_size, cfg.d_bottleneck,
            link_bits=cfg.link_bits, wire=wire,
            dtype=paper_model.compute_dtype(cfg))["total"]

    def epoch_overhead_wire_bytes(self, cfg, state) -> float:
        # the J sequential client -> client hand-offs each move the
        # client-side parameter buffers (fp32 master weights: the wire
        # format does not quantize weight transfers)
        return float(base.tree_nbytes(state["client"]) * cfg.num_clients)
