"""Split learning behind the unified Scheme API (wraps core/sl.py).

Reference: src/repro/core/schemes/sl.py (`SLScheme.init`, `make_round`,
`predict`, `bits_per_round`, `epoch_overhead_bits`,
`wire_bytes_per_round`, `epoch_overhead_wire_bytes`).  One round == one
client -> server -> client exchange on a minibatch: the client's conv
branches emit deterministic cut-layer activations through the fused
kernel's no-noise mode, they cross the wire (`wire=`: dense, or packed
codeword lanes on the pack kernels), the server decoder computes the loss
and the error vector comes back through the kernel's backward.  Per §III-C
the epoch costs (2 p q + eta N J) s: the activation/error traffic accrues
per round, the J sequential client -> client weight hand-offs once per
epoch.

The reference's bounded retry over a lossy uplink (`_skip_failed_round`)
is the identity on the clean star, the only network this slice runs; link
models raise NotImplementedError naming the link-fault slice, as do the
transport and sharded rounds their slices.
"""
from __future__ import annotations

import torch

from repro_torch import as_generator, as_input, optim, resolve_device
from repro_torch.core import bandwidth, paper_model, sl, wirefmt
from repro_torch.core import schemes as _schemes
from repro_torch.core.schemes import base


@_schemes.register
class SLScheme(base.Scheme):
    name = "sl"

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None):
        device = resolve_device(device)
        generator = as_generator(generator, device)
        (client, server), state = sl.init(cfg, generator, device=device)
        return {"client": client, "server": server, "state": state,
                "opt_c": optim.adam(lr).init(client),
                "opt_s": optim.adam(lr).init(server)}

    def make_round(self, cfg, *, lr: float = 2e-3, wire: str = "dense",
                   topology=None):
        # SL's cut is ONE client -> server boundary (all conv branches live
        # on the active client), so only the star has a reading here
        base.clean_star(cfg, topology, scheme=self.name)
        step = sl.make_train_step(
            optim.adam(lr), optim.adam(lr), link_bits=cfg.link_bits,
            wire=wire, compute_dtype=getattr(cfg, "compute_dtype", "fp32"))

        def round_fn(state, views, labels, generator, *, drop_masks=None):
            """views (1, J, B, ...), labels (1, B); the server decoder's
            dropout masks drawn from `generator` unless given."""
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
        return round_fn

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None):
        views = as_input(state["client"], views, device)
        with torch.no_grad():
            return sl.predict(state["client"], state["server"],
                              state["state"], views)

    def bits_per_round(self, cfg, state, batch_size: int, *,
                       topology=None) -> float:
        base.clean_star(cfg, topology, scheme=self.name)
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
