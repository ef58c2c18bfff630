"""The `Scheme` interface registered schemes implement.

Reference: src/repro/core/schemes/base.py (`Scheme.batches_per_round`,
`init`, `make_round`, `make_transport_round`, `make_epoch`, `predict`,
`serve_buckets`, `predict_batched`, `predict_under_faults`, the bandwidth
ledgers `bits_per_round`, `epoch_overhead_bits`, `wire_bytes_per_round`,
`epoch_overhead_wire_bytes`, `edge_ledger`, `evaluate_accuracy` and
`evaluate_accuracy_under_faults`).  A
scheme's `state` is an opaque dict of tensors bundling its parameters,
model state and optimizer state; only the scheme looks inside.

Rounds vs batches: a "round" is the scheme's training transaction (one
optimizer step for INL); `batches_per_round` tells the runner how many
(views, labels) minibatches to stack into one round call, which receives
them as (R, J, B, ...) / (R, B) tensors.  Randomness comes from a
torch.Generator the runner owns and hands to every round; over unreliable
links a round also takes its fault key (`round_key=`,
core/linkfault.round_key), from which it draws its delivery masks.

The sharded round comes with its slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree_leaves
from repro_torch.core import linkfault
from repro_torch.core import topology as topology_lib


class Scheme:
    """Base class: override `init`, `make_round`, `predict` and the
    bandwidth ledgers."""

    name: str = ""

    def batches_per_round(self, cfg) -> int:
        """Minibatches one round consumes (the runner stacks this many)."""
        return 1

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None) -> Any:
        """Build parameters and optimizer state for `cfg`
        (PaperExperimentConfig) on `device` (None: cuda), deterministic in
        `generator`; `lr` must match `make_round`'s."""
        raise NotImplementedError

    def make_round(self, cfg, *, lr: float = 2e-3, wire: str = "dense",
                   topology=None):
        """Return round_fn(state, views, labels, generator, *, eps=None,
        drop_masks=None, round_key=None) -> (new_state, metrics) with
        views (R, J, B, H, W, C), labels (R, B), R ==
        batches_per_round(cfg).  The round draws its randomness from
        `generator` unless it is given, and over unreliable links its fault
        draws from `round_key`; metrics include "loss"."""
        raise NotImplementedError

    def make_transport_round(self, cfg, *, lr: float = 2e-3,
                             wire: str = "dense", topology=None):
        """Return round_fn(state, views, labels, generator, delivery, *,
        drop_masks=None) -> (new_state, metrics): `make_round` with the
        fault outcome as an EXPLICIT (J,) boolean argument in place of a
        draw.  Each scheme applies its own degradation to the same mask:
        INL partial-fuses the surviving views (one vote lost per failed
        route), FL drops the missing clients from the FedAvg average (their
        whole round of local work lost), SL carries the state through
        unchanged unless every link delivered (the whole round lost)."""
        raise NotImplementedError(f"scheme {self.name!r} has no "
                                  "transport round")

    def make_epoch(self, cfg, *, lr: float = 2e-3, mesh=None,
                   wire: str = "dense", topology=None):
        """K rounds in one call: epoch_fn(state, views, labels, generator)
        -> (state, metrics) with views (K, R, J, B, ...), labels (K, R, B)
        and metrics stacked (K,).  The reference runs them as one jitted
        lax.scan; eager PyTorch has no scan, so this is a Python loop over
        `make_round`, drawing from `generator` round after round exactly as
        K separate rounds would."""
        if mesh is not None:
            raise NotImplementedError("mesh execution comes with the "
                                      "sharded slice of the port")
        round_fn = self.make_round(cfg, lr=lr, wire=wire, topology=topology)

        def epoch_fn(state, views, labels, generator):
            per_round = []
            for k in range(views.shape[0]):
                state, metrics = round_fn(state, views[k], labels[k],
                                          generator)
                per_round.append(metrics)
            stacked = {key: torch.stack([m[key] for m in per_round])
                       for key in (per_round[0] if per_round else {})}
            return state, stacked
        return epoch_fn

    # serving bucket sizes (repro_torch/serving): in-flight requests are
    # padded to the smallest bucket, so the engine runs at most one batch
    # shape per bucket size
    serve_buckets: Tuple[int, ...] = (1, 4, 16, 64)

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None) -> Any:
        """views (J, B, ...) -> class probabilities (B, C); rows sum to 1."""
        raise NotImplementedError

    def predict_batched(self, state, views, *, delivery=None, topology=None,
                        cfg=None, wire: str = "dense", device=None) -> Any:
        """The serving plane's batched inference entry: `predict` plus an
        optional (J,) or (J, B) per-request delivery mask and the serving
        wire format.  delivery=None MUST equal `predict` bit for bit.

        Default masked semantics (single-uplink schemes: FL's central
        model, SL's one boundary): a request answers only if its whole
        uplink payload arrived; any dropped view degrades it to the uniform
        distribution.  INL overrides with per-request partial fusion."""
        probs = self.predict(state, views, topology=topology, cfg=cfg,
                             device=device)
        if delivery is None:
            return probs
        ok = np.all(host_mask(delivery), axis=0)
        return linkfault.degrade_probs(probs, ok)

    def predict_under_faults(self, state, views, key, topology=None,
                             cfg=None, *, device=None) -> Any:
        """`predict` when the topology's links are unreliable: per-request
        fault draws from `key` (a linkfault key) decide what the decoding
        side receives.  Default (FL's central model, SL's client -> server
        boundary): the answer rides ONE uplink, and a request whose
        erasure or deadline draw fails gets the uniform distribution.  INL
        overrides with per-sample partial fusion."""
        probs = self.predict(state, views, topology=topology, cfg=cfg,
                             device=device)
        topo = topology_lib.resolve(topology, cfg)
        ok = linkfault.request_survival(key, topo, cfg, views.shape[1])
        return linkfault.degrade_probs(probs, ok)

    def bits_per_round(self, cfg, state, batch_size: int, *,
                       topology=None) -> float:
        """Bits moved by ONE round, via the core/bandwidth.py closed
        forms."""
        raise NotImplementedError

    def epoch_overhead_bits(self, cfg, state) -> float:
        """Bits charged once per epoch on top of the per-round cost.
        Default 0."""
        return 0.0

    def wire_bytes_per_round(self, cfg, state, batch_size: int, *,
                             wire: str = "dense", topology=None) -> float:
        """MEASURED bytes one round puts on the wire under `wire`: the
        nbytes of the transmitted buffers (core/wirefmt.py), not the
        closed-form accounting."""
        raise NotImplementedError

    def epoch_overhead_wire_bytes(self, cfg, state) -> float:
        """Measured bytes of the once-per-epoch transfers.  Default 0."""
        return 0.0

    def edge_ledger(self, cfg, state, batch_size: int, *,
                    wire: str = "dense",
                    topology=None) -> Optional[Dict[str, Tuple[float,
                                                               float]]]:
        """Per-edge bandwidth of one round: {edge_key: (closed-form bits,
        measured wire bytes)}, summing to bits_per_round /
        wire_bytes_per_round exactly.  None (the default) for schemes whose
        exchange has no per-edge decomposition."""
        return None

    @staticmethod
    def param_count(tree) -> int:
        return sum(t.numel() for t in tree_leaves(tree))

    def __repr__(self):
        return f"<Scheme {self.name!r}>"


def tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of `tree`: what moving it costs."""
    return sum(t.nbytes for t in tree_leaves(tree))


def host_mask(mask) -> np.ndarray:
    """A delivery mask (numpy, or a tensor on any device) as a host bool
    array."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return np.asarray(mask, bool)


def evaluate_accuracy(scheme: Scheme, state, views, labels, topology=None,
                      cfg=None, *, device=None) -> float:
    """Top-1 accuracy through the scheme's own predict convention, one
    predict over all of `views`."""
    probs = scheme.predict(state, views, topology=topology, cfg=cfg,
                           device=device)
    return _accuracy(probs, labels)


def evaluate_accuracy_under_faults(scheme: Scheme, state, views, labels,
                                   key, topology=None, cfg=None, *,
                                   device=None) -> float:
    """Top-1 accuracy through `predict_under_faults`: the per-request fault
    draws come from `key` (vary it to average over network
    realisations)."""
    probs = scheme.predict_under_faults(state, views, key, topology=topology,
                                        cfg=cfg, device=device)
    return _accuracy(probs, labels)


def _accuracy(probs, labels) -> float:
    labels = torch.as_tensor(labels, device=probs.device)
    return float((torch.argmax(probs, dim=-1) == labels)
                 .to(torch.float32).mean())
