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

A round has two parts (`make_round_parts`): the HOST part draws the
round's faults from its key and takes every decision the host takes (a
FedAvg over all, none or n of the uploads, SL's keep or skip), returning
the round's host signature and its delivery mask; the DEVICE part is the
round's computation, with the mask as data.  `make_round` runs the two in
turn; `make_epoch` runs K rounds and on the card replays one CUDA graph of
the device part per host signature (repro_torch/graphs.py), the
counterpart of the reference's `lax.scan` over the round.

The sharded round comes with its slice of the port.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import graphs, tree_leaves, tree_map
from repro_torch.core import linkfault
from repro_torch.core import topology as topology_lib


class RoundParts(NamedTuple):
    """A round split at the host/device boundary.

    plan(round_key, batch_size) -> (signature, mask): the host part.  The
    signature (hashable) names the round's variant, one CUDA graph each
    ("clean", "masked"; SL's "keep"/"skip"; FL's "all"/"none"/("partial",
    n)); mask is the round's (J,) host bool delivery mask, or None.

    step(state, views, labels, generator, signature, mask, **kw) ->
    (new_state, metrics): the device part, mask a bool tensor on the
    device (or None), kw the round's `eps=` / `drop_masks=`."""
    plan: Callable
    step: Callable


def fusion_plan(cfg, topology, missing_key: str):
    """The host part of a round that fuses what arrived (INL, SplitFed,
    hybrid): "clean" with no mask, or over unreliable links (link models
    on the topology, or cfg.edge_dropout > 0) "masked" with the round's
    (J,) delivery mask drawn from its `round_key`, as the meter replays
    it; a lossy round without its key raises ValueError(missing_key)."""
    topo_full = topology_lib.resolve(topology, cfg)
    faulty = linkfault.active(topo_full, cfg, train=True)

    def plan(round_key, batch_size):
        if not faulty:
            return "clean", None
        if round_key is None:
            raise ValueError(missing_key)
        return "masked", linkfault.round_delivery_mask(
            round_key, topo_full, cfg, batch_size, train=True)
    return plan


class Scheme:
    """Base class: override `init`, `make_round_parts` (or `make_round`),
    `predict` and the bandwidth ledgers."""

    name: str = ""

    def batches_per_round(self, cfg) -> int:
        """Minibatches one round consumes (the runner stacks this many)."""
        return 1

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None) -> Any:
        """Build parameters and optimizer state for `cfg`
        (PaperExperimentConfig) on `device` (None: cuda), deterministic in
        `generator`; `lr` must match `make_round`'s."""
        raise NotImplementedError

    def make_round_parts(self, cfg, *, lr: float = 2e-3,
                         wire: str = "dense", topology=None) -> RoundParts:
        """The round's host part and device part (`RoundParts`)."""
        raise NotImplementedError

    def make_round(self, cfg, *, lr: float = 2e-3, wire: str = "dense",
                   topology=None):
        """Return round_fn(state, views, labels, generator, *, eps=None,
        drop_masks=None, round_key=None) -> (new_state, metrics) with
        views (R, J, B, H, W, C), labels (R, B), R ==
        batches_per_round(cfg).  The round draws its randomness from
        `generator` unless it is given, and over unreliable links its fault
        draws from `round_key`; metrics include "loss".  Runs the host part
        of `make_round_parts`, then its device part."""
        plan, step = self.make_round_parts(cfg, lr=lr, wire=wire,
                                           topology=topology)

        def round_fn(state, views, labels, generator, *, round_key=None,
                     **kw):
            # the host part first: a lossy round without its key raises
            # before any tensor is read
            sig, mask = plan(round_key,
                             None if labels is None else labels.shape[-1])
            if mask is not None:
                mask = linkfault.mask_tensor(mask, labels.device)
            return step(state, views, labels, generator, sig, mask, **kw)
        return round_fn

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
        """K rounds in one call: epoch_fn(state, views, labels, generator,
        round_keys=None) -> (state, metrics) with views (K, R, J, B, ...),
        labels (K, R, B), round_keys the K rounds' fault keys (over
        unreliable links) and metrics stacked (K,).

        The reference runs the K rounds as one jitted lax.scan, which
        traces the round once.  On the CPU this is a Python loop over
        the round, drawing from `generator` round after round exactly as
        K `make_round` calls would.  On the card the device part of the
        round is a CUDA graph, one per host signature, replayed once a
        round with no host synchronisation between replays: the epoch's
        host parts (fault draws, decisions) run first, then each round
        copies its minibatch and mask into the graph's static buffers and
        replays.  The first round of a signature runs eagerly on a side
        stream (the warm-up, and the round itself) and is then captured.
        The state lives in static buffers that the graph updates in place
        (the state returned is those buffers), so every replay reads the
        previous round's result.  `epoch_fn.captures` counts the captures
        per signature; each signature is captured once for the
        epoch_fn's lifetime.  Either way the trajectory equals K
        `make_round` calls bit for bit (where the card's algorithms are
        deterministic)."""
        if mesh is not None:
            raise NotImplementedError("mesh execution comes with the "
                                      "sharded slice of the port")
        plan, step = self.make_round_parts(cfg, lr=lr, wire=wire,
                                           topology=topology)
        graphed = _GraphedRounds(plan, step)

        def epoch_fn(state, views, labels, generator, round_keys=None):
            if views.device.type == "cuda":
                return graphed.epoch(state, views, labels, generator,
                                     round_keys)
            per_round = []
            for k in range(views.shape[0]):
                sig, mask = plan(None if round_keys is None
                                 else round_keys[k], labels.shape[-1])
                if mask is not None:
                    mask = linkfault.mask_tensor(mask, labels.device)
                state, metrics = step(state, views[k], labels[k],
                                      generator, sig, mask)
                per_round.append(metrics)
            return state, _stack_metrics(per_round)
        epoch_fn.captures = graphed.graphs.captures
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
        # on the device: a captured predict reads its mask there
        ok = torch.all(linkfault.mask_tensor(delivery, probs.device), dim=0)
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


def _stack_metrics(per_round) -> dict:
    return {key: torch.stack([m[key] for m in per_round])
            for key in (per_round[0] if per_round else {})}


class _GraphedRounds:
    """The card's epoch loop of `Scheme.make_epoch`: the device part of the
    round captured once per host signature (repro_torch/graphs.py) and
    replayed over the static state buffers, which persist from one epoch
    to the next."""

    def __init__(self, plan, step):
        self.plan, self.step = plan, step
        self.graphs = graphs.GraphCache()
        self._state = None        # the static state buffers
        self._views = self._labels = None
        self._masks: Dict[Any, torch.Tensor] = {}
        self._generator = None

    def _bind(self, state) -> None:
        """Make `state` the static buffers' content."""
        if state is self._state:
            return
        if self._state is None:
            self._state = tree_map(torch.clone, state)
            return
        src, dst = tree_leaves(state), tree_leaves(self._state)
        if [(t.shape, t.dtype) for t in src] != \
                [(t.shape, t.dtype) for t in dst]:
            raise ValueError("epoch_fn's graphs were captured for another "
                             "state structure; make a new epoch_fn")
        torch._foreach_copy_(dst, src)

    def epoch(self, state, views, labels, generator, round_keys):
        if self._generator is None:
            self._generator = generator
        elif generator is not self._generator:
            raise ValueError("epoch_fn's graphs draw from the generator "
                             "they were captured with; pass that one")
        K = views.shape[0]
        self._bind(state)
        plans = [self.plan(None if round_keys is None else round_keys[k],
                           labels.shape[-1]) for k in range(K)]
        # every mask of the epoch reaches the device in one copy
        masked = [k for k, (_, m) in enumerate(plans) if m is not None]
        dev_masks = {}
        if masked:
            stacked = linkfault.mask_tensor(
                np.stack([plans[k][1] for k in masked]), views.device)
            dev_masks = dict(zip(masked, stacked))
        stacked_metrics = None
        for k in range(K):
            sig = plans[k][0]
            graph = self.graphs.get(sig)
            if graph is None:
                metrics = self._first_round(sig, views[k], labels[k],
                                            dev_masks.get(k))
            else:
                self._views.copy_(views[k])
                self._labels.copy_(labels[k])
                if k in dev_masks:
                    self._masks[sig].copy_(dev_masks[k])
                metrics = graph.replay()
            if stacked_metrics is None:
                stacked_metrics = {key: torch.empty((K,) + m.shape,
                                                    dtype=m.dtype,
                                                    device=m.device)
                                   for key, m in metrics.items()}
            torch._foreach_copy_([stacked_metrics[key][k] for key in metrics],
                                 list(metrics.values()))
        return self._state, (stacked_metrics or {})

    def _first_round(self, sig, views, labels, mask):
        """The round eagerly on a side stream (into the static state
        buffers), then its device part captured for `sig`."""
        new, metrics = graphs.warm_up(self.step, self._state, views, labels,
                                      self._generator, sig, mask)
        torch._foreach_copy_(tree_leaves(self._state), tree_leaves(new))
        if self._views is None:
            self._views = torch.empty_like(views)
            self._labels = torch.empty_like(labels)
        if mask is not None and sig not in self._masks:
            self._masks[sig] = torch.empty_like(mask)
        smask = None if mask is None else self._masks[sig]
        buffers = (self._state, self._views, self._labels, smask)

        def device_part():
            out, m = self.step(self._state, self._views, self._labels,
                               self._generator, sig, smask)
            dst, src = tree_leaves(self._state), tree_leaves(out)
            moved = [(d, s) for d, s in zip(dst, src) if d is not s]
            if moved:
                torch._foreach_copy_([d for d, _ in moved],
                                     [s for _, s in moved])
            return m
        self.graphs.capture(sig, device_part, generators=(self._generator,),
                            keep=buffers)
        return metrics


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
