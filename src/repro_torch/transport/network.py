"""Fault-tolerant edge transport over a topology: retries, breakers, chaos.

Reference: src/repro/transport/network.py.

`core/linkfault.py` models unreliable links as INLINE MASKS — pure draws
consumed by the round and predict paths.  This module moves the
same `LinkModel` outcomes down to an actual TRANSPORT: every topology edge
gets a `Channel` (loopback or a real socket), a `RetryPolicy` (bounded
attempts, exponential backoff with seeded jitter, per-attempt timeout) and
a `CircuitBreaker` (open after K consecutive failures, half-open probe,
close on success).  A payload now either ARRIVES — possibly after retries
that cost offered bandwidth and latency — or is LOST because its link
erased every attempt, its route's breaker short-circuited, or a chaos
schedule killed the sending node.

Determinism: every fault draw is a pure function of
(seed, domain, tick, edge index, attempt) through a counter-seeded
`np.random.default_rng`, where tick = the training round index or the
serving request id.  Replaying the same schedule replays the same
outcomes, breaker transitions included — the property the deterministic
chaos harness (repro_torch/chaos.py) is built on.
These draws are the transport's OWN stream: they model the same LinkModel
parameters as linkfault's counter-hash draws but are not bit-coupled to them (the
inline-mask paths and their golden trajectories are untouched).

Ledger convention (BandwidthMeter): every attempt that actually rides a
link offers its full payload charge (retries RE-OFFER — that is their
cost); short-circuited attempts offer NOTHING (that is the breaker's
saving).  Delivered credit accrues when the consumer uses the payload:
rounds credit inside `round_outcome`, the serving engine credits per
completed fusion via `credit_delivered` (so speculative patching can
credit a straggler that was eventually fused).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import bandwidth
from repro_torch.core import topology as topology_lib
from repro_torch.transport import channel as channel_lib
from repro_torch.transport.policy import (CircuitBreaker, NoBreaker,
                                          RetryPolicy, DEFAULT_RETRY,
                                          NO_RETRY)

# draw domains: disjoint streams for training rounds vs serving requests
DOMAIN_ROUND = 0
DOMAIN_REQUEST = 1

_PROBE = b"\x00INLPROBE"          # tiny frame for payload-less transmissions


def _edge_tx_ms(link, payload_bits: float) -> float:
    if link is None or link.bandwidth_bps is None:
        return 0.0
    return 1e3 * payload_bits / link.bandwidth_bps


@dataclass
class EdgeResult:
    """One payload's fate on one edge."""
    ok: bool                      # delivered within the attempt budget
    latency_ms: float             # cumulative: failed attempts + backoff +
                                  # the delivering attempt's latency
    attempts: int = 0             # attempts that actually rode the link
    short_circuited: bool = False  # breaker refused every attempt


class EdgeTransport:
    """One edge's channel + policy + breaker + fault model."""

    def __init__(self, edge, index: int, *, seed: int, policy: RetryPolicy,
                 breaker, chan: channel_lib.Channel, chaos=None):
        self.edge = edge
        self.index = index
        self.seed = seed
        self.policy = policy
        self.breaker = breaker if breaker is not None else NoBreaker()
        self.channel = chan
        self.chaos = chaos

    def _draws(self, domain: int, tick: int, attempt: int):
        rng = np.random.default_rng(
            (self.seed, domain, tick, self.index, attempt))
        return rng.random(), rng.exponential(), rng.random()

    def transmit(self, domain: int, tick: int, payload_bits: float,
                 frame: Optional[bytes] = None) -> EdgeResult:
        """Try to move one payload over this edge at `tick`.

        Walks the retry budget: each attempt consults the breaker (an OPEN
        breaker short-circuits the attempt — nothing offered), then draws
        erasure/latency from the edge's LinkModel under the chaos
        schedule's overrides (a down edge fails deterministically; a slow
        window multiplies latency).  The delivering attempt sends `frame`
        (or a probe) through the channel and pulls it across, so bytes
        genuinely traverse the transport.  Returns the EdgeResult; the
        caller owns ledger charges (it knows the bits basis)."""
        link = self.edge.link
        chaos = self.chaos
        t_ms = 0.0
        attempts_used = 0
        refused = 0
        for attempt in range(self.policy.max_attempts):
            u_erase, exp_lat, u_jit = self._draws(domain, tick, attempt)
            t_ms += self.policy.backoff_ms(attempt, u_jit)
            if not self.breaker.allow(tick):
                refused += 1
                continue
            attempts_used += 1
            down = chaos is not None and chaos.edge_down(self.edge.key, tick)
            slow = chaos.slow_factor(self.edge.key, tick) if chaos is not None \
                else 1.0
            erased = down
            lat = 0.0
            if link is not None:
                erased = erased or (link.erasure > 0
                                    and u_erase < link.erasure)
                lat = link.latency_ms + link.jitter_ms * exp_lat
            lat = lat * slow + _edge_tx_ms(link, payload_bits)
            if erased:
                # loss is detected after the timeout (or one latency's
                # worth of silence when no timeout is configured)
                t_ms += self.policy.timeout_ms if self.policy.timeout_ms \
                    is not None else max(lat, 1.0)
                self.breaker.record_failure(tick)
                continue
            if self.policy.attempt_failed(lat):
                t_ms += self.policy.timeout_ms
                self.breaker.record_failure(tick)
                continue
            # delivered: the frame rides the channel end to end.  A channel
            # that fails underneath us (torn frame, dead worker process)
            # is just another failed attempt — typed, not fatal.
            try:
                self.channel.send(frame if frame is not None else _PROBE)
            except channel_lib.ChannelError:
                t_ms += self.policy.timeout_ms if self.policy.timeout_ms \
                    is not None else max(lat, 1.0)
                self.breaker.record_failure(tick)
                continue
            self.breaker.record_success()
            return EdgeResult(ok=True, latency_ms=t_ms + lat,
                              attempts=attempts_used)
        return EdgeResult(ok=False, latency_ms=t_ms, attempts=attempts_used,
                          short_circuited=refused == self.policy.max_attempts)

    def receive(self, timeout: float = 5.0) -> Optional[bytes]:
        try:
            return self.channel.recv(timeout)
        except channel_lib.ChannelError:
            return None                          # abrupt close == lost payload


@dataclass
class RequestReport:
    """One request's transport outcome: which views made the fusion
    deadline (`on_time`), which would still arrive late (`eventual` minus
    `on_time` — the stragglers speculative fusion patches in), and which
    are gone (erased every attempt / short-circuited / dead node)."""
    rid: int
    on_time: np.ndarray           # (J,) bool
    eventual: np.ndarray          # (J,) bool, superset of on_time
    latency_ms: np.ndarray        # (J,) float; inf when lost
    received: Optional[List[Optional[np.ndarray]]] = None
    attempts: Dict[str, int] = field(default_factory=dict)

    @property
    def stragglers(self) -> np.ndarray:
        return self.eventual & ~self.on_time


@dataclass
class RoundReport:
    """One training round's transport outcome."""
    tick: int
    mask: np.ndarray              # (J,) bool: views fused this round
    latency_ms: np.ndarray        # (J,) float
    attempts: Dict[str, int] = field(default_factory=dict)


class NetworkTransport:
    """The per-topology transport: one `EdgeTransport` per edge.

    topo/cfg        a RESOLVED core/topology.Topology and the experiment
                    config (payload widths, deadline default).
    seed            the fault-draw stream (disjoint per domain/tick/edge).
    policy          RetryPolicy for every edge, or {edge_key: policy}.
    breaker         None (no breaking), "default" (CircuitBreaker() per
                    edge), or a factory ``lambda: CircuitBreaker(...)``.
    chaos           a repro_torch/chaos.ChaosSchedule (or None).
    channels        "loopback" | "socket" — the byte transport per edge —
                    or a mapping {edge_key: Channel} supplying ready-made
                    channels (how `repro_torch/cluster` routes edges whose
                    source is a supervised worker PROCESS through its TCP
                    connection; unmapped edges fall back to loopback).
    meter           BandwidthMeter accruing offered/delivered; owns one
                    when not given.
    adaptive        an AdaptivePolicy retuning per-edge retry budgets and
                    breaker thresholds each window from delivered/offered
                    (None keeps the fixed constants).
    on_tick         callable(tick) invoked at the top of every
                    round_outcome/send_request BEFORE any fault draw — the
                    cluster supervisor's hook to realise scheduled
                    kills/freezes and heartbeat at deterministic points.
    node_down       callable(name, tick) -> bool consulted alongside the
                    chaos schedule — the membership view's hook, so an
                    unscheduled worker death masks exactly the votes that
                    worker owned.

    Thread-safe: the serving engine submits from arbitrary threads; breaker
    state and ledger charges are serialised under one lock.
    """

    def __init__(self, topo, cfg, *, seed: int = 0,
                 policy: RetryPolicy = DEFAULT_RETRY, breaker="default",
                 chaos=None, channels="loopback", meter=None,
                 adaptive=None, on_tick=None, node_down=None):
        self.topo = topology_lib.resolve(topo, cfg)
        self.cfg = cfg
        self.seed = seed
        self.chaos = chaos
        self.meter = bandwidth.BandwidthMeter() if meter is None else meter
        self.adaptive = adaptive
        self.on_tick = on_tick
        self.node_down = node_down
        self._lock = threading.Lock()
        if breaker == "default":
            breaker = CircuitBreaker
        self.edges: Dict[str, EdgeTransport] = {}
        for i, e in enumerate(self.topo.edges):
            pol = policy.get(e.key, NO_RETRY) if isinstance(policy, dict) \
                else policy
            if isinstance(channels, str):
                chan = channel_lib.make_channel(channels)
            else:
                chan = channels.get(e.key) or channel_lib.LoopbackChannel()
            self.edges[e.key] = EdgeTransport(
                e, i, seed=seed, policy=pol,
                breaker=breaker() if callable(breaker) else None,
                chan=chan, chaos=chaos)
        # static per-(view, edge) unit charges for serving requests
        self._unit_bits = {e.key: float(cfg.d_bottleneck
                                        * topology_lib.edge_bits(e, cfg))
                           for e in self.topo.edges}
        self._routes = {name: self._route(name)
                        for name in self.topo.view_nodes()}

    # -- helpers -----------------------------------------------------------

    def _route(self, name: str):
        out, cur = [], name
        while cur != self.topo.fuse_node:
            e = self.topo.out_edge(cur)
            out.append(e)
            cur = e.dst
        return out

    def _node_dead(self, name: str, tick: int) -> bool:
        if self.chaos is not None and self.chaos.node_dead(name, tick):
            return True
        return self.node_down is not None and self.node_down(name, tick)

    def _apply_adaptive(self) -> None:
        """Install the controller's current knobs on every edge (called at
        the top of each tick, before any transmit — so a retune triggered
        by tick t's observations first applies at tick t+1)."""
        for et in self.edges.values():
            et.policy = self.adaptive.policy_for(et.edge.key)
            if hasattr(et.breaker, "failure_threshold"):
                et.breaker.failure_threshold = \
                    self.adaptive.threshold_for(et.edge.key)

    def breaker_states(self) -> Dict[str, str]:
        return {k: et.breaker.state for k, et in self.edges.items()}

    def snapshot(self) -> Dict[str, object]:
        """Ledger + breaker counters (the chaos bench's record)."""
        return {
            "offered_bits": self.meter.total_bits,
            "delivered_bits": self.meter.delivered_bits,
            "delivery_ratio": self.meter.delivery_ratio,
            "breaker": {k: {"state": et.breaker.state,
                            "opens": et.breaker.opens,
                            "short_circuits": et.breaker.short_circuits}
                        for k, et in self.edges.items()},
            **({"adaptive": self.adaptive.state_dict()}
               if self.adaptive is not None else {}),
        }

    def load_snapshot(self, snap: Dict[str, object]) -> None:
        """Restore the REPLAYABLE half of a `snapshot()` — the adaptive
        controller's window accumulators and retuned knobs.  Breaker/ledger
        counters are NOT loaded here: resume rebuilds breakers by replaying
        completed ticks with ``charge=False`` and restores ledgers from the
        checkpoint sidecar's meter dump, so loading them twice would
        double-count.  Loading adaptive state after that replay is
        idempotent (the replay reproduces the same trajectory) but makes
        the sidecar authoritative."""
        state = snap.get("adaptive") if isinstance(snap, dict) else None
        if self.adaptive is None or state is None:
            return
        with self._lock:
            self.adaptive.load_state_dict(state)
            self._apply_adaptive()

    def close(self) -> None:
        for et in self.edges.values():
            et.channel.close()

    # -- serving: one request ---------------------------------------------

    def send_request(self, rid: int, views=None,
                     deadline_ms: Optional[float] = None) -> RequestReport:
        """Route one request's J view fragments to the fusion center.

        Each view's fragment traverses its route's channels hop by hop
        (store-and-forward); every hop runs the edge's retry/breaker
        machinery against its LinkModel + chaos window at tick=rid.  A view
        is `on_time` when every hop delivered and the cumulative simulated
        latency met the deadline (engine deadline, else
        cfg.fusion_deadline_ms, else no deadline); delivered-but-late views
        are the stragglers speculative fusion patches into the next bucket.
        Offered bits are charged per attempt; delivered credit is the
        ENGINE's call (`credit_delivered`) once a fusion consumed the
        views."""
        if self.on_tick is not None:
            self.on_tick(rid)
        if deadline_ms is None:
            deadline_ms = getattr(self.cfg, "fusion_deadline_ms", None)
        names = self.topo.view_nodes()
        J = len(names)
        on_time = np.zeros(J, bool)
        eventual = np.zeros(J, bool)
        lat = np.full(J, np.inf, np.float64)
        received: List[Optional[np.ndarray]] = [None] * J
        attempts: Dict[str, int] = {}
        with self._lock:
            if self.adaptive is not None:
                self._apply_adaptive()
            for j, name in enumerate(names):
                if self._node_dead(name, rid):
                    continue                      # a dead node sends nothing
                frame = None
                if views is not None:
                    frame = channel_lib.encode_fragment(
                        rid, j, np.asarray(views[j]))
                t = 0.0
                delivered = True
                for e in self._routes[name]:
                    et = self.edges[e.key]
                    if self._node_dead(e.src, rid):
                        delivered = False
                        break
                    res = et.transmit(DOMAIN_REQUEST, rid,
                                      self._unit_bits[e.key], frame)
                    attempts[e.key] = attempts.get(e.key, 0) + res.attempts
                    self.meter.add_edge(
                        e.key, bits=res.attempts * self._unit_bits[e.key])
                    t += res.latency_ms
                    got = et.receive() if res.ok else None
                    hop_ok = res.ok and got is not None
                    if self.adaptive is not None:
                        self.adaptive.observe(e.key, offered=res.attempts,
                                              delivered=float(hop_ok))
                    if not hop_ok:
                        delivered = False
                        break
                    frame = got if frame is not None else None
                if not delivered:
                    continue
                eventual[j] = True
                lat[j] = t
                on_time[j] = deadline_ms is None or t <= deadline_ms
                if frame is not None:
                    _, jj, arr = channel_lib.decode_fragment(frame)
                    assert jj == j
                    received[j] = arr
        return RequestReport(rid=rid, on_time=on_time, eventual=eventual,
                             latency_ms=lat,
                             received=received if views is not None else None,
                             attempts=attempts)

    def credit_delivered(self, mask: np.ndarray) -> None:
        """Credit one completed fusion's consumed views on the delivered
        ledger: each edge earns its unit charge per payload view the fusion
        actually used (speculative patching credits stragglers here when
        their patched fusion lands)."""
        mask = np.asarray(mask, bool)
        with self._lock:
            for e in self.topo.edges:
                pay = list(self.topo.payload(e))
                n = int(mask[pay].sum())
                if n:
                    self.meter.add_delivered(
                        bits=n * self._unit_bits[e.key], edge=e.key)

    # -- training: one round ----------------------------------------------

    def round_outcome(self, round_idx: int, batch_size: int,
                      charges: Optional[Dict] = None,
                      charge: bool = True) -> RoundReport:
        """One training round's transport outcome at tick=round_idx.

        Each edge carries its round payload once (the whole batch's latent
        block, both directions — the same per-edge basis the runner's
        static `charges` use); retries/breaker/chaos apply per edge.  The
        (J,) mask composes routes exactly like the inline-mask path:
        a view fuses iff every hop delivered (dead nodes fail their own
        subtree) and its cumulative latency met cfg.fusion_deadline_ms.
        Offered/delivered are charged here (per attempt / per surviving
        payload fraction — `linkfault.round_fault_charges` convention with
        the retry multiplier on the offered side).  `charge=False` replays
        the round WITHOUT touching the ledgers — how a resumed run
        fast-forwards the transport (breaker trajectories included)
        through rounds a checkpoint already accounted for."""
        if self.on_tick is not None:
            self.on_tick(round_idx)
        topo, cfg = self.topo, self.cfg
        if charges is None:
            bits = topology_lib.round_edge_bits(topo, cfg, batch_size)
            charges = {k: (b, b / 8.0) for k, b in bits.items()}
        deadline = getattr(cfg, "fusion_deadline_ms", None)
        results: Dict[str, EdgeResult] = {}
        attempts: Dict[str, int] = {}
        with self._lock:
            if self.adaptive is not None:
                self._apply_adaptive()
            for e in topo.edges:
                et = self.edges[e.key]
                ebits, _ = charges[e.key]
                if self._node_dead(e.src, round_idx):
                    results[e.key] = EdgeResult(ok=False, latency_ms=0.0)
                    attempts[e.key] = 0
                    continue
                res = et.transmit(DOMAIN_ROUND, round_idx, ebits)
                if res.ok and et.receive() is None:
                    res = EdgeResult(ok=False, latency_ms=res.latency_ms,
                                     attempts=res.attempts)
                results[e.key] = res
                attempts[e.key] = res.attempts
            names = topo.view_nodes()
            J = len(names)
            mask = np.zeros(J, bool)
            lat = np.full(J, np.inf, np.float64)
            for j, name in enumerate(names):
                if self._node_dead(name, round_idx):
                    continue
                t, ok = 0.0, True
                for e in self._routes[name]:
                    res = results[e.key]
                    if not res.ok:
                        ok = False
                        break
                    t += res.latency_ms
                if ok:
                    lat[j] = t
                    mask[j] = deadline is None or t <= deadline
            # per-edge surviving payload fraction: the delivered basis for
            # both the ledger credit and the adaptive controller
            fracs = {}
            for e in topo.edges:
                pay = list(topo.payload(e))
                fracs[e.key] = float(mask[pay].sum()) / len(pay)
            # the controller observes every round — charged or not — so an
            # uncharged resume replay rebuilds the same knob trajectory
            if self.adaptive is not None:
                for e in topo.edges:
                    self.adaptive.observe(e.key, offered=attempts[e.key],
                                          delivered=fracs[e.key])
            # ledgers: attempts re-offer the edge's nominal charge; the
            # delivered credit is the surviving payload fraction
            if charge:
                for e in topo.edges:
                    ebits, enbytes = charges[e.key]
                    a = attempts[e.key]
                    self.meter.add_edge(e.key, bits=a * ebits,
                                        nbytes=a * enbytes)
                    frac = fracs[e.key]
                    if frac:
                        self.meter.add_delivered(bits=ebits * frac,
                                                 nbytes=enbytes * frac,
                                                 edge=e.key)
        return RoundReport(tick=round_idx, mask=mask, latency_ms=lat,
                           attempts=attempts)
