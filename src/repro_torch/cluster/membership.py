"""Elastic membership as PURE state machines: no processes, no sockets,
no wall clock.

Reference: src/repro/cluster/membership.py.

The `Supervisor` owns real subprocesses, but every supervision DECISION —
when to probe, when a silent node becomes suspect, when suspect becomes
dead, when a dead node's restart is due, how the backoff escalates — lives
here as a function of (tick, observation), so the whole
miss-threshold -> suspect -> dead -> restart-backoff -> rejoin ladder is
unit-testable without spawning anything, and two supervisors fed the same
observation sequence publish the same membership views.

Heartbeat cadence is SEEDED per node: each node probes every `interval`
ticks at a phase drawn from a counter-seeded rng, so probes spread across
ticks instead of thundering together, yet replay identically for a given
seed.

Standard library + numpy only (worker processes never import this, but
the monitor must not drag torch into the supervisor's hot path either)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

UP = "up"
SUSPECT = "suspect"          # missed probes, still counted until dead
DOWN = "down"


@dataclass
class NodeHealth:
    """One node's supervision record (mutable; owned by the monitor)."""
    name: str
    status: str = DOWN                  # nodes join by announcing themselves
    incarnation: int = 0                # bumped on every (re)join
    misses: int = 0                     # consecutive failed probes
    restarts: int = 0
    backoff_level: int = 0
    restart_due: Optional[int] = None   # tick a restart becomes allowed
    down_since: Optional[int] = None
    up_since: Optional[int] = None


@dataclass(frozen=True)
class MembershipView:
    """An immutable snapshot the transport masks read from."""
    version: int
    status: Tuple[Tuple[str, str], ...]          # (name, UP/SUSPECT/DOWN)
    incarnations: Tuple[Tuple[str, int], ...]

    def is_down(self, name: str) -> bool:
        return dict(self.status).get(name, DOWN) == DOWN

    def mask(self, names: Sequence[str]) -> np.ndarray:
        """(J,) bool: which of `names` may vote (UP or SUSPECT — a suspect
        node keeps its vote until declared dead, exactly like the paper's
        partial-fusion semantics keep a slow link's vote until it misses
        the deadline)."""
        st = dict(self.status)
        return np.array([st.get(n, DOWN) != DOWN for n in names], bool)


class HeartbeatMonitor:
    """The supervision ladder for a fixed node set.

    interval / seed    probe cadence: node n is probed at ticks where
                       (tick - phase_n) % interval == 0, phase_n seeded.
    suspect_after      consecutive misses before UP -> SUSPECT.
    dead_after         consecutive misses before -> DOWN (>= suspect_after).
    backoff_base/_mult/_cap
                       restart delay in TICKS after an unscheduled death:
                       min(base * mult**level, cap), level escalating per
                       death and resetting once the node stays up
                       `stable_after` ticks.
    """

    def __init__(self, nodes: Sequence[str], *, seed: int = 0,
                 interval: int = 1, suspect_after: int = 1,
                 dead_after: int = 2, backoff_base: int = 1,
                 backoff_mult: int = 2, backoff_cap: int = 8,
                 stable_after: int = 4):
        if dead_after < suspect_after:
            raise ValueError("dead_after must be >= suspect_after")
        self.interval = int(interval)
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.backoff_base = int(backoff_base)
        self.backoff_mult = int(backoff_mult)
        self.backoff_cap = int(backoff_cap)
        self.stable_after = int(stable_after)
        self.nodes: Dict[str, NodeHealth] = {
            n: NodeHealth(name=n) for n in nodes}
        self._phase = {
            n: int(np.random.default_rng((seed, i)).integers(self.interval))
            for i, n in enumerate(nodes)}
        self.version = 0
        self.events: list = []          # (tick, node, transition) audit trail

    # -- probe cadence ------------------------------------------------------

    def beat_due(self, name: str, tick: int) -> bool:
        return (tick - self._phase[name]) % self.interval == 0

    # -- observations -------------------------------------------------------

    def _transition(self, h: NodeHealth, status: str, tick: int) -> None:
        if h.status == status:
            return
        self.events.append((tick, h.name, f"{h.status}->{status}"))
        h.status = status
        self.version += 1

    def observe(self, name: str, tick: int, ok: bool) -> None:
        """One probe result.  A pong clears the miss count (and rejoins a
        node that was declared dead while merely frozen — same
        incarnation, it never restarted); silence walks the ladder."""
        h = self.nodes[name]
        if ok:
            h.misses = 0
            if h.status != UP:
                if h.status == DOWN:
                    h.restart_due = None       # it answered: not dead
                    h.down_since = None
                    h.up_since = tick
                self._transition(h, UP, tick)
            self._maybe_stabilise(h, tick)
            return
        h.misses += 1
        if h.status == UP and h.misses >= self.suspect_after:
            self._transition(h, SUSPECT, tick)
        if h.status == SUSPECT and h.misses >= self.dead_after:
            self._mark_down(h, tick)

    def note_exit(self, name: str, tick: int,
                  scheduled: bool = False) -> None:
        """The worker PROCESS is gone (waitpid said so).  Scheduled exits
        (a chaos kill window) restart as soon as the window allows — the
        schedule owns the timing; unscheduled exits pay the capped
        exponential backoff, escalating on a crash loop."""
        h = self.nodes[name]
        if h.status != DOWN:
            self._mark_down(h, tick)
        if scheduled:
            h.restart_due = tick
        elif h.restart_due is None:
            delay = min(self.backoff_base
                        * self.backoff_mult ** h.backoff_level,
                        self.backoff_cap)
            h.restart_due = tick + delay
            h.backoff_level += 1

    def _mark_down(self, h: NodeHealth, tick: int) -> None:
        h.down_since = tick
        h.up_since = None
        self._transition(h, DOWN, tick)

    def due_restart(self, name: str, tick: int) -> bool:
        h = self.nodes[name]
        return (h.status == DOWN and h.restart_due is not None
                and tick >= h.restart_due)

    def note_joined(self, name: str, tick: int) -> None:
        """A (re)spawned worker completed its handshake."""
        h = self.nodes[name]
        h.incarnation += 1
        h.restarts += 1 if h.incarnation > 1 else 0
        h.misses = 0
        h.restart_due = None
        h.down_since = None
        h.up_since = tick
        self._transition(h, UP, tick)

    def _maybe_stabilise(self, h: NodeHealth, tick: int) -> None:
        if (h.backoff_level and h.up_since is not None
                and tick - h.up_since >= self.stable_after):
            h.backoff_level = 0

    def tick_stability(self, tick: int) -> None:
        """Decay restart backoff for nodes that have stayed up."""
        for h in self.nodes.values():
            if h.status == UP:
                self._maybe_stabilise(h, tick)

    # -- snapshots ----------------------------------------------------------

    def view(self) -> MembershipView:
        return MembershipView(
            version=self.version,
            status=tuple((n, h.status) for n, h in self.nodes.items()),
            incarnations=tuple((n, h.incarnation)
                               for n, h in self.nodes.items()))

    def is_down(self, name: str) -> bool:
        h = self.nodes.get(name)
        return h is None or h.status == DOWN
