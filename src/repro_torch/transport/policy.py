"""Per-edge delivery policies: bounded retries and circuit breaking.

Reference: src/repro/transport/policy.py.

A `Channel` (transport/channel.py) moves bytes; these policies decide how
hard an edge TRIES.  Both are deliberately tiny state machines so the chaos
harness (repro_torch/chaos.py) can assert their transitions exactly:

    RetryPolicy     how many attempts one payload gets, the per-attempt
                    timeout, and the exponential-backoff-with-jitter delay
                    between attempts.  The jitter draw is an INPUT (a
                    uniform in [0, 1) from the transport's seeded stream),
                    so a schedule replays bit-identically.

    CircuitBreaker  classic three-state breaker per edge: CLOSED counts
                    consecutive failures and OPENs at `failure_threshold`;
                    OPEN short-circuits every transmission (nothing is
                    offered to a link that is known-dead — the wasted-bits
                    bound BENCH_chaos.json asserts) until `cooldown` ticks
                    elapsed; then ONE half-open probe rides the link — its
                    success CLOSEs the breaker, its failure re-OPENs it and
                    restarts the cooldown.

Time is counted in TICKS — one tick per transmission opportunity (a
training round, or a request id at serving time) — not wall-clock, so
breaker trajectories are pure functions of the outcome sequence and the
deterministic chaos schedules stay deterministic end to end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    max_attempts     total tries per payload (1 = no retry — the legacy
                     one-shot semantics linkfault's inline masks model)
    base_backoff_ms  delay before the 2nd attempt
    backoff_mult     exponential growth per further attempt
    max_backoff_ms   backoff ceiling
    jitter           fraction of the backoff randomised away (0 = none;
                     0.5 = delay uniform in [0.5, 1.0] x backoff)
    timeout_ms       per-attempt timeout: an attempt whose link latency
                     draw exceeds it counts as FAILED (and is retried) even
                     if the payload would eventually have arrived.  None
                     disables the timeout.
    """
    max_attempts: int = 1
    base_backoff_ms: float = 1.0
    backoff_mult: float = 2.0
    max_backoff_ms: float = 64.0
    jitter: float = 0.5
    timeout_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.base_backoff_ms < 0 or self.max_backoff_ms < 0:
            raise ValueError("backoff delays must be >= 0")

    def backoff_ms(self, attempt: int, u: float = 0.0) -> float:
        """Delay BEFORE attempt `attempt` (0-based; attempt 0 never waits).
        `u` is a uniform [0, 1) jitter draw from the caller's seeded stream
        — the same (attempt, u) pair always yields the same delay."""
        if attempt <= 0:
            return 0.0
        raw = min(self.base_backoff_ms * self.backoff_mult ** (attempt - 1),
                  self.max_backoff_ms)
        return raw * (1.0 - self.jitter * float(u))

    def attempt_failed(self, latency_ms: float) -> bool:
        """Whether a surviving transmission still MISSED its per-attempt
        timeout (counted as a failure and retried)."""
        return self.timeout_ms is not None and latency_ms > self.timeout_ms


#: the legacy semantics: one shot, no timeout — linkfault's inline masks
NO_RETRY = RetryPolicy(max_attempts=1)
#: a sane default for retrying transports
DEFAULT_RETRY = RetryPolicy(max_attempts=3)


class CircuitBreaker:
    """Per-edge three-state breaker over tick time.

    CLOSED    transmissions flow; `failure_threshold` CONSECUTIVE failures
              trip the breaker OPEN (a success resets the count).
    OPEN      `allow` short-circuits (False) — the edge is not even
              offered traffic — until `cooldown` ticks after the trip.
    HALF_OPEN the first `allow` after the cooldown admits one probe:
              `record_success` CLOSEs the breaker, `record_failure`
              re-OPENs it and restarts the cooldown from that tick.

    Counters (`opens`, `short_circuits`, `probes`) feed the chaos bench's
    wasted-bandwidth accounting.  Not thread-safe by itself — the owning
    NetworkTransport serialises access.
    """

    def __init__(self, failure_threshold: int = 3, cooldown: int = 4):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got "
                             f"{failure_threshold}")
        if cooldown < 1:
            raise ValueError(f"cooldown must be >= 1 tick, got {cooldown}")
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at_tick: Optional[int] = None
        self.opens = 0
        self.short_circuits = 0
        self.probes = 0

    def allow(self, tick: int) -> bool:
        """May a transmission ride the edge at `tick`?  OPEN short-circuits
        until the cooldown elapses, then admits a half-open probe."""
        if self.state == OPEN:
            if tick - self.opened_at_tick >= self.cooldown:
                self.state = HALF_OPEN
                self.probes += 1
                return True
            self.short_circuits += 1
            return False
        if self.state == HALF_OPEN:
            # one probe is already in flight this tick sequence; further
            # traffic keeps short-circuiting until its verdict lands
            self.short_circuits += 1
            return False
        return True

    def record_success(self) -> None:
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at_tick = None

    def record_failure(self, tick: int) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or \
                self.consecutive_failures >= self.failure_threshold:
            if self.state != OPEN:
                self.opens += 1
            self.state = OPEN
            self.opened_at_tick = tick


class NoBreaker:
    """The null object: every transmission allowed (the no-breaker baseline
    the chaos bench compares wasted offered bits against)."""

    state = "disabled"
    opens = 0
    short_circuits = 0
    probes = 0

    def allow(self, tick: int) -> bool:
        return True

    def record_success(self) -> None:
        pass

    def record_failure(self, tick: int) -> None:
        pass
