"""Adaptive fault policies: retune retry budgets and breaker thresholds
from the measured delivered/offered ratio instead of fixed constants.

Reference: src/repro/transport/adaptive.py.

The controller is deliberately boring: per edge it accumulates a WINDOW of
transport outcomes (offered attempt units vs delivered payload fraction —
the same basis as the BandwidthMeter's two ledgers), and at each window
boundary nudges two knobs one step:

    ratio < ratio_low    the link is wasting offered bandwidth — shrink the
                         retry budget toward 1 and lower the breaker's
                         open-threshold (open faster, stop re-offering into
                         a dead link);
    ratio >= ratio_high  the link is healthy — step both knobs back toward
                         their configured base.

Everything is a pure function of the observation sequence: no wall clock,
no randomness.  Replaying the same transport outcomes (e.g. the uncharged
`round_outcome(..., charge=False)` fast-forward a resumed run performs)
rebuilds the same knob trajectory, and `state_dict()`/`load_state_dict()`
round-trip the controller through the crash-atomic checkpoint sidecar —
so an adaptive run resumes bit-identically, knobs included.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.transport.policy import DEFAULT_RETRY, RetryPolicy


@dataclass(frozen=True)
class AdaptiveConfig:
    """Window rules for the controller (see module docstring)."""
    window: int = 8               # observations per edge per retune
    ratio_low: float = 0.5        # below: tighten (fewer attempts, open faster)
    ratio_high: float = 0.9       # at/above: relax back toward base
    min_attempts: int = 1
    min_threshold: int = 1


class AdaptivePolicy:
    """Per-edge retry/breaker controller driven by delivered/offered.

    base             the RetryPolicy ceiling (its max_attempts is the upper
                     bound the controller relaxes back to).
    base_threshold   the breaker open-threshold ceiling — match it to the
                     CircuitBreaker the transport installs.
    """

    def __init__(self, base: RetryPolicy = DEFAULT_RETRY,
                 base_threshold: int = 3,
                 config: Optional[AdaptiveConfig] = None):
        self.base = base
        self.base_threshold = int(base_threshold)
        self.config = config or AdaptiveConfig()
        self._attempts: Dict[str, int] = {}     # current per-edge budget
        self._thresholds: Dict[str, int] = {}   # current per-edge threshold
        # per-edge open window: [observations, offered units, delivered units]
        self._window: Dict[str, list] = {}
        self.retunes = 0

    # -- knobs --------------------------------------------------------------

    def policy_for(self, edge_key: str) -> RetryPolicy:
        n = self._attempts.get(edge_key, self.base.max_attempts)
        if n == self.base.max_attempts:
            return self.base
        return dataclasses.replace(self.base, max_attempts=n)

    def threshold_for(self, edge_key: str) -> int:
        return self._thresholds.get(edge_key, self.base_threshold)

    # -- observations -------------------------------------------------------

    def observe(self, edge_key: str, *, offered: float,
                delivered: float) -> None:
        """One transport outcome on one edge: `offered` in attempt units
        (0 when the breaker short-circuited every attempt), `delivered` as
        the payload fraction that reached the consumer (0..1)."""
        w = self._window.setdefault(edge_key, [0, 0.0, 0.0])
        w[0] += 1
        w[1] += float(offered)
        w[2] += float(delivered)
        if w[0] >= self.config.window:
            self._retune(edge_key, w)
            self._window[edge_key] = [0, 0.0, 0.0]

    def _retune(self, edge_key: str, w: list) -> None:
        self.retunes += 1
        cfg = self.config
        cur_a = self._attempts.get(edge_key, self.base.max_attempts)
        cur_t = self._thresholds.get(edge_key, self.base_threshold)
        if w[1] <= 0.0:
            # the breaker refused the whole window: nothing was offered, so
            # the ratio is uninformative — hold the knobs where they are
            return
        ratio = w[2] / w[1]
        if ratio < cfg.ratio_low:
            a = max(cfg.min_attempts, cur_a - 1)
            t = max(cfg.min_threshold, cur_t - 1)
        elif ratio >= cfg.ratio_high:
            a = min(self.base.max_attempts, cur_a + 1)
            t = min(self.base_threshold, cur_t + 1)
        else:
            return
        self._attempts[edge_key] = a
        self._thresholds[edge_key] = t

    # -- checkpointing ------------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        return {
            "attempts": dict(self._attempts),
            "thresholds": dict(self._thresholds),
            "window": {k: list(v) for k, v in self._window.items()},
            "retunes": self.retunes,
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self._attempts = {k: int(v) for k, v in state["attempts"].items()}
        self._thresholds = {k: int(v)
                            for k, v in state["thresholds"].items()}
        self._window = {k: [int(v[0]), float(v[1]), float(v[2])]
                        for k, v in state["window"].items()}
        self.retunes = int(state["retunes"])
