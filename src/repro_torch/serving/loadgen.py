"""Poisson load generation against a live ServingEngine.

Reference: src/repro/serving/loadgen.py.

The benchmarkable question for the serving plane is not "how fast is one
predict" but "what latency does a request see at a given OFFERED LOAD" —
the continuous-batching argument only shows up under contention, when
arrivals outpace serial service and the engine coalesces the backlog into
wide buckets.  `run_poisson` drives exactly that experiment: seeded
exponential inter-arrivals at a target rate, every request's views drawn
from a fixed pool, and a summary with the three serving numbers that
matter — p50/p99 latency, goodput, and the per-request delivered-bits
ledger snapshotted off the engine's BandwidthMeter.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np


def percentile_ms(latencies, q: float) -> float:
    """`np.percentile` with the degenerate sample sizes guarded: an empty
    list is 0.0 (not a ValueError mid-benchmark) and a single sample IS
    every percentile — so `run_poisson` with one request reports a real
    p99 instead of crashing the summary."""
    lats = np.asarray(latencies, np.float64)
    if lats.size == 0:
        return 0.0
    if lats.size == 1:
        return float(lats[0])
    return float(np.percentile(lats, q))


def run_poisson(engine, views_pool: np.ndarray, *, rate_rps: float,
                num_requests: int, seed: int = 0,
                timeout: float = 600.0) -> Dict[str, float]:
    """Offer `num_requests` to a STARTED engine at `rate_rps` (Poisson:
    seeded exponential inter-arrivals), wait for all completions, and
    summarise.

    views_pool — (J, n_pool, ...) request views, cycled through in order so
    a fixed (pool, seed) pair replays an identical arrival stream.  When
    the generator falls behind its schedule (a long batch blocked the
    clock) it submits immediately and catches up rather than silently
    thinning the offered load.

    Returns {offered_rps, goodput_rps, p50_ms, p99_ms, served, mean_views_fused,
    offered_gbits, delivered_gbits, delivery_ratio, wall_s} — goodput is
    completions over the span from first submit to last completion, and the
    bit ledgers are this run's delta on the engine meter.
    """
    rng = np.random.default_rng(seed)
    n_pool = views_pool.shape[1]
    gaps = rng.exponential(1.0 / rate_rps, size=num_requests)

    bits0, dbits0 = engine.meter.total_bits, engine.meter.delivered_bits
    futs = []
    t0 = time.perf_counter()
    due = t0
    for i in range(num_requests):
        due += gaps[i]
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        futs.append(engine.submit(views_pool[:, i % n_pool])[1])

    results = [f.result(timeout=timeout) for f in futs]
    # an engine with max_queue= resolves shed requests to Rejected — they
    # count against goodput (offered but not served), not against latency
    served = [r for r in results if hasattr(r, "probs")]
    # num_requests=0 (or 1) must yield a NaN-free summary: guard the empty
    # max()/mean() and let percentile_ms handle the sub-2-sample lists
    t_end = max((r.t_done for r in results), default=t0)
    span = max(t_end - t0, 1e-9)

    lats = [r.latency_ms for r in served]
    fused = [r.views_fused for r in served]
    offered_bits = engine.meter.total_bits - bits0
    delivered_bits = engine.meter.delivered_bits - dbits0
    return {
        "offered_rps": float(rate_rps),
        "goodput_rps": len(served) / span,
        "p50_ms": percentile_ms(lats, 50),
        "p99_ms": percentile_ms(lats, 99),
        "served": len(served),
        "shed": len(results) - len(served),
        "mean_views_fused": float(np.mean(fused)) if fused else 0.0,
        "offered_gbits": offered_bits / 1e9,
        "delivered_gbits": delivered_bits / 1e9,
        "delivery_ratio": (delivered_bits / offered_bits
                           if offered_bits else 1.0),
        "wall_s": span,
    }


def measure_serial_capacity(engine, views_pool: np.ndarray, *,
                            num_requests: int = 32,
                            timeout: float = 600.0) -> float:
    """Requests-per-second of STRICTLY SERIAL service on a started engine:
    submit one, wait, submit the next.  The calibration anchor for the
    sweep's offered-load points — and the baseline the continuous-batching
    goodput is asserted against."""
    n_pool = views_pool.shape[1]
    t0 = time.perf_counter()
    last = t0
    for i in range(num_requests):
        _, fut = engine.submit(views_pool[:, i % n_pool])
        last = fut.result(timeout=timeout).t_done
    return num_requests / max(last - t0, 1e-9)
