"""Pareto extraction on the (accuracy up, accounted Gbits down) plane.

Reference: src/repro/search/pareto.py, copied (it is framework-free).
"""
from __future__ import annotations


def dominates(a, b, *, acc=lambda p: p.accuracy,
              cost=lambda p: p.gbits) -> bool:
    """a weakly better on both axes, strictly better on at least one."""
    return (acc(a) >= acc(b) and cost(a) <= cost(b)
            and (acc(a) > acc(b) or cost(a) < cost(b)))


def pareto_frontier(points, *, acc=lambda p: p.accuracy,
                    cost=lambda p: p.gbits) -> list:
    """Non-dominated subset, sorted by cost ascending.  Duplicates on both
    axes keep their first spelling (stable for the bench artifact).  A
    point ties onto the frontier only if nothing dominates it — equal
    (acc, cost) pairs are mutually non-dominating and both survive."""
    items = sorted(points, key=lambda p: (cost(p), -acc(p)))
    out = []
    best_acc = None
    for p in items:
        if best_acc is None or acc(p) > best_acc:
            out.append(p)
            best_acc = acc(p)
        elif acc(p) == best_acc and out and cost(out[-1]) == cost(p):
            out.append(p)            # exact tie with the incumbent
    return out


def best_under_budget(points, budget, *, acc=lambda p: p.accuracy,
                      cost=lambda p: p.gbits):
    """Highest accuracy reachable at cost <= budget; None if nothing
    fits."""
    feasible = [p for p in points if cost(p) <= budget]
    return max(feasible, key=acc) if feasible else None
