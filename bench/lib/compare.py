"""The numbers that decide `correct` for a training cell, and their limits.

Each training cell's set-up drives the program through its first three
steps through the window's own call and feed; the plain reference follows
the same three steps from the same weights, data and draws.  Three numbers
are compared, each against its limit in bench/workloads/<cell>.json:

    loss    the largest relative gap of the three steps' losses
    grad    the first gradient as the optimizer got it (worked out from its
            state after step 1): by the worst leaf, the gap between the
            program's norm of the leaf and the reference's, over the larger
            of the reference's norm of that leaf and of the median leaf
    change  the parameters' change after three steps, as the state that
            step 4 reads holds it, by the worst leaf as for `grad`; a leaf
            whose reference gradient is under a thousandth of the median
            leaf's moves by round-off alone and is left out

Norms are taken in float64, a slice at a time.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

KEEP_BELOW_MEDIAN = 1e-3
_CHUNK = 1 << 26


def norm(t: torch.Tensor) -> float:
    """The 2-norm of `t` in float64, without a float64 copy of all of it."""
    flat = t.detach().reshape(-1)
    acc = torch.zeros((), dtype=torch.float64, device=flat.device)
    for i in range(0, flat.numel(), _CHUNK):
        c = flat[i:i + _CHUNK].to(torch.float64)
        acc += torch.dot(c, c)
    return math.sqrt(float(acc))


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    gaps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
            for p, r in zip(program, reference)]
    return max(gaps)


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   keep: Sequence[str] = None) -> float:
    """max over the kept leaves of |program - reference| / max(reference,
    the reference's median leaf norm)."""
    median = statistics.median(reference.values())
    names = list(reference) if keep is None else list(keep)
    worst = 0.0
    for k in names:
        p = program[k]
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - reference[k]) / max(reference[k], median))
    return worst


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's norm."""
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= KEEP_BELOW_MEDIAN * median]


def numbers(program: dict, reference: dict) -> Dict[str, float]:
    """program / reference: {"losses": [3 floats], "grad": {leaf: norm},
    "change": {leaf: norm}} -> {"loss", "grad", "change"}."""
    keep = moving_leaves(reference["grad"])
    return {"loss": loss_gap(program["losses"], reference["losses"]),
            "grad": worst_leaf_gap(program["grad"], reference["grad"]),
            "change": worst_leaf_gap(program["change"], reference["change"],
                                     keep)}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{"correct": bool, "checks": {name: {"value", "limit"}}}: correct when
    every number is finite and within its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}
