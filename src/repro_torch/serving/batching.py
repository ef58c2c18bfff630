"""Bucketed batch assembly: pad in-flight requests to a fixed size grid.

Reference: src/repro/serving/batching.py, copied (numpy only).  The engine
coalesces requests into the smallest BUCKET that holds them (default grid
{1, 4, 16, 64}, `Scheme.serve_buckets`) and pads the batch up to that size,
so predict only ever runs at four batch shapes: a library picks one
convolution and one matrix-product algorithm per shape, and a CUDA graph
per bucket (a later step) captures a fixed shape.

Padding is row-wise inert: inference has no cross-sample ops (BatchNorm
runs on running stats, the fusion concatenation is per sample), so a real
request's probabilities are bit-identical whether it rides a full bucket
or a padded one of the same size (tests/test_torch_serving.py pins this).
Pad rows replicate the last real request, and their outputs are dropped
before completion.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

BUCKETS: Tuple[int, ...] = (1, 4, 16, 64)


def validate_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """Ascending, positive, deduplicated — the engine's static size grid."""
    out = tuple(sorted(set(int(b) for b in buckets)))
    if not out or out[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket holding n requests (callers cap collection at
    max(buckets), so n never exceeds the grid)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{buckets[-1]}; collect at most max(buckets) requests")


def pad_to_bucket(views: np.ndarray, rids: np.ndarray, bucket: int):
    """((J, n, ...) views, (n,) ids) -> ((J, bucket, ...), (bucket,)).

    Pad rows repeat the last real request (ids included, so their fault
    draws are well-defined); the engine slices the first n rows of the
    result and never completes a pad row."""
    n = views.shape[1]
    if n > bucket:
        raise ValueError(f"batch of {n} does not fit bucket {bucket}")
    if n == bucket:
        return views, rids
    pad = bucket - n
    views = np.concatenate(
        [views, np.repeat(views[:, -1:], pad, axis=1)], axis=1)
    rids = np.concatenate([rids, np.repeat(rids[-1:], pad)])
    return views, rids
