"""INL serving plane: continuous-batching inference on the star.

Reference: src/repro/serving/.

    engine    per-node request queues, pad-to-bucket batched predict,
              admission control, two-ledger bandwidth metering.
    batching  the pad-to-bucket grid ({1, 4, 16, 64} by default).
    metering  per-request per-edge bit/byte charges (forward direction).

The load generator (`loadgen`) comes with the benchmark of the port.
"""
from repro_torch.serving.batching import BUCKETS, pad_to_bucket, pick_bucket
from repro_torch.serving.engine import (EngineShutdown, Rejected,
                                        ServedRequest, ServeStats,
                                        ServingEngine)
from repro_torch.serving.metering import request_bits, request_edge_bits

__all__ = [
    "BUCKETS", "pad_to_bucket", "pick_bucket",
    "EngineShutdown", "Rejected", "ServedRequest", "ServeStats",
    "ServingEngine",
    "request_bits", "request_edge_bits",
]
