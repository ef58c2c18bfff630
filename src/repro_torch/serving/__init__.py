"""INL serving plane: continuous-batching inference over a topology.

Reference: src/repro/serving/.

    engine    per-node request queues, pad-to-bucket batched predict,
              admission control, two-ledger bandwidth metering.
    batching  the pad-to-bucket grid ({1, 4, 16, 64} by default).
    metering  per-request per-edge bit/byte charges (forward direction).
    loadgen   seeded Poisson offered-load runs + serial-capacity anchor.

`launch/serve.py --arch paper-inl` is the CLI front end.
"""
from repro_torch.serving.batching import BUCKETS, pad_to_bucket, pick_bucket
from repro_torch.serving.engine import (EngineShutdown, Rejected,
                                        ServedRequest, ServeStats,
                                        ServingEngine)
from repro_torch.serving.loadgen import measure_serial_capacity, run_poisson
from repro_torch.serving.metering import request_bits, request_edge_bits

__all__ = [
    "BUCKETS", "pad_to_bucket", "pick_bucket",
    "EngineShutdown", "Rejected", "ServedRequest", "ServeStats",
    "ServingEngine",
    "measure_serial_capacity", "run_poisson",
    "request_bits", "request_edge_bits",
]
