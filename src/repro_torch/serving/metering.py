"""Per-request bandwidth: what ONE inference puts on each topology edge.

Reference: src/repro/serving/metering.py, copied over the port's topology
and wire-format modules.

Training rounds charge both directions (§III-C: activations forward, eq.-
(10) error vectors back); a served request ships each edge's payload ONCE,
forward only — every view latent traverses its route to the fusion center
and nothing returns.  Closed-form charge per edge is therefore
|payload| * d_bottleneck * link_bits, and the measured bytes are the
forward leg of the same `core/wirefmt.py` accounting the training ledgers
use (`shipped_nbytes` over the real buffers) — so the serving meter and
the training meter cannot drift apart.

The engine charges these static per-request figures on the OFFERED ledger
for every completed request, and credits the DELIVERED ledger with each
edge's surviving payload fraction from the request's fuse-what-arrived
mask: the convention `linkfault.round_fault_charges` applies to training
rounds, at request granularity here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import topology as topology_lib
from repro_torch.core import wirefmt


def request_edge_bits(topo, cfg) -> Dict[str, float]:
    """Closed-form bits ONE request offers each edge (forward only)."""
    return {e.key: float(len(topo.payload(e)) * cfg.d_bottleneck
                         * topology_lib.edge_bits(e, cfg))
            for e in topo.topo_edges()}


def request_edge_wire_bytes(topo, cfg, *, wire: str = "dense"
                            ) -> Dict[str, float]:
    """Measured bytes ONE request's payload occupies on each edge under
    `wire` (the edge's own wire/dtype overrides win, as in training)."""
    return {e.key: float(wirefmt.shipped_nbytes(
                len(topo.payload(e)), cfg.d_bottleneck,
                link_bits=topology_lib.edge_bits(e, cfg),
                wire=topology_lib.edge_wire(e, wire),
                dtype=topology_lib.edge_dtype(e, cfg)))
            for e in topo.topo_edges()}


def request_bits(topo, cfg) -> float:
    return float(sum(request_edge_bits(topo, cfg).values()))


def meter_served_batch(meter, topo, cfg, mask, *, edge_bits: Dict[str, float],
                       edge_nbytes: Dict[str, float]) -> None:
    """Charge one completed batch on a BandwidthMeter's two ledgers.

    mask — the (J, n) delivery mask of the n REAL requests (pad rows
    already sliced off).  Offered: every request charges every edge in
    full (the schedule transmitted; the network dropped).  Delivered: each
    edge credits the fraction of its payload views that reached the fusion,
    summed over the batch — all-ones masks credit delivered == offered
    exactly, so a clean network keeps delivery_ratio at 1.0."""
    n = int(mask.shape[1])
    for e in topo.topo_edges():
        pay = list(topo.payload(e))
        bits, nbytes = edge_bits[e.key], edge_nbytes[e.key]
        meter.add_edge(e.key, bits=n * bits, nbytes=n * nbytes)
        frac = float(mask[pay, :].sum()) / len(pay)   # sums over requests
        meter.add_delivered(bits=bits * frac, nbytes=nbytes * frac,
                            edge=e.key)
