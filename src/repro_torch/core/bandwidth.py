"""Bandwidth accounting — §III-C / Table I, exactly as published.

Reference: src/repro/core/bandwidth.py, copied (it is framework-free).

    INL:  2 p q s / J        per epoch (activations fwd + errors bwd; each of
                             the J nodes holds q/J points and sends p/J values)
    FL:   2 N J s            per round (full weights down + up, J clients)
    SL:   (2 p q + eta N J) s  per epoch (cut activations for all q points +
                             J sequential weight hand-offs of eta*N params)

Table I constants: VGG16 N=138,344,128; ResNet50 N=25,636,712; J=500;
p=25088; eta=0.11 (VGG16) / 0.88 (ResNet50); s=32 bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

GBIT = 1e9

VGG16_PARAMS = 138_344_128
RESNET50_PARAMS = 25_636_712
TABLE1_J = 500
TABLE1_P = 25_088
TABLE1_ETA = {"vgg16": 0.11, "resnet50": 0.88}
TABLE1_BITS = 32


def inl_epoch_bits(p: int, q: int, J: int, s: int = TABLE1_BITS) -> float:
    return 2.0 * p * q * s / J


def fl_round_bits(N: int, J: int, s: int = TABLE1_BITS) -> float:
    return 2.0 * N * J * s


def sl_epoch_bits(p: int, q: int, N: int, J: int, eta: float,
                  s: int = TABLE1_BITS) -> float:
    return (2.0 * p * q + eta * N * J) * s


def table1(q: int, network: str) -> Dict[str, float]:
    """Reproduce one row of Table I (values in Gbits).

    `network` must be a Table-I architecture — an unknown string used to
    fall through to resnet50 silently."""
    if network not in TABLE1_ETA:
        raise ValueError(f"unknown Table-I network {network!r}; "
                         f"known: {sorted(TABLE1_ETA)}")
    N = VGG16_PARAMS if network == "vgg16" else RESNET50_PARAMS
    eta = TABLE1_ETA[network]
    return {
        "federated": fl_round_bits(N, TABLE1_J) / GBIT,
        "split": sl_epoch_bits(TABLE1_P, q, N, TABLE1_J, eta) / GBIT,
        "in_network": inl_epoch_bits(TABLE1_P, q, TABLE1_J) / GBIT,
    }


# Published Table I values (Gbits) for validation in tests/benchmarks.
PAPER_TABLE1 = {
    ("vgg16", 50_000): {"federated": 4427, "split": 324, "in_network": 0.16},
    ("resnet50", 50_000): {"federated": 820, "split": 441, "in_network": 0.16},
    ("vgg16", 500_000): {"federated": 4427, "split": 1046, "in_network": 1.6},
    ("resnet50", 500_000): {"federated": 820, "split": 1164,
                            "in_network": 1.6},
}


@dataclass
class BandwidthMeter:
    """Two ledgers for one run: the ACCOUNTED bits (closed-form §III-C /
    Table-I charges, `add`) and the MEASURED bytes (`add_measured`) — the
    `nbytes` of the buffers the execution layer actually put on the wire
    (core/wirefmt.py derives them from the size of the real buffers).

    With the packed wire format the two ledgers agree exactly
    (measured_bits == accounted bits); the dense fp32 baseline moves
    32/link_bits more than it accounts — the gap this meter exists to
    expose.  tests/test_scheme_parity.py pins the agreement.

    Both ledgers also decompose PER EDGE of a network topology
    (core/topology.py): `add_edge` charges one named link on both ledgers
    at once, accumulating `edge_bits` / `edge_measured_bytes` alongside the
    totals — for `star(J)` the per-edge charges sum to exactly the Table-I
    totals the scalar `add` path produces.

    Unreliable links (core/linkfault.py) split each ledger further into
    OFFERED vs DELIVERED: `add` / `add_measured` / `add_edge` charge what
    the schedule put on the links (SL's bounded retries re-offer the
    round's exchange per attempt), while `add_delivered` accrues what the
    consumer actually used (the latent chunks that reached the fusion in
    time, the FedAvg uploads that arrived, the SL rounds that ran).  On a
    fault-free run the runner credits delivered == offered, so
    `delivery_ratio` is exactly 1.0 and drops with the network."""
    total_bits: float = 0.0
    measured_bytes: float = 0.0
    edge_bits: Dict[str, float] = field(default_factory=dict)
    edge_measured_bytes: Dict[str, float] = field(default_factory=dict)
    delivered_bits: float = 0.0
    delivered_measured_bytes: float = 0.0
    edge_delivered_bits: Dict[str, float] = field(default_factory=dict)

    def add(self, bits: float) -> None:
        self.total_bits += float(bits)

    def add_measured(self, nbytes: float) -> None:
        self.measured_bytes += float(nbytes)

    def add_edge(self, edge: str, *, bits: float = 0.0,
                 nbytes: float = 0.0) -> None:
        """Charge one topology edge on both ledgers (totals included)."""
        self.edge_bits[edge] = self.edge_bits.get(edge, 0.0) + float(bits)
        self.edge_measured_bytes[edge] = \
            self.edge_measured_bytes.get(edge, 0.0) + float(nbytes)
        self.add(bits)
        self.add_measured(nbytes)

    def add_delivered(self, *, bits: float = 0.0, nbytes: float = 0.0,
                      edge: str = None) -> None:
        """Credit traffic the consumer actually used (<= the offered
        charge of the same transmission; per edge when named)."""
        self.delivered_bits += float(bits)
        self.delivered_measured_bytes += float(nbytes)
        if edge is not None:
            self.edge_delivered_bits[edge] = \
                self.edge_delivered_bits.get(edge, 0.0) + float(bits)

    @property
    def gbits(self) -> float:
        return self.total_bits / GBIT

    @property
    def measured_bits(self) -> float:
        return self.measured_bytes * 8.0

    @property
    def measured_gbits(self) -> float:
        return self.measured_bits / GBIT

    @property
    def delivered_gbits(self) -> float:
        return self.delivered_bits / GBIT

    @property
    def delivery_ratio(self) -> float:
        """Delivered / offered accounted bits; 1.0 on an idle meter (and
        on any fault-free run — the runner credits both ledgers equally)."""
        return (self.delivered_bits / self.total_bits
                if self.total_bits else 1.0)


# the ISSUE/roadmap name for the measured meter
BitMeter = BandwidthMeter
