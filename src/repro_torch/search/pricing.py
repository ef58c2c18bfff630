"""Stage 1 of the search: price every point from the closed-form ledgers —
no training, no round function built — then prune with rules
that are SOUND, not heuristic: a pruned point's trained result is provably
(bit-identically) equal to a surviving point's at equal-or-higher cost, so
pruning can never discard a frontier config.  `frontier_bench.py --smoke`
verifies exactly that by exhaustively training the pruned points too.

Rule 1 — wire equivalence.  "packed" is a lossless re-encoding of the
same quantized values ("dense" at the same link width): trajectories are
bit-identical (pinned by tests/test_wireformat.py) and the closed-form
charge only depends on the width, so of {dense, packed} at one
(scheme, topology, link_bits, cut_depth) only one representative trains —
the accuracy axis AND the accounted-Gbit axis are shared.  NOT
"packed_duplex": its backward path genuinely quantizes the error chunks,
a different trajectory.

Rule 2 — star dominance.  A constructor graph (edge-homogeneous, widths
inherited from cfg) at link_bits=32 executes every relay hop as the exact
identity (the uniform quantizer is idempotent, fp32 storage round-trips),
so training and inference are bit-identical to the star on the same
views — while the multi-hop ledger charges every edge for its full
payload, strictly more than the star's J single-latent links.  When the
star sibling is in the grid, the non-star point is weakly dominated by
construction and skips training.

Everything else trains: narrow links on a graph are NOT pruned (hops
re-quantize at inference — accuracy genuinely moves), and no accuracy
estimate is ever used to prune (the ledgers know bits, not accuracy).

Reference: src/repro/search/pricing.py.  Pricing inits each scheme only
to read its parameter shapes, so it does so on the CPU from a generator
seeded 0, whatever device the search trains on: the ledgers depend on
shapes alone, so the prices equal what the runner meters on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import schemes
from repro_torch.core.schemes import runner as runner_lib
from repro_torch.search.space import ConfigPoint

CANDIDATE = "candidate"
PRUNED_WIRE = "pruned:wire-equivalent"
PRUNED_STAR = "pruned:star-dominated"


@dataclass
class PricedPoint:
    point: ConfigPoint
    cfg: object
    topology: object              # resolved Topology or None (default star)
    rounds_per_epoch: int
    round_bits: float             # closed-form §III-C charge, one round
    round_nbytes: float           # measured wire bytes, one round
    overhead_bits: float          # once-per-epoch charges (SL hand-offs)
    overhead_nbytes: float
    status: str = CANDIDATE
    stand_in: Optional[str] = None   # key of the point that trains instead

    @property
    def key(self) -> str:
        return self.point.key

    def epoch_bits(self) -> float:
        return self.rounds_per_epoch * self.round_bits + self.overhead_bits

    def epoch_nbytes(self) -> float:
        return self.rounds_per_epoch * self.round_nbytes \
            + self.overhead_nbytes

    def total_gbits(self, epochs: int) -> float:
        return epochs * self.epoch_bits() / 1e9

    def record(self) -> dict:
        return {"key": self.key, "scheme": self.point.scheme,
                "topology": self.point.topology,
                "link_bits": self.point.link_bits, "wire": self.point.wire,
                "cut_depth": self.point.cut_depth, "status": self.status,
                "stand_in": self.stand_in,
                "rounds_per_epoch": self.rounds_per_epoch,
                "epoch_bits": self.epoch_bits(),
                "epoch_wire_bytes": self.epoch_nbytes()}


def price_point(point: ConfigPoint, base_cfg, *, batch_size: int,
                train_n: int) -> PricedPoint:
    """Exact per-epoch pricing from the scheme's own ledgers — the same
    closed forms the runner's BandwidthMeter charges, via the same
    `rounds_per_epoch` rule, so priced == metered bit for bit."""
    cfg, topo = point.resolve(base_cfg)
    scheme = schemes.get(point.scheme)
    state = scheme.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return PricedPoint(
        point=point, cfg=cfg, topology=topo,
        rounds_per_epoch=runner_lib.rounds_per_epoch(scheme, cfg, train_n,
                                                     batch_size),
        round_bits=scheme.bits_per_round(cfg, state, batch_size,
                                         topology=topo),
        round_nbytes=scheme.wire_bytes_per_round(cfg, state, batch_size,
                                                 wire=point.wire,
                                                 topology=topo),
        overhead_bits=scheme.epoch_overhead_bits(cfg, state),
        overhead_nbytes=scheme.epoch_overhead_wire_bytes(cfg, state))


def _apply_wire_equivalence(priced: list) -> None:
    groups: dict = {}
    for pp in priced:
        p = pp.point
        if p.wire in ("dense", "packed"):
            groups.setdefault(
                (p.scheme, p.topology, p.link_bits, p.cut_depth),
                []).append(pp)
    for members in groups.values():
        if len(members) < 2:
            continue
        rep = next((m for m in members if m.point.wire == "dense"),
                   members[0])
        for m in members:
            if m is rep:
                continue
            if m.round_bits != rep.round_bits:     # closed forms must agree
                raise AssertionError(
                    f"wire-equivalence violated: {m.key} charges "
                    f"{m.round_bits} vs {rep.key} {rep.round_bits}")
            m.status, m.stand_in = PRUNED_WIRE, rep.key


def _apply_star_dominance(priced: list) -> None:
    by_key = {pp.key: pp for pp in priced}
    for pp in priced:
        p = pp.point
        if pp.status != CANDIDATE or p.link_bits != 32 \
                or p.topology.startswith("star("):
            continue
        star_key = ConfigPoint(p.scheme, f"star({pp.cfg.num_clients})",
                               p.link_bits, p.wire, p.cut_depth).key
        sibling = by_key.get(star_key)
        if sibling is None or sibling.status != CANDIDATE:
            continue                     # nothing to stand in — train it
        if pp.round_bits < sibling.round_bits:
            raise AssertionError(
                f"star dominance violated: {pp.key} charges {pp.round_bits}"
                f" < star sibling {sibling.round_bits}")
        pp.status, pp.stand_in = PRUNED_STAR, star_key


def price(points, base_cfg, *, batch_size: int, train_n: int) -> list:
    """Price every point, then mark the provably-redundant ones."""
    priced = [price_point(p, base_cfg, batch_size=batch_size,
                          train_n=train_n) for p in points]
    _apply_wire_equivalence(priced)
    _apply_star_dominance(priced)
    return priced
