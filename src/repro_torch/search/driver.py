"""Stage 2 of the search: train the surviving candidates and extract the
accuracy-per-Gbit Pareto frontier.

Every trained point runs through the SAME `runner.run_scheme` pipeline the
paper curves use — one metered run per point, accuracy from the shared
eval split, bandwidth from the runner's BandwidthMeter — and the driver
checks the stage-1 pricing against the meter EXACTLY (both sides are sums
of the same integer-valued per-round charges, so equality is ==, not
isclose).  `train_pruned=True` additionally trains the pruned points
(the smoke-grid soundness audit frontier_bench asserts on).

Reference: src/repro/search/driver.py.  The port trains on `device`
(None: cuda); each noise ladder's views move there once and every point
that shares the ladder trains on them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import bandwidth
from repro_torch.core.schemes import runner as runner_lib
from repro_torch.data import multiview
from repro_torch.search import pareto
from repro_torch.search.pricing import CANDIDATE, PricedPoint, price
from repro_torch.search.space import merge_points


@dataclass
class MeasuredPoint:
    key: str
    status: str
    stand_in: Optional[str]
    accuracy: float
    gbits: float                  # accounted (closed-form), cumulative
    measured_gbits: float
    delivered_gbits: float
    priced_gbits: float           # stage-1 prediction of `gbits`
    priced_measured_gbits: float
    trained: bool                 # False = inherited from its stand-in

    def record(self) -> dict:
        return dict(self.__dict__)


@dataclass
class SearchResult:
    priced: List[PricedPoint]
    measured: Dict[str, MeasuredPoint]
    frontier: List[MeasuredPoint] = field(default_factory=list)

    def candidates(self):
        return [m for m in self.measured.values()
                if m.status == CANDIDATE and m.trained]

    def record(self) -> dict:
        return {"grid": [pp.record() for pp in self.priced],
                "measured": [m.record() for m in self.measured.values()],
                "frontier": [m.key for m in self.frontier]}


class _DataCache:
    """One base image set, one view stack per noise ladder — points that
    share a view count share their data, so star/chain/tree comparisons
    are apples-to-apples.  The views of a ladder and the labels move to
    `device` once."""

    def __init__(self, base_cfg, device):
        self.device = device
        self.images, labels = multiview.make_base_dataset(
            base_cfg.dataset_size, num_classes=base_cfg.num_classes,
            image_shape=base_cfg.image_shape, seed=base_cfg.seed)
        self.labels = torch.as_tensor(labels, device=device).long()
        self._views: dict = {}

    def views(self, cfg):
        key = cfg.noise_stds
        if key not in self._views:
            self._views[key] = torch.as_tensor(
                multiview.make_views(self.images, cfg.noise_stds),
                device=self.device)
        return self._views[key], self.labels


def _train_one(pp: PricedPoint, data: _DataCache, *, epochs, batch_size,
               lr, seed, eval_n) -> MeasuredPoint:
    views, labels = data.views(pp.cfg)
    meter = bandwidth.BandwidthMeter()
    curve = runner_lib.run_scheme(
        pp.point.scheme, views, labels, pp.cfg, epochs=epochs,
        batch_size=batch_size, lr=lr, seed=seed, eval_n=eval_n,
        wire=pp.point.wire, topology=pp.topology, meter=meter,
        device=data.device)
    last = curve[-1]
    return MeasuredPoint(
        key=pp.key, status=pp.status, stand_in=pp.stand_in,
        accuracy=last.accuracy, gbits=last.gbits,
        measured_gbits=last.measured_gbits,
        delivered_gbits=last.delivered_gbits,
        priced_gbits=pp.total_gbits(epochs),
        priced_measured_gbits=epochs * pp.epoch_nbytes() * 8 / 1e9,
        trained=True)


def run_search(spaces, base_cfg, *, epochs: int, batch_size: int,
               lr: float = 2e-3, seed: int = 0, eval_n: int = 256,
               train_pruned: bool = False, log=print,
               device=None) -> SearchResult:
    """The two-stage driver, training on `device` (None: cuda).  `spaces`:
    SearchSpace instances (their valid points are merged, first spelling
    wins) or a ready list of ConfigPoints."""
    device = resolve_device(device)
    points = spaces if isinstance(spaces, list) else merge_points(*spaces)
    train_n = (base_cfg.dataset_size // batch_size) * batch_size
    priced = price(points, base_cfg, batch_size=batch_size, train_n=train_n)
    todo = [pp for pp in priced
            if pp.status == CANDIDATE or train_pruned]
    n_pruned = len(priced) - sum(pp.status == CANDIDATE for pp in priced)
    log(f"search: {len(priced)} valid points, {n_pruned} pruned by ledger, "
        f"training {len(todo)}")

    data = _DataCache(base_cfg, device)
    result = SearchResult(priced=priced, measured={})
    for i, pp in enumerate(todo):
        m = _train_one(pp, data, epochs=epochs, batch_size=batch_size,
                       lr=lr, seed=seed, eval_n=eval_n)
        result.measured[m.key] = m
        log(f"  [{i + 1}/{len(todo)}] {m.key}: acc {m.accuracy:.3f}, "
            f"{m.gbits:.5f} Gbit ({m.status})")

    # pruned points that did not train inherit their stand-in's measured
    # result — sound by construction (bit-identical trajectory at equal
    # accuracy; the wire twin also shares the accounted-Gbit axis, the
    # star-dominated point keeps its own, strictly larger, price)
    for pp in priced:
        if pp.key in result.measured or pp.stand_in is None:
            continue
        rep = result.measured.get(pp.stand_in)
        if rep is None:
            continue
        result.measured[pp.key] = MeasuredPoint(
            key=pp.key, status=pp.status, stand_in=pp.stand_in,
            accuracy=rep.accuracy, gbits=pp.total_gbits(epochs),
            measured_gbits=epochs * pp.epoch_nbytes() * 8 / 1e9,
            delivered_gbits=pp.total_gbits(epochs),
            priced_gbits=pp.total_gbits(epochs),
            priced_measured_gbits=epochs * pp.epoch_nbytes() * 8 / 1e9,
            trained=False)

    result.frontier = pareto.pareto_frontier(result.candidates())
    return result
