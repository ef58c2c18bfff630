"""The port's auto-placement search (repro_torch/search) against the
reference's (repro/search), on the CPU.

Twins of tests/test_search.py: topology names, the space's structural
rejections, cut depth for the hybrids only, `resolve`, the two pruning
rules, priced == metered exactly, the shared rounds-per-epoch rule,
dominance, frontier extraction, the best point under a budget, and an
end-to-end `run_search`.  Parity with the reference:
  * on `benchmarks/frontier_bench.py`'s smoke grid at its SMOKE widths,
    the port's `price` gives the reference's keys, statuses, stand-ins,
    rounds, priced bits and priced wire bytes, exactly (==);
  * `excluded()` gives the same combinations with the same reasons;
  * `pareto_frontier` and `best_under_budget` pick the same points from
    the same inputs;
  * `run_search` on the CPU meters exactly what it priced, and a pruned
    star-dominated graph trains to its star's accuracy exactly.
Trajectories are not compared with the reference's: the random draws
differ (ROADMAP, "How parity works").
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _schemes_common import BATCH, CFG as JCFG  # noqa: E402
from benchmarks import frontier_bench  # noqa: E402
from repro import search as jsearch  # noqa: E402
from repro.search import pareto as jpareto  # noqa: E402
from repro.search import space as jspace  # noqa: E402
from repro_torch.configs.paper_inl import PaperExperimentConfig  # noqa: E402
from repro_torch.core import bandwidth, schemes  # noqa: E402
from repro_torch.core import topology as topology_lib  # noqa: E402
from repro_torch.core.schemes import runner  # noqa: E402
from repro_torch.data import multiview  # noqa: E402
from repro_torch.search import (ConfigPoint, SearchSpace, dominates,  # noqa
                                pareto_frontier, price, run_search)
from repro_torch.search.pareto import best_under_budget  # noqa: E402
from repro_torch.search.pricing import (CANDIDATE, PRUNED_STAR,  # noqa: E402
                                        PRUNED_WIRE)
from repro_torch.search import space as tspace  # noqa: E402
from repro_torch.search.space import merge_points  # noqa: E402

CFG = PaperExperimentConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# topology names (core/topology.from_name / named_topologies)
# ---------------------------------------------------------------------------

def test_from_name_round_trips():
    assert topology_lib.from_name("star(5)").num_views() == 5
    assert topology_lib.from_name("chain(3)").num_views() == 3
    assert topology_lib.from_name("tree(2,2)").num_views() == 6


@pytest.mark.parametrize("bad", ["ring(4)", "star", "star(0)", "tree(2)",
                                 "chain(2,2)", "star(2,3)", ""])
def test_from_name_rejects(bad):
    with pytest.raises(ValueError):
        topology_lib.from_name(bad)


def test_named_topologies():
    topos = topology_lib.named_topologies(6)
    assert "star(6)" in topos and "chain(6)" in topos
    assert "tree(2,2)" in topos
    assert list(topology_lib.named_topologies(1)) == ["star(1)"]
    for name, topo in topology_lib.named_topologies(9).items():
        assert topo.num_views() == 9
        assert topology_lib.from_name(name).num_views() == 9


# ---------------------------------------------------------------------------
# the space
# ---------------------------------------------------------------------------

def _structural_space(pkg):
    return pkg.SearchSpace(schemes=("inl", "fl", "sl"),
                           topologies=("star(3)", "chain(3)"),
                           link_bits=(4, 32), wires=("dense", "packed"))


def test_space_structural_rejections():
    space = _structural_space(tspace)
    keys = {p.key for p in space.points()}
    assert "inl/chain(3)/q4/packed/dfull" in keys
    assert "inl/star(3)/q32/packed/dfull" not in keys
    assert not any(k.startswith("fl/chain") or k.startswith("sl/chain")
                   for k in keys)
    assert [k for k in keys if k.startswith("fl/")] == \
        ["fl/star(3)/q32/dense/dfull"]
    assert not any(k.startswith("sl/") and "/q4/" in k for k in keys)
    reasons = {p.key: r for p, r in space.excluded()}
    assert "star topology" in reasons["fl/chain(3)/q32/dense/dfull"]
    assert "fp32" in reasons["fl/star(3)/q4/dense/dfull"]


def test_points_and_exclusions_equal_the_reference():
    spaces = [_structural_space(jspace), _structural_space(tspace)]
    (jpts, jexc), (tpts, texc) = ((s.points(), s.excluded()) for s in spaces)
    assert [p.key for p in tpts] == [p.key for p in jpts]
    assert [(p.key, r) for p, r in texc] == [(p.key, r) for p, r in jexc]
    assert [dataclasses.astuple(p) for p in tpts] == \
        [dataclasses.astuple(p) for p in jpts]


def test_cut_depth_only_for_hybrids():
    space = SearchSpace(schemes=("inl", "splitfed"), topologies=("star(3)",),
                        cut_depths=(None, 1))
    keys = {p.key for p in space.points()}
    assert keys == {"inl/star(3)/q32/dense/dfull",
                    "splitfed/star(3)/q32/dense/dfull",
                    "splitfed/star(3)/q32/dense/d1"}


def test_resolve_adapts_clients_and_noise():
    p = ConfigPoint("inl", "tree(2,2)", link_bits=8, wire="packed")
    cfg, topo = p.resolve(CFG)
    assert cfg.num_clients == 6 and topo is not None
    assert cfg.noise_stds == tuple(CFG.noise_stds[j % len(CFG.noise_stds)]
                                   for j in range(6))
    assert cfg.link_bits == 8
    star = ConfigPoint("inl", f"star({CFG.num_clients})")
    cfg2, topo2 = star.resolve(CFG)
    assert topo2 is None
    assert cfg2.noise_stds == CFG.noise_stds
    hash(p)                                    # hashable, JSON-able fields
    assert dataclasses.asdict(p)["topology"] == "tree(2,2)"


# ---------------------------------------------------------------------------
# pricing and pruning
# ---------------------------------------------------------------------------

def _price(points):
    return price(points, CFG, batch_size=BATCH, train_n=CFG.dataset_size)


def test_wire_equivalence_prunes_to_dense_rep():
    priced = _price(SearchSpace(schemes=("inl",), topologies=("star(3)",),
                                link_bits=(4,),
                                wires=("dense", "packed")).points())
    by = {pp.key: pp for pp in priced}
    dense = by["inl/star(3)/q4/dense/dfull"]
    packed = by["inl/star(3)/q4/packed/dfull"]
    assert dense.status == CANDIDATE
    assert packed.status == PRUNED_WIRE and packed.stand_in == dense.key
    assert packed.round_bits == dense.round_bits
    assert packed.round_nbytes < dense.round_nbytes


def test_star_dominance_prunes_q32_graphs_only():
    priced = _price(merge_points(
        SearchSpace(schemes=("inl",), topologies=("star(3)", "chain(3)")),
        SearchSpace(schemes=("inl",), topologies=("star(3)", "chain(3)"),
                    link_bits=(4,), wires=("packed_duplex",))))
    by = {pp.key: pp for pp in priced}
    chain32 = by["inl/chain(3)/q32/dense/dfull"]
    assert chain32.status == PRUNED_STAR
    assert chain32.stand_in == "inl/star(3)/q32/dense/dfull"
    assert chain32.round_bits > by[chain32.stand_in].round_bits
    assert by["inl/chain(3)/q4/packed_duplex/dfull"].status == CANDIDATE


def test_no_star_sibling_no_prune():
    priced = _price(SearchSpace(schemes=("inl",),
                                topologies=("chain(3)",)).points())
    assert priced[0].status == CANDIDATE


def _views(cfg, n):
    imgs, labels = multiview.make_base_dataset(
        n, image_shape=cfg.image_shape, seed=0)
    return multiview.make_views(imgs, cfg.noise_stds), labels


def test_pricing_matches_meter_exactly():
    pp = _price([ConfigPoint("inl", f"star({CFG.num_clients})")])[0]
    views, labels = _views(CFG, CFG.dataset_size)
    meter = bandwidth.BandwidthMeter()
    curve = runner.run_scheme(
        "inl", views, labels, pp.cfg, epochs=1, batch_size=BATCH,
        eval_n=64, meter=meter, topology=pp.topology, wire=pp.point.wire,
        device="cpu")
    assert meter.total_bits == pp.epoch_bits()
    assert meter.measured_bytes == pp.epoch_nbytes()
    assert curve[-1].gbits == pp.total_gbits(1)


def test_rounds_per_epoch_rule_is_shared():
    scheme = schemes.get("inl")
    n = CFG.dataset_size
    assert runner.rounds_per_epoch(scheme, CFG, n, BATCH) == \
        (n // BATCH) // scheme.batches_per_round(CFG)
    pp = _price([ConfigPoint("inl", f"star({CFG.num_clients})")])[0]
    assert pp.rounds_per_epoch == \
        runner.rounds_per_epoch(scheme, pp.cfg, n, BATCH)
    fl = _price([ConfigPoint("fl", f"star({CFG.num_clients})")])[0]
    assert fl.rounds_per_epoch == (n // BATCH) // 10


def test_price_equals_the_reference_on_the_smoke_grid():
    """frontier_bench's smoke grid at its SMOKE widths: every point's key,
    status, stand-in, rounds, priced bits and wire bytes exactly."""
    jcfg = frontier_bench.SMOKE_CFG
    tcfg = PaperExperimentConfig(**dataclasses.asdict(jcfg))
    jpoints = frontier_bench.build_grid(smoke=True)
    tpoints = [ConfigPoint(*dataclasses.astuple(p)) for p in jpoints]
    batch, train_n = 32, (jcfg.dataset_size // 32) * 32
    want = jsearch.price(jpoints, jcfg, batch_size=batch, train_n=train_n)
    got = price(tpoints, tcfg, batch_size=batch, train_n=train_n)
    assert len(got) == len(want) == 14

    def row(pp):
        return (pp.key, pp.status, pp.stand_in, pp.rounds_per_epoch,
                pp.round_bits, pp.round_nbytes, pp.overhead_bits,
                pp.overhead_nbytes, pp.epoch_bits(), pp.epoch_nbytes(),
                pp.total_gbits(2))
    assert [row(pp) for pp in got] == [row(pp) for pp in want]
    assert [pp.record() for pp in got] == [pp.record() for pp in want]
    assert {pp.status for pp in got} == {CANDIDATE, PRUNED_STAR}


# ---------------------------------------------------------------------------
# pareto
# ---------------------------------------------------------------------------

class P:
    def __init__(self, key, accuracy, gbits):
        self.key, self.accuracy, self.gbits = key, accuracy, gbits


def test_dominates_weak_both_strict_one():
    assert dominates(P("a", 0.9, 1.0), P("b", 0.8, 1.0))
    assert dominates(P("a", 0.9, 0.5), P("b", 0.9, 1.0))
    assert not dominates(P("a", 0.9, 1.0), P("b", 0.9, 1.0))
    assert not dominates(P("a", 0.9, 2.0), P("b", 0.8, 1.0))


def test_pareto_frontier_extraction():
    pts = [P("cheap", 0.5, 0.1), P("mid", 0.8, 1.0), P("best", 0.9, 5.0),
           P("dominated", 0.7, 2.0), P("dup-mid", 0.8, 1.0),
           P("worse-same-cost", 0.6, 1.0)]
    front = pareto_frontier(pts)
    assert [p.key for p in front] == ["cheap", "mid", "dup-mid", "best"]
    for f in front:
        assert not any(dominates(q, f) for q in pts)


def test_best_under_budget():
    pts = [P("cheap", 0.5, 0.1), P("best", 0.9, 5.0)]
    assert best_under_budget(pts, 1.0).key == "cheap"
    assert best_under_budget(pts, 10.0).key == "best"
    assert best_under_budget(pts, 0.01) is None


def test_pareto_picks_equal_the_reference():
    rng = np.random.default_rng(0)
    # coarse values so that ties on either axis occur
    pts = [P(f"p{i}", float(rng.integers(0, 8)) / 8,
             float(rng.integers(1, 10)) / 4) for i in range(60)]
    assert [p.key for p in pareto_frontier(pts)] == \
        [p.key for p in jpareto.pareto_frontier(pts)]
    for budget in (0.1, 0.25, 0.5, 1.0, 1.75, 2.5, 10.0):
        t, j = best_under_budget(pts, budget), \
            jpareto.best_under_budget(pts, budget)
        assert (t and t.key) == (j and j.key)
    assert [dominates(a, b) for a in pts[:12] for b in pts[:12]] == \
        [jpareto.dominates(a, b) for a in pts[:12] for b in pts[:12]]


# ---------------------------------------------------------------------------
# the driver, end to end
# ---------------------------------------------------------------------------

def test_run_search_end_to_end():
    base = dataclasses.replace(CFG, dataset_size=64)
    logs = []
    result = run_search(
        [ConfigPoint("inl", "star(3)"),
         ConfigPoint("inl", "star(3)", link_bits=4, wire="packed_duplex"),
         ConfigPoint("inl", "chain(3)")],
        base, epochs=1, batch_size=BATCH, eval_n=32, train_pruned=True,
        log=logs.append, device="cpu")
    assert logs[0] == ("search: 3 valid points, 1 pruned by ledger, "
                       "training 3")
    assert len(result.candidates()) == 2
    for m in result.measured.values():
        assert m.trained
        assert m.gbits == m.priced_gbits
        assert m.measured_gbits == m.priced_measured_gbits
    pruned = result.measured["inl/chain(3)/q32/dense/dfull"]
    star = result.measured["inl/star(3)/q32/dense/dfull"]
    assert pruned.status == PRUNED_STAR and pruned.stand_in == star.key
    assert pruned.accuracy == star.accuracy
    assert pruned.gbits > star.gbits
    assert result.frontier
    for m in result.frontier:
        assert m.status == CANDIDATE and m.trained
    rec = result.record()
    assert [g["key"] for g in rec["grid"]] == [pp.key for pp in
                                               result.priced]


def test_run_search_inherits_the_stand_in_when_pruned_points_skip():
    base = dataclasses.replace(CFG, dataset_size=64)
    result = run_search(
        [ConfigPoint("inl", "star(3)"), ConfigPoint("inl", "chain(3)")],
        base, epochs=1, batch_size=BATCH, eval_n=32, log=lambda *a: None,
        device="cpu")
    pruned = result.measured["inl/chain(3)/q32/dense/dfull"]
    assert not pruned.trained
    assert pruned.accuracy == \
        result.measured["inl/star(3)/q32/dense/dfull"].accuracy
    assert pruned.gbits == pruned.priced_gbits > \
        result.measured[pruned.stand_in].gbits
    assert [m.key for m in result.frontier] == \
        ["inl/star(3)/q32/dense/dfull"]
