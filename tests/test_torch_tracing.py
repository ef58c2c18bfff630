"""The port's own measurement (repro_torch/tracing.py).

  * under `torch.profiler` one paper INL round, one FL round and one INL
    step over the smoke LLM emit the spans "repro.forward",
    "repro.backward" and "repro.optimizer" in that order, a triple a
    local step; `prefetch_to_device` emits "repro.feed.wait" and
    "repro.feed.copy" (the producer's thread under a profiler of all
    threads);
  * without a profiler no span is entered on those paths;
  * a round's parameters are bit for bit the same under the profiler;
  * the phase marks' units, sums, "other", profiled flags and allocator
    retries, and a graph's harvest once a replay, on a fake event clock;
    a capture takes its launches back and each replay adds them;
  * on the card only (skipped here): a captured two-phase toy round's
    graph-node marks against CUDA events around the same replays; graphed
    INL and FL rounds, whose calls end on the graph with marks, against
    eager rounds bit for bit.

No JAX here: the card's test runs from this file.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing, tree_leaves  # noqa: E402
from repro_torch.configs.paper_inl import PaperExperimentConfig  # noqa: E402
from repro_torch.core import inl_llm, schemes  # noqa: E402
from repro_torch.core.schemes import runner  # noqa: E402
from repro_torch.data import multiview, prefetch  # noqa: E402
from repro_torch.kernels import inl_bottleneck  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402

CFG = PaperExperimentConfig(conv_channels=(4,), d_bottleneck=8,
                            dense_units=(32,), image_shape=(16, 16, 3),
                            dataset_size=128)
BATCH = 8
TRIPLE = ["repro.forward", "repro.backward", "repro.optimizer"]
CUDA = torch.device("cuda")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the H100")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_marks():
    tracing.reset()
    yield
    tracing.reset()


def _repro_spans(prof):
    events = [e for e in prof.events() if e.name.startswith("repro.")]
    events.sort(key=lambda e: e.time_range.start)
    return [e.name for e in events]


def _profiled(fn, **kw):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, **kw) as prof:
        out = fn()
    return out, _repro_spans(prof)


def _paper_round(name, seed=0):
    """(run, state): run() trains one round of scheme `name` on CFG from
    the state seeded by `seed`, on the CPU."""
    scheme = schemes.get(name)
    imgs, labels = multiview.make_base_dataset(
        64 * 4, image_shape=CFG.image_shape, seed=0)
    views = torch.as_tensor(multiview.make_views(imgs, CFG.noise_stds))
    labels = torch.as_tensor(labels)
    bpr = scheme.batches_per_round(CFG)
    ep_views, ep_labels = runner.epoch_batches(views, labels, 0, 1, bpr,
                                               BATCH)
    state = scheme.init(CFG, torch.Generator().manual_seed(seed), lr=1e-3,
                        device="cpu")
    epoch = scheme.make_epoch(CFG, lr=1e-3)

    def run():
        return epoch(state, ep_views[:1], ep_labels[:1],
                     torch.Generator().manual_seed(seed + 1))
    return run, bpr


def _llm_step():
    args = train.parse_args(["--arch", "llama3.2-1b", "--smoke", "--scheme",
                             "inl", "--batch", "2", "--seq", "16",
                             "--device", "cpu"])
    cfg = train.model_config(args)
    params = inl_llm.init(cfg, 0, device="cpu")
    from repro_torch import optim
    opt = optim.adamw(1e-3, weight_decay=0.1)
    step = steps.make_inl_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    state = opt.init(params)

    def run():
        return step(params, state, batch, torch.Generator().manual_seed(1))
    return run


# -- spans ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["inl", "fl"])
def test_paper_round_emits_the_phases_in_order(name):
    run, bpr = _paper_round(name)
    _, spans = _profiled(run)
    local_steps = bpr if name == "fl" else 1
    assert spans == TRIPLE * local_steps


def test_llm_inl_step_emits_the_phases_in_order():
    _, spans = _profiled(_llm_step())
    assert spans == TRIPLE


def test_prefetch_emits_the_feed_spans():
    items = ({"x": np.full((3,), i, np.float32)} for i in range(3))

    def drain():
        return [b["x"].tolist() for b in
                prefetch.prefetch_to_device(items, size=2, device="cpu")]
    from torch._C._profiler import _ExperimentalConfig
    got, spans = _profiled(drain, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))
    assert got == [[i] * 3 for i in range(3)]
    assert spans.count("repro.feed.copy") == 3
    assert spans.count("repro.feed.wait") == 4      # 3 items and the end


def test_no_span_without_a_profiler(monkeypatch):
    entered = []
    real = tracing._RecordFunctionFast

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(tracing, "_RecordFunctionFast", counting)
    for name in ("inl", "fl"):
        _paper_round(name)[0]()
    _llm_step()()
    assert entered == []
    assert tracing.span("graph.replay") is tracing.span("feed.wait")


def test_round_is_bit_identical_under_the_profiler():
    plain, _ = _paper_round("inl")[0]()
    (traced, _), spans = _profiled(_paper_round("inl")[0])
    assert spans == TRIPLE
    for a, b in zip(tree_leaves(plain), tree_leaves(traced)):
        assert torch.equal(a, b)


# -- marks on a fake event clock --------------------------------------------

class _Event:
    def __init__(self, clock, t):
        self.clock, self.t = clock, t

    def query(self):
        return self.t is not None and self.t <= self.clock.done

    def elapsed_time(self, other):
        return other.t - self.t


class _Clock:
    """Device time `now` (ms), advanced by hand; events up to `done` have
    run; inside a capture an event gets its time at a replay."""

    def __init__(self):
        self.now, self.done = 0.0, float("inf")
        self.capture, self.count = False, 0

    def event(self, device, external=False):
        assert external == self.capture
        return _Event(self, None if self.capture else self.now)

    def capturing(self, device):
        return self.capture

    def retries(self, device):
        return self.count


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(tracing, "_clock", c)
    return c


def _phase(clock, name, ms, gap=0.0, retries=0):
    with tracing.phase(name, CUDA):
        clock.now += ms
        clock.count += retries
    clock.now += gap


def test_eager_steps_group_into_units(clock):
    # step 1: 2 + 3 + 1 ms, 0.5 ms between backward and optimizer
    _phase(clock, "forward", 2.0)
    _phase(clock, "backward", 3.0, gap=0.5, retries=2)
    _phase(clock, "optimizer", 1.0, gap=4.0)
    # step 2, profiled: two updates (SL's client and server)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _phase(clock, "forward", 1.0)
    _phase(clock, "backward", 1.0)
    _phase(clock, "optimizer", 1.0, gap=0.25)
    _phase(clock, "optimizer", 0.5, gap=4.0)
    # step 3: two microbatches, then one update
    for _ in range(2):
        _phase(clock, "forward", 1.5)
        _phase(clock, "backward", 2.5, retries=1)
    _phase(clock, "optimizer", 1.0)
    clock.done = 15.0                       # step 3 has not run yet
    got = tracing.samples()
    assert [s.kind for s in got] == ["eager", "eager"]
    clock.done = float("inf")
    got = tracing.samples()
    assert [s.profiled for s in got] == [False, True, False]
    want = [dict(forward=2.0, backward=3.0, optimizer=1.0, unit=6.5,
                 other=0.5),
            dict(forward=1.0, backward=1.0, optimizer=1.5, unit=3.75,
                 other=0.25),
            dict(forward=3.0, backward=5.0, optimizer=1.0, unit=9.0,
                 other=0.0)]
    assert [s.ms for s in got] == pytest.approx(want)
    assert [s.alloc_retries for s in got] == [2, 0, 2]
    split = tracing.summary("eager")
    assert split["n"] == 2 and split["forward"] == pytest.approx(2.5)
    assert split["alloc_retries"] == pytest.approx(2.0)
    assert tracing.summary("graph") is None
    assert tracing.samples(since=2) == got[2:]


def test_cursor_counts_the_samples_made_after_it(clock):
    _phase(clock, "forward", 1.0)
    _phase(clock, "optimizer", 1.0)
    _phase(clock, "forward", 1.0)           # closes the first step
    mark = tracing.cursor()
    assert mark == 1
    _phase(clock, "optimizer", 2.0)
    later = tracing.samples(since=mark)
    assert len(later) == 1 and later[0].ms["unit"] == pytest.approx(3.0)


def test_marks_off_and_the_cpu_record_nothing(clock, monkeypatch):
    with tracing.phase("forward", torch.device("cpu")):
        pass
    monkeypatch.setattr(tracing, "MARKS", False)
    _phase(clock, "forward", 1.0)
    _phase(clock, "optimizer", 1.0)
    assert tracing.samples() == []


def _replay(rec, clock, times):
    """One replay of a captured record: its events' device times, in the
    order they were recorded (the unit's start, the marks', its end)."""
    events = [rec.bounds[0]] + [e for _, s, t in rec.marks
                                for e in (s, t)] + [rec.bounds[1]]
    for e, t in zip(events, times):
        e.t = t
    rec.replayed()


def test_a_graph_gives_one_sample_a_harvest(clock):
    before = dict(inl_bottleneck.LAUNCHES)
    clock.capture = True
    with tracing.capture() as rec:
        with tracing.unit(CUDA):
            _phase(clock, "forward", 0)
            inl_bottleneck.LAUNCHES["cut_fwd"] += 3
            _phase(clock, "backward", 0)
            _phase(clock, "optimizer", 0)
    clock.capture = False
    assert inl_bottleneck.LAUNCHES == before
    assert rec.launches == [(inl_bottleneck.LAUNCHES, {"cut_fwd": 3})]
    tracing.harvest()
    assert tracing.samples() == []          # captured, never replayed
    owner = type("Owner", (), {})()
    rec.owned_by(owner)
    # unit 0-10: forward 1-3, backward 3-7, optimizer 7-8, FedAvg after
    _replay(rec, clock, [0, 1, 3, 3, 7, 7, 8, 10])
    assert inl_bottleneck.LAUNCHES["cut_fwd"] == before["cut_fwd"] + 3
    _replay(rec, clock, [20, 21, 22, 22, 24, 24, 25, 26])
    tracing.harvest()
    tracing.harvest()                       # nothing new replayed
    got = tracing.samples()
    assert len(got) == 1 and got[0].kind == "graph"
    assert got[0].ms == pytest.approx(dict(forward=1.0, backward=2.0,
                                           optimizer=1.0, unit=6.0,
                                           other=2.0))
    assert got[0].alloc_retries is None and not got[0].profiled
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _replay(rec, clock, [30, 31, 32, 32, 33, 33, 34, 35])
    del owner
    gc.collect()
    assert tracing.samples()[-1].profiled
    assert tracing._state.graphs == []      # its graph is gone, harvested
    inl_bottleneck.LAUNCHES.update(before)


def test_a_failed_capture_takes_its_launches_back(clock):
    before = dict(inl_bottleneck.LAUNCHES)
    clock.capture = True
    with pytest.raises(RuntimeError):
        with tracing.capture():
            _phase(clock, "forward", 0)
            inl_bottleneck.LAUNCHES["cut_bwd"] += 1
            raise RuntimeError("capture failed")
    clock.capture = False
    assert inl_bottleneck.LAUNCHES == before
    assert tracing._state.graphs == []


def test_step_split_line():
    assert train.step_split(None, torch.device("cpu")) \
        == "step split: not measured on cpu"
    line = train.step_split(dict(forward=1.0, backward=2.25, optimizer=3.0,
                                 other=0.5, alloc_retries=0.0, n=7),
                            torch.device("cuda"))
    assert line == ("step split (median of 7 steps, device ms): forward 1.0 "
                    "backward 2.2 optimizer 3.0 other 0.5; alloc retries "
                    "0.00 a step")


# -- on the card ------------------------------------------------------------

def test_graph_marks_match_outer_events_on_cuda(cuda_device):
    """A captured toy round of two phases (4096^2 fp32 matmuls, ~2 ms
    each): its marks, summed over 20 replays harvested one by one, within
    5% of CUDA events around the same replays."""
    from repro_torch import graphs
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4096, 4096, device=cuda_device, generator=gen)
    b = torch.randn(4096, 4096, device=cuda_device, generator=gen)

    def round_():
        with tracing.unit(cuda_device):
            with tracing.phase("forward", cuda_device):
                h = a @ b
            with tracing.phase("backward", cuda_device):
                out = h @ b
        return out
    graphs.warm_up(round_)
    cache = graphs.GraphCache()
    graph = cache.capture("toy", round_)
    graph.replay()
    torch.cuda.synchronize()
    tracing.harvest()
    n0 = tracing.cursor()
    outer = 0.0
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        outer += start.elapsed_time(end)
        tracing.harvest()
    got = [s for s in tracing.samples(since=n0) if s.kind == "graph"]
    assert len(got) == 20
    marks = sum(s.ms["forward"] + s.ms["backward"] for s in got)
    units = sum(s.ms["unit"] for s in got)
    assert abs(marks - outer) <= 0.05 * outer, (marks, outer)
    assert abs(units - outer) <= 0.05 * outer, (units, outer)


@pytest.mark.parametrize("name", ["inl", "fl"])
def test_marked_twin_rounds_equal_eager_on_cuda(cuda_device, name):
    """Seven graphed rounds in two calls (each call's last round replays
    the graph with marks, the others the graph without) == seven eager
    rounds bit for bit; one capture a signature is counted, and the two
    calls give two graph samples."""
    scheme = schemes.get(name)
    bpr = scheme.batches_per_round(CFG)
    imgs, labels = multiview.make_base_dataset(
        7 * bpr * BATCH, image_shape=CFG.image_shape, seed=0)
    views = torch.as_tensor(multiview.make_views(imgs, CFG.noise_stds))
    v, lab = runner.epoch_batches(views.to(cuda_device),
                                  torch.as_tensor(labels).to(cuda_device),
                                  0, 7, bpr, BATCH)

    def init():
        return scheme.init(CFG, torch.Generator(device=cuda_device)
                           .manual_seed(0), lr=1e-3, device=cuda_device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        epoch_fn = scheme.make_epoch(CFG, lr=1e-3)
        g = torch.Generator(device=cuda_device).manual_seed(1)
        st, m1 = epoch_fn(init(), v[:4], lab[:4], g)
        torch.cuda.synchronize()           # the next call harvests it
        st_g, m2 = epoch_fn(st, v[4:], lab[4:], g)
        st_g = [t.clone() for t in tree_leaves(st_g)]
        round_fn = scheme.make_round(CFG, lr=1e-3)
        g = torch.Generator(device=cuda_device).manual_seed(1)
        st_e, losses = init(), []
        for k in range(7):
            st_e, m = round_fn(st_e, v[k], lab[k], g)
            losses.append(m["loss"])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert list(epoch_fn.captures.values()) == [1]   # one signature
    assert torch.equal(torch.cat([m1["loss"], m2["loss"]]),
                       torch.stack(losses))
    for a, b in zip(st_g, tree_leaves(st_e)):
        assert torch.equal(a, b)
    got = [s for s in tracing.samples() if s.kind == "graph"]
    assert len(got) == 2, got
    for s in got:
        assert s.ms["forward"] > 0 and s.ms["backward"] > 0
        assert s.ms["optimizer"] > 0 and s.ms["other"] >= 0
