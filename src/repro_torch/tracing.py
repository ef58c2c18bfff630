"""What the port measures of itself: phase marks timed on the device, host
spans on the profiler's clock, and counters.

Phase marks.  `with phase("forward", device):` around one of a training
step's three phases, "forward", "backward" and "optimizer"
(`common.value_and_grad` marks the first two, the optimizers' `update` the
third, so every training path of the port is marked).  On a CUDA device a
mark records a timing `torch.cuda.Event` on the current stream at entry
and one at exit.  Inside a CUDA graph's capture the events are `external`,
so each record becomes an event-record node of the graph and every replay
records it again; `capture(marks=False)` leaves them out.  On any other
device a mark records nothing.  A mark never synchronises, reads no tensor
and changes no result.

Marks are summed by unit:

    an eager step     from its first `forward` to the end of its last
                      `optimizer` (a `forward` after an `optimizer` opens
                      the next step); its events are read once its last
                      one is done, when the next step opens or on a read
    a graphed round   one replay of a graph captured with marks; the
                      captured function puts `with unit(device):` around
                      itself to bound it, so what the round does outside
                      the three phases (the FedAvg, the state copies) is
                      its "other".  A replay overwrites the graph's
                      events, so a graph gives one sample a `harvest()`

Each event node adds ~6-7 us to a replay on the H100, 0.4-0.8% of a paper
round that is launch-bound, so the schemes' epoch loop
(`core/schemes/base.py`) captures each round twice: once without marks,
replayed for every round, and once with them, replayed for a signature's
last round of each epoch call; the loop harvests at each epoch's start
and a read does.  That is the sample a graph can give in any case.

Sub-marks.  `with submark("ssd_backward", device):` times a part of a
phase of an eager step on the card (the SSD backward recompute inside
"backward", `models/ssm.py`); the step's sample sums each sub-mark under
its name in `ms`.  A sub-mark is no phase: it enters neither the phases'
sum nor "other", and inside a capture or off the card it records nothing.

`samples()` returns one `Sample` a unit: the device ms of each phase,
summed over the unit, the unit's ms, "other" (the unit less its phases),
whether a profiler was recording when the unit was launched (a profiler
slows an eager step at S=4096 up to twofold, so a median leaves those
out), and for an eager step on the card the allocator's retries
(`num_alloc_retries`) over it.  `summary()` gives their medians.

Host spans.  `with span("graph.replay"):` records the host range
"repro.graph.replay" while a profiler records (`recording()`), and
otherwise costs that check; a phase mark opens its phase's span
("repro.forward", ...) as well.  Spans sit on the profiler's clock, which
the device timeline shares, so an idle gap of a trace can be put down to
the program's layer.  A span is a host op (`_RecordFunctionFast`), not a
`record_function` user annotation: the profiler copies an annotation that
encloses kernels onto the device's timeline, where a reader of device
events that does not know its kind would count it as work.  A span in a
thread other than the one the profiler was started in is recorded only
under a profiler that profiles all threads
(`_ExperimentalConfig(profile_all_threads=True)`).

Launch counters.  The hand-written kernels' `LAUNCHES` dicts are made by
`launch_counter` and kept here.  `capture()` is the bookkeeping of a CUDA
graph's capture (`graphs.GraphCache.capture`): it takes back what the
capture counted (a capture launches nothing), collects the marks made in
it, and hands back a `Captured`, whose `replayed()` adds the launches
again and flags the marks for the next harvest.

`MARKS` and `SPANS` switch marks and spans off, to measure what they cost.
"""
from __future__ import annotations

import collections
import contextlib
import statistics
import threading
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PHASES = ("forward", "backward", "optimizer")
MAX_SAMPLES = 100_000      # the newest kept
MAX_PENDING = 256          # eager steps whose events are not done yet
MAX_STEP_MARKS = 4096      # a step that never reaches its optimizer

MARKS = True
SPANS = True


class Sample(NamedTuple):
    kind: str                       # "eager" (a step) or "graph" (a replay)
    profiled: bool                  # a profiler recorded at its launch
    ms: Dict[str, float]            # PHASES, "unit", "other" and the
                                    # sub-marks made: device ms
    alloc_retries: Optional[int]    # the allocator's retries (eager, card)


class _CudaClock:
    """The card's side of a mark: an event recorded on the current stream,
    the capture state, the allocator's retry count."""

    @staticmethod
    def event(device, *, external: bool = False):
        ev = torch.cuda.Event(enable_timing=True, external=external)
        ev.record(torch.cuda.current_stream(device))
        return ev

    @staticmethod
    def capturing(device) -> bool:
        return torch.cuda.is_current_stream_capturing()

    @staticmethod
    def retries(device) -> int:
        return torch.cuda.memory_stats_as_nested_dict(device).get(
            "num_alloc_retries", 0)


_clock = _CudaClock()
_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records: the process-wide flag every profiler
    sets (a profiler of all threads leaves the thread's own unset), or
    this thread's."""
    return getattr(_profiler, "_is_profiler_enabled", False) \
        or torch.autograd._profiler_enabled()


def span(name: str):
    """The span "repro.<name>" while a profiler records."""
    if SPANS and recording():
        return _RecordFunctionFast("repro." + name)
    return _NO_SPAN


class _Step:
    """An eager step: its marks and sub-marks (name, start event, end
    event)."""
    __slots__ = ("marks", "submarks", "profiled", "retries0", "retries",
                 "optimized")

    def __init__(self, profiled: bool, retries0: Optional[int]):
        self.marks: list = []
        self.submarks: list = []
        self.profiled = profiled
        self.retries0 = retries0
        self.retries: Optional[int] = None
        self.optimized = False


class Captured:
    """What one CUDA graph's capture recorded: the kernels' launches (a
    list of (counter dict, {kernel: count})) and the marks made in it,
    with the unit's bounds where the captured function set them."""

    def __init__(self):
        self.launches: list = []
        self.marks: list = []
        self.bounds = None
        self.profiled = False
        self.pending = False       # replayed since the last harvest
        self.owned = True          # its graph is alive

    def replayed(self) -> None:
        """One replay: add the launches again; flag the marks."""
        for counts, added in self.launches:
            for name, n in added.items():
                counts[name] += n
        if self.marks:
            self.pending = True
            self.profiled = recording()

    def owned_by(self, graph) -> None:
        """Keep the marks readable until `graph` is gone and its last
        replay harvested."""
        if self.marks:
            weakref.finalize(graph, setattr, self, "owned", False)


class _State:
    def __init__(self):
        self.lock = threading.RLock()
        self.step: Optional[_Step] = None
        self.pending: List[_Step] = []       # closed steps, events not read
        self.graphs: List[Captured] = []     # captures with marks
        self.collector: Optional[Captured] = None
        self.samples: collections.deque = collections.deque(
            maxlen=MAX_SAMPLES)
        self.made = 0                        # samples ever made

    def add(self, sample: Sample) -> None:
        self.samples.append(sample)
        self.made += 1


_state = _State()
_COUNTERS: List[Dict[str, int]] = []


def launch_counter(names) -> Dict[str, int]:
    """{kernel: 0} for a kernel module's `LAUNCHES`, registered so that a
    graph's capture takes its counts back and each replay adds them."""
    counts = {name: 0 for name in names}
    _COUNTERS.append(counts)
    return counts


def _sample(kind, profiled, marks, bounds, retries, submarks=()) -> Sample:
    ms = dict.fromkeys(PHASES, 0.0)
    for name, start, end in marks:
        ms[name] += start.elapsed_time(end)
    first, last = bounds or (marks[0][1], marks[-1][2])
    ms["unit"] = first.elapsed_time(last)
    ms["other"] = ms["unit"] - sum(ms[p] for p in PHASES)
    for name, start, end in submarks:
        ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
    return Sample(kind, profiled, ms, retries)


def _close_step() -> None:
    step, _state.step = _state.step, None
    if step is not None and step.marks:
        _state.pending.append(step)
        del _state.pending[:-MAX_PENDING]


def _resolve() -> None:
    """Turn the closed steps whose last event is done into samples."""
    left = []
    for step in _state.pending:
        if left or not step.marks[-1][2].query():
            left.append(step)
            continue
        _state.add(_sample("eager", step.profiled, step.marks, None,
                           step.retries, step.submarks))
    _state.pending = left


@contextlib.contextmanager
def phase(name: str, device):
    """Mark one phase of a training step (one of PHASES) on `device`."""
    with span(name):
        if not MARKS or device.type != "cuda":
            yield
            return
        with _state.lock:
            start = _enter(name, device)
        yield
        if start is None:
            return
        with _state.lock:
            _exit(name, device, start)


def _enter(name, device):
    if _clock.capturing(device):
        if _state.collector is None:
            return None
        return _clock.event(device, external=True)
    step = _state.step
    if step is None or (name == "forward" and step.optimized):
        _close_step()
        _resolve()
        _state.step = _Step(recording(), _clock.retries(device))
    return _clock.event(device)


def _exit(name, device, start) -> None:
    if _clock.capturing(device):
        _state.collector.marks.append(
            (name, start, _clock.event(device, external=True)))
        return
    end = _clock.event(device)
    step = _state.step
    if step is None:          # read while the phase ran: its own step
        step = _state.step = _Step(recording(), None)
    step.marks.append((name, start, end))
    if name == "optimizer":
        step.optimized = True
        if step.retries0 is not None:
            step.retries = _clock.retries(device) - step.retries0
    if len(step.marks) >= MAX_STEP_MARKS:
        _close_step()


@contextlib.contextmanager
def submark(name: str, device):
    """Time a part of the open eager step's current phase on `device` (a
    CUDA device outside a capture; elsewhere it records nothing)."""
    if not MARKS or device.type != "cuda" or _clock.capturing(device):
        yield
        return
    start = _clock.event(device)
    yield
    end = _clock.event(device)
    with _state.lock:
        if _state.step is not None:
            _state.step.submarks.append((name, start, end))


@contextlib.contextmanager
def unit(device):
    """Bound a graphed round: the captured function runs inside.  Outside
    a capture with marks it records nothing."""
    if not MARKS or device.type != "cuda" or not _clock.capturing(device) \
            or _state.collector is None:
        yield
        return
    start = _clock.event(device, external=True)
    yield
    _state.collector.bounds = (start, _clock.event(device, external=True))


@contextlib.contextmanager
def capture(*, marks: bool = True):
    """Around a CUDA graph's capture: yields the `Captured` that collects
    the capture's marks (none with marks=False) and, at exit, the launches
    it counted, which are taken back from the counters (also when the
    capture raises)."""
    before = [dict(c) for c in _COUNTERS]
    rec = Captured()
    outer, _state.collector = _state.collector, rec if marks else None
    ok = False
    try:
        yield rec
        ok = True
    finally:
        _state.collector = outer
        # a counter registered during the capture started from nothing
        before += [{}] * (len(_COUNTERS) - len(before))
        for counts, old in zip(_COUNTERS, before):
            added = {k: n - old.get(k, 0) for k, n in counts.items()
                     if n != old.get(k, 0)}
            for k in added:
                counts[k] = old.get(k, 0)
            if added:
                rec.launches.append((counts, added))
        if ok and rec.marks:
            with _state.lock:
                _state.graphs.append(rec)


def harvest() -> None:
    """Read what is done: the closed eager steps, and each marked graph's
    last replay since the previous harvest."""
    with _state.lock:
        _resolve()
        kept = []
        for rec in _state.graphs:
            end = rec.bounds[1] if rec.bounds else rec.marks[-1][2]
            if rec.pending and end.query():
                rec.pending = False
                _state.add(_sample("graph", rec.profiled, rec.marks,
                                   rec.bounds, None))
            if rec.pending or rec.owned:
                kept.append(rec)
        _state.graphs = kept


def cursor() -> int:
    """The number of samples made so far: `samples(since=cursor())` later
    gives those made after this point."""
    harvest()
    return _state.made


def samples(since: int = 0) -> List[Sample]:
    """Every sample made (the newest MAX_SAMPLES), or those made after
    `cursor()` read `since`.  A read closes an eager step that has passed
    its optimizer and harvests."""
    with _state.lock:
        if _state.step is not None and _state.step.optimized:
            _close_step()
        harvest()
        got = list(_state.samples)
        return got[max(len(got) - (_state.made - since), 0):]


def summary(kind: str = "eager", since: int = 0) -> Optional[dict]:
    """The medians of the unprofiled samples of `kind` made after `since`:
    {phase or "unit" or "other": ms, "alloc_retries": the mean a unit
    (None where not counted), "n": how many}; None without samples."""
    got = [s for s in samples(since) if s.kind == kind and not s.profiled]
    if not got:
        return None
    out = {k: statistics.median(s.ms[k] for s in got)
           for k in PHASES + ("unit", "other")}
    retries = [s.alloc_retries for s in got if s.alloc_retries is not None]
    out["alloc_retries"] = statistics.fmean(retries) if retries else None
    out["n"] = len(got)
    return out


def reset() -> None:
    """Forget every sample, open step and marked graph."""
    global _state
    _state = _State()
