"""The readers of the program's phase marks (bench/lib/marks.py) on
synthetic samples: the median of each phase over the unprofiled units of
their kind, the mean retries, None below three samples or without the
program's tracing module."""
import sys

import pytest

from bench.lib import marks, spec

PAPER = ("fwd_ms.paper", "bwd_ms.paper", "optim_ms.paper")
LLM = ("fwd_ms.llm", "bwd_ms.llm", "optim_ms.llm")
PHASE = {"fwd": "forward", "bwd": "backward", "optim": "optimizer"}


def _sample(kind, base, profiled=False, retries=None):
    from repro_torch import tracing
    ms = {"forward": base, "backward": 2 * base, "optimizer": 3 * base,
          "unit": 7 * base, "other": base}
    return tracing.Sample(kind, profiled, ms, retries)


@pytest.fixture
def fake_samples(monkeypatch):
    from repro_torch import tracing
    got = []
    monkeypatch.setattr(tracing, "samples", lambda since=0: list(got))
    return got


@pytest.mark.parametrize("name", PAPER + LLM)
def test_phase_readers(fake_samples, name):
    read = spec.metric_reader(name)
    kind, other = ("graph", "eager") if name in PAPER else ("eager", "graph")
    scale = {"forward": 1, "backward": 2, "optimizer": 3}[
        PHASE[name.split("_")[0]]]
    fake_samples += [_sample(kind, 1.0), _sample(kind, 2.0),
                     _sample(kind, 100.0, profiled=True),
                     _sample(other, 50.0)]
    assert read({}) is None                 # two unprofiled of its kind
    fake_samples += [_sample(kind, 4.0), _sample(other, 60.0)]
    assert read({}) == pytest.approx(2.0 * scale)


def test_alloc_retries_reader(fake_samples):
    read = spec.metric_reader("alloc_retries.llm")
    fake_samples += [_sample("eager", 1.0, retries=0),
                     _sample("eager", 1.0, retries=3),
                     _sample("eager", 1.0, profiled=True, retries=50),
                     _sample("graph", 1.0)]
    assert read({}) is None
    fake_samples.append(_sample("eager", 1.0, retries=0))
    assert read({}) == pytest.approx(1.0)


def test_readers_without_the_program_module(monkeypatch):
    """A program without `repro_torch.tracing` (the parent of the marks):
    every reader returns None and raises nothing."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for name in PAPER + LLM + ("alloc_retries.llm",):
        assert spec.metric_reader(name)({}) is None
    assert marks.unprofiled("eager") == []
