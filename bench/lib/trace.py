"""The device trace of a steady part of the window, and what is read from
it: device busy time, the idle gaps and what the host did in each, and
device time by kernel.

`Segment` runs `torch.profiler` (CPU and CUDA activities) around the part
of the window a driver chooses.  The segment is bracketed by
`torch.cuda.synchronize()` inside a `bench.traced` annotation, so its
window holds all the device work queued in it and nothing before it.  The
events are read from the profiler's kineto results directly (one tuple an
event), which stays quick for hundreds of thousands of kernels.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

TRACED = "bench.traced"


class Trace(NamedTuple):
    start_ns: int
    end_ns: int
    device: List[Tuple[str, int, int]]   # (name, start, end): kernels, copies
    host: List[Tuple[str, int, int]]     # CPU ops and the bench's spans

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Segment:
    """with Segment() as seg: ...  then seg.trace (a `Trace`)."""

    def __init__(self):
        self.trace: Optional[Trace] = None
        self._prof = None
        self._span = None

    def __enter__(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(TRACED)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = _read(self._prof)
        return False


def _read(prof) -> Trace:
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device's copies of the host's annotations are no work
            if not _annotation(e):
                device.append((e.name(), start, end))
        else:
            name = e.name()
            if name == TRACED:
                window = (start, end)
            host.append((name, start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {TRACED!r} span")
    device = [d for d in device if d[2] > window[0] and d[1] < window[1]]
    return Trace(window[0], window[1], device, host)


def _annotation(e) -> bool:
    kind = getattr(e, "activity_type", None)
    return e.name().startswith("bench.") or (
        kind is not None and "annotation" in str(kind()).lower())


def busy_intervals(trace: Trace) -> List[Tuple[int, int]]:
    """The union of the device's activity intervals inside the window,
    sorted and disjoint."""
    spans = sorted((max(s, trace.start_ns), min(e, trace.end_ns))
                   for _, s, e in trace.device)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) * 1e-9


def idle_gaps(trace: Trace) -> List[Tuple[int, int]]:
    gaps, t = [], trace.start_ns
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.end_ns > t:
        gaps.append((t, trace.end_ns))
    return gaps


def _host_label(trace: Trace, s: int, e: int) -> str:
    """What the host did over the gap [s, e): the innermost bench span
    covering its middle, and the outermost other host op there."""
    mid = (s + e) // 2
    covering = [(hs, -he, name) for name, hs, he in trace.host
                if hs <= mid < he and name != TRACED]
    if not covering:
        return "host: no op"
    covering.sort()
    spans = [n for _, _, n in covering if n.startswith("bench.")]
    ops = [n for _, _, n in covering if not n.startswith("bench.")]
    parts = ([spans[-1]] if spans else []) + ([ops[0]] if ops else [])
    return " / ".join(parts)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """{"device_ops": [[kernel, seconds]], "idle_gaps": [[host activity,
    seconds]]}: the device operations that took most time, summed by name,
    and the longest idle gaps, each named by what the host was doing."""
    by_name: Dict[str, int] = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], ns * 1e-9] for n, ns in ops],
            "idle_gaps": [[_host_label(trace, s, e), (e - s) * 1e-9]
                          for s, e in gaps]}


def kernel_time(trace: Trace, *names: str) -> Tuple[int, float]:
    """(launches, seconds) of the device events whose name contains any of
    `names`."""
    n, ns = 0, 0
    for name, s, e in trace.device:
        if any(k in name for k in names):
            n += 1
            ns += e - s
    return n, ns * 1e-9
