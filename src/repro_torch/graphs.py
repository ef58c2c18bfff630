"""CUDA graphs: the port's counterpart of `jax.jit` and `lax.scan`.

Reference: the JAX package compiles its dispatch units once and runs each
as one dispatch: `jax.jit` of a predict per serving bucket
(src/repro/serving/engine.py, `trace_counts`) and of the decode step
(src/repro/launch/serve.py, `trace_log`), and `lax.scan` of the training
round over a whole epoch (src/repro/core/schemes/base.py,
`Scheme.make_epoch`), which traces the round once.  Eager PyTorch traces
nothing and pays the host's dispatch for every op.  On the card a CUDA
graph takes jit's place: the kernels of one call are recorded once and
replayed with one launch.

    warm_up(fn, *args)   runs fn eagerly on a side stream (the first call
                         of a unit: library set-up happens there, never
                         inside a capture) and returns its result
    GraphCache           graphs by key, each captured once from fn() into
                         a `Graph`; `captures` counts the captures per key
                         (jax's trace counts)

A captured function reads its inputs from static buffers and writes its
outputs to tensors the graph owns; a replay re-runs the recorded kernels
on whatever the buffers hold and returns the same output tensors again.
Inside a capture nothing may copy from the host or wait for the device
(no `torch.tensor(..., device=)` of a host value, no `.item()`, no
indexing with a 0-dim CUDA tensor); such a call raises there.  Random
draws from an explicit `torch.Generator` are captured graph-safe when the
generator is registered with the graph (`generators=`): a replay draws
from the generator's current offset and advances it as the eager draws
would, so replayed rounds draw the eager rounds' numbers bit for bit.

Launch counts and phase marks: the kernels' `LAUNCHES` counters
(kernels/inl_bottleneck, flash_attention, ssm_scan) are bumped by their
Python wrappers, which run only while a graph is captured.
`GraphCache.capture` runs the capture inside `tracing.capture()`, which
takes back what the capture added (a capture launches nothing) and keeps
it, with the phase marks recorded in the capture, as the graph's
`Captured`; every replay adds the launches again and flags the marks for
the next harvest.  So `LAUNCHES` counts kernel executions under either
dispatch, and a graph captured with marks times its phases on every
replay.

Graphs are a card feature: callers take their eager path for CPU tensors
and never ask for a graph there.  On the card a capture or a replay that
fails raises; nothing falls back to the eager path.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Iterable, Optional

import torch

from repro_torch import tracing, tree_leaves


def warm_up(fn: Callable, *args, **kwargs):
    """fn(*args, **kwargs) run eagerly on a side stream, ordered after the
    current stream's work and before its later work.  Its result is the
    call's real result (a unit's first call IS its warm-up), handed back
    for use on the current stream."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream(device=cur.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*args, **kwargs)
    cur.wait_stream(side)
    for t in tree_leaves(out):
        if t.device.type == "cuda":
            t.record_stream(cur)
    return out


class Graph:
    """One captured call.  `outputs` is what the captured function
    returned; `replay()` re-runs the recorded kernels, adds the graph's
    launches to the counters, flags its phase marks and returns `outputs`
    (the same tensors every time, overwritten by each replay)."""

    def __init__(self, graph, outputs, captured, keep):
        self._graph = graph
        self.outputs = outputs
        self.captured = captured      # tracing.Captured: launches, marks
        self._keep = keep             # the static inputs the graph reads
        captured.owned_by(self)

    def replay(self):
        with tracing.span("graph.replay"):
            self._graph.replay()
        self.captured.replayed()
        return self.outputs

    def pool(self):
        """The graph's memory pool, for `GraphCache.capture(pool=)`."""
        return self._graph.pool()


class GraphCache:
    """Graphs by key, each captured once.  `captures[key]` counts the
    captures made under `key`: the counterpart of a jitted function's
    trace count (`keys` start it at 0).  `capture_error_mode` as
    `torch.cuda.graph`'s ("thread_local" where another thread may use the
    card meanwhile)."""

    def __init__(self, keys: Iterable[Hashable] = (), *,
                 capture_error_mode: str = "global"):
        self.captures: Dict[Hashable, int] = {k: 0 for k in keys}
        self._graphs: Dict[Hashable, Graph] = {}
        self._mode = capture_error_mode

    def get(self, key: Hashable) -> Optional[Graph]:
        return self._graphs.get(key)

    def capture(self, key: Hashable, fn: Callable[[], Any], *,
                generators: Iterable = (), keep: Any = (),
                marks: bool = True, pool=None) -> Graph:
        """Record fn() into a CUDA graph under `key`.  fn reads static
        buffers only; the graph keeps `keep` (those buffers) alive.
        `generators` — the torch.Generators fn draws from, registered so
        that replays draw graph-safe.  marks=False leaves fn's phase marks
        out of the graph (`tracing.capture`).  `pool` — another graph's
        memory pool (`Graph.pool()`) to share, for a graph that is never
        replayed at the same time as that one."""
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with tracing.span("graph.capture"), \
                tracing.capture(marks=marks) as captured, \
                torch.cuda.graph(graph, pool=pool,
                                 capture_error_mode=self._mode):
            outputs = fn()
        self._graphs[key] = Graph(graph, outputs, captured, keep)
        self.captures[key] = self.captures.get(key, 0) + 1
        return self._graphs[key]

    def clear(self) -> None:
        """Drop every graph (their inputs were replaced); the capture
        counts stay."""
        self._graphs.clear()


def signature(tree) -> tuple:
    """What a graph over `tree`'s tensors is bound to: each leaf's address,
    shape, strides and dtype.  Two trees with one signature can be read by
    one graph."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tree_leaves(tree))
