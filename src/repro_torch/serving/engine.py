"""The INL serving plane: continuous batching over a network topology.

Reference: src/repro/serving/engine.py (`ServingEngine`, `ServeStats`,
`ServedRequest`, `Rejected`, `EngineShutdown`).  The engine turns the
scheme's batched predict into a serving loop:

    per-node request queues   a request fans its J views out to one queue
                              per view node (`submit` enqueues all J
                              fragments atomically, so the queues stay
                              aligned); the scheduler pops the oldest
                              aligned prefix of every queue.
    continuous batching       the scheduler thread loops: grab EVERYTHING
                              queued (up to the largest bucket), launch,
                              complete, repeat.
    pad-to-bucket             batches pad to the smallest bucket in
                              `Scheme.serve_buckets` ({1, 4, 16, 64}), so
                              predict runs at four batch shapes only.
    fuse-what-arrived         per REQUEST: fault draws are keyed by request
                              id (`linkfault.request_delivery_mask`, on the
                              host), so a straggling view misses only its
                              own fusion, and a request's mask is the same
                              whether it rides a full bucket or is served
                              alone.
    metering                  every completed request charges the offered /
                              delivered `BandwidthMeter` ledgers per edge
                              (serving/metering.py), delivered from its
                              real mask.

Numerics contract (tests/test_torch_serving.py): WITHIN a bucket, padding
and batch composition cannot move any request's output — bit for bit,
clean or faulty (padding is row-inert and fault draws are keyed by request
id).  Across bucket sizes outputs agree to float tolerance (each batch
shape may run another convolution or matrix-product algorithm); boolean
delivery masks are exact everywhere.

Any topology (core/topology.py) serves: a chain or tree runs the
scheme's `predict_batched(topology=...)` once per bucket, as the star
does, its latents re-encoded on every hop over the edges' wires.  Link
models on the topology's edges, or an explicit `deadline_ms=`, switch
serving onto per-request delivery masks drawn from (`seed`, request id).
Not in this slice, and refused with NotImplementedError: `transport=` and
`speculative=` (the transport slice).  `wire` ("dense", "packed",
"packed_duplex") sets what the meter charges (a packed wire's codeword
lanes, core/wirefmt.shipped_nbytes) and, on a non-star graph, each hop's
encoding, which leaves the answers as they are; the star's predict ships
unquantized latents and ignores it, as the reference's does.

One compiled predict per bucket: the reference jits the bucket's predict
once (`_make_bucket_predict`) and counts its traces in `trace_counts`.
On the card the engine captures each bucket's predict once as a CUDA
graph (repro_torch/graphs.py) over static views (and, with faults, a
static (J, b) delivery mask) and replays it for every batch of that
bucket; `trace_counts[b]` counts the captures, one per bucket for the
engine's lifetime.  `warmup()` captures every bucket on the caller's
thread; a bucket not warmed up is captured at its first batch.  The
graphs read the state's tensors where they lie: replace `engine.state`
(or any of its tensors) and the next batch captures its bucket again.
On the CPU the engine runs the eager predict and `trace_counts` stays 0.
A capture or replay that fails raises; the engine never falls back to
the eager predict on the card.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import graphs, resolve_device
from repro_torch.core import bandwidth, linkfault
from repro_torch.core import topology as topology_lib
from repro_torch.serving import batching, metering


class EngineShutdown(RuntimeError):
    """The engine is shutting down: new submits are refused with this, and
    requests still pending when the drain window closes fail with it."""


@dataclass(frozen=True)
class Rejected:
    """One request refused at admission (its Future resolves to THIS, not
    to an exception: shedding is an expected overload outcome the caller
    handles inline, not a programming error)."""
    rid: int
    reason: str
    t_done: float                # perf_counter stamp at rejection


@dataclass(frozen=True)
class ServedRequest:
    """One completed request, as its Future resolves it."""
    rid: int
    probs: np.ndarray            # (C,) class probabilities
    views_fused: int             # how many of the J views made the fusion
    latency_ms: float            # submit -> completion (queue + batch + run)
    t_done: float                # perf_counter stamp at completion
    bucket: int                  # the padded batch size it was served in


@dataclass
class ServeStats:
    """Aggregates the engine accumulates while serving."""
    completed: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    views_fused: List[int] = field(default_factory=list)
    launches: int = 0
    launched_rows: int = 0       # bucket rows launched (padding included)
    shed: int = 0                # requests refused at admission (Rejected)

    @property
    def pad_fraction(self) -> float:
        """Fraction of launched rows that were padding — the price of the
        bucket grid (0.0 when every batch lands exactly on a bucket)."""
        if not self.launched_rows:
            return 0.0
        return 1.0 - self.completed / self.launched_rows


class ServingEngine:
    """Continuous-batching inference over one scheme state.

    scheme/state/cfg — a registered Scheme, its state (tensors on
    `device`, which predict checks) and the experiment config.  `device`
    None means "cuda".  topology (None: the implicit star) may carry
    LinkModels; any link model, or an explicit `deadline_ms`, switches
    serving onto per-request fuse-what-arrived masks, drawn from the key
    of `seed` and each request's id.
    `buckets` overrides the scheme's grid (a serial baseline is
    `buckets=(1,)`).  `max_queue` sheds at admission once any node's queue
    reaches the bound, resolving the Future with a `Rejected`.

    Thread model: `submit` is called from any thread; one scheduler thread
    (started by `start()` / the context manager) runs the collect -> pad ->
    launch -> complete loop.  `stop()` drains everything queued before
    joining.  The engine also works synchronously: `serve()` submits a block
    and waits, and `step()` runs one scheduler iteration inline.  A
    scheduler-thread exception fails every pending Future and re-raises on
    the next `submit` / `stop` / `__exit__` — it never strands a blocked
    submitter.
    """

    def __init__(self, scheme, state, cfg, *, topology=None,
                 wire: str = "dense", buckets: Sequence[int] = None,
                 deadline_ms: Optional[float] = None, seed: int = 0,
                 transport=None, speculative: bool = False,
                 max_queue: Optional[int] = None, device=None):
        if transport is not None or speculative:
            raise NotImplementedError(
                "transport= and speculative fusion come with the transport "
                "slice of the port")
        self.topo = topology_lib.resolve(topology, cfg)
        self.deadline_ms = deadline_ms
        # any link model (or an explicit deadline) switches serving onto
        # per-request delivery masks; a bare topology stays on the plain
        # predict, bit-identical to scheme.predict
        self.faulty = (linkfault.has_link_models(self.topo)
                       or deadline_ms is not None)
        self._key = linkfault.key(seed)
        self.device = resolve_device(device)
        self.scheme, self.state, self.cfg = scheme, state, cfg
        self.topology = topology
        self.wire = wire
        self.buckets = batching.validate_buckets(
            buckets if buckets is not None else scheme.serve_buckets)
        self.max_queue = max_queue
        self._draining = False
        self._queues: Dict[str, collections.deque] = {
            name: collections.deque() for name in self.topo.view_nodes()}
        self._futures: Dict[int, Future] = {}
        self._submit_t: Dict[int, float] = {}
        self._next_rid = 0
        self._work = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # one graph per bucket on the card; the graphs may be captured on
        # the scheduler thread while the caller's thread uses the card
        self._graphs = graphs.GraphCache(self.buckets,
                                         capture_error_mode="thread_local")
        self.trace_counts: Dict[int, int] = self._graphs.captures
        self._graph_state = None         # signature the graphs read
        self._static: Dict[int, tuple] = {}
        self.meter = bandwidth.BandwidthMeter()
        self._edge_bits = metering.request_edge_bits(self.topo, cfg)
        self._edge_nbytes = metering.request_edge_wire_bytes(
            self.topo, cfg, wire=wire)
        self.stats = ServeStats()

    # -- the bucketed predict ---------------------------------------------

    def _delivery(self, rids: np.ndarray) -> Optional[np.ndarray]:
        """The (J, n) delivery masks of requests `rids` (None on the clean
        network): a pure function of (seed, request id, edge)."""
        if not self.faulty:
            return None
        return linkfault.request_delivery_mask(
            self._key, self.topo, self.cfg, rids, deadline=self.deadline_ms)

    def _predict(self, views: np.ndarray, delivery=None) -> torch.Tensor:
        """The bucket's predict on padded views (J, b, ...) and, with
        faults, their (J, b) masks: eager on the CPU, the bucket's graph
        on the card."""
        if self.device.type != "cuda":
            return self.scheme.predict_batched(
                self.state, torch.from_numpy(views), delivery=delivery,
                topology=self.topology, cfg=self.cfg, wire=self.wire,
                device=self.device)
        b = views.shape[1]
        sig = graphs.signature(self.state)
        if sig != self._graph_state:
            self._graphs.clear()         # bound to the replaced tensors
            self._static.clear()
            self._graph_state = sig
        graph = self._graphs.get(b)
        if graph is None:
            return self._capture(views, delivery)
        sviews, smask = self._static[b]
        sviews.copy_(torch.from_numpy(views))
        if smask is not None:
            smask.copy_(torch.from_numpy(delivery))
        return graph.replay()

    def _capture(self, views: np.ndarray, delivery) -> torch.Tensor:
        """Bucket b's first batch: the eager predict on a side stream (its
        answer), then the predict captured over static buffers."""
        sviews = torch.from_numpy(views).to(self.device)
        smask = None if delivery is None else linkfault.mask_tensor(
            delivery, self.device)

        def predict():
            return self.scheme.predict_batched(
                self.state, sviews, delivery=smask, topology=self.topology,
                cfg=self.cfg, wire=self.wire, device=self.device)
        probs = graphs.warm_up(predict)
        b = views.shape[1]
        self._static[b] = (sviews, smask)
        self._graphs.capture(b, predict, keep=(self.state, sviews, smask))
        return probs

    def warmup(self) -> None:
        """Run every bucket once, so latency measurements never include a
        first call's library set-up (handles, algorithm choice); on the
        card this captures each bucket's graph."""
        J = self.topo.num_views()
        H, W, C = self.cfg.image_shape
        for b in self.buckets:
            self._predict(np.zeros((J, b, H, W, C), np.float32),
                          self._delivery(np.zeros((b,), np.int64))).cpu()

    # -- scheduler-failure propagation ------------------------------------

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                "serving engine scheduler failed; no further requests will "
                "be served") from self._error

    def _fail_pending(self, exc: BaseException) -> None:
        """Scheduler died: record the error, fail EVERY pending Future
        (blocked waiters wake with the real exception instead of hanging),
        drop the queues."""
        with self._work:
            self._error = exc
            for fut in self._futures.values():
                if not fut.done():
                    fut.set_exception(exc)
            self._clear_locked()

    def _clear_locked(self) -> None:
        self._futures.clear()
        self._submit_t.clear()
        for q in self._queues.values():
            q.clear()
        self._work.notify_all()

    # -- request intake ----------------------------------------------------

    def submit(self, views) -> Tuple[int, Future]:
        """Enqueue one request's (J, H, W, C) views — one fragment per view
        node queue, atomically, so the per-node queues always pop aligned.
        Returns (request id, Future resolving to a ServedRequest).

        With `max_queue=`, a request that would push any per-node queue
        past the bound is SHED: its Future resolves at once to a
        `Rejected` and it never launches."""
        self._check_error()
        self._check_shutdown()
        views = np.asarray(views, np.float32)
        if views.shape[0] != self.topo.num_views():
            raise ValueError(
                f"request has {views.shape[0]} views; topology "
                f"{self.topo.describe()} expects {self.topo.num_views()}")
        fut: Future = Future()
        with self._work:
            self._check_shutdown()
            rid, admitted = self._admit_locked(fut)
            if admitted:
                for j, name in enumerate(self.topo.view_nodes()):
                    self._queues[name].append((rid, views[j]))
                self._futures[rid] = fut
                self._submit_t[rid] = time.perf_counter()
                self._work.notify()
        return rid, fut

    def _admit_locked(self, fut: Future) -> Tuple[int, bool]:
        """(caller holds _work) Allocate a rid; shed when the queues are at
        the admission bound."""
        rid = self._next_rid
        self._next_rid += 1
        if self.max_queue is not None:
            depth = max((len(q) for q in self._queues.values()), default=0)
            if depth >= self.max_queue:
                self.stats.shed += 1
                fut.set_result(Rejected(
                    rid=rid, t_done=time.perf_counter(),
                    reason=f"queue depth {depth} at max_queue="
                           f"{self.max_queue}"))
                return rid, False
        return rid, True

    def _check_shutdown(self) -> None:
        if self._draining:
            raise EngineShutdown(
                "serving engine is shutting down; request not accepted")

    def pending(self) -> int:
        with self._work:
            return len(self._futures)

    # -- the scheduler -----------------------------------------------------

    def _collect(self):
        """Pop the oldest <= max-bucket requests off every node queue
        (caller holds the lock).  Returns ((n,) rids, (J, n, ...) views)
        or None when idle."""
        names = self.topo.view_nodes()
        m = min(len(self._queues[nm]) for nm in names)
        m = min(m, self.buckets[-1])
        if m == 0:
            return None
        rids, frags = None, []
        for nm in names:
            row = [self._queues[nm].popleft() for _ in range(m)]
            got = [r for r, _ in row]
            if rids is None:
                rids = got
            # submit() appends to every queue under the lock, so the
            # aligned-prefix invariant cannot break
            assert got == rids, (got, rids)
            frags.append(np.stack([f for _, f in row]))
        return np.asarray(rids, np.int32), np.stack(frags)

    def _execute(self, rids: np.ndarray, views: np.ndarray) -> None:
        n = len(rids)
        bucket = batching.pick_bucket(n, self.buckets)
        pviews, prids = batching.pad_to_bucket(views, rids, bucket)
        delivery = self._delivery(prids)    # pad rows repeat the last id
        probs_np = self._predict(pviews, delivery)[:n].cpu().numpy()  # waits
        t_done = time.perf_counter()
        mask_np = (np.ones((self.topo.num_views(), n), bool)
                   if delivery is None else delivery[:, :n])
        metering.meter_served_batch(self.meter, self.topo, self.cfg,
                                    mask_np, edge_bits=self._edge_bits,
                                    edge_nbytes=self._edge_nbytes)
        self.stats.launches += 1
        self.stats.launched_rows += bucket
        for i, rid in enumerate(rids):
            rid = int(rid)
            with self._work:
                fut = self._futures.pop(rid)
                t_sub = self._submit_t.pop(rid)
            lat = (t_done - t_sub) * 1e3
            fused = int(mask_np[:, i].sum())
            self.stats.completed += 1
            self.stats.latencies_ms.append(lat)
            self.stats.views_fused.append(fused)
            fut.set_result(ServedRequest(rid=rid, probs=probs_np[i],
                                         views_fused=fused, latency_ms=lat,
                                         t_done=t_done, bucket=bucket))

    def step(self, timeout: float = 0.0) -> int:
        """One scheduler iteration inline: collect -> launch -> complete.
        Returns the number of requests completed (0 when idle past
        `timeout`)."""
        self._check_error()
        with self._work:
            batch = self._collect()
            if batch is None and timeout > 0:
                self._work.wait(timeout)
                batch = self._collect()
        if batch is None:
            return 0
        self._execute(*batch)
        return len(batch[0])

    def _loop(self) -> None:
        try:
            while True:
                with self._work:
                    batch = self._collect()
                    if batch is None:
                        if self._stop.is_set():
                            return                 # queues drained: done
                        self._work.wait(timeout=0.05)
                        continue
                self._execute(*batch)
        except BaseException as exc:               # noqa: BLE001
            # a dead scheduler must not strand blocked submitters: fail
            # every pending Future now, re-raise on the next submit/stop
            self._fail_pending(exc)

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="inl-serving-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 60.0, reraise: bool = True) -> None:
        """Drain the queues, complete everything in flight, join.  If the
        scheduler thread died, its exception re-raises here (pending
        Futures were already failed with it)."""
        if self._thread is None:
            if reraise:
                self._check_error()
            return
        self._stop.set()
        with self._work:
            self._work.notify()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("serving engine failed to drain and stop")
        self._thread = None
        if reraise:
            self._check_error()

    def shutdown(self, drain_timeout: float = 30.0) -> None:
        """GRACEFUL shutdown: stop admitting — further `submit` calls raise
        `EngineShutdown` — then drain what is already queued for up to
        `drain_timeout` seconds, and fail whatever remains pending with
        `EngineShutdown` so no waiter ever hangs on a dead engine.
        Idempotent."""
        with self._work:
            self._draining = True
            self._work.notify_all()
        if self._thread is not None:
            self._stop.set()
            with self._work:
                self._work.notify()
            self._thread.join(timeout=drain_timeout)
            if not self._thread.is_alive():
                self._thread = None
        elif self._error is None:
            deadline = time.perf_counter() + drain_timeout
            try:
                while self.pending() and time.perf_counter() < deadline:
                    if self.step() == 0:
                        break
            except RuntimeError:
                pass                      # a dying drain still fails pending
        exc = EngineShutdown(
            "serving engine shut down before this request completed")
        with self._work:
            for fut in self._futures.values():
                if not fut.done():
                    fut.set_exception(exc)
            self._clear_locked()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, exc_type, *exc) -> None:
        # don't mask an in-flight body exception with the scheduler's
        self.stop(reraise=exc_type is None)

    # -- synchronous conveniences -----------------------------------------

    def serve(self, views, timeout: float = 120.0):
        """Submit a (J, n, ...) block and wait for all n answers.

        Returns ((n, C) probabilities, list of ServedRequest in submit
        order).  Runs through the live scheduler thread when started, else
        inline."""
        n = views.shape[1]
        futs = [self.submit(views[:, i])[1] for i in range(n)]
        if self._thread is None:
            while any(not f.done() for f in futs):
                if self.step() == 0:
                    break
        results = [f.result(timeout=timeout) for f in futs]
        return np.stack([r.probs for r in results]), results
