"""Host -> device input pipeline: double-buffered batch prefetch.

Reference: src/repro/data/prefetch.py (`prefetch_to_device`).  The scan
train step (`launch/steps.make_scan_train_step`) runs a group of K steps
in one call; this module overlaps the host-to-device copy of group g + 1
with the compute of group g.  A producer THREAD pulls the iterator up to
``size`` items ahead and starts each item's copy as soon as it has it:

    on a CUDA device  each leaf goes into pinned host memory, then to the
                      device with `non_blocking=True` on a side stream;
                      an event recorded after the item's copies is what
                      the consumer's stream waits on before the item is
                      yielded, and `record_stream` tells the caching
                      allocator that the consumer's stream uses the
                      buffers, so none is reused while that stream may
                      still read it;
    on the CPU        the same thread and queue, each leaf a tensor on
                      the host (no stream, no copy to wait for).

An item is a tree (dicts, lists, tuples) of numpy arrays, numpy scalars
or tensors; it comes back with every leaf a tensor on the device, in its
dtype.  Failure containment, as the reference's: an exception anywhere in
the producer (the source iterator, host-side batch assembly, the copy) is
captured and RE-RAISED on the consumer side at the next pull, after the
items buffered before it.  A consumer that stops early (close() or GC)
sets a stop flag, drains the queue and joins the thread.

Spans (`tracing.span`): "repro.feed.wait" around the consumer's wait for
an item and its stream's wait on the copy, "repro.feed.copy" around the
producer's pinning and copy (in the producer's thread: a profiler sees it
when it profiles all threads).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch import resolve_device, tracing, tree_leaves, tree_map

# queue sentinel: exhaustion; a producer fault rides in a _Failure
_DONE = object()


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _host_tree(item):
    """`item` with every numpy array or scalar as a tensor (numpy's
    dtype) on the host; tensors stay as they are."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if isinstance(t, torch.Tensor):
            return t
        a = np.asarray(t)
        return torch.from_numpy(a if a.flags.c_contiguous
                                else np.ascontiguousarray(a))
    return walk(item)


def prefetch_to_device(iterator: Iterable, *, size: int = 2,
                       device=None) -> Iterator:
    """Yield the items of `iterator` with their leaves on `device` (None:
    cuda), keeping up to `size` items' transfers in flight ahead of the
    consumer (double-buffered at the default size=2).

    On a CUDA device an item yielded here is ready for the consumer's
    current stream: the stream waits on the item's copy event, so work
    the consumer queues on it reads the copied values."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def _put(item):
        host = _host_tree(item)
        with tracing.span("feed.copy"):
            if not cuda:
                return tree_map(lambda t: t.to(device), host)
            with torch.cuda.device(device), torch.cuda.stream(side):
                moved = tree_map(
                    lambda t: t.pin_memory().to(device, non_blocking=True),
                    host)
                done = torch.cuda.Event()
                done.record(side)
            return moved, done

    # maxsize bounds host and device memory: at most `size` items buffered
    # plus the one the producer is transferring
    buf: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def _offer(item) -> bool:
        """put() that gives up when the consumer dropped the generator."""
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer():
        try:
            for item in iterator:
                if not _offer(_put(item)):
                    return
            _offer(_DONE)
        except BaseException as exc:  # re-raised consumer-side, never lost
            _offer(_Failure(exc))

    def _drain():
        """Release every buffered item and unblock a producer stuck in
        put()."""
        while True:
            try:
                buf.get_nowait()
            except queue.Empty:
                return

    thread = threading.Thread(target=_producer, name="prefetch_to_device",
                              daemon=True)
    thread.start()
    try:
        while True:
            with tracing.span("feed.wait"):
                got = buf.get()
                if got is _DONE:
                    return
                if isinstance(got, _Failure):
                    raise got.exc
                if cuda:
                    got, done = got
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(done)
                    for t in tree_leaves(got):
                        t.record_stream(consumer)
            yield got
    finally:
        # the producer sees `stop` within its 0.1-s put timeout, so the
        # bounded join trips only if a copy itself hangs (and the daemon
        # thread cannot block interpreter exit)
        stop.set()
        _drain()
        thread.join(timeout=5.0)
        _drain()
