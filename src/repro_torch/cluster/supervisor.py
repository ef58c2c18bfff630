"""The Supervisor: spawn, probe, kill, freeze, and restart worker
processes; publish the membership view the transport masks read.

Reference: src/repro/cluster/supervisor.py.

One worker process per measure node (`cluster/worker.py`).  The worker
binds an ephemeral port and prints a JSON registration line; the
supervisor reads it and dials back over the TCP `SocketChannel` mode
(versioned handshake asserting the peer really is that node, bounded
reconnect).  Topology edges whose SOURCE is a supervised node get a
`WorkerChannel` — a `Channel` whose send/recv is an echo round trip
through the worker, so a delivered payload genuinely crossed two process
boundaries — and everything above the Channel API (`NetworkTransport`,
retries, breakers, ledgers, the serving engine) runs unchanged.

Supervision is TICK-driven, not wall-clock-driven: `tick(t)` runs as the
transport's `on_tick` hook at the top of every round/request, so
scheduled kills/freezes (a `ChaosSchedule` with node_kill/node_freeze
windows) are realised with REAL SIGKILL/SIGSTOP/SIGCONT at deterministic
points, and the membership ladder (`cluster/membership.py`) advances as a
function of tick-stamped observations.  What stays wall-clock is only
detection I/O (probe timeouts against a frozen process) — outcomes, and
therefore masks and trajectories, are deterministic per tick.
"""
from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.cluster import proto
from repro_torch.cluster.membership import (DOWN, HeartbeatMonitor,
                                            MembershipView)
from repro_torch.transport.channel import Channel, ChannelError, SocketChannel

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


class WorkerHandle:
    """One supervised process: Popen + connected channel + request tags."""

    def __init__(self, node: str):
        self.node = node
        self.proc: Optional[subprocess.Popen] = None
        self.channel: Optional[SocketChannel] = None
        self.port: Optional[int] = None
        self.frozen = False
        self.lock = threading.Lock()      # serialises request/response I/O
        self._tag = 0

    def next_tag(self) -> int:
        self._tag += 1
        return self._tag

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class WorkerChannel(Channel):
    """A topology edge riding a worker process: send() ships the frame to
    the worker as an ECHO request, recv() awaits the tagged reply — so the
    payload crosses the process boundary twice, and a dead or frozen
    worker fails the edge exactly like a lossy link (typed ChannelError /
    recv timeout), which the EdgeTransport's retry/breaker machinery
    already knows how to price."""

    kind = "cluster"

    def __init__(self, supervisor: "Supervisor", node: str):
        self._sup = supervisor
        self._node = node
        self._pending: Optional[int] = None

    def send(self, frame: bytes) -> None:
        self._pending = self._sup._echo_send(self._node, frame)

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        tag, self._pending = self._pending, None
        if tag is None:
            return None
        return self._sup._echo_recv(self._node, tag, timeout)

    def close(self) -> None:
        pass                               # the supervisor owns the socket


class Supervisor:
    """Spawn one worker per node; keep them alive; answer for their health.

    nodes               the measure-node names to supervise.
    seed                heartbeat phase stream (membership.HeartbeatMonitor).
    chaos               a ChaosSchedule whose node_kill/node_freeze windows
                        this supervisor REALISES with SIGKILL/SIGSTOP at
                        tick boundaries (also consulted to route scheduled
                        restarts around the backoff ladder).
    heartbeat_interval / suspect_after / dead_after / backoff_*
                        the membership ladder's parameters, in ticks.
    io_timeout          per-probe / per-echo-slice socket timeout (seconds)
                        — the only wall-clock knob; it bounds how long a
                        frozen worker can stall one transmission.
    """

    def __init__(self, nodes: Sequence[str], *, seed: int = 0, chaos=None,
                 heartbeat_interval: int = 1, suspect_after: int = 1,
                 dead_after: int = 2, backoff_base: int = 1,
                 backoff_mult: int = 2, backoff_cap: int = 8,
                 stable_after: int = 4, io_timeout: float = 0.25,
                 spawn_timeout: float = 30.0, python: Optional[str] = None):
        self.nodes = list(nodes)
        self.chaos = chaos
        self.monitor = HeartbeatMonitor(
            self.nodes, seed=seed, interval=heartbeat_interval,
            suspect_after=suspect_after, dead_after=dead_after,
            backoff_base=backoff_base, backoff_mult=backoff_mult,
            backoff_cap=backoff_cap, stable_after=stable_after)
        self.handles: Dict[str, WorkerHandle] = {
            n: WorkerHandle(n) for n in self.nodes}
        self.io_timeout = io_timeout
        self.spawn_timeout = spawn_timeout
        self._python = python or sys.executable
        self._lock = threading.RLock()
        self._started = False
        self.respawns = 0
        self.last_tick: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Supervisor":
        with self._lock:
            for node in self.nodes:
                self._spawn(node, tick=0)
            self._started = True
        return self

    def stop(self) -> None:
        with self._lock:
            self._started = False
            for h in self.handles.values():
                if h.channel is not None:
                    try:
                        h.channel.send(proto.pack_msg(proto.OP_EXIT, 0))
                    except ChannelError:
                        pass
                    h.channel.close()
                    h.channel = None
                if h.proc is not None:
                    if h.frozen:
                        self._signal(h, signal.SIGCONT)
                        h.frozen = False
                    h.proc.terminate()
            for h in self.handles.values():
                if h.proc is not None:
                    try:
                        h.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        h.proc.kill()
                        h.proc.wait()
                    if h.proc.stdout is not None:
                        h.proc.stdout.close()
                    h.proc = None

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- spawning -----------------------------------------------------------

    def _spawn(self, node: str, tick: int) -> None:
        h = self.handles[node]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [_SRC, env.get("PYTHONPATH", "")] if p)
        h.proc = subprocess.Popen(
            [self._python, "-m", "repro_torch.cluster.worker", "--node", node],
            stdout=subprocess.PIPE, text=True, env=env)
        try:
            info = json.loads(self._read_registration(h.proc))
        except Exception:
            h.proc.kill()
            h.proc.wait()
            raise
        if info.get("node") != node:
            h.proc.kill()
            h.proc.wait()
            raise ChannelError(f"worker registered as {info.get('node')!r}, "
                               f"expected {node!r}")
        h.port = int(info["port"])
        h.channel = SocketChannel.connect(
            info.get("host", "127.0.0.1"), h.port, name="supervisor",
            expect_peer=node, timeout=self.spawn_timeout)
        h.frozen = False
        self.monitor.note_joined(node, tick)

    def _read_registration(self, proc: subprocess.Popen) -> str:
        deadline = time.monotonic() + self.spawn_timeout
        assert proc.stdout is not None
        while time.monotonic() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [], 0.1)
            if ready:
                line = proc.stdout.readline()
                if line:
                    return line
                raise ChannelError("worker exited before registering")
            if proc.poll() is not None:
                raise ChannelError(
                    f"worker died during spawn (rc={proc.returncode})")
        raise ChannelError("worker registration timed out")

    def _respawn(self, node: str, tick: int) -> None:
        h = self.handles[node]
        if h.channel is not None:
            h.channel.close()
            h.channel = None
        if h.proc is not None:
            if h.proc.stdout is not None:
                h.proc.stdout.close()
            h.proc = None
        self._spawn(node, tick)
        self.respawns += 1

    # -- faults (real signals) ---------------------------------------------

    @staticmethod
    def _signal(h: WorkerHandle, sig: int) -> None:
        try:
            os.kill(h.proc.pid, sig)
        except (OSError, AttributeError):
            pass

    def kill(self, node: str) -> None:
        """SIGKILL the worker NOW (an unscheduled death: the next tick's
        poll walks the membership ladder and pays restart backoff)."""
        with self._lock:
            h = self.handles[node]
            if h.proc is None:
                return
            if h.frozen:
                self._signal(h, signal.SIGCONT)
                h.frozen = False
            self._signal(h, signal.SIGKILL)
            try:
                h.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass

    def freeze(self, node: str) -> None:
        with self._lock:
            h = self.handles[node]
            if h.alive() and not h.frozen:
                self._signal(h, signal.SIGSTOP)
                h.frozen = True

    def thaw(self, node: str) -> None:
        with self._lock:
            h = self.handles[node]
            if h.alive() and h.frozen:
                self._signal(h, signal.SIGCONT)
                h.frozen = False

    # -- the supervision tick ----------------------------------------------

    def tick(self, t: int) -> None:
        """Advance supervision to tick `t`: realise the chaos schedule with
        real signals, reap exits, run due heartbeats, restart what the
        ladder allows.  Runs as the transport's `on_tick` hook, BEFORE any
        of tick t's transmissions — so a scheduled kill at t already masks
        t's votes, exactly like the inline chaos path."""
        with self._lock:
            if not self._started:
                return
            self.last_tick = t
            for node in self.nodes:
                h = self.handles[node]
                want_dead = self.chaos is not None \
                    and self.chaos.node_dead(node, t)
                want_frozen = self.chaos is not None \
                    and self.chaos.node_frozen(node, t)
                # 1) realise the schedule
                if want_dead and h.alive():
                    self.kill(node)
                if h.alive():
                    if want_frozen and not h.frozen:
                        self._signal(h, signal.SIGSTOP)
                        h.frozen = True
                    elif not want_frozen and h.frozen:
                        self._signal(h, signal.SIGCONT)
                        h.frozen = False
                # 2) reap deaths (scheduled or not)
                if h.proc is not None and h.proc.poll() is not None \
                        and self.monitor.nodes[node].status != DOWN:
                    self.monitor.note_exit(node, t, scheduled=want_dead)
                    if h.channel is not None:
                        h.channel.close()
                        h.channel = None
                # 3) restart what is due (never inside a scheduled window)
                if not want_dead and not h.alive() \
                        and self.monitor.due_restart(node, t):
                    self._respawn(node, t)
                # 4) probe on the seeded cadence
                elif h.alive() and self.monitor.beat_due(node, t):
                    self.monitor.observe(node, t, self._ping(node))
            self.monitor.tick_stability(t)

    # -- health / membership ------------------------------------------------

    def membership(self) -> MembershipView:
        with self._lock:
            return self.monitor.view()

    def is_down(self, name: str, tick: int = 0) -> bool:
        """The transport's `node_down` hook: a node this supervisor does
        not own is never down on its account."""
        with self._lock:
            if name not in self.handles:
                return False
            return self.monitor.is_down(name)

    def events(self) -> List[tuple]:
        with self._lock:
            return list(self.monitor.events)

    # -- the data path ------------------------------------------------------

    def edge_channels(self, topo) -> Dict[str, Channel]:
        """{edge_key: WorkerChannel} for every edge whose source is a
        supervised node (the transport falls back to loopback for the
        rest — relay/fuse hops stay in the serving process)."""
        return {e.key: WorkerChannel(self, e.src)
                for e in topo.edges if e.src in self.handles}

    def _echo_send(self, node: str, frame: bytes) -> int:
        h = self.handles[node]
        with h.lock:
            if h.channel is None or not h.alive():
                raise ChannelError(f"worker {node} is down")
            tag = h.next_tag()
            h.channel.send(proto.pack_msg(proto.OP_ECHO, tag, frame))
            return tag

    def _echo_recv(self, node: str, tag: int,
                   timeout: Optional[float]) -> Optional[bytes]:
        return self._await_reply(node, proto.OP_ECHO_REPLY, tag,
                                 self.io_timeout if timeout is None
                                 else min(timeout, self.io_timeout))

    def _await_reply(self, node: str, want_op: int, tag: int,
                     timeout: float) -> Optional[bytes]:
        h = self.handles[node]
        with h.lock:
            if h.channel is None:
                return None
            deadline = time.monotonic() + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                try:
                    frame = h.channel.recv(remaining)
                except ChannelError:
                    return None
                if frame is None:
                    if h.channel.eof:
                        return None
                    continue
                op, rtag, payload = proto.unpack_msg(frame)
                if rtag != tag or op != want_op:
                    continue               # stale reply from a thawed worker
                return payload

    def _ping(self, node: str) -> bool:
        h = self.handles[node]
        try:
            with h.lock:
                if h.channel is None or not h.alive():
                    return False
                tag = h.next_tag()
                h.channel.send(proto.pack_msg(proto.OP_PING, tag))
            return self._await_reply(node, proto.OP_PONG, tag,
                                     self.io_timeout) is not None
        except ChannelError:
            return False
