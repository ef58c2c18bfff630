"""The port's transport layer (repro_torch/transport, repro_torch/chaos),
mirroring tests/test_transport.py case for case, and held against the
reference's:

  * retry policy, circuit breaker, channels (loopback and socket, bit-exact
    fragments), the TCP handshake, typed torn-frame errors and the bounded
    reconnect, the chaos windows and the seeded schedule: the reference's
    cases on the port's modules;
  * parity: for several seeds, chaos schedules, a retry timeout, the
    adaptive controller and a chain(3), every `RoundReport` (mask,
    latency_ms, attempts) and every `RequestReport` (on_time, eventual,
    latency_ms, stragglers, the received fragments) of the port equals the
    reference's exactly, and so do both meters' ledgers (per edge),
    `snapshot()` and the adaptive state.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.chaos import ChaosEvent, ChaosSchedule  # noqa: E402
from repro_torch.core import topology as topology_lib  # noqa: E402
from repro_torch.transport import (DEFAULT_RETRY, NO_RETRY,  # noqa: E402
                                   CircuitBreaker, LoopbackChannel,
                                   NetworkTransport, NoBreaker, RetryPolicy,
                                   SocketChannel, decode_fragment,
                                   encode_fragment, make_channel)
from tests._schemes_common import CFG  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the workers of a parallel
    test run share the machine's cores)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

def test_backoff_grows_then_caps():
    p = RetryPolicy(max_attempts=6, base_backoff_ms=1.0, backoff_mult=2.0,
                    max_backoff_ms=4.0, jitter=0.0)
    assert p.backoff_ms(0, 0.5) == 0.0          # first attempt never waits
    assert p.backoff_ms(1, 0.5) == 1.0
    assert p.backoff_ms(2, 0.5) == 2.0
    assert p.backoff_ms(3, 0.5) == 4.0
    assert p.backoff_ms(5, 0.5) == 4.0          # capped

def test_jitter_only_shortens():
    p = RetryPolicy(max_attempts=3, base_backoff_ms=8.0, jitter=0.5)
    full = p.backoff_ms(1, 0.0)
    assert p.backoff_ms(1, 1.0) == pytest.approx(full * 0.5)
    assert 0.0 < p.backoff_ms(1, 0.7) < full

def test_timeout_marks_attempt_failed():
    p = RetryPolicy(max_attempts=2, timeout_ms=10.0)
    assert p.attempt_failed(11.0) and not p.attempt_failed(9.0)
    assert not NO_RETRY.attempt_failed(1e9)     # no timeout -> never late


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_state_machine():
    b = CircuitBreaker(failure_threshold=3, cooldown=4)
    assert b.state == "closed"
    for t in range(3):
        assert b.allow(t)
        b.record_failure(t)
    assert b.state == "open" and b.opens == 1
    assert not b.allow(3)                       # short-circuit inside cooldown
    assert b.short_circuits == 1
    assert b.allow(2 + 4)                       # cooldown elapsed: probe
    assert b.state == "half_open" and b.probes == 1
    b.record_success()
    assert b.state == "closed"

def test_breaker_reopens_on_failed_probe():
    b = CircuitBreaker(failure_threshold=1, cooldown=2)
    b.allow(0)
    b.record_failure(0)
    assert b.state == "open"
    assert b.allow(2)                           # probe
    b.record_failure(2)
    assert b.state == "open" and b.opens == 2

def test_no_breaker_always_allows():
    b = NoBreaker()
    assert b.state == "disabled"
    assert b.allow(0) and b.allow(10**9)
    b.record_failure(0)
    b.record_success()
    assert b.allow(1)


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["loopback", "socket"])
def test_channel_roundtrips_fragment_bit_exact(kind):
    chan = make_channel(kind)
    try:
        arr = np.random.default_rng(0).standard_normal((7, 8)).astype(
            np.float32)
        chan.send(encode_fragment(42, 3, arr))
        rid, j, got = decode_fragment(chan.recv())
        assert (rid, j) == (42, 3)
        assert got.dtype == arr.dtype and np.array_equal(got, arr)
    finally:
        chan.close()

def test_channel_kinds():
    assert isinstance(make_channel("loopback"), LoopbackChannel)
    assert isinstance(make_channel("socket"), SocketChannel)
    with pytest.raises(ValueError):
        make_channel("carrier-pigeon")

def test_loopback_recv_timeout_returns_none():
    chan = LoopbackChannel()
    assert chan.recv(timeout=0.01) is None


# ---------------------------------------------------------------------------
# network transport
# ---------------------------------------------------------------------------

def _lossy_topo(erasure=0.5):
    from repro_torch.core import linkfault
    return topology_lib.resolve(
        linkfault.with_links(topology_lib.star(CFG.num_clients),
                             linkfault.LinkModel(erasure=erasure)), CFG)

def test_outcomes_deterministic_per_seed():
    masks = []
    for _ in range(2):
        tr = NetworkTransport(_lossy_topo(), CFG, seed=3,
                              policy=DEFAULT_RETRY)
        masks.append(np.stack([tr.round_outcome(t, 32).mask
                               for t in range(8)]))
        tr.close()
    assert np.array_equal(masks[0], masks[1])
    tr = NetworkTransport(_lossy_topo(), CFG, seed=4, policy=DEFAULT_RETRY)
    other = np.stack([tr.round_outcome(t, 32).mask for t in range(8)])
    tr.close()
    assert not np.array_equal(masks[0], other)  # different seed, new story

def _all_edges_down(topo, ticks=64):
    s = ChaosSchedule()
    for e in topo.edges:
        s = s.down_edge(e.key, 0, ticks)
    return s

def test_retries_reoffer_full_charge():
    # every edge chaos-down: every attempt fails -> offered =
    # max_attempts * charge, delivered = 0
    topo = topology_lib.resolve(None, CFG)
    tr = NetworkTransport(topo, CFG, seed=0,
                          policy=RetryPolicy(max_attempts=3), breaker=None,
                          chaos=_all_edges_down(topo))
    charges = {e.key: (100.0, 10.0) for e in tr.topo.edges}
    rep = tr.round_outcome(0, 32, charges=charges)
    assert not rep.mask.any()
    assert all(a == 3 for a in rep.attempts.values())
    assert tr.meter.total_bits == 3 * 100.0 * len(tr.topo.edges)
    assert tr.meter.delivered_bits == 0.0
    tr.close()

def test_breaker_short_circuits_offer_nothing():
    topo = topology_lib.resolve(None, CFG)
    tr = NetworkTransport(
        topo, CFG, seed=0, policy=NO_RETRY,
        breaker=lambda: CircuitBreaker(failure_threshold=1, cooldown=100),
        chaos=_all_edges_down(topo))
    charges = {e.key: (100.0, 10.0) for e in tr.topo.edges}
    tr.round_outcome(0, 32, charges=charges)    # every breaker opens
    before = tr.meter.total_bits
    rep = tr.round_outcome(1, 32, charges=charges)
    assert tr.meter.total_bits == before        # short-circuits: no offer
    assert all(a == 0 for a in rep.attempts.values())
    assert all(s == "open" for s in tr.breaker_states().values())
    tr.close()

def test_charge_false_replays_without_ledger():
    tr = NetworkTransport(_lossy_topo(), CFG, seed=3, policy=DEFAULT_RETRY)
    live = [tr.round_outcome(t, 32).mask for t in range(4)]
    spent = tr.meter.total_bits
    tr.close()
    tr2 = NetworkTransport(_lossy_topo(), CFG, seed=3, policy=DEFAULT_RETRY)
    replay = [tr2.round_outcome(t, 32, charge=False).mask for t in range(4)]
    assert np.array_equal(np.stack(live), np.stack(replay))
    assert tr2.meter.total_bits == 0.0 and spent > 0.0
    tr2.close()

def test_dead_node_fails_its_route_and_request_frames_arrive():
    chaos = ChaosSchedule().kill_node("m1", at=0, duration=2)
    topo = topology_lib.resolve(None, CFG)
    tr = NetworkTransport(topo, CFG, seed=0, chaos=chaos)
    views = np.random.default_rng(0).standard_normal(
        (CFG.num_clients, 16, 16, 3)).astype(np.float32)
    rep = tr.send_request(0, views)
    assert not rep.eventual[1] and rep.eventual[[0, 2, 3, 4]].all()
    assert rep.received[1] is None
    for j in (0, 2, 3, 4):
        assert np.array_equal(rep.received[j], views[j])  # bit-exact ride
    rep2 = tr.send_request(2, views)            # node rejoined
    assert rep2.eventual.all()
    tr.close()


# ---------------------------------------------------------------------------
# chaos schedule
# ---------------------------------------------------------------------------

def test_chaos_windows_and_flap():
    s = (ChaosSchedule()
         .down_edge("e", 2, 3)
         .flap_edge("f", start=0, stop=8, period=4, duty=2)
         .slow_edge("g", 1, 5, factor=10.0)
         .kill_node("n", at=3))
    assert [s.edge_down("e", t) for t in range(6)] == \
        [False, False, True, True, True, False]
    assert [s.edge_down("f", t) for t in range(9)] == \
        [True, True, False, False, True, True, False, False, False]
    assert s.slow_factor("g", 2) == 10.0 and s.slow_factor("g", 5) == 1.0
    assert not s.node_dead("n", 2) and s.node_dead("n", 10**6)

def test_chaos_event_validation():
    with pytest.raises(ValueError):
        ChaosEvent("tsunami", "e")
    with pytest.raises(ValueError):
        ChaosEvent("edge_down", "e", start=5, stop=5)
    with pytest.raises(ValueError):
        ChaosEvent("edge_flap", "e", period=2, duty=3)

def test_seeded_schedule_replays():
    kw = dict(edge_keys=["a", "b"], nodes=["n"], ticks=32)
    assert ChaosSchedule.seeded(7, **kw) == ChaosSchedule.seeded(7, **kw)
    assert ChaosSchedule.seeded(7, **kw) != ChaosSchedule.seeded(8, **kw)


# ---------------------------------------------------------------------------
# socket channel hardening: torn frames, clean EOF, TCP handshake
# ---------------------------------------------------------------------------

def _raw_pair():
    """A SocketChannel wrapping one end of a raw socketpair, with the OTHER
    end exposed raw — so tests can tear frames mid-byte."""
    import socket as socket_lib
    a, b = socket_lib.socketpair()
    return SocketChannel(sock=a), b

def test_peer_close_mid_header_raises_typed_error():
    from repro_torch.transport import ChannelError
    chan, raw = _raw_pair()
    raw.sendall(b"\x07\x00")                     # 2 of the 4 prefix bytes
    raw.close()
    with pytest.raises(ChannelError, match="mid-header"):
        chan.recv(1.0)
    chan.close()

def test_peer_close_mid_frame_raises_typed_error():
    import struct
    from repro_torch.transport import ChannelError
    chan, raw = _raw_pair()
    raw.sendall(struct.pack("<I", 100) + b"only a few body bytes")
    raw.close()
    with pytest.raises(ChannelError, match="mid-frame"):
        chan.recv(1.0)
    chan.close()

def test_clean_close_at_boundary_is_eof_not_error():
    import struct
    chan, raw = _raw_pair()
    raw.sendall(struct.pack("<I", 3) + b"abc")   # one whole frame, then gone
    raw.close()
    assert chan.recv(1.0) == b"abc"
    assert chan.recv(1.0) is None and chan.eof   # gone, not "nothing yet"
    chan.close()

def test_timeout_mid_prefix_keeps_partial_bytes_buffered():
    import struct
    chan, raw = _raw_pair()
    frame = struct.pack("<I", 4) + b"wxyz"
    raw.sendall(frame[:2])                       # half a length prefix
    assert chan.recv(0.05) is None               # timeout, NOT an error
    assert not chan.eof
    raw.sendall(frame[2:])
    assert chan.recv(1.0) == b"wxyz"             # nothing was lost
    raw.close()
    chan.close()

def test_send_on_closed_channel_raises():
    from repro_torch.transport import ChannelError
    chan = SocketChannel()
    chan.close()
    with pytest.raises(ChannelError):
        chan.send(b"x")
    assert chan.recv(0.01) is None               # recv degrades quietly

def test_close_idempotent_and_safe_under_concurrency():
    import threading
    chan, raw = _raw_pair()
    done = threading.Event()
    def blocked_recv():
        try:
            chan.recv(5.0)                       # close() must unblock this
        except Exception:
            pass
        done.set()
    t = threading.Thread(target=blocked_recv)
    t.start()
    threads = [threading.Thread(target=chan.close) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    chan.close()                                 # and once more, for luck
    assert done.wait(5.0)
    t.join()
    raw.close()

def test_tcp_handshake_identifies_both_peers():
    import threading
    from repro_torch.transport import TcpListener
    listener = TcpListener(name="fuse")
    server_chan = []
    t = threading.Thread(
        target=lambda: server_chan.append(listener.accept(timeout=5.0)))
    t.start()
    client = SocketChannel.connect(listener.host, listener.port,
                                   name="m0", expect_peer="fuse")
    t.join()
    server = server_chan[0]
    try:
        assert client.peer == "fuse" and server.peer == "m0"
        arr = np.random.default_rng(1).standard_normal((5, 6)).astype(
            np.float32)
        client.send(encode_fragment(7, 2, arr))
        rid, j, got = decode_fragment(server.recv(5.0))
        assert (rid, j) == (7, 2) and np.array_equal(got, arr)
        server.send(b"ack")
        assert client.recv(5.0) == b"ack"        # full duplex
    finally:
        client.close()
        server.close()
        listener.close()

def test_wrong_peer_name_is_fatal_handshake_error():
    import threading
    from repro_torch.transport import HandshakeError, TcpListener
    listener = TcpListener(name="impostor")
    t = threading.Thread(target=lambda: listener.accept(timeout=5.0))
    t.start()
    with pytest.raises(HandshakeError) as exc:
        SocketChannel.connect(listener.host, listener.port,
                              name="m0", expect_peer="fuse")
    assert exc.value.fatal                       # reconnecting cannot fix it
    t.join()
    listener.close()

def test_version_mismatch_is_fatal_and_skips_the_retry_loop():
    import socket as socket_lib
    import struct
    import threading
    import time
    from repro_torch.transport import HandshakeError
    from repro_torch.transport.channel import _HELLO_MAGIC
    srv = socket_lib.socket(socket_lib.AF_INET, socket_lib.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    def bad_server():
        conn, _ = srv.accept()
        conn.recv(4096)                          # swallow the client hello
        body = struct.pack("<IHH", _HELLO_MAGIC, 999, 1) + b"x"
        conn.sendall(struct.pack("<I", len(body)) + body)
        time.sleep(0.2)
        conn.close()
    t = threading.Thread(target=bad_server)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(HandshakeError, match="version") as exc:
        SocketChannel.connect("127.0.0.1", port, name="m0",
                              attempts=5, backoff_s=1.0)
    assert exc.value.fatal
    assert time.monotonic() - t0 < 1.0           # no 5-attempt backoff walk
    t.join()
    srv.close()

def test_bounded_reconnect_gives_up_with_channel_error():
    import socket as socket_lib
    import time
    from repro_torch.transport import ChannelError
    probe = socket_lib.socket(socket_lib.AF_INET, socket_lib.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()                                # nobody listens here now
    t0 = time.monotonic()
    with pytest.raises(ChannelError, match="could not connect"):
        SocketChannel.connect("127.0.0.1", dead_port, name="m0",
                              attempts=3, backoff_s=0.01, timeout=0.5)
    assert time.monotonic() - t0 < 5.0           # bounded, not forever


# ---------------------------------------------------------------------------
# parity with the reference's transport
# ---------------------------------------------------------------------------

DEADLINE_CFG = dataclasses.replace(CFG, fusion_deadline_ms=20.0)
CHAIN_CFG = dataclasses.replace(CFG, num_clients=3,
                                noise_stds=(0.4, 1.0, 2.0),
                                fusion_deadline_ms=40.0)
TICKS = 24


def _sides():
    """(chaos, linkfault, topology, transport) of the reference and of the
    port."""
    import repro.chaos as jchaos
    import repro.transport as jtransport
    from repro.core import linkfault as jlinkfault
    from repro.core import topology as jtopology
    import repro_torch.chaos as tchaos
    import repro_torch.transport as ttransport
    from repro_torch.core import linkfault as tlinkfault
    from repro_torch.core import topology as ttopology
    return {"ref": (jchaos, jlinkfault, jtopology, jtransport),
            "port": (tchaos, tlinkfault, ttopology, ttransport)}


def _scenario(name, C, L, T, TR):
    """(topology, cfg, NetworkTransport kwargs) of one scenario, built
    from one package's modules."""
    lossy = L.LinkModel(erasure=0.3, latency_ms=5.0, jitter_ms=10.0)
    star = L.with_links(T.star(CFG.num_clients), lossy)
    if name == "lossy star":
        return star, DEADLINE_CFG, dict(seed=3, policy=TR.DEFAULT_RETRY)
    if name == "chaos":
        chaos = (C.ChaosSchedule().down_edge("m0->fuse", 2, 3)
                 .flap_edge("m1->fuse", start=0, stop=16, period=3, duty=2)
                 .slow_edge("m2->fuse", 4, 12, factor=10.0)
                 .kill_node("m3", at=6, duration=5))
        return star, DEADLINE_CFG, dict(
            seed=5, policy=TR.DEFAULT_RETRY, chaos=chaos,
            breaker=lambda: TR.CircuitBreaker(failure_threshold=2,
                                              cooldown=3))
    if name == "seeded chaos":
        keys = [f"m{j}->fuse" for j in range(CFG.num_clients)]
        chaos = C.ChaosSchedule.seeded(
            11, edge_keys=keys, nodes=["m1", "m4"], ticks=TICKS,
            p_edge_down=0.15, p_node_kill=0.05)
        return star, DEADLINE_CFG, dict(seed=7, policy=TR.DEFAULT_RETRY,
                                        chaos=chaos)
    if name == "timeout + adaptive":
        pol = TR.RetryPolicy(max_attempts=3, timeout_ms=12.0)
        return star, DEADLINE_CFG, dict(
            seed=9, policy=pol, adaptive=TR.AdaptivePolicy(
                base=pol, base_threshold=3,
                config=TR.AdaptiveConfig(window=4, ratio_low=0.6)))
    if name == "chain(3)":
        chain = T.chain(3)
        links = {e.key: lossy for e in chain.edges}
        chaos = C.ChaosSchedule().kill_node("m1", at=3, duration=4) \
            .down_edge(chain.edges[-1].key, 10, 2)
        return L.with_links(chain, links), CHAIN_CFG, dict(
            seed=13, policy=TR.DEFAULT_RETRY, chaos=chaos)
    raise KeyError(name)


SCENARIOS = ("lossy star", "chaos", "seeded chaos", "timeout + adaptive",
             "chain(3)")


def _ledgers(meter):
    return (meter.total_bits, meter.measured_bytes, meter.delivered_bits,
            meter.delivered_measured_bytes, dict(meter.edge_bits),
            dict(meter.edge_measured_bytes), dict(meter.edge_delivered_bits))


def _drive(side, name):
    """TICKS rounds, then TICKS requests carrying seeded fragments (each
    request's on-time views credited as a fusion would), on one side."""
    C, L, T, TR = _sides()[side]
    topo, cfg, kw = _scenario(name, C, L, T, TR)
    tr = TR.NetworkTransport(topo, cfg, **kw)
    rng = np.random.default_rng(1)
    J = tr.topo.num_views()
    try:
        rounds = [tr.round_outcome(t, 32) for t in range(TICKS)]
        snap_rounds = tr.snapshot()
        requests = []
        for rid in range(TICKS):
            views = rng.standard_normal((J, 4, 4, 3)).astype(np.float32)
            rep = tr.send_request(rid, views)
            tr.credit_delivered(rep.on_time)
            requests.append(rep)
        return rounds, requests, snap_rounds, tr.snapshot(), \
            _ledgers(tr.meter)
    finally:
        tr.close()


@pytest.mark.parametrize("name", SCENARIOS)
def test_reports_ledgers_and_snapshots_match_reference(name):
    (r_ref, q_ref, s1_ref, s2_ref, l_ref), (r_port, q_port, s1_port,
                                            s2_port, l_port) = (
        _drive("ref", name), _drive("port", name))
    for a, b in zip(r_ref, r_port):
        assert a.tick == b.tick
        assert np.array_equal(a.mask, b.mask), (a.tick, a.mask, b.mask)
        assert np.array_equal(a.latency_ms, b.latency_ms)
        assert a.attempts == b.attempts
    for a, b in zip(q_ref, q_port):
        assert a.rid == b.rid
        for f in ("on_time", "eventual", "latency_ms", "stragglers"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (a.rid, f)
        assert a.attempts == b.attempts
        for x, y in zip(a.received, b.received):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y)
    assert s1_ref == s1_port and s2_ref == s2_port
    assert l_ref == l_port
    # the scenarios exercise what they are named for
    masks = np.stack([r.mask for r in r_ref])
    assert masks.any() and not masks.all()
    if name == "timeout + adaptive":
        assert s2_ref["adaptive"]["retunes"] > 0
    if name == "chaos":
        assert any(b["opens"] for b in s2_ref["breaker"].values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_match_reference_across_seeds(seed):
    masks = {}
    for side, (C, L, T, TR) in _sides().items():
        topo, cfg, kw = _scenario("lossy star", C, L, T, TR)
        tr = TR.NetworkTransport(topo, cfg, **dict(kw, seed=seed))
        masks[side] = np.stack([tr.round_outcome(t, 64, charge=False).mask
                                for t in range(TICKS)])
        assert tr.meter.total_bits == 0.0
        tr.close()
    assert np.array_equal(masks["ref"], masks["port"])


def test_replay_then_load_snapshot_matches_reference():
    """The resume path: TICKS uncharged replays, then load_snapshot of the
    reference's sidecar copy; the adaptive state equals on both sides."""
    snaps = {}
    for side, (C, L, T, TR) in _sides().items():
        topo, cfg, kw = _scenario("timeout + adaptive", C, L, T, TR)
        tr = TR.NetworkTransport(topo, cfg, **kw)
        for t in range(TICKS):
            tr.round_outcome(t, 32, charge=False)
        snaps[side] = tr.snapshot()
        tr.close()
    assert snaps["ref"] == snaps["port"]
    C, L, T, TR = _sides()["port"]
    topo, cfg, kw = _scenario("timeout + adaptive", C, L, T, TR)
    tr = TR.NetworkTransport(topo, cfg, **kw)
    tr.load_snapshot(snaps["ref"])
    assert tr.adaptive.state_dict() == snaps["ref"]["adaptive"]
    tr.close()


def test_chaos_queries_and_describe_match_reference():
    C_ref, C_port = _sides()["ref"][0], _sides()["port"][0]
    kw = dict(edge_keys=["a", "b", "c"], nodes=["n", "o"], ticks=48,
              p_edge_down=0.2, p_node_kill=0.05)
    ref, port = C_ref.ChaosSchedule.seeded(4, **kw), \
        C_port.ChaosSchedule.seeded(4, **kw)
    ref = ref.freeze_node("o", at=3, duration=2).slow_edge("a", 1, 9, 3.0)
    port = port.freeze_node("o", at=3, duration=2).slow_edge("a", 1, 9, 3.0)
    assert ref.describe() == port.describe()
    for t in range(50):
        for k in ("a", "b", "c"):
            assert ref.edge_down(k, t) == port.edge_down(k, t)
            assert ref.slow_factor(k, t) == port.slow_factor(k, t)
        for n in ("n", "o"):
            assert ref.node_dead(n, t) == port.node_dead(n, t)
            assert ref.node_frozen(n, t) == port.node_frozen(n, t)
