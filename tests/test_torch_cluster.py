"""The port's worker plane (repro_torch/cluster, transport/adaptive),
mirroring tests/test_cluster.py, and held against the reference's:

  * the membership ladder and the adaptive controller as pure state
    machines: the reference's cases on the port's modules, and on one
    seeded observation stream the port's events, views, node records and
    knob trajectories equal the reference's;
  * real worker processes (`python -m repro_torch.cluster.worker`): spawn,
    register, a bit-exact echo across two process boundaries, SIGKILL
    (ladder, backoff, respawn), SIGSTOP (suspect, dead, rejoin in place);
  * a `Cluster` over a scripted kill and freeze gives the masks, membership
    events and incarnations of the reference's `Cluster` on the same
    schedule, which are exactly the scheduled windows.

The engine's admission control and graceful shutdown (the rest of
tests/test_cluster.py) are mirrored in tests/test_torch_serving.py.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.cluster import (DOWN, SUSPECT, UP,  # noqa: E402
                                 HeartbeatMonitor, Supervisor)
from repro_torch.core import topology as topology_lib  # noqa: E402
from repro_torch.transport import (AdaptiveConfig,  # noqa: E402
                                   AdaptivePolicy, DEFAULT_RETRY)
from repro_torch.transport.policy import RetryPolicy  # noqa: E402


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
# membership ladder (pure)
# ---------------------------------------------------------------------------

def _monitor(**kw):
    kw.setdefault("seed", 0)
    kw.setdefault("interval", 1)
    kw.setdefault("suspect_after", 1)
    kw.setdefault("dead_after", 3)
    kw.setdefault("backoff_base", 2)
    kw.setdefault("backoff_mult", 2)
    kw.setdefault("backoff_cap", 8)
    kw.setdefault("stable_after", 2)
    m = HeartbeatMonitor(["a"], **kw)
    m.note_joined("a", 0)
    return m


def test_miss_ladder_up_suspect_dead():
    m = _monitor()
    assert m.view().mask(["a"]).tolist() == [True]
    m.observe("a", 1, False)
    assert m.nodes["a"].status == SUSPECT
    assert m.view().mask(["a"]).tolist() == [True]   # suspects keep voting
    m.observe("a", 2, False)
    assert m.nodes["a"].status == SUSPECT            # dead_after=3 not hit
    m.observe("a", 3, False)
    assert m.nodes["a"].status == DOWN
    assert m.is_down("a") and not m.view().mask(["a"]).any()
    assert [e[2] for e in m.events] == \
        ["down->up", "up->suspect", "suspect->down"]


def test_pong_clears_misses_and_rejoins_frozen_node_in_place():
    m = _monitor()
    for t in (1, 2, 3):
        m.observe("a", t, False)
    assert m.nodes["a"].status == DOWN
    inc = m.nodes["a"].incarnation
    m.observe("a", 4, True)             # it answered: frozen, not dead
    assert m.nodes["a"].status == UP
    assert m.nodes["a"].incarnation == inc          # same incarnation
    assert m.nodes["a"].restart_due is None         # no restart pending


def test_scheduled_exit_restarts_at_window_end():
    m = _monitor()
    m.note_exit("a", 5, scheduled=True)
    assert m.nodes["a"].status == DOWN
    assert m.due_restart("a", 5)         # the schedule owns the timing
    assert m.nodes["a"].backoff_level == 0          # no backoff charged


def test_unscheduled_exit_backoff_escalates_then_caps():
    m = _monitor(backoff_base=2, backoff_mult=2, backoff_cap=8)
    due = []
    t = 0
    for crash in range(4):
        m.note_exit("a", t, scheduled=False)
        due.append(m.nodes["a"].restart_due - t)
        assert not m.due_restart("a", t + due[-1] - 1)
        assert m.due_restart("a", t + due[-1])
        t += due[-1]
        m.note_joined("a", t)
    assert due == [2, 4, 8, 8]           # base * mult**level, capped


def test_stability_decays_backoff_level():
    m = _monitor(stable_after=2)
    m.note_exit("a", 0, scheduled=False)
    m.note_joined("a", 2)
    assert m.nodes["a"].backoff_level == 1
    m.tick_stability(3)
    assert m.nodes["a"].backoff_level == 1          # not stable yet
    m.tick_stability(4)
    assert m.nodes["a"].backoff_level == 0          # 2 up-ticks: decayed


def test_rejoin_bumps_incarnation_and_version():
    m = _monitor()
    v0 = m.view().version
    m.note_exit("a", 1, scheduled=False)
    m.note_joined("a", 3)
    view = m.view()
    assert dict(view.incarnations)["a"] == 2
    assert view.version > v0
    assert m.nodes["a"].restarts == 1


def test_beat_phases_seeded_and_replayable():
    nodes = [f"m{i}" for i in range(8)]
    a = HeartbeatMonitor(nodes, seed=7, interval=4)
    b = HeartbeatMonitor(nodes, seed=7, interval=4)
    for n in nodes:
        assert [a.beat_due(n, t) for t in range(16)] == \
            [b.beat_due(n, t) for t in range(16)]
        assert sum(a.beat_due(n, t) for t in range(4)) == 1
    c = HeartbeatMonitor(nodes, seed=8, interval=4)
    assert any([a.beat_due(n, t) for t in range(16)]
               != [c.beat_due(n, t) for t in range(16)] for n in nodes)


def test_dead_after_validation():
    with pytest.raises(ValueError):
        HeartbeatMonitor(["a"], suspect_after=3, dead_after=2)


# ---------------------------------------------------------------------------
# adaptive fault policies (pure)
# ---------------------------------------------------------------------------

def test_adaptive_tightens_on_low_ratio_and_floors():
    pol = AdaptivePolicy(base=RetryPolicy(max_attempts=3), base_threshold=3,
                         config=AdaptiveConfig(window=4))
    for _ in range(3 * 4):               # three windows of pure loss
        pol.observe("e", offered=3.0, delivered=0.0)
    assert pol.policy_for("e").max_attempts == 1    # floored, not 0
    assert pol.threshold_for("e") == 1
    assert pol.retunes == 3


def test_adaptive_relaxes_back_to_base_and_ceilings():
    pol = AdaptivePolicy(base=RetryPolicy(max_attempts=3), base_threshold=3,
                         config=AdaptiveConfig(window=2))
    for _ in range(2 * 2):
        pol.observe("e", offered=3.0, delivered=0.0)
    assert pol.policy_for("e").max_attempts == 1
    for _ in range(6 * 2):               # healthy windows walk back up
        pol.observe("e", offered=1.0, delivered=1.0)
    assert pol.policy_for("e") is pol.base          # back at base: identity
    assert pol.threshold_for("e") == 3


def test_adaptive_holds_when_nothing_offered():
    pol = AdaptivePolicy(base=RetryPolicy(max_attempts=3), base_threshold=3,
                         config=AdaptiveConfig(window=2))
    for _ in range(4):                   # breaker short-circuited the window
        pol.observe("e", offered=0.0, delivered=0.0)
    assert pol.policy_for("e").max_attempts == 3    # uninformative: hold
    assert pol.retunes == 2              # the window still closed


def test_adaptive_midband_holds_knobs():
    pol = AdaptivePolicy(base=RetryPolicy(max_attempts=3), base_threshold=3,
                         config=AdaptiveConfig(window=2, ratio_low=0.5,
                                               ratio_high=0.9))
    for _ in range(4):                   # ratio 0.7: between the rails
        pol.observe("e", offered=1.0, delivered=0.7)
    assert pol.policy_for("e").max_attempts == 3


def test_adaptive_state_roundtrip_resumes_mid_window():
    a = AdaptivePolicy(base=DEFAULT_RETRY, base_threshold=3,
                       config=AdaptiveConfig(window=4))
    for i in range(6):                   # one retune + half an open window
        a.observe("e", offered=2.0, delivered=0.0)
    b = AdaptivePolicy(base=DEFAULT_RETRY, base_threshold=3,
                       config=AdaptiveConfig(window=4))
    b.load_state_dict(a.state_dict())
    for p in (a, b):
        p.observe("e", offered=2.0, delivered=0.0)
        p.observe("e", offered=2.0, delivered=0.0)
    assert a.state_dict() == b.state_dict()
    assert a.policy_for("e").max_attempts == b.policy_for("e").max_attempts


# ---------------------------------------------------------------------------
# real worker processes: spawn, echo, SIGKILL, SIGSTOP
# ---------------------------------------------------------------------------

def _supervisor(**kw):
    kw.setdefault("seed", 0)
    kw.setdefault("heartbeat_interval", 1)
    kw.setdefault("suspect_after", 1)
    kw.setdefault("dead_after", 2)
    kw.setdefault("backoff_base", 2)
    kw.setdefault("io_timeout", 0.2)
    return Supervisor(["m0", "m1"], **kw)


def test_workers_spawn_register_and_echo_bit_exact():
    with _supervisor() as sup:
        pids = {n: h.proc.pid for n, h in sup.handles.items()}
        assert len(set(pids.values())) == 2         # two real processes
        topo = topology_lib.star(2)
        chans = sup.edge_channels(topo)
        assert set(chans) == {e.key for e in topo.edges}
        payload = np.random.default_rng(0).bytes(4096)
        chan = next(iter(chans.values()))
        chan.send(payload)
        assert chan.recv(5.0) == payload            # crossed two boundaries
        sup.tick(0)
        sup.tick(1)
        assert sup.membership().mask(["m0", "m1"]).all()


def test_sigkill_walks_ladder_pays_backoff_and_rejoins():
    with _supervisor(backoff_base=2) as sup:
        sup.tick(0)
        sup.kill("m1")                   # UNSCHEDULED: backoff applies
        sup.tick(1)                      # reaped: down, restart due at 3
        assert sup.is_down("m1")
        assert not sup.is_down("m0")     # healthy nodes keep their vote
        assert not sup.membership().mask(["m0", "m1"])[1]
        sup.tick(2)
        assert sup.is_down("m1")         # backoff not elapsed
        sup.tick(3)                      # due: respawned
        assert not sup.is_down("m1")
        view = sup.membership()
        assert dict(view.incarnations)["m1"] == 2
        assert sup.respawns == 1
        assert ("up->down" in [e[2] for e in sup.events() if e[1] == "m1"])


def test_sigstop_suspect_dead_then_thaw_rejoins_same_incarnation():
    # the freeze rides the chaos schedule: tick() realises the window with
    # a real SIGSTOP and thaws with SIGCONT when it closes (a manual
    # freeze() outside any window would be reconciled away next tick)
    from repro_torch.chaos import ChaosSchedule
    chaos = ChaosSchedule().freeze_node("m0", at=1, duration=2)
    with _supervisor(dead_after=2, chaos=chaos) as sup:
        sup.tick(0)
        sup.tick(1)                      # SIGSTOP; probe times out: suspect
        assert sup.monitor.nodes["m0"].status == SUSPECT
        assert sup.handles["m0"].frozen
        assert sup.membership().mask(["m0", "m1"])[0]   # suspects vote
        sup.tick(2)                      # second miss: dead
        assert sup.is_down("m0")
        sup.tick(3)                      # window closed: SIGCONT, pong
        assert not sup.is_down("m0")
        assert dict(sup.membership().incarnations)["m0"] == 1
        assert sup.respawns == 0         # it never restarted


def test_is_down_ignores_unowned_nodes():
    with _supervisor() as sup:
        assert not sup.is_down("fuse")   # not ours: never down on our account


# ---------------------------------------------------------------------------
# parity with the reference's state machines and cluster
# ---------------------------------------------------------------------------

NODES = ["m0", "m1", "m2", "m3"]


def _ladder_stream(HM, seed):
    """A seeded observation stream through one monitor: probes that
    answer or miss, scheduled and unscheduled exits, restarts when due,
    stability ticks.  Returns every step's (view, node records) and the
    events."""
    m = HM(NODES, seed=seed, interval=2, suspect_after=1, dead_after=3,
           backoff_base=1, backoff_mult=2, backoff_cap=8, stable_after=3)
    for n in NODES:
        m.note_joined(n, 0)
    rng = np.random.default_rng((seed, 7))
    trace = []
    for t in range(1, 80):
        for n in NODES:
            u = rng.random()
            if m.due_restart(n, t):
                m.note_joined(n, t)
            elif u < 0.05:
                m.note_exit(n, t, scheduled=bool(rng.random() < 0.5))
            elif m.beat_due(n, t):
                m.observe(n, t, bool(rng.random() < 0.7))
        m.tick_stability(t)
        trace.append((m.view(), {n: vars(h).copy()
                                 for n, h in m.nodes.items()}))
    return trace, list(m.events)


@pytest.mark.parametrize("seed", [0, 3])
def test_ladder_equals_reference_on_a_seeded_stream(seed):
    from repro.cluster.membership import HeartbeatMonitor as JHM
    ref, ref_events = _ladder_stream(JHM, seed)
    port, port_events = _ladder_stream(HeartbeatMonitor, seed)
    assert port_events == ref_events and len(ref_events) > 20
    for (v_ref, h_ref), (v_port, h_port) in zip(ref, port):
        assert (v_port.version, v_port.status, v_port.incarnations) == \
            (v_ref.version, v_ref.status, v_ref.incarnations)
        assert np.array_equal(v_port.mask(NODES), v_ref.mask(NODES))
        assert h_port == h_ref


def test_adaptive_equals_reference_on_a_seeded_stream():
    from repro.transport.adaptive import AdaptiveConfig as JAC
    from repro.transport.adaptive import AdaptivePolicy as JAP
    from repro.transport.policy import RetryPolicy as JRP
    cfg = dict(window=3, ratio_low=0.4, ratio_high=0.8)
    ref = JAP(base=JRP(max_attempts=4), base_threshold=4, config=JAC(**cfg))
    port = AdaptivePolicy(base=RetryPolicy(max_attempts=4),
                          base_threshold=4, config=AdaptiveConfig(**cfg))
    rng = np.random.default_rng(5)
    for _ in range(200):
        key = f"e{int(rng.integers(3))}"
        offered = float(rng.integers(0, 5))
        delivered = float(rng.random()) if offered else 0.0
        ref.observe(key, offered=offered, delivered=delivered)
        port.observe(key, offered=offered, delivered=delivered)
        assert port.state_dict() == ref.state_dict()
        assert port.policy_for(key).max_attempts == \
            ref.policy_for(key).max_attempts
        assert port.threshold_for(key) == ref.threshold_for(key)
    assert ref.retunes > 20


def _cluster_masks(side):
    """A 3-node cluster of real workers of one package under a scripted
    SIGKILL and SIGSTOP: (masks, membership events, incarnations,
    respawns)."""
    if side == "ref":
        from repro.chaos import ChaosSchedule as CS
        from repro.cluster import Cluster as CL
        from repro.transport import NO_RETRY as NR
    else:
        from repro_torch.chaos import ChaosSchedule as CS
        from repro_torch.cluster import Cluster as CL
        from repro_torch.transport import NO_RETRY as NR
    import dataclasses
    from tests._schemes_common import CFG
    cfg = dataclasses.replace(CFG, num_clients=3, noise_stds=(0.4, 1.0, 2.0))
    sched = CS().kill_node("m1", at=2, duration=2) \
        .freeze_node("m2", at=5, duration=2)
    with CL(cfg, seed=0, chaos=sched, policy=NR, breaker=None,
            io_timeout=0.2) as cl:
        masks = [cl.transport.round_outcome(t, 32).mask.tolist()
                 for t in range(9)]
        return (masks, cl.supervisor.events(),
                dict(cl.supervisor.membership().incarnations),
                cl.supervisor.respawns)


def test_cluster_masks_equal_reference_and_the_scheduled_windows():
    ref, port = _cluster_masks("ref"), _cluster_masks("port")
    assert port == ref
    masks, events, incarnations, respawns = port
    for t, row in enumerate(masks):
        assert row == [True, not 2 <= t < 4, not 5 <= t < 7], (t, row)
    assert incarnations == {"m0": 1, "m1": 2, "m2": 1} and respawns == 1
    assert [e[2] for e in events if e[1] == "m2"][-1] == "down->up"

