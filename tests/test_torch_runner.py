"""The port's training runner (repro_torch/core/schemes/runner) against the
JAX reference's.

  * `run_scheme("inl")` on tests/_schemes_common.CFG for two epochs: one
    curve point per epoch, accuracy above the untrained model's;
  * both bandwidth ledgers (`gbits`, `measured_gbits`, and the meter's
    per-edge ledgers) equal, exactly, what the reference's `run_scheme`
    meters for the same settings: the closed forms do not depend on the
    weights or the random streams;
  * `transport=` runs (a lossy star's NetworkTransport, whose meter is
    the run's); a mesh that is not a ('client', 'data') mesh, a
    mesh under dispatch="per_round" or beside transport=, and a packed wire
    at an unpackable width (CFG's 32 bits) raise ValueError with the
    reference's messages (dispatch="scan", the default, runs:
    tests/test_torch_dispatch.py; run_scheme(mesh=) on a mesh:
    tests/test_torch_sharded.py);
    `ckpt_dir=` with `resume=True` on an empty directory trains from
    scratch and leaves its checkpoint (resume: tests/test_torch_recovery.py);
  * `run_scheme(transport=)` for INL, FL and SL under both dispatches
    equals, bit for bit, per-round `make_transport_round` calls on the
    masks of a second transport built with the same seed, and its curve's
    `gbits`, `measured_gbits` and `delivered_gbits` and the per-edge
    ledgers equal the reference's `run_scheme(transport=)` exactly;
    `meter=` beside `transport=` raises the reference's ValueError.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _schemes_common import CFG  # noqa: E402

from repro.core import bandwidth as jbw  # noqa: E402
from repro.core.schemes import runner as jrunner  # noqa: E402
from repro.data import multiview  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import schemes, topology  # noqa: E402
from repro_torch.core.schemes import base, runner  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402

N, BATCH, EPOCHS = 256, 32, 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the workers of a parallel
    test run share the machine's cores)."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def _data():
    imgs, labels = multiview.make_base_dataset(
        N, image_shape=CFG.image_shape, seed=0)
    return multiview.make_views(imgs, CFG.noise_stds), labels


def test_run_scheme_trains_and_meters_as_the_reference():
    views, labels = _data()
    meter = tbw.BandwidthMeter()
    curve = runner.run_scheme("inl", views, labels, CFG, epochs=EPOCHS,
                              batch_size=BATCH, eval_n=N, meter=meter,
                              device="cpu")
    assert [p.epoch for p in curve] == list(range(1, EPOCHS + 1))
    jmeter = jbw.BandwidthMeter()
    jcurve = jrunner.run_scheme("inl", views, labels, CFG, epochs=EPOCHS,
                                batch_size=BATCH, eval_n=N, meter=jmeter,
                                dispatch="per_round")
    for p, q in zip(curve, jcurve):
        assert (p.gbits, p.measured_gbits, p.delivered_gbits) == \
            (q.gbits, q.measured_gbits, q.delivered_gbits)
    assert meter.edge_bits == jmeter.edge_bits
    assert meter.edge_measured_bytes == jmeter.edge_measured_bytes
    assert meter.delivery_ratio == 1.0
    # (J x d x 32 bits) x 2 directions x batch x rounds, closed form
    rounds = runner.rounds_per_epoch(schemes.get("inl"), CFG, N, BATCH)
    assert rounds == N // BATCH
    assert curve[-1].gbits == pytest.approx(
        EPOCHS * rounds * 2 * BATCH * CFG.num_clients * CFG.d_bottleneck
        * CFG.link_bits / 1e9, rel=1e-12)
    # the port learns: above the untrained model, as the reference does
    untrained = base.evaluate_accuracy(
        schemes.get("inl"),
        schemes.get("inl").init(CFG, torch.Generator().manual_seed(0),
                                device="cpu"),
        views, labels, device="cpu")
    assert curve[-1].accuracy > untrained + 0.1
    assert jcurve[-1].accuracy > untrained + 0.1
    assert runner.efficiency(curve) == curve[-1].accuracy / curve[-1].gbits


@pytest.mark.parametrize("kw, err, match", [
    ({"dispatch": "bogus"}, ValueError, "unknown dispatch"),
    ({"mesh": object()}, ValueError,
     "sharded schemes need a 'client' mesh axis; got ()"),
    ({"transport": "lossy star"}, None, None),
    ({"ckpt_dir": None, "resume": True}, None, None),
    ({"wire": "packed"}, ValueError, "packable"),
    # per-edge widths run; a packed wire refuses an unpackable edge
    ({"topology": topology.star(CFG.num_clients,
                                link_bits=(4,) * (CFG.num_clients - 1)
                                + (32,)),
      "wire": "packed"}, ValueError, "packable"),
    ({"mesh": object(), "dispatch": "per_round"}, ValueError,
     "mesh execution needs dispatch='scan'"),
    ({"mesh": object(), "transport": object()}, ValueError,
     "transport execution is per-round; no mesh"),
], ids=["unknown", "mesh", "transport", "ckpt", "packed",
        "per-edge-widths", "mesh-per-round", "mesh-transport"])
def test_deferred_options_raise(kw, err, match, tmp_path):
    views, labels = _data()
    if kw.get("transport") == "lossy star":
        # the transport slice's option runs, metering on the transport
        tr = _transport("inl", "port", seed=1)
        curve = runner.run_scheme("inl", views[:, :BATCH], labels[:BATCH],
                                  CFG, epochs=1, batch_size=BATCH,
                                  device="cpu", transport=tr)
        tr.close()
        assert [p.epoch for p in curve] == [1]
        assert curve[0].gbits == tr.meter.gbits > 0
        return
    if err is None:
        # the checkpoint slice's options run: an empty directory resumes
        # from nothing and holds the run's checkpoint afterwards
        kw = dict(kw, ckpt_dir=str(tmp_path))
        curve = runner.run_scheme("inl", views[:, :BATCH], labels[:BATCH],
                                  CFG, epochs=1, batch_size=BATCH,
                                  device="cpu", **kw)
        assert [p.epoch for p in curve] == [1]
        assert checkpoint.latest_step(str(tmp_path)) == 1
        return
    with pytest.raises(err, match=match):
        runner.run_scheme("inl", views[:, :BATCH], labels[:BATCH], CFG,
                          epochs=1, batch_size=BATCH, device="cpu", **kw)


def test_run_all_and_empty_curve():
    views, labels = _data()
    with pytest.raises(ValueError, match="meter="):
        runner.run_all(["inl", "inl"], views, labels, CFG, epochs=1,
                       meter=tbw.BandwidthMeter(), device="cpu")
    assert runner.efficiency([]) == 0.0
    out = runner.run_all(["inl"], views[:, :BATCH], labels[:BATCH], CFG,
                         epochs=1, batch_size=BATCH, device="cpu")
    assert list(out) == ["inl"] and len(out["inl"]) == 1
    # fewer samples than a batch: no round runs, the epoch still evaluates
    curve = runner.run_scheme("inl", views[:, :4], labels[:4], CFG,
                              epochs=1, batch_size=BATCH, device="cpu")
    assert len(curve) == 1 and curve[0].gbits == 0.0


def test_epoch_fn_equals_per_round_calls():
    """make_epoch's loop draws from the generator exactly as K separate
    rounds would: the same state bit for bit."""
    views, labels = _data()
    scheme = schemes.get("inl")
    v = torch.from_numpy(views[:, :2 * BATCH]).reshape(
        CFG.num_clients, 2, 1, BATCH, *CFG.image_shape).permute(
            1, 2, 0, 3, 4, 5, 6)                       # (K, R, J, B, ...)
    lab = torch.from_numpy(labels[:2 * BATCH]).long().reshape(2, 1, BATCH)
    init = scheme.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    st_e, metrics = scheme.make_epoch(CFG)(init, v, lab,
                                           torch.Generator().manual_seed(1))
    assert metrics["loss"].shape == (2,)
    round_fn = scheme.make_round(CFG)
    g = torch.Generator().manual_seed(1)
    st_r = init
    for k in range(2):
        st_r, _ = round_fn(st_r, v[k], lab[k], g)
    from repro_torch import tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st_e),
                                                  tree_leaves(st_r)))
    # a mesh needs ('client', 'data') axes: the reference's check_mesh
    with pytest.raises(ValueError, match="sharded schemes need a 'client' "
                                         "mesh axis"):
        scheme.make_epoch(CFG, mesh=object())


# ---------------------------------------------------------------------------
# run_scheme(transport=)
# ---------------------------------------------------------------------------

T_BATCH = 8
TRANSPORT_N = 10 * T_BATCH       # an epoch: one FL round, 10 INL/SL rounds


def _transport(name, side, seed=4):
    """A lossy star's NetworkTransport (erasure 0.3, latency against a
    deadline, m1 killed at ticks 2-4, m3's edge flapping) of one
    package."""
    if side == "ref":
        from repro.chaos import ChaosSchedule
        from repro.core import linkfault as lf
        from repro.core import topology as topo_lib
        from repro.transport import DEFAULT_RETRY, NetworkTransport
    else:
        from repro_torch.chaos import ChaosSchedule
        from repro_torch.core import linkfault as lf
        from repro_torch.core import topology as topo_lib
        from repro_torch.transport import DEFAULT_RETRY, NetworkTransport
    cfg = dataclasses.replace(CFG, fusion_deadline_ms=25.0)
    topo = lf.with_links(topo_lib.star(CFG.num_clients),
                         lf.LinkModel(erasure=0.3, latency_ms=5.0,
                                      jitter_ms=10.0))
    chaos = ChaosSchedule().kill_node("m1", at=2, duration=3) \
        .flap_edge("m3->fuse", start=0, stop=12, period=2)
    return NetworkTransport(topo, cfg, seed=seed, policy=DEFAULT_RETRY,
                            chaos=chaos)


@pytest.fixture(scope="module")
def transport_data():
    imgs, labels = multiview.make_base_dataset(
        TRANSPORT_N, image_shape=CFG.image_shape, seed=0)
    return multiview.make_views(imgs, CFG.noise_stds), labels


@pytest.mark.parametrize("dispatch", ["scan", "per_round"])
@pytest.mark.parametrize("name", ["inl", "fl", "sl"])
def test_run_scheme_transport_equals_per_round_replay(name, dispatch,
                                                      transport_data):
    views, labels = transport_data
    scheme = schemes.get(name)
    attr = "make_transport_epoch" if dispatch == "scan" \
        else "make_transport_round"
    make, finals = getattr(scheme, attr), []

    def recording(*a, **kw):
        fn = make(*a, **kw)

        def rec(*ra, **rkw):
            out = fn(*ra, **rkw)
            finals.append(out[0])
            return out
        return rec
    setattr(scheme, attr, recording)
    tr = _transport(name, "port")
    try:
        curve = runner.run_scheme(name, views, labels, CFG, epochs=2,
                                  batch_size=T_BATCH, eval_n=40, seed=2,
                                  dispatch=dispatch, transport=tr,
                                  device="cpu")
    finally:
        delattr(scheme, attr)
        tr.close()
    # the replay: a second transport from the same seed gives the masks
    twin = _transport(name, "port")
    bpr = scheme.batches_per_round(CFG)
    rounds = runner.rounds_per_epoch(scheme, CFG, TRANSPORT_N, T_BATCH)
    state = scheme.init(CFG, torch.Generator().manual_seed(2),
                        device="cpu")
    gen = torch.Generator().manual_seed(3)
    round_fn = scheme.make_transport_round(CFG)
    tv, tl = torch.from_numpy(views), torch.from_numpy(labels).long()
    masks = []
    for ep in range(2):
        ev, el = runner.epoch_batches(tv, tl, ep, rounds, bpr, T_BATCH)
        for r in range(rounds):
            mask = twin.round_outcome(ep * rounds + r, T_BATCH,
                                      charge=False).mask
            masks.append(mask)
            state, _ = round_fn(state, ev[r], el[r], gen, mask)
    twin.close()
    masks = np.stack(masks)
    assert masks.any() and not masks.all()
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(finals[-1]), tree_leaves(state)))
    assert len(curve) == 2 and curve[-1].delivered_gbits < curve[-1].gbits


@pytest.mark.parametrize("name", ["inl", "fl", "sl"])
def test_transport_ledgers_equal_the_reference(name, transport_data):
    views, labels = transport_data
    tr = _transport(name, "port")
    curve = runner.run_scheme(name, views, labels, CFG, epochs=2,
                              batch_size=T_BATCH, eval_n=40, transport=tr,
                              device="cpu")
    tr.close()
    jtr = _transport(name, "ref")
    jcurve = jrunner.run_scheme(name, views, labels, CFG, epochs=2,
                                batch_size=T_BATCH, eval_n=40, transport=jtr)
    jtr.close()
    for p, q in zip(curve, jcurve):
        assert (p.gbits, p.measured_gbits, p.delivered_gbits) == \
            (q.gbits, q.measured_gbits, q.delivered_gbits)
    assert runner._meter_dump(tr.meter) == jrunner._meter_dump(jtr.meter)
    assert tr.snapshot() == jtr.snapshot()
    assert 0 < curve[-1].delivered_gbits < curve[-1].gbits


def test_transport_refuses_a_foreign_meter():
    views, labels = _data()
    tr = _transport("inl", "port")
    with pytest.raises(ValueError, match="meter"):
        runner.run_scheme("inl", views, labels, CFG, epochs=1,
                          batch_size=T_BATCH, transport=tr,
                          meter=tbw.BandwidthMeter(), device="cpu")
    tr.close()
