"""The port's training runner (repro_torch/core/schemes/runner) against the
JAX reference's.

  * `run_scheme("inl")` on tests/_schemes_common.CFG for two epochs: one
    curve point per epoch, accuracy above the untrained model's;
  * both bandwidth ledgers (`gbits`, `measured_gbits`, and the meter's
    per-edge ledgers) equal, exactly, what the reference's `run_scheme`
    meters for the same settings: the closed forms do not depend on the
    weights or the random streams;
  * the options that come with later slices raise NotImplementedError, and
    a packed wire at an unpackable width (CFG's 32 bits) a ValueError
    (dispatch="scan", the default, runs: tests/test_torch_dispatch.py);
    `ckpt_dir=` with `resume=True` on an empty directory trains from
    scratch and leaves its checkpoint (resume: tests/test_torch_recovery.py).
"""
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

N, BATCH, EPOCHS = 256, 32, 2


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
    ({"mesh": object()}, NotImplementedError, "sharded slice"),
    ({"transport": object()}, NotImplementedError, "transport slice"),
    ({"ckpt_dir": None, "resume": True}, None, None),
    ({"wire": "packed"}, ValueError, "packable"),
    # per-edge widths run; a packed wire refuses an unpackable edge
    ({"topology": topology.star(CFG.num_clients,
                                link_bits=(4,) * (CFG.num_clients - 1)
                                + (32,)),
      "wire": "packed"}, ValueError, "packable"),
], ids=["unknown", "mesh", "transport", "ckpt", "packed",
        "per-edge-widths"])
def test_deferred_options_raise(kw, err, match, tmp_path):
    views, labels = _data()
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
    with pytest.raises(NotImplementedError, match="sharded"):
        scheme.make_epoch(CFG, mesh=object())
