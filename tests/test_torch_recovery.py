"""Resume in the port's runner (run_scheme's ckpt_dir / ckpt_every /
resume) is bit-identical to the uninterrupted run, on the CPU.

The twins of tests/test_recovery.py:43-61 and
tests/test_hybrid_schemes.py:214-226, for all six golden runs (inl, fl,
sl, inl+learned_prior, splitfed, hybrid), under dispatch "scan" and
"per_round", on the clean star and at erasure 0.3 an edge:
  * a run of 2 epochs against a run of 1 epoch with `ckpt_dir` and then
    `resume=True` to 2: the curves equal (`CurvePoint`s with ==), every
    state leaf of the two final checkpoints bit for bit, both meters'
    ledgers (per edge too) and the round generator's saved state;
and for INL:
  * `edge_dropout=0.3` over 4 epochs, resumed at 2, `ckpt_every=2`
    writing epochs 2 and 4 only;
  * a directory whose newest npz lacks its sidecar (a save killed between
    the two files) resumes from the checkpoint before it, bit-identical;
  * a finished run resumes to its saved curve; a checkpoint whose
    generator drew on another device type is refused;
  * `run_scheme(transport=)`, the reference's
    test_transport_resume_replays_breakers_without_recharging, under both
    dispatches and with an adaptive controller: bit for bit, the
    transport's snapshot included.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.paper_inl import PaperExperimentConfig  # noqa: E402
from repro_torch.core import bandwidth, linkfault, topology  # noqa: E402
from repro_torch.core.schemes import runner  # noqa: E402
from repro_torch.data import multiview  # noqa: E402

CFG = PaperExperimentConfig(conv_channels=(4,), d_bottleneck=8,
                            dense_units=(32,), image_shape=(16, 16, 3),
                            dataset_size=128)
BATCH = 8
SCHEMES = (("inl", CFG), ("inl+learned_prior",
                          dataclasses.replace(CFG, learned_prior=True)),
           ("sl", CFG), ("fl", CFG), ("splitfed", CFG), ("hybrid", CFG))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the workers of a parallel
    test run share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n):
    imgs, labels = multiview.make_base_dataset(
        n, image_shape=CFG.image_shape, seed=0)
    return multiview.make_views(imgs, CFG.noise_stds), labels


def _run(name, cfg, views, labels, epochs, **kw):
    meter = bandwidth.BandwidthMeter()
    curve = runner.run_scheme(name, views, labels, cfg, epochs=epochs,
                              batch_size=BATCH, eval_n=24, seed=3,
                              meter=meter, device="cpu", **kw)
    return curve, meter


def _assert_same_checkpoint(d1, d2, step):
    """Two runs' checkpoints of `step`: every array bit for bit, and the
    sidecars (curve, ledgers, generator state) equal."""
    p1, p2 = (os.path.join(d, f"ckpt_{step:08d}.npz") for d in (d1, d2))
    with np.load(p1) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files) and a.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    assert checkpoint.load_meta(d1, step) == checkpoint.load_meta(d2, step)


def _assert_same_meter(a, b):
    assert runner._meter_dump(a) == runner._meter_dump(b)


def _resume_case(name, cfg, views, labels, tmp_path, *, epochs, half,
                 **kw):
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    golden, gmeter = _run(name, cfg, views, labels, epochs,
                          ckpt_dir=full_dir, **kw)
    first, _ = _run(name, cfg, views, labels, half, ckpt_dir=part_dir, **kw)
    assert first == golden[:half]
    resumed, rmeter = _run(name, cfg, views, labels, epochs,
                           ckpt_dir=part_dir, resume=True, **kw)
    assert resumed == golden            # CurvePoints compare exactly
    _assert_same_meter(gmeter, rmeter)
    _assert_same_checkpoint(full_dir, part_dir, epochs)
    return golden, gmeter


@pytest.mark.parametrize("lossy", [False, True], ids=["clean", "erasure"])
@pytest.mark.parametrize("dispatch", ["scan", "per_round"])
@pytest.mark.parametrize("label, cfg", SCHEMES, ids=[s for s, _ in SCHEMES])
def test_resume_bit_identical(label, cfg, dispatch, lossy, tmp_path):
    name = label.split("+")[0]
    # two epochs of one FL round (10 minibatches), of three other rounds
    views, labels = _data(80 if name == "fl" else 24)
    topo = linkfault.with_links(topology.star(cfg.num_clients),
                                linkfault.LinkModel(erasure=0.3)) \
        if lossy else None
    golden, meter = _resume_case(name, cfg, views, labels, tmp_path,
                                 epochs=2, half=1, dispatch=dispatch,
                                 topology=topo)
    assert golden[-1].gbits > 0
    assert (meter.delivery_ratio < 1.0) == lossy


def test_resume_bit_identical_under_edge_dropout(tmp_path):
    """The reference's EPOCHS=4 / HALF=2 under cfg.edge_dropout=0.3, with
    a checkpoint every second epoch."""
    cfg = dataclasses.replace(CFG, edge_dropout=0.3)
    views, labels = _data(24)
    _resume_case("inl", cfg, views, labels, tmp_path, epochs=4, half=2,
                 ckpt_every=2)
    assert sorted(os.listdir(tmp_path / "full")) == [
        "ckpt_00000002.json", "ckpt_00000002.npz", "ckpt_00000004.json",
        "ckpt_00000004.npz"]


def test_a_torn_newest_checkpoint_resumes_from_the_one_before(tmp_path):
    views, labels = _data(24)
    golden, _ = _run("inl", CFG, views, labels, 3)
    d = str(tmp_path)
    _run("inl", CFG, views, labels, 2, ckpt_dir=d)
    # killed between the npz's replace and the sidecar's
    os.remove(os.path.join(d, "ckpt_00000002.json"))
    assert checkpoint.latest_step(d) == 1
    resumed, _ = _run("inl", CFG, views, labels, 3, ckpt_dir=d, resume=True)
    assert resumed == golden


def test_finished_runs_and_foreign_generators(tmp_path):
    views, labels = _data(24)
    d = str(tmp_path)
    golden, _ = _run("inl", CFG, views, labels, 2, ckpt_dir=d)
    again, _ = _run("inl", CFG, views, labels, 2, ckpt_dir=d, resume=True)
    assert again == golden
    meta_path = os.path.join(d, "ckpt_00000002.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["scheme"] == "inl" and meta["epoch"] == 2
    assert len(meta["curve"]) == 2 and meta["generator"]["device"] == "cpu"
    meta["generator"]["device"] = "cuda"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="device type that wrote it"):
        _run("inl", CFG, views, labels, 3, ckpt_dir=d, resume=True)


def _transport(chaos=None, adaptive=False, seed=7):
    from repro_torch.transport import (DEFAULT_RETRY, AdaptiveConfig,
                                       AdaptivePolicy, NetworkTransport)
    topo = linkfault.with_links(topology.star(CFG.num_clients),
                                linkfault.LinkModel(erasure=0.2))
    return NetworkTransport(
        topo, CFG, seed=seed, policy=DEFAULT_RETRY, chaos=chaos,
        adaptive=AdaptivePolicy(config=AdaptiveConfig(window=3))
        if adaptive else None)


@pytest.mark.parametrize("dispatch", ["scan", "per_round"])
def test_transport_resume_replays_breakers_without_recharging(dispatch,
                                                              tmp_path):
    """The reference's twin (EPOCHS=4, HALF=2, m0->fuse down at ticks 1-2),
    with an adaptive controller: the resumed run replays the completed
    ticks without touching the restored ledgers, so its curve, final
    checkpoint (state, ledgers, generator, the transport snapshot) and
    snapshot equal the uninterrupted run's bit for bit."""
    from repro_torch.chaos import ChaosSchedule
    chaos = ChaosSchedule().down_edge("m0->fuse", 1, 2)
    views, labels = _data(24)
    kw = dict(batch_size=BATCH, eval_n=24, seed=3, device="cpu",
              dispatch=dispatch)
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    tg = _transport(chaos, adaptive=True)
    golden = runner.run_scheme("inl", views, labels, CFG, epochs=4,
                               transport=tg, ckpt_dir=full_dir, **kw)
    gsnap = tg.snapshot()
    tg.close()
    t1 = _transport(chaos, adaptive=True)
    first = runner.run_scheme("inl", views, labels, CFG, epochs=2,
                              transport=t1, ckpt_dir=part_dir, **kw)
    t1.close()
    assert first == golden[:2]
    t2 = _transport(chaos, adaptive=True)
    resumed = runner.run_scheme("inl", views, labels, CFG, epochs=4,
                                transport=t2, ckpt_dir=part_dir,
                                resume=True, **kw)
    rsnap = t2.snapshot()
    t2.close()
    assert resumed == golden
    assert gsnap == rsnap           # ledgers, breaker counters, adaptive
    assert gsnap["adaptive"]["retunes"] > 0
    assert gsnap["breaker"]["m0->fuse"]["opens"] > 0
    assert gsnap["delivery_ratio"] < 1.0
    _assert_same_checkpoint(full_dir, part_dir, 4)
    assert checkpoint.load_meta(part_dir, 4)["transport"] == gsnap
