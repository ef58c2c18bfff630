"""The port's serving plane (repro_torch/serving), mirroring
tests/test_serving.py and the engine units of tests/test_cluster.py.

  * the bucket helpers;
  * clean serving equals the reference's jitted predict on converted
    weights within atol 1e-5, and meters delivered == offered;
  * within a bucket, padding and batch composition cannot move any
    request's output, bit for bit;
  * across buckets, float tolerance and identical decisions;
  * FIFO drain, the wrong view count, scheduler-error propagation,
    max_queue shedding and graceful shutdown;
  * a deadline and link models on the edges (a lossy star, a chain with a
    lossy last hop) serve rows equal to `predict_batched` under the
    request-id-keyed masks, and meter the masks' payload fraction;
  * over a transport (repro_torch/transport): speculative fusion needs a
    transport (the reference's ValueError); stragglers are patched into
    the next bucket; a hard outage credits nothing delivered; on a lossy
    star with a deadline the port's engine and the reference's, each over
    its own package's transport from one seed, give the same masks,
    `served_by`, `patched`, `views_recovered` and ledgers exactly and the
    same probabilities within atol 1e-5;
  * loadgen's guards (percentiles of 0 and 1 samples, 0 and 1 requests),
    `--requests` clamping, and the `--arch paper-inl` front end on the CPU
    (transport, speculative fusion, a deadline; a checkpoint written by
    the reference served through `--ckpt-dir`).
"""
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import inl as jinl  # noqa: E402
from repro.serving import metering as jmetering  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch.core import linkfault, schemes  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.serving import (EngineShutdown, Rejected,  # noqa: E402
                                 ServingEngine, batching, metering)
from tests._schemes_common import CFG  # noqa: E402
from tests._torch_common import jax_inl, torch_inl, views_np  # noqa: E402

N_VIEWS = 24


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the workers of a parallel
    test run share the machine's cores)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inl():
    scheme = schemes.get("inl")
    params, state = torch_inl(CFG)
    return scheme, {"params": params, "state": state}, views_np(CFG, N_VIEWS)


def _engine(**kw):
    scheme, state, views = _inl()
    return ServingEngine(scheme, state, CFG, device="cpu", **kw), views


def _jax_predict(views):
    jp, js = jax_inl(CFG)
    return np.asarray(jax.jit(lambda p, s, v: jinl.predict(p, s, v))(
        jp, js, jnp.asarray(views)))


# ---------------------------------------------------------------------------
# bucket grid
# ---------------------------------------------------------------------------

def test_bucket_helpers():
    assert batching.validate_buckets([16, 1, 4, 4]) == (1, 4, 16)
    assert batching.pick_bucket(1, (1, 4, 16)) == 1
    assert batching.pick_bucket(5, (1, 4, 16)) == 16
    with pytest.raises(ValueError):
        batching.pick_bucket(17, (1, 4, 16))
    with pytest.raises(ValueError):
        batching.validate_buckets([])
    v = np.arange(2 * 3 * 5, dtype=np.float32).reshape(2, 3, 5)
    pv, pr = batching.pad_to_bucket(v, np.arange(3, dtype=np.int32), 4)
    assert pv.shape == (2, 4, 5) and pr.tolist() == [0, 1, 2, 2]
    assert np.array_equal(pv[:, 3], v[:, 2])      # pad repeats the last row


# ---------------------------------------------------------------------------
# clean serving == the reference's jitted predict
# ---------------------------------------------------------------------------

def test_clean_serving_matches_jitted_predict():
    engine, views = _engine()
    engine.warmup()
    with engine:
        probs, results = engine.serve(views[:, :23])
    ref = _jax_predict(views[:, :23])
    np.testing.assert_allclose(probs, ref, rtol=0, atol=1e-5)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 1e-4
    assert np.array_equal(np.argmax(probs, -1)[decided],
                          np.argmax(ref, -1)[decided])
    assert all(r.views_fused == CFG.num_clients for r in results)
    assert {r.bucket for r in results} == {64}
    assert engine.meter.total_bits > 0
    assert engine.meter.delivery_ratio == 1.0


def test_metering_matches_the_reference():
    topo_t, topo_j = ttopo.star(CFG.num_clients), jtopo.star(CFG.num_clients)
    assert metering.request_edge_bits(topo_t, CFG) == \
        jmetering.request_edge_bits(topo_j, CFG)
    assert metering.request_edge_wire_bytes(topo_t, CFG) == \
        jmetering.request_edge_wire_bytes(topo_j, CFG)
    engine, views = _engine()
    with engine:
        engine.serve(views[:, :5])
    assert engine.meter.total_bits == \
        5 * metering.request_bits(topo_t, CFG)
    assert engine.meter.measured_bytes == 5 * sum(
        jmetering.request_edge_wire_bytes(topo_j, CFG).values())


def test_padding_and_composition_bit_exact_within_bucket():
    """Two batches that land in the SAME bucket must give every shared
    request a bitwise identical answer, however much padding or however
    many other requests ride along."""
    a, views = _engine()
    with a:
        pa, ra = a.serve(views[:, :7])             # 7 padded to 16
    b, _ = _engine()
    with b:
        pb, rb = b.serve(views[:, :13])            # the same 7 plus 6 more
    assert {r.bucket for r in ra} == {r.bucket for r in rb} == {16}
    assert np.array_equal(pa, pb[:7]), \
        "batch composition moved a request's output inside one bucket"


def test_cross_bucket_agreement():
    """Across bucket sizes, outputs agree to float tolerance with identical
    decisions (each batch shape may take another algorithm)."""
    outs = []
    for split in ((7,), (1,) * 7, (3, 4)):
        engine, views = _engine()
        got, i = [], 0
        with engine:
            for k in split:
                p, _ = engine.serve(views[:, i:i + k])
                got.append(p)
                i += k
        outs.append(np.concatenate(got))
    for other in outs[1:]:
        np.testing.assert_allclose(outs[0], other, rtol=0, atol=2e-6)
        assert np.array_equal(np.argmax(outs[0], -1), np.argmax(other, -1))


# ---------------------------------------------------------------------------
# scheduler behaviour
# ---------------------------------------------------------------------------

def test_queue_drain_fifo_under_seeded_arrival_stream():
    engine, views = _engine()
    engine.warmup()
    rng = np.random.default_rng(0)
    n = 20
    futs = []
    with engine:
        for i in range(n):
            rid, fut = engine.submit(views[:, i])
            assert rid == i
            futs.append(fut)
            if rng.random() < 0.3:
                time.sleep(float(rng.exponential(0.002)))
    assert all(f.done() for f in futs)
    assert engine.pending() == 0 and engine.stats.completed == n
    results = [f.result(timeout=1.0) for f in futs]
    assert [r.rid for r in results] == list(range(n))
    t = [r.t_done for r in results]
    assert all(x <= y + 1e-9 for x, y in zip(t, t[1:]))
    np.testing.assert_allclose(np.stack([r.probs for r in results]),
                               _jax_predict(views[:, :n]), rtol=0, atol=1e-5)


def test_submit_rejects_wrong_view_count():
    engine, views = _engine()
    with pytest.raises(ValueError, match="views"):
        engine.submit(views[:3, 0])


def test_scheduler_exception_fails_pending_then_poisons_engine():
    engine, views = _engine()
    boom = ValueError("injected scheduler failure")

    def bad_execute(rids, batch):
        raise boom
    engine._execute = bad_execute
    engine.start()
    _, fut = engine.submit(views[:, 0])
    assert fut.exception(timeout=5.0) is boom
    assert engine.pending() == 0
    with pytest.raises(RuntimeError, match="scheduler failed") as ei:
        engine.submit(views[:, 1])
    assert ei.value.__cause__ is boom
    with pytest.raises(RuntimeError, match="scheduler failed"):
        engine.stop()
    with pytest.raises(RuntimeError) as ei:
        engine.stop()
    assert ei.value.__cause__ is boom


def test_scheduler_exception_does_not_mask_body_exception():
    engine, views = _engine()
    engine._execute = lambda rids, batch: (_ for _ in ()).throw(
        RuntimeError("scheduler died too"))
    with pytest.raises(KeyError, match="body wins"):
        with engine:
            _, fut = engine.submit(views[:, 0])
            fut.exception(timeout=5.0)
            raise KeyError("body wins")


def test_inline_step_surfaces_scheduler_error():
    engine, _ = _engine()
    engine._error = ValueError("poisoned")
    with pytest.raises(RuntimeError, match="scheduler failed"):
        engine.step()


def test_bounded_queue_sheds_with_typed_rejected():
    engine, views = _engine(max_queue=2)
    futs = [engine.submit(views[:, i])[1] for i in range(5)]
    shed = [f for f in futs if f.done() and isinstance(f.result(), Rejected)]
    assert len(shed) == 3 and engine.stats.shed == 3
    assert all(r.result().reason for r in shed)
    while engine.pending():
        engine.step()
    served = [f.result() for f in futs
              if not isinstance(f.result(), Rejected)]
    assert len(served) == 2 and all(r.probs.shape[-1] == 10 for r in served)


def test_shutdown_fails_pending_futures_and_refuses_new_submits():
    engine, views = _engine()
    futs = [engine.submit(views[:, i])[1] for i in range(3)]
    engine.shutdown(drain_timeout=0.0)
    for f in futs:
        with pytest.raises(EngineShutdown):
            f.result(timeout=1.0)
    with pytest.raises(EngineShutdown):
        engine.submit(views[:, 0])
    engine.shutdown()                    # idempotent


def test_shutdown_with_budget_drains_then_stops():
    engine, views = _engine()
    futs = [engine.submit(views[:, i])[1] for i in range(3)]
    engine.shutdown(drain_timeout=30.0)
    assert all(f.done() for f in futs)
    assert all(not isinstance(f.result(), Rejected) for f in futs)
    assert engine.pending() == 0


# ---------------------------------------------------------------------------
# unreliable links: deadlines and link models on the edges
# ---------------------------------------------------------------------------

LOSSY = linkfault.LinkModel(erasure=0.3)


def _relay_chain():
    """m0 -> r1 -> ... -> fuse with a lossy last edge, which carries every
    view's latent."""
    chain = ttopo.chain(CFG.num_clients)
    return linkfault.with_links(chain, {chain.edges[-1].key: LOSSY})


@pytest.mark.parametrize("option", ["deadline", "lossy star", "lossy chain"])
def test_faulty_serving_options(option):
    """Each request's rows equal predict_batched under its request-id-keyed
    mask, bit for bit in its bucket; views_fused and the delivered ledger
    follow the same masks."""
    scheme, state, views = _inl()
    kw = {"deadline": dict(deadline_ms=10.0),
          "lossy star": dict(topology=linkfault.with_links(
              ttopo.star(CFG.num_clients), LOSSY), seed=3),
          "lossy chain": dict(topology=_relay_chain(), seed=4)}[option]
    engine = ServingEngine(scheme, state, CFG, device="cpu", **kw)
    assert engine.faulty
    with engine:
        probs, results = engine.serve(views[:, :7])    # one bucket of 16
    rids = np.array([r.rid for r in results])
    mask = linkfault.request_delivery_mask(
        linkfault.key(kw.get("seed", 0)), engine.topo, CFG, rids,
        deadline=kw.get("deadline_ms"))
    idx = list(range(7)) + [6] * 9
    want = scheme.predict_batched(
        state, views[:, idx], topology=kw.get("topology"), cfg=CFG,
        delivery=mask[:, idx], device="cpu").numpy()[:7]
    assert np.array_equal(probs, want)
    assert [r.views_fused for r in results] == mask.sum(0).tolist()
    if option == "deadline":          # no link model: every view arrives
        assert mask.all() and engine.meter.delivery_ratio == 1.0
    else:
        assert not mask.all()
    offered = engine.meter.edge_bits
    frac = {e.key: mask[list(engine.topo.payload(e))].mean()
            for e in engine.topo.edges}
    for k, bits in offered.items():
        assert np.isclose(engine.meter.edge_delivered_bits[k],
                          bits * frac[k], rtol=1e-12)


# ---------------------------------------------------------------------------
# the transport slice's options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option, slice_name", [
    (dict(transport="loopback"), "transport"),
    (dict(speculative=True), "transport"),
])
def test_unported_options_raise(option, slice_name):
    """Both options run now: transport= serves over a transport, and
    speculative=True without one raises the reference's ValueError."""
    scheme, state, views = _inl()
    if "transport" not in option:
        with pytest.raises(ValueError, match=slice_name):
            ServingEngine(scheme, state, CFG, device="cpu", **option)
        return
    tr = _port_transport(ttopo.star(CFG.num_clients))
    engine = ServingEngine(scheme, state, CFG, transport=tr, device="cpu")
    probs, results = engine.serve(views[:, :3])
    tr.close()
    assert engine.meter is tr.meter and tr.meter.delivery_ratio == 1.0
    assert [r.views_fused for r in results] == [CFG.num_clients] * 3
    np.testing.assert_allclose(probs, _jax_predict(views[:, :3]), rtol=0,
                               atol=1e-5)


def _port_transport(topo, **kw):
    from repro_torch.transport import NO_RETRY, NetworkTransport
    kw.setdefault("policy", NO_RETRY)
    kw.setdefault("breaker", None)
    return NetworkTransport(topo, CFG, seed=0, **kw)


def _late_star(latency_ms=50.0):
    # deterministic stragglers: every link delivers (erasure 0, jitter 0)
    # but 50 ms of latency blows a 10 ms fusion deadline on every view
    return linkfault.with_links(
        ttopo.star(CFG.num_clients),
        linkfault.LinkModel(erasure=0.0, latency_ms=latency_ms,
                            jitter_ms=0.0))


def test_speculative_requires_transport():
    scheme, state, _ = _inl()
    with pytest.raises(ValueError, match="transport"):
        ServingEngine(scheme, state, CFG, seed=0, speculative=True,
                      device="cpu")


def test_speculative_fusion_patches_stragglers():
    """All J views delivered but LATE: without speculation the fusion at
    the deadline answers from nothing; with it, the request is answered by
    the next bucket's PATCHED fusion carrying every recovered view."""
    scheme, state, views = _inl()
    J, n = CFG.num_clients, 5
    topo = _late_star()

    tr = _port_transport(topo)
    plain = ServingEngine(scheme, state, CFG, topology=topo, transport=tr,
                          deadline_ms=10.0, seed=0, device="cpu")
    _, res = plain.serve(views[:, :n])
    tr.close()
    assert [r.views_fused for r in res] == [0] * n
    assert all(r.served_by == "first" for r in res)
    assert plain.stats.patched == 0

    tr = _port_transport(topo)
    spec = ServingEngine(scheme, state, CFG, topology=topo, transport=tr,
                         deadline_ms=10.0, seed=0, speculative=True,
                         device="cpu")
    probs, res = spec.serve(views[:, :n])
    snap = tr.snapshot()
    tr.close()
    assert all(r.served_by == "patched" for r in res)
    assert [r.views_fused for r in res] == [J] * n
    assert [r.views_recovered for r in res] == [J] * n
    assert spec.stats.patched == n and spec.stats.views_recovered == n * J
    # the patched fusion consumed every view -> full delivered credit
    assert snap["delivery_ratio"] == 1.0
    # an all-views patched fusion decides like the clean engine
    clean = ServingEngine(scheme, state, CFG, seed=0, device="cpu")
    cp, _ = clean.serve(views[:, :n])
    assert np.allclose(probs, cp, atol=2e-6, rtol=0)
    assert np.array_equal(np.argmax(probs, -1), np.argmax(cp, -1))


def test_transport_serving_credits_only_consumed_views():
    """Non-speculative serving under a hard outage: the at-deadline fusion
    consumed nothing, so the delivered ledger stays empty while offered
    accrues per attempt."""
    from repro_torch.chaos import ChaosSchedule
    scheme, state, views = _inl()
    topo = ttopo.resolve(None, CFG)
    chaos = ChaosSchedule()
    for e in topo.edges:
        chaos = chaos.down_edge(e.key, 0, 64)
    tr = _port_transport(topo, chaos=chaos)
    engine = ServingEngine(scheme, state, CFG, transport=tr, seed=0,
                           device="cpu")
    _, res = engine.serve(views[:, :3])
    assert [r.views_fused for r in res] == [0, 0, 0]
    assert tr.meter.total_bits > 0 and tr.meter.delivered_bits == 0.0
    tr.close()


def _speculative_run(side, views):
    """20 requests through one package's engine and transport: a lossy
    star (erasure 0.2, latency 5 + Exp(10) ms) against a 30 ms deadline,
    DEFAULT_RETRY, speculative fusion."""
    if side == "ref":
        from repro.core import linkfault as lf
        from repro.core import schemes as sch
        from repro.core import topology as tp
        from repro.serving import ServingEngine as Engine
        from repro.transport import DEFAULT_RETRY, NetworkTransport
        jp, js = jax_inl(CFG)
        state, kw = {"params": jp, "state": js}, {}
    else:
        from repro_torch.core import linkfault as lf
        from repro_torch.core import schemes as sch
        from repro_torch.core import topology as tp
        from repro_torch.transport import DEFAULT_RETRY, NetworkTransport
        Engine = ServingEngine
        params, st = torch_inl(CFG)
        state, kw = {"params": params, "state": st}, {"device": "cpu"}
    topo = lf.with_links(tp.star(CFG.num_clients),
                         lf.LinkModel(erasure=0.2, latency_ms=5.0,
                                      jitter_ms=10.0))
    tr = NetworkTransport(topo, CFG, seed=11, policy=DEFAULT_RETRY)
    engine = Engine(sch.get("inl"), state, CFG, topology=topo, transport=tr,
                    deadline_ms=30.0, seed=0, speculative=True, **kw)
    probs, res = engine.serve(views[:, :20])
    tr.close()
    return (np.asarray(probs), [(r.rid, r.views_fused, r.served_by,
                                 r.views_recovered) for r in res],
            (engine.stats.patched, engine.stats.views_recovered,
             engine.stats.launches, engine.stats.launched_rows),
            tr.snapshot(), dict(tr.meter.edge_bits),
            dict(tr.meter.edge_delivered_bits))


def test_speculative_serving_equals_the_reference_engine():
    _, _, views = _inl()
    ref, port = _speculative_run("ref", views), _speculative_run("port",
                                                                 views)
    np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=1e-5)
    assert port[1:] == ref[1:]
    served_by = [r[2] for r in port[1]]
    assert "patched" in served_by and "first" in served_by
    assert port[2][0] == served_by.count("patched") and port[2][1] > 0
    assert 0 < port[3]["delivery_ratio"] < 1


# ---------------------------------------------------------------------------
# loadgen guards and the front end
# ---------------------------------------------------------------------------

def test_percentile_guards_degenerate_samples():
    from repro_torch.serving.loadgen import percentile_ms
    assert percentile_ms([], 50) == 0.0           # not a ValueError
    assert percentile_ms([], 99) == 0.0
    assert percentile_ms([7.25], 50) == 7.25      # one sample IS every pct
    assert percentile_ms([7.25], 99) == 7.25
    lats = [1.0, 2.0, 3.0, 4.0]
    assert percentile_ms(lats, 50) == pytest.approx(np.percentile(lats, 50))


def test_run_poisson_zero_and_one_request_nan_free():
    from repro_torch.serving.loadgen import run_poisson
    scheme, state, views = _inl()
    engine = ServingEngine(scheme, state, CFG, seed=0, buckets=(1,),
                           device="cpu")
    with engine:
        empty = run_poisson(engine, views[:, :4], rate_rps=100.0,
                            num_requests=0)
        one = run_poisson(engine, views[:, :4], rate_rps=100.0,
                          num_requests=1)
    for summary, served in ((empty, 0), (one, 1)):
        assert summary["served"] == served
        for k, v in summary.items():
            assert np.isfinite(v), (k, v)
    assert empty["p50_ms"] == 0.0 and empty["mean_views_fused"] == 0.0
    assert one["p99_ms"] == one["p50_ms"] > 0.0
    assert one["mean_views_fused"] == CFG.num_clients


def test_clamp_requests_warns_and_clamps():
    from repro_torch.launch.serve import clamp_requests
    assert clamp_requests(8, 100) == 8
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert clamp_requests(1000, 640) == 640
    assert any(issubclass(x.category, RuntimeWarning)
               and "exceeds" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="strict"):
        clamp_requests(1000, 640, strict=True)


def test_paper_inl_front_end_over_a_socket_transport(tmp_path, capsys):
    """`--arch paper-inl --smoke` on the CPU: trains, serves 24 requests
    over socket channels with speculative fusion and a 10 ms deadline,
    and saves its model to --ckpt-dir; a second call serves that
    checkpoint without training."""
    from repro_torch.launch import serve
    argv = ["--arch", "paper-inl", "--smoke", "--device", "cpu",
            "--requests", "24", "--transport", "socket", "--speculative",
            "--deadline-ms", "10", "--ckpt-dir", str(tmp_path)]
    out = serve.main(argv)
    assert out["served"] == 24 and out["patched"] > 0
    assert out["views_recovered"] > 0
    assert all(c == 0 for c in out["trace_counts"].values())   # CPU: eager
    again = serve.main(argv)
    assert "serving from checkpoint step 2" in capsys.readouterr().out
    assert again["views_fused"] == out["views_fused"]
    assert again["accuracy"] == out["accuracy"]


def test_front_end_serves_a_reference_checkpoint(tmp_path, capsys):
    """A checkpoint the reference wrote (its layout: conv weights HWIO)
    serves through `--ckpt-dir`, answering as the reference's predict."""
    import jax
    from repro import checkpoint as jcheckpoint
    from repro.core import schemes as jschemes
    from repro_torch.launch import serve
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    smoke = PaperExperimentConfig(conv_channels=(4,), d_bottleneck=8,
                                  dense_units=(32,), image_shape=(16, 16, 3),
                                  dataset_size=640)
    jstate = jschemes.get("inl").init(smoke, jax.random.PRNGKey(5))
    jcheckpoint.save(str(tmp_path), 7, jax.device_get(jstate))
    out = serve.main(["--arch", "paper-inl", "--smoke", "--device", "cpu",
                      "--requests", "16", "--ckpt-dir", str(tmp_path)])
    assert "serving from checkpoint step 7" in capsys.readouterr().out
    from repro.data import multiview as jmv
    imgs, labels = jmv.make_base_dataset(640, image_shape=smoke.image_shape,
                                         seed=0)
    views = jmv.make_views(imgs, smoke.noise_stds)[:, :16]
    want = np.asarray(jinl.predict(jstate["params"], jstate["state"],
                                   jnp.asarray(views)))
    assert out["accuracy"] == float(np.mean(np.argmax(want, -1)
                                            == labels[:16]))
