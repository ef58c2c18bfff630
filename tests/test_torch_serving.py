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
  * each option not ported yet raises NotImplementedError naming its slice.
"""
import time

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
# options of later slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option, slice_name", [
    (dict(transport=object()), "transport"),
    (dict(speculative=True), "transport"),
])
def test_unported_options_raise(option, slice_name):
    scheme, state, _ = _inl()
    with pytest.raises(NotImplementedError, match=slice_name):
        ServingEngine(scheme, state, CFG, device="cpu", **option)
