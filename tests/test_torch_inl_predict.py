"""The port's INL inference slice (repro_torch/core/inl and what it stands on)
against the JAX reference.

  * predict at SMOKE and at the paper's full width: probabilities within
    atol 1e-5, argmax identical wherever the reference's top-2 margin
    exceeds 1e-4 (a smaller margin may flip under fp32 reordering);
  * the ported multiview generator is bit-identical to the reference's;
  * the copied bandwidth closed forms, the star topology and the dense
    wire's byte counts equal the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_inl import SMOKE, PaperExperimentConfig  # noqa: E402
from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import inl as jinl  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import wirefmt as jwire  # noqa: E402
from repro.data import multiview as jmv  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402
from repro_torch.configs import paper_inl as tcfg  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import inl as tinl  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core import wirefmt as twire  # noqa: E402
from repro_torch.data import multiview as tmv  # noqa: E402
from tests._torch_common import jax_inl, torch_inl, views_np  # noqa: E402

CFGS = {"smoke": SMOKE, "full": PaperExperimentConfig()}


def _assert_predict_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 1e-4
    assert np.array_equal(np.argmax(got, -1)[decided],
                          np.argmax(ref, -1)[decided])


@pytest.mark.parametrize("name", ["smoke", "full"])
def test_predict_matches_jax(name):
    cfg = CFGS[name]
    views = views_np(cfg, 6)
    jp, js = jax_inl(cfg)
    ref = np.asarray(jax.jit(lambda p, s, v: jinl.predict(p, s, v))(
        jp, js, jnp.asarray(views)))
    tp, ts = torch_inl(cfg)
    got = tinl.predict(tp, ts, views, device="cpu").numpy()
    assert got.shape == (6, cfg.num_classes)
    _assert_predict_close(got, ref)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)


def test_encode_decode_and_evaluate_match_jax():
    cfg = SMOKE
    views = views_np(cfg, 5)
    labels = np.array([0, 3, -1, 7, 2], np.int32)
    jp, js = jax_inl(cfg)
    tp, ts = torch_inl(cfg)
    ju, jmu, _, _ = jinl.encode(jp, js, jnp.asarray(views), train=False,
                                sample_latent=False)
    with torch.no_grad():
        tu, tmu, _, _ = tinl.encode(tp, ts, torch.from_numpy(views),
                                    train=False, sample_latent=False)
        tj, tb = tinl.decode(tp, tu, train=False)
    jj, jb = jinl.decode(jp, ju, train=False)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    ja = float(jinl.evaluate(jp, js, jnp.asarray(views), jnp.asarray(labels)))
    ta = float(tinl.evaluate(tp, ts, views, labels, device="cpu"))
    assert ta == pytest.approx(ja, abs=1e-7)
    logits = np.random.default_rng(0).normal(size=(5, 10)).astype(np.float32)
    assert float(tlosses.accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))) == \
        pytest.approx(float(jlosses.accuracy(jnp.asarray(logits),
                                             jnp.asarray(labels))))


def test_init_is_seeded_and_shaped_like_the_reference():
    cfg = SMOKE
    p1, s1 = tinl.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    p2, s2 = tinl.init(cfg, 4, device="cpu")
    tp, ts = torch_inl(cfg)
    for a, b, c in zip(tree_leaves(p1), tree_leaves(p2), tree_leaves(tp)):
        assert torch.equal(a, b) and a.shape == c.shape
    probs = tinl.predict(p1, s1, views_np(cfg, 3), device="cpu")
    assert torch.isfinite(probs).all()
    # learned priors: per-node (J, d) zeros, as the reference's
    lp = dataclasses.replace(cfg, learned_prior=True)
    pp, _ = tinl.init(lp, 0, device="cpu")
    jp, _ = jinl.init(lp, jax.random.PRNGKey(0))
    assert set(pp.priors) == set(jp.priors) == {"mu", "logvar"}
    for k in pp.priors:
        assert np.array_equal(pp.priors[k].numpy(), np.asarray(jp.priors[k]))


def test_predict_refuses_unported_options():
    cfg = SMOKE
    tp, ts = torch_inl(cfg)
    views = views_np(cfg, 2)
    # a delivery mask now fuses what arrived; all ones is the perfect
    # network, the clean predict bit for bit (tests/test_torch_linkfault.py)
    assert torch.equal(
        tinl.predict(tp, ts, views, delivery=np.ones((5, 2), bool),
                     device="cpu"),
        tinl.predict(tp, ts, views, device="cpu"))
    # a topology whose view count is not cfg's is refused; a per-edge-width
    # star is a graph (tests/test_torch_topology.py) and predicts
    with pytest.raises(ValueError, match="view nodes"):
        tinl.predict(tp, ts, views, cfg=cfg, device="cpu",
                     topology=ttopo.star(cfg.num_clients + 1, link_bits=4))
    probs = tinl.predict(tp, ts, views, cfg=cfg, device="cpu",
                         topology=ttopo.star(cfg.num_clients, link_bits=4))
    assert torch.allclose(probs.sum(-1), torch.ones(2))
    with pytest.raises(ValueError, match="lie on"):
        tinl.predict(tp, ts, views, device="meta")


def test_multiview_is_bit_identical_to_the_reference():
    assert dataclasses.asdict(tcfg.PaperExperimentConfig()) == \
        dataclasses.asdict(PaperExperimentConfig())
    assert dataclasses.asdict(tcfg.SMOKE) == dataclasses.asdict(SMOKE)
    ji, jl = jmv.make_base_dataset(64, seed=3)
    ti, tl = tmv.make_base_dataset(64, seed=3)
    assert np.array_equal(ji, ti) and np.array_equal(jl, tl)
    jv = jmv.make_views(ji, SMOKE.noise_stds, seed=5)
    tv = tmv.make_views(ti, SMOKE.noise_stds, seed=5)
    assert np.array_equal(jv, tv)
    assert np.array_equal(jmv.average_view(jv), tmv.average_view(tv))
    js = jmv.split_experiment1(jv, jl, 5)
    ts = tmv.split_experiment1(tv, tl, 5)
    for (a, b), (c, d) in zip(js["fl"], ts["fl"]):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert all(np.array_equal(a, b) for a, b in zip(
        jmv.batch_indices(64, 16, seed=1, epochs=2),
        tmv.batch_indices(64, 16, seed=1, epochs=2)))


def test_bandwidth_closed_forms_equal_the_reference():
    for net, q in jbw.PAPER_TABLE1:
        assert tbw.table1(q, net) == jbw.table1(q, net)
    assert tbw.inl_epoch_bits(320, 640, 5, 8) == \
        jbw.inl_epoch_bits(320, 640, 5, 8)
    m = tbw.BandwidthMeter()
    assert m.delivery_ratio == 1.0
    m.add_edge("m0->fuse", bits=64.0, nbytes=8.0)
    m.add_delivered(bits=32.0, nbytes=4.0, edge="m0->fuse")
    assert m.delivery_ratio == 0.5 and m.measured_bits == 64.0


def test_star_topology_and_dense_wire_equal_the_reference():
    for J in (1, 5):
        t, j = ttopo.star(J), jtopo.star(J)
        assert t.describe() == j.describe()
        assert t.is_default_star() and j.is_default_star()
        assert [t.payload(e) for e in t.topo_edges()] == \
            [j.payload(e) for e in j.topo_edges()]
    cfg = SMOKE
    assert ttopo.resolve(None, cfg).describe() == \
        jtopo.resolve(None, cfg).describe()
    assert not ttopo.star(5, link_bits=4).is_default_star()
    with pytest.raises(ValueError, match="view nodes"):
        ttopo.resolve(ttopo.star(3), cfg)
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        assert twire.shipped_nbytes(20, 64, link_bits=8, dtype=dt_t) == \
            jwire.shipped_nbytes(20, 64, link_bits=8, dtype=dt_j)
    assert twire.shipped_nbytes(20, 64, link_bits=8, wire="packed") == \
        jwire.shipped_nbytes(20, 64, link_bits=8, wire="packed") \
        == 20 * 16 * 4
    with pytest.raises(ValueError, match="unknown wire"):
        twire.shipped_nbytes(20, 64, link_bits=8, wire="bogus")
