"""The port's unreliable links (repro_torch/core/linkfault.py and its callers
in core/inl, core/fl, core/schemes/{base,inl,fl,sl,runner} and serving)
against the JAX reference, mirroring tests/test_linkfault.py.

JAX's fold_in streams cannot be reproduced in torch: where a JAX draw is
compared, the JAX side runs inside `jax.threefry_partitionable(False)`
(ROADMAP queue 3) and its masks reach the port as data.

  * LinkModel's and with_links' messages word for word, the activation
    rule;
  * `partial_fuse` bit for bit on (J,) and (J, B) masks, all-ones (the
    identity) and all-zero, and its backward (dropped chunks get zero);
  * masks with no random draw (erasure 0, jitter 0; latency, bandwidth
    caps at each edge's own width, a deadline) bit for bit on star,
    chain(5), tree(2, 2) and the mixed-width chain;
  * JAX's masks fed through both packages' transport rounds: INL six
    rounds at rtol 1e-4, FL three rounds with an all-lost one (the previous
    model kept bit for bit), SL a round with a lost link (state unchanged
    bit for bit) and an all-delivered one (the clean round bit for bit);
  * predict with a mask on the star and chain(5) at predict's bar (atol
    1e-5, equal decisions);
  * `fault_charges_from_mask` on JAX's mask == JAX's `round_fault_charges`
    for inl, fl and sl;
  * the port's own draws: a perfect LinkModel() on every edge equals no
    link model bit for bit (inl, fl, sl, chain(5)), the runner meters the
    replayed draws, draws are deterministic and disjoint by salt, erasure
    and the latency tail lie within binomial bounds, a chain compounds
    erasure along its route, id-keyed masks ignore batch position and
    padding, and SL served over a lossy star answers failed requests with
    the uniform distribution.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _schemes_common import (BATCH, CFG, fixture_data,  # noqa: E402
                             round_inputs)
from _torch_common import jax_inl, torch_inl, views_np  # noqa: E402

from repro.core import inl as jinl  # noqa: E402
from repro.core import linkfault as jlf  # noqa: E402
from repro.core import paper_model as jpm  # noqa: E402
from repro.core import schemes as jschemes  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch import convert, optim, tree_leaves, tree_stack  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import fl as tfl  # noqa: E402
from repro_torch.core import inl as tinl  # noqa: E402
from repro_torch.core import linkfault as LF  # noqa: E402
from repro_torch.core import schemes  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.schemes import base, runner  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

LR = 2e-3
J = CFG.num_clients
LOSSY = dict(erasure=0.5)


def _links(module, topo, spec):
    """`topo` with LinkModel(**spec) of `module` on every edge."""
    return module.with_links(topo, module.LinkModel(**spec))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(name):
    views, labels = fixture_data()
    v, lab = round_inputs(jschemes.get(name), CFG, views, labels)
    return v, lab, (torch.from_numpy(np.array(v)),
                    torch.from_numpy(np.array(lab)).long())


# ---------------------------------------------------------------------------
# the data model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(erasure=1.0), dict(erasure=-0.1),
                                dict(latency_ms=-1.0), dict(jitter_ms=-2.0),
                                dict(bandwidth_bps=0.0)])
def test_linkmodel_validation_word_for_word(kw):
    with pytest.raises(ValueError) as want:
        jlf.LinkModel(**kw)
    with pytest.raises(ValueError) as got:
        LF.LinkModel(**kw)
    assert str(got.value) == str(want.value)


def test_with_links_and_activation_rule():
    star = TT.star(3)
    lossy = LF.with_links(star, LF.LinkModel(**LOSSY))
    assert all(e.link == LF.LinkModel(**LOSSY) for e in lossy.edges)
    assert LF.has_link_models(lossy) and not LF.has_link_models(star)
    one = LF.with_links(star, {"m0->fuse": LF.LinkModel(**LOSSY)})
    assert one.edges[0].link is not None and one.edges[1].link is None
    with pytest.raises(ValueError) as got:
        LF.with_links(star, {"nope->fuse": LF.LinkModel()})
    with pytest.raises(ValueError) as want:
        jlf.with_links(JT.star(3), {"nope->fuse": jlf.LinkModel()})
    assert str(got.value) == str(want.value)
    assert not LF.active(TT.star(J), CFG, train=True)
    assert LF.active(LF.with_links(TT.star(J), LF.LinkModel()), CFG,
                     train=True)
    drop = dataclasses.replace(CFG, edge_dropout=0.2)
    assert LF.active(TT.star(J), drop, train=True)
    assert not LF.active(TT.star(J), drop, train=False)
    assert LF.FORCE_ERASURE_ENV == jlf.FORCE_ERASURE_ENV
    assert LF.forced_erasure(0.25) == jlf.forced_erasure(0.25)


# ---------------------------------------------------------------------------
# partial_fuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["round", "sample", "ones", "zeros"])
def test_partial_fuse_matches_jax(kind):
    rng = np.random.default_rng(1)
    u = rng.normal(size=(J, 7, 16)).astype(np.float32)
    mask = {"round": np.array([1, 0, 1, 1, 0], bool),
            "sample": rng.random((J, 7)) < 0.6,
            "ones": np.ones((J, 7), bool),
            "zeros": np.zeros((J,), bool)}[kind]
    got = LF.partial_fuse(torch.from_numpy(u), mask).numpy()
    want = np.asarray(jlf.partial_fuse(jnp.asarray(u), jnp.asarray(mask)))
    assert np.array_equal(got, want)
    if kind == "ones":
        assert np.array_equal(got, u)               # exactly the identity
    if kind == "zeros":
        assert not got.any()
    # backward: the cotangents of dropped chunks are exactly zero, the
    # survivors' scaled like the forward, as the reference's VJP
    g = rng.normal(size=u.shape).astype(np.float32)
    ut = torch.from_numpy(u).requires_grad_(True)
    (LF.partial_fuse(ut, torch.from_numpy(mask)) * torch.from_numpy(g)) \
        .sum().backward()
    _, vjp = jax.vjp(lambda x: jlf.partial_fuse(x, jnp.asarray(mask)),
                     jnp.asarray(u))
    assert np.array_equal(ut.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    kept = mask.reshape(mask.shape + (1,) * (3 - mask.ndim))
    dropped = ~np.broadcast_to(kept, u.shape)
    assert not ut.grad.numpy()[dropped].any()


# ---------------------------------------------------------------------------
# masks with no random draw: bit for bit
# ---------------------------------------------------------------------------

GRAPHS = {"star": lambda M: M.star(5),
          "chain(5)": lambda M: M.chain(5),
          "tree(2, 2)": lambda M: M.tree(2, 2),
          "mixed chain": lambda M: M.chain(5, link_bits=(2, 4, 8, 8, 32))}


def _timed_links(module, topo):
    """Per-edge latency (not representable in fp32) and, on every other
    edge, a bandwidth cap; no erasure, no jitter."""
    return module.with_links(topo, {
        e.key: module.LinkModel(
            latency_ms=0.1 * (i + 1) + 0.03,
            bandwidth_bps=None if i % 2 else 3e6 * (1 + i % 3))
        for i, e in enumerate(topo.edges)})


@pytest.mark.parametrize("name", list(GRAPHS))
def test_deterministic_masks_equal_jax(name):
    jt = _timed_links(jlf, GRAPHS[name](JT))
    tt = _timed_links(LF, GRAPHS[name](TT))
    # each view's route time in float64, and deadlines on either side of
    # its fp32 rounding, so only the reference's fp32 sum order passes
    times = []
    for name_v in tt.view_nodes():
        t = 0.0
        for _, e in LF._route(tt, name_v):
            bits = BATCH * len(tt.payload(e)) * CFG.d_bottleneck \
                * TT.edge_bits(e, CFG)
            t += e.link.latency_ms + LF._edge_tx_ms(e.link, bits)
        times.append(t)
    deadlines = [None]
    for t in times:
        t32 = np.float32(t)
        deadlines += [t, float(t32), float(np.nextafter(t32, np.inf)),
                      float(np.nextafter(t32, -np.inf))]
    seen = set()
    for dl in deadlines:
        want = np.asarray(jlf.delivery_mask(
            jax.random.PRNGKey(0), jt, CFG, payload_scale=float(BATCH),
            deadline=dl, shape=(2,)))
        got = LF.delivery_mask(LF.key(0), tt, CFG,
                               payload_scale=float(BATCH), deadline=dl,
                               shape=(2,))
        assert got.dtype == bool and np.array_equal(got, want), dl
        seen.add(int(got.sum()))
    assert len(seen) > 2                 # the sweep cuts between views
    # the round mask reads cfg.fusion_deadline_ms
    cfg = dataclasses.replace(CFG, fusion_deadline_ms=float(np.median(times)))
    want = np.asarray(jlf.round_delivery_mask(jax.random.PRNGKey(3), jt, cfg,
                                              BATCH, train=False))
    got = LF.round_delivery_mask(LF.round_key(0, 3), tt, cfg, BATCH,
                                 train=False)
    assert np.array_equal(got, want) and 0 < got.sum() < len(got)


# ---------------------------------------------------------------------------
# JAX's masks fed as data through both packages' transport rounds
# ---------------------------------------------------------------------------

def _jax_masks(draw, n, offset=100):
    with jax.threefry_partitionable(False):
        return [np.asarray(draw(jax.random.PRNGKey(offset + i)))
                for i in range(n)]


def _inl_draws(i):
    """The JAX round i's eps and dropout masks (call inside the
    non-partitionable threefry, as the round ran)."""
    r_enc, r_dec = jax.random.split(jax.random.PRNGKey(i))
    eps = jax.random.normal(r_enc, (J, BATCH, CFG.d_bottleneck), jnp.float32)
    masks = jpm.decoder_dropout_masks(r_dec, CFG.dense_units, BATCH)
    return (torch.from_numpy(np.array(eps)),
            [torch.from_numpy(np.array(m)) for m in masks])


def test_inl_transport_rounds_match_jax():
    jt = _links(jlf, JT.star(J), LOSSY)
    masks = _jax_masks(lambda k: jlf.round_delivery_mask(
        k, jt, CFG, BATCH, train=True), 6)
    assert any(not m.all() for m in masks)
    v, lab, (tv, tlab) = _inputs("inl")
    jsch = jschemes.get("inl")
    with jax.threefry_partitionable(False):
        jst = jsch.init(CFG, jax.random.PRNGKey(0))
        params, state = convert.inl_from_jax(
            _np(jst["params"]), _np(jst["state"]), CFG, device="cpu")
        jround = jsch.make_transport_round(CFG, lr=LR)
        want = []
        for i, m in enumerate(masks):
            jst, jm = jround(jst, v, lab, jax.random.PRNGKey(i),
                             jnp.asarray(m))
            want.append(float(jm["loss"]))
        draws = [_inl_draws(i) for i in range(len(masks))]
    st = {"params": params, "state": state,
          "opt": optim.adam(LR).init(params)}
    round_fn = schemes.get("inl").make_transport_round(CFG, lr=LR)
    got = []
    for m, (eps, drop) in zip(masks, draws):
        st, tm = round_fn(st, tv, tlab, None, m, eps=eps, drop_masks=drop)
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    want_p, _ = convert.inl_from_jax(_np(jst["params"]), _np(jst["state"]),
                                     CFG, device="cpu")
    for a, b in zip(tree_leaves(st["params"].decoder),
                    tree_leaves(want_p.decoder)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _fl_masks(i, local_steps=2):
    out = []
    for r in jax.random.split(jax.random.PRNGKey(i), J):
        steps = []
        for _ in range(local_steps):
            r, sub = jax.random.split(r)
            steps.append([torch.from_numpy(np.array(m)) for m in
                          jpm.decoder_dropout_masks(sub, CFG.dense_units,
                                                    BATCH)])
        out.append(steps)
    return out


def _fl_strict(params):
    """FL parameter leaves but the conv biases (zero exact gradient under
    BatchNorm: rounding noise that Adam scales, ROADMAP queue 3)."""
    loose = [c["b"] for e in params["encoders"] for c in e["convs"]]
    return [t for t in tree_leaves(params) if not any(t is x for x in loose)]


def test_fl_transport_rounds_match_jax():
    jt = _links(jlf, JT.star(J), LOSSY)
    m0, m2 = _jax_masks(lambda k: jlf.client_delivery_mask(
        k, jt, CFG, train=True), 2)
    masks = [m0, np.zeros(J, bool), m2]        # round 2: every upload lost
    assert 0 < m0.sum() < J
    v, lab, (tv, tlab) = _inputs("fl")
    jsch = jschemes.get("fl")
    with jax.threefry_partitionable(False):
        jst = jsch.init(CFG, jax.random.PRNGKey(0))
        params, state = convert.fl_from_jax(_np(jst["params"]),
                                            _np(jst["state"]), CFG,
                                            device="cpu")
        jround = jsch.make_transport_round(CFG, lr=LR)
        want, jparams = [], []
        for i, m in enumerate(masks):
            jst, jm = jround(jst, v, lab, jax.random.PRNGKey(i),
                             jnp.asarray(m))
            want.append(float(jm["loss"]))
            jparams.append(_np(jst["params"]))
        drops = [_fl_masks(i) for i in range(len(masks))]
    opt = [optim.adam(LR).init(tfl.replica(params, j)) for j in range(J)]
    st = {"params": params, "state": state, "opt": tree_stack(opt)}
    round_fn = schemes.get("fl").make_transport_round(CFG, lr=LR)
    got = []
    for i, m in enumerate(masks):
        before = st["params"]
        st, tm = round_fn(st, tv, tlab, None, m, drop_masks=drops[i])
        got.append(float(tm["loss"]))
        if not m.any():     # all lost: the previous global model, bit exact
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(st["params"]), tree_leaves(before)))
        want_p, _ = convert.fl_from_jax(jparams[i], _np(jst["state"]), CFG,
                                        device="cpu")
        for a, b in zip(_fl_strict(st["params"]), _fl_strict(want_p)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.array_equal(jparams[1]["decoder"]["dense"][0]["w"],
                          jparams[0]["decoder"]["dense"][0]["w"])


def _sl_masks(i):
    return [torch.from_numpy(np.array(m)) for m in jpm.decoder_dropout_masks(
        jax.random.PRNGKey(i), CFG.dense_units, BATCH)]


def _sl_state(jst):
    client, server, state = convert.sl_from_jax(
        jst["client"], jst["server"], jst["state"], CFG, device="cpu")
    return {"client": client, "server": server, "state": state,
            "opt_c": optim.adam(LR).init(client),
            "opt_s": optim.adam(LR).init(server)}


def test_sl_transport_rounds_match_jax():
    jt = _links(jlf, JT.star(J), LOSSY)
    (lost,) = _jax_masks(lambda k: jlf.round_delivery_mask(
        k, jt, CFG, BATCH, train=True), 1, offset=101)
    assert not lost.all()
    masks = [lost, np.ones(J, bool)]
    v, lab, (tv, tlab) = _inputs("sl")
    jsch = jschemes.get("sl")
    with jax.threefry_partitionable(False):
        jst0 = jsch.init(CFG, jax.random.PRNGKey(0))
        jround = jsch.make_transport_round(CFG, lr=LR)
        want = [float(jround(jst0, v, lab, jax.random.PRNGKey(i),
                             jnp.asarray(m))[1]["loss"])
                for i, m in enumerate(masks)]
        drops = [_sl_masks(i) for i in range(len(masks))]
    st0 = _sl_state(_np(jst0))
    sch = schemes.get("sl")
    round_t = sch.make_transport_round(CFG, lr=LR)
    clean = sch.make_round(CFG, lr=LR)
    got = []
    # a lost link: the round is computed (its loss reported) and discarded
    st1, m1 = round_t(st0, tv, tlab, None, lost, drop_masks=drops[0])
    got.append(float(m1["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st1),
                                                 tree_leaves(st0)))
    # every link delivered: the clean round, bit for bit
    st2, m2 = round_t(st0, tv, tlab, None, masks[1], drop_masks=drops[1])
    st2c, m2c = clean(st0, tv, tlab, None, drop_masks=drops[1])
    got.append(float(m2["loss"]))
    assert torch.equal(m2["loss"], m2c["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st2),
                                                 tree_leaves(st2c)))
    assert not torch.equal(tree_leaves(st2)[0], tree_leaves(st0)[0])
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# predict with a mask; the meter's charges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["star", "chain(5)"])
def test_predict_with_delivery_matches_jax(graph):
    views = views_np(CFG, 8)
    jp, js = jax_inl(CFG)
    tp, ts = torch_inl(CFG)
    jt, tt = (None, None) if graph == "star" else (JT.chain(J), TT.chain(J))
    rng = np.random.default_rng(2)
    per_sample = rng.random((J, 8)) < 0.6
    per_sample[:, 0] = False                     # nothing arrived
    per_sample[:, 1] = True                      # everything arrived
    for mask in (per_sample, np.array([1, 1, 0, 1, 0], bool)):
        want = np.asarray(jax.jit(lambda p, s, v, m: jinl.predict(
            p, s, v, cfg=CFG, topology=jt, delivery=m))(
                jp, js, jnp.asarray(views), jnp.asarray(mask)))
        got = tinl.predict(tp, ts, views, cfg=CFG, topology=tt,
                           delivery=mask, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 1e-4
        assert np.array_equal(np.argmax(got, -1)[decided],
                              np.argmax(want, -1)[decided])


@pytest.mark.parametrize("name", ["inl", "fl", "sl"])
def test_fault_charges_match_jax(name):
    make = (lambda M: M.chain(J)) if name == "inl" else (lambda M: M.star(J))
    jt, tt = _links(jlf, make(JT), LOSSY), _links(LF, make(TT), LOSSY)
    if name == "inl":
        bits = TT.round_edge_bits(tt, CFG, BATCH)
        nbytes = TT.round_edge_wire_bytes(tt, CFG, BATCH)
        charges = {k: (bits[k], nbytes[k]) for k in bits}
        draw = lambda k: jlf.round_delivery_mask(k, jt, CFG, BATCH,  # noqa
                                                 train=True)
    elif name == "fl":
        charges = {None: (1.25e6, 1.5625e5)}
        draw = lambda k: jlf.client_delivery_mask(k, jt, CFG,  # noqa
                                                  train=True)
    else:
        charges = {None: (1000.0, 125.0)}
        draw = lambda k: jlf.attempt_successes(k, jt, CFG, 3)  # noqa
    assert LF.retry_attempts() == 3
    lossy_rounds = 0
    with jax.threefry_partitionable(False):
        for k in range(12):
            key = jax.random.PRNGKey(k)
            mask = np.asarray(draw(key))
            want = jlf.round_fault_charges(key, name, jt, CFG, BATCH,
                                           charges)
            got = LF.fault_charges_from_mask(name, tt, CFG, charges, mask)
            assert got == want
            lossy_rounds += got[1] != charges
    assert lossy_rounds
    # the port's own replay: its draw, then the same arithmetic
    rk = LF.round_key(5, 0)
    port_mask = {"inl": lambda: LF.round_delivery_mask(rk, tt, CFG, BATCH,
                                                       train=True),
                 "fl": lambda: LF.client_delivery_mask(rk, tt, CFG,
                                                       train=True),
                 "sl": lambda: LF.attempt_successes(rk, tt, CFG, 3)}[name]()
    assert LF.round_fault_charges(rk, name, tt, CFG, BATCH, charges) == \
        LF.fault_charges_from_mask(name, tt, CFG, charges, port_mask)


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["inl", "fl", "sl", "chain(5)"])
def test_perfect_links_are_bitwise_identity(name):
    """LinkModel() on every edge takes the fault path with all-ones masks:
    losses and every state leaf equal the run without link models, bit for
    bit (the round's generator draws are untouched by the fault stream)."""
    scheme = schemes.get("inl" if name == "chain(5)" else name)
    bare = TT.chain(J) if name == "chain(5)" else TT.star(J)
    _, _, (tv, tlab) = _inputs(scheme.name)
    runs = []
    for topo in (bare, LF.with_links(bare, LF.LinkModel())):
        st = scheme.init(CFG, 0, lr=LR, device="cpu")
        round_fn = scheme.make_round(CFG, lr=LR, topology=topo)
        gen = torch.Generator().manual_seed(1)
        losses = []
        for i in range(2):
            kw = {} if topo is bare else {"round_key": LF.round_key(0, i)}
            st, m = round_fn(st, tv, tlab, gen, **kw)
            losses.append(m["loss"])
        runs.append((losses, tree_leaves(st)))
    (la, sa), (lb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert len(sa) == len(sb) > 0
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))


def test_runner_meters_the_replayed_draws():
    """run_scheme over a lossy star: the delivered ledger is each round's
    replayed payload fraction; perfect links leave the curve as it was."""
    views, labels = fixture_data()
    views, labels = np.array(views), np.array(labels)
    lossy = LF.with_links(TT.star(J), LF.LinkModel(**LOSSY))
    curves, meters = {}, {}
    for label, topo in (("bare", None),
                        ("perfect", LF.with_links(TT.star(J),
                                                  LF.LinkModel())),
                        ("lossy", lossy)):
        meters[label] = tbw.BandwidthMeter()
        curves[label] = runner.run_scheme(
            "inl", views, labels, CFG, epochs=1, batch_size=BATCH,
            eval_n=64, topology=topo, meter=meters[label], device="cpu")
    assert curves["perfect"] == curves["bare"]
    rounds = len(labels) // BATCH
    per_edge = TT.round_edge_bits(lossy, CFG, BATCH)
    want = sum(per_edge[e.key] * LF.round_delivery_mask(
        LF.round_key(0, r), lossy, CFG, BATCH, train=True)[j]
        for r in range(rounds) for j, e in enumerate(lossy.edges))
    m = meters["lossy"]
    assert m.total_bits == meters["bare"].total_bits
    assert np.isclose(m.delivered_bits, want, rtol=1e-12)
    assert m.delivered_bits < m.total_bits
    assert curves["lossy"][-1].delivered_gbits == m.delivered_gbits


def test_draws_are_deterministic_and_disjoint_by_salt():
    topo = LF.with_links(TT.star(4), LF.LinkModel(erasure=0.3,
                                                  jitter_ms=1.0))
    a = LF.round_delivery_mask(LF.round_key(7, 0), topo, CFG, BATCH,
                               train=True)
    b = LF.round_delivery_mask(LF.round_key(7, 0), topo, CFG, BATCH,
                               train=True)
    assert np.array_equal(a, b)
    masks = [LF.round_delivery_mask(LF.round_key(7, r), topo, CFG, BATCH,
                                    train=True) for r in range(32)]
    assert any(not np.array_equal(masks[0], m) for m in masks[1:])
    k = LF.round_key(7, 0)
    streams = [LF._uniform(LF.fold_in(k, s), (256,)) for s in
               (LF._SALT_FAULTS, LF._SALT_DROPOUT, LF._SALT_RETRY)]
    streams.append(LF._uniform(LF.fold_in(LF.fault_key(k), 0), (256,)))
    for i in range(len(streams)):
        for j in range(i + 1, len(streams)):
            assert not np.isin(streams[i], streams[j]).any()
    assert (LF.round_key(7, 0) != LF.round_key(8, 0)
            and LF.round_key(7, 0) != LF.round_key(7, 1))


def _within(rate, p, n, sigmas=5.0):
    return abs(rate - p) <= sigmas * np.sqrt(p * (1 - p) / n)


def test_erasure_and_latency_tail_within_binomial_bounds():
    n = 4000
    star = TT.star(J)
    erased = 1.0 - LF.sample_delivery_mask(
        LF.key(1), LF.with_links(star, LF.LinkModel(erasure=0.3)), CFG,
        n).mean()
    assert _within(erased, 0.3, J * n)
    # latency 1 + Exp(1) ms against a 2 ms deadline: P(Exp(1) > 1) = e^-1
    late = 1.0 - LF.sample_delivery_mask(
        LF.key(2), LF.with_links(star, LF.LinkModel(latency_ms=1.0,
                                                    jitter_ms=1.0)),
        CFG, n, deadline=2.0).mean()
    assert _within(late, np.exp(-1.0), J * n)
    # SL's retries: all three attempts fail with p^3
    fails = np.mean([not LF.round_success(
        LF.round_key(3, r), LF.with_links(star, LF.LinkModel(erasure=0.5)),
        CFG, 3) for r in range(2000)])
    assert _within(fails, 0.125, 2000)


def test_chain_compounds_erasure_along_its_route():
    n = 4000
    topo = LF.with_links(TT.chain(4), LF.LinkModel(erasure=0.3))
    alive = LF.sample_delivery_mask(LF.key(4), topo, CFG, n).mean(axis=1)
    for j, rate in enumerate(alive):             # view j crosses 4 - j hops
        assert _within(rate, 0.7 ** (4 - j), n), (j, rate)
    assert alive[0] < alive[-1]


def test_request_masks_ignore_position_and_padding():
    topo = LF.with_links(TT.star(J), LF.LinkModel(erasure=0.3,
                                                  latency_ms=1.0,
                                                  jitter_ms=1.0))
    k = LF.key(9)
    ids = np.array([7, 3, 11, 3, 40], np.int32)
    m = LF.request_delivery_mask(k, topo, CFG, ids, deadline=2.0)
    assert m.shape == (J, 5) and not m.all() and m.any()
    for i, rid in enumerate(ids):
        alone = LF.request_delivery_mask(k, topo, CFG, [rid], deadline=2.0)
        assert np.array_equal(m[:, i], alone[:, 0])
    padded = LF.request_delivery_mask(
        k, topo, CFG, np.concatenate([ids[::-1], [ids[0]] * 11]),
        deadline=2.0)
    assert np.array_equal(padded[:, :5], m[:, ::-1])
    assert np.array_equal(m[:, 1], m[:, 3])       # one id, one mask


def test_single_uplink_serving_degrades_to_uniform():
    """SL served over a lossy star: the base predict_batched answers a
    request only if its whole uplink arrived, else with the uniform
    distribution; the served rows equal it under the id-keyed masks, and
    predict_under_faults on a perfect star is predict."""
    scheme = schemes.get("sl")
    st = scheme.init(CFG, 0, device="cpu")
    views = views_np(CFG, 7)
    topo = LF.with_links(TT.star(J), LF.LinkModel(erasure=0.2))
    engine = ServingEngine(scheme, st, CFG, topology=topo, seed=5,
                           device="cpu")
    probs, results = engine.serve(views)
    mask = LF.request_delivery_mask(LF.key(5), topo, CFG,
                                    [r.rid for r in results])
    idx = list(range(7)) + [6] * 9
    want = scheme.predict_batched(st, views[:, idx], delivery=mask[:, idx],
                                  cfg=CFG, device="cpu").numpy()[:7]
    assert np.array_equal(probs, want)
    ok = mask.all(axis=0)
    assert not ok.all()
    np.testing.assert_allclose(probs[~ok], 1.0 / CFG.num_classes, rtol=1e-6)
    clean = scheme.predict(st, views, device="cpu")
    assert torch.equal(torch.from_numpy(probs[ok]), clean[ok])
    perfect = LF.with_links(TT.star(J), LF.LinkModel())
    assert torch.equal(scheme.predict_under_faults(
        st, views, LF.key(0), topology=perfect, cfg=CFG, device="cpu"),
        clean)
    assert base.evaluate_accuracy_under_faults(
        scheme, st, views, np.zeros(7), LF.key(0), topology=perfect,
        cfg=CFG, device="cpu") == base.evaluate_accuracy(
            scheme, st, views, np.zeros(7), cfg=CFG, device="cpu")
