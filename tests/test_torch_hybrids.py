"""The port's hybrid schemes (repro_torch/core/schemes/{splitfed,hybrid}.py)
against the JAX reference (src/repro/core/schemes/{splitfed,hybrid}.py),
mirroring tests/test_hybrid_schemes.py.

JAX's threefry streams cannot be reproduced in torch, so the port is fed
what the reference drew: its raw init (`convert.splitfed_from_jax`,
`convert.hybrid_from_jax`) and, per round i, the server decoder's dropout
keep masks.  Both reference steps split the round key and hand the SECOND
half to the decoder (`_, r_dec = split(rng)`), so round i's masks are
`decoder_dropout_masks(split(PRNGKey(i))[1], ...)` (SL's are drawn from
PRNGKey(i) itself).

Bars (those of tests/test_torch_sl_fl.py):
  * six rounds on tests/_schemes_common.CFG, one fixed batch: losses at
    rtol 1e-4; trained parameters and BatchNorm variances at rtol 1e-5,
    atol lr / 100; conv biases and BatchNorm running means
    (zero exact gradient under BatchNorm) at rounds * lr; predict on the
    reference's trained state at rtol 1e-5, atol 1e-6;
  * the goldens: with the JAX init and draws under
    `jax.threefry_partitionable(False)` (ROADMAP queue 3) the port
    reproduces tests/golden/scheme_metrics.json["splitfed"] and
    ["hybrid"] at rtol 1e-4 with an equal final accuracy;
  * cut_depth=1 on a two-block trunk and hybrid_fl_clients=(0, 1) train
    six rounds against JAX at the same bars; their errors word for word;
  * transport rounds on explicit masks (a dead cut client, a dead weight
    client, every client dead) against JAX's at the same bars, with the
    semantics bit for bit: SplitFed's dead client keeps its own update and
    the survivors hold one average, the hybrid's dead weight client keeps
    its previous rows;
  * predict with (J,) and (J, B) masks and predict_under_faults on JAX's
    masks at predict's bar; perfect links equal no links bit for bit; a
    lossy run delivers the replayed masks' payload fraction;
  * the ledgers: closed form == per-edge sum == metered == measured on the
    star and chain(5), equal to the reference's exactly, and at the full
    PaperExperimentConfig() the reference's closed forms.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _schemes_common import (BATCH, CFG, ROUNDS, fixture_data,  # noqa: E402
                             round_inputs, trajectory)

from repro.configs.paper_inl import \
    PaperExperimentConfig as JPaperConfig  # noqa: E402
from repro.core import linkfault as jlf  # noqa: E402
from repro.core import paper_model as jpm  # noqa: E402
from repro.core import schemes as jschemes  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.schemes import hybrid as jhybrid  # noqa: E402
from repro.core.schemes import splitfed as jsplitfed  # noqa: E402
from repro_torch import convert, optim, tree_leaves  # noqa: E402
from repro_torch.configs.paper_inl import \
    PaperExperimentConfig  # noqa: E402
from repro_torch.core import bandwidth, linkfault, paper_model  # noqa: E402
from repro_torch.core import schemes  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.schemes import hybrid, runner, splitfed  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden" / "scheme_metrics.json"
HYBRIDS = ("splitfed", "hybrid")
LR = 2e-3
J = CFG.num_clients
DEEP = dataclasses.replace(CFG, conv_channels=(4, 8))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _drops(cfg, i):
    """Round i's decoder keep masks: drawn from the second half of
    split(PRNGKey(i)), as both reference steps draw them."""
    r_dec = jax.random.split(jax.random.PRNGKey(i))[1]
    return [torch.from_numpy(np.array(m)) for m in
            jpm.decoder_dropout_masks(r_dec, cfg.dense_units, BATCH)]


def _jax_state(name, cfg):
    return _np(jschemes.get(name).init(cfg, jax.random.PRNGKey(0)))


def _port_state(name, cfg, jst):
    if name == "splitfed":
        params, state = convert.splitfed_from_jax(
            jst["params"], jst["state"], cfg, device="cpu")
        extra = {}
    else:
        params, state, modes = convert.hybrid_from_jax(
            jst["params"], jst["state"], jst["modes"], cfg, device="cpu")
        extra = {"modes": modes}
    return {"params": params, "state": state,
            "opt": optim.adam(LR).init(params), **extra}


def _inputs():
    views, labels = fixture_data()
    v, lab = round_inputs(jschemes.get("splitfed"), CFG, views, labels)
    return v, lab, (torch.from_numpy(np.array(v)),
                    torch.from_numpy(np.array(lab)).long())


def _port_rounds(name, cfg, jst, rounds=ROUNDS, **kw):
    st = _port_state(name, cfg, jst)
    round_fn = schemes.get(name).make_round(cfg, lr=LR, **kw)
    _, _, (tv, tlab) = _inputs()
    out = []
    for i in range(rounds):
        st, m = round_fn(st, tv, tlab, None, drop_masks=_drops(cfg, i))
        out.append(float(m["loss"]))
    return out, st


def _jax_rounds(name, cfg, rounds=ROUNDS):
    scheme = jschemes.get(name)
    st = scheme.init(cfg, jax.random.PRNGKey(0))
    round_fn = scheme.make_round(cfg, lr=LR)
    v, lab, _ = _inputs()
    out = []
    for i in range(rounds):
        st, m = round_fn(st, v, lab, jax.random.PRNGKey(i))
        out.append(float(m["loss"]))
    return out, _np(st)


def _split_leaves(st):
    """(parameters and BatchNorm statistics held to rtol 1e-5 atol
    lr / 100, conv biases and BatchNorm running means held to rounds *
    lr)."""
    encs, bns = st["params"]["encoders"], st["state"]["encoders"]["bns"]
    loose = [c["b"] for c in encs["convs"]] + [b["mean"] for b in bns]
    strict = [t for t in tree_leaves((st["params"], st["state"]))
              if not any(t is x for x in loose)]
    return strict, loose


def _assert_states_close(got, want, rounds=ROUNDS):
    got_s, got_l = _split_leaves(got)
    want_s, want_l = _split_leaves(want)
    assert len(got_s) == len(want_s) > 0 and len(got_l) == len(want_l) > 0
    for x, y in zip(got_s, want_s):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=LR / 100)
    for x, y in zip(got_l, want_l):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=rounds * LR)
    assert int(got["opt"]["step"]) == rounds
    if "modes" in want:
        assert torch.equal(got["modes"], want["modes"])


def _equal_leaves(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) > 0 and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# training against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", HYBRIDS)
def test_six_rounds_match_jax(name):
    rec = trajectory(name)                    # the reference's six rounds
    got, st = _port_rounds(name, CFG, _jax_state(name, CFG))
    np.testing.assert_allclose(got, rec["losses"], rtol=1e-4)
    want = _port_state(name, CFG, _np(rec["state"]))
    _assert_states_close(st, want)
    # predict through the scheme on the reference's trained state, with and
    # without a cfg (the hybrid reads its mode split from the state)
    views, labels = fixture_data()
    v = np.array(views[:, :BATCH])
    jprobs = np.asarray(jschemes.get(name).predict(rec["state"],
                                                   views[:, :BATCH]))
    for cfg in (None, CFG):
        probs = schemes.get(name).predict(want, v, cfg=cfg, device="cpu")
        np.testing.assert_allclose(probs.numpy(), jprobs, rtol=1e-5,
                                   atol=1e-6)
    acc = (schemes.get(name).predict(st, v, device="cpu").argmax(-1).numpy()
           == np.array(labels[:BATCH])).mean()
    assert acc == rec["final_accuracy"]


@pytest.mark.parametrize("name", HYBRIDS)
def test_port_reproduces_golden_trajectory(name):
    """The goldens were drawn under the non-partitionable threefry; the JAX
    init and draws run in that scope, the port as always."""
    want = json.loads(GOLDEN.read_text())[name]
    with jax.threefry_partitionable(False):
        jst = _jax_state(name, CFG)
        drops = [_drops(CFG, i) for i in range(ROUNDS)]
    st = _port_state(name, CFG, jst)
    round_fn = schemes.get(name).make_round(CFG, lr=LR)
    _, _, (tv, tlab) = _inputs()
    got = []
    for masks in drops:
        st, m = round_fn(st, tv, tlab, None, drop_masks=masks)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want["losses"], rtol=1e-4)
    views, labels = fixture_data()
    probs = schemes.get(name).predict(st, np.array(views[:, :BATCH]),
                                      device="cpu")
    acc = float((probs.argmax(-1).numpy() == np.array(labels[:BATCH]))
                .mean())
    assert acc == want["final_accuracy"]


@pytest.mark.parametrize("name", HYBRIDS)
def test_cut_depth_trains_against_jax(name):
    cfg = dataclasses.replace(DEEP, cut_depth=1)
    want, jst_trained = _jax_rounds(name, cfg)
    got, st = _port_rounds(name, cfg, _jax_state(name, cfg))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_states_close(st, _port_state(name, cfg, jst_trained))
    assert st["params"]["encoders"]["convs"][0]["w"].shape == (J, 4, 3, 3, 3)
    assert len(st["params"]["encoders"]["convs"]) == 1


@pytest.mark.parametrize("depth", (0, 3, -1))
def test_cut_depth_out_of_range_word_for_word(depth):
    bad = dataclasses.replace(DEEP, cut_depth=depth)
    with pytest.raises(ValueError) as want:
        jsplitfed.client_cfg(bad)
    with pytest.raises(ValueError, match="cut_depth") as got:
        splitfed.client_cfg(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="cut_depth"):
        schemes.get("splitfed").init(bad, 0, device="cpu")


def test_cut_depth_ledger_tracks_the_truncated_trunk():
    deep, shallow = DEEP, dataclasses.replace(DEEP, cut_depth=1)
    assert splitfed.client_cfg(shallow).conv_channels == (4,)
    assert splitfed.client_cfg(deep) is deep
    n_shallow = paper_model.encoder_param_count(splitfed.client_cfg(shallow))
    n_deep = paper_model.encoder_param_count(splitfed.client_cfg(deep))
    assert n_shallow == jpm.encoder_param_count(
        jsplitfed.client_cfg(shallow)) != n_deep
    scheme, jscheme = schemes.get("splitfed"), jschemes.get("splitfed")
    bits = {}
    for label, cfg in (("shallow", shallow), ("deep", deep)):
        st = scheme.init(cfg, 0, device="cpu")
        assert scheme.param_count(st["params"]["encoders"]) == J * (
            n_shallow if label == "shallow" else n_deep)
        bits[label] = scheme.bits_per_round(cfg, st, BATCH)
        assert bits[label] == jscheme.bits_per_round(
            cfg, jscheme.init(cfg, jax.random.PRNGKey(0)), BATCH)
    assert bits["shallow"] - bits["deep"] == 2.0 * 32.0 * J * (
        n_shallow - n_deep)


def test_two_weight_mode_clients_train_against_jax():
    cfg = dataclasses.replace(CFG, hybrid_fl_clients=(0, 1))
    want, jst_trained = _jax_rounds("hybrid", cfg)
    got, st = _port_rounds("hybrid", cfg, _jax_state("hybrid", cfg))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_states_close(st, _port_state("hybrid", cfg, jst_trained))
    assert st["modes"].tolist() == [False, False, True, True, True]


@pytest.mark.parametrize("fl", [(CFG.num_clients,), (-1, 2),
                                tuple(range(CFG.num_clients))])
def test_hybrid_fl_clients_validation_word_for_word(fl):
    bad = dataclasses.replace(CFG, hybrid_fl_clients=fl)
    with pytest.raises(ValueError) as want:
        jhybrid.cut_mask(bad)
    with pytest.raises(ValueError) as got:
        hybrid.cut_mask(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="hybrid"):
        schemes.get("hybrid").make_round(bad)
    assert np.array_equal(hybrid.cut_mask(CFG), jhybrid.cut_mask(CFG))
    assert hybrid.fl_clients(dataclasses.replace(
        CFG, hybrid_fl_clients=(3, 1, 3))) == (1, 3)


def test_hybrid_mix_changes_the_ledger_as_jax_does():
    scheme, jscheme = schemes.get("hybrid"), jschemes.get("hybrid")
    ledgers = []
    for fl in ((0,), (0, 1)):
        cfg = dataclasses.replace(CFG, hybrid_fl_clients=fl)
        got = scheme.edge_ledger(cfg, scheme.init(cfg, 0, device="cpu"),
                                 BATCH)
        want = jscheme.edge_ledger(
            cfg, jscheme.init(cfg, jax.random.PRNGKey(0)), BATCH)
        assert got == {k: (float(b), float(n))
                       for k, (b, n) in want.items()}
        ledgers.append(got)
    assert ledgers[0].keys() == ledgers[1].keys()
    assert ledgers[0] != ledgers[1]


def test_fedavg_matches_jax():
    rng = np.random.default_rng(3)
    new = {"a": rng.normal(size=(J, 3, 4)).astype(np.float32),
           "b": [rng.normal(size=(J, 7)).astype(np.float32)]}
    old = jax.tree.map(lambda x: x + 1.0, new)
    t_new = jax.tree.map(torch.from_numpy, new)
    for mask in (np.ones(J, bool), np.array([1, 0, 1, 1, 0], bool),
                 np.zeros(J, bool)):
        want = jax.jit(jsplitfed.fedavg)(new, old, jnp.asarray(mask))
        got = splitfed.fedavg(t_new, mask)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)
        dead = ~mask
        for g, x in zip(tree_leaves(got), tree_leaves(t_new)):
            assert torch.equal(g[dead], x[dead])      # their own update
            if mask.any():
                alive = g[mask]
                assert all(torch.equal(alive[0], r) for r in alive)


# ---------------------------------------------------------------------------
# faults: JAX's explicit masks through both packages' transport rounds
# ---------------------------------------------------------------------------

# a dead cut client (2), the dead weight client (0), every client dead
TRANSPORT_MASKS = (np.array([1, 1, 0, 1, 1], bool),
                   np.array([0, 1, 1, 1, 1], bool),
                   np.zeros(J, bool))


@pytest.mark.parametrize("name", HYBRIDS)
def test_transport_rounds_match_jax(name):
    v, lab, (tv, tlab) = _inputs()
    jsch = jschemes.get(name)
    jst = jsch.init(CFG, jax.random.PRNGKey(0))
    st = _port_state(name, CFG, _np(jst))
    jround = jsch.make_transport_round(CFG, lr=LR)
    round_fn = schemes.get(name).make_transport_round(CFG, lr=LR)
    for i, mask in enumerate(TRANSPORT_MASKS):
        jst, jm = jround(jst, v, lab, jax.random.PRNGKey(i),
                         jnp.asarray(mask))
        before = st
        st, m = round_fn(st, tv, tlab, None, mask, drop_masks=_drops(CFG, i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        _assert_states_close(st, _port_state(name, CFG, _np(jst)), i + 1)
        enc = tree_leaves(st["params"]["encoders"])
        if name == "splitfed":
            # survivors hold one average bit for bit; a dead client keeps
            # its own update, which is not that average
            for x in enc:
                alive = x[mask]
                assert all(torch.equal(alive[0], r) for r in alive)
            if mask.sum() == J - 1:
                dead = int(np.flatnonzero(~mask)[0])
                assert not torch.equal(enc[0][dead], enc[0][mask][0])
        else:
            prev = tree_leaves(before["params"]["encoders"]) + tree_leaves(
                before["params"]["decoder"]["branch_heads"])
            now = enc + tree_leaves(st["params"]["decoder"]["branch_heads"])
            for j in range(J):
                # weight client 0 reverts iff its route died; cut clients
                # keep their local updates
                reverted = all(torch.equal(a[j], b[j])
                               for a, b in zip(now, prev))
                assert reverted == (j == 0 and not mask[0]), (i, j)


@pytest.mark.parametrize("name", HYBRIDS)
def test_predict_with_delivery_matches_jax(name):
    rec = trajectory(name)
    st = _port_state(name, CFG, _np(rec["state"]))
    jsch, tsch = jschemes.get(name), schemes.get(name)
    views, _ = fixture_data()
    v = views[:, :8]
    rng = np.random.default_rng(2)
    per_sample = rng.random((J, 8)) < 0.6
    per_sample[:, 0] = False                     # nothing arrived
    per_sample[:, 1] = True                      # everything arrived
    per_sample[1:, 2] = False                    # only weight client 0
    for mask in (per_sample, np.array([1, 1, 0, 1, 0], bool),
                 np.array([0, 1, 1, 1, 1], bool)):
        want = np.asarray(jsch.predict_batched(rec["state"], v,
                                               delivery=jnp.asarray(mask)))
        got = tsch.predict_batched(st, np.array(v), delivery=mask,
                                   device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # predict_under_faults: JAX's per-sample masks fed to the port as data
    jt = jlf.with_links(JT.star(J), jlf.LinkModel(erasure=0.4))
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(7)
        mask = np.asarray(jlf.sample_delivery_mask(key, jt, CFG, 8))
        want = np.asarray(jsch.predict_under_faults(rec["state"], v, key,
                                                    topology=jt, cfg=CFG))
    assert not mask.all() and mask.any()
    got = tsch.predict_batched(st, np.array(v), delivery=mask,
                               device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the port's own draw: a (J, 8) mask of its fault stream
    tt = linkfault.with_links(TT.star(J), linkfault.LinkModel(erasure=0.4))
    own = linkfault.sample_delivery_mask(linkfault.key(7), tt, CFG, 8)
    assert torch.equal(
        tsch.predict_under_faults(st, np.array(v), linkfault.key(7),
                                  topology=tt, cfg=CFG, device="cpu"),
        tsch.predict_batched(st, np.array(v), delivery=own, topology=tt,
                             cfg=CFG, device="cpu"))


@pytest.mark.parametrize("graph", ["star", "chain(5)"])
@pytest.mark.parametrize("name", HYBRIDS)
def test_perfect_links_are_bitwise_identity(name, graph):
    """LinkModel() on every edge takes the fault path with all-ones masks
    (SplitFed's masked FedAvg, the hybrid's revert): losses and every state
    leaf equal the run without link models, bit for bit."""
    scheme = schemes.get(name)
    bare = TT.chain(J) if graph == "chain(5)" else TT.star(J)
    _, _, (tv, tlab) = _inputs()
    runs = []
    for topo in (bare, linkfault.with_links(bare, linkfault.LinkModel())):
        st = scheme.init(CFG, 0, lr=LR, device="cpu")
        round_fn = scheme.make_round(CFG, lr=LR, topology=topo)
        gen = torch.Generator().manual_seed(1)
        losses = []
        for i in range(2):
            kw = {} if topo is bare else {
                "round_key": linkfault.round_key(0, i)}
            st, m = round_fn(st, tv, tlab, gen, **kw)
            losses.append(m["loss"])
        runs.append((losses, st))
    (la, sa), (lb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert _equal_leaves(sa, sb)
    with pytest.raises(ValueError, match="round_key"):
        scheme.make_round(CFG, topology=linkfault.with_links(
            bare, linkfault.LinkModel()))(sa, tv, tlab, None)


@pytest.mark.parametrize("name", HYBRIDS)
def test_lossy_run_delivers_the_replayed_payload_fraction(name):
    views, labels = (np.array(x) for x in fixture_data())
    lossy = linkfault.with_links(
        TT.star(J), linkfault.LinkModel(erasure=linkfault.forced_erasure(
            0.3)))
    meter = bandwidth.BandwidthMeter()
    curve = runner.run_scheme(name, views, labels, CFG, epochs=1,
                              batch_size=BATCH, eval_n=64, topology=lossy,
                              meter=meter, device="cpu")
    scheme = schemes.get(name)
    ledger = scheme.edge_ledger(CFG, scheme.init(CFG, 0, device="cpu"),
                                BATCH)
    rounds = len(labels) // BATCH
    want = sum(ledger[e.key][0] * linkfault.round_delivery_mask(
        linkfault.round_key(0, r), lossy, CFG, BATCH, train=True)[j]
        for r in range(rounds) for j, e in enumerate(lossy.edges))
    assert np.isfinite(curve[-1].accuracy)
    assert meter.total_bits == rounds * sum(b for b, _ in ledger.values())
    assert np.isclose(meter.delivered_bits, want, rtol=1e-12)
    assert curve[-1].delivered_gbits < curve[-1].gbits


# ---------------------------------------------------------------------------
# bandwidth: closed form == per-edge ledger == metered == measured == JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["dense", "packed_duplex"])
@pytest.mark.parametrize("graph", ["star", "chain(5)"])
@pytest.mark.parametrize("name", HYBRIDS)
def test_ledgers_match_jax_and_the_meter(name, graph, wire):
    cfg = CFG if wire == "dense" else dataclasses.replace(CFG, link_bits=4)
    tt = TT.chain(J) if graph == "chain(5)" else None
    jt = JT.chain(J) if graph == "chain(5)" else None
    scheme, jscheme = schemes.get(name), jschemes.get(name)
    st = scheme.init(cfg, 0, device="cpu")
    jst = jscheme.init(cfg, jax.random.PRNGKey(0))
    ledger = scheme.edge_ledger(cfg, st, BATCH, wire=wire, topology=tt)
    want = jscheme.edge_ledger(cfg, jst, BATCH, wire=wire, topology=jt)
    assert ledger == {k: (float(b), float(n)) for k, (b, n) in want.items()}
    closed = scheme.bits_per_round(cfg, st, BATCH, topology=tt)
    nbytes = scheme.wire_bytes_per_round(cfg, st, BATCH, wire=wire,
                                         topology=tt)
    assert closed == sum(b for b, _ in ledger.values()) == \
        jscheme.bits_per_round(cfg, jst, BATCH, topology=jt)
    assert nbytes == sum(n for _, n in ledger.values()) == \
        jscheme.wire_bytes_per_round(cfg, jst, BATCH, wire=wire,
                                     topology=jt)
    if wire == "dense":     # fp32 at q=32: the wire ships what is charged
        assert nbytes * 8 == closed
    views, labels = (np.array(x) for x in fixture_data())
    meter = bandwidth.BandwidthMeter()
    curve = runner.run_scheme(name, views, labels, cfg, epochs=1,
                              batch_size=BATCH, eval_n=BATCH, wire=wire,
                              topology=tt, meter=meter, device="cpu")
    rounds = runner.rounds_per_epoch(scheme, cfg, len(labels), BATCH)
    assert meter.total_bits == rounds * closed
    assert meter.measured_bytes == rounds * nbytes
    assert meter.edge_measured_bytes == {k: rounds * n
                                         for k, (_, n) in ledger.items()}
    assert curve[-1].gbits == meter.total_bits / 1e9
    assert curve[-1].delivered_gbits == curve[-1].gbits


# (link_bits, wire, cut_depth) -> the reference's closed forms at
# PaperExperimentConfig(), batch 64, hybrid_fl_clients=(0,): {scheme:
# (bits per round, measured wire bytes per round)}
FULL_WIDTH_TABLE = {
    (32, "dense", None): {"splitfed": (115_220_480, 14_402_560),
                          "hybrid": (23_872_128, 2_984_016)},
    (32, "dense", 1): {"splitfed": (337_203_200, 42_150_400),
                       "hybrid": (68_268_672, 8_533_584)},
    (4, "packed_duplex", None): {"splitfed": (114_073_600, 14_259_200),
                                 "hybrid": (22_954_624, 2_869_328)},
    (4, "packed_duplex", 1): {"splitfed": (336_056_320, 42_007_040),
                              "hybrid": (67_351_168, 8_418_896)},
}


@pytest.mark.parametrize("row", list(FULL_WIDTH_TABLE),
                         ids=[f"b{b}-{w}-depth{d}"
                              for b, w, d in FULL_WIDTH_TABLE])
def test_full_width_ledgers_equal_the_reference(row):
    bits, wire, depth = row
    cfg = PaperExperimentConfig(link_bits=bits, cut_depth=depth)
    jcfg = JPaperConfig(link_bits=bits, cut_depth=depth)
    for name, (want_bits, want_bytes) in FULL_WIDTH_TABLE[row].items():
        scheme, jscheme = schemes.get(name), jschemes.get(name)
        st = scheme.init(cfg, 0, device="cpu")
        jst = jax.eval_shape(lambda k, s=jscheme: s.init(jcfg, k),
                             jax.random.PRNGKey(0))
        got = (scheme.bits_per_round(cfg, st, 64),
               scheme.wire_bytes_per_round(cfg, st, 64, wire=wire))
        assert got == (want_bits, want_bytes)
        assert got == (jscheme.bits_per_round(jcfg, jst, 64),
                       jscheme.wire_bytes_per_round(jcfg, jst, 64,
                                                    wire=wire))


# ---------------------------------------------------------------------------
# serving and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", HYBRIDS)
def test_engine_serves_the_hybrids(name):
    """Served rows equal predict_batched in their padded bucket, bit for
    bit, on the clean star and under id-keyed masks of a lossy one."""
    scheme = schemes.get(name)
    st = scheme.init(CFG, 0, device="cpu")
    views = np.array(fixture_data()[0][:, :7])
    idx = list(range(7)) + [6] * 9                   # bucket 16
    clean_engine = ServingEngine(scheme, st, CFG, device="cpu")
    probs, results = clean_engine.serve(views)
    assert {r.bucket for r in results} == {16}
    want = scheme.predict_batched(st, views[:, idx], cfg=CFG,
                                  device="cpu").numpy()[:7]
    assert np.array_equal(probs, want)
    topo = linkfault.with_links(TT.star(J), linkfault.LinkModel(erasure=0.4))
    engine = ServingEngine(scheme, st, CFG, topology=topo, seed=5,
                           device="cpu")
    probs, results = engine.serve(views)
    mask = linkfault.request_delivery_mask(linkfault.key(5), topo, CFG,
                                           [r.rid for r in results])
    assert not mask.all()
    want = scheme.predict_batched(st, views[:, idx], delivery=mask[:, idx],
                                  cfg=CFG, device="cpu").numpy()[:7]
    assert np.array_equal(probs, want)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-6)
    assert engine.meter.delivery_ratio < 1.0


def test_registry_lists_every_scheme_and_refuses_unknown_names():
    assert schemes.available() == ("inl", "sl", "fl", "hybrid", "splitfed")
    assert schemes.available() == jschemes.available()
    with pytest.raises(KeyError) as ei:
        schemes.get("splitfedv2")
    for name in ("inl", "fl", "sl") + HYBRIDS:
        assert f"'{name}'" in str(ei.value)
    for name in HYBRIDS:
        with pytest.raises(ValueError, match="packable"):
            schemes.get(name).make_round(CFG, wire="packed")   # 32 bits
