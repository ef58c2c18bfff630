"""The port's split-learning and federated-learning baselines
(repro_torch/core/{sl,fl}.py, core/schemes/{sl,fl}.py) against the JAX
reference.

JAX's threefry streams cannot be reproduced in torch, so the port is fed
what the reference drew: its raw init (`convert.sl_from_jax`,
`convert.fl_from_jax`) and, per round i, the dropout keep masks its round
draws inside its loss from `PRNGKey(i)`:
  * SL: `decoder_dropout_masks(PRNGKey(i), ...)`, the server decoder's;
  * FL: client j's local step s takes `sub` of the chain
    `r = split(PRNGKey(i), J)[j]; r, sub = split(r)` (one split per step).

Bars:
  * six rounds on tests/_schemes_common.CFG, one fixed batch: losses at
    rtol 1e-4; the trained parameters and BatchNorm statistics at rtol
    1e-5 (the running variances reach about 30) and atol lr / 100 = 2e-5
    (an FL client takes twelve Adam steps in six rounds, and Adam
    normalises each step, so an entry whose gradient lies at the rounding
    floor moves by a fraction of lr; measured: at most 1.3e-5); the conv
    biases and the running means that carry them, whose exact gradient is
    zero under BatchNorm, at rounds * lr (ROADMAP queue 3, as
    tests/test_torch_train.py);
  * the goldens: with the JAX draws under `jax.threefry_partitionable(False)`
    (ROADMAP queue 3), the port reproduces tests/golden/scheme_metrics.json
    for "sl" and "fl" at rtol 1e-4 with an equal final accuracy;
  * SL on the packed wire equals SL on the dense wire bit for bit, and
    matches the reference's packed SL at rtol 1e-4;
  * the bandwidth ledgers, the parameter counts and FL's Exp-2 view packing
    equal the reference's exactly.
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

from repro.core import paper_model as jpm  # noqa: E402
from repro.core import schemes as jschemes  # noqa: E402
from repro.core import sl as jsl  # noqa: E402
from repro.core.schemes import fl as jfl_scheme  # noqa: E402
from repro_torch import convert, optim, tree_leaves, tree_stack  # noqa: E402
from repro_torch.core import (fl, linkfault, paper_model,  # noqa: E402
                              schemes, sl)
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.schemes import base, runner  # noqa: E402
from repro_torch.core.schemes import fl as tfl_scheme  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden" / "scheme_metrics.json"
LR = 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sl_masks(cfg, i):
    return [torch.from_numpy(np.array(m)) for m in jpm.decoder_dropout_masks(
        jax.random.PRNGKey(i), cfg.dense_units, BATCH)]


def _fl_masks(cfg, i, local_steps=2):
    out = []
    for r in jax.random.split(jax.random.PRNGKey(i), cfg.num_clients):
        steps = []
        for _ in range(local_steps):
            r, sub = jax.random.split(r)
            steps.append([torch.from_numpy(np.array(m)) for m in
                          jpm.decoder_dropout_masks(sub, cfg.dense_units,
                                                    BATCH)])
        out.append(steps)
    return out


def _jax_state(name, cfg):
    return _np(jschemes.get(name).init(cfg, jax.random.PRNGKey(0)))


def _port_state(name, cfg, jst):
    if name == "sl":
        client, server, state = convert.sl_from_jax(
            jst["client"], jst["server"], jst["state"], cfg, device="cpu")
        return {"client": client, "server": server, "state": state,
                "opt_c": optim.adam(LR).init(client),
                "opt_s": optim.adam(LR).init(server)}
    params, state = convert.fl_from_jax(jst["params"], jst["state"], cfg,
                                        device="cpu")
    opt = [optim.adam(LR).init(fl.replica(params, j))
           for j in range(cfg.num_clients)]
    return {"params": params, "state": state, "opt": tree_stack(opt)}


def _inputs(name, cfg):
    views, labels = fixture_data()
    v, lab = round_inputs(jschemes.get(name), cfg, views, labels)
    return (torch.from_numpy(np.array(v)),
            torch.from_numpy(np.array(lab)).long())


def _port_rounds(name, cfg, jst, masks, wire="dense"):
    st = _port_state(name, cfg, jst)
    round_fn = schemes.get(name).make_round(cfg, lr=LR, wire=wire)
    v, lab = _inputs(name, cfg)
    out = []
    for m in masks:
        st, metrics = round_fn(st, v, lab, None, drop_masks=m)
        out.append(float(metrics["loss"]))
    return out, st


def _masks(name, cfg, rounds=ROUNDS):
    draw = _sl_masks if name == "sl" else _fl_masks
    return [draw(cfg, i) for i in range(rounds)]


def _trained_leaves(name, st):
    """(leaves held to rtol 1e-5 atol lr / 100, conv biases and BN running
    means)."""
    if name == "sl":
        encs, states = st["client"]["encoders"], st["state"]["encoders"]
        params = (st["client"], st["server"])
    else:
        encs, states = st["params"]["encoders"], st["state"]["encoders"]
        params = st["params"]
    loose = [c["b"] for e in encs for c in e["convs"]] \
        + [b["mean"] for s in states for b in s["bns"]]
    strict = [t for t in tree_leaves((params, st["state"]))
              if not any(t is x for x in loose)]
    return strict, loose


@pytest.mark.parametrize("name", ["sl", "fl"])
def test_six_rounds_match_jax(name):
    rec = trajectory(name)                    # the reference's six rounds
    got, st = _port_rounds(name, CFG, _jax_state(name, CFG),
                           _masks(name, CFG))
    np.testing.assert_allclose(got, rec["losses"], rtol=1e-4)
    want = _port_state(name, CFG, _np(rec["state"]))
    got_s, got_l = _trained_leaves(name, st)
    want_s, want_l = _trained_leaves(name, want)
    assert len(got_s) == len(want_s) > 0 and len(got_l) == len(want_l)
    for x, y in zip(got_s, want_s):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=LR / 100)
    for x, y in zip(got_l, want_l):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=ROUNDS * LR)
    # predict through the scheme on the reference's trained state: its
    # answers within rtol 1e-5 atol 1e-6 (one forward pass in fp32); on the
    # port's own trained state, whose conv biases and BN running means carry
    # the rounding noise above into eval mode, the same accuracy
    views, labels = fixture_data()
    v = np.array(views[:, :BATCH])
    jprobs = np.asarray(jschemes.get(name).predict(rec["state"],
                                                   views[:, :BATCH]))
    probs = schemes.get(name).predict(want, v, device="cpu")
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=1e-5, atol=1e-6)
    acc = (schemes.get(name).predict(st, v, device="cpu").argmax(-1).numpy()
           == np.array(labels[:BATCH])).mean()
    assert acc == rec["final_accuracy"]


@pytest.mark.parametrize("name", ["sl", "fl"])
def test_port_reproduces_golden_trajectory(name):
    """The goldens were drawn under the non-partitionable threefry; the JAX
    init and draws run in that scope, the port as always."""
    want = json.loads(GOLDEN.read_text())[name]
    with jax.threefry_partitionable(False):
        jst = _jax_state(name, CFG)
        masks = _masks(name, CFG)
    got, st = _port_rounds(name, CFG, jst, masks)
    np.testing.assert_allclose(got, want["losses"], rtol=1e-4)
    views, labels = fixture_data()
    probs = schemes.get(name).predict(st, np.array(views[:, :BATCH]),
                                      device="cpu")
    acc = float((probs.argmax(-1).numpy() == np.array(labels[:BATCH]))
                .mean())
    assert acc == want["final_accuracy"]


def _jax_packed_sl(cfg, rounds):
    scheme = jschemes.get("sl")
    state = scheme.init(cfg, jax.random.PRNGKey(0))
    round_fn = scheme.make_round(cfg, wire="packed")
    views, labels = fixture_data()
    v, lab = round_inputs(scheme, cfg, views, labels)
    out = []
    for i in range(rounds):
        state, m = round_fn(state, v, lab, jax.random.PRNGKey(i))
        out.append(float(m["loss"]))
    return out


def test_sl_on_the_packed_wire_is_dense_and_matches_jax():
    cfg = dataclasses.replace(CFG, link_bits=8)
    jst = _jax_state("sl", cfg)
    masks = _masks("sl", cfg, rounds=4)
    dense, st_d = _port_rounds("sl", cfg, jst, masks)
    packed, st_p = _port_rounds("sl", cfg, jst, masks, wire="packed")
    assert packed == dense
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st_d),
                                                  tree_leaves(st_p)))
    np.testing.assert_allclose(packed, _jax_packed_sl(cfg, 4), rtol=1e-4)
    duplex, _ = _port_rounds("sl", cfg, jst, masks, wire="packed_duplex")
    np.testing.assert_allclose(duplex, dense, rtol=0.05)
    assert duplex[0] == dense[0] and duplex != dense


def test_parameter_counts_match_jax():
    for cfg in (CFG, dataclasses.replace(CFG, conv_channels=(8, 16),
                                         d_bottleneck=16)):
        assert paper_model.encoder_param_count(cfg) == \
            jpm.encoder_param_count(cfg)
        assert paper_model.decoder_param_count(cfg) == \
            jpm.decoder_param_count(cfg)
        assert paper_model.fl_param_count(cfg) == jpm.fl_param_count(cfg)
    params, _ = paper_model.fl_model_init(torch.Generator().manual_seed(0),
                                          CFG)
    assert base.Scheme.param_count(params) == jpm.fl_param_count(CFG)


@pytest.mark.parametrize("name", ["sl", "fl"])
@pytest.mark.parametrize("wire", ["dense", "packed", "packed_duplex"])
def test_ledgers_match_jax(name, wire):
    cfg = dataclasses.replace(CFG, link_bits=4)
    tst = schemes.get(name).init(cfg, 0, device="cpu")
    jst = jschemes.get(name).init(cfg, jax.random.PRNGKey(0))
    ts, js = schemes.get(name), jschemes.get(name)
    assert ts.batches_per_round(cfg) == js.batches_per_round(cfg)
    assert ts.bits_per_round(cfg, tst, BATCH) == \
        js.bits_per_round(cfg, jst, BATCH)
    assert ts.epoch_overhead_bits(cfg, tst) == \
        js.epoch_overhead_bits(cfg, jst)
    assert ts.wire_bytes_per_round(cfg, tst, BATCH, wire=wire) == \
        js.wire_bytes_per_round(cfg, jst, BATCH, wire=wire)
    assert ts.epoch_overhead_wire_bytes(cfg, tst) == \
        js.epoch_overhead_wire_bytes(cfg, jst)
    if name == "sl":
        client = base.Scheme.param_count(tst["client"])
        assert ts.epoch_overhead_bits(cfg, tst) == \
            jsl.epoch_bits(cfg, 0, client, 4)


def test_runner_trains_sl_and_fl_and_meters_as_the_closed_forms():
    views, labels = (np.array(x) for x in fixture_data())
    cfg = dataclasses.replace(CFG, link_bits=8)
    curves = runner.run_all(("sl", "fl"), views, labels, cfg, epochs=1,
                            batch_size=BATCH, eval_n=BATCH, device="cpu",
                            wire="packed")
    n = labels.shape[0]
    for name, curve in curves.items():
        scheme, jscheme = schemes.get(name), jschemes.get(name)
        st = scheme.init(cfg, 0, device="cpu")
        jst = jscheme.init(cfg, jax.random.PRNGKey(0))
        rounds = runner.rounds_per_epoch(scheme, cfg, n, BATCH)
        bits = rounds * jscheme.bits_per_round(cfg, jst, BATCH) \
            + jscheme.epoch_overhead_bits(cfg, jst)
        nbytes = rounds * jscheme.wire_bytes_per_round(
            cfg, jst, BATCH, wire="packed") \
            + jscheme.epoch_overhead_wire_bytes(cfg, jst)
        assert len(curve) == 1 and 0.0 <= curve[0].accuracy <= 1.0
        assert curve[0].gbits == pytest.approx(bits / 1e9, rel=1e-12)
        assert curve[0].measured_gbits == pytest.approx(nbytes * 8 / 1e9,
                                                        rel=1e-12)
        assert curve[0].delivered_gbits == curve[0].gbits
        assert scheme.bits_per_round(cfg, st, BATCH) == \
            jscheme.bits_per_round(cfg, jst, BATCH)
    assert runner.rounds_per_epoch(schemes.get("fl"), cfg, n, BATCH) == \
        n // BATCH // (cfg.num_clients * 2)


def test_fl_views_packing_and_central_predict():
    J, ls = CFG.num_clients, 2
    rng = np.random.default_rng(0)
    views = rng.normal(size=(J * ls, J, 3, 4, 4, 2)).astype(np.float32)
    labels = rng.integers(0, 10, size=(J * ls, 3))
    got_v, got_l = tfl_scheme._pack_exp2_views(torch.from_numpy(views),
                                               torch.from_numpy(labels), J,
                                               ls)
    want_v, want_l = jfl_scheme._pack_exp2_views(jnp.asarray(views),
                                                 jnp.asarray(labels), J, ls)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    st = schemes.get("fl").init(CFG, 0, device="cpu")
    views, _ = fixture_data()
    probs = schemes.get("fl").predict(st, np.array(views[:, :8]),
                                      device="cpu")
    assert probs.shape == (8, CFG.num_classes)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)
    # every client starts from one broadcast copy
    for leaf in tree_leaves(st["params"]):
        assert leaf.shape[0] == J and torch.equal(leaf[0], leaf[-1])
    assert st["opt"]["step"].shape == (J,)


def test_registry_and_the_options_of_later_slices():
    assert schemes.available()[:3] == ("inl", "sl", "fl")
    lossy = linkfault.with_links(topology.star(CFG.num_clients),
                                 linkfault.LinkModel(erasure=0.3))
    for name in ("sl", "fl"):
        scheme = schemes.get(name)
        # unreliable links now build their rounds (tests/
        # test_torch_linkfault.py runs them); such a round needs its fault
        # key
        for cfg, topo in ((CFG, lossy),
                          (dataclasses.replace(CFG, edge_dropout=0.2), None)):
            round_fn = scheme.make_round(cfg, topology=topo)
            with pytest.raises(ValueError, match="round_key"):
                round_fn(None, None, None, None)
        with pytest.raises(ValueError, match="star topology only"):
            scheme.make_round(CFG, topology=topology.star(CFG.num_clients,
                                                          link_bits=4))
    with pytest.raises(ValueError, match="packable"):
        schemes.get("sl").make_round(CFG, wire="packed")     # link_bits 32
    # the masked FedAvg: a faulty round takes the client delivery mask
    assert callable(fl.make_round(CFG, optim.adam(LR), 2, faulty=True))
