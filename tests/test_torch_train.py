"""The port's INL training (repro_torch/core/inl train step, optim, the
Scheme round) against the JAX reference.

JAX's threefry streams cannot be reproduced in torch, so the port is fed
what the reference drew: its raw init (`convert.inl_from_jax`), and per
round i the eps and dropout masks of `r_enc, r_dec = split(PRNGKey(i))`
(eps = normal(r_enc, (J, B, d)); masks = decoder_dropout_masks(r_dec, ...)),
the draws the reference's round makes inside its loss.

  * six rounds on tests/_schemes_common.CFG, one fixed batch: losses at
    rtol 1e-4 and the parameters and BatchNorm statistics after round 6 at
    atol 1e-5 (the conv biases, whose exact gradient is zero, see
    `_strict_and_loose`), with and without learned priors;
  * the goldens: under `jax.threefry_partitionable(False)` around the JAX
    draws only (ROADMAP queue 3), the port reproduces
    tests/golden/scheme_metrics.json for "inl" and "inl+learned_prior" at
    rtol 1e-4 with an equal final accuracy;
  * compute_dtype="bf16": two rounds at rtol 1e-2 (bf16 convolutions and
    matmuls accumulate differently in the two frameworks);
  * the optimizer, the loss terms, the rate estimators and the link
    quantizer against their reference counterparts.
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
                             trajectory)

from repro import optim as joptim  # noqa: E402
from repro.core import bottleneck as jbottleneck  # noqa: E402
from repro.core import linkmodel as jlinkmodel  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import paper_model as jpm  # noqa: E402
from repro.core import schemes as jschemes  # noqa: E402
from repro_torch import convert, optim, tree_leaves, tree_map  # noqa: E402
from repro_torch.core import bottleneck, inl, linkmodel, losses  # noqa: E402
from repro_torch.core import schemes  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden" / "scheme_metrics.json"


def _cfg(learned_prior=False, **kw):
    return dataclasses.replace(CFG, learned_prior=learned_prior, **kw)


def _draws(cfg, i):
    """The reference's round-i noise, as torch tensors."""
    r_enc, r_dec = jax.random.split(jax.random.PRNGKey(i))
    eps = jax.random.normal(r_enc, (cfg.num_clients, BATCH,
                                    cfg.d_bottleneck), jnp.float32)
    masks = jpm.decoder_dropout_masks(r_dec, cfg.dense_units, BATCH)
    return (torch.from_numpy(np.array(eps)),
            [torch.from_numpy(np.array(m)) for m in masks])


def _jax_init(cfg):
    """The reference scheme's raw init (no added noise), as numpy."""
    st = jschemes.get("inl").init(cfg, jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, st["params"]),
            jax.tree.map(np.asarray, st["state"]))


def _batch():
    views, labels = fixture_data()
    return (torch.from_numpy(np.array(views[:, :BATCH]))[None],
            torch.from_numpy(np.array(labels[:BATCH])).long()[None])


def _port_rounds(cfg, jinit, draws):
    """The port's INL rounds from the reference's init and draws; returns
    (losses, final scheme state)."""
    params, state = convert.inl_from_jax(*jinit, cfg, device="cpu")
    st = {"params": params, "state": state,
          "opt": optim.adam(2e-3).init(params)}
    round_fn = schemes.get("inl").make_round(cfg)
    v, lab = _batch()
    out = []
    for eps, masks in draws:
        st, m = round_fn(st, v, lab, None, eps=eps, drop_masks=masks)
        out.append(float(m["loss"]))
    return out, st


def _strict_and_loose(params, state):
    """(leaves held to atol 1e-5, leaves held to ROUNDS * lr).

    A conv bias feeds BatchNorm, which subtracts it again: its exact
    gradient is zero, and what either framework computes is rounding noise
    that Adam scales up to steps of about lr.  Those biases, and the
    BatchNorm running means that carry them, can differ by up to
    ROUNDS * lr; every other leaf is held to 1e-5."""
    loose = [c["b"] for c in params.encoders["convs"]] \
        + [b["mean"] for b in state["encoders"]["bns"]]
    strict = [t for t in tree_leaves((params, state))
              if not any(t is x for x in loose)]
    return strict, loose


@pytest.mark.parametrize("learned_prior", [False, True],
                         ids=["inl", "inl+learned_prior"])
def test_six_rounds_match_jax(learned_prior):
    cfg = _cfg(learned_prior)
    rec = trajectory("inl", learned_prior)          # the reference's rounds
    got, st = _port_rounds(cfg, _jax_init(cfg),
                           [_draws(cfg, i) for i in range(ROUNDS)])
    np.testing.assert_allclose(got, rec["losses"], rtol=1e-4)
    jst = rec["state"]
    want_p, want_s = convert.inl_from_jax(
        jax.tree.map(np.asarray, jst["params"]),
        jax.tree.map(np.asarray, jst["state"]), cfg, device="cpu")
    got_s, got_l = _strict_and_loose(st["params"], st["state"])
    want_s, want_l = _strict_and_loose(want_p, want_s)
    assert len(got_s) == len(want_s) > 0 and len(got_l) == len(want_l)
    for x, y in zip(got_s, want_s):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-5)
    for x, y in zip(got_l, want_l):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=ROUNDS * 2e-3)
    assert int(st["opt"]["step"]) == ROUNDS
    if learned_prior:
        assert float(st["params"].priors["logvar"].abs().max()) > 0.0


@pytest.mark.parametrize("learned_prior", [False, True],
                         ids=["inl", "inl+learned_prior"])
def test_port_reproduces_golden_trajectory(learned_prior):
    """The checked-in goldens were drawn under the non-partitionable
    threefry; the JAX draws run in that scope, the port as always."""
    cfg = _cfg(learned_prior)
    want = json.loads(GOLDEN.read_text())[
        "inl+learned_prior" if learned_prior else "inl"]
    with jax.threefry_partitionable(False):
        jinit = _jax_init(cfg)
        draws = [_draws(cfg, i) for i in range(ROUNDS)]
    got, st = _port_rounds(cfg, jinit, draws)
    np.testing.assert_allclose(got, want["losses"], rtol=1e-4)
    views, labels = fixture_data()
    probs = inl.predict(st["params"], st["state"],
                        np.array(views[:, :BATCH]), device="cpu")
    acc = float((probs.argmax(-1).numpy() == np.array(labels[:BATCH]))
                .mean())
    assert acc == want["final_accuracy"]


def test_bf16_policy_two_rounds_match_jax():
    cfg = _cfg(compute_dtype="bf16")
    scheme = jschemes.get("inl")
    jst = scheme.init(cfg, jax.random.PRNGKey(0))
    jinit = (jax.tree.map(np.asarray, jst["params"]),
             jax.tree.map(np.asarray, jst["state"]))
    round_fn = scheme.make_round(cfg)
    views, labels = fixture_data()
    v, lab = views[None, :, :BATCH], labels[None, :BATCH]
    want = []
    for i in range(2):
        jst, m = round_fn(jst, v, lab, jax.random.PRNGKey(i))
        want.append(float(m["loss"]))
    got, st = _port_rounds(cfg, jinit, [_draws(cfg, i) for i in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-2)
    # the policy casts inside the loss: parameters and moments stay fp32
    floats = tree_leaves((st["params"], st["state"], st["opt"]["m"],
                          st["opt"]["v"]))
    assert all(t.dtype == torch.float32 for t in floats)
    assert "master" not in st["opt"]


def test_train_step_bits_and_metrics():
    cfg = _cfg()
    params, state = inl.init(cfg, 0, device="cpu")
    opt = optim.adam(2e-3)
    step = inl.make_train_step(cfg, opt)
    v, lab = _batch()
    g = torch.Generator().manual_seed(0)
    new_p, new_s, new_o, m = step(params, state, opt.init(params), v[0],
                                  lab[0], g)
    assert float(m["bits_sent"]) == jlinkmodel.training_step_bits(
        BATCH, cfg.num_clients * cfg.d_bottleneck, cfg.link_bits)
    assert set(m) == {"loss", "ce_joint", "ce_branch_mean", "rate_mean",
                      "rate_total", "accuracy", "bits_sent"}
    assert all(not t.requires_grad for t in tree_leaves((new_p, new_s, m)))
    # the BatchNorm statistics moved and the parameters changed
    assert not torch.equal(new_s["encoders"]["bns"][0]["mean"],
                           state["encoders"]["bns"][0]["mean"])
    assert not torch.equal(new_p.decoder["dense"][0]["w"],
                           params.decoder["dense"][0]["w"])
    with pytest.raises(ValueError, match="generator"):
        step(params, state, opt.init(params), v[0], lab[0], None)


def test_deferred_training_options_raise():
    cfg = _cfg()
    from repro_torch.core import linkfault, topology
    # the transport-mode step, link models and edge dropout are ported
    # (tests/test_torch_linkfault.py); a step over unreliable links that
    # is given neither its fault key nor a delivery mask says so
    assert callable(inl.make_train_step(cfg, optim.adam(1e-3),
                                        explicit_delivery=True))
    lossy = linkfault.with_links(topology.star(cfg.num_clients, link_bits=4),
                                 linkfault.LinkModel(erasure=0.3))
    v, lab = _batch()
    for c, topo in ((cfg, lossy), (_cfg(edge_dropout=0.2), None)):
        params, state = inl.init(c, 0, device="cpu")
        step = inl.make_train_step(c, optim.adam(1e-3), topology=topo)
        with pytest.raises(ValueError, match="round_key"):
            step(params, state, optim.adam(1e-3).init(params), v[0], lab[0],
                 torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="packable"):     # link_bits 32
        inl.make_train_step(cfg, optim.adam(1e-3), wire="packed")


def _tree(seed, shapes=((3, 4), (5,), (2, 2, 2))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.normal(size=s).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_reference(name):
    """Three updates of the port's optimizer against repro.optim on the same
    parameters and gradients (clipping engaged: the gradients' global norm
    exceeds 1)."""
    make = {"adam": lambda m: m.adam(1e-2),
            "adamw": lambda m: m.adamw(m.warmup_cosine_schedule(1e-2, 2, 6),
                                       weight_decay=0.1),
            "sgd": lambda m: m.sgd(m.linear_schedule(1e-2, 1, 5),
                                   momentum=0.9, clip_norm=1.0)}[name]
    jo, to = make(joptim), make(optim)
    p = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = _tree(i + 1)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(ts["step"]) == int(js["step"]) == 3
    g = {k: torch.from_numpy(v) for k, v in _tree(9).items()}
    np.testing.assert_allclose(
        float(optim.global_norm(g)),
        float(joptim.global_norm({k: jnp.asarray(v.numpy())
                                  for k, v in g.items()})), rtol=1e-6)


def test_adam_keeps_fp32_master_for_bf16_params():
    p = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in _tree(0).items()}
    opt = optim.adam(1e-2)
    st = opt.init(p)
    assert all(t.dtype == torch.float32 for t in tree_leaves(st["master"]))
    new_p, st = opt.update(tree_map(torch.ones_like, p), st, p)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(new_p))
    assert all(t.dtype == torch.float32 for t in tree_leaves(st["master"]))


def test_loss_terms_match_reference():
    rng = np.random.default_rng(0)
    J, B, C, d = 3, 6, 5, 4
    joint = rng.normal(size=(B, C)).astype(np.float32)
    branch = rng.normal(size=(J, B, C)).astype(np.float32)
    labels = np.array([0, 1, -1, 4, 2, -1], np.int32)
    mu, lv, u = (rng.normal(size=(J, B, d)).astype(np.float32)
                 for _ in range(3))
    prior = {"mu": rng.normal(size=(J, d)).astype(np.float32),
             "logvar": rng.normal(size=(J, d)).astype(np.float32)}
    T = torch.from_numpy
    np.testing.assert_allclose(
        float(losses.xent(T(joint), T(labels))),
        float(jlosses.xent(jnp.asarray(joint), jnp.asarray(labels))),
        rtol=1e-6)
    for est in ("sample", "analytic"):
        for pri in ({}, prior):
            tl, tm = losses.inl_loss(
                T(joint), list(T(branch)), T(labels), list(T(mu)),
                list(T(lv)), list(T(u)), s=0.01, rate_estimator=est,
                priors={k: T(v) for k, v in pri.items()})
            jl, jm = jlosses.inl_loss(
                jnp.asarray(joint), list(jnp.asarray(branch)),
                jnp.asarray(labels), list(jnp.asarray(mu)),
                list(jnp.asarray(lv)), list(jnp.asarray(u)), s=0.01,
                rate_estimator=est,
                priors={k: jnp.asarray(v) for k, v in pri.items()})
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        bottleneck.rate_sampled(T(u[0]), T(mu[0]), T(lv[0])).numpy(),
        np.asarray(jbottleneck.rate_sampled(u[0], mu[0], lv[0])),
        rtol=1e-5, atol=1e-5)


def test_quantize_st_is_straight_through():
    x = torch.linspace(-5, 5, 41, requires_grad=True)
    q = linkmodel.quantize_st(x, 3)
    np.testing.assert_allclose(
        q.detach().numpy(),
        np.asarray(jlinkmodel.quantize_st(jnp.asarray(x.detach().numpy()),
                                          3)), atol=5e-7)
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert linkmodel.quantize_st(x, 32) is x
    assert linkmodel.inference_step_bits(4, 10, 8) == \
        jlinkmodel.inference_step_bits(4, 10, 8)
    assert linkmodel.activation_bits(4, 10, 8) == 320


def test_bottleneck_estimators_match_reference():
    """sample keeps the latent's dtype; the rate estimators (standard and
    learned prior) and the log-densities equal the reference's."""
    rng = np.random.default_rng(1)
    mu, lv, u = (rng.normal(size=(6, 4)).astype(np.float32)
                 for _ in range(3))
    prior = {"mu": rng.normal(size=(4,)).astype(np.float32),
             "logvar": rng.normal(size=(4,)).astype(np.float32)}
    T = torch.from_numpy
    tp = {k: T(v) for k, v in prior.items()}
    for pri_t, pri_j in (({}, {}), (tp, prior)):
        np.testing.assert_allclose(
            bottleneck.rate_analytic(T(mu), T(lv), pri_t).numpy(),
            np.asarray(jbottleneck.rate_analytic(mu, lv, pri_j)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            bottleneck.rate_sampled(T(u), T(mu), T(lv), pri_t).numpy(),
            np.asarray(jbottleneck.rate_sampled(u, mu, lv, pri_j)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            bottleneck.prior_logpdf(pri_t, T(u)).numpy(),
            np.asarray(jbottleneck.prior_logpdf(pri_j, u)), rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    s = bottleneck.sample(g, T(mu).to(torch.bfloat16), T(lv))
    assert s.dtype == torch.bfloat16 and s.shape == (6, 4)
    eps = torch.randn((6, 4), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        bottleneck.sample(torch.Generator().manual_seed(0), T(mu), T(lv)),
        T(mu) + torch.exp(0.5 * T(lv)) * eps)
    assert bottleneck.prior_init(4) == {}
    p = bottleneck.prior_init(4, learned=True, num_nodes=3)
    assert p["mu"].shape == (3, 4) and not p["logvar"].any()
