"""The port's network topologies (repro_torch/core/topology, wirefmt's
relay_hop, the graph paths of core/inl, the INL scheme, the runner and the
serving engine) against the JAX reference, on tests/_schemes_common.CFG.

The bars (ROADMAP queue 3): codewords identical, values within one ulp,
rows with an entry within 1e-6 of a rounding midpoint excepted and
counted; gradients through the hops within 1e-5 of `jax.grad` of the
reference; training rounds at rtol 1e-4.  The reference draws its round
noise inside `jax.threefry_partitionable(False)`, and the port is fed the
same draws.

  * `chain`, `tree`, `from_name` and `named_topologies` build the
    reference's graphs and raise its validation errors, word for word;
  * `graph_cut_and_ship` on chain(5), chain(2, link_bits=(8, 2)) and
    tree(2, 2), dense and packed (and duplex on the chain), forward and
    backward; `relay_hop` alone on re-codings, dtypes and wires;
  * in the port alone: a dense homogeneous chain(5) is the star bit for
    bit (latents, rate, gradients, the loss), and a packed chain is the
    dense chain bit for bit;
  * per-edge bits and bytes equal the reference's exactly, and measured
    bytes equal the closed forms on a mixed-width chain;
  * four INL rounds on chain(5, link_bits=(2, 4, 8, 8, 32)) and on
    tree(2, 2), graph predict, the runner's per-edge meter, served rows on
    chain(5) equal to predict bit for bit, FL/SL refusing graphs with the
    reference's messages, and the heterogeneous-encoder loss and
    gradients;
  * what stays for ROADMAP item 9 raises NotImplementedError, and link
    models on a graph's edges (item 8) leave its hops as they are.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _schemes_common import CFG  # noqa: E402
from _torch_common import cut_inputs, near_midpoint  # noqa: E402

from repro.core import inl as jinl  # noqa: E402
from repro.core import paper_model as jpm  # noqa: E402
from repro.core import schemes as jschemes  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core import wirefmt as jwire  # noqa: E402
from repro.core.schemes import runner as jrunner  # noqa: E402
from repro.data import multiview  # noqa: E402
from repro_torch import convert, optim, tree_leaves, value_and_grad  # noqa
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import inl, linkfault, schemes, wirefmt  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.schemes import runner  # noqa: E402
from repro_torch.serving import ServingEngine, batching  # noqa: E402

B = 16
ROUNDS = 4
CFG8 = dataclasses.replace(CFG, link_bits=8)
CFG6 = dataclasses.replace(CFG, num_clients=6,
                           noise_stds=(0.4, 1.0, 2.0, 3.0, 4.0, 0.7))
CFG6_8 = dataclasses.replace(CFG6, link_bits=8)
CFG2 = dataclasses.replace(CFG, num_clients=2, noise_stds=(0.4, 1.0))
HET = (2, 4, 8, 8, 32)


def _both(make):
    """make(module) for the reference's topology module and the port's."""
    return make(JT), make(TT)


def _structure(t):
    """Everything a Topology says, as plain values."""
    return (tuple((n.name, n.role) for n in t.nodes),
            tuple((e.src, e.dst, e.link_bits, e.wire, e.dtype)
                  for e in t.edges),
            tuple(e.key for e in t.topo_edges()),
            tuple(t.payload(e) for e in t.topo_edges()),
            t.levels(), t.is_default_star(), t.describe(), t.fuse_node)


# ---------------------------------------------------------------------------
# constructors and validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda T: T.star(5), lambda T: T.star(3, link_bits=4),
    lambda T: T.chain(1), lambda T: T.chain(5),
    lambda T: T.chain(5, link_bits=HET), lambda T: T.tree(2, 2),
    lambda T: T.tree(3, 1), lambda T: T.tree(1, 3),
    lambda T: T.tree(2, 2, link_bits=8), lambda T: T.tree(3, 2)],
    ids=["star5", "star3-b4", "chain1", "chain5", "chain5-het", "tree22",
         "tree31", "tree13", "tree22-b8", "tree32"])
def test_constructors_build_the_reference_graphs(make):
    want, got = _both(make)
    assert _structure(got) == _structure(want)
    assert got.num_views() == want.num_views()
    assert got.view_nodes() == want.view_nodes()


@pytest.mark.parametrize("J", [1, 2, 5, 6, 12, 14])
def test_named_topologies_and_from_name_match_the_reference(J):
    want, got = _both(lambda T: T.named_topologies(J))
    assert list(got) == list(want)
    for name, topo in got.items():
        assert _structure(topo) == _structure(want[name])
        assert _structure(TT.from_name(name)) == _structure(topo)
        assert _structure(TT.from_name(name.replace(",", ", "))) == \
            _structure(topo)
    chains = TT.named_topologies(J, families=("chain",))
    assert list(chains) == list(JT.named_topologies(J, families=("chain",)))


@pytest.mark.parametrize("make", [
    lambda T: T.star(0), lambda T: T.chain(0), lambda T: T.tree(0, 1),
    lambda T: T.tree(2, 0), lambda T: T.chain(3, link_bits=(2, 4)),
    lambda T: T.star(2, link_bits=(1, 2, 3)),
    lambda T: T.from_name("ring(3)"), lambda T: T.from_name("tree(2)"),
    lambda T: T.from_name("chain(2,2)"), lambda T: T.from_name("star(0)"),
    lambda T: T.from_name("tree(0,3)"),
    # the validation of a hand-built graph
    lambda T: T.Topology((T.Node("a", "measure"),), ()),
    lambda T: T.Topology(
        (T.Node("a", "measure"), T.Node("r", "relay"), T.Node("f", "fuse")),
        (T.Edge("a", "r"), T.Edge("a", "f"), T.Edge("r", "f"))),
    lambda T: T.Topology(
        (T.Node("a", "measure"), T.Node("r1", "relay"),
         T.Node("r2", "relay"), T.Node("f", "fuse")),
        (T.Edge("a", "r1"), T.Edge("r1", "r2"), T.Edge("r2", "r1"))),
    lambda T: T.Topology(
        (T.Node("stranded", "measure"), T.Node("loner", "relay"),
         T.Node("m", "measure"), T.Node("f", "fuse")),
        (T.Edge("stranded", "loner"), T.Edge("m", "f"))),
    lambda T: T.Topology((T.Node("orphan", "relay"), T.Node("f", "fuse")),
                         (T.Edge("orphan", "f"),)),
    lambda T: T.Topology(
        (T.Node("a", "measure"), T.Node("b", "measure"),
         T.Node("f", "fuse")), (T.Edge("a", "b"), T.Edge("b", "f"))),
    lambda T: T.Topology((T.Node("f", "fuse"),), (T.Edge("ghost", "f"),)),
    lambda T: T.Topology((T.Node("dup", "measure"), T.Node("dup", "measure"),
                          T.Node("f", "fuse")), (T.Edge("dup", "f"),)),
    lambda T: T.resolve(T.chain(3), CFG),
], ids=["star0", "chain0", "tree01", "tree20", "chain-bits", "star-bits",
        "name-ring", "name-tree", "name-chain", "name-star0", "name-tree0",
        "no-fuse", "multicast", "cycle", "dead-end", "orphan-relay",
        "measure-incoming", "unknown-node", "duplicate", "view-count"])
def test_errors_are_the_reference_errors(make):
    with pytest.raises(ValueError) as want:
        make(JT)
    with pytest.raises(ValueError) as got:
        make(TT)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# graph execution against the reference
# ---------------------------------------------------------------------------

def _route_bits(topo, cfg):
    """Per view: the link widths of its route's edges, first hop first."""
    out = []
    for name in topo.view_nodes():
        bits, cur = [], name
        while cur != topo.fuse_node:
            e = topo.out_edge(cur)
            bits.append(TT.edge_bits(e, cfg))
            cur = e.dst
        out.append(bits)
    return out


def _codes(x, bits):
    """Codewords of values on the `bits` grid, in float64 (exact)."""
    scale = ((1 << bits) - 1) / 8.0
    return np.round((np.clip(x.astype(np.float64), -4, 4) + 4) * scale)


# one fp32 ulp at |u| <= 4: the reference's CPU jit dequantizes by an FMA
# with the reciprocal, the port by a true division (ROADMAP queue 3)
ULP = 5e-7


def _hold(got, want, keep, grid_bits, what):
    """Values within one ulp and, per node, codewords identical on its
    grid, over the rows `keep` (J, B)."""
    for j, bits in enumerate(grid_bits):
        g, w = got[j][keep[j]], want[j][keep[j]]
        np.testing.assert_allclose(g, w, rtol=0, atol=ULP)
        if bits < 32:
            assert np.array_equal(_codes(g, bits), _codes(w, bits)), \
                f"{what}: node {j} codewords differ"


GRAPHS = {
    "chain5": (lambda T: T.chain(5), CFG8),
    "chain2-8-2": (lambda T: T.chain(2, link_bits=(8, 2)), CFG2),
    "tree22": (lambda T: T.tree(2, 2), CFG6_8),
}


@pytest.mark.parametrize("graph, wire", [
    ("chain5", "dense"), ("chain5", "packed"), ("chain5", "packed_duplex"),
    ("chain2-8-2", "dense"), ("chain2-8-2", "packed"),
    ("tree22", "dense"), ("tree22", "packed")])
def test_graph_cut_and_ship_matches_jax(graph, wire):
    """(u, rate, u_fused) and the gradients through every hop against the
    reference (its plain jnp backend)."""
    make, cfg = GRAPHS[graph]
    jt, tt = _both(make)
    J, d = cfg.num_clients, cfg.d_bottleneck
    mu, lv, eps = cut_inputs((J, B, d), seed=J)
    rng = np.random.default_rng(7)
    gu, gf, gr = (rng.normal(size=s).astype(np.float32)
                  for s in ((J, B, d), (J, B, d), (J, B)))

    def jloss(m, v):
        u, r, uf = JT.graph_cut_and_ship(jt, cfg, m, v, jnp.asarray(eps),
                                         wire=wire, backend="reference")
        return (jnp.sum(u * gu) + jnp.sum(uf * gf) + jnp.sum(r * gr),
                (u, r, uf))
    (_, (ju, jr, juf)), (jdm, jdv) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(mu), jnp.asarray(lv))
    m = torch.tensor(mu, requires_grad=True)
    v = torch.tensor(lv, requires_grad=True)
    u, r, uf = TT.graph_cut_and_ship(tt, cfg, m, v, torch.tensor(eps),
                                     wire=wire)
    (torch.sum(u * torch.tensor(gu)) + torch.sum(uf * torch.tensor(gf))
     + torch.sum(r * torch.tensor(gr))).backward()

    routes = _route_bits(tt, cfg)
    mid = np.stack([near_midpoint(mu[j], lv[j], eps[j], bits[0]).any(-1)
                    if bits[0] < 32 else np.zeros(B, bool)
                    for j, bits in enumerate(routes)])
    keep = ~mid
    assert mid.sum() <= 0.05 * mid.size, f"{int(mid.sum())} midpoint rows"
    _hold(u.detach().numpy(), np.asarray(ju), keep,
          [b[0] for b in routes], "u")
    _hold(uf.detach().numpy(), np.asarray(juf), keep,
          [min(b) for b in routes], "u_fused")
    np.testing.assert_allclose(r.detach().numpy()[keep], np.asarray(jr)[keep],
                               rtol=1e-5, atol=1e-4)
    for got, want in ((m.grad, jdm), (v.grad, jdv)):
        np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits, wire, dtype", [
    (2, "dense", None), (4, "dense", "bf16"), (8, "packed", None),
    (8, "packed_duplex", None), (3, "packed", None), (32, "dense", "bf16")])
def test_relay_hop_matches_jax(bits, wire, dtype):
    """One hop on 8-bit-grid values: the re-coding at `bits`, the storage
    dtype's round trip on a dense edge, the wire; and its VJP."""
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 255, size=(3, 4, 8))
    x = (idx / (255 / 8.0) - 4.0).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    tdt = None if dtype is None else {"bf16": torch.bfloat16}[dtype]
    jdt = None if dtype is None else jnp.bfloat16
    want, vjp = jax.vjp(lambda a: jwire.relay_hop(
        a, link_bits=bits, wire=wire, dtype=jdt, backend="reference"),
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = wirefmt.relay_hop(xt, link_bits=bits, wire=wire, dtype=tdt)
    (gx,) = torch.autograd.grad(got, xt, torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ULP)
    if bits < 32:
        assert np.array_equal(_codes(got.detach().numpy(), bits),
                              _codes(np.asarray(want), bits))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cfg", [CFG, CFG8], ids=["b32", "b8"])
def test_dense_homogeneous_chain_is_bitwise_the_star(cfg):
    """In the port alone: re-coding on one grid is the identity, so a dense
    chain(5) delivers the star's latents, rates and gradients bit for bit,
    and its loss; a packed chain is the dense chain bit for bit."""
    J, d = cfg.num_clients, cfg.d_bottleneck
    mu, lv, eps = (torch.tensor(a) for a in cut_inputs((J, B, d), seed=3))
    gf = torch.tensor(np.random.default_rng(3).normal(size=(J, B, d)),
                      dtype=torch.float32)
    wires = ("dense", "packed") if cfg.link_bits <= 16 else ("dense",)
    out = {}
    for name, topo, wire in [("star", TT.star(J), "dense")] + [
            ("chain " + w, TT.chain(J), w) for w in wires]:
        m, v = mu.clone().requires_grad_(), lv.clone().requires_grad_()
        u, r, uf = TT.graph_cut_and_ship(topo, cfg, m, v, eps, wire=wire)
        (torch.sum(uf * gf) + torch.sum(r)).backward()
        out[name] = [t.detach() for t in (u, r, uf, m.grad, v.grad)]
    for name in out:
        assert all(torch.equal(a, b) for a, b in zip(out[name],
                                                     out["star"])), name
    # the loss through inl.loss_fn: the chain's graph path against the
    # star's pre-topology path, the same draws
    params, state = inl.init(cfg, 0, device="cpu")
    views = torch.tensor(_views(cfg, B))
    labels = torch.tensor(_labels(B))
    masks = [torch.tensor(np.random.default_rng(i).random((B, n)) > 0.3)
             for i, n in enumerate(cfg.dense_units)]
    res = [value_and_grad(inl.loss_fn, params, state, views, labels, cfg,
                          eps=eps, drop_masks=masks, topology=topo)
           for topo in (None, TT.chain(J))]
    assert torch.equal(res[0][0], res[1][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(res[0][2]),
                                                  tree_leaves(res[1][2])))


# ---------------------------------------------------------------------------
# per-edge bandwidth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make, cfg, wires", [
    (lambda T: T.star(5), CFG8, ("dense", "packed", "packed_duplex")),
    (lambda T: T.chain(5), CFG8, ("dense", "packed", "packed_duplex")),
    (lambda T: T.chain(5, link_bits=HET), CFG, ("dense",)),
    (lambda T: T.tree(2, 2), CFG6_8, ("dense", "packed", "packed_duplex")),
    (lambda T: T.chain(2, link_bits=(2, 8)),
     dataclasses.replace(CFG2, d_bottleneck=16), ("packed_duplex",)),
    (lambda T: T.chain(5), dataclasses.replace(CFG, compute_dtype="bf16"),
     ("dense",))],
    ids=["star5", "chain5", "chain5-het", "tree22", "chain2-2-8",
         "chain5-bf16"])
def test_edge_ledgers_equal_the_reference(make, cfg, wires):
    jt, tt = _both(make)
    assert TT.round_edge_bits(tt, cfg, B) == JT.round_edge_bits(jt, cfg, B)
    assert TT.round_bits(tt, cfg, B) == JT.round_bits(jt, cfg, B)
    js, ts = jschemes.get("inl"), schemes.get("inl")
    assert ts.bits_per_round(cfg, None, B, topology=tt) == \
        js.bits_per_round(cfg, None, B, topology=jt)
    for wire in wires:
        assert TT.round_edge_wire_bytes(tt, cfg, B, wire=wire) == \
            JT.round_edge_wire_bytes(jt, cfg, B, wire=wire)
        assert TT.round_wire_bytes(tt, cfg, B, wire=wire) == \
            JT.round_wire_bytes(jt, cfg, B, wire=wire)
        assert ts.edge_ledger(cfg, None, B, wire=wire, topology=tt) == \
            js.edge_ledger(cfg, None, B, wire=wire, topology=jt)
        assert ts.wire_bytes_per_round(cfg, None, B, wire=wire,
                                       topology=tt) == \
            js.wire_bytes_per_round(cfg, None, B, wire=wire, topology=jt)


def test_mixed_chain_measured_bytes_equal_the_closed_forms():
    """chain(2, link_bits=(2, 8)) at d_bottleneck 16 on "packed_duplex":
    every edge's measured bytes are its closed form, both directions at the
    edge's width; chain(5, link_bits=(2, 4, 8, 8, 16)) likewise."""
    for topo, cfg in (
            (TT.chain(2, link_bits=(2, 8)),
             dataclasses.replace(CFG2, d_bottleneck=16)),
            (TT.chain(5, link_bits=(2, 4, 8, 8, 16)),
             dataclasses.replace(CFG, d_bottleneck=16))):
        closed = TT.round_edge_bits(topo, cfg, B)
        measured = TT.round_edge_wire_bytes(topo, cfg, B,
                                            wire="packed_duplex")
        assert list(closed) == [e.key for e in topo.edges]
        for e in topo.edges:
            assert closed[e.key] == 2 * B * len(topo.payload(e)) * 16 \
                * e.link_bits
            assert measured[e.key] * 8 == closed[e.key], e.key


# ---------------------------------------------------------------------------
# training, predict, the runner, serving
# ---------------------------------------------------------------------------

def _views(cfg, n):
    imgs, _ = multiview.make_base_dataset(128, image_shape=cfg.image_shape,
                                          seed=0)
    return multiview.make_views(imgs, cfg.noise_stds)[:, :n]


def _labels(n):
    return multiview.make_base_dataset(128, image_shape=CFG.image_shape,
                                       seed=0)[1][:n].astype(np.int64)


@pytest.mark.parametrize("topo, cfg, wire", [
    (lambda T: T.chain(5, link_bits=HET), CFG, "dense"),
    (lambda T: T.tree(2, 2), CFG6, "dense"),
    (lambda T: T.chain(5), CFG8, "packed_duplex")],
    ids=["chain5-het", "tree22", "chain5-duplex"])
def test_graph_rounds_match_jax(topo, cfg, wire):
    jt, tt = _both(topo)
    views, labels = _views(cfg, B)[None], _labels(B)[None]
    with jax.threefry_partitionable(False):
        st = jschemes.get("inl").init(cfg, jax.random.PRNGKey(0))
        init = (jax.tree.map(np.asarray, st["params"]),
                jax.tree.map(np.asarray, st["state"]))
        round_fn = jschemes.get("inl").make_round(cfg, wire=wire,
                                                  topology=jt)
        want, draws = [], []
        for i in range(ROUNDS):
            st, m = round_fn(st, jnp.asarray(views), jnp.asarray(labels),
                             jax.random.PRNGKey(i))
            want.append((float(m["loss"]), float(m["bits_sent"])))
            r_enc, r_dec = jax.random.split(jax.random.PRNGKey(i))
            eps = jax.random.normal(r_enc, (cfg.num_clients, B,
                                            cfg.d_bottleneck), jnp.float32)
            masks = jpm.decoder_dropout_masks(r_dec, cfg.dense_units, B)
            draws.append((torch.tensor(np.asarray(eps)),
                          [torch.tensor(np.asarray(k)) for k in masks]))
    params, state = convert.inl_from_jax(*init, cfg, device="cpu")
    tst = {"params": params, "state": state,
           "opt": optim.adam(2e-3).init(params)}
    round_t = schemes.get("inl").make_round(cfg, wire=wire, topology=tt)
    got = []
    for eps, masks in draws:
        tst, m = round_t(tst, torch.tensor(views), torch.tensor(labels),
                         None, eps=eps, drop_masks=masks)
        got.append((float(m["loss"]), float(m["bits_sent"])))
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    assert [g[1] for g in got] == [w[1] for w in want] == \
        [TT.round_bits(tt, cfg, B)] * ROUNDS


def _trained(cfg):
    """Converted reference weights (no training needed for predict)."""
    st = jschemes.get("inl").init(cfg, jax.random.PRNGKey(1))
    return convert.inl_from_jax(jax.tree.map(np.asarray, st["params"]),
                                jax.tree.map(np.asarray, st["state"]), cfg,
                                device="cpu"), st


@pytest.mark.parametrize("bits", [2, 8, 32])
def test_graph_predict_matches_jax(bits):
    """predict through chain(5) delivers the quantized multi-hop latents:
    equal to the reference's within float tolerance; the packed wire's
    answers equal the dense wire's bit for bit; at 32 bits equal to the
    star's."""
    cfg = dataclasses.replace(CFG, link_bits=bits)
    (params, state), jst = _trained(cfg)
    views = _views(cfg, B)
    want = np.asarray(jax.jit(lambda p, st, v: jinl.predict(
        p, st, v, cfg=cfg, topology=JT.chain(5)))(
            jst["params"], jst["state"], jnp.asarray(views)))
    got = inl.predict(params, state, views, cfg=cfg, topology=TT.chain(5),
                      device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if bits <= 16:
        packed = inl.predict(params, state, views, cfg=cfg, wire="packed",
                             topology=TT.chain(5), device="cpu")
        assert torch.equal(packed, got)
    else:
        assert torch.equal(got, inl.predict(params, state, views,
                                            device="cpu"))


def test_runner_meters_a_chain_per_edge_as_the_reference():
    cfg = CFG8
    imgs, labels = multiview.make_base_dataset(64, image_shape=cfg.image_shape,
                                               seed=0)
    views = multiview.make_views(imgs, cfg.noise_stds)
    meter = tbw.BandwidthMeter()
    curve = runner.run_scheme("inl", views, labels, cfg, epochs=1,
                              batch_size=B, eval_n=32, wire="packed",
                              topology=TT.chain(5), meter=meter, device="cpu")
    jmeter = jrunner.bandwidth.BandwidthMeter()
    jcurve = jrunner.run_scheme("inl", views, labels, cfg, epochs=1,
                                batch_size=B, eval_n=32, wire="packed",
                                topology=JT.chain(5), meter=jmeter)
    assert meter.edge_bits == jmeter.edge_bits
    assert meter.edge_measured_bytes == jmeter.edge_measured_bytes
    assert set(meter.edge_bits) == {e.key for e in TT.chain(5).edges}
    assert sum(meter.edge_bits.values()) == meter.total_bits
    assert sum(meter.edge_measured_bytes.values()) == meter.measured_bytes
    assert [(p.gbits, p.measured_gbits) for p in curve] == \
        [(p.gbits, p.measured_gbits) for p in jcurve]
    assert np.isfinite(curve[-1].accuracy)


def test_served_chain_rows_equal_predict():
    """The engine serves chain(5) on the packed wire through the scheme's
    graph predict, one call per bucket: each answer equals predict on the
    same padded bucket bit for bit; the meter charges every edge."""
    cfg = CFG8
    (params, state), _ = _trained(cfg)
    scheme = schemes.get("inl")
    st = {"params": params, "state": state}
    views = _views(cfg, 24).astype(np.float32)
    engine = ServingEngine(scheme, st, cfg, topology=TT.chain(5),
                           wire="packed", device="cpu")
    with engine:
        probs, results = engine.serve(views[:, :13])
    assert {r.bucket for r in results} == {16}
    padded, _ = batching.pad_to_bucket(views[:, :13], np.arange(13), 16)
    want = inl.predict(params, state, padded, cfg=cfg, wire="packed",
                       topology=TT.chain(5), device="cpu")[:13]
    assert np.array_equal(probs, want.numpy())
    assert set(engine.meter.edge_bits) == {e.key for e in TT.chain(5).edges}
    assert engine.meter.delivery_ratio == 1.0


@pytest.mark.parametrize("name", ["fl", "sl"])
def test_star_only_schemes_refuse_graphs_as_the_reference(name):
    for topo_j, topo_t in ((JT.chain(5), TT.chain(5)),
                           (JT.star(5, link_bits=4), TT.star(5,
                                                             link_bits=4))):
        with pytest.raises(ValueError) as want:
            jschemes.get(name).make_round(CFG, topology=topo_j)
        with pytest.raises(ValueError) as got:
            schemes.get(name).make_round(CFG, topology=topo_t)
        assert str(got.value) == str(want.value)
        assert "star topology only" in str(got.value)


def test_heterogeneous_loss_matches_jax():
    """Per-node encoder architectures: the reference's init_heterogeneous
    converted, its draws fed in; the loss and every gradient leaf."""
    cfgs = [dataclasses.replace(CFG, conv_channels=c)
            for c in ((4,), (4, 6), (3,), (5,), (4, 4))]
    jp, js = jinl.init_heterogeneous(cfgs, jax.random.PRNGKey(2))
    views = _views(CFG, B)
    labels = _labels(B)
    rng = jax.random.PRNGKey(5)

    def jloss(p):
        return jinl.loss_fn_heterogeneous(p, js, jnp.asarray(views),
                                          jnp.asarray(labels), rng, CFG)
    (want, (jm, _)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    _, r_cut, r_dec = jax.random.split(rng, 3)
    eps = torch.tensor(np.asarray(jax.random.normal(
        r_cut, (5, B, CFG.d_bottleneck), jnp.float32)))
    masks = [torch.tensor(np.asarray(k)) for k in
             jpm.decoder_dropout_masks(r_dec, CFG.dense_units, B)]
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params, state = convert.inl_heterogeneous_from_jax(
        to_np(jp), to_np(js), cfgs, device="cpu")
    got, (metrics, new_state), grads = value_and_grad(
        inl.loss_fn_heterogeneous, params, state, torch.tensor(views),
        torch.tensor(labels), CFG, eps=eps, drop_masks=masks)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["rate_mean"].detach()),
                               float(jm["rate_mean"]), rtol=1e-5)
    jg, _ = convert.inl_heterogeneous_from_jax(
        to_np(jgrads), to_np(js), cfgs, device="cpu")
    for a, b in zip(tree_leaves(grads), tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    # the port's own init: the converted trees' structure and shapes
    own, own_state = inl.init_heterogeneous(cfgs, 0, device="cpu")
    assert [t.shape for t in tree_leaves((own, own_state))] == \
        [t.shape for t in tree_leaves((params, state))]
    assert len(new_state["encoders"]) == 5


def test_graph_paths_of_later_items_raise():
    mu, lv, eps = (torch.tensor(a) for a in cut_inputs((5, B, 8), seed=0))
    for kw in ({"axis_name": "client"}, {"group_ids": torch.zeros(5)}):
        with pytest.raises(NotImplementedError, match="item 9"):
            TT.graph_cut_and_ship(TT.chain(5), CFG, mu, lv, eps, **kw)
    # link models (item 8, ported) only produce delivery masks: the graph
    # runs its hops as it would without them, bit for bit
    chain = TT.chain(5)
    lossy = linkfault.with_links(chain, {chain.edges[-1].key:
                                         linkfault.LinkModel(erasure=0.3)})
    for got, want in zip(TT.graph_cut_and_ship(lossy, CFG, mu, lv, eps),
                         TT.graph_cut_and_ship(chain, CFG, mu, lv, eps)):
        assert torch.equal(got, want)
