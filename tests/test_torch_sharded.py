"""The port's sharded scheme rounds (repro_torch/core/sharded.py,
launch/mesh.py, launch/sharding.py, `run_scheme(mesh=)`) on the CPU.

Two worlds of two ranks, each spawned once (`_torch_common.SpawnedRanks`:
gloo over a FileStore in the test's temporary directory, one intra-op
thread a rank), run every case of their mesh (tests/_torch_ranks.py):

  * (client=1, data=2) on tests/_schemes_common.CFG (J=5, so the client
    axis falls back to replicated, as the reference's host mesh does): six
    rounds of INL, FL and SL from the reference's init and draws (round
    i's split chain, as tests/test_torch_train.py and test_torch_sl_fl.py
    feed them) against the JAX single-device rounds, losses at rtol 1e-4
    and the final accuracy equal (the reference's bar,
    tests/test_sharded_parity.py);
  * (client=2, data=1) on CFG with J=2: INL, FL and INL with learned
    priors, the same bar;
  * on both meshes: the packed wire equal to the dense wire bit for bit
    (losses and the gathered state), INL/FL/SL over links at erasure 0.3
    against the single-device port at rtol 1e-4, the differentiable
    collectives' gradients equal to the reference's transposes
    (all_gather -> the summing reduce-scatter, psum -> psum, pmean ->
    pmean) to float rounding;
  * the client mesh: the fan-in's bytes per round equal to the wire
    closed forms (the packed_duplex reduce-scatter stays dense), and a
    chain(4) of three first-hop widths (each rank cuts its nodes at their
    widths through its group_ids) against the single-device port;
  * the data mesh: the wire and the graph on the one-rank client axis
    equal to no axis bit for bit; run_scheme(mesh=)'s curve against
    dispatch="per_round" (accuracy at rtol 1e-4, gbits at 1e-6); a mesh
    run resumed from its checkpoint equal to the uninterrupted one bit for
    bit; a mesh checkpoint resumed without the mesh and the other way
    round.

A float64 copy of the port (tests/_torch_f64_witness.py, two more worlds
of two ranks in a subprocess): three sharded rounds of each scheme equal
the single-device rounds to 1e-12, so the float32 differences are
rounding.

In this process: `_client_axis_size` against the reference's over a grid,
its warning, and `check_mesh` / `_check_batch`'s errors word for word.  In
a subprocess with two forced host devices
(XLA_FLAGS=--xla_force_host_platform_device_count=2), the reference's own
`make_inl_sharded_round` on (client=2): its six rounds against the port's
sharded rounds on the same init and PRNGKey(i) draws (tier-1 runs the
reference's sharded rounds nowhere else: tests/test_sharded_parity.py
needs two devices).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import _torch_ranks  # noqa: E402
from _schemes_common import (BATCH, CFG, ROUNDS, fixture_data,  # noqa: E402
                             round_inputs)
from _torch_common import SpawnedRanks  # noqa: E402

from repro.core import paper_model as jpm  # noqa: E402
from repro.core import schemes as jschemes  # noqa: E402
from repro.core import sharded as jsharded  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch import convert, optim, tree_stack  # noqa: E402
from repro_torch.core import fl, sharded, wirefmt  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

CFG_J2 = dataclasses.replace(CFG, num_clients=2, noise_stds=(0.4, 2.0))
LR = 2e-3
RTOL = 1e-4
WORLD_TIMEOUT = 240.0
# a state entry's bar a round: an Adam step moves an entry by up to about
# lr, so entries whose gradient is rounding noise (the conv biases under
# BatchNorm, and the running means that carry them; ROADMAP queue 3) can
# part by that much a round, as tests/test_torch_train.py allows
STATE_ATOL = LR


# ---------------------------------------------------------------------------
# the reference's side: init, draws and trajectories
# ---------------------------------------------------------------------------

def _cfg(key, base_cfg):
    return dataclasses.replace(base_cfg, learned_prior=True) \
        if key.endswith("+learned_prior") else base_cfg


def _draws(name, cfg, i):
    """Round i's draws as the reference's round makes them, as numpy."""
    key = jax.random.PRNGKey(i)
    if name == "inl":
        r_enc, r_dec = jax.random.split(key)
        eps = jax.random.normal(r_enc, (cfg.num_clients, BATCH,
                                        cfg.d_bottleneck), jnp.float32)
        return (np.array(eps), [np.array(m) for m in
                                jpm.decoder_dropout_masks(
                                    r_dec, cfg.dense_units, BATCH)])
    if name == "sl":
        return [np.array(m) for m in jpm.decoder_dropout_masks(
            key, cfg.dense_units, BATCH)]
    out = []
    for r in jax.random.split(key, cfg.num_clients):
        steps = []
        for _ in range(2):
            r, sub = jax.random.split(r)
            steps.append([np.array(m) for m in jpm.decoder_dropout_masks(
                sub, cfg.dense_units, BATCH)])
        out.append(steps)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(name, cfg):
    """The reference scheme's init at PRNGKey(0), shared by the ranks'
    inputs and the trajectory.  INL's is jitted (its eager init compiles
    one random op at a time, ~2x slower here); the others' eager inits are
    the quicker."""
    init = jschemes.get(name).init
    if name == "inl":
        init = jax.jit(init, static_argnums=0)
    return init(cfg, jax.random.PRNGKey(0))


def _port_state(name, cfg, jst):
    """The reference's init as the port's scheme state."""
    jst = jax.tree.map(np.asarray, jst)
    if name == "inl":
        params, state = convert.inl_from_jax(jst["params"], jst["state"], cfg,
                                             device="cpu")
        return {"params": params, "state": state,
                "opt": optim.adam(LR).init(params)}
    if name == "sl":
        client, server, state = convert.sl_from_jax(
            jst["client"], jst["server"], jst["state"], cfg, device="cpu")
        return {"client": client, "server": server, "state": state,
                "opt_c": optim.adam(LR).init(client),
                "opt_s": optim.adam(LR).init(server)}
    params, state = convert.fl_from_jax(jst["params"], jst["state"], cfg,
                                        device="cpu")
    return {"params": params, "state": state,
            "opt": tree_stack([optim.adam(LR).init(fl.replica(params, j))
                               for j in range(cfg.num_clients)])}


def _world_inputs(keys, base_cfg, tmp):
    """What a world's ranks need: for each case its config, the
    reference's init as the port's state, the fixed batch and the six
    rounds' draws; the evaluation batch; a checkpoint directory."""
    views, labels = fixture_data()
    views = views[:base_cfg.num_clients]
    ref = {}
    for key in keys:
        name, cfg = key.split("+")[0], _cfg(key, base_cfg)
        scheme = jschemes.get(name)
        v, lab = round_inputs(scheme, cfg, views, labels)
        ref[key] = {
            "cfg": cfg,
            "state": _torch_ranks.to_numpy(_port_state(
                name, cfg, _jax_init(name, cfg))),
            "v": np.array(v), "lab": np.array(lab).astype(np.int64),
            "draws": [_draws(name, cfg, i) for i in range(ROUNDS)]}
    return {"cfg": base_cfg, "reference": ref,
            "eval": (np.array(views[:, :BATCH]),
                     np.array(labels[:BATCH]).astype(np.int64)),
            "ckpt_root": str(tmp)}


@functools.lru_cache(maxsize=None)
def _jax_trajectory(key, base_cfg):
    """The reference's single-device rounds on the fixed batch: (losses,
    final accuracy)."""
    name, cfg = key.split("+")[0], _cfg(key, base_cfg)
    views, labels = fixture_data()
    views = views[:cfg.num_clients]
    scheme = jschemes.get(name)
    state = _jax_init(name, cfg)
    round_fn = scheme.make_round(cfg)
    v, lab = round_inputs(scheme, cfg, views, labels)
    losses = []
    for i in range(ROUNDS):
        state, m = round_fn(state, v, lab, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    probs = scheme.predict(state, views[:, :BATCH])
    acc = float((jnp.argmax(probs, -1) == labels[:BATCH]).mean())
    return losses, acc


@pytest.fixture(scope="module")
def data_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data_world")
    ranks = SpawnedRanks(_torch_ranks.data_world, 2, tmp,
                         _world_inputs(("inl", "fl", "sl"), CFG, tmp),
                         timeout=WORLD_TIMEOUT)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def client_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("client_world")
    ranks = SpawnedRanks(_torch_ranks.client_world, 2, tmp,
                         _world_inputs(("inl", "fl", "inl+learned_prior"),
                                       CFG_J2, tmp),
                         timeout=WORLD_TIMEOUT)
    yield ranks
    ranks.close()


# the reference's sharded INL rounds on (client=2) of two forced host
# devices: its losses as JSON on the last line
_JAX_SHARDED = """
import dataclasses, json, jax
from _schemes_common import CFG, ROUNDS, fixture_data, round_inputs
from repro.core import schemes
from repro.launch import mesh as mesh_lib
cfg = dataclasses.replace(CFG, num_clients=2, noise_stds=(0.4, 2.0))
mesh = mesh_lib.make_inl_host_mesh(2)
views, labels = fixture_data()
scheme = schemes.get("inl")
state = scheme.init(cfg, jax.random.PRNGKey(0))
state = jax.device_put(state, scheme.state_shardings(cfg, state, mesh))
round_fn = scheme.make_sharded_round(cfg, mesh)
v, lab = round_inputs(scheme, cfg, views[:2], labels)
losses = []
for i in range(ROUNDS):
    state, m = round_fn(state, v, lab, jax.random.PRNGKey(i))
    losses.append(float(m["loss"]))
print(json.dumps({"shape": dict(mesh.shape), "losses": losses}))
"""


@pytest.fixture(scope="module")
def jax_sharded_run():
    """The reference's sharded rounds in a subprocess, started with the
    module's first test."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           str(root / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SHARDED], env=env,
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)


@pytest.fixture(scope="module", autouse=True)
def _start_worlds(jax_sharded_run, data_world, client_world):
    """Both worlds and the reference's sharded run start with the module's
    first test; the reference's trajectories are computed in this process
    while they run."""


def _worlds(request, which):
    return request.getfixturevalue(f"{which}_world")


# ---------------------------------------------------------------------------
# the reference's rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which, key", [
    ("data", "inl"), ("data", "fl"), ("data", "sl"),
    ("client", "inl"), ("client", "fl"), ("client", "inl+learned_prior")])
def test_sharded_rounds_match_jax(request, which, key):
    """(client=1, data=2) on J=5 and (client=2, data=1) on J=2: six rounds
    from the reference's init and draws against its single-device
    rounds."""
    want_losses, want_acc = _jax_trajectory(
        key, CFG if which == "data" else CFG_J2)
    results = _worlds(request, which).results()
    shape = {"data": {"client": 1, "data": 2},
             "client": {"client": 2, "data": 1}}[which]
    for rank, res in enumerate(results):
        assert res["shape"] == shape
        np.testing.assert_allclose(res[key]["losses"], want_losses,
                                   rtol=RTOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(res[key]["accuracy"], want_acc,
                                   rtol=RTOL, atol=1e-6)
    # every rank reports the same global metrics
    assert results[0][key] == results[1][key]


# ---------------------------------------------------------------------------
# wires, faults and graphs on the mesh
# ---------------------------------------------------------------------------

def _same_tree(a, b) -> bool:
    la, lb = (jax.tree_util.tree_leaves(t) for t in (a, b))
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


def _close_trees(a, b, rtol, atol):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["data", "client"])
def test_packed_equals_dense_on_mesh(request, which):
    """link_bits=8: the packed fan-in (codeword lanes gathered) trains as
    the dense one bit for bit; both, and packed_duplex, track the
    single-device port."""
    for res in _worlds(request, which).results():
        wires = res["wires"]
        (ld, _, sd, _), (lp, _, sp, _) = wires["dense"], wires["packed"]
        assert ld == lp and _same_tree(sd, sp)
        for wire, (lm, l1, sm, s1) in wires.items():
            np.testing.assert_allclose(lm, l1, rtol=RTOL, err_msg=wire)
            assert np.all(np.isfinite(lm))


@pytest.mark.parametrize("which, name", [
    ("data", "inl"), ("data", "fl"), ("data", "sl"),
    ("client", "inl"), ("client", "fl")])
def test_lossy_rounds_on_mesh(request, which, name):
    """Erasure 0.3 on every edge, the runner's round keys: the mesh's
    rounds (the fuse-what-arrived mask, the masked FedAvg, SL's skipped
    rounds) against the single-device port's, losses at rtol 1e-4 and the
    final state within STATE_ATOL (FL's data-replicated rounds bit for
    bit)."""
    for res in _worlds(request, which).results():
        lm, l1, sm, s1 = res["lossy"][name]
        np.testing.assert_allclose(lm, l1, rtol=RTOL)
        if name == "fl" and which == "data":
            assert lm == l1 and _same_tree(sm, s1)
        else:
            _close_trees(sm, s1, rtol=0, atol=STATE_ATOL * len(lm))


def test_chain_with_group_ids_on_client_mesh(client_world):
    """chain(4, link_bits=(2, 4, 8, 32)) on (client=2): each rank cuts its
    two nodes at their own first-hop widths (two launches), the gather
    brings every node's latent to every rank, the hops run replicated;
    losses against the single-device port at rtol 1e-4."""
    for res in client_world.results():
        lm, l1, sm, s1 = res["chain"]["dense"]
        np.testing.assert_allclose(lm, l1, rtol=RTOL)
        _close_trees(sm, s1, rtol=0, atol=STATE_ATOL * len(lm))


def test_fan_in_bytes_equal_closed_forms(client_world):
    """One round at link_bits=8 on (client=2): the bytes of the client
    axis' gather (forward) and reduce-scatter (backward), summed over the
    ranks, equal wirefmt.round_wire_bytes for dense and packed; duplex
    gathers the packed lanes and reduce-scatters the dense cotangent
    (its charged backward is the packed chunk)."""
    cfg = dataclasses.replace(CFG_J2, link_bits=8)
    n, d = cfg.num_clients * 8, cfg.d_bottleneck
    results = client_world.results()
    total = {wire: {k: sum(r["bytes"][wire][k] for r in results)
                    for k in ("all_gather", "reduce_scatter")}
             for wire in ("dense", "packed", "packed_duplex")}
    for wire in ("dense", "packed"):
        want = wirefmt.round_wire_bytes(n, d, link_bits=8, wire=wire)
        assert total[wire] == {"all_gather": want["fwd"],
                               "reduce_scatter": want["bwd"]}
    duplex = wirefmt.round_wire_bytes(n, d, link_bits=8,
                                      wire="packed_duplex")
    dense = wirefmt.round_wire_bytes(n, d, link_bits=8, wire="dense")
    assert total["packed_duplex"] == {"all_gather": duplex["fwd"],
                                      "reduce_scatter": dense["bwd"]}
    assert duplex["bwd"] == duplex["fwd"] < dense["bwd"]


@pytest.mark.parametrize("which, op", [
    (w, op) for w in ("data", "client")
    for op in ("all_gather", "psum", "pmean")])
def test_collective_backward_is_the_reference_transpose(request, which, op):
    """x (3, 4) on each rank, y = op(x), loss_r = sum(c_r * y): the
    forward is the gather / sum / mean, and x_r's gradient the reference's
    transpose: the summed cotangents' block r (psum_scatter), their sum
    (psum), their mean (pmean)."""
    results = _worlds(request, which).results()
    xs = [r["collectives"][op][0] for r in results]
    cs = [r["collectives"][op][1] for r in results]
    for rank, res in enumerate(results):
        _, _, y, grad = res["collectives"][op]
        if op == "all_gather":
            want_y = np.concatenate(xs)
            want_g = sum(cs)[3 * rank:3 * (rank + 1)]
        elif op == "psum":
            want_y, want_g = sum(xs), sum(cs)
        else:
            want_y, want_g = sum(xs) / 2, sum(cs) / 2
        np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(grad, want_g, rtol=1e-6, atol=1e-7)


def test_axis_of_one_rank_is_bit_for_bit(data_world):
    """The one-rank client axis of the data mesh: cut_and_ship and ship on
    the three wires, and graph_cut_and_ship on chain(3) of three widths,
    equal to no axis bit for bit (outputs and the input's gradient)."""
    for res in data_world.results():
        assert res["axis_of_one"] and all(res["axis_of_one"].values()), \
            res["axis_of_one"]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_run_scheme_on_mesh_matches_per_round(data_world):
    """run_scheme("inl", mesh=) for two epochs: every rank's curve the
    same, against the single-device dispatch="per_round" curve: accuracy
    at rtol 1e-4, gbits and measured gbits at 1e-6."""
    results = data_world.results()
    for res in results:
        mesh_curve = np.array(res["runner"]["mesh"])
        ref_curve = np.array(res["runner"]["per_round"])
        assert mesh_curve.shape == ref_curve.shape == (2, 5)
        np.testing.assert_allclose(mesh_curve[:, 1], ref_curve[:, 1],
                                   rtol=RTOL)
        np.testing.assert_allclose(mesh_curve[:, 2:], ref_curve[:, 2:],
                                   rtol=1e-6)
    assert results[0]["runner"]["mesh"] == results[1]["runner"]["mesh"]


def test_mesh_resume_is_bit_for_bit(data_world):
    """Two epochs on the mesh against one epoch, then a resume on the
    mesh: the same curve and the same final checkpoint, bit for bit.  A
    checkpoint written on the mesh resumes without one, and one written
    without a mesh resumes on it: each keeps the first epoch's point and
    trains the second."""
    results = data_world.results()
    for rank, res in enumerate(results):
        r = res["runner"]
        assert r["resumed"] == r["full"] and r["same_checkpoint"]
        assert len(r["on_mesh"]) == 2 and np.isfinite(r["on_mesh"][1][1])
        if rank == 0:
            assert r["off_mesh"][0] == r["full"][0]
            assert len(r["off_mesh"]) == 2
    assert results[0]["runner"]["on_mesh"] == results[1]["runner"]["on_mesh"]


def test_reference_sharded_rounds_match_port_mesh(jax_sharded_run,
                                                  client_world):
    """The reference's make_inl_sharded_round (shard_map over two forced
    host devices, (client=2, data=1), J=2) and the port's sharded rounds
    on the same init and draws: six losses at rtol 1e-4."""
    try:
        out, err = jax_sharded_run.communicate(timeout=WORLD_TIMEOUT)
    except subprocess.TimeoutExpired:
        jax_sharded_run.kill()
        raise
    assert jax_sharded_run.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert ref["shape"] == {"client": 2, "data": 1}
    for res in client_world.results():
        np.testing.assert_allclose(res["inl"]["losses"], ref["losses"],
                                   rtol=RTOL)


@pytest.fixture(scope="module")
def float64_witness(tmp_path_factory):
    """tests/_torch_f64_witness.py in a subprocess, on a float64 copy of
    the port: {world: {case: (deviation, path)}}."""
    import _torch_f64_witness
    root = pathlib.Path(__file__).resolve().parents[1]
    tmp = tmp_path_factory.mktemp("float64")
    pkg = _torch_f64_witness.float64_copy(str(root / "src" / "repro_torch"),
                                          str(tmp / "src"))
    out = tmp / "witness.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [pkg, str(root / "tests")]))
    subprocess.run([sys.executable, str(root / "tests"
                                        / "_torch_f64_witness.py"),
                    str(out)], env=env, cwd=root, check=True,
                   timeout=WORLD_TIMEOUT)
    return json.loads(out.read_text())


@pytest.mark.parametrize("which, key", [
    ("data", "inl"), ("data", "sl"), ("data", "fl"),
    ("client", "inl"), ("client", "inl+learned_prior"), ("client", "fl")])
def test_sharded_round_is_the_single_device_round_in_float64(
        float64_witness, which, key):
    """The sharded rounds differ from the single-device rounds by rounding
    alone: on a float64 copy of the port, three rounds on (client=1,
    data=2) and (client=2, data=1), each from the single-device round's
    state, equal the single-device rounds to 1e-12 on every leaf (the conv
    biases and running means apart, whose exact gradient is zero).  A
    missing mean over 'data' parts INL's by 2.7."""
    res = float64_witness[which]
    assert res["dtype"] == "torch.float64"
    assert res["shape"] == {"data": {"client": 1, "data": 2},
                            "client": {"client": 2, "data": 1}}[which]
    dev, path = res[key]
    assert dev < 1e-12, (dev, path)


# ---------------------------------------------------------------------------
# the mesh helpers (in this process)
# ---------------------------------------------------------------------------

def test_client_axis_size_matches_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for J in range(1, 13):
            for slots in range(1, 17):
                assert tmesh._client_axis_size(J, slots) == \
                    jmesh._client_axis_size(J, slots), (J, slots)


def test_client_axis_fallback_warns_as_reference():
    with pytest.warns(UserWarning) as got:
        assert tmesh._client_axis_size(5, 2) == 1
    with pytest.warns(UserWarning) as want:
        jmesh._client_axis_size(5, 2)
    assert str(got[0].message) == str(want[0].message)
    assert "replicated client axis (client=1)" in str(got[0].message)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _message(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


@pytest.mark.parametrize("shape, J", [
    ({"data": 2}, 5), ({"client": 2}, 4), ({"client": 2, "data": 1}, 5),
    ({"client": 4, "data": 2}, 6)])
def test_check_mesh_errors_word_for_word(shape, J):
    mesh = _FakeMesh(shape)
    assert _message(sharded.check_mesh, mesh, J) == \
        _message(jsharded.check_mesh, mesh, J)
    assert sharded.axis_size(mesh, "data") == jsharded.axis_size(mesh,
                                                                 "data")


def test_check_batch_error_word_for_word():
    assert _message(sharded._check_batch, 7, 2) == \
        _message(jsharded._check_batch, 7, 2)
    sharded._check_batch(8, 2)


def test_mesh_needs_a_process_group_and_schemes_refuse():
    """Without an initialised process group the meshes say what to do;
    SplitFed and the hybrid have no sharded round, as in the reference."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_inl_host_mesh(5, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_host_mesh(device="cpu")
    from repro_torch.core import schemes
    for name in ("splitfed", "hybrid"):
        with pytest.raises(NotImplementedError, match="no sharded round"):
            schemes.get(name).make_sharded_round(CFG, _FakeMesh(
                {"client": 1, "data": 1}))
    # SL's client and server are replicated on every rank
    assert schemes.get("sl").state_shardings(
        CFG, {"client": [torch.zeros(2)], "step": torch.zeros(())},
        None) == {"client": [None], "step": None}
