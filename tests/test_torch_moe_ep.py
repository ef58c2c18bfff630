"""The expert-parallel MoE (`moe.moe_apply_ep(mesh=)`) on gloo meshes of
2 and 4 spawned ranks ((data, model) = (1, 2) and (2, 2)), fp32, the smoke
DeepSeek-V2 (shared experts) and Arctic MoE layers.

  * Against the reference's `moe_apply_ep` (shard_map over a forced
    4-device CPU mesh, run in a subprocess with
    XLA_FLAGS=--xla_force_host_platform_device_count=4) on the same
    weights, with a router tilted so that the local capacity drops
    tokens: y on every rank, the aux values (averaged over the batch
    shards), and the gradients of x and of every parameter through the
    psum (sum semantics: each rank's cotangent its share, the gradient of
    a leaf the sum over the ranks holding it) against the reference's
    VJP.
  * Droppless (a capacity of every token), EP equals the port's
    single-process `moe_apply`: y, z_loss and expert_load on both meshes,
    lb_loss on the (1, 2) mesh (on two batch shards the reference, too,
    averages the shards' lb values, not the global one).
  * Inside the model: the smoke DeepSeek-V2 grown to two MoE blocks
    (moe_impl "ep", remat on, so the psum reruns in the periods'
    recompute), droppless, through `zoo.loss_and_metrics(mesh=)` on the
    (1, 2) mesh equals the single-process `loss_and_metrics`: the loss and
    metrics (the aux values summed over the blocks) on each rank, and the
    gradient of every parameter.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_moe_ranks  # noqa: E402
from _torch_common import SpawnedRanks  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import moe, zoo  # noqa: E402

ARCHS = ("deepseek-v2-236b", "arctic-480b")
MESHES = ((1, 2), (2, 2))
B, S = 4, 8
TILT = 3.0             # expert 0's logit raised by ~TILT: it overflows
TOL = dict(rtol=2e-5, atol=2e-6)
MODEL_MESH, MODEL_SEED, MODEL_BATCH = (1, 2), 11, (2, 16)
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the xdist workers share the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, droppless):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if droppless:       # C = T k / E * E / k = T slots: nothing dropped
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.experts_per_token))
    return cfg


def _case(arch, mesh_shape, droppless, seed):
    """Weights of the reference's `moe_init` layout (its shapes from
    `jax.eval_shape`), N(0, 1/fan_in) from numpy, and x, the cotangents."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype="float32")
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: j_moe.moe_init(k, jcfg, jnp.float32),
                            jax.random.PRNGKey(0))
    p = jax.tree.map(lambda t: (rng.normal(size=t.shape)
                                / np.sqrt(t.shape[-2])).astype(np.float32),
                     shapes)
    d = jcfg.d_model
    # x has a mean of 1 in every feature, so a column raised by TILT / d
    # raises that expert's logit by ~TILT for every token
    x = (rng.normal(size=(B, S, d)) + 1.0).astype(np.float32)
    if not droppless:
        p["router"] = {"w": p["router"]["w"].copy()}
        p["router"]["w"][:, 0] += TILT / d
    return {"cfg": _cfg(arch, droppless), "mesh": mesh_shape, "params": p,
            "x": x,
            "ct_y": rng.normal(size=(B, S, d)).astype(np.float32),
            "c_lb": 0.7, "c_z": -0.3, "arch": arch, "droppless": droppless}


@pytest.fixture(scope="module")
def cases():
    return {(arch, mesh, dl): _case(arch, mesh, dl, 3 + i)
            for i, (arch, mesh, dl) in enumerate(
                (a, m, dl) for a in ARCHS for m in MESHES
                for dl in (False, True))}


def _model_case():
    """(cfg, seed, batch): the smoke DeepSeek-V2 with one dense block and
    two MoE blocks in two remat periods, fp32, droppless; a batch of ids
    from numpy."""
    cfg = _cfg("deepseek-v2-236b", True)
    cfg = dataclasses.replace(cfg, num_layers=cfg.moe.first_dense_layers + 2)
    assert cfg.moe_impl == "ep" and cfg.remat and cfg.scan_layers
    rng = np.random.default_rng(MODEL_SEED)
    ids = rng.integers(0, cfg.vocab_size, size=(MODEL_BATCH[0],
                                                MODEL_BATCH[1] + 1))
    batch = {"tokens": ids[:, :-1].astype(np.int64),
             "labels": ids[:, 1:].astype(np.int64)}
    return cfg, MODEL_SEED, batch


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """(the reference's EP on each drop case, from a 4-device subprocess;
    the ranks' results of every case): the subprocess starts first, then
    each mesh's world is spawned once, and they run side by side."""
    tmp = tmp_path_factory.mktemp("jax_ep")
    keys = [k for k in cases if not k[2]]
    inp, out = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump([dict(cases[k], cfg=dataclasses.replace(
            j_get_smoke(k[0]), dtype="float32")) for k in keys], f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    jax_run = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_moe_ep.py"), inp, out],
        env=env)
    worlds = {}
    try:
        for mesh_shape in MESHES:
            mkeys = [k for k in cases if k[1] == mesh_shape]
            worlds[mesh_shape] = (mkeys, SpawnedRanks(
                _torch_moe_ranks.ep_world, mesh_shape[0] * mesh_shape[1],
                tmp_path_factory.mktemp(f"ep{mesh_shape}"), mesh_shape,
                [cases[k] for k in mkeys],
                _model_case() if mesh_shape == MODEL_MESH else None,
                timeout=240))
        assert jax_run.wait(timeout=300) == 0, "the reference's EP failed"
        with open(out, "rb") as f:
            reference = dict(zip(keys, pickle.load(f)))
        ranks = {}
        for mesh_shape, (mkeys, world) in worlds.items():
            per_rank = world.results()
            for i, k in enumerate(mkeys):
                ranks[k] = [r[0][i] for r in per_rank]
            if mesh_shape == MODEL_MESH:
                ranks["model"] = [r[1] for r in per_rank]
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
        for _, world in worlds.values():
            world.close()
    return reference, ranks


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


def _assembled(per_rank, mesh_shape, full_shape):
    """(y, dx, {leaf: gradient}) over the whole batch and all experts from
    the ranks' pieces: y from the model-0 rank of each data block, dx and
    the replicated leaves' gradients summed over their holders, the expert
    blocks' summed over 'data' and laid end to end."""
    data, model = mesh_shape
    nb = full_shape[0] // data
    y = np.zeros(full_shape, np.float32)
    dx = np.zeros(full_shape, np.float32)
    grads = {}
    for r in per_rank:
        di, mi = r["coords"]
        sl = slice(di * nb, (di + 1) * nb)
        if mi == 0:
            y[sl] = r["y"]
        dx[sl] += r["dx"]
        for k, g in _flat(r["dparams"]).items():
            if k.split("/")[0] in _torch_moe_ranks.EXPERT_LEAVES:
                e = g.shape[0]
                full = grads.setdefault(k, np.zeros(
                    (e * model,) + g.shape[1:], np.float32))
                full[mi * e:(mi + 1) * e] += g
            else:
                grads[k] = grads.get(k, 0) + g
    return y, dx, grads


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_equals_the_reference(arch, mesh_shape, cases, runs):
    key = (arch, mesh_shape, False)
    want, per_rank = runs[0][key], runs[1][key]
    y, dx, grads = _assembled(per_rank, mesh_shape, cases[key]["x"].shape)
    _close(y, want["y"], "y")
    for r in per_rank:
        _close(r["lb_loss"], want["lb_loss"], "lb_loss")
        _close(r["z_loss"], want["z_loss"], "z_loss")
        _close(r["expert_load"], want["expert_load"], "expert_load")
    _close(dx, want["dx"], "dx")
    ref_grads = _flat(want["dparams"])
    assert sorted(grads) == sorted(ref_grads)
    for k, g in grads.items():
        _close(g, ref_grads[k], f"d{k}")


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_and_droppless(arch, mesh_shape, cases, runs):
    """The tilted router overflows expert 0 in every batch shard (so the
    comparison above drops tokens); droppless, EP == moe_apply."""
    tilted = cases[(arch, mesh_shape, False)]
    cfg = tilted["cfg"]
    nb = B // mesh_shape[0]
    logits = tilted["x"].reshape(mesh_shape[0], nb * S, -1) \
        @ tilted["params"]["router"]["w"]
    top = np.argsort(-logits, axis=-1, kind="stable")[
        ..., :cfg.moe.experts_per_token]
    cap = moe.expert_capacity(nb * S, cfg.moe)
    assert all((top[i] == 0).sum() > cap for i in range(mesh_shape[0]))

    key = (arch, mesh_shape, True)
    case, per_rank = cases[key], runs[1][key]
    p = _nested(case["params"])
    y_ref, aux_ref = moe.moe_apply(p, case["cfg"],
                                   torch.from_numpy(case["x"]))
    y, _, _ = _assembled(per_rank, mesh_shape, case["x"].shape)
    _close(y, y_ref.numpy(), "droppless y")
    for r in per_rank:
        _close(r["z_loss"], float(aux_ref["z_loss"]), "z_loss")
        _close(r["expert_load"], aux_ref["expert_load"].numpy(),
               "expert_load")
        if mesh_shape[0] == 1:
            _close(r["lb_loss"], float(aux_ref["lb_loss"]), "lb_loss")


def test_ep_inside_the_model(runs):
    cfg, seed, batch = _model_case()
    params = zoo.init_params(cfg, seed, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = zoo.loss_and_metrics(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert {"lb_loss", "z_loss"} <= set(metrics)
    per_rank = runs[1]["model"]
    for r in per_rank:
        for k, v in metrics.items():
            _close(r["metrics"][k], float(v.detach()), k)
    # the ranks' gradients: the expert blocks laid end to end on dim -3,
    # every other leaf summed over the ranks that hold it
    paths = []
    sharding.map_with_path(lambda path, t: paths.append(path), params)
    ranks = sorted(per_rank, key=lambda r: r["coords"][1])
    n_expert = 0
    for i, (path, g) in enumerate(zip(paths, grads)):
        mine = [r["grads"][i] for r in ranks]
        if _torch_moe_ranks.is_expert_leaf(path):
            got = np.concatenate(mine, axis=-3)
            n_expert += 1
        else:
            got = sum(mine)
        _close(got, g.numpy(), f"d{path}")
    assert n_expert == 3


def _nested(tree):
    if isinstance(tree, dict):
        return {k: _nested(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_without_a_model_axis_it_is_moe_apply():
    cfg = _cfg("deepseek-v2-236b", False)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     device="cpu")
    x = torch.randn((2, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y0, a0 = moe.moe_apply(p, cfg, x)
    y1, a1 = moe.moe_apply_ep(p, cfg, x)
    assert torch.equal(y0, y1) and all(torch.equal(a0[k], a1[k]) for k in a0)
    with pytest.raises(ValueError, match="AbstractMesh"):
        moe.moe_apply_ep(p, cfg, x, mesh=mesh_lib.make_production_mesh())
