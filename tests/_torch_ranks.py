"""What the ranks of tests/test_torch_sharded.py run.

Each process that `_torch_common.spawn_ranks` starts imports this module
(torch and repro_torch only: no JAX, so a rank starts in seconds), joins a
gloo process group over a FileStore and runs one of the `*_world`
functions below, which build their mesh and run every case of one world;
their results (tensors, floats) go back to the test, which holds them
against the JAX reference and the single-device port.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint, tree_leaves
from repro_torch.core import linkfault, schemes, topology, wirefmt
from repro_torch.core.schemes import runner
from repro_torch.data import multiview
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding

LR = 2e-3
ERASURE = 0.3


def rank_entry(fn, rank, world, store_path, args, queue):
    """One rank: a gloo process group over the FileStore at `store_path`,
    one intra-op thread, then fn(rank, world, *args) into `queue` as
    (rank, ok, result or traceback)."""
    torch.set_num_threads(1)
    try:
        # a rank left waiting in a collective fails within a minute
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        queue.put((rank, True, fn(rank, world, *args)))
    except BaseException:                # reported to the test, then raised
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh(num_clients):
    with warnings.catch_warnings():
        # J=5 on two ranks: the replicated client axis, warned
        warnings.simplefilter("ignore", UserWarning)
        return mesh_lib.make_inl_host_mesh(num_clients, device="cpu")


def convert(tree, fn):
    """`tree` (dicts, lists, tuples, NamedTuples) with fn applied to its
    tensor and numpy leaves: numpy crosses between processes by value."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: convert(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(convert(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(convert(v, fn) for v in tree)
    return tree


def to_numpy(tree):
    return convert(tree, lambda t: t.detach().numpy()
                   if isinstance(t, torch.Tensor) else t)


def to_torch(tree):
    return convert(tree, lambda t: torch.from_numpy(np.array(t))
                   if isinstance(t, np.ndarray) else t)


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def reference_rounds(mesh, name, cfg, state, v, lab, draws, views_eval,
                     labels_eval):
    """The scheme's sharded round on the reference's init and draws
    (INL: (eps, masks) a round; FL and SL: masks): the losses, the final
    accuracy on the gathered state and the gathered state."""
    scheme = schemes.get(name)
    specs = scheme.state_shardings(cfg, state, mesh)
    st = sharding.shard_state(state, specs, mesh)
    round_fn = scheme.make_sharded_round(cfg, mesh, lr=LR)
    losses = []
    for draw in draws:
        kw = ({"eps": draw[0], "drop_masks": draw[1]} if name == "inl"
              else {"drop_masks": draw})
        st, m = round_fn(st, v, lab, None, **kw)
        losses.append(float(m["loss"]))
    full = sharding.gather_state(st, specs, mesh)
    probs = scheme.predict(full, views_eval, device="cpu")
    acc = float((probs.argmax(-1) == labels_eval).to(torch.float32).mean())
    return {"losses": losses, "accuracy": acc, "state": full}


def epoch_runs(mesh, name, cfg, v, lab, rounds, *, wire="dense", topo=None,
               lossy=False):
    """`rounds` rounds through make_epoch on the mesh and without it, from
    one init and one generator seed (and, over lossy links, the runner's
    round keys): (mesh losses, single-device losses, gathered final state,
    single-device final state)."""
    scheme = schemes.get(name)
    if lossy:
        topo = linkfault.with_links(topology.star(cfg.num_clients),
                                    linkfault.LinkModel(erasure=ERASURE))
    keys = ([linkfault.round_key(0, r) for r in range(rounds)]
            if lossy else None)
    vs = v[None].expand((rounds,) + tuple(v.shape))
    ls = lab[None].expand((rounds,) + tuple(lab.shape))
    init = scheme.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = scheme.state_shardings(cfg, init, mesh)
    st, m = scheme.make_epoch(cfg, lr=LR, mesh=mesh, wire=wire,
                              topology=topo)(
        sharding.shard_state(init, specs, mesh), vs, ls,
        torch.Generator().manual_seed(1), round_keys=keys)
    st1, m1 = scheme.make_epoch(cfg, lr=LR, wire=wire, topology=topo)(
        init, vs, ls, torch.Generator().manual_seed(1), round_keys=keys)
    return (m["loss"].tolist(), m1["loss"].tolist(),
            sharding.gather_state(st, specs, mesh), st1)


def fan_in_bytes(mesh, cfg, v, lab):
    """One INL round per wire: this rank's bytes on the 'client' axis'
    gather and reduce-scatter (the fan-in and its transpose)."""
    cax = mesh.axis("client")
    out = {}
    for wire in ("dense", "packed", "packed_duplex"):
        scheme = schemes.get("inl")
        init = scheme.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        st = sharding.shard_state(
            init, scheme.state_shardings(cfg, init, mesh), mesh)
        before = dict(cax.traffic)
        scheme.make_sharded_round(cfg, mesh, wire=wire)(
            st, v, lab, torch.Generator().manual_seed(1))
        out[wire] = {k: cax.traffic[k] - before[k]
                     for k in ("all_gather", "reduce_scatter")}
    return out


def collective_grads(mesh, name, rank):
    """x (3, 4) a rank through each differentiable collective of axis
    `name`, and the gradient of sum(c * y) for a rank-seeded cotangent c."""
    ax = mesh.axis(name)
    out = {}
    for op in ("all_gather", "psum", "pmean"):
        g = torch.Generator().manual_seed(10 * rank + 1)
        x = torch.randn((3, 4), generator=g).requires_grad_(True)
        y = getattr(ax, op)(x)
        c = torch.randn(y.shape, generator=g)
        (y * c).sum().backward()
        out[op] = (x.detach(), c, y.detach(), x.grad)
    return out


def axis_of_one(mesh, cfg):
    """The wire and the graph on this rank's one-rank 'client' axis against
    no axis: every output and gradient bit for bit."""
    ax = mesh.axis("client")
    assert ax.size == 1
    g = torch.Generator().manual_seed(5)
    mu = torch.randn((3, 4, 8), generator=g) * 2.0
    lv = torch.rand((3, 4, 8), generator=g) * 6.0 - 3.0
    eps = torch.randn((3, 4, 8), generator=g)
    gu = torch.randn((3, 4, 8), generator=g)
    same = {}

    def run(fn, axis):
        m = mu.clone().requires_grad_(True)
        out = fn(m, axis)
        (sum((o.to(torch.float32) * gu[..., :o.shape[-1]] if o.dim() == 3
              else o).sum() for o in out)).backward()
        return [o.detach() for o in out] + [m.grad]

    for wire in ("dense", "packed", "packed_duplex"):
        def cut(m, axis, wire=wire):
            return wirefmt.cut_and_ship(None, m, lv, eps=eps, link_bits=4,
                                        wire=wire, axis_name=axis)

        def ship(m, axis, wire=wire):
            u = wirefmt.ship(m, link_bits=4, wire=wire, axis_name=axis)
            return (u,)
        same[f"cut_and_ship {wire}"] = _same(run(cut, ax), run(cut, None))
        same[f"ship {wire}"] = _same(run(ship, ax), run(ship, None))
    chain = topology.chain(3, link_bits=(4, 8, 32))
    c3 = dataclasses.replace(cfg, num_clients=3, noise_stds=(0.4, 1.0, 2.0))
    gids = topology.first_hop_groups(chain, c3)[1]

    def graph(m, axis):
        return topology.graph_cut_and_ship(chain, c3, m, lv, eps,
                                           wire="dense", axis_name=axis,
                                           group_ids=gids)
    same["graph_cut_and_ship chain(3)"] = _same(run(graph, ax),
                                                run(graph, None))
    return same


def runner_and_resume(mesh, rank, cfg, views, labels, ckpt_root):
    """run_scheme(mesh=) against the single-device per-round run; a mesh
    run resumed from its epoch-1 checkpoint against the uninterrupted one;
    a mesh checkpoint resumed without the mesh and the other way round."""
    kw = dict(epochs=2, batch_size=16, eval_n=64, device="cpu")
    out = {"mesh": runner.run_scheme("inl", views, labels, cfg, mesh=mesh,
                                     **kw),
           "per_round": runner.run_scheme("inl", views, labels, cfg,
                                          dispatch="per_round", **kw)}
    full, part = (os.path.join(ckpt_root, d) for d in ("full", "part"))
    out["full"] = runner.run_scheme("inl", views, labels, cfg, mesh=mesh,
                                    ckpt_dir=full, **kw)
    runner.run_scheme("inl", views, labels, cfg, mesh=mesh, ckpt_dir=part,
                      **dict(kw, epochs=1))
    out["resumed"] = runner.run_scheme("inl", views, labels, cfg, mesh=mesh,
                                       ckpt_dir=part, resume=True, **kw)
    # both directories now hold epoch 2: the same leaves, bit for bit
    template = schemes.get("inl").init(cfg, 0, device="cpu")
    a, _ = checkpoint.restore(full, template, step=2)
    b, _ = checkpoint.restore(part, template, step=2)
    out["same_checkpoint"] = _same(a, b)
    # a mesh checkpoint resumed without the mesh (rank 0 alone), and a
    # checkpoint written without a mesh resumed on it
    off, on = (os.path.join(ckpt_root, d) for d in ("off", "on"))
    if rank == 0:
        os.makedirs(off)
        for f in os.listdir(part):
            if "00000001" in f:
                shutil.copy(os.path.join(part, f), off)
        out["off_mesh"] = runner.run_scheme("inl", views, labels, cfg,
                                            ckpt_dir=off, resume=True, **kw)
        runner.run_scheme("inl", views, labels, cfg, ckpt_dir=on,
                          **dict(kw, epochs=1))
    mesh.barrier()
    out["on_mesh"] = runner.run_scheme("inl", views, labels, cfg, mesh=mesh,
                                       ckpt_dir=on, resume=True, **kw)
    return out


def _batch(cfg, n, seed=0):
    """(views (J, n, ...), labels (n,)) of the port's data generator."""
    imgs, labels = multiview.make_base_dataset(n, image_shape=cfg.image_shape,
                                               seed=seed)
    return (torch.from_numpy(multiview.make_views(imgs, cfg.noise_stds)),
            torch.from_numpy(labels).long())


def _round_batch(name, cfg, views, labels, b):
    """One minibatch stacked batches_per_round times: ((R, J, b, ...),
    (R, b))."""
    R = schemes.get(name).batches_per_round(cfg)
    return (views[:, :b][None].expand((R,) + tuple(views[:, :b].shape)),
            labels[:b][None].expand(R, b))


def _reference_cases(mesh, inputs, names):
    ev, el = inputs["eval"]
    out = {}
    for key in names:
        r = inputs["reference"][key]
        name = key.split("+")[0]
        res = reference_rounds(mesh, name, r["cfg"], r["state"], r["v"],
                               r["lab"], r["draws"], ev, el)
        out[key] = {"losses": res["losses"], "accuracy": res["accuracy"]}
    return out


def _wire_cases(mesh, cfg, b):
    """INL on the three wires at link_bits=8, 3 rounds through make_epoch
    on the mesh and without it."""
    c8 = dataclasses.replace(cfg, link_bits=8)
    v, lab = _round_batch("inl", c8, *_batch(c8, b), b)
    return {wire: epoch_runs(mesh, "inl", c8, v, lab, 3, wire=wire)
            for wire in ("dense", "packed", "packed_duplex")}


def _lossy_cases(mesh, cfg, names, b):
    out = {}
    views, labels = _batch(cfg, b)
    for name in names:
        v, lab = _round_batch(name, cfg, views, labels, b)
        out[name] = epoch_runs(mesh, name, cfg, v, lab, 4, lossy=True)
    return out


def data_world(rank, world, inputs):
    """(client=1, data=2) on the J=5 config: the reference's rounds for
    INL, FL and SL; the wires; lossy links; the one-rank client axis; the
    data axis' collectives; the runner and its checkpoints."""
    cfg = inputs["cfg"]
    mesh = _mesh(cfg.num_clients)
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}
    out.update(_reference_cases(mesh, to_torch(inputs), ("inl", "fl", "sl")))
    out["wires"] = _wire_cases(mesh, cfg, 8)
    out["lossy"] = _lossy_cases(mesh, cfg, ("inl", "fl", "sl"), 8)
    out["axis_of_one"] = axis_of_one(mesh, cfg)
    out["collectives"] = collective_grads(mesh, "data", rank)
    views, labels = _batch(cfg, 64)
    out["runner"] = runner_and_resume(mesh, rank, cfg, views, labels,
                                      inputs["ckpt_root"])
    return to_numpy(out)


def client_world(rank, world, inputs):
    """(client=2, data=1) on the J=2 config: the reference's rounds for
    INL, FL and INL with learned priors; the wires and the fan-in's bytes;
    lossy links; a chain(4) of three widths; the client axis'
    collectives."""
    cfg = inputs["cfg"]
    mesh = _mesh(cfg.num_clients)
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}
    out.update(_reference_cases(mesh, to_torch(inputs),
                                ("inl", "fl", "inl+learned_prior")))
    out["wires"] = _wire_cases(mesh, cfg, 8)
    c8 = dataclasses.replace(cfg, link_bits=8)
    v, lab = _round_batch("inl", c8, *_batch(c8, 8), 8)
    out["bytes"] = fan_in_bytes(mesh, c8, v, lab)
    out["lossy"] = _lossy_cases(mesh, cfg, ("inl", "fl"), 8)
    c4 = dataclasses.replace(cfg, num_clients=4,
                             noise_stds=(0.4, 1.0, 2.0, 3.0))
    chain = topology.chain(4, link_bits=(2, 4, 8, 32))
    v4, lab4 = _round_batch("inl", c4, *_batch(c4, 8), 8)
    out["chain"] = {wire: epoch_runs(mesh, "inl", c4, v4, lab4, 3,
                                     wire=wire, topo=chain)
                    for wire in ("dense",)}
    out["collectives"] = collective_grads(mesh, "client", rank)
    return to_numpy(out)
