"""What the ranks of tests/test_torch_moe_ep.py run (torch and
repro_torch only: no JAX, so a rank starts in seconds).

`ep_world` builds a ('data', 'model') mesh over the gloo world, and for
every case runs `moe.moe_apply_ep` on this rank's batch shard and block of
experts, then its backward with sum semantics: the cotangent of y, which
the ranks of a 'model' group share, enters each of them divided by the
group's size, and that of the aux values, which every rank shares, divided
by the world size.  It returns y, the aux values and this rank's
gradients as numpy.

Given a `model` case (a config with moe_impl "ep", a seed, a batch), it
also runs the whole model's `zoo.loss_and_metrics(..., mesh=)` on that
mesh, every MoE layer on this rank's block of experts (`model_on_rank`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree_leaves, tree_unflatten
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import moe, zoo

EXPERT_LEAVES = ("wi", "wg", "wo")


def local_params(params, mesh):
    """The rank's params: router and shared experts whole, its block of
    the experts."""
    ax = mesh.axis("model")
    out = dict(params)
    for k in EXPERT_LEAVES:
        out[k] = params[k][ax.block(params[k].shape[0])].clone()
    return out


def is_expert_leaf(path) -> bool:
    names = sharding._path_names(path)
    return "moe" in names[:-1] and names[-1] in EXPERT_LEAVES


def expert_blocks(params, mesh):
    """A model's params with every MoE layer's expert leaves cut to this
    rank's block of the 'model' axis (the expert dim, -3, of (..., E, d, f)
    and (..., E, f, d)); the rest whole."""
    ax = mesh.axis("model")

    def cut(path, t):
        if not is_expert_leaf(path):
            return t
        return t.narrow(t.dim() - 3, ax.index * (t.shape[-3] // ax.size),
                        t.shape[-3] // ax.size).clone()
    return sharding.map_with_path(cut, params)


def model_on_rank(mesh, cfg, seed, batch):
    """zoo.loss_and_metrics of (cfg, params from `seed`) on `batch` (this
    rank's shard, numpy) with the experts parallel over the mesh, and the
    gradients of this rank's leaves (a list in `tree_leaves` order) with
    the loss seeded by 1 / the world size (every rank holds the same
    loss)."""
    params = expert_blocks(zoo.init_params(cfg, seed, device="cpu"), mesh)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    params = tree_unflatten(params, leaves)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = zoo.loss_and_metrics(params, cfg, batch, mesh=mesh)
    world = mesh.axis("data").size * mesh.axis("model").size
    grads = torch.autograd.grad(loss / world, leaves)
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": [g.numpy() for g in grads],         # tree_leaves order
            "coords": (mesh.axis("data").index, mesh.axis("model").index)}


def ep_world(rank, world, mesh_shape, cases, model_case=None):
    """(the cases' results, model_on_rank(*model_case) or None)."""
    mesh = mesh_lib.Mesh(mesh_shape, ("data", "model"), device="cpu")
    data, model = mesh.axis("data"), mesh.axis("model")
    out = []
    for case in cases:
        p = local_params(_to_torch(case["params"]), mesh)
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        p = tree_unflatten(p, leaves)
        x_all = torch.from_numpy(case["x"])
        x = x_all[data.block(x_all.shape[0])].clone().requires_grad_(True)
        y, aux = moe.moe_apply_ep(p, case["cfg"], x, mesh=mesh)
        ct = torch.from_numpy(case["ct_y"])[data.block(x_all.shape[0])]
        loss = (y * ct).sum() / model.size + (
            case["c_lb"] * aux["lb_loss"] + case["c_z"] * aux["z_loss"]) \
            / (data.size * model.size)
        grads = torch.autograd.grad(loss, leaves + [x])
        out.append({
            "y": y.detach().numpy(),
            "lb_loss": float(aux["lb_loss"].detach()),
            "z_loss": float(aux["z_loss"].detach()),
            "expert_load": aux["expert_load"].numpy(),
            "dparams": tree_unflatten(p, [g.numpy() for g in grads[:-1]]),
            "dx": grads[-1].numpy(),
            "coords": (data.index, model.index)})
    return out, (None if model_case is None
                 else model_on_rank(mesh, *model_case))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))
