"""Node-parallel scheme execution: the rounds over a ('client', 'data') mesh
of torch.distributed ranks.

Reference: src/repro/core/sharded.py (`axis_size`, `check_mesh`,
`_check_batch`, `make_inl_sharded_round`, `make_fl_sharded_round`,
`make_sl_sharded_round`).  The paper's claim that INL is *naturally
distributed* (J nodes compute features in parallel, a fusion center
combines them) as an execution: each rank of a `launch/mesh` mesh runs its
block of the round —

    'client'  holds the J INL/FL branches (encoder params, branch heads,
              per-node priors, per-client FL replicas are sliced on their
              leading J axis, `Scheme.state_shardings`),
    'data'    shards the batch.

Cross-node traffic is the paper's cut-layer exchange: the hand-written cut
kernels run on each rank's (J/c * B/d, d) block, and the only collectives
are the fusion center's fan-in (the 'client' all_gather of the cut
latents, eq. (5)'s concatenation as a wire transfer, core/wirefmt.py), the
decoder's and FedAvg's reductions (a sum over 'client') and the batch
means (over 'data').  The fan-in's wire format is selectable (`wire=`):
"dense" gathers the quantized fp32 latents, "packed" the link_bits-bit
codewords in uint32 lanes (values and trajectories bit-identical),
"packed_duplex" also quantizes each node's error chunk after the dense
reduce-scatter that executes (the meter charges the quantized chunk).
FL's weight exchange stays fp32.

Single-device semantics, as in the reference:

- all randomness (eps, the decoder's dropout masks, FL's per-client
  masks) is drawn at GLOBAL shape from the round's generator, every rank
  drawing the whole tensor in the single-device order and keeping its
  block, so every rank's generator stays in step with the single-device
  run round after round (and under CUDA graphs); the fault mask is the
  host part's (core/schemes/base.py), the same on every rank;
- BatchNorm statistics are global (`pmean` over 'data' in the two-pass
  form, paper_model.bn_apply);
- the fusion term, replicated on every 'client' rank, enters the
  objective divided by the client axis' size: the all_gather's backward
  (a summing reduce-scatter) adds the ranks' identical cotangents back to
  full weight, and the decoder's dense gradients are summed over
  'client'; every gradient is then averaged over 'data'.

Gradients come out of the body; each rank's Adam updates its own shard of
the parameters and moments, which is elementwise, with the global-norm
clip reading the norm of the whole gradient (a sum over 'client' of the
sharded leaves' squares).  On a mesh of one rank every collective is the
identity on the values and every step the single-device one, so the
trajectory is the unsharded one bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import (tree_leaves, tree_map, tree_stack, tree_unflatten,
                         value_and_grad)
from repro_torch.core import fl, inl, linkmodel, paper_model, sl, wirefmt
from repro_torch.core import topology as topology_lib
from repro_torch.launch import sharding


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def check_mesh(mesh, num_clients: int):
    """The sharded rounds need ('client', 'data') axes with J divisible by
    the client axis (make_inl_host_mesh guarantees this via its replicated
    fallback)."""
    names = tuple(getattr(mesh, "axis_names", ()))
    for ax in ("client", "data"):
        if ax not in names:
            raise ValueError(f"sharded schemes need a {ax!r} mesh axis; "
                             f"got {names} (use "
                             f"launch.mesh.make_inl_host_mesh)")
    n_c = axis_size(mesh, "client")
    if num_clients % n_c:
        raise ValueError(f"client axis {n_c} does not divide J="
                         f"{num_clients}; make_inl_host_mesh falls back to "
                         f"a replicated client axis for such J")


def _check_batch(batch: int, n_d: int):
    if batch % n_d:
        raise ValueError(f"batch {batch} not divisible by data axis {n_d}; "
                         f"pick a batch size divisible by the device count")


def _psum_tree(axis, tree):
    return tree_unflatten(tree, axis.all_reduce_tree(tree_leaves(tree)))


def _pmean_tree(axis, tree):
    return tree_unflatten(tree, axis.mean_tree(tree_leaves(tree)))


def _global_metrics(metrics, client_axis=None, data_axis=None, *,
                    client_sums=()):
    """The rank's scalar metrics made global: summed over 'client' where
    `client_sums` names them, else averaged there (a value every client
    rank holds alike stays itself), then averaged over 'data'; one
    all-reduce an axis."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().to(torch.float32) for k in keys])
    if client_axis is not None:
        vals = client_axis.all_reduce(vals)
        vals = torch.stack([v if k in client_sums else v / client_axis.size
                            for k, v in zip(keys, vals)])
    if data_axis is not None:
        vals = data_axis.all_reduce(vals) / data_axis.size
    return dict(zip(keys, vals.unbind(0)))


# ---------------------------------------------------------------------------
# INL: encoders sharded over 'client', batch over 'data', all_gather fan-in
# ---------------------------------------------------------------------------

def make_inl_sharded_round(cfg, mesh, optimizer, *, wire: str = "dense",
                           topology=None):
    """The train step of core/inl.make_train_step on a mesh:

        step(params, state, opt_state, views, labels, generator, *,
             eps=None, drop_masks=None, delivery=None)
            -> (new_params, new_state, new_opt_state, metrics)

    params, state and opt_state are this rank's slices
    (`Scheme.state_shardings`); views (J, B, ...), labels (B,), eps
    (J, B, d) and drop_masks (B, units each) are GLOBAL, drawn from
    `generator` in the single-device order unless given, and the rank
    takes its block (launch/sharding.scheme_batch_shardings).  delivery —
    the round's (J,) fault mask, the same on every rank.  The metrics are
    the global ones, the same on every rank.

    A non-star `topology` swaps the fan-in for the graph execution
    (core/topology.graph_cut_and_ship): each rank cuts its nodes at their
    first-hop widths, the 'client' all_gather remains the one physical
    collective, and the hops run replicated on the gathered buffer."""
    check_mesh(mesh, cfg.num_clients)
    topo = topology_lib.nontrivial(topology, cfg)
    topology_lib.check_wires(topo, cfg, wire)        # fail at build time
    J, d = cfg.num_clients, cfg.d_bottleneck
    cax, dax = mesh.axis("client"), mesh.axis("data")
    gids = None if topo is None else \
        topology_lib.first_hop_groups(topo, cfg)[1][cax.block(J)]

    def global_norm(grads):
        # the decoder's dense layers are replicated; every other leaf is
        # this rank's share of a (J, ...) tensor
        def squares(leaves):
            return torch.sum(torch.stack([torch.sum(torch.square(
                x.to(torch.float32))) for x in leaves]))
        return torch.sqrt(squares(tree_leaves(grads.decoder["dense"]))
                          + cax.all_reduce(squares(tree_leaves(
                              (grads.encoders, grads.decoder["branch_heads"],
                               grads.priors)))))

    def step(params, state, opt_state, views, labels, generator, *,
             eps=None, drop_masks=None, delivery=None):
        B = labels.shape[0]
        _check_batch(B, dax.size)
        if eps is None:
            eps = torch.randn((J, B, d), generator=generator,
                              dtype=torch.float32, device=labels.device)
        if drop_masks is None:
            drop_masks = paper_model.decoder_dropout_masks(
                generator, cfg.dense_units, B, device=labels.device)
        (_, _, c, b), _ = sharding.scheme_batch_shardings(mesh, J, B)
        _, (metrics, new_state), grads = value_and_grad(
            inl.loss_fn, params, state, views[c, b], labels[b], cfg,
            eps=eps[c, b], drop_masks=[m[b] for m in drop_masks],
            train=True, wire=wire, topology=topology, delivery=delivery,
            client_axis=cax, data_axis=dax, group_ids=gids)
        # the decoder's dense gradients carry 1/n_c each: sum them back
        grads = grads._replace(decoder={
            "dense": _psum_tree(cax, grads.decoder["dense"]),
            "branch_heads": grads.decoder["branch_heads"]})
        grads = _pmean_tree(dax, grads)                # global batch mean
        new_params, new_opt = optimizer.update(
            grads, opt_state, params,
            norm=None if cax.size == 1 else global_norm(grads))
        metrics = _global_metrics(
            {k: v for k, v in metrics.items() if k != "bits_sent"}, cax, dax,
            client_sums=("loss", "rate_total"))
        bits = (linkmodel.training_step_bits(B, J * d, cfg.link_bits)
                if topo is None else topology_lib.round_bits(topo, cfg, B))
        metrics["bits_sent"] = torch.tensor(float(bits), dtype=torch.float32)
        return new_params, new_state, new_opt, metrics
    return step


# ---------------------------------------------------------------------------
# FL: the J client replicas (params, opt state, local steps) over 'client'
# ---------------------------------------------------------------------------

def make_fl_sharded_round(cfg, mesh, optimizer, local_steps: int, *,
                          faulty: bool = False):
    """The FedAvg round of core/fl.make_round on a mesh, the clients' local
    steps running in parallel across 'client' and the server's average one
    sum over it:

        round_fn(params, state, opt_state, views, labels, drop_masks,
                 mask=None, *, plan=None) -> (params, state, opt_state,
                                               metrics)

    params, state and opt_state hold this rank's J_local client replicas;
    views (J, local_steps, J, B, ...), labels (J, local_steps, B),
    drop_masks[j][s] and the (J,) mask are GLOBAL, and the rank trains its
    own clients.  The weight exchange stays fp32.  faulty=True averages
    over the uploads that arrived, as fl.make_round does (all lost keeps
    the previous global model); `plan` and `mask` as there.  'data' only
    replicates: every data rank runs the same clients."""
    check_mesh(mesh, cfg.num_clients)
    J = cfg.num_clients
    cax = mesh.axis("client")
    own = cax.block(J)
    one_client = fl.make_one_client(
        optimizer, compute_dtype=getattr(cfg, "compute_dtype", "fp32"))

    def average(p, old, plan, w):
        if plan == "all":
            return _pmean_tree(cax, tree_map(lambda x: torch.mean(x, dim=0),
                                             p))
        if plan == "none":
            return tree_map(lambda x, o: o[0].to(x.dtype), p, old)
        n, w = plan[1], w.to(torch.float32)

        def part(x):
            return torch.sum(x * w.reshape((w.shape[0],)
                                           + (1,) * (x.dim() - 1)), dim=0)
        return tree_map(lambda s: s / float(n),
                        _psum_tree(cax, tree_map(part, p)))

    def round_fn(params, state, opt_state, views, labels, drop_masks,
                 mask=None, *, plan=None):
        outs = [one_client(fl.replica(params, k), fl.replica(state, k),
                           fl.replica(opt_state, k), views[j], labels[j],
                           drop_masks[j])
                for k, j in enumerate(range(own.start, own.stop))]
        p, s, o, m = (tree_stack([out[i] for out in outs]) for i in range(4))
        w = None
        if not faulty:
            plan = "all"
        elif plan is None:
            if mask is None:
                raise ValueError("a faulty FedAvg round takes the (J,) "
                                 "client delivery mask as its last argument")
            plan = fl.average_plan(mask)
            w = torch.as_tensor(np.array(mask, bool),
                                device=tree_leaves(p)[0].device)
        else:
            w = mask
        avg = average(p, params, plan, None if w is None else w[own])
        p_new = tree_stack([avg] * (own.stop - own.start))
        metrics = _global_metrics({k: v.mean() for k, v in m.items()}, cax)
        return p_new, s, o, metrics
    return round_fn


# ---------------------------------------------------------------------------
# SL: client/server split is sequential by construction; the batch shards
# ---------------------------------------------------------------------------

def make_sl_sharded_round(cfg, mesh, opt_client, opt_server, *,
                          wire: str = "dense"):
    """The SL step of core/sl.make_train_step on a mesh, the minibatch
    sharded over 'data' (the J conv branches all live client-side, so
    'client' only replicates):

        step(client, server, state, opt_c, opt_s, views, labels, drop_masks)
            -> (client, server, state, opt_c, opt_s, metrics)

    views (J, B, ...), labels (B,) and drop_masks are GLOBAL; the rank
    takes its rows, and the gradients are averaged over 'data' back to the
    global-batch values.  The cut crossing honours `wire` (packed codewords
    are a per-row re-encoding, so any batch sharding sees identical
    values)."""
    check_mesh(mesh, cfg.num_clients)
    wirefmt.resolve_wire(wire, cfg.link_bits)
    dax = mesh.axis("data")
    compute_dtype = getattr(cfg, "compute_dtype", "fp32")

    def _loss(params, state, views, labels, drop_masks):
        client, server = params
        return sl.loss_fn(client, server, state, views, labels,
                          drop_masks=drop_masks, link_bits=cfg.link_bits,
                          wire=wire, compute_dtype=compute_dtype,
                          axis_name=dax)

    def step(client, server, state, opt_c, opt_s, views, labels,
             drop_masks):
        B = labels.shape[0]
        _check_batch(B, dax.size)
        (_, _, _, b), _ = sharding.scheme_batch_shardings(
            mesh, cfg.num_clients, B)
        _, (metrics, new_state), grads = value_and_grad(
            _loss, (client, server), state, views[:, b], labels[b],
            [m[b] for m in drop_masks])
        g_client, g_server = _pmean_tree(dax, grads)
        new_client, new_opt_c = opt_client.update(g_client, opt_c, client)
        new_server, new_opt_s = opt_server.update(g_server, opt_s, server)
        metrics = _global_metrics(metrics, data_axis=dax)
        return (new_client, new_server, new_state, new_opt_c, new_opt_s,
                metrics)
    return step
