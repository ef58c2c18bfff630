"""Registry-driven training runner — one loop for every scheme.

Reference: src/repro/core/schemes/runner.py (`CurvePoint`,
`rounds_per_epoch`, `run_scheme`, `_run_per_round`, `run_all`,
`efficiency`).  The scheme supplies init / round / predict / bandwidth
through the Scheme interface; this module supplies the epoch loop,
minibatch grouping, the BandwidthMeter and the accuracy-vs-Gbit curve.

Two dispatches, as in the reference.  "scan" (the default) runs each
epoch through `Scheme.make_epoch`: on the card one CUDA graph of the
round's device part per host signature, replayed once a round (the
counterpart of the reference's jitted lax.scan over the epoch), on the
CPU the same rounds in a Python loop.  "per_round" calls the round once
per group of minibatches, the reference's `_run_per_round`.  The two give
the same trajectory bit for bit.  The reference's `prefetch_size=`
overlaps the host-to-device copies of the next epoch's minibatches; the
port has none to overlap, since the data set moves to the device once.

`mesh=` (launch/mesh.make_inl_host_mesh; every rank of the mesh calls
run_scheme with the same arguments) trains across the mesh's ranks under
"scan": each rank holds its slice of the state (`Scheme.state_shardings`)
and its epoch_fn runs the sharded round (core/sharded.py), which reads its
block of each epoch's minibatches.  After each epoch the state is
gathered, so every rank evaluates the same model and its curve is the
same; the ledgers are the unsharded run's.  Checkpoints hold the gathered
state in the unsharded layout, written by rank 0 between two barriers; a
resume restores on every rank and slices again, so a checkpoint written
on a mesh resumes without one and the other way round.

The data set moves to the device once; each epoch gathers its
minibatches there in one go from the reference's seeded batch indices
(data/multiview), so the port sees the same batches in the same order.  A
torch.Generator seeded with `seed + 1` supplies every round's eps and
dropout masks, in that order; the initial state comes from one seeded
with `seed`.

Unreliable links (core/linkfault.py): when the topology carries link
models or cfg.edge_dropout > 0, global round g (counted from 0 over the
run) gets the fault key `linkfault.round_key(seed, g)`, a stream apart from
the generator's.  The round draws its masks from it, and the meter
replays the same draws on the host (`_meter_fault_rounds`), splitting the
round's charges between the offered and the delivered ledgers, so
`CurvePoint.delivered_gbits` counts what reached its consumer.

`transport=` (repro_torch/transport.NetworkTransport, the reference's
`_run_transport`): fault outcomes come from the transport's retrying
channels, circuit breakers and chaos schedule, one `round_outcome` a
round at tick = the global round index, and reach the scheme's
transport round (`Scheme.make_transport_round_parts`) as its explicit
(J,) mask.  The transport owns the run's meter: offered accrues per
attempt, delivered per surviving payload fraction, with FL's and SL's
scalar round charges split equally across the star's edges.  Outcomes
depend on ticks only, never on device results, so under "scan" each
epoch first takes its rounds' outcomes in tick order (a cluster's
`on_tick` hook realises its kills and freezes there) and then runs
`Scheme.make_transport_epoch`: on the card one CUDA graph per host
signature, each round's mask copied into its static buffer.  A resume
replays the completed ticks with `charge=False` (breakers and the
adaptive controller rebuilt, the restored ledgers left alone), then loads
the sidecar's `transport.snapshot()`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as checkpoint_lib
from repro_torch import resolve_device
from repro_torch.core import bandwidth, linkfault, schemes
from repro_torch.core import topology as topology_lib
from repro_torch.core.schemes import base
from repro_torch.data import multiview
from repro_torch.launch import sharding


class CurvePoint(NamedTuple):
    epoch: int
    accuracy: float
    gbits: float                 # cumulative ACCOUNTED bits (§III-C), Gbit
    measured_gbits: float = 0.0  # cumulative MEASURED wire-buffer bits, Gbit
    delivered_gbits: float = 0.0  # what actually reached its consumer, Gbit


def _round_charges(scheme, cfg, state, batch_size, *, wire, topology):
    """ONE round's bandwidth charges, computed once per run: the per-edge
    ledger where the scheme decomposes its exchange over the topology's
    links, else the scalar totals under the key None."""
    ledger = scheme.edge_ledger(cfg, state, batch_size, wire=wire,
                                topology=topology)
    if ledger is not None:
        return ledger
    return {None: (scheme.bits_per_round(cfg, state, batch_size,
                                         topology=topology),
                   scheme.wire_bytes_per_round(cfg, state, batch_size,
                                               wire=wire,
                                               topology=topology))}


def _meter_rounds(meter, charges, delivered=None) -> None:
    """Charge one round of `charges` as offered traffic, and `delivered`
    (default the same charges: on the clean network everything offered
    arrives) on the delivered ledger."""
    for edge, (bits, nbytes) in charges.items():
        if edge is None:
            meter.add(bits)
            meter.add_measured(nbytes)
        else:
            meter.add_edge(edge, bits=bits, nbytes=nbytes)
    for edge, (bits, nbytes) in (charges if delivered is None
                                 else delivered).items():
        meter.add_delivered(bits=bits, nbytes=nbytes, edge=edge)


def _meter_fault_rounds(meter, scheme, topo_full, cfg, batch_size, charges,
                        round_keys) -> None:
    """Per-round fault metering: replay each round key's fault draws
    (linkfault.round_fault_charges draws from the SAME keys the rounds'
    masks came from) and split the round between the offered and delivered
    ledgers."""
    for rk in round_keys:
        off, dlv = linkfault.round_fault_charges(
            rk, scheme.name, topo_full, cfg, batch_size, charges)
        _meter_rounds(meter, off, delivered=dlv)


def _meter_overheads(meter, scheme, cfg, state) -> None:
    """Once-per-epoch charges, charged and delivered in full."""
    bits = scheme.epoch_overhead_bits(cfg, state)
    nbytes = scheme.epoch_overhead_wire_bytes(cfg, state)
    meter.add(bits)
    meter.add_measured(nbytes)
    meter.add_delivered(bits=bits, nbytes=nbytes)


def _meter_dump(meter) -> dict:
    """The meter's full ledger state, JSON-serialisable (resume context)."""
    return {"total_bits": meter.total_bits,
            "measured_bytes": meter.measured_bytes,
            "delivered_bits": meter.delivered_bits,
            "delivered_measured_bytes": meter.delivered_measured_bytes,
            "edge_bits": dict(meter.edge_bits),
            "edge_measured_bytes": dict(meter.edge_measured_bytes),
            "edge_delivered_bits": dict(meter.edge_delivered_bits)}


def _meter_load(meter, d: dict) -> None:
    meter.total_bits = float(d["total_bits"])
    meter.measured_bytes = float(d["measured_bytes"])
    meter.delivered_bits = float(d["delivered_bits"])
    meter.delivered_measured_bytes = float(d["delivered_measured_bytes"])
    meter.edge_bits = {k: float(v) for k, v in d["edge_bits"].items()}
    meter.edge_measured_bytes = {k: float(v) for k, v
                                 in d["edge_measured_bytes"].items()}
    meter.edge_delivered_bits = {k: float(v) for k, v
                                 in d["edge_delivered_bits"].items()}


def _save_epoch(ckpt_dir, name, ep, state, curve, meter, generator,
                transport=None) -> None:
    """One epoch-granular checkpoint: the whole training state, and in the
    sidecar the curve, both meter ledgers and the round generator's state
    (as hex), everything a bit-identical resume needs.  The state's leaves
    are copied to the host here, before the next epoch can overwrite
    them.  A transport run also records `transport.snapshot()`: breaker
    counters for the record, the adaptive controller's state for the
    resume."""
    extra = {"scheme": name, "epoch": ep,
             "curve": [list(map(float, p)) for p in curve],
             "meter": _meter_dump(meter),
             "generator": {"device": generator.device.type,
                           "state": generator.get_state().numpy()
                           .tobytes().hex()}}
    if transport is not None:
        extra["transport"] = transport.snapshot()
    checkpoint_lib.save(ckpt_dir, ep, state, extra=extra)


def _try_resume(ckpt_dir, state, meter, generator):
    """Restore the latest complete epoch checkpoint when one exists:
    returns (state, curve so far, epochs already done, the transport
    snapshot or None), with the meter's ledgers and `generator`'s state
    set from the sidecar.  A directory without one resumes from nothing:
    epoch 0 with the given state."""
    step = checkpoint_lib.latest_step(ckpt_dir)
    if step is None:
        return state, [], 0, None
    meta = checkpoint_lib.load_meta(ckpt_dir, step)
    saved = meta["generator"]
    if saved["device"] != generator.device.type:
        raise ValueError(f"the checkpoint's round generator drew on "
                         f"{saved['device']}, this run draws on "
                         f"{generator.device.type}; resume on the device "
                         f"type that wrote it")
    restored, _ = checkpoint_lib.restore(ckpt_dir, state, step=step)
    curve = [CurvePoint(int(p[0]), *map(float, p[1:]))
             for p in meta["curve"]]
    _meter_load(meter, meta["meter"])
    generator.set_state(torch.frombuffer(
        bytearray.fromhex(saved["state"]), dtype=torch.uint8))
    return restored, curve, int(meta["epoch"]), meta.get("transport")


def _host(x):
    """A tensor as it is, anything else (a jax or numpy array) as numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def rounds_per_epoch(scheme, cfg, n: int, batch_size: int) -> int:
    """Rounds one epoch of an n-sample set runs: full minibatches grouped
    by the scheme's batches_per_round.  The search's closed-form pricing
    (repro_torch/search/pricing.py) charges exactly these rounds."""
    return (n // batch_size) // scheme.batches_per_round(cfg)


def _check_options(dispatch, mesh, transport, meter) -> None:
    if transport is not None:
        if mesh is not None:
            raise ValueError("transport execution is per-round; no mesh")
        if meter is not None and meter is not transport.meter:
            raise ValueError("pass either meter= or transport= (the "
                             "transport owns the run's meter)")
    if dispatch == "per_round" and mesh is not None:
        raise ValueError("mesh execution needs dispatch='scan'")
    if dispatch not in ("scan", "per_round"):
        raise ValueError(f"unknown dispatch {dispatch!r}")


def run_scheme(name: str, views, labels, cfg, *, epochs: int,
               batch_size: int = 64, lr: float = 2e-3, seed: int = 0,
               eval_n: int = 512, dispatch: str = "scan", mesh=None,
               wire: str = "dense", topology=None, meter=None,
               transport=None, ckpt_dir=None, ckpt_every: int = 1,
               resume: bool = False, device=None) -> List[CurvePoint]:
    """Train scheme `name` for `epochs` over the (J, n, ...) multi-view set
    (numpy or tensors) on `device` (None: cuda) and return its
    accuracy/bandwidth curve (paper Figs. 5/7 rows).

    Minibatches are grouped `batches_per_round(cfg)` at a time into round
    calls; a trailing partial group is dropped.  Bandwidth accrues on two
    ledgers: the §III-C closed forms (`gbits`) and the measured bytes of
    the wire buffers (`measured_gbits`), per edge where the scheme
    decomposes its exchange (pass `meter=` a BandwidthMeter to read the
    per-edge ledgers afterwards).  After each epoch, accuracy is one
    predict over the first `eval_n` samples.  Over unreliable links the
    delivered ledger (`delivered_gbits`) follows each round's fault draws
    (module docstring).  dispatch "scan" runs each epoch as one
    `Scheme.make_epoch` call (CUDA graphs on the card), "per_round" one
    round call per group; the same trajectory either way.  `ckpt_dir`
    saves a checkpoint every `ckpt_every` epochs and after the last;
    `resume=True` trains on from the latest one there, bit-identical to
    the uninterrupted run (module docstring).  `mesh` trains across a
    mesh of ranks (module docstring); `device` defaults to the mesh's.
    `transport` (a NetworkTransport over the resolved topology) decides
    each round's delivery from its channels, breakers and chaos schedule
    and meters on its own meter (module docstring)."""
    _check_options(dispatch, mesh, transport, meter)
    device = resolve_device(mesh.device if mesh is not None and device is None
                            else device)
    scheme = schemes.get(name)
    if transport is not None:
        return _run_transport(
            scheme, views, labels, cfg, epochs=epochs,
            batch_size=batch_size, lr=lr, seed=seed, eval_n=eval_n,
            dispatch=dispatch, wire=wire, topology=topology,
            transport=transport, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            resume=resume, device=device)
    state = scheme.init(cfg, torch.Generator(device=device).manual_seed(seed),
                        lr=lr, device=device)
    if dispatch == "scan":
        epoch_fn = scheme.make_epoch(cfg, lr=lr, mesh=mesh, wire=wire,
                                     topology=topology)
    else:
        round_fn = scheme.make_round(cfg, lr=lr, wire=wire,
                                     topology=topology)
    bpr = scheme.batches_per_round(cfg)
    # tensors already on the device (the search's shared views) stay there
    views = torch.as_tensor(_host(views), dtype=torch.float32, device=device)
    labels = torch.as_tensor(_host(labels), device=device).long()
    n = labels.shape[0]
    meter = bandwidth.BandwidthMeter() if meter is None else meter
    charges = _round_charges(scheme, cfg, state, batch_size, wire=wire,
                             topology=topology)
    rounds = rounds_per_epoch(scheme, cfg, n, batch_size)
    topo_full = topology_lib.resolve(topology, cfg)
    faulty = linkfault.active(topo_full, cfg, train=True)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    start_ep, curve = 0, []
    if resume and ckpt_dir:
        state, curve, start_ep, _ = _try_resume(ckpt_dir, state, meter, gen)
    if mesh is not None:
        specs = scheme.state_shardings(cfg, state, mesh)
        state = sharding.shard_state(state, specs, mesh)
    n_eval = min(eval_n, n)
    ev, el = views[:, :n_eval], labels[:n_eval]

    for ep in range(start_ep, epochs):
        ep_views, ep_labels = epoch_batches(views, labels, ep, rounds, bpr,
                                             batch_size)
        keys = ([linkfault.round_key(seed, ep * rounds + r)
                 for r in range(rounds)] if faulty else None)
        if dispatch == "scan":
            if rounds:
                state, _ = epoch_fn(state, ep_views, ep_labels, gen,
                                    round_keys=keys)
        else:
            for r in range(rounds):
                state, _ = round_fn(state, ep_views[r], ep_labels[r], gen,
                                    round_key=None if keys is None
                                    else keys[r])
        if faulty:
            _meter_fault_rounds(meter, scheme, topo_full, cfg, batch_size,
                                charges, keys)
        else:
            for _ in range(rounds):
                _meter_rounds(meter, charges)
        full = state if mesh is None else \
            sharding.gather_state(state, specs, mesh)
        _meter_overheads(meter, scheme, cfg, full)
        acc = base.evaluate_accuracy(scheme, full, ev, el,
                                     topology=topology, cfg=cfg,
                                     device=device)
        curve.append(CurvePoint(ep + 1, acc, meter.gbits,
                                meter.measured_gbits, meter.delivered_gbits))
        if ckpt_dir and ((ep + 1) % max(ckpt_every, 1) == 0
                         or ep + 1 == epochs):
            if mesh is None:
                _save_epoch(ckpt_dir, scheme.name, ep + 1, full, curve,
                            meter, gen)
            else:
                # one writer: every rank holds the same gathered state,
                # curve, ledgers and generator
                mesh.barrier()
                if mesh.rank == 0:
                    _save_epoch(ckpt_dir, scheme.name, ep + 1, full, curve,
                                meter, gen)
                mesh.barrier()
    return curve


def epoch_batches(views, labels, ep, rounds, bpr, batch_size):
    """Epoch `ep`'s minibatches of the (J, n, ...) views and (n,) labels
    (tensors), gathered on their device in one go from the seeded batch
    indices: (K, bpr, J, B, ...) views and (K, bpr, B) labels, K =
    `rounds`."""
    batches = list(multiview.batch_indices(labels.shape[0], batch_size,
                                           seed=ep))
    idx = torch.as_tensor(
        np.array(batches[:rounds * bpr], dtype=np.int64).reshape(
            rounds, bpr, batch_size), device=views.device)
    return (views[:, idx].permute(1, 2, 0, *range(3, views.dim() + 2)),
            labels[idx])


def _run_transport(scheme, views, labels, cfg, *, epochs, batch_size, lr,
                   seed, eval_n, dispatch, wire, topology, transport,
                   ckpt_dir, ckpt_every, resume, device):
    """`run_scheme(transport=)`: each round's delivery is
    `transport.round_outcome(tick)`, handed to the scheme's transport round
    as its explicit (J,) mask (module docstring)."""
    state = scheme.init(cfg, torch.Generator(device=device).manual_seed(seed),
                        lr=lr, device=device)
    if dispatch == "scan":
        epoch_fn = scheme.make_transport_epoch(cfg, lr=lr, wire=wire,
                                               topology=topology)
    else:
        round_fn = scheme.make_transport_round(cfg, lr=lr, wire=wire,
                                               topology=topology)
    bpr = scheme.batches_per_round(cfg)
    views = torch.as_tensor(_host(views), dtype=torch.float32, device=device)
    labels = torch.as_tensor(_host(labels), device=device).long()
    n = labels.shape[0]
    meter = transport.meter
    charges = _round_charges(scheme, cfg, state, batch_size, wire=wire,
                             topology=topology)
    edges = transport.topo.edges
    if set(charges) == {None}:
        # scalar totals (FL/SL): split the round's charge equally across
        # the (star) edges so per-edge attempts re-offer their own share
        b, nb = charges[None]
        charges = {e.key: (b / len(edges), nb / len(edges)) for e in edges}
    rounds = rounds_per_epoch(scheme, cfg, n, batch_size)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    start_ep, curve, tsnap = 0, [], None
    if resume and ckpt_dir:
        state, curve, start_ep, tsnap = _try_resume(ckpt_dir, state, meter,
                                                    gen)
    tick = start_ep * rounds
    for t in range(tick):                 # breaker replay, ledger-free
        transport.round_outcome(t, batch_size, charges=charges, charge=False)
    if tsnap is not None:
        # the replay already rebuilt the adaptive knobs (observe runs on
        # uncharged rounds too); the sidecar's copy is authoritative
        transport.load_snapshot(tsnap)
    n_eval = min(eval_n, n)
    ev, el = views[:, :n_eval], labels[:n_eval]

    for ep in range(start_ep, epochs):
        ep_views, ep_labels = epoch_batches(views, labels, ep, rounds, bpr,
                                             batch_size)
        if dispatch == "scan":
            masks = [transport.round_outcome(tick + r, batch_size,
                                             charges=charges).mask
                     for r in range(rounds)]
            if rounds:
                state, _ = epoch_fn(state, ep_views, ep_labels, gen, masks)
        else:
            for r in range(rounds):
                rep = transport.round_outcome(tick + r, batch_size,
                                              charges=charges)
                state, _ = round_fn(state, ep_views[r], ep_labels[r], gen,
                                    rep.mask)
        tick += rounds
        _meter_overheads(meter, scheme, cfg, state)
        acc = base.evaluate_accuracy(scheme, state, ev, el,
                                     topology=topology, cfg=cfg,
                                     device=device)
        curve.append(CurvePoint(ep + 1, acc, meter.gbits,
                                meter.measured_gbits, meter.delivered_gbits))
        if ckpt_dir and ((ep + 1) % max(ckpt_every, 1) == 0
                         or ep + 1 == epochs):
            _save_epoch(ckpt_dir, scheme.name, ep + 1, state, curve, meter,
                        gen, transport=transport)
    return curve


def run_all(names: Sequence[str], views, labels, cfg, *, epochs: int,
            **kw) -> dict:
    """Curves for several registered schemes on the same data.  A
    caller-supplied `meter=` would accumulate every earlier scheme's
    traffic into the later curves, so it is refused for several schemes."""
    if kw.get("meter") is not None and len(names) > 1:
        raise ValueError("meter= accumulates across runs; pass it to "
                         "run_scheme per scheme (or run one scheme)")
    return {n: run_scheme(n, views, labels, cfg, epochs=epochs, **kw)
            for n in names}


def efficiency(curve: Sequence[CurvePoint]) -> float:
    """Final accuracy per Gbit exchanged (the paper's headline metric);
    0.0 for an empty curve."""
    if not curve:
        return 0.0
    last = curve[-1]
    return last.accuracy / max(last.gbits, 1e-9)
