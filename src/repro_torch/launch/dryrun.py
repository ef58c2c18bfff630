"""Pod-scale dry-run without a compiler: every (architecture x input shape
x mesh) run on `meta` tensors, its per-rank bytes under the sharding rules
and its roofline terms for H100 ranks.

Reference: src/repro/launch/dryrun.py (`_variant`, `lower_step`,
`lower_inl_step`, `run_inl`, `run_one`, `main`), which lowers, SPMD-
partitions and compiles each combination for 512 placeholder XLA devices
and reads XLA's memory and cost analyses.  torch has no such lowering.
What this dry-run checks in its place, per combination:

  1. Shapes.  The step runs end to end on `meta` tensors, which carry
     shapes and dtypes and allocate nothing: the train step
     (`steps.make_train_step` with `default_optimizer`) on the params,
     the optimizer state and `zoo.input_specs`' batch; the prefill step
     on the params and the batch; the decode step on the params, one
     token and `zoo.cache_specs`' cache.  A combination that cannot be
     expressed raises, and its record is `status: fail` with the reason.
  2. Per-rank bytes.  What one rank holds of the step's arguments
     (params, optimizer state with ZeRO-1, batch, cache) under the rules
     of launch/sharding.py on the mesh, and `fits_hbm` against 80 GB.
     Activations and temporaries are NOT counted: XLA's `temp_bytes` has
     no counterpart without a compiler, so the record says so.
  3. FLOPs.  `torch.utils.flop_counter.FlopCounterMode` over the step at 1
     and 2 unrolled periods (the reference's cost-oracle variants: full
     sequence attention tiles and CE chunk, so every product is counted),
     compensated as fixed + n_periods * body;
     `useful_flop_ratio = model_flops / counted`.  The attention forward
     is counted as its plain version computes it, every (query, key)
     product with the mask applied after, as the reference's cost oracle
     counts it.  xLSTM runs one cell a step, which on meta takes
     milliseconds a cell, so for sequences past XLSTM_DIRECT_SEQ its
     counts are taken at two short lengths and extrapolated linearly
     (its FLOPs and bytes are linear in S); the record says so.
  4. HBM bytes.  Every op of the step reads its inputs and writes its
     outputs once (views move nothing), and each hand-written kernel
     (flash_attn_fwd, flash_attn_bwd, ssd_scan) counts its own inputs and
     outputs, not its plain version's intermediates (`counting` swaps
     kernels/ops' entries for counting versions while a step runs): the
     traffic of the port's eager step, unfused.  From the realistic 1- and
     2-period variants, compensated.
  5. Collective bytes, modelled from the sharding rules
     (roofline/analysis.collective_bytes), and the three roofline terms.

What it does NOT check: that a partitioner can realise the layout, the
collective schedule, any compilation, or activation memory.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh single --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree_leaves
from repro_torch.configs.base import (INPUT_SHAPES, arch_for_shape,
                                      get_config, get_smoke_config,
                                      list_archs)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, steps
from repro_torch.models import transformer, zoo
from repro_torch.roofline import analysis as roofline

META = torch.device("meta")
XLSTM_DIRECT_SEQ = 16          # longer xLSTM sequences are extrapolated
XLSTM_SEQS = (8, 16)           # ... from these two lengths
ALLOC_GRANULE = 512            # the CUDA caching allocator's block rounding
# kernels/ops' entries, counted as kernels
KERNEL_ENTRIES = ("attention", "attention_bwd", "ssd_scan")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _leaf_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(
        tree if isinstance(tree, (tuple, list)) else [tree]))


class _ByteCounter(TorchDispatchMode):
    """The bytes of every non-view op's tensor inputs and outputs, except
    inside a function wrapped by `kernel`."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.inside = 0

    def kernel(self, fn):
        """fn (a hand-written kernel's entry), counted as the kernel: its
        positional tensor inputs and its outputs once, none of the ops its
        plain version runs."""
        def counted(*args, **kwargs):
            self.inside += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.inside -= 1
            self.bytes += _leaf_bytes(list(args)) + _leaf_bytes(out)
            return out
        return counted

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.inside and not func.is_view:
            flat = tree_leaves(list(args) + list((kwargs or {}).values()))
            self.bytes += sum(_nbytes(t) for t in flat) + _leaf_bytes(out)
        return out


@contextlib.contextmanager
def counting():
    """(FlopCounterMode, _ByteCounter), both active; while they are,
    kernels/ops' entries of the hand-written kernels a step reaches
    (KERNEL_ENTRIES) are swapped for `_ByteCounter.kernel` versions, so
    each counts as the kernel's own inputs and outputs.  Not thread-safe:
    the swap is of module attributes."""
    counter = _ByteCounter()
    saved = {name: getattr(ops, name) for name in KERNEL_ENTRIES}
    for name, fn in saved.items():
        setattr(ops, name, counter.kernel(fn))
    try:
        with FlopCounterMode(display=False) as flops, counter:
            yield flops, counter
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _variant(cfg, periods: int, *, cost_oracle: bool = False):
    """The model unrolled to `periods` periods (scan_layers off, so no
    remat, as the reference's variants); cost_oracle=True also makes the
    attention backward's tiles and the CE chunk the whole sequence."""
    big = 1 << 30
    kw = dict(attn_block_q=big, attn_block_k=big, ce_chunk=big) \
        if cost_oracle else {}
    pat = transformer.block_pattern(cfg)
    return dataclasses.replace(
        cfg, num_layers=cfg.moe.first_dense_layers + periods * len(pat),
        scan_layers=False, **kw)


def _meta(specs):
    return {k: torch.empty(shape, dtype=dtype, device=META)
            for k, (shape, dtype) in specs.items()}


def step_arguments(cfg, shape):
    """The step's arguments on `meta`: (params, optimizer state or None,
    batch specs, cache or None)."""
    params = zoo.init_params(cfg, 0, device=META)
    opt_state = steps.default_optimizer(cfg).init(params) \
        if shape.mode == "train" else None
    cache = zoo.cache_specs(cfg, shape) if shape.mode == "decode" else None
    return params, opt_state, zoo.input_specs(cfg, shape), cache


def _step(cfg, shape, arguments=None):
    """(the step of (cfg, shape), its arguments on meta tensors), from
    `arguments` (step_arguments' tuple) when given."""
    params, opt_state, specs, cache = arguments or step_arguments(cfg, shape)
    batch = _meta(specs)
    if shape.mode == "train":
        return (steps.make_train_step(cfg, steps.default_optimizer(cfg)),
                (params, opt_state, batch))
    if shape.mode == "prefill":
        return steps.make_prefill_step(cfg), (params, batch)
    return steps.make_decode_step(cfg), (params, batch, cache)


def run_step(cfg, shape):
    """The step of (cfg, shape) once on meta tensors."""
    fn, args = _step(cfg, shape)
    return fn(*args)


def count(cfg, shape, arguments=None):
    """(FLOPs, HBM bytes) of one step of (cfg, shape) on meta tensors (the
    arguments are made outside the count)."""
    fn, args = _step(cfg, shape, arguments)
    with counting() as (flops, bytes_mode):
        fn(*args)
    return float(flops.get_total_flops()), float(bytes_mode.bytes)


def _recurrent(cfg) -> bool:
    return any(k in ("mlstm", "slstm") for k in transformer.block_pattern(cfg))


def _seq_points(cfg, shape):
    """The shapes counted for (cfg, shape): itself, or two short lengths
    for an xLSTM sequence past XLSTM_DIRECT_SEQ."""
    if shape.mode == "decode" or not _recurrent(cfg) \
            or shape.seq_len <= XLSTM_DIRECT_SEQ:
        return [shape]
    return [dataclasses.replace(shape, seq_len=s) for s in XLSTM_SEQS]


def _count_at(cfg, shape, arguments=None):
    """count(), extrapolated linearly in S from _seq_points."""
    pts = _seq_points(cfg, shape)
    if len(pts) == 1:
        return count(cfg, shape, arguments)
    (s1, s2) = (p.seq_len for p in pts)
    (f1, b1), (f2, b2) = (count(cfg, p) for p in pts)
    at = shape.seq_len
    return (f1 + (at - s1) * (f2 - f1) / (s2 - s1),
            b1 + (at - s1) * (b2 - b1) / (s2 - s1))


def argument_bytes(cfg, shape, mesh, arguments=None):
    """{params, opt_state, batch, cache} bytes one rank holds under the
    rules, and the same rounded leaf by leaf to the CUDA caching
    allocator's 512-byte blocks (what `memory_allocated` reports)."""
    params, opt_state, specs, cache = arguments or step_arguments(cfg,
                                                                  shape)
    p_specs = sharding.param_shardings(params, mesh)
    parts = {"params": (params, p_specs),
             "batch": (specs, sharding.batch_shardings(specs, mesh))}
    if opt_state is not None:
        parts["opt_state"] = (opt_state, sharding.opt_state_shardings(
            opt_state, p_specs, mesh))
    if cache is not None:
        parts["cache"] = (cache, sharding.cache_shardings(cache, mesh))
    exact, allocated = {}, {}
    for name, (tree, spec_tree) in parts.items():
        sizes = sharding.leaf_shard_bytes(tree, spec_tree, mesh)
        exact[name] = sum(sizes)
        allocated[name] = sum(-(-n // ALLOC_GRANULE) * ALLOC_GRANULE
                              for n in sizes)
    return exact, allocated


def run_record(arch, cfg, shape, mesh, mesh_name, *,
               with_compensation: bool = True) -> dict:
    """The dry-run record of one (arch, shape, mesh); raises where the
    combination cannot be expressed."""
    chips = int(np.prod(list(mesh.shape.values())))
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "mesh_shape": dict(mesh.shape), "chips": chips, "status": "ok"}
    t0 = time.time()

    # ---- 1. the whole model's step on meta (without compensation, or
    # for decode, the counting run below is that step)
    compensate = with_compensation and shape.mode != "decode"
    check_shape = _seq_points(cfg, shape)[-1]
    if check_shape is not shape:
        rec["shape_check_seq_len"] = check_shape.seq_len
    if compensate:
        run_step(cfg, check_shape)

    # ---- 2. per-rank bytes
    arguments = step_arguments(cfg, shape)
    exact, allocated = argument_bytes(cfg, shape, mesh, arguments)
    per_device = sum(exact.values())
    rec["memory"] = {
        **{f"{k}_bytes": v for k, v in exact.items()},
        "argument_bytes": per_device,
        "argument_bytes_allocated": sum(allocated.values()),
        "per_device_bytes": per_device,
        "fits_hbm": bool(per_device <= roofline.HW.hbm_bytes),
        "not_counted": "activations and temporaries (no compiler: XLA's "
                       "temp_bytes has no counterpart)"}

    # ---- 3-4. FLOPs and bytes, scan-compensated
    nper = transformer.num_periods(cfg)
    if compensate:
        f1, _ = _count_at(_variant(cfg, 1, cost_oracle=True), shape)
        f2, _ = _count_at(_variant(cfg, 2, cost_oracle=True), shape)
        _, b1 = _count_at(_variant(cfg, 1), shape)
        _, b2 = _count_at(_variant(cfg, 2), shape)

        def comp(a, b):
            return a + (nper - 1) * max(b - a, 0.0)
        flops, hbm = comp(f1, f2), comp(b1, b2)
        rec["compensation"] = {"periods": nper, "flops_1_2": [f1, f2],
                               "hbm_bytes_1_2": [b1, b2]}
    else:
        flops, hbm = _count_at(cfg, shape, arguments)
    if len(_seq_points(cfg, shape)) > 1:
        rec["seq_extrapolated"] = {"from": list(XLSTM_SEQS),
                                   "to": shape.seq_len}

    # ---- 5. collectives and the roofline
    coll = roofline.collective_bytes(arguments[0], cfg, shape, mesh)
    rec["cost"] = {"flops": flops, "hbm_bytes": hbm,
                   "coll_bytes": coll["total"],
                   "coll_by_kind": {k: v for k, v in coll.items()
                                    if k != "total"},
                   "coll_is_model": True}
    rec["roofline"] = roofline.analyze(
        {"flops": flops, "hbm_bytes": hbm, "coll_bytes": coll["total"]},
        cfg, shape, chips)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def _config(arch: str, smoke: bool):
    return get_smoke_config(arch) if smoke else get_config(arch)


def run_one(arch: str, shape_name: str, mesh_name: str, *,
            with_compensation: bool = True, smoke: bool = False) -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(_config(arch, smoke), shape)
    mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_name == "multi"))
    return run_record(arch, cfg, shape, mesh, mesh_name,
                      with_compensation=with_compensation)


def run_inl(arch: str, shape_name: str = "train_4k", *,
            link_bits: int = 16, smoke: bool = False) -> dict:
    """INL-mode record for one arch (client mesh, single pod): the INL
    train step on meta, its per-rank bytes with the encoders' J axis on
    'client' where the rules put it, and its FLOPs."""
    from repro_torch import optim
    from repro_torch.core import inl_llm
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(_config(arch, smoke), shape)
    cfg = dataclasses.replace(
        cfg, inl=dataclasses.replace(cfg.inl, link_bits=link_bits))
    mesh = mesh_lib.make_inl_mesh(cfg.inl.num_nodes)
    chips = int(np.prod(list(mesh.shape.values())))
    t0 = time.time()
    params = inl_llm.init(cfg, 0, device=META)
    opt = optim.adamw(1e-4)
    opt_state = opt.init(params)
    specs = inl_llm.input_specs(cfg, shape)
    step = steps.make_inl_train_step(cfg, opt)
    # the step's draws as meta tensors (a generator would draw on its host)
    J, (B, S) = cfg.inl.num_nodes, specs["tokens"][0]
    draws = _meta({"noise": ((J, B, S, cfg.d_model), torch.float32),
                   "eps": ((J, B, S, cfg.inl.d_bottleneck), torch.float32)})
    with counting() as (flops, bytes_mode):
        step(params, opt_state, _meta(specs), **draws)
    p_specs = sharding.param_shardings(params, mesh, client_axis=True)
    per_device = sum(sharding.leaf_shard_bytes(params, p_specs, mesh)) \
        + sum(sharding.leaf_shard_bytes(opt_state, sharding.
                                        opt_state_shardings(
                                            opt_state, p_specs, mesh),
                                        mesh)) \
        + sum(sharding.leaf_shard_bytes(
            specs, sharding.batch_shardings(specs, mesh), mesh))
    return {"arch": arch, "shape": shape_name, "mesh": "inl-single",
            "mesh_shape": dict(mesh.shape), "link_bits": link_bits,
            "chips": chips, "status": "ok",
            "total_s": round(time.time() - t0, 2),
            "memory": {"per_device_bytes": per_device,
                       "not_counted": "activations and temporaries"},
            "cost": {"flops": float(flops.get_total_flops()),
                     "hbm_bytes": float(bytes_mode.bytes)}}


def _fail(rec: dict, e: Exception) -> dict:
    return {**rec, "status": "fail", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-compensation", action="store_true")
    ap.add_argument("--inl", action="store_true",
                    help="the paper-mode (INL) train step instead "
                         "(client mesh; train_4k; link_bits 16 and 8)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs (CPU test size) at the same "
                         "input shapes")
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    os.makedirs(args.out, exist_ok=True)
    failures = 0

    if args.inl:
        for arch in archs:
            for bits in (16, 8):
                tag = f"{arch}_inl_train_4k_b{bits}"
                try:
                    rec = run_inl(arch, link_bits=bits, smoke=args.smoke)
                    print(f"[ok] {tag}: mem/dev="
                          f"{rec['memory']['per_device_bytes'] / 1e9:.1f}GB "
                          f"flops={rec['cost']['flops']:.3e}", flush=True)
                except Exception as e:  # noqa: BLE001 — report, continue
                    failures += 1
                    rec = _fail({"arch": arch, "link_bits": bits}, e)
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
                with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
                    json.dump(rec, f, indent=2)
        raise SystemExit(1 if failures else 0)

    shapes = list(INPUT_SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}_{shape_name}_{mesh_name}"
                try:
                    rec = run_one(arch, shape_name, mesh_name,
                                  with_compensation=not args.no_compensation,
                                  smoke=args.smoke)
                    r = rec["roofline"]
                    mem_gb = rec["memory"]["per_device_bytes"] / 1e9
                    print(f"[ok] {tag}: {rec['total_s']}s "
                          f"mem/dev={mem_gb:.2f}GB "
                          f"fits={rec['memory']['fits_hbm']} "
                          f"compute={r['compute_s']:.3e}s "
                          f"memory={r['memory_s']:.3e}s "
                          f"coll={r['collective_s']:.3e}s "
                          f"dominant={r['dominant']} "
                          f"useful={r['useful_flop_ratio']:.3f} "
                          f"[{roofline.HW.name}]", flush=True)
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures += 1
                    rec = _fail({"arch": arch, "shape": shape_name,
                                 "mesh": mesh_name}, e)
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
                with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
                    json.dump(rec, f, indent=2)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
