"""Roofline analysis of the dry-run's counts, for H100 ranks.

Reference: src/repro/roofline/analysis.py (`Hardware`, `HW`,
`model_flops`, `roofline_terms`, `_SUGGESTIONS`, `analyze`).  Three terms
per (arch x shape x mesh), all in seconds:

    compute    = FLOPs      / (chips * PEAK_FLOPS)
    memory     = HBM bytes  / (chips * HBM_BW)
    collective = coll bytes / (chips * LINK_BW)

The constants are the NVIDIA H100 SXM's data-sheet figures (dense bf16,
HBM3, NVLink 4 each way, at its 700-W power limit), not the reference's
TPU v5e.  FLOPs and HBM bytes come from launch/dryrun.py, which counts a
step on `meta` tensors (`torch.utils.flop_counter.FlopCounterMode`) with
the reference's 1- and 2-period scan compensation.

The reference parses the collective bytes out of XLA's post-SPMD HLO
(`collective_bytes(hlo_text)`); torch produces no HLO, so
`collective_bytes` here counts a step's collectives from the sharding
rules (launch/sharding.py).  It is a MODEL of the traffic, not a
measurement: per rank, ring algorithms (an axis of n ranks moves (n-1)/n
of the gathered tensor in an all-gather, the same of the input in a
reduce-scatter, twice that in an all-reduce), summed over the fleet:

    all-gather      each parameter sharded over 'pod'/'data' (FSDP),
                    gathered for the forward and again for the backward
    reduce-scatter  that parameter's gradient (train)
    all-reduce      the (tokens, d_out) output of every row-parallel layer
                    sharded over 'model' (Megatron), forward and, in
                    train, backward; and a MoE layer's (T_loc, d) psum
                    over 'model' in expert parallelism (moe_impl "ep")

Not counted: the vocab-parallel embedding's and logits' collectives, the
data-parallel loss and metric reductions, and the aux pmeans (scalars).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

# ---------------------------------------------------------------------------
# Hardware constants: one NVIDIA H100 SXM (data sheet, dense, 700 W)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Hardware:
    name: str = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
    peak_flops: float = 989e12       # dense bf16 FLOP/s per chip
    hbm_bw: float = 3.35e12          # HBM3 bytes/s per chip
    link_bw: float = 450e9           # NVLink bytes/s per chip, each way
    hbm_bytes: float = 80e9          # capacity per chip


HW = Hardware()


# ---------------------------------------------------------------------------
# Analytic model FLOPs
# ---------------------------------------------------------------------------

def model_flops(cfg, shape_cfg) -> float:
    """6*N*D (train), 2*N*D (prefill), 2*N*B (decode); N = active params."""
    from repro_torch.models import zoo
    n_active = zoo.param_count(cfg, active_only=True)
    if shape_cfg.mode == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n_active * tokens
    if shape_cfg.mode == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape_cfg.global_batch      # decode: 1 token/seq


# ---------------------------------------------------------------------------
# Collective bytes of a step, from the sharding rules (a model)
# ---------------------------------------------------------------------------

_KINDS = ("all-gather", "reduce-scatter", "all-reduce")


def _ring(n: int) -> float:
    return (n - 1) / n if n > 1 else 0.0


def collective_bytes(params, cfg, shape_cfg, mesh) -> Dict[str, float]:
    """{"all-gather", "reduce-scatter", "all-reduce", "total"}: the bytes a
    step moves over the whole fleet (the sum over ranks), modelled from
    the sharding rules as the module docstring says.  `params` is the
    parameter tree (meta tensors or (shape, dtype) pairs)."""
    from repro_torch.launch import sharding
    from repro_torch.models import transformer, zoo
    out = {k: 0.0 for k in _KINDS}
    chips = int(np.prod(list(mesh.shape.values())))
    train = shape_cfg.mode == "train"
    dp = sharding._dp(mesh)
    msize = sharding._axis_size(mesh, "model")
    act_bytes = zoo.model_dtype(cfg).itemsize
    b = shape_cfg.global_batch
    s = 1 if shape_cfg.mode == "decode" else shape_cfg.seq_len
    # a rank's tokens: the batch (or, at batch 1, the sequence) split over
    # the batch axes as batch_spec splits it
    n_dp = int(np.prod([sharding._axis_size(mesh, a) for a in dp]))
    split = n_dp > 1 and (b % n_dp == 0 or s % n_dp == 0)
    local_tokens = b * s // n_dp if split else b * s

    def one(path, leaf):
        shape = sharding._shape(leaf)
        spec = sharding.param_spec(path, leaf, mesh)
        nbytes = float(np.prod(shape, dtype=np.float64)) \
            * sharding._dtype(leaf).itemsize
        data_n, other_n = 1, 1
        for entry in spec:
            for a in (() if entry is None else
                      entry if isinstance(entry, tuple) else (entry,)):
                if a in ("pod", "data"):
                    data_n *= mesh.shape[a]
                else:
                    other_n *= mesh.shape[a]
        gathered = nbytes / other_n           # a rank's leaf after the gather
        if data_n > 1:
            out["all-gather"] += (2 if train else 1) * _ring(data_n) \
                * gathered * chips
            if train:
                out["reduce-scatter"] += _ring(data_n) * gathered * chips
        names = sharding._path_names(path)
        owner = names[-2] if names and names[-1] == "w" and len(names) > 1 \
            else (names[-1] if names else "")
        is_expert = "moe" in names[:-1] and names[-1] in ("wi", "wg", "wo")
        if owner in sharding._ROW and not is_expert and len(shape) >= 2 \
                and spec[len(shape) - 2] == "model":
            layers = int(np.prod(shape[:-2], dtype=np.int64))
            act = local_tokens * shape[-1] * act_bytes
            out["all-reduce"] += (2 if train else 1) * layers \
                * 2 * _ring(msize) * act * chips

    sharding.map_with_path(one, params)
    if cfg.is_moe and cfg.moe_impl == "ep" and msize > 1 \
            and shape_cfg.mode != "decode":
        pat = transformer.block_pattern(cfg)
        n_moe = transformer.num_periods(cfg) * sum(k == "attn" for k in pat)
        act = local_tokens * cfg.d_model * act_bytes
        out["all-reduce"] += (2 if train else 1) * n_moe \
            * 2 * _ring(msize) * act * chips
    out["total"] = sum(out[k] for k in _KINDS)
    return out


# ---------------------------------------------------------------------------
# The three terms
# ---------------------------------------------------------------------------

def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, hw: Hardware = HW) -> Dict[str, float]:
    compute = flops / (chips * hw.peak_flops)
    memory = hbm_bytes / (chips * hw.hbm_bw)
    collective = coll_bytes / (chips * hw.link_bw)
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant}


_SUGGESTIONS = {
    "compute": ("shard the replicated attention heads (sequence/context "
                "parallelism) or cut recompute from remat to reduce the "
                "counted FLOPs toward the 6ND model floor"),
    "memory": ("reduce activation residency and traffic: hand-written "
               "backward kernels instead of the plain fp32 backwards, "
               "fused elementwise passes, bf16 intermediates, or larger "
               "microbatches to raise arithmetic intensity"),
    "collective": ("overlap or restructure collectives: the expert-parallel "
                   "dispatch (moe_impl 'ep'), reduce-scatter + all-gather "
                   "(ZeRO) instead of all-reduce, INL-style bottleneck "
                   "compression of cross-boundary activations"),
}


def analyze(record: dict, cfg, shape_cfg, chips: int,
            hw: Hardware = HW) -> dict:
    """record: {'flops', 'hbm_bytes', 'coll_bytes'} (scan-compensated)."""
    terms = roofline_terms(record["flops"], record["hbm_bytes"],
                           record["coll_bytes"], chips, hw)
    mf = model_flops(cfg, shape_cfg)
    terms["model_flops"] = mf
    terms["counted_flops"] = record["flops"]
    terms["useful_flop_ratio"] = mf / record["flops"] if record["flops"] \
        else 0.0
    terms["suggestion"] = _SUGGESTIONS[terms["dominant"]]
    terms["hardware"] = hw.name
    return terms
