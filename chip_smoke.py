#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --decode-times

Phases, each checked; any failed check exits non-zero before the last line:

  1. device   the card's name, capability (9, 0), name and power limit
              from nvidia-smi; TF32 switched off for fp32 matmuls and convs.
  2. build    every kernel of repro_torch/kernels/csrc/ compiled by nvcc for
              sm_90a from the checkout's sources, one nvcc each, together;
              ptxas's register and spill report of each; the HMMA
              (tensor-core) instructions in the SASS of flash_attn_fwd and
              ssd_scan counted (cuobjdump -sass), none failing the run.
  3. kernels  each kernel against its plain PyTorch version on the same CUDA
              tensors, over shapes (5, 64, 64), (5, 7, 64) (ragged) and
              (5, 4096, 96), link widths {1, 2, 4, 8, 16, 32} and fp32/bf16
              latents.  Rows with an entry whose pre-quantization value lies
              within 1e-6 of a rounding midpoint may differ at b < 32 in the
              sample mode; they are counted.
                cut_fwd        modes {sample, analytic, none}: u identical,
                               the rate within rtol 1e-5, atol 1e-5;
                cut_bwd        the three modes: dmu, dlv, deps within
                               rtol 1e-5, atol 1e-6;
                cut_prior_fwd  modes {sample, analytic}, shared (d,) and
                  cut_prior_bwd  per-node (J, d) priors: u identical, the
                               per-row gradients within rtol 1e-5 atol 1e-6
                               (both read one saved u, so on every row),
                               and two launches of cut_prior_bwd identical
                               bit for bit.  The sums — the rate, dpmu,
                               dplv — within rtol/atol 1e-5, or, where
                               their terms cancel, within 1e-5 of the sum
                               of the terms' absolute values (fp32 sums in
                               two orders; such sums are counted); dpmu and
                               dplv equal bit for bit to the plain sums in
                               the kernel's order
                               (ref.cutlayer_prior_bwd_sums_ordered).  Then
                               cut_prior_bwd on J in {1, 5} nodes of T in
                               {1, 65, 4097} rows (its 8-row chunks and
                               ~264-block grid), d in {64, 37}: the same
                               checks, three launches and two replays of
                               one CUDA-graph capture identical;
              and torch.autograd.grad through ops.cutlayer on CUDA equal to
              the kernels' outputs for the same cotangents.  The packed
              wire's kernels over the same shapes, widths
              b in {1, 2, 3, 4, 8, 16} and fp32/bf16:
                cut_fwd_pack   modes {sample, analytic, none}: (u, rate)
                               identical to cut_fwd's, u and the lanes
                               identical to the plain version's (rows at a
                               rounding midpoint excepted and counted);
                pack           the lanes of u identical to cut_fwd_pack's
                               and the plain version's (bf16 at b <= 8; at
                               b > 8 pack_values must refuse bf16);
                unpack_dequant unpack(lanes) == u bit for bit, and equal to
                               the plain version; then at every b in 1..16,
                               d in {7, 33, 64, 100}, R in {1, 7, 257}, fp32
                               and bf16, on lanes one row into their
                               allocation: equal to the plain version bit
                               for bit, unpack(pack(u)) == u (fp32; bf16 at
                               b <= 8);
                pack           then at every b in 1..16, d in {7, 33, 64,
                               100}, R in {1, 7, 257}, fp32 and bf16 (b <=
                               8), on values one row into their allocation,
                               off-grid (past the clip range, a quarter at
                               rounding midpoints) and on the grid: the
                               lanes equal the plain version's bit for bit,
                               unpack(pack(u)) == u on the grid.
  4. serving  INLScheme at PaperExperimentConfig() (the paper's full width)
              on the card from a seeded generator, a ServingEngine over
              buckets (1, 4, 16, 64) answering requests through its
              scheduler thread.  Launch counts are set to 0 just before and
              read just after; the cut kernel must have launched exactly once
              per engine launch.  Answers must be finite rows summing to 1,
              equal bit for bit to the port's predict on the card in the same
              bucket, within atol 1e-4 of the port on the CPU, and fully
              delivered on the meter.
  5. training the main path: run_scheme("inl") at PaperExperimentConfig(),
              batch 64, 1024 synthetic samples, 2 epochs (32 train steps, two
              evaluations), launch counts set to 0 just before and read just
              after.  Every loss finite; the mean loss of the last 4 rounds
              below the first 4's; final accuracy >= 0.3; gbits equal to
              32 x training_step_bits(64, 320, 32) / 1e9 exactly; cut_bwd
              launched once per step, cut_fwd once per step plus once per
              evaluation, the prior kernels never.  Then 8 steps with
              learned_prior=True: each prior kernel once per step, cut_fwd
              and cut_bwd never, and the priors moved from zero.
  5b. packed the packed wire at PaperExperimentConfig(link_bits=8), batch
              64, each path with launch counts set to 0 just before and read
              just after: run_scheme("inl", wire="packed") (cut_fwd_pack,
              unpack_dequant and cut_bwd once per step, cut_fwd once per
              evaluation, pack never); one packed step equal to one dense
              step bit for bit (loss and every gradient leaf, under
              torch.use_deterministic_algorithms); wire="packed_duplex";
              learned_prior=True on "packed" (the prior kernels, pack and
              unpack_dequant once per step); run_scheme("sl",
              wire="packed") (cut_fwd, pack, unpack_dequant and cut_bwd
              once per step, cut_fwd once more per evaluation); and
              run_scheme("fl") rounds (cut_fwd and cut_bwd once per local
              step).  Every loss finite and falling; the measured bytes
              exactly 320 x 16 x 4 forward + 320 x 64 x 4 backward per
              packed round and 2 x 320 x 16 x 4 per duplex round (the
              closed form's 2 x 64 x 320 x 8 bits).
  6. cpu      card against CPU: one set of weights, eps and dropout masks
              drawn on the CPU and moved to the card, 3 steps on each.  Step
              1's loss within rtol 1e-3, atol 1e-5, and every gradient leaf
              as a tensor: |card - cpu| <= 1e-3 |cpu| + 1e-5 sqrt(n) in the
              2-norm (entries outside the entrywise bar are counted); the
              losses of steps 2-3 within rtol 1e-3.
  6b. topology non-star graphs at full width, batch 64, each through
              run_scheme("inl", topology=...) for 16 steps with launch counts
              set to 0 just before and read just after: chain(5) at
              link_bits=8 on "packed" and "packed_duplex" (cut_fwd and
              cut_bwd once per step, pack and unpack_dequant 5 times a step,
              once per edge), tree(2, 2) dense with six views, and
              chain(5, link_bits=(2, 4, 8, 8, 32)) dense (cut_fwd and cut_bwd
              once per first-hop width group, 4 a step); cut_fwd once more
              per group for the evaluation.  Losses finite and falling, the
              meter's per-edge bits and bytes steps x the closed forms and
              wirefmt sizes (measured == closed form on duplex and fp32
              links).  One step on the packed chain(5) == the dense chain(5)
              == the star bit for bit; step 1 of the packed chain(5) and of
              tree(2, 2) against the CPU port as in phase 6; chain(5) served
              on the packed wire over buckets (1, 4, 16, 64): one cut_fwd and
              5 pack and unpack_dequant an engine launch, rows bit for bit
              equal to predict on the card in their bucket.
  6c. linkfault unreliable links (core/linkfault) at full width, batch 64:
              LinkModel() on every edge against no link model, 4 INL steps
              on the star, one FL round and 4 steps on the packed chain(5),
              deterministic algorithms on: losses and every state leaf bit
              for bit.  Then through run_scheme, launch counts set to 0 just
              before each run and read just after, at the reference's
              headline settings (benchmarks/links_bench.py: erasure 0.3 an
              edge, INL with edge_dropout 0.2): INL on the star (16 steps),
              with learned priors (8), at link_bits=8 packed (16), the
              packed chain(5) at erasure 0.1 an edge (16), FL (4 rounds) and
              SL (16 rounds, the first seed with a skipped round): every
              kernel launched as on the clean network (one cut_fwd and one
              cut_bwd a lossy INL step, five pack and five unpack_dequant a
              lossy packed chain(5) step), the meter's delivery ratio equal
              to the ratio the replayed masks imply, SL's skipped rounds
              leaving the state as it was and every other round moving it.
              One lossy step (an explicit mask, two views lost) on the card
              against the CPU port as in phase 6.  The star with
              LinkModel(latency_ms=1, jitter_ms=1) and deadline_ms=2 served
              over buckets (1, 4, 16, 64): one cut_fwd an engine launch,
              about e^-1 of the views missed (5 sigma), each request's mask
              the same in its bucket as alone, rows equal to predict_batched
              under the id-keyed masks bit for bit in their bucket, the
              meter's delivery ratio the masks' fraction.
  6d. hybrids the hybrid schemes at full width, batch 64
              (`hybrids:` lines): run_scheme("splitfed") and
              run_scheme("hybrid") (hybrid_fl_clients=(0,)) for 16 rounds
              on the dense star, with cut_depth=1, at link_bits=4 on
              "packed_duplex" and on the packed chain(5) at link_bits=8,
              launch counts set to 0 just before each and read just after:
              the loss falls, the launches as predicted (the dense star 17
              cut_fwd and 16 cut_bwd, the duplex star 16 cut_fwd_pack,
              unpack_dequant and cut_bwd, the chain 80 pack and
              unpack_dequant), the meter's per-edge bits and bytes 16 x the
              closed form from the shapes and, on the star, 16 x the
              reference's ledgers.  LinkModel() on every edge == no link
              model for 4 rounds of each, bit for bit; erasure 0.3 an edge
              for 16 rounds: the launches as clean, the delivery ratio the
              replayed masks' payload fraction, SplitFed's survivors one
              average bit for bit and a dead client not that average, the
              hybrid's weight client 0 keeping its rows bit for bit exactly
              when its route died.  One round of each, card against the CPU
              port at the phase-6 bar.  Each trained state served over
              buckets (1, 4, 16, 64), clean and at erasure 0.3: one cut_fwd
              an engine launch, rows == predict_batched bit for bit in
              their bucket.
  6e. graphs  CUDA graphs (repro_torch/graphs.py), deterministic
              algorithms on (`graphs:` lines): run_scheme under "scan"
              (the default: one captured round replayed per round) and
              under "per_round" from one seed (GRAPH_SEED), one epoch of
              16 rounds at batch 64 each, for inl, inl with learned
              priors, sl, fl, splitfed and hybrid on the dense star, INL at
              link_bits=8 on "packed" and "packed_duplex" and on the packed
              chain(5), and each of the six at erasure 0.3 an edge, launch
              counts set to 0 just before each run and read just after:
              every round's loss and every leaf of the final state bit for
              bit, the same launches per kernel, the same curve and
              offered and delivered ledgers, and exactly one capture per
              host signature (SL's keep/skip, FL's all/none/partial n).
              The trained INL state served over buckets (1, 4, 16, 64),
              clean and at erasure 0.3, three batches a bucket after
              warmup(): trace_counts == {b: 1}, rows == the eager
              predict_batched bit for bit, one cut_fwd an engine launch.
              Phases 4-6d hook rounds, so they run "per_round"; their
              engines replay graphs too.
  7. times    per-bucket predict latency, train-step latency (median of 20
              steps, with the device busy time and idle share from the
              profiler, and the device time by kernel) on the dense,
              packed and duplex wires, on the packed chain(5), tree(2, 2)
              and the mixed-width chain, and on the lossy star beside the
              clean one (`linkfault times:`), one dense round of splitfed,
              hybrid, SL and FL beside INL's (`hybrids times:`), each of
              those five rounds and the predict per bucket graphed beside
              eager (`graphs times:`: wall, device time from CUDA events
              around back-to-back replays, idle share), and each
              kernel's device time beside its bound and its plain version
              (cut_prior_bwd, unpack_dequant and pack beside their first
              designs' times, with cut_prior_bwd's first two launches
              apart), with the card's name and power limit on every line.
  8. llm      the LLM stack, Zamba2-2.7B:
                llm kernels  flash_attn_fwd against its plain version over
                             (B, S, H, KV, Dh) in {(1,128,4,4,32),
                             (2,256,8,2,64), (1,256,8,1,64), (2,192,32,32,80)
                             (ragged), (1,512,2,2,128), (2,512,32,32,80),
                             (4,512,32,32,80) (the serving prefill's)},
                             causal, window {0, 100}, q_offset {0, 64} on a
                             q slice; ssd_scan (y and the final state) over
                             (B, S, H, P, N, chunk) in {(1,128,2,32,16,32),
                             (2,256,4,64,64,128), (1,192,2,16,8,64),
                             (2,512,80,64,64,256), (4,512,80,64,64,256)
                             (the serving prefill's)}; fp32 within 2e-5 and
                             bf16 within 2e-2 (absolute for attention,
                             relative to the plain max for the scan); the
                             scan's chunk 64 against chunk 128;
                llm serving  the full config in bf16 from a seeded
                             generator: prefill and two decode steps give
                             finite logits, and each kernel against its
                             plain version on the very inputs that prefill
                             gave it (9 attention and 54 scan calls, bf16,
                             the bars above); serve_batch for 4 requests x
                             prompt 512 x 32 tokens, launch counts set to 0
                             just before and read just after: exactly 9
                             flash_attn_fwd and 54 ssd_scan (one prefill;
                             decode launches neither), tokens in the
                             vocabulary, peak memory;
                llm graphs   B=4 after a prompt of 512, 32 tokens,
                             deterministic algorithms on: the decode loop
                             on the graphed step (steps.make_decode_step)
                             == the loop on the eager step from one
                             prefill, ids and every cache leaf bit for
                             bit, one capture (trace_log); serve_batch
                             gives the eager ids with one capture;
                llm fp32     one period (num_layers=6) at full width in
                             fp32, the adapter drawn N(0, 1/d_model) in
                             place of init's 1e-4 scale so the shared
                             attention moves the logits: the card against the CPU on one set of
                             weights, prefill 512 and 8 decode steps fed
                             the CPU's tokens within rtol/atol 1e-3, greedy
                             tokens equal where the CPU's top-2 margin
                             exceeds 1e-2 (closer calls counted); prefill of
                             256 against prefill of 255 + one decode step
                             within 1e-3;
                times        prefill latency at (4, 512) and (4, 2048) and
                             decode latency per token (eager, and graphed
                             beside it), with device busy time,
                             idle share and the prefill's time in the top
                             kernels and in the two hand-written ones (the
                             profiler); both kernels' device time at
                             (4, 512) and (4, 2048) beside the bound, the
                             plain version, the first (SIMT) kernels' times
                             from PERF.md, the scan's four launches by the
                             profiler and, for attention,
                             scaled_dot_product_attention (timed only).

The line before the last two is {"kernels": [...]} (the cut-layer kernels
of the hybrids' path with their counts per run, `launches_on_hybrids`,
and every cut-layer kernel's counts in the graphed runs,
`launches_on_graphs`),
the one before the last
nvidia-smi's name and power limit, and the last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.

With --kernel-times it runs phase 1, builds the cut-layer kernels and
prints only their device times (phase 7's kernel lines, each kernel a call
launches by name with its time), and no result line; with --decode-times
it builds the two LLM kernels and prints only Zamba2-2.7B's decode
latency per token (phase 8's `llm decode latency` and graphed decode
lines, seeded weights), and no result line.  Either times the checkout it
sits in: to compare two checkouts on one card, copy it into both and run
them in turns, one after another on the same card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEV = "cuda"                        # the card: every phase runs there
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
MIDPOINT_TOL = 1e-6
RATE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
PRIOR_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
CARD_CPU_TOL = dict(rtol=1e-3, atol=1e-5)
CPU_ATOL = 1e-4
BUCKETS = (1, 4, 16, 64)
N_REQUESTS = 256
SWEEP_SHAPES = ((5, 64, 64), (5, 7, 64), (5, 4096, 96))
SWEEP_BITS = (1, 2, 4, 8, 16, 32)
TRAIN_BATCH = 64
TRAIN_SAMPLES = 1024
TRAIN_EPOCHS = 2
PRIOR_STEPS = 8
PRIOR_GEOMETRY_T = (1, 65, 4097)    # rows a node: 8-row chunks, ~264 blocks
PACK_BITS = (1, 2, 3, 4, 8, 16)
WIRE_BITS = 8                       # the packed wire's width on the path
PACKED_SAMPLES = 1024               # 16 steps of 64 in one epoch
FL_ROUNDS = 4                       # each round: 5 clients x 2 local steps
GRAPH_SAMPLES = 1024                # 16 steps of 64 in one epoch
TREE_STDS = (0.4, 1.0, 2.0, 3.0, 4.0, 0.7)   # the reference's test_topology
HET_BITS = (2, 4, 8, 8, 32)         # chain(5)'s per-edge widths
PROFILE_TRIES = 3
BF16_FLOPS = 989e12                 # H100 SXM dense bf16 tensor cores
FP32_BAR, BF16_BAR = 2e-5, 2e-2     # the bars of tests/test_kernels.py
FLASH_CASES = ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 256, 8, 1, 64),
               (2, 192, 32, 32, 80), (1, 512, 2, 2, 128), (2, 512, 32, 32, 80),
               (4, 512, 32, 32, 80))
SSD_CASES = ((1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 64, 128),
             (1, 192, 2, 16, 8, 64), (2, 512, 80, 64, 64, 256),
             (4, 512, 80, 64, 64, 256))
LLM_B, LLM_PROMPT, LLM_GEN = 4, 512, 32    # Zamba2 serving: requests, tokens
LLM_CPU_TOL = dict(rtol=1e-3, atol=1e-3)
LLM_CPU_STEPS = 8
LLM_MARGIN = 1e-2                   # top-2 logit margin of a decided token
LLM_CONSIST_P = 255                 # P and P + 1 both prefill in one chunk
TENSOR_CORE_KERNELS = ("flash_attn_fwd", "ssd_scan")
# graph_ms of the first, SIMT (fp32 FMA) kernels at the bf16 shapes of
# llm_kernel_timing, (kernel, S) -> ms: the final chip_smoke.py run that
# measured them on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6)
SIMT_MS = {("flash_attn_fwd", 512): 0.4703, ("flash_attn_fwd", 2048): 5.0504,
           ("ssd_scan", 512): 0.6286, ("ssd_scan", 2048): 2.5219}
# device ms (profiler) of the first designs of the three redesigned
# kernels, at the shapes of new_kernel_timing / pack_kernel_timing,
# (kernel, R) -> ms: the final chip_smoke.py run that measured them on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6)
FIRST_DESIGN_MS = {("cut_prior_bwd", 320): 0.00982,
                   ("cut_prior_bwd", 20480): 0.03317,
                   ("cut_prior_bwd", 262144): 0.54090,
                   ("unpack_dequant", 320): 0.00182,
                   ("unpack_dequant", 20480): 0.00750,
                   ("unpack_dequant", 262144): 0.07647,
                   ("pack", 320): 0.00176,
                   ("pack", 20480): 0.00642,
                   ("pack", 262144): 0.06924}
# the first design of cut_prior_bwd ran two launches; (rows, reduce) device
# ms by kernel name, R -> ms: this script's --kernel-times run in a checkout
# of that design, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6)
FIRST_PRIOR_BWD_STAGES = {320: (0.00856, 0.00125),
                          20480: (0.02247, 0.01116),
                          262144: (0.23076, 0.31338)}
# the kernels redesigned after their first designs, and how
REDESIGNED = {"cut_prior_bwd": "one launch, parallel fixed-order reduction",
              "unpack_dequant": "one thread per lane word, vector stores",
              "pack": "one thread per lane word, vector loads"}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_phase(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    card = smi()
    print(f"device: {name} capability {cap} count "
          f"{torch.cuda.device_count()}")
    print(f"nvidia-smi: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    check(cap == (9, 0), f"capability {cap}, the kernels are built for "
                         "sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    return name, card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_phase(names=None):
    """Build every kernel (or `names`); with every kernel, count the LLM
    kernels' tensor-core instructions."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build_all(names)
    print(f"build: {sorted(seconds)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process "
          f"per source)")
    for name, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    if names is None:
        tensor_core_phase(build)


def tensor_core_phase(build):
    """The bf16 paths of the LLM kernels run on tensor cores: count the
    HMMA instructions in the SASS of their libraries (cuobjdump -sass),
    beside ptxas's spill report of each library."""
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    parts = []
    for name in TENSOR_CORE_KERNELS:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build._library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        hmma = sum("HMMA" in line for line in sass.splitlines())
        ldsm = sum("LDSM" in line for line in sass.splitlines())
        spills = sorted({line.split(",", 1)[1].strip()
                         for line in build.build_logs.get(name, "")
                         .splitlines() if "spill" in line})
        check(hmma > 0, f"{name}: no HMMA instruction in its SASS; its bf16 "
                        f"path does not run on tensor cores")
        parts.append(f"{name} {hmma} HMMA, {ldsm} LDSM (ptxas: "
                     f"{'; '.join(spills) or 'no report, built earlier'})")
    print("tensor cores: " + "; ".join(parts))


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def near_midpoint(pre64: np.ndarray, bits: int) -> np.ndarray:
    r = 4.0
    scale = ((1 << bits) - 1) / (2.0 * r)
    t = (np.clip(pre64, -r, r) + r) * scale
    return np.abs(t - np.floor(t) - 0.5) / scale < MIDPOINT_TOL


def cut_inputs(torch, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    mu = rng.normal(scale=2.0, size=shape).astype(np.float32)
    lv = rng.uniform(-3.0, 3.0, size=shape).astype(np.float32)
    eps = rng.normal(size=shape).astype(np.float32)
    return (torch.from_numpy(mu).cuda().to(dtype),
            torch.from_numpy(lv).cuda().to(dtype),
            torch.from_numpy(eps).cuda())


def kernel_phase(torch):
    from repro_torch.kernels import ops, ref
    worst = 0.0
    midpoints = 0
    n = 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in SWEEP_BITS:
            for mode in ("sample", "analytic", "none"):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps = cut_inputs(torch, shape, dtype, bits)
                    u, rate = ops.cutlayer(mu, lv, eps, link_bits=bits,
                                           rate_estimator=mode)
                    pu, prate = ref.cutlayer_fwd_ref(
                        mu.reshape(-1, d), lv.reshape(-1, d),
                        eps.reshape(-1, d), bits, mode)
                    torch.cuda.synchronize()
                    check(u.dtype == dtype and rate.dtype == torch.float32,
                          f"dtypes {u.dtype}, {rate.dtype}")
                    a = u.float().cpu().numpy().reshape(-1, d)
                    b = pu.float().cpu().numpy()
                    diff = a != b
                    bad_rows = np.zeros(a.shape[0], bool)
                    if diff.any():
                        check(bits < 32, f"u differs at b=32 ({mode}, "
                                         f"{dtype}, {shape})")
                        pre = (mu.double() + torch.exp(0.5 * lv.double())
                               * eps.double()).cpu().numpy().reshape(-1, d)
                        mid = near_midpoint(pre, bits)
                        check(not (diff & ~mid).any(),
                              f"{int((diff & ~mid).sum())} u entries differ "
                              f"away from a midpoint ({mode}, b={bits}, "
                              f"{dtype}, {shape})")
                        midpoints += int(diff.sum())
                        bad_rows = diff.any(axis=-1)
                    ra = rate.cpu().numpy().reshape(-1)[~bad_rows]
                    rb = prate.cpu().numpy()[~bad_rows]
                    check(np.allclose(ra, rb, **RATE_TOL),
                          f"rate differs ({mode}, b={bits}, {dtype}, "
                          f"{shape}): max {np.abs(ra - rb).max()}")
                    if ra.size:
                        worst = max(worst, float(np.abs(ra - rb).max()))
                    worst = max(worst, float(np.abs(a - b)[~diff].max()))
                    n += 1
    torch.cuda.synchronize()
    print(f"kernels: cut_fwd == plain on {n} cases (3 shapes x 6 widths x "
          f"3 modes x 2 dtypes); {midpoints} u entries at a rounding "
          f"midpoint; max |kernel - plain| {worst:.3g}")
    return worst


def grad_inputs(torch, shape, dtype, seed):
    """cut_inputs plus the cotangents: gu (shape) in `dtype`, grate
    (shape[:-1]) fp32 at the small scale of a training step's rate
    cotangent."""
    mu, lv, eps = cut_inputs(torch, shape, dtype, seed)
    rng = np.random.default_rng(seed + 7)
    gu = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    gr = rng.normal(scale=0.1, size=shape[:-1]).astype(np.float32)
    return mu, lv, eps, gu.cuda().to(dtype), torch.from_numpy(gr).cuda()


def prior_inputs(torch, J, d, seed):
    rng = np.random.default_rng(seed + 11)
    pm = rng.normal(scale=0.5, size=(J, d)).astype(np.float32)
    pv = rng.uniform(-1.0, 1.0, size=(J, d)).astype(np.float32)
    return torch.from_numpy(pm).cuda(), torch.from_numpy(pv).cuda()


def midpoint_rows(torch, mu, lv, eps, bits):
    """Rows (flattened leading axes) with an entry near a rounding
    midpoint; none at b = 32."""
    d = mu.shape[-1]
    if bits >= 32:
        return np.zeros(mu.numel() // d, bool)
    pre = (mu.double() + torch.exp(0.5 * lv.double()) * eps.double()) \
        .cpu().numpy().reshape(-1, d)
    return near_midpoint(pre, bits).any(axis=-1)


def compare_rows(got, want, tol, what):
    """Per-row comparison of (rows, d) outputs: returns (bool rows that
    fail `tol`, max |got - want| over the entries that pass)."""
    a = got.float().cpu().numpy().reshape(got.shape[0], -1)
    b = want.float().cpu().numpy().reshape(want.shape[0], -1)
    check(a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}")
    close = np.isclose(a, b, **tol)
    err = float(np.abs(a - b)[close].max()) if close.any() else 0.0
    return ~close.all(axis=-1), err


def allow_midpoints(bad, mid, mode, bits, what):
    """Failing rows are allowed only at rounding midpoints in the sample
    mode at b < 32; returns how many there were."""
    if bad.any():
        check(mode == "sample" and bits < 32 and not (bad & ~mid).any(),
              f"{what}: {int((bad & ~mid).sum())} rows differ away from a "
              f"rounding midpoint")
    return int(bad.sum())


def bwd_kernel_phase(torch):
    """cut_bwd against cutlayer_bwd_ref over the sweep."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst, midpoints, n = 0.0, 0, 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in SWEEP_BITS:
            for mode in ("sample", "analytic", "none"):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps, gu, gr = grad_inputs(torch, shape, dtype,
                                                      bits)
                    rows = [t.reshape(-1, d) for t in (mu, lv, eps, gu)]
                    k = inl_bottleneck.cut_bwd(*rows, gr.reshape(-1),
                                               bits=bits, mode=mode)
                    p = ref.cutlayer_bwd_ref(*rows, gr.reshape(-1), bits,
                                             mode)
                    torch.cuda.synchronize()
                    what = f"cut_bwd {mode} b={bits} {dtype} {shape}"
                    check([t.dtype for t in k] == [dtype, dtype,
                                                   torch.float32],
                          f"{what}: dtypes {[t.dtype for t in k]}")
                    bad = np.zeros(rows[0].shape[0], bool)
                    for a, b in zip(k, p):
                        rb, err = compare_rows(a, b, GRAD_TOL, what)
                        bad |= rb
                        worst = max(worst, err)
                    midpoints += allow_midpoints(
                        bad, midpoint_rows(torch, mu, lv, eps, bits), mode,
                        bits, what)
                    n += 1
    print(f"kernels: cut_bwd == plain on {n} cases (3 shapes x 6 widths x "
          f"3 modes x 2 dtypes, rtol 1e-5 atol 1e-6); {midpoints} rows at "
          f"a rounding midpoint; max |kernel - plain| {worst:.3g}")
    return worst


def sum_scales(torch, mu, lv, u, pm, pv, gr, mode):
    """Float64 sums of the absolute values of the terms that the prior
    kernels add up: per row for the rate, per (node, column) for dpmu and
    dplv.  A sum that cancels can lose its relative digits in fp32 however
    it is ordered; these scales say how far."""
    m, l, q = mu.double(), lv.double(), u.double()
    p, v = pm.double()[:, None, :], pv.double()[:, None, :]
    g = gr.double()[..., None].abs()
    if mode == "sample":
        rate = (q - p) ** 2 * torch.exp(-v) + v.abs() \
            + (q - m) ** 2 * torch.exp(-l) + l.abs()
        wq = (q - p) * torch.exp(-v)
        dpmu = (g * wq.abs()).sum(1)
        dplv = 0.5 * (g.sum(1) + (g * (wq * (q - p)).abs()).sum(1))
    else:
        rate = v.abs() + l.abs() + (torch.exp(l) + (m - p) ** 2) \
            * torch.exp(-v) + 1.0
        dm = (m - p) * torch.exp(-v)
        dpmu = (g * dm.abs()).sum(1)
        dplv = 0.5 * (g.sum(1) + (g * torch.exp(l - v)).sum(1)
                      + (g * (dm * (m - p)).abs()).sum(1))
    return 0.5 * rate.sum(-1), dpmu, dplv


def sums_close(got, want, scale, keep, what):
    """A sum agrees within rtol/atol 1e-5 of its value or, where its terms
    cancel, within 1e-5 of the sum of their absolute values.  Returns (how
    many entries needed the second bar, max |got - want|)."""
    a = got.double().cpu().numpy().ravel()[keep]
    b = want.double().cpu().numpy().ravel()[keep]
    sc = scale.cpu().numpy().ravel()[keep]
    diff = np.abs(a - b)
    plain = diff <= 1e-5 + 1e-5 * np.abs(b)
    scaled = diff <= 1e-5 * sc
    bad = ~(plain | scaled)
    check(not bad.any(),
          f"{what}: {int(bad.sum())} sums differ: max |diff| "
          f"{diff[bad].max() if bad.any() else 0}, value "
          f"{b[bad][:3] if bad.any() else ''}, scale "
          f"{sc[bad][:3] if bad.any() else ''}")
    return int((~plain).sum()), float(diff.max()) if diff.size else 0.0


def prior_kernel_phase(torch):
    """cut_prior_fwd / cut_prior_bwd against their plain versions over the
    sweep, shared and per-node priors; the backward twice, bit for bit."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst = {"cut_prior_fwd": 0.0, "cut_prior_bwd": 0.0}
    midpoints, cancelling, n = 0, 0, 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in SWEEP_BITS:
            for mode in ("sample", "analytic"):
                for prior in ("shared", "node"):
                    for dtype in (torch.float32, torch.bfloat16):
                        mu, lv, eps, gu, gr = grad_inputs(torch, shape,
                                                          dtype, bits)
                        J = 1 if prior == "shared" else shape[0]
                        mu, lv, eps, gu = (t.reshape(J, -1, d)
                                           for t in (mu, lv, eps, gu))
                        gr = gr.reshape(J, -1)
                        pm, pv = prior_inputs(torch, J, d, bits)
                        what = (f"prior {prior} {mode} b={bits} {dtype} "
                                f"{shape}")
                        u, rate = inl_bottleneck.cut_prior_fwd(
                            mu, lv, eps, pm, pv, bits=bits, mode=mode)
                        pu, prate = ref.cutlayer_prior_fwd_ref(
                            mu, lv, eps, pm, pv, bits, mode)
                        k1 = inl_bottleneck.cut_prior_bwd(
                            mu, lv, eps, pm, pv, u, gu, gr, mode=mode)
                        k2 = inl_bottleneck.cut_prior_bwd(
                            mu, lv, eps, pm, pv, u, gu, gr, mode=mode)
                        p = ref.cutlayer_prior_bwd_ref(
                            mu, lv, eps, pm, pv, u, gu, gr, bits, mode)
                        o = ref.cutlayer_prior_bwd_sums_ordered(
                            mu, lv, pm, pv, u, gr, mode)
                        torch.cuda.synchronize()
                        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
                              f"{what}: two launches of cut_prior_bwd "
                              f"differ")
                        check(torch.equal(k1[3], o[0])
                              and torch.equal(k1[4], o[1]),
                              f"{what}: dpmu, dplv differ from the ordered "
                              f"plain sums")
                        # forward: u identical but at midpoints; the rate
                        # on the rows whose u agrees
                        mid = midpoint_rows(torch, mu, lv, eps, bits)
                        R = mid.shape[0]
                        bad_u = (u != pu).reshape(R, d).any(-1).cpu().numpy()
                        midpoints += allow_midpoints(bad_u, mid, mode, bits,
                                                     what + " u")
                        s_rate, s_pmu, s_plv = sum_scales(
                            torch, mu, lv, u, pm, pv, gr, mode)
                        c, err = sums_close(rate, prate, s_rate, ~bad_u,
                                            what + " rate")
                        cancelling += c
                        worst["cut_prior_fwd"] = max(worst["cut_prior_fwd"],
                                                     err)
                        # backward: both read the same saved u, so every
                        # row must agree
                        for name, a, b in zip(("dmu", "dlv", "deps"), k1[:3],
                                              p[:3]):
                            rb, err = compare_rows(a.reshape(R, d),
                                                   b.reshape(R, d),
                                                   GRAD_TOL, what)
                            check(not rb.any(), f"{what}: {name} differs "
                                  f"on {int(rb.sum())} rows beyond rtol "
                                  f"1e-5 atol 1e-6")
                            worst["cut_prior_bwd"] = max(
                                worst["cut_prior_bwd"], err)
                        for name, a, b, sc in (("dpmu", k1[3], p[3], s_pmu),
                                               ("dplv", k1[4], p[4], s_plv)):
                            c, err = sums_close(a, b, sc, slice(None),
                                                f"{what} {name}")
                            cancelling += c
                            worst["cut_prior_bwd"] = max(
                                worst["cut_prior_bwd"], err)
                        n += 1
    print(f"kernels: cut_prior_fwd and cut_prior_bwd == plain on {n} cases "
          f"(3 shapes x 6 widths x 2 modes x shared/per-node x 2 dtypes); "
          f"cut_prior_bwd identical bit for bit over two launches, its "
          f"dpmu and dplv equal to the ordered plain sums bit for bit; "
          f"{midpoints} rows at a rounding midpoint; {cancelling} rate or "
          f"prior-gradient sums that cancel held to 1e-5 of the sum of "
          f"|terms|; max |kernel - plain| fwd {worst['cut_prior_fwd']:.3g} "
          f"bwd {worst['cut_prior_bwd']:.3g}")
    worst["cut_prior_bwd"] = max(worst["cut_prior_bwd"],
                                 prior_geometry_phase(torch))
    return worst


def prior_geometry_phase(torch):
    """cut_prior_bwd on rows that fill, straddle and overrun its 8-row
    chunks and its ~264-block grid (T in PRIOR_GEOMETRY_T, J in {1, 5}), at
    an even d (column pairs) and an odd one, fp32 and bf16, both modes:
    dpmu, dplv equal the ordered plain sums bit for bit, the per-row
    gradients the plain backward within rtol 1e-5, atol 1e-6; three
    launches identical; one CUDA-graph capture replayed twice identical to
    the eager call.  Returns the max |kernel - plain| of the row
    gradients."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst, n = 0.0, 0
    for J in (1, 5):
        for T in PRIOR_GEOMETRY_T:
            for d in (64, 37):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps, gu, gr = grad_inputs(torch, (J, T, d),
                                                      dtype, T + d)
                    pm, pv = prior_inputs(torch, J, d, T)
                    for mode in ("sample", "analytic"):
                        what = f"cut_prior_bwd J={J} T={T} d={d} {dtype} " \
                               f"{mode}"
                        u, _ = inl_bottleneck.cut_prior_fwd(
                            mu, lv, eps, pm, pv, bits=WIRE_BITS, mode=mode)

                        def call():
                            return inl_bottleneck.cut_prior_bwd(
                                mu, lv, eps, pm, pv, u, gu, gr, mode=mode)
                        runs = [call() for _ in range(3)]
                        graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(graph):
                            captured = call()
                        replays = []
                        for _ in range(2):
                            for t in captured:
                                t.fill_(float("nan"))
                            graph.replay()
                            replays.append([t.clone() for t in captured])
                        o = ref.cutlayer_prior_bwd_sums_ordered(
                            mu, lv, pm, pv, u, gr, mode)
                        p = ref.cutlayer_prior_bwd_ref(
                            mu, lv, eps, pm, pv, u, gu, gr, WIRE_BITS, mode)
                        torch.cuda.synchronize()
                        check(all(same_bits(a, b) for k in runs[1:] + replays
                                  for a, b in zip(runs[0], k)),
                              f"{what}: three launches and two graph "
                              f"replays are not identical")
                        check(same_bits(runs[0][3], o[0])
                              and same_bits(runs[0][4], o[1]),
                              f"{what}: dpmu, dplv differ from the ordered "
                              f"plain sums")
                        for name, a, b in zip(("dmu", "dlv", "deps"),
                                              runs[0][:3], p[:3]):
                            rb, err = compare_rows(a.reshape(J * T, d),
                                                   b.reshape(J * T, d),
                                                   GRAD_TOL, what)
                            check(not rb.any(), f"{what}: {name} differs "
                                  f"on {int(rb.sum())} rows")
                            worst = max(worst, err)
                        del graph
                        n += 1
    print(f"kernels: cut_prior_bwd geometry on {n} cases (J in {{1, 5}} x "
          f"T in {PRIOR_GEOMETRY_T} x d in {{64, 37}} x 2 dtypes x 2 "
          f"modes): dpmu, dplv == ordered plain sums bit for bit, three "
          f"launches and two CUDA-graph replays identical; max |kernel - "
          f"plain| of the row gradients {worst:.3g}")
    return worst


def autograd_phase(torch):
    """torch.autograd.grad through ops.cutlayer on CUDA == the kernels'
    outputs for the same cotangents, with and without a learned prior."""
    from repro_torch.kernels import inl_bottleneck, ops
    shape, d = (5, 64, 64), 64
    for mode, bits in (("sample", 8), ("sample", 32), ("analytic", 4),
                       ("none", 2)):
        mu, lv, eps, gu, gr = grad_inputs(torch, shape, torch.float32, bits)
        ins = [t.clone().requires_grad_() for t in (mu, lv)]
        u, rate = ops.cutlayer(*ins, eps, link_bits=bits,
                               rate_estimator=mode)
        got = torch.autograd.grad((u, rate), ins, (gu, gr))
        want = inl_bottleneck.cut_bwd(mu.reshape(-1, d), lv.reshape(-1, d),
                                      eps.reshape(-1, d), gu.reshape(-1, d),
                                      gr.reshape(-1), bits=bits, mode=mode)
        check(all(torch.equal(a.reshape(-1, d), b)
                  for a, b in zip(got, want)),
              f"autograd through ops.cutlayer != cut_bwd ({mode}, b={bits})")
        if mode == "none":
            continue
        pm, pv = prior_inputs(torch, shape[0], d, bits)
        ins = [t.clone().requires_grad_() for t in (mu, lv, pm, pv)]
        u, rate = ops.cutlayer(ins[0], ins[1], eps, link_bits=bits,
                               rate_estimator=mode, prior_mu=ins[2],
                               prior_logvar=ins[3])
        got = torch.autograd.grad((u, rate), ins, (gu, gr))
        k = inl_bottleneck.cut_prior_bwd(mu, lv, eps, pm, pv, u.detach(), gu,
                                         gr, mode=mode)
        want = (k[0], k[1], k[3], k[4])
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"autograd through ops.cutlayer(prior) != cut_prior_bwd "
              f"({mode}, b={bits})")
    print("kernels: torch.autograd.grad through ops.cutlayer on CUDA equals "
          "cut_bwd and cut_prior_bwd bit for bit (4 standard, 3 prior "
          "cases)")


def same_bits(a, b) -> bool:
    """Equal bit for bit (uint32 lanes through an int32 view)."""
    import torch
    if a.dtype == torch.uint32 and b.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def pack_kernel_phase(torch):
    """cut_fwd_pack, pack and unpack_dequant against their plain versions
    and against cut_fwd, over the sweep at the packable widths."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst = {"cut_fwd_pack": 0.0, "pack": 0.0, "unpack_dequant": 0.0}
    midpoints, n = 0, 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in PACK_BITS:
            for mode in ("sample", "analytic", "none"):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps = (t.reshape(-1, d) for t in
                                   cut_inputs(torch, shape, dtype, bits))
                    what = f"pack {mode} b={bits} {dtype} {shape}"
                    u, lanes, rate = inl_bottleneck.cut_fwd_pack(
                        mu, lv, eps, bits=bits, mode=mode)
                    u1, rate1 = inl_bottleneck.cut_fwd(mu, lv, eps,
                                                       bits=bits, mode=mode)
                    pu, plan, prate = ref.cutlayer_pack_fwd_ref(
                        mu, lv, eps, bits, mode)
                    back = inl_bottleneck.unpack(lanes, d=d, bits=bits,
                                                 dtype=dtype)
                    pback = ref.unpack_dequant_ref(lanes, d, bits,
                                                   dtype=dtype)
                    torch.cuda.synchronize()
                    check(u.dtype == dtype and lanes.dtype == torch.uint32
                          and lanes.shape == (mu.shape[0],
                                              ref.packed_width(d, bits)),
                          f"{what}: {u.dtype} {lanes.dtype} {lanes.shape}")
                    check(same_bits(u, u1) and same_bits(rate, rate1),
                          f"{what}: (u, rate) differ from cut_fwd's")
                    check(same_bits(back, u) and same_bits(pback, back),
                          f"{what}: unpack(lanes) != u or != its plain "
                          f"version")
                    # the plain version: lanes and u equal but on rows at a
                    # rounding midpoint
                    mid = midpoint_rows(torch, mu, lv, eps, bits)
                    bad = ((lanes.view(torch.int32) != plan.view(torch.int32))
                           .any(-1) | (u != pu).any(-1)).cpu().numpy()
                    check(not (bad & ~mid).any(),
                          f"{what}: {int((bad & ~mid).sum())} rows differ "
                          f"from the plain version away from a midpoint")
                    midpoints += int(bad.sum())
                    keep = torch.from_numpy(~bad).to(DEV)
                    rb, err = compare_rows(rate[keep][:, None],
                                           prate[keep][:, None], RATE_TOL,
                                           what + " rate")
                    check(not rb.any(), f"{what}: rate differs from the "
                          f"plain version")
                    worst["cut_fwd_pack"] = max(worst["cut_fwd_pack"], err)
                    if dtype == torch.float32 or bits <= 8:
                        k = inl_bottleneck.pack(u, bits=bits)
                        p = ref.pack_values_ref(u, bits)
                        torch.cuda.synchronize()
                        check(same_bits(k, lanes) and same_bits(p, lanes),
                              f"{what}: pack(u) differs from the lanes")
                    else:
                        try:
                            inl_bottleneck.pack_values(u, link_bits=bits)
                        except ValueError:
                            pass
                        else:
                            check(False, f"{what}: pack_values took bf16 "
                                         f"values at {bits} bits")
                    n += 1
    print(f"kernels: cut_fwd_pack, pack, unpack_dequant on {n} cases (3 "
          f"shapes x 6 widths x 3 modes x 2 dtypes): (u, rate) == cut_fwd "
          f"bit for bit, lanes == plain, unpack(pack(u)) == u bit for bit; "
          f"{midpoints} rows at a rounding midpoint; max |rate - plain| "
          f"{worst['cut_fwd_pack']:.3g}")
    unpack_width_phase(torch)
    pack_width_phase(torch)
    return worst


def unpack_width_phase(torch):
    """unpack_dequant at every b in 1..16 (vpw a power of two or not, lanes
    with unused bits), d in {7, 33, 64, 100} (a row's last word partly
    used; row starts off the vector's alignment), R in {1, 7, 257}, fp32
    and bf16, on lanes that start one row into their allocation: equal to
    the plain version bit for bit, and unpack(pack(u)) == u where pack
    takes the type (fp32, or bf16 at b <= 8)."""
    from repro_torch.kernels import inl_bottleneck, ref
    rng = np.random.default_rng(16)
    n = 0
    for bits in range(1, 17):
        for d in (7, 33, 64, 100):
            for R in (1, 7, 257):
                idx = torch.from_numpy(rng.integers(
                    0, 1 << bits, size=(R + 1, d))).to(DEV)
                lanes = ref.pack_indices(idx, bits)[1:]
                for dtype in (torch.float32, torch.bfloat16):
                    what = f"unpack_dequant b={bits} d={d} R={R} {dtype}"
                    back = inl_bottleneck.unpack(lanes, d=d, bits=bits,
                                                 dtype=dtype)
                    want = ref.unpack_dequant_ref(lanes, d, bits,
                                                  dtype=dtype)
                    torch.cuda.synchronize()
                    check(same_bits(back, want),
                          f"{what}: differs from the plain version")
                    if dtype == torch.float32 or bits <= 8:
                        again = inl_bottleneck.unpack(
                            inl_bottleneck.pack(back, bits=bits), d=d,
                            bits=bits, dtype=dtype)
                        torch.cuda.synchronize()
                        check(same_bits(again, back),
                              f"{what}: unpack(pack(u)) != u")
                    n += 1
    print(f"kernels: unpack_dequant on {n} cases (b in 1..16 x d in "
          f"{{7, 33, 64, 100}} x R in {{1, 7, 257}} x fp32/bf16, lanes one "
          f"row into their allocation) == plain bit for bit, "
          f"unpack(pack(u)) == u (fp32, bf16 at b <= 8)")


def pack_width_phase(torch):
    """pack at every b in 1..16 (vpw a power of two or not, lanes with
    unused bits), d in {7, 33, 64, 100} (a row's last word partly used; row
    starts off the vector's alignment), R in {1, 7, 257}, fp32 and bf16 (b
    <= 8), on values that start one row into their allocation: off-grid
    values (N(0, 2.5^2), past the clip range, a quarter of them at rounding
    midpoints) and values on the b-bit grid.  The lanes equal the plain
    version's bit for bit, and unpack(pack(u)) == u on the grid."""
    from repro_torch.kernels import inl_bottleneck, ref
    rng = np.random.default_rng(17)
    n = 0
    for bits in range(1, 17):
        scale = ((1 << bits) - 1) / (2.0 * ref.QUANT_RANGE)
        for d in (7, 33, 64, 100):
            for R in (1, 7, 257):
                shape = (R + 1, d)
                off = rng.normal(scale=2.5, size=shape)
                mids = (rng.integers(0, (1 << bits) - 1, size=shape) + 0.5) \
                    / scale - ref.QUANT_RANGE
                off = np.where(rng.random(shape) < 0.25, mids, off)
                grid = ref.dequantize_index(torch.from_numpy(rng.integers(
                    0, 1 << bits, size=shape)).to(DEV), bits)
                for kind, vals in (
                        ("off-grid", torch.from_numpy(
                            off.astype(np.float32)).to(DEV)),
                        ("on-grid", grid)):
                    for dtype in (torch.float32, torch.bfloat16):
                        if dtype == torch.bfloat16 and bits > 8:
                            continue
                        what = f"pack {kind} b={bits} d={d} R={R} {dtype}"
                        u = vals.to(dtype)[1:]
                        lanes = inl_bottleneck.pack(u, bits=bits)
                        want = ref.pack_values_ref(u, bits)
                        torch.cuda.synchronize()
                        check(same_bits(lanes, want),
                              f"{what}: lanes differ from the plain version")
                        if kind == "on-grid":
                            back = inl_bottleneck.unpack(lanes, d=d,
                                                         bits=bits,
                                                         dtype=dtype)
                            torch.cuda.synchronize()
                            check(same_bits(back, u),
                                  f"{what}: unpack(pack(u)) != u")
                        n += 1
    print(f"kernels: pack on {n} cases (b in 1..16 x d in {{7, 33, 64, 100}}"
          f" x R in {{1, 7, 257}} x off-grid/on-grid values x fp32/bf16 at "
          f"b <= 8, values one row into their allocation) == plain bit for "
          f"bit, unpack(pack(u)) == u on the grid")


# ---------------------------------------------------------------------------
# 4. serving at full width: the main path
# ---------------------------------------------------------------------------

def serving_phase(torch, card_line):
    from repro_torch import tree_map
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.data import multiview
    from repro_torch.kernels import inl_bottleneck
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    scheme = schemes.get("inl")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    state = scheme.init(cfg, gen, device="cuda")
    imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
    views = multiview.make_views(imgs, cfg.noise_stds)    # (J, n, 32, 32, 3)
    engine = ServingEngine(scheme, state, cfg, buckets=BUCKETS,
                           device="cuda")
    engine.warmup()
    torch.cuda.synchronize()

    # closed loop: each burst waits for its answers, so every bucket
    # serves; then one flood of N_REQUESTS at once, for the throughput
    bursts = (1, 2, 4, 7, 16, 33, 64) * 2
    for k in inl_bottleneck.LAUNCHES:
        inl_bottleneck.LAUNCHES[k] = 0
    futs, view_of = [], {}

    def submit():
        m = len(futs) % N_REQUESTS
        rid, fut = engine.submit(views[:, m])
        view_of[rid] = m
        futs.append(fut)
        return fut

    with engine:
        for k in bursts:
            burst = [submit() for _ in range(k)]
            for f in burst:
                f.result(timeout=60)
        t0 = time.perf_counter()
        flood = [submit() for _ in range(N_REQUESTS)]
        for f in flood:
            f.result(timeout=60)
        wall = time.perf_counter() - t0
    launches = dict(inl_bottleneck.LAUNCHES)
    results = [f.result(timeout=60) for f in futs]
    n_served = len(results)

    stats = engine.stats
    check(stats.completed == n_served, f"{stats.completed} completed")
    check(launches["cut_fwd"] == stats.launches and stats.launches > 0,
          f"cut_fwd launched {launches['cut_fwd']} times over "
          f"{stats.launches} engine launches")
    probs = np.stack([r.probs for r in results])
    check(np.isfinite(probs).all(), "non-finite probabilities")
    check(np.abs(probs.sum(-1) - 1.0).max() <= 1e-5, "rows do not sum to 1")
    check(engine.meter.delivery_ratio == 1.0,
          f"delivery_ratio {engine.meter.delivery_ratio}")
    used = sorted({r.bucket for r in results})
    print(f"serving: {n_served} requests, {stats.launches} engine "
          f"launches over buckets {used}, pad fraction "
          f"{stats.pad_fraction:.3f}, cut_fwd launches "
          f"{launches['cut_fwd']}")

    # bit for bit against predict on the card, in the same bucket
    for b in used:
        rows = [r for r in results if r.bucket == b]
        for c in range(0, len(rows), b):
            chunk = rows[c:c + b]
            idx = [view_of[r.rid] for r in chunk]
            idx += [idx[-1]] * (b - len(idx))
            ref = scheme.predict(state, views[:, idx], device="cuda")
            ref = ref.cpu().numpy()[:len(chunk)]
            got = np.stack([r.probs for r in chunk])
            check(np.array_equal(got, ref),
                  f"served rows differ from predict in bucket {b}: max "
                  f"{np.abs(got - ref).max()}")
    # against the port on the CPU
    state_cpu = tree_map(lambda t: t.cpu(), state)
    cpu = scheme.predict(state_cpu, views, device="cpu").numpy()
    cpu = cpu[[view_of[r.rid] for r in results]]
    err = float(np.abs(probs - cpu).max())
    check(err <= CPU_ATOL, f"card vs CPU max |diff| {err} > {CPU_ATOL}")
    print(f"serving: served == predict(cuda) bit for bit in every bucket; "
          f"max |cuda - cpu| {err:.3g} (atol {CPU_ATOL})")
    flood_lat = stats.latencies_ms[-N_REQUESTS:]
    print(f"serving: flood of {N_REQUESTS} requests served at "
          f"{N_REQUESTS / wall:.1f} requests/s through the scheduler thread, "
          f"p50 latency {statistics.median(flood_lat):.3f} ms [{card_line}]")
    return scheme, state, views, launches


# ---------------------------------------------------------------------------
# 5. training at full width: the main path
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels import flash_attention, inl_bottleneck, ssm_scan
    return (inl_bottleneck.LAUNCHES, flash_attention.LAUNCHES,
            ssm_scan.LAUNCHES)


def reset_launches():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches():
    return {k: n for counts in _counters() for k, n in counts.items()}


def training_data(cfg, n=TRAIN_SAMPLES):
    from repro_torch.data import multiview
    imgs, labels = multiview.make_base_dataset(n, seed=1)
    return multiview.make_views(imgs, cfg.noise_stds), labels


def recorded_run(torch, name, cfg, views, labels, *, epochs, wire="dense",
                 seed=0, topology=None, states=None, dispatch="per_round",
                 captures=None, **run_kw):
    """run_scheme(name, dispatch=dispatch) on the card, with the launch
    counts set to 0 just before and read just after, and every round's
    loss recorded by a wrapper around the registered scheme's make_round
    ("per_round") or make_epoch's epoch_fn ("scan"; the graphs phase holds
    the two against each other).  Into `states`, when given, each call's
    (state in, state out): a round's, or under "scan" an epoch's; into
    `captures`, when given, the epoch_fn's captures per host signature;
    `run_kw` (ckpt_dir=, resume=) go to run_scheme.  Returns (curve,
    losses, launches, meter, seconds, the rounds' mean rates (INL; empty
    for SL and FL))."""
    from repro_torch.core import bandwidth, schemes
    from repro_torch.core.schemes import runner

    scheme = schemes.get(name)
    losses, rates, made = [], [], []
    attr = "make_epoch" if dispatch == "scan" else "make_round"
    make = getattr(scheme, attr)

    def recording_make(*a, **kw):
        fn = make(*a, **kw)
        made.append(fn)

        def rec(*ra, **rkw):
            st, m = fn(*ra, **rkw)
            if states is not None:
                states.append((ra[0], st))
            per = (lambda t: list(t.unbind(0))) if dispatch == "scan" \
                else (lambda t: [t])
            losses.extend(per(m["loss"]))
            if "rate_mean" in m:
                rates.extend(per(m["rate_mean"]))
            return st, m
        return rec
    setattr(scheme, attr, recording_make)
    meter = bandwidth.BandwidthMeter()
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        curve = runner.run_scheme(name, views, labels, cfg, epochs=epochs,
                                  batch_size=TRAIN_BATCH, eval_n=512,
                                  meter=meter, wire=wire, seed=seed,
                                  topology=topology, dispatch=dispatch,
                                  device=DEV, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        delattr(scheme, attr)
    if captures is not None and dispatch == "scan" and made:
        captures.update(made[0].captures)
    loss = [float(x) for x in losses]
    check(all(np.isfinite(loss)), f"{name} {wire}: non-finite loss {loss}")
    return curve, loss, launches, meter, wall, [float(x) for x in rates]


def falls(loss, k=4) -> tuple:
    """(mean of the first k losses, of the last k); checks the second is
    below the first."""
    first, last = float(np.mean(loss[:k])), float(np.mean(loss[-k:]))
    check(last < first, f"loss did not fall: first {k} {first}, last {k} "
                        f"{last}")
    return first, last


def training_phase(torch, card_line):
    """run_scheme("inl") at full width on the card."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkmodel

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    curve, loss, launches, meter, wall, _ = recorded_run(
        torch, "inl", cfg, views, labels, epochs=TRAIN_EPOCHS)
    steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // TRAIN_BATCH)
    check(len(loss) == steps, f"{len(loss)} train steps, expected {steps}")
    first, last = falls(loss)
    acc = curve[-1].accuracy
    check(acc >= 0.3, f"final accuracy {acc} < 0.3")
    want_gbits = steps * linkmodel.training_step_bits(
        TRAIN_BATCH, cfg.num_clients * cfg.d_bottleneck, cfg.link_bits) / 1e9
    check(curve[-1].gbits == want_gbits,
          f"gbits {curve[-1].gbits} != {want_gbits}")
    check(launches["cut_bwd"] == steps,
          f"cut_bwd launched {launches['cut_bwd']} times in {steps} steps")
    check(launches["cut_fwd"] == steps + TRAIN_EPOCHS,
          f"cut_fwd launched {launches['cut_fwd']} times in {steps} steps "
          f"and {TRAIN_EPOCHS} evaluations")
    check(launches["cut_prior_fwd"] == launches["cut_prior_bwd"] == 0,
          f"prior kernels launched on the standard prior: {launches}")
    check(launches["cut_fwd_pack"] == launches["pack"]
          == launches["unpack_dequant"] == 0,
          f"pack kernels launched on the dense wire: {launches}")
    print(f"training: run_scheme('inl') at PaperExperimentConfig(), batch "
          f"{TRAIN_BATCH}, {TRAIN_SAMPLES} samples, {TRAIN_EPOCHS} epochs = "
          f"{steps} steps in {wall:.2f} s; loss {loss[0]:.4f} -> "
          f"{loss[-1]:.4f} (mean of first 4 {first:.4f}, last 4 "
          f"{last:.4f}); accuracy per epoch "
          f"{[round(p.accuracy, 4) for p in curve]}; gbits "
          f"{curve[-1].gbits!r} (measured {curve[-1].measured_gbits!r}); "
          f"launches {launches} [{card_line}]")
    return launches, acc


def prior_training_phase(torch, card_line):
    """PRIOR_STEPS train steps with learned_prior=True through the scheme's
    round: each prior kernel once per step, the standard kernels never."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes

    cfg = dataclasses.replace(PaperExperimentConfig(), learned_prior=True)
    views, labels = training_data(cfg)
    scheme = schemes.get("inl")
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(2),
                        device=DEV)
    round_fn = scheme.make_round(cfg)
    gen = torch.Generator(device=DEV).manual_seed(3)
    v = torch.from_numpy(views).to(DEV)
    lab = torch.from_numpy(labels).to(DEV).long()
    losses = []
    torch.cuda.synchronize()
    reset_launches()
    for k in range(PRIOR_STEPS):
        sl = slice(k * TRAIN_BATCH, (k + 1) * TRAIN_BATCH)
        state, m = round_fn(state, v[None, :, sl], lab[None, sl], gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = read_launches()
    loss = [float(x) for x in losses]
    check(all(np.isfinite(loss)), f"non-finite loss: {loss}")
    check(launches["cut_prior_fwd"] == launches["cut_prior_bwd"]
          == PRIOR_STEPS, f"prior kernels: {launches} in {PRIOR_STEPS} steps")
    check(launches["cut_fwd"] == launches["cut_bwd"] == 0,
          f"standard kernels launched with a learned prior: {launches}")
    pri = state["params"].priors
    moved = max(float(pri["mu"].abs().max()),
                float(pri["logvar"].abs().max()))
    check(moved > 0.0, "the learned priors did not move from zero")
    print(f"training: learned_prior=True, {PRIOR_STEPS} steps; loss "
          f"{loss[0]:.4f} -> {loss[-1]:.4f}; max |prior| {moved:.4g}; "
          f"launches {launches} [{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# 5b. the packed wire and the SL/FL baselines at full width
# ---------------------------------------------------------------------------

def expect_launches(launches, want, what):
    """Every kernel's count equal to `want`'s (absent: 0)."""
    full = {k: want.get(k, 0) for k in launches}
    check(launches == full, f"{what}: launches {launches}, expected {full}")


def packed_training_phase(torch, card_line):
    """The packed-wire paths, each driven through run_scheme with the launch
    counts set to 0 just before and read just after.  Returns {path:
    launches}."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkmodel, paper_model

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    views, labels = training_data(cfg, PACKED_SAMPLES)
    steps = PACKED_SAMPLES // TRAIN_BATCH
    R, d = cfg.num_clients * TRAIN_BATCH, cfg.d_bottleneck      # 320, 64
    W = d * WIRE_BITS // 32                                       # 16 lanes
    per_round = {"packed": R * W * 4 + R * d * 4,
                 "packed_duplex": 2 * R * W * 4}
    closed = linkmodel.training_step_bits(TRAIN_BATCH, cfg.num_clients * d,
                                          WIRE_BITS)
    # SL also moves its client-side weights once an epoch, J hand-offs of
    # J fp32 encoders
    handoff = cfg.num_clients * cfg.num_clients * 4 \
        * paper_model.encoder_param_count(cfg)
    check(per_round["packed_duplex"] * 8 == closed,
          f"duplex bytes {per_round['packed_duplex']} vs closed form "
          f"{closed} bits")
    out = {}
    runs = (("inl", "packed", cfg, views, labels),
            ("inl", "packed_duplex", cfg, views, labels),
            ("inl+learned_prior", "packed",
             dataclasses.replace(cfg, learned_prior=True), views, labels),
            ("sl", "packed", cfg, views, labels))
    for path, wire, c, v, lab in runs:
        name = path.split("+")[0]
        curve, loss, launches, meter, wall, rates = recorded_run(
            torch, name, c, v, lab, epochs=1, wire=wire)
        check(len(loss) == steps, f"{path} {wire}: {len(loss)} steps")
        first, last = falls(loss)
        if path == "inl+learned_prior":
            want = {"cut_prior_fwd": steps, "cut_prior_bwd": steps,
                    "pack": steps, "unpack_dequant": steps, "cut_fwd": 1}
        elif name == "inl":
            want = {"cut_fwd_pack": steps, "unpack_dequant": steps,
                    "cut_bwd": steps, "cut_fwd": 1}
        else:                       # sl: its cut, then ship; + evaluation
            want = {"cut_fwd": steps + 1, "pack": steps,
                    "unpack_dequant": steps, "cut_bwd": steps}
        expect_launches(launches, want, f"{path} {wire}")
        extra = handoff if name == "sl" else 0
        check(meter.measured_bytes == steps * per_round[wire] + extra,
              f"{path} {wire}: measured {meter.measured_bytes} bytes, "
              f"expected {steps} x {per_round[wire]} + {extra}")
        if wire == "packed_duplex":
            check(meter.measured_bits == meter.total_bits,
                  f"duplex measured {meter.measured_bits} bits != closed "
                  f"form {meter.total_bits}")
        out[f"{path} {wire}"] = launches
        print(f"packed: run_scheme('{name}', wire='{wire}') at "
              f"PaperExperimentConfig(link_bits={WIRE_BITS}"
              f"{', learned_prior=True' if 'prior' in path else ''}), "
              f"{steps} steps of {TRAIN_BATCH} in {wall:.2f} s; loss "
              f"{loss[0]:.4f} -> {loss[-1]:.4f} (first 4 {first:.4f}, last "
              f"4 {last:.4f}); mean rate "
              f"{[round(r, 1) for r in rates[::5]] if rates else 'n/a'}; "
              f"accuracy {curve[-1].accuracy:.4f}; gbits "
              f"{curve[-1].gbits!r}, measured {curve[-1].measured_gbits!r} "
              f"({per_round[wire]} bytes a round); launches {launches} "
              f"[{card_line}]")
    # FL: J clients x 2 local steps a round, one full model each
    rounds_samples = FL_ROUNDS * cfg.num_clients * 2 * TRAIN_BATCH
    fv, fl_labels = training_data(cfg, rounds_samples)
    curve, loss, launches, meter, wall, _ = recorded_run(
        torch, "fl", cfg, fv, fl_labels, epochs=1)
    local = FL_ROUNDS * cfg.num_clients * 2
    check(len(loss) == FL_ROUNDS, f"fl: {len(loss)} rounds")
    falls(loss, k=1)
    expect_launches(launches, {"cut_fwd": local + 1, "cut_bwd": local},
                    "fl")
    out["fl"] = launches
    print(f"packed: run_scheme('fl') at PaperExperimentConfig(link_bits="
          f"{WIRE_BITS}), {FL_ROUNDS} rounds of {cfg.num_clients} clients x "
          f"2 local steps of {TRAIN_BATCH} in {wall:.2f} s; round loss "
          f"{[round(x, 4) for x in loss]}; accuracy "
          f"{curve[-1].accuracy:.4f}; gbits {curve[-1].gbits!r}, measured "
          f"{curve[-1].measured_gbits!r}; launches {launches} "
          f"[{card_line}]")
    return out


def packed_step_equals_dense(torch, card_line):
    """From one state and one set of draws, the loss and every gradient leaf
    of a packed step equal a dense step's, bit for bit (deterministic
    algorithms on for the comparison)."""
    from repro_torch import tree_leaves, value_and_grad
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import inl, paper_model, schemes

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    views, labels = training_data(cfg)
    st = schemes.get("inl").init(cfg, torch.Generator(device=DEV)
                                 .manual_seed(8), device=DEV)
    v = torch.from_numpy(views[:, :TRAIN_BATCH]).to(DEV)
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).to(DEV).long()
    gen = torch.Generator(device=DEV).manual_seed(9)
    eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                      generator=gen, device=DEV)
    masks = paper_model.decoder_dropout_masks(gen, cfg.dense_units,
                                              TRAIN_BATCH, device=DEV)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for wire in ("dense", "packed"):
            loss, _, grads = value_and_grad(
                inl.loss_fn, st["params"], st["state"], v, lab, cfg,
                eps=eps, drop_masks=masks, wire=wire)
            out[wire] = (loss, tree_leaves(grads))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (ld, gd), (lp, gp) = out["dense"], out["packed"]
    check(same_bits(ld, lp), f"packed step loss {float(lp)} != dense "
                             f"{float(ld)}")
    check(len(gd) == len(gp) > 0 and all(same_bits(a, b)
                                         for a, b in zip(gd, gp)),
          "a gradient leaf of the packed step differs from the dense one")
    print(f"packed: one packed step == one dense step bit for bit (loss "
          f"{float(ld)!r}, {len(gd)} gradient leaves) [{card_line}]")


def _loss_and_grads(torch, cfg, params, state, views, labels, eps, masks,
                    **kw):
    from repro_torch import tree_leaves, tree_unflatten
    from repro_torch.core import inl
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = inl.loss_fn(tree_unflatten(params, leaves), state, views,
                          labels, cfg, eps=eps, drop_masks=masks, **kw)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def grads_close(l_gpu, l_cpu, g_gpu, g_cpu, what):
    """Step-1 loss within rtol 1e-3, atol 1e-5 and every gradient leaf as a
    tensor: |card - cpu| <= 1e-3 |cpu| + 1e-5 sqrt(n) in the 2-norm.
    Returns (largest |card - cpu| / |cpu| of a leaf above the atol floor,
    largest entry difference, entries outside the bar entry by entry)."""
    check(np.isclose(l_gpu, l_cpu, **CARD_CPU_TOL),
          f"{what}: step-1 loss card {l_gpu} vs cpu {l_cpu}")
    max_abs, max_leaf, off_entries = 0.0, 0.0, 0
    for a, b in zip(g_gpu, g_cpu):
        a, b = a.cpu().double().numpy(), b.double().numpy()
        # a leaf as a tensor: |a - b| <= rtol |b| + atol sqrt(n) in the 2-norm
        # (a single entry of a conv-weight gradient sums 65536 products that
        # cancel, and cuDNN and the CPU add them in other orders)
        dist, size = np.linalg.norm(a - b), np.linalg.norm(b)
        bar = CARD_CPU_TOL["rtol"] * size \
            + CARD_CPU_TOL["atol"] * np.sqrt(a.size)
        check(dist <= bar, f"{what}: gradient leaf {a.shape}: |card - cpu| "
              f"{dist} > {bar} (|cpu| {size})")
        max_abs = max(max_abs, float(np.abs(a - b).max()))
        if size > bar:          # leaves whose gradient is not ~0 (conv
            max_leaf = max(max_leaf, float(dist / size))   # biases are)
        off_entries += int((~np.isclose(a, b, **CARD_CPU_TOL)).sum())
    return max_leaf, max_abs, off_entries


def card_vs_cpu_phase(torch, card_line):
    """One set of weights, eps and masks drawn on the CPU: step 1's loss and
    gradients, and 3 steps' losses, on the card against the CPU port."""
    from repro_torch import tree_map
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import paper_model, schemes

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    scheme = schemes.get("inl")
    cpu = scheme.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    gpu = tree_map(lambda t: t.to(DEV), cpu)
    v = torch.from_numpy(views[:, :TRAIN_BATCH])
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).long()
    gen = torch.Generator().manual_seed(5)
    draws = []
    for _ in range(3):
        eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                          generator=gen)
        draws.append((eps, paper_model.decoder_dropout_masks(
            gen, cfg.dense_units, TRAIN_BATCH)))

    def on(dev, t):
        return tree_map(lambda x: x.to(dev), t)
    l_cpu, g_cpu = _loss_and_grads(torch, cfg, cpu["params"], cpu["state"],
                                   v, lab, *draws[0])
    l_gpu, g_gpu = _loss_and_grads(torch, cfg, gpu["params"], gpu["state"],
                                   v.to(DEV), lab.to(DEV), *on(DEV,
                                                             draws[0]))
    max_leaf, max_abs, off_entries = grads_close(l_gpu, l_cpu, g_gpu, g_cpu,
                                                 "star")
    round_fn = scheme.make_round(cfg)
    losses = {}
    for dev, st in (("cpu", cpu), (DEV, gpu)):
        out = []
        for eps, masks in draws:
            st, m = round_fn(st, v[None].to(dev), lab[None].to(dev), None,
                             eps=eps.to(dev),
                             drop_masks=[x.to(dev) for x in masks])
            out.append(float(m["loss"]))
        losses[dev] = out
    check(np.allclose(losses[DEV], losses["cpu"], rtol=1e-3, atol=0),
          f"3-step losses card {losses[DEV]} vs cpu {losses['cpu']}")
    print(f"cpu: step-1 loss card {l_gpu:.7f} cpu {l_cpu:.7f}; "
          f"{len(g_gpu)} gradient leaves within rtol 1e-3 atol 1e-5 as "
          f"tensors, largest |card - cpu| / |cpu| of a leaf {max_leaf:.3g} "
          f"(leaves above the atol floor), "
          f"largest entry difference {max_abs:.3g}, {off_entries} entries "
          f"outside the bar taken entry by entry; 3-step losses card "
          f"{losses[DEV]} cpu {losses['cpu']} [{card_line}]")


# ---------------------------------------------------------------------------
# 6b. non-star topologies at full width
# ---------------------------------------------------------------------------

def graph_runs():
    """(label, topology, config, wire) of the graph training runs."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import topology as T
    cfg8 = PaperExperimentConfig(link_bits=WIRE_BITS)
    return (("chain(5) packed", T.chain(5), cfg8, "packed"),
            ("chain(5) packed_duplex", T.chain(5), cfg8, "packed_duplex"),
            ("tree(2, 2) dense", T.tree(2, 2),
             PaperExperimentConfig(num_clients=6, noise_stds=TREE_STDS),
             "dense"),
            (f"chain(5, link_bits={HET_BITS}) dense",
             T.chain(5, link_bits=HET_BITS), PaperExperimentConfig(),
             "dense"))


def topology_phase(torch, card_line):
    """The graph paths at full width, batch 64, each driven through
    run_scheme("inl", topology=...) with the launch counts set to 0 just
    before and read just after: one cut_fwd and one cut_bwd a first-hop
    width group a step (one more cut_fwd a group for the evaluation, on the
    dense wire), one pack and one unpack_dequant an edge a step on a packed
    wire; the meter's per-edge bytes equal steps x the closed forms'
    wirefmt sizes.  Returns {label: launches}."""
    from repro_torch.core import topology as T

    steps = GRAPH_SAMPLES // TRAIN_BATCH
    out = {}
    for label, topo, cfg, wire in graph_runs():
        views, labels = training_data(cfg, GRAPH_SAMPLES)
        curve, loss, launches, meter, wall, rates = recorded_run(
            torch, "inl", cfg, views, labels, epochs=1, wire=wire,
            topology=topo)
        check(len(loss) == steps, f"{label}: {len(loss)} steps")
        first, last = falls(loss)
        groups = len(T.first_hop_groups(topo, cfg)[0])
        hops = 0 if wire == "dense" else len(topo.edges)
        expect_launches(launches, {
            "cut_fwd": groups * (steps + 1), "cut_bwd": groups * steps,
            "pack": hops * steps, "unpack_dequant": hops * steps}, label)
        bits = T.round_edge_bits(topo, cfg, TRAIN_BATCH)
        nbytes = T.round_edge_wire_bytes(topo, cfg, TRAIN_BATCH, wire=wire)
        check(meter.edge_bits == {k: steps * v for k, v in bits.items()}
              and meter.edge_measured_bytes
              == {k: steps * v for k, v in nbytes.items()},
              f"{label}: per-edge ledger {meter.edge_bits} "
              f"{meter.edge_measured_bytes} != {steps} x {bits} {nbytes}")
        if wire == "packed_duplex" or cfg.link_bits == 32 and all(
                e.link_bits in (None, 32) for e in topo.edges):
            check(all(nbytes[k] * 8 == bits[k] for k in bits),
                  f"{label}: measured bytes differ from the closed forms")
        out[label] = launches
        per_edge = "; ".join(
            f"{k} payload {len(topo.payload(e))}: closed {bits[k]:.0f} "
            f"bits, measured {nbytes[k]:.0f} bytes"
            for e in topo.topo_edges() for k in [e.key])
        print(f"topology: run_scheme('inl') on {label} at full width, "
              f"{cfg.num_clients} views, {steps} steps of {TRAIN_BATCH} in {wall:.2f} s; loss "
              f"{loss[0]:.4f} -> {loss[-1]:.4f} (first 4 {first:.4f}, last "
              f"4 {last:.4f}); accuracy {curve[-1].accuracy:.4f}; "
              f"{groups} first-hop group(s), {hops} packed hop(s) a step; "
              f"launches {launches} [{card_line}]")
        print(f"topology: {label} per edge and round: {per_edge}")
    return out


def graph_step_checks(torch, card_line):
    """From one state and one set of draws at PaperExperimentConfig(link_bits
    =8): the loss and every gradient leaf of a step on the packed chain(5)
    equal the dense chain's, and the dense chain's the star's, bit for bit
    (deterministic algorithms on); then step 1 of the packed chain(5) and
    of tree(2, 2) on the card against the CPU port (grads_close)."""
    from repro_torch import tree_leaves, tree_map, value_and_grad
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import inl, paper_model, schemes
    from repro_torch.core import topology as T

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    views, labels = training_data(cfg)
    st = schemes.get("inl").init(cfg, torch.Generator(device=DEV)
                                 .manual_seed(10), device=DEV)
    v = torch.from_numpy(views[:, :TRAIN_BATCH]).to(DEV)
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).to(DEV).long()
    gen = torch.Generator(device=DEV).manual_seed(11)
    eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                      generator=gen, device=DEV)
    masks = paper_model.decoder_dropout_masks(gen, cfg.dense_units,
                                              TRAIN_BATCH, device=DEV)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, topo, wire in (("star", None, "dense"),
                                  ("chain dense", T.chain(5), "dense"),
                                  ("chain packed", T.chain(5), "packed")):
            loss, _, grads = value_and_grad(
                inl.loss_fn, st["params"], st["state"], v, lab, cfg,
                eps=eps, drop_masks=masks, wire=wire, topology=topo)
            out[label] = (loss, tree_leaves(grads))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in (("chain dense", "star"), ("chain packed", "chain dense")):
        (la, ga), (lb, gb) = out[a], out[b]
        check(same_bits(la, lb), f"{a} step loss {float(la)} != {b} "
                                 f"{float(lb)}")
        check(len(ga) == len(gb) > 0 and all(same_bits(x, y)
                                             for x, y in zip(ga, gb)),
              f"a gradient leaf of the {a} step differs from the {b} one")
    print(f"topology: one step on the packed chain(5) == the dense chain(5) "
          f"== the star, bit for bit (loss {float(out['star'][0])!r}, "
          f"{len(out['star'][1])} gradient leaves) [{card_line}]")

    for label, topo, c, wire in graph_runs()[::2]:
        cv, cl = training_data(c)
        cpu = schemes.get("inl").init(c, torch.Generator().manual_seed(12),
                                      device="cpu")
        g = torch.Generator().manual_seed(13)
        e = torch.randn((c.num_clients, TRAIN_BATCH, c.d_bottleneck),
                        generator=g)
        m = paper_model.decoder_dropout_masks(g, c.dense_units, TRAIN_BATCH)
        vc = torch.from_numpy(cv[:, :TRAIN_BATCH])
        lc = torch.from_numpy(cl[:TRAIN_BATCH]).long()
        kw = dict(topology=topo, wire=wire)
        l_cpu, g_cpu = _loss_and_grads(torch, c, cpu["params"],
                                       cpu["state"], vc, lc, e, m, **kw)
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        l_gpu, g_gpu = _loss_and_grads(
            torch, c, gpu["params"], gpu["state"], vc.to(DEV), lc.to(DEV),
            e.to(DEV), [x.to(DEV) for x in m], **kw)
        max_leaf, max_abs, off = grads_close(l_gpu, l_cpu, g_gpu, g_cpu,
                                             label)
        print(f"topology: {label} step 1, card against the CPU port: loss "
              f"{l_gpu:.7f} / {l_cpu:.7f}; {len(g_gpu)} gradient leaves "
              f"within rtol 1e-3 atol 1e-5 as tensors, largest |card - cpu|"
              f" / |cpu| of a leaf {max_leaf:.3g}, largest entry difference "
              f"{max_abs:.3g}, {off} entries outside the bar taken entry by "
              f"entry [{card_line}]")


def graph_serving_phase(torch, card_line):
    """chain(5) served at PaperExperimentConfig(link_bits=8) on the packed
    wire over buckets (1, 4, 16, 64), launch counts set to 0 just before
    and read just after: one cut_fwd and five pack and unpack_dequant an
    engine launch; answers finite rows summing to 1, equal bit for bit to
    predict on the card in the same bucket; every edge metered."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine, metering

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    topo = T.chain(5)
    scheme = schemes.get("inl")
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(14),
                        device=DEV)
    imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
    views = multiview.make_views(imgs, cfg.noise_stds)
    engine = ServingEngine(scheme, state, cfg, topology=topo, wire="packed",
                           buckets=BUCKETS, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    reset_launches()
    futs, view_of = [], {}

    def submit():
        m = len(futs) % N_REQUESTS
        rid, fut = engine.submit(views[:, m])
        view_of[rid] = m
        futs.append(fut)
        return fut

    with engine:
        for k in (1, 2, 4, 7, 16, 33, 64) * 2:
            burst = [submit() for _ in range(k)]
            for f in burst:
                f.result(timeout=60)
        t0 = time.perf_counter()
        flood = [submit() for _ in range(N_REQUESTS)]
        for f in flood:
            f.result(timeout=60)
        wall = time.perf_counter() - t0
    launches = read_launches()
    results = [f.result(timeout=60) for f in futs]
    stats = engine.stats
    n_edges = len(topo.edges)
    expect_launches(launches, {"cut_fwd": stats.launches,
                               "pack": n_edges * stats.launches,
                               "unpack_dequant": n_edges * stats.launches},
                    "chain(5) serving")
    probs = np.stack([r.probs for r in results])
    check(np.isfinite(probs).all()
          and np.abs(probs.sum(-1) - 1.0).max() <= 1e-5,
          "chain(5) serving: rows not finite or not summing to 1")
    per_req = metering.request_edge_wire_bytes(topo, cfg, wire="packed")
    check(engine.meter.edge_measured_bytes
          == {k: len(results) * v for k, v in per_req.items()},
          f"chain(5) serving: per-edge bytes "
          f"{engine.meter.edge_measured_bytes}")
    # bit for bit against predict on the card in the same bucket: within a
    # bucket no request's answer depends on the batch it rode in
    checked = 0
    for b in sorted({r.bucket for r in results}):
        rows = [r for r in results if r.bucket == b]
        for c in range(0, len(rows), b):
            chunk = rows[c:c + b]
            idx = [view_of[r.rid] for r in chunk]
            idx += [idx[-1]] * (b - len(idx))
            ref = scheme.predict_batched(state, views[:, idx],
                                         topology=topo, cfg=cfg,
                                         wire="packed", device=DEV)
            ref = ref.cpu().numpy()[:len(chunk)]
            got = np.stack([r.probs for r in chunk])
            check(np.array_equal(got, ref),
                  f"chain(5) served rows differ from predict in bucket {b}:"
                  f" max {np.abs(got - ref).max()}")
            checked += len(chunk)
    used = sorted({r.bucket for r in results})
    print(f"topology: served chain(5) (packed, link_bits={WIRE_BITS}): "
          f"{len(results)} requests in {stats.launches} engine launches "
          f"over buckets {used}, {checked} rows == predict(cuda) bit for "
          f"bit in their bucket; flood of {N_REQUESTS} at "
          f"{N_REQUESTS / wall:.1f} requests/s, p50 latency "
          f"{statistics.median(stats.latencies_ms[-N_REQUESTS:]):.3f} ms; "
          f"launches {launches} [{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# 6c. unreliable links (core/linkfault) at full width
# ---------------------------------------------------------------------------

HEADLINE_ERASURE = 0.3          # benchmarks/links_bench.py's headline rate
HEADLINE_DROPOUT = 0.2          # and its INL edge-dropout curriculum
CHAIN_ERASURE = 0.1             # per edge: chain(5)'s head crosses five
LOSSY_STEPS = 16
PERFECT_STEPS = 4
SERVE_LINK = dict(latency_ms=1.0, jitter_ms=1.0)
SERVE_DEADLINE_MS = 2.0         # a view misses iff Exp(1) > 1: p = e^-1


def _round_batches(torch, scheme, cfg, steps, seed=1):
    """`steps` rounds of (bpr, J, B, ...) views and (bpr, B) labels on the
    card, laid out as run_scheme gathers them."""
    bpr = scheme.batches_per_round(cfg)
    views, labels = training_data(cfg, steps * bpr * TRAIN_BATCH)
    v = torch.from_numpy(views).to(DEV)
    lab = torch.from_numpy(labels).to(DEV).long()
    out = []
    for k in range(steps):
        idx = torch.arange(k * bpr * TRAIN_BATCH, (k + 1) * bpr * TRAIN_BATCH,
                           device=DEV).reshape(bpr, TRAIN_BATCH)
        out.append((v[:, idx].transpose(0, 1), lab[idx]))
    return out


def perfect_links_phase(torch, card_line):
    """LinkModel() on every edge against no link model, from one state and
    one generator, deterministic algorithms on: PERFECT_STEPS INL steps on
    the star, one FL round, PERFECT_STEPS steps on the packed chain(5); the
    losses and every state leaf (parameters, BatchNorm statistics,
    optimizer state) bit for bit."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import topology as T

    cfg, cfg8 = PaperExperimentConfig(), PaperExperimentConfig(
        link_bits=WIRE_BITS)
    runs = (("INL star", "inl", cfg, T.star(cfg.num_clients), "dense",
             PERFECT_STEPS),
            ("FL star", "fl", cfg, T.star(cfg.num_clients), "dense", 1),
            ("INL chain(5) packed", "inl", cfg8, T.chain(5), "packed",
             PERFECT_STEPS))
    perfect_equals_bare(torch, card_line, runs, "linkfault")


def perfect_equals_bare(torch, card_line, runs, prefix):
    """Each (label, scheme, config, topology, wire, steps) of `runs`: the
    topology with LinkModel() on every edge against the bare one, from one
    state and one generator, deterministic algorithms on; the losses and
    every state leaf bit for bit."""
    from repro_torch import tree_leaves
    from repro_torch.core import linkfault, schemes

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, name, c, bare, wire, steps in runs:
            scheme = schemes.get(name)
            batches = _round_batches(torch, scheme, c, steps)
            out = []
            for topo in (bare, linkfault.with_links(bare,
                                                    linkfault.LinkModel())):
                st = scheme.init(c, torch.Generator(device=DEV)
                                 .manual_seed(15), device=DEV)
                round_fn = scheme.make_round(c, wire=wire, topology=topo)
                gen = torch.Generator(device=DEV).manual_seed(16)
                losses = []
                for k, (rv, rl) in enumerate(batches):
                    kw = ({} if topo is bare
                          else {"round_key": linkfault.round_key(0, k)})
                    st, m = round_fn(st, rv, rl, gen, **kw)
                    losses.append(m["loss"])
                torch.cuda.synchronize()
                out.append((losses, tree_leaves(st)))
            (la, sa), (lb, sb) = out
            check(all(same_bits(a, b) for a, b in zip(la, lb)),
                  f"{label}: perfect links moved the loss {la} -> {lb}")
            check(len(sa) == len(sb) > 0
                  and all(same_bits(a, b) for a, b in zip(sa, sb)),
                  f"{label}: perfect links moved a state leaf")
            print(f"{prefix}: perfect links on {label} == no link model, "
                  f"{steps} round(s) bit for bit (losses "
                  f"{[float(x) for x in la]}, {len(sa)} state leaves) "
                  f"[{card_line}]")
    finally:
        torch.use_deterministic_algorithms(False)


def lossy_runs():
    """(label, scheme, config, topology, wire, samples) of the lossy
    training runs: the reference's headline erasure on every edge of the
    star (INL with its edge-dropout curriculum), CHAIN_ERASURE on every
    edge of the packed chain(5)."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T

    star = LF.with_links(T.star(5), LF.LinkModel(erasure=HEADLINE_ERASURE))
    chain = LF.with_links(T.chain(5), LF.LinkModel(erasure=CHAIN_ERASURE))
    inl = PaperExperimentConfig(edge_dropout=HEADLINE_DROPOUT)
    inl8 = dataclasses.replace(inl, link_bits=WIRE_BITS)
    plain = PaperExperimentConfig()
    n = LOSSY_STEPS * TRAIN_BATCH
    return (("inl star", "inl", inl, star, "dense", n),
            ("inl+learned_prior star", "inl",
             dataclasses.replace(inl, learned_prior=True), star, "dense",
             PRIOR_STEPS * TRAIN_BATCH),
            ("inl star packed", "inl", inl8, star, "packed", n),
            ("inl chain(5) packed", "inl", inl8, chain, "packed", n),
            ("fl star", "fl", plain, star, "dense",
             FL_ROUNDS * 5 * 2 * TRAIN_BATCH),
            ("sl star", "sl", plain, star, "dense", n))


def _expected_ratio(name, scheme, cfg, topo, seed, rounds, state):
    """The delivery ratio the masks of the run's round keys imply,
    replayed on the host with the masks' own arithmetic (not the meter's):
    INL the per-edge payload fraction weighted by the edges' bits, FL the
    broadcast plus the arrived uploads, SL the rounds that ran over the
    attempts made (plus the hand-offs, delivered in full)."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T
    keys = [LF.round_key(seed, r) for r in range(rounds)]
    J = cfg.num_clients
    if name == "inl":
        bits = T.round_edge_bits(topo, cfg, TRAIN_BATCH)
        got = 0.0
        for k in keys:
            mask = LF.round_delivery_mask(k, topo, cfg, TRAIN_BATCH,
                                          train=True)
            got += sum(bits[e.key] * float(np.mean(mask[list(
                topo.payload(e))])) for e in topo.edges)
        return got / (rounds * sum(bits.values()))
    if name == "fl":
        return float(np.mean([(J + LF.client_delivery_mask(
            k, topo, cfg, train=True).sum()) / (2.0 * J) for k in keys]))
    b = scheme.bits_per_round(cfg, state, TRAIN_BATCH)
    over = scheme.epoch_overhead_bits(cfg, state)
    ran = used = 0
    for k in keys:
        oks = LF.attempt_successes(k, topo, cfg, LF.retry_attempts())
        ran += bool(oks.any())
        used += int(oks.argmax()) + 1 if oks.any() else len(oks)
    return (ran * b + over) / (used * b + over)


def lossy_training_phase(torch, card_line):
    """The lossy runs through run_scheme at full width, batch 64, launch
    counts set to 0 just before each and read just after: every kernel
    launched as on the clean network; the meter's delivery ratio equal to
    the ratio the replayed masks imply; SL's skipped rounds counted from
    the replay, each leaving the state as it was, each other round moving
    it.  Returns {label: launches}."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T

    out = {}
    for label, name, cfg, topo, wire, n in lossy_runs():
        scheme = schemes.get(name)
        views, labels = training_data(cfg, n)
        rounds = n // TRAIN_BATCH // scheme.batches_per_round(cfg)
        seed = 0
        if name == "sl":
            # the first seed whose rounds include a skipped one, so the
            # skip path runs (P(skip) = 0.3^3 a round)
            seed = next(s for s in range(1000) if any(
                not LF.round_success(LF.round_key(s, r), topo, cfg,
                                     LF.retry_attempts())
                for r in range(rounds)))
        states = []
        curve, loss, launches, meter, wall, rates = recorded_run(
            torch, name, cfg, views, labels, epochs=1, wire=wire, seed=seed,
            topology=topo, states=states)
        check(len(loss) == rounds, f"{label}: {len(loss)} rounds")
        groups = len(T.first_hop_groups(topo, cfg)[0])
        hops = 0 if wire == "dense" or T.nontrivial(topo, cfg) is None \
            else len(topo.edges)
        if name == "fl":
            local = rounds * cfg.num_clients * 2
            want = {"cut_fwd": local + 1, "cut_bwd": local}
        elif name == "sl":
            want = {"cut_fwd": rounds + 1, "cut_bwd": rounds}
        elif cfg.learned_prior:
            want = {"cut_prior_fwd": rounds, "cut_prior_bwd": rounds,
                    "cut_fwd": 1}
        elif wire == "packed" and hops == 0:
            want = {"cut_fwd_pack": rounds, "unpack_dequant": rounds,
                    "cut_bwd": rounds, "cut_fwd": 1}
        else:
            want = {"cut_fwd": groups * (rounds + 1),
                    "cut_bwd": groups * rounds, "pack": hops * rounds,
                    "unpack_dequant": hops * rounds}
        expect_launches(launches, want, f"lossy {label}")
        ratio = _expected_ratio(name, scheme, cfg, topo, seed, rounds,
                                states[0][0])
        check(np.isclose(meter.delivery_ratio, ratio, rtol=1e-12, atol=0)
              and meter.delivery_ratio < 1.0,
              f"lossy {label}: meter delivery ratio {meter.delivery_ratio} "
              f"!= the masks' {ratio}")
        skips = ""
        if name == "sl":
            skipped = [r for r in range(rounds) if not LF.round_success(
                LF.round_key(seed, r), topo, cfg, LF.retry_attempts())]
            from repro_torch import tree_leaves
            for r, (before, after) in enumerate(states):
                same = all(same_bits(a, b) for a, b in zip(
                    tree_leaves(before), tree_leaves(after)))
                what = "skipped" if r in skipped else "ran"
                check(same == (r in skipped),
                      f"lossy sl: round {r} {what} but its state "
                      f"{'stayed' if same else 'moved'}")
            check(len(skipped) >= 1, "lossy sl: no round was skipped")
            skips = f"; seed {seed}: rounds {skipped} skipped, state unchanged"
        out[label] = launches
        print(f"linkfault: run_scheme('{name}') on {label} (erasure "
              f"{topo.edges[0].link.erasure} an edge, edge_dropout "
              f"{cfg.edge_dropout}, link_bits={cfg.link_bits}, {wire}), "
              f"{rounds} rounds in {wall:.2f} s; loss {loss[0]:.4f} -> "
              f"{loss[-1]:.4f}; accuracy {curve[-1].accuracy:.4f}; "
              f"delivery ratio {meter.delivery_ratio!r} == the masks' "
              f"{ratio!r} (gbits {curve[-1].gbits!r}, delivered "
              f"{curve[-1].delivered_gbits!r}){skips}; launches {launches} "
              f"[{card_line}]")
    return out


LOSSY_CPU_SEEDS = 5


def worst_leaf_shape(g_gpu, g_cpu):
    """The shape of the gradient leaf with the largest |card - cpu| / |cpu|
    among those above grads_close's atol floor."""
    best, shape = -1.0, None
    for a, b in zip(g_gpu, g_cpu):
        a, b = a.cpu().double().numpy(), b.double().numpy()
        size = np.linalg.norm(b)
        floor = CARD_CPU_TOL["rtol"] * size \
            + CARD_CPU_TOL["atol"] * np.sqrt(a.size)
        if size > floor and np.linalg.norm(a - b) / size > best:
            best, shape = np.linalg.norm(a - b) / size, tuple(a.shape)
    return shape


def lossy_card_vs_cpu(torch, card_line):
    """One lossy step, card against the CPU port, on LOSSY_CPU_SEEDS sets
    of weights, eps and dropout masks and one explicit delivery mask (two
    views lost): loss and gradients at the phase-6 bar (grads_close), and
    beside each the clean step's on the same draws.  Prints each seed's
    largest |card - cpu| / |cpu| of a leaf, lossy and clean, and whether it
    stays under the bar's rtol term alone."""
    from repro_torch import tree_map
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import paper_model, schemes

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    v = torch.from_numpy(views[:, :TRAIN_BATCH])
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).long()
    delivery = np.array([True, False, True, True, False])
    for i in range(LOSSY_CPU_SEEDS):
        cpu = schemes.get("inl").init(
            cfg, torch.Generator().manual_seed(19 + 2 * i), device="cpu")
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        g = torch.Generator().manual_seed(20 + 2 * i)
        eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                          generator=g)
        masks = paper_model.decoder_dropout_masks(g, cfg.dense_units,
                                                  TRAIN_BATCH)
        worst = {}
        for label, kw in (("lossy", {"delivery": delivery}),
                          ("clean", {})):
            l_cpu, g_cpu = _loss_and_grads(torch, cfg, cpu["params"],
                                           cpu["state"], v, lab, eps, masks,
                                           **kw)
            l_gpu, g_gpu = _loss_and_grads(
                torch, cfg, gpu["params"], gpu["state"], v.to(DEV),
                lab.to(DEV), eps.to(DEV), [x.to(DEV) for x in masks], **kw)
            worst[label] = (l_gpu, l_cpu) + grads_close(
                l_gpu, l_cpu, g_gpu, g_cpu, f"{label} star, seed {i}") \
                + (worst_leaf_shape(g_gpu, g_cpu),)
        check(worst["lossy"][1] != worst["clean"][1],
              "the delivery mask did not change the loss")
        (lg, lc, leaf, mx, off, shape), (_, cc, c_leaf, _, _, c_shape) = \
            worst["lossy"], worst["clean"]
        print(f"linkfault: one lossy step (views 1 and 4 lost), seed {i}, "
              f"card against the CPU port: loss {lg:.7f} / {lc:.7f} (clean "
              f"{cc:.7f}); {len(g_cpu)} gradient leaves within rtol 1e-3 "
              f"atol 1e-5 as tensors, largest |card - cpu| / |cpu| of a "
              f"leaf {leaf:.3g} lossy (a {shape} leaf), {c_leaf:.3g} clean "
              f"(a {c_shape} leaf; under the rtol "
              f"term alone: {leaf <= CARD_CPU_TOL['rtol']} / "
              f"{c_leaf <= CARD_CPU_TOL['rtol']}), largest entry difference "
              f"{mx:.3g}, {off} entries outside the bar taken entry by "
              f"entry [{card_line}]")


def lossy_serving_phase(torch, card_line):
    """The star with LinkModel(latency_ms=1, jitter_ms=1) on every edge and
    deadline_ms=2 served over buckets (1, 4, 16, 64), launch counts set to
    0 just before and read just after: one cut_fwd an engine launch; about
    e^-1 of the views miss (a binomial bound); each request's mask the same
    in its padded bucket as alone, and equal to views_fused; rows equal
    predict_batched under the id-keyed masks bit for bit in their bucket;
    the meter's delivery ratio the masks' fraction."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    topo = LF.with_links(T.star(cfg.num_clients), LF.LinkModel(**SERVE_LINK))
    scheme = schemes.get("inl")
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(17),
                        device=DEV)
    imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
    views = multiview.make_views(imgs, cfg.noise_stds)
    engine = ServingEngine(scheme, state, cfg, topology=topo,
                           deadline_ms=SERVE_DEADLINE_MS, buckets=BUCKETS,
                           seed=18, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    reset_launches()
    futs, view_of = [], {}

    def submit():
        m = len(futs) % N_REQUESTS
        rid, fut = engine.submit(views[:, m])
        view_of[rid] = m
        futs.append(fut)
        return fut

    with engine:
        for k in (1, 2, 4, 7, 16, 33, 64) * 2:
            burst = [submit() for _ in range(k)]
            for f in burst:
                f.result(timeout=60)
        t0 = time.perf_counter()
        flood = [submit() for _ in range(N_REQUESTS)]
        for f in flood:
            f.result(timeout=60)
        wall = time.perf_counter() - t0
    launches = read_launches()
    results = [f.result(timeout=60) for f in futs]
    stats = engine.stats
    expect_launches(launches, {"cut_fwd": stats.launches}, "lossy serving")
    key = LF.key(18)
    rids = np.array([r.rid for r in results])
    alone = LF.request_delivery_mask(key, topo, cfg, rids,
                                     deadline=SERVE_DEADLINE_MS)
    check([r.views_fused for r in results] == alone.sum(0).tolist(),
          "lossy serving: views_fused differs from the id-keyed masks")
    miss = 1.0 - float(alone.mean())
    n_views = alone.size
    bound = 5.0 * np.sqrt(np.exp(-1.0) * (1 - np.exp(-1.0)) / n_views)
    check(abs(miss - np.exp(-1.0)) <= bound,
          f"lossy serving: {miss} of the views missed, expected e^-1 within "
          f"{bound}")
    check(np.isclose(engine.meter.delivery_ratio, float(alone.mean()),
                     rtol=1e-12, atol=0),
          f"lossy serving: meter delivery ratio {engine.meter.delivery_ratio}"
          f" != the masks' {float(alone.mean())}")
    checked = 0
    for b in sorted({r.bucket for r in results}):
        rows = [r for r in results if r.bucket == b]
        for c in range(0, len(rows), b):
            chunk = rows[c:c + b]
            ids = [r.rid for r in chunk]
            ids += [ids[-1]] * (b - len(ids))
            mask = LF.request_delivery_mask(key, topo, cfg, ids,
                                            deadline=SERVE_DEADLINE_MS)
            pos = [int(np.flatnonzero(rids == r.rid)[0]) for r in chunk]
            check(np.array_equal(mask[:, :len(chunk)], alone[:, pos]),
                  f"lossy serving: a request's mask moved in bucket {b}")
            idx = [view_of[r.rid] for r in chunk]
            idx += [idx[-1]] * (b - len(idx))
            ref = scheme.predict_batched(state, views[:, idx],
                                         delivery=mask, cfg=cfg, device=DEV)
            ref = ref.cpu().numpy()[:len(chunk)]
            got = np.stack([r.probs for r in chunk])
            check(np.array_equal(got, ref),
                  f"lossy serving: rows differ from predict_batched in "
                  f"bucket {b}: max {np.abs(got - ref).max()}")
            checked += len(chunk)
    probs = np.stack([r.probs for r in results])
    check(np.isfinite(probs).all()
          and np.abs(probs.sum(-1) - 1.0).max() <= 1e-5,
          "lossy serving: rows not finite or not summing to 1")
    print(f"linkfault: served the star with LinkModel({SERVE_LINK}) and "
          f"deadline_ms={SERVE_DEADLINE_MS}: {len(results)} requests in "
          f"{stats.launches} engine launches over buckets "
          f"{sorted({r.bucket for r in results})}; {miss:.4f} of "
          f"{n_views} views missed (e^-1 = {np.exp(-1.0):.4f}); {checked} "
          f"rows == predict_batched(cuda) under the id-keyed masks bit for "
          f"bit in their bucket, every mask the same as its request's "
          f"alone; delivery ratio {engine.meter.delivery_ratio!r}; flood "
          f"of {N_REQUESTS} at {N_REQUESTS / wall:.1f} requests/s, p50 "
          f"latency {statistics.median(stats.latencies_ms[-N_REQUESTS:]):.3f}"
          f" ms; launches {launches} [{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# 6d. the hybrid schemes (SplitFed, hybrid FL/SL) at full width
# ---------------------------------------------------------------------------

HYBRIDS = ("splitfed", "hybrid")
HYBRID_SAMPLES = 1024               # 16 rounds of 64 in one epoch
# the reference's ledgers (src/repro/core/schemes/{splitfed,hybrid}.py) at
# PaperExperimentConfig(), batch 64, hybrid_fl_clients=(0,): (bits,
# measured bytes) of one round, by run
HYBRID_CLOSED = {
    ("dense", "splitfed"): (115_220_480, 14_402_560),
    ("dense", "hybrid"): (23_872_128, 2_984_016),
    ("dense cut_depth=1", "splitfed"): (337_203_200, 42_150_400),
    ("dense cut_depth=1", "hybrid"): (68_268_672, 8_533_584),
    ("packed_duplex b=4", "splitfed"): (114_073_600, 14_259_200),
    ("packed_duplex b=4", "hybrid"): (22_954_624, 2_869_328),
}
HYBRID_SEED_TRIES = 1000


def hybrid_runs():
    """(label, config, topology, wire) of the hybrids' training runs: the
    dense star, the client trunk cut after its first block, the frontier
    bench's width (benchmarks/frontier_bench.py: link_bits 4 on the duplex
    wire) and the packed chain(5)."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import topology as T

    cfg = PaperExperimentConfig()
    return (("dense", cfg, None, "dense"),
            ("dense cut_depth=1", dataclasses.replace(cfg, cut_depth=1),
             None, "dense"),
            ("packed_duplex b=4", PaperExperimentConfig(link_bits=4), None,
             "packed_duplex"),
            ("chain(5) packed b=8", PaperExperimentConfig(link_bits=WIRE_BITS),
             T.chain(5), "packed"))


def hybrid_round_charges(name, cfg, topo, wire, state):
    """{edge: (bits, bytes)} of one round at batch 64 from the shapes alone,
    apart from the schemes' ledgers: an edge carrying n_cut cut latents and
    n_w weight exchanges moves 2 * 64 * n_cut * d * b bits of activations
    and error vectors (fp32 values, or lanes of 32 // b codewords on a
    packed direction) plus 2 * n_w * 32 * N bits of fp32 weights, N the
    client-side parameters counted in `state` (SplitFed: every payload
    client's encoder; hybrid: the weight-mode clients' encoder and branch
    head)."""
    from repro_torch import tree_leaves
    J, d, b = cfg.num_clients, cfg.d_bottleneck, cfg.link_bits
    n = sum(t.numel() for t in tree_leaves(state["params"]["encoders"])) // J
    weight = set()
    if name == "hybrid":
        weight = set(cfg.hybrid_fl_clients)
        n += d * cfg.num_classes + cfg.num_classes
    value = 4 * d
    lanes = 4 * -(-d // (32 // b)) if b <= 16 else None
    out = {}
    for e in topo.topo_edges():
        pay = topo.payload(e)
        n_cut = len(pay) if name == "splitfed" \
            else sum(j not in weight for j in pay)
        n_w = len(pay) if name == "splitfed" else len(pay) - n_cut
        rows = TRAIN_BATCH * n_cut
        fwd = rows * (value if wire == "dense" else lanes)
        bwd = rows * (lanes if wire == "packed_duplex" else value)
        out[e.key] = (2 * rows * d * b + 2 * n_w * 32 * n,
                      fwd + bwd + 2 * n_w * 4 * n)
    return out


def hybrid_launches(wire, topo, rounds):
    """The cut-layer launches of `rounds` training rounds and one
    evaluation: one cut per round (and one for the evaluation), the packed
    star's pack-emitting cut and unpack, a packed graph's pack and unpack
    on every hop."""
    if topo is not None:
        hops = len(topo.edges)
        return {"cut_fwd": rounds + 1, "cut_bwd": rounds,
                "pack": hops * rounds, "unpack_dequant": hops * rounds}
    if wire == "dense":
        return {"cut_fwd": rounds + 1, "cut_bwd": rounds}
    return {"cut_fwd_pack": rounds, "unpack_dequant": rounds,
            "cut_bwd": rounds, "cut_fwd": 1}


def hybrids_training_phase(torch, card_line):
    """run_scheme of both hybrids on each of `hybrid_runs`, 16 rounds,
    launch counts set to 0 just before and read just after: the loss falls,
    the launches as `hybrid_launches` predicts, the meter's per-edge bits
    and bytes 16 x `hybrid_round_charges` and, on the star, 16 x the
    reference's closed forms.  Returns ({"scheme run": launches}, {scheme:
    (config, the dense run's trained state)})."""
    from repro_torch.core import topology as T

    out, trained = {}, {}
    rounds = HYBRID_SAMPLES // TRAIN_BATCH
    for label, cfg, topo, wire in hybrid_runs():
        views, labels = training_data(cfg, HYBRID_SAMPLES)
        graph = topo or T.star(cfg.num_clients)
        for name in HYBRIDS:
            states = []
            curve, loss, launches, meter, wall, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=1, wire=wire,
                topology=topo, states=states)
            check(len(loss) == rounds, f"{name} {label}: {len(loss)} rounds")
            first, last = falls(loss)
            expect_launches(launches, hybrid_launches(wire, topo, rounds),
                            f"{name} {label}")
            charges = hybrid_round_charges(name, cfg, graph, wire,
                                           states[-1][1])
            check(meter.edge_bits == {k: rounds * b
                                      for k, (b, _) in charges.items()}
                  and meter.edge_measured_bytes == {
                      k: rounds * n for k, (_, n) in charges.items()},
                  f"{name} {label}: per-edge bits {meter.edge_bits}, bytes "
                  f"{meter.edge_measured_bytes}, closed form {charges}")
            bits = sum(b for b, _ in charges.values())
            nbytes = sum(n for _, n in charges.values())
            if (label, name) in HYBRID_CLOSED:
                check((bits, nbytes) == HYBRID_CLOSED[label, name],
                      f"{name} {label}: ({bits}, {nbytes}) a round, the "
                      f"reference's {HYBRID_CLOSED[label, name]}")
            check(meter.total_bits == rounds * bits
                  and meter.measured_bytes == rounds * nbytes
                  and meter.delivery_ratio == 1.0,
                  f"{name} {label}: meter {meter.total_bits} bits, "
                  f"{meter.measured_bytes} bytes")
            out[f"{name} {label}"] = launches
            if label == "dense":
                trained[name] = (cfg, states[-1][1])
            print(f"hybrids: run_scheme('{name}') {label} (link_bits="
                  f"{cfg.link_bits}, cut_depth {cfg.cut_depth}, "
                  f"{'star' if topo is None else 'chain(5)'}), {rounds} "
                  f"rounds in {wall:.2f} s; loss {loss[0]:.4f} -> "
                  f"{loss[-1]:.4f} (first 4 {first:.4f}, last 4 {last:.4f}); "
                  f"accuracy {curve[-1].accuracy:.4f}; {bits} bits and "
                  f"{nbytes} bytes a round (metered == closed form per "
                  f"edge); launches {launches} [{card_line}]")
    return out, trained


def _hybrid_lossy_seed(topo, cfg, rounds):
    """The first seed whose round masks include a round with some but not
    all routes dead, one with route 0 (hybrid's weight client) dead and one
    with it alive."""
    from repro_torch.core import linkfault as LF
    J = cfg.num_clients
    for seed in range(HYBRID_SEED_TRIES):
        masks = [LF.round_delivery_mask(LF.round_key(seed, r), topo, cfg,
                                        TRAIN_BATCH, train=True)
                 for r in range(rounds)]
        if any(0 < m.sum() < J for m in masks) \
                and any(not m[0] for m in masks) and any(m[0] for m in masks):
            return seed, masks
    raise CheckFailed("no seed gives the lossy rounds the checks need")


def hybrids_faults_phase(torch, card_line):
    """Perfect links (PERFECT_STEPS rounds of each scheme: LinkModel() on
    every edge == no link model, bit for bit), then both schemes through
    run_scheme at erasure HEADLINE_ERASURE an edge of the star for 16
    rounds, launch counts set to 0 just before and read just after: the
    launches of the clean network, the meter's delivery ratio the replayed
    masks' payload fraction, and each round's state against its mask:
    SplitFed's survivors hold one average bit for bit while a dead client
    keeps its own update, not that average; the hybrid's weight client 0
    keeps its previous encoder and branch-head rows bit for bit exactly
    when its route died.  Returns {"scheme lossy star": launches}."""
    from repro_torch import tree_leaves
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T

    cfg = PaperExperimentConfig()
    star = T.star(cfg.num_clients)
    perfect_equals_bare(torch, card_line, [
        (f"{name} star", name, cfg, star, "dense", PERFECT_STEPS)
        for name in HYBRIDS], "hybrids")
    lossy = LF.with_links(star, LF.LinkModel(erasure=HEADLINE_ERASURE))
    rounds = LOSSY_STEPS
    seed, masks = _hybrid_lossy_seed(lossy, cfg, rounds)
    views, labels = training_data(cfg, rounds * TRAIN_BATCH)
    out = {}
    for name in HYBRIDS:
        states = []
        curve, loss, launches, meter, wall, _ = recorded_run(
            torch, name, cfg, views, labels, epochs=1, seed=seed,
            topology=lossy, states=states)
        expect_launches(launches, hybrid_launches("dense", None, rounds),
                        f"lossy {name}")
        charges = hybrid_round_charges(name, cfg, lossy, "dense",
                                       states[0][0])
        delivered = sum(charges[e.key][0] * float(np.mean(m[list(
            lossy.payload(e))])) for m in masks for e in lossy.edges)
        ratio = delivered / (rounds * sum(b for b, _ in charges.values()))
        check(np.isclose(meter.delivery_ratio, ratio, rtol=1e-12, atol=0)
              and ratio < 1.0,
              f"lossy {name}: meter delivery ratio {meter.delivery_ratio} "
              f"!= the masks' {ratio}")
        checked = []
        for r, ((before, after), m) in enumerate(zip(states, masks)):
            enc = tree_leaves(after["params"]["encoders"])
            if name == "splitfed":
                if not 0 < m.sum() < len(m):
                    continue
                alive = np.flatnonzero(m)
                for x in enc:
                    check(all(same_bits(x[alive[0]], x[j]) for j in alive),
                          f"lossy splitfed round {r}: survivors differ")
                for j in np.flatnonzero(~m):
                    check(not same_bits(enc[0][j], enc[0][alive[0]]),
                          f"lossy splitfed round {r}: dead client {j} holds "
                          f"the survivors' average")
            else:
                enc += tree_leaves(after["params"]["decoder"]["branch_heads"])
                prev = tree_leaves((before["params"]["encoders"],
                                    before["params"]["decoder"]
                                    ["branch_heads"]))
                kept = all(same_bits(a[0], b[0]) for a, b in zip(enc, prev))
                check(kept == (not m[0]),
                      f"lossy hybrid round {r}: weight client 0's route "
                      f"{'died' if not m[0] else 'held'} but its rows "
                      f"{'moved' if not kept else 'stayed'}")
                check(not same_bits(enc[0][1], prev[0][1]),
                      f"lossy hybrid round {r}: cut client 1 did not move")
            checked.append(r)
        out[f"{name} lossy star"] = launches
        print(f"hybrids: run_scheme('{name}') on the star at erasure "
              f"{HEADLINE_ERASURE} an edge (seed {seed}), {rounds} rounds in "
              f"{wall:.2f} s; loss {loss[0]:.4f} -> {loss[-1]:.4f}; accuracy "
              f"{curve[-1].accuracy:.4f}; delivery ratio "
              f"{meter.delivery_ratio!r} == the masks' {ratio!r}; rounds "
              f"{checked} checked against their masks bit for bit; "
              f"launches {launches} [{card_line}]")
    return out


def hybrids_card_vs_cpu(torch, card_line):
    """One round of each scheme from one state and one set of dropout masks
    drawn on the CPU and moved to the card: the loss and every gradient
    leaf at the phase-6 bar (grads_close), and the round's loss on both
    within rtol 1e-3."""
    from repro_torch import tree_leaves, tree_map, value_and_grad
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import paper_model, schemes

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    v = torch.from_numpy(views[:, :TRAIN_BATCH])
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).long()
    for k, name in enumerate(HYBRIDS):
        scheme = schemes.get(name)
        cpu = scheme.init(cfg, torch.Generator().manual_seed(21 + k),
                          device="cpu")
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        masks = paper_model.decoder_dropout_masks(
            torch.Generator().manual_seed(23 + k), cfg.dense_units,
            TRAIN_BATCH)
        res = {}
        for dev, st in (("cpu", cpu), (DEV, gpu)):
            modes = (st["modes"],) if name == "hybrid" else ()
            drop = [m.to(dev) for m in masks]
            loss, _, grads = value_and_grad(
                scheme._loss, st["params"], st["state"], *modes, v.to(dev),
                lab.to(dev), cfg, wire="dense", topo=None, delivery=None,
                drop_masks=drop)
            _, m = scheme.make_round(cfg)(st, v[None].to(dev),
                                          lab[None].to(dev), None,
                                          drop_masks=drop)
            res[dev] = (float(loss), tree_leaves(grads), float(m["loss"]))
        (l_cpu, g_cpu, r_cpu), (l_gpu, g_gpu, r_gpu) = res["cpu"], res[DEV]
        max_leaf, max_abs, off = grads_close(l_gpu, l_cpu, g_gpu, g_cpu,
                                             name)
        check(np.isclose(r_gpu, r_cpu, rtol=1e-3, atol=0),
              f"{name}: the round's loss card {r_gpu} vs cpu {r_cpu}")
        print(f"hybrids: one {name} round, card against the CPU port: loss "
              f"{l_gpu:.7f} / {l_cpu:.7f}; {len(g_gpu)} gradient leaves "
              f"within rtol 1e-3 atol 1e-5 as tensors, largest |card - cpu|"
              f" / |cpu| of a leaf {max_leaf:.3g}, largest entry difference "
              f"{max_abs:.3g}, {off} entries outside the bar taken entry by "
              f"entry [{card_line}]")


def hybrids_serving_phase(torch, card_line, trained):
    """Each scheme's trained state served by a ServingEngine over buckets
    (1, 4, 16, 64), on the clean star and with LinkModel(erasure=0.3) on
    every edge, launch counts set to 0 just before and read just after:
    one cut_fwd an engine launch; rows finite, summing to 1 and equal bit
    for bit to predict_batched in their bucket (under the id-keyed masks on
    the lossy star).  Returns {"scheme served ...": launches}."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    out = {}
    for name, (cfg, state) in trained.items():
        scheme = schemes.get(name)
        imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
        views = multiview.make_views(imgs, cfg.noise_stds)
        lossy = LF.with_links(T.star(cfg.num_clients),
                              LF.LinkModel(erasure=HEADLINE_ERASURE))
        for label, topo in (("clean star", None), ("lossy star", lossy)):
            engine = ServingEngine(scheme, state, cfg, topology=topo,
                                   buckets=BUCKETS, seed=24, device=DEV)
            engine.warmup()
            torch.cuda.synchronize()
            reset_launches()
            futs, view_of = [], {}
            with engine:
                for k in (1, 2, 4, 7, 16, 33, 64) * 2:
                    burst = []
                    for _ in range(k):
                        rid, fut = engine.submit(views[:, len(futs)
                                                       % N_REQUESTS])
                        view_of[rid] = len(futs) % N_REQUESTS
                        futs.append(fut)
                        burst.append(fut)
                    for f in burst:
                        f.result(timeout=60)
            launches = read_launches()
            results = [f.result(timeout=60) for f in futs]
            stats = engine.stats
            expect_launches(launches, {"cut_fwd": stats.launches},
                            f"{name} served on the {label}")
            checked = 0
            for b in sorted({r.bucket for r in results}):
                rows = [r for r in results if r.bucket == b]
                for c in range(0, len(rows), b):
                    chunk = rows[c:c + b]
                    ids = [r.rid for r in chunk]
                    ids += [ids[-1]] * (b - len(ids))
                    mask = None if topo is None else \
                        LF.request_delivery_mask(LF.key(24), topo, cfg, ids)
                    idx = [view_of[i] for i in ids]
                    ref = scheme.predict_batched(
                        state, views[:, idx], delivery=mask, topology=topo,
                        cfg=cfg, device=DEV).cpu().numpy()[:len(chunk)]
                    got = np.stack([r.probs for r in chunk])
                    check(np.array_equal(got, ref),
                          f"{name} served on the {label}: rows differ from "
                          f"predict_batched in bucket {b}: max "
                          f"{np.abs(got - ref).max()}")
                    checked += len(chunk)
            probs = np.stack([r.probs for r in results])
            check(np.isfinite(probs).all()
                  and np.abs(probs.sum(-1) - 1.0).max() <= 1e-5,
                  f"{name} served on the {label}: rows not finite or not "
                  f"summing to 1")
            ratio = engine.meter.delivery_ratio
            check((ratio == 1.0) == (topo is None),
                  f"{name} served on the {label}: delivery ratio {ratio}")
            out[f"{name} served {label}"] = launches
            print(f"hybrids: served {name} on the {label}: {len(results)} "
                  f"requests in {stats.launches} engine launches over "
                  f"buckets {sorted({r.bucket for r in results})}, {checked}"
                  f" rows == predict_batched(cuda) bit for bit in their "
                  f"bucket; delivery ratio {ratio!r}; launches {launches} "
                  f"[{card_line}]")
    return out


def hybrids_phase(torch, card_line):
    """The hybrid schemes on the card: training, faults, card against CPU,
    serving.  Returns {run: launches} over all of them."""
    launches, trained = hybrids_training_phase(torch, card_line)
    launches.update(hybrids_faults_phase(torch, card_line))
    hybrids_card_vs_cpu(torch, card_line)
    launches.update(hybrids_serving_phase(torch, card_line, trained))
    return launches


# ---------------------------------------------------------------------------
# 6e. CUDA graphs: one dispatch per round, per bucket and per token
# ---------------------------------------------------------------------------

GRAPH_ROUNDS = 16                   # one epoch of 16 rounds a run
GRAPH_SEED = 0     # at erasure 0.3: SL skips rounds 1 and 13, FL averages
                   # over all, 4, 3 and 2 uploads (four signatures)
GRAPH_ERASURE = 0.3                 # benchmarks/links_bench.py's headline
GRAPH_SERVE_BATCHES = 3             # batches per bucket
GRAPH_TIME_ROUNDS = {"fl": 4}       # rounds an epoch in the timing (else 16)


def dispatch_runs():
    """(label, scheme, cfg, wire, topology) of the graphs phase: the six
    schemes on the dense star, INL on the packed and duplex wires and the
    packed chain(5), then each scheme at erasure 0.3 an edge."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T
    cfg = PaperExperimentConfig()
    wire_cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    prior = dataclasses.replace(cfg, learned_prior=True)
    six = (("inl", "inl", cfg), ("inl+learned_prior", "inl", prior),
           ("sl", "sl", cfg), ("fl", "fl", cfg),
           ("splitfed", "splitfed", cfg), ("hybrid", "hybrid", cfg))
    lossy = LF.with_links(T.star(cfg.num_clients),
                          LF.LinkModel(erasure=GRAPH_ERASURE))
    runs = [(label, name, c, "dense", None) for label, name, c in six]
    runs += [("inl packed", "inl", wire_cfg, "packed", None),
             ("inl packed_duplex", "inl", wire_cfg, "packed_duplex", None),
             ("inl chain(5) packed", "inl", wire_cfg, "packed",
              T.chain(wire_cfg.num_clients))]
    runs += [(f"{label} lossy", name, c, "dense", lossy)
             for label, name, c in six]
    return runs


def expected_signatures(name, cfg, wire, topology, rounds, first=0):
    """The host signatures of a run's rounds `first`..`first + rounds - 1`:
    each round's host part on its fault key, as run_scheme hands them
    out."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    plan, _ = schemes.get(name).make_round_parts(cfg, wire=wire,
                                                 topology=topology)
    faulty = LF.active(T.resolve(topology, cfg), cfg, train=True)
    return {plan(LF.round_key(GRAPH_SEED, g) if faulty else None,
                 TRAIN_BATCH)[0] for g in range(first, first + rounds)}


def ledgers(meter):
    return (meter.total_bits, meter.measured_bytes, meter.delivered_bits,
            meter.delivered_measured_bytes, dict(meter.edge_bits),
            dict(meter.edge_measured_bytes), dict(meter.edge_delivered_bits))


def graph_training_phase(torch, card_line):
    """Each run of `dispatch_runs` for one epoch of 16 rounds under "scan"
    and under "per_round" from one seed, deterministic algorithms on: the
    per-round losses and every leaf of the final state bit for bit, the
    same launches per kernel, the same offered and delivered ledgers and
    curve, and exactly one capture per host signature.  Returns ({label:
    scan launches}, the trained INL state)."""
    from repro_torch import tree_leaves
    from repro_torch.core import schemes

    torch.use_deterministic_algorithms(True, warn_only=True)
    out, trained = {}, None
    data = {}
    try:
        for label, name, cfg, wire, topo in dispatch_runs():
            bpr = schemes.get(name).batches_per_round(cfg)
            n = GRAPH_ROUNDS * bpr * TRAIN_BATCH
            if n not in data:
                data[n] = training_data(cfg, n)
            views, labels = data[n]
            caps, runs = {}, {}
            for dispatch in ("scan", "per_round"):
                states = []
                curve, loss, launches, meter, wall, _ = recorded_run(
                    torch, name, cfg, views, labels, epochs=1, wire=wire,
                    seed=GRAPH_SEED, topology=topo, states=states,
                    dispatch=dispatch, captures=caps)
                runs[dispatch] = (curve, loss, states[-1][1], launches,
                                  meter, wall)
            (c_s, l_s, s_s, n_s, m_s, w_s), (c_r, l_r, s_r, n_r, m_r, w_r) \
                = runs["scan"], runs["per_round"]
            check(len(l_s) == len(l_r) == GRAPH_ROUNDS,
                  f"graphs {label}: {len(l_s)} / {len(l_r)} rounds")
            # python floats of fp32 losses: equal iff the bits are
            check(l_s == l_r, f"graphs {label}: scan losses {l_s} != "
                              f"per_round {l_r}")
            leaves_s, leaves_r = tree_leaves(s_s), tree_leaves(s_r)
            check(len(leaves_s) == len(leaves_r) and all(
                torch.equal(a, b) for a, b in zip(leaves_s, leaves_r)),
                f"graphs {label}: the final states differ")
            check(n_s == n_r, f"graphs {label}: launches scan {n_s} "
                              f"per_round {n_r}")
            check(ledgers(m_s) == ledgers(m_r) and c_s == c_r,
                  f"graphs {label}: ledgers or curves differ")
            want = expected_signatures(name, cfg, wire, topo, GRAPH_ROUNDS)
            check(set(caps) == want and all(v == 1 for v in caps.values()),
                  f"graphs {label}: captures {caps}, signatures {want}")
            out[label] = {k: v for k, v in n_s.items() if v}
            if label == "inl":
                trained = s_s
            print(f"graphs: run_scheme('{name}') {label} (wire={wire}, "
                  f"link_bits={cfg.link_bits}), {GRAPH_ROUNDS} rounds: "
                  f"scan == per_round bit for bit (losses, {len(leaves_s)} "
                  f"state leaves), launches {out[label]} under both, "
                  f"delivery ratio {m_s.delivery_ratio:.5f} under both, "
                  f"captures {caps}; loss {l_s[0]:.4f} -> {l_s[-1]:.4f}; "
                  f"wall scan {w_s:.2f} s, per_round {w_r:.2f} s "
                  f"[{card_line}]")
    finally:
        torch.use_deterministic_algorithms(False)
    return out, trained


def graph_serving_check(torch, card_line, state):
    """The trained INL state served over buckets (1, 4, 16, 64), clean and
    at erasure 0.3 an edge: after warmup() and GRAPH_SERVE_BATCHES batches
    of b requests per bucket, trace_counts == {b: 1}, and every batch's
    rows equal predict_batched (eager) bit for bit.  Returns the launches
    of the clean engine's batches."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    scheme = schemes.get("inl")
    n = GRAPH_SERVE_BATCHES * sum(BUCKETS)
    imgs, _ = multiview.make_base_dataset(n, seed=cfg.seed + 3)
    views = multiview.make_views(imgs, cfg.noise_stds)
    lossy = LF.with_links(T.star(cfg.num_clients),
                          LF.LinkModel(erasure=GRAPH_ERASURE))
    launches = None
    for label, topo in (("clean", None), ("lossy", lossy)):
        engine = ServingEngine(scheme, state, cfg, topology=topo,
                               buckets=BUCKETS, seed=19, device=DEV)
        engine.warmup()
        torch.cuda.synchronize()
        reset_launches()
        batches, at = [], 0
        for b in BUCKETS:
            for _ in range(GRAPH_SERVE_BATCHES):
                block = views[:, at:at + b]
                at += b
                batches.append((b, block) + engine.serve(block))
        torch.cuda.synchronize()
        got = read_launches()
        rows = 0
        for b, block, probs, served in batches:
            check({r.bucket for r in served} == {b},
                  f"graphs serving: a block of {b} rode buckets "
                  f"{ {r.bucket for r in served} }")
            mask = None
            if topo is not None:
                mask = LF.request_delivery_mask(
                    LF.key(19), topo, cfg, [r.rid for r in served])
            want = scheme.predict_batched(state, block, delivery=mask,
                                          cfg=cfg, device=DEV).cpu().numpy()
            check(np.array_equal(probs, want),
                  f"graphs serving {label}: bucket {b} rows differ from "
                  f"the eager predict_batched: max "
                  f"{np.abs(probs - want).max()}")
            rows += b
        check(engine.trace_counts == {b: 1 for b in BUCKETS},
              f"graphs serving {label}: trace_counts {engine.trace_counts}")
        check(got["cut_fwd"] == engine.stats.launches,
              f"graphs serving {label}: cut_fwd {got['cut_fwd']} in "
              f"{engine.stats.launches} engine launches")
        if launches is None:
            launches = {k: v for k, v in got.items() if v}
        print(f"graphs: served the trained INL state {label} over buckets "
              f"{BUCKETS}, {GRAPH_SERVE_BATCHES} batches each: trace_counts "
              f"{engine.trace_counts}, {rows} rows == eager predict_batched "
              f"bit for bit, cut_fwd {got['cut_fwd']} in "
              f"{engine.stats.launches} engine launches [{card_line}]")
    return launches


def graphs_phase(torch, card_line):
    """Training and serving under CUDA graphs.  Returns ({run: launches}
    of the scan runs and the served batches, the trained INL state)."""
    t0 = time.perf_counter()
    launches, trained = graph_training_phase(torch, card_line)
    launches["served (graphs)"] = graph_serving_check(torch, card_line,
                                                      trained)
    print(f"graphs: phase took {time.perf_counter() - t0:.1f} s")
    return launches, trained


# ---------------------------------------------------------------------------
# 6f. checkpoints: resume bit for bit
# ---------------------------------------------------------------------------

CKPT_EPOCHS = 2                     # the uninterrupted run; resumed at 1
CKPT_TIMING_REPS = 3


def checkpoint_runs():
    """(label, scheme, cfg, wire, topology, dispatch) of the checkpoint
    phase: the six golden runs on the dense star under "scan", INL under
    "per_round", INL on links_bench's lossy star (erasure 0.3 an edge,
    edge dropout 0.2) and INL on the packed wire."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    runs = [(label, name, cfg, "dense", None, "scan")
            for label, name, cfg, _, _ in dispatch_runs()[:6]]
    _, _, lossy_cfg, lossy_star, _, _ = lossy_runs()[0]
    runs += [("inl per_round", "inl", PaperExperimentConfig(), "dense",
              None, "per_round"),
             ("inl lossy star", "inl", lossy_cfg, "dense", lossy_star,
              "scan"),
             ("inl packed", "inl", PaperExperimentConfig(
                 link_bits=WIRE_BITS), "packed", None, "scan")]
    return runs


def same_checkpoints(checkpoint, d1, d2, step):
    """Checkpoint `step` of two directories: every array bit for bit and
    the sidecars (curve, ledgers, generator state) equal.  Returns the
    number of arrays."""
    import os
    p1, p2 = (os.path.join(d, f"ckpt_{step:08d}.npz") for d in (d1, d2))
    with np.load(p1) as a, np.load(p2) as b:
        check(sorted(a.files) == sorted(b.files) and len(a.files) > 0,
              f"checkpoints {p1} and {p2} hold other leaves")
        for key in a.files:
            check(a[key].dtype == b[key].dtype
                  and a[key].tobytes() == b[key].tobytes(),
                  f"checkpoint leaf {key} differs between {p1} and {p2}")
        n = len(a.files)
    check(checkpoint.load_meta(d1, step) == checkpoint.load_meta(d2, step),
          f"the sidecars of {p1} and {p2} differ")
    return n


def checkpoint_timing(torch, checkpoint, cfg, d, card_line):
    """Save and restore ms of the trained INL state at full width (the
    median of CKPT_TIMING_REPS, host clock, the restore ending in a
    synchronize) and the npz's size."""
    import os
    from repro_torch import tree_leaves
    from repro_torch.core import schemes
    template = schemes.get("inl").init(cfg, 0, device=DEV)
    torch.cuda.synchronize()
    restore_ms, save_ms = [], []
    for _ in range(CKPT_TIMING_REPS):
        t0 = time.perf_counter()
        state, step = checkpoint.restore(d, template)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    out = os.path.join(d, "timed")
    for i in range(CKPT_TIMING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(out, i, state)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    mb = os.path.getsize(path) / 1e6
    n = sum(t.numel() for t in tree_leaves(state))
    print(f"checkpoint times: the INL state at PaperExperimentConfig() "
          f"({n} values with the optimizer's) save "
          f"{statistics.median(save_ms):.3f} ms, restore onto the card "
          f"{statistics.median(restore_ms):.3f} ms (medians of "
          f"{CKPT_TIMING_REPS}, host clock), npz {mb:.3f} MB [{card_line}]")
    return statistics.median(save_ms), statistics.median(restore_ms), mb


def checkpoint_phase(torch, card_line):
    """Each run of `checkpoint_runs`, deterministic algorithms on: run_scheme
    for CKPT_EPOCHS epochs with ckpt_dir against CKPT_EPOCHS // 2 epochs
    with ckpt_dir and then resume=True to CKPT_EPOCHS: the curves equal,
    the resumed rounds' losses the uninterrupted run's, both final
    checkpoints' leaves and sidecars (ledgers, generator state) bit for
    bit, the meters' ledgers equal, and under "scan" one capture per host
    signature in the resumed run.  Then a directory whose newest npz lost
    its sidecar resumes from the one before, and the save and restore
    times.  Returns ({run: launches of the resumed run}, the timings)."""
    import shutil
    from repro_torch import checkpoint
    from repro_torch.core import schemes
    from repro_torch.core.schemes import runner

    t_phase = time.perf_counter()
    root = ROOT / "build" / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    half = CKPT_EPOCHS // 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    out, times = {}, None
    try:
        for label, name, cfg, wire, topo, dispatch in checkpoint_runs():
            views, labels = training_data(cfg)
            rounds = runner.rounds_per_epoch(schemes.get(name), cfg,
                                             len(labels), TRAIN_BATCH)
            full, part = (str(root / label.replace(" ", "_") / k)
                          for k in ("full", "part"))
            kw = dict(wire=wire, topology=topo, dispatch=dispatch)
            c_g, l_g, _, m_g, w_g, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=CKPT_EPOCHS,
                ckpt_dir=full, **kw)
            c_h, _, _, _, _, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=half,
                ckpt_dir=part, **kw)
            caps = {}
            c_r, l_r, n_r, m_r, w_r, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=CKPT_EPOCHS,
                ckpt_dir=part, resume=True, captures=caps, **kw)
            check(c_h == c_g[:half] and c_r == c_g,
                  f"checkpoint {label}: resumed curve {c_r} != {c_g}")
            check(l_r == l_g[half * rounds:],
                  f"checkpoint {label}: the resumed rounds' losses differ")
            leaves = same_checkpoints(checkpoint, full, part, CKPT_EPOCHS)
            check(ledgers(m_r) == ledgers(m_g),
                  f"checkpoint {label}: the ledgers differ")
            if dispatch == "scan":
                want = expected_signatures(name, cfg, wire, topo,
                                           (CKPT_EPOCHS - half) * rounds,
                                           first=half * rounds)
                check(set(caps) == want
                      and all(v == 1 for v in caps.values()),
                      f"checkpoint {label}: captures {caps}, signatures "
                      f"{want}")
            out[label] = {k: v for k, v in n_r.items() if v}
            print(f"checkpoint: run_scheme('{name}') {label} ({wire}, "
                  f"{dispatch}), {CKPT_EPOCHS} epochs of {rounds} rounds == "
                  f"{half} + resume=True bit for bit (curve, "
                  f"{len(l_r)} resumed losses, {leaves} state leaves, "
                  f"ledgers, generator state; delivery ratio "
                  f"{m_r.delivery_ratio:.5f}), captures in the resumed run "
                  f"{caps if dispatch == 'scan' else '(per_round)'}, "
                  f"launches {out[label]}; wall {w_g:.2f} s uninterrupted, "
                  f"{w_r:.2f} s resumed [{card_line}]")
            if label == "inl":
                # a save killed between the npz and its sidecar
                import os
                os.remove(os.path.join(part, f"ckpt_{CKPT_EPOCHS:08d}"
                                             ".json"))
                check(checkpoint.latest_step(part) == half,
                      "checkpoint: a sidecarless npz counted")
                c_t = recorded_run(torch, name, cfg, views, labels,
                                   epochs=CKPT_EPOCHS, ckpt_dir=part,
                                   resume=True, **kw)[0]
                check(c_t == c_g, "checkpoint: the resume past a torn "
                                  "checkpoint differs")
                print(f"checkpoint: epoch {CKPT_EPOCHS}'s sidecar removed, "
                      f"resume=True went on from epoch {half}: the curve "
                      f"== the uninterrupted one [{card_line}]")
                times = checkpoint_timing(torch, checkpoint, cfg, full,
                                          card_line)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    print(f"checkpoint: phase took {time.perf_counter() - t_phase:.1f} s")
    return out, times


# ---------------------------------------------------------------------------
# 6g. the placement search
# ---------------------------------------------------------------------------

SEARCH_EPOCHS = 2


def search_grid():
    """The spaces of benchmarks/frontier_bench.py's build_grid(smoke=True),
    copied: INL on star(5) and chain(5) at 32 bits dense and at 4 bits on
    packed_duplex, splitfed and hybrid on star(5) at cut depth None and 1
    on both, fl and sl on star(5): 14 points."""
    from repro_torch.search.space import SearchSpace, merge_points
    topos, star, widths = ("star(5)", "chain(5)"), ("star(5)",), (4,)
    return merge_points(
        SearchSpace(schemes=("inl",), topologies=topos),
        SearchSpace(schemes=("inl",), topologies=topos, link_bits=widths,
                    wires=("packed_duplex",)),
        SearchSpace(schemes=("splitfed", "hybrid"), topologies=star,
                    cut_depths=(None, 1)),
        SearchSpace(schemes=("splitfed", "hybrid"), topologies=star,
                    link_bits=widths, wires=("packed_duplex",),
                    cut_depths=(None, 1)),
        SearchSpace(schemes=("fl", "sl"), topologies=star))


def search_phase(torch, card_line):
    """run_search over `search_grid` at PaperExperimentConfig()'s widths
    with TRAIN_SAMPLES samples, batch 64, SEARCH_EPOCHS epochs,
    train_pruned=True, deterministic algorithms on, launch counts set to 0
    just before and read just after: every trained point priced == metered
    == closed form (frontier_bench.assert_parity's bars, |d| x 1e9 < 1
    bit), every pruned point's accuracy == its stand-in's exactly (a
    star-dominated one costlier), a non-empty frontier of candidates.
    Returns the launches."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.search import driver
    from repro_torch.search.pricing import CANDIDATE, PRUNED_STAR

    base = dataclasses.replace(PaperExperimentConfig(),
                               dataset_size=TRAIN_SAMPLES)
    stamps = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        result = driver.run_search(
            search_grid(), base, epochs=SEARCH_EPOCHS,
            batch_size=TRAIN_BATCH, eval_n=256, train_pruned=True,
            log=lambda msg: stamps.append((time.perf_counter(), msg)),
            device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        torch.use_deterministic_algorithms(False)
    priced = {pp.key: pp for pp in result.priced}
    check(len(priced) == 14 and len(result.measured) == 14
          and all(m.trained for m in result.measured.values()),
          f"search: {len(priced)} priced, {len(result.measured)} measured")
    for m in result.measured.values():
        for a, b, what in ((m.gbits, m.priced_gbits, "priced"),
                           (m.measured_gbits, m.priced_measured_gbits,
                            "priced wire"),
                           (m.gbits, m.measured_gbits, "closed-form")):
            check(abs(a - b) * 1e9 < 1.0,
                  f"search {m.key}: {what} {b} Gbit != metered {a} Gbit")
        if m.status != CANDIDATE:
            sib = result.measured[m.stand_in]
            check(m.accuracy == sib.accuracy,
                  f"search {m.key}: accuracy {m.accuracy} != its stand-in "
                  f"{sib.key}'s {sib.accuracy}")
            check(m.status != PRUNED_STAR or m.gbits > sib.gbits,
                  f"search {m.key}: not costlier than its star sibling")
    check(result.frontier and all(m.status == CANDIDATE and m.trained
                                  for m in result.frontier),
          f"search: frontier {[m.key for m in result.frontier]}")
    walls = [b[0] - a[0] for a, b in zip(stamps, stamps[1:])]
    for (key, m), w in zip(result.measured.items(), walls):
        print(f"search: {key} ({m.status}"
              f"{'' if m.stand_in is None else ', stands in: ' + m.stand_in}"
              f") accuracy {m.accuracy:.4f}, {m.gbits:.6f} Gbit accounted "
              f"== metered == priced, measured {m.measured_gbits:.6f} "
              f"Gbit, wall {w:.2f} s [{card_line}]")
    print(f"search: {len(priced)} points priced in "
          f"{stamps[0][0] - t0:.2f} s, all trained ({SEARCH_EPOCHS} epochs "
          f"each, {TRAIN_SAMPLES} samples, batch {TRAIN_BATCH}); frontier "
          f"{[m.key for m in result.frontier]}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase "
          f"{wall:.1f} s [{card_line}]")
    return launches


def graphed_round_timing(torch, card_line, name, *, cfg=None,
                         wire="dense", topology=None):
    """One round of scheme `name` at full width, batch 64 (`cfg`, `wire`
    and `topology` as run_scheme takes them), as the scan dispatch runs
    it: make_epoch's epoch of K rounds on one fixed batch, captured by a
    first call, then timed: wall per round on the host's clock around an
    epoch ending in a synchronize (median of 5 epochs), device time per
    round from CUDA events around 3 epochs (the replays run back to back,
    so this is the device's time with the launch gaps the graph leaves).
    Over unreliable links round k takes the fault key of round k of a run
    seeded 0.  Returns (wall ms, device ms)."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T

    cfg = cfg or PaperExperimentConfig()
    views, labels = training_data(cfg)
    scheme = schemes.get(name)
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(6),
                        device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    R = scheme.batches_per_round(cfg)
    K = GRAPH_TIME_ROUNDS.get(name, GRAPH_ROUNDS)
    v = torch.from_numpy(views[:, :R * TRAIN_BATCH]).to(DEV)
    v = v.reshape((v.shape[0], R, TRAIN_BATCH) + v.shape[2:]).transpose(
        0, 1).contiguous()
    lab = torch.from_numpy(labels[:R * TRAIN_BATCH]).to(DEV).long().reshape(
        R, TRAIN_BATCH)
    ev = v[None].expand((K,) + v.shape)
    el = lab[None].expand((K,) + lab.shape)
    epoch_fn = scheme.make_epoch(cfg, wire=wire, topology=topology)
    faulty = LF.active(T.resolve(topology, cfg), cfg, train=True)
    keys = [LF.round_key(0, g) for g in range(K)] if faulty else None
    box = [state]

    def epoch():
        box[0], _ = epoch_fn(box[0], ev, el, gen, round_keys=keys)
    wall = timed_host(torch, epoch, reps=5) / K
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        epoch()
    end.record()
    torch.cuda.synchronize()
    dev = start.elapsed_time(end) / (3 * K)
    plan, _ = scheme.make_round_parts(cfg, wire=wire, topology=topology)
    want = {plan(None if keys is None else keys[k], TRAIN_BATCH)[0]
            for k in range(K)}
    check(epoch_fn.captures == {sig: 1 for sig in want},
          f"{name}: captures {epoch_fn.captures}")
    return wall, dev


def graphed_predict_timing(torch, card_line, state):
    """Per bucket: the engine's predict (views copied from the host, then
    the bucket's graph) against the eager predict_batched on the same
    views copied the same way, both ending in a synchronize: wall (median
    of 25), and the device time of the predict without the copy (the
    profiler's busy time for eager, CUDA events around 20 back-to-back
    replays of the bucket's graph).  Returns {bucket: (eager wall, eager
    busy, graph wall, graph device)}."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    scheme = schemes.get("inl")
    imgs, _ = multiview.make_base_dataset(BUCKETS[-1], seed=cfg.seed + 4)
    views = multiview.make_views(imgs, cfg.noise_stds)
    engine = ServingEngine(scheme, state, cfg, buckets=BUCKETS, device=DEV)
    engine.warmup()
    out = {}
    for b in BUCKETS:
        pv = np.ascontiguousarray(views[:, :b])
        v_dev = torch.from_numpy(pv).to(DEV)

        def eager():
            scheme.predict_batched(state, torch.from_numpy(pv).to(DEV),
                                   cfg=cfg, device=DEV)

        def graphed():
            engine._predict(pv)            # the engine's bucketed predict
        e_wall = timed_host(torch, eager, reps=25)
        e_busy = device_ms(torch, lambda: scheme.predict_batched(
            state, v_dev, cfg=cfg, device=DEV), reps=10, warmup=2)
        g_wall = timed_host(torch, graphed, reps=25)
        # the bucket's graph itself (the engine's), replayed back to back
        g_dev = cuda_ms(torch, engine._graphs.get(b).replay, reps=20,
                        warmup=2)
        out[b] = (e_wall, e_busy, g_wall, g_dev)
        print(f"graphs times: predict bucket {b} (views from the host): "
              f"eager wall {e_wall:.3f} ms, busy {e_busy:.4f} ms, idle "
              f"{1 - e_busy / e_wall:.3f}; graph wall {g_wall:.3f} ms, "
              f"device {g_dev:.4f} ms, idle {1 - g_dev / g_wall:.3f} "
              f"[{card_line}]")
    check(engine.trace_counts == {b: 1 for b in BUCKETS},
          f"predict timing: trace_counts {engine.trace_counts}")
    return out


def graphs_timing(torch, card_line, eager_steps, state):
    """Graphed rounds of INL, SL, FL, SplitFed and hybrid beside the eager
    rounds of the same run (`eager_steps`: {name: (wall, busy)} from
    train_step_timing), then predict per bucket."""
    rows = {}
    for name in ("inl", "sl", "fl") + HYBRIDS:
        e_wall, e_busy = eager_steps[name]
        g_wall, g_dev = graphed_round_timing(torch, card_line, name)
        rows[name] = (e_wall, e_busy, g_wall, g_dev)
        print(f"graphs times: {name} round (PaperExperimentConfig, batch "
              f"{TRAIN_BATCH}{', ten local steps' if name == 'fl' else ''}):"
              f" eager wall {e_wall:.3f} ms, busy {e_busy:.4f} ms, idle "
              f"{1 - e_busy / e_wall:.3f}; scan (CUDA graph) wall "
              f"{g_wall:.3f} ms, device {g_dev:.4f} ms, idle "
              f"{1 - g_dev / g_wall:.3f}; {e_wall / g_wall:.2f}x "
              f"[{card_line}]")
    # what a graph resolves that separate eager loops could not: the
    # device time a variant adds to the same scheme's dense round
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T
    cfg = PaperExperimentConfig()
    wire_cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    lossy = LF.with_links(T.star(cfg.num_clients),
                          LF.LinkModel(erasure=GRAPH_ERASURE))
    base = {name: rows[name][3] for name in ("inl",) + HYBRIDS}
    base["inl packed"] = graphed_round_timing(torch, card_line, "inl",
                                              cfg=wire_cfg,
                                              wire="packed")[1]
    for label, name, c, wire, topo, ref in (
            ("inl chain(5) packed", "inl", wire_cfg, "packed",
             T.chain(cfg.num_clients), "inl packed"),
            ("inl lossy", "inl", cfg, "dense", lossy, "inl"),
            ("splitfed lossy", "splitfed", cfg, "dense", lossy, "splitfed"),
            ("hybrid lossy", "hybrid", cfg, "dense", lossy, "hybrid")):
        _, dev = graphed_round_timing(torch, card_line, name, cfg=c,
                                      wire=wire, topology=topo)
        rows[label] = (dev, base[ref])
        print(f"graphs times: {label} round device {dev:.4f} ms against "
              f"{ref}'s {base[ref]:.4f} ms in this run: "
              f"{dev - base[ref]:+.4f} ms (CUDA events, scan) "
              f"[{card_line}]")
    rows["predict"] = graphed_predict_timing(torch, card_line, state)
    return rows


# ---------------------------------------------------------------------------
# 7. times
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps=200, warmup=20):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Device ms per call of `fn`: `reps` calls captured in one CUDA graph,
    its replay timed with CUDA events, so the host's launch work is not
    counted however slow it is.  (The profiler's trace dropped most of the
    launches of millisecond kernels in one run on the H100, so the LLM
    kernels are timed this way.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def device_profile(torch, fn, reps=100, warmup=10):
    """(device ms per call, [(kernel name, device ms per call), ...] by
    descending time): the device time of every kernel and copy `fn` runs,
    from torch.profiler's CUDA trace, over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the CUDA trace now and then comes back empty (seen once in 14 runs on
    # the H100); a window is traced again, at most PROFILE_TRIES times
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = sorted(((e.key, e.self_device_time_total / reps / 1e3)
                          for e in prof.key_averages()
                          if e.self_device_time_total > 0),
                         key=lambda kv: -kv[1])
        total = sum(ms for _, ms in by_name)
        if total > 0:
            return total, by_name
    raise CheckFailed(f"the profiler recorded no device time in "
                      f"{PROFILE_TRIES} traces")


def device_ms(torch, fn, reps=100, warmup=10):
    """Device time per call (see device_profile)."""
    return device_profile(torch, fn, reps, warmup)[0]


def timing_phase(torch, scheme, state, views, card_line):
    from repro_torch.kernels import inl_bottleneck, ref
    for b in BUCKETS:
        v = torch.from_numpy(views[:, :b]).to(DEV)

        def predict():
            scheme.predict(state, v, device=DEV)
        times = []
        for i in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict()
            torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(times)
        busy = device_ms(torch, predict, reps=10, warmup=2)
        print(f"predict latency bucket {b}: median {wall:.3f} ms over "
              f"{len(times)} runs; device busy {busy:.4f} ms of it, idle "
              f"share {1 - busy / wall:.3f} [{card_line}]")

    rows = {}
    # R=320: the serving call (bucket 64 x J=5); R=20480: 21 MB, which the
    # 50 MB L2 holds across back-to-back launches; R=262144: 268 MB, which
    # it cannot, so that row runs at device-memory rate
    for R, mode, bits in ((320, "none", 32), (20480, "none", 32),
                          (20480, "sample", 8), (262144, "none", 32),
                          (262144, "sample", 8)):
        d = 64
        mu, lv, eps = cut_inputs(torch, (R, d), torch.float32, 0)
        def kernel():
            inl_bottleneck.cut_fwd(mu, lv, eps, bits=bits, mode=mode)

        def plain():
            ref.cutlayer_fwd_ref(mu, lv, eps, bits, mode)
        k_dev, p_dev = device_ms(torch, kernel), device_ms(torch, plain)
        k_call, p_call = cuda_ms(torch, kernel), cuda_ms(torch, plain)
        nbytes = R * d * (4 + 4 + 4 + 4) + 4 * R
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[(R, mode, bits)] = (k_dev, p_dev, bound)
        print(f"cut_fwd R={R} d={d} {mode} b={bits} fp32: device time "
              f"kernel {k_dev:.5f} ms, plain {p_dev:.5f} ms, bound "
              f"{bound:.5f} ms (bytes {nbytes}, {bound / k_dev:.3f} of the "
              f"bound); per call with the host's launch work kernel "
              f"{k_call:.5f} ms, plain {p_call:.5f} ms [{card_line}]")
    return rows


def train_step_timing(torch, card_line, *, wire="dense", link_bits=32,
                      topology=None, cfg=None, label=None, name="inl"):
    """Train-step latency of scheme `name` (one round: for FL, ten local
    steps) at full width and batch 64 on `wire` (on the star, or on
    `topology` at `cfg`): the median of 20 rounds on the host's clock, and
    the device's busy time per round from the profiler, with its breakdown
    by kernel.  Over unreliable links each step takes the next round's
    fault key, as run_scheme hands them out."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault, schemes
    from repro_torch.core import topology as T

    cfg = cfg or PaperExperimentConfig(link_bits=link_bits)
    label = label or wire
    views, labels = training_data(cfg)
    scheme = schemes.get(name)
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(6),
                        device=DEV)
    round_fn = scheme.make_round(cfg, wire=wire, topology=topology)
    gen = torch.Generator(device=DEV).manual_seed(7)
    # (R, J, B, ...) views and (R, B) labels, R the round's minibatches
    R = scheme.batches_per_round(cfg)
    v = torch.from_numpy(views[:, :R * TRAIN_BATCH]).to(DEV)
    v = v.reshape((v.shape[0], R, TRAIN_BATCH) + v.shape[2:]).transpose(
        0, 1).contiguous()
    lab = torch.from_numpy(labels[:R * TRAIN_BATCH]).to(DEV).long().reshape(
        R, TRAIN_BATCH)
    box = [state]
    faulty = linkfault.active(T.resolve(topology, cfg), cfg, train=True)
    count = [0]

    def step():
        kw = {}
        if faulty:
            kw["round_key"] = linkfault.round_key(0, count[0])
            count[0] += 1
        box[0], _ = round_fn(box[0], v, lab, gen, **kw)
    times = []
    for i in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(times)
    busy, by_name = device_profile(torch, step, reps=10, warmup=2)
    print(f"train step latency ({label}, link_bits={cfg.link_bits}): "
          f"median {wall:.3f} ms over {len(times)} steps "
          f"(PaperExperimentConfig, batch {TRAIN_BATCH}); device busy "
          f"{busy:.4f} ms of it, idle share {1 - busy / wall:.3f} "
          f"[{card_line}]")
    kinds = {}
    for name, ms in by_name:
        low = name.lower()
        kind = ("cut-layer kernels" if "cut_" in low else
                "convolution" if "conv" in low or "cudnn" in low
                or "xmma" in low or "implicit" in low else
                "matmul" if "gemm" in low or "sgemm" in low else
                "copy/fill" if "memcpy" in low or "memset" in low
                or "fill" in low else
                "reduction" if "reduce" in low else "elementwise/other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"train step ({label}) device time by kind: " + ", ".join(
        f"{k} {ms:.4f} ms" for k, ms in sorted(kinds.items(),
                                              key=lambda kv: -kv[1])))
    print(f"train step ({label}) device time, top kernels: " + "; ".join(
        f"{name[:60]} {ms:.4f} ms" for name, ms in by_name[:8]))
    return wall, busy


def new_kernel_timing(torch, card_line):
    """cut_bwd, cut_prior_fwd and cut_prior_bwd: device time at the
    training shape (R = 320 = 5 nodes x 64, d = 64) and at R = 20480 and
    262144 (fp32, sample mode, b = 32 as training runs), beside the bytes
    bound and the plain version."""
    from repro_torch.kernels import inl_bottleneck, ref
    rows = {}
    d, bits, mode = 64, 32, "sample"
    for R in (320, 20480, 262144):
        J = 5 if R % 5 == 0 else 4          # nodes of T rows, J * T == R
        T = R // J
        mu, lv, eps, gu, gr = grad_inputs(torch, (J, T, d), torch.float32, 0)
        pm, pv = prior_inputs(torch, J, d, 0)
        u, _ = inl_bottleneck.cut_prior_fwd(mu, lv, eps, pm, pv, bits=bits,
                                            mode=mode)
        flat = [t.reshape(R, d) for t in (mu, lv, eps, gu)]
        grf = gr.reshape(R)
        reps = 100 if R < 262144 else 30
        cases = {
            "cut_bwd": (
                lambda: inl_bottleneck.cut_bwd(*flat, grf, bits=bits,
                                               mode=mode),
                lambda: ref.cutlayer_bwd_ref(*flat, grf, bits, mode),
                28 * R * d + 4 * R),
            "cut_prior_fwd": (
                lambda: inl_bottleneck.cut_prior_fwd(mu, lv, eps, pm, pv,
                                                     bits=bits, mode=mode),
                lambda: ref.cutlayer_prior_fwd_ref(mu, lv, eps, pm, pv,
                                                   bits, mode),
                16 * R * d + 4 * R + 8 * J * d),
            "cut_prior_bwd": (
                lambda: inl_bottleneck.cut_prior_bwd(mu, lv, eps, pm, pv, u,
                                                     gu, gr, mode=mode),
                lambda: ref.cutlayer_prior_bwd_ref(mu, lv, eps, pm, pv, u,
                                                   gu, gr, bits, mode),
                32 * R * d + 4 * R + 16 * J * d),
        }
        for name, (kernel, plain, nbytes) in cases.items():
            k_dev, launched = device_profile(torch, kernel, reps=reps)
            p_dev = device_ms(torch, plain, reps=reps)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rows[(name, R)] = (k_dev, p_dev, bound)
            earlier = ""
            if name == "cut_prior_bwd":
                stages = FIRST_PRIOR_BWD_STAGES[R]
                names = []
                for k, ms in launched:        # by kernel name
                    m = re.search(r"(\w+)(?:<[^>]*>)?\(", k)
                    names.append(f"{m.group(1) if m else k[:48]} "
                                 f"{ms:.5f} ms")
                earlier = (f" ({' + '.join(names)}; the first design's two "
                           f"launches: {FIRST_DESIGN_MS[name, R]} ms, rows "
                           f"{stages[0]} + reduce {stages[1]} ms, PERF.md)")
            print(f"{name} R={R} d={d} J={J} {mode} b={bits} fp32: device "
                  f"time kernel {k_dev:.5f} ms{earlier}, plain {p_dev:.5f} "
                  f"ms, bound {bound:.5f} ms (bytes {nbytes}, "
                  f"{bound / k_dev:.3f} of the bound) [{card_line}]")
    return rows


def pack_kernel_timing(torch, card_line):
    """cut_fwd_pack, pack and unpack_dequant: device time at the training
    shape (R = 320, d = 64) and at R = 20480 and 262144, fp32, b = 8 (the
    path's width), cut_fwd_pack in the sample mode, beside the bytes bound
    and the plain version."""
    from repro_torch.kernels import inl_bottleneck, ref
    rows = {}
    d, bits, mode = 64, WIRE_BITS, "sample"
    W = ref.packed_width(d, bits)
    for R in (320, 20480, 262144):
        mu, lv, eps = cut_inputs(torch, (R, d), torch.float32, 0)
        u, lanes, _ = inl_bottleneck.cut_fwd_pack(mu, lv, eps, bits=bits,
                                                  mode=mode)
        reps = 100 if R < 262144 else 30
        cases = {
            "cut_fwd_pack": (
                lambda: inl_bottleneck.cut_fwd_pack(mu, lv, eps, bits=bits,
                                                    mode=mode),
                lambda: ref.cutlayer_pack_fwd_ref(mu, lv, eps, bits, mode),
                R * (16 * d + 4 * W + 4)),
            "pack": (
                lambda: inl_bottleneck.pack(u, bits=bits),
                lambda: ref.pack_values_ref(u, bits),
                R * (4 * d + 4 * W)),
            "unpack_dequant": (
                lambda: inl_bottleneck.unpack(lanes, d=d, bits=bits),
                lambda: ref.unpack_dequant_ref(lanes, d, bits),
                R * (4 * d + 4 * W)),
        }
        for name, (kernel, plain, nbytes) in cases.items():
            k_dev = device_ms(torch, kernel, reps=reps)
            p_dev = device_ms(torch, plain, reps=reps)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rows[(name, R)] = (k_dev, p_dev, bound)
            earlier = (f" (the first design's: "
                       f"{FIRST_DESIGN_MS[name, R]} ms, PERF.md)"
                       if (name, R) in FIRST_DESIGN_MS else "")
            print(f"{name} R={R} d={d} W={W} b={bits} fp32: device time "
                  f"kernel {k_dev:.5f} ms{earlier}, plain {p_dev:.5f} ms, "
                  f"bound {bound:.5f} ms (bytes {nbytes}, "
                  f"{bound / k_dev:.3f} of the bound) [{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# 8. the LLM stack: Zamba2-2.7B serving
# ---------------------------------------------------------------------------

def attn_cost(torch, B, S, H, KV, Dh, dtype):
    """(flops, bytes) the causal call needs: 4 Dh flops per kept (query,
    key) pair, S (S + 1) / 2 of them, and head; q, k, v read once and o
    written once."""
    flops = 4.0 * Dh * (S * (S + 1) // 2) * B * H
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * B * S * Dh * (2 * H + 2 * KV)
    return flops, nbytes


def ssd_cost(torch, B, S, H, P, N, L, dtype):
    """(flops, bytes) of the chunked scan: C.B^T once per (b, chunk) over
    the causal pairs, then per head G.x, the inter-chunk term and the state
    update; x, B, C in `dtype`, dt, a, D fp32 read once, y written in
    `dtype` and the fp32 state once."""
    nc, pairs = S // L, L * (L + 1) // 2
    flops = 2.0 * B * nc * (pairs * N + H * (pairs * P + 2 * L * N * P))
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (esize * B * S * (2 * H * P + 2 * N) + 4 * B * S * H + 8 * H
              + 4 * B * H * N * P)
    return flops, nbytes


def bound_of(flops, nbytes, peak):
    """(bound ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qkv_inputs(torch, B, S, H, KV, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, S, n, Dh))
                                  .astype(np.float32)).to(DEV).to(dtype)
                 for n in (H, KV, KV))


def ssd_inputs(torch, B, S, H, P, N, dtype, seed):
    """(x, dt, a, bm, cm, d): x, bm, cm in `dtype`; dt a softplus of a
    normal, a = -exp(0.2 N(0, 1)), D around 1, all fp32 (the draws of
    tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(DEV)
    x = f(rng.normal(size=(B, S, H, P))).to(dtype)
    dt = f(np.log1p(np.exp(rng.normal(size=(B, S, H)))))
    a = f(-np.exp(0.2 * rng.normal(size=(H,))))
    bm = f(rng.normal(size=(B, S, N))).to(dtype)
    cm = f(rng.normal(size=(B, S, N))).to(dtype)
    d = f(1.0 + 0.2 * rng.normal(size=(H,)))
    return x, dt, a, bm, cm, d


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / (want.double().abs().max() + 1e-6))


def llm_kernel_phase(torch):
    """flash_attn_fwd and ssd_scan against their plain versions on the
    same CUDA tensors.  Returns {name: max |kernel - plain|}."""
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    worst = {"flash_attn_fwd": 0.0, "ssd_scan": 0.0}
    worst_rel = 0.0
    n_fa = n_ssd = 0
    for B, S, H, KV, Dh in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv_inputs(torch, B, S, H, KV, Dh, dtype, S + Dh)
            for window in (0, 100):
                for q_offset in (0, 64):
                    qs = q[:, q_offset:].contiguous()
                    got = flash_attention.flash_attn_fwd(
                        qs, k, v, causal=True, window=window,
                        q_offset=q_offset)
                    want = ref.attention_ref(qs, k, v, causal=True,
                                             window=window, q_offset=q_offset)
                    torch.cuda.synchronize()
                    check(got.dtype == dtype and got.shape == qs.shape,
                          f"flash_attn_fwd gave {got.dtype} {got.shape}")
                    err = float((got.float() - want.float()).abs().max())
                    bar = FP32_BAR if dtype == torch.float32 else BF16_BAR
                    check(err <= bar, f"flash_attn_fwd differs from plain by "
                                      f"{err} > {bar} at {(B, S, H, KV, Dh)}"
                                      f" {dtype} window={window} "
                                      f"q_offset={q_offset}")
                    worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"],
                                                  err)
                    n_fa += 1
    for B, S, H, P, N, chunk in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm, d = ssd_inputs(torch, B, S, H, P, N, dtype, S)
            y, st = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=chunk)
            y_ref, st_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, d,
                                                chunk=chunk)
            torch.cuda.synchronize()
            check(y.dtype == dtype and st.dtype == torch.float32,
                  f"ssd_scan gave {y.dtype}, {st.dtype}")
            bar = FP32_BAR if dtype == torch.float32 else BF16_BAR
            for what, g, w in (("y", y, y_ref), ("state", st, st_ref)):
                err = rel_err(g, w)
                check(err <= bar, f"ssd_scan {what} differs from plain by "
                                  f"{err} (relative to max) > {bar} at "
                                  f"{(B, S, H, P, N, chunk)} {dtype}")
                worst_rel = max(worst_rel, err)
                worst["ssd_scan"] = max(worst["ssd_scan"], float(
                    (g.float() - w.float()).abs().max()))
            n_ssd += 1
    # chunk invariance on the card, at the shape and bar of
    # tests/test_kernels.py::test_ssd_chunk_invariance
    x, dt, a, bm, cm, d = ssd_inputs(torch, 1, 128, 2, 16, 8, torch.float32,
                                     0)
    y64, s64 = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=64)
    y128, s128 = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=128)
    torch.cuda.synchronize()
    inv = float((y64 - y128).abs().max())
    check(torch.allclose(y64, y128, atol=5e-4, rtol=1e-4) and
          torch.allclose(s64, s128, atol=5e-4, rtol=1e-4),
          f"ssd_scan chunk 64 vs chunk 128 differ by {inv}")
    print(f"llm kernels: flash_attn_fwd == plain on {n_fa} cases "
          f"({len(FLASH_CASES)} shapes "
          f"x fp32/bf16 x window {{0, 100}} x q_offset {{0, 64}}), max "
          f"|kernel - plain| {worst['flash_attn_fwd']:.3g} (bars {FP32_BAR} "
          f"fp32, {BF16_BAR} bf16); ssd_scan == plain on {n_ssd} cases "
          f"(y and final state), max error relative to the plain max "
          f"{worst_rel:.3g}, max |kernel - plain| {worst['ssd_scan']:.3g}; "
          f"chunk 64 vs 128 max |diff| {inv:.3g}")
    return worst


def zamba2(torch, *, num_layers=None, dtype="bfloat16"):
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config("zamba2-2.7b")
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return dataclasses.replace(cfg, dtype=dtype)


def kernel_inputs_of(fn):
    """Run fn() with the two LLM kernels' wrappers wrapped to keep the
    arguments of every call.  Returns (fn's result, {name: [(args, kw)]})."""
    from repro_torch.kernels import flash_attention, ssm_scan
    mods = {"flash_attn_fwd": flash_attention, "ssd_scan": ssm_scan}
    seen = {name: [] for name in mods}

    def keeping(name, launch):
        def call(*args, **kw):
            seen[name].append((args, kw))
            return launch(*args, **kw)
        return call
    orig = {name: getattr(mod, name) for name, mod in mods.items()}
    for name, mod in mods.items():
        setattr(mod, name, keeping(name, orig[name]))
    try:
        return fn(), seen
    finally:
        for name, mod in mods.items():
            setattr(mod, name, orig[name])


def path_inputs_check(torch, seen):
    """Each kernel against its plain version on the inputs that the
    serving prefill gave it, at the bars of `llm kernels`.  Returns
    ({name: max |kernel - plain|}, worst scan error relative to the plain
    max, max |o| of the attention outputs)."""
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    worst = {"flash_attn_fwd": 0.0, "ssd_scan": 0.0}
    worst_rel = o_max = 0.0
    for (q, k, v), kw in seen["flash_attn_fwd"]:
        got = flash_attention.flash_attn_fwd(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        bar = FP32_BAR if q.dtype == torch.float32 else BF16_BAR
        err = float((got.float() - want.float()).abs().max())
        check(got.shape == q.shape and err <= bar,
              f"flash_attn_fwd on the serving prefill's inputs "
              f"{tuple(q.shape)} {q.dtype} {kw} differs from plain by "
              f"{err} > {bar}")
        worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], err)
        o_max = max(o_max, float(want.float().abs().max()))
    for args, kw in seen["ssd_scan"]:
        y, st = ssm_scan.ssd_scan(*args, **kw)
        y_ref, st_ref = ref.ssd_chunked_ref(*args, **kw)
        bar = FP32_BAR if args[0].dtype == torch.float32 else BF16_BAR
        for what, g, w in (("y", y, y_ref), ("state", st, st_ref)):
            err = rel_err(g, w)
            check(err <= bar, f"ssd_scan {what} on the serving prefill's "
                              f"inputs {tuple(args[0].shape)} {kw} differs "
                              f"from plain by {err} (relative to max) > {bar}")
            worst_rel = max(worst_rel, err)
            worst["ssd_scan"] = max(worst["ssd_scan"], float(
                (g.float() - w.float()).abs().max()))
    torch.cuda.synchronize()
    return worst, worst_rel, o_max


def llm_serving_phase(torch, card_line):
    """Zamba2-2.7B at its full config in bf16 on the card: one prefill whose
    kernel inputs are kept and each kernel held against its plain version
    on them; serve_batch for 4 requests x prompt 512 x 32 tokens, launch
    counts set to 0 just before and read just after.  Returns (cfg, params,
    launches, {name: max |kernel - plain| on the prefill's inputs})."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    cfg = zamba2(torch)
    params = zoo.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             device=DEV)
    prompts = serve.prompts_for(cfg, LLM_B, LLM_PROMPT, 0).to(DEV)
    # logits of the prefill and two decode steps: finite, the right shape
    prefill = steps.make_prefill_step(cfg)
    (logits, cache), seen = kernel_inputs_of(
        lambda: prefill(params, {"tokens": prompts}))
    check(len(seen["flash_attn_fwd"]) == 9 and len(seen["ssd_scan"]) == 54,
          f"the prefill called the kernels {[len(c) for c in seen.values()]}"
          f" times, not 9 and 54")
    worst, worst_rel, o_max = path_inputs_check(torch, seen)
    del seen
    print(f"llm serving kernels: on the inputs the bf16 prefill (B={LLM_B}, "
          f"P={LLM_PROMPT}) gave them, flash_attn_fwd == plain on its 9 calls"
          f", max |kernel - plain| {worst['flash_attn_fwd']:.3g} (max |o| "
          f"{o_max:.3g}, bar {BF16_BAR}); ssd_scan == plain on its 54 calls "
          f"(y and final state), max error relative to the plain max "
          f"{worst_rel:.3g} (bar {BF16_BAR}), max |kernel - plain| "
          f"{worst['ssd_scan']:.3g}")
    cache = zoo.pad_cache(cache, 2)
    decode = steps.make_decode_step(cfg)
    all_logits = [logits]
    for t in range(2):
        tok = torch.argmax(all_logits[-1], dim=-1)[:, None]
        lg, cache = decode(params, {"tokens": tok,
                                    "cache_len": LLM_PROMPT + t}, cache)
        all_logits.append(lg)
    for lg in all_logits:
        check(lg.shape == (LLM_B, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), "non-finite logits")
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    gen = serve.serve_batch(cfg, params, prompts, LLM_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(gen.shape == (LLM_B, LLM_GEN) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.vocab_size, f"tokens out of range {gen}")
    expect_launches(launches, {"flash_attn_fwd": 9, "ssd_scan": 54},
                    "Zamba2-2.7B serve_batch (one prefill, 31 decode steps)")
    n_params = zoo.param_count(cfg)
    print(f"llm serving: Zamba2-2.7B (d_model {cfg.d_model}, {cfg.num_layers}"
          f" layers, {n_params} parameters, bf16) served {LLM_B} requests x "
          f"prompt {LLM_PROMPT} x {LLM_GEN} tokens in {wall:.3f} s; one "
          f"prefill launched flash_attn_fwd {launches['flash_attn_fwd']} and "
          f"ssd_scan {launches['ssd_scan']} times, the decode steps neither; "
          f"logits finite; peak memory {peak:.2f} GiB; sample "
          f"{gen[0, :8].tolist()} [{card_line}]")
    return cfg, params, launches, worst


def llm_fp32_phase(torch, card_line):
    """One period of Zamba2-2.7B at full width in fp32 (num_layers=6: five
    Mamba2 layers and the shared attention): (a) the card against the CPU,
    one set of weights, prefill of 512 and 8 greedy steps fed the CPU's
    tokens; (b) on the card, prefill of P+1 tokens against prefill of P and
    one decode step."""
    from repro_torch import tree_map
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    cfg = zamba2(torch, num_layers=6, dtype="float32")
    p_cpu = zoo.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    # N(0, 1/d_model) adapters in place of init's N(0, 1e-8): the shared
    # attention block then moves the compared logits as a Mamba2 layer does
    for pos in p_cpu["stack"]["pattern"]:
        if "adapter" in pos:
            pos["adapter"]["w"].mul_(1e4 / cfg.d_model ** 0.5)
    p_dev = tree_map(lambda t: t.to(DEV), p_cpu)
    prompts = serve.prompts_for(cfg, 1, LLM_PROMPT, 1)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    lc, cc = prefill(p_cpu, {"tokens": prompts})
    lg, cg = prefill(p_dev, {"tokens": prompts.to(DEV)})
    lg = lg.cpu()
    check(torch.allclose(lg, lc, **LLM_CPU_TOL),
          f"prefill logits card vs CPU max |diff| {(lg - lc).abs().max()}")
    err = float((lg - lc).abs().max())
    cc, cg = zoo.pad_cache(cc, LLM_CPU_STEPS), zoo.pad_cache(cg, LLM_CPU_STEPS)
    same = close = 0
    step_err = 0.0
    for t in range(LLM_CPU_STEPS):
        top2 = torch.topk(lc, 2, dim=-1).values[0]
        margin = float(top2[0] - top2[1])
        if margin > LLM_MARGIN:
            check(int(lg.argmax()) == int(lc.argmax()),
                  f"greedy token {t}: card {int(lg.argmax())} cpu "
                  f"{int(lc.argmax())} at a top-2 margin of {margin}")
            same += 1
        else:
            close += 1
        tok = lc.argmax(dim=-1)[:, None]
        lc, cc = decode(p_cpu, {"tokens": tok,
                                "cache_len": LLM_PROMPT + t}, cc)
        lg, cg = decode(p_dev, {"tokens": tok.to(DEV),
                                "cache_len": LLM_PROMPT + t}, cg)
        lg = lg.cpu()
        check(torch.allclose(lg, lc, **LLM_CPU_TOL),
              f"decode step {t} logits card vs CPU max |diff| "
              f"{(lg - lc).abs().max()}")
        step_err = max(step_err, float((lg - lc).abs().max()))
    del p_cpu, cc, cg
    # (b) prefill of P + 1 == prefill of P + one decode step, on the card
    P = LLM_CONSIST_P
    toks = serve.prompts_for(cfg, 2, P + 1, 2).to(DEV)
    full, _ = prefill(p_dev, {"tokens": toks})
    _, cache = prefill(p_dev, {"tokens": toks[:, :P]})
    cache = zoo.pad_cache(cache, 1)
    step, _ = decode(p_dev, {"tokens": toks[:, P:], "cache_len": P}, cache)
    torch.cuda.synchronize()
    check(torch.allclose(step, full, **LLM_CPU_TOL),
          f"prefill {P + 1} vs prefill {P} + decode: max |diff| "
          f"{(step - full).abs().max()}")
    cons = float((step - full).abs().max())
    print(f"llm fp32 (num_layers=6, d_model {cfg.d_model}): prefill "
          f"{LLM_PROMPT} last logits card vs CPU max |diff| {err:.3g}, "
          f"{LLM_CPU_STEPS} decode steps fed the CPU's tokens max |diff| "
          f"{step_err:.3g} (rtol/atol 1e-3); greedy tokens equal on {same} "
          f"steps with a top-2 margin above {LLM_MARGIN}, {close} closer "
          f"calls; prefill {P + 1} vs prefill {P} + one decode step max "
          f"|diff| {cons:.3g} [{card_line}]")


def timed_host(torch, fn, reps):
    """Median host-clock ms of `fn` ending in a synchronize, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def eager_decode(torch, cfg):
    """The greedy decode step run eagerly, never captured: the body of
    steps.make_decode_step(greedy=True), for holding the graphed step
    against it."""
    from repro_torch.models import zoo

    @torch.no_grad()
    def decode(params, batch, cache):
        logits, cache = zoo.forward(params, cfg, batch, mode="decode",
                                    cache=cache)
        return torch.argmax(logits[:, -1], dim=-1), cache
    return decode


def decode_attention_check(torch, cfg, card_line):
    """One bf16 decode_attention call at the serving decode's shapes (B=4,
    a cache of 512 + 32 slots, 300 valid, Zamba2's heads): the device
    memory it allocates beyond its inputs against the bytes an fp32 copy
    of both caches would take, its device time (CUDA events), and the
    entries that differ from the CPU port on the same inputs."""
    from repro_torch.models import attention

    g = torch.Generator(device=DEV).manual_seed(21)
    W, KV, H, Dh = LLM_PROMPT + LLM_GEN, cfg.num_kv_heads, cfg.num_heads, \
        cfg.head_dim

    def draw(*shape):
        return torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
    q, kn, vn = draw(LLM_B, 1, H, Dh), draw(LLM_B, 1, KV, Dh), \
        draw(LLM_B, 1, KV, Dh)
    kc, vc = draw(LLM_B, W, KV, Dh), draw(LLM_B, W, KV, Dh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = attention.decode_attention(q, kc, vc, 300, kn, vn)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    copies = 2 * kc.numel() * 4
    check(extra < copies / 4, f"decode_attention allocated {extra} bytes, "
                              f"an fp32 copy of the caches is {copies}")
    cpu = attention.decode_attention(*(t.cpu() for t in (q, kc, vc)), 300,
                                     kn.cpu(), vn.cpu())
    differ = int((out.cpu() != cpu).sum())
    err = float((out.cpu().float() - cpu.float()).abs().max())
    check(err <= 2e-2 * float(cpu.float().abs().max()),
          f"decode_attention: card against the CPU port {err}")
    ms = cuda_ms(torch, lambda: attention.decode_attention(
        q, kc, vc, 300, kn, vn), reps=100, warmup=10)
    print(f"llm decode attention: bf16 B={LLM_B} W={W} H={H} KV={KV} "
          f"Dh={Dh}, 300 valid: {extra} bytes allocated beyond the inputs "
          f"(an fp32 copy of both caches: {copies}), {ms:.4f} ms a call "
          f"(CUDA events, eager), {differ} of {out.numel()} outputs differ "
          f"from the CPU port's, by at most {err:.3g} [{card_line}]")


def llm_graph_phase(torch, cfg, params, card_line):
    """Zamba2-2.7B at full width, B=4 after a prompt of 512, 32 tokens,
    deterministic algorithms on: the greedy decode loop on the graphed step
    (steps.make_decode_step) against the same loop on the eager step from
    one prefill, the ids and every leaf of the final cache bit for bit and
    one capture (trace_log); then serve_batch(trace_log=) gives the eager
    ids with one capture.  Returns the graphed loop's launches."""
    from repro_torch import tree_leaves, tree_map
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo

    prompts = serve.prompts_for(cfg, LLM_B, LLM_PROMPT, 5).to(DEV)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        logits, cache0 = steps.make_prefill_step(cfg)(params,
                                                      {"tokens": prompts})
        log = []
        runs = {}
        for label, decode in (("eager", eager_decode(torch, cfg)),
                              ("graph", steps.make_decode_step(
                                  cfg, greedy=True, trace_log=log))):
            cache = zoo.pad_cache(tree_map(torch.clone, cache0), LLM_GEN)
            tok = torch.argmax(logits, dim=-1)
            ids = [tok]
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            for t in range(LLM_GEN - 1):
                pos = torch.full((), LLM_PROMPT + t, dtype=torch.int64,
                                 device=DEV)
                tok, cache = decode(params, {"tokens": tok[:, None],
                                             "cache_len": pos}, cache)
                ids.append(tok)
            torch.cuda.synchronize()
            runs[label] = (torch.stack(ids, dim=1), cache,
                           time.perf_counter() - t0, read_launches())
        (ids_e, cache_e, t_e, _), (ids_g, cache_g, t_g, launches) = \
            runs["eager"], runs["graph"]
        check(torch.equal(ids_e, ids_g), "decode: graphed ids differ from "
                                         "the eager ones")
        le, lg = tree_leaves(cache_e), tree_leaves(cache_g)
        check(len(le) == len(lg) and all(torch.equal(a, b)
                                         for a, b in zip(le, lg)),
              "decode: the graphed final cache differs from the eager one")
        check(len(log) == 1, f"decode: {len(log)} captures, not 1")
        log2 = []
        gen = serve.serve_batch(cfg, params, prompts, LLM_GEN,
                                trace_log=log2)
        check(torch.equal(gen, ids_e) and len(log2) == 1,
              f"serve_batch: ids == eager {torch.equal(gen, ids_e)}, "
              f"{len(log2)} captures")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"llm graphs: Zamba2-2.7B (bf16, full width) B={LLM_B} after "
          f"{LLM_PROMPT}, {LLM_GEN} tokens: the graphed decode loop == the "
          f"eager one bit for bit (ids and {len(le)} cache leaves), "
          f"trace_log {len(log)} entry; serve_batch == eager ids with one "
          f"capture; loop wall eager {t_e:.3f} s, graphed {t_g:.3f} s "
          f"[{card_line}]")
    return launches


def llm_timing(torch, cfg, params, card_line):
    """Zamba2-2.7B prefill latency at (B=4, P=512) and (B=4, P=2048) and
    the decode latency per token, each with the device's busy time and idle
    share from the profiler; the decode step eager and graphed (its device
    time from CUDA events around back-to-back steps)."""
    from repro_torch.launch import serve, steps
    prefill = steps.make_prefill_step(cfg)
    out = {}
    for P in (LLM_PROMPT, 2048):
        prompts = serve.prompts_for(cfg, LLM_B, P, 3).to(DEV)
        fn = lambda: prefill(params, {"tokens": prompts})
        wall = timed_host(torch, fn, reps=5)
        busy, by_name = device_profile(torch, fn, reps=3, warmup=1)
        out[f"prefill_{P}"] = (wall, busy)
        top = "; ".join(f"{n[:48]} {ms:.3f} ms" for n, ms in by_name[:5])
        own = {k: sum(ms for n, ms in by_name if tag in n)
               for k, tag in (("flash_attn_fwd", "flash_fwd"),
                              ("ssd_scan", "ssd_"))}
        print(f"llm prefill latency (B={LLM_B}, P={P}): median {wall:.3f} ms "
              f"over 5; device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}; top kernels: {top}; the hand-written "
              f"kernels: flash_attn_fwd {own['flash_attn_fwd']:.3f} ms, "
              f"ssd_scan {own['ssd_scan']:.3f} ms [{card_line}]")
    out.update(decode_timing(torch, cfg, params, card_line))
    return out


def decode_timing(torch, cfg, params, card_line):
    """Zamba2-2.7B's decode latency per token after a prompt of 512, eager
    (host clock, and the profiler's busy time) and graphed (host clock,
    and the device time from CUDA events around back-to-back steps)."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    prefill = steps.make_prefill_step(cfg)
    decode = eager_decode(torch, cfg)
    out = {}
    prompts = serve.prompts_for(cfg, LLM_B, LLM_PROMPT, 4).to(DEV)
    _, cache = prefill(params, {"tokens": prompts})
    steps_n = 24
    # room for the timed steps and every profiler window, retries included
    cache = zoo.pad_cache(cache, 1 + steps_n + PROFILE_TRIES * 12)
    tok = prompts[:, -1]
    box = [tok, cache, LLM_PROMPT]

    def one():
        pos = torch.full((), box[2], dtype=torch.int64, device=DEV)
        box[0], box[1] = decode(params, {"tokens": box[0][:, None],
                                         "cache_len": pos}, box[1])
        box[2] += 1
    wall = timed_host(torch, one, reps=steps_n)
    busy, _ = device_profile(torch, one, reps=10, warmup=2)
    out["decode"] = (wall, busy)
    print(f"llm decode latency per token (B={LLM_B}, cache {LLM_PROMPT}+): "
          f"median {wall:.3f} ms over {steps_n} steps; device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f} [{card_line}]")
    # the graphed step on a fresh cache: one capture, then replays
    graphed = steps.make_decode_step(cfg, greedy=True)
    _, cache = prefill(params, {"tokens": prompts})
    cache = zoo.pad_cache(cache, 2 + 2 * steps_n + 20)
    box = [tok, cache, LLM_PROMPT]

    def one_graphed():
        pos = torch.full((), box[2], dtype=torch.int64, device=DEV)
        box[0], box[1] = graphed(params, {"tokens": box[0][:, None],
                                          "cache_len": pos}, box[1])
        box[2] += 1
    g_wall = timed_host(torch, one_graphed, reps=steps_n)
    g_dev = cuda_ms(torch, one_graphed, reps=steps_n, warmup=2)
    out["decode graphed"] = (g_wall, g_dev)
    print(f"graphs times: llm decode per token (B={LLM_B}, cache "
          f"{LLM_PROMPT}+): eager wall {wall:.3f} ms, busy {busy:.3f} ms, "
          f"idle {1 - busy / wall:.3f}; graph wall {g_wall:.3f} ms, device "
          f"{g_dev:.3f} ms (CUDA events around {steps_n} steps), idle "
          f"{1 - g_dev / g_wall:.3f}; {wall / g_wall:.2f}x [{card_line}]")
    return out


def llm_kernel_timing(torch, card_line):
    """flash_attn_fwd and ssd_scan device time (graph_ms) at the serving
    shape (B=4, S=512) and at S=2048, bf16, Zamba2's widths, beside the
    bound, the plain version and (attention) scaled_dot_product_attention,
    which the port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    rows = {}
    bf16 = torch.bfloat16
    for S in (LLM_PROMPT, 2048):
        reps = 20 if S == LLM_PROMPT else 5
        timed = lambda fn: graph_ms(torch, fn, reps)
        q, k, v = qkv_inputs(torch, LLM_B, S, 32, 32, 80, bf16, 5)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = attn_cost(torch, LLM_B, S, 32, 32, 80, bf16)
        bound, by = bound_of(flops, nbytes, BF16_FLOPS)
        k_ms = timed(lambda: flash_attention.flash_attn_fwd(q, k, v,
                                                            causal=True))
        p_ms = timed(lambda: ref.attention_ref(q, k, v, causal=True))
        l_ms = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        rows[("flash_attn_fwd", S)] = (k_ms, p_ms, bound, by, l_ms)
        print(f"flash_attn_fwd B={LLM_B} S={S} H=KV=32 Dh=80 bf16 causal: "
              f"device time kernel {k_ms:.4f} ms (the SIMT kernel: "
              f"{SIMT_MS['flash_attn_fwd', S]} ms, PERF.md), plain "
              f"{p_ms:.4f} ms, scaled_dot_product_attention {l_ms:.4f} ms, "
              f"bound {bound:.4f} ms by {by} ({flops:.3g} flops, {nbytes} "
              f"bytes; {bound / k_ms:.3f} of the bound, "
              f"{flops / k_ms / 1e9:.1f} TFLOP/s) [{card_line}]")
        x, dt, a, bm, cm, d = ssd_inputs(torch, LLM_B, S, 80, 64, 64, bf16, 6)
        flops, nbytes = ssd_cost(torch, LLM_B, S, 80, 64, 64, 256, bf16)
        bound, by = bound_of(flops, nbytes, BF16_FLOPS)
        k_ms = timed(lambda: ssm_scan.ssd_scan(x, dt, a, bm, cm, d,
                                               chunk=256))
        p_ms = timed(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm, d,
                                                 chunk=256))
        rows[("ssd_scan", S)] = (k_ms, p_ms, bound, by, None)
        _, stages = device_profile(
            torch, lambda: ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=256),
            reps=10, warmup=2)
        stages = ", ".join(f"{n.split('::')[-1].split('(')[0]} {ms:.4f}"
                           for n, ms in stages)
        print(f"ssd_scan B={LLM_B} S={S} H=80 P=64 N=64 chunk 256 bf16: "
              f"device time kernel {k_ms:.4f} ms (the SIMT kernel: "
              f"{SIMT_MS['ssd_scan', S]} ms, PERF.md; its launches by the "
              f"profiler: {stages} ms), plain {p_ms:.4f} ms, bound "
              f"{bound:.4f} ms by {by} ({flops:.3g} flops, {nbytes} bytes; "
              f"{bound / k_ms:.3f} of the bound); no single torch call "
              f"[{card_line}]")
    return rows


CUT_LAYER_SOURCES = ("cut_fwd", "cut_bwd", "cut_prior_fwd", "cut_prior_bwd",
                     "cut_fwd_pack", "pack", "unpack_dequant")
# the kernels the hybrid schemes' runs launch (the deterministic cut)
HYBRID_PATH_KERNELS = ("cut_fwd", "cut_bwd", "cut_fwd_pack", "pack",
                       "unpack_dequant")
# the kernels the resumed runs (learned priors among them) and the search
# grid (packed_duplex on the star and on chain(5)) must launch
RESUME_PATH_KERNELS = ("cut_fwd", "cut_bwd", "cut_prior_fwd",
                       "cut_prior_bwd")
SEARCH_PATH_KERNELS = ("cut_fwd", "cut_bwd", "cut_fwd_pack", "pack",
                       "unpack_dequant")


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one NVIDIA H100.")
    parser.add_argument("--kernel-times", action="store_true",
                        help="build the cut-layer kernels and print only "
                             "their device times")
    parser.add_argument("--decode-times", action="store_true",
                        help="build the LLM kernels and print only "
                             "Zamba2-2.7B's decode latency per token, "
                             "eager and graphed")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    name, card = device_phase(torch)
    if args.kernel_times:
        build_phase(CUT_LAYER_SOURCES)
        new_kernel_timing(torch, card)
        pack_kernel_timing(torch, card)
        return 0
    if args.decode_times:
        from repro_torch.models import zoo
        build_phase(TENSOR_CORE_KERNELS)
        cfg = zamba2(torch)
        params = zoo.init_params(
            cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        decode_timing(torch, cfg, params, card)
        return 0
    build_phase()
    worst = {"cut_fwd": kernel_phase(torch),
             "cut_bwd": bwd_kernel_phase(torch),
             **prior_kernel_phase(torch),
             **pack_kernel_phase(torch)}
    autograd_phase(torch)
    scheme, state, views, serve_launches = serving_phase(torch, card)
    train_launches, accuracy = training_phase(torch, card)
    prior_launches = prior_training_phase(torch, card)
    packed_launches = packed_training_phase(torch, card)
    packed_step_equals_dense(torch, card)
    card_vs_cpu_phase(torch, card)
    graph_launches = topology_phase(torch, card)
    graph_step_checks(torch, card)
    graph_serve_launches = graph_serving_phase(torch, card)
    perfect_links_phase(torch, card)
    lossy_launches = lossy_training_phase(torch, card)
    lossy_card_vs_cpu(torch, card)
    lossy_serve_launches = lossy_serving_phase(torch, card)
    hybrid_launches_by_run = hybrids_phase(torch, card)
    graph_launches_by_run, graph_state = graphs_phase(torch, card)
    resume_launches_by_run, _ = checkpoint_phase(torch, card)
    search_launches = search_phase(torch, card)
    torch.cuda.synchronize()
    rows = timing_phase(torch, scheme, state, views, card)
    steps = {wire: train_step_timing(torch, card, wire=wire,
                                     link_bits=bits)
             for wire, bits in (("dense", 32), ("packed", WIRE_BITS),
                                ("packed_duplex", WIRE_BITS))}
    for label, topo, cfg, wire in graph_runs():
        if wire != "packed_duplex":
            steps[label] = train_step_timing(torch, card, wire=wire,
                                             topology=topo, cfg=cfg,
                                             label=label)
    _, _, lossy_cfg, lossy_star, _, _ = lossy_runs()[0]
    steps["lossy star"] = train_step_timing(
        torch, card, topology=lossy_star, cfg=lossy_cfg,
        label="lossy star: erasure 0.3 an edge, edge_dropout 0.2")
    (lw, lb), (cw, cb) = steps["lossy star"], steps["dense"]
    print(f"linkfault times: lossy INL step {lw:.3f} ms (device busy "
          f"{lb:.4f} ms) against the clean star's {cw:.3f} ms (busy "
          f"{cb:.4f} ms) in this run: {lw - cw:+.3f} ms wall, "
          f"{lb - cb:+.4f} ms busy [{card}]")
    for hname in HYBRIDS + ("sl", "fl"):
        steps[f"{hname} dense"] = train_step_timing(
            torch, card, name=hname, label=f"{hname} dense")
    rounds = [("inl", steps["dense"])] + [
        (h, steps[f"{h} dense"]) for h in HYBRIDS + ("sl", "fl")]
    print("hybrids times: one dense round at PaperExperimentConfig(), batch "
          "64 (FL: ten local steps), median wall and device busy: "
          + ", ".join(f"{h} {w:.3f} ms (busy {b:.4f} ms)"
                      for h, (w, b) in rounds) + f" [{card}]")
    graph_times = graphs_timing(torch, card, dict(rounds), graph_state)
    rows.update(new_kernel_timing(torch, card))
    rows.update(pack_kernel_timing(torch, card))
    torch.cuda.synchronize()
    worst.update(llm_kernel_phase(torch))
    llm_cfg, llm_params, llm_launches, path_worst = llm_serving_phase(
        torch, card)
    for kname, err in path_worst.items():
        worst[kname] = max(worst[kname], err)
    llm_fp32_phase(torch, card)
    llm_graph_launches = llm_graph_phase(torch, llm_cfg, llm_params, card)
    decode_attention_check(torch, llm_cfg, card)
    llm_times = llm_timing(torch, llm_cfg, llm_params, card)
    del llm_params
    rows.update(llm_kernel_timing(torch, card))
    torch.cuda.synchronize()
    launches = {"cut_fwd": train_launches["cut_fwd"],
                "cut_bwd": train_launches["cut_bwd"],
                "cut_prior_fwd": prior_launches["cut_prior_fwd"],
                "cut_prior_bwd": prior_launches["cut_prior_bwd"],
                "cut_fwd_pack": packed_launches["inl packed"]["cut_fwd_pack"],
                "pack": graph_launches["chain(5) packed"]["pack"],
                "unpack_dequant":
                    graph_launches["chain(5) packed"]["unpack_dequant"],
                "flash_attn_fwd": llm_launches["flash_attn_fwd"],
                "ssd_scan": llm_launches["ssd_scan"]}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    lossy = {k: {label: n[k] for label, n in lossy_launches.items() if n[k]}
             for k in CUT_LAYER_SOURCES}
    lossy["cut_fwd"]["served lossy star"] = lossy_serve_launches["cut_fwd"]
    check(all(lossy[k] for k in CUT_LAYER_SOURCES),
          f"a cut-layer kernel never launched on the lossy paths: {lossy}")
    on_hybrids = {k: {run: n[k] for run, n in hybrid_launches_by_run.items()
                      if n[k]} for k in HYBRID_PATH_KERNELS}
    check(all(on_hybrids.values()),
          f"a kernel of the hybrids' path never launched: {on_hybrids}")
    on_graphs = {k: {run: n[k] for run, n in graph_launches_by_run.items()
                     if n.get(k)} for k in CUT_LAYER_SOURCES}
    check(all(on_graphs.values()),
          f"a cut-layer kernel never launched under graphs: {on_graphs}")
    on_resume = {k: {run: n[k] for run, n in resume_launches_by_run.items()
                     if n.get(k)} for k in CUT_LAYER_SOURCES}
    check(all(on_resume[k] for k in RESUME_PATH_KERNELS),
          f"a kernel of the resume path never launched: {on_resume}")
    on_search = {k: search_launches.get(k, 0) for k in CUT_LAYER_SOURCES}
    check(all(on_search[k] for k in SEARCH_PATH_KERNELS),
          f"a kernel of the search grid never launched: {on_search}")
    check(not any(llm_graph_launches.values()),
          f"the graphed decode loop launched {llm_graph_launches}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s; final accuracy {accuracy}, "
          f"train step " + ", ".join(
              f"{w} {ms:.3f} ms (device busy {busy:.4f} ms)"
              for w, (ms, busy) in steps.items())
          + "; Zamba2-2.7B " + ", ".join(
              f"{k} {ms:.3f} ms (device {busy:.3f} ms)"
              for k, (ms, busy) in llm_times.items())
          + "; graphed rounds " + ", ".join(
              f"{k} {row[2]:.3f} ms (device {row[3]:.4f} ms, eager "
              f"{row[0]:.3f} ms)" for k, row in graph_times.items()
              if k != "predict" and len(row) == 4))
    src = "src/repro_torch/kernels/csrc/"
    replaces = "src/repro/kernels/inl_bottleneck.py:"
    kernels = []
    for kname, line, shape, key, per_step, path in (
            ("cut_fwd", 83, "R=320 d=64 fp32 none b=32 (serving)",
             (320, "none", 32), f"1 + 1 per evaluation; serving: "
             f"{serve_launches['cut_fwd']} in its run", "training"),
            ("cut_bwd", 169, "R=320 d=64 fp32 sample b=32 (training)",
             ("cut_bwd", 320), 1, "training"),
            ("cut_prior_fwd", 279,
             "J=5 T=64 d=64 fp32 sample b=32 (training)",
             ("cut_prior_fwd", 320), 1, "training, learned prior"),
            ("cut_prior_bwd", 298,
             "J=5 T=64 d=64 fp32 sample (training)",
             ("cut_prior_bwd", 320), 1, "training, learned prior"),
            ("cut_fwd_pack", 117, "R=320 d=64 fp32 sample b=8 (training)",
             ("cut_fwd_pack", 320), 1, "INL training, packed wire"),
            ("pack", 143, "R=320 d=64 fp32 b=8 (training)", ("pack", 320),
             f"5 on the packed chain(5) (64-320 rows a hop), 1 on SL and "
             f"the learned prior; serving chain(5): "
             f"{graph_serve_launches['pack']} in its run",
             "INL on chain(5), SL and learned prior, packed wire"),
            ("unpack_dequant", 153, "R=320 d=64 fp32 b=8 (training)",
             ("unpack_dequant", 320), "5 on the packed chain(5), 1 on "
             "every other packed path", "every packed path")):
        k_ms, p_ms, b_ms = rows[key]
        entry = {
            "name": kname, "route": "cuda", "source": f"{src}{kname}.cu",
            "replaces": f"{replaces}{line}", "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None,
            "shape": shape, "launches_per_train_step": per_step,
            "path": path, "launches_on_lossy_links": lossy[kname],
            "launches_on_graphs": on_graphs[kname],
            "launches_on_resume": on_resume[kname],
            "launches_on_search": on_search[kname]}
        if kname in on_hybrids:
            entry["launches_on_hybrids"] = on_hybrids[kname]
        if kname in REDESIGNED:
            entry["redesigned"] = REDESIGNED[kname]
            entry["at_large_r"] = {
                f"R={R}": dict(zip(("ms", "plain_ms", "bound_ms"),
                                   rows[kname, R])) for R in (20480, 262144)}
        kernels.append(entry)
    for kname, line, source in (
            ("flash_attn_fwd", "flash_attention.py:31",
             "flash_attn_fwd.cu"),
            ("ssd_scan", "ssm_scan.py:28", "ssd_scan.cu")):
        k_ms, p_ms, b_ms, by, l_ms = rows[(kname, LLM_PROMPT)]
        k2, p2, b2, _, l2 = rows[(kname, 2048)]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"{src}{source}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": launches[kname], "max_abs_err": worst[kname],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": l_ms,
            "shape": f"B={LLM_B} S={LLM_PROMPT} bf16 (the serving prefill)",
            "at_s2048": {"ms": k2, "plain_ms": p2, "bound_ms": b2,
                         "library_ms": l2},
            "launches_per_prefill": {"flash_attn_fwd": 9,
                                     "ssd_scan": 54}[kname],
            "path": "Zamba2-2.7B serving (prefill)"})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
