#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each checked; any failed check exits non-zero before the last line:

  1. device   the card's name, capability (9, 0), name and power limit
              from nvidia-smi; TF32 switched off for fp32 matmuls and convs.
  2. build    every kernel of repro_torch/kernels/csrc/ compiled by nvcc for
              sm_90a from the checkout's sources, one nvcc each, together.
  3. kernels  each kernel against its plain PyTorch version on the same CUDA
              tensors: the cut-layer forward over modes {sample, analytic,
              none}, link widths {1, 2, 4, 8, 16, 32}, fp32/bf16 latents and
              shapes (5, 64, 64), (5, 7, 64) (ragged), (5, 4096, 96).  u must
              be identical; at b < 32 only entries whose pre-quantization
              value lies within 1e-6 of a rounding midpoint may differ (they
              are counted).  The rate within rtol 1e-5, atol 1e-5.
  4. serving  the main path: INLScheme at PaperExperimentConfig() (the
              paper's full width) on the card from a seeded generator, a
              ServingEngine over buckets (1, 4, 16, 64) answering 256
              requests through its scheduler thread.  Every launch count is
              set to 0 just before and read just after; the cut kernel must
              have launched exactly once per engine launch.  Answers must be
              finite rows summing to 1, equal bit for bit to the port's
              predict on the card in the same bucket, within atol 1e-4 of
              the port on the CPU, and fully delivered on the meter.
  5. times    per-bucket predict latency, served requests/s, and each
              kernel's time beside its bound and its plain version, with the
              card's name and power limit on every line.

The line before the last two is {"kernels": [...]}, the one before the last
nvidia-smi's name and power limit, and the last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
MIDPOINT_TOL = 1e-6
RATE_TOL = dict(rtol=1e-5, atol=1e-5)
CPU_ATOL = 1e-4
BUCKETS = (1, 4, 16, 64)
N_REQUESTS = 256


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

def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"build: {sorted(seconds)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process "
          f"per source)")
    for name, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


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
    for shape in ((5, 64, 64), (5, 7, 64), (5, 4096, 96)):
        d = shape[-1]
        for bits in (1, 2, 4, 8, 16, 32):
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
# 5. times
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


def device_ms(torch, fn, reps=100, warmup=10):
    """Device time per call: the sum of the device time of every kernel and
    copy `fn` runs, from torch.profiler's CUDA trace, over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / reps / 1e3


def timing_phase(torch, scheme, state, views, card_line):
    from repro_torch.kernels import inl_bottleneck, ref
    for b in BUCKETS:
        v = torch.from_numpy(views[:, :b]).cuda()

        def predict():
            scheme.predict(state, v, device="cuda")
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


def main() -> int:
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
    build_phase()
    worst = kernel_phase(torch)
    scheme, state, views, launches = serving_phase(torch, card)
    torch.cuda.synchronize()
    rows = timing_phase(torch, scheme, state, views, card)
    torch.cuda.synchronize()
    kernel, plain, bound = rows[(320, "none", 32)]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "cut_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cut_fwd.cu",
        "replaces": "src/repro/kernels/inl_bottleneck.py:83",
        "launches": launches["cut_fwd"], "max_abs_err": worst,
        "ms": kernel, "plain_ms": plain, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
        "shape": "R=320 d=64 fp32 none b=32"}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
