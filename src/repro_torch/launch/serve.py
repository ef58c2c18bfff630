"""Serving driver: the CLI front end over the INL serving plane
(`repro_torch/serving/`) plus batched prefill + greedy decode of an LLM.

Reference: src/repro/launch/serve.py (`greedy`, `clamp_requests`,
`serve_batch`, `drain_on_signal`, `flush_stats`, `_inl_setup`,
`serve_inl`, `serve_inl_loadgen`, `main`).

Usage (the card by default; `--device cpu` runs the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --smoke --requests 4 --prompt-len 64 --gen-len 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-inl \\
      --transport socket --speculative --deadline-ms 10

`--arch` takes every registered LLM (`configs.base.list_archs()`: all
ten of the reference's) but the VLM, which it refuses with the
reference's message (its decode runs through the steps).  LLM weights are
random, drawn from `--seed`; prompts come from the seeded Markov token
stream (`data/tokens`), an audio model's broadcast to its K codebooks.
`--smoke` takes the reduced config in fp32, as the reference does.

`--arch paper-inl` serves the paper's in-network model: it trains INL
(the smoke config with `--smoke`, else `PaperExperimentConfig()`) on the
seeded synthetic views, or restores it from `--ckpt-dir` (a checkpoint of
either package), then requests fan their J views into per-node queues and
the continuous-batching engine coalesces whatever is in flight into
bucketed launches (one CUDA graph per bucket on the card).  With
`--deadline-ms` / `--erasure` the fusion center fuses WHAT ARRIVED per
request; `--transport` rides each fragment over the retrying edge
channels of `repro_torch/transport` and `--speculative` patches late
stragglers into the next bucket.  `--load-gen` switches from the one-shot
block to a seeded Poisson offered-load sweep with p50/p99 latency and
goodput per load point.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import signal
import time
import warnings

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import tokens as token_data
from repro_torch.launch import steps as steps_lib
from repro_torch.models import zoo


def greedy(logits):
    return torch.argmax(logits, dim=-1)


def clamp_requests(n: int, available: int, *, strict: bool = False) -> int:
    """`--requests` larger than the dataset clamps loudly (RuntimeWarning)
    to the available rows, or raises under `--strict`."""
    if n <= available:
        return n
    msg = (f"--requests {n} exceeds the {available} requests available in "
           f"the dataset; serving {available}")
    if strict:
        raise ValueError(msg + " is disallowed in strict mode")
    warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return available


def serve_batch(cfg, params, prompts, gen_len: int, *, trace_log=None):
    """prompts: (B, P) integer ids on the parameters' device.  Returns
    (B, gen_len) generated ids.  Prefill once, then greedy decode against
    the cache, grown once by gen_len slots.  An audio model reads the
    prompt on each of its K codebooks and feeds each generated token (the
    first codebook's argmax) back on all K.

    The argmax lives inside the decode step (`make_decode_step(greedy=
    True)`), the token and cache_len stay on the device between steps, and
    on the card the step is one CUDA graph captured once and replayed once
    per token, with no host synchronisation in the loop.  `trace_log` is
    forwarded to the decode step: one entry per capture (none on the
    CPU)."""
    B, P = prompts.shape
    prefill = steps_lib.make_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg, greedy=True,
                                        trace_log=trace_log)
    audio = cfg.modality == "audio_tokens"
    K = cfg.num_codebooks

    def inputs(ids):                          # (B, S) -> the batch's key
        if audio:
            return {"tokens_mc": ids[..., None].expand(*ids.shape, K)}
        return {"tokens": ids}
    last_logits, cache = prefill(params, inputs(prompts))
    cache = zoo.pad_cache(cache, gen_len)
    tok = greedy(last_logits)
    if audio:                                 # (B, K) -> the first codebook
        tok = tok[:, 0]
    out = torch.empty((B, gen_len), dtype=tok.dtype, device=tok.device)
    out[:, 0] = tok
    for t in range(gen_len - 1):
        cache_len = torch.full((), P + t, dtype=torch.int64,
                               device=prompts.device)
        tok, cache = decode(params, dict(inputs(tok[:, None]),
                                         cache_len=cache_len), cache)
        out[:, t + 1] = tok
    return out


def prompts_for(cfg, requests: int, prompt_len: int, seed: int):
    """(requests, prompt_len) int64 ids from the seeded Markov stream."""
    toks = token_data.markov_stream(cfg.vocab_size, requests * prompt_len,
                                    seed=seed)
    return torch.from_numpy(toks.astype(np.int64)).reshape(requests,
                                                           prompt_len)


@contextlib.contextmanager
def drain_on_signal(engine):
    """SIGTERM/Ctrl-C become a GRACEFUL engine shutdown: admission stops,
    queued work drains, and still-pending futures fail with
    `EngineShutdown` instead of hanging their waiters.  Yields a dict that
    gains a "sig" key if a signal fired (the caller picks a clean exit
    code over a crash)."""
    fired = {}

    def _handler(signum, frame):
        fired["sig"] = signum
        engine.shutdown()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _handler)
        except ValueError:      # not the main thread (embedded use)
            pass
    try:
        yield fired
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)


def flush_stats(engine, *, label: str = "shutdown") -> None:
    """The ledger flush every exit path owes the operator: whatever the
    engine completed is reported even when the run was cut short."""
    st = engine.stats
    print(f"[{label}] served={st.completed} launches={st.launches} "
          f"shed={st.shed} patched={st.patched} "
          f"pad_fraction={st.pad_fraction:.2f}")
    print(f"[{label}] ledger: offered={engine.meter.gbits * 1e3:.3f} Mbits "
          f"delivery_ratio={engine.meter.delivery_ratio:.3f}")


def _conv_path(path) -> bool:
    return len(path) >= 3 and path[-1] == "w" and path[-3] == "convs"


def _reference_layout(tree, path=()):
    """Zeros of `tree`'s structure (numpy) in the reference's layout: conv
    weights HWIO where the port keeps OIHW."""
    if isinstance(tree, torch.Tensor):
        shape = tuple(tree.shape)
        if _conv_path(path):
            lead = shape[:-4]
            o, i, h, w = shape[-4:]
            shape = lead + (h, w, i, o)
        return np.zeros(shape, np.float32 if tree.is_floating_point()
                        else tree.cpu().numpy().dtype)
    if isinstance(tree, dict):
        return {k: _reference_layout(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_reference_layout(v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reference_layout(v, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def _restore_inl(ckpt_dir, state, cfg, device):
    """The INL state of `ckpt_dir`'s latest checkpoint, written by either
    package: the port's layout restores as it is; the reference's (conv
    weights HWIO) through `convert.inl_from_jax` (params and BatchNorm
    state; serving needs no optimizer state)."""
    from repro_torch import checkpoint, convert
    try:
        return checkpoint.restore(ckpt_dir, state)
    except ValueError:
        ref, step = checkpoint.restore(ckpt_dir, _reference_layout(state))
    params, st = convert.inl_from_jax(ref["params"], ref["state"], cfg,
                                      device=device)
    return dict(state, params=params, state=st), step


def _inl_setup(args):
    """Train INL (or restore it from --ckpt-dir) and build the requested
    serving topology.  Returns (scheme, state, cfg, topology, (J, n) views,
    labels, device)."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault, schemes
    from repro_torch.core import topology as topology_lib
    from repro_torch.core.schemes import runner
    from repro_torch.data import multiview

    device = resolve_device(args.device)
    cfg = PaperExperimentConfig(
        conv_channels=(4,), d_bottleneck=8, dense_units=(32,),
        image_shape=(16, 16, 3), dataset_size=640) if args.smoke \
        else PaperExperimentConfig()
    if args.topology == "tree":
        topo = topology_lib.tree(2, 2)
        cfg = dataclasses.replace(
            cfg, num_clients=topo.num_views(),
            noise_stds=cfg.noise_stds
            + (1.5,) * (topo.num_views() - len(cfg.noise_stds)))
    else:
        topo = topology_lib.star(cfg.num_clients)
    if args.wire == "packed" and cfg.link_bits > 16:
        cfg = dataclasses.replace(cfg, link_bits=8)

    scheme = schemes.get("inl")
    state = scheme.init(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    imgs, labels = multiview.make_base_dataset(
        cfg.dataset_size, image_shape=cfg.image_shape, seed=args.seed)
    views = multiview.make_views(imgs, cfg.noise_stds)
    ckpt_dir = getattr(args, "ckpt_dir", "")
    restored = False
    if ckpt_dir:
        from repro_torch import checkpoint
        if checkpoint.latest_step(ckpt_dir) is not None:
            state, step = _restore_inl(ckpt_dir, state, cfg, device)
            print(f"serving from checkpoint step {step} ({ckpt_dir})")
            restored = True
    if not restored:
        # the reference's loop: one round a minibatch of 32, every epoch
        # a fresh seeded permutation; one epoch_fn call an epoch
        epoch_fn = scheme.make_epoch(cfg)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        tv = torch.as_tensor(views, device=device)
        tl = torch.as_tensor(labels, device=device).long()
        rounds = len(labels) // 32
        epochs = 2 if args.smoke else 5
        for ep in range(epochs):
            ev, el = runner.epoch_batches(tv, tl, ep, rounds, 1, 32)
            state, _ = epoch_fn(state, ev, el, gen)
        if ckpt_dir:
            from repro_torch import checkpoint
            checkpoint.save(ckpt_dir, epochs, state,
                            extra={"arch": "paper-inl", "epochs": epochs})

    # a network whose uplinks straggle: exponential latency tails around
    # the deadline, plus a little outright loss
    link = None
    if args.deadline_ms is not None:
        link = linkfault.LinkModel(erasure=max(args.erasure, 0.05),
                                   latency_ms=5.0, jitter_ms=10.0)
    elif args.erasure > 0:
        link = linkfault.LinkModel(erasure=args.erasure)
    if link is not None:
        topo = linkfault.with_links(topo, link)
    return scheme, state, cfg, topo, views, labels, device


def serve_inl(args):
    """One-shot fuse-what-arrived serving through the continuous-batching
    engine: submit a block of requests, report fused-view stats, accuracy
    under the deadline vs clean, and the per-request bit ledger.  Returns
    a summary dict."""
    from repro_torch.serving import EngineShutdown, ServingEngine

    scheme, state, cfg, topo, views, labels, device = _inl_setup(args)
    n = clamp_requests(args.requests, views.shape[1], strict=args.strict)
    ev, el = views[:, :n], labels[:n]

    transport = None
    if args.transport:
        from repro_torch.transport import DEFAULT_RETRY, NetworkTransport
        transport = NetworkTransport(topo, cfg, seed=args.seed + 3,
                                     policy=DEFAULT_RETRY,
                                     channels=args.transport)
    try:
        engine = ServingEngine(scheme, state, cfg, topology=topo,
                               wire=args.wire, deadline_ms=args.deadline_ms,
                               seed=args.seed + 2, transport=transport,
                               speculative=args.speculative, device=device)
        engine.warmup()
        t0 = time.time()
        try:
            with engine, drain_on_signal(engine) as fired:
                probs, results = engine.serve(ev)
        except EngineShutdown:
            flush_stats(engine, label="drained")
            raise SystemExit(0 if fired.get("sig") else 1)
        dt = time.time() - t0
        snap = transport.snapshot() if transport is not None else None
    finally:
        if transport is not None:
            transport.close()
    arrived = np.asarray([r.views_fused for r in results])
    acc = float(np.mean(np.argmax(probs, -1) == el))
    # the clean reference: the port's predict over the whole block at
    # once; across bucket shapes the engine agrees to float tolerance with
    # identical decisions (serving/engine.py's numerics contract)
    ref_topo = None if args.topology == "star" else topo
    clean = scheme.predict(state, ev, cfg=cfg, topology=ref_topo,
                           device=device).cpu().numpy()
    clean_acc = float(np.mean(np.argmax(clean, -1) == el))
    dl = "none" if args.deadline_ms is None else f"{args.deadline_ms:g}ms"
    J = engine.topo.num_views()
    print(f"arch=paper-inl on {device} served {n} requests over "
          f"{engine.topo.describe()} wire={args.wire}, deadline={dl} "
          f"({dt:.1f}s post-warmup)")
    print(f"views fused per request: min={int(arrived.min())} "
          f"mean={arrived.mean():.2f} max={int(arrived.max())} of {J}")
    print(f"launches={engine.stats.launches} "
          f"pad_fraction={engine.stats.pad_fraction:.2f} "
          f"traces={dict(engine.trace_counts)}")
    print(f"accuracy: {acc:.4f} under the deadline vs {clean_acc:.4f} on a "
          f"clean network; offered={engine.meter.gbits * 1e3:.3f} Mbits "
          f"delivery_ratio={engine.meter.delivery_ratio:.3f}")
    if snap is not None:
        breakers = {k: b["state"] for k, b in snap["breaker"].items()}
        print(f"transport: channels={args.transport} "
              f"patched={engine.stats.patched} "
              f"views_recovered={engine.stats.views_recovered} "
              f"breakers={breakers}")
    if any(c > 1 for c in engine.trace_counts.values()):
        raise RuntimeError(f"bucket predict recaptured: "
                           f"{engine.trace_counts}")
    if args.deadline_ms is not None and int(arrived.min()) == J \
            and engine.stats.patched == 0:
        # speculative fusion RECOVERS stragglers, so the evidence the
        # deadline bit is either a short fusion or a patched request
        raise RuntimeError("deadline never bit: the straggler path was "
                           "not exercised")
    if not engine.faulty and (
            not np.allclose(probs, clean, atol=2e-6, rtol=0)
            or not np.array_equal(np.argmax(probs, -1),
                                  np.argmax(clean, -1))):
        raise RuntimeError("clean-network serving drifted from "
                           "scheme.predict")
    return {"served": n, "accuracy": acc, "clean_accuracy": clean_acc,
            "views_fused": arrived.tolist(),
            "patched": engine.stats.patched,
            "views_recovered": engine.stats.views_recovered,
            "trace_counts": dict(engine.trace_counts)}


def serve_inl_loadgen(args):
    """Poisson offered-load sweep: calibrate serial capacity, then offer
    multiples of it and print p50/p99 latency + goodput per point.
    Returns the sweep's summaries."""
    from repro_torch.serving import (EngineShutdown, ServingEngine,
                                     measure_serial_capacity, run_poisson)

    scheme, state, cfg, topo, views, labels, device = _inl_setup(args)
    n = clamp_requests(args.requests, views.shape[1], strict=args.strict)
    pool = views[:, :n]

    serial = ServingEngine(scheme, state, cfg, topology=topo,
                           wire=args.wire, deadline_ms=args.deadline_ms,
                           buckets=(1,), seed=args.seed + 2, device=device)
    serial.warmup()
    with serial:
        cap = measure_serial_capacity(serial, pool,
                                      num_requests=min(n, 32))
    print(f"serial capacity: {cap:.1f} req/s over {serial.topo.describe()}")

    engine = ServingEngine(scheme, state, cfg, topology=topo,
                           wire=args.wire, deadline_ms=args.deadline_ms,
                           seed=args.seed + 2, max_queue=args.max_queue,
                           device=device)
    engine.warmup()
    print(f"{'offered_rps':>12} {'goodput_rps':>12} {'p50_ms':>9} "
          f"{'p99_ms':>9} {'fused':>6} {'shed':>5}")
    sweep = []
    try:
        with engine, drain_on_signal(engine) as fired:
            for mult in (0.5, 2.0, 8.0):
                s = run_poisson(engine, pool, rate_rps=cap * mult,
                                num_requests=n,
                                seed=args.seed + int(mult * 10))
                sweep.append(s)
                print(f"{s['offered_rps']:12.1f} {s['goodput_rps']:12.1f} "
                      f"{s['p50_ms']:9.2f} {s['p99_ms']:9.2f} "
                      f"{s['mean_views_fused']:6.2f} {s['shed']:5d}")
    except EngineShutdown:
        flush_stats(engine, label="drained")
        raise SystemExit(0 if fired.get("sig") else 1)
    flush_stats(engine, label="done")
    if any(c > 1 for c in engine.trace_counts.values()):
        raise RuntimeError(f"bucket predict recaptured: "
                           f"{engine.trace_counts}")
    return sweep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="paper-inl: per-request fusion deadline — latents "
                         "missing it are dropped and the survivors fused")
    ap.add_argument("--topology", choices=("star", "tree"), default="star",
                    help="paper-inl: serving graph (tree = tree(2, 2))")
    ap.add_argument("--erasure", type=float, default=0.0,
                    help="paper-inl: per-link erasure probability")
    ap.add_argument("--wire", choices=("dense", "packed"), default="dense",
                    help="paper-inl: relay-hop wire format (graph paths)")
    ap.add_argument("--strict", action="store_true",
                    help="error (rather than clamp) when --requests "
                         "exceeds the dataset")
    ap.add_argument("--ckpt-dir", default="",
                    help="paper-inl: serve the latest checkpoint under this "
                         "directory (either package's), skipping the "
                         "training, or save the trained model there when "
                         "none exists")
    ap.add_argument("--transport", choices=("loopback", "socket"),
                    default=None,
                    help="paper-inl: ride each view fragment over a real "
                         "retrying edge channel (repro_torch/transport/) "
                         "instead of per-request fault draws")
    ap.add_argument("--speculative", action="store_true",
                    help="paper-inl (needs --transport): fuse what arrived "
                         "at the deadline, patch late stragglers into the "
                         "next bucket")
    ap.add_argument("--load-gen", action="store_true",
                    help="paper-inl: Poisson offered-load sweep instead of "
                         "the one-shot block")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="paper-inl --load-gen: bound per-node queue depth; "
                         "arrivals over the bound are shed with a typed "
                         "Rejected result")
    args = ap.parse_args(argv)

    if args.arch == "paper-inl":
        return (serve_inl_loadgen if args.load_gen else serve_inl)(args)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.modality == "vlm":
        raise SystemExit("serve demo supports text/audio archs; VLM decode "
                         "is exercised via the dry-run")
    params = zoo.init_params(cfg, args.seed, device=device)
    prompts = prompts_for(cfg, args.requests, args.prompt_len,
                          args.seed).to(device)

    t0 = time.perf_counter()
    gen = serve_batch(cfg, params, prompts, args.gen_len)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.requests * args.gen_len
    print(f"arch={cfg.name} on {device}: served {args.requests} requests, "
          f"prompt={args.prompt_len}, generated {args.gen_len} each "
          f"({toks} tokens, {dt:.1f}s, {toks / dt:.1f} tok/s incl. kernel "
          f"builds)")
    print("sample:", gen[0, :16].tolist())
    return gen


if __name__ == "__main__":
    main()
