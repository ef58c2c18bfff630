"""Serving driver: batched prefill + greedy decode of an LLM.

Reference: src/repro/launch/serve.py (`greedy`, `serve_batch`, `main`'s
LLM branch).

Usage (the card by default; `--device cpu` runs the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --smoke --requests 4 --prompt-len 64 --gen-len 16 --device cpu

Weights are random, drawn from `--seed`; prompts come from the seeded
Markov token stream (`data/tokens`).  `--smoke` takes the reduced config
in fp32, as the reference does.  The paper's INL serving
(`--arch paper-inl`) is `repro_torch.serving.ServingEngine`; this driver's
INL front end comes with a later slice (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import tokens as token_data
from repro_torch.launch import steps as steps_lib
from repro_torch.models import zoo


def greedy(logits):
    return torch.argmax(logits, dim=-1)


def serve_batch(cfg, params, prompts, gen_len: int, *, trace_log=None):
    """prompts: (B, P) integer ids on the parameters' device.  Returns
    (B, gen_len) generated ids.  Prefill once, then greedy decode against
    the cache, grown once by gen_len slots.

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
    last_logits, cache = prefill(params, {"tokens": prompts})
    cache = zoo.pad_cache(cache, gen_len)
    tok = greedy(last_logits)
    out = torch.empty((B, gen_len), dtype=tok.dtype, device=tok.device)
    out[:, 0] = tok
    for t in range(gen_len - 1):
        cache_len = torch.full((), P + t, dtype=torch.int64,
                               device=prompts.device)
        tok, cache = decode(params, {"tokens": tok[:, None],
                                     "cache_len": cache_len}, cache)
        out[:, t + 1] = tok
    return out


def prompts_for(cfg, requests: int, prompt_len: int, seed: int):
    """(requests, prompt_len) int64 ids from the seeded Markov stream."""
    toks = token_data.markov_stream(cfg.vocab_size, requests * prompt_len,
                                    seed=seed)
    return torch.from_numpy(toks.astype(np.int64)).reshape(requests,
                                                           prompt_len)


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
    args = ap.parse_args(argv)

    if args.arch == "paper-inl":
        raise NotImplementedError(
            "--arch paper-inl: serve the paper's model through "
            "repro_torch.serving.ServingEngine; this driver's INL front end "
            "comes with a later slice (ROADMAP queue 1, item 12)")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
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
