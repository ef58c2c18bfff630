"""Training driver.

Reference: src/repro/launch/train.py (`main`), the same flags and the same
schedule, plus `--device` (default cuda).  Two schemes:

    standard  plain LM training of the selected arch
    inl       the paper's in-network learning split of the same arch
              (J encoder nodes + fusion decoder, eq.-6 loss)

The optimizer is `adamw` under `warmup_cosine_schedule(lr, steps // 10,
steps)`, weight decay 0.1, clipped at a global norm of 1.  The batches
(`data/tokens.lm_batches`, numpy) are grouped by `--scan-steps`, stacked,
turned into tensors (ids int64) and put on the device by
`data/prefetch.prefetch_to_device` `--prefetch` groups ahead; each group
runs as one `steps.make_scan_train_step` call and prints one JSON metric
line (the group's last step), then `loss A -> B`.  The inl scheme draws
its view noise and eps from a torch.Generator seeded with seed + 1.

`--ckpt-dir` / `--ckpt-every` save {"params", "opt"} (and, for the inl
scheme, "rng": the generator's state) through `repro_torch.checkpoint`
when a group crosses a multiple of --ckpt-every, and at the end;
`--resume` restores the latest checkpoint, fast-forwards the data stream
through the completed steps, as the reference does, and restores the
generator's state, so a resumed run finishes the schedule bit for bit
like an uninterrupted one (`repro_torch.chaos.crash_resume_check` SIGKILLs
one and compares).  On the card the run is always deterministic, so that
this holds there too: `torch.use_deterministic_algorithms(True)`, under
which an op with no deterministic CUDA implementation raises, and
CUBLAS_WORKSPACE_CONFIG=:4096:8 unless the environment sets it.  cuBLAS
reads that variable once a process, at its first CUDA matmul, so a caller
that runs `main` in a process that has already used cuBLAS sets it before
then; a fresh `python -m` process needs nothing.  `main` undoes both when
it returns.

`main(argv=None)` returns the history (one dict a group), so a caller can
run the CLI in-process; its "wall_s" is unrounded (the printed line
rounds it to 0.1 s, as the reference's).  The line before the last is the
run's step split, the medians over its steps that no profiler recorded of
the device ms of each phase a step (`repro_torch.tracing`: forward,
backward, optimizer and the rest of the step, "other") and the
allocator's retries a step:

    step split (median of 8 steps, device ms): forward 182.1 backward
    401.7 optimizer 98.0 other 3.2; alloc retries 0.00 a step

(one line; on the CPU, which has no device marks, `step split: not
measured on cpu`).  The last line printed is `kernel launches: {...}`,
the process's launch counts of the hand-written kernels (what the
crash-resume check reads from its children).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 50 --batch 8 --seq 128 [--scheme inl] \\
      [--ckpt-dir ckpts] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import (checkpoint, optim, resolve_device, tracing,
                         tree_leaves)
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import prefetch
from repro_torch.data import tokens as token_data
from repro_torch.launch import steps as steps_lib

CUBLAS_WORKSPACE = "CUBLAS_WORKSPACE_CONFIG"


def _as_tensors(batch):
    """A stacked host batch as tensors: ids int64, floats as they are."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu"
                                else v) for k, v in batch.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--scheme", default="standard",
                    choices=["standard", "inl"])
    ap.add_argument("--learned-prior", action="store_true",
                    help="inl scheme: learned per-node Gaussian priors "
                         "Q_psi_j in the eq.-(6) rate (the prior kernels)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--scan-steps", type=int, default=10,
                    help="optimizer steps per make_scan_train_step call "
                         "(1 = a call a step)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="stacked scan groups kept in flight host->device "
                         "(data/prefetch.py); 1 disables the overlap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest --ckpt-dir checkpoint (params, "
                         "optimizer state, the inl generator) and fast-"
                         "forward the data stream, finishing the schedule "
                         "bit-identically to an uninterrupted run "
                         "(repro_torch/chaos.py SIGKILLs + asserts it)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="(superseded: metrics are logged once per scan "
                         "group, i.e. every --scan-steps steps)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    return ap.parse_args(argv)


def model_config(args):
    """The run's config: the smoke config in fp32 with --smoke; for the
    inl scheme grown to encoder_layers + 1 periods and with learned
    priors on --learned-prior."""
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if args.scheme == "inl":
        from repro_torch.models import transformer
        # the INL split needs >= encoder_layers + 1 periods; smoke configs
        # have exactly one: grow the reduced model by one period
        pat = transformer.block_pattern(cfg)
        need = (cfg.inl.encoder_layers + 1) * len(pat) \
            + cfg.moe.first_dense_layers
        if cfg.num_layers < need:
            cfg = dataclasses.replace(cfg, num_layers=need)
        if args.learned_prior:
            cfg = dataclasses.replace(
                cfg, inl=dataclasses.replace(cfg.inl, learned_prior=True))
    return cfg


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        return _train(args, device)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    workspace = os.environ.get(CUBLAS_WORKSPACE)
    os.environ.setdefault(CUBLAS_WORKSPACE, ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args, device)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        if workspace is None:
            del os.environ[CUBLAS_WORKSPACE]


def _train(args, device):
    cfg = model_config(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    optimizer = optim.adamw(
        optim.warmup_cosine_schedule(args.lr, max(args.steps // 10, 1),
                                     args.steps), weight_decay=0.1,
        clip_norm=1.0)
    if args.scheme == "inl":
        from repro_torch.core import inl_llm
        params = inl_llm.init(cfg, gen, device=device)
    else:
        from repro_torch.models import zoo
        params = zoo.init_params(cfg, gen, device=device)
    opt_state = optimizer.init(params)
    epoch_fn = steps_lib.make_scan_train_step(
        cfg, optimizer, scheme=args.scheme, microbatches=args.microbatches)

    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} scheme={args.scheme} params={n_params:,} "
          f"device={device}")

    data = token_data.lm_batches(cfg, args.batch, args.seq, steps=args.steps,
                                 seed=args.seed)
    rng = torch.Generator(device=device).manual_seed(args.seed + 1) \
        if args.scheme == "inl" else None
    K = max(args.scan_steps, 1)
    step = 0

    def state():
        tree = {"params": params, "opt": opt_state}
        if rng is not None:
            tree["rng"] = rng.get_state()
        return tree

    if args.resume and args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            restored, _ = checkpoint.restore(args.ckpt_dir, state(),
                                             step=latest)
            params, opt_state = restored["params"], restored["opt"]
            if rng is not None:
                rng.set_state(restored["rng"])
            step = latest
            # the data generator is deterministic per (cfg, seed): replay
            # it through the completed steps
            for _ in range(step):
                next(data)
            print(f"resumed from step {step} ({args.ckpt_dir})")
    t0 = time.time()
    history = []
    marks_from = tracing.cursor()
    stacked = (_as_tensors(steps_lib.stack_batches(g))
               for g in steps_lib.grouped_batches(data, K))
    for batches in prefetch.prefetch_to_device(
            stacked, size=max(args.prefetch, 1), device=device):
        k = tree_leaves(batches)[0].shape[0]
        if rng is not None:
            params, opt_state, ms = epoch_fn(params, opt_state, batches, rng)
        else:
            params, opt_state, ms = epoch_fn(params, opt_state, batches)
        prev_step, step = step, step + k
        m = {name: float(v[-1]) for name, v in ms.items() if v.ndim == 1}
        m["step"] = step - 1
        m["wall_s"] = time.time() - t0
        history.append(m)
        line = {key: (round(v, 4) if isinstance(v, float) else v)
                for key, v in m.items()}
        line["wall_s"] = round(m["wall_s"], 1)
        print(json.dumps(line), flush=True)
        # checkpoint when the group crossed a --ckpt-every boundary (step
        # advances by the group size, so an exact-multiple test would skip)
        if args.ckpt_dir and args.ckpt_every and \
                step // args.ckpt_every > prev_step // args.ckpt_every:
            checkpoint.save(args.ckpt_dir, step, state(),
                            extra={"arch": cfg.name, "scheme": args.scheme})
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, state(),
                        extra={"arch": cfg.name, "scheme": args.scheme})
    if history:
        first, last = history[0], history[-1]
        key_metric = "loss" if "loss" in last else "ce"
        print(f"loss {first[key_metric]:.4f} -> {last[key_metric]:.4f} "
              f"({args.steps} steps, {time.time() - t0:.1f}s)")
    print(step_split(tracing.summary("eager", since=marks_from), device))
    print("kernel launches: " + json.dumps(_launches()), flush=True)
    return history


def step_split(split, device) -> str:
    """The step-split line of `tracing.summary`'s medians."""
    if split is None:
        return f"step split: not measured on {device.type}"
    retries = "not counted" if split["alloc_retries"] is None \
        else f"{split['alloc_retries']:.2f} a step"
    return (f"step split (median of {split['n']} steps, device ms): "
            + " ".join(f"{k} {split[k]:.1f}" for k in
                       ("forward", "backward", "optimizer", "other"))
            + f"; alloc retries {retries}")


def _launches() -> dict:
    """The hand-written kernels' launch counts in this process (nonzero
    ones; none on the CPU)."""
    from repro_torch.kernels import (adamw, flash_attention, inl_bottleneck,
                                     ssm_scan)
    return {k: n for counts in (inl_bottleneck.LAUNCHES,
                                flash_attention.LAUNCHES, ssm_scan.LAUNCHES,
                                adamw.LAUNCHES)
            for k, n in counts.items() if n}


if __name__ == "__main__":
    main()
