"""The LLM cells' timed entry: INL over an attention-block LLM trained as
`launch/train` trains it.  `steps.make_scan_train_step(cfg, adamw,
scheme="inl")` runs K optimizer steps a call, fed by
`data/prefetch.prefetch_to_device` with groups of K batches stacked by
`steps.stack_batches`, the view noise and eps drawn from one generator;
AdamW under the warm-up cosine schedule, weight decay, clipping; CUDA's
deterministic algorithms on, as the launcher runs on the card.  Each
group's last loss is read on the host, as the launcher prints it.

Set-up draws the weights from the seed on the device (the reference's
`make_weight`, one leaf at a time, written into the tree `inl_llm.init`
built), and drives the first three steps through the same call and feed:
a group of one step, then one of two.  The first is the warm-up; the
comparison keeps the losses, the optimizer's first moment after step 1 and
the fp32 master weights after step 3.  The window runs groups of K until
`seconds` have passed.  With --trace 1 it traces `trace_groups` groups
after the first of the window.  The time the loop waits in `next()` on the
prefetch iterator is the benchmark's span `bench.data_wait`.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from bench import roofline
from bench.lib import compare, spec, trace, weights
from bench.traffic import tokens as token_traffic

CHECKED_STEPS = 3
CUBLAS_WORKSPACE = "CUBLAS_WORKSPACE_CONFIG"


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.m = cell.config["program"]
        self.t = cell.traffic
        self.ref = spec.reference(cell.config["reference"])
        if self.device.type == "cuda":
            # cuBLAS reads it at its first matmul, which comes later
            os.environ.setdefault(CUBLAS_WORKSPACE, ":4096:8")
            torch.use_deterministic_algorithms(True)

    def _model_config(self):
        """The program's registered config of the architecture with every
        size the configuration file states put in its place."""
        from repro_torch.configs.base import get_config
        m = self.m
        cfg = get_config(m["arch"])
        held = {k: m[k] for k in ("num_layers", "d_model", "num_heads",
                                  "num_kv_heads", "head_dim", "d_ff",
                                  "vocab_size", "qkv_bias", "rope_theta",
                                  "act", "norm_eps", "dtype",
                                  "sliding_window")}
        return dataclasses.replace(
            cfg, **held, inl=dataclasses.replace(cfg.inl, **m["inl"]))

    def _optimizer(self):
        from repro_torch import optim
        o = self.opt_cfg
        return optim.adamw(
            optim.warmup_cosine_schedule(o["lr"], o["warmup"],
                                         o["schedule_steps"]),
            weight_decay=o["weight_decay"], clip_norm=o["clip"])

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.core import inl_llm
        from repro_torch.data import prefetch
        from repro_torch.launch import steps as steps_lib
        t, dev = self.t, self.device
        self.cfg = self._model_config()
        self.opt_cfg = {"lr": t["lr"], "warmup": max(t["schedule_steps"] // 10,
                                                     1),
                        "schedule_steps": t["schedule_steps"],
                        "weight_decay": t["weight_decay"], "clip": t["clip"]}
        params = inl_llm.init(self.cfg, torch.Generator(device=dev)
                              .manual_seed(weights.leaf_seed(self.seed,
                                                             "program")),
                              device=dev)
        shapes = self.ref.shapes(self.m)
        used = set()

        def make(name, shape):
            if shapes.get(name) != shape:
                raise ValueError(f"{name}: the program holds {shape}, the "
                                 f"reference {shapes.get(name)}")
            used.add(name)
            return self.ref.make_weight(self.m, name, shape, self.seed, dev)
        weights.fill(params, make)
        if used != set(shapes):
            raise ValueError(f"weights the program does not hold: "
                             f"{sorted(set(shapes) - used)}")
        optimizer = self._optimizer()
        opt_state = optimizer.init(params)
        self.epoch = steps_lib.make_scan_train_step(self.cfg, optimizer,
                                                    scheme="inl")
        self.gen_seed = weights.leaf_seed(self.seed, "draws")
        self.gen = torch.Generator(device=dev).manual_seed(self.gen_seed)

        K, first = t["scan_steps"], [1, CHECKED_STEPS - 1]
        self.checked = []

        def groups():
            stream = token_traffic.lm_stream(
                self.m["vocab_size"], t["batch"], t["seq"],
                seed=weights.leaf_seed(self.seed, "tokens"),
                noise=t["markov_noise"])
            sizes = iter(first)
            while True:
                k = next(sizes, K)
                group = [next(stream) for _ in range(k)]
                if len(self.checked) < CHECKED_STEPS:
                    self.checked += [dict(b) for b in group]
                yield {key: torch.from_numpy(v.astype(np.int64))
                       for key, v in steps_lib.stack_batches(group).items()}

        self.feed = prefetch.prefetch_to_device(groups(), size=t["prefetch"],
                                                device=dev)
        params, opt_state, m1 = self.epoch(params, opt_state,
                                           next(self.feed), self.gen)
        grad = {name: compare.norm(m) / (1 - 0.9) for name, m
                in weights.named_leaves(opt_state["m"])}
        params, opt_state, m2 = self.epoch(params, opt_state,
                                           next(self.feed), self.gen)
        losses = torch.cat([m1["loss"], m2["loss"]]).tolist()
        master = opt_state.get("master", params)
        change = {}
        for name, p in weights.named_leaves(master):
            w0 = self.ref.make_weight(self.m, name, tuple(p.shape), self.seed,
                                      dev, torch.float32)
            change[name] = compare.norm(p.float() - w0)
            del w0
        self.program = {"losses": losses, "grad": grad, "change": change}
        self.params, self.opt_state = params, opt_state
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, traced: bool) -> dict:
        t = self.t
        K, tokens = t["scan_steps"], t["batch"] * t["seq"]
        params, opt_state = self.params, self.opt_state
        seg, tr, losses, steps, groups, wait = None, None, [], 0, 0, 0.0
        n_trace = t["trace_groups"]
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            if traced and tr is None and seg is None and groups == 1:
                seg, traced_from = trace.Segment().__enter__(), groups
            w = time.perf_counter()
            with torch.profiler.record_function("bench.data_wait"):
                batches = next(self.feed)
            wait += time.perf_counter() - w
            with torch.profiler.record_function("bench.scan_step"):
                params, opt_state, ms = self.epoch(params, opt_state, batches,
                                                   self.gen)
            del batches
            losses.append(ms["loss"])
            float(ms["loss"][-1])
            steps += K
            groups += 1
            marks.append(time.perf_counter())
            if seg is not None and groups - traced_from == n_trace:
                seg.__exit__(None, None, None)
                tr, seg = seg.trace, None
                after = (time.perf_counter(), steps)
            if seg is None and time.perf_counter() - t0 >= seconds \
                    and (tr is not None or not traced):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.params, self.opt_state = params, opt_state
        finite = torch.isfinite(torch.cat(losses))
        out = {"attempted": steps, "failed": int((~finite).sum()),
               "end_to_end": {"train_tokens_per_s": steps * tokens / wall},
               "trace": tr, "info": {},
               "unit_s": [b - a for a, b in zip(marks, marks[1:])]}
        if tr is not None:
            out["info"] = self._trace_info(n_trace * K, wait / steps)
            out["info"].update(mfu_units=steps - after[1],
                               mfu_seconds=t0 + wall - after[0])
        return out

    def _trace_info(self, n_steps: int, wait_s: float) -> dict:
        t, m = self.t, self.m
        B, S = t["batch"], t["seq"]
        J, d_b = m["inl"]["num_nodes"], m["inl"]["d_bottleneck"]
        R = J * B * S
        layers = J * m["inl"]["encoder_layers"] + m["num_layers"] \
            - m["inl"]["encoder_layers"]
        H, KV, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        peak = roofline.PEAKS["h100"]["bf16_flops_per_s"]
        flash = roofline.bound_s(roofline.flash_fwd_flops(B, S, H, Dh),
                                 roofline.flash_fwd_bytes(B, S, H, KV, Dh),
                                 peak)
        return {"unit_flops": roofline.inl_llm_step_flops(m, B, S),
                "flops_peak": peak,
                "cut_launches": {
                    "cut_fwd_kernel": [(R, d_b, 2, "sample", n_steps)],
                    "cut_bwd_kernel": [(R, d_b, 2, "sample", n_steps)]},
                # a forward and the period's recompute a layer, each step
                "flash_launches": 2 * layers * n_steps,
                "flash_bound_s": flash,
                "data_wait_s": wait_s}

    # -- the comparison ------------------------------------------------------

    def release(self) -> None:
        self.feed.close()
        self.params = self.opt_state = self.epoch = self.feed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: str = "fp32", half: bool = False) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        batches = [tuple(torch.from_numpy(b[k].astype(np.int64))
                         .to(self.device) for k in ("tokens", "labels"))
                   for b in self.checked[:CHECKED_STEPS]]
        return self.ref.run(self.m, self.opt_cfg, self.seed, batches, gen,
                            prec=prec, half=half, device=self.device)
