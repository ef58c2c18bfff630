"""A plain LLM training cell's timed entry: the standard scheme, as
`launch/train` trains an architecture by default.
`steps.make_scan_train_step(cfg, adamw, scheme="standard")` runs K
optimizer steps a call over the stage's `zoo.loss_and_metrics`, fed by
`data/prefetch.prefetch_to_device` with groups of K batches stacked by
`steps.stack_batches`; AdamW under the warm-up cosine schedule, weight
decay, clipping; CUDA's deterministic algorithms on, as the launcher runs
on the card.  The step draws nothing.

Set-up draws the weights from the seed on the device (the reference's
`make_weight`, one leaf at a time, written into the tree
`zoo.init_params` built) and drives the first three steps through the same
call and feed, a group of one step then one of two, as
bench/drivers/llm_inl_train.py does, whose window, release and feed this
driver shares.  The architecture is the configuration file's `arch`; a
checkout whose port does not register it fails at the start of set-up.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench import roofline
from bench.drivers import llm_inl_train
from bench.lib import compare, weights
from bench.roofline import zamba2 as zamba2_roofline
from bench.traffic import tokens as token_traffic

CHECKED_STEPS = llm_inl_train.CHECKED_STEPS
# the sizes the configuration file states, put in place of the
# registered config's
HELD = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size", "rope_theta", "norm_eps", "dtype",
        "num_mem_blocks", "adapter_rank", "attn_scale")
SSD_KERNELS = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
               "ssd_out_kernel")


class Driver(llm_inl_train.Driver):

    def _model_config(self):
        from repro_torch.configs.base import get_config
        m = self.m
        cfg = get_config(m["arch"])
        ssm = dataclasses.replace(cfg.ssm, **m["ssm"])
        return dataclasses.replace(cfg, **{k: m[k] for k in HELD}, ssm=ssm)

    def setup(self) -> None:
        t, dev = self.t, self.device
        self.cfg = self._model_config()
        from repro_torch.data import prefetch
        from repro_torch.launch import steps as steps_lib
        from repro_torch.models import zoo
        self.opt_cfg = {"lr": t["lr"], "warmup": max(t["schedule_steps"] // 10,
                                                     1),
                        "schedule_steps": t["schedule_steps"],
                        "weight_decay": t["weight_decay"], "clip": t["clip"]}
        params = zoo.init_params(self.cfg, torch.Generator(device=dev)
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
                                                    scheme="standard")
        self.gen = None

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
                                           next(self.feed))
        grad = {name: compare.norm(m) / (1 - 0.9) for name, m
                in weights.named_leaves(opt_state["m"])}
        params, opt_state, m2 = self.epoch(params, opt_state,
                                           next(self.feed))
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

    def _trace_info(self, n_steps: int, wait_s: float) -> dict:
        t, m = self.t, self.m
        B, S = t["batch"], t["seq"]
        s = m["ssm"]
        H, Dh = m["num_heads"], m["head_dim"]
        hybrids = m["num_layers"] // 6
        H_ssd = s["expand"] * m["d_model"] // s["head_dim"]
        peak = roofline.PEAKS["h100"]["bf16_flops_per_s"]
        flash = roofline.bound_s(roofline.flash_fwd_flops(B, S, H, Dh),
                                 roofline.flash_fwd_bytes(B, S, H, H, Dh),
                                 peak)
        ssd = roofline.bound_s(
            zamba2_roofline.ssd_scan_flops(B, S, H_ssd, s["head_dim"],
                                           s["state_dim"], s["ngroups"],
                                           min(s["chunk_size"], S)),
            zamba2_roofline.ssd_scan_bytes(B, S, H_ssd, s["head_dim"],
                                           s["state_dim"], s["ngroups"]),
            peak)
        # a forward and the period's recompute a layer, each step; the
        # backward at Dh > 128 is four launches (dq, dv, dk, the sum)
        return {"unit_flops": zamba2_roofline.step_flops(m, B, S),
                "flops_peak": peak,
                "flash_launches": 2 * hybrids * n_steps,
                "flash_bound_s": flash,
                "ssd_launches": {"kernels": SSD_KERNELS,
                                 "calls": 2 * m["num_layers"] * n_steps,
                                 "launches_a_call": len(SSD_KERNELS),
                                 "bound_s": ssd},
                "flash_bwd_launches": {
                    "calls": hybrids * n_steps,
                    "launches_a_call": 4 if Dh > 128 else 3,
                    "bound_s": zamba2_roofline.flash_bwd_flops(B, S, H, Dh)
                    / peak},
                "data_wait_s": wait_s}

    def reference(self, prec: str = "fp32", half: bool = False) -> dict:
        batches = [tuple(torch.from_numpy(b[k].astype(np.int64))
                         .to(self.device) for k in ("tokens", "labels"))
                   for b in self.checked[:CHECKED_STEPS]]
        return self.ref.run(self.m, self.opt_cfg, self.seed, batches, None,
                            prec=prec, half=half, device=self.device)
