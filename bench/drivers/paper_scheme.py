"""The paper cells' timed entry: a registered scheme's epoch function
(`Scheme.make_epoch`: on the card one CUDA graph a host signature,
replayed once a round), run as `core/schemes/runner.run_scheme` runs each
epoch: `runner.epoch_batches`, the epoch's rounds, then the accuracy on
the first `eval_n` images.

Set-up makes the data set and the weights from the seed on the device
(bench/traffic/multiview.py, the reference's `make_weights`, written into
the state the scheme's `init` built), builds the epoch function and drives
it through rounds 1-3 of epoch 0 in two calls (one round, then two), which
captures its graphs; it keeps the losses, the optimizer's first moment
after round 1 and the weights after round 3 for the comparison, then runs
the rest of epoch 0 and its evaluation.  The window runs whole epochs from epoch 1 until
`seconds` have passed.  With --trace 1 it traces the last `trace_rounds`
rounds of its second epoch, that epoch's evaluation and the next epoch's
batch gather.
"""
from __future__ import annotations

import time

import torch

from bench import roofline
from bench.lib import compare, spec, trace, weights
from bench.traffic import multiview

CHECKED_ROUNDS = 3


def _span(name):
    return torch.profiler.record_function(name)



class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.m = cell.config["program"]
        self.t = cell.traffic
        self.ref = spec.reference(cell.config["reference"])

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.configs.paper_inl import PaperExperimentConfig
        from repro_torch.core import schemes
        from repro_torch.core.schemes import base, runner
        self._base, self._runner = base, runner
        t, dev = self.t, self.device
        self.cfg = PaperExperimentConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in self.m.items()})
        self.views, self.labels = multiview.make(self.m, self.seed, dev)
        self.scheme = schemes.get(t["scheme"])
        state = self.scheme.init(
            self.cfg, torch.Generator(device=dev).manual_seed(
                weights.leaf_seed(self.seed, "program")), lr=t["lr"],
            device=dev)
        self.w0 = self.ref.make_weights(self.m, t["scheme"], self.seed, dev)
        self.replicas = self.cfg.num_clients if t["scheme"] == "fl" else 0
        used = set()

        def make(name, shape):
            w = self.w0[name]
            if tuple(w.shape) != shape:
                raise ValueError(f"{name}: the program holds {shape}, the "
                                 f"reference {tuple(w.shape)}")
            used.add(name)
            return w
        weights.fill(state["params"], make, self.replicas)
        if used != set(self.w0):
            raise ValueError(f"weights the program does not hold: "
                             f"{sorted(set(self.w0) - used)}")

        self.epoch_fn = self.scheme.make_epoch(self.cfg, lr=t["lr"],
                                               wire=t["wire"])
        self.gen_seed = weights.leaf_seed(self.seed, "rounds")
        self.gen = torch.Generator(device=dev).manual_seed(self.gen_seed)
        B, n = t["batch"], self.labels.shape[0]
        self.bpr = self.scheme.batches_per_round(self.cfg)
        self.rounds = runner.rounds_per_epoch(self.scheme, self.cfg, n, B)
        n_eval = min(t["eval_n"], n)
        self.ev, self.el = self.views[:, :n_eval], self.labels[:n_eval]

        ep_views, ep_labels = runner.epoch_batches(
            self.views, self.labels, 0, self.rounds, self.bpr, B)
        k = CHECKED_ROUNDS
        self.checked = [(ep_views[r].clone(), ep_labels[r].clone())
                        for r in range(k)]
        state, m1 = self.epoch_fn(state, ep_views[:1], ep_labels[:1],
                                  self.gen)
        grad = {name: compare.norm(m) / (1 - 0.9) for name, m
                in weights.named_leaves(state["opt"]["m"])}
        state, m2 = self.epoch_fn(state, ep_views[1:k], ep_labels[1:k],
                                  self.gen)
        losses = torch.cat([m1["loss"], m2["loss"]]).tolist()
        change = {name: compare.norm((p[0] if self.replicas else p)
                                     - self.w0[name])
                  for name, p in weights.named_leaves(state["params"])}
        self.program = {"losses": losses, "grad": grad, "change": change}
        # the rest of epoch 0 and its evaluation: the card's first seconds
        # of this work run slower, and they are warm-up, not the window
        state, _ = self.epoch_fn(state, ep_views[k:], ep_labels[k:],
                                 self.gen)
        del ep_views, ep_labels
        self._evaluate(state)
        self.state = state
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _evaluate(self, state) -> float:
        return self._base.evaluate_accuracy(self.scheme, state, self.ev,
                                            self.el, cfg=self.cfg,
                                            device=self.device)

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, traced: bool) -> dict:
        t, B = self.t, self.t["batch"]
        runner, state, gen = self._runner, self.state, self.gen
        n_trace = min(t["trace_rounds"], self.rounds)
        seg, tr, losses, done, ep = None, None, [], 0, 1
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            with _span("bench.epoch_batches"):
                ep_views, ep_labels = runner.epoch_batches(
                    self.views, self.labels, ep, self.rounds, self.bpr, B)
            if seg is not None:
                seg.__exit__(None, None, None)
                tr, seg = seg.trace, None
                after = (time.perf_counter(), done)
            if traced and tr is None and ep == 2:
                k0 = self.rounds - n_trace
                state, m = self.epoch_fn(state, ep_views[:k0],
                                         ep_labels[:k0], gen)
                losses.append(m["loss"])
                seg = trace.Segment().__enter__()
                with _span("bench.rounds"):
                    state, m = self.epoch_fn(state, ep_views[k0:],
                                             ep_labels[k0:], gen)
            else:
                with _span("bench.rounds"):
                    state, m = self.epoch_fn(state, ep_views, ep_labels, gen)
            losses.append(m["loss"])
            with _span("bench.evaluate"):
                self._evaluate(state)
            done += self.rounds
            ep += 1
            marks.append(time.perf_counter())
            if seg is None and time.perf_counter() - t0 >= seconds \
                    and (tr is not None or not traced):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.state = state
        finite = torch.isfinite(torch.cat(losses))
        out = {"attempted": done, "failed": int((~finite).sum()),
               "end_to_end": {"train_images_per_s":
                              done * self.bpr * B / wall},
               "trace": tr, "info": {},
               "unit_s": [b - a for a, b in zip(marks, marks[1:])]}
        if tr is not None:
            out["info"] = self._trace_info(n_trace)
            out["info"].update(mfu_units=done - after[1],
                               mfu_seconds=t0 + wall - after[0])
        return out

    def _trace_info(self, n_rounds: int) -> dict:
        """What the per-layer readers need (bench/lib/readers.py): a
        round's model FLOPs, the peak they are held to, and the traced
        segment's cut-layer launches with their rows (its rounds', then its
        one evaluation's)."""
        t, m = self.t, self.m
        J, B, d = m["num_clients"], t["batch"], m["d_bottleneck"]
        fl = t["scheme"] == "fl"
        steps, mode = (self.bpr, "none") if fl else (1, "sample")
        n_eval = self.el.shape[0]
        fwd = [(J * B, d, 4, mode, n_rounds * steps), (J * n_eval, d, 4,
                                                       "none", 1)]
        bwd = [(J * B, d, 4, mode, n_rounds * steps)]
        return {"unit_flops": roofline.paper_round_flops(
                    m, t["scheme"], B, local_steps=self.bpr // J),
                "flops_peak": roofline.PEAKS["h100"]["fp32_flops_per_s"],
                "cut_launches": {"cut_fwd_kernel": fwd,
                                 "cut_bwd_kernel": bwd}}

    # -- the comparison ------------------------------------------------------

    def release(self) -> None:
        for name in ("state", "epoch_fn", "views", "labels", "ev", "el"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: str = "fp32", half: bool = False) -> dict:
        """The plain reference's three rounds from the same weights, data
        and draws (a generator seeded as the program's)."""
        gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        kw = dict(lr=self.t["lr"], prec=prec, half=half)
        if self.t["scheme"] == "fl":
            return self.ref.run_fl(self.m, self.w0, self.checked, gen,
                                   local_steps=self.bpr // self.m[
                                       "num_clients"], **kw)
        rounds = [(v[0], lab[0]) for v, lab in self.checked]
        return self.ref.run_inl(self.m, self.w0, rounds, gen, **kw)
