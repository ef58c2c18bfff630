"""Deterministic chaos: scripted process/link faults and the cluster drill.

Reference: src/repro/chaos.py (`ChaosEvent`, `ChaosSchedule`,
`cluster_drill`, `main`).

The transport layer (repro_torch/transport/) consults a `ChaosSchedule`
on every transmission: the schedule answers three pure queries over TICK
time (a training round index, or a serving request id) —

    edge_down(key, tick)     the edge drops every attempt in the window
    slow_factor(key, tick)   latency multiplier (a 10x-slowed client)
    node_dead(name, tick)    the node is killed: it sends nothing, and
                             every route THROUGH it fails

Windows are half-open [start, stop) in ticks; `stop=None` means forever.
Because the queries are pure functions of (schedule, tick) and every
transport fault draw is already counter-seeded, a chaos run replays
bit-identically.  `ChaosSchedule.seeded` scripts a reproducible random
schedule from an integer seed; the builder methods (`kill_node`,
`down_edge`, `flap_edge`, `slow_edge`) script exact scenarios.

`cluster_drill` (`--procs`) SIGKILLs and SIGSTOPs real supervised worker
processes (repro_torch/cluster) on a schedule and asserts the masks:

    PYTHONPATH=src python -m repro_torch.chaos --procs

`crash_resume_check` (the default, without `--procs`; the reference's
`_train_argv`, `_run_until_kill`, `_final_arrays` and
`crash_resume_check`) SIGKILLs a real `repro_torch.launch.train` process
after `--kill-after-step`, resumes it with `--resume`, and asserts that
the resumed metric lines equal the uninterrupted run's and that the final
checkpoints are equal bit for bit:

    PYTHONPATH=src python -m repro_torch.chaos [--device cpu] \
        [--learned-prior]

The children run with `--prefetch 1`, as the reference's; on the card
the launcher always runs with deterministic algorithms.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

EVENT_KINDS = ("edge_down", "edge_flap", "edge_slow", "node_kill",
               "node_freeze")


@dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault window over tick time, [start, stop)."""
    kind: str                     # one of EVENT_KINDS
    target: str                   # edge key ("m0->fuse") or node name
    start: int = 0
    stop: Optional[int] = None    # None = never recovers
    factor: float = 1.0           # edge_slow: latency multiplier
    period: int = 2               # edge_flap: down `duty` of every `period`
    duty: int = 1

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown chaos event kind {self.kind!r}; "
                             f"one of {EVENT_KINDS}")
        if self.stop is not None and self.stop <= self.start:
            raise ValueError(f"empty window [{self.start}, {self.stop})")
        if self.kind == "edge_flap" and not 0 < self.duty <= self.period:
            raise ValueError(f"flap needs 0 < duty <= period, got "
                             f"duty={self.duty} period={self.period}")

    def active(self, tick: int) -> bool:
        return tick >= self.start and (self.stop is None or tick < self.stop)


@dataclass(frozen=True)
class ChaosSchedule:
    """An immutable script of fault windows; builders return new schedules
    so scenarios compose fluently:

        ChaosSchedule().kill_node("m1", at=4, duration=3) \\
                       .flap_edge("m0->fuse", start=2, stop=10, period=2)
    """
    events: Tuple[ChaosEvent, ...] = ()

    # -- the three transport queries --------------------------------------

    def edge_down(self, key: str, tick: int) -> bool:
        for e in self.events:
            if e.target != key or not e.active(tick):
                continue
            if e.kind == "edge_down":
                return True
            if e.kind == "edge_flap" and \
                    (tick - e.start) % e.period < e.duty:
                return True
        return False

    def slow_factor(self, key: str, tick: int) -> float:
        f = 1.0
        for e in self.events:
            if e.kind == "edge_slow" and e.target == key and e.active(tick):
                f *= e.factor
        return f

    def node_dead(self, name: str, tick: int) -> bool:
        return any(e.kind == "node_kill" and e.target == name
                   and e.active(tick) for e in self.events)

    def node_frozen(self, name: str, tick: int) -> bool:
        """The node is SIGSTOPped: its process exists but answers nothing.
        Unlike `node_dead` the transport does NOT consult this directly —
        a frozen worker is discovered the hard way (probe and data-path
        timeouts walking the membership ladder), which is the point."""
        return any(e.kind == "node_freeze" and e.target == name
                   and e.active(tick) for e in self.events)

    # -- builders ----------------------------------------------------------

    def _with(self, ev: ChaosEvent) -> "ChaosSchedule":
        return ChaosSchedule(self.events + (ev,))

    def kill_node(self, name: str, at: int,
                  duration: Optional[int] = None) -> "ChaosSchedule":
        """SIGKILL node `name` at tick `at`; it rejoins after `duration`
        ticks (None: never — a permanent client leave)."""
        return self._with(ChaosEvent(
            "node_kill", name, start=at,
            stop=None if duration is None else at + duration))

    def freeze_node(self, name: str, at: int,
                    duration: Optional[int] = None) -> "ChaosSchedule":
        """SIGSTOP node `name` at tick `at`, SIGCONT after `duration` ticks
        (None: never).  Realised by the cluster Supervisor on real worker
        processes; in-process transports ignore freeze windows."""
        return self._with(ChaosEvent(
            "node_freeze", name, start=at,
            stop=None if duration is None else at + duration))

    def down_edge(self, key: str, at: int, duration: int = 1):
        return self._with(ChaosEvent("edge_down", key, start=at,
                                     stop=at + duration))

    def flap_edge(self, key: str, start: int, stop: int, period: int = 2,
                  duty: int = 1):
        """The edge goes down for `duty` of every `period` ticks in
        [start, stop) — the breaker-exercising pattern."""
        return self._with(ChaosEvent("edge_flap", key, start=start,
                                     stop=stop, period=period, duty=duty))

    def slow_edge(self, key: str, start: int, stop: Optional[int],
                  factor: float = 10.0):
        """Multiply the edge's latency by `factor` — the 10x-slowed client
        whose payloads turn into deadline stragglers."""
        return self._with(ChaosEvent("edge_slow", key, start=start,
                                     stop=stop, factor=factor))

    @classmethod
    def seeded(cls, seed: int, *, edge_keys: Sequence[str] = (),
               nodes: Sequence[str] = (), ticks: int = 64,
               p_edge_down: float = 0.1, p_node_kill: float = 0.02,
               max_outage: int = 4) -> "ChaosSchedule":
        """A reproducible random schedule: per tick, each edge goes down
        with `p_edge_down` and each node dies with `p_node_kill`, for an
        outage of 1..max_outage ticks — same seed, same script."""
        rng = np.random.default_rng((seed, 0xC4A05))
        sched = cls()
        for key in edge_keys:
            for t in range(ticks):
                if rng.random() < p_edge_down:
                    sched = sched.down_edge(
                        key, t, int(rng.integers(1, max_outage + 1)))
        for name in nodes:
            for t in range(ticks):
                if rng.random() < p_node_kill:
                    sched = sched.kill_node(
                        name, t, int(rng.integers(1, max_outage + 1)))
        return sched

    def describe(self) -> str:
        if not self.events:
            return "ChaosSchedule(empty)"
        spans = [f"{e.kind}:{e.target}@[{e.start},"
                 f"{'inf' if e.stop is None else e.stop})"
                 for e in self.events]
        return f"ChaosSchedule({len(self.events)} events: " \
               f"{'; '.join(spans[:8])}{'...' if len(spans) > 8 else ''})"


# ---------------------------------------------------------------------------
# Process-kill drill: SIGKILL/SIGSTOP real supervised workers, assert masks
# ---------------------------------------------------------------------------

def _expect(ok: bool, what) -> None:
    """The drill's assertion: raises AssertionError (also under -O)."""
    if not ok:
        raise AssertionError(what)


def cluster_drill(args) -> dict:
    """The `--procs` CI drill: a 3-process cluster under a scripted kill
    AND a scripted freeze, asserted at the mask level.

      * SIGKILL m1 for 3 ticks: its vote is lost for EXACTLY that window
        (the supervisor respawns it the first tick the schedule allows,
        incarnation bumped);
      * SIGSTOP m2 for 3 ticks: the process survives but answers nothing —
        data-path timeouts cost its vote, the membership ladder walks
        up -> suspect -> down, and the first pong after SIGCONT rejoins
        the SAME incarnation (no respawn);
      * the whole story replays: a second cluster run over the same
        schedule produces identical masks.
    """
    from repro_torch.cluster import Cluster
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.transport import NO_RETRY

    cfg = PaperExperimentConfig(
        num_clients=3, noise_stds=(0.4, 1.0, 2.0), conv_channels=(4,),
        d_bottleneck=8, dense_units=(32,), image_shape=(16, 16, 3),
        dataset_size=128)
    kill = ("m1", 6, 3)
    freeze = ("m2", 12, 3)
    ticks = 20
    sched = (ChaosSchedule()
             .kill_node(kill[0], at=kill[1], duration=kill[2])
             .freeze_node(freeze[0], at=freeze[1], duration=freeze[2]))

    def run():
        # NO_RETRY + no breaker keep the mask windows exact: one attempt
        # per edge per tick, no open-breaker tail after recovery
        with Cluster(cfg, seed=args.seed, chaos=sched, policy=NO_RETRY,
                     breaker=None) as cl:
            names = cl.topo.view_nodes()
            masks = [cl.transport.round_outcome(t, 32).mask.tolist()
                     for t in range(ticks)]
            return (names, masks, cl.supervisor.events(),
                    dict(cl.supervisor.membership().incarnations),
                    cl.supervisor.respawns)

    names, masks, events, incarnations, respawns = run()
    idx = {n: j for j, n in enumerate(names)}
    for t in range(ticks):
        for name, at, dur in (kill, freeze):
            want = not (at <= t < at + dur)
            _expect(masks[t][idx[name]] == want,
                    f"tick {t}: {name} vote {masks[t][idx[name]]}, "
                    f"want {want}; masks={masks}")
        for name in names:
            if name not in (kill[0], freeze[0]):
                _expect(masks[t][idx[name]], f"healthy {name} lost tick {t}")
    _expect(incarnations[kill[0]] == 2, incarnations)    # respawned once
    _expect(incarnations[freeze[0]] == 1, incarnations)  # rejoined in place
    _expect(respawns == 1, respawns)
    transitions = [ev[2] for ev in events if ev[1] == freeze[0]]
    _expect("up->suspect" in transitions and "suspect->down" in transitions
            and transitions[-1] == "down->up", transitions)

    _, masks2, *_ = run()
    _expect(masks == masks2, "cluster drill did not replay identically")
    return {"nodes": list(names), "ticks": ticks,
            "kill": {"node": kill[0], "window": [kill[1], kill[1] + kill[2]]},
            "freeze": {"node": freeze[0],
                       "window": [freeze[1], freeze[1] + freeze[2]]},
            "respawns": respawns,
            "incarnations": incarnations,
            "membership_events": [list(ev) for ev in events],
            "replay_identical": True}


# ---------------------------------------------------------------------------
# Crash-resume rig: SIGKILL a real training process, resume, compare
# ---------------------------------------------------------------------------

_SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHES = "kernel launches: "      # launch/train.py's last line


def _train_argv(args, ckpt_dir: str, resume: bool):
    argv = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", args.arch, "--smoke", "--scheme", args.scheme,
            "--steps", str(args.steps), "--batch", str(args.batch),
            "--seq", str(args.seq), "--scan-steps", str(args.scan_steps),
            "--seed", str(args.seed), "--prefetch", "1",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", str(args.ckpt_every),
            "--device", getattr(args, "device", "cuda")]
    if getattr(args, "learned_prior", False):
        argv.append("--learned-prior")
    if resume:
        argv.append("--resume")
    return argv


def _run_until_kill(argv, kill_after_step: Optional[int]):
    """Run the training subprocess, streaming its JSON metric lines; when
    `kill_after_step` is reached, SIGKILL the process mid-run (the crash
    under test: no atexit, no flush, no goodbye).  Returns (metric lines,
    killed?, the run's kernel launch counts, None for a killed run)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [_SRC, env.get("PYTHONPATH", "")] if p)
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines, killed, other, launches = [], False, [], None
    assert proc.stdout is not None
    for line in proc.stdout:
        line = line.strip()
        if line.startswith(_LAUNCHES):
            launches = json.loads(line[len(_LAUNCHES):])
        if not line.startswith("{"):
            other.append(line)
            continue
        try:
            m = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "step" in m:
            lines.append(m)
            if kill_after_step is not None and not killed \
                    and m["step"] >= kill_after_step:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
    proc.stdout.read()
    proc.wait()
    if not killed and proc.returncode != 0:
        raise RuntimeError(f"training run failed (rc={proc.returncode}); "
                           f"argv={argv}\n" + "\n".join(other[-20:]))
    return lines, killed, launches


def _final_arrays(ckpt_dir: str):
    from repro_torch import checkpoint
    step = checkpoint.latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        return step, {k: data[k].copy() for k in data.files}


def crash_resume_check(args) -> dict:
    """The CI crash-resume assertion, end to end:

      1. GOLDEN: an uninterrupted run, metrics + final checkpoint kept;
      2. CRASH:  the same run SIGKILLed once step `kill_after_step` prints;
      3. RESUME: rerun with --resume: it restores the last checkpoint,
         fast-forwards the data stream, restores the inl generator and
         finishes the schedule;
      4. assert every post-resume metric line equals the golden line for
         the same step, and the final checkpoints match BIT FOR BIT.

    `args` has the reference's fields (arch, scheme, steps, batch, seq,
    scan_steps, seed, ckpt_every, kill_after_step, workdir) and, optional,
    `device` (default cuda) and `learned_prior`.  Returns the comparison
    record, the reference's with the golden and resumed children's kernel
    launch counts added ("kernel_launches")."""
    golden_dir = os.path.join(args.workdir, "golden")
    crash_dir = os.path.join(args.workdir, "crash")
    golden, _, golden_launches = _run_until_kill(
        _train_argv(args, golden_dir, resume=False), None)
    _expect(bool(golden), "golden run produced no metric lines")

    partial, killed, _ = _run_until_kill(
        _train_argv(args, crash_dir, resume=False), args.kill_after_step)
    _expect(killed, f"run finished before step {args.kill_after_step}; "
                    f"raise --steps or lower --kill-after-step")
    from repro_torch import checkpoint
    resume_from = checkpoint.latest_step(crash_dir)
    _expect(resume_from is not None,
            "crash left no checkpoint; lower --ckpt-every")

    resumed, _, resumed_launches = _run_until_kill(
        _train_argv(args, crash_dir, resume=True), None)
    _expect(bool(resumed), "resumed run produced no metric lines")

    by_step = {m["step"]: m for m in golden}
    mismatches = []
    for m in resumed:
        g = by_step.get(m["step"])
        if g is None or any(g.get(k) != v for k, v in m.items()
                            if k != "wall_s"):
            mismatches.append((m, g))
    _expect(not mismatches,
            f"resumed trajectory diverged from golden: {mismatches[:3]}")

    gstep, garr = _final_arrays(golden_dir)
    rstep, rarr = _final_arrays(crash_dir)
    _expect(gstep == rstep, (gstep, rstep))
    _expect(set(garr) == set(rarr), sorted(set(garr) ^ set(rarr))[:5])
    diff = [k for k in garr if not np.array_equal(garr[k], rarr[k])]
    _expect(not diff, f"final checkpoints differ bitwise on {diff[:5]}")
    return {"resume_from_step": resume_from,
            "final_step": gstep,
            "metric_lines_compared": len(resumed),
            "tensors_compared": len(garr),
            "bitwise_identical": True,
            "kernel_launches": {"golden": golden_launches,
                                "resumed": resumed_launches}}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="crash-resume chaos check over launch/train.py; "
                    "--procs runs the cluster drill instead")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--scheme", default="inl",
                    choices=["standard", "inl"])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--scan-steps", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--kill-after-step", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default="chaos_workdir")
    ap.add_argument("--learned-prior", action="store_true",
                    help="inl scheme: train with learned priors")
    ap.add_argument("--device", default="cuda",
                    help="the training runs' device: cuda or cpu")
    ap.add_argument("--procs", action="store_true",
                    help="run the multi-process cluster drill (real worker "
                         "SIGKILL/SIGSTOP under a scripted schedule) "
                         "instead of the training crash-resume check")
    args = ap.parse_args(argv)
    if args.procs:
        record = cluster_drill(args)
        print(json.dumps({"cluster_drill": record}, indent=2))
        return record
    record = crash_resume_check(args)
    print(json.dumps({"crash_resume": record}, indent=2))
    return record


if __name__ == "__main__":
    main()
