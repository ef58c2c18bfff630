"""Wire a Supervisor's worker processes under a NetworkTransport.

Reference: src/repro/cluster/transport.py.

`cluster_transport` is the whole trick: edges sourced at supervised nodes
get `WorkerChannel`s, the supervisor's `tick` becomes the transport's
`on_tick` hook (supervision advances at the top of every round/request,
deterministically in tick time), and its membership view backs the
`node_down` mask hook.  Everything else — retries, breakers, chaos draws,
both ledgers, `run_scheme(..., transport=)`, the serving engine — is the
unchanged transport, which is why a fault-free 3-process run is
bit-identical to the in-process one: the fault draws are pure functions
of (seed, domain, tick, edge, attempt) and never see the channel kind.

`Cluster` bundles the common case as a context manager:

    with Cluster(cfg, topology=star, seed=0, chaos=sched) as cl:
        curve = run_scheme("inl", views, labels, cfg,
                           epochs=2, transport=cl.transport)
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.cluster.supervisor import Supervisor
from repro_torch.core import topology as topology_lib
from repro_torch.transport.network import NetworkTransport
from repro_torch.transport.policy import DEFAULT_RETRY, RetryPolicy


def cluster_transport(supervisor: Supervisor, topo, cfg, *, seed: int = 0,
                      policy: RetryPolicy = DEFAULT_RETRY,
                      breaker="default", chaos=None, adaptive=None,
                      meter=None) -> NetworkTransport:
    """A NetworkTransport whose supervised edges cross process boundaries.

    Pass the SAME ChaosSchedule to the supervisor and here: the supervisor
    realises node windows with real signals, the transport consults them
    for deterministic masks — one schedule, two enforcement points."""
    topo = topology_lib.resolve(topo, cfg)
    return NetworkTransport(
        topo, cfg, seed=seed, policy=policy, breaker=breaker, chaos=chaos,
        channels=supervisor.edge_channels(topo), meter=meter,
        adaptive=adaptive, on_tick=supervisor.tick,
        node_down=supervisor.is_down)


class Cluster:
    """Supervisor + transport over a topology's measure nodes, as one
    context manager (workers spawn on __enter__, die on __exit__)."""

    def __init__(self, cfg, topology=None, *, seed: int = 0, chaos=None,
                 policy: RetryPolicy = DEFAULT_RETRY, breaker="default",
                 adaptive=None, meter=None, nodes: Optional[Sequence[str]] = None,
                 **supervisor_kwargs):
        self.topo = topology_lib.resolve(topology, cfg)
        self.cfg = cfg
        self.seed = seed
        self.chaos = chaos
        self._policy = policy
        self._breaker = breaker
        self._adaptive = adaptive
        self._meter = meter
        self.supervisor = Supervisor(
            list(nodes) if nodes is not None else self.topo.view_nodes(),
            seed=seed, chaos=chaos, **supervisor_kwargs)
        self.transport: Optional[NetworkTransport] = None

    def __enter__(self) -> "Cluster":
        self.supervisor.start()
        self.transport = cluster_transport(
            self.supervisor, self.topo, self.cfg, seed=self.seed,
            policy=self._policy, breaker=self._breaker, chaos=self.chaos,
            adaptive=self._adaptive, meter=self._meter)
        return self

    def __exit__(self, *exc) -> None:
        if self.transport is not None:
            self.transport.close()
            self.transport = None
        self.supervisor.stop()
