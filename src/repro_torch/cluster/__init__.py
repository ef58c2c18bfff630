"""Multi-process worker plane: supervised measure-node processes.

Reference: src/repro/cluster/__init__.py.

`repro_torch/cluster` turns the transport's fault model from simulation into a
system: every measure node of a topology becomes a REAL OS process (a
`worker` serving the echo/heartbeat protocol over the TCP `SocketChannel`
mode), a `Supervisor` spawns/monitors/restarts them and publishes a
membership view, and `cluster_transport`/`Cluster` wire the worker
channels under an unchanged `NetworkTransport` — so a SIGKILL'd worker
costs INL exactly the votes it owned until the supervisor restores it.

Exports resolve lazily (PEP 562): `python -m repro_torch.cluster.worker` must
NOT import the supervisor side (which pulls the core ledgers -> torch) —
the worker itself needs only the channel layer.
"""
import importlib

_EXPORTS = {
    "OP_PING": "proto", "OP_PONG": "proto", "OP_ECHO": "proto",
    "OP_ECHO_REPLY": "proto", "OP_EXIT": "proto",
    "pack_msg": "proto", "unpack_msg": "proto",
    "UP": "membership", "SUSPECT": "membership", "DOWN": "membership",
    "HeartbeatMonitor": "membership", "MembershipView": "membership",
    "NodeHealth": "membership",
    "Supervisor": "supervisor", "WorkerChannel": "supervisor",
    "WorkerHandle": "supervisor",
    "Cluster": "transport", "cluster_transport": "transport",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
