"""Fault-tolerant edge transport: channels, retry/breaker policies, adaptive
retuning, and the per-topology `NetworkTransport` that turns
`linkfault.LinkModel` parameters into actual transport outcomes (delivered /
late / lost payloads) for the serving engine and the training round paths.

Reference: src/repro/transport/__init__.py.

Exports resolve lazily (PEP 562): `repro_torch.cluster.worker` processes
import `repro_torch.transport.channel` through this package, and pulling
`network` eagerly would drag torch into every spawned worker — the channel
layer itself needs only numpy and the standard library.
"""
import importlib

_EXPORTS = {
    # channel layer (numpy + stdlib only — worker processes import these)
    "CHANNEL_KINDS": "channel", "Channel": "channel",
    "ChannelError": "channel", "HandshakeError": "channel",
    "LoopbackChannel": "channel", "SocketChannel": "channel",
    "TcpListener": "channel", "PROTOCOL_VERSION": "channel",
    "decode_fragment": "channel", "encode_fragment": "channel",
    "make_channel": "channel",
    # transport proper (imports the core ledgers -> torch)
    "DOMAIN_REQUEST": "network", "DOMAIN_ROUND": "network",
    "EdgeResult": "network", "EdgeTransport": "network",
    "NetworkTransport": "network", "RequestReport": "network",
    "RoundReport": "network",
    # policies
    "DEFAULT_RETRY": "policy", "NO_RETRY": "policy",
    "CircuitBreaker": "policy", "NoBreaker": "policy",
    "RetryPolicy": "policy",
    "AdaptiveConfig": "adaptive", "AdaptivePolicy": "adaptive",
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
