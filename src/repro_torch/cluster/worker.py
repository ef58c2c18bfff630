"""The measure-node worker process: `python -m repro_torch.cluster.worker`.

Reference: src/repro/cluster/worker.py.

A worker owns its node's end of the byte transport and its own liveness —
nothing else.  The fusion math stays in the supervisor's process
(it is the fusion CENTER; the paper's measure nodes ship bytes, they do
not hold the decoder), so what a SIGKILL here costs the system is exactly
what the paper says a lost node costs: the votes this node's uplink
owned, until the supervisor restores it.

Protocol: bind an ephemeral TCP port, print one JSON registration line
(`{"node", "host", "port", "pid"}`) on stdout for the supervisor to read,
then serve the echo/heartbeat protocol (`cluster/proto.py`) over the
versioned-handshake `SocketChannel` until told to exit.  The worker
re-enters accept() after a disconnect, so a supervisor that lost its
connection (or a restarted supervisor) can re-dial the same incarnation.

Deliberately light: standard library + numpy via the channel layer — no
torch, no jax, no repro_torch.core (the package's `__init__` resolves its
exports lazily) — so a restart costs process-spawn time, not a torch
import.  The worker also watches its parent pid and exits when orphaned,
so a SIGKILL'd supervisor never leaks worker processes.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from repro_torch.cluster import proto
from repro_torch.transport.channel import (ChannelError, HandshakeError,
                                           TcpListener)

_ACCEPT_SLICE_S = 0.5       # granularity of the orphan-watch poll


def _orphaned(parent: int) -> bool:
    return os.getppid() != parent


def _serve(chan, parent: int) -> None:
    """Answer one supervisor connection until it closes or we are told
    to exit.  Stale requests queued while the process was SIGSTOPped are
    answered too — the supervisor's tag matching writes them off."""
    try:
        while True:
            try:
                frame = chan.recv(timeout=_ACCEPT_SLICE_S)
            except ChannelError:
                return                       # torn frame / reset: re-accept
            if frame is None:
                if chan.eof or _orphaned(parent):
                    return
                continue                     # idle slice
            op, tag, payload = proto.unpack_msg(frame)
            if op == proto.OP_PING:
                chan.send(proto.pack_msg(proto.OP_PONG, tag))
            elif op == proto.OP_ECHO:
                chan.send(proto.pack_msg(proto.OP_ECHO_REPLY, tag, payload))
            elif op == proto.OP_EXIT:
                raise SystemExit(0)
    finally:
        chan.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="supervised measure-node worker (see repro_torch/cluster)")
    p.add_argument("--node", required=True, help="topology node name")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (default: ephemeral)")
    args = p.parse_args(argv)

    parent = os.getppid()
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    listener = TcpListener(args.host, args.port, name=args.node)
    print(json.dumps({"node": args.node, "host": listener.host,
                      "port": listener.port, "pid": os.getpid()}),
          flush=True)
    try:
        while not _orphaned(parent):
            try:
                chan = listener.accept(timeout=_ACCEPT_SLICE_S)
            except (HandshakeError, OSError):
                continue                     # a bad client is not our death
            if chan is not None:
                _serve(chan, parent)
    finally:
        listener.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
