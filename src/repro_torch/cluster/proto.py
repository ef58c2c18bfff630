"""The supervisor<->worker message protocol, layered inside the channel
layer's length-prefixed frames: a 1-byte opcode, an 8-byte request tag,
and the payload.

Reference: src/repro/cluster/proto.py.

Tags let the supervisor discard STALE replies: a worker thawed after a
SIGSTOP flushes the echoes/pongs it owed from ticks that have already been
written off, and the tag mismatch identifies them as history rather than
answers to the current request.

Standard library only — this module is imported by spawned worker
processes, which must stay light (no torch, no repro_torch.core)."""
from __future__ import annotations

import struct
from typing import Tuple

OP_PING = 1        # liveness probe              -> OP_PONG, same tag
OP_PONG = 2
OP_ECHO = 3        # payload round-trip          -> OP_ECHO_REPLY, same tag
OP_ECHO_REPLY = 4
OP_EXIT = 5        # graceful shutdown (no reply)

_MSG = struct.Struct("<Bq")


def pack_msg(op: int, tag: int, payload: bytes = b"") -> bytes:
    return _MSG.pack(op, tag) + payload


def unpack_msg(frame: bytes) -> Tuple[int, int, bytes]:
    if len(frame) < _MSG.size:
        raise ValueError(f"short cluster message ({len(frame)} bytes)")
    op, tag = _MSG.unpack_from(frame, 0)
    return op, tag, frame[_MSG.size:]
