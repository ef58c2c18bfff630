"""Edge channels: the byte-moving layer under the fault-tolerant transport.

Reference: src/repro/transport/channel.py.

One `Channel` per topology edge.  The interface is deliberately minimal —
length-prefixed frames in submission order — because everything clever
(retries, backoff, breakers, fault injection, routing) lives ABOVE it in
`transport/network.py`.  Implementations sharing it:

    LoopbackChannel   an in-process deque — the fast path the serving
                      engine uses by default (same process, no
                      serialisation cost beyond the frame encode).

    SocketChannel     a REAL socket, framed with a 4-byte length prefix.
                      Two modes: `SocketChannel()` wraps a
                      `socket.socketpair()` (AF_UNIX kernel buffers, both
                      ends in-process), while `TcpListener.accept()` /
                      `SocketChannel.connect()` put the two ends in
                      DIFFERENT processes over TCP with a versioned
                      handshake — the mode `repro_torch/cluster` uses to talk
                      to
                      supervised worker processes.

Failure semantics are typed and deliberately narrow:

    * a peer closing cleanly at a frame boundary -> `recv` returns None;
    * a peer vanishing mid-frame (short read of the 4-byte length prefix
      or of the body) -> `ChannelError` — never silent partial bytes;
    * handshake problems (bad magic, protocol version mismatch, wrong
      peer) -> `HandshakeError`;
    * `close()` is idempotent and thread-safe against concurrent
      send/recv — a blocked `recv` returns None, a subsequent `send`
      raises `ChannelError`.

Frames carry view fragments: `(request id, view index, ndarray)` encoded
with a fixed header (`encode_fragment`/`decode_fragment`), so a fragment
that crossed a socket reconstructs bit-identically on the far side.
"""
from __future__ import annotations

import collections
import socket
import struct
import threading
import time
from typing import Optional, Tuple

import numpy as np

# frame header: magic, request id, view index, dtype tag length, ndim
_MAGIC = 0x494E4C46                     # "INLF"
_HEAD = struct.Struct("<IqiBB")
_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 28                    # 256 MB sanity bound

# connection handshake: magic, protocol version, peer-name length
PROTOCOL_VERSION = 1
_HELLO_MAGIC = 0x494E4C48               # "INLH"
_HELLO = struct.Struct("<IHH")
_MAX_HELLO = 4096


class ChannelError(RuntimeError):
    """A channel failed in a way the transport should treat as a lost
    transmission: torn frame, abrupt peer close, send on a closed pipe."""


class HandshakeError(ChannelError):
    """Connection setup failed.  `fatal=True` marks mismatches reconnecting
    cannot fix (wrong protocol version, wrong peer identity)."""

    def __init__(self, msg: str, *, fatal: bool = False):
        super().__init__(msg)
        self.fatal = fatal


def encode_fragment(rid: int, view_index: int, arr: np.ndarray) -> bytes:
    """One view fragment as a self-describing byte frame."""
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype.str.encode("ascii")
    head = _HEAD.pack(_MAGIC, rid, view_index, len(dt), arr.ndim)
    dims = struct.pack(f"<{arr.ndim}q", *arr.shape)
    return head + dt + dims + arr.tobytes()


def decode_fragment(frame: bytes) -> Tuple[int, int, np.ndarray]:
    """Inverse of `encode_fragment`; bit-exact round trip."""
    magic, rid, j, dtlen, ndim = _HEAD.unpack_from(frame, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad fragment frame (magic {magic:#x})")
    off = _HEAD.size
    dt = np.dtype(frame[off:off + dtlen].decode("ascii"))
    off += dtlen
    shape = struct.unpack_from(f"<{ndim}q", frame, off)
    off += 8 * ndim
    count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
    arr = np.frombuffer(frame, dtype=dt, count=count,
                        offset=off).reshape(shape)
    return rid, j, arr.copy()


class Channel:
    """One directed edge's byte pipe: ordered, length-prefixed frames."""

    kind = "abstract"
    eof = False          # True once the peer closed cleanly (recv -> None
                         # then means "gone", not "nothing yet")

    def send(self, frame: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Next frame, or None when nothing arrives within `timeout`
        seconds (None blocks; 0 polls)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class LoopbackChannel(Channel):
    """In-process channel: a bounded deque behind a condition variable."""

    kind = "loopback"

    def __init__(self):
        self._frames = collections.deque()
        self._cond = threading.Condition()
        self._closed = False

    def send(self, frame: bytes) -> None:
        with self._cond:
            if self._closed:
                raise ChannelError("send on closed loopback channel")
            self._frames.append(bytes(frame))
            self._cond.notify()

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        with self._cond:
            if not self._frames and not self._closed:
                self._cond.wait(timeout)
            return self._frames.popleft() if self._frames else None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def _pack_hello(name: str) -> bytes:
    nb = name.encode("utf-8")
    body = _HELLO.pack(_HELLO_MAGIC, PROTOCOL_VERSION, len(nb)) + nb
    return _LEN.pack(len(body)) + body


def _sock_read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (socket.timeout, TimeoutError) as e:
            raise HandshakeError("timed out waiting for hello") from e
        except OSError as e:
            raise HandshakeError(f"socket error during handshake: {e}") from e
        if not chunk:
            raise HandshakeError("peer closed during handshake")
        buf.extend(chunk)
    return bytes(buf)


def _read_hello(sock: socket.socket) -> str:
    (n,) = _LEN.unpack(_sock_read_exact(sock, _LEN.size))
    if n > _MAX_HELLO:
        raise HandshakeError(f"oversized hello ({n} bytes)", fatal=True)
    payload = _sock_read_exact(sock, n)
    if len(payload) < _HELLO.size:
        raise HandshakeError("short hello", fatal=True)
    magic, version, nlen = _HELLO.unpack_from(payload, 0)
    if magic != _HELLO_MAGIC:
        raise HandshakeError(f"bad hello magic {magic:#x}", fatal=True)
    if version != PROTOCOL_VERSION:
        raise HandshakeError(
            f"protocol version mismatch: peer speaks v{version}, "
            f"this build speaks v{PROTOCOL_VERSION}", fatal=True)
    return payload[_HELLO.size:_HELLO.size + nlen].decode("utf-8")


class SocketChannel(Channel):
    """A real kernel-buffered byte pipe framed with a 4-byte length prefix.

    `SocketChannel()` wraps a `socket.socketpair()` (both ends in this
    process); `SocketChannel.connect()` / `TcpListener.accept()` wrap one
    end of a TCP connection whose peer lives in another process.  send()
    may block briefly when the kernel buffer fills; recv() honours
    `timeout` via the socket timeout.  A timed-out recv never loses bytes:
    a partial length prefix stays buffered for the next call."""

    kind = "socket"

    def __init__(self, sock: Optional[socket.socket] = None, *, peer: str = ""):
        if sock is None:
            self._tx, self._rx = socket.socketpair()
        else:
            self._tx = self._rx = sock
        self.peer = peer
        self._tx_lock = threading.Lock()
        self._rx_lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._head_buf = bytearray()
        self._closed = False

    # -- connection setup ---------------------------------------------------

    @classmethod
    def connect(cls, host: str, port: int, *, name: str = "client",
                expect_peer: Optional[str] = None, timeout: float = 5.0,
                attempts: int = 5, backoff_s: float = 0.05,
                backoff_cap_s: float = 1.0) -> "SocketChannel":
        """Dial a `TcpListener` with a bounded reconnect loop (capped
        exponential backoff).  Fatal handshake mismatches (wrong protocol
        version, wrong peer) raise immediately; refused/reset connections
        retry up to `attempts` times before raising `ChannelError`."""
        last: Optional[BaseException] = None
        for i in range(max(1, attempts)):
            if i:
                time.sleep(min(backoff_s * (2 ** (i - 1)), backoff_cap_s))
            try:
                sock = socket.create_connection((host, port), timeout=timeout)
            except OSError as e:
                last = e
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(timeout)
            try:
                sock.sendall(_pack_hello(name))
                peer = _read_hello(sock)
            except HandshakeError as e:
                sock.close()
                if e.fatal:
                    raise
                last = e
                continue
            except OSError as e:
                sock.close()
                last = e
                continue
            if expect_peer is not None and peer != expect_peer:
                sock.close()
                raise HandshakeError(
                    f"connected to {peer!r}, expected {expect_peer!r}",
                    fatal=True)
            sock.settimeout(None)
            return cls(sock=sock, peer=peer)
        raise ChannelError(
            f"could not connect to {host}:{port} after {max(1, attempts)} "
            f"attempts: {last}") from last

    # -- framing ------------------------------------------------------------

    def send(self, frame: bytes) -> None:
        if len(frame) > _MAX_FRAME:
            raise ValueError(f"frame of {len(frame)} bytes exceeds the "
                             f"{_MAX_FRAME} byte channel bound")
        with self._tx_lock:
            if self._closed:
                raise ChannelError("send on closed socket channel")
            try:
                self._tx.sendall(_LEN.pack(len(frame)) + frame)
            except OSError as e:
                if self._closed:
                    raise ChannelError("send on closed socket channel") from e
                raise ChannelError(f"send failed: {e}") from e

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        with self._rx_lock:
            if self._closed:
                return None
            # 1) the 4-byte length prefix.  A timeout mid-prefix keeps the
            #    partial bytes buffered; an EOF mid-prefix is a torn frame.
            buf = self._head_buf
            try:
                self._rx.settimeout(timeout)
            except OSError:
                return None                      # closed under us
            while len(buf) < _LEN.size:
                try:
                    chunk = self._rx.recv(_LEN.size - len(buf))
                except (socket.timeout, TimeoutError):
                    return None
                except OSError as e:
                    if self._closed:
                        return None
                    raise ChannelError(
                        f"socket error while reading frame header: {e}") from e
                if not chunk:
                    if buf:
                        raise ChannelError(
                            f"peer closed mid-header "
                            f"({len(buf)}/{_LEN.size} bytes)")
                    self.eof = True
                    return None                  # clean EOF at a boundary
                buf.extend(chunk)
            (n,) = _LEN.unpack(bytes(buf))
            buf.clear()
            if n > _MAX_FRAME:
                raise ChannelError(f"frame of {n} bytes exceeds the "
                                   f"{_MAX_FRAME} byte channel bound")
            # 2) the body: the prefix arrived, so the body is in flight —
            #    wait for all of it; a short read here is a torn frame.
            self._rx.settimeout(None)
            body = bytearray()
            while len(body) < n:
                try:
                    chunk = self._rx.recv(n - len(body))
                except OSError as e:
                    if self._closed:
                        return None
                    raise ChannelError(
                        f"socket error while reading frame body: {e}") from e
                if not chunk:
                    raise ChannelError(
                        f"peer closed mid-frame ({len(body)}/{n} bytes)")
                body.extend(chunk)
            return bytes(body)

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        for s in {self._tx, self._rx}:
            try:
                s.shutdown(socket.SHUT_RDWR)     # unblock concurrent recv
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class TcpListener:
    """Server side of the TCP channel mode: bind, accept, handshake.

    `accept()` validates the client hello (magic + protocol version),
    replies with this listener's name, and returns a connected
    `SocketChannel` whose `.peer` is the client's announced name — or None
    on accept timeout."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 name: str = "listener", backlog: int = 8):
        self.name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._close_lock = threading.Lock()

    def accept(self, timeout: Optional[float] = None,
               *, handshake_timeout: float = 5.0) -> Optional[SocketChannel]:
        try:
            self._sock.settimeout(timeout)
            conn, _ = self._sock.accept()
        except (socket.timeout, TimeoutError):
            return None
        except OSError:
            if self._closed:
                return None
            raise
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(handshake_timeout)
        try:
            peer = _read_hello(conn)
            conn.sendall(_pack_hello(self.name))
        except (HandshakeError, OSError):
            conn.close()
            raise
        conn.settimeout(None)
        return SocketChannel(sock=conn, peer=peer)

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


CHANNEL_KINDS = ("loopback", "socket")


def make_channel(kind: str = "loopback") -> Channel:
    """Factory the NetworkTransport uses per edge."""
    if kind == "loopback":
        return LoopbackChannel()
    if kind == "socket":
        return SocketChannel()
    raise ValueError(f"unknown channel kind {kind!r}; one of {CHANNEL_KINDS}")
