"""Minimal RFC 6455 WebSocket — the streaming leg of the gateway, in
the same zero-dependency stdlib style as the ``ThreadingHTTPServer``
scrape surface (``serve/httpd.py``).  A copy of
``distributed_gol_tpu/serve/ws.py``: the port imports nothing of the JAX
package, so it keeps its own.

Scope: exactly what a pod's controller/spectator legs need —
server-side upgrade inside a ``BaseHTTPRequestHandler``, client-side
connect over a raw socket, text/binary messages, fragmented-message
assembly, auto-ponged pings, masked client frames (the RFC mandate),
bounded frame sizes, and a clean close handshake.  No extensions, no
subprotocol negotiation, no compression — a spectator stream's payload
is already delta-encoded (``engine/frames.py``).

Both ends of ``tools/gol_client.py`` ⇄ ``serve/gateway.py`` speak this
one codec, so the wire format cannot drift between them.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading

#: RFC 6455 §1.3 handshake GUID.
GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

#: Frames over this are refused (a spectator keyframe of a 65536²
#: pooled viewport is far below it; anything bigger is a protocol bug).
MAX_PAYLOAD = 1 << 26


class WsClosed(ConnectionError):
    """The peer closed (or the socket died) — the detach signal."""


class WsTimeout(WsClosed):
    """The peer stopped SENDING without closing (recv deadline or
    keepalive budget exhausted) — a half-open connection.  Subclasses
    :class:`WsClosed` so every existing detach path already handles it;
    catch it first to count/react to stalls specifically."""


def accept_key(key: str) -> str:
    """RFC 6455 §4.2.2: the Sec-WebSocket-Accept for a client key."""
    digest = hashlib.sha1((key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _mask(data, key) -> "bytes | bytearray":
    """XOR-mask ``data`` with the 4-byte ``key`` (involutive).  A
    ``bytearray`` is masked IN PLACE and returned — the receive path
    unmasks each payload inside the buffer it was read into, so a
    frame costs one allocation, not one per mask pass."""
    n = len(data)
    if not n:
        return data
    rep = (bytes(key) * (n // 4 + 1))[:n]
    word = int.from_bytes(data, "little") ^ int.from_bytes(rep, "little")
    if isinstance(data, bytearray):
        data[:] = word.to_bytes(n, "little")
        return data
    return word.to_bytes(n, "little")


def _frame_head(opcode: int, n: int, mask_bit: int) -> bytearray:
    """The frame header for an ``n``-byte payload (no mask key)."""
    head = bytearray([0x80 | opcode])
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    return head


def encode_server_frame(opcode: int, payload) -> bytes:
    """One complete UNMASKED (server→client) frame: header + payload in
    a single buffer.  The relay's single-serialize/multi-write seam —
    encode the frame ONCE, then :meth:`WebSocket.send_raw` the same
    ``memoryview`` into every downstream socket.  Byte-identical to
    what ``_send`` puts on the wire from a server endpoint."""
    n = len(payload)
    if n > MAX_PAYLOAD:
        raise ValueError(f"payload of {n} bytes exceeds MAX_PAYLOAD")
    head = _frame_head(opcode, n, 0)
    head += payload
    return bytes(head)


class WebSocket:
    """One connected endpoint over buffered binary file objects
    (``rfile``/``wfile`` of an HTTP handler, or ``socket.makefile``
    pairs on the client).  ``send_*`` are thread-safe (one lock — the
    gateway's reader thread pongs while the pump thread streams);
    ``recv`` is single-consumer."""

    def __init__(
        self, rfile, wfile, *, mask: bool, sock=None,
        max_payload: int = MAX_PAYLOAD,
    ):
        self._r = rfile
        self._w = wfile
        self._mask_frames = mask
        self._sock = sock
        self._send_lock = threading.Lock()
        self._close_sent = False
        self.closed = False
        #: Inbound frame-size cap (outbound keeps the module constant —
        #: what WE send is already bounded by construction).
        self.max_payload = max_payload
        #: Keepalive state (:meth:`enable_keepalive`): 0 = off.
        self._keepalive_seconds = 0.0
        self._keepalive_misses = 3
        self._keepalive_budget = 0
        self._mid_frame = False

    # -- send ------------------------------------------------------------------
    def send_text(self, text: str) -> int:
        return self._send(OP_TEXT, text.encode())

    def send_binary(self, payload) -> int:
        return self._send(OP_BINARY, payload)

    def ping(self, payload: bytes = b"") -> None:
        self._send(OP_PING, payload)

    def send_raw(self, frame) -> int:
        """Write a pre-encoded frame (:func:`encode_server_frame`)
        verbatim — the multi-write half of the relay's
        single-serialize/multi-write fan-out.  Only legal on an
        unmasked (server) endpoint: a masked one needs a fresh key —
        and a fresh serialization — per frame."""
        if self._mask_frames:
            raise ValueError("send_raw requires an unmasked (server) "
                             "endpoint")
        with self._send_lock:
            if self.closed:
                raise WsClosed("websocket is closed")
            try:
                self._w.write(frame)
                self._w.flush()
            except (OSError, ValueError) as e:
                self.closed = True
                raise WsClosed(f"send failed: {e}") from e
        return len(frame)

    def _send(self, opcode: int, payload) -> int:
        n = len(payload)
        if n > MAX_PAYLOAD:
            raise ValueError(f"payload of {n} bytes exceeds MAX_PAYLOAD")
        head = _frame_head(opcode, n, 0x80 if self._mask_frames else 0)
        if self._mask_frames:
            key = os.urandom(4)
            head += key
            # Mask a COPY (bytes in, bytes out): the caller's buffer is
            # not ours to scramble, even involutively.
            payload = _mask(bytes(payload), key)
        with self._send_lock:
            if self.closed:
                raise WsClosed("websocket is closed")
            try:
                # Two buffered writes, one flush: no header+payload
                # concatenation copy on the hot path.
                self._w.write(head)
                if n:
                    self._w.write(payload)
                self._w.flush()
            except (OSError, ValueError) as e:
                self.closed = True
                raise WsClosed(f"send failed: {e}") from e
        return n

    # -- receive ---------------------------------------------------------------
    def enable_keepalive(self, seconds: float, misses: int = 3) -> None:
        """Arm recv-deadline keepalive: :meth:`recv` blocks at most
        ``seconds`` per read; a timeout at a frame BOUNDARY sends a
        ping and keeps waiting, and after ``misses`` consecutive
        silent intervals (no frame of any kind — a live peer's auto-
        pong answers well inside one) raises :class:`WsTimeout` — the
        stalled-not-closed peer detected within ``seconds * misses``.
        A timeout MID-frame raises immediately (a peer that died
        between a header and its payload is not coming back).  The
        socket timeout also bounds sends, so a peer that stops READING
        cannot park a sender forever either."""
        if seconds <= 0:
            raise ValueError("keepalive seconds must be positive")
        if misses < 1:
            raise ValueError("keepalive misses must be >= 1")
        self._keepalive_seconds = seconds
        self._keepalive_misses = misses
        self._keepalive_budget = misses
        self.settimeout(seconds)

    def disable_keepalive(self) -> None:
        """Suspend the keepalive machinery (an explicit
        ``settimeout`` poll owns the deadline from here); the
        configuration is remembered — :attr:`keepalive` still reports
        it, and :meth:`enable_keepalive` re-arms."""
        self._keepalive_budget = 0

    @property
    def keepalive(self) -> tuple[float, int] | None:
        """The configured ``(seconds, misses)``, or None if keepalive
        was never armed — how a caller that interleaves explicit
        ``settimeout`` polls re-arms the stream's standing policy."""
        if self._keepalive_seconds > 0:
            return (self._keepalive_seconds, self._keepalive_misses)
        return None

    def recv(self) -> tuple[int, bytes]:
        """The next complete MESSAGE as ``(opcode, payload)`` —
        fragments assembled, pings auto-ponged, pongs swallowed.  A
        close frame (or socket EOF) raises :class:`WsClosed` after
        echoing the close handshake; a recv deadline past the
        keepalive budget (:meth:`enable_keepalive`) raises
        :class:`WsTimeout`."""
        opcode, buf = None, b""
        silent = 0
        while True:
            try:
                op, fin, payload = self._read_frame()
            except WsTimeout:
                if not self._keepalive_budget or self._mid_frame:
                    self.closed = True
                    raise
                silent += 1
                if silent >= self._keepalive_budget:
                    self.closed = True
                    raise WsTimeout(
                        f"keepalive timeout: no frame in "
                        f"{silent * self._keepalive_seconds:g}s"
                    ) from None
                try:
                    self.ping()
                except WsClosed:
                    raise WsTimeout("keepalive ping failed") from None
                continue
            silent = 0
            if op == OP_PING:
                try:
                    self._send(OP_PONG, payload)
                except WsClosed:
                    pass
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                self.close()
                raise WsClosed("peer closed")
            if op in (OP_TEXT, OP_BINARY):
                opcode, buf = op, payload
            elif op == OP_CONT and opcode is not None:
                buf += payload
            else:
                raise WsClosed(f"protocol error: unexpected opcode {op:#x}")
            if fin:
                return opcode, buf

    def _read_frame(self) -> tuple[int, bool, bytes]:
        self._mid_frame = False
        head = self._read_exact(2)
        self._mid_frame = True  # header started: a stall now is fatal
        try:
            fin = bool(head[0] & 0x80)
            op = head[0] & 0x0F
            if head[0] & 0x70:
                # RSV bits without a negotiated extension (we negotiate
                # none) are a protocol error, not garbage to forward.
                raise WsClosed(
                    f"protocol error: reserved bits set ({head[0]:#04x})"
                )
            masked = bool(head[1] & 0x80)
            n = head[1] & 0x7F
            if op >= OP_CLOSE and (not fin or n > 125):
                # RFC 6455 §5.5: control frames must be unfragmented
                # with payloads <= 125 bytes.
                raise WsClosed(
                    f"protocol error: fragmented/oversized control "
                    f"frame ({op:#x})"
                )
            if n == 126:
                n = struct.unpack(">H", self._read_exact(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", self._read_exact(8))[0]
            if n > self.max_payload:
                raise WsClosed(
                    f"frame of {n} bytes exceeds the {self.max_payload}"
                    f"-byte cap"
                )
            key = self._read_exact(4) if masked else None
            payload = self._read_exact(n)
            if key is not None:
                payload = _mask(payload, key)  # in place: payload is ours
            return op, fin, payload
        finally:
            self._mid_frame = False

    def _read_exact(self, n: int) -> bytearray:
        """Read exactly ``n`` bytes into ONE preallocated buffer
        (``readinto`` over a memoryview) — the unmask pass then runs in
        place, so a received frame costs a single payload-sized
        allocation end to end.  A socket deadline expiring raises
        :class:`WsTimeout` WITHOUT poisoning the endpoint (the
        keepalive path resumes reading); any other failure closes."""
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        while got < n:
            try:
                k = self._r.readinto(view[got:])
            except TimeoutError as e:
                if got:
                    # A torn read: bytes arrived, then silence — the
                    # peer died mid-frame; keepalive must not resume
                    # into a misaligned stream.
                    self._mid_frame = True
                # CPython's SocketIO poisons itself after one timeout
                # (every later read raises "cannot read from timed out
                # object") — clear the flag so the keepalive path can
                # actually resume reading after its ping.
                raw = getattr(self._r, "raw", None)
                if getattr(raw, "_timeout_occurred", False):
                    raw._timeout_occurred = False
                raise WsTimeout(f"read deadline expired: {e}") from e
            except (OSError, ValueError) as e:
                self.closed = True
                raise WsClosed(f"read failed: {e}") from e
            if not k:
                self.closed = True
                raise WsClosed("socket EOF")
            got += k
        return out

    # -- lifecycle -------------------------------------------------------------
    def settimeout(self, seconds: float | None) -> None:
        if self._sock is not None:
            self._sock.settimeout(seconds)

    def abort(self) -> None:
        """Hard-close the underlying socket, no close handshake — the
        only way another thread can unblock a reader parked in
        :meth:`recv` (the relay's teardown, and how the chaos suite
        kills an upstream mid-stream).  Idempotent."""
        self.closed = True
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass

    def close(self, code: int = 1000) -> None:
        """Send the close frame (once) and mark the endpoint closed.
        Idempotent; safe from any thread."""
        with self._send_lock:
            if self._close_sent:
                self.closed = True
                return
            self._close_sent = True
            try:
                payload = struct.pack(">H", code)
                head = bytearray([0x80 | OP_CLOSE])
                if self._mask_frames:
                    key = os.urandom(4)
                    head += bytes([0x80 | len(payload)]) + key
                    payload = _mask(payload, key)
                else:
                    head.append(len(payload))
                self._w.write(bytes(head) + payload)
                self._w.flush()
            except (OSError, ValueError):
                pass
            self.closed = True


# -- server side ---------------------------------------------------------------

def server_upgrade(request, max_payload: int = MAX_PAYLOAD) -> WebSocket | None:
    """Upgrade a live ``BaseHTTPRequestHandler`` request to a WebSocket
    (RFC 6455 §4.2).  Returns the server-side endpoint, or None after
    answering 400 when the request is not a well-formed upgrade.  The
    caller owns the connection from here on and must not send a normal
    HTTP response."""
    upgrade = (request.headers.get("Upgrade") or "").lower()
    key = request.headers.get("Sec-WebSocket-Key")
    if upgrade != "websocket" or not key:
        request._send(400, b"websocket upgrade required\n", "text/plain")
        return None
    response = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
        "\r\n"
    )
    request.wfile.write(response.encode())
    request.wfile.flush()
    request.close_connection = True  # the socket is ours until EOF
    # The HTTP layer's read deadline / slow-loris reaper stops at the
    # upgrade boundary: a WebSocket leg owns its own deadline/keepalive
    # policy (enable_keepalive / settimeout) from here on.
    disarm = getattr(request.rfile, "disarm", None)
    if disarm is not None:
        disarm()
    try:
        request.connection.settimeout(None)
    except OSError:
        pass
    return WebSocket(
        request.rfile, request.wfile, mask=False,
        sock=request.connection, max_payload=max_payload,
    )


# -- client side ---------------------------------------------------------------

def client_connect(
    host: str,
    port: int,
    path: str,
    timeout: float = 30.0,
    recv_buffer: int | None = None,
) -> WebSocket:
    """Dial ``ws://host:port{path}``: TCP connect, upgrade handshake,
    verified accept key.  Client frames are masked per the RFC.
    ``recv_buffer`` pins SO_RCVBUF before connecting (how the chaos
    tests simulate a slow consumer deterministically)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if recv_buffer is not None:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, recv_buffer)
    sock.settimeout(timeout)
    try:
        sock.connect((host, port))
    except BaseException:
        sock.close()
        raise
    key = base64.b64encode(os.urandom(16)).decode()
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n"
        "\r\n"
    )
    rfile = sock.makefile("rb")
    wfile = sock.makefile("wb")
    try:
        wfile.write(req.encode())
        wfile.flush()
        status = rfile.readline(4096).decode("latin-1")
        if " 101 " not in status:
            raise WsClosed(f"upgrade refused: {status.strip()!r}")
        accept = None
        while True:
            line = rfile.readline(4096).decode("latin-1")
            if line in ("\r\n", "\n", ""):
                break
            name, _, value = line.partition(":")
            if name.strip().lower() == "sec-websocket-accept":
                accept = value.strip()
        if accept != accept_key(key):
            raise WsClosed("handshake accept-key mismatch")
    except BaseException:
        sock.close()
        raise
    return WebSocket(rfile, wfile, mask=True, sock=sock)


__all__ = [
    "MAX_PAYLOAD",
    "WebSocket",
    "WsClosed",
    "WsTimeout",
    "accept_key",
    "client_connect",
    "encode_server_frame",
    "server_upgrade",
]
