"""Spectator relay tier — broadcast-tree frame fan-out.

A copy of ``distributed_gol_tpu/serve/relay.py`` on the port's WebSocket
codec, HTTP scaffolding and (for cache compaction only) frame codec.

The FramePlane fans ONE device fetch to N direct
subscribers, and the gateway puts that stream on the wire —
but N is bounded by one pod's sockets and egress.  This module is the
tier that unbounds it: a :class:`RelayServer` is a standalone process
(stdlib + the existing ``serve/ws.py`` codec and ``serve/httpd.py``
scaffolding, never a device) that subscribes ONCE to an upstream
spectator stream — a gateway pod, or ANOTHER relay, so trees chain to
arbitrary depth — and re-fans the frames to M downstream WebSocket
clients.  Depth 2–3 of modest fan-out reaches 10⁶ viewers while the
pod still pays one device fetch and one spectator socket per subtree.

Hot-path contract (the perf_opt):

- **Header-only decode.**  Each upstream binary frame is parsed to its
  length-prefixed JSON header (``type``/``turn``/``rect``) and no
  further — payload bytes are never touched, let alone re-encoded.
- **Single-serialize / multi-write.**  The outgoing WebSocket frame is
  encoded ONCE per upstream message (``ws.encode_server_frame``) and
  the same buffer is written to every downstream socket
  (``WebSocket.send_raw`` over a ``memoryview``) — fan-out cost is M
  writes, not M serializations.
- **Re-keyframe cache.**  The last keyframe plus every delta since
  (bounded at ``cache_deltas``) is retained verbatim; late joiners and
  drop-recovered clients are served from it LOCALLY — zero upstream
  round trips, the pod never learns a viewer joined.  When the delta
  tail would overflow, the cache is *compacted*: the retained frames
  are folded into one synthesized keyframe (the single place the relay
  decodes payload bytes — amortized one band-apply per frame, and one
  keyframe encode per ``cache_deltas`` frames).
- **Stall isolation.**  Per-downstream bounded queues drop OLDEST on
  overflow and flag the client for a cache resync (keyframe + deltas,
  then live) — one stalled viewer never backpressures the tree, same
  contract as the FramePlane it mirrors.
- **Seq-gap resubscribe.**  An upstream disconnect triggers
  capped-exponential-backoff resubscription.  Frames may have been
  missed in the gap, so deltas are REFUSED until the new
  subscription's keyframe arrives (a fresh FramePlane subscriber — or
  a parent relay's cache — always keyframes first); relaying that
  keyframe verbatim is what re-keyframes the whole subtree.  The cache
  keeps serving late joiners across the outage.

Observability (grown for the fleet plane): ``relay.*``
counters plus a ``relay.frame_staleness_seconds`` histogram (frame
age at ingest, from the pod's wall-clock ``ts`` header stamp — blobs
ride verbatim, so the last hop of a depth-N chain measures true
end-to-end staleness) on the relay's own registry; ``/healthz`` (body
carries ``"relay": true`` — what flips ``tools/pod_top.py`` into the
relay view), ``/metrics`` (OpenMetrics) and ``/traces``.  The relay
joins the stream's distributed trace from the upstream hello's
traceparent (``gol.relay.subscribe`` / ``.resubscribe`` /
``.cache_serve`` spans, a ``gol.relay.first_frame`` event) and
re-exports the traceparent downstream, so ``/fleet/traces`` stitches
pod, relay and broker legs on one id.  Downstream endpoint: ``GET
/v1/frames`` (upgrade) —
``/v1/sessions/<anything>/frames`` is an alias, so
``tools/gol_client.py`` spectates a relay with no client-side changes.
"""

from __future__ import annotations

import itertools
import json
import queue
import struct
import threading
import time
from urllib.parse import urlsplit

from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import openmetrics
from distributed_gol_torch.obs import tracing
from distributed_gol_torch.serve import ws as ws_lib
from distributed_gol_torch.serve.httpd import StdlibHTTPServer
from distributed_gol_torch.serve.ws import WsClosed, WsTimeout

#: Default per-downstream queue depth (frames) — the FramePlane default.
DEFAULT_QUEUE_DEPTH = 8

#: Default cached-delta bound before compaction.
DEFAULT_CACHE_DELTAS = 64

#: Resubscribe backoff curve: initial and cap, seconds.
BACKOFF_INITIAL = 0.25
BACKOFF_MAX = 5.0

#: Default upstream keepalive: frames can be arbitrarily
#: sparse (a paused session), so silence alone is not death — but an
#: upstream that answers neither frames NOR pongs inside this bound
#: times 3 misses is a half-open stall, treated exactly like a
#: disconnect (backoff-resubscribe, seq-gap latch re-anchors).
DEFAULT_KEEPALIVE = 20.0


def _parse_frame_header(blob) -> dict:
    """The JSON header of one spectator wire message — the ONLY part of
    an upstream frame the relay hot path decodes (payload bytes ride
    through verbatim)."""
    if len(blob) < 4:
        raise ValueError("frame message shorter than its length prefix")
    (hlen,) = struct.unpack_from(">I", blob)
    if 4 + hlen > len(blob):
        raise ValueError("frame header truncated")
    return json.loads(bytes(blob[4 : 4 + hlen]))


def _wire_blob(frame: bytes) -> bytes:
    """The spectator wire message inside a cached ws frame (strip the
    ws header) — the compaction path's inverse of
    ``ws.encode_server_frame``."""
    n7 = frame[1] & 0x7F
    off = 2 + (2 if n7 == 126 else 8 if n7 == 127 else 0)
    return frame[off:]


class _Downstream:
    """One relayed viewer: a bounded frame queue (drop-oldest) and the
    resync flag its pump services from the cache."""

    def __init__(self, cid: int, depth: int):
        self.id = cid
        self.frames: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self.dropped = False  # overflowed: pump resyncs from the cache


class RelayServer(StdlibHTTPServer):
    """One relay node.  ``upstream`` is a spectator stream URL — a
    gateway leg (``http://pod/v1/sessions/<t>/frames?rect=...``) or
    another relay (``http://relay/v1/frames``).  ``port=0`` binds
    ephemeral and publishes the URL as the ``relay.endpoint`` info
    label on the relay's own registry."""

    thread_name = "gol-relay-http"

    def __init__(
        self,
        upstream: str,
        port: int = 0,
        host: str = "127.0.0.1",
        cache_deltas: int = DEFAULT_CACHE_DELTAS,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        backoff_initial: float = BACKOFF_INITIAL,
        backoff_max: float = BACKOFF_MAX,
        connect_timeout: float = 10.0,
        keepalive_seconds: float = DEFAULT_KEEPALIVE,
        registry=None,
    ):
        self.upstream = upstream
        self._cache_max = max(1, int(cache_deltas))
        self._queue_depth = max(1, int(queue_depth))
        self._backoff_initial = backoff_initial
        self._backoff_max = backoff_max
        self._connect_timeout = connect_timeout
        self._keepalive_seconds = float(keepalive_seconds)

        self._lock = threading.Lock()
        self._clients: dict[int, _Downstream] = {}
        self._ids = itertools.count(1)
        #: The re-keyframe cache: (turn, encoded ws frame) anchor plus
        #: the verbatim delta tail since it.
        self._cache_key: tuple[int, bytes] | None = None
        self._cache_deltas: list[tuple[int, bytes]] = []
        #: Seq-gap latch: True while inbound deltas cannot be assumed
        #: contiguous with the cache (fresh start, post-reconnect) —
        #: they are refused until a keyframe re-anchors the stream.
        self._gap = True
        self._hello: dict = {"type": "hello", "tenant": None, "rect": None}
        #: Set on the FIRST upstream hello — downstream upgrades wait
        #: (bounded) on it so a chain built faster than its hellos
        #: propagate never caches a default (tenant-less) hello at a
        #: lower tier.  Stays set forever after; only the construction
        #: window can stall, and only until the upstream speaks.
        self._hello_seen = threading.Event()
        self._turn = 0
        self._connected = False
        self._ended = threading.Event()
        self._closing = False
        self._upstream_ws = None
        #: The relay's leg of the distributed trace: joined from the
        #: upstream hello's traceparent (same trace id as the gateway's
        #: ``gol.request`` — what ``/fleet/traces`` stitches on) and
        #: re-exported downstream so chained relays join the same trace.
        self._trace: tracing.Trace | None = None
        self._first_frame_pending = False
        self._t_subscribe_ns = tracing.clock_ns()

        reg = registry if registry is not None else metrics_lib.MetricsRegistry()
        self._m_frames_in = reg.counter("relay.frames_in")
        self._m_frames_out = reg.counter("relay.frames_out")
        self._m_bytes_in = reg.counter("relay.bytes_in")
        self._m_bytes_out = reg.counter("relay.bytes_out")
        self._m_drops = reg.counter("relay.drops")
        self._m_cache_serves = reg.counter("relay.cache_serves")
        self._m_resubscribes = reg.counter("relay.resubscribes")
        self._m_keepalive_drops = reg.counter("net.keepalive_drops")
        #: End-to-end frame age at ingest, from the ``ts`` wall-clock
        #: stamp pods put in the frame header — relays forward blobs
        #: verbatim, so a depth-N chain's last hop still measures true
        #: pod-to-here staleness.
        self._m_staleness = reg.histogram("relay.frame_staleness_seconds")
        self._g_clients = reg.gauge("relay.clients")
        self._g_clients.set(0)
        reg.info("relay.upstream", upstream)
        super().__init__(port=port, host=host, registry=reg)
        reg.info("relay.endpoint", self.url)
        self._thread_up = threading.Thread(
            target=self._upstream_loop, name="gol-relay-upstream", daemon=True
        )
        self._thread_up.start()

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        self._closing = True
        u = self._upstream_ws
        if u is not None:
            u.abort()  # unblock the reader parked in recv
        t = self._trace
        if t is not None:
            self._trace = None
            tracing.TRACER.end_trace(t)
        super().close()

    # -- the upstream leg ------------------------------------------------------
    def _connect_upstream(self):
        u = urlsplit(self.upstream)
        path = u.path or "/v1/frames"
        if u.query:
            path += "?" + u.query
        return ws_lib.client_connect(
            u.hostname or "127.0.0.1",
            u.port or 80,
            path,
            timeout=self._connect_timeout,
        )

    def _upstream_loop(self) -> None:
        """Subscribe ONCE; on disconnect, capped-backoff resubscribe.
        Every (re)connection opens the seq-gap latch — the new
        subscription's first keyframe closes it and, relayed verbatim,
        re-keyframes the whole downstream subtree."""
        backoff = self._backoff_initial
        first = True
        while not self._closing and not self._ended.is_set():
            if not first:
                self._m_resubscribes.inc()
                t0 = tracing.clock_ns()
                time.sleep(backoff)
                if self._trace is not None:
                    self._trace.record_span(
                        "gol.relay.resubscribe",
                        t0,
                        tracing.clock_ns(),
                        backoff_seconds=backoff,
                    )
                backoff = min(backoff * 2, self._backoff_max)
            first = False
            self._t_subscribe_ns = tracing.clock_ns()
            try:
                wsock = self._connect_upstream()
            except (OSError, WsClosed, ValueError):
                continue
            self._upstream_ws = wsock
            # Frames can be arbitrarily sparse (a paused session), so
            # silence alone is not death — the keepalive pings through
            # it, and only an upstream that answers neither frames nor
            # pongs (the half-open stall) is dropped, riding the SAME
            # backoff-resubscribe + seq-gap path as a disconnect.
            # keepalive_seconds=0 restores the unbounded blocking read
            # (close()/abort() still unblocks it).
            if self._keepalive_seconds > 0:
                wsock.enable_keepalive(self._keepalive_seconds)
            else:
                wsock.settimeout(None)
            with self._lock:
                self._connected = True
                self._gap = True
            try:
                while not self._closing:
                    op, payload = wsock.recv()
                    if op == ws_lib.OP_TEXT:
                        self._on_text(payload)
                        if self._ended.is_set():
                            break
                        continue
                    self._ingest(payload)
                    backoff = self._backoff_initial
            except WsTimeout:
                # Stalled-not-closed upstream: count it, then recover
                # exactly like a disconnect.
                self._m_keepalive_drops.inc()
            except (WsClosed, OSError, ValueError):
                pass
            finally:
                with self._lock:
                    self._connected = False
                wsock.close()
        self._upstream_ws = None

    def _on_text(self, payload) -> None:
        try:
            msg = json.loads(payload)
        except ValueError:
            return
        kind = msg.get("type")
        if kind == "hello":
            trace = self._join_trace(
                msg.get("traceparent"), msg.get("tenant")
            )
            with self._lock:
                self._hello = {
                    "type": "hello",
                    "tenant": msg.get("tenant"),
                    "rect": msg.get("rect"),
                    "traceparent": (
                        trace.traceparent() if trace is not None
                        else None
                    ),
                }
                self._turn = max(self._turn, int(msg.get("turn") or 0))
            self._hello_seen.set()
        elif kind == "end":
            self._ended.set()
            # Wake every pump NOW (a None sentinel through the normal
            # queue) instead of waiting out its poll timeout — end
            # propagation stays prompt at any tree depth.
            with self._lock:
                for c in self._clients.values():
                    self._offer(c, None)

    def _join_trace(self, traceparent, tenant) -> tracing.Trace | None:
        """Join the stream's distributed trace from the upstream
        hello's traceparent — SAME trace id as the pod's
        ``gol.request`` (the ``/fleet/traces`` stitch key), this
        relay's spans riding as its own process lane.  A resubscribe
        to the same stream records a fresh subscribe span on the
        existing leg; a different stream retires the old leg first.
        An untraced upstream (no traceparent) records nothing."""
        old = self._trace
        parsed = tracing.parse_traceparent(traceparent)
        now = tracing.clock_ns()
        if old is not None:
            if parsed is not None and parsed[0] == old.trace_id:
                old.record_span(
                    "gol.relay.subscribe",
                    self._t_subscribe_ns,
                    now,
                    upstream=self.upstream,
                )
                return old
            self._trace = None
            tracing.TRACER.end_trace(old)
        if parsed is None:
            return None
        trace = tracing.TRACER.start_trace(
            "gol.relay.subscribe", traceparent=traceparent, tenant=tenant
        )
        trace.record_span(
            "gol.relay.subscribe",
            self._t_subscribe_ns,
            now,
            upstream=self.upstream,
        )
        self._trace = trace
        self._first_frame_pending = True
        return trace

    def _ingest(self, blob) -> None:
        """One upstream binary frame: header-only decode, cache update,
        single-serialize, fan-out.  The encoded ws frame is built ONCE;
        every downstream queue gets the same buffer."""
        header = _parse_frame_header(blob)
        kind = header.get("type")
        turn = int(header.get("turn") or 0)
        self._m_frames_in.inc()
        self._m_bytes_in.inc(len(blob))
        ts = header.get("ts")
        if isinstance(ts, (int, float)):
            self._m_staleness.observe(max(0.0, time.time() - ts))
        if self._first_frame_pending and self._trace is not None:
            self._first_frame_pending = False
            self._trace.add_event("gol.relay.first_frame", turn=turn)
        frame = ws_lib.encode_server_frame(ws_lib.OP_BINARY, blob)
        with self._lock:
            if kind == "keyframe":
                self._cache_key = (turn, frame)
                self._cache_deltas.clear()
                self._gap = False
                if header.get("rect") is not None:
                    self._hello["rect"] = header["rect"]
            elif kind == "delta":
                if self._gap or self._cache_key is None:
                    # Seq gap: a delta with no contiguous anchor cannot
                    # apply anywhere downstream — refuse it; the
                    # upstream re-keyframe re-anchors the stream.
                    self._m_drops.inc()
                    return
                self._cache_deltas.append((turn, frame))
                if len(self._cache_deltas) > self._cache_max:
                    self._compact_locked()
            else:
                return  # unknown frame kind: not relayed
            self._turn = turn
            mv = memoryview(frame)
            for c in self._clients.values():
                self._offer(c, mv)

    def _offer(self, c: _Downstream, frame) -> None:
        """Bounded fan-out put: drop OLDEST and flag the client for a
        cache resync — a stalled viewer loses frames, never stalls the
        tree.  Caller holds the relay lock (one producer; the lock is
        what makes cache snapshot + queue contents gap-free)."""
        while True:
            try:
                c.frames.put_nowait(frame)
                return
            except queue.Full:
                c.dropped = True
                self._m_drops.inc()
                try:
                    c.frames.get_nowait()
                except queue.Empty:
                    pass

    def _compact_locked(self) -> None:
        """Fold the cached delta tail into one synthesized keyframe so
        the cache stays bounded while late joiners are ALWAYS served —
        the only place the relay touches payload bytes, amortized one
        band-apply per frame plus one keyframe encode per
        ``cache_deltas`` frames.  Live streams never see the synthetic
        keyframe; it only anchors future cache serves."""
        import numpy as np

        from distributed_gol_torch.engine import frames as frames_lib
        from distributed_gol_torch.engine.events import FrameReady
        from distributed_gol_torch.serve import wire

        key_turn, key_frame = self._cache_key
        ev = wire.decode_frame_event(_wire_blob(key_frame))
        buf = np.array(ev.frame, dtype=np.uint8, copy=True)
        turn, ts = key_turn, ev.ts
        for turn, frame in self._cache_deltas:
            delta = wire.decode_frame_event(_wire_blob(frame))
            frames_lib.apply_bands(buf, delta.bands)
            ts = delta.ts if delta.ts is not None else ts
        blob = wire.encode_frame_event(
            FrameReady(turn, buf, rect=ev.rect, ts=ts)
        )
        self._cache_key = (
            turn, ws_lib.encode_server_frame(ws_lib.OP_BINARY, blob)
        )
        self._cache_deltas.clear()

    def _cache_frames_locked(self) -> list:
        """Keyframe + delta tail, in ship order (caller holds the
        lock) — what a late joiner or a drop-recovered client is
        served.  Empty until the first upstream keyframe lands."""
        if self._cache_key is None:
            return []
        out = [self._cache_key[1]]
        out.extend(frame for _, frame in self._cache_deltas)
        return out

    # -- the downstream leg ----------------------------------------------------
    def handle(self, request, method: str, path: str, query: dict) -> bool:
        if path == "/healthz" and method == "GET":
            health = self.health()
            request._send_json(200 if health["ready"] else 503, health)
            return True
        if path == "/metrics" and method == "GET":
            text = openmetrics.render(self.registry.snapshot().to_dict())
            request._send(200, text.encode(), openmetrics.CONTENT_TYPE)
            return True
        if path == "/traces" and method == "GET":
            code, obj = tracing.http_traces(query)
            request._send_json(code, obj)
            return True
        if method == "GET" and (
            path == "/v1/frames"
            or (path.startswith("/v1/sessions/") and path.endswith("/frames"))
        ):
            return self._downstream_ws(request, query)
        return False

    def health(self) -> dict:
        with self._lock:
            cache = {
                "anchored": self._cache_key is not None,
                "keyframe_turn": (
                    self._cache_key[0] if self._cache_key else None
                ),
                "deltas": len(self._cache_deltas),
            }
            out = {
                "relay": True,
                "ready": self._connected or cache["anchored"],
                "connected": self._connected,
                "ended": self._ended.is_set(),
                "upstream": self.upstream,
                "endpoint": self.url,
                "tenant": self._hello.get("tenant"),
                "rect": self._hello.get("rect"),
                "turn": self._turn,
                "clients": len(self._clients),
                "cache": cache,
            }
        for name, counter in (
            ("frames_in", self._m_frames_in),
            ("frames_out", self._m_frames_out),
            ("bytes_in", self._m_bytes_in),
            ("bytes_out", self._m_bytes_out),
            ("drops", self._m_drops),
            ("cache_serves", self._m_cache_serves),
            ("resubscribes", self._m_resubscribes),
        ):
            out[name] = counter.value
        return out

    def _downstream_ws(self, request, query) -> bool:
        try:
            depth = max(1, int(query.get("queue", self._queue_depth)))
        except ValueError:
            request._send_json(400, {"error": "bad queue depth"})
            return True
        # Liveness over staleness, same as the gateway's spectator leg:
        # bound kernel send buffering so a stalled client's backpressure
        # reaches the drop-oldest queue within a few frames.
        try:
            import socket as socket_mod

            request.connection.setsockopt(
                socket_mod.SOL_SOCKET, socket_mod.SO_SNDBUF, 1 << 16
            )
        except OSError:
            pass
        wsock = ws_lib.server_upgrade(request)
        if wsock is None:
            return True
        # Bounded wait for the first upstream hello (see _hello_seen):
        # no-op after it ever arrived; a dead-at-birth upstream falls
        # through to the default hello after the timeout.
        self._hello_seen.wait(timeout=2.0)
        c = _Downstream(next(self._ids), depth)
        with self._lock:
            hello = dict(self._hello)
            hello["turn"] = self._turn
            hello["relay"] = True
            snapshot = self._cache_frames_locked()
            self._clients[c.id] = c
            self._g_clients.set(len(self._clients))
        dead = threading.Event()
        try:
            wsock.send_text(json.dumps(hello))
            self._serve_frames(wsock, snapshot, cached=True)
            self._start_reader(wsock, dead)
            while not dead.is_set() and not self._closing:
                if c.dropped:
                    # Drop recovery, served locally: snapshot the cache
                    # and clear the queue under the SAME lock the
                    # producer fans out under — everything fanned out
                    # after this snapshot is still in (or headed for)
                    # the queue, so the stream stays contiguous.
                    with self._lock:
                        snapshot = self._cache_frames_locked()
                        while True:
                            try:
                                c.frames.get_nowait()
                            except queue.Empty:
                                break
                        c.dropped = False
                    self._serve_frames(wsock, snapshot, cached=True)
                    continue
                try:
                    frame = c.frames.get(timeout=0.25)
                except queue.Empty:
                    if self._ended.is_set():
                        wsock.send_text(json.dumps({"type": "end"}))
                        break
                    continue
                if frame is None:  # end sentinel: drain then close out
                    if c.frames.empty() and self._ended.is_set():
                        wsock.send_text(json.dumps({"type": "end"}))
                        break
                    continue
                self._serve_frames(wsock, (frame,), cached=False)
        except (WsClosed, OSError):
            pass  # viewer left; the tree loses one leaf
        finally:
            with self._lock:
                self._clients.pop(c.id, None)
                self._g_clients.set(len(self._clients))
            wsock.close()
        return True

    def _serve_frames(self, wsock, frames, cached: bool) -> None:
        """Multi-write half of the hot path: pre-encoded frames go out
        verbatim.  ``cached`` counts re-keyframe-cache serves (late
        join, drop recovery) apart from live relay."""
        t0 = tracing.clock_ns() if cached and frames else None
        for frame in frames:
            n = wsock.send_raw(frame)
            self._m_frames_out.inc()
            self._m_bytes_out.inc(n)
            if cached:
                self._m_cache_serves.inc()
        if t0 is not None and self._trace is not None:
            self._trace.record_span(
                "gol.relay.cache_serve",
                t0,
                tracing.clock_ns(),
                frames=len(frames),
            )

    def _start_reader(self, wsock, dead) -> None:
        """Inbound frames from a viewer: the relay's streams are
        fixed-rect (one upstream subscription serves every leaf), so
        control frames are answered with an error, never forwarded —
        and a disconnect flags the pump."""

        def reader():
            try:
                while True:
                    wsock.recv()
                    wsock.send_text(json.dumps({
                        "type": "error",
                        "error": "relay streams are fixed-rect; "
                                 "set_viewport is not supported here",
                    }))
            except (WsClosed, OSError, ValueError):
                pass
            finally:
                dead.set()

        threading.Thread(
            target=reader, name="gol-relay-ws-reader", daemon=True
        ).start()


__all__ = [
    "BACKOFF_INITIAL",
    "BACKOFF_MAX",
    "DEFAULT_CACHE_DELTAS",
    "DEFAULT_QUEUE_DEPTH",
    "RelayServer",
]
