"""The network gateway — the broker goes on the wire.

A copy of ``distributed_gol_tpu/serve/gateway.py`` on the port's
serving plane.  A wire submission carries no device: the gateway's
``device`` (the serve CLI's ``--device``) places every session it admits.

Every serving subsystem so far is in-process: admission/shedding
(``serve/admission.py``), the multi-tenant plane (``serve/plane.py``),
ROI frame fan-out (``serve/frames.py``), SLO'd telemetry
(``serve/telemetry.py``).  This module is the face ROADMAP item 1 and
the module docs of ``plane.py``/``frames.py`` reserved a seam for: an
HTTP control plane plus WebSocket streaming that maps the reference
broker contract (PAPER.md §1, ``Broker.Publish/Pause/CheckStates/
Quit``) onto a live :class:`~distributed_gol_torch.serve.plane.ServePlane`
— zero dependencies, riding ``serve/httpd.py`` + ``serve/ws.py``.

HTTP control plane (``wire.py`` is the schema home):

- ``POST /v1/sessions`` — ``Broker.Publish``: a board upload (base64
  PGM) or soup spec + Params JSON through the admission ladder; a shed
  submission answers **429 with a Retry-After** header (the admission
  hint), a permanent rejection 409, a draining pod 503.
- ``POST /v1/sessions/<t>/pause|resume|quit`` — ``Broker.Pause`` /
  ``Quit``: keyboard-equivalent keys routed into the resident
  controller ('p' toggles at a superstep boundary; 'q' parks the
  resumable checkpoint — the reference detach).
- ``GET /v1/sessions[/<t>/state]`` — ``Broker.CheckStates``: status /
  turn / alive count per session.
- ``POST /v1/drain`` — pod drain over the wire; the response is the
  parked-resumable receipt a restarted pod re-adopts from
  (``serve --readopt``).
- ``GET /healthz`` — the plane's health dict (200 ready / 503 not).

WebSocket legs (one connected client is a *controller* or a
*spectator*):

- ``GET /v1/sessions/<t>/events`` (upgrade) — the controller leg: the
  session's live event stream as JSON text frames (``TurnsCompleted``
  ranges, alive counts, state changes, the terminal ``end`` receipt),
  each stamped with a monotonic ``seq``; inbound control frames are
  pause/resume/quit or raw keys.  **Disconnect is the reference's
  controller detach** — the run keeps going; reconnecting (optionally
  ``?since=<seq>``) re-attaches to the same tenant and replays the
  bounded ring tail.
- ``GET /v1/sessions/<t>/frames?rect=y0,x0,vh,vw`` (upgrade) — the
  spectator leg: subscribes the rect to the session's FramePlane and
  streams keyframe-then-delta binary frames (the ``engine/frames.py``
  wire format, byte-exact the in-process stream); ``set_viewport``
  text frames pan/zoom mid-stream.  A slow spectator loses oldest
  frames (the FramePlane drop-oldest contract) and re-anchors on the
  automatic re-keyframe — it can never wedge the producer.

Drain integration: the gateway registers a pre-drain hook on the
plane, so a SIGTERM (``ServePlane.install``) closes the wire face —
new submissions 503 — *before* the plane sheds its queue; resident
streams keep flowing until each session's emergency checkpoint lands
and the ``end`` receipt is broadcast.
"""

from __future__ import annotations

import itertools
import json
import queue
import re
import threading
from collections import OrderedDict, deque
from pathlib import Path

from distributed_gol_torch.engine.events import (
    AliveCellsCount,
    EventQueue,
    FinalTurnComplete,
    StateChange,
    TurnComplete,
    TurnsCompleted,
)
from distributed_gol_torch.obs import openmetrics
from distributed_gol_torch.obs import tracing
from distributed_gol_torch.serve import wire
from distributed_gol_torch.serve.admission import AdmissionRejected
from distributed_gol_torch.serve.httpd import StdlibHTTPServer, read_body
from distributed_gol_torch.serve.ws import WsClosed, WsTimeout, server_upgrade

#: Event-ring depth per session: the reconnect replay window (a
#: controller that detached longer ago than this re-anchors from the
#: hello snapshot instead).
RING_DEPTH = 256

#: Tenant names must be metrics-label and path safe.
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

_SESSION_PATH = re.compile(r"^/v1/sessions/([^/]+)(?:/([a-z_]+))?$")


class _WireSession:
    """One gateway-managed tenant: the control/key queue, the event
    pump, the bounded replay ring, attached controllers, and (spectate
    sessions) the FramePlane spectators subscribe to."""

    def __init__(self, tenant: str, params, spectate: bool):
        self.tenant = tenant
        self.params = params
        self.keys: queue.Queue = queue.Queue()
        self.events = EventQueue()
        self.frame_plane = None
        if spectate:
            from distributed_gol_torch.serve.frames import FramePlane

            self.frame_plane = FramePlane(
                board_shape=(params.image_height, params.image_width),
                metrics=params.metrics,
            )
        self.handle = None  # set right after plane.submit
        #: The request trace: created from the submission's
        #: inbound ``traceparent`` (or minted) — its id rides every
        #: response for this tenant as ``X-Gol-Trace-Id``.
        self.trace = None
        self.lock = threading.Lock()
        self.seq = 0
        self.ring: deque = deque(maxlen=RING_DEPTH)
        self.controllers: dict[int, queue.Queue] = {}
        self._ids = itertools.count(1)
        #: The gateway's view of the pause toggle — what makes the REST
        #: pause/resume idempotent over the controller's 'p' flip; the
        #: authoritative echo arrives as a StateChange event.
        self.paused_target = False
        self.paused = False
        self.alive: int | None = None
        self.alive_turn = 0
        self.turn = 0
        self.ended = threading.Event()

    # -- control (Broker.Pause / Quit over the wire) ---------------------------
    def pause(self) -> bool:
        with self.lock:
            if self.ended.is_set():
                return False
            if not self.paused_target:
                self.paused_target = True
                self.keys.put("p")
            return True

    def resume(self) -> bool:
        with self.lock:
            if self.ended.is_set():
                return False
            if self.paused_target:
                self.paused_target = False
                self.keys.put("p")
            return True

    def quit(self) -> bool:
        """The 'q' detach: park the resumable checkpoint, end the run."""
        with self.lock:
            if self.ended.is_set():
                return False
            self.keys.put("q")
            return True

    def press(self, key: str) -> bool:
        with self.lock:
            if self.ended.is_set():
                return False
            self.keys.put(key)
            return True

    # -- the event pump --------------------------------------------------------
    def start_pump(self) -> None:
        threading.Thread(
            target=self._pump,
            name=f"gol-gateway-pump-{self.tenant}",
            daemon=True,
        ).start()

    def _pump(self) -> None:
        """Drain the session's event stream: track the CheckStates
        surface (turn / alive / paused), serialize to wire messages,
        broadcast to attached controllers, retain the bounded ring."""
        while True:
            items = self.events.get_many(256)
            for item in items:
                if item is None:
                    self._finish()
                    return
                self._observe(item)
                msg = wire.event_to_wire(item)
                if msg is not None:
                    self._broadcast(msg)

    def _observe(self, event) -> None:
        if isinstance(event, (TurnComplete, TurnsCompleted)):
            self.turn = event.completed_turns
        elif isinstance(event, AliveCellsCount):
            self.alive = event.cells_count
            self.alive_turn = event.completed_turns
        elif isinstance(event, FinalTurnComplete):
            self.turn = event.completed_turns
            self.alive = len(event.alive)
            self.alive_turn = event.completed_turns
        elif isinstance(event, StateChange):
            state = str(event.new_state)
            if state in ("Paused", "Executing"):
                with self.lock:
                    self.paused = state == "Paused"
                    self.paused_target = self.paused

    def _finish(self) -> None:
        """Terminal path: wait for the plane to classify the handle,
        broadcast the ``end`` receipt, release every attached
        controller."""
        handle = self.handle
        if handle is not None:
            handle.wait(timeout=30)
            self.turn = max(self.turn, handle.last_turn)
            self._broadcast(
                {
                    "type": "end",
                    "status": handle.status,
                    "turn": self.turn,
                    "resumable": handle.resumable,
                    "error": handle.error,
                }
            )
        self.ended.set()
        with self.lock:
            queues = list(self.controllers.values())
        for q in queues:
            _put_drop_oldest(q, None)

    def _broadcast(self, msg: dict) -> None:
        with self.lock:
            self.seq += 1
            msg["seq"] = self.seq
            text = json.dumps(msg)
            self.ring.append((self.seq, text))
            queues = list(self.controllers.values())
        for q in queues:
            _put_drop_oldest(q, text)

    def summary(self) -> dict:
        handle = self.handle
        return {
            "status": handle.status if handle else "queued",
            "admitted_as": handle.admitted_as if handle else None,
            "turn": max(self.turn, handle.last_turn if handle else 0),
            "alive": self.alive,
            "alive_turn": self.alive_turn,
            "paused": self.paused_target,
            "resumable": handle.resumable if handle else False,
            "error": handle.error if handle else None,
            "seq": self.seq,
            "controllable": True,
            "spectate": self.frame_plane is not None,
            "controllers": len(self.controllers),
            "spectators": (
                self.frame_plane.subscribers()
                if self.frame_plane is not None
                else 0
            ),
        }


def _put_drop_oldest(q: queue.Queue, item) -> None:
    """Bounded fan-out put: a stalled controller loses OLDEST messages
    (the seq stamps make the gap visible client-side) instead of
    backing the pump up — the same policy as the FramePlane."""
    while True:
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            try:
                q.get_nowait()
            except queue.Empty:
                pass


class GatewayServer(StdlibHTTPServer):
    """The pod's wire face.  Construct with a live ``ServePlane`` (or
    use :func:`serve_plane_gateway`); ``port=0`` binds ephemeral and
    publishes the URL as the ``gateway.endpoint`` info label."""

    thread_name = "gol-gateway-http"

    def __init__(
        self,
        plane,
        port: int = 0,
        host: str = "127.0.0.1",
        upload_root: str | Path | None = None,
        device: str = "cuda",
    ):
        self.plane = plane
        self._device = device
        self._upload_root = (
            Path(upload_root)
            if upload_root is not None
            else (plane._root or Path("out"))
        )
        self._sessions: dict[str, _WireSession] = {}
        self._lock = threading.Lock()
        self._draining = False
        self._closing = False
        reg = plane.metrics
        self._m_requests = reg.counter("gateway.requests")
        self._m_submitted = reg.counter("gateway.sessions_submitted")
        self._m_rejected = reg.counter("gateway.rejected")
        self._m_ws_messages = reg.counter("gateway.ws_messages")
        self._m_frames = reg.counter("gateway.frames_streamed")
        self._m_bytes = reg.counter("gateway.bytes_streamed")
        self._g_controllers = reg.gauge("gateway.controllers")
        self._g_spectators = reg.gauge("gateway.spectators")
        self._g_controllers.set(0)
        self._g_spectators.set(0)
        self._n_controllers = 0
        self._n_spectators = 0
        # Wire hardening: the gateway arms the scaffolding's
        # read deadline / body cap / connection bound from ServeConfig,
        # keeps a bounded idempotency-receipt ring so a retried POST
        # /v1/sessions (response died mid-body) replays its receipt
        # instead of double-placing the tenant, and counts keepalive
        # drops from its WebSocket legs.
        cfg = plane.config
        self._ws_keepalive = float(cfg.ws_keepalive_seconds)
        self._ws_keepalive_misses = int(cfg.ws_keepalive_misses)
        self._ws_max_frame = int(cfg.ws_max_frame_bytes)
        self._idem_cap = int(cfg.idempotency_cache_size)
        self._idem: OrderedDict[str, tuple[int, dict]] = OrderedDict()
        self._m_replays = reg.counter("net.idempotent_replays")
        self._m_keepalive_drops = reg.counter("net.keepalive_drops")
        # SIGTERM closes the wire face BEFORE the plane sheds (the
        # drain contract's gateway half).
        plane.add_drain_hook(self._on_drain)
        super().__init__(
            port=port,
            host=host,
            registry=reg,
            request_counter=self._m_requests,
            read_timeout=(cfg.wire_read_timeout_seconds or None),
            body_cap=cfg.wire_body_cap_bytes,
            max_connections=cfg.wire_max_connections,
        )
        # The bound wire address (ephemeral port 0 resolved) — how a
        # second terminal discovers the gateway.
        reg.info("gateway.endpoint", self.url)

    # -- lifecycle -------------------------------------------------------------
    def _on_drain(self) -> None:
        self._draining = True

    def close(self) -> None:
        """Stop accepting, wake every streaming loop, tear down."""
        self._draining = True
        self._closing = True
        super().close()

    # -- submissions (shared by POST and the serve CLI) ------------------------
    def local_submit(
        self,
        tenant: str,
        params,
        deadline_seconds: float | None = None,
        spectate: bool = False,
        trace=None,
    ):
        """Submit one session THROUGH the gateway's books (key queue,
        event pump, optional FramePlane) so it is wire-controllable —
        the path the serve CLI's scripted/re-adopted tenants take when
        a gateway is armed.  Raises ``AdmissionRejected`` like
        ``plane.submit``.  ``trace`` is the request trace the
        wire handler created from the inbound ``traceparent``; None
        mints one in the plane."""
        session = _WireSession(tenant, params, spectate)
        handle = self.plane.submit(
            tenant,
            params,
            events=session.events,
            deadline_seconds=deadline_seconds,
            keys=session.keys,
            frame_plane=session.frame_plane,
            trace=trace,
        )
        session.handle = handle
        session.trace = handle.trace
        with self._lock:
            self._sessions[tenant] = session
            self._prune_sessions()
        session.start_pump()
        self._m_submitted.inc()
        return handle

    def _prune_sessions(self) -> None:
        """Drop wire books for ended tenants the plane itself no longer
        retains (its ``max_retained_handles`` eviction ring) — a
        churning-tenant gateway pod stays bounded-memory exactly like
        the plane under it.  Caller holds ``self._lock``."""
        retained = self.plane.handles()
        for tenant, session in list(self._sessions.items()):
            if (
                session.ended.is_set()
                and retained.get(tenant) is not session.handle
            ):
                del self._sessions[tenant]

    # -- routing ---------------------------------------------------------------
    def _trace_headers(self, session) -> list:
        """``X-Gol-Trace-Id`` for every response that resolves to a
        traced session — how a client correlates any
        state/control answer with the request timeline on ``/traces``."""
        trace = session.trace if session is not None else None
        if trace is None:
            return []
        return [("X-Gol-Trace-Id", trace.trace_id)]

    def handle(self, request, method: str, path: str, query: dict) -> bool:
        if path == "/healthz" and method == "GET":
            health = self.plane.health()
            request._send_json(200 if health.get("ready") else 503, health)
            return True
        if path == "/traces" and method == "GET":
            # The request-timeline surface, served from the gateway too
            # (one base URL drives tools/gol_client.py --trace); the
            # telemetry server carries the same route.
            code, obj = tracing.http_traces(query)
            request._send_json(code, obj)
            return True
        if path == "/metrics" and method == "GET":
            # The fleet collector's per-pod scrape target:
            # one base URL serves frames AND metrics, so a pod needs no
            # sidecar telemetry server to join the federated plane.
            snap = self.plane.metrics.snapshot().to_dict()
            text = openmetrics.render(snap)
            request._send(200, text.encode(), openmetrics.CONTENT_TYPE)
            return True
        if path == "/flight" and method == "GET":
            # The pod's plane ring, same shape as the broker's /flight —
            # what /fleet/flight time-orders into the merged postmortem.
            request._send_json(200, {"records": self.plane.flight.records()})
            return True
        if path == "/v1/sessions":
            if method == "GET":
                return self._list_sessions(request)
            if method == "POST":
                return self._submit(request)
            return False
        if path == "/v1/drain" and method == "POST":
            timeout = None
            if "timeout" in query:
                try:
                    timeout = float(query["timeout"])
                except ValueError:
                    request._send_json(400, {"error": "bad timeout"})
                    return True
            receipt = self.plane.drain(timeout)
            request._send_json(200, {"draining": True, "sessions": receipt})
            return True
        m = _SESSION_PATH.match(path)
        if not m:
            return False
        tenant, action = m.group(1), m.group(2)
        with self._lock:
            session = self._sessions.get(tenant)
        handle = self.plane.handle(tenant)
        if handle is None and session is None:
            request._send_json(404, {"error": f"no session {tenant!r}"})
            return True
        if method == "GET" and action in (None, "state"):
            request._send_json(
                200,
                self._summary(tenant, session, handle),
                headers=self._trace_headers(session),
            )
            return True
        if method == "GET" and action == "events":
            return self._controller_ws(request, tenant, session, query)
        if method == "GET" and action == "frames":
            return self._spectator_ws(request, tenant, session, query)
        if method == "POST" and action in ("pause", "resume", "quit"):
            return self._control(request, tenant, session, action)
        return False

    # -- REST handlers ---------------------------------------------------------
    def _summary(self, tenant, session, handle) -> dict:
        if session is not None:
            out = session.summary()
        else:
            # A plane-submitted tenant (no wire books): state only.
            out = {
                "status": handle.status,
                "admitted_as": handle.admitted_as,
                "turn": handle.last_turn,
                "alive": None,
                "alive_turn": 0,
                "paused": None,
                "resumable": handle.resumable,
                "error": handle.error,
                "seq": 0,
                "controllable": False,
                "spectate": False,
                "controllers": 0,
                "spectators": 0,
            }
        out["tenant"] = tenant
        return out

    def _list_sessions(self, request) -> bool:
        with self._lock:
            sessions = dict(self._sessions)
        out = {}
        for tenant, handle in self.plane.handles().items():
            out[tenant] = self._summary(tenant, sessions.get(tenant), handle)
        request._send_json(
            200, {"sessions": out, "draining": self.plane.draining}
        )
        return True

    def _submit(self, request) -> bool:
        if self._draining:
            self._m_rejected.inc()
            request._send_json(
                503, {"error": "pod is draining; admissions closed"}
            )
            return True
        try:
            doc = json.loads(read_body(request) or b"{}")
        except ValueError as e:
            request._send_json(400, {"error": f"body is not JSON: {e}"})
            return True
        tenant = doc.pop("tenant", None) if isinstance(doc, dict) else None
        if not isinstance(tenant, str) or not _TENANT_RE.match(tenant):
            request._send_json(
                400,
                {"error": "tenant must match [A-Za-z0-9][A-Za-z0-9._-]*"},
            )
            return True
        # Idempotent retry: a client whose 201 died mid-body
        # resends with the same ``X-Gol-Idempotency-Key``; the stored
        # receipt is replayed verbatim instead of double-placing the
        # tenant through admission.
        idem_key = request.headers.get("X-Gol-Idempotency-Key")
        if idem_key:
            with self._lock:
                stored = self._idem.get(idem_key)
            if stored is not None:
                code, receipt = stored
                self._m_replays.inc()
                request._send_json(
                    code,
                    receipt,
                    headers=[("X-Gol-Idempotent-Replay", "1")],
                )
                return True
        # Request-scoped tracing: accept the inbound W3C
        # ``traceparent`` (a malformed one starts a fresh trace; an
        # inbound sampled flag forces retention) — the wire-handling
        # span below is the timeline's first entry, BEFORE admission.
        req_ns = tracing.clock_ns()
        req_trace = tracing.TRACER.start_trace(
            "gol.request",
            traceparent=request.headers.get("traceparent"),
            tenant=tenant,
        )
        trace_headers = [
            ("X-Gol-Trace-Id", req_trace.trace_id),
            ("traceparent", req_trace.traceparent()),
        ]
        try:
            params, options = wire.params_from_spec(
                tenant, doc, root=self._upload_root, device=self._device
            )
        except wire.SpecError as e:
            tracing.TRACER.end_trace(
                req_trace, status="rejected", error=str(e)
            )
            request._send_json(
                400, {"error": str(e)}, headers=trace_headers
            )
            return True
        try:
            handle = self.local_submit(
                tenant,
                params,
                deadline_seconds=options.get("deadline_seconds"),
                spectate=options["spectate"],
                trace=req_trace,
            )
        except AdmissionRejected as e:
            # The admission ladder on the wire: transient rejections are
            # 429 + Retry-After (the shed hint), permanent ones 409.
            # The plane already ended the trace ``rejected``; the id
            # still rides the answer so a shed caller can fetch it.
            self._m_rejected.inc()
            if e.retry_after is not None:
                request._send_json(
                    429,
                    {"error": e.reason, "retry_after": e.retry_after},
                    headers=[("Retry-After", f"{e.retry_after:g}")]
                    + trace_headers,
                )
            else:
                request._send_json(
                    409, {"error": e.reason}, headers=trace_headers
                )
            return True
        req_trace.record_span(
            "gol.request.handle",
            req_ns,
            tracing.clock_ns(),
            method="POST",
            path="/v1/sessions",
            tenant=tenant,
        )
        receipt = {
            "tenant": tenant,
            "status": handle.status,
            "admitted_as": handle.admitted_as,
            "spectate": options["spectate"],
            # The correlation stamp: fetch the timeline
            # at GET /traces?trace_id=<this> once the run moves.
            "trace_id": req_trace.trace_id,
            "traceparent": req_trace.traceparent(),
            "links": {
                "state": f"/v1/sessions/{tenant}/state",
                "events": f"/v1/sessions/{tenant}/events",
                "frames": f"/v1/sessions/{tenant}/frames",
                "trace": f"/traces?trace_id={req_trace.trace_id}",
            },
        }
        if idem_key and self._idem_cap:
            # Store BEFORE the send: it is exactly the response that
            # dies mid-body whose retry must find the receipt.
            with self._lock:
                self._idem[idem_key] = (201, receipt)
                while len(self._idem) > self._idem_cap:
                    self._idem.popitem(last=False)
        request._send_json(201, receipt, headers=trace_headers)
        return True

    def _control(self, request, tenant, session, action) -> bool:
        if session is None:
            request._send_json(
                409,
                {
                    "error": f"session {tenant!r} was not submitted "
                    "through the gateway; no control channel"
                },
            )
            return True
        ok = getattr(session, action)()
        if not ok:
            request._send_json(
                409,
                {"error": f"session {tenant!r} already ended"},
                headers=self._trace_headers(session),
            )
            return True
        request._send_json(
            200,
            {"tenant": tenant, "action": action, "ok": True},
            headers=self._trace_headers(session),
        )
        return True

    # -- ws legs ---------------------------------------------------------------
    def _upgrade(self, request):
        """``server_upgrade`` with the gateway's wire policy: the
        inbound frame cap, and (when armed) the recv-deadline keepalive
        that detects a stalled-not-closed peer.  The keepalive socket
        timeout also bounds every ``send``: a spectator that stopped
        reading (full SO_SNDBUF) times the leg out instead of parking
        its streaming thread forever."""
        ws = server_upgrade(request, max_payload=self._ws_max_frame)
        if ws is not None and self._ws_keepalive > 0:
            ws.enable_keepalive(
                self._ws_keepalive, misses=self._ws_keepalive_misses
            )
        return ws

    # -- the controller leg ----------------------------------------------------
    def _controller_ws(self, request, tenant, session, query) -> bool:
        if session is None:
            request._send_json(
                409, {"error": f"session {tenant!r} has no wire books"}
            )
            return True
        try:
            since = int(query.get("since", 0) or 0)
        except ValueError:
            request._send_json(400, {"error": "bad since"})
            return True
        ws = self._upgrade(request)
        if ws is None:
            return True
        cq: queue.Queue = queue.Queue(maxsize=1024)
        with session.lock:
            replay = [text for s, text in session.ring if s > since]
            cid = next(session._ids)
            session.controllers[cid] = cq
            hello = {
                "type": "hello",
                "tenant": tenant,
                "seq": session.seq,
                "status": session.handle.status,
                "turn": max(session.turn, session.handle.last_turn),
                "paused": session.paused_target,
                "replay": len(replay),
            }
            ended = session.ended.is_set()
        self._count_controllers(+1)
        dead = threading.Event()
        try:
            ws.send_text(json.dumps(hello))
            for text in replay:
                ws.send_text(text)
            self._start_reader(ws, session, dead, spectator=None)
            if ended:
                return True  # replay (incl. the end receipt) is the tail
            while not dead.is_set() and not self._closing:
                try:
                    item = cq.get(timeout=0.25)
                except queue.Empty:
                    continue
                if item is None:
                    break  # session ended; the end receipt was queued
                ws.send_text(item)
        except (WsClosed, OSError):
            pass  # controller detached: the run keeps going
        finally:
            with session.lock:
                session.controllers.pop(cid, None)
            self._count_controllers(-1)
            ws.close()
        return True

    # -- the spectator leg -----------------------------------------------------
    def _spectator_ws(self, request, tenant, session, query) -> bool:
        if session is None or session.frame_plane is None:
            request._send_json(
                409,
                {
                    "error": f"session {tenant!r} has no spectator plane "
                    "(submit with \"spectate\": true)"
                },
            )
            return True
        p = session.params
        rect = (0, 0, min(256, p.image_height), min(256, p.image_width))
        if p.viewport is not None:
            rect = tuple(p.viewport)
        if "rect" in query:
            try:
                rect = tuple(int(v) for v in query["rect"].split(","))
            except ValueError:
                rect = ()
            if len(rect) != 4 or rect[2] < 1 or rect[3] < 1:
                request._send_json(
                    400, {"error": "rect wants y0,x0,vh,vw"}
                )
                return True
        try:
            depth = max(1, int(query.get("queue", 8)))
        except ValueError:
            request._send_json(400, {"error": "bad queue depth"})
            return True
        sub = session.frame_plane.subscribe(rect, maxsize=depth)
        # Liveness over staleness: bound the kernel's send buffering so
        # a stalled spectator's backpressure reaches the subscriber
        # queue (where drop-oldest + re-keyframe handle it) within a
        # few frames, instead of the kernel silently absorbing
        # megabytes of stale frames the client will only ever skip.
        try:
            import socket as socket_mod

            request.connection.setsockopt(
                socket_mod.SOL_SOCKET, socket_mod.SO_SNDBUF, 1 << 16
            )
        except OSError:
            pass
        ws = self._upgrade(request)
        if ws is None:
            session.frame_plane.unsubscribe(sub)
            return True
        self._count_spectators(+1)
        dead = threading.Event()
        try:
            ws.send_text(
                json.dumps(
                    {
                        "type": "hello",
                        "tenant": tenant,
                        "rect": list(sub.rect),
                        "turn": session.turn,
                        # The session's request trace, exported to the
                        # stream: a subscribing relay joins
                        # it (gol.relay.* spans) and re-exports it, so
                        # /fleet/traces stitches pod + relay legs on
                        # one id.
                        "traceparent": (
                            session.trace.traceparent()
                            if session.trace is not None
                            else None
                        ),
                    }
                )
            )
            self._start_reader(ws, session, dead, spectator=sub)
            first_send = True
            while not dead.is_set() and not self._closing:
                try:
                    ev = sub.events.get(timeout=0.25)
                except queue.Empty:
                    if session.ended.is_set():
                        ws.send_text(json.dumps({"type": "end"}))
                        break
                    continue
                blob = wire.encode_frame_event(ev)
                ws.send_binary(blob)
                if first_send:
                    # The last hop of the request timeline:
                    # FramePlane publish → this spectator's first wire
                    # frame.  Once per connection, into the session's
                    # always-retained event ring.
                    first_send = False
                    if session.trace is not None:
                        session.trace.add_event(
                            "gol.spectator.first_send",
                            turn=ev.completed_turns,
                            bytes=len(blob),
                        )
                self._m_frames.inc()
                self._m_bytes.inc(len(blob))
        except (WsClosed, OSError):
            pass  # spectator left; the plane just loses one subscriber
        finally:
            session.frame_plane.unsubscribe(sub)
            self._count_spectators(-1)
            ws.close()
        return True

    # -- inbound ws control frames ---------------------------------------------
    def _start_reader(self, ws, session, dead, spectator) -> None:
        """One reader thread per ws connection: control frames in,
        errors answered, disconnect flagged for the streaming loop."""

        def reader():
            try:
                while True:
                    opcode, payload = ws.recv()
                    self._m_ws_messages.inc()
                    try:
                        msg = wire.parse_control(payload.decode())
                        self._apply_control(msg, session, spectator)
                    except wire.SpecError as e:
                        ws.send_text(
                            json.dumps({"type": "error", "error": str(e)})
                        )
            except WsTimeout:
                # The keepalive verdict: no frame (not even a pong)
                # inside the miss budget — a stalled-not-closed peer.
                self._m_keepalive_drops.inc()
            except (WsClosed, OSError, UnicodeDecodeError):
                pass
            finally:
                dead.set()

        threading.Thread(
            target=reader, name="gol-gateway-ws-reader", daemon=True
        ).start()

    def _apply_control(self, msg: dict, session, spectator) -> None:
        kind = msg["type"]
        if spectator is not None:
            # Spectators are read-only: pan/zoom their own viewport.
            if kind != "set_viewport":
                raise wire.SpecError(
                    f"spectators may only set_viewport, not {kind!r}"
                )
            session.frame_plane.set_viewport(spectator, msg["rect"])
            return
        if kind == "pause":
            session.pause()
        elif kind == "resume":
            session.resume()
        elif kind == "quit":
            session.quit()
        elif kind == "key":
            session.press(msg["key"])
        else:
            raise wire.SpecError(f"controllers cannot {kind!r}")

    # -- gauges ----------------------------------------------------------------
    def _count_controllers(self, d: int) -> None:
        with self._lock:
            self._n_controllers += d
            self._g_controllers.set(self._n_controllers)

    def _count_spectators(self, d: int) -> None:
        with self._lock:
            self._n_spectators += d
            self._g_spectators.set(self._n_spectators)


def serve_plane_gateway(
    plane, port: int = 0, host: str = "127.0.0.1", upload_root=None,
    device: str = "cuda",
) -> GatewayServer:
    """Attach the wire face to a ``ServePlane`` (the serve CLI's
    ``--gateway-port``); wire submissions run on ``device``."""
    return GatewayServer(
        plane, port=port, host=host, upload_root=upload_root, device=device
    )


__all__ = ["GatewayServer", "serve_plane_gateway", "RING_DEPTH"]
