"""Stdlib HTTP scaffolding — ONE home for the pod's wire servers.

A copy of ``distributed_gol_tpu/serve/httpd.py`` (stdlib only; the port
keeps its own copy and imports nothing of the JAX package).

Both network faces of the serving plane — the telemetry scrape surface
(``serve/telemetry.py``) and the gateway control plane
(``serve/gateway.py``) — are zero-dependency
``ThreadingHTTPServer`` daemons with the same obligations:

- **Quiet logs**: a wire surface must never block or spam the pod's
  stderr (``log_message`` is a no-op).
- **Send policy**: every response carries ``Content-Type`` +
  ``Content-Length``; a client that vanished mid-response
  (``BrokenPipeError``/``ConnectionResetError``) is swallowed, a handler
  bug is a 500 with the exception name in the body, never a wedged
  socket or a traceback-spew.
- **Ephemeral-port publish**: ``port=0`` binds an ephemeral port, and
  each server publishes its bound URL as an ``*.endpoint`` info label
  (``telemetry.endpoint`` / ``gateway.endpoint``) right after
  construction — a pod's own wire addresses belong in its telemetry,
  and with port 0 they are otherwise only knowable from inside.  Subclasses
  register the label with a literal name so the metric-docs lint
  (``tools/check_metric_docs.py``) sees it.
- **Bounded-time contract** (by construction, not enforcement):
  handlers compute from in-memory state — books, samples, handles —
  and never touch a device, take a session lock, or wait on a
  dispatch, so a wedged tenant can never hang a request.

Wire hardening (docs/API.md "Wire hardening") — three
optional knobs, each off (0/None) by default so every existing server
keeps its exact behavior until it arms them:

- ``read_timeout`` — per-connection socket read deadline.  A peer that
  trickles its request slower than the deadline (the slow-loris shape)
  is answered a best-effort ``408`` and reaped, counted on
  ``net.slowloris_reaped``.  WebSocket upgrades DISARM the reaper (the
  leg owns its own deadline/keepalive policy from there).
- ``body_cap`` — :func:`read_body`'s default Content-Length bound; an
  oversized declaration is a ``413`` (never a 500), counted on
  ``net.oversize_rejected``.
- ``max_connections`` — concurrent-connection bound; past it, a new
  connection is answered a raw ``503`` and closed before a handler
  thread is ever spawned, counted on ``net.connections_shed``.

Subclasses implement :meth:`handle`; everything above stays here
instead of growing a second hand-rolled copy per server.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from distributed_gol_torch.obs import metrics as metrics_lib

#: Default Content-Length bound of :func:`read_body` when neither the
#: caller nor the server armed one (a 65536² board upload is ~0.5 GiB
#: of PGM; anything past 64 MiB through a control endpoint is a bug).
DEFAULT_BODY_CAP = 1 << 26


class BodyTooLarge(ValueError):
    """A request body whose declared length exceeds the cap — the
    routing layer answers 413 (and bumps ``net.oversize_rejected``)
    instead of the generic 500."""


class _ReapingFile:
    """The slow-loris reaper: wraps a handler's ``rfile`` so a read
    deadline expiring mid-request is COUNTED and answered a
    best-effort 408 before the stdlib's quiet TimeoutError close path
    runs.  :func:`ws.server_upgrade` disarms it — a WebSocket leg owns
    its own deadline/keepalive policy."""

    def __init__(self, inner, connection, on_timeout):
        self._inner = inner
        self._connection = connection
        self._on_timeout = on_timeout
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def _reap(self) -> None:
        if not self.armed:
            return
        self.armed = False  # count one reap per connection
        self._on_timeout()
        try:
            self._connection.sendall(
                b"HTTP/1.1 408 Request Timeout\r\n"
                b"Content-Length: 0\r\nConnection: close\r\n\r\n"
            )
        except OSError:
            pass

    def readline(self, *args):
        try:
            return self._inner.readline(*args)
        except TimeoutError:
            self._reap()
            raise

    def read(self, *args):
        try:
            return self._inner.read(*args)
        except TimeoutError:
            self._reap()
            raise

    def readinto(self, b):
        try:
            return self._inner.readinto(b)
        except TimeoutError:
            self._reap()
            raise

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with an optional concurrent-connection
    bound: past ``gol_conn_slots``, a new connection gets a raw 503
    and is closed on the ACCEPT thread — no handler thread, no parse,
    no queue."""

    gol_conn_slots: threading.Semaphore | None = None
    gol_on_shed = None

    def process_request(self, request, client_address):
        slots = self.gol_conn_slots
        if slots is not None and not slots.acquire(blocking=False):
            if self.gol_on_shed is not None:
                self.gol_on_shed()
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Length: 0\r\nConnection: close\r\n\r\n"
                )
            except OSError:
                pass
            self.shutdown_request(request)
            return
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            if self.gol_conn_slots is not None:
                self.gol_conn_slots.release()


class StdlibHTTPServer:
    """The scaffolding base: bind, serve from daemon threads, publish
    the endpoint, tear down.  ``request_counter`` (optional) is bumped
    once per request before routing — the ``telemetry.scrapes`` /
    ``gateway.requests`` families ride it.  ``read_timeout`` /
    ``body_cap`` / ``max_connections`` arm the wire hardening (module
    docstring); all default off."""

    #: Thread name of the accept loop; subclasses override.
    thread_name = "gol-http"

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry=None,
        request_counter=None,
        read_timeout: float | None = None,
        body_cap: int = DEFAULT_BODY_CAP,
        max_connections: int = 0,
    ):
        self.registry = (
            registry if registry is not None else metrics_lib.REGISTRY
        )
        self._request_counter = request_counter
        self._read_timeout = read_timeout if read_timeout else None
        self._body_cap = int(body_cap)
        # The wire-hardening families, one registration site
        # for every server that rides this scaffolding.
        self._m_slowloris = self.registry.counter("net.slowloris_reaped")
        self._m_oversize = self.registry.counter("net.oversize_rejected")
        self._m_conn_shed = self.registry.counter("net.connections_shed")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # A wire surface must never block on the pod's logs.
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def setup(self):
                super().setup()
                self.gol_body_cap = outer._body_cap
                if outer._read_timeout is not None:
                    self.connection.settimeout(outer._read_timeout)
                    self.rfile = _ReapingFile(
                        self.rfile,
                        self.connection,
                        outer._m_slowloris.inc,
                    )

            def _send(
                self, code: int, body: bytes, ctype: str, headers=()
            ) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for name, value in headers:
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj, headers=()) -> None:
                self._send(
                    code, json.dumps(obj).encode(), "application/json",
                    headers,
                )

            def do_GET(self):  # noqa: N802 — http.server contract
                outer._route(self, "GET")

            def do_POST(self):  # noqa: N802
                outer._route(self, "POST")

            def do_DELETE(self):  # noqa: N802
                outer._route(self, "DELETE")

        self._httpd = _BoundedThreadingHTTPServer((host, port), Handler)
        if max_connections:
            self._httpd.gol_conn_slots = threading.Semaphore(
                int(max_connections)
            )
            self._httpd.gol_on_shed = self._m_conn_shed.inc
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=self.thread_name,
            daemon=True,
        )
        self._thread.start()

    # -- routing ---------------------------------------------------------------
    def _route(self, request, method: str) -> None:
        if self._request_counter is not None:
            self._request_counter.inc()
        split = urlsplit(request.path)
        path = split.path.rstrip("/") or "/"
        query = {
            k: v[-1] for k, v in parse_qs(split.query).items()
        }
        try:
            if not self.handle(request, method, path, query):
                request._send(404, b"not found\n", "text/plain")
        except BodyTooLarge as e:
            self._m_oversize.inc()
            try:
                request._send_json(413, {"error": str(e)})
            except OSError:
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response
        except TimeoutError:
            # The read deadline fired inside a handler's body read: the
            # reaper already counted it and answered 408 — re-raise so
            # the stdlib's handle_one_request closes the connection.
            raise
        except Exception as e:  # noqa: BLE001 — a handler bug is a 500
            body = f"{type(e).__name__}: {e}\n".encode()
            try:
                request._send(500, body, "text/plain")
            except OSError:
                pass

    def handle(self, request, method: str, path: str, query: dict) -> bool:
        """Route one request.  ``request`` is the live handler (use its
        ``_send`` / ``_send_json``; ``rfile``/``wfile``/``connection``
        for protocol upgrades).  Return False for "no such route" — the
        scaffolding sends the 404."""
        raise NotImplementedError

    # -- lifecycle -------------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_body(request, cap: int | None = None) -> bytes:
    """The request body per its Content-Length (empty when absent),
    refused past ``cap`` — a wire surface reads bounded input only.
    ``cap=None`` uses the server's armed ``body_cap`` (falling back to
    :data:`DEFAULT_BODY_CAP`); the refusal is a 413 through the
    routing layer (:class:`BodyTooLarge`), never a 500."""
    if cap is None:
        cap = getattr(request, "gol_body_cap", DEFAULT_BODY_CAP)
    length = int(request.headers.get("Content-Length") or 0)
    if length < 0 or length > cap:
        raise BodyTooLarge(
            f"request body of {length} bytes exceeds the {cap}-byte cap"
        )
    return request.rfile.read(length) if length else b""
