"""Stdlib HTTP telemetry endpoints.

A copy of ``distributed_gol_tpu/serve/telemetry.py`` on the port's
registry, sampler and OpenMetrics renderer.

The reference system's ``Broker.CheckStates`` RPC is an external party
asking a live pod "how are you doing, per run" over the network
(PAPER.md §1); this is its rebuilt, scrape-shaped form — three
endpoints on a tiny ``http.server`` daemon:

- ``GET /metrics`` — the latest telemetry sample rendered as
  OpenMetrics text (``obs/openmetrics.py``).
- ``GET /healthz`` — the plane's ready/live JSON (HTTP 200 when ready,
  503 when not — what a load balancer's health check consumes; the body
  is the full health dict either way).
- ``GET /slo`` — the per-tenant SLO table (404 when no objectives are
  armed).

**Bounded-time contract**: every response is computed from the
sampler's latest in-memory sample (or, sampler off, a direct
``include_lazy=False`` registry snapshot — plain dict copies under the
registry lock).  No handler ever touches a device, takes a session
lock, or waits on a dispatch, so a wedged device or hung tenant can
never hang a scrape — the worst case is a stale sample, and the
staleness itself is published (``telemetry.sample_age_seconds`` on
``/healthz``).  The server scaffolding — daemon threads, quiet logs,
the send/error policy, the ephemeral-port ``telemetry.endpoint``
publish — is the shared :class:`serve.httpd.StdlibHTTPServer` (one
home, not a second hand-rolled copy).

Entry points: ``TelemetryServer(...)`` directly,
:func:`serve_plane_telemetry` for a ``ServePlane`` (the serve CLI's
``--telemetry-port``), and :func:`run_telemetry` for a single
``gol.run(..., telemetry_port=...)``.
"""

from __future__ import annotations

from typing import Callable

from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import openmetrics
from distributed_gol_torch.obs import tracing
from distributed_gol_torch.serve.httpd import StdlibHTTPServer


class TelemetryServer(StdlibHTTPServer):
    """One pod's scrape surface.  ``port=0`` binds an ephemeral port
    (read it back from :attr:`port` — the test spelling); ``host``
    defaults to loopback, production pods pass ``"0.0.0.0"``."""

    thread_name = "gol-telemetry-http"

    def __init__(
        self,
        metrics_fn: Callable[[], dict],
        health_fn: Callable[[], dict],
        slo_fn: Callable[[], dict] | None = None,
        port: int = 0,
        host: str = "127.0.0.1",
        registry=None,
        flight_fn: Callable[[], dict] | None = None,
    ):
        self._metrics_fn = metrics_fn
        self._health_fn = health_fn
        self._slo_fn = slo_fn
        self._flight_fn = flight_fn
        registry = registry if registry is not None else metrics_lib.REGISTRY
        # The scrape counter exists BEFORE the server binds (the base
        # bumps it per request), so even a scrape racing construction
        # is counted.
        super().__init__(
            port=port,
            host=host,
            registry=registry,
            request_counter=registry.counter("telemetry.scrapes"),
        )
        # Publish the bound address: with port=0 the ephemeral port is
        # otherwise only knowable from inside the process.
        self.registry.info("telemetry.endpoint", self.url)

    def handle(self, request, method: str, path: str, query: dict) -> bool:
        if method != "GET":
            return False
        if path == "/metrics":
            text = openmetrics.render(self._metrics_fn())
            request._send(200, text.encode(), openmetrics.CONTENT_TYPE)
        elif path == "/healthz":
            health = self._health_fn()
            code = 200 if health.get("ready", False) else 503
            request._send_json(code, health)
        elif path == "/slo" and self._slo_fn is not None:
            request._send_json(200, self._slo_fn())
        elif path == "/flight" and self._flight_fn is not None:
            # The plane's flight ring, broker-/flight-shaped:
            # one of the sources /fleet/flight time-orders into the
            # merged postmortem.
            request._send_json(200, self._flight_fn())
        elif path == "/traces":
            # Request-scoped tracing: recent retained traces
            # (``?tenant=``, ``?limit=``) or one by ``?trace_id=`` —
            # pure in-memory ring reads, the same bounded-time contract
            # as every other endpoint here.
            code, obj = tracing.http_traces(query)
            request._send_json(code, obj)
        else:
            return False
        return True


def serve_plane_telemetry(plane, port: int = 0, host: str = "127.0.0.1"):
    """Attach the scrape surface to a ``ServePlane``: ``/metrics`` serves
    the plane sampler's latest sample (falling back to a direct lazy-free
    snapshot when the sampler is off), ``/healthz`` serves
    ``plane.health()`` (itself sampler-backed, see the plane), ``/slo``
    the SLO tracker's table when objectives are armed, and ``/flight``
    the plane's flight ring (one source of the fleet postmortem)."""

    def metrics_fn() -> dict:
        sampler = plane.sampler
        if sampler is not None:
            latest = sampler.latest()
            if latest is not None:
                return latest.snapshot
        return plane.metrics.snapshot(include_lazy=False).to_dict()

    slo_fn = None
    if plane.slo is not None:
        slo_fn = plane.slo.summary
    return TelemetryServer(
        metrics_fn, plane.health, slo_fn, port=port, host=host,
        registry=plane.metrics,
        flight_fn=lambda: {"records": plane.flight.records()},
    )


def run_telemetry(sampler, port: int = 0, host: str = "127.0.0.1"):
    """The single-run form (``gol.run(..., telemetry_port=...)``): the
    run has no admission books, so ``/healthz`` reports liveness plus
    the sampler-derived windowed rates — enough for a balancer to see
    "this run is alive and computing"."""

    def metrics_fn() -> dict:
        latest = sampler.latest()
        if latest is not None:
            return latest.snapshot
        return sampler.registry.snapshot(include_lazy=False).to_dict()

    def health_fn() -> dict:
        age = sampler.staleness
        return {
            "ready": True,
            "live": True,
            "sampling": sampler.running,
            "sample_age_seconds": round(age, 3) if age != float("inf") else None,
            "staleness_bound_seconds": sampler.interval,
            "rates": sampler.derived(),
        }

    return TelemetryServer(
        metrics_fn, health_fn, port=port, host=host, registry=sampler.registry
    )
