"""Pod-gateway client for the broker tier.

A copy of ``distributed_gol_tpu/serve/podclient.py`` (stdlib only; the
port keeps its own copy and imports nothing of the JAX package).

The broker (``serve/broker.py``) talks to its pods over exactly the
wire contract ``serve/gateway.py`` publishes — nothing side-channel —
through this bounded-timeout ``http.client`` wrapper.  Two disciplines
distinguish it from a generic HTTP helper:

- **Bounded time, always**: every call carries an explicit socket
  timeout (the broker's health-probe loop must never wedge on a dead
  pod — a pod that cannot answer inside the probe timeout IS the
  signal), and a connect/read failure is one typed outcome
  (:class:`PodUnreachable`), never a raw socket exception leaking into
  placement logic.
- **Deterministic retry/backoff** riding the controller's retry-policy shape
  (``engine/controller.py::_backoff``): ``attempts`` tries with delay
  ``backoff_seconds * 2**(attempt-1)`` capped at
  ``backoff_max_seconds`` — a pure function of the attempt index, no
  jitter, so a scripted chaos test sees the same retry schedule every
  run.  Retries apply only to *transport* failures (unreachable /
  reset); an HTTP error status is a pod ANSWER and is surfaced
  immediately as :class:`PodHTTPError` — retrying a 429 is the
  caller's placement decision, not the transport's.

Zero dependencies beyond the stdlib, importable without torch — the
broker process never touches a device.
"""

from __future__ import annotations

import http.client
import json
import time
import uuid
from urllib.parse import urlsplit

#: Response-size bound: a broker control answer is JSON a
#: few KiB long; a pod (or a chaos proxy wearing its address) that
#: declares or streams more than this is answering garbage, and the
#: broker must not buffer it.
DEFAULT_RESPONSE_CAP = 1 << 24

#: The idempotency header ``POST /v1/sessions`` retries carry
#: (docs/API.md "Wire hardening"); the gateway replays the stored
#: receipt for a repeated key instead of double-placing the tenant.
IDEMPOTENCY_HEADER = "X-Gol-Idempotency-Key"


class PodUnreachable(RuntimeError):
    """The pod did not answer inside the bounded budget (connect
    refused, socket timeout, reset mid-response) — the transport-level
    outcome the prober's miss counter feeds on."""

    def __init__(self, endpoint: str, error: BaseException):
        self.endpoint = endpoint
        self.error = error
        super().__init__(f"{endpoint}: {type(error).__name__}: {error}")


class PodHTTPError(RuntimeError):
    """A non-2xx pod answer; carries status, parsed body, and the 429
    ``retry_after`` hint so the broker can relay honest backpressure."""

    def __init__(self, status: int, body):
        self.status = status
        self.body = body
        self.retry_after = None
        if isinstance(body, dict):
            self.retry_after = body.get("retry_after")
        super().__init__(f"HTTP {status}: {body}")


def backoff_delay(
    attempt: int,
    backoff_seconds: float,
    backoff_max_seconds: float,
) -> float:
    """The controller's retry-policy shape as one pure function: delay before
    retry ``attempt`` (1-based), exponential from ``backoff_seconds``
    and capped — shared by this client and ``tools/gol_client.py``'s
    429 loop so every wire retry schedule in the system is the same
    deterministic curve."""
    if attempt < 1 or backoff_seconds <= 0:
        return 0.0
    return min(backoff_seconds * (2 ** (attempt - 1)), backoff_max_seconds)


class PodClient:
    """One pod gateway, as a bounded-time object.

    ``timeout`` is the per-request socket budget for control calls;
    ``probe_timeout`` (defaults to ``timeout``) is the tighter budget
    :meth:`health` uses — probe liveness questions deserve probe-sized
    patience.  ``attempts``/``backoff_seconds``/``backoff_max_seconds``
    are the transport retry policy (attempts=1 disables retries, the
    prober's setting: one miss is one datum)."""

    def __init__(
        self,
        base_url: str,
        timeout: float = 30.0,
        probe_timeout: float | None = None,
        attempts: int = 1,
        backoff_seconds: float = 0.05,
        backoff_max_seconds: float = 1.0,
        connect_timeout: float | None = None,
        response_cap: int = DEFAULT_RESPONSE_CAP,
    ):
        split = urlsplit(base_url if "//" in base_url else f"//{base_url}")
        self.host = split.hostname or "127.0.0.1"
        self.port = split.port or 80
        self.base_url = f"http://{self.host}:{self.port}"
        self.timeout = timeout
        self.probe_timeout = probe_timeout if probe_timeout else timeout
        self.attempts = max(1, attempts)
        self.backoff_seconds = backoff_seconds
        self.backoff_max_seconds = backoff_max_seconds
        # Split budgets: TCP connect gets its own (usually
        # tighter) deadline — a blackholed address should fail in
        # connect_timeout, not eat the whole read budget.  Default:
        # min(read budget, 10 s).
        self.connect_timeout = (
            float(connect_timeout)
            if connect_timeout is not None
            else min(timeout, 10.0)
        )
        self.response_cap = int(response_cap)

    def __repr__(self) -> str:
        return f"PodClient({self.base_url})"

    # -- transport -------------------------------------------------------------
    def _once(
        self,
        method: str,
        path: str,
        body: dict | None,
        headers: dict | None,
        timeout: float,
    ):
        # Connect under its own deadline, then widen to the read
        # budget for the request/response exchange (the split-timeout
        # discipline: a blackholed pod fails fast, a slow answer gets
        # its full read budget).
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=min(self.connect_timeout, timeout)
        )
        try:
            conn.connect()
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            payload = json.dumps(body).encode() if body is not None else None
            send_headers = dict(headers or {})
            if payload:
                send_headers["Content-Type"] = "application/json"
            conn.request(method, path, body=payload, headers=send_headers)
            resp = conn.getresponse()
            cap = self.response_cap
            declared = int(resp.headers.get("Content-Length") or 0)
            if declared > cap:
                raise PodHTTPError(
                    resp.status,
                    {
                        "error": f"response of {declared} bytes exceeds "
                        f"the {cap}-byte cap"
                    },
                )
            raw = resp.read(cap + 1)
            if len(raw) > cap:
                raise PodHTTPError(
                    resp.status,
                    {"error": f"response exceeds the {cap}-byte cap"},
                )
            try:
                doc = json.loads(raw) if raw else {}
            except ValueError:
                doc = {"raw": raw.decode(errors="replace")}
            if resp.status >= 400:
                raise PodHTTPError(resp.status, doc)
            return doc
        finally:
            conn.close()

    def request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        headers: dict | None = None,
        timeout: float | None = None,
    ):
        """One bounded-time request with the deterministic transport
        retry ladder.  HTTP errors pass straight through (a pod that
        ANSWERED is reachable); only transport failures are retried."""
        budget = self.timeout if timeout is None else timeout
        last: BaseException | None = None
        for attempt in range(1, self.attempts + 1):
            try:
                return self._once(method, path, body, headers, budget)
            except PodHTTPError:
                raise
            except (OSError, http.client.HTTPException) as e:
                last = e
                if attempt < self.attempts:
                    time.sleep(
                        backoff_delay(
                            attempt,
                            self.backoff_seconds,
                            self.backoff_max_seconds,
                        )
                    )
        raise PodUnreachable(self.base_url, last)

    # -- the gateway verbs the broker needs ------------------------------------
    def health(self) -> dict:
        """``GET /healthz`` under the probe budget.  A 503 body that
        still carries the health dict is an ANSWER (not-ready-but-live
        pods report through it); anything else re-raises."""
        try:
            return self.request(
                "GET", "/healthz", timeout=self.probe_timeout
            )
        except PodHTTPError as e:
            if isinstance(e.body, dict) and "ready" in e.body:
                return e.body
            raise

    def submit(
        self,
        doc: dict,
        traceparent: str | None = None,
        idempotency_key: str | None = None,
    ) -> dict:
        """``POST /v1/sessions`` — the spec doc verbatim (the broker
        forwards what the client sent; ``serve/wire.py`` on the pod is
        the single schema authority).  ``traceparent`` rides as the W3C
        header so the pod joins the broker's trace.

        One ``X-Gol-Idempotency-Key`` is minted per *call* (not per
        attempt), so the internal transport-retry ladder — exactly the
        path a response that died mid-body takes — replays the stored
        receipt instead of double-placing the tenant.  Pass
        ``idempotency_key`` to span retries ABOVE this call (the
        broker's spill-and-retry)."""
        headers = {IDEMPOTENCY_HEADER: idempotency_key or uuid.uuid4().hex}
        if traceparent:
            headers["traceparent"] = traceparent
        return self.request("POST", "/v1/sessions", doc, headers=headers)

    def sessions(self) -> dict:
        return self.request("GET", "/v1/sessions")

    def state(self, tenant: str) -> dict:
        return self.request("GET", f"/v1/sessions/{tenant}/state")

    def control(self, tenant: str, action: str) -> dict:
        """``POST /v1/sessions/<t>/pause|resume|quit``."""
        return self.request("POST", f"/v1/sessions/{tenant}/{action}")

    def drain(self, timeout: float | None = None) -> dict:
        """``POST /v1/drain`` — returns the parked-resumable receipt the
        migration path readopts from.  The socket budget stretches to
        cover the drain itself."""
        path = "/v1/drain"
        if timeout is not None:
            path += f"?timeout={timeout:g}"
        budget = self.timeout + (timeout or 0.0)
        return self.request("POST", path, timeout=budget)


__all__ = [
    "DEFAULT_RESPONSE_CAP",
    "IDEMPOTENCY_HEADER",
    "PodClient",
    "PodHTTPError",
    "PodUnreachable",
    "backoff_delay",
]
