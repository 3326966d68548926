"""Request-scoped tracing: trace IDs from the wire to the
kernel launch.

The telemetry plane answers "how is the pod doing" with
aggregate p99s and burn rates; this module answers "why was THIS request
slow": an **always-on, bounded, lock-cheap host-side span store** that
follows one request across every layer it crosses — gateway HTTP
handling, the admission ladder (queue-wait as a span), ``ServePlane``
session start, the controller's dispatch issue/resolve (the existing
``obs.spans`` call sites feed BOTH the ``torch.profiler`` annotation and
this store), cohort-batched launches, supervisor restarts, checkpoint
saves, and FramePlane publish → WebSocket spectator send.

Design constraints:

- **Lock-cheap.**  The hot-path question "is a trace active here?" is
  one ``contextvars.ContextVar`` read; with no active trace every helper
  is a no-op returning a shared nullcontext.  Recording a span is a
  monotonic-ns read plus a bounded ``list.append`` — no locks on the
  dispatch path (span interleavings across threads are tolerated; each
  record is atomic under the GIL).
- **Bounded.**  A trace retains at most ``max_spans`` spans (the FIRST
  N — a request timeline's interesting part is its head: admission,
  first dispatch, first frame; later spans are counted in
  ``dropped_spans``), plus a small always-retained event ring for the
  records that must never be evicted (watchdog fires, restarts).  The
  store holds a bounded ring of finished traces and a bounded map of
  active ones.
- **Head-sampled, tail-retained.**  The retention decision is made at
  trace START (``sample_rate``, deterministic in the trace id, so tests
  and multi-process pods agree) — but ANY trace that was ``flag()``-ed
  (terminal failure, watchdog fire, supervisor restart) is retained at
  end regardless: error traces are never lost.  Unretained traces cost
  their bounded in-flight buffer and nothing else.

**Propagation** is W3C Trace Context: the gateway accepts an inbound
``traceparent`` header (an inbound sampled flag forces retention — the
caller asked), answers every traced response with ``X-Gol-Trace-Id`` +
``traceparent``, and stamps the id into flight records, the terminal
``MetricsReport``, and gateway receipts.  In-process, the active trace
rides a context variable (``activate``/``current``) so deep layers need
no plumbing — ``obs.spans.span`` call sites attach automatically.

**Export**: ``/traces`` on the telemetry server AND the gateway serves
:func:`http_traces` (recent retained traces, or one by id);
``tools/trace_export.py`` renders any trace to Chrome Trace Event JSON
loadable in Perfetto.  Schema ``gol-trace-v1``::

    {"schema": "gol-trace-v1", "trace_id": <32-hex>, "name": "gol.request",
     "tenant": ..., "sampled": bool, "flagged": <reason or None>,
     "status": "ok|completed|parked|failed|...", "error": ...,
     "t0_unix": <seconds>, "duration_ns": ...,
     "spans": [{"span_id", "parent_id", "name", "t0_ns", "dur_ns",
                "labels": {...}}, ...],            # t0_ns relative to trace start
     "events": [...],                              # always-retained instants
     "marks": {"first_dispatch": <ns>, ...},       # SLI first-occurrence marks
     "dropped_spans": 0}
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Mapping, Sequence

from distributed_gol_torch.obs import metrics as metrics_lib

SCHEMA = "gol-trace-v1"

#: The one nullcontext every inactive-path helper returns.
NULL_CM = contextlib.nullcontext()

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def parse_traceparent(header: str | None):
    """``(trace_id, parent_span_id, sampled)`` from a W3C ``traceparent``
    header, or None when absent/malformed (a bad header must never fail
    the request — the trace just starts fresh)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m or m.group(2) == "0" * 32 or m.group(3) == "0" * 16:
        return None
    return m.group(2), m.group(3), bool(int(m.group(4), 16) & 1)


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def new_trace_id() -> str:
    return os.urandom(16).hex()


def clock_ns() -> int:
    """The store's clock (monotonic ns) — callers building explicit
    spans (``record_span``) sample it so their timestamps share the
    traces' timeline."""
    return time.monotonic_ns()


def head_sampled(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling decision: a pure function of the
    trace id, so every process of a pod (and every test) agrees."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) / 0xFFFFFFFF < rate


class _Ctx:
    __slots__ = ("trace", "span_id")

    def __init__(self, trace: "Trace", span_id: str):
        self.trace = trace
        self.span_id = span_id


_ACTIVE: ContextVar[_Ctx | None] = ContextVar("gol_trace_ctx", default=None)


class _SpanCtx:
    """One in-flight span: parent resolved from the context at entry,
    children nest under it while it is open."""

    __slots__ = ("_trace", "_name", "_labels", "_t0", "_id", "_parent", "_token")

    def __init__(self, trace: "Trace", name: str, labels: dict):
        self._trace = trace
        self._name = name
        self._labels = labels

    def __enter__(self):
        trace = self._trace
        ctx = _ACTIVE.get()
        self._parent = (
            ctx.span_id if ctx is not None and ctx.trace is trace else trace.root_id
        )
        self._id = trace._next_id()
        self._t0 = time.monotonic_ns()
        self._token = _ACTIVE.set(_Ctx(trace, self._id))
        return self

    def __exit__(self, exc_type, exc, tb):
        _ACTIVE.reset(self._token)
        labels = self._labels
        if exc_type is not None:
            labels = dict(labels, error=exc_type.__name__)
        self._trace._append(
            self._name, self._id, self._parent, self._t0,
            time.monotonic_ns(), labels,
        )
        return False


class Trace:
    """One request's causal timeline.  Construct via
    :meth:`Tracer.start_trace`; record with :meth:`span` (context
    manager, nests via the active context), :meth:`record_span`
    (explicit timestamps — the queue-wait / cohort-launch spelling), and
    :meth:`add_event` (always-retained instants).  ``mark(name)``
    returns elapsed seconds on the FIRST call per name (None after) —
    the SLI first-occurrence hook (time-to-first-dispatch/-frame)."""

    _MAX_EVENTS = 32

    def __init__(
        self,
        trace_id: str,
        name: str = "gol.request",
        tenant: str | None = None,
        sampled: bool = True,
        parent_span_id: str | None = None,
        max_spans: int = 512,
    ):
        self.trace_id = trace_id
        self.name = name
        self.tenant = tenant
        self.sampled = sampled
        self.parent_span_id = parent_span_id  # the remote caller's span
        self.flagged: str | None = None
        self.status = "active"
        self.error: str | None = None
        self.ended = False
        self.t0_unix = time.time()
        self.t0_ns = time.monotonic_ns()
        self.duration_ns: int | None = None
        self.max_spans = max_spans
        self.dropped = 0
        self._seq = itertools.count(2)
        self.root_id = f"{1:016x}"
        self._spans: list[dict] = []
        self._events: deque[dict] = deque(maxlen=self._MAX_EVENTS)
        self._marks: dict[str, int] = {}
        self._marks_lock = threading.Lock()

    @property
    def short_id(self) -> str:
        """The 8-hex prefix stamped on flight-ring records (the full id
        rides the dump header)."""
        return self.trace_id[:8]

    def _next_id(self) -> str:
        return f"{next(self._seq):016x}"

    def _append(self, name, span_id, parent_id, t0_ns, t1_ns, labels) -> None:
        if self.ended:
            return
        if len(self._spans) >= self.max_spans:
            # Bounded by keeping the HEAD of the timeline (admission,
            # first dispatches, first frames — what a request postmortem
            # reads); the tail is counted, and always-retained events
            # (add_event) have their own ring.
            self.dropped += 1
            return
        self._spans.append(
            {
                "span_id": span_id,
                "parent_id": parent_id,
                "name": name,
                "t0_ns": t0_ns - self.t0_ns,
                "dur_ns": max(0, t1_ns - t0_ns),
                "labels": labels,
            }
        )

    # -- recording -------------------------------------------------------------
    def span(self, name: str, **labels) -> _SpanCtx:
        return _SpanCtx(self, name, labels)

    def record_span(
        self,
        name: str,
        t0_ns: int,
        t1_ns: int,
        parent_id: str | None = None,
        **labels,
    ) -> None:
        """A span with explicit :func:`clock_ns` timestamps — for spans
        whose start predates the code that records them (queue wait) or
        that are recorded into ANOTHER request's trace (the cohort
        batcher linking member traces)."""
        self._append(
            name,
            self._next_id(),
            parent_id or self.root_id,
            t0_ns,
            t1_ns,
            labels,
        )

    def add_event(self, name: str, **labels) -> None:
        """An always-retained instant (watchdog fire, restart, first
        spectator send): lands in the bounded event ring, never evicted
        by the span cap."""
        if self.ended:
            return
        self._events.append(
            {
                "name": name,
                "t_ns": time.monotonic_ns() - self.t0_ns,
                "labels": labels,
            }
        )

    def flag(self, reason: str) -> None:
        """Force tail retention: this trace is kept at end even when
        head sampling dropped it (failure/watchdog-fire/restart traces
        are never lost).  First reason wins."""
        if self.flagged is None:
            self.flagged = reason

    def mark(self, name: str) -> float | None:
        """First-occurrence mark: elapsed seconds since the request
        started, returned exactly once per name (None afterwards) — the
        SLI observation hook."""
        with self._marks_lock:
            if name in self._marks:
                return None
            dt = time.monotonic_ns() - self.t0_ns
            self._marks[name] = dt
            return dt / 1e9

    # -- export ----------------------------------------------------------------
    def to_dict(self) -> dict:
        dur = self.duration_ns
        if dur is None:
            dur = time.monotonic_ns() - self.t0_ns
        return {
            "schema": SCHEMA,
            "trace_id": self.trace_id,
            "name": self.name,
            "tenant": self.tenant,
            "sampled": self.sampled,
            "flagged": self.flagged,
            "status": self.status,
            "error": self.error,
            "parent_span_id": self.parent_span_id,
            "root_span_id": self.root_id,
            "t0_unix": round(self.t0_unix, 6),
            "duration_ns": int(dur),
            "spans": list(self._spans),
            "events": list(self._events),
            "marks": dict(self._marks),
            "dropped_spans": self.dropped,
        }

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.root_id, self.sampled)


class Tracer:
    """The process-wide store (:data:`TRACER`): a bounded map of active
    traces, a bounded ring of finished (retained) trace dicts, and the
    tenant binding the cohort batcher / gateway headers look up.
    ``configure`` is how ``ServeConfig`` applies its knobs."""

    _MAX_ACTIVE = 1024

    def __init__(
        self,
        sample_rate: float = 1.0,
        ring_depth: int = 256,
        max_spans: int = 512,
    ):
        self.sample_rate = sample_rate
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._active: dict[str, Trace] = {}
        self._by_tenant: dict[str, Trace] = {}
        self._finished: deque[dict] = deque(maxlen=max(1, ring_depth))
        reg = metrics_lib.REGISTRY
        self._c_started = reg.counter("traces.started")
        self._c_retained = reg.counter("traces.retained")
        self._c_dropped = reg.counter("traces.dropped")
        self._c_tail = reg.counter("traces.tail_retained")

    def configure(
        self,
        sample_rate: float | None = None,
        ring_depth: int | None = None,
        max_spans: int | None = None,
    ) -> "Tracer":
        with self._lock:
            if sample_rate is not None:
                self.sample_rate = sample_rate
            if max_spans is not None:
                self.max_spans = max_spans
            if ring_depth is not None and ring_depth != self._finished.maxlen:
                self._finished = deque(
                    self._finished, maxlen=max(1, ring_depth)
                )
        return self

    # -- lifecycle -------------------------------------------------------------
    def start_trace(
        self,
        name: str = "gol.request",
        traceparent: str | None = None,
        tenant: str | None = None,
        sampled: bool | None = None,
    ) -> Trace:
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_id, remote_sampled = parsed
        else:
            trace_id, parent_id, remote_sampled = new_trace_id(), None, False
        if sampled is None:
            # An inbound sampled flag forces retention (the caller asked
            # to see this trace); otherwise head-sample at the rate.
            sampled = remote_sampled or head_sampled(trace_id, self.sample_rate)
        trace = Trace(
            trace_id,
            name=name,
            tenant=tenant,
            sampled=sampled,
            parent_span_id=parent_id,
            max_spans=self.max_spans,
        )
        self._c_started.inc()
        with self._lock:
            self._active[trace_id] = trace
            while len(self._active) > self._MAX_ACTIVE:
                # A leaked/never-ended trace must not grow the store:
                # evict oldest-started as dropped.
                old_id = next(iter(self._active))
                old = self._active.pop(old_id)
                old.ended = True
                self._c_dropped.inc()
            if tenant is not None:
                self._by_tenant[tenant] = trace
        return trace

    def end_trace(
        self, trace: Trace, status: str = "ok", error: str | None = None
    ) -> None:
        """Finalize + apply the retention policy (idempotent).  The root
        span (the whole-request bar every export anchors on) is appended
        here, covering start→end."""
        with self._lock:
            self._active.pop(trace.trace_id, None)
            if trace.ended:
                return
            trace.ended = True
        trace.status = status
        if error is not None:
            trace.error = str(error)[:500]
        now = time.monotonic_ns()
        trace.duration_ns = now - trace.t0_ns
        trace._spans.append(
            {
                "span_id": trace.root_id,
                "parent_id": trace.parent_span_id,
                "name": trace.name,
                "t0_ns": 0,
                "dur_ns": trace.duration_ns,
                "labels": {"tenant": trace.tenant, "status": status},
            }
        )
        if trace.sampled or trace.flagged is not None:
            if trace.flagged is not None and not trace.sampled:
                self._c_tail.inc()
            self._c_retained.inc()
            with self._lock:
                self._finished.append(trace.to_dict())
        else:
            self._c_dropped.inc()

    # -- tenant binding (the batcher/gateway lookup) ---------------------------
    def bind_tenant(self, tenant: str, trace: Trace) -> None:
        """Latest submission wins — the lookup the cohort batcher and
        the gateway's response headers use."""
        with self._lock:
            self._by_tenant[tenant] = trace

    def for_tenant(self, tenant: str) -> Trace | None:
        """The tenant's CURRENT trace (latest submission wins); ended
        traces still resolve (the gateway's state/control responses
        stamp the id after the run finished)."""
        with self._lock:
            return self._by_tenant.get(tenant)

    def unbind_tenant(self, tenant: str) -> None:
        """The serving plane's eviction hook — rides beside
        ``MetricsRegistry.clear_tenant`` so a churning-tenant pod's
        binding map stays bounded."""
        with self._lock:
            self._by_tenant.pop(tenant, None)

    # -- queries (the /traces surface) -----------------------------------------
    def recent(self, limit: int = 32, tenant: str | None = None) -> list[dict]:
        """Retained traces, newest first."""
        with self._lock:
            docs = list(self._finished)
        if tenant is not None:
            docs = [d for d in docs if d.get("tenant") == tenant]
        return list(reversed(docs))[: max(0, limit)]

    def lookup(self, trace_id: str) -> dict | None:
        """One trace by id (or unique prefix): finished first, then a
        live snapshot of an active trace."""
        with self._lock:
            docs = list(self._finished)
            active = list(self._active.values())
        hits = [d for d in docs if d["trace_id"].startswith(trace_id)]
        if hits:
            return hits[-1]
        live = [t for t in active if t.trace_id.startswith(trace_id)]
        if live:
            return live[-1].to_dict()
        return None

    def lookup_all(self, trace_id: str) -> list[dict]:
        """EVERY leg this process retains for an id (or prefix):
        finished docs plus live snapshots.  One process can hold
        several legs of one trace — a broker's request leg already
        ended while a relay's subscribe leg on the same id is still
        open — and ``lookup`` returns only one of them (finished
        first, shadowing the live leg).  The fleet stitcher wants
        them all."""
        with self._lock:
            docs = list(self._finished)
            active = list(self._active.values())
        out = [d for d in docs if d["trace_id"].startswith(trace_id)]
        out.extend(
            t.to_dict() for t in active if t.trace_id.startswith(trace_id)
        )
        return out

    def clear(self) -> None:
        """Drop all state (tests)."""
        with self._lock:
            self._active.clear()
            self._by_tenant.clear()
            self._finished.clear()


#: The process-wide store every layer records into.
TRACER = Tracer()


# -- the context-variable face (zero-plumbing deep layers) ---------------------

def current() -> Trace | None:
    """The trace active on this thread's context, or None."""
    ctx = _ACTIVE.get()
    return ctx.trace if ctx is not None else None


class _ActivateCtx:
    __slots__ = ("_trace", "_token")

    def __init__(self, trace: Trace):
        self._trace = trace

    def __enter__(self):
        self._token = _ACTIVE.set(_Ctx(self._trace, self._trace.root_id))
        return self._trace

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return False


def activate(trace: Trace | None):
    """Bind ``trace`` as this context's active trace (None = no-op
    nullcontext): everything the controller/supervisor records through
    ``obs.spans`` / the module helpers below attaches to it, with no
    parameter threading."""
    if trace is None:
        return NULL_CM
    return _ActivateCtx(trace)


def span(name: str, **labels):
    """A span on the ACTIVE trace (shared nullcontext when none — one
    ContextVar read on the inactive path)."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return NULL_CM
    return ctx.trace.span(name, **labels)


def add_event(name: str, **labels) -> None:
    ctx = _ACTIVE.get()
    if ctx is not None:
        ctx.trace.add_event(name, **labels)


def flag(reason: str) -> None:
    """Tail-retain the active trace (no-op when none)."""
    ctx = _ACTIVE.get()
    if ctx is not None:
        ctx.trace.flag(reason)


def current_trace_id() -> str | None:
    ctx = _ACTIVE.get()
    return ctx.trace.trace_id if ctx is not None else None


# -- the /traces HTTP payload (shared by telemetry + gateway servers) ----------

def http_traces(query: dict) -> tuple[int, dict]:
    """``GET /traces`` handler body: ``?trace_id=`` (full or prefix) for
    one trace, else the recent retained ring (``?tenant=`` filter,
    ``?limit=``, default 32).  Pure in-memory reads — the bounded-time
    endpoint contract."""
    trace_id = query.get("trace_id")
    if trace_id:
        if query.get("all"):
            # Every retained leg of the id (the fleet stitcher's form):
            # a process serving both a finished request leg and a live
            # relay leg on one id returns BOTH.
            docs = TRACER.lookup_all(trace_id)
            if not docs:
                return 404, {"error": f"no retained trace {trace_id!r}"}
            return 200, {"schema": "gol-traces-v1", "traces": docs}
        doc = TRACER.lookup(trace_id)
        if doc is None:
            return 404, {"error": f"no retained trace {trace_id!r}"}
        return 200, doc
    try:
        limit = int(query.get("limit", 32))
    except ValueError:
        return 400, {"error": "bad limit"}
    return 200, {
        "schema": "gol-traces-v1",
        "traces": TRACER.recent(limit, tenant=query.get("tenant")),
    }


# -- cross-process stitching (the fleet plane) -----------------------

FLEET_SCHEMA = "gol-fleet-trace-v1"


def stitch_traces(node_docs: Mapping[str, Sequence[dict]]) -> dict | None:
    """Merge per-process ``gol-trace-v1`` docs sharing ONE trace id into
    a single ``gol-fleet-trace-v1`` timeline: ``{node: [docs]}`` (as the
    fleet collector's ``/traces?trace_id=`` fan-out returns them) →
    one span forest whose every span/event carries a ``node`` stamp and
    a ``t0_ns`` re-based onto the EARLIEST process's clock.

    Alignment is by wall clock: each doc's ``t0_unix`` is its monotonic
    origin's wall time, so ``offset_ns = (t0_unix - min_t0_unix)*1e9``
    places its relative span times on the shared axis (good to NTP skew
    — microseconds locally, the only cross-process clock there is).
    Span ids are process-local (every trace roots at span 1), so span
    ids and parent links are namespaced ``node:span_id`` in the merged
    forest.  Pure function; returns None when no node had the trace."""
    docs = [
        (node, doc)
        for node, ds in node_docs.items()
        for doc in (ds or ())
        if doc and doc.get("trace_id")
    ]
    if not docs:
        return None
    trace_id = docs[0][1]["trace_id"]
    base = min(float(d.get("t0_unix", 0.0)) for _, d in docs)
    spans: list[dict] = []
    events: list[dict] = []
    nodes: dict[str, dict] = {}
    tenant = None
    flagged = None
    end_ns = 0
    for node, d in sorted(docs, key=lambda nd: float(nd[1].get("t0_unix", 0.0))):
        off = round((float(d.get("t0_unix", 0.0)) - base) * 1e9)
        info = nodes.setdefault(
            node,
            {"traces": 0, "names": [], "t0_unix": d.get("t0_unix")},
        )
        info["traces"] += 1
        if d.get("name") not in info["names"]:
            info["names"].append(d.get("name"))
        if tenant is None:
            tenant = d.get("tenant")
        if flagged is None:
            flagged = d.get("flagged")
        for s in d.get("spans", ()):
            t0 = int(s.get("t0_ns", 0)) + off
            spans.append(
                {
                    **s,
                    "node": node,
                    "t0_ns": t0,
                    "span_id": f"{node}:{s.get('span_id')}",
                    "parent_id": (
                        f"{node}:{s['parent_id']}"
                        if s.get("parent_id") is not None
                        else None
                    ),
                }
            )
            end_ns = max(end_ns, t0 + int(s.get("dur_ns", 0)))
        for e in d.get("events", ()):
            t = int(e.get("t_ns", 0)) + off
            events.append({**e, "node": node, "t_ns": t})
            end_ns = max(end_ns, t)
    spans.sort(key=lambda s: s["t0_ns"])
    events.sort(key=lambda e: e["t_ns"])
    return {
        "schema": FLEET_SCHEMA,
        "trace_id": trace_id,
        "tenant": tenant,
        "flagged": flagged,
        "t0_unix": round(base, 6),
        "duration_ns": end_ns,
        "nodes": nodes,
        "spans": spans,
        "events": events,
    }


__all__ = [
    "FLEET_SCHEMA",
    "SCHEMA",
    "TRACER",
    "Trace",
    "Tracer",
    "activate",
    "add_event",
    "clock_ns",
    "current",
    "current_trace_id",
    "flag",
    "format_traceparent",
    "head_sampled",
    "http_traces",
    "new_trace_id",
    "parse_traceparent",
    "span",
    "stitch_traces",
]
