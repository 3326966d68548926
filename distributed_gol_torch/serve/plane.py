"""The fault-isolated multi-tenant serving plane.

Copy of ``distributed_gol_tpu/serve/plane.py`` on the port's engine.
:class:`ServePlane` is one pod process multiplexing N independent
sessions — each with its own board, :class:`~distributed_gol_torch.engine.
params.Params`, scoped checkpoint directory, and event stream — with
robustness as the headline contract:

- **Admission control + backpressure** (``serve/admission.py``): a
  capacity budget with bounded queues and explicit load-shedding
  (:class:`AdmissionRejected` with a retry-after hint — never an
  unbounded queue, never an OOM), plus per-session deadlines that
  propagate into the dispatch watchdog
  (``Params.dispatch_deadline_seconds``).
- **Per-session fault isolation**: every session runs under its own
  controller on its own worker; one tenant's terminal ``DispatchError``
  parks *that* session (checkpoint + flight record in its scoped
  directory) while every other tenant keeps dispatching — no
  cross-tenant abort, no pod exit.
- **Graceful pod drain**: SIGTERM (``install``) stops admissions, sheds
  the waiting queue, routes the ``GracefulStop`` latch into every
  resident session — each emergency-checkpoints through the controller's
  ``_checkpoint_now`` path (fsync-durable) and exits
  paused-and-resumable — and the pod exits cleanly; a restarted pod
  re-adopts every tenant via the ``Session.check_states`` scan.
- **Health surface** (:meth:`ServePlane.health`): readiness/liveness
  derived from the obs registry (watchdog fires, queue depths,
  per-tenant ``tenant=`` metric labels) so an external balancer can
  eject a sick pod.
- **Batched cohorts** (``ServeConfig.batched``): same-key resident
  sessions share one :class:`~distributed_gol_torch.engine.backend.
  BatchedBackend` launch per superstep (``serve/batcher.py``).

Concurrency shape: an asyncio loop (one daemon thread) owns session
lifecycle — admission hand-off, slot scheduling, completion — while the
blocking controller runs execute on a bounded executor
(``max_sessions`` workers).  The public API is thread-safe and
synchronous (``submit``/``drain``/``health``).  A session with
``Params.restart_limit > 0`` runs under the supervisor
(``engine/supervisor.py``), which rebuilds its backend through the
plane's ``backend_factory``.  The network gateway
(``serve/gateway.py``) and the spectator ``frame_plane`` fan-out
(``serve/frames.py``) drive resident sessions through ``submit``'s
``keys`` and ``frame_plane``.
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path
from typing import Callable, Optional

from distributed_gol_torch.engine import gol
from distributed_gol_torch.engine.events import (
    CheckpointSaved,
    DispatchError,
    EventQueue,
    FinalTurnComplete,
    MetricsReport,
    TurnComplete,
    TurnsCompleted,
)
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.engine.session import Session
from distributed_gol_torch.engine.supervisor import GracefulStop
from distributed_gol_torch.obs import flight as flight_lib
from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import tracing
from distributed_gol_torch.obs.slo import SLOTracker
from distributed_gol_torch.obs.timeseries import TelemetrySampler
from distributed_gol_torch.parallel import mesh as mesh_lib
from distributed_gol_torch.serve.admission import (
    ADMIT_RUN,
    AdmissionController,
    AdmissionRejected,
    ServeConfig,
)

#: Handle lifecycle: ``queued`` → ``running`` → one terminal state.
TERMINAL_STATES = ("completed", "parked", "drained", "failed", "shed")


class SessionHandle:
    """One tenant's run through the plane: identity, live status, the
    event stream, and the terminal digest.

    ``events`` is the session's own stream (the per-tenant analog of the
    reference's one events channel).  When the submitter brought a queue
    it owns draining it (the plane only TEES the producer side through
    the digest — see :class:`_DigestTee`); otherwise the stream reduces
    inline to the digest at the producer and retains nothing
    (:class:`_DigestSink`).  Either way the **digest** fields (``final``,
    ``report``, ``errors``, ``checkpoint_turns``, ``last_turn``) are
    populated — they are what the drain receipt and terminal
    classification read — and bounded, so a session's events can never
    grow the pod's memory.  The stream is guaranteed to end with the
    ``None`` sentinel (possibly one extra trailing sentinel on
    plane-terminated paths — consumers stop at the first, so it is
    invisible to the standard drain loop)."""

    # Caps on retained digest entries — a postmortem tail, not an
    # unbounded log (the digest's whole point is O(1) memory/session):
    # first 32 DispatchErrors, last 32 checkpoint turns.
    _MAX_ERRORS = 32
    _MAX_CHECKPOINTS = 32

    def __init__(
        self,
        tenant: str,
        params: Params,
        session: Session,
        events: queue.Queue,
        owns_events: bool,
    ):
        self.tenant = tenant
        self.params = params
        self.session = session
        self.events = events
        #: Optional control/streaming seams: a keyboard-
        #: equivalent key queue routed into the controller (the wire
        #: gateway's pause/resume/quit leg) and a FramePlane the run
        #: publishes every rendered turn to (the spectator leg).
        self.keys: queue.Queue | None = None
        self.frame_plane = None
        #: The request trace: created (or accepted from the
        #: gateway's ``traceparent`` handling) at submit, activated on
        #: the worker context for the whole run, ended at terminal
        #: classification.  Always present on plane-submitted sessions.
        self.trace = None
        self._submit_ns = 0  # tracing clock at submit (queue-wait span)
        self._h_qwait = None  # the tenant's queue-wait SLI histogram
        self.stop = GracefulStop()
        self.status = "queued"
        #: The admission verdict at submit time ("run" = a slot was
        #: free, "queue" = parked in the bounded wait queue) — stable,
        #: unlike ``status``, which advances as the session runs.
        self.admitted_as = "run"
        self.error: str | None = None
        #: Whether a fresh run on this tenant's session would resume
        #: (a paused checkpoint is parked) — truthful in every terminal
        #: state, including ``failed``.
        self.resumable = False
        self.t_submit = time.perf_counter()
        self.t_start: float | None = None
        self.t_end: float | None = None
        # -- digest (populated only when the plane owns the stream) --
        self.final: FinalTurnComplete | None = None
        self.report: MetricsReport | None = None
        self.errors: list[DispatchError] = []
        self.checkpoint_turns: deque[int] = deque(maxlen=self._MAX_CHECKPOINTS)
        self.last_turn = 0
        self._owns_events = owns_events
        self._done = threading.Event()
        self._backend = None
        self._backend_factory = None

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATES

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the session reaches a terminal state."""
        return self._done.wait(timeout)

    @property
    def duration(self) -> float | None:
        """Running wall-clock (start → terminal), excluding queue wait."""
        if self.t_start is None or self.t_end is None:
            return None
        return self.t_end - self.t_start

    def _finish(self, status: str, error: str | None = None) -> None:
        self.status = status
        if error is not None:
            self.error = error
        if self.t_end is None and self.t_start is not None:
            self.t_end = time.perf_counter()
        self.resumable = self.session.paused
        # A caller-owned stream never fed the digest, so ``last_turn``
        # would read 0 however far the run got — the parked checkpoint's
        # turn is the progress oracle the drain receipt needs.
        parked = self.session.parked_turn
        if parked is not None:
            self.last_turn = max(self.last_turn, parked)
        self._done.set()

    def _digest(self, event) -> None:
        if isinstance(event, (TurnComplete, TurnsCompleted)):
            self.last_turn = event.completed_turns
        elif isinstance(event, FinalTurnComplete):
            self.final = event
            self.last_turn = event.completed_turns
        elif isinstance(event, MetricsReport):
            self.report = event
        elif isinstance(event, DispatchError):
            if len(self.errors) < self._MAX_ERRORS:
                self.errors.append(event)
        elif isinstance(event, CheckpointSaved):
            self.checkpoint_turns.append(event.completed_turns)

    def __repr__(self) -> str:
        return (
            f"SessionHandle(tenant={self.tenant!r}, status={self.status!r}, "
            f"turn={self.last_turn}, resumable={self.resumable})"
        )


class _DigestSink(EventQueue):
    """The PLANE-owned event stream: events digest inline at the
    producer and are retained nowhere — the bounded digest is the only
    consumer of an unwatched stream, so no drain thread (and no wakeup
    per event per session) is needed.  Subclasses :class:`EventQueue` so
    the controller keeps its one-entry ``put_turns`` batching; a
    caller-supplied queue still gets the :class:`_DigestTee` treatment
    (every event forwarded)."""

    def __init__(self, handle: SessionHandle):
        super().__init__()
        self._handle = handle

    def put(self, item, block: bool = True, timeout: float | None = None):
        if item is None:
            # The terminal sentinel IS retained: a consumer waiting on a
            # plane-owned stream (the shed-queue contract promises them
            # a terminated stream) still observes the end.
            super().put(item, block, timeout)
        else:
            self._handle._digest(item)

    def put_turns(self, first: int, last: int) -> None:
        if last >= first:
            self._handle.last_turn = last


class _DigestTee(EventQueue):
    """Producer-side wrapper around a CALLER-owned event queue: digests
    every event into the handle, then forwards it to the caller's queue
    untouched — the drain receipt and terminal classification see the
    run's progress without the plane consuming a stream it does not own.

    Subclasses :class:`EventQueue` so the controller keeps batching
    TurnComplete ranges (``put_turns``) when the caller's queue can
    expand them; a caller bringing a plain ``queue.Queue`` gets the
    per-event fallback, exactly as if it were handed to ``gol.run``
    directly.  Only the producer side is ever used (the caller reads
    their own queue object)."""

    def __init__(self, handle: SessionHandle, inner: queue.Queue):
        super().__init__()
        self._handle = handle
        self._inner = inner

    def put(self, item, block: bool = True, timeout: float | None = None):
        if item is not None:
            self._handle._digest(item)
        self._inner.put(item, block, timeout)

    def put_turns(self, first: int, last: int) -> None:
        if last >= first:
            self._handle.last_turn = last
        if isinstance(self._inner, EventQueue):
            self._inner.put_turns(first, last)
        else:
            for t in range(first, last + 1):
                self._inner.put(TurnComplete(t))

    def qsize(self) -> int:
        return self._inner.qsize()

    def empty(self) -> bool:
        return self._inner.empty()


class ServePlane:
    """The pod: N tenants, one backend process, robustness contracts as
    in the module doc.  Use as a context manager (``close`` drains)."""

    def __init__(
        self,
        config: ServeConfig | None = None,
        checkpoint_root: str | Path | None = None,
        metrics: bool = True,
    ):
        self.config = config if config is not None else ServeConfig()
        self._root = Path(checkpoint_root) if checkpoint_root else None
        self._lock = threading.Lock()
        self._state = threading.Condition(self._lock)
        self._admission = AdmissionController(self.config)
        # Batched dispatch cohorts: the coalescer that groups resident
        # same-key sessions into shared launches.  None = one solo launch
        # per session per superstep.
        self.batcher = None
        if self.config.batched:
            from distributed_gol_torch.serve.batcher import CohortBatcher

            self.batcher = CohortBatcher(self.config, metrics=metrics)
        self._handles: dict[str, SessionHandle] = {}  # latest per tenant
        # Pre-drain hooks: callables invoked at the top of
        # begin_drain, BEFORE admissions close and the queue sheds —
        # how the network gateway stops accepting wire submissions
        # before the pod starts refusing them (install() SIGTERM closes
        # the gateway first).  Hooks must be fast, non-blocking, and
        # idempotent (see add_drain_hook).
        self._drain_hooks: list[Callable[[], None]] = []
        # Terminal handles in completion order — the eviction ring that
        # keeps a churning-tenant pod's memory bounded (``_on_done``).
        self._retired: deque[tuple[str, SessionHandle]] = deque()
        self._closed = False
        # -- observability (the health surface's substrate) --
        self.metrics = metrics_lib.registry_for(metrics)
        self._metrics_start = self.metrics.snapshot(include_lazy=False)
        self._c_admitted = self.metrics.counter("serve.admitted")
        self._c_rejected = self.metrics.counter("serve.rejected")
        self._c_drains = self.metrics.counter("serve.drains")
        self._c_outcome = {
            s: self.metrics.counter(f"serve.sessions_{s}")
            for s in TERMINAL_STATES
        }
        self._g_resident = self.metrics.gauge("serve.resident_sessions")
        self._g_queued = self.metrics.gauge("serve.queued_sessions")
        self._g_cells = self.metrics.gauge("serve.resident_cells")
        self._g_resident.set(0)
        self._g_queued.set(0)
        self._g_cells.set(0)
        # -- continuous telemetry + SLOs --
        # The plane-level flight ring: SLO alert transitions land here
        # (``slo_alert``/``slo_resolved``), introspectable via
        # ``plane.flight.records()`` — distinct from the per-session
        # rings each controller dumps on ITS terminal path.
        self.flight = flight_lib.FlightRecorder(256 if metrics else 0)
        # Request-scoped tracing: the plane applies its
        # config's knobs to the process-wide store — sampling rate,
        # /traces ring depth, per-trace span cap.  (One store per
        # process; the last-constructed plane's config wins, like the
        # registry's process-wide instruments.)
        tracing.TRACER.configure(
            sample_rate=self.config.trace_sample_rate,
            ring_depth=self.config.trace_ring_depth,
            max_spans=self.config.trace_max_spans,
        )
        self.slo: SLOTracker | None = None
        objectives = self.config.slo_objectives()
        if metrics and objectives is not None:
            self.slo = SLOTracker(objectives, self.metrics, self.flight)
        self.sampler: TelemetrySampler | None = None
        if metrics and self.config.telemetry_sample_seconds > 0:
            self.sampler = TelemetrySampler(
                registry=self.metrics,
                interval=self.config.telemetry_sample_seconds,
                depth=self.config.telemetry_ring_depth,
                lazy_every=self.config.telemetry_lazy_every,
                on_sample=self._on_sample,
            ).start()
        # -- the asyncio control plane --
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, name="gol-serve-plane", daemon=True
        )
        self._loop_thread.start()
        self._executor = ThreadPoolExecutor(
            max_workers=self.config.max_sessions,
            thread_name_prefix="gol-serve-run",
        )

    # -- context manager -------------------------------------------------------
    def __enter__(self) -> "ServePlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission (leg 1) -----------------------------------------------------
    def submit(
        self,
        tenant: str,
        params: Params,
        events: queue.Queue | None = None,
        deadline_seconds: float | None = None,
        backend=None,
        backend_factory: Optional[Callable] = None,
        keys: queue.Queue | None = None,
        frame_plane=None,
        trace=None,
    ) -> SessionHandle:
        """Admit one session or shed it (:class:`AdmissionRejected`).

        Never blocks on capacity: the decision is immediate — run now,
        wait in the bounded queue, or reject with a retry-after hint.
        ``deadline_seconds`` (or the config default) propagates into the
        session's ``Params.dispatch_deadline_seconds`` watchdog, so a
        wedged dispatch surfaces as that tenant's own ``DispatchTimeout``
        instead of silently pinning a pod worker.  ``backend`` /
        ``backend_factory`` are the fault-injection seams.

        ``keys`` is a keyboard-equivalent control queue
        routed into the session's controller — 'p'/'q'/'k' semantics
        exactly as the CLI viewer's listener; ``frame_plane`` attaches
        a spectator fan-out hub the run publishes every rendered turn
        to (frame-mode sessions only — see ``serve/frames.py``).  Both
        are how the network gateway drives a resident session.

        ``trace`` is the request's ``obs.tracing.Trace`` —
        the gateway creates it from the inbound ``traceparent`` so the
        wire-handling span precedes admission; direct submitters get one
        minted here.  The plane OWNS its end: the admission verdict is a
        span, queue wait is a span + the ``sli.queue_wait_seconds``
        SLI, the whole run is activated under it, and terminal
        classification ends it (failure/watchdog/restart traces are
        tail-retained regardless of head sampling)."""
        overrides: dict = {"tenant": tenant}
        if deadline_seconds is not None:
            # An explicit per-request deadline always wins.
            overrides["dispatch_deadline_seconds"] = deadline_seconds
        elif (
            self.config.default_deadline_seconds
            and not params.dispatch_deadline_seconds
        ):
            # The config default applies only to sessions that did not
            # bring their own (admission.py's documented contract).
            overrides["dispatch_deadline_seconds"] = (
                self.config.default_deadline_seconds
            )
        if params.tenant is not None and params.tenant != tenant:
            raise ValueError(
                f"params.tenant {params.tenant!r} contradicts the "
                f"submission tenant {tenant!r}"
            )
        params = replace(params, **overrides)
        cells = params.image_width * params.image_height
        if trace is None:
            trace = tracing.TRACER.start_trace("gol.request", tenant=tenant)
        admit_ns = tracing.clock_ns()
        with self._lock:
            if self._closed:
                self._c_rejected.inc()
                self._reject_trace(trace, admit_ns, "pod is closed")
                raise AdmissionRejected("pod is closed")
            # Degraded-mode sync: a resident supervisor that
            # condemned devices onto the process-wide blacklist shrank
            # the silicon this pod schedules onto; every admission
            # decision re-reads the healthy fraction so the cell budget
            # tracks reality, not the config's full-health assumption.
            self._admission.capacity_factor = mesh_lib.capacity_fraction()
            try:
                verdict = self._admission.admit(tenant, cells)
            except AdmissionRejected as e:
                self._c_rejected.inc()
                self._reject_trace(trace, admit_ns, e.reason)
                raise
            session = Session(self._root / tenant) if self._root else Session()
            handle = SessionHandle(
                tenant,
                params,
                session,
                events if events is not None else EventQueue(),
                owns_events=events is None,
            )
            if events is not None:
                # Tee the producer side through the digest so the drain
                # receipt and classification see progress the plane
                # never consumes (the caller keeps reading their queue).
                handle.events = _DigestTee(handle, events)
            else:
                # Unwatched stream: digest inline, retain nothing — no
                # per-session drain thread (see _DigestSink).
                handle.events = _DigestSink(handle)
            handle._backend = backend
            handle._backend_factory = backend_factory
            handle.keys = keys
            handle.frame_plane = frame_plane
            if (
                self.batcher is not None
                and backend is None
                and backend_factory is None
            ):
                # Batched pods default every session's backend to a
                # cohort member (solo Backend where the Params can't
                # cohort); explicit backend/factory submissions — the
                # fault-injection seams — keep what they brought.
                handle._backend_factory = (
                    lambda p, attempt: self.batcher.member_backend(p)
                )
            handle.admitted_as = verdict
            handle.trace = trace
            handle._submit_ns = admit_ns
            handle._h_qwait = self.metrics.histogram(
                metrics_lib.labelled("sli.queue_wait_seconds", tenant)
            )
            trace.record_span(
                "gol.admission", admit_ns, tracing.clock_ns(),
                verdict=verdict, cells=cells,
            )
            tracing.TRACER.bind_tenant(tenant, trace)
            self._handles[tenant] = handle
            self._c_admitted.inc()
            self._sync_gauges()
        if verdict == ADMIT_RUN:
            self._launch(handle)
        return handle

    @staticmethod
    def _reject_trace(trace, admit_ns: int, reason: str) -> None:
        """A shed submission still yields a complete (tiny) trace: the
        admission span carries the rejection, the trace ends
        ``rejected`` — head sampling decides retention (a shed request
        is a normal outcome, not an error)."""
        trace.record_span(
            "gol.admission", admit_ns, tracing.clock_ns(),
            verdict="rejected", reason=reason,
        )
        tracing.TRACER.end_trace(trace, status="rejected", error=reason)

    # -- scheduling ------------------------------------------------------------
    def _launch(self, handle: SessionHandle) -> None:
        """THE SCHEDULER SEAM: turn one admitted session into device
        work: one asyncio task awaiting one bounded-executor worker
        running the session's own controller — which is what makes fault
        isolation structural.  Batched pods coalesce below it, at the
        dispatch seam (``serve/batcher.py``)."""
        asyncio.run_coroutine_threadsafe(self._run_async(handle), self._loop)

    async def _run_async(self, handle: SessionHandle) -> None:
        try:
            await self._loop.run_in_executor(
                self._executor, self._run_session, handle
            )
        finally:
            self._on_done(handle)

    def _run_session(self, handle: SessionHandle) -> None:
        """One session end-to-end on a pod worker — every exception is
        absorbed here (classified into the handle's terminal state):
        a tenant's failure must never propagate into the plane."""
        handle.status = "running"
        handle.t_start = time.perf_counter()
        trace = handle.trace
        if trace is not None:
            # The queue-wait SLI: submit → this worker
            # picking the session up, observed for EVERY admission —
            # run-now sessions contribute their (near-zero) wait so the
            # queue-wait SLO's bad fraction is over all admissions, not
            # just the queued tail.  The timeline span is recorded only
            # when the session actually queued (a µs-wide span on every
            # run-now request would be noise).
            now_ns = tracing.clock_ns()
            if handle._h_qwait is not None:
                handle._h_qwait.observe(
                    (now_ns - handle._submit_ns) / 1e9
                )
            if handle.admitted_as != ADMIT_RUN:
                trace.record_span(
                    "gol.queue.wait", handle._submit_ns, now_ns
                )
        exc: BaseException | None = None
        try:
            # Activate the request trace on THIS worker context: the
            # controller, supervisor, and every obs.spans call site
            # attach to it with no parameter threading.
            with tracing.activate(trace), tracing.span(
                "gol.session.run", tenant=handle.tenant
            ):
                gol.run(
                    handle.params,
                    handle.events,
                    key_presses=handle.keys,
                    session=handle.session,
                    backend=handle._backend,
                    backend_factory=handle._backend_factory,
                    stop=handle.stop,
                    frame_plane=handle.frame_plane,
                )
        except BaseException as e:  # noqa: BLE001 — isolation boundary
            exc = e
        finally:
            # Terminal-stream guarantee: the engine emits its own
            # sentinel on every path except a failed first build; one
            # extra trailing sentinel is invisible to consumers (they
            # stop at the first; the plane-owned _DigestSink drops it).
            handle.events.put(None)
        self._classify(handle, exc)

    def _classify(self, handle: SessionHandle, exc: BaseException | None):
        """Map one finished run onto the handle's terminal state.  The
        session's own ``paused`` flag is the resumability oracle (a
        terminal park, an emergency checkpoint, and a 'q' detach all
        leave it set; a completed run consumed/discarded everything)."""
        completed_all = (
            handle.final is not None
            and handle.final.completed_turns >= handle.params.turns
        )
        if exc is None:
            if handle.stop.requested and not completed_all:
                handle._finish("drained")
            elif handle.session.paused:
                handle._finish("parked")
            else:
                handle._finish("completed")
        else:
            handle._finish(
                "parked" if handle.session.paused else "failed",
                error=f"{type(exc).__name__}: {exc}",
            )
        if handle.trace is not None:
            # Tail retention: a request that ended in a
            # failure (terminal park or raw failure) keeps its trace
            # even when head sampling dropped it — error traces are
            # never lost.  Clean terminals keep the head decision.
            if handle.status in ("failed", "parked"):
                handle.trace.flag(handle.status)
            tracing.TRACER.end_trace(
                handle.trace, status=handle.status, error=handle.error
            )

    def _on_done(self, handle: SessionHandle) -> None:
        """Free the slot, promote the longest-waiting admission (unless
        draining, which shed the queue), publish gauges."""
        if self.batcher is not None:
            # Cohort membership follows the plane's books: a terminal
            # session leaves its cohort so rounds stop waiting for it.
            self.batcher.retire(handle.tenant)
        with self._state:
            self._admission.release(handle.tenant)
            self._c_outcome[handle.status].inc()
            # Bound the terminal-handle books: evict oldest-completed
            # beyond the budget — handle, digest, and (outside the lock)
            # the tenant's labelled metrics instruments.  A tenant that
            # was resubmitted keeps its CURRENT handle; only the stale
            # terminal one leaves the ring.
            self._retired.append((handle.tenant, handle))
            evicted: list[str] = []
            while len(self._retired) > self.config.max_retained_handles:
                t, old = self._retired.popleft()
                if self._handles.get(t) is old:
                    del self._handles[t]
                    evicted.append(t)
            promoted = None
            if not self._admission.draining:
                nxt = self._admission.pop_waiting()
                if nxt is not None:
                    promoted = self._handles.get(nxt[0])
            self._sync_gauges()
            if self.sampler is not None:
                # Terminal-event freshness tick, BEFORE waiters wake: a
                # session just ended, so any health()/scrape issued after
                # wait_idle returns must see its final counters
                # (restarts, watchdog fires, outcome) without waiting
                # out the sampling interval.  Steady-state cost stays
                # one snapshot per interval — sessions ending is the
                # cold path.  lazy=False is load-bearing: this runs
                # under the plane lock health() also takes, so it must
                # never land on a lazy-cadence tick whose callback
                # gauges could block on the very wedged device the
                # session just died of.
                self.sampler.sample_now(lazy=False)
            self._state.notify_all()
        for t in evicted:
            self.metrics.clear_tenant(t)
            # The tracer's tenant binding rides the same eviction ring
            #: a churning-tenant pod stays bounded-memory.
            tracing.TRACER.unbind_tenant(t)
        if promoted is not None:
            self._launch(promoted)

    def _sync_gauges(self) -> None:
        self._g_resident.set(len(self._admission.resident))
        self._g_queued.set(self._admission.queued)
        self._g_cells.set(self._admission.resident_cells)

    def _own_counter(self, counter, name: str):
        """Exact current value of a plane-owned counter relative to the
        plane-start baseline (the registry is process-wide; a previous
        plane's counts must not leak into this one's health)."""
        base = self._metrics_start.data.get("counters", {}).get(name, 0)
        return getattr(counter, "value", 0) - base

    # -- drain (leg 3) ---------------------------------------------------------
    def begin_drain(self, signum=None, frame=None) -> None:
        """The non-blocking half of a graceful drain: close admissions,
        shed the waiting queue (their streams are terminated so no
        consumer hangs), and raise every resident session's
        ``GracefulStop`` latch — each controller emergency-checkpoints
        at its next turn boundary (the fsync-durable ``_checkpoint_now``
        path) and exits paused-and-resumable.

        Takes the plane's (non-reentrant) lock, so it must NOT run
        directly inside a signal handler — the signal could land while
        the main thread holds that lock (mid-``submit``) and deadlock
        the drain.  :meth:`install` therefore routes signals through a
        trampoline that runs it on a fresh thread."""
        # Close the wire face FIRST (outside the lock — a hook may be
        # answering a request that wants plane state): new gateway
        # submissions 503 before the plane sheds anything.
        for hook in list(self._drain_hooks):
            try:
                hook()
            except Exception:  # noqa: BLE001 — a hook bug must not block drain
                pass
        with self._state:
            if self._admission.draining:
                return
            self._admission.draining = True
            self._c_drains.inc()
            shed = [self._handles[t] for t in self._admission.shed_waiting()]
            running = [
                self._handles[t] for t in list(self._admission.resident)
            ]
            self._sync_gauges()
            self._state.notify_all()
        for handle in shed:
            handle._finish("shed", error="pod drained before a slot freed")
            self._c_outcome["shed"].inc()
            handle.events.put(None)  # terminal event for any waiting consumer
        for handle in running:
            handle.stop.request(signum)

    def drain(self, timeout: float | None = None) -> dict:
        """Blocking graceful drain: :meth:`begin_drain`, then wait (up to
        ``timeout``, default the config's ``drain_timeout_seconds``) for
        every resident session to reach a terminal state.  Returns a
        summary ``{tenant: {status, turn, resumable}}`` — the drain
        contract's receipt: with a checkpoint root, every ``drained``
        tenant is re-adoptable by a fresh pod."""
        self.begin_drain()
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.config.drain_timeout_seconds
        )
        with self._state:
            while self._admission.resident:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._state.wait(timeout=remaining):
                    break
            handles = dict(self._handles)
        return {
            t: {
                "status": h.status,
                "turn": h.last_turn,
                "resumable": h.resumable,
            }
            for t, h in handles.items()
        }

    def install(self, signals=None) -> Callable[[], None]:
        """Route SIGTERM (default) to :meth:`begin_drain`; returns a
        restore callable, like ``GracefulStop.install``.  The handler
        itself only spawns the drain thread (never touches the plane's
        lock on the interrupted thread — see :meth:`begin_drain`); the
        process's main loop observes the drain via :meth:`wait_idle` /
        handle waits and exits when the pod is empty."""
        import signal as signal_mod

        from distributed_gol_torch.engine.supervisor import route_signals

        if signals is None:
            signals = (signal_mod.SIGTERM,)

        def handler(signum, frame):
            threading.Thread(
                target=self.begin_drain,
                args=(signum,),
                name="gol-serve-drain",
                daemon=True,
            ).start()

        return route_signals(handler, signals)

    def add_drain_hook(self, hook: Callable[[], None]) -> None:
        """Register a pre-drain hook (see ``_drain_hooks``).  Hooks must
        be fast and idempotent: a repeated drain signal re-invokes them
        even though the drain itself is once-only."""
        self._drain_hooks.append(hook)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no session is resident or queued."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._state:
            while self._admission.resident or self._admission.waiting:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                if not self._state.wait(timeout=remaining):
                    return False
            return True

    def _on_sample(self, sampler) -> None:
        """The sampler's per-tick hook (sampler thread): evaluate the
        SLO objectives over the refreshed ring."""
        if self.slo is not None:
            self.slo.observe(sampler)

    def close(self, timeout: float | None = None) -> None:
        """Drain, then tear the control plane down (idempotent)."""
        with self._lock:
            if self._closed:
                return
        self.drain(timeout)
        with self._lock:
            self._closed = True
        if self.sampler is not None:
            self.sampler.stop()
        self._executor.shutdown(wait=False)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=10)

    # -- health (leg 4) --------------------------------------------------------
    def health(self) -> dict:
        """Readiness/liveness for an external balancer, derived from the
        plane's books plus the obs registry delta since plane start
        (watchdog fires, supervisor restarts, per-tenant dispatch
        counters via their ``tenant=`` labels).  ``ready`` = this pod
        can admit work now; ``live`` = the control plane itself is
        healthy (a not-live pod should be ejected/restarted; a
        not-ready-but-live pod is full or draining — route around it).

        With the sampler on (the default), the metrics half is read
        from the sampler's LATEST sample — one registry snapshot per
        sampling interval however often health is polled, values at
        most ``telemetry_sample_seconds`` stale (the ``telemetry``
        section publishes the actual age).  The per-call direct
        snapshot survives only as the sampler-off fallback (the
        direct-snapshot cost profile)."""
        devices_lost = mesh_lib.lost_device_count()
        with self._lock:
            self._admission.capacity_factor = mesh_lib.capacity_fraction()
            draining = self._admission.draining
            resident = len(self._admission.resident)
            queued = self._admission.queued
            resident_cells = self._admission.resident_cells
            effective_cells = self._admission.effective_total_cells
            ready = (
                not self._closed
                and not draining
                and self._admission.has_room()
            )
            statuses = {t: h.status for t, h in self._handles.items()}
            closed = self._closed
        latest = self.sampler.latest() if self.sampler is not None else None
        if latest is not None:
            snap = (
                metrics_lib.MetricsSnapshot(latest.snapshot)
                .delta(self._metrics_start)
                .to_dict()
            )
            telemetry = {
                "sampling": True,
                "sample_age_seconds": round(self.sampler.staleness, 3),
                "staleness_bound_seconds": self.sampler.interval,
            }
        else:
            snap = (
                self.metrics.snapshot(include_lazy=False)
                .delta(self._metrics_start)
                .to_dict()
            )
            telemetry = {"sampling": False}
        counters = snap.get("counters", {})
        snap_gauges = snap.get("gauges", {})
        snap_info = snap.get("info", {})
        tenants = {
            t: {
                "status": status,
                "dispatches": counters.get(
                    metrics_lib.labelled("controller.dispatches", t), 0
                ),
                "turns": counters.get(
                    metrics_lib.labelled("controller.turns", t), 0
                ),
            }
            for t, status in statuses.items()
        }
        return {
            "ready": ready,
            "live": not closed and self._loop_thread.is_alive(),
            # Degraded mode: this pod lost devices to the
            # blacklist (an elastic supervisor condemned them) and now
            # admits against the reduced capacity.  A balancer keeps
            # routing to a degraded-but-ready pod — it just holds less.
            "degraded": devices_lost > 0,
            "devices_lost": devices_lost,
            "draining": draining,
            "resident_sessions": resident,
            "queued_sessions": queued,
            "resident_cells": resident_cells,
            "capacity": {
                "max_sessions": self.config.max_sessions,
                "max_queued": self.config.max_queued,
                "max_total_cells": self.config.max_total_cells,
                "effective_total_cells": effective_cells,
            },
            "watchdog_fires": counters.get("faults.watchdog_fires", 0),
            "supervisor_restarts": counters.get("supervisor.restarts", 0),
            # The plane's OWN admission/outcome counters read exactly
            # (plain attribute reads on pre-bound instruments, minus the
            # plane-start baseline) — a rejection is visible in the very
            # next health() even between sampler ticks.
            "sessions_parked": self._own_counter(
                self._c_outcome["parked"], "serve.sessions_parked"
            ),
            "sessions_failed": self._own_counter(
                self._c_outcome["failed"], "serve.sessions_failed"
            ),
            "rejected": self._own_counter(self._c_rejected, "serve.rejected"),
            # Batched-cohort surface: physical launch economics
            # a balancer (or the bench) reads straight off health.
            "batched": self.batcher is not None,
            "batched_launches": counters.get("serve.batched_launches", 0),
            "batched_boards": counters.get("serve.batched_boards", 0),
            "cohort_evictions": counters.get("serve.cohort_evictions", 0),
            # Continuous-telemetry surface: how fresh the
            # metrics half of this response is, and the per-tenant SLO
            # table when objectives are armed.
            "telemetry": telemetry,
            "slo": self.slo.summary() if self.slo is not None else None,
            "slo_alerts": counters.get("serve.slo_alerts", 0),
            # Spectator fan-out economics: the
            # FramePlane counters, straight off the pod registry, so
            # tools/pod_top.py renders a sessions/spectators panel
            # without a second scrape.  ``subscribers`` is the lazy
            # gauge — None until a lazy sampler tick has run.
            "frames": {
                "publishes": counters.get("frames.publishes", 0),
                "fetches": counters.get("frames.fetches", 0),
                "frames_served": counters.get("frames.frames_served", 0),
                "bytes_shipped": counters.get("frames.bytes_shipped", 0),
                "subscribers": snap_gauges.get("frames.subscribers"),
            },
            # The wire face: who is attached and what the
            # gateway shipped — all-zero (endpoint None) on a pod
            # serving no gateway.
            "gateway": {
                "endpoint": snap_info.get("gateway.endpoint"),
                "sessions_submitted": counters.get(
                    "gateway.sessions_submitted", 0
                ),
                "rejected": counters.get("gateway.rejected", 0),
                "controllers": snap_gauges.get("gateway.controllers", 0),
                "spectators": snap_gauges.get("gateway.spectators", 0),
                "frames_streamed": counters.get("gateway.frames_streamed", 0),
                "bytes_streamed": counters.get("gateway.bytes_streamed", 0),
            },
            "tenants": tenants,
        }

    # -- re-adoption (the restarted-pod half of the drain contract) ------------
    def resumable_tenants(self) -> dict[str, dict]:
        """Scan the checkpoint root for tenants a fresh pod can re-adopt:
        ``{tenant: {turn, shape, rule}}`` for every tenant directory
        holding a paused (unconsumed) checkpoint sidecar.  Submitting a
        matching ``Params`` for such a tenant resumes it via the normal
        ``Session.check_states`` negotiation."""
        out: dict[str, dict] = {}
        if self._root is None or not self._root.is_dir():
            return out
        for tenant_dir in sorted(p for p in self._root.iterdir() if p.is_dir()):
            best: dict | None = None
            for sidecar in tenant_dir.glob("checkpoint*.json"):
                try:
                    meta = json.loads(sidecar.read_text())
                except (OSError, ValueError):
                    continue
                if not isinstance(meta, dict) or not meta.get("paused"):
                    continue
                turn = meta.get("turn")
                if not isinstance(turn, int):
                    continue
                if best is None or turn > best["turn"]:
                    best = {
                        "turn": turn,
                        "shape": meta.get("shape"),
                        "rule": meta.get("rule"),
                    }
            if best is not None:
                out[tenant_dir.name] = best
        return out

    # -- introspection ---------------------------------------------------------
    def handle(self, tenant: str) -> SessionHandle | None:
        with self._lock:
            return self._handles.get(tenant)

    def handles(self) -> dict[str, SessionHandle]:
        """A point-in-time copy of the tenant book (latest handle per
        tenant, resident and retained-terminal) — the gateway's session
        listing reads this."""
        with self._lock:
            return dict(self._handles)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._admission.draining
