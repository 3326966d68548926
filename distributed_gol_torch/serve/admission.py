"""Admission control and backpressure for the serving plane.

Copy of ``distributed_gol_tpu/serve/admission.py`` (stdlib only; the port
never imports the JAX package).  A **capacity budget** (max resident
sessions, max queued admissions, per-tenant and pod-wide cell budgets) is
enforced with **explicit load-shedding**: a submission the budget cannot
hold is refused *immediately* with :class:`AdmissionRejected` (carrying a
``retry_after`` hint when the condition is transient), never parked on an
unbounded queue and never left to time out.

The controller is pure bookkeeping — no locks, no device work, no I/O —
so the plane can consult it under its own lock and tests can drive it
directly.  Every decision is deterministic in the submission order.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class ServeConfig:
    """The serving plane's capacity budget (docs/API.md "Serving").

    Defaults are sized for a small demo pod; a production deployment
    tunes them to the device's memory and the balancer's patience."""

    # Sessions computing concurrently (each runs under its own
    # supervisor ladder on its own worker thread today; the batched-board
    # scheduler slots in behind the same budget later).
    max_sessions: int = 4
    # Admissions allowed to WAIT for a slot.  A queued session holds only
    # its Params — no board is loaded until it starts — so queue memory
    # is O(max_queued) small objects, bounded by construction.  0 =
    # no waiting: a full pod sheds immediately.
    max_queued: int = 8
    # Per-tenant board budget in cells (width × height).  A board over
    # this never fits, so the rejection carries no retry_after.
    max_cells_per_session: int = 2**24  # one 4096² board
    # Pod-wide cell budget across resident + queued sessions — the
    # device-memory guard.  0 = only the per-session bound applies.
    max_total_cells: int = 2**26
    # Dispatch watchdog deadline stamped on every admitted session that
    # did not bring its own (``submit(deadline_seconds=...)`` wins):
    # propagates into ``Params.dispatch_deadline_seconds`` so one wedged
    # tenant surfaces as ITS OWN DispatchTimeout instead of a silent
    # stall.  0 keeps the per-run default (watchdog off).
    default_deadline_seconds: float = 0.0
    # The retry-after hint stamped on transient rejections (pod full,
    # queue full, total-cell budget) — what an HTTP front-end would send
    # as a 429 Retry-After.
    retry_after_seconds: float = 1.0
    # How long a drain waits for resident sessions to emergency-
    # checkpoint and exit before giving up (``ServePlane.drain``).
    drain_timeout_seconds: float = 60.0
    # TERMINAL session handles retained for introspection (health /
    # drain receipts / ``plane.handle``).  Beyond this the oldest are
    # evicted — handle, digest, AND the tenant's labelled metrics
    # instruments — so a pod serving churning tenant names stays
    # bounded-memory (the same contract the queue bound enforces).
    # Resident and queued sessions are never evicted.
    max_retained_handles: int = 256
    # --- batched dispatch cohorts (docs/API.md "Batched serving") ---
    # Coalesce resident same-key sessions (``serve.batcher.cohort_key``:
    # every dispatch-relevant Params field) into shared launch cohorts:
    # each superstep, one BatchedBackend launch advances every cohort
    # member's board — the per-launch-overhead amortiser.  Off by
    # default: one solo launch per session per superstep.
    batched: bool = False
    # How long a cohort round waits for the rest of its members before
    # firing with whoever showed up.  Bounds the damage any slow/faulted
    # member can do to its cohort-mates (per round); in steady state
    # members arrive together and no round ever waits this long — the
    # window only binds while a member is MISSING, so it should sit
    # ABOVE the rig's worst thread-scheduling delay: a grace below it
    # reads descheduled-but-healthy members as stragglers, fires
    # partial rounds, and can cascade into mass eviction under CPU
    # starvation (measured on a contended 2-core rig at 0.25 s: half
    # the cohort evicted to solo launches, launches/superstep 16 -> 8
    # instead of -> 1).
    cohort_grace_seconds: float = 1.0
    # OPTIONAL join-quiescence window: > 0 makes a round also fire once
    # no new member has joined for this long (each join resets the
    # clock; grace stays the hard cap) — an early-fire lever for pods
    # whose members arrive in one tight burst and where waiting the
    # full grace window for a dead slot costs real latency.  0
    # (default) = off: rounds fire on full membership or the grace cap
    # only.  Keep it comfortably above the cohort's inter-arrival
    # spread — a window below it shatters rounds into near-solo
    # launches and costs the very amortisation batching exists for
    # (measured: 30 ms on a 2-core contended rig turned 1.0
    # launches/superstep into 13.2).
    cohort_quiesce_seconds: float = 0.0
    # Consecutive missed rounds before a member is evicted from its
    # cohort back to solo launches (the straggler/faulted-slot ladder).
    # >= 2 so a one-off stall (GC pause, first checkpoint fetch) does
    # not cost a healthy tenant its cohort.
    cohort_evict_misses: int = 2
    # --- continuous telemetry + per-tenant SLOs (docs/API.md "Telemetry
    # export") ---
    # Sampling cadence of the pod's TelemetrySampler (obs/timeseries.py):
    # every N seconds one registry snapshot lands in the bounded ring
    # that backs health(), /metrics, /healthz, and the SLO windows.
    # Staleness bound of everything served from it = this interval.
    # 0 disables the sampler; health() then falls back to a direct
    # (lazy-free) snapshot per call.
    telemetry_sample_seconds: float = 1.0
    # Ring depth (samples retained) and the lazy-gauge cadence (every
    # N-th tick also evaluates device-forcing callback gauges — skip
    # fraction, cache stats; the fast ticks never touch a device).
    telemetry_ring_depth: int = 600
    telemetry_lazy_every: int = 10
    # Per-tenant SLO objectives (obs/slo.py; 0 = that objective off).
    # Latency: "slo_latency_percentile of dispatches resolve within
    # slo_latency_seconds"; errors: "at most slo_error_rate of dispatch
    # attempts fail".  Burn-rate alerts fire when BOTH windows burn
    # above slo_burn_threshold; budgets track over the budget window.
    # Arming any objective requires the sampler (the windows live on
    # its ring), and the ring's span (telemetry_ring_depth ×
    # telemetry_sample_seconds) must cover the slow window — the
    # multi-window "a sustained burn can't hide" guarantee is only as
    # long as the ring's memory.  The budget window is clamped to the
    # ring span the same way (the defaults agree: 600 samples × 1 s =
    # the 600 s budget window); size the ring up for longer budgets.
    slo_latency_seconds: float = 0.0
    slo_latency_percentile: float = 0.99
    slo_error_rate: float = 0.0
    slo_fast_window_seconds: float = 60.0
    slo_slow_window_seconds: float = 300.0
    slo_burn_threshold: float = 2.0
    slo_budget_window_seconds: float = 600.0
    # Queue-wait SLO: "slo_latency_percentile of
    # admissions start within this many seconds of submit", judged from
    # the per-tenant ``sli.queue_wait_seconds`` histogram the request-
    # tracing plane derives — the admission-ladder half of request
    # latency the dispatch-latency objective cannot see.
    slo_queue_wait_seconds: float = 0.0
    # --- request-scoped tracing (docs/API.md "Distributed tracing") ---
    # Head-sampling rate in [0, 1]: the fraction of requests whose trace
    # is RETAINED at end (deterministic in the trace id; an inbound
    # traceparent with the sampled flag set always retains).  Tracing
    # itself is always on — unsampled traces still buffer in-flight so
    # tail retention can keep any trace that ends in a failure,
    # watchdog fire, or supervisor restart.  1.0 (demo default) retains
    # everything; production pods sample down.
    trace_sample_rate: float = 1.0
    # Finished-trace ring depth (the /traces window) and the per-trace
    # span cap (the FIRST N spans are kept; later ones are counted in
    # dropped_spans — a request timeline's interesting part is its head).
    trace_ring_depth: int = 256
    trace_max_spans: int = 512
    # --- wire hardening ---
    # Per-connection HTTP read deadline on the gateway: a peer that
    # trickles its request slower than this (slow-loris) is answered a
    # best-effort 408 and reaped (net.slowloris_reaped).  0 = off.
    wire_read_timeout_seconds: float = 30.0
    # Request-body Content-Length bound; an oversized declaration is a
    # 413 (net.oversize_rejected), never a 500.
    wire_body_cap_bytes: int = 1 << 26
    # Concurrent-connection bound on the gateway: past it, a new
    # connection gets a raw 503 on the accept thread
    # (net.connections_shed).  0 = unbounded.
    wire_max_connections: int = 0
    # WebSocket recv keepalive on the gateway's controller/spectator
    # legs: a stalled-NOT-closed peer (half-open socket) is pinged
    # every this-many seconds and dropped after ws_keepalive_misses
    # silent intervals (net.keepalive_drops) — detection bound =
    # seconds × misses.  0 = off: a quiet controller leg may sit idle
    # forever (a live client's auto-pong makes
    # arming this safe whenever the client library is ours).
    ws_keepalive_seconds: float = 0.0
    ws_keepalive_misses: int = 3
    # Inbound WebSocket frame-size cap on the gateway's legs (control
    # messages are tiny; anything near the codec ceiling is an attack
    # or a bug).
    ws_max_frame_bytes: int = 1 << 20
    # POST /v1/sessions idempotency-token replay window: receipts for
    # the last N tokens are retained so a submit whose response died
    # mid-body can be retried (same X-Gol-Idempotency-Key) without
    # double-placing the tenant (net.idempotent_replays).
    idempotency_cache_size: int = 256

    def __post_init__(self):
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if self.max_queued < 0:
            raise ValueError("max_queued must be >= 0")
        if self.max_cells_per_session < 1:
            raise ValueError("max_cells_per_session must be >= 1")
        if self.max_total_cells < 0:
            raise ValueError("max_total_cells must be >= 0 (0 = unbounded)")
        if self.default_deadline_seconds < 0:
            raise ValueError("default_deadline_seconds must be >= 0")
        if self.retry_after_seconds < 0:
            raise ValueError("retry_after_seconds must be >= 0")
        if self.drain_timeout_seconds <= 0:
            raise ValueError("drain_timeout_seconds must be positive")
        if self.max_retained_handles < 0:
            raise ValueError(
                "max_retained_handles must be >= 0 (0 = drop terminal "
                "handles immediately)"
            )
        if self.cohort_grace_seconds <= 0:
            raise ValueError("cohort_grace_seconds must be positive")
        if not 0 <= self.cohort_quiesce_seconds <= self.cohort_grace_seconds:
            raise ValueError(
                "cohort_quiesce_seconds must be in [0, cohort_grace_seconds] "
                "(0 = off)"
            )
        if self.cohort_evict_misses < 1:
            raise ValueError("cohort_evict_misses must be >= 1")
        if self.telemetry_sample_seconds < 0:
            raise ValueError(
                "telemetry_sample_seconds must be >= 0 (0 disables sampling)"
            )
        if self.telemetry_ring_depth < 2:
            raise ValueError("telemetry_ring_depth must be >= 2")
        if self.telemetry_lazy_every < 1:
            raise ValueError("telemetry_lazy_every must be >= 1")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError("trace_sample_rate must be in [0, 1]")
        if self.trace_ring_depth < 1:
            raise ValueError("trace_ring_depth must be >= 1")
        if self.trace_max_spans < 16:
            raise ValueError("trace_max_spans must be >= 16")
        if self.slo_queue_wait_seconds < 0:
            raise ValueError(
                "slo_queue_wait_seconds must be >= 0 (0 disables)"
            )
        if self.wire_read_timeout_seconds < 0:
            raise ValueError(
                "wire_read_timeout_seconds must be >= 0 (0 disables)"
            )
        if self.wire_body_cap_bytes < 1:
            raise ValueError("wire_body_cap_bytes must be >= 1")
        if self.wire_max_connections < 0:
            raise ValueError(
                "wire_max_connections must be >= 0 (0 = unbounded)"
            )
        if self.ws_keepalive_seconds < 0:
            raise ValueError(
                "ws_keepalive_seconds must be >= 0 (0 disables)"
            )
        if self.ws_keepalive_misses < 1:
            raise ValueError("ws_keepalive_misses must be >= 1")
        if self.ws_max_frame_bytes < 1:
            raise ValueError("ws_max_frame_bytes must be >= 1")
        if self.idempotency_cache_size < 0:
            raise ValueError(
                "idempotency_cache_size must be >= 0 (0 disables replay)"
            )
        # The SLO field set validates as a unit (ranges, window ordering)
        # and an armed objective REQUIRES the sampler: the burn windows
        # live on its ring.
        objectives = self.slo_objectives()
        if objectives is not None:
            if not self.telemetry_sample_seconds:
                raise ValueError(
                    "SLO objectives need the telemetry sampler: set "
                    "telemetry_sample_seconds > 0"
                )
            span = self.telemetry_ring_depth * self.telemetry_sample_seconds
            if span < self.slo_slow_window_seconds:
                # A ring shorter than the slow window would silently
                # turn the multi-window alert into a fast-window-only
                # one — permanently, not as warm-up.  Refuse instead.
                raise ValueError(
                    f"sampler ring spans {span:g}s (telemetry_ring_depth x "
                    f"telemetry_sample_seconds) but slo_slow_window_seconds "
                    f"is {self.slo_slow_window_seconds:g}s: the slow burn "
                    "window must fit the ring — raise the depth or shrink "
                    "the window"
                )

    def slo_objectives(self):
        """The validated :class:`obs.slo.SLOObjectives` this config arms,
        or None when both objectives are off."""
        from distributed_gol_torch.obs.slo import SLOObjectives

        objectives = SLOObjectives(
            latency_seconds=self.slo_latency_seconds,
            latency_percentile=self.slo_latency_percentile,
            error_rate=self.slo_error_rate,
            fast_window_seconds=self.slo_fast_window_seconds,
            slow_window_seconds=self.slo_slow_window_seconds,
            burn_threshold=self.slo_burn_threshold,
            budget_window_seconds=self.slo_budget_window_seconds,
            queue_wait_seconds=self.slo_queue_wait_seconds,
        )
        return objectives if objectives.enabled else None


class AdmissionRejected(RuntimeError):
    """A submission the capacity budget cannot hold was shed.

    ``retry_after`` is the back-off hint in seconds; None means the
    rejection is permanent for this request (board over the per-tenant
    budget, pod draining) and retrying the same submission is futile."""

    def __init__(self, reason: str, retry_after: float | None = None):
        super().__init__(reason)
        self.reason = reason
        self.retry_after = retry_after

    def __str__(self) -> str:
        hint = (
            f" (retry after {self.retry_after:g}s)"
            if self.retry_after is not None
            else ""
        )
        return f"{self.reason}{hint}"


# Admission outcomes (``AdmissionController.admit``).
ADMIT_RUN = "run"  # a session slot is free: start now
ADMIT_QUEUE = "queue"  # pod full, queue has room: wait for a slot


class AdmissionController:
    """The budget bookkeeping: who is resident, who is waiting, how many
    cells they pin.  Pure state — the plane serialises access under its
    own lock; every mutation is O(1).

    Tenant identity is the admission key: one live run per tenant (its
    scoped checkpoint dir is single-writer by contract), so a duplicate
    submission is shed with a retry-after rather than queued behind
    itself."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self.resident: dict[str, int] = {}  # tenant -> cells
        self.waiting: deque[str] = deque()  # admission order
        self._waiting_cells: dict[str, int] = {}
        self.draining = False
        # Degraded-capacity factor in (0, 1]: the healthy share
        # of the pod's devices.  The plane syncs it from the process-wide
        # device blacklist (``parallel.mesh.capacity_fraction``) so a
        # resident supervisor landing on a shrunken mesh shrinks the
        # pod-wide cell budget with it — admission sheds/queues against
        # what the surviving silicon can actually hold.  Pure state here
        # (this module stays device-free); 1.0 = full health.
        self.capacity_factor = 1.0

    # -- the decision ----------------------------------------------------------
    def admit(self, tenant: str, cells: int) -> str:
        """Decide one submission: :data:`ADMIT_RUN`, :data:`ADMIT_QUEUE`
        (both recorded in the books), or raise :class:`AdmissionRejected`
        (books untouched).  Deterministic in submission order."""
        cfg = self.config
        if self.draining:
            raise AdmissionRejected("pod is draining; admissions closed")
        if cells > cfg.max_cells_per_session:
            raise AdmissionRejected(
                f"board of {cells} cells exceeds the per-session budget "
                f"({cfg.max_cells_per_session})"
            )
        if tenant in self.resident or tenant in self._waiting_cells:
            raise AdmissionRejected(
                f"tenant {tenant!r} already has a live session",
                retry_after=cfg.retry_after_seconds,
            )
        budget = self.effective_total_cells
        if budget and self.total_cells + cells > budget:
            degraded = (
                f" (degraded: {self.capacity_factor:.0%} of "
                f"{cfg.max_total_cells})"
                if self.capacity_factor < 1.0
                else ""
            )
            raise AdmissionRejected(
                f"pod cell budget exhausted ({self.total_cells} + {cells} "
                f"> {budget}{degraded})",
                retry_after=cfg.retry_after_seconds,
            )
        if len(self.resident) < cfg.max_sessions:
            self.resident[tenant] = cells
            return ADMIT_RUN
        if len(self.waiting) < cfg.max_queued:
            self.waiting.append(tenant)
            self._waiting_cells[tenant] = cells
            return ADMIT_QUEUE
        raise AdmissionRejected(
            f"pod full ({cfg.max_sessions} resident, "
            f"{len(self.waiting)} queued)",
            retry_after=cfg.retry_after_seconds,
        )

    # -- bookkeeping transitions ----------------------------------------------
    def release(self, tenant: str) -> None:
        """A resident session reached a terminal state: free its slot."""
        self.resident.pop(tenant, None)

    def pop_waiting(self) -> tuple[str, int] | None:
        """Promote the longest-waiting admission into a freed slot
        (admission order, no starvation); None when nothing waits."""
        if not self.waiting or len(self.resident) >= self.config.max_sessions:
            return None
        tenant = self.waiting.popleft()
        cells = self._waiting_cells.pop(tenant)
        self.resident[tenant] = cells
        return tenant, cells

    def shed_waiting(self) -> list[str]:
        """Drop every queued admission (the drain path); returns them in
        admission order so each handle can be terminated explicitly."""
        shed = list(self.waiting)
        self.waiting.clear()
        self._waiting_cells.clear()
        return shed

    # -- read side -------------------------------------------------------------
    @property
    def effective_total_cells(self) -> int:
        """The pod-wide cell budget after degradation: ``max_total_cells``
        scaled by :attr:`capacity_factor` (0 stays 0 = unbounded — a pod
        that opted out of the cell guard keeps that choice while
        degraded; the per-session bound still applies)."""
        if not self.config.max_total_cells:
            return 0
        return max(1, int(self.config.max_total_cells * self.capacity_factor))

    @property
    def total_cells(self) -> int:
        return sum(self.resident.values()) + sum(self._waiting_cells.values())

    @property
    def resident_cells(self) -> int:
        return sum(self.resident.values())

    @property
    def queued(self) -> int:
        return len(self.waiting)

    def has_room(self) -> bool:
        """Whether a (budget-sized) submission could be admitted right
        now — the readiness half of the health surface."""
        return not self.draining and (
            len(self.resident) < self.config.max_sessions
            or len(self.waiting) < self.config.max_queued
        )
