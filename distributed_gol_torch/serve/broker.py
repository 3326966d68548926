"""Pod federation: the health-probed broker tier.

A copy of ``distributed_gol_tpu/serve/broker.py`` over the port's pod
client, tracing, flight ring and fleet collector.  The broker forwards
a tenant's spec verbatim: it names no device, so a session runs on its
pod's ``--device``.

PAPER.md §1's broker is the process that owns run state so controllers
can come and go; ROADMAP item 1 promotes it one level — from
fan-out-over-workers to fan-out-over-pods.  This module is that layer:
a :class:`Broker` fronts N gateway pods (``serve/gateway.py``), routes
``POST /v1/sessions`` by tenant → pod placement against each pod's
live ``/healthz`` capacity, and continuously health-probes the fleet —
the same condemn-don't-wait policy ``parallel/mesh.py`` applies to
devices, one level up: a pod that misses ``probe_miss_threshold``
consecutive probes is **condemned** and routed around, and a condemned
pod that answers ``rejoin_threshold`` consecutive probes rejoins the
placement ring.

Robustness legs (the tentpole's three):

1. **Failover** — a condemned pod's resident tenants are re-adopted on
   surviving pods from their newest intact durable checkpoints: the
   federation's one shared contract is the checkpoint root (every pod
   of a federation mounts the same root, and a tenant's directory has
   a single writer because only one pod runs a tenant at a time), so
   re-POSTing the tenant's original spec to any pod lands in the same
   ``root/<tenant>`` directory and the pod's normal
   ``Session.check_states`` negotiation resumes it **bit-identical**
   from the last parked turn (durable sidecars are written
   ``paused=True``, so even a SIGKILLed pod leaves adoptable state).
2. **Live migration** — ``POST /v1/migrate``: single-tenant (quit →
   parked checkpoint → readopt on the target) or whole-pod (drain
   receipt → readopt every parked tenant; queued admissions the drain
   shed are re-submitted fresh — "spilled" — to the warming side).
   Reshard-on-restore means source and target meshes need not
   match.
3. **Degraded routing** — placement scores live headroom
   (``effective_total_cells`` already reflects the device blacklist's
   capacity fraction) and deprioritises pods whose SLO burn is
   alerting; broker rejections carry an honest ``Retry-After`` derived
   from fleet headroom (pod-provided hints when the pods answered,
   the condemnation-recovery horizon when they did not).  A healed
   pod is **reconciled before readmission**: a SIGSTOP-partitioned
   pod resumes running its old sessions the instant it thaws, so any
   resident whose placement moved to a survivor during the outage is
   quit on the healed pod first — the single-writer invariant on
   ``root/<tenant>`` survives partition heal, not just pod death.

Cross-pod tracing (one level up): a submission's inbound
W3C ``traceparent`` starts the broker's request trace, and the broker
forwards ``trace.traceparent()`` to the pod — broker → pod → dispatch
is ONE trace id, two retained timelines joined by ``parent_span_id``.

Observability: ``broker.*`` counters on the process registry and a
bounded :class:`~distributed_gol_torch.obs.flight.FlightRecorder` ring
(``GET /flight``) carrying the ``pod_condemned`` → ``failover`` /
``migration`` sequence — the fleet postmortem surface
``tools/pod_top.py --fleet`` and the chaos matrix read.

The broker never touches a device and holds no run state of its own
beyond the placement map — a restarted broker re-discovers residency
from the pods' session lists and orphaned checkpoints from the shared
root (``POST /v1/recover`` sweeps orphans onto live pods).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import openmetrics
from distributed_gol_torch.obs import tracing
from distributed_gol_torch.obs.flight import FlightRecorder
from distributed_gol_torch.serve.httpd import StdlibHTTPServer, read_body
from distributed_gol_torch.serve.podclient import (
    PodClient,
    PodHTTPError,
    PodUnreachable,
)

_TERMINAL = ("completed", "failed", "parked", "shed", "rejected")


@dataclass(frozen=True)
class BrokerConfig:
    """The federation knobs, validated at construction.

    ``probe_miss_threshold`` consecutive probe misses condemn a pod
    (mirroring the device blacklist's consecutive-probe policy);
    ``rejoin_threshold`` consecutive healthy probes readmit it.  The
    prober's per-probe patience is ``probe_timeout_seconds`` — strictly
    bounded so one dead pod costs one timeout per cycle, never a wedged
    prober.  ``checkpoint_root`` is the shared root every pod of the
    federation mounts; None disables the orphan scan (failover then
    re-adopts optimistically, trusting the pods' own roots)."""

    probe_interval_seconds: float = 0.5
    probe_timeout_seconds: float = 2.0
    probe_miss_threshold: int = 3
    rejoin_threshold: int = 2
    checkpoint_root: str | Path | None = None
    failover: bool = True
    request_timeout_seconds: float = 30.0
    #: Fallback Retry-After when no pod supplied a hint: the horizon at
    #: which a condemned pod could have rejoined (interval * threshold).
    retry_after_seconds: float = 1.0
    flight_depth: int = 256
    #: TCP connect deadline for broker→pod calls, split from the read
    #: budget: a blackholed pod address fails in this bound
    #: instead of eating the whole request timeout.
    connect_timeout_seconds: float = 5.0
    #: Transport retry policy for control forwards (the controller's retry shape);
    #: probes always use attempts=1 — one miss is one datum.
    attempts: int = 2
    backoff_seconds: float = 0.05
    backoff_max_seconds: float = 1.0
    #: Ride the fleet observability collector in-broker:
    #: scrape every pod's /metrics + /healthz on a cadence and serve
    #: the /fleet/* surface (aggregated metrics, stitched traces, the
    #: merged postmortem) from this broker's port.
    collector: bool = False
    collector_interval_seconds: float = 0.5
    collector_scrape_timeout_seconds: float = 2.0

    def __post_init__(self):
        if self.probe_interval_seconds <= 0:
            raise ValueError("probe_interval_seconds must be > 0")
        if self.probe_timeout_seconds <= 0:
            raise ValueError("probe_timeout_seconds must be > 0")
        if self.probe_miss_threshold < 1:
            raise ValueError("probe_miss_threshold must be >= 1")
        if self.rejoin_threshold < 1:
            raise ValueError("rejoin_threshold must be >= 1")
        if self.flight_depth < 0:
            raise ValueError("flight_depth must be >= 0")
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if self.connect_timeout_seconds <= 0:
            raise ValueError("connect_timeout_seconds must be > 0")
        if self.collector_interval_seconds <= 0:
            raise ValueError("collector_interval_seconds must be > 0")
        if self.collector_scrape_timeout_seconds <= 0:
            raise ValueError("collector_scrape_timeout_seconds must be > 0")


@dataclass
class PodState:
    """The broker's book on one pod: its client, the prober's counters,
    and the last good health dict placement scores against."""

    endpoint: str
    client: PodClient
    condemned: bool = False
    misses: int = 0
    healthy_streak: int = 0
    health: dict | None = None
    health_age: float = 0.0  # monotonic stamp of the last good probe
    resident: set = field(default_factory=set)
    #: True while a failover worker is still re-placing this pod's
    #: stranded tenants; rejoin is deferred until it finishes so the
    #: heal-time reconcile sees the final placement map.
    failover_inflight: bool = False

    @property
    def status(self) -> str:
        """One placement-relevant word: condemned > draining >
        degraded > ready > full > unprobed."""
        if self.condemned:
            return "condemned"
        h = self.health
        if h is None:
            return "unprobed"
        if h.get("draining"):
            return "draining"
        if not h.get("live", True):
            return "not-live"
        if h.get("degraded"):
            return "degraded"
        return "ready" if h.get("ready") else "full"

    def summary(self) -> dict:
        h = self.health or {}
        cap = h.get("capacity") or {}
        slo = h.get("slo") or {}
        return {
            "endpoint": self.endpoint,
            "status": self.status,
            "condemned": self.condemned,
            "misses": self.misses,
            "ready": bool(h.get("ready")),
            "degraded": bool(h.get("degraded")),
            "draining": bool(h.get("draining")),
            "devices_lost": h.get("devices_lost", 0),
            "resident_sessions": h.get("resident_sessions", 0),
            "queued_sessions": h.get("queued_sessions", 0),
            "resident_cells": h.get("resident_cells", 0),
            "effective_total_cells": cap.get("effective_total_cells"),
            "slo_alerting": list(slo.get("alerting") or ()),
            "placed": sorted(self.resident),
        }


def scan_resumable(root: str | Path | None) -> dict[str, dict]:
    """The broker-side twin of ``ServePlane.resumable_tenants``: scan
    the SHARED checkpoint root for tenants holding a paused durable
    sidecar — ``{tenant: {turn, shape, rule}}``, newest turn per
    tenant.  Standalone (no plane, no torch) because the broker process
    never owns sessions; the scan is how failover confirms a condemned
    pod left adoptable state, and how a restarted broker finds orphans
    no live pod claims."""
    out: dict[str, dict] = {}
    if root is None:
        return out
    root = Path(root)
    if not root.is_dir():
        return out
    for tenant_dir in sorted(p for p in root.iterdir() if p.is_dir()):
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


class Broker(StdlibHTTPServer):
    """The federation's front door.  Construct with the pod gateway
    endpoints; ``port=0`` binds ephemeral and publishes the URL as the
    ``broker.endpoint`` info label.

    Routes::

        GET  /healthz                      fleet aggregate (200 if any
                                           pod can admit, else 503)
        GET  /v1/pods                      per-pod detail (the fleet
                                           dashboard surface)
        POST /v1/sessions                  placement + forward
        GET  /v1/sessions                  merged CheckStates across pods
        GET  /v1/sessions/<t>[/state]      proxied to the owning pod
        POST /v1/sessions/<t>/pause|resume|quit   proxied control
        GET  /v1/sessions/<t>/placement    {tenant, pod} — the client's
                                           follow-the-placement hook
                                           (WS legs connect pod-direct)
        POST /v1/migrate                   {"tenant": t[, "to": url]} or
                                           {"pod": url[, "to": url]}
        POST /v1/recover                   sweep orphaned checkpoints
                                           onto live pods
        GET  /flight                       the broker's flight ring
        GET  /traces                       this process's trace surface
        GET  /metrics                      the broker's own registry
                                           (OpenMetrics)
        GET  /fleet/*                      the fleet observability
                                           surface (metrics, healthz,
                                           slo, traces/<id>, flight) —
                                           only with config.collector
    """

    thread_name = "gol-broker-http"

    def __init__(
        self,
        endpoints,
        config: BrokerConfig | None = None,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        self.config = config or BrokerConfig()
        reg = metrics_lib.REGISTRY
        self.metrics = reg
        self._m_requests = reg.counter("broker.requests")
        self._m_routed = reg.counter("broker.sessions_routed")
        self._m_rejected = reg.counter("broker.rejected")
        self._m_probes = reg.counter("broker.probes")
        self._m_probe_misses = reg.counter("broker.probe_misses")
        self._m_condemned = reg.counter("broker.pods_condemned")
        self._m_rejoined = reg.counter("broker.pods_rejoined")
        self._m_failovers = reg.counter("broker.failovers")
        self._m_failovers_lost = reg.counter("broker.failovers_lost")
        self._m_migrations = reg.counter("broker.migrations")
        self._m_rejoin_quits = reg.counter("broker.rejoin_quits")
        self._g_pods_ready = reg.gauge("broker.pods_ready")
        self.flight = FlightRecorder(self.config.flight_depth)
        self._lock = threading.Lock()
        self._pods: list[PodState] = [
            PodState(
                endpoint=e,
                client=PodClient(
                    e,
                    timeout=self.config.request_timeout_seconds,
                    probe_timeout=self.config.probe_timeout_seconds,
                    attempts=self.config.attempts,
                    backoff_seconds=self.config.backoff_seconds,
                    backoff_max_seconds=self.config.backoff_max_seconds,
                    connect_timeout=self.config.connect_timeout_seconds,
                ),
            )
            for e in endpoints
        ]
        if not self._pods:
            raise ValueError("a broker needs at least one pod endpoint")
        #: tenant -> PodState: who runs it now.
        self._placements: dict[str, PodState] = {}
        #: tenant -> the spec doc the client POSTed, verbatim — what
        #: failover/migration re-submits (the pod's wire.py re-derives
        #: everything else, including the shared-root out_dir).
        self._specs: dict[str, dict] = {}
        self._failover_threads: list[threading.Thread] = []
        self._closed = threading.Event()
        self._probe_wake = threading.Event()
        super().__init__(port=port, host=host, registry=reg,
                         request_counter=self._m_requests)
        reg.info("broker.endpoint", self.url)
        #: The in-broker fleet observability collector:
        #: armed by config, scrapes the SAME pod endpoints the prober
        #: probes and serves /fleet/* off this broker's port.  The
        #: broker's own flight ring and the shared checkpoint root join
        #: the merged postmortem; local_name folds the broker's
        #: process-wide registry (and its retained traces) in.
        self.collector = None
        if self.config.collector:
            from distributed_gol_torch.obs.fleet import FleetCollector

            self.collector = FleetCollector(
                list(endpoints),
                interval=self.config.collector_interval_seconds,
                scrape_timeout=self.config.collector_scrape_timeout_seconds,
                checkpoint_root=self.config.checkpoint_root,
                local_name="broker",
                local_flight=self.flight,
                registry=reg,
            )
        self._discover()
        self._prober = threading.Thread(
            target=self._probe_loop, name="gol-broker-prober", daemon=True
        )
        self._prober.start()

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        self._closed.set()
        self._probe_wake.set()
        if self.collector is not None:
            self.collector.close()
        super().close()
        self._prober.join(timeout=5)
        with self._lock:
            pending = list(self._failover_threads)
        for worker in pending:
            worker.join(timeout=5)

    def _discover(self) -> None:
        """Broker-restart re-discovery: the placement map is soft state,
        rebuilt from the pods' own session lists (a pod that answers
        owns what it lists) — so a broker crash loses no federation
        state.  Specs are NOT recoverable from the wire; re-discovered
        tenants fail over on their sidecar-reconstructed spec (resumed
        to the parked turn — no lost work, no invented work)."""
        for pod in self._pods:
            try:
                doc = pod.client.sessions()
            except (PodUnreachable, PodHTTPError):
                continue
            for tenant, row in (doc.get("sessions") or {}).items():
                if row.get("status") in _TERMINAL and not row.get("resumable"):
                    continue
                with self._lock:
                    pod.resident.add(tenant)
                    self._placements[tenant] = pod
        with self._lock:
            n = len(self._placements)
        if n:
            self.flight.record("discover", tenants=n)

    # -- the prober (the device-blacklist policy, one level up) ----------------
    def _probe_loop(self) -> None:
        while not self._closed.is_set():
            self.probe_once()
            self._probe_wake.wait(self.config.probe_interval_seconds)
            self._probe_wake.clear()

    def probe_once(self) -> None:
        """One probe cycle over every pod (also callable directly —
        tests and the bench drive condemnation deterministically without
        racing the wall-clock loop)."""
        for pod in self._pods:
            if self._closed.is_set():
                return
            self._m_probes.inc()
            try:
                health = pod.client.health()
            except (PodUnreachable, PodHTTPError):
                self._m_probe_misses.inc()
                condemn = False
                with self._lock:
                    pod.misses += 1
                    pod.healthy_streak = 0
                    if (
                        not pod.condemned
                        and pod.misses >= self.config.probe_miss_threshold
                    ):
                        pod.condemned = True
                        condemn = True
                if condemn:
                    self._on_condemned(pod)
                continue
            rejoin_due = False
            with self._lock:
                pod.misses = 0
                pod.health = health
                pod.health_age = time.monotonic()
                if pod.condemned:
                    pod.healthy_streak += 1
                    # Rejoin waits for the failover worker: reconcile
                    # must see where the stranded tenants LANDED.
                    rejoin_due = (
                        pod.healthy_streak >= self.config.rejoin_threshold
                        and not pod.failover_inflight
                    )
            if rejoin_due and self._reconcile_rejoin(pod):
                with self._lock:
                    pod.condemned = False
                    pod.healthy_streak = 0
                self._m_rejoined.inc()
                self.flight.record("pod_rejoined", pod=pod.endpoint)
        with self._lock:
            ready = sum(
                1 for p in self._pods
                if not p.condemned
                and p.misses == 0
                and (p.health or {}).get("ready")
            )
        self._g_pods_ready.set(ready)

    def _reconcile_rejoin(self, pod: PodState) -> bool:
        """The split-brain guard on partition heal: while the pod was
        condemned its residents failed over to survivors, but a
        partitioned (not dead) pod kept RUNNING them — readmitting it
        as-is would leave two pods writing the same shared
        ``root/<tenant>`` checkpoint directory, breaking the
        single-writer invariant the bit-identical resume guarantee
        rests on.  So before the ring takes the pod back: quit every
        session it still holds whose placement now points at a
        DIFFERENT pod (counted in ``broker.rejoin_quits``), and
        re-adopt into the books any live session nobody else owns (the
        pod carried it through the partition — failover had lost it).
        Returns False — rejoin deferred to the next healthy probe, the
        streak intact — when the pod cannot answer or a stale quit
        fails."""
        try:
            doc = pod.client.sessions()
        except (PodUnreachable, PodHTTPError):
            return False
        ok = True
        for tenant, row in sorted((doc.get("sessions") or {}).items()):
            status = row.get("status")
            if status in _TERMINAL and not row.get("resumable"):
                continue
            with self._lock:
                owner = self._placements.get(tenant)
                readopt = owner is None
                if readopt:
                    self._placements[tenant] = pod
                    pod.resident.add(tenant)
            if readopt:
                self.flight.record(
                    "rejoin_readopt", tenant=tenant, pod=pod.endpoint
                )
                continue
            if owner is pod or status in _TERMINAL:
                continue  # rightful resident / parked (not writing)
            try:
                pod.client.control(tenant, "quit")
            except PodHTTPError as e:
                if e.status != 404:  # gone already = already not writing
                    ok = False
                    continue
            except PodUnreachable:
                ok = False
                continue
            self._m_rejoin_quits.inc()
            self.flight.record(
                "rejoin_quit",
                tenant=tenant,
                pod=pod.endpoint,
                owner=owner.endpoint,
            )
        return ok

    def _on_condemned(self, pod: PodState) -> None:
        """A pod crossed the miss threshold: record it, then fail its
        residents over to the survivors on a worker thread — each
        re-submission is a bounded-timeout HTTP sweep, and the prober
        must keep its cadence (health data going stale behind a slow
        failover would delay condemning OTHER failing pods).
        Config-gated: a broker run as a pure balancer can leave
        adoption to operators."""
        self._m_condemned.inc()
        with self._lock:
            stranded = sorted(pod.resident)
        self.flight.record(
            "pod_condemned",
            pod=pod.endpoint,
            misses=pod.misses,
            stranded=stranded,
        )
        if not self.config.failover or not stranded:
            return
        worker = threading.Thread(
            target=self._failover,
            args=(pod, stranded),
            name="gol-broker-failover",
            daemon=True,
        )
        with self._lock:
            pod.failover_inflight = True
            self._failover_threads = [
                t for t in self._failover_threads if t.is_alive()
            ]
            self._failover_threads.append(worker)
        worker.start()

    # -- leg 1: failover -------------------------------------------------------
    def _failover(self, dead: PodState, tenants) -> None:
        """Re-adopt a dead pod's residents on the survivors, newest
        durable checkpoint first.  Each tenant's re-submission is one
        flagged trace (``gol.broker.failover``) so the postmortem
        timeline is retained regardless of sampling.  A tenant that
        cannot be re-placed is dropped from the placement map — the
        client's next ``/placement`` or state poll gets an honest 404
        instead of 502s against the condemned endpoint (its spec is
        kept, so ``/v1/recover`` or a fresh submit restores it)."""
        try:
            orphans = scan_resumable(self.config.checkpoint_root)
            for tenant in tenants:
                info = orphans.get(tenant)
                doc = self._respec(tenant, info)
                if doc is None:
                    self._m_failovers_lost.inc()
                    self._drop_placement(tenant, dead)
                    self.flight.record(
                        "failover_lost",
                        tenant=tenant,
                        pod=dead.endpoint,
                        reason="no spec and no resumable checkpoint",
                    )
                    continue
                trace = tracing.TRACER.start_trace(
                    "gol.broker.failover", tenant=tenant
                )
                trace.flag("failover")
                target, receipt, err, _ = self._place(
                    tenant, doc, trace, exclude=(dead,)
                )
                if target is None:
                    tracing.TRACER.end_trace(
                        trace, status="failed", error=err
                    )
                    self._m_failovers_lost.inc()
                    self._drop_placement(tenant, dead)
                    self.flight.record(
                        "failover_lost",
                        tenant=tenant,
                        pod=dead.endpoint,
                        reason=err or "no adoptive pod",
                    )
                    continue
                tracing.TRACER.end_trace(trace, status="ok")
                self._m_failovers.inc()
                self.flight.record(
                    "failover",
                    tenant=tenant,
                    from_pod=dead.endpoint,
                    to_pod=target.endpoint,
                    checkpoint_turn=info["turn"] if info else None,
                    trace_id=trace.trace_id,
                )
            with self._lock:
                dead.resident.clear()
        finally:
            with self._lock:
                dead.failover_inflight = False

    def _drop_placement(self, tenant: str, pod: PodState) -> None:
        """Forget a placement that still points at ``pod`` — the
        tenant could not be re-placed, and stale books would keep
        proxying its control plane into a dead endpoint."""
        with self._lock:
            if self._placements.get(tenant) is pod:
                del self._placements[tenant]
            pod.resident.discard(tenant)

    def _respec(self, tenant: str, info: dict | None) -> dict | None:
        """The spec failover re-submits: the client's original doc when
        the broker routed it, else one reconstructed from the durable
        sidecar (shape + rule + parked turn — the session resumes AND
        parks at its checkpoint turn: re-discovered tenants lose no
        work and are never run past what their owner asked for)."""
        with self._lock:
            doc = self._specs.get(tenant)
        if doc is not None:
            return dict(doc)
        if info is None or not info.get("shape"):
            return None
        import base64

        import numpy as np

        from distributed_gol_torch.engine import pgm

        h, w = info["shape"]
        params: dict = {"width": w, "height": h, "turns": info["turn"]}
        if info.get("rule"):
            params["rule"] = info["rule"]
        # The wire contract wants a board source, but the durable
        # checkpoint supplies the real board at adoption; an all-dead
        # upload makes a failed adoption loudly wrong (an empty board at
        # the parked turn) instead of silently plausible.
        dead = base64.b64encode(
            pgm.encode_pgm(np.zeros((h, w), dtype=np.uint8))
        ).decode()
        return {"tenant": tenant, "params": params, "board_b64": dead}

    # -- leg 2: live migration -------------------------------------------------
    def _migrate_tenant(
        self, tenant: str, to: str | None, wait_seconds: float = 30.0
    ) -> tuple[int, dict]:
        """Single-session migration: quit on the source parks the
        durable checkpoint; the readopt POST on the target resumes it
        bit-identical (reshard-on-restore absorbs mesh mismatch).  The
        quit is only issued once a plausible target exists (don't stop
        a healthy session just to discover the fleet is full), and a
        placement that still fails rolls back — the spec is re-submitted
        to the SOURCE pod, which readopts its own parked checkpoint, so
        the tenant is never left stopped with a stale placement."""
        with self._lock:
            source = self._placements.get(tenant)
            doc = self._specs.get(tenant)
        if source is None:
            return 404, {"error": f"no placement for {tenant!r}"}
        if doc is None:
            return 409, {"error": f"no stored spec for {tenant!r}"}
        target_only = None
        if to is not None:
            target_only = self._pod_by_endpoint(to)
            if target_only is None:
                return 404, {"error": f"unknown target pod {to!r}"}
            if target_only.condemned:
                return 409, {"error": f"target pod {to!r} is condemned"}
        elif not self._candidates(exclude=(source,)):
            return 503, {"error": "no admitting target pod in the ring"}
        try:
            source.client.control(tenant, "quit")
        except (PodUnreachable, PodHTTPError) as e:
            return 502, {"error": f"source quit failed: {e}"}
        parked = self._await_parked(source, tenant, wait_seconds)
        if not parked:
            return 504, {"error": f"{tenant!r} did not park in time"}
        trace = tracing.TRACER.start_trace(
            "gol.broker.migration", tenant=tenant
        )
        trace.flag("migration")
        target, receipt, err, _ = self._place(
            tenant, dict(doc), trace,
            exclude=(source,) if to is None else (),
            only=target_only,
        )
        if target is None:
            tracing.TRACER.end_trace(trace, status="failed", error=err)
            restored = self._restore_to_source(source, tenant, doc)
            self.flight.record(
                "migration_failed",
                tenant=tenant,
                from_pod=source.endpoint,
                restored=restored,
                error=err,
            )
            return 502, {
                "error": err or "no target pod",
                "restored": restored,
            }
        tracing.TRACER.end_trace(trace, status="ok")
        self._m_migrations.inc()
        self.flight.record(
            "migration",
            tenant=tenant,
            from_pod=source.endpoint,
            to_pod=target.endpoint,
            turn=parked.get("turn"),
            trace_id=trace.trace_id,
        )
        return 200, {
            "tenant": tenant,
            "from": source.endpoint,
            "to": target.endpoint,
            "turn": parked.get("turn"),
            "receipt": receipt,
        }

    def _restore_to_source(
        self, source: PodState, tenant: str, doc: dict
    ) -> bool:
        """Failed-migration rollback: the tenant is already quit and
        its parked checkpoint sits on the shared root, so re-submitting
        the spec to the source pod resumes it exactly where the aborted
        migration stopped it.  If even that fails the placement is
        dropped — an honest 404 beats books pointing at a stopped
        session."""
        try:
            source.client.submit(dict(doc))
        except (PodUnreachable, PodHTTPError):
            self._drop_placement(tenant, source)
            return False
        return True

    def _migrate_pod(self, endpoint: str, to: str | None) -> tuple[int, dict]:
        """Whole-pod migration: drain the source (its receipt lists
        every parked-resumable tenant and every shed queued admission),
        readopt the parked on the targets, spill the shed as fresh
        submissions — the warming-pod path."""
        source = self._pod_by_endpoint(endpoint)
        if source is None:
            return 404, {"error": f"unknown pod {endpoint!r}"}
        if to is not None and self._pod_by_endpoint(to) is None:
            return 404, {"error": f"unknown target pod {to!r}"}
        try:
            drained = source.client.drain(timeout=60.0)
        except (PodUnreachable, PodHTTPError) as e:
            return 502, {"error": f"drain failed: {e}"}
        receipt = drained.get("sessions") or {}
        moved, spilled, lost = [], [], []
        for tenant, row in sorted(receipt.items()):
            with self._lock:
                if self._placements.get(tenant) is not source:
                    continue
                doc = self._specs.get(tenant)
            if doc is None:
                continue
            if not (row.get("resumable") or row.get("status") == "shed"):
                continue  # completed/failed on the way down: nothing to move
            trace = tracing.TRACER.start_trace(
                "gol.broker.migration", tenant=tenant
            )
            trace.flag("migration")
            target, _, err, _ = self._place(
                tenant, dict(doc), trace,
                exclude=(source,) if to is None else (),
                only=self._pod_by_endpoint(to),
            )
            if target is None:
                tracing.TRACER.end_trace(trace, status="failed", error=err)
                # Honest books: the drained source no longer runs it.
                self._drop_placement(tenant, source)
                lost.append(tenant)
                continue
            tracing.TRACER.end_trace(trace, status="ok")
            self._m_migrations.inc()
            kind = "spill" if row.get("status") == "shed" else "migration"
            (spilled if kind == "spill" else moved).append(tenant)
            self.flight.record(
                kind,
                tenant=tenant,
                from_pod=source.endpoint,
                to_pod=target.endpoint,
                turn=row.get("turn"),
                trace_id=trace.trace_id,
            )
        with self._lock:
            source.resident.clear()
        return 200, {
            "pod": source.endpoint,
            "migrated": moved,
            "spilled": spilled,
            "lost": lost,
            "receipt": receipt,
        }

    def _await_parked(
        self, pod: PodState, tenant: str, wait_seconds: float
    ) -> dict | None:
        deadline = time.monotonic() + wait_seconds
        while time.monotonic() < deadline:
            try:
                state = pod.client.state(tenant)
            except (PodUnreachable, PodHTTPError):
                return None
            if state.get("status") in _TERMINAL:
                return state if state.get("resumable") else None
            time.sleep(0.05)
        return None

    def _pod_by_endpoint(self, endpoint: str | None) -> PodState | None:
        if endpoint is None:
            return None
        for pod in self._pods:
            if pod.endpoint == endpoint:
                return pod
        return None

    # -- leg 3: placement + degraded routing -----------------------------------
    def _candidates(self, exclude=()) -> list[PodState]:
        """Placement order: non-condemned, non-draining, live pods by
        descending effective headroom (cells the pod can still hold —
        the degraded capacity fraction is already inside
        ``effective_total_cells``), SLO-alerting pods last (burn-rate
        deprioritisation, not exclusion: a burning pod beats no pod)."""
        with self._lock:
            pods = [
                p for p in self._pods
                if p not in exclude
                and not p.condemned
                and p.health is not None
                and not p.health.get("draining")
                and p.health.get("live", True)
            ]

            def score(p: PodState) -> tuple:
                h = p.health or {}
                cap = h.get("capacity") or {}
                total = cap.get("effective_total_cells")
                headroom = (
                    float("inf") if total is None
                    else total - h.get("resident_cells", 0)
                )
                burning = bool((h.get("slo") or {}).get("alerting"))
                return (burning, -headroom, h.get("queued_sessions", 0))

            return sorted(pods, key=score)

    def _place(
        self,
        tenant: str,
        doc: dict,
        trace,
        exclude=(),
        only: PodState | None = None,
        hints: list | None = None,
    ) -> tuple[PodState | None, dict | None, str | None, tuple | None]:
        """Try candidates in placement order; a pod that sheds (429) or
        closes admissions (503) spills the submission to the next one
        (its ``retry_after`` hint collected into ``hints`` — the honest
        input to the broker's own Retry-After).  Returns
        ``(pod, receipt, None, None)`` or ``(None, None, why,
        permanent)``; a permanent pod answer (400/404/409) aborts the
        sweep — every other pod would refuse the same spec the same
        way — and comes back as ``permanent = (status, body)`` so the
        caller can relay the pod's verdict verbatim instead of masking
        a bad spec as a retryable 429."""
        t0 = tracing.clock_ns()
        pods = [only] if only is not None else self._candidates(exclude)
        trace.record_span(
            "gol.broker.place",
            t0,
            tracing.clock_ns(),
            tenant=tenant,
            candidates=len(pods),
        )
        last_err = "no admitting pod"
        for pod in pods:
            f0 = tracing.clock_ns()
            try:
                receipt = pod.client.submit(
                    dict(doc), traceparent=trace.traceparent()
                )
            except PodUnreachable as e:
                last_err = str(e)
                continue
            except PodHTTPError as e:
                last_err = f"{pod.endpoint}: HTTP {e.status}"
                if e.status in (429, 503):
                    if hints is not None and e.retry_after is not None:
                        hints.append(e.retry_after)
                    continue  # shed/draining: spill to the next pod
                body = dict(e.body) if isinstance(e.body, dict) else {
                    "error": str(e.body)
                }
                body["pod"] = pod.endpoint
                return None, None, last_err, (e.status, body)
            trace.record_span(
                "gol.broker.forward",
                f0,
                tracing.clock_ns(),
                tenant=tenant,
                pod=pod.endpoint,
            )
            with self._lock:
                old = self._placements.get(tenant)
                if old is not None and old is not pod:
                    old.resident.discard(tenant)
                self._placements[tenant] = pod
                self._specs[tenant] = dict(doc)
                pod.resident.add(tenant)
            return pod, receipt, None, None
        return None, None, last_err, None

    def _fleet_retry_after(self, hints) -> float:
        """Honest backpressure: the largest pod-provided 429 hint when
        any pod ANSWERED (fleet headroom speaks for itself), else the
        condemnation-recovery horizon — the earliest a condemned pod
        could rejoin and restore capacity."""
        hints = [h for h in hints if isinstance(h, (int, float)) and h > 0]
        if hints:
            return max(hints)
        horizon = self.config.probe_interval_seconds * (
            self.config.probe_miss_threshold + self.config.rejoin_threshold
        )
        return max(self.config.retry_after_seconds, horizon)

    # -- routing ---------------------------------------------------------------
    def fleet_health(self) -> dict:
        with self._lock:
            pods = [p.summary() for p in self._pods]
            placements = len(self._placements)
        ready = any(p["ready"] and not p["condemned"] for p in pods)
        return {
            "broker": True,
            "ready": ready,
            "live": True,
            "pods": pods,
            "pods_ready": sum(
                1 for p in pods if p["ready"] and not p["condemned"]
            ),
            "pods_condemned": sum(1 for p in pods if p["condemned"]),
            "placements": placements,
            "resident_sessions": sum(p["resident_sessions"] for p in pods),
            "queued_sessions": sum(p["queued_sessions"] for p in pods),
            "resident_cells": sum(p["resident_cells"] for p in pods),
        }

    def handle(self, request, method: str, path: str, query: dict) -> bool:
        if path == "/healthz" and method == "GET":
            health = self.fleet_health()
            request._send_json(200 if health["ready"] else 503, health)
            return True
        if path == "/v1/pods" and method == "GET":
            with self._lock:
                pods = [p.summary() for p in self._pods]
            request._send_json(200, {"pods": pods})
            return True
        if path == "/flight" and method == "GET":
            request._send_json(200, {"records": self.flight.records()})
            return True
        if path == "/traces" and method == "GET":
            code, obj = tracing.http_traces(query)
            request._send_json(code, obj)
            return True
        if path == "/metrics" and method == "GET":
            # The broker's OWN registry (a fleet collector scrapes this
            # like any node); the aggregated view is /fleet/metrics.
            text = openmetrics.render(self.metrics.snapshot().to_dict())
            request._send(200, text.encode(), openmetrics.CONTENT_TYPE)
            return True
        if self.collector is not None and path.startswith("/fleet"):
            return self.collector.handle_http(request, method, path, query)
        if path == "/v1/sessions":
            if method == "POST":
                return self._submit(request)
            if method == "GET":
                return self._list_sessions(request)
            return False
        if path == "/v1/migrate" and method == "POST":
            return self._migrate(request)
        if path == "/v1/recover" and method == "POST":
            return self._recover(request)
        parts = path.split("/")
        # /v1/sessions/<t>[/<action>]
        if len(parts) in (4, 5) and parts[1] == "v1" and parts[2] == "sessions":
            tenant = parts[3]
            action = parts[4] if len(parts) == 5 else None
            return self._proxy_session(request, method, tenant, action)
        return False

    def _submit(self, request) -> bool:
        try:
            doc = json.loads(read_body(request) or b"{}")
        except ValueError as e:
            request._send_json(400, {"error": f"body is not JSON: {e}"})
            return True
        tenant = doc.get("tenant") if isinstance(doc, dict) else None
        if not isinstance(tenant, str) or not tenant:
            request._send_json(400, {"error": "spec wants a tenant name"})
            return True
        trace = tracing.TRACER.start_trace(
            "gol.broker.request",
            traceparent=request.headers.get("traceparent"),
            tenant=tenant,
        )
        headers = [
            ("X-Gol-Trace-Id", trace.trace_id),
            ("traceparent", trace.traceparent()),
        ]
        hints: list = []
        pod, receipt, err, permanent = self._place(
            tenant, doc, trace, hints=hints
        )
        if pod is None:
            tracing.TRACER.end_trace(trace, status="rejected", error=err)
            self._m_rejected.inc()
            if permanent is not None:
                # A pod REFUSED the spec (bad spec, duplicate tenant…):
                # relay its status and body verbatim — retrying would
                # meet the same answer, so no Retry-After theatre.
                status, body = permanent
                request._send_json(status, body, headers=headers)
                return True
            retry_after = self._fleet_retry_after(hints)
            request._send_json(
                429,
                {
                    "error": err or "no admitting pod",
                    "retry_after": retry_after,
                },
                headers=[("Retry-After", f"{retry_after:g}")] + headers,
            )
            return True
        tracing.TRACER.end_trace(trace, status="routed")
        self._m_routed.inc()
        out = dict(receipt or {})
        out["pod"] = pod.endpoint
        out["broker_trace_id"] = trace.trace_id
        request._send_json(201, out, headers=headers)
        return True

    def _list_sessions(self, request) -> bool:
        out: dict = {}
        with self._lock:
            pods = list(self._pods)
        for pod in pods:
            if pod.condemned:
                continue
            try:
                doc = pod.client.sessions()
            except (PodUnreachable, PodHTTPError):
                continue
            for tenant, row in (doc.get("sessions") or {}).items():
                row = dict(row)
                row["pod"] = pod.endpoint
                out[tenant] = row
        request._send_json(200, {"sessions": out, "broker": True})
        return True

    def _proxy_session(self, request, method, tenant, action) -> bool:
        with self._lock:
            pod = self._placements.get(tenant)
        if pod is None:
            request._send_json(
                404, {"error": f"no placement for {tenant!r}"}
            )
            return True
        if method == "GET" and action == "placement":
            request._send_json(
                200,
                {
                    "tenant": tenant,
                    "pod": pod.endpoint,
                    "status": pod.status,
                },
            )
            return True
        if method == "GET" and action in (None, "state"):
            verb = ("GET", f"/v1/sessions/{tenant}/state")
        elif method == "POST" and action in ("pause", "resume", "quit"):
            verb = ("POST", f"/v1/sessions/{tenant}/{action}")
        else:
            return False
        try:
            doc = pod.client.request(*verb)
        except PodHTTPError as e:
            body = e.body if isinstance(e.body, dict) else {"error": str(e)}
            body["pod"] = pod.endpoint
            request._send_json(e.status, body)
            return True
        except PodUnreachable as e:
            request._send_json(
                502, {"error": str(e), "pod": pod.endpoint}
            )
            return True
        doc = dict(doc)
        doc["pod"] = pod.endpoint
        request._send_json(200, doc)
        return True

    def _migrate(self, request) -> bool:
        try:
            doc = json.loads(read_body(request) or b"{}")
        except ValueError as e:
            request._send_json(400, {"error": f"body is not JSON: {e}"})
            return True
        to = doc.get("to")
        if doc.get("tenant"):
            code, out = self._migrate_tenant(str(doc["tenant"]), to)
        elif doc.get("pod"):
            code, out = self._migrate_pod(str(doc["pod"]), to)
        else:
            code, out = 400, {"error": "migrate wants a tenant or a pod"}
        request._send_json(code, out)
        return True

    def _recover(self, request) -> bool:
        """Sweep the shared root for orphaned resumable checkpoints no
        live pod claims (the broker-restart-after-pod-loss hole: the
        dead pod is gone from the ring, so nothing condemns it) and
        readopt them — availability from durable state alone."""
        orphans = scan_resumable(self.config.checkpoint_root)
        with self._lock:
            owned = set(self._placements)
        adopted, lost = [], []
        for tenant, info in sorted(orphans.items()):
            if tenant in owned:
                continue
            doc = self._respec(tenant, info)
            if doc is None:
                lost.append(tenant)
                continue
            trace = tracing.TRACER.start_trace(
                "gol.broker.failover", tenant=tenant
            )
            trace.flag("recover")
            pod, _, err, _ = self._place(tenant, doc, trace)
            if pod is None:
                tracing.TRACER.end_trace(trace, status="failed", error=err)
                lost.append(tenant)
                continue
            tracing.TRACER.end_trace(trace, status="ok")
            self._m_failovers.inc()
            self.flight.record(
                "failover",
                tenant=tenant,
                from_pod=None,
                to_pod=pod.endpoint,
                checkpoint_turn=info["turn"],
                trace_id=trace.trace_id,
            )
            adopted.append(tenant)
        request._send_json(200, {"adopted": adopted, "lost": lost})
        return True

    # -- introspection (tests / bench) -----------------------------------------
    def placement(self, tenant: str) -> str | None:
        with self._lock:
            pod = self._placements.get(tenant)
            return pod.endpoint if pod else None

    def pod_states(self) -> list[dict]:
        with self._lock:
            return [p.summary() for p in self._pods]


__all__ = ["Broker", "BrokerConfig", "PodState", "scan_resumable"]
