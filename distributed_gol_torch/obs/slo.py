"""Per-tenant SLO tracking over the telemetry ring.

Two objective kinds, both judged from the sampler's ring — never from a
device — so evaluation is bounded-time and a wedged tenant cannot stall
its own (or anyone else's) verdict:

- **Latency**: "``latency_percentile`` of dispatches resolve within
  ``latency_seconds``".  The violating fraction over a window comes from
  the per-tenant ``controller.dispatch_seconds{tenant=}`` histogram
  delta, with the threshold rounded DOWN to a bucket bound
  (:func:`obs.timeseries.fraction_above` — conservative, never
  under-reports).
- **Error rate**: "at most ``error_rate`` of dispatch attempts fail",
  from the per-tenant ``controller.dispatch_failures{tenant=}`` vs
  ``controller.dispatches{tenant=}`` counter deltas.

**Burn rate** is the standard SRE quotient: the observed bad fraction
over a window divided by the fraction the objective allows (1.0 = the
error budget spends exactly at sustainable pace).  Alerts are
multi-window: a tenant pages only when BOTH the fast and the slow
window burn above ``burn_threshold`` — a one-sample blip can't page,
a sustained burn can't hide.  Until the ring spans a window, the whole
ring stands in for it (documented warm-up: a young pod alerts on
sustained early burn rather than staying blind for a slow-window).

**Error budget** is tracked over ``budget_window_seconds`` — clamped to
the sampler ring's span (``ServeConfig`` validates the slow window fits
the ring and ships defaults where the budget window equals the span;
an oversized budget window degrades to the ring, never silently to
less): ``remaining = 1 - bad_events / (allowed_fraction ·
total_events)``, clamped to [0, 1], published as the per-tenant
``slo.error_budget_remaining{tenant=}`` gauge — the WORST (minimum)
across armed objectives — with the per-objective fast burn rates
beside it (``slo.<objective>_burn_rate{tenant=}``).

Alert transitions are edge-triggered into the plane's flight ring
(``slo_alert`` records, rendered by ``tools/flight_report.py``) and the
``serve.slo_alerts`` counter; the full per-tenant table rides
``ServePlane.health()["slo"]`` and the ``/slo`` endpoint.
"""

from __future__ import annotations

from dataclasses import dataclass

from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs.timeseries import (
    TelemetrySampler,
    fraction_above,
    histogram_delta_percentiles,
)


@dataclass(frozen=True)
class SLOObjectives:
    """The objective set one pod enforces (built by ``ServePlane`` from
    ``ServeConfig``'s ``slo_*`` fields).  An objective with its
    threshold at 0 is OFF."""

    latency_seconds: float = 0.0  # 0 = no latency objective
    latency_percentile: float = 0.99  # "p99 under latency_seconds"
    error_rate: float = 0.0  # 0 = no error objective
    fast_window_seconds: float = 60.0
    slow_window_seconds: float = 300.0
    burn_threshold: float = 2.0
    budget_window_seconds: float = 3600.0
    # Queue-wait objective: "latency_percentile of
    # admissions start within queue_wait_seconds", judged from the
    # per-tenant ``sli.queue_wait_seconds{tenant=}`` histogram the
    # request-tracing plane observes at session start — the admission
    # half of request latency the dispatch objective cannot see.
    queue_wait_seconds: float = 0.0

    def __post_init__(self):
        if (
            self.latency_seconds < 0
            or self.error_rate < 0
            or self.queue_wait_seconds < 0
        ):
            raise ValueError("SLO thresholds must be >= 0 (0 disables)")
        if not 0 < self.latency_percentile < 1:
            raise ValueError("latency_percentile must be in (0, 1)")
        if not 0 < self.fast_window_seconds <= self.slow_window_seconds:
            raise ValueError(
                "windows must satisfy 0 < fast <= slow"
            )
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be positive")
        if self.budget_window_seconds <= 0:
            raise ValueError("budget_window_seconds must be positive")

    @property
    def enabled(self) -> bool:
        return (
            self.latency_seconds > 0
            or self.error_rate > 0
            or self.queue_wait_seconds > 0
        )


def _tenants_of(snapshot: dict) -> set[str]:
    out = set()
    for name in snapshot.get("counters", {}):
        t = metrics_lib.tenant_of(name)
        if t is not None and name.startswith("controller."):
            out.add(t)
    # A queued tenant has SLI observations before its first dispatch
    # counter exists — the queue-wait objective must see it.
    for name in snapshot.get("histograms", {}):
        t = metrics_lib.tenant_of(name)
        if t is not None and name.startswith(("controller.", "sli.")):
            out.add(t)
    return out


class SLOTracker:
    """Evaluates :class:`SLOObjectives` for every tenant visible in the
    sampler ring; designed to run as the sampler's ``on_sample`` hook
    (one evaluation per sample, pure ring reads)."""

    def __init__(self, objectives: SLOObjectives, registry, flight=None):
        self.objectives = objectives
        self.registry = registry
        self.flight = flight  # the plane's ring; None = no records
        self._m_alerts = registry.counter("serve.slo_alerts")
        # (tenant, objective) pairs currently alerting — the edge trigger.
        self._alerting: set[tuple[str, str]] = set()
        self._summary: dict[str, dict] = {}

    # -- the window math -------------------------------------------------------
    def _hist_bad_fraction(
        self,
        sampler: TelemetrySampler,
        metric: str,
        tenant: str,
        window_seconds: float,
        threshold: float,
    ) -> float | None:
        """Fraction of ``metric``'s window observations above
        ``threshold`` (bucket-rounded-down, conservative) — shared by
        the dispatch-latency and queue-wait objectives."""
        w = sampler.window(window_seconds)
        if w is None:
            return None
        old, new = w
        name = metrics_lib.labelled(metric, tenant)
        return fraction_above(
            new.snapshot.get("histograms", {}).get(name),
            old.snapshot.get("histograms", {}).get(name),
            threshold,
        )

    def _latency_bad_fraction(
        self, sampler: TelemetrySampler, tenant: str, seconds: float
    ) -> float | None:
        return self._hist_bad_fraction(
            sampler,
            "controller.dispatch_seconds",
            tenant,
            seconds,
            self.objectives.latency_seconds,
        )

    def _error_fraction(
        self, sampler: TelemetrySampler, tenant: str, seconds: float
    ):
        """(bad, total) dispatch attempts over the window, or None."""
        ok = sampler.counter_delta(
            metrics_lib.labelled("controller.dispatches", tenant), seconds
        )
        bad = sampler.counter_delta(
            metrics_lib.labelled("controller.dispatch_failures", tenant),
            seconds,
        )
        if ok is None:
            return None
        n_ok = ok[0]
        n_bad = bad[0] if bad is not None else 0
        total = n_ok + n_bad
        return (n_bad, total) if total > 0 else None

    def _burn(self, bad_fraction: float | None, allowed: float) -> float | None:
        if bad_fraction is None:
            return None
        return bad_fraction / max(allowed, 1e-9)

    # -- evaluation (the sampler hook) -----------------------------------------
    def observe(self, sampler: TelemetrySampler) -> dict[str, dict]:
        """One evaluation pass; returns (and retains, for ``summary``)
        the per-tenant table."""
        obj = self.objectives
        latest = sampler.latest()
        if latest is None or not obj.enabled:
            return self._summary
        table: dict[str, dict] = {}
        for tenant in sorted(_tenants_of(latest.snapshot)):
            row: dict = {}
            # Live latency percentiles for the dashboard, objective or not.
            pcts = sampler.percentiles(
                metrics_lib.labelled("controller.dispatch_seconds", tenant),
                obj.fast_window_seconds,
            )
            if pcts is not None:
                row["resolve_latency"] = pcts
            if obj.latency_seconds > 0:
                allowed = 1.0 - obj.latency_percentile
                row["latency"] = self._objective_row(
                    tenant,
                    "latency",
                    allowed,
                    fast=self._latency_bad_fraction(
                        sampler, tenant, obj.fast_window_seconds
                    ),
                    slow=self._latency_bad_fraction(
                        sampler, tenant, obj.slow_window_seconds
                    ),
                    budget=self._latency_bad_fraction(
                        sampler, tenant, obj.budget_window_seconds
                    ),
                )
            if obj.queue_wait_seconds > 0:
                allowed = 1.0 - obj.latency_percentile
                qwait = lambda window: self._hist_bad_fraction(  # noqa: E731
                    sampler,
                    "sli.queue_wait_seconds",
                    tenant,
                    window,
                    obj.queue_wait_seconds,
                )
                row["queue_wait"] = self._objective_row(
                    tenant,
                    "queue_wait",
                    allowed,
                    fast=qwait(obj.fast_window_seconds),
                    slow=qwait(obj.slow_window_seconds),
                    budget=qwait(obj.budget_window_seconds),
                )
            if obj.error_rate > 0:
                fast = self._error_fraction(
                    sampler, tenant, obj.fast_window_seconds
                )
                slow = self._error_fraction(
                    sampler, tenant, obj.slow_window_seconds
                )
                budget = self._error_fraction(
                    sampler, tenant, obj.budget_window_seconds
                )
                row["errors"] = self._objective_row(
                    tenant,
                    "errors",
                    obj.error_rate,
                    fast=None if fast is None else fast[0] / fast[1],
                    slow=None if slow is None else slow[0] / slow[1],
                    budget=None if budget is None else budget[0] / budget[1],
                )
            table[tenant] = row
            # One budget gauge per tenant: the WORST (minimum) remaining
            # across armed objectives — the operationally meaningful
            # number (a dashboard must not show a full error budget
            # while the latency budget is burnt).
            budgets = [
                o["budget_remaining"]
                for o in (
                    row.get("latency"),
                    row.get("errors"),
                    row.get("queue_wait"),
                )
                if o is not None and o.get("budget_remaining") is not None
            ]
            if budgets:
                self.registry.gauge(
                    metrics_lib.labelled("slo.error_budget_remaining", tenant)
                ).set(round(min(budgets), 4))
        # Tenants that left the snapshot (terminal handle evicted,
        # labelled instruments cleared) must not haunt the alert set:
        # un-latch them so a REUSED tenant name can page again, and the
        # /slo 'alerting' list stops naming ghosts.
        for key in [k for k in self._alerting if k[0] not in table]:
            self._alerting.discard(key)
            if self.flight is not None:
                self.flight.record(
                    "slo_resolved",
                    tenant=key[0],
                    objective=key[1],
                    reason="tenant evicted",
                )
        self._summary = table
        return table

    def _objective_row(
        self,
        tenant: str,
        objective: str,
        allowed: float,
        fast: float | None,
        slow: float | None,
        budget: float | None,
    ) -> dict:
        obj = self.objectives
        burn_fast = self._burn(fast, allowed)
        burn_slow = self._burn(slow, allowed)
        alerting = (
            burn_fast is not None
            and burn_slow is not None
            and burn_fast > obj.burn_threshold
            and burn_slow > obj.burn_threshold
        )
        remaining = None
        if budget is not None:
            remaining = max(0.0, min(1.0, 1.0 - budget / max(allowed, 1e-9)))
        key = (tenant, objective)
        if alerting and key not in self._alerting:
            self._alerting.add(key)
            self._m_alerts.inc()
            if self.flight is not None:
                self.flight.record(
                    "slo_alert",
                    tenant=tenant,
                    objective=objective,
                    burn_fast=round(burn_fast, 3),
                    burn_slow=round(burn_slow, 3),
                    threshold=obj.burn_threshold,
                    budget_remaining=(
                        round(remaining, 4) if remaining is not None else None
                    ),
                )
        elif not alerting and key in self._alerting:
            self._alerting.discard(key)
            if self.flight is not None:
                self.flight.record(
                    "slo_resolved", tenant=tenant, objective=objective
                )
        # Per-objective burn gauges; the single budget gauge is set by
        # observe() as the minimum across objectives.
        self.registry.gauge(
            metrics_lib.labelled(f"slo.{objective}_burn_rate", tenant)
        ).set(round(burn_fast, 4) if burn_fast is not None else -1.0)
        return {
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "alerting": alerting,
            "budget_remaining": remaining,
        }

    def summary(self) -> dict:
        """The ``health()['slo']`` / ``/slo`` payload: objectives +
        latest per-tenant table."""
        obj = self.objectives
        return {
            "objectives": {
                "latency_seconds": obj.latency_seconds,
                "latency_percentile": obj.latency_percentile,
                "error_rate": obj.error_rate,
                "fast_window_seconds": obj.fast_window_seconds,
                "slow_window_seconds": obj.slow_window_seconds,
                "burn_threshold": obj.burn_threshold,
                "budget_window_seconds": obj.budget_window_seconds,
                "queue_wait_seconds": obj.queue_wait_seconds,
            },
            "alerting": sorted(
                f"{t}:{o}" for t, o in self._alerting
            ),
            "tenants": self._summary,
        }


__all__ = [
    "SLOObjectives",
    "SLOTracker",
    "histogram_delta_percentiles",
]
