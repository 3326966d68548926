"""Fleet observability plane: the first subsystem whose unit
of observation is the FLEET, not the process.

A copy of ``distributed_gol_tpu/obs/fleet.py`` over the port's registry,
OpenMetrics parser, samplers and pod client.

Everything the per-process planes built — flight rings, ``/metrics`` + SLOs,
``/traces`` — is per-process: a failover is three disjoint stories on
three ports.  :class:`FleetCollector` is the device-less federation of
those surfaces:

- **Federated scrape plane.**  Every node's ``/metrics`` (OpenMetrics
  text, re-parsed via :func:`obs.openmetrics.parse`) + ``/healthz`` is
  scraped on a cadence into bounded per-node
  :class:`~distributed_gol_torch.obs.timeseries.TelemetrySampler` rings
  (over :class:`~distributed_gol_torch.obs.timeseries.SnapshotRegistry`
  shims), and a fleet-AGGREGATE ring samples their merge
  (:func:`obs.metrics.aggregate_snapshots`: counters sum, gauges max,
  histogram buckets sum).  ``/fleet/metrics`` re-exports ONE OpenMetrics
  page: the aggregate families unlabelled beside every node's families
  under a ``node=`` label.  A dead node's last-good snapshot stays in
  the aggregate (its counters are history, not state), which is exactly
  what makes a migrated tenant's fleet SLO budget CONTINUOUS — the
  budget window sums ``tenant=`` counters across every pod that ever
  ran the tenant.
- **Trace stitching.**  ``/fleet/traces/<id>`` fans the prefix lookup
  to every node's ``/traces`` (plus the local tracer when the collector
  rides in-broker) and merges the span forests on the shared trace id
  via :func:`obs.tracing.stitch_traces` — broker ``gol.broker.*``, pod
  ``gol.request``→dispatch, relay subscribe/first-frame, one timeline.
- **Merged postmortems.**  ``/fleet/flight`` time-orders the local
  (broker) flight ring, every node's ``/flight`` ring, and the on-disk
  ``flight-*.json`` abort dumps under the shared checkpoint root into
  one node-stamped sequence: a SIGKILL failover reads
  ``pod_condemned → failover → rejoin_readopt`` in one report.

Never-block contract (the sampler's staleness contract, fleet-
sized): scrapes use bounded per-node HTTP timeouts
(:class:`~distributed_gol_torch.serve.podclient.PodClient` with
``attempts=1``); a wedged or dead node costs one bounded miss
(``fleet.scrape_misses{node=}``) per round, its ring simply stops
advancing, and its growing ``sample_age_seconds`` is surfaced in
``/fleet/healthz`` beside the ``staleness_bound_seconds`` the cadence
promises.  Every ``/fleet/*`` read is served from the rings — pure
in-memory (plus one bounded directory glob for ``/fleet/flight``) —
so a scrape storm or a dying pod can never wedge the observers.

Zero device deps: importable and runnable without torch, like the broker
and relay tiers.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Mapping, Sequence
from urllib.parse import urlsplit

from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import openmetrics, tracing
from distributed_gol_torch.obs.flight import load_flight_record
from distributed_gol_torch.obs.timeseries import (
    SnapshotRegistry,
    TelemetrySampler,
    fraction_above,
)
from distributed_gol_torch.serve.podclient import (
    PodClient,
    PodHTTPError,
    PodUnreachable,
)

FLEET_FLIGHT_SCHEMA = "gol-fleet-flight-v1"
FLEET_SLO_SCHEMA = "gol-fleet-slo-v1"

#: Mangled (post-:func:`openmetrics.parse`) spellings of the SLI
#: instruments the fleet burn math reads from the AGGREGATE ring — the
#: per-process :class:`obs.slo.SLOTracker` reads the unmangled names.
_M_DISPATCHES = "gol_controller_dispatches"
_M_FAILURES = "gol_controller_dispatch_failures"
_M_LATENCY = "gol_controller_dispatch_seconds"


def node_name(url: str) -> str:
    """The default ``node=`` label value for one scrape target: its
    ``host:port`` (stable, unique per endpoint, safe in the registry's
    ``{node=...}`` spelling — no ``,``/``=``/braces)."""
    net = urlsplit(url).netloc
    return net or url


def _empty_snapshot() -> dict:
    return {
        "schema": metrics_lib.SCHEMA,
        "counters": {},
        "gauges": {},
        "histograms": {},
        "info": {},
    }


class _Node:
    """One scrape target's books: transport, last-good scrape results,
    and the per-node time-series ring."""

    def __init__(self, name: str, url: str, timeout: float, interval: float,
                 depth: int, registry):
        self.name = name
        self.url = url
        self.client = PodClient(url, timeout=timeout, attempts=1)
        self.metrics: dict | None = None  # last-good parsed gol-metrics-v1
        self.health: dict | None = None  # last-good /healthz body
        self.consecutive_misses = 0
        self.last_error: str | None = None
        self.sampler = TelemetrySampler(
            registry=SnapshotRegistry(lambda: self.metrics, registry),
            interval=interval,
            depth=depth,
        )


class FleetCollector:
    """The device-less collector (module doc).  ``nodes`` maps node name
    → base URL (a plain URL sequence auto-names via :func:`node_name`).
    Rides in-broker (the broker delegates ``/fleet/*`` to
    :meth:`handle_http` and passes its flight ring as ``local_flight``)
    or standalone behind :class:`CollectorServer`.

    ``objectives`` (an :class:`obs.slo.SLOObjectives` or None) arms the
    fleet-level burn math ``/fleet/slo`` computes over the aggregate
    ring; without it the endpoint still reports per-tenant fleet
    dispatch totals (the budget-continuity surface).
    """

    def __init__(
        self,
        nodes: Mapping[str, str] | Sequence[str],
        interval: float = 0.5,
        scrape_timeout: float = 2.0,
        depth: int = 240,
        checkpoint_root: str | Path | None = None,
        objectives=None,
        local_name: str | None = None,
        local_flight=None,
        registry=None,
        start: bool = True,
    ):
        if interval <= 0:
            raise ValueError("collector interval must be positive")
        if scrape_timeout <= 0:
            raise ValueError("collector scrape timeout must be positive")
        if not isinstance(nodes, Mapping):
            nodes = {node_name(u): u for u in nodes}
        if not nodes:
            raise ValueError("a collector needs at least one node")
        self.interval = interval
        self.scrape_timeout = scrape_timeout
        self.checkpoint_root = (
            Path(checkpoint_root) if checkpoint_root is not None else None
        )
        self.objectives = objectives
        self.local_name = local_name
        self.local_flight = local_flight
        self.registry = (
            registry if registry is not None else metrics_lib.REGISTRY
        )
        self._nodes = {
            name: _Node(
                name, url, scrape_timeout, interval, depth, self.registry
            )
            for name, url in nodes.items()
        }
        self._agg: dict = _empty_snapshot()
        self._agg_sampler = TelemetrySampler(
            registry=SnapshotRegistry(lambda: self._agg, self.registry),
            interval=interval,
            depth=depth,
        )
        self._m_rounds = self.registry.counter("fleet.scrape_rounds")
        self._m_misses = {
            name: self.registry.counter(
                f"fleet.scrape_misses{{node={name}}}"
            )
            for name in self._nodes
        }
        self.registry.gauge("fleet.nodes").set(len(self._nodes))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self.start()

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "FleetCollector":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gol-fleet-collector", daemon=True
        )
        self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — observers never kill the host
                continue

    # -- the scrape round ------------------------------------------------------
    def scrape_once(self) -> None:
        """One round: scrape every node (bounded per-node timeouts),
        advance the per-node rings that answered, then re-aggregate and
        advance the fleet ring.  Public so tests drive rounds without
        wall-clock waits (the ``probe_once`` idiom)."""
        for node in self._nodes.values():
            self._scrape_node(node)
        merged = metrics_lib.aggregate_snapshots(
            [n.metrics for n in self._nodes.values() if n.metrics is not None]
        )
        self._agg = merged
        self._agg_sampler.sample_now(lazy=False)
        self._m_rounds.inc()

    def _scrape_node(self, node: _Node) -> None:
        try:
            doc = node.client.request("GET", "/metrics")
            text = doc.get("raw") if isinstance(doc, dict) else None
            if text is None:
                raise ValueError("/metrics did not return exposition text")
            node.metrics = openmetrics.parse(text)
            node.health = node.client.health()
            node.consecutive_misses = 0
            node.last_error = None
            node.sampler.sample_now(lazy=False)
        except (PodUnreachable, PodHTTPError, ValueError, OSError) as e:
            node.consecutive_misses += 1
            node.last_error = f"{type(e).__name__}: {e}"
            self._m_misses[node.name].inc()

    # -- /fleet/metrics --------------------------------------------------------
    def merged_snapshot(self) -> dict:
        """The export snapshot: fleet-aggregate families (unlabelled) +
        every node's families re-keyed under ``node=`` + the collector's
        own local instruments (``fleet.*`` and, riding in-broker, the
        ``broker.*`` families).  Pure ring/registry reads."""
        out = _empty_snapshot()
        for section in ("counters", "gauges", "histograms", "info"):
            out[section].update(self._agg.get(section, {}))
        for node in self._nodes.values():
            snap = node.metrics
            if snap is None:
                continue
            for section in ("counters", "gauges", "histograms", "info"):
                for key, v in snap.get(section, {}).items():
                    base, labels = openmetrics.split_all(key)
                    labels["node"] = node.name
                    out[section][openmetrics.spell(base, labels)] = v
        local = self.registry.snapshot(include_lazy=False).to_dict()
        for section in ("counters", "gauges", "histograms", "info"):
            for key, v in local.get(section, {}).items():
                base, labels = openmetrics.split_all(key)
                mangled = openmetrics.spell(
                    openmetrics.metric_name(base), labels
                )
                # An in-process pod sharing the collector's registry
                # already rides the aggregate — exporting its local
                # spelling too would render duplicate sample lines.
                if mangled in out[section]:
                    continue
                out[section][key] = v
        return out

    def render_metrics(self) -> str:
        return openmetrics.render(self.merged_snapshot())

    # -- /fleet/healthz --------------------------------------------------------
    def fleet_health(self) -> dict:
        """Fleet readiness + the per-node staleness contract: each node
        row carries ``sample_age_seconds`` (its ring's actual age)
        beside the ``staleness_bound_seconds`` the cadence promises —
        the sampler's contract, per scrape target.  ``stale`` marks
        a node whose last-good sample has outlived twice the bound."""
        now = time.time()
        nodes = {}
        ready = True
        bound = self.interval + self.scrape_timeout
        for node in self._nodes.values():
            age = node.sampler.staleness
            stale = age > 2 * bound
            node_ready = bool((node.health or {}).get("ready")) and not stale
            latest = node.sampler.latest()
            nodes[node.name] = {
                "url": node.url,
                "ready": node_ready,
                "stale": stale,
                "sample_age_seconds": (
                    round(age, 3) if age != float("inf") else None
                ),
                "last_sample_t": round(latest.t, 3) if latest else None,
                "consecutive_misses": node.consecutive_misses,
                "last_error": node.last_error,
            }
            ready = ready and node_ready
        agg_age = self._agg_sampler.staleness
        return {
            "fleet": True,
            "ready": ready,
            "nodes": nodes,
            "scrape_interval_seconds": self.interval,
            "staleness_bound_seconds": bound,
            "aggregate_sample_age_seconds": (
                round(agg_age, 3) if agg_age != float("inf") else None
            ),
            "t": round(now, 3),
        }

    # -- /fleet/slo ------------------------------------------------------------
    def fleet_slo(self) -> dict:
        """Per-tenant SLI/SLO rollup over the AGGREGATE ring — the fleet
        keeps one continuous series per tenant across migrations because
        the aggregate sums every pod's ``tenant=`` counters (dead pods'
        last-good snapshots included).  Burn rates mirror
        ``obs.slo.SLOTracker`` (bad_fraction / allowed per window, both
        windows over threshold = alerting) but read the mangled
        post-``parse`` instrument names."""
        obj = self.objectives
        sampler = self._agg_sampler
        latest = sampler.latest()
        out: dict = {
            "schema": FLEET_SLO_SCHEMA,
            "aggregate": True,
            "tenants": {},
        }
        if obj is not None:
            out["objectives"] = {
                "latency_seconds": obj.latency_seconds,
                "latency_percentile": obj.latency_percentile,
                "error_rate": obj.error_rate,
                "fast_window_seconds": obj.fast_window_seconds,
                "slow_window_seconds": obj.slow_window_seconds,
                "burn_threshold": obj.burn_threshold,
                "budget_window_seconds": obj.budget_window_seconds,
            }
        if latest is None:
            return out
        tenants = set()
        for key in latest.snapshot.get("counters", {}):
            base, labels = openmetrics.split_all(key)
            if base == _M_DISPATCHES and "tenant" in labels:
                tenants.add(labels["tenant"])
        windows = [("budget", None if obj is None else obj.budget_window_seconds)]
        if obj is not None:
            windows = [
                ("fast", obj.fast_window_seconds),
                ("slow", obj.slow_window_seconds),
                ("budget", obj.budget_window_seconds),
            ]
        for tenant in sorted(tenants):
            d_key = openmetrics.spell(_M_DISPATCHES, {"tenant": tenant})
            f_key = openmetrics.spell(_M_FAILURES, {"tenant": tenant})
            h_key = openmetrics.spell(_M_LATENCY, {"tenant": tenant})
            row: dict = {
                "dispatches_total": latest.snapshot["counters"].get(d_key, 0),
                "failures_total": latest.snapshot["counters"].get(
                    f_key, 0
                ),
            }
            alerting = []
            for wname, seconds in windows:
                w = sampler.window(seconds)
                if w is None:
                    continue
                old, new = w
                oc = old.snapshot.get("counters", {})
                nc = new.snapshot.get("counters", {})
                dd = nc.get(d_key, 0) - oc.get(d_key, 0)
                fd = nc.get(f_key, 0) - oc.get(f_key, 0)
                wrow: dict = {
                    "window_seconds": round(new.t - old.t, 3),
                    "dispatches": dd,
                    "failures": fd,
                }
                if obj is not None and obj.latency_seconds > 0:
                    bad = fraction_above(
                        new.snapshot.get("histograms", {}).get(h_key),
                        old.snapshot.get("histograms", {}).get(h_key),
                        obj.latency_seconds,
                    )
                    allowed = 1.0 - obj.latency_percentile
                    if bad is not None:
                        wrow["latency_bad_fraction"] = round(bad, 6)
                        wrow["latency_burn"] = round(bad / allowed, 3)
                if obj is not None and obj.error_rate > 0 and dd > 0:
                    err = fd / dd
                    wrow["error_fraction"] = round(err, 6)
                    wrow["error_burn"] = round(err / obj.error_rate, 3)
                row[wname] = wrow
            if obj is not None and "fast" in row and "slow" in row:
                for kind in ("latency", "error"):
                    fast = row["fast"].get(f"{kind}_burn")
                    slow = row["slow"].get(f"{kind}_burn")
                    if (
                        fast is not None
                        and slow is not None
                        and fast > obj.burn_threshold
                        and slow > obj.burn_threshold
                    ):
                        alerting.append(kind)
            if obj is not None and "budget" in row:
                budget = row["budget"]
                remaining = 1.0
                if obj.latency_seconds > 0:
                    bad = budget.get("latency_bad_fraction")
                    if bad is not None:
                        allowed = 1.0 - obj.latency_percentile
                        remaining = min(
                            remaining, max(0.0, 1.0 - bad / allowed)
                        )
                if obj.error_rate > 0:
                    err = budget.get("error_fraction")
                    if err is not None:
                        remaining = min(
                            remaining,
                            max(0.0, 1.0 - err / obj.error_rate),
                        )
                row["budget_remaining"] = round(remaining, 6)
            row["alerting"] = alerting
            out["tenants"][tenant] = row
        return out

    # -- /fleet/traces ---------------------------------------------------------
    def stitched_trace(self, trace_id: str) -> dict | None:
        """Fan ``GET /traces?trace_id=&all=1`` to every node (bounded
        by the scrape timeout), include every leg the local tracer
        retains when riding in-broker, and merge on the shared id.
        The ``all`` form matters: one process can hold a finished
        request leg AND a live relay leg on the same id, and the
        stitch wants both lanes."""
        hits: dict[str, list[dict]] = {}
        if self.local_name is not None:
            docs = tracing.TRACER.lookup_all(trace_id)
            if docs:
                hits[self.local_name] = docs
        for node in self._nodes.values():
            try:
                doc = node.client.request(
                    "GET", f"/traces?trace_id={trace_id}&all=1"
                )
            except (PodUnreachable, PodHTTPError, OSError):
                continue
            if not isinstance(doc, dict):
                continue
            if isinstance(doc.get("traces"), list):
                hits.setdefault(node.name, []).extend(
                    d for d in doc["traces"]
                    if isinstance(d, dict) and d.get("trace_id")
                )
            elif doc.get("trace_id"):
                # A node that predates the ``all`` form answers with
                # its single best leg — still stitchable.
                hits.setdefault(node.name, []).append(doc)
        return tracing.stitch_traces(hits)

    # -- /fleet/flight ---------------------------------------------------------
    def merged_flight(self, limit: int = 512) -> dict:
        """One time-ordered, node-stamped postmortem sequence: the local
        (broker) ring, every node's ``/flight`` ring, and the abort
        dumps parked as ``flight-*.json`` under the shared checkpoint
        root.  Nodes without a ``/flight`` surface (or dead ones) are
        skipped — their on-disk dumps still tell their half."""
        records: list[dict] = []
        sources: list[str] = []
        if self.local_flight is not None and self.local_name is not None:
            sources.append(self.local_name)
            for r in self.local_flight.records():
                records.append({**r, "node": self.local_name})
        for node in self._nodes.values():
            try:
                doc = node.client.request("GET", "/flight")
            except (PodUnreachable, PodHTTPError, OSError):
                continue
            if isinstance(doc, dict) and isinstance(doc.get("records"), list):
                sources.append(node.name)
                for r in doc["records"]:
                    if isinstance(r, dict):
                        records.append({**r, "node": node.name})
        if self.checkpoint_root is not None and self.checkpoint_root.is_dir():
            for path in sorted(self.checkpoint_root.rglob("flight-*.json")):
                try:
                    doc = load_flight_record(path)
                except (OSError, ValueError):
                    continue
                src = str(path.relative_to(self.checkpoint_root))
                sources.append(f"dump:{src}")
                stamp = {
                    "node": f"dump:{src}",
                    "cause": doc.get("cause"),
                }
                for r in doc.get("records", []):
                    if isinstance(r, dict):
                        records.append({**r, **stamp})
        records.sort(key=lambda r: r.get("t", 0))
        if limit > 0:
            records = records[-limit:]
        return {
            "schema": FLEET_FLIGHT_SCHEMA,
            "records": records,
            "sources": sources,
        }

    # -- the shared HTTP face --------------------------------------------------
    def handle_http(self, request, method: str, path: str, query: dict) -> bool:
        """``/fleet/*`` routing, shared by the in-broker rider and the
        standalone :class:`CollectorServer` (same contract as
        ``StdlibHTTPServer.handle``: True = handled)."""
        if method != "GET" or not path.startswith("/fleet"):
            return False
        if path == "/fleet/metrics":
            request._send(
                200,
                self.render_metrics().encode(),
                openmetrics.CONTENT_TYPE,
            )
            return True
        if path == "/fleet/healthz":
            health = self.fleet_health()
            request._send_json(200 if health["ready"] else 503, health)
            return True
        if path == "/fleet/slo":
            request._send_json(200, self.fleet_slo())
            return True
        if path == "/fleet/flight":
            try:
                limit = int(query.get("limit", 512))
            except ValueError:
                request._send_json(400, {"error": "bad limit"})
                return True
            request._send_json(200, self.merged_flight(limit=limit))
            return True
        if path == "/fleet/traces" or path.startswith("/fleet/traces/"):
            trace_id = (
                path.rpartition("/")[2]
                if path.startswith("/fleet/traces/")
                else query.get("trace_id", "")
            )
            if not trace_id:
                request._send_json(
                    400, {"error": "need /fleet/traces/<id> or ?trace_id="}
                )
                return True
            doc = self.stitched_trace(trace_id)
            if doc is None:
                request._send_json(
                    404, {"error": f"no node retains trace {trace_id!r}"}
                )
                return True
            request._send_json(200, doc)
            return True
        return False


class CollectorServer:
    """The standalone surface: ``python -m distributed_gol_torch collector
    --node URL...`` — a :class:`FleetCollector` behind its own HTTP
    port.  ``/healthz`` and ``/metrics`` alias the fleet forms so one
    ``tools/pod_top.py --fleet`` scrape (or any OpenMetrics scraper
    pointed at the collector) needs no ``/fleet`` prefix."""

    def __init__(self, collector: FleetCollector, port: int = 0,
                 host: str = "127.0.0.1"):
        # Local import: serve.httpd is stdlib-only, but keep obs/fleet
        # importable even if the serve package grows heavier imports.
        from distributed_gol_torch.serve.httpd import StdlibHTTPServer

        self.collector = collector
        outer = self

        class _Server(StdlibHTTPServer):
            thread_name = "gol-collector-http"

            def handle(self, request, method, path, query):
                if path == "/healthz":
                    path = "/fleet/healthz"
                elif path == "/metrics":
                    path = "/fleet/metrics"
                elif path == "/traces" or path.startswith("/traces/"):
                    path = "/fleet" + path
                return outer.collector.handle_http(
                    request, method, path, query
                )

        self._server = _Server(port=port, host=host)
        self.collector.registry.info("fleet.endpoint", self._server.url)

    @property
    def url(self) -> str:
        return self._server.url

    def close(self) -> None:
        self._server.close()
        self.collector.close()


__all__ = [
    "FLEET_FLIGHT_SCHEMA",
    "FLEET_SLO_SCHEMA",
    "CollectorServer",
    "FleetCollector",
    "node_name",
]
