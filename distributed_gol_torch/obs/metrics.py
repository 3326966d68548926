"""Metrics registry: process-wide counters, gauges, fixed-bucket histograms.

Design constraints:

- **Near-zero clean-path cost.**  A bump is a plain attribute operation on
  a pre-resolved instrument object — no locks, no dict lookups, no string
  formatting on the dispatch path.  Instruments are resolved ONCE (at
  controller/backend construction, the cold path, under a lock) and held
  as attributes; concurrent bumps may lose the occasional increment under
  free-threading, which is the standard serving-stack trade (a metric is
  telemetry, not an invariant).
- **Snapshot-on-read.**  Nothing is aggregated until someone asks:
  :meth:`MetricsRegistry.snapshot` walks the instruments and copies their
  values into a plain-dict :class:`MetricsSnapshot`.  Expensive or lazy
  values (skip fraction, compile-cache hit counts) register as
  *callback gauges* (:meth:`MetricsRegistry.gauge_fn`) and are evaluated
  only at snapshot time.
- **Schema-linted artifacts.**  Every embedded snapshot — ``bench.py``
  records, ``Session`` checkpoint sidecars, flight records, the terminal
  :class:`~distributed_gol_torch.engine.events.MetricsReport` — carries the
  ``gol-metrics-v1`` shape, and :func:`check_metrics_snapshot` /
  :func:`require_metrics_snapshot` lint it exactly the way
  ``measure.check_headline_stats`` lints bench records.

The process-wide default registry is :data:`REGISTRY`;
``Params.metrics=False`` swaps in :data:`NULL` (same interface, no-op
instruments, empty snapshots) via :func:`registry_for`, so instrumented
code never branches.
"""

from __future__ import annotations

import json
import math
import threading
from bisect import bisect_left
from typing import Callable, Mapping, Sequence

from distributed_gol_torch.engine.events import TurnTiming

SCHEMA = "gol-metrics-v1"

# Dispatch/checkpoint latency buckets (seconds): sub-ms async issues up to
# the tens-of-seconds first-dispatch jit compile at 16384²-class boards.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0,
)


class MalformedSnapshot(ValueError):
    """A metrics snapshot violated the ``gol-metrics-v1`` schema."""


class Counter:
    """Monotonic accumulator.  ``inc`` is one attribute add — the whole
    point; never put a lock here."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (None = never set, omitted from snapshots)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` covers values ≤ ``buckets[i]``
    (first bucket that fits), with one overflow slot past the last bound —
    so ``len(counts) == len(buckets) + 1`` and ``count == sum(counts)``,
    which is exactly what the schema lint checks."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(a >= b for a, b in zip(bounds, bounds[1:])):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1


class MetricsSnapshot:
    """A point-in-time copy of a registry, as a plain ``gol-metrics-v1``
    dict (:attr:`data`) ready for JSON embedding."""

    def __init__(self, data: dict):
        self.data = data

    def to_dict(self) -> dict:
        return self.data

    def to_json(self) -> str:
        return json.dumps(self.data, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "MetricsSnapshot":
        snap = cls(json.loads(text))
        require_metrics_snapshot(snap.data)
        return snap

    def delta(self, earlier: "MetricsSnapshot | dict") -> "MetricsSnapshot":
        """This snapshot minus ``earlier`` — the per-run view of a
        process-wide registry (counters and histogram counts subtract;
        gauges and info keep this snapshot's values, they are not
        cumulative)."""
        base = earlier.data if isinstance(earlier, MetricsSnapshot) else earlier
        bc = base.get("counters", {})
        # Untouched instruments are DROPPED from the delta (not emitted as
        # zeros): a run's report describes what that run did, not every
        # counter the process ever created.
        counters = {
            k: v - bc.get(k, 0)
            for k, v in self.data.get("counters", {}).items()
            if v - bc.get(k, 0)
        }
        bh = base.get("histograms", {})
        histograms = {}
        for k, h in self.data.get("histograms", {}).items():
            prev = bh.get(k)
            if prev and prev.get("buckets") == h["buckets"]:
                d = {
                    "buckets": list(h["buckets"]),
                    "counts": [a - b for a, b in zip(h["counts"], prev["counts"])],
                    "sum": h["sum"] - prev["sum"],
                    "count": h["count"] - prev["count"],
                }
            else:
                d = {
                    "buckets": list(h["buckets"]),
                    "counts": list(h["counts"]),
                    "sum": h["sum"],
                    "count": h["count"],
                }
            if d["count"]:
                histograms[k] = d
        return MetricsSnapshot(
            {
                "schema": SCHEMA,
                "counters": counters,
                "gauges": dict(self.data.get("gauges", {})),
                "histograms": histograms,
                "info": dict(self.data.get("info", {})),
            }
        )


def new_run_id(tenant: str | None = None) -> str:
    """A fresh correlation id: stamped once per logical run
    (stable across supervisor restarts) on the terminal
    ``MetricsReport``, every flight dump, and every checkpoint sidecar,
    so a scrape series, a postmortem, and a resumed session join
    offline.  Tenant-prefixed for human-greppable artifacts."""
    import uuid

    suffix = uuid.uuid4().hex[:12]
    return f"{tenant}-{suffix}" if tenant else suffix


def labelled(name: str, tenant: str | None = None) -> str:
    """Instrument name carrying a ``tenant=`` label: the flat
    registry stays flat — a labelled instrument is just a distinct name,
    ``name{tenant=x}`` — so one process-wide snapshot separates tenants
    multiplexed through the serving plane, and deltas/aggregation/lint
    need no label machinery.  ``tenant=None`` returns ``name`` unchanged:
    untenanted runs keep the exact pre-serving metric names."""
    return name if tenant is None else f"{name}{{tenant={tenant}}}"


def tenant_of(name: str) -> str | None:
    """Inverse of :func:`labelled`: the tenant a snapshot key belongs to
    (None = untenanted) — what per-tenant rollups key on."""
    if name.endswith("}") and "{tenant=" in name:
        return name[name.rindex("{tenant=") + 8 : -1]
    return None


class MetricsRegistry:
    """Named instruments; creation is locked (cold path), bumps are not
    (hot path).  ``snapshot()`` is the only aggregation point."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._gauge_fns: dict[str, Callable[[], float | None]] = {}
        self._info: dict[str, str] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS
    ) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram(buckets))

    def gauge_fn(self, name: str, fn: Callable[[], float | None]) -> None:
        """Register a snapshot-time callback gauge: ``fn`` is called only
        when a snapshot is taken; returning None omits the gauge.  Latest
        registration under a name wins (a new run's backend replaces the
        previous run's callbacks)."""
        with self._lock:
            self._gauge_fns[name] = fn

    def info(self, name: str, value: str) -> None:
        """A string-valued label (engine in use, exchange tier, ...)."""
        with self._lock:
            self._info[name] = str(value)

    def clear_tenant(self, tenant: str) -> None:
        """Drop every instrument carrying this ``tenant=`` label — the
        serving plane's eviction hook: a pod serving churning
        tenant names must not grow the registry without bound.  Unlike
        :meth:`clear_labels`, COUNTERS go too: an evicted tenant's
        series is over (its run is terminal, nothing bumps the orphaned
        instruments again), and snapshot deltas tolerate missing keys."""
        with self._lock:
            suffix = f"{{tenant={tenant}}}"
            for store in (
                self._counters,
                self._gauges,
                self._histograms,
                self._gauge_fns,
                self._info,
            ):
                for k in [k for k in store if k.endswith(suffix)]:
                    del store[k]

    def clear_labels(self, prefix: str) -> None:
        """Drop every gauge, callback gauge, and info label under
        ``prefix``.  The run-scoped reset: a new Backend clears
        ``backend.`` before registering its own, so a run's snapshot
        cannot carry a PREVIOUS run's tier label or skip fraction — and
        the old backend's bound-method callbacks stop pinning it alive.
        Counters are cumulative by design and stay (deltas subtract
        them correctly)."""
        with self._lock:
            for store in (self._gauges, self._gauge_fns, self._info):
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]

    def snapshot(self, include_lazy: bool = True) -> MetricsSnapshot:
        """``include_lazy=False`` skips the callback gauges: abort-path
        snapshots (the flight dump) must not force device values — a
        wedged device would turn the postmortem into the very unbounded
        hang it documents."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {
                k: g.value for k, g in self._gauges.items() if g.value is not None
            }
            histograms = {
                k: {
                    "buckets": list(h.buckets),
                    "counts": list(h.counts),
                    "sum": h.sum,
                    "count": h.count,
                }
                for k, h in self._histograms.items()
            }
            fns = list(self._gauge_fns.items()) if include_lazy else []
            info = dict(self._info)
        for name, fn in fns:
            try:
                v = fn()
            except Exception:  # noqa: BLE001 — telemetry must not take a run down
                continue
            if v is not None:
                gauges[name] = float(v)
        return MetricsSnapshot(
            {
                "schema": SCHEMA,
                "counters": counters,
                "gauges": gauges,
                "histograms": histograms,
                "info": info,
            }
        )


class _NullInstrument:
    __slots__ = ()

    def inc(self, n: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """The ``Params.metrics=False`` registry: same interface, no state —
    instrumented code never branches on whether metrics are on."""

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge_fn(self, name: str, fn) -> None:
        pass

    def info(self, name: str, value: str) -> None:
        pass

    def clear_labels(self, prefix: str) -> None:
        pass

    def clear_tenant(self, tenant: str) -> None:
        pass

    def snapshot(self, include_lazy: bool = True) -> MetricsSnapshot:
        return MetricsSnapshot(
            {
                "schema": SCHEMA,
                "counters": {},
                "gauges": {},
                "histograms": {},
                "info": {},
            }
        )


#: The process-wide registry every instrumented component resolves from.
REGISTRY = MetricsRegistry()
#: The no-op registry ``Params.metrics=False`` swaps in.
NULL = NullRegistry()


def registry_for(enabled: bool) -> MetricsRegistry | NullRegistry:
    return REGISTRY if enabled else NULL


class DispatchRecorder:
    """The one home of per-dispatch instrumentation — the unified form of
    the two hand-rolled ``TurnTiming`` emission sites the controller used
    to carry (sync viewer path and pipelined headless resolve): timing
    events, metrics bumps, and the flight-ring dispatch record can never
    drift between paths again."""

    def __init__(
        self,
        registry,
        flight,
        emit: Callable[[object], None],
        emit_timing: bool = False,
        qsize: Callable[[], int] | None = None,
        tenant: str | None = None,
        trace=None,
    ):
        self._flight = flight
        self._emit = emit
        self._emit_timing = emit_timing
        self._qsize = qsize
        # Request trace: when the run serves a traced request
        # the recorder stamps the trace's short id on flight dispatch
        # records and observes the time-to-first-dispatch SLI off the
        # trace's first-occurrence mark.  None (the untraced default)
        # keeps the hot path at one attribute compare.
        self._trace = trace
        # ``tenant`` labels every instrument: N
        # sessions multiplexed onto one process-wide registry stay
        # separable in a single snapshot — and the labels ride the run's
        # delta into checkpoint sidecars and the terminal MetricsReport.
        self._c_dispatches = registry.counter(
            labelled("controller.dispatches", tenant)
        )
        self._c_turns = registry.counter(labelled("controller.turns", tenant))
        self._h_seconds = registry.histogram(
            labelled("controller.dispatch_seconds", tenant)
        )
        self._g_superstep = registry.gauge(
            labelled("controller.superstep", tenant)
        )
        self._g_qdepth = registry.gauge(
            labelled("controller.event_queue_depth", tenant)
        )
        # Failed dispatch ATTEMPTS, tenant-labelled: beside
        # the per-cause ``faults.failures.<Type>`` counters, this is the
        # per-tenant series the SLO tracker's error-rate objective reads
        # off the sampler ring.
        self._c_failures = registry.counter(
            labelled("controller.dispatch_failures", tenant)
        )
        # Time-to-first-dispatch SLI: request start (trace
        # t0) → first RESOLVED dispatch, per tenant — the "how long until
        # this request computed anything" histogram the SLO machinery
        # was missing.  Observed once per request, only for traced runs.
        self._h_ttfd = registry.histogram(
            labelled("sli.time_to_first_dispatch_seconds", tenant)
        )
        self.last_turn = 0  # the abort path's best known turn

    def record(self, turn: int, k: int, seconds: float) -> None:
        """One resolved dispatch: ``k`` generations ending at ``turn``
        took ``seconds`` of wall-clock (same dt semantics each caller
        already measured)."""
        self._c_dispatches.inc()
        self._c_turns.inc(k)
        self._h_seconds.observe(seconds)
        self._g_superstep.set(k)
        if self._qsize is not None:
            self._g_qdepth.set(self._qsize())
        if self._trace is None:
            self._flight.record(
                "dispatch", turn=turn, k=k, s=round(seconds, 6)
            )
        else:
            # The flight↔trace correlation: dispatch records
            # carry the trace's short id, so `flight_report` joins a
            # postmortem ring to the request timeline.
            self._flight.record(
                "dispatch",
                turn=turn,
                k=k,
                s=round(seconds, 6),
                trace=self._trace.short_id,
            )
            first = self._trace.mark("first_dispatch")
            if first is not None:
                self._h_ttfd.observe(first)
        self.last_turn = turn
        if self._emit_timing:
            self._emit(TurnTiming(turn, k, seconds))

    def record_failure(self) -> None:
        """One failed dispatch attempt (retried or terminal) — the
        error-rate half of the per-tenant SLO inputs."""
        self._c_failures.inc()


# -- aggregation (the multihost seam's pure half) ------------------------------

def aggregate_snapshots(snaps: Sequence[dict | MetricsSnapshot]) -> dict:
    """Merge per-process snapshots into one: counters and histogram counts
    sum (work is additive across processes), gauges take the max (each is
    a local last-observation; max keeps the worst queue depth / largest
    superstep visible), info keeps the first process's labels (identical
    everywhere by SPMD construction)."""
    out = {
        "schema": SCHEMA,
        "counters": {},
        "gauges": {},
        "histograms": {},
        "info": {},
    }
    for s in snaps:
        d = s.data if isinstance(s, MetricsSnapshot) else s
        for k, v in d.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, v in d.get("gauges", {}).items():
            prev = out["gauges"].get(k)
            out["gauges"][k] = v if prev is None else max(prev, v)
        for k, h in d.get("histograms", {}).items():
            prev = out["histograms"].get(k)
            if prev is None or prev["buckets"] != h["buckets"]:
                out["histograms"][k] = {
                    "buckets": list(h["buckets"]),
                    "counts": list(h["counts"]),
                    "sum": h["sum"],
                    "count": h["count"],
                }
            else:
                prev["counts"] = [
                    a + b for a, b in zip(prev["counts"], h["counts"])
                ]
                prev["sum"] += h["sum"]
                prev["count"] += h["count"]
        for k, v in d.get("info", {}).items():
            out["info"].setdefault(k, v)
    return out


# -- the snapshot schema lint --------------------------------------------------

def _finite(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)


def check_metrics_snapshot(obj, path: str = "$") -> list[str]:
    """Lint one ``gol-metrics-v1`` snapshot dict; returns the violations
    (empty = clean) — the same contract shape as
    ``measure.check_headline_stats``."""
    problems: list[str] = []
    if not isinstance(obj, Mapping):
        return [f"{path}: snapshot is not a dict ({type(obj).__name__})"]
    if obj.get("schema") != SCHEMA:
        problems.append(f"{path}.schema: want {SCHEMA!r}, got {obj.get('schema')!r}")
    # Sections come from arbitrary on-disk JSON (flight records, sidecars):
    # a corrupted section must become a VIOLATION, never an AttributeError
    # out of the lint itself.
    for section in ("counters", "gauges", "histograms", "info"):
        if not isinstance(obj.get(section, {}), Mapping):
            problems.append(
                f"{path}.{section}: not a dict "
                f"({type(obj.get(section)).__name__})"
            )
    if problems:
        return problems
    for k, v in obj.get("counters", {}).items():
        if not _finite(v) or v < 0:
            problems.append(f"{path}.counters.{k}: not a finite non-negative number ({v!r})")
    for k, v in obj.get("gauges", {}).items():
        if not _finite(v):
            problems.append(f"{path}.gauges.{k}: not a finite number ({v!r})")
    for k, h in obj.get("histograms", {}).items():
        hp = f"{path}.histograms.{k}"
        if not isinstance(h, Mapping):
            problems.append(f"{hp}: not a dict")
            continue
        buckets = h.get("buckets")
        counts = h.get("counts")
        if not isinstance(buckets, (list, tuple)) or not all(
            _finite(b) for b in buckets
        ):
            problems.append(f"{hp}.buckets: not a list of finite numbers")
            continue
        if any(a >= b for a, b in zip(buckets, list(buckets)[1:])):
            problems.append(f"{hp}.buckets: not strictly increasing")
        if not isinstance(counts, (list, tuple)) or len(counts) != len(buckets) + 1:
            problems.append(
                f"{hp}.counts: want len(buckets)+1 slots, got "
                f"{len(counts) if isinstance(counts, (list, tuple)) else 'n/a'}"
            )
            continue
        if any(not isinstance(c, int) or c < 0 for c in counts):
            problems.append(f"{hp}.counts: not all non-negative ints")
        elif h.get("count") != sum(counts):
            problems.append(
                f"{hp}.count: {h.get('count')!r} != sum(counts) {sum(counts)}"
            )
        if not _finite(h.get("sum")):
            problems.append(f"{hp}.sum: not a finite number ({h.get('sum')!r})")
    for k, v in obj.get("info", {}).items():
        if not isinstance(v, str):
            problems.append(f"{path}.info.{k}: not a string ({v!r})")
    return problems


def require_metrics_snapshot(obj) -> None:
    """Raising form of :func:`check_metrics_snapshot` — artifact writers
    (bench.py, the flight dump) run this before publishing, same contract
    as ``measure.require_headline_stats``."""
    problems = check_metrics_snapshot(obj)
    if problems:
        raise MalformedSnapshot("; ".join(problems))


def check_embedded_metrics(record, path: str = "$") -> list[str]:
    """Walk an arbitrary artifact record; every ``"metrics"`` key holding
    a dict must be a schema-valid snapshot.  This is what ``bench.py``
    runs on its own record before printing (alongside
    ``require_headline_stats``)."""
    problems: list[str] = []
    if isinstance(record, Mapping):
        for k, v in record.items():
            if k == "metrics" and isinstance(v, Mapping):
                problems.extend(check_metrics_snapshot(v, f"{path}.metrics"))
            else:
                problems.extend(check_embedded_metrics(v, f"{path}.{k}"))
    elif isinstance(record, (list, tuple)):
        for i, v in enumerate(record):
            problems.extend(check_embedded_metrics(v, f"{path}[{i}]"))
    return problems


def require_embedded_metrics(record) -> None:
    problems = check_embedded_metrics(record)
    if problems:
        raise MalformedSnapshot("; ".join(problems))
