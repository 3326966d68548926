"""Continuous telemetry sampling.

Everything PRs 4-8 planted is *pull-on-demand*: registry snapshots
materialize at terminal ``MetricsReport`` events, bench records, and
flight dumps — a live pod has no time axis.  :class:`TelemetrySampler`
adds it: a daemon thread snapshots the process-wide registry every
``interval`` seconds into a bounded ring of timestamped samples, and the
derived views — windowed rates (gens/s, dispatches/s, retries/s,
watchdog-fires/min) and histogram-delta percentiles (p50/p95/p99
issue/resolve latency) — are computed from *consecutive samples*, so
they describe what the pod is doing NOW, not since process start.

Contracts:

- **The sampling path never blocks on a device.**  Samples are taken
  with ``include_lazy=False`` (plain dict copies under the registry
  lock); the lazy callback gauges (skip fraction, compile-cache stats,
  live subscriber counts) — which may force device values — are
  evaluated only every ``lazy_every``-th tick and merged into that
  tick's sample.  A wedged device can therefore stall at most the lazy
  leg of one tick; the ring keeps serving the last good sample, and
  consumers read the growing :attr:`staleness` instead of hanging.
- **Bounded everything.**  The ring holds ``depth`` samples (oldest
  evicted), a sample is a plain ``gol-metrics-v1`` dict, and every read
  API is lock-bounded pure-Python — which is what lets the HTTP
  endpoints (``serve/telemetry.py``) promise bounded-time scrapes.
- **Staleness bound = one interval.**  Consumers serving from
  :meth:`latest` (the serving plane's ``health()``, the ``/metrics``
  endpoint) see data at most ``interval`` seconds old while the sampler
  is healthy; :attr:`staleness` exposes the actual age so a stalled
  sampler is itself observable.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Sequence

from distributed_gol_torch.obs import metrics as metrics_lib


class Sample:
    """One timestamped registry snapshot (``snapshot`` is the plain
    ``gol-metrics-v1`` dict; ``lazy`` marks a tick that also evaluated
    the callback gauges)."""

    __slots__ = ("t", "snapshot", "lazy")

    def __init__(self, t: float, snapshot: dict, lazy: bool = False):
        self.t = t
        self.snapshot = snapshot
        self.lazy = lazy


def histogram_delta_percentiles(
    new: dict | None, old: dict | None, qs: Sequence[float] = (0.5, 0.95, 0.99)
) -> dict[str, float] | None:
    """Percentiles of the observations that landed BETWEEN two snapshots
    of one fixed-bucket histogram (``{"buckets", "counts", ...}`` dicts
    as snapshots carry them), linearly interpolated within a bucket.

    ``old=None`` treats ``new`` as the whole population (the since-start
    view).  Returns None when no observations landed in the window.
    Values past the last bound are pinned to it — an overflow quantile
    reads "at least the last bound", which is the conservative answer a
    latency SLO wants."""
    if not new:
        return None
    bounds = list(new.get("buckets", ()))
    counts = list(new.get("counts", ()))
    if old and old.get("buckets") == new.get("buckets"):
        counts = [a - b for a, b in zip(counts, old.get("counts", ()))]
    if len(counts) != len(bounds) + 1 or any(c < 0 for c in counts):
        return None
    total = sum(counts)
    if total <= 0:
        return None
    out: dict[str, float] = {}
    for q in qs:
        target = q * total
        cum = 0.0
        value = float(bounds[-1])
        for i, c in enumerate(counts):
            if cum + c >= target and c > 0:
                hi = float(bounds[i]) if i < len(bounds) else float(bounds[-1])
                lo = float(bounds[i - 1]) if i > 0 else 0.0
                frac = (target - cum) / c
                value = min(lo + frac * (hi - lo), float(bounds[-1]))
                break
            cum += c
        out[f"p{int(q * 100)}"] = value
    return out


def fraction_above(
    new: dict | None, old: dict | None, threshold: float
) -> float | None:
    """Fraction of the window's observations ABOVE ``threshold``, from
    the histogram delta between two snapshots.  The threshold is rounded
    DOWN to the nearest bucket bound (conservative: observations between
    the bound and the threshold count as "above"), so a latency SLO
    judged through this never under-reports violations.  None = no
    observations in the window."""
    if not new:
        return None
    bounds = list(new.get("buckets", ()))
    counts = list(new.get("counts", ()))
    if old and old.get("buckets") == new.get("buckets"):
        counts = [a - b for a, b in zip(counts, old.get("counts", ()))]
    if len(counts) != len(bounds) + 1 or any(c < 0 for c in counts):
        return None
    total = sum(counts)
    if total <= 0:
        return None
    # counts[i] covers values <= bounds[i]; everything in a bucket whose
    # UPPER bound exceeds the threshold is counted as a violation.
    good = sum(c for b, c in zip(bounds, counts) if b <= threshold)
    return (total - good) / total


class SnapshotRegistry:
    """A :class:`~distributed_gol_torch.obs.metrics.MetricsRegistry`
    duck-type over an EXTERNAL snapshot source — what lets a
    :class:`TelemetrySampler` ring hold some OTHER process's metrics
    (the fleet collector's per-node rings over scraped ``/metrics``
    text, and the fleet-aggregate ring over their merge)
    while the sampler's own bookkeeping counters land on a real local
    ``registry``.  ``fn`` returns the newest ``gol-metrics-v1`` dict
    the source holds (None samples as empty); it should hand back a
    dict it will not mutate afterwards, since ring samples alias it."""

    def __init__(self, fn: Callable[[], dict | None], registry=None):
        self._fn = fn
        self._registry = (
            registry if registry is not None else metrics_lib.REGISTRY
        )

    def snapshot(self, include_lazy: bool = True) -> metrics_lib.MetricsSnapshot:
        snap = self._fn()
        if snap is None:
            snap = {
                "schema": metrics_lib.SCHEMA,
                "counters": {},
                "gauges": {},
                "histograms": {},
                "info": {},
            }
        return metrics_lib.MetricsSnapshot(snap)

    def counter(self, name: str):
        return self._registry.counter(name)


class TelemetrySampler:
    """The continuous-sampling daemon (module doc).  ``interval`` is the
    cadence in seconds; ``depth`` bounds the ring; every ``lazy_every``-th
    tick also evaluates the registry's callback gauges.  ``on_sample``
    (optional) is called with the sampler after each tick — the SLO
    tracker's hook — on the sampler thread, exceptions contained."""

    def __init__(
        self,
        registry=None,
        interval: float = 1.0,
        depth: int = 600,
        lazy_every: int = 10,
        on_sample: Callable[["TelemetrySampler"], None] | None = None,
    ):
        if interval <= 0:
            raise ValueError("sampler interval must be positive")
        if depth < 2:
            raise ValueError("sampler depth must be >= 2 (rates need a delta)")
        if lazy_every < 1:
            raise ValueError("lazy_every must be >= 1")
        self.registry = registry if registry is not None else metrics_lib.REGISTRY
        self.interval = interval
        self.lazy_every = lazy_every
        self.on_sample = on_sample
        self._ring: deque[Sample] = deque(maxlen=depth)
        self._lock = threading.Lock()
        # Two small locks, deliberately NOT one around the whole tick: a
        # lazy tick's snapshot may block on a wedged device's callback
        # gauge, and an event-driven fast tick (the serving plane's
        # terminal-session freshness tick, taken under the plane lock)
        # must never queue behind it — only the cadence bump and the
        # on_sample callback (alert edge-triggering) are serialized.
        self._cadence_lock = threading.Lock()
        self._cb_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ticks = 0
        self._m_samples = self.registry.counter("telemetry.samples")
        self._m_lazy = self.registry.counter("telemetry.lazy_samples")

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "TelemetrySampler":
        """Take one sample synchronously (so ``latest()`` is never None
        after start) and launch the daemon."""
        if self._thread is not None:
            return self
        self.sample_now()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gol-telemetry-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_now()
            except Exception:  # noqa: BLE001 — telemetry never kills a pod
                continue

    # -- the tick --------------------------------------------------------------
    def sample_now(self, lazy: bool | None = None) -> Sample:
        """One tick: snapshot, append, fire ``on_sample``.  Public so
        tests (and the synchronous start above) can drive the ring
        without wall-clock waits.  ``lazy=None`` follows the cadence;
        ``False`` forces a fast (never device-touching) tick — what
        event-driven callers like the serving plane's terminal-session
        freshness tick must pass, since they may hold locks a scrape
        path also needs; ``True`` forces a lazy tick.

        The cadence bump and the ``on_sample`` callback are serialized
        (concurrent ticks cannot skew the lazy schedule or race the SLO
        tracker's alert edge-trigger); the snapshot itself is NOT — a
        lazy tick blocked on a wedged device must not make a concurrent
        fast tick wait behind it (see the lock comment in __init__)."""
        with self._cadence_lock:
            self._ticks += 1
            if lazy is None:
                # Never-lazy on the first tick (even at lazy_every=1):
                # start() samples synchronously and must not block pod
                # startup on a device-forcing callback gauge.
                lazy = (
                    self._ticks > 1 and (self._ticks % self.lazy_every) == 0
                )
        snap = self.registry.snapshot(include_lazy=lazy).to_dict()
        sample = Sample(time.time(), snap, lazy=lazy)
        if lazy:
            self._m_lazy.inc()
        self._m_samples.inc()
        with self._lock:
            self._ring.append(sample)
        cb = self.on_sample
        if cb is not None:
            with self._cb_lock:
                try:
                    cb(self)
                except Exception:  # noqa: BLE001 — an SLO bug must not stop sampling
                    pass
        return sample

    # -- reads -----------------------------------------------------------------
    def latest(self) -> Sample | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def samples(self) -> list[Sample]:
        with self._lock:
            return list(self._ring)

    @property
    def staleness(self) -> float:
        """Seconds since the last sample (inf before the first) — how a
        consumer of :meth:`latest` observes a stalled sampler."""
        s = self.latest()
        return time.time() - s.t if s is not None else float("inf")

    def window(self, seconds: float | None = None) -> tuple[Sample, Sample] | None:
        """(oldest-within-window, newest) pair, or None until two samples
        exist.  ``seconds=None`` spans the whole ring.  When the ring
        does not yet cover ``seconds``, the whole ring is used — the
        window grows to spec as samples accumulate (documented SLO
        warm-up behaviour)."""
        with self._lock:
            if len(self._ring) < 2:
                return None
            new = self._ring[-1]
            if seconds is None:
                return self._ring[0], new
            old = self._ring[0]
            for s in self._ring:
                if s.t >= new.t - seconds:
                    old = s
                    break
            if old is new:
                old = self._ring[-2]
            return old, new

    def counter_delta(self, name: str, seconds: float | None = None):
        """(delta, dt) for one counter over the window; None without two
        samples."""
        w = self.window(seconds)
        if w is None:
            return None
        old, new = w
        dt = max(new.t - old.t, 1e-9)
        d = new.snapshot.get("counters", {}).get(name, 0) - old.snapshot.get(
            "counters", {}
        ).get(name, 0)
        return d, dt

    def rate(self, name: str, seconds: float | None = None) -> float | None:
        d = self.counter_delta(name, seconds)
        return None if d is None else d[0] / d[1]

    def percentiles(
        self,
        name: str,
        seconds: float | None = None,
        qs: Sequence[float] = (0.5, 0.95, 0.99),
    ) -> dict[str, float] | None:
        """Windowed percentiles of one histogram instrument (see
        :func:`histogram_delta_percentiles`)."""
        w = self.window(seconds)
        if w is None:
            return None
        old, new = w
        return histogram_delta_percentiles(
            new.snapshot.get("histograms", {}).get(name),
            old.snapshot.get("histograms", {}).get(name),
            qs,
        )

    def derived(self, seconds: float | None = None) -> dict:
        """The dashboard rollup: pod-wide windowed rates + latency
        percentiles + per-tenant rows, all from ring deltas.  Shape::

            {"window_seconds", "gens_per_s", "dispatches_per_s",
             "retries_per_s", "watchdog_fires_per_min",
             "issue_latency": {p50, p95, p99} | None,
             "resolve_latency": {...} | None,
             "tenants": {tenant: {"gens_per_s", "dispatches_per_s",
                                  "resolve_latency": {...} | None}}}

        Pod-wide rates SUM the untenanted instruments and every
        ``tenant=`` variant (a serving pod's work lives under labels)."""
        w = self.window(seconds)
        if w is None:
            return {}
        old, new = w
        dt = max(new.t - old.t, 1e-9)
        oc = old.snapshot.get("counters", {})
        nc = new.snapshot.get("counters", {})

        def rate_all(base: str) -> float:
            total = 0.0
            for k, v in nc.items():
                if k == base or (
                    k.startswith(base + "{")
                    and metrics_lib.tenant_of(k) is not None
                ):
                    total += v - oc.get(k, 0)
            return total / dt

        oh = old.snapshot.get("histograms", {})
        nh = new.snapshot.get("histograms", {})
        tenants: dict[str, dict] = {}
        for k in nc:
            t = metrics_lib.tenant_of(k)
            if t is None or not k.startswith("controller."):
                continue
            row = tenants.setdefault(t, {})
            base = k[: k.index("{")]
            if base == "controller.turns":
                row["gens_per_s"] = (nc[k] - oc.get(k, 0)) / dt
            elif base == "controller.dispatches":
                row["dispatches_per_s"] = (nc[k] - oc.get(k, 0)) / dt
        for t, row in tenants.items():
            hname = metrics_lib.labelled("controller.dispatch_seconds", t)
            row["resolve_latency"] = histogram_delta_percentiles(
                nh.get(hname), oh.get(hname)
            )
        return {
            "window_seconds": round(dt, 3),
            "gens_per_s": rate_all("controller.turns"),
            "dispatches_per_s": rate_all("controller.dispatches"),
            "retries_per_s": rate_all("faults.retries"),
            "watchdog_fires_per_min": rate_all("faults.watchdog_fires") * 60.0,
            "issue_latency": histogram_delta_percentiles(
                nh.get("controller.issue_seconds"),
                oh.get("controller.issue_seconds"),
            ),
            "resolve_latency": histogram_delta_percentiles(
                nh.get("controller.dispatch_seconds"),
                oh.get("controller.dispatch_seconds"),
            ),
            "tenants": tenants,
        }
