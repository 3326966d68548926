"""Temporal-compression tier (``Params.time_compression``).

Counterpart of ``distributed_gol_tpu/engine/timecomp.py``, carried over
as it is: the process-wide LRU (:data:`CACHE`) and the ``timecomp.*``
counters and gauge ride the port's registry (``obs/metrics.py``).

Every perf lever before this one lowered the cost of a launch; this is
the first that changes the NUMBER of launches per generation.  Once a
board has settled into ash, the engine already *proves* periodicity on
device (the whole-board cycle probe, the frontier kernels' per-tile
stability windows); this module exploits that proof temporally, in the
spirit of Gosper's Hashlife: a proved-periodic board advances through
time in ``p·2^k``-generation chunks with zero device launches, its
alive-count stream replayed from a one-period capture.

Three rungs, all exact, all gated behind ``Params.time_compression``
(default off = byte-for-byte the dense engine):

1. **Whole-board host-side skip** — the controller's fast-forward path
   (``Controller._timecomp_fast_forward``) advances ``turn`` by
   ``p·2^k`` per "dispatch" once the board is proved within the rule's
   ash period ``p`` (``LifeRule.ash_period``), recording each chunk in
   the flight ring and the ``timecomp.*`` counters.
2. **Periodic-region memoization** — :class:`AshCache` below: a
   bounded, process-wide LRU mapping a settled macro-cell's identity
   (board shape + rule + device fingerprint + popcount — no host
   refetch of the board bytes) to its period and per-phase alive
   counts, so recurring ash is recognized across runs, resumes, and
   supervisor restarts.  Hit/miss/evict counters plus a lazy
   ``timecomp.cache_entries`` gauge ride the metrics registry.
3. **Hybrid frontier gating** — while ``Backend.activity_bitmap()``
   still reports active stripes, cycle probes are deferred (counted in
   ``timecomp.probe_deferrals``) and the adaptive tier keeps running —
   its in-kernel skip already elides settled stripes
   *spatially*; the temporal tier engages once the whole frontier has
   burned out.

Exactness guard (the "never silent corruption" contract): a
fast-forward only engages after the SDC roll-stencil probe — an
INDEPENDENT formulation from every production engine — re-derives one
full period on a sampled stripe and reproduces the board; the terminal
phase advance (the next real dispatch) is re-validated the same way,
and any mismatch falls back to dense replay from the last verified
turn.  Cached counts are cross-checked against the freshly captured
ones on every hit, so even a fingerprint collision (32-bit hash +
popcount) degrades to a counted miss, never to wrong output.
"""

from __future__ import annotations

import threading
import warnings
from collections import OrderedDict
from dataclasses import dataclass

from distributed_gol_torch.engine.params import Params

#: Cap on the doubling exponent of a skip chunk: 2^20 · p generations
#: per chunk bounds one flight-ring record / host-loop iteration while
#: still reaching any practical run length in ~20 chunks.
MAX_SKIP_LOG2 = 20


@dataclass(frozen=True)
class AshEntry:
    """What the cache remembers about one settled macro-cell: its proved
    period and the alive count after each of the ``period`` phases
    (``counts[i]`` = count after i+1 generations)."""

    period: int
    counts: tuple[int, ...]

    def __post_init__(self):
        if len(self.counts) != self.period:
            raise ValueError(
                f"expected {self.period} phase counts, got {len(self.counts)}"
            )


class AshCache:
    """Bounded LRU of settled macro-cells (rung 2).

    Keys are ``(height, width, rule_notation, period, fingerprint,
    popcount)`` — identity material the backend computes ON DEVICE (the
    SDC probe's rolling-hash fingerprint + popcount), so recognition
    never refetches the board bytes.  The fingerprint is 32-bit, so a
    collision is possible; consumers therefore treat a hit as a HINT
    and cross-check the cached counts against the device capture
    (:meth:`TimeCompressor.resolve_counts`) — a collision costs one
    recapture, never a wrong count.

    Thread-safe; shared process-wide via :data:`CACHE` so a resumed or
    supervisor-restarted run recognizes the same ash instantly."""

    def __init__(self, slots: int = 256):
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, AshEntry] = OrderedDict()
        self._slots = slots
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple) -> AshEntry | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: tuple, entry: AshEntry, slots: int | None = None):
        """Insert (or refresh) an entry, evicting least-recently-used
        ones past ``slots`` (callers pass ``Params.timecomp_cache_slots``;
        the smallest bound any caller asked for wins for the shared
        process-wide instance)."""
        with self._lock:
            if slots is not None:
                self._slots = min(self._slots, max(1, slots))
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self._slots:
                self._entries.popitem(last=False)
                self.evictions += 1

    def drop(self, key: tuple):
        with self._lock:
            self._entries.pop(key, None)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0


#: The process-wide cache instance (rung 2's whole point: recognition
#: must survive the run object — resumes and supervisor restarts build
#: fresh controllers but hit the same ash).
CACHE = AshCache()

# One warning per (process, rule): a serving pod fielding many
# unknown-rule submissions must not spam a warning per run.
_warned_rules: set[str] = set()
_warned_lock = threading.Lock()


def maybe_create(params: Params, metrics, flight) -> "TimeCompressor | None":
    """The controller's entry point: a :class:`TimeCompressor` when
    ``params.time_compression`` is on AND the rule's ash period is
    known, else None (with a one-time scoped warning when the knob was
    requested for an unknown-period rule — the run proceeds dense, it
    does not fail)."""
    if not params.time_compression:
        return None
    period = params.rule.ash_period
    if period is None:
        notation = params.rule.notation
        with _warned_lock:
            first = notation not in _warned_rules
            _warned_rules.add(notation)
        if first:
            warnings.warn(
                f"time_compression requested but rule {notation} has no "
                "known ash period (LifeRule.ash_period is None): running "
                "dense. Known-period rules: B3/S23, B36/S23.",
                RuntimeWarning,
                stacklevel=3,
            )
        return None
    return TimeCompressor(params, period, metrics, flight)


class TimeCompressor:
    """Per-run façade over the process-wide :data:`CACHE`: binds the
    run's metrics registry and flight recorder, and owns the run's
    computed-vs-effective turn accounting (checkpoint truthfulness —
    the sidecar's ``computed_turns`` field is ``turn`` minus this
    object's :attr:`skipped_turns`)."""

    def __init__(self, params: Params, period: int, metrics, flight):
        self.params = params
        self.period = period
        self.flight = flight
        #: Generations delivered without device work, cumulative across
        #: resume (restored from the adopted checkpoint's sidecar).
        self.skipped_turns = 0
        self._m_skips = metrics.counter("timecomp.skips")
        self._m_skipped_turns = metrics.counter("timecomp.skipped_turns")
        self._m_hits = metrics.counter("timecomp.cache_hits")
        self._m_misses = metrics.counter("timecomp.cache_misses")
        self._m_evictions = metrics.counter("timecomp.cache_evictions")
        self._m_guard_checks = metrics.counter("timecomp.guard_checks")
        self._m_guard_mismatches = metrics.counter("timecomp.guard_mismatches")
        self._m_probe_deferrals = metrics.counter("timecomp.probe_deferrals")
        self._m_dense_replays = metrics.counter("timecomp.dense_replays")
        metrics.gauge_fn("timecomp.cache_entries", lambda: float(len(CACHE)))

    # -- rung 3: frontier-gated probing ---------------------------------------
    def defer_probe(self, backend) -> bool:
        """Whether to DEFER this cycle-probe issuance: while the activity
        bitmap proves active stripes remain, a whole-board periodicity
        probe cannot pass — skip its device work and let the adaptive tier's
        spatial skip keep grinding the frontier down.  A None bitmap
        (engine without adaptive telemetry, or too early) never defers:
        the probe is then the only settledness signal.  Conservative
        either way — deferral only delays WHEN fast-forward engages,
        never what it computes."""
        bitmap = backend.activity_bitmap()
        if bitmap is None or not bitmap.any():
            return False
        self._m_probe_deferrals.inc()
        return True

    # -- rung 2: memoized per-phase counts ------------------------------------
    def cache_key(self, fingerprint: int, popcount: int) -> tuple:
        p = self.params
        return (
            p.image_height,
            p.image_width,
            p.rule.notation,
            self.period,
            int(fingerprint),
            int(popcount),
        )

    def resolve_counts(self, key: tuple, popcount: int, capture) -> list[int]:
        """The per-phase alive counts for the settled board identified by
        ``key``: from the cache when an entry agrees with this board's
        popcount (a periodic board's count after a full period is its own
        popcount — the cheap collision cross-check), else captured on
        device via ``capture()`` and memoized."""
        entry = CACHE.get(key)
        if entry is not None:
            if entry.counts[self.period - 1] == popcount:
                self._m_hits.inc()
                return list(entry.counts)
            # Fingerprint collision (32-bit) or a stale entry: drop it and
            # recapture — counted as a miss, never trusted into output.
            CACHE.drop(key)
        self._m_misses.inc()
        counts = [int(c) for c in capture()]
        before = CACHE.evictions
        CACHE.put(
            key,
            AshEntry(self.period, tuple(counts)),
            slots=self.params.timecomp_cache_slots,
        )
        evicted = CACHE.evictions - before
        if evicted:
            self._m_evictions.inc(evicted)
        return counts

    # -- rung 1: accounting for zero-launch advancement -----------------------
    def note_skip(self, first: int, last: int):
        """Record one zero-launch chunk advancing turns
        ``first..last`` inclusive (flight ring + counters + the
        cumulative effective-vs-computed split)."""
        turns = last - first + 1
        self.skipped_turns += turns
        self._m_skips.inc()
        self._m_skipped_turns.inc(turns)
        self.flight.record(
            "timecomp_skip", first=first, last=last, turns=turns
        )

    # -- the exactness guard ---------------------------------------------------
    def note_guard(self, turn: int, ok: bool):
        self._m_guard_checks.inc()
        if not ok:
            self._m_guard_mismatches.inc()
            self.flight.record("timecomp_guard_mismatch", turn=turn)

    def note_dense_replay(self, turn: int):
        self._m_dense_replays.inc()
        self.flight.record("timecomp_dense_replay", turn=turn)

    def restore(self, computed_turns: int | None, effective_turns: int | None):
        """Adopt the effective-vs-computed split a resumed checkpoint's
        sidecar recorded, so this run's sidecars stay cumulative-honest."""
        if computed_turns is not None and effective_turns is not None:
            self.skipped_turns = max(0, effective_turns - computed_turns)


__all__ = [
    "AshCache",
    "AshEntry",
    "CACHE",
    "MAX_SKIP_LOG2",
    "TimeCompressor",
    "maybe_create",
]
