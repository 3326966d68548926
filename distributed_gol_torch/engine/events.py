"""The typed event stream — the framework's observability contract.

Reference: ``gol/event.go``.  The event channel IS the observability system
(SURVEY.md §5): six event types flow from the engine to whoever is watching
(SDL window, tests, headless drain).  Ordering contract (``gol/event.go:55-58``,
enforced by ``sdl_test.go``): every ``CellFlipped`` for a turn is delivered
before that turn's ``TurnComplete``.

Python mapping: events are frozen dataclasses on a ``queue.Queue``; the
channel-close that ends the reference's event stream (``gol/distributor.go:262``)
becomes a ``None`` sentinel posted by the engine.
"""

from __future__ import annotations

import enum
import queue
from dataclasses import dataclass, field
from typing import Sequence, Union

from distributed_gol_torch.utils.cell import Cell


class State(enum.Enum):
    """Execution states announced via StateChange (``gol/event.go:34-45``)."""

    PAUSED = "Paused"
    EXECUTING = "Executing"
    QUITTING = "Quitting"

    def __str__(self) -> str:
        return self.value


@dataclass(frozen=True)
class Event:
    """Base event: everything carries the number of completed turns
    (``gol/event.go:9-15``: the Event interface = Stringer +
    GetCompletedTurns)."""

    completed_turns: int

    def __str__(self) -> str:  # non-empty => the viewer loop prints it
        return ""


@dataclass(frozen=True)
class AliveCellsCount(Event):
    """Emitted every 2 seconds (``gol/event.go:17-19``,
    ``gol/distributor.go:178-179``).  Unlike the reference (quirk Q7: count
    latched one event behind), ``cells_count`` here is exactly the alive
    count at ``completed_turns``."""

    cells_count: int = 0

    def __str__(self) -> str:
        return f"Alive Cells {self.cells_count}"


@dataclass(frozen=True)
class ImageOutputComplete(Event):
    """A PGM snapshot hit the filesystem (``gol/event.go:22-26``)."""

    filename: str = ""

    def __str__(self) -> str:
        return f"File {self.filename} output complete"


@dataclass(frozen=True)
class StateChange(Event):
    """Pause/resume/quit announcements (``gol/event.go:29-45``)."""

    new_state: State = State.EXECUTING

    def __str__(self) -> str:
        return f"State change to {self.new_state}"


@dataclass(frozen=True)
class CellFlipped(Event):
    """One cell changed value this turn (``gol/event.go:48-50``).  All flips
    for a turn precede its TurnComplete."""

    cell: Cell = Cell(0, 0)


@dataclass(frozen=True)
class CellsFlipped(Event):
    """Batch form of CellFlipped (framework extension): every changed cell of
    one turn in a single event.  Viewers that understand it avoid a Python
    object per cell; the engine can emit either form (see
    ``Controller._emit_flips``).  Not part of the reference contract."""

    cells: Sequence[Cell] = field(default_factory=tuple)


@dataclass(frozen=True)
class FrameReady(Event):
    """A device-pooled viewer frame for one turn (framework extension).

    Above ``Params._FLIP_VIEW_MAX_CELLS`` an "auto" viewer is fed these
    instead of per-cell flips: the board is max-pooled on device to at most
    ``Params.frame_max`` cells, so the per-turn host transfer is bounded
    regardless of board size (SURVEY.md §7 hard part 4 — the reference
    fetched and rendered every pixel every turn, ``sdl/window.go:56-64``).
    ``frame`` is a uint8 (rows, cols) array; a nonzero entry means some cell
    in that tile is alive.  Ordering matches flips: the frame for a turn is
    delivered before that turn's TurnComplete."""

    # np.ndarray; excluded from the generated __eq__/__hash__ (arrays are
    # unhashable and their __eq__ is elementwise) — two FrameReady events
    # compare by (turn, factors), like every other event compares by its
    # scalar fields.
    frame: object = field(default=None, compare=False)
    factors: tuple = (1, 1)  # (fy, fx) pooling factors
    # Viewport rect (y0, x0, height, width) in BOARD cells this frame
    # covers, or None for a whole-board frame — viewers pin
    # pan/zoom changes to it.  A FrameReady is a KEYFRAME in the delta
    # protocol: it replaces the viewer's buffer wholesale and re-anchors
    # subsequent FrameDelta bands.
    rect: tuple | None = None
    # Wall-clock publish stamp, set ONCE by the FramePlane so
    # every subscriber's copy of one publish encodes to identical wire
    # bytes (the relay tree's bit-identity guarantee); relays forward
    # blobs verbatim, so the last hop of a depth-N chain still measures
    # true pod-to-viewer staleness from it.  None = unstamped (engine
    # internal frames, old peers).
    ts: float | None = field(default=None, compare=False)


@dataclass(frozen=True)
class FrameDelta(Event):
    """Changed bands of one rendered frame against the previously
    delivered frame (framework extension) — the delta half of
    the spectator-streaming wire format.

    ``bands`` is a sequence of ``(y0, rows)`` pairs: ``rows`` is a uint8
    (n, cols) array replacing frame rows ``y0 .. y0 + n - 1`` in place;
    rows outside every band are UNCHANGED from the previous frame and
    must not be touched by the viewer (pinned by test — the in-place
    contract is what keeps a million-viewer fan-out's per-frame work
    O(activity), not O(viewport)).  Bands are 8-row-aligned, disjoint,
    and ascending; an empty ``bands`` is a legal frame (nothing in the
    viewport changed — the turn still ticks).  Deltas only ever follow a
    FrameReady keyframe with the same ``rect``; any viewport change
    re-keyframes.  Ordering matches FrameReady: delivered before the
    turn's TurnComplete."""

    bands: Sequence = field(default_factory=tuple, compare=False)
    factors: tuple = (1, 1)
    rect: tuple | None = None
    # Wall-clock publish stamp — see FrameReady.ts.
    ts: float | None = field(default=None, compare=False)


@dataclass(frozen=True)
class TurnComplete(Event):
    """A full generation finished; a viewer may render (``gol/event.go:53-58``)."""


@dataclass(frozen=True)
class TurnsCompleted(Event):
    """Batch form of TurnComplete (framework extension): one event per
    device dispatch covering turns ``first_turn..completed_turns``
    inclusive, emitted when ``Params.turn_events == "batch"``.

    Why it exists: the reference contract is one TurnComplete per
    generation, which costs one queue.put per turn — at the engine's
    measured 2M gens/s @ 1024² a headless ``gol.run()`` is then bounded by
    Python queue throughput, not the device.
    Batch mode keeps the exact turn accounting (ranges tile the run with
    no gaps or overlaps) at O(dispatches) host cost instead of O(turns).
    The default stays the reference-exact per-turn stream."""

    first_turn: int = 0

    @property
    def turns(self) -> int:
        return self.completed_turns - self.first_turn + 1


@dataclass(frozen=True)
class CycleDetected(Event):
    """The whole board was proved periodic (framework extension).

    Emitted by a headless run when the cycle probe
    (``Params.cycle_check``) verifies that advancing the board ``period``
    generations reproduces it exactly.  From that point the dynamics are
    a fixed cycle, so the controller stops dispatching device work and
    fast-forwards: every remaining turn's events and alive counts come
    from the cycle phases, and the final board is the phase at
    ``(turns - completed_turns) mod period`` generations past the board
    at ``completed_turns`` — bit-identical to stepping the rest of the
    way.  ``completed_turns`` is the turn at which periodicity was
    established (the true period may be any divisor of ``period``)."""

    period: int = 6

    def __str__(self) -> str:
        return (
            f"Board is period-{self.period} stable; fast-forwarding remaining turns"
        )


@dataclass(frozen=True)
class FinalTurnComplete(Event):
    """The run is over; carries the final alive-cell list, consumed directly
    by tests (``gol/event.go:61-65``, ``gol_test.go:33-41``).

    Quirk decisions (SURVEY.md appendix Q1/Q2): ``completed_turns`` is the
    TRUE number of completed turns (the reference always reported 0); a
    controller-detach ('q') still emits this event with ``alive=()`` so
    viewers exit, matching reference behaviour."""

    alive: Sequence[Cell] = field(default_factory=tuple)


@dataclass(frozen=True)
class DispatchError(Event):
    """A device dispatch failed (framework extension).  The host-level
    analog of the reference broker re-queuing a failed worker RPC
    (``broker/broker.go:67-73``), generalised to a policy: the controller
    retries the superstep from the last good board up to
    ``Params.retry_limit`` times with deterministic exponential backoff
    (``Params.retry_backoff_seconds``); a terminal failure — retries
    exhausted, per-run ``Params.failure_budget`` spent, or a watchdog
    timeout — parks a checkpoint on the session (resumable like a 'q'
    detach) and aborts the run.  The stream still ends with the sentinel
    either way.

    ``attempt``: 1-based count of failed attempts for this dispatch so far
    (1 = the original dispatch failed, 2 = its first retry failed...).
    ``will_retry``: this failure is about to be retried.
    ``checkpointed``: terminal failure, last good board parked on the session.
    """

    error: str = ""
    will_retry: bool = False
    checkpointed: bool = False
    attempt: int = 0

    def __str__(self) -> str:
        action = (
            "retrying"
            if self.will_retry
            else ("checkpointed" if self.checkpointed else "aborting")
        )
        tag = f"attempt {self.attempt}, " if self.attempt else ""
        return f"Dispatch error ({tag}{action}): {self.error}"


@dataclass(frozen=True)
class CheckpointSaved(Event):
    """A durable periodic checkpoint was parked on the session (framework
    extension; ``Params.checkpoint_every_turns`` /
    ``checkpoint_every_seconds``).  The board at ``completed_turns`` is
    resumable by a fresh controller — the crash-recovery contract: atomic
    tmp+rename writes, world-before-meta ordering, a CRC32 sidecar that
    detects torn writes at resume, keep-last-K rotation (see
    ``Session.save_checkpoint``)."""

    def __str__(self) -> str:
        return f"Checkpoint saved at turn {self.completed_turns}"


@dataclass(frozen=True)
class TurnTiming(Event):
    """Per-dispatch timing telemetry (framework extension, off by default —
    enable with ``Params.emit_timing``).  The TPU analog of the reference's
    ``runtime/trace`` harness output (``trace_test.go:12-29``): one event per
    device dispatch with wall-clock and derived throughput, so a long run's
    progress is observable without attaching a profiler.  For kernel-level
    traces use ``utils.profiling.trace`` (jax.profiler → Perfetto)."""

    turns: int = 0  # generations in this dispatch
    seconds: float = 0.0  # wall-clock for the dispatch (incl. host sync)

    @property
    def gens_per_sec(self) -> float:
        return self.turns / self.seconds if self.seconds > 0 else 0.0

    def __str__(self) -> str:
        return f"{self.turns} turns in {self.seconds:.4f}s ({self.gens_per_sec:,.0f}/s)"


@dataclass(frozen=True)
class MetricsReport(Event):
    """Terminal metrics snapshot (framework extension): the run's
    observability rollup — dispatch counts and latency histograms, retry/
    watchdog/checkpoint counters, skip fraction, compile-cache hits —
    emitted just before FinalTurnComplete when ``Params.metrics`` is on.

    ``snapshot`` is a ``gol-metrics-v1`` dict (the per-run DELTA of the
    process-wide registry; schema in ``obs/metrics.py``, linted by
    ``check_metrics_snapshot``).  Multi-host runs aggregate every
    process's snapshot through the broadcast seam, so ``processes``
    records how many were merged.  Excluded from equality like
    ``FrameReady.frame``: two reports compare by (turn, processes) — the
    snapshot carries wall-clock values no two runs share.

    ``run_id`` / ``tenant``: the correlation stamp shared
    with the run's flight dumps and checkpoint sidecars, so a scrape
    series, a postmortem, and a resumed session can be joined offline.
    Stable across supervisor restarts of one logical run; excluded from
    equality like the snapshot.

    ``trace_id``: the request trace this run served, when it
    was submitted through the traced serving path — joins the report to
    the ``/traces`` timeline and the gateway receipt.  Empty for
    untraced runs."""

    snapshot: dict = field(default_factory=dict, compare=False)
    processes: int = 1
    run_id: str = field(default="", compare=False)
    tenant: str | None = field(default=None, compare=False)
    trace_id: str = field(default="", compare=False)


class _TurnRange:
    """Internal queue entry: the TurnComplete events for turns
    ``first..last`` (inclusive) compressed into one object.  Never reaches
    a consumer — :meth:`EventQueue.get` re-expands it one event at a time."""

    __slots__ = ("first", "last")

    def __init__(self, first: int, last: int):
        self.first = first
        self.last = last


class EventQueue(queue.Queue):
    """A ``queue.Queue`` whose producer side can enqueue a whole dispatch's
    TurnComplete events as ONE put (:meth:`put_turns`); ``get`` re-expands
    them lazily, so a consumer sees the exact per-turn reference stream
    (``gol/event.go:53-58``) while the engine pays one queue operation per
    dispatch instead of one per generation.

    Why: per-turn ``Queue.put`` bounds a headless ``gol.run()`` at Python
    queue throughput — measured 14% of the engine's own rate at 512²
   .  The controller batches automatically when
    the events queue is an ``EventQueue``; with a plain ``queue.Queue`` it
    falls back to per-event puts, so the drop-in reference contract is
    unchanged for callers who bring their own queue.

    Single-consumer by design (like the reference's one SDL loop draining
    the events channel, ``sdl/loop.go:30-52``): the expansion cursor is
    consumer-side state and is deliberately unlocked.  ``task_done``/
    ``join`` keep working with the canonical one-``task_done``-per-``get``
    pattern (the surplus calls a range expansion produces are absorbed);
    ``qsize`` counts queue entries, so it under-reports pending expanded
    events — use ``empty``, which is exact."""

    def __init__(self, maxsize: int = 0):
        super().__init__(maxsize)
        self._expand: tuple[int, int] | None = None  # (next, last) turns
        self._surplus_dones = 0  # task_done calls owed to expanded events

    # -- producer side -----------------------------------------------------
    def put_turns(self, first: int, last: int) -> None:
        """Enqueue TurnComplete(first..last), inclusive, as one entry."""
        if first == last:
            self.put(TurnComplete(first))
        elif first < last:
            self.put(_TurnRange(first, last))

    # -- consumer side -----------------------------------------------------
    def get(self, block: bool = True, timeout: float | None = None):
        exp = self._expand
        if exp is not None:
            t, last = exp
            self._expand = (t + 1, last) if t < last else None
            return TurnComplete(t)
        item = super().get(block, timeout)
        if type(item) is _TurnRange:
            self._expand = (item.first + 1, item.last)
            self._surplus_dones += item.last - item.first
            return TurnComplete(item.first)
        return item

    def get_many(
        self, max_n: int = 65536, block: bool = True, timeout: float | None = None
    ):
        """Up to ``max_n`` events in one call — the batched drain (round
        5).  Compressed turn ranges come back COMPRESSED, as the public
        :class:`TurnsCompleted` batch event, instead of being expanded
        one :class:`TurnComplete` per generation: Python object creation
        measures ~0.8 µs each on this class of host, which caps a
        per-turn drain near 1.2M turns/s however it is batched — keeping
        the run form removes the per-turn cost entirely while preserving
        exact ordering and turn accounting (ranges tile the stream with
        no gaps or overlaps; every other event type is returned as-is,
        in place).  Consumers that need the reference-exact per-turn
        objects keep calling :meth:`get`.

        Blocking applies to the FIRST event only (per ``block`` /
        ``timeout``, raising ``queue.Empty`` like ``get``); the rest are
        whatever is available without waiting.  The list ends early at a
        ``None`` stream sentinel, which is included for the caller to
        see.  The one-``task_done``-per-returned-event pattern keeps
        working (a returned run counts as one)."""
        out: list = []
        while len(out) < max_n:
            exp = self._expand
            if exp is not None:
                t, last = exp
                self._expand = None
                out.append(
                    TurnsCompleted(completed_turns=last, first_turn=t)
                    if last > t
                    else TurnComplete(t)
                )
                # The originating get() pre-paid one surplus per expanded
                # event; collapsing the tail into ONE event must leave
                # exactly one consumer task_done mapping to the real one.
                self._surplus_dones -= last - t
                continue
            try:
                item = super().get(block and not out, timeout if not out else None)
            except queue.Empty:
                if not out:
                    raise  # same contract as get() on an empty stream
                break
            if type(item) is _TurnRange:
                out.append(
                    TurnsCompleted(
                        completed_turns=item.last, first_turn=item.first
                    )
                )
            else:
                out.append(item)
                if item is None:
                    break
        return out

    def task_done(self) -> None:
        # One underlying entry backs a whole expanded range: absorb the
        # per-event surplus so `get(); ...; task_done()` consumers and
        # producer-side `join()` keep their standard semantics.
        if self._surplus_dones > 0:
            self._surplus_dones -= 1
            return
        super().task_done()

    def empty(self) -> bool:
        return self._expand is None and super().empty()


AnyEvent = Union[
    AliveCellsCount,
    ImageOutputComplete,
    StateChange,
    CellFlipped,
    CellsFlipped,
    FrameReady,
    FrameDelta,
    TurnComplete,
    TurnsCompleted,
    CycleDetected,
    FinalTurnComplete,
    DispatchError,
    CheckpointSaved,
    TurnTiming,
    MetricsReport,
]
