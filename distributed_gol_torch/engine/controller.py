"""The run controller: orchestration of a whole simulation.

The controller of ``distributed_gol_tpu/engine/controller.py`` for one
device, carried over with its contracts: load (or resume) a board, drive
generations through the Backend seam, emit the event stream, honour
s/p/q/k keypresses, snapshot PGMs, and shut down cleanly — plus the
pipelined headless dispatch loop, cycle fast-forward, retry/watchdog,
periodic checkpoints, the SDC sentinel and graceful preemption, the
time-compression tier (``Params.time_compression``: ``engine/timecomp.py``),
and the per-turn viewer loop: exact flips, device-pooled frames, and a
viewport with delta-encoded frames and pan/zoom keys, and the serving
plane's spectator fan-out (``frame_plane``: one coalesced viewport fetch a
rendered turn, ``serve/frames.py``).

- The per-turn RPC round-trip (``gol/distributor.go:48-66``) becomes a
  device superstep: N generations per dispatch.
- Keypresses are honoured at superstep granularity with exact turn numbers.

Threading model: the controller runs in the caller's thread (like
``distributor`` runs in ``gol.Run``'s goroutine); the only helper thread is
the 2-second alive-count ticker (``gol/distributor.go:168-191``).  Events go
to a ``queue.Queue``; the stream ends with a ``None`` sentinel (the
reference's ``close(events)``, ``gol/distributor.go:262``).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from distributed_gol_torch.engine import pgm
from distributed_gol_torch.engine import timecomp as timecomp_lib
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.events import (
    AliveCellsCount,
    CellFlipped,
    CellsFlipped,
    CheckpointSaved,
    CycleDetected,
    DispatchError,
    EventQueue,
    FinalTurnComplete,
    FrameDelta,
    FrameReady,
    ImageOutputComplete,
    MetricsReport,
    State,
    StateChange,
    TurnComplete,
    TurnsCompleted,
)
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.engine.session import Session, default_session
from distributed_gol_torch.obs import flight as flight_lib
from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import spans
from distributed_gol_torch.obs import tracing
from distributed_gol_torch.utils.cell import AliveCells, Cell


# Forces every dispatch to resolve before the next is issued — an A/B
# measurement aid for quantifying the pipelining win, not a
# user knob: there is no reason to want the serialised behaviour.
_PIPELINE_DISABLED = os.environ.get("GOL_NO_PIPELINE", "").lower() not in (
    "",
    "0",
    "false",
)


class DispatchTimeout(RuntimeError):
    """A dispatch failed to resolve within ``Params.dispatch_deadline_seconds``
    (the dispatch watchdog).  Terminal by policy — a wedged device or
    collective would wedge a retry too — so the controller parks what it
    can, emits the terminal DispatchError, guarantees the stream sentinel,
    and raises this."""


class CorruptionDetected(RuntimeError):
    """The SDC sentinel (``Params.sdc_check_every_turns``) caught the
    device state diverging from a redundant recompute — silent data
    corruption, or a broken engine.  Terminal by policy and, unlike every
    other terminal failure, the current board is NOT parked as a
    checkpoint (it is the corrupt state); the rollback target is the last
    periodic checkpoint, which the supervisor restores when armed
    (``Params.restart_limit``)."""


# ``Controller._maybe_sdc_check`` outcomes (both truthy — the probe hit
# the device, so pipeline callers re-latch their clocks either way; only
# a parking boundary distinguishes them: a skipped check is NOT a verify
# and must withhold the park).
_SDC_VERIFIED = "verified"
_SDC_SKIPPED = "skipped"


class _Watchdog:
    """Bounds blocking waits on dispatch results (the dispatch watchdog,
    ``Params.dispatch_deadline_seconds``).

    Disabled (deadline 0, the default) it is a plain call — zero clean-path
    overhead.  Enabled, the wait runs on a throwaway daemon thread and the
    caller abandons it at the deadline: CUDA has no cancellation for an
    in-flight computation, so the wedged wait is left behind (daemon ⇒ it
    cannot block interpreter exit) and the controller gets its abort path
    instead of wedging with it.

    ``on_arm`` / ``on_fire`` (optional zero-arg callables) are the
    observability hooks: arm is counted per guarded wait, fire per
    timeout — metrics bumps only, so the disabled (deadline 0) path stays
    a plain call with zero overhead."""

    #: How often an armed ``interrupt`` callback is polled mid-wait.
    INTERRUPT_POLL_SECONDS = 0.25

    def __init__(self, deadline: float, on_arm=None, on_fire=None):
        self.deadline = deadline
        self._on_arm = on_arm
        self._on_fire = on_fire
        #: Optional zero-arg callable polled during the wait;
        #: returning an exception abandons the wait and raises it
        #: immediately — the multihost tier wires the peer-heartbeat
        #: check here, so a survivor blocked in a collective its dead
        #: peer never joins aborts within the HEARTBEAT bound (naming
        #: the dead rank) instead of sitting out the full dispatch
        #: deadline, which must stay conservative enough to cover a
        #: first-dispatch compile.  None (default) keeps the plain
        #: single wait.
        self.interrupt = None

    def call(self, fn):
        # Deadline 0 with no interrupt is OFF: a plain call, zero cost.
        # An armed interrupt keeps polling even with no deadline — the
        # heartbeat must be able to break a wait the deadline would
        # never bound (``dispatch_deadline_seconds=0`` is the default);
        # such waits never fire a DispatchTimeout, only the interrupt.
        if not self.deadline and self.interrupt is None:
            return fn()
        if self.deadline and self._on_arm is not None:
            self._on_arm()
        box: list = []
        done = threading.Event()

        def _runner():
            try:
                box.append((True, fn()))
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box.append((False, e))
            finally:
                done.set()

        t = threading.Thread(target=_runner, name="gol-watchdog", daemon=True)
        t.start()
        deadline_at = (
            time.monotonic() + self.deadline if self.deadline else None
        )
        while True:
            if self.interrupt is not None:
                step = self.INTERRUPT_POLL_SECONDS
            else:
                step = self.deadline
            if deadline_at is not None:
                step = min(step, max(deadline_at - time.monotonic(), 0.001))
            if done.wait(step):
                break
            if self.interrupt is not None:
                err = self.interrupt()
                if err is not None:
                    raise err  # the wedged wait is abandoned, like a fire
            if deadline_at is not None and time.monotonic() >= deadline_at:
                if self._on_fire is not None:
                    self._on_fire()
                raise DispatchTimeout(
                    f"dispatch did not resolve within {self.deadline}s "
                    "(device or collective wedged)"
                )
        ok, value = box[0]
        if ok:
            return value
        raise value


class _ParkGuard:
    """Closes the watchdog-abandonment race on the terminal park: the
    session write (commit) and the abort's abandonment are mutually
    exclusive under one lock, and the abort reads back whether a commit
    won — so ``DispatchError.checkpointed`` is truthful in every
    interleaving, and a park the abort gave up on can never mutate the
    session behind a ``checkpointed=False`` report."""

    def __init__(self):
        self._lock = threading.Lock()
        self._abandoned = False
        self.committed = False

    def commit(self, fn) -> bool:
        with self._lock:
            if self._abandoned:
                return False
            fn()
            self.committed = True
            return True

    def abandon(self) -> bool:
        """Abandon the park; returns whether a commit already won (the
        rare at-deadline race: report it checkpointed after all)."""
        with self._lock:
            self._abandoned = True
            return self.committed


class _TickerState:
    """(turn, count) pair shared with the ticker thread; always a consistent
    pair (unlike the reference's one-behind latch, quirk Q7)."""

    def __init__(self, turn: int, count: int):
        self._lock = threading.Lock()
        self._turn = turn
        self._count = count

    def set(self, turn: int, count: int):
        with self._lock:
            self._turn, self._count = turn, count

    def get(self) -> tuple[int, int]:
        with self._lock:
            return self._turn, self._count


class _Ticker(threading.Thread):
    """Emits AliveCellsCount every ``period`` seconds
    (``gol/distributor.go:228``: 2000 ms ticker), including while paused."""

    def __init__(self, period: float, events: queue.Queue, state: _TickerState):
        super().__init__(name="gol-alive-ticker", daemon=True)
        self._period = period
        self._events = events
        self._state = state
        # NB: not named _stop — threading.Thread uses that attribute name
        # internally and shadowing it breaks Thread.join().
        self._stop_evt = threading.Event()

    def run(self):
        while not self._stop_evt.wait(self._period):
            turn, count = self._state.get()
            self._events.put(AliveCellsCount(turn, count))

    def stop(self):
        self._stop_evt.set()


class Controller:
    # Largest adaptive dispatch: bounds one dispatch's TurnComplete flood
    # and the set of dispatch sizes the growth path can request.
    _ADAPT_CAP = 16384
    # Batch turn telemetry has no per-turn flood (one TurnsCompleted per
    # dispatch), so its only bounds are keypress latency — already owned
    # by max_dispatch_seconds — and the count of dispatch sizes
    # (logarithmic in the cap).  Effectively unbounded.
    _ADAPT_CAP_BATCH = 1 << 20

    def __init__(
        self,
        params: Params,
        events: queue.Queue,
        key_presses: Optional[queue.Queue] = None,
        session: Optional[Session] = None,
        backend: Optional[Backend] = None,
        flight=None,
        stop=None,
        frame_plane=None,
        run_id: Optional[str] = None,
    ):
        self.params = params
        # Correlation id: stamped on the terminal
        # MetricsReport, every flight dump, and every checkpoint sidecar.
        # The supervisor passes ONE id across all restart attempts of a
        # logical run; unsupervised runs mint their own here.
        self.run_id = run_id or metrics_lib.new_run_id(params.tenant)
        self.events = events
        self.key_presses = key_presses
        self.session = session if session is not None else default_session()
        self.backend = backend if backend is not None else Backend(params)
        # -- the viewport viewer --
        # Live viewport rect [y0, x0, vh, vw] (mutated by pan/zoom keys)
        # or None = whole-board frames; the delta encoder's state; and
        # the optional spectator fan-out hub (serve.frames.FramePlane)
        # fed one coalesced publish per rendered turn.
        self._rect = (
            None
            if params.viewport is None
            else list(
                Backend.normalize_rect(
                    params.viewport, params.image_height, params.image_width
                )
            )
        )
        self._deltas_on = params.frame_deltas_enabled()
        self._last_frame = None
        self._frame_keyframe = True
        self._rect_resized = False
        self.frame_plane = frame_plane
        if frame_plane is not None:
            frame_plane.bind(params.image_height, params.image_width)
        # "completed" | "detached" ('q') | "killed" ('k') | "preempted"
        # (graceful stop: SIGTERM/SIGINT → emergency checkpoint → exit
        # paused-and-resumable)
        self._outcome = "completed"
        self._paused = False
        # Graceful-stop latch: any object with a ``requested``
        # attribute (supervisor.GracefulStop); checked at turn boundaries.
        # None = no preemption handling armed, zero clean-path cost.
        self._stop = stop
        # Sticky record of _stop_now() having returned True.  On
        # multi-host runs _stop_now is a COLLECTIVE — call sites that
        # need to act on an already-observed stop (the paused keys loop)
        # consult this purely-local latch instead of issuing another
        # collective off-schedule.  Every rank latches at the same
        # schedule point (the allgather returned the same max), so reads
        # stay deterministic across processes.
        self._stop_seen = False
        # Set by the supervisor: intermediate (restartable) aborts must
        # not dump the flight ring or end the event stream — the
        # supervisor owns both on the FINAL outcome.
        self._supervised = False
        # -- observability --
        # Process-wide registry (or the no-op null registry); instruments
        # are resolved HERE, the cold path, so hot-path bumps are plain
        # attribute adds on pre-bound objects.
        self.metrics = metrics_lib.registry_for(params.metrics)
        # The supervisor passes its shared ring so restart history and the
        # next attempt's records land in ONE postmortem artifact.
        self.flight = (
            flight
            if flight is not None
            else flight_lib.FlightRecorder(params.flight_recorder_depth)
        )
        # The tier label every span carries: the sharded exchange tier
        # when one is in play, else the engine that actually runs.
        self._tier = self.backend.sharded_tier or self.backend.engine_used
        # Request trace: the serving plane activates the
        # request's trace on the worker context before gol.run, so the
        # controller (and everything it calls through obs.spans) attaches
        # without parameter threading.  None for untraced runs — every
        # per-dispatch check below is then one attribute compare.
        self.trace = tracing.current()
        qsize = getattr(self.events, "qsize", None)
        self._dispatch_rec = metrics_lib.DispatchRecorder(
            self.metrics,
            self.flight,
            emit=self._emit,
            emit_timing=params.emit_timing,
            qsize=qsize,
            tenant=params.tenant,
            trace=self.trace,
        )
        # Time-to-first-frame SLI: request start → first rendered frame,
        # per tenant (traced frame-mode runs).
        self._h_ttff = self.metrics.histogram(
            metrics_lib.labelled(
                "sli.time_to_first_frame_seconds", params.tenant
            )
        )
        self._m_pipeline_overlap = self.metrics.counter(
            "controller.pipeline_overlap"
        )
        # Issue latency is host-side async-dispatch cost (~sub-ms when the
        # pipeline is healthy); a growing issue time means the runtime's
        # dispatch queue is backing up — distinct from resolve latency,
        # which is device time.
        self._h_issue_seconds = self.metrics.histogram(
            "controller.issue_seconds"
        )
        self._m_backoff_s = self.metrics.counter("faults.backoff_seconds")
        self._m_ckpt_saves = self.metrics.counter("faults.checkpoint_saves")
        self._m_ckpt_bytes = self.metrics.counter("faults.checkpoint_bytes")
        self._m_ckpt_failures = self.metrics.counter("faults.checkpoint_failures")
        self._h_ckpt_seconds = self.metrics.histogram(
            "faults.checkpoint_save_seconds"
        )
        self.flight.record(
            "tier",
            engine=self.backend.engine_used,
            tier=self._tier,
            mesh=list(params.mesh_shape),
        )
        # The per-run report is the DELTA against this start snapshot: the
        # registry is process-wide (many runs per process), the report is
        # this run's.
        self._metrics_start = self.metrics.snapshot()
        # -- fault-tolerance state --
        self._watchdog = _Watchdog(
            params.dispatch_deadline_seconds,
            on_arm=self.metrics.counter("faults.watchdog_arms").inc,
            on_fire=self._watchdog_fired,
        )
        self._failures = 0  # per-run failed-dispatch count (failure_budget)
        self._ckpt_saved = False  # any periodic checkpoint parked this run
        self._ckpt_save_warned = False  # one warning per run for failed saves
        self._last_ckpt_turn = 0
        self._last_ckpt_time = time.monotonic()
        # Last SUCCESSFULLY saved checkpoint turn.  Distinct from the
        # cadence anchor above, which advances on FAILED saves too (the
        # retry-at-next-cadence policy): the emergency-checkpoint guard
        # must ask "is the session resumable at this turn", not "did we
        # recently try".
        self._saved_ckpt_turn = 0
        self._resumed = False  # did _initial_world CONSUME a checkpoint?
        self._sdc_probe_warned = False  # one warning per run for probe errors
        # -- resilience state --
        self._last_sdc_turn = 0
        # (board_out, forced count) of the newest resolved dispatch —
        # board_out is the live current board (no extra device pinning);
        # the count lets a preemption cross-check the board it is about
        # to park (``_preempt_exit``) without the long-dropped
        # pre-dispatch board a stripe recompute would need.
        self._last_resolved = None
        self._m_sdc_checks = self.metrics.counter("sdc.checks")
        self._m_sdc_mismatches = self.metrics.counter("sdc.mismatches")
        self._m_preempt = self.metrics.counter("preempt.signals")
        # -- temporal compression --
        # None unless Params.time_compression is on AND the rule's ash
        # period is known — and with it None, every path below is
        # byte-for-byte the dense controller.
        self._timecomp = timecomp_lib.maybe_create(
            params, self.metrics, self.flight
        )

    # -- event helpers ---------------------------------------------------------
    def _emit(self, event):
        self.events.put(event)

    def _emit_turns(self, first: int, last: int):
        """TurnComplete for every turn in ``first..last`` inclusive.  On an
        :class:`EventQueue` the whole range is ONE queue entry (expanded
        back to per-turn events on the consumer side); a plain
        ``queue.Queue`` gets the reference-exact per-event puts — which
        bound headless per-turn throughput at queue speed."""
        if last < first:
            return
        if isinstance(self.events, EventQueue):
            self.events.put_turns(first, last)
        else:
            for t in range(first, last + 1):
                self.events.put(TurnComplete(t))

    def _emit_flips(self, turn: int, coords: np.ndarray):
        """coords: (n, 2) array of (y, x).  Per-cell events preserve the
        reference contract (``gol/event.go:48-58``); the batch form is the
        cheap framework extension."""
        pairs = coords.tolist()  # Python ints: ~2x faster than numpy rows
        if self.params.flip_events == "batch":
            self._emit(CellsFlipped(turn, tuple(Cell(x, y) for y, x in pairs)))
        else:
            for y, x in pairs:
                self._emit(CellFlipped(turn, Cell(x, y)))

    # -- keypresses (gol/distributor.go:105-151) -------------------------------
    def _write_pgm(self, path, board_np):
        """File-output seam: multi-host runs override this so only the
        controller process touches the filesystem (the fetch that feeds it
        is collective and runs everywhere)."""
        pgm.write_pgm(path, board_np)

    def _snapshot(self, board, turn: int):
        name = self.params.snapshot_name(turn)
        self._write_pgm(
            self.params.out_dir / f"{name}.pgm", self.backend.fetch(board)
        )
        self._emit(ImageOutputComplete(turn, name))

    def _handle_key(self, key: str, board, turn: int):
        if key == "s":
            self._snapshot(board, turn)
        elif key == "p":
            self._paused = not self._paused
            self.session.pause(self._paused)
            # Quirk Q9 (deliberate): the reference reports ``turn + 1`` here
            # (gol/distributor.go:133-137) because its pause lands while a
            # turn-RPC is mid-flight and THAT turn will still complete.  Our
            # pause lands at a superstep boundary — no turn is in flight —
            # so ``turn`` is the true completed count and +1 would be a lie.
            # Same truth-over-parity policy as Q1 (README quirk table).
            self._emit(
                StateChange(turn, State.PAUSED if self._paused else State.EXECUTING)
            )
        elif key == "q":
            # Detach: park the checkpoint on the session; a new controller
            # resumes it (gol/distributor.go:139-147, broker/broker.go:143-148).
            self._emit(StateChange(turn, State.QUITTING))
            self.session.pause(
                True,
                world=self.backend.fetch(board),
                turn=turn,
                rule=self.params.rule.notation,
                **self._ckpt_accounting(turn),
            )
            self._outcome = "detached"
        elif key == "k":
            # Kill the whole system (gol/distributor.go:121-128).
            self._snapshot(board, turn)
            self._emit(StateChange(turn, State.QUITTING))
            self.session.quit()
            self._outcome = "killed"
        elif self._rect is not None and key in self._VIEWPORT_KEYS:
            self._pan_zoom(key)

    # Viewport pan/zoom keys: a/d/w/x pan left/right/up/down by half a
    # viewport; '+'/'=' zoom in (halve the rect about its centre), '-'
    # zoom out (double, clamped to the board).  Chosen to avoid the
    # reference's s/p/q/k; ignored on non-viewport runs.
    _VIEWPORT_KEYS = frozenset("adwx+=-")
    _VIEWPORT_MIN = 16  # smallest zoomed-in rect side, cells

    def _pan_zoom(self, key: str):
        """Mutate the live viewport rect; the next frame re-keyframes
        (and, on a zoom, flags the resize so the auto-stride policy can
        re-probe a materially different fetch)."""
        h, w = self.params.image_height, self.params.image_width
        y0, x0, vh, vw = self._rect
        if key in "adwx":
            dy = {"w": -vh // 2, "x": vh // 2}.get(key, 0)
            dx = {"a": -vw // 2, "d": vw // 2}.get(key, 0)
            y0, x0 = (y0 + dy) % h, (x0 + dx) % w
        else:
            cy, cx = y0 + vh // 2, x0 + vw // 2
            if key == "-":
                nvh, nvw = min(2 * vh, h), min(2 * vw, w)
            else:
                # Zoom-in floor: the smaller of _VIEWPORT_MIN, the board
                # side, and the CURRENT size — so '+' never grows a rect
                # and never exceeds a small board.
                nvh = max(min(self._VIEWPORT_MIN, h, vh), vh // 2)
                nvw = max(min(self._VIEWPORT_MIN, w, vw), vw // 2)
            if (nvh, nvw) == (vh, vw):
                return
            vh, vw = nvh, nvw
            y0, x0 = (cy - vh // 2) % h, (cx - vw // 2) % w
            self._rect_resized = True
        self._rect = [y0, x0, vh, vw]
        self._frame_keyframe = True

    def _poll_keys(self, board, turn: int):
        """Drain pending keys; while paused, block here (stepping stops, the
        ticker keeps ticking) until resumed or quit."""
        if self.key_presses is None:
            return
        while True:
            try:
                key = self.key_presses.get(block=self._paused, timeout=0.05)
            except queue.Empty:
                if not self._paused:
                    return
                if self._stop_now():
                    # A graceful stop must drain a PAUSED run too: return
                    # with the stop latched in _stop_seen — the call site
                    # preempts at THIS turn, before any further dispatch
                    # can advance the state the user froze (the paused
                    # flag is identical on every process, so the
                    # multi-host collective poll stays deterministic).
                    return
                continue
            self._handle_key(key, board, turn)
            if self._outcome != "completed":
                return
            if not self._paused and self.key_presses.empty():
                return

    # -- failure surface -------------------------------------------------------
    def _watchdog_fired(self):
        """Watchdog-fire observability: counter + flight-ring transition
        (the state change a postmortem needs to see)."""
        self.metrics.counter("faults.watchdog_fires").inc()
        fields = dict(
            deadline_s=self.params.dispatch_deadline_seconds,
            turn=self._dispatch_rec.last_turn,
        )
        if self.trace is not None:
            # Tail retention: a watchdog fire makes this
            # request's trace an error trace — retained at end even when
            # head sampling dropped it, with the fire in the
            # always-retained event ring and the short id on the flight
            # row for the postmortem join.
            fields["trace"] = self.trace.short_id
            self.trace.add_event(
                "gol.watchdog.fire", turn=self._dispatch_rec.last_turn
            )
            self.trace.flag("watchdog_fire")
        self.flight.record("watchdog_fire", **fields)

    def _dispatch(self, step, board, turn: int):
        """Run one device dispatch under the watchdog, with the retry
        policy on failure (``Params.retry_limit`` — the broker's re-queue,
        ``broker/broker.go:67-73``, generalised): on failure, retry from
        the last good board via :meth:`_retry_failed` — the single home of
        the retry contract."""
        try:
            with spans.span("gol.dispatch.sync", turn=turn, tier=self._tier):
                return self._watchdog.call(step)
        except Exception as e:  # noqa: BLE001 — any device/runtime failure
            return self._retry_failed(step, board, turn, e)

    def _force(self, count_dev) -> int:
        """Force an on-device count under the dispatch watchdog — the
        blocking wait of the pipelined headless path."""
        return self._watchdog.call(lambda: int(count_dev))

    def _backoff(self, attempt: int):
        """Deterministic exponential backoff before the ``attempt``-th
        retry: base·2^(attempt-1) seconds, capped.  Zero base (default)
        sleeps nothing — the reference's immediate re-queue."""
        p = self.params
        if p.retry_backoff_seconds <= 0:
            return
        delay = p.retry_backoff_seconds * (2 ** (attempt - 1))
        if p.retry_backoff_max_seconds > 0:
            delay = min(delay, p.retry_backoff_max_seconds)
        self._m_backoff_s.inc(delay)
        time.sleep(delay)

    def _retry_failed(self, step, board_in, turn: int, error: Exception):
        """The retry contract, shared by the viewer path (``_dispatch``)
        and the pipelined headless path (issue- and resolve-time
        failures): announce each failure (DispatchError carries the
        attempt count) and re-run ``step`` — under the watchdog, after
        deterministic backoff — up to ``Params.retry_limit`` times.

        Terminal failures — retries exhausted, the per-run
        ``Params.failure_budget`` spent, or a watchdog timeout (a wedged
        device would wedge the retry too) — park ``board_in`` (the last
        good board) as a paused checkpoint, the same resumable state a 'q'
        detach leaves, emit the terminal DispatchError, and re-raise.
        ``run()`` still guarantees the stream sentinel."""
        p = self.params
        attempt = 1  # failed attempts for this dispatch so far
        while True:
            self._failures += 1
            # Retries by cause: the cause key is the exception
            # class — DispatchTimeout, RuntimeError (device errors),
            # XlaRuntimeError... — a cold path, so the per-cause counter
            # lookup is fine here.
            self.metrics.counter(
                f"faults.failures.{type(error).__name__}"
            ).inc()
            # The per-tenant failure counter: what the SLO
            # tracker's error-rate objective reads off the sampler ring.
            self._dispatch_rec.record_failure()
            terminal = (
                isinstance(error, DispatchTimeout)
                or attempt > p.retry_limit
                or (p.failure_budget and self._failures > p.failure_budget)
            )
            self.flight.record(
                "retry" if not terminal else "terminal_failure",
                turn=turn,
                attempt=attempt,
                cause=type(error).__name__,
                error=str(error)[:200],
            )
            if not terminal:
                self.metrics.counter("faults.retries").inc()
                self._emit(
                    DispatchError(
                        turn, error=str(error), will_retry=True, attempt=attempt
                    )
                )
                self._backoff(attempt)
                try:
                    with spans.span("gol.retry", turn=turn, attempt=attempt):
                        return self._watchdog.call(step)
                except Exception as e:  # noqa: BLE001
                    error = e
                    attempt += 1
                    continue
            # The park's fetch blocks on the device too: watchdog-guard it
            # so a wedged device cannot turn the abort into a hang; the
            # guard makes the session write and the abort's abandonment
            # mutually exclusive, so the checkpointed flag below is
            # truthful in every interleaving.
            guard = _ParkGuard()
            try:
                with spans.span("gol.park", turn=turn):
                    checkpointed = self._watchdog.call(
                        lambda: self._park_checkpoint(board_in, turn, guard)
                    )
            except Exception:  # device wedged: board unfetchable
                checkpointed = guard.abandon()
            self.flight.record(
                "terminal_park", turn=turn, checkpointed=checkpointed
            )
            self._emit(
                DispatchError(
                    turn,
                    error=str(error),
                    checkpointed=checkpointed,
                    attempt=attempt,
                )
            )
            raise error

    def _park_checkpoint(self, board, turn: int, guard=None) -> bool:
        """Park the last good board as a paused checkpoint after a terminal
        dispatch failure.  A seam, not just a helper: on a multi-host run the
        ``fetch`` below is a collective allgather, and after a one-sided
        failure the peer processes are not guaranteed to enter it — so the
        multi-host controller overrides this to skip checkpointing rather
        than hang alone in a collective.

        ``guard`` (a :class:`_ParkGuard`, present when the watchdog owns
        this call): the session write goes through ``guard.commit`` so a
        park the abort abandoned can never mutate the session behind a
        ``checkpointed=False`` report."""
        world = self.backend.fetch(board)

        def commit():
            self.session.pause(
                True,
                world=world,
                turn=turn,
                rule=self.params.rule.notation,
                **self._ckpt_accounting(turn),
            )

        if guard is None:
            commit()
            return True
        return guard.commit(commit)

    def _ckpt_accounting(self, turn: int) -> dict:
        """Checkpoint-truthfulness fields: a time-compressed run's sidecars
        split delivered turns (``effective_turns`` == ``turn``) from
        dispatched ones (``computed_turns``).  Empty when the tier is off —
        dense sidecars stay byte-identical."""
        tc = self._timecomp
        if tc is None:
            return {}
        return {
            "computed_turns": turn - tc.skipped_turns,
            "effective_turns": turn,
        }

    # -- durable periodic checkpoints --------------------------------
    def _save_checkpoint(self, world, turn: int):
        """The session-write half of a periodic checkpoint — a seam: the
        multi-host controller overrides it so FOLLOWERS drop the
        (collectively fetched) world instead of pinning a full-board copy
        on a throwaway session nothing can ever resume."""
        self.session.save_checkpoint(
            world,
            turn,
            rule=self.params.rule.notation,
            keep=self.params.checkpoint_keep,
            # The artifact embedding: the sidecar carries the
            # run's metrics-so-far, so a postmortem can read a crashed
            # run's telemetry off its last checkpoint.
            metrics=self._run_metrics() if self.params.metrics else None,
            # Correlation stamp: joins this sidecar to the
            # run's MetricsReport, flight dumps, and scrape series.
            run_id=self.run_id,
            tenant=self.params.tenant,
            **self._ckpt_accounting(turn),
        )

    def _checkpoint_due(self, turn: int) -> bool:
        p = self.params
        if (
            p.checkpoint_every_turns
            and turn - self._last_ckpt_turn >= p.checkpoint_every_turns
        ):
            return True
        return bool(
            p.checkpoint_every_seconds
            and time.monotonic() - self._last_ckpt_time
            >= p.checkpoint_every_seconds
        )

    def _ckpt_due_now(self, turn: int) -> bool:
        """Whether THIS boundary will park a periodic checkpoint
        (``Params.checkpoint_every_turns`` / ``checkpoint_every_seconds``).
        Evaluated exactly once per boundary — the wall-clock cadence
        reads ``time.monotonic()``, so deciding, running the (possibly
        seconds-long) SDC probe, then re-deciding could flip the answer
        between the sentinel and the save.  The turn cadence is
        deterministic in the dispatch schedule, so on multi-host runs
        every process enters the collective ``fetch`` together (the
        wall-clock cadence is refused there — ``run_distributed``)."""
        if turn <= self._last_ckpt_turn or turn >= self.params.turns:
            # Nothing new to guard — and the final turn is about to become
            # the durable final PGM anyway (a completed run discards its
            # periodic checkpoints in _finalize).
            return False
        return self._checkpoint_due(turn)

    def _guard_boundary(self, board_in, board_out, turn, k, count) -> bool:
        """The turn-boundary resilience pair: SDC-check the dispatch that
        just resolved, then park a periodic checkpoint if one is due —
        in that order, with the sentinel FORCED (out of cadence) at any
        boundary about to park.  Verify-before-park is what makes the
        checkpoint trustworthy: without it the wall-clock cadence could
        persist a board corrupted since the last check, and the
        supervisor would roll back INTO corruption (``Params`` refuses
        the analogous turn-cadence misconfiguration outright).  A
        CorruptionDetected raised by the forced check propagates before
        the save runs, so a corrupt board is never parked.  Returns
        whether either leg stalled the pipeline on a device fetch
        (callers re-latch their pipeline clocks)."""
        self._last_resolved = (board_out, count)
        due = self._ckpt_due_now(turn)
        checked = self._maybe_sdc_check(
            board_in, board_out, turn, k, count, force=due
        )
        if due and checked is _SDC_SKIPPED:
            # The verify is what makes the park trustworthy: a transient
            # probe error at a parking boundary (the correlated-failure
            # case — a sick device corrupting state AND failing its own
            # health check) must not park the never-verified board.
            # Older checkpoints stay authoritative, and the cadence
            # anchors are left alone, so the very next boundary is due
            # again and parks once a forced check passes.
            self.flight.record("ckpt_skipped_unverified", turn=turn)
            due = False
        wrote = due and self._checkpoint_now(board_out, turn)
        return wrote or bool(checked)

    def _checkpoint_now(self, board, turn: int) -> bool:
        """The guarded fetch-and-save half of a checkpoint, shared by the
        periodic cadence (``_guard_boundary``) and the out-of-cadence
        emergency checkpoint a graceful stop forces (``_preempt_exit``) —
        one home for the watchdog bound, the failure degradation, and the
        obs records."""
        # The fetch blocks on the device (and, multi-host, is a collective
        # allgather): watchdog-bounded like every other blocking dispatch
        # wait, so a wedged device or dead peer surfaces as the terminal
        # DispatchTimeout abort, never a hang at the checkpoint.
        t0 = time.perf_counter()
        try:
            with spans.span("gol.checkpoint.fetch", turn=turn, tier=self._tier):
                world = self._watchdog.call(lambda: self.backend.fetch(board))
            self._save_checkpoint(world, turn)
        except DispatchTimeout as e:
            # Wedged device/collective: the watchdog abort policy.  Tell
            # the stream (like every other terminal timeout) before the
            # sentinel — no park attempt, the fetch just proved wedged.
            self._emit(DispatchError(turn, error=str(e), checkpointed=False))
            raise
        except Exception as e:  # noqa: BLE001 — ENOSPC, perms, ...
            # Crash insurance must not BE the crash: a failed save leaves
            # the run computing and the previous checkpoints intact; warn
            # once and retry at the next cadence.  BOTH cadence anchors
            # advance — the due schedule must stay a pure function of the
            # dispatch schedule (multi-host processes decide `due`
            # independently, and the collective fetch above only lines up
            # if a save failure on one process cannot desync its anchors).
            self._m_ckpt_failures.inc()
            self.flight.record(
                "checkpoint_failed", turn=turn, error=str(e)[:200]
            )
            if not self._ckpt_save_warned:
                self._ckpt_save_warned = True
                import warnings

                warnings.warn(
                    f"periodic checkpoint at turn {turn} failed ({e}); "
                    "run continues, will retry at the next cadence",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self._last_ckpt_turn = turn
            self._last_ckpt_time = time.monotonic()
            return False
        save_s = time.perf_counter() - t0
        self._m_ckpt_saves.inc()
        self._m_ckpt_bytes.inc(world.nbytes)
        self._h_ckpt_seconds.observe(save_s)
        self.flight.record(
            "checkpoint",
            turn=turn,
            bytes=int(world.nbytes),
            s=round(save_s, 6),
        )
        self._ckpt_saved = True
        self._last_ckpt_turn = turn
        self._saved_ckpt_turn = turn
        self._last_ckpt_time = time.monotonic()
        self._emit(CheckpointSaved(turn))
        return True

    # -- graceful stop / preemption ----------------------------------
    def _stop_now(self) -> bool:
        """Whether a graceful stop (SIGTERM/SIGINT latch) is pending —
        polled at turn boundaries.  A seam: the multi-host controller
        overrides this with a tiny allgather so ANY signalled rank stops
        the whole collective together instead of vanishing mid-allgather
        (``parallel/multihost.py``).  A True result is latched in
        ``_stop_seen`` (here and in the override) so later code can act
        on it without another poll."""
        if self._stop is not None and bool(self._stop.requested):
            self._stop_seen = True
        return self._stop_seen

    def _preempt_exit(self, board, turn: int):
        """The preemption contract: a graceful stop observed at a turn
        boundary forces an out-of-cadence EMERGENCY checkpoint (the same
        guarded fetch path as the periodic cadence) and exits
        paused-and-resumable — a fresh run with the same session resumes
        at ``turn`` exactly.  If a periodic checkpoint at this very turn
        already exists the save is skipped (the session is already
        resumable); a failed save degrades exactly like a failed periodic
        one (older checkpoints stay authoritative)."""
        self._m_preempt.inc()
        self.flight.record("preempt", turn=turn)
        due = self._emergency_save_due(turn)
        if due and self._last_sdc_turn != turn:
            # Verify-before-park holds for the EMERGENCY checkpoint too:
            # when the sentinel is armed and this boundary was not already
            # checked, cross-check the board about to be parked against
            # its dispatch's forced count (k=0: popcount/fingerprint leg
            # only — the stripe recompute would need the pre-dispatch
            # board, dropped long ago, and pinning it for the whole run
            # would double peak board memory).  A CorruptionDetected here
            # propagates BEFORE the save: the corrupt board is never
            # parked, older checkpoints stay authoritative, and a
            # supervisor rolls back instead of resuming into corruption.
            lr = self._last_resolved
            if lr is not None and lr[0] is board:
                checked = self._maybe_sdc_check(
                    board, board, turn, 0, lr[1], force=True
                )
                if checked is _SDC_SKIPPED:
                    # A transient probe error means the board about to be
                    # parked was never verified: withhold the emergency
                    # save (same policy as _guard_boundary) — the exit
                    # stays resumable from the last GOOD checkpoint
                    # rather than durably committing an unverified board.
                    self.flight.record("preempt_save_skipped", turn=turn)
                    due = False
        self._emit(StateChange(turn, State.QUITTING))
        if due:
            with spans.span("gol.preempt.checkpoint", turn=turn):
                self._checkpoint_now(board, turn)
        self._outcome = "preempted"

    def _emergency_save_due(self, turn: int) -> bool:
        """Whether the preemption needs an out-of-cadence save: gate on
        the last SUCCESSFUL save — a failed periodic save at this same
        boundary advanced the cadence anchor but left nothing resumable
        here, so the emergency save must still be attempted (the failure
        may have been transient, e.g. freed disk space).  A seam: the
        answer depends on process-LOCAL disk outcomes (a follower's no-op
        save "succeeds" while process 0's hits ENOSPC), and
        ``_checkpoint_now``'s fetch is a collective — so the multi-host
        controller overrides this to broadcast process 0's decision,
        keeping every rank on the same side of that collective."""
        return turn > self._saved_ckpt_turn

    # -- SDC sentinel ------------------------------------------------
    def _maybe_sdc_check(
        self,
        board_in,
        board_out,
        turn: int,
        k: int,
        count: int,
        force: bool = False,
    ):
        """Every ``Params.sdc_check_every_turns``, cross-check the
        dispatch that just resolved (``board_in`` --k turns--> ``board_out``
        with forced alive ``count``) against redundant on-device work:

        - a recompute of the whole dispatch on a sampled row stripe
          through the independent roll-stencil formulation, and
        - a popcount + rolling-hash fingerprint of ``board_out``, whose
          popcount must equal the count the dispatch already forced.

        ``force=True`` runs the check out of cadence (still only when
        the sentinel is armed): ``_guard_boundary`` forces it at every
        boundary about to park a checkpoint, so nothing durable is ever
        written unverified.  For dispatches too deep for the stripe
        recompute to stay a sampled check
        (``Backend.sdc_stripe_affordable``) only the popcount/fingerprint
        leg runs — counted in ``sdc.stripe_skipped`` — instead of a
        full-board slow-formulation replay that could outcost the run
        and trip the dispatch watchdog.

        The stripe start is a pure function of the turn, so multi-host
        processes issue the identical collective.  A mismatch raises
        :class:`CorruptionDetected` — terminal, never retried (the state
        is corrupt; retrying computes garbage forward), and the board is
        deliberately NOT parked; the supervisor rolls back to the last
        periodic checkpoint instead.

        Returns ``False`` when no probe ran (sentinel off / not due),
        ``_SDC_VERIFIED`` on a passing check, or ``_SDC_SKIPPED`` when a
        transient probe error skipped it — both truthy (the device was
        hit either way, so pipeline callers re-latch their clocks), but
        a parking boundary must treat ``_SDC_SKIPPED`` as NOT verified
        and withhold the park (``_guard_boundary``, ``_preempt_exit``)."""
        p = self.params
        if not p.sdc_check_every_turns:
            return False
        if not force and turn - self._last_sdc_turn < p.sdc_check_every_turns:
            return False
        self._last_sdc_turn = turn
        self._m_sdc_checks.inc()
        # k == 0 is the preemption cross-check: board_out IS board_in, so
        # only the popcount/fingerprint leg carries information.
        stripe = k > 0 and self.backend.sdc_stripe_affordable(k)
        if not stripe:
            self.metrics.counter("sdc.stripe_skipped").inc()
        # Golden-ratio hash of the turn: a deterministic, schedule-pure
        # stripe sample (identical on every process of a multi-host run).
        y0 = (turn * 2654435761) % p.image_height
        with spans.span("gol.sdc.check", turn=turn, k=k):
            try:
                ok, pop, fp = self._watchdog.call(
                    lambda: self.backend.sdc_probe(
                        board_in, board_out, k, y0, stripe=stripe
                    )
                )
            except DispatchTimeout as e:
                # Wedged device: the watchdog abort policy — announce the
                # cause on the stream like every other timed-out fetch,
                # then let the terminal path run.
                self._emit(DispatchError(turn, error=str(e), checkpointed=False))
                raise
            except Exception as e:  # noqa: BLE001 — transient device error
                # The health check must not BE the failure: a transient
                # probe error (the class the retry policy exists to
                # absorb) skips this check — the data path's own
                # retry/sentinel machinery owns real failures.  Warn once,
                # count it, retry at the next cadence.
                self.metrics.counter("sdc.probe_failures").inc()
                self.flight.record(
                    "sdc_probe_failed", turn=turn, error=str(e)[:200]
                )
                if not self._sdc_probe_warned:
                    self._sdc_probe_warned = True
                    import warnings

                    warnings.warn(
                        f"SDC probe at turn {turn} failed ({e}); check "
                        "skipped, will retry at the next cadence",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                return _SDC_SKIPPED
        self.flight.record(
            "sdc_check",
            turn=turn,
            ok=bool(ok),
            fingerprint=int(fp),
            stripe=stripe,
        )
        if ok and pop == count:
            return _SDC_VERIFIED
        self._m_sdc_mismatches.inc()
        self.flight.record(
            "sdc_mismatch",
            turn=turn,
            stripe_ok=bool(ok),
            popcount=int(pop),
            count=int(count),
        )
        err = CorruptionDetected(
            f"SDC sentinel: device state at turn {turn} fails its redundant "
            f"recompute (stripe y0={y0} ok={bool(ok)}, popcount {pop} vs "
            f"forced count {count})"
        )
        self._emit(DispatchError(turn, error=str(err), checkpointed=False))
        raise err

    # -- observability plumbing --------------------------------------
    def _run_metrics(self) -> dict:
        """This run's metrics so far: the registry delta against the
        run-start snapshot, as a plain ``gol-metrics-v1`` dict."""
        return self.metrics.snapshot().delta(self._metrics_start).to_dict()

    def _gather_snapshots(self, snap: dict) -> list[dict]:
        """The multihost aggregation seam: single-host, a run's snapshot
        is the whole story; the multihost controller overrides this to
        allgather every process's snapshot through the existing broadcast
        transport (``parallel/multihost.py``)."""
        return [snap]

    def _flight_dir(self):
        """Where the postmortem lands: next to the durable checkpoints
        when the session has a directory, else the run's out_dir."""
        return self.session.checkpoint_dir or self.params.out_dir

    def _dump_flight(self, exc: BaseException) -> None:
        """Terminal-path postmortem: dump the flight ring (with the run's
        metrics delta) before the run dies.  Best-effort by contract —
        never masks the abort being documented.  The snapshot here SKIPS
        the lazy callback gauges (``include_lazy=False``): skip-fraction
        and friends force on-device values, and on the very wedged device
        this dump is documenting that force would hang the abort path
        forever, outside any watchdog."""
        try:
            metrics = (
                self.metrics.snapshot(include_lazy=False)
                .delta(self._metrics_start)
                .to_dict()
                if self.params.metrics
                else None
            )
            self.flight.dump(
                self._flight_dir(),
                cause=type(exc).__name__,
                error=str(exc),
                turn=self._dispatch_rec.last_turn,
                metrics=metrics,
                run_id=self.run_id,
                tenant=self.params.tenant,
                trace_id=self.trace.trace_id if self.trace else None,
            )
        except Exception:  # noqa: BLE001 — the abort must still propagate
            pass

    # -- the run (distributor, gol/distributor.go:194-262) ---------------------
    def run(self):
        """Drive the whole run; the event stream is always terminated with
        the ``None`` sentinel, even on error — a viewer blocked on the queue
        must never hang because the engine died (the reference relies on
        ``close(events)`` for the same guarantee, ``gol/distributor.go:262``).
        Every terminal path additionally dumps the flight recorder
        (``flight-<ts>.json`` next to the checkpoint dir) so a dead run
        leaves its own postmortem; clean completions and q/k exits write
        nothing."""
        try:
            self._run()
        except BaseException as e:
            # Supervised attempts defer both the postmortem dump and the
            # stream sentinel to the supervisor: a restartable abort is
            # not the end of the stream, and a RECOVERED run must write no
            # flight record at all (absence = nothing went wrong).
            if not self._supervised:
                self._dump_flight(e)
                self.events.put(None)
            raise

    def _run(self):
        p = self.params
        board_np, start_turn = self._initial_world()
        self._last_ckpt_turn = start_turn
        # A RESUMED run just CONSUMED the pair it started from (resume is
        # consume-once), so the session is NOT resumable at start_turn —
        # a preemption before the first new save must re-park the board,
        # not skip on "already saved here".  Fresh runs (nothing consumed)
        # keep the skip: preempting at turn 0 loses nothing.
        self._saved_ckpt_turn = start_turn - 1 if self._resumed else start_turn
        self._last_ckpt_time = time.monotonic()
        self._last_sdc_turn = start_turn
        viewer = p.wants_flips() or p.wants_frames()

        # Initial flips: one per alive cell of the *actual* starting world
        # (the reference emits them from the freshly loaded PGM even when it
        # then resumes from a checkpoint, desyncing viewers; deliberate fix).
        if p.wants_flips():
            ys, xs = np.nonzero(board_np)
            self._emit_flips(start_turn, np.stack([ys, xs], axis=1))
        elif p.wants_frames():
            # The starting frame, through the same pooling op every later
            # frame uses (on the host: the board is not placed yet).
            from distributed_gol_torch.ops import stencil

            fy, fx = p.frame_factors()
            src, rect = board_np, None
            if self._rect is not None:
                # Viewport viewer: the starting KEYFRAME covers the
                # viewport only — a host-side toroidal crop of the loaded
                # world, with the device path's wrap semantics.
                y0, x0, vh, vw = self._rect
                rows = (np.arange(vh) + y0) % p.image_height
                cols = (np.arange(vw) + x0) % p.image_width
                src = board_np[rows[:, None], cols[None, :]]
                rect = tuple(self._rect)
            pooled = stencil.frame_pool(torch.from_numpy(np.array(src)), fy, fx).numpy()
            self._emit(FrameReady(start_turn, pooled, (fy, fx), rect=rect))

        board = self.backend.put(board_np)
        state = _TickerState(start_turn, int(np.count_nonzero(board_np)))
        ticker = _Ticker(p.ticker_period, self.events, state)
        ticker.start()
        try:
            if viewer:
                board, turn = self._viewer_loop(board, start_turn, state)
            else:
                board, turn = self._headless_loop(board, start_turn, state)
        finally:
            ticker.stop()
            ticker.join()

        self._finalize(board, turn)

    def _viewer_loop(self, board, turn: int, state: _TickerState):
        """Per-turn visible stepping, synchronous — a viewer wants the
        freshest turn, not pipelined throughput.  Flips mode is exactly
        per-turn (the reference contract needs every diff); frame mode
        advances ``Params.frame_stride`` exact generations per rendered
        frame, with the TurnComplete stream staying dense and each frame
        delivered before its own turn's TurnComplete.

        Latency-adaptive stride (``frame_stride == 0``, the default): the
        frame-fetch round-trip is measured at viewer start (the pool +
        transfer probe, no simulation), the first two stride-1 dispatches
        warm up and time one generation, and the effective stride is then
        raised so a slow link stops rate-limiting the simulation
        (``_auto_frame_stride``).  An explicit ``frame_stride`` always
        wins; local links keep the frame-per-turn cadence either way."""
        p = self.params
        wants_flips = p.wants_flips()
        fy, fx = p.frame_factors()
        roi = self._rect is not None and not wants_flips
        rect = tuple(self._rect) if roi else None
        stride = p.runtime_superstep()  # 1 for flips; frame_stride for frames
        auto_stride = not wants_flips and p.frame_stride == 0 and turn < p.turns
        rtt = (
            self._measure_frame_rtt(board, fy, fx, turn, rect=rect)
            if auto_stride
            else 0.0
        )
        probed_area = rect[2] * rect[3] if roi else 0
        self.frame_stride_effective = stride
        warm_frames = 0
        while turn < p.turns:
            if self._stop_now():
                self._preempt_exit(board, turn)
                break
            self._poll_keys(board, turn)
            if self._outcome != "completed":
                break
            if self._stop_seen:
                # A stop observed inside the paused keys loop preempts at
                # the turn the user froze.
                self._preempt_exit(board, turn)
                break
            t0 = time.perf_counter()
            board_in = board
            if wants_flips:
                k = 1
                board, count, coords = self._dispatch(
                    lambda: self.backend.run_turn_with_flips(board),
                    board,
                    turn,
                )
                turn += 1
                state.set(turn, count)
                self._emit_flips(turn, coords)
            else:
                if roi:
                    # The live rect: pan/zoom keys mutate it between
                    # dispatches; a zoom also changes the pool factors.
                    rect = tuple(self._rect)
                    fy, fx = self._roi_factors(rect)
                    if self._rect_resized:
                        self._rect_resized = False
                        area = rect[2] * rect[3]
                        # Re-probe on a MATERIAL size change (>= 2x either
                        # way): the stride must be sized from the fetch the
                        # viewer pays now, and a re-warm re-times one
                        # generation at the new rect.
                        if auto_stride and not (
                            probed_area // 2 < area < probed_area * 2
                        ):
                            rtt = self._measure_frame_rtt(
                                board, fy, fx, turn, rect=rect
                            )
                            probed_area = area
                            stride = 1
                            warm_frames = 0
                            self.frame_stride_effective = stride
                k = min(stride, p.turns - turn)
                t_disp = time.perf_counter()
                if roi:
                    step_rect = rect
                    board, count, frame = self._dispatch(
                        lambda: self.backend.run_turn_with_viewport(
                            board, step_rect, fy, fx, k
                        ),
                        board,
                        turn,
                    )
                else:
                    board, count, frame = self._dispatch(
                        lambda: self.backend.run_turn_with_frame(
                            board, fy, fx, k
                        ),
                        board,
                        turn,
                    )
                if auto_stride and stride == 1:
                    # Dispatch 1 pays the one-time set-up — warm only;
                    # dispatch 2 times one true (generation + fetch) and
                    # fixes the stride for the rest of the run.
                    warm_frames += 1
                    if warm_frames == 2:
                        stride = self._auto_frame_stride(
                            rtt, time.perf_counter() - t_disp
                        )
                        self.frame_stride_effective = stride
                self._emit_turns(turn + 1, turn + k - 1)
                turn += k
                state.set(turn, count)
                self._emit_frame(turn, frame, (fy, fx), rect)
                if self.frame_plane is not None:
                    # Spectator fan-out: ONE coalesced device fetch per
                    # rendered turn serves every subscriber, riding the
                    # full dispatch contract (watchdog and retry policy)
                    # like every other per-turn fetch.
                    fetch_board = board
                    self.frame_plane.publish(
                        turn,
                        lambda r: self._dispatch(
                            lambda: self.backend.fetch_viewport(fetch_board, r),
                            fetch_board,
                            turn,
                        ),
                    )
            self._emit(TurnComplete(turn))
            # The unified per-dispatch record, shared with the pipelined
            # headless path (DispatchRecorder).
            self._dispatch_rec.record(turn, k, time.perf_counter() - t0)
            self._guard_boundary(board_in, board, turn, k, count)
        return board, turn

    def _roi_factors(self, rect) -> tuple[int, int]:
        """(fy, fx) pooling factors for the LIVE viewport rect — the
        dynamic-zoom form of ``Params.frame_factors`` (which only knows
        the starting viewport)."""
        return self.params.factors_for(rect[2], rect[3])

    def _mark_first_frame(self) -> None:
        """Time-to-first-frame SLI: observed once per traced request, at
        the first frame emitted to the viewer stream."""
        if self.trace is not None:
            first = self.trace.mark("first_frame")
            if first is not None:
                self._h_ttff.observe(first)

    def _emit_frame(self, turn: int, frame, factors, rect):
        """Emit one rendered frame: a FrameReady keyframe when the delta
        protocol is off, not yet anchored, or just re-anchored (first
        frame, pan/zoom, shape change); else the changed-band FrameDelta
        against the last delivered frame (``engine/frames.py``)."""
        self._mark_first_frame()
        if not self._deltas_on:
            self._emit(FrameReady(turn, frame, factors, rect=rect))
            return
        from distributed_gol_torch.engine import frames as frames_lib

        last = self._last_frame
        self._last_frame = frame
        if (
            last is None
            or self._frame_keyframe
            or last.shape != frame.shape
        ):
            self._frame_keyframe = False
            self._emit(FrameReady(turn, frame, factors, rect=rect))
            return
        bands = frames_lib.delta_bands(last, frame)
        self._emit(FrameDelta(turn, bands=bands, factors=factors, rect=rect))

    def _measure_frame_rtt(
        self,
        board,
        fy: int,
        fx: int,
        turn: int = 0,
        probes: int = 3,
        rect=None,
    ) -> float:
        """Median round-trip of one frame fetch (pool + count + bit-pack
        + host transfer, no simulation — ``Backend.probe_frame_fetch``),
        first call excluded (one-time set-up).  With ``rect`` the probe
        runs the VIEWPORT fetch path, so the auto-stride policy is sized
        from what a viewport viewer actually pays.  Device work goes
        through the standard dispatch contract (watchdog + retry);
        ``turn`` is the run's TRUE current turn — a terminal probe failure
        parks the board as a checkpoint at that turn."""
        probe = lambda: self.backend.probe_frame_fetch(  # noqa: E731
            board, fy, fx, rect=rect
        )
        self._dispatch(probe, board, turn)  # warm-up
        times = []
        for _ in range(max(1, probes)):
            t0 = time.perf_counter()
            self._dispatch(probe, board, turn)
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    # Auto-stride engages above this measured per-frame round-trip: below
    # it the link is effectively local and the reference-faithful
    # frame-per-turn cadence costs nothing worth trading away.
    _STRIDE_RTT_ENGAGE = 0.02
    # ...and the raised stride is bounded: even a free generation never
    # strides past 256 turns per frame (the screen still updates at the
    # link's fps; the bound keeps keypress latency and the TurnComplete
    # emission chunk sane).
    _STRIDE_MAX = 256

    @classmethod
    def _auto_frame_stride(cls, rtt: float, dispatch_s: float) -> int:
        """The latency-adaptive stride policy: with ``rtt`` the measured
        per-frame fetch round-trip and ``dispatch_s`` one warm stride-1
        frame dispatch (= one generation + one fetch), pick
        ``stride ≈ rtt / t_gen`` — device time per dispatch then matches
        the fetch time, so the fetch overhead drops from ~100% of
        wall-clock to ~50% while frames keep arriving at the link's
        natural fps.  Local links (rtt < 20 ms) keep stride 1."""
        if rtt < cls._STRIDE_RTT_ENGAGE:
            return 1
        t_gen = max(dispatch_s - rtt, rtt / cls._STRIDE_MAX, 1e-4)
        return max(1, min(cls._STRIDE_MAX, round(rtt / t_gen)))

    def _headless_loop(self, board, turn: int, state: _TickerState):
        """Headless stepping: multi-generation supersteps, **pipelined** —
        superstep k+1 is issued before the counts of superstep k are
        forced (CUDA work is asynchronous), so host work (TurnComplete
        emission, key polling, the ticker) and the per-dispatch transfer
        latency overlap device compute instead of serialising with it.
        The pipeline is depth 2: at most one dispatch is unresolved when
        the next is issued, so a keypress is honoured within ~2 dispatch
        times — the same interactivity contract as
        ``Params.max_dispatch_seconds``.

        The reference pays two synchronous TCP round-trips per generation
        (``gol/distributor.go:48-66``); this loop pays zero exposed
        round-trips per superstep in steady state."""
        p = self.params
        superstep = p.runtime_superstep()
        # Adaptive dispatch (superstep=0, headless): grow the dispatch size
        # until one dispatch takes ~max_dispatch_seconds, so deep temporal
        # blocking amortises without unbounded keypress latency (SURVEY §7
        # hard part 3).  Doubling keeps the number of distinct dispatch
        # sizes logarithmic (sizes 50·2^n plus at most one tail
        # remainder k < superstep per distinct k); the cap bounds the
        # per-turn event flood of one dispatch — batch turn telemetry has
        # no flood, so its cap is effectively the run length.
        adaptive = p.superstep == 0 and p.no_vis
        batch = p.turn_events == "batch"
        cap = self._ADAPT_CAP_BATCH if batch else self._ADAPT_CAP
        # The first dispatch at each size pays one-time set-up (the kernel
        # build, allocator growth); adapting on that wall-clock would
        # halve/oscillate forever.  Only dispatches at an already-seen size
        # update the size.
        warm_sizes: set[int] = set()

        # One in-flight dispatch: (board_in, board_out, count_dev, k, t_issue).
        pending = None
        prev_resolve = 0.0

        def resolve():
            """Force the pending dispatch's count, emit its turn events,
            latch the ticker pair, and adapt the superstep.  Returns the
            settled board; on a resolve-time device failure the retry
            contract replaces it (callers must discard any dispatch they
            speculatively issued on the failed board)."""
            nonlocal pending, turn, prev_resolve, superstep
            board_in, board_out, count_dev, k, t_issue = pending
            pending = None
            try:
                with spans.span(
                    "gol.resolve", turn=turn + k, k=k, tier=self._tier
                ):
                    count = self._force(count_dev)
            except Exception as e:  # noqa: BLE001 — device/runtime failure
                board_out, count = self._retry_failed(
                    lambda: self.backend.run_turns(board_in, k),
                    board_in,
                    turn,
                    e,
                )
            now = time.perf_counter()
            # Steady state: time since the previous resolve == device time
            # per dispatch (host work is overlapped).  After an idle gap
            # (pipeline drained), fall back to this dispatch's issue time.
            dt = now - max(prev_resolve, t_issue)
            prev_resolve = now
            if batch:
                self._emit(TurnsCompleted(turn + k, first_turn=turn + 1))
            else:
                self._emit_turns(turn + 1, turn + k)
            turn += k
            state.set(turn, count)
            # The unified per-dispatch record — shared with the sync
            # viewer path.
            self._dispatch_rec.record(turn, k, dt)
            if adaptive and k == superstep:
                superstep = self._next_superstep(k, dt, superstep, warm_sizes, cap)
            if self._guard_boundary(board_in, board_out, turn, k, count):
                # The checkpoint/sentinel fetch stalled the pipeline;
                # don't bill that host time to the next dispatch's
                # adaptive sizing.
                prev_resolve = time.perf_counter()
            return board_out

        # Whole-board cycle detection (Params.cycle_check): every
        # ``probe_every`` issued dispatches, issue an async period-6 probe
        # on the current (possibly still unresolved) board, and force the
        # *previous* probe's flag — which resolved dispatches ago, so the
        # read costs one round-trip, not a pipeline stall.  Probes are
        # scheduled by dispatch count, not wall-clock, so every process of
        # a multi-host run makes the identical sequence of collective
        # calls.  Once a probe passes, periodicity holds for every later
        # turn (the dynamics are deterministic), so acting on the flag a
        # few dispatches after it was computed is still exact.
        #
        # Time compression rides this probe as its settledness detector,
        # so an armed tier with cycle_check=0 would otherwise be
        # configured to never engage — give it the default cadence instead
        # (dense runs keep cycle_check's exact semantics).
        probe_every = p.cycle_check
        if not probe_every and self._timecomp is not None:
            probe_every = type(p).cycle_check
        probe_flag = None
        n_issued = 0
        next_probe = probe_every

        issued_turn = turn
        while True:
            # Graceful stop: polled at the top of every
            # iteration — a turn boundary, like the keys poll below.  On
            # multi-host runs _stop_now is a tiny collective (any rank's
            # SIGTERM stops everyone together), so it must be evaluated
            # unconditionally at this schedule point on every process.
            if self._stop_now():
                if pending is not None:
                    board = resolve()
                if turn < p.turns:
                    self._preempt_exit(board, turn)
                    return board, turn
            # Keys are handled against a settled board and exact turn:
            # drain the pipeline first whenever a key is waiting (or we
            # are paused).  ``empty()`` is deterministic across processes
            # in multi-host runs (_BroadcastKeys), keeping the SPMD
            # control flow identical everywhere.
            if self.key_presses is not None and (
                self._paused or not self.key_presses.empty()
            ):
                if pending is not None:
                    board = resolve()
                    issued_turn = turn
                self._poll_keys(board, turn)
                if self._outcome != "completed":
                    return board, turn
                if self._stop_seen and turn < p.turns:
                    # Stop observed while paused: preempt at the frozen
                    # turn (the pipeline was drained before _poll_keys).
                    self._preempt_exit(board, turn)
                    return board, turn
            if probe_every and n_issued >= next_probe and issued_turn < p.turns:
                next_probe = n_issued + probe_every
                if probe_flag is not None:
                    with spans.span("gol.cycle_probe.force", turn=turn):
                        fired = self._force_probe(probe_flag)
                    probe_flag = None
                    if fired:
                        if pending is not None:
                            board = resolve()
                        issued_turn = turn
                        if self._timecomp is None:
                            return self._fast_forward(board, turn, state)
                        ff = self._timecomp_fast_forward(board, turn, state)
                        if ff is not None:
                            return ff
                        # The exactness entry guard refused the
                        # fast-forward (independent-stencil re-derivation
                        # mismatched): nothing was emitted, so "dense
                        # replay from the last verified turn" is simply
                        # this loop continuing to dispatch from ``turn``.
                # Rung 3: while the activity bitmap proves live frontier
                # stripes remain, a whole-board periodicity probe cannot
                # pass — defer its device work and let the adaptive
                # tier's spatial skip keep grinding.
                if self._timecomp is not None and self._timecomp.defer_probe(
                    self.backend
                ):
                    continue
                with spans.span("gol.cycle_probe.issue", turn=issued_turn):
                    probe_flag = self.backend.cycle_probe_async(board)
            if issued_turn >= p.turns:
                break
            k = min(superstep, p.turns - issued_turn)
            n_issued += 1
            t0 = time.perf_counter()
            try:
                with spans.step_span(
                    "gol.issue",
                    n_issued,
                    turn=issued_turn,
                    k=k,
                    tier=self._tier,
                ):
                    new_board, count_dev = self.backend.run_turns_async(board, k)
                self._h_issue_seconds.observe(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — issue-time failure
                # Settle what already ran, then apply the retry contract
                # to the failed dispatch synchronously and route its
                # result through resolve() so event emission, the ticker
                # latch, and timing telemetry have exactly one home.
                if pending is not None:
                    board = resolve()
                new_board, count = self._retry_failed(
                    lambda: self.backend.run_turns(board, k), board, turn, e
                )
                pending = (board, new_board, count, k, t0)
                board = resolve()
                issued_turn = turn
                continue
            spec = (board, new_board, count_dev, k, t0)
            if pending is not None:
                # Depth-2 occupancy: this issue overlapped an unresolved
                # dispatch — the pipelining the headless path exists for.
                self._m_pipeline_overlap.inc()
                out_expected = pending[1]
                settled = resolve()
                if settled is not out_expected:
                    # Resolve-time retry replaced the board the speculative
                    # dispatch was issued on; discard it and re-issue.
                    board = settled
                    issued_turn = turn
                    continue
            pending = spec
            board = new_board
            issued_turn += k
            if _PIPELINE_DISABLED:
                board = resolve()  # A/B accounting aid; see flag above
        if pending is not None:
            board = resolve()
        return board, turn

    def _next_superstep(
        self, k: int, dt: float, superstep: int, warm_sizes: set, cap: int
    ) -> int:
        """One adaptive-sizing decision per resolved dispatch at the current
        size: double while a dispatch finishes in under half the target,
        halve past 1.5×.  The first dispatch at each size includes jit
        compilation, so it only warms the size — adapting on that
        wall-clock would halve/oscillate forever.

        A seam: every call site is deterministic in the dispatch schedule
        (``adaptive and k == superstep``), but ``dt`` is local wall-clock —
        the one input a multi-host run cannot share.  The multi-host
        controller overrides this to broadcast process 0's decision so all
        processes run the identical schedule (``parallel/multihost.py``)."""
        if k not in warm_sizes:
            warm_sizes.add(k)  # compile dispatch: don't adapt
            return superstep
        p = self.params
        if dt < p.max_dispatch_seconds / 2:
            return min(superstep * 2, cap)
        if dt > p.max_dispatch_seconds * 1.5 and superstep > 1:
            return max(1, superstep // 2)
        return superstep

    def _force_probe(self, flag) -> bool:
        """Force a cycle-probe flag.  Single-host, the probe is advisory:
        if forcing it surfaces a device failure (e.g. it was computed from
        a dispatch the retry contract has since replaced), drop it and let
        the data path's own retry handle the real failure.  A seam because
        multi-host must NOT swallow: the flag's value is identical on
        every process, but *forcing* is per-process — one process quietly
        reading False while its peers read True would diverge the
        collective schedules, so the multi-host controller re-raises
        instead (see MultihostController)."""
        try:
            return bool(flag)
        except Exception:  # noqa: BLE001 — device/runtime failure
            return False

    # Per-turn fast-forward emission chunk: bounds the latency of a key
    # poll / ticker latch during cycle-mode dense TurnComplete emission.
    _FF_CHUNK = 1 << 16

    def _fast_forward(self, board, turn: int, state: _TickerState):
        """The board at ``turn`` is proved periodic (period dividing the
        rule's probe depth, ``Backend.cycle_period``); deliver the rest of
        the run without device supersteps.

        Exactness: every remaining turn's alive count is one of the
        cycle-phase counts, the final board is the phase at
        ``(turns - turn) mod period``, and the TurnComplete/TurnsCompleted
        stream is emitted exactly as a dispatched run would — so oracles,
        goldens, and viewers can't tell the difference except by the
        wall-clock (and the CycleDetected announcement).  Keypresses keep
        full semantics in per-turn mode: a snapshot/detach at emitted
        turn t operates on the true phase board for t."""
        p = self.params
        period = self.backend.cycle_period
        remaining = p.turns - turn
        if remaining <= 0:
            return board, turn
        # Device work below goes through _dispatch: the standard
        # retry-then-park contract, like any other dispatch.
        counts = self._dispatch(
            lambda: self.backend.cycle_counts(board), board, turn
        )  # count after i+1 generations
        self._emit(CycleDetected(turn, period=period))
        if p.turn_events == "batch":
            self._emit(TurnsCompleted(p.turns, first_turn=turn + 1))
            state.set(p.turns, int(counts[(remaining - 1) % period]))
        else:
            t = turn
            while t < p.turns:
                if self._stop_now():
                    phase = (t - turn) % period
                    board_t = (
                        self._dispatch(
                            lambda: self.backend.run_turns(board, phase)[0],
                            board,
                            t,
                        )
                        if phase
                        else board
                    )
                    self._preempt_exit(board_t, t)
                    return board_t, t
                if self.key_presses is not None and (
                    self._paused or not self.key_presses.empty()
                ):
                    phase = (t - turn) % period
                    board_t = (
                        self._dispatch(
                            lambda: self.backend.run_turns(board, phase)[0],
                            board,
                            t,
                        )
                        if phase
                        else board
                    )
                    self._poll_keys(board_t, t)
                    if self._outcome != "completed":
                        return board_t, t
                    if self._stop_seen:
                        # Stop observed while paused mid-fast-forward:
                        # preempt at the settled phase board, not one
                        # chunk later.
                        self._preempt_exit(board_t, t)
                        return board_t, t
                end = min(t + self._FF_CHUNK, p.turns)
                self._emit_turns(t + 1, end)
                t = end
                state.set(t, int(counts[(t - turn - 1) % period]))
        off = (p.turns - turn) % period
        if off:
            board = self._dispatch(
                lambda: self.backend.run_turns(board, off)[0], board, turn
            )
        return board, p.turns

    def _tc_phase_board(self, board, turn: int, t: int, period: int):
        """The true board for emitted turn ``t`` during a time-compressed
        interval: the periodic board at ``turn`` advanced by the phase
        offset (a real dispatch through the standard retry contract), or
        ``board`` itself on a whole-period boundary."""
        phase = (t - turn) % period
        if not phase:
            return board
        return self._dispatch(
            lambda: self.backend.run_turns(board, phase)[0], board, t
        )

    def _timecomp_fast_forward(self, board, turn: int, state: _TickerState):
        """Rung 1 of the temporal-compression tier
        (``Params.time_compression``): the async cycle probe
        just proved ``board`` periodic under the production engine —
        advance the rest of the run in doubling ``period·2^k``
        zero-launch chunks, the alive-count stream replayed from a
        (rung-2 memoized) one-period capture, the whole interval
        bracketed by the roll-stencil exactness guard (the SDC probe).

        The guard contract ("never silent corruption"):

        - **entry**: before a single turn is emitted,
          ``Backend.sdc_probe`` re-derives one full period on a sampled
          stripe through the INDEPENDENT slow formulation and must
          reproduce the board.  A mismatch (or probe failure) returns
          None — the caller's dense loop keeps dispatching from ``turn``,
          which IS the "dense replay from the last verified turn"
          (nothing was emitted yet).
        - **exit**: the terminal phase advance (the next real dispatch)
          is re-validated the same way, its forced count cross-checked
          against the captured phase count; one retry from the verified
          periodic board, then :class:`CorruptionDetected` — the SDC
          sentinel's policy exactly.

        The entry probe's device-computed popcount + fingerprint double
        as the rung-2 cache identity (``TimeCompressor.cache_key``), so
        recurring ash is recognized without fetching the board bytes."""
        p = self.params
        tc = self._timecomp
        period = self.backend.cycle_period
        remaining = p.turns - turn
        if remaining <= 0:
            return board, turn
        # -- entry guard ------------------------------------------------------
        y0 = (turn * 2654435761) % p.image_height
        with spans.span("gol.timecomp.guard", turn=turn, k=period):
            try:
                ok, pop, fp = self._watchdog.call(
                    lambda: self.backend.sdc_probe(
                        board, board, period, y0, stripe=True
                    )
                )
            except DispatchTimeout as e:
                # Wedged device: the watchdog abort policy, announced on
                # the stream like every other timed-out wait.
                self._emit(DispatchError(turn, error=str(e), checkpointed=False))
                raise
            except Exception as e:  # noqa: BLE001 — transient probe error
                # The accelerator lever must not BE the failure: an
                # interval the guard cannot prove is simply not
                # compressed — the dense loop owns it.
                self.flight.record(
                    "timecomp_guard_failed", turn=turn, error=str(e)[:200]
                )
                tc.note_dense_replay(turn)
                return None
        tc.note_guard(turn, bool(ok))
        if not ok:
            tc.note_dense_replay(turn)
            return None
        # -- rung 2: the per-phase counts, memoized across runs ---------------
        counts = tc.resolve_counts(
            tc.cache_key(int(fp), int(pop)),
            int(pop),
            lambda: self._dispatch(
                lambda: self.backend.cycle_counts(board), board, turn
            ),
        )
        self._emit(CycleDetected(turn, period=period))
        off = remaining % period
        # Last turn deliverable with zero launches: the final ``off``
        # turns ride the exit dispatch below, so they count as COMPUTED
        # in the effective-vs-computed split, never as skipped.
        skip_until = p.turns - off
        if p.turn_events == "batch":
            self._emit(TurnsCompleted(p.turns, first_turn=turn + 1))
            state.set(p.turns, int(counts[(remaining - 1) % period]))
            t, log2 = turn, 0
            while t < skip_until:
                chunk = period << min(log2, timecomp_lib.MAX_SKIP_LOG2)
                end = min(t + chunk, skip_until)
                tc.note_skip(t + 1, end)
                t, log2 = end, log2 + 1
        else:
            t, log2 = turn, 0
            while t < p.turns:
                if self._stop_now():
                    board_t = self._tc_phase_board(board, turn, t, period)
                    self._preempt_exit(board_t, t)
                    return board_t, t
                if self.key_presses is not None and (
                    self._paused or not self.key_presses.empty()
                ):
                    board_t = self._tc_phase_board(board, turn, t, period)
                    self._poll_keys(board_t, t)
                    if self._outcome != "completed":
                        return board_t, t
                    if self._stop_seen:
                        self._preempt_exit(board_t, t)
                        return board_t, t
                # Per-turn mode also caps a chunk at _FF_CHUNK: the
                # emission flood per chunk bounds key/ticker latency,
                # exactly like the legacy fast-forward.
                chunk = min(
                    period << min(log2, timecomp_lib.MAX_SKIP_LOG2),
                    self._FF_CHUNK,
                )
                end = min(t + chunk, p.turns)
                skip_end = min(end, skip_until)
                if skip_end > t:
                    tc.note_skip(t + 1, skip_end)
                self._emit_turns(t + 1, end)
                t, log2 = end, log2 + 1
                state.set(t, int(counts[(t - turn - 1) % period]))
        if not off:
            # The final board IS the entry-verified periodic board: zero
            # launches, nothing new to validate.
            return board, p.turns
        # -- terminal phase advance + exit guard ------------------------------
        expect = int(counts[off - 1])
        y1 = (p.turns * 2654435761) % p.image_height
        stripe = self.backend.sdc_stripe_affordable(off)
        for retry in (False, True):
            board_f = self._dispatch(
                lambda: self.backend.run_turns(board, off)[0], board, p.turns
            )
            with spans.span("gol.timecomp.guard", turn=p.turns, k=off):
                try:
                    ok, pop, _ = self._watchdog.call(
                        lambda: self.backend.sdc_probe(
                            board, board_f, off, y1, stripe=stripe
                        )
                    )
                except DispatchTimeout as e:
                    self._emit(
                        DispatchError(p.turns, error=str(e), checkpointed=False)
                    )
                    raise
                except Exception as e:  # noqa: BLE001 — transient probe error
                    # Same degradation as the SDC sentinel: the phase
                    # advance went through the standard dispatch/retry
                    # contract, so a transient GUARD failure documents
                    # itself and accepts — exactly as verified as any
                    # dense dispatch.
                    self.flight.record(
                        "timecomp_guard_failed",
                        turn=p.turns,
                        error=str(e)[:200],
                    )
                    return board_f, p.turns
            good = bool(ok) and int(pop) == expect
            tc.note_guard(p.turns, good)
            if good:
                return board_f, p.turns
            # Mismatch: dense replay from the last verified state — the
            # entry-guarded periodic board — once; a second failure is
            # persistent corruption and must surface, never be emitted.
            tc.note_dense_replay(p.turns)
        err = CorruptionDetected(
            f"time-compression exit guard: phase advance to turn {p.turns} "
            f"fails its redundant recompute twice (stripe y0={y1} "
            f"ok={bool(ok)}, popcount {int(pop)} vs captured {expect})"
        )
        self._emit(DispatchError(p.turns, error=str(err), checkpointed=False))
        raise err

    def _initial_world(self) -> tuple[np.ndarray, int]:
        p = self.params
        # Resume negotiation (makeCall, gol/distributor.go:69-91): with
        # turns == 0 the reference skips the broker entirely; otherwise
        # resume iff a paused same-size checkpoint exists.
        if p.turns > 0:
            ckpt = self.session.check_states(
                p.image_width, p.image_height, p.rule.notation
            )
            if ckpt is not None:
                self._resumed = True
                if self._timecomp is not None:
                    # Cumulative truthfulness: adopt the parking run's
                    # computed-vs-effective split so this run's own
                    # sidecars keep counting from there.
                    self._timecomp.restore(
                        ckpt.computed_turns, ckpt.effective_turns
                    )
                return ckpt.world, ckpt.turn
        return self._load_input(), 0

    def _load_input(self) -> np.ndarray:
        """Read + validate the input PGM — or generate a random soup when
        ``Params.soup_density`` is set (multi-host controllers negotiate
        resume separately and call this directly; the seeded generator
        makes every process produce the identical board)."""
        p = self.params
        if p.soup_density is not None:
            from distributed_gol_torch.utils.soup import random_soup

            return random_soup(
                p.image_height, p.image_width, p.soup_density, p.soup_seed
            )
        board_np = pgm.read_pgm(p.input_path)
        if board_np.shape != (p.image_height, p.image_width):
            raise ValueError(
                f"{p.input_path} is {board_np.shape[1]}x{board_np.shape[0]}, "
                f"params want {p.image_width}x{p.image_height}"
            )  # gol/io.go:105-112 panics on mismatch
        return board_np

    def _finalize(self, board, turn: int):
        p = self.params
        if p.metrics:
            # The terminal observability rollup, emitted FIRST (before the
            # final fetch) so the multihost override's snapshot-gather
            # collective lines up at the same schedule point on every
            # process regardless of outcome.
            snaps = self._gather_snapshots(self._run_metrics())
            self._emit(
                MetricsReport(
                    turn,
                    snapshot=metrics_lib.aggregate_snapshots(snaps),
                    processes=len(snaps),
                    run_id=self.run_id,
                    tenant=self.params.tenant,
                    trace_id=self.trace.trace_id if self.trace else "",
                )
            )
        if self._outcome == "completed":
            if self._ckpt_saved:
                # The run the periodic checkpoints guarded finished:
                # nothing may resume from them (same consume-once policy
                # as check_states).  Detach/kill paths keep their own
                # semantics — 'q' parked a newer checkpoint, 'k' quit().
                self.session.discard_checkpoint()
            final_np = self.backend.fetch(board)
            # FinalTurnComplete carries the true turn count (quirk Q1 fixed)
            # and the alive-cell list tests consume (gol_test.go:33-41).
            self._emit(FinalTurnComplete(turn, AliveCells.from_board(final_np)))
            # Final PGM write, no ImageOutputComplete for it — matching the
            # reference (gol/distributor.go:246-253 emits no event).
            self._write_pgm(p.out_dir / f"{p.final_output_name}.pgm", final_np)
            self._emit(StateChange(turn, State.QUITTING))
        else:
            # Detach/kill paths still emit a FinalTurnComplete with an empty
            # alive list so viewers exit (quirk Q2 semantics, true turn).
            self._emit(FinalTurnComplete(turn, ()))
        self.events.put(None)  # stream end: the close(events) analog
