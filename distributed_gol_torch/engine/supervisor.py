"""The self-healing runtime: rollback-recovery supervisor and the
graceful-stop (preemption) latch.

Counterpart of ``distributed_gol_tpu/engine/supervisor.py``, carried over
with its contracts:

- :class:`Supervisor` / :func:`supervise` wrap ``Controller.run`` so a
  terminal dispatch failure (``DispatchError`` exhaustion,
  ``DispatchTimeout``, ``CorruptionDetected``) with a resumable checkpoint
  available no longer aborts: the backend is rebuilt on an **escalation
  ladder** (restart 1: the same tier; restart 2: the forced-ppermute
  exchange tier, ``Backend(params, in_kernel=False)`` — a wedged in-kernel
  exchange must not be rebuilt verbatim forever; restart >= 3: the
  **topology-elastic rung** — probe every device, condemn the dead ones
  into the process-wide blacklist (``parallel.mesh``), and rebuild on the
  largest healthy mesh, resharding the restored full-board checkpoint
  onto it), the newest intact checkpoint is restored through the
  ``Session.check_states`` scan, and the run resumes.  Restarts are
  bounded by ``Params.restart_limit`` plus the
  ``Params.restart_window_seconds`` rate budget; exhaustion degrades to
  the unsupervised sentinel abort, with the full restart history in the
  flight record (the supervisor shares ONE flight ring across attempts).

- :class:`GracefulStop` is the preemption latch: ``install()`` hooks
  SIGTERM/SIGINT so a preemption notice sets a flag the controller polls
  at turn boundaries; the run forces an out-of-cadence emergency
  checkpoint and exits paused-and-resumable instead of dying mid-write.

The devices are ``torch.device``s: the CUDA devices, or on the CPU the
virtual CPU devices of ``parallel.mesh.cpu_devices``.  On one card the
elastic rung has nothing to shrink onto: a condemned card ends the run in
:class:`AllDevicesCondemned`.  An abandoned (watchdog-timed-out) dispatch
may still be running on the card's stream when the ladder rebuilds; the
next Backend reads only the restored checkpoint, a fresh host copy, and
the kernels' shared objects are built once a process
(``ops/cuda_build.py``).

The supervisor is OFF by default (``Params.restart_limit = 0``):
``gol.run`` is then byte-for-byte the unsupervised controller path.
"""

from __future__ import annotations

import queue
import signal as signal_mod
import time
from typing import Callable, Optional

from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.controller import Controller
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.engine.session import Session, default_session
from distributed_gol_torch.obs import flight as flight_lib
from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import spans
from distributed_gol_torch.obs import tracing
from distributed_gol_torch.parallel import mesh as mesh_lib


class AllDevicesCondemned(RuntimeError):
    """The elastic rung's device probe found no healthy device to rebuild
    on (or no mesh over the survivors divides the board).  Terminal by
    construction: the run degrades to the unsupervised sentinel abort with the
    full probe results and blacklist in the flight ring."""


def route_signals(
    handler: Callable, signals: tuple
) -> Callable[[], None]:
    """Route ``signals`` to ``handler``; returns a callable restoring the
    previous handlers (process-global state — callers must put them
    back).  The shared plumbing under :meth:`GracefulStop.install` and
    ``serve.ServePlane.install``."""
    prev = [(s, signal_mod.getsignal(s)) for s in signals]
    for s in signals:
        signal_mod.signal(s, handler)

    def restore():
        for s, h in prev:
            signal_mod.signal(s, h)

    return restore


class GracefulStop:
    """The preemption latch: a process-wide ``requested`` flag the
    controller polls at turn boundaries (``Controller._stop_now``).

    ``request()`` doubles as a signal handler, so ``install()`` is just
    ``signal.signal(SIGTERM, stop.request)`` with bookkeeping; it returns
    a restore callable (handlers are process-global state — tests and
    embedders must put them back).  Signals can only be installed from
    the main thread (the standard CPython rule); the flag itself may be
    set from anywhere."""

    def __init__(self):
        self.requested = False
        self.signum: int | None = None

    def request(self, signum=None, frame=None) -> None:
        """Latch the stop (usable directly or as a signal handler)."""
        self.requested = True
        if signum is not None:
            self.signum = signum

    def install(
        self, signals: tuple = (signal_mod.SIGTERM, signal_mod.SIGINT)
    ) -> Callable[[], None]:
        """Route ``signals`` to :meth:`request`; returns a callable that
        restores the previous handlers."""
        return route_signals(self.request, signals)


class Supervisor:
    """Rollback-recovery around :class:`Controller` (see module doc).

    One instance drives one logical run: attempt 0 plus up to
    ``Params.restart_limit`` restarts, all feeding the SAME event stream
    (intermediate aborts emit their terminal ``DispatchError`` but no
    stream sentinel — the stream ends exactly once, at the final
    completion or the final degraded abort) and ONE shared flight ring,
    so a postmortem of the degraded abort shows every restart that
    preceded it and a recovered run's terminal ``MetricsReport`` is the
    delta over ALL attempts (``supervisor.restarts`` et al. included).

    ``backend_factory(params, attempt)`` is the rebuild seam (attempt 0 =
    the first build): the default implements the escalation ladder —
    attempt 1 rebuilds the same tier (a transient deserves one fresh
    chance), attempt >= 2 forces the ppermute exchange fallback via
    ``Backend(params, in_kernel=False)``, attempt >= 3 is the elastic
    rung: devices are probed (``device_probe``, default
    ``parallel.mesh.probe_devices``), dead ones are condemned into the
    process-wide blacklist, and the rebuild lands on the largest healthy
    mesh — ``Backend(params', devices=healthy)`` on the default ladder;
    a ``backend_factory`` receives the SHRUNKEN ``params'`` (its
    ``mesh_shape`` reduced) and its own ``Backend(params')`` excludes the
    blacklisted cards through the Backend's default CUDA placement (on
    the CPU, whose default mesh puts every shard on the CPU, a factory
    that needs named shards places them on
    ``parallel.mesh.healthy_devices(parallel.mesh.cpu_devices())``).
    Chaos tests inject fault harnesses here (and a plan-consistent
    ``device_probe`` — ``FaultInjectionBackend.device_probe``)."""

    # Restart attempt at which the rebuild escalates to forced-ppermute.
    _ESCALATE_AT = 2
    # Restart attempt at which the rebuild turns topology-elastic: probe
    # devices, blacklist the dead, shrink the mesh to the healthy set.
    _ELASTIC_AT = 3

    def __init__(
        self,
        params: Params,
        events: queue.Queue,
        key_presses: Optional[queue.Queue] = None,
        session: Optional[Session] = None,
        backend: Optional[Backend] = None,
        backend_factory: Optional[Callable[[Params, int], Backend]] = None,
        stop: Optional[GracefulStop] = None,
        device_probe: Optional[Callable] = None,
        frame_plane=None,
    ):
        self.params = params
        self.events = events
        self.key_presses = key_presses
        self.session = session if session is not None else default_session()
        self._first_backend = backend
        self._backend_factory = backend_factory
        self.stop = stop
        # The spectator fan-out hub is not ported yet (ROADMAP A9).
        if frame_plane is not None:
            raise NotImplementedError(
                "frame_plane: the spectator frame fan-out is not ported yet (ROADMAP A9)"
            )
        # The health-classification seam of the elastic rung:
        # ``device_probe(devices) -> (healthy, condemned)``.  Default is
        # the real put/fetch probe, watchdog-bounded by the dispatch
        # deadline when one is set (a wedged card must fail its probe in
        # bounded time, not hang the recovery).
        if device_probe is None:
            deadline = (
                params.dispatch_deadline_seconds
                or mesh_lib.PROBE_DEADLINE_SECONDS
            )
            device_probe = lambda devs: mesh_lib.probe_devices(  # noqa: E731
                devs, deadline
            )
        self._device_probe = device_probe
        # (shrunken params, healthy device list) once the elastic rung
        # has planned a rebuild — consumed by _build_backend.
        self._elastic: Optional[tuple[Params, list]] = None
        self.flight = flight_lib.FlightRecorder(params.flight_recorder_depth)
        self.metrics = metrics_lib.registry_for(params.metrics)
        # ONE correlation id for the whole supervised run:
        # every restart attempt's controller stamps the same id, so the
        # recovered run's MetricsReport, any flight dump, and every
        # checkpoint sidecar across attempts join as one logical run.
        self.run_id = metrics_lib.new_run_id(params.tenant)
        self._m_restarts = self.metrics.counter("supervisor.restarts")
        self._m_rollback = self.metrics.counter("supervisor.rollback_turns")
        #: One dict per restart: attempt, cause, from_turn, resume_turn,
        #: tier, mesh_shape, excluded_devices, t (unix seconds) — the
        #: run's restart history.
        self.history: list[dict] = []
        self._restart_times: list[float] = []  # monotonic, for the rate budget

    # -- the rebuild ladder ----------------------------------------------------
    def _placement(self) -> list | None:
        """The devices the caller placed the first attempt on — a virtual
        mesh names one card several times, which no default placement
        does — or None (the Backend's default placement)."""
        first = self._first_backend
        devices = getattr(first, "devices", None) if first is not None else None
        return list(devices) if devices else None

    def _build_backend(self, attempt: int) -> Backend:
        if attempt == 0 and self._first_backend is not None:
            return self._first_backend
        if attempt >= self._ELASTIC_AT and self._elastic is not None:
            # The elastic rung (planned by _plan_elastic, which ran the
            # probe and condemned dead devices before this rebuild).
            eparams, healthy = self._elastic
            if self._backend_factory is not None:
                # The factory builds its own Backend from the shrunken
                # params (see the class docstring for its placement).
                return self._backend_factory(eparams, attempt)
            if eparams.mesh_shape == self.params.mesh_shape:
                # Nothing condemned (the failure was not device-tied):
                # stay on the forced-ppermute rung's tier rather than
                # rebuilding the possibly-wedged exchange verbatim, on
                # the caller's placement while all of it is healthy.
                placement = self._placement()
                ok = {mesh_lib.device_key(d) for d in healthy}
                if placement and all(mesh_lib.device_key(d) in ok for d in placement):
                    healthy = placement
                return Backend(eparams, devices=healthy, in_kernel=False)
            return Backend(eparams, devices=healthy)
        if self._backend_factory is not None:
            return self._backend_factory(self.params, attempt)
        if attempt >= self._ESCALATE_AT:
            # Same-tier rebuild already failed once: escalate to the
            # ppermute exchange fallback (bit-identical, slower tier) —
            # recorded in Backend.sharded_tier_policy as
            # "forced-ppermute (in_kernel=False)".  Single-device configs
            # accept the flag as a no-op.
            return Backend(self.params, devices=self._placement(), in_kernel=False)
        return Backend(self.params, devices=self._placement())

    def _ladder_tier(self, attempt: int) -> str:
        if attempt >= self._ELASTIC_AT:
            return "elastic"
        if self._backend_factory is not None:
            return "factory"
        return "forced-ppermute" if attempt >= self._ESCALATE_AT else "same"

    # -- the elastic rung ------------------------------------------------------
    def _plan_elastic(self, attempt: int) -> tuple[tuple[int, int], list[int]]:
        """Probe the (non-blacklisted) devices, condemn the dead ones,
        and pick the rebuild topology: the original mesh when enough
        devices stay healthy, else the largest healthy factorisation
        that divides the board (word-aligned shapes preferred so the
        shrink keeps the packed engine family —
        ``mesh_lib.largest_mesh_shape``).  Returns
        ``(mesh_shape, excluded_ids)`` for the restart-history row and
        stashes the rebuild config for ``_build_backend``; raises
        :class:`AllDevicesCondemned` when nothing survives.

        Every probe outcome is a flight record (``device_blacklist``),
        success or not — a postmortem of a mid-ladder exhaustion must
        show the full probe results, not just the abort."""
        from dataclasses import replace

        p = self.params
        candidates = mesh_lib.healthy_devices(
            mesh_lib.device_pool(p.device)
        )
        with spans.span("gol.supervisor.probe", attempt=attempt):
            healthy, condemned = self._device_probe(candidates)
        newly = mesh_lib.condemn(condemned) if condemned else []
        excluded = sorted(mesh_lib.blacklisted(self.params.device))
        self.flight.record(
            "device_blacklist",
            attempt=attempt,
            probed=len(candidates),
            condemned=sorted(mesh_lib.device_id(d) for d in condemned),
            blacklist=excluded,
        )
        del newly  # counted by mesh_lib.condemn (mesh.devices_lost)
        if not healthy:
            raise AllDevicesCondemned(
                f"device probe condemned all {len(candidates)} remaining "
                f"devices (blacklist: {excluded})"
            )
        old = p.mesh_shape
        if len(healthy) >= old[0] * old[1]:
            new = old  # enough survivors: keep the run's own topology
        else:
            new = mesh_lib.largest_mesh_shape(
                len(healthy), p.image_height, p.image_width
            )
        if new != old:
            self.flight.record(
                "mesh_shrink",
                attempt=attempt,
                from_shape=list(old),
                to_shape=list(new),
                healthy=len(healthy),
            )
        self._elastic = (replace(p, mesh_shape=new), healthy)
        return new, excluded

    # -- the restart budget ----------------------------------------------------
    def _budget_allows(self, now: float) -> bool:
        """Whether one more restart fits the budget.  Two explicit modes:

        - ``restart_window_seconds == 0`` (default): ``restart_limit``
          bounds the ALL-TIME restart count of this run
          (``len(self.history)``).
        - ``restart_window_seconds > 0``: the limit bounds restarts
          whose detection time falls inside the trailing window — older
          restarts age out, so a steady trickle keeps being survived.

        The elastic rungs interact with both modes identically: one
        restart consumes exactly ONE budget unit however expensive its
        rebuild was (probe + blacklist + reshard all ride the same
        restart), and a budget denial mid-ladder degrades to the
        sentinel abort — with the full probe results already in the
        flight ring from the elastic attempts that did run."""
        p = self.params
        if p.restart_window_seconds > 0:
            recent = [
                t
                for t in self._restart_times
                if now - t < p.restart_window_seconds
            ]
            return len(recent) < p.restart_limit
        return len(self.history) < p.restart_limit

    # -- the rollback target ---------------------------------------------------
    def _restore_point(self):
        """The newest intact resumable checkpoint, via the existing
        ``Session.check_states`` scan (torn pairs skipped, CRC-checked,
        consume-once on disk) — then re-armed in memory so the restarted
        controller's own resume negotiation adopts it.  None = nothing to
        roll back to (degrade to the abort)."""
        p = self.params
        ckpt = self.session.check_states(
            p.image_width, p.image_height, p.rule.notation
        )
        if ckpt is None:
            return None
        # check_states consumed the slot (paused -> False, on disk too);
        # RE-PARK the world for the restarted controller.  Parking with
        # the world (not just the flag) makes the restore itself durable
        # on disk-backed sessions: a process kill between this restart
        # and the next periodic checkpoint still leaves a resumable pair,
        # and the consume-once contract holds (the re-park is a fresh
        # parked state, adopted exactly once by the next check_states).
        try:
            self.session.pause(
                True, world=ckpt.world, turn=ckpt.turn, rule=ckpt.rule
            )
        except Exception as e:  # noqa: BLE001 — ENOSPC, perms, ...
            # The persist failed but the in-memory slot was armed before
            # the write (Session.pause sets state first): recovery can
            # proceed — only the crash-between-restarts durability is
            # degraded until the next periodic checkpoint, same policy as
            # a failed periodic save.  Killing a viable recovery over a
            # full disk would be worse.
            self.flight.record(
                "restore_persist_failed", turn=ckpt.turn, error=str(e)[:200]
            )
            import warnings

            warnings.warn(
                f"supervisor restore could not re-persist the checkpoint "
                f"({e}); recovery continues from memory",
                RuntimeWarning,
                stacklevel=3,
            )
        return ckpt

    # -- the final-abort path --------------------------------------------------
    def _abort(self, controller: Controller, error: BaseException) -> None:
        """Degrade to the unsupervised sentinel abort: dump the shared flight ring
        (restart history included — its tail is the abort record) and end
        the stream exactly once."""
        fields = dict(restarts=len(self.history), cause=type(error).__name__)
        blacklist = sorted(mesh_lib.blacklisted(self.params.device))
        if blacklist:
            # A degraded abort after elastic attempts documents the
            # condemned topology right in its tail record (the probe
            # results themselves are earlier ``device_blacklist`` rows).
            fields["device_blacklist"] = blacklist
        self.flight.record("supervisor_exhausted", **fields)
        controller._dump_flight(error)
        self.events.put(None)

    # -- the run ---------------------------------------------------------------
    def run(self) -> None:
        """Drive the supervised run to its single terminal outcome:
        normal completion (stream ends via ``_finalize``), or a degraded
        abort re-raising the last error after the flight dump + sentinel."""
        attempt = 0
        start_snapshot = None
        prev_controller = None
        while True:
            try:
                controller = Controller(
                    self.params,
                    self.events,
                    self.key_presses,
                    self.session,
                    self._build_backend(attempt),
                    flight=self.flight,
                    stop=self.stop,
                    run_id=self.run_id,
                )
            except BaseException as e:
                # A failed REBUILD (attempt >= 1) must still honour the
                # stream contract: consumers already hold a live stream,
                # so degrade to the abort (flight dump + sentinel) rather
                # than escaping with the queue left open forever.  A
                # failed FIRST build matches unsupervised behaviour (the
                # stream never started) and just propagates.
                if prev_controller is not None:
                    self.flight.record(
                        "rebuild_failed",
                        attempt=attempt,
                        cause=type(e).__name__,
                        error=str(e)[:200],
                    )
                    self._abort(prev_controller, e)
                raise
            prev_controller = controller
            controller._supervised = True
            if start_snapshot is None:
                start_snapshot = controller._metrics_start
            else:
                # The terminal MetricsReport must be the delta over the
                # WHOLE supervised run — a recovered run documents its
                # restarts, not just its last attempt.
                controller._metrics_start = start_snapshot
            try:
                controller.run()
                return
            except BaseException as e:
                if not isinstance(e, Exception):
                    # KeyboardInterrupt / SystemExit: never restarted.
                    self._abort(controller, e)
                    raise
                now = time.monotonic()
                # Detection timestamp, captured BEFORE the restore: the
                # restart flight record anchors recovery_times(), and MTTR
                # is defined as detection -> first resolved dispatch —
                # the checkpoint scan + durable re-park below are part of
                # the recovery being measured, not overhead before it.
                t_detect = round(time.time(), 6)
                if not self._budget_allows(now):
                    self._abort(controller, e)
                    raise
                with spans.span("gol.supervisor.restore", attempt=attempt + 1):
                    ckpt = self._restore_point()
                if ckpt is None:
                    # Nothing to roll back to (no checkpoint survived, or
                    # the failure predates the first one): degrade.
                    self._abort(controller, e)
                    raise
                attempt += 1
                mesh_shape = self.params.mesh_shape
                excluded: list[int] = sorted(mesh_lib.blacklisted(self.params.device))
                if attempt >= self._ELASTIC_AT:
                    # The topology-elastic rung: classify devices and plan
                    # the shrunken rebuild BEFORE the restart is recorded,
                    # so the history row carries the topology it resumed
                    # on.  An unsalvageable topology (every device
                    # condemned) degrades to the sentinel abort with the
                    # probe results already in the ring.
                    try:
                        mesh_shape, excluded = self._plan_elastic(attempt)
                    except Exception as probe_err:
                        # AllDevicesCondemned, or the injectable
                        # device_probe seam itself failing: either way
                        # the stream contract holds — every failure path
                        # out of this handler aborts with the flight
                        # dump and the sentinel, never an escaped
                        # exception that leaves consumers blocked on a
                        # stream that can no longer end.
                        self.flight.record(
                            "elastic_exhausted",
                            attempt=attempt,
                            cause=type(probe_err).__name__,
                            error=str(probe_err)[:200],
                        )
                        self._abort(controller, e)
                        raise e from probe_err
                crash_turn = controller._dispatch_rec.last_turn
                record = dict(
                    attempt=attempt,
                    cause=type(e).__name__,
                    error=str(e)[:200],
                    from_turn=crash_turn,
                    resume_turn=ckpt.turn,
                    tier=self._ladder_tier(attempt),
                    mesh_shape=list(mesh_shape),
                    excluded_devices=excluded,
                )
                self.history.append({**record, "t": t_detect})
                self._restart_times.append(now)
                # Request trace: a restart makes this an error
                # trace — tail-retained with the restart in the
                # always-kept event ring, and the restart flight record
                # carries the short id for the postmortem join.  The
                # trace rides the worker context the plane activated, so
                # no plumbing.
                req_trace = tracing.current()
                if req_trace is not None:
                    record["trace"] = req_trace.short_id
                    req_trace.add_event(
                        "gol.supervisor.restart",
                        attempt=attempt,
                        cause=record["cause"],
                        resume_turn=ckpt.turn,
                    )
                    req_trace.flag("restart")
                # t= overrides the ring's own stamp with the DETECTION
                # time (see above).
                self.flight.record("restart", t=t_detect, **record)
                self._m_restarts.inc()
                self._m_rollback.inc(max(0, crash_turn - ckpt.turn))
                # Loop: the rebuild at the top IS the teardown — replacing
                # the controller/backend references releases their device
                # buffers (the kernels' shared objects stay loaded for the
                # process); the dead attempt is kept only until the new
                # build succeeds, as the abort path's flight/metrics home.

    # -- report helpers --------------------------------------------------------
    def recovery_times(self) -> list[float]:
        """Per-restart time-to-recover, from the shared flight ring: the
        gap between each ``restart`` record and the restarted attempt's
        first resolved ``dispatch`` record — i.e. detection-to-computing,
        including backend rebuild, checkpoint restore, and the first
        (warm-up) dispatch; their median is the run's MTTR.  Bounded-ring
        caveat: only restarts still in the ring are visible (size runs
        well under ``Params.flight_recorder_depth``)."""
        out: list[float] = []
        records = self.flight.records()
        for i, r in enumerate(records):
            if r.get("kind") != "restart":
                continue
            for later in records[i + 1 :]:
                if later.get("kind") == "dispatch":
                    out.append(max(0.0, later["t"] - r["t"]))
                    break
        return out


def supervise(
    params: Params,
    events: queue.Queue,
    key_presses: Optional[queue.Queue] = None,
    session: Optional[Session] = None,
    backend: Optional[Backend] = None,
    backend_factory: Optional[Callable[[Params, int], Backend]] = None,
    stop: Optional[GracefulStop] = None,
    device_probe: Optional[Callable] = None,
    frame_plane=None,
) -> Supervisor:
    """Run one supervised simulation (see :class:`Supervisor`); returns
    the supervisor so callers can read ``history`` /
    ``recovery_times()``.  ``gol.run`` routes here whenever
    ``params.restart_limit > 0``.  ``device_probe(devices) ->
    (healthy, condemned)`` overrides the elastic rung's health
    classifier (chaos tests pass the fault harness's plan-consistent
    probe)."""
    sup = Supervisor(
        params,
        events,
        key_presses,
        session,
        backend,
        backend_factory,
        stop,
        device_probe=device_probe,
        frame_plane=frame_plane,
    )
    sup.run()
    return sup


__all__ = ["AllDevicesCondemned", "GracefulStop", "Supervisor", "supervise"]
