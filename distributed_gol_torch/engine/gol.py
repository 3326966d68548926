"""The engine façade — equivalent of ``gol.Run`` (``gol/gol.go:14``).

Contract, as in ``distributed_gol_tpu/engine/gol.py``:

- ``events``: receives the typed event stream; a ``None`` sentinel marks
  the end (the ``close(events)`` analog).
- ``key_presses``: optional queue of single-character strings
  ('s'/'p'/'q'/'k', ``sdl/loop.go:15-28`` semantics).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.controller import Controller
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.engine.session import Session


def run(
    params: Params,
    events: queue.Queue,
    key_presses: Optional[queue.Queue] = None,
    session: Optional[Session] = None,
    backend: Optional[Backend] = None,
    stop=None,
    backend_factory=None,
    frame_plane=None,
    telemetry_port: Optional[int] = None,
) -> None:
    """Drive one whole simulation, blocking until the event stream ends.

    ``stop`` (a ``supervisor.GracefulStop``, or any object with a
    ``requested`` flag, optional) arms preemption handling: when the flag
    is raised — typically by a SIGTERM handler — the run forces an
    emergency checkpoint at the next turn boundary and exits
    paused-and-resumable.  With ``params.restart_limit > 0`` the whole run
    is supervised (``engine/supervisor.py``): terminal dispatch failures
    roll back to the newest checkpoint and resume instead of aborting.
    ``backend`` replaces the default ``Backend(params)`` for the first
    attempt.

    ``backend_factory(params, attempt)`` is the build seam the serving
    plane and chaos harnesses use: supervised runs hand it to the
    supervisor's rebuild ladder; unsupervised runs call it once with
    ``attempt=0``.  An explicit ``backend`` wins for attempt 0.

    ``params.metrics`` with ``params.telemetry_sample_seconds > 0`` arms a
    ``obs.timeseries.TelemetrySampler`` at that cadence for the run's
    lifetime, outside the supervisor's ladder, so it keeps sampling
    through backend rebuilds, and stops it when the run ends.

    ``frame_plane`` (the spectator fan-out hub) and ``telemetry_port`` (the
    run's telemetry endpoints) are not ported yet (ROADMAP A9) and raise
    when given."""
    if frame_plane is not None:
        raise NotImplementedError(
            "frame_plane: the spectator frame fan-out is not ported yet (ROADMAP A9)"
        )
    if telemetry_port is not None:
        raise NotImplementedError(
            "telemetry_port: the telemetry endpoints are not ported yet (ROADMAP A9)"
        )
    sampler = None
    if params.metrics and params.telemetry_sample_seconds > 0:
        from distributed_gol_torch.obs.timeseries import TelemetrySampler

        sampler = TelemetrySampler(interval=params.telemetry_sample_seconds).start()
    try:
        if params.restart_limit > 0:
            from distributed_gol_torch.engine.supervisor import supervise

            supervise(
                params,
                events,
                key_presses,
                session,
                backend,
                backend_factory=backend_factory,
                stop=stop,
            )
        else:
            if backend is None and backend_factory is not None:
                backend = backend_factory(params, 0)
            Controller(params, events, key_presses, session, backend, stop=stop).run()
    finally:
        if sampler is not None:
            sampler.stop()


def start(
    params: Params,
    events: queue.Queue,
    key_presses: Optional[queue.Queue] = None,
    session: Optional[Session] = None,
    backend: Optional[Backend] = None,
    stop=None,
    backend_factory=None,
    frame_plane=None,
    telemetry_port: Optional[int] = None,
) -> threading.Thread:
    """``go gol.Run(...)``: run in a daemon thread, return it."""
    t = threading.Thread(
        target=run,
        args=(params, events, key_presses, session, backend, stop, backend_factory,
              frame_plane, telemetry_port),
        name="gol-run",
        daemon=True,
    )
    t.start()
    return t
