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
    paused-and-resumable.  ``backend`` replaces the default
    ``Backend(params)``.

    ``backend_factory(params, attempt)`` is the build seam the serving
    plane uses: the run calls it once with ``attempt=0`` (the supervisor,
    which would call it again on each rebuild, is ROADMAP A7).  An
    explicit ``backend`` wins.

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
    if backend is None and backend_factory is not None:
        backend = backend_factory(params, 0)
    Controller(params, events, key_presses, session, backend, stop=stop).run()


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
