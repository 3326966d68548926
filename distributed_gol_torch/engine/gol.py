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
) -> None:
    """Drive one whole simulation, blocking until the event stream ends.

    ``stop`` (any object with a ``requested`` flag, optional) arms
    preemption handling: when the flag is raised — typically by a SIGTERM
    handler — the run forces an emergency checkpoint at the next turn
    boundary and exits paused-and-resumable.  ``backend`` replaces the
    default ``Backend(params)``."""
    Controller(params, events, key_presses, session, backend, stop=stop).run()


def start(
    params: Params,
    events: queue.Queue,
    key_presses: Optional[queue.Queue] = None,
    session: Optional[Session] = None,
    backend: Optional[Backend] = None,
    stop=None,
) -> threading.Thread:
    """``go gol.Run(...)``: run in a daemon thread, return it."""
    t = threading.Thread(
        target=run,
        args=(params, events, key_presses, session, backend, stop),
        name="gol-run",
        daemon=True,
    )
    t.start()
    return t
