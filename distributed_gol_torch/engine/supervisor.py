"""The graceful-stop (preemption) latch and its signal plumbing.

Counterpart of the first half of ``distributed_gol_tpu/engine/supervisor.py``:
:class:`GracefulStop` (the flag the controller polls at turn boundaries)
and :func:`route_signals` (the plumbing shared with
``serve.ServePlane.install``).  The rollback-recovery supervisor itself
(``Supervisor``, ``supervise`` and the rebuild ladder) is not ported yet
(ROADMAP A7), so ``Params.restart_limit > 0`` is refused.
"""

from __future__ import annotations

import signal as signal_mod
from typing import Callable


def route_signals(handler: Callable, signals: tuple) -> Callable[[], None]:
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
    """The preemption latch: a ``requested`` flag the controller polls at
    turn boundaries (``Controller._stop_now``).

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
