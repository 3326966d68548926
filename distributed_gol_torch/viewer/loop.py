"""Viewer event loops — the ``sdl.Run`` equivalents (``sdl/loop.go:9-54``).

A copy of ``distributed_gol_tpu/viewer/loop.py`` over the port's events.

Both loops consume the typed event stream until FinalTurnComplete or the
``None`` sentinel and print any event with a non-empty ``str()`` as
``Completed Turns <n>       <event>`` — the same console telemetry the
reference prints for count/state/image events (``sdl/loop.go:44-47``).

``run_terminal`` additionally keeps a shadow board from CellFlipped /
CellsFlipped events (the FlipPixel XOR, ``sdl/window.go:78-88``) and redraws
it on TurnComplete, honouring the flips-before-TurnComplete ordering
contract (``gol/event.go:55-58``).
"""

from __future__ import annotations

import queue
import sys
import time

import numpy as np

from distributed_gol_torch.engine.events import (
    CellFlipped,
    CellsFlipped,
    FinalTurnComplete,
    FrameDelta,
    FrameReady,
    TurnComplete,
    TurnsCompleted,
)
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.viewer import render as R


def _print_event(event) -> None:
    s = str(event)
    if s:
        print(f"Completed Turns {event.completed_turns:<8}{s}", flush=True)


def run_headless(params: Params, events: queue.Queue) -> FinalTurnComplete | None:
    """Drain the stream, printing telemetry; returns the final event.
    Equivalent of the reference's -noVis drain loop (``main.go:56-67``).
    On an :class:`EventQueue` the drain is batched (``get_many``): turn
    runs stay compressed as ``TurnsCompleted`` — both turn forms print
    nothing, so the visible output is unchanged while the drain stops
    costing one Python object per generation."""
    final = None
    get_many = getattr(events, "get_many", None)
    while True:
        batch = get_many() if get_many is not None else [events.get()]
        for e in batch:
            if e is None:
                return final
            if isinstance(e, FinalTurnComplete):
                final = e
            _print_event(e)


def run_terminal(
    params: Params,
    events: queue.Queue,
    max_fps: float = 20.0,
    out=sys.stdout,
) -> FinalTurnComplete | None:
    """Live ANSI rendering fed purely by the event stream."""
    if params.wants_frames():
        # Frame mode replaces the shadow wholesale with each FrameReady
        # (the first arrives before any TurnComplete); never allocate a
        # board-sized buffer for a mode that exists to avoid exactly that.
        shadow = np.zeros(params.frame_max, dtype=np.uint8)
    else:
        shadow = np.zeros(
            (params.image_height, params.image_width), dtype=np.uint8
        )
    final = None
    min_dt = 1.0 / max_fps
    last_draw = 0.0
    out.write(R.clear_screen())
    while True:
        e = events.get()
        if e is None:
            break
        if isinstance(e, CellFlipped):
            shadow[e.cell.y, e.cell.x] ^= 255
        elif isinstance(e, CellsFlipped):
            for c in e.cells:
                shadow[c.y, c.x] ^= 255
        elif isinstance(e, FrameReady):
            # Large boards: the engine ships a device-pooled frame instead
            # of per-cell flips; render it directly (it IS the view).
            # COPY: FrameDelta bands apply in place below, and the
            # producer keeps the delivered keyframe as its delta base.
            shadow = np.array(e.frame, dtype=np.uint8, copy=True)
        elif isinstance(e, FrameDelta):
            # Viewport delta stream: touch only the changed bands.
            from distributed_gol_torch.engine.frames import apply_bands

            apply_bands(shadow, e.bands)
        elif isinstance(e, (TurnComplete, TurnsCompleted)):
            # TurnsCompleted: batch telemetry (one event per dispatch);
            # reachable here only with flip_events="off", where there is
            # nothing to redraw but the turn counter should still tick.
            now = time.monotonic()
            if now - last_draw >= min_dt:
                last_draw = now
                out.write(R.home_cursor() + R.render(shadow))
                out.write(f"\nturn {e.completed_turns}   [s]nap [p]ause [q]uit [k]ill\n")
                out.flush()
        elif isinstance(e, FinalTurnComplete):
            final = e
            _print_event(e)
        else:
            _print_event(e)
    return final
