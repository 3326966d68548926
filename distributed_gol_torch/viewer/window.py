"""Pixel-window viewer — the SDL window frontend (``sdl/window.go``,
``sdl/loop.go``), as an optional pygame surface.  A copy of
``distributed_gol_tpu/viewer/window.py`` over the port's events.

The reference renders an ARGB texture sized W×H: ``FlipPixel`` XORs one
pixel with bounds panics (``sdl/window.go:78-88``), ``RenderFrame``
uploads the texture and presents (``:56-64``), and the loop maps
keydown p/s/q/k to the keypress channel and drains the event stream
(``sdl/loop.go:9-52``).  This module reproduces that contract on top of
the SAME typed event stream the terminal viewer consumes — flips XOR a
shadow pixel buffer, ``FrameReady`` replaces it wholesale (device-pooled
frames are the large-board feed; the window scales them up), and
``TurnComplete`` presents a frame.

pygame is an optional dependency: importing this module is safe
everywhere (the import happens inside :class:`Window`), headless rigs run
it under SDL's dummy videodriver (as the tests do), and the CLI only
touches it behind ``--window``.
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
from distributed_gol_torch.viewer.loop import _print_event

# Present at most this many pixels; boards larger than the screen are
# window-scaled (the engine already pools frames above frame_max).
_MAX_WINDOW = (1024, 1024)


class Window:
    """The ``sdl.Window`` equivalent: a pixel buffer + a pygame surface.

    ``flip_pixel``/``render_frame``/``poll_keys``/``count_pixels``/
    ``clear_pixels``/``destroy`` mirror the reference's method surface
    (``sdl/window.go:22-104``); the buffer is a numpy uint8 (H, W) array
    presented via ``pygame.surfarray`` with nearest scaling."""

    def __init__(self, width: int, height: int, title: str = "distributed-gol-torch"):
        import pygame  # optional dependency: import only when a window opens

        self._pygame = pygame
        pygame.display.init()
        ww = min(width, _MAX_WINDOW[1])
        wh = min(height, _MAX_WINDOW[0])
        self._screen = pygame.display.set_mode((ww, wh))
        pygame.display.set_caption(title)
        self._pixels = np.zeros((height, width), dtype=np.uint8)

    def flip_pixel(self, x: int, y: int) -> None:
        """XOR one pixel (``sdl/window.go:78-88``, including its
        out-of-bounds panic — here an IndexError)."""
        h, w = self._pixels.shape
        if not (0 <= x < w and 0 <= y < h):
            raise IndexError(f"pixel ({x}, {y}) outside {w}x{h} window")
        self._pixels[y, x] ^= 0xFF

    def set_frame(self, frame: np.ndarray) -> None:
        """Replace the buffer wholesale — the FrameReady keyframe feed
        (device-pooled frames; no reference equivalent, it fetched every
        pixel).  Always a COPY: the engine keeps the delivered frame as
        its delta base, so in-place band application here must never
        reach back into the producer's array."""
        self._pixels = np.array(frame, dtype=np.uint8, copy=True)

    def apply_delta(self, bands) -> None:
        """Apply a FrameDelta's changed bands IN PLACE: rows outside every
        band are not touched — the viewer-side half of the O(activity)
        in-place contract."""
        from distributed_gol_torch.engine.frames import apply_bands

        apply_bands(self._pixels, bands)

    def render_frame(self) -> None:
        """Present the buffer (``sdl/window.go:56-64``): grayscale →
        RGB surface, nearest-scaled to the window."""
        pygame = self._pygame
        rgb = np.repeat(self._pixels.T[:, :, None], 3, axis=2)
        surf = pygame.surfarray.make_surface(rgb)
        pygame.transform.scale(surf, self._screen.get_size(), self._screen)
        pygame.display.flip()

    def poll_keys(self) -> list[str]:
        """Drain the OS event queue; returns the pressed s/p/q/k keys
        (``sdl/loop.go:15-28``); window close maps to 'q' (detach)."""
        pygame = self._pygame
        keys = []
        keymap = {
            pygame.K_s: "s",
            pygame.K_p: "p",
            pygame.K_q: "q",
            pygame.K_k: "k",
            # Viewport pan/zoom: letters and arrows pan, +/-
            # zoom — the same chars the terminal keyboard forwards.
            pygame.K_a: "a",
            pygame.K_d: "d",
            pygame.K_w: "w",
            pygame.K_x: "x",
            pygame.K_LEFT: "a",
            pygame.K_RIGHT: "d",
            pygame.K_UP: "w",
            pygame.K_DOWN: "x",
            pygame.K_PLUS: "+",
            pygame.K_EQUALS: "+",
            pygame.K_MINUS: "-",
        }
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT:
                keys.append("q")
            elif ev.type == pygame.KEYDOWN and ev.key in keymap:
                keys.append(keymap[ev.key])
        return keys

    def count_pixels(self) -> int:
        """Lit-pixel count (``sdl/window.go:90-97``) — the tests' hook for
        the shadow-board consistency check."""
        return int(np.count_nonzero(self._pixels))

    def clear_pixels(self) -> None:
        self._pixels[:] = 0  # sdl/window.go:99-104

    def destroy(self) -> None:
        self._pygame.display.quit()


def run_window(
    params: Params,
    events: queue.Queue,
    key_presses: queue.Queue | None = None,
    max_fps: float = 30.0,
    window: Window | None = None,
) -> FinalTurnComplete | None:
    """The ``sdl.Run`` loop (``sdl/loop.go:9-52``) over a :class:`Window`:
    drain the stream until FinalTurnComplete or the ``None`` sentinel,
    XOR flips / adopt frames, present on TurnComplete (rate-limited),
    forward keypresses, print printable events.  Returns the final event
    (None if the engine died — callers report failure, ``__main__._drive``)."""
    if window is None:
        if params.wants_frames():
            fy, fx = params.frame_factors()
            if params.viewport is not None:
                # Viewport viewer: the window shows the viewport's
                # pooled frame; zoom changes arrive as new-shape
                # keyframes, which set_frame adopts wholesale.
                _, _, vh, vw = params.viewport
                window = Window(-(-vw // fx), -(-vh // fy))
            else:
                window = Window(
                    -(-params.image_width // fx),
                    -(-params.image_height // fy),
                )
        else:
            window = Window(params.image_width, params.image_height)
    final = None
    min_dt = 1.0 / max_fps
    last_draw = 0.0
    try:
        while True:
            for key in window.poll_keys():
                if key_presses is not None:
                    key_presses.put(key)
            try:
                e = events.get(timeout=0.05)
            except queue.Empty:
                continue  # keep polling the OS queue while the engine works
            if e is None:
                break
            if isinstance(e, CellFlipped):
                window.flip_pixel(e.cell.x, e.cell.y)
            elif isinstance(e, CellsFlipped):
                for c in e.cells:
                    window.flip_pixel(c.x, c.y)
            elif isinstance(e, FrameReady):
                window.set_frame(np.asarray(e.frame))
            elif isinstance(e, FrameDelta):
                window.apply_delta(e.bands)
            elif isinstance(e, (TurnComplete, TurnsCompleted)):
                now = time.monotonic()
                if now - last_draw >= min_dt:
                    last_draw = now
                    window.render_frame()
            elif isinstance(e, FinalTurnComplete):
                final = e
                window.render_frame()
                _print_event(e)
            else:
                _print_event(e)
    finally:
        window.destroy()
    return final


def available() -> bool:
    """Whether the pygame frontend can be used on this rig."""
    try:
        import pygame  # noqa: F401

        return True
    except ImportError:
        return False


if __name__ == "__main__":  # manual smoke: python -m ...viewer.window
    print("pygame available:", available(), file=sys.stderr)
