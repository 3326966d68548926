"""Viewer frontends: the SDL-window replacement.

The reference's GUI layer is an SDL window fed by the event stream plus a
keyboard poller (``sdl/loop.go``, ``sdl/window.go``).  The contract to
preserve is the *event stream*, not the SDL binding — so this package
ships a pure-terminal renderer (ANSI half-blocks, downsampling for big
boards), a headless drain, and an optional pygame window
(``viewer.window``, imported only when used), all consuming the same typed
events; a keyboard thread feeds s/p/q/k to the engine exactly like the SDL
poller.  The port's copy of ``distributed_gol_tpu/viewer``.
"""

from distributed_gol_torch.viewer.loop import run_headless, run_terminal
from distributed_gol_torch.viewer.keyboard import keyboard_listener

__all__ = ["run_headless", "run_terminal", "keyboard_listener"]
