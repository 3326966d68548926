"""Keyboard input → key-press queue.

Equivalent of the SDL event poller (``sdl/loop.go:15-28``): watch for
's'/'p'/'q'/'k' and forward them to the engine's key queue.  Works on any
POSIX tty via termios cbreak mode; a daemon thread so it never blocks
shutdown.

Terminal-mode restore is the CALLER's job via the returned handle: the
watcher thread spends its life blocked in ``stdin.read`` and its own
``finally`` may never run before process exit, so the main thread must call
``restore()`` (idempotent) on the way out or the user's shell is left with
echo off.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Callable, Optional


# s/p/q/k are the reference's control keys (``sdl/loop.go:15-28``);
# a/d/w/x pan and '+'/'='/'-' zoom a region-of-interest viewport
# — forwarded unconditionally, ignored by non-viewport runs.
KEYS = frozenset("spqk" + "adwx+=-")


def keyboard_listener(
    key_presses: queue.Queue, stop: threading.Event
) -> Optional[Callable[[], None]]:
    """Start the stdin watcher; returns a ``restore()`` callable to put the
    terminal back (call from the main thread), or None when stdin isn't a
    tty."""
    if not sys.stdin.isatty():
        return None

    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    restored = threading.Lock()

    def restore():
        if restored.acquire(blocking=False):
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    def watch():
        try:
            while not stop.is_set():
                ch = sys.stdin.read(1)
                if ch in KEYS:
                    key_presses.put(ch)
                if ch == "\x03":  # Ctrl-C in cbreak mode
                    key_presses.put("q")
                    return
        except Exception:
            pass  # tty went away; engine shutdown proceeds regardless

    tty.setcbreak(fd)
    t = threading.Thread(target=watch, name="gol-keyboard", daemon=True)
    t.start()
    return restore
