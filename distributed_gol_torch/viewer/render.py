"""Terminal board renderer: ANSI half-block cells with downsampling.

A copy of ``distributed_gol_tpu/viewer/render.py``.

Replaces the SDL texture window (``sdl/window.go``): each character cell
shows two board rows via the upper-half-block glyph; boards larger than the
terminal are max-pooled so any live cell in a tile lights it (at 16384² a
live-anywhere tile is the only readable choice).
"""

from __future__ import annotations

import shutil

import numpy as np

RESET = "\x1b[0m"
FG_ON = "\x1b[38;5;255m"
FG_OFF = "\x1b[38;5;236m"
BG_ON = "\x1b[48;5;255m"
BG_OFF = "\x1b[48;5;236m"
HALF = "▀"  # upper half block: fg = top row, bg = bottom row


def downsample(board: np.ndarray, max_h: int, max_w: int) -> np.ndarray:
    """Max-pool to fit (max_h, max_w); sizes not divisible by the factor are
    zero-padded (dead cells) up to a multiple, so trailing rows/columns of
    live cells still light their tile — matching the device-side
    ``ops.stencil.frame_pool``."""
    h, w = board.shape
    fy = max(1, -(-h // max_h))
    fx = max(1, -(-w // max_w))
    ph, pw = -(-h // fy) * fy, -(-w // fx) * fx
    if (ph, pw) != (h, w):
        board = np.pad(board, ((0, ph - h), (0, pw - w)))
    return board.reshape(ph // fy, fy, pw // fx, fx).max(axis=(1, 3))


def render(board: np.ndarray, term_size: tuple[int, int] | None = None) -> str:
    """One ANSI frame of the board (two rows per text line)."""
    if term_size is None:
        ts = shutil.get_terminal_size((80, 24))
        term_size = (max(4, (ts.lines - 2) * 2), max(4, ts.columns - 2))
    view = downsample(board != 0, *term_size)
    if view.shape[0] % 2:
        view = np.vstack([view, np.zeros((1, view.shape[1]), bool)])
    top, bottom = view[0::2], view[1::2]
    lines = []
    for t_row, b_row in zip(top, bottom):
        line = []
        for t, b in zip(t_row, b_row):
            fg = FG_ON if t else FG_OFF
            bg = BG_ON if b else BG_OFF
            line.append(f"{fg}{bg}{HALF}")
        lines.append("".join(line) + RESET)
    return "\n".join(lines)


def home_cursor() -> str:
    return "\x1b[H"


def clear_screen() -> str:
    return "\x1b[2J\x1b[H"
