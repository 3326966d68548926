"""ASCII board renderers for small-board test-failure diffs.

A copy of ``distributed_gol_tpu/utils/visualise.py``.

Role equivalent of the reference's ``util/visualise.go:21-48``
(``AliveCellsToString``): when a 16x16 golden-board assertion fails, print
the expected and actual boards side by side with box-drawing borders so the
failure is readable in a terminal.  Fresh implementation — renders from
either cell lists or uint8 boards, marks mismatched cells.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from distributed_gol_torch.utils.cell import Cell, board_from_alive_cells

_ALIVE = "#"
_DEAD = "."
_WRONG = "X"  # alive where it should be dead, or vice versa


def _render(board: np.ndarray, diff: np.ndarray | None, title: str) -> list[str]:
    h, w = board.shape
    lines = [title.center(w + 2), "┌" + "─" * w + "┐"]
    for y in range(h):
        row = []
        for x in range(w):
            if diff is not None and diff[y, x]:
                row.append(_WRONG)
            else:
                row.append(_ALIVE if board[y, x] else _DEAD)
        lines.append("│" + "".join(row) + "│")
    lines.append("└" + "─" * w + "┘")
    return lines


def alive_cells_to_string(
    expected: Sequence[Cell] | Iterable[tuple[int, int]],
    actual: Sequence[Cell] | Iterable[tuple[int, int]],
    width: int,
    height: int,
) -> str:
    """Side-by-side expected/actual board diff with mismatches marked ``X``.

    Only sensible for small boards; tests use it at 16x16 like the
    reference's ``boardFail`` helper (``gol_test.go:49-56``).
    """
    exp = board_from_alive_cells(list(expected), width, height)
    act = board_from_alive_cells(list(actual), width, height)
    return boards_to_string(exp, act)


def boards_to_string(expected: np.ndarray, actual: np.ndarray) -> str:
    expected = np.asarray(expected)
    actual = np.asarray(actual)
    diff = expected != actual
    left = _render(expected, None, "expected")
    right = _render(actual, diff, "actual (X = wrong)")
    sep = "   "
    return "\n".join(l + sep + r for l, r in zip(left, right))


def board_to_string(board: np.ndarray, title: str = "board") -> str:
    return "\n".join(_render(np.asarray(board), None, title))
