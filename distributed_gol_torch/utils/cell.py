"""The board-coordinate type (reference: ``util/cell.go:4-6``)."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class Cell(NamedTuple):
    """An (x, y) coordinate on the board.

    ``x`` is the column, ``y`` the row — the same convention as the
    reference's ``util.Cell{X, Y}`` (``util/cell.go:4-6``), which tests
    compare as an order-insensitive multiset (``gol_test.go:58-86``).
    """

    x: int
    y: int


class AliveCells(Sequence):
    """Immutable sequence of alive cells backed by ONE (n, 2) int32 array.

    The reference returns ``[]util.Cell`` from ``calculateAliveCells``
    (``gol/distributor.go:153-166``) — a slice of structs, cheap in Go.  The
    Python equivalent (a tuple of ``Cell`` NamedTuples) materialises ~8M
    objects / ~0.5 GB for a 30%-soup 16384² board, so ``FinalTurnComplete``
    carries this array-backed view instead: same iteration/len/index/equality
    behaviour, O(1) construction from the fetched board, no per-cell objects
    until a caller actually asks for one.
    """

    __slots__ = ("_xy",)

    def __init__(self, xy: np.ndarray):
        xy = np.asarray(xy, dtype=np.int32)
        self._xy = xy.reshape(-1, 2)
        self._xy.setflags(write=False)

    @classmethod
    def from_board(cls, board: np.ndarray) -> "AliveCells":
        """Alive cells of a {0, 255} uint8 board, row-major order — the
        vectorised ``calculateAliveCells`` (``gol/distributor.go:153-166``).
        Flat-index + int32 divmod is ~3× faster than ``np.nonzero`` at the
        16384² finalize this exists for."""
        board = np.asarray(board)
        h, w = board.shape
        flat = np.flatnonzero(board)
        if board.size < 2**31:  # int32 flat index is exact; divmod is faster
            flat = flat.astype(np.int32, copy=False)
        xy = np.empty((flat.size, 2), np.int32)
        np.remainder(flat, w, out=xy[:, 0], casting="unsafe")
        np.floor_divide(flat, w, out=xy[:, 1], casting="unsafe")
        return cls(xy)

    @property
    def xy(self) -> np.ndarray:
        """The raw (n, 2) array of (x, y) pairs (read-only view)."""
        return self._xy

    def __len__(self) -> int:
        return self._xy.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return AliveCells(self._xy[i])
        x, y = self._xy[i]
        return Cell(int(x), int(y))

    def __iter__(self):
        for x, y in self._xy:
            yield Cell(int(x), int(y))

    def __eq__(self, other) -> bool:
        """Order-sensitive sequence equality against any iterable of (x, y)
        pairs — ``final.alive == ()`` stays valid for empty streams."""
        if isinstance(other, AliveCells):
            return np.array_equal(self._xy, other._xy)
        try:
            other_xy = np.asarray(list(other), dtype=np.int32).reshape(-1, 2)
        except (TypeError, ValueError):
            return NotImplemented
        return np.array_equal(self._xy, other_xy)

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    # Unhashable, like the numpy array backing it: == compares equal to plain
    # cell sequences whose hashes we could never match without materialising.
    __hash__ = None

    def __repr__(self) -> str:
        return f"AliveCells(n={len(self)})"


def alive_cells_from_board(board: np.ndarray) -> list[Cell]:
    """All alive cells of a {0, 255} uint8 board, row-major order.

    Equivalent of the reference's ``calculateAliveCells``
    (``gol/distributor.go:153-166``), but vectorised on the host: the board
    is fetched from device once and scanned with NumPy instead of a nested
    Go loop.  Prefer ``AliveCells.from_board`` where the result may be large
    — this materialises a ``Cell`` per alive cell.
    """
    ys, xs = np.nonzero(np.asarray(board))
    return [Cell(int(x), int(y)) for x, y in zip(xs, ys)]


def board_from_alive_cells(
    cells: list[Cell] | list[tuple[int, int]], width: int, height: int
) -> np.ndarray:
    """Rebuild a {0, 255} uint8 board from a list of alive (x, y) cells."""
    board = np.zeros((height, width), dtype=np.uint8)
    for x, y in cells:
        board[y, x] = 255
    return board
