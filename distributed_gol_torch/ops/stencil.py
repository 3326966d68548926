"""Roll-based 9-point stencil: the always-correct baseline generation engine.

PyTorch counterpart of ``distributed_gol_tpu/ops/stencil.py``.  Cells are
uint8 {0, 255}; the board is a torus; a generation applies an
outer-totalistic rule to every cell's 8-neighbour count through the
18-entry table of ``LifeRule.table``.  The torus is four ``torch.roll``s
and the rule one gather per cell, so every op is a plain tensor op that
runs unchanged on the CPU and on the card.  This engine is the port's CPU
reference and the independent formulation the SDC probe recomputes with.
"""

from __future__ import annotations

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule


def rule_table(rule: LifeRule, device) -> torch.Tensor:
    """``rule.table`` as a uint8 tensor on ``device``."""
    return torch.as_tensor(rule.table, dtype=torch.uint8, device=device)


def neighbour_counts(alive: torch.Tensor) -> torch.Tensor:
    """8-neighbour Moore counts with toroidal wrap, for a {0,1} uint8 grid.

    Separable form: sum the 3-row window, then the 3-column window of that,
    then subtract the centre.  Max value 9 before the subtraction fits
    uint8."""
    rows = alive + torch.roll(alive, 1, 0) + torch.roll(alive, -1, 0)
    return rows + torch.roll(rows, 1, 1) + torch.roll(rows, -1, 1) - alive


def apply_rule(
    alive: torch.Tensor, counts: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Next-generation board bytes: ``table[9 * alive + count]`` → 0/255."""
    idx = counts.long() + 9 * alive.long()
    return table[idx]


def step(board: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One generation on a {0,255} uint8 board (torus)."""
    alive = board & 1  # 255 & 1 == 1: the LSB is the alive bit
    return apply_rule(alive, neighbour_counts(alive), table)


#: Cells in one row block of the whole-board passes (the packing passes
#: of ``ops/packed.py``, :func:`alive_count`, the SDC fingerprint): each
#: block's transients take a few bytes a cell, so a pass holds little
#: beside its input and output at any board size (64 blocks at 65536²).
BLOCK_CELLS = 1 << 26


def row_blocks(rows: int, row_cells: int) -> list[tuple[int, int]]:
    """``(start, stop)`` ranges over ``rows`` rows of ``row_cells`` cells
    each (a row of every board of a stack), at most :data:`BLOCK_CELLS`
    cells a range and one row at least."""
    step = max(1, BLOCK_CELLS // max(1, row_cells))
    return [(r, min(rows, r + step)) for r in range(0, rows, step)]


def alive_count(board: torch.Tensor) -> torch.Tensor:
    """Alive-cell count as an unsynced 0-d int64 tensor on the board's
    device (``int()`` forces it).  A sum first widens what it sums to its
    accumulator's type, so the board is summed a row block at a time
    (:func:`row_blocks`): int32 within a block, int64 across them."""
    total = torch.zeros((), dtype=torch.int64, device=board.device)
    for y0, y1 in row_blocks(board.shape[-2], board[..., :1, :].numel()):
        total += torch.sum(board[..., y0:y1, :] & 1, dtype=torch.int32)
    return total


def superstep(board: torch.Tensor, table: torch.Tensor, turns: int) -> torch.Tensor:
    """``turns`` generations."""
    for _ in range(turns):
        board = step(board, table)
    return board


def steps_with_counts(
    board: torch.Tensor, table: torch.Tensor, turns: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``turns`` generations → (final board, int64[turns] counts);
    ``counts[i]`` is the alive count after generation ``i + 1``."""
    counts = []
    for _ in range(turns):
        board = step(board, table)
        counts.append(alive_count(board))
    if not counts:
        return board, torch.zeros(0, dtype=torch.int64, device=board.device)
    return board, torch.stack(counts)


def frame_pool(board: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Max-pool a uint8 board by (fy, fx): a live cell anywhere in a tile
    lights the tile.  Sizes that are not a multiple of the factor are
    zero-padded (dead cells) up to one."""
    h, w = board.shape
    ph, pw = -(-h // fy) * fy, -(-w // fx) * fx
    if (ph, pw) != (h, w):
        board = torch.nn.functional.pad(board, (0, pw - w, 0, ph - h))
    return board.reshape(ph // fy, fy, pw // fx, fx).amax(dim=(1, 3))


def viewport(board: torch.Tensor, y0: int, x0: int, vh: int, vw: int) -> torch.Tensor:
    """Toroidal (vh, vw) window of ``board`` anchored at (y0, x0); any
    integer anchor is legal (floor-mod wrap)."""
    h, w = board.shape
    rows = torch.remainder(y0 + torch.arange(vh, device=board.device), h)
    cols = torch.remainder(x0 + torch.arange(vw, device=board.device), w)
    return board.index_select(0, rows).index_select(1, cols)


def flip_mask(prev: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Cells that changed between two boards, as a uint8 0/1 mask."""
    return (prev ^ new) & 1


def make_step_fn(rule: LifeRule = CONWAY):
    """A one-generation function specialised to ``rule``: ``board ->
    board``, with the rule table made once per device."""
    tables: dict = {}

    def fn(board: torch.Tensor) -> torch.Tensor:
        table = tables.get(board.device)
        if table is None:
            table = tables[board.device] = rule_table(rule, board.device)
        return step(board, table)

    return fn


# Weight of each of the 8 cells of a packed byte, first cell highest.
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(x: torch.Tensor) -> torch.Tensor:
    """``numpy.packbits(x != 0, axis=-1)`` (and ``jnp.packbits``): 8 cells
    per uint8 along the last axis, the first cell in the most significant
    bit, the last byte zero-padded when the length is not a multiple of 8.
    ``numpy.unpackbits(..., axis=-1, count=n)`` inverts it."""
    bits = (x != 0).to(torch.uint8)
    pad = -bits.shape[-1] % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], -1, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=x.device)
    return (bits * weights).sum(dim=-1, dtype=torch.uint8)
