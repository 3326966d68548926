"""The packed SWAR engine on a mesh: halo exchange at word granularity.

Counterpart of ``distributed_gol_tpu/parallel/packed_halo.py``.  The same
exchange as ``parallel/halo.py`` (neighbour-only copies over the
``("y", "x")`` mesh), on the 32-cells-per-word board of ``ops/packed.py``:

- Each shard is an (h/ny, wp/nx) block of int32-held uint32 words.
- Row halos are one packed row each way.
- Column halos are one *word* column each way: the horizontal shift with
  cross-word carry needs only the adjacent word, so one word carries the
  1-bit halo plus 31 bits of slack.
- Corners ride along by exchanging columns of the row-extended block.

Bit-identical to ``ops/packed.py`` on any mesh shape (a 1-sized axis
copies a shard's own edge, which IS the torus wrap).  One exchange per
generation: the temporally blocked form is ``parallel/cuda_halo.py``.
"""

from __future__ import annotations

import torch

from distributed_gol_torch.models.life import LifeRule
from distributed_gol_torch.ops import packed
from distributed_gol_torch.ops.packed import WORD, _maj, _shr, apply_rule_planes
from distributed_gol_torch.parallel.halo import (
    ShardedBoard,
    _exchange_and_extend,  # dtype-agnostic: one packed row / word column per side
    psum,
)
from distributed_gol_torch.parallel.mesh import Mesh


def _hshift(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """West/east 1-bit shifts of a column-extended plane (h, wp+2); the
    cross-word carry words are the extended columns, so no roll is needed.
    Returns (west, east) planes of shape (h, wp)."""
    west = (v[:, 1:-1] << 1) | _shr(v[:, :-2], 31)
    east = _shr(v[:, 1:-1], 1) | (v[:, 2:] << 31)
    return west, east


def _local_step(ext: torch.Tensor, rule: LifeRule) -> torch.Tensor:
    """One packed generation of a shard from its (h+2, wp+2) extended
    block: the adder network of ``packed.step`` with the horizontal
    carries taken from the exchanged word columns instead of a roll."""
    centre = ext[1:-1, 1:-1]
    n, c, s = ext[:-2, :], ext[1:-1, :], ext[2:, :]
    v0 = n ^ c ^ s  # (h, wp+2): the vertical 3-row adder, then horizontal
    v1 = _maj(n, c, s)
    v0w, v0e = _hshift(v0)
    v1w, v1e = _hshift(v1)
    v0c, v1c = v0[:, 1:-1], v1[:, 1:-1]
    s0 = v0c ^ v0w ^ v0e
    c0 = _maj(v0c, v0w, v0e)
    s1 = v1c ^ v1w ^ v1e
    c1 = _maj(v1c, v1w, v1e)
    k = c0 & s1
    totals = (s0, c0 ^ s1, c1 ^ k, c1 & k)  # the 9-cell total planes
    return apply_rule_planes(totals, centre, rule)


def _step(board: ShardedBoard, rule: LifeRule) -> ShardedBoard:
    ext = _exchange_and_extend(board)
    return ShardedBoard(board.mesh, [[_local_step(e, rule) for e in row] for row in ext])


def _local_count(board: ShardedBoard, dtype) -> torch.Tensor:
    return psum(packed.popcount(t).sum().to(dtype) for t in board.flat)


def sharded_superstep(mesh: Mesh, rule: LifeRule):
    """(packed board, turns) -> packed board, one exchange a generation."""

    def run(board: ShardedBoard, turns: int) -> ShardedBoard:
        for _ in range(turns):
            board = _step(board, rule)
        return board

    return run


def _counting_scan(board: ShardedBoard, rule: LifeRule, dtype, turns: int):
    counts = []
    for _ in range(turns):
        board = _step(board, rule)
        counts.append(_local_count(board, dtype))
    if not counts:
        return board, torch.zeros(0, dtype=dtype, device=board.shards[0][0].device)
    return board, torch.stack(counts)


def sharded_steps_with_counts(mesh: Mesh, rule: LifeRule):
    """(packed board, turns) -> (packed board, int[turns] global counts):
    int32 below 2^31 board cells, int64 at and above."""

    def run(board: ShardedBoard, turns: int):
        h, wp = board.shape
        return _counting_scan(board, rule, packed.count_dtype(h * wp * WORD), turns)

    return run


# -- byte-board drivers: uint8 {0,255} shards in and out ----------------------
#
# The board stays a sharded uint8 board at the engine layer (the same
# put/fetch contract as every other engine); each shard is packed and
# unpacked on its own device, so packing never moves data between shards.


def supports(shape: tuple[int, int], mesh_shape: tuple[int, int]) -> bool:
    h, w = shape
    ny, nx = mesh_shape
    return h % ny == 0 and w % nx == 0 and (w // nx) % WORD == 0 and w > 0


def make_superstep_bytes(mesh: Mesh, rule: LifeRule):
    inner = sharded_superstep(mesh, rule)

    def run(board: ShardedBoard, turns: int) -> ShardedBoard:
        return inner(board.map(packed.pack), turns).map(packed.unpack)

    return run


def make_steps_with_counts_bytes(mesh: Mesh, rule: LifeRule):
    def run(board: ShardedBoard, turns: int):
        h, w = board.shape
        final, counts = _counting_scan(
            board.map(packed.pack), rule, packed.count_dtype(h * w), turns
        )
        return final.map(packed.unpack), counts

    return run
