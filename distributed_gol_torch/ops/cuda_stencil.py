"""The byte stencil kernel (K6) on an H100: one generation per launch.

Counterpart of ``distributed_gol_tpu/ops/pallas_stencil.py``, the engine
``"pallas"`` names: per-turn-visible runs (the viewers) take it under
``auto`` on the card, where packing around every one-generation dispatch
would not pay.  One CUDA kernel (``csrc/stencil.cu``, replaces
``pallas_stencil.py::_stencil_kernel``) with a wrapper, a launch counter
and a plain PyTorch version:

- :func:`stencil_step` launches K6 on a CUDA tensor and counts the launch
  in ``stencil_step.launches``; on a CPU tensor it runs
  :func:`stencil_step_plain` and counts nothing.  It never falls back.
- :func:`make_step_fn`, :func:`make_superstep` and
  :func:`make_steps_with_counts` have the JAX package's signatures minus
  ``interpret``.  A superstep ping-pongs two buffers; the input board is
  never written (the controller keeps it for the SDC probe).

Gate (:func:`supports`): what K6 needs — W % 4 == 0 (it moves 4-cell
words) and at most 65,535 row tiles; every H.  That is every shape
``pallas_stencil.supports`` accepts (W % 128 == 0 and H a multiple of an
8-row tile) and more.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule
from distributed_gol_torch.ops import cuda_build
from distributed_gol_torch.ops.cuda_packed import _stream, rule_masks

# Cells per word K6 loads and stores: W must be a multiple of it.
WORD_BYTES = 4
# Rows per K6 tile (kTileH in csrc/stencil.cu) and the grid's row limit.
TILE_H = 32
MAX_ROW_TILES = 65535


def supports(shape: tuple[int, int]) -> bool:
    """Board shapes (cells) K6 takes: W a positive multiple of 4, any H up
    to 65,535 row tiles."""
    h, w = shape
    return h >= 1 and w >= WORD_BYTES and w % WORD_BYTES == 0 and -(-h // TILE_H) <= MAX_ROW_TILES


def _mask_bits(mask: int, device) -> torch.Tensor:
    """Bit k of ``mask`` at index k, for the 9-cell totals 0..9."""
    return torch.tensor([(mask >> k) & 1 for k in range(10)], dtype=torch.uint8, device=device)


def stencil_step_plain(board: torch.Tensor, rule: LifeRule) -> torch.Tensor:
    """Plain version of K6, in the kernel's own formulation: alive bits,
    a 3-row then a 3-column sum (each cell's 9-cell total), and the rule
    as the (born, surv) masks over that total."""
    alive = board & 1
    rows = alive + torch.roll(alive, 1, 0) + torch.roll(alive, -1, 0)
    total = (rows + torch.roll(rows, 1, 1) + torch.roll(rows, -1, 1)).long()
    born, surv = rule_masks(rule)
    nxt = torch.where(
        alive.bool(), _mask_bits(surv, board.device)[total], _mask_bits(born, board.device)[total]
    )
    return nxt * 255


def _check_board(board: torch.Tensor) -> None:
    if board.dtype != torch.uint8 or board.dim() != 2 or not board.is_contiguous():
        raise ValueError(
            f"the board must be a contiguous 2-D uint8 tensor, got {board.dtype} "
            f"{tuple(board.shape)}"
        )
    if board.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {board.device}")


def stencil_step(
    board: torch.Tensor, rule: LifeRule, out: torch.Tensor | None = None
) -> torch.Tensor:
    """K6: one generation of ``board`` into ``out`` (a new tensor when
    None; never ``board`` itself).  CPU tensors run
    :func:`stencil_step_plain`."""
    _check_board(board)
    if out is not None:
        _check_board(out)
        if out.shape != board.shape or out.device != board.device or out.data_ptr() == board.data_ptr():
            raise ValueError("out must be another tensor of the board's shape and device")
    if board.device.type == "cpu":
        nxt = stencil_step_plain(board, rule)
        return nxt if out is None else out.copy_(nxt)
    h, w = board.shape
    if not supports((h, w)):
        raise ValueError(f"the stencil kernel does not take a {h}x{w} board (W % 4 != 0)")
    if out is None:
        out = torch.empty_like(board)
    if board.data_ptr() % WORD_BYTES or out.data_ptr() % WORD_BYTES:
        raise ValueError("the board and out must start at a 4-byte boundary")
    lib = cuda_build.load("stencil")
    born, surv = rule_masks(rule)
    err = lib.gol_stencil_launch(
        ctypes.c_void_p(board.data_ptr()), ctypes.c_void_p(out.data_ptr()), h, w,
        ctypes.c_uint(born), ctypes.c_uint(surv), _stream(board),
    )
    cuda_build.check(lib, err, "stencil")
    stencil_step.launches += 1
    return out


stencil_step.launches = 0


def reset_launches() -> None:
    """Set K6's launch counter to 0."""
    stencil_step.launches = 0


def make_step_fn(rule: LifeRule = CONWAY):
    """A one-generation function ``board -> board``."""
    return lambda board: stencil_step(board, rule)


def _generations(board: torch.Tensor, rule: LifeRule, turns: int):
    """Yield the board after each of ``turns`` generations, the launches
    ping-ponging between two buffers; ``board`` itself is never written."""
    bufs: list[torch.Tensor] = []
    for i in range(turns):
        board = stencil_step(board, rule, out=bufs[i % 2] if len(bufs) == 2 else None)
        if len(bufs) < 2:
            bufs.append(board)
        yield board


def make_superstep(rule: LifeRule = CONWAY):
    """``(board, turns) -> board``: one launch per generation, ping-ponging
    two buffers; the input board is never written."""

    def superstep(board: torch.Tensor, turns: int) -> torch.Tensor:
        for board in _generations(board, rule, turns):
            pass
        return board

    return superstep


def make_steps_with_counts(rule: LifeRule = CONWAY):
    """``(board, turns) -> (board, int64[turns])``: entry i is the alive
    count after generation i + 1 (unsynced on the board's device)."""

    def run(board: torch.Tensor, turns: int):
        counts = []
        for board in _generations(board, rule, turns):
            counts.append(torch.sum(board & 1, dtype=torch.int64))
        if not counts:
            return board, torch.zeros(0, dtype=torch.int64, device=board.device)
        return board, torch.stack(counts)

    return run
