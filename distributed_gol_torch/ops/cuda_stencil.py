"""The byte stencil kernel (K6) on an H100: one generation per launch.

Counterpart of ``distributed_gol_tpu/ops/pallas_stencil.py``, the engine
``"pallas"`` names: per-turn-visible runs (the viewers) take it under
``auto`` on the card, where packing around every one-generation dispatch
would not pay.  One CUDA kernel (``csrc/stencil.cu``, replaces
``pallas_stencil.py::_stencil_kernel``) with a wrapper, a launch counter
and a plain PyTorch version:

- :func:`stencil_step` launches K6 on a CUDA tensor and counts the launch
  in ``stencil_step.launches`` (and in its rule's instantiation,
  ``stencil_step.rules``); on a CPU tensor it runs
  :func:`stencil_step_plain` and counts nothing.  It never falls back.
  Given a ``count`` (an int64 tensor of one element on the board's
  device), the launch adds the new board's alive count to it: K6 sums
  the cells it writes in its epilogue.
- :func:`make_step_fn`, :func:`make_superstep` and
  :func:`make_steps_with_counts` have the JAX package's signatures minus
  ``interpret``; :func:`make_counted_superstep` also returns the last
  generation's alive count, taken from K6 (the viewers' dispatches).  A
  superstep ping-pongs two buffers; the input board is never written
  (the controller keeps it for the SDC probe).

Gate (:func:`supports`): what K6 needs — W % 4 == 0 (it moves 4-cell
words); every H.  That is every shape ``pallas_stencil.supports`` accepts
(W % 128 == 0 and H a multiple of an 8-row tile) and more.  Rows of
W % 16 == 0 cells on 16-byte aligned boards take the 16-cell (one
``uint4``) instantiation, the rest the 4-cell one (:func:`words_per_thread`).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule
from distributed_gol_torch.ops import cuda_build
from distributed_gol_torch.ops.cuda_adaptive import REG_RULES, reg_rule
from distributed_gol_torch.ops.cuda_packed import _stream

# Cells per word K6 loads and stores: W must be a multiple of it.
WORD_BYTES = 4
# Rows a K6 warp walks.  At 16384² on an H100 runs of 4 rows are the
# fastest of 4 to 128 (`tools/regwin_ab.py --sweep`, PERF.md): many short
# runs make many small blocks, which keep every SM's loads in flight to
# the end, and L2 serves the two rows each run reads again.
RUN_ROWS = 4

_LOW, _HIGH, _MASK32 = 0x01010101, 0x80808080, 0xFFFFFFFF


def supports(shape: tuple[int, int]) -> bool:
    """Board shapes (cells) K6 takes: W a positive multiple of 4, any H."""
    h, w = shape
    return h >= 1 and w >= WORD_BYTES and w % WORD_BYTES == 0


def words_per_thread(board: torch.Tensor, out: torch.Tensor | None = None) -> int:
    """4-cell words a K6 thread loads and stores: 4 (one 16-byte load) where
    every row starts at a 16-byte boundary (W % 16 == 0 and both boards
    16-byte aligned), else 1."""
    w = board.shape[1]
    ptrs = [board.data_ptr()] + ([] if out is None else [out.data_ptr()])
    return 4 if w % 16 == 0 and all(p % 16 == 0 for p in ptrs) else 1


def _rule_bytes(n: torch.Tensor, a: torch.Tensor, rule: LifeRule) -> torch.Tensor:
    """0x80 in each byte of the int64 words whose cell is alive next, from
    its live neighbours ``n`` and alive bit ``a`` (bytes 0/1): K6's
    ``ByteRule`` — B3/S23 where (n | a) == 3, B36/S23 where it is 3 or 6,
    any other rule byte by byte through its (born, surv) masks."""
    born, surv, variant = reg_rule(rule)

    def zero(x):  # 0x80 in each zero byte (every byte < 0x80)
        return ~(x + 0x7F7F7F7F) & _HIGH

    if variant == 1:
        return zero((n | a) ^ 0x03030303)
    if variant == 2:
        x = n | a
        return zero(x ^ 0x03030303) | zero(x ^ 0x06060606)
    z = torch.zeros_like(n)
    for i in range(4):
        ai = (a >> (8 * i)) & 1
        t = ((n >> (8 * i)) & 0xFF) + ai
        mask = torch.where(ai.bool(), surv, born)
        z |= ((mask >> t) & 1) << (8 * i + 7)
    return z


def stencil_step_plain(
    board: torch.Tensor, rule: LifeRule, count: torch.Tensor | None = None,
    run: int | None = None,
) -> torch.Tensor:
    """Plain version of K6, in the kernel's own formulation: the board as
    little-endian 4-cell words (int64), the alive bits of each run of
    ``run`` rows (None: ``RUN_ROWS``) and of its rows above and below,
    3-row sums, the west and east bytes by funnel shifts across the words
    (the row wrapping), each cell's live neighbours, the SWAR rule
    (:func:`_rule_bytes`), and the 0/1 result bytes times 255.  ``count``
    gains the new board's alive count, the result bytes summed."""
    h, w = board.shape
    dev = board.device
    words = board.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    run = run or RUN_ROWS
    runs = -(-h // run)
    rows = torch.remainder(torch.arange(runs, device=dev)[:, None] * run - 1
                           + torch.arange(run + 2, device=dev), h)
    a = (words & _LOW)[rows]  # (runs, run + 2, W / 4)
    mid = a[:, 1:-1]
    v = a[:, :-2] + mid + a[:, 2:]
    west = ((v << 8) & _MASK32) | (torch.roll(v, 1, 2) >> 24)
    east = (v >> 8) | ((torch.roll(v, -1, 2) << 24) & _MASK32)
    ones = (_rule_bytes(west + east + v - mid, mid, rule) >> 7).flatten(0, 1)[:h]
    if count is not None:
        count += ((ones * _LOW) >> 24 & 0xFF).sum()
    cells = torch.stack([(ones >> (8 * i)) & 1 for i in range(4)], dim=-1)  # byte i: cell 4k + i
    return (cells * 0xFF).to(torch.uint8).view(h, w)


def _check_board(board: torch.Tensor) -> None:
    if board.dtype != torch.uint8 or board.dim() != 2 or not board.is_contiguous():
        raise ValueError(
            f"the board must be a contiguous 2-D uint8 tensor, got {board.dtype} "
            f"{tuple(board.shape)}"
        )
    if board.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {board.device}")


def _check_count(count: torch.Tensor, board: torch.Tensor) -> None:
    if count.dtype != torch.int64 or count.numel() != 1 or count.device != board.device:
        raise ValueError(f"count must be one int64 on {board.device}, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")


def stencil_step(
    board: torch.Tensor, rule: LifeRule, out: torch.Tensor | None = None,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """K6: one generation of ``board`` into ``out`` (a new tensor when
    None; never ``board`` itself); ``count`` (one int64 on the board's
    device), when given, gains the new board's alive count.  CPU tensors
    run :func:`stencil_step_plain`; a CUDA tensor launches K6 in the rule's
    instantiation (B3/S23 and B36/S23 compiled in, any other rule by its
    masks) or raises."""
    _check_board(board)
    if out is not None:
        _check_board(out)
        if out.shape != board.shape or out.device != board.device or out.data_ptr() == board.data_ptr():
            raise ValueError("out must be another tensor of the board's shape and device")
    if count is not None:
        _check_count(count, board)
    h, w = board.shape
    if not supports((h, w)):
        raise ValueError(f"the stencil kernel does not take a {h}x{w} board (W % 4 != 0)")
    if board.device.type == "cpu":
        nxt = stencil_step_plain(board, rule, count)
        return nxt if out is None else out.copy_(nxt)
    if out is None:
        out = torch.empty_like(board)
    if board.data_ptr() % WORD_BYTES or out.data_ptr() % WORD_BYTES:
        raise ValueError("the board and out must start at a 4-byte boundary")
    words = words_per_thread(board, out)
    lib = cuda_build.load("stencil")
    born, surv, variant = reg_rule(rule)
    err = lib.gol_stencil_launch(
        ctypes.c_void_p(board.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(None if count is None else count.data_ptr()), h, w, words, RUN_ROWS,
        variant,
        ctypes.c_uint(born), ctypes.c_uint(surv), _stream(board),
    )
    cuda_build.check(lib, err, "stencil")
    stencil_step.launches += 1
    stencil_step.rules[REG_RULES[variant]] += 1
    return out


stencil_step.launches = 0
stencil_step.rules = collections.Counter()


def reset_launches() -> None:
    """Set K6's launch counter to 0."""
    stencil_step.launches = 0


def make_step_fn(rule: LifeRule = CONWAY):
    """A one-generation function ``board -> board``."""
    return lambda board: stencil_step(board, rule)


def _generations(board: torch.Tensor, rule: LifeRule, turns: int, counts=None):
    """Yield the board after each of ``turns`` generations, the launches
    ping-ponging between two buffers; ``board`` itself is never written.
    ``counts(i)`` is the counter generation i + 1 adds its alive count to
    (None: not counted)."""
    bufs: list[torch.Tensor] = []
    for i in range(turns):
        board = stencil_step(board, rule, out=bufs[i % 2] if len(bufs) == 2 else None,
                             count=None if counts is None else counts(i))
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


def make_counted_superstep(rule: LifeRule = CONWAY):
    """``(board, turns) -> (board, int64 count)``: :func:`make_superstep`
    whose last launch also counts the board it writes (the count unsynced
    on the board's device); no launch at 0 turns, where the count is the
    input's."""

    def superstep(board: torch.Tensor, turns: int):
        if turns == 0:
            return board, torch.sum(board & 1, dtype=torch.int64)
        count = torch.zeros((), dtype=torch.int64, device=board.device)
        for board in _generations(board, rule, turns,
                                  lambda i: count if i == turns - 1 else None):
            pass
        return board, count

    return superstep


def make_steps_with_counts(rule: LifeRule = CONWAY):
    """``(board, turns) -> (board, int64[turns])``: entry i is the alive
    count after generation i + 1, K6's own count of the board it wrote
    (unsynced on the board's device)."""

    def run(board: torch.Tensor, turns: int):
        counts = torch.zeros(turns, dtype=torch.int64, device=board.device)
        for board in _generations(board, rule, turns, lambda i: counts[i]):
            pass
        return board, counts

    return run
