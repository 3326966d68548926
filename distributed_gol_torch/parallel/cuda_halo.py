"""Temporal blocking on a mesh: the ``pallas-packed`` engine's sharded form.

Counterpart of the strip and plain 2-D parts of
``distributed_gol_tpu/parallel/pallas_halo.py``.  One halo exchange buys
T generations: each shard of the packed board receives ``pad = T``
boundary rows from its y-neighbours (and, on a 2-D mesh, ``xpad`` word
columns from its x-neighbours, the corners riding the row-extended
block), and K9 (``csrc/ext.cu``; replaces ``pallas_halo.py::_ext_kernel``)
advances the extended block T generations and writes back its centre.
Communication per generation drops T-fold against the per-turn engines
(``parallel/packed_halo.py``).

- :func:`supports` is the port's own gate: every mesh that divides the
  packed board into shards of at least one row and one word takes K9, so
  K9 takes every board ``packed_halo`` takes.
  The plan caps T at the strip height, so every halo comes from the
  adjacent shard alone; the TPU's gate instead needs strips of 8k >= 8
  rows (``pallas_halo.py:117-146``).
- :func:`launch_plan` is the port's own plan: T = min(turns, 32,
  h_loc), pad = T, xpad = ceil(T / 32) on a 2-D mesh and 0 on a row
  mesh, then one remainder launch; K9's tiles are K2's
  (``ops/cuda_packed.py``), sized for shared memory.  The TPU's
  ``launch_turns``, ``_tile_for_pad``, ``_LAUNCH_COST`` and
  ``_xpad_words`` are v5e ratios and are not carried over.
- :func:`ext_launch` is K9's wrapper with its launch counter; a CPU tensor
  runs :func:`ext_launch_plain`, a CUDA tensor launches K9 or raises.
  :func:`ext_launch_mirror` replays K9's window decomposition in PyTorch.

``skip_stable`` on a mesh (the adaptive strip and 2-D tiers) is ROADMAP
B8-B12 and raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule
from distributed_gol_torch.ops import cuda_build, cuda_packed, packed
from distributed_gol_torch.ops.cuda_packed import (
    SMEM_BYTES, TILED_COLS, TILED_MAX_T, TiledPlan, _check_words, _stream, rule_masks)
from distributed_gol_torch.ops.packed import WORD
from distributed_gol_torch.parallel.halo import ShardedBoard, extend
from distributed_gol_torch.parallel.mesh import Mesh

#: Deepest launch the plan asks for: one halo word per side covers it.
EXT_MAX_T = TILED_MAX_T


def supports(pshape: tuple[int, int], mesh_shape: tuple[int, int]) -> bool:
    """Whether the packed (H, wp) board runs K9 on an (ny, nx) mesh: the
    mesh divides it into shards of at least one row and one word — every
    board the word-halo engine (``packed_halo.supports``) takes."""
    h, wp = pshape
    ny, nx = mesh_shape
    return h > 0 and wp > 0 and h % ny == 0 and wp % nx == 0


# -- the plan (pure Python) ---------------------------------------------------


def ext_tiles(strip: tuple[int, int], t: int) -> TiledPlan:
    """K9's tiling of an (h_loc, wpl) centre for a T-generation launch: K2's
    rule — the widest window of at most ``TILED_COLS`` words with an
    xw = ceil(T / 32)-word border, split evenly over the width, then the
    tallest tile whose two window buffers fit ``SMEM_BYTES``, split evenly
    over the height.  ``TiledPlan.xpad`` is the window's border xw."""
    h_loc, wpl = strip
    xw = -(-t // WORD)
    if 2 * xw >= TILED_COLS:
        raise ValueError(f"no K9 window for {t} generations")
    tile_w = cuda_packed.tile_width(wpl, xw)
    max_tile_h = SMEM_BYTES // (2 * 4 * (tile_w + 2 * xw)) - 2 * t
    if max_tile_h < 1:
        raise ValueError(f"no K9 window for {t} generations: shared memory")
    ny = -(-h_loc // max_tile_h)
    return TiledPlan(t, -(-h_loc // ny), tile_w, xw)


@dataclasses.dataclass(frozen=True)
class ExtPlan:
    """One sharded launch: an exchange of ``pad`` rows and ``xpad`` word
    columns per side, then K9 advancing each extended shard ``t``
    generations on ``tiles``."""

    t: int
    pad: int
    xpad: int
    tiles: TiledPlan

    def grid(self, strip: tuple[int, int]) -> tuple[int, int]:
        """(tile rows, tile columns) of one shard's K9 launch."""
        return self.tiles.grid(strip)

    def halo_bytes(self, strip: tuple[int, int]) -> int:
        """Bytes one shard receives in the exchange: its pad rows and its
        xpad columns of the row-extended block."""
        h_loc, wpl = strip
        return 4 * (2 * self.pad * wpl + 2 * self.xpad * (h_loc + 2 * self.pad))


def _plan_for(strip: tuple[int, int], nx: int, t: int) -> ExtPlan:
    return ExtPlan(t, t, -(-t // WORD) if nx > 1 else 0, ext_tiles(strip, t))


def launch_plan(
    strip: tuple[int, int], mesh_shape: tuple[int, int], turns: int
) -> list[ExtPlan]:
    """The launches of a ``turns``-generation dispatch on shards of
    ``strip`` = (h_loc, wpl) packed words: full launches of T = min(turns,
    ``EXT_MAX_T``, h_loc), then one remainder launch.  Capping T at h_loc
    keeps every halo within the adjacent shard."""
    if turns < 1:
        return []
    nx = mesh_shape[1]
    t = max(1, min(turns, EXT_MAX_T, strip[0]))
    full, rem = divmod(turns, t)
    launches = [_plan_for(strip, nx, t)] * full
    if rem:
        launches.append(_plan_for(strip, nx, rem))
    return launches


# -- K9 and its plain versions --------------------------------------------------


def _centre(ext: torch.Tensor, turns: int, pad: int, xpad: int) -> tuple[int, int]:
    """(h_loc, wpl) of an extended block, after checking the launch."""
    h_loc, wpl = ext.shape[0] - 2 * pad, ext.shape[1] - 2 * xpad
    if h_loc < 1 or wpl < 1 or not 1 <= turns <= pad or (xpad and WORD * xpad < turns):
        raise ValueError(
            f"K9 cannot advance a {tuple(ext.shape)} block {turns} generations with "
            f"pad {pad} and xpad {xpad}: need 1 <= turns <= pad and xpad * 32 >= turns"
        )
    return h_loc, wpl


def ext_launch_plain(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int
) -> torch.Tensor:
    """Plain version of K9: ``turns`` generations of the extended block in
    PyTorch, then its (h_loc, wpl) centre.  The rolls wrap the block;
    that error spreads one row or cell per generation from its edge and
    never reaches the centre (pad >= turns, xpad·32 >= turns).  On a row
    mesh (xpad = 0) the column roll is the exact torus."""
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    out = packed.superstep(ext, rule, turns)
    return out[pad : pad + h_loc, xpad : xpad + wpl].contiguous()


def ext_launch_mirror(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int,
    tiles: TiledPlan | None = None,
) -> torch.Tensor:
    """K9's exact window decomposition in PyTorch: every tile's window
    gathered as ``load_ext_window`` does (rows as they are, columns modulo
    the width when xpad = 0, zero outside the block), stepped with
    zero-filled window edges, its centre stored.  ``tiles`` forces the
    tiling (tests); None takes :func:`ext_tiles`."""
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    tiles = tiles or ext_tiles((h_loc, wpl), turns)
    xw = tiles.xpad
    rows_in, cols_in = ext.shape
    ny, nx = tiles.grid((h_loc, wpl))
    dev = ext.device
    rows = (pad - turns + torch.arange(ny, device=dev)[:, None] * tiles.tile_h
            + torch.arange(tiles.tile_h + 2 * turns, device=dev))
    cols = (xpad - xw + torch.arange(nx, device=dev)[:, None] * tiles.tile_w
            + torch.arange(tiles.tile_w + 2 * xw, device=dev))
    if xpad == 0:
        cols = torch.remainder(cols, cols_in)
    row_ok = (rows >= 0) & (rows < rows_in)
    col_ok = (cols >= 0) & (cols < cols_in)
    win = ext[rows.clamp(0, rows_in - 1)[:, None, :, None],
              cols.clamp(0, cols_in - 1)[None, :, None, :]]
    win = win * (row_ok[:, None, :, None] & col_ok[None, :, None, :])
    for _ in range(turns):
        win = cuda_packed._window_gen(win, rule)
    centre = win[:, :, turns : turns + tiles.tile_h, xw : xw + tiles.tile_w]
    out = centre.permute(0, 2, 1, 3).reshape(ny * tiles.tile_h, nx * tiles.tile_w)
    return out[:h_loc, :wpl].contiguous()


def ext_launch(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int
) -> torch.Tensor:
    """K9: ``turns`` generations of a halo-extended (h_loc + 2·pad,
    wpl + 2·xpad) block of packed words, returning its (h_loc, wpl) centre
    in a fresh tensor; the input is never written.  A CPU tensor runs
    :func:`ext_launch_plain`; a CUDA tensor launches K9 or raises."""
    _check_words(ext)
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    if ext.device.type == "cpu":
        return ext_launch_plain(ext, rule, turns, pad, xpad)
    tiles = ext_tiles((h_loc, wpl), turns)
    lib = cuda_build.load("ext")
    born, surv = rule_masks(rule)
    out = torch.empty((h_loc, wpl), dtype=torch.int32, device=ext.device)
    with torch.cuda.device(ext.device):
        err = lib.gol_ext_launch(
            ctypes.c_void_p(ext.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            h_loc, wpl, pad, xpad, turns, tiles.tile_h, tiles.tile_w,
            ctypes.c_uint(born), ctypes.c_uint(surv), _stream(ext),
        )
    cuda_build.check(lib, err, "ext")
    ext_launch.launches += 1
    return out


ext_launch.launches = 0


def reset_launches() -> None:
    """Set K9's launch counter to 0."""
    ext_launch.launches = 0


# -- the drivers ------------------------------------------------------------------


def _refuse_skip_stable(skip_stable: bool) -> None:
    if skip_stable:
        raise NotImplementedError(
            "skip_stable on a mesh: the sharded adaptive tier is not ported "
            "yet (ROADMAP B8-B12)"
        )


def make_superstep(mesh: Mesh, rule: LifeRule = CONWAY, skip_stable: bool = False):
    """``(packed ShardedBoard, turns) -> packed ShardedBoard`` on the mesh:
    the launches of :func:`launch_plan`, each one exchange
    (``halo.extend``: rows on a row mesh, the counterpart of
    ``_extend_rows``; rows then word columns on a 2-D mesh, of
    ``_extend_tile_2d``) plus one K9 launch per shard into a fresh output
    shard."""
    _refuse_skip_stable(skip_stable)
    mesh_shape = (mesh.shape["y"], mesh.shape["x"])

    def run(board: ShardedBoard, turns: int) -> ShardedBoard:
        for plan in launch_plan(board.shard_shape, mesh_shape, turns):
            ext = extend(board, plan.pad, plan.xpad)
            board = ShardedBoard(board.mesh, [
                [ext_launch(e, rule, plan.t, plan.pad, plan.xpad) for e in row] for row in ext
            ])
        return board

    return run


def make_superstep_bytes(mesh: Mesh, rule: LifeRule = CONWAY, skip_stable: bool = False):
    """``(uint8 ShardedBoard, turns) -> uint8 ShardedBoard``: each shard
    packed and unpacked on its own device around :func:`make_superstep`."""
    inner = make_superstep(mesh, rule, skip_stable)

    def run(board: ShardedBoard, turns: int) -> ShardedBoard:
        if not turns:
            return board
        return inner(board.map(packed.pack), turns).map(packed.unpack)

    return run
