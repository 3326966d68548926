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

``skip_stable`` on a row mesh (``(ny, 1)``) runs the adaptive strip tier,
the counterpart of ``make_superstep(skip_stable=True)``'s ppermute form:

- :func:`adaptive_strip_plan` is the one plan decision, shared by
  :func:`make_superstep`, the skip fraction's denominator (:func:`adaptive_strip_launches`)
  and the tier record (:func:`tier_policy`): the port's own adaptive plan
  (``cuda_adaptive.adaptive_plan``) on the strip, its launch depth lowered
  until the probe halo fits in one stripe.
- The full launches of a dispatch run K12 (``csrc/frontier.cu``,
  :func:`strip_frontier_launch`; replaces ``_ext_kernel_frontier``) where
  the plan has a frontier form, else K11 (``csrc/probing.cu``,
  :func:`strip_probing_launch`; replaces ``_ext_kernel_adaptive``); a
  strip with no plan runs K10 (``csrc/ext.cu``, :func:`ext_skip_launch`;
  replaces ``_ext_kernel``'s skip form) on every launch.  The
  period-multiple part of the remainder is one K10 launch and the last
  < 6 generations one K9 launch.
- Between launches the exchange (``halo.edge_rows``, :func:`edge_flags`,
  :func:`edge_intervals`) hands each strip its neighbours' boundary rows,
  their edge stripes' skip flags (K11) or tracked row intervals shifted
  into its row frame (K12).  Each strip keeps two buffers, and a launch
  writes the one of two launches ago (write elision).

``skip_stable`` on a 2-D mesh (``(ny, nx)``, nx > 1) runs the adaptive
tile tier, the counterpart of ``make_superstep``'s ``_run_2d`` on its
ppermute tier:

- :func:`adaptive_tile_plan` is its one plan decision: the strip plan at
  the tile's height, and an x-halo of ``xpad`` = ceil((T + 6) / 32) words
  (:func:`probe_xpad`).
- The full launches run K13 (``csrc/probing.cu``,
  :func:`tile_probing_launch`; replaces ``_ext_kernel_adaptive_2d``) on
  each tile pre-extended by ``halo.extend`` (rows, then columns, so the
  corners ride along), with the 3x3 elision of :func:`tile_elision`; a
  tile with no plan runs K10 on every launch.  The remainders run K10
  and K9 at ``xpad`` = ceil(T / 32), as on a row mesh.

The in-kernel exchange tiers are not ported (ROADMAP B10 on a row mesh,
B12 on a 2-D mesh): the tier is always "ppermute".
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule
from distributed_gol_torch.ops import cuda_adaptive, cuda_build, cuda_packed, packed
from distributed_gol_torch.ops.cuda_adaptive import (
    _EMPTY_LO, _I, _P, _U, SKIP_PERIOD, AdaptivePlan, _adaptive_eligible, _launcher, skip_plan)
from distributed_gol_torch.ops.cuda_packed import (
    SMEM_BYTES, TILED_COLS, TILED_MAX_T, TiledPlan, _check_words, _stream, rule_masks)
from distributed_gol_torch.ops.packed import WORD
from distributed_gol_torch.parallel.halo import ShardedBoard, edge_rows, extend, psum
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


# -- the adaptive strip plan (pure Python) ----------------------------------------


# The plan of a ``skip_stable`` dispatch on a packed (h_loc, wp) strip, the
# counterpart of ``_adaptive_strip_plan`` (and of ``_strip_plan_tile``: the
# stripes are the plan's): the port's one plan rule, whose probe halo
# round8(T) fits in one stripe, so the halo lies within the adjacent strip
# too.  The one decision of :func:`make_superstep`, the skip fraction's
# denominator and the tier record on a row mesh; tests replace it to put
# the port on the JAX plan.
adaptive_strip_plan = cuda_adaptive.adaptive_plan


def probe_xpad(t: int) -> int:
    """Words of x-halo a side for a probing launch of ``t`` generations on
    a 2-D tile: the fewest with T + 6 <= 32·xpad, the JAX plan's x-depth
    rule (``_x_depth_cap``).  K13's windows read the extended tile's
    columns modulo its width, as the JAX kernel's lane rotate does; that
    wrap puts wrong cells at the extended tile's x edges, which spread one
    cell a generation, so T generations and the probe's 6 must stay
    within the halo for the probe to see only what the JAX kernel sees
    and for the centre to be exact."""
    return -(-(t + SKIP_PERIOD) // WORD)


def adaptive_tile_plan(
    tile: tuple[int, int], turns: int, cap: int = 0
) -> tuple[AdaptivePlan, int] | None:
    """(plan, xpad) of a ``skip_stable`` dispatch of ``turns`` generations
    on a packed (h_loc, wpl) tile of a 2-D mesh, the counterpart of
    ``_adaptive_plan_2d`` with ``_plan_tile_2d`` and ``_xpad_words``: the
    strip plan at the tile's height (:func:`adaptive_strip_plan`) and
    :func:`probe_xpad` of its depth.  None when the tile has no adaptive
    plan, or its width is below the x-halo.  The one decision of the 2-D
    branch of :func:`make_superstep`, its skip fraction's denominator and
    its tier record."""
    plan = adaptive_strip_plan(tile, turns, cap)
    if plan is None or probe_xpad(plan.t) > tile[1]:
        return None
    return plan, probe_xpad(plan.t)


def skip_launch_depth(strip: tuple[int, int], turns: int) -> tuple[int, bool]:
    """(T, skip form?) of the full launches of a ``skip_stable`` dispatch
    on a strip with no adaptive plan: K9's depth min(turns, 32, h_loc)
    rounded down to a multiple of 6 (K10) where it is at least 6, else as
    it is (K9)."""
    return skip_plan(max(1, min(turns, EXT_MAX_T, strip[0])))


def adaptive_strip_launches(
    pshape: tuple[int, int], mesh_shape: tuple[int, int], turns: int, cap: int = 0
) -> int:
    """How many stripe-launches an adaptive dispatch of ``turns``
    generations performs across all strips of a row mesh, or all
    (stripe, x-tile) cells of a 2-D mesh: the skip fraction's denominator,
    from the plan the dispatch runs (the remainder launches are excluded,
    as in the JAX package's ``adaptive_strip_launches``).  0 without a
    plan."""
    ny, nx = mesh_shape
    if not supports(pshape, mesh_shape):
        return 0
    h_loc = pshape[0] // ny
    if nx > 1:
        tp = adaptive_tile_plan((h_loc, pshape[1] // nx), turns, cap)
        plan = tp[0] if tp else None
    else:
        plan = adaptive_strip_plan((h_loc, pshape[1]), turns, cap)
    if plan is None:
        return 0
    return (turns // plan.t) * ny * nx * plan.grid(h_loc)


# The JAX package's reason for its ppermute tier on a mesh of several
# interpret-mode devices (``ici_tier_policy``): the port's CPU shards
# report it, so that the two packages' run records agree.
INTERPRET_REASON = (
    "interpret-mode multi-device: no remote-DMA emulation "
    "(hermetic coverage runs the loopback/virtual builds — "
    "make_superstep_virtual_2d emulates (ny, nx) on one device; "
    "hardware lowering is gated by tools/hw_compile_gate.py)"
)


def tier_policy(mesh: Mesh, strip: tuple[int, int] | None = None, tile_cap: int = 0
                ) -> tuple[bool, str]:
    """Whether a ``skip_stable`` run on ``mesh`` takes the in-kernel
    exchange tier, with the reason when it does not; the counterpart of
    ``ici_tier_policy``, whose reasons it copies.  The in-kernel tiers are
    not ported (ROADMAP B10 on a row mesh, B12 on a 2-D mesh), so the
    answer is always False: a strip or tile with no frontier plan says so,
    as the JAX package does (on a 2-D mesh the plan of
    :func:`adaptive_tile_plan`, whose x-halo always covers T + 6: the
    geometry the 2-D megakernel will ride); then ``DGOL_ICI=0``; then a
    mesh of CPU shards gives the JAX package's interpret-mode reason, and
    a mesh on the card says that the tier is not ported."""
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    if strip is not None:
        if nx == 1:
            plan = adaptive_strip_plan(strip, 10**6, tile_cap)
        else:
            plan = (adaptive_tile_plan(strip, 10**6, tile_cap) or (None,))[0]
        if plan is None or not plan.frontier:
            return False, (
                f"no frontier plan for tile {strip} on ({ny}, {nx}): the "
                "in-kernel tier rides the frontier megakernel (ppermute "
                "probing/plain forms run instead)"
            )
    if os.environ.get("DGOL_ICI", "").lower() in ("0", "off", "false"):
        return False, "forced-ppermute (DGOL_ICI=0)"
    if ny * nx > 1 and all(d.type == "cpu" for d in mesh.flat):
        return False, INTERPRET_REASON
    if nx > 1:
        return False, (
            "in-kernel exchange tier not ported (ROADMAP B12): the ppermute "
            "tile form runs, its exchange by tensor copies"
        )
    return False, (
        "in-kernel exchange tier not ported (ROADMAP B10): the ppermute "
        "strip form runs, its exchange by tensor copies"
    )


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


def _ext_windows(ext: torch.Tensor, turns: int, pad: int, xpad: int,
                 tiles: TiledPlan | None):
    """Every K9 tile's window gathered as ``load_ext_window`` does (rows as
    they are, columns modulo the width when xpad = 0, zero outside the
    block): (windows (ny, nx, rows, cols), tiles, (ny, nx), (h_loc, wpl))."""
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
    return win, tiles, (ny, nx), (h_loc, wpl)


def _stitch(win: torch.Tensor, turns: int, tiles: TiledPlan, centre: tuple[int, int]):
    """The (h_loc, wpl) centre from every tile's window at generation
    ``turns``."""
    ny, nx = win.shape[:2]
    c = win[:, :, turns : turns + tiles.tile_h, tiles.xpad : tiles.xpad + tiles.tile_w]
    out = c.permute(0, 2, 1, 3).reshape(ny * tiles.tile_h, nx * tiles.tile_w)
    return out[: centre[0], : centre[1]].contiguous()


def ext_launch_mirror(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int,
    tiles: TiledPlan | None = None,
) -> torch.Tensor:
    """K9's exact window decomposition in PyTorch: every tile's window
    gathered as ``load_ext_window`` does (rows as they are, columns modulo
    the width when xpad = 0, zero outside the block), stepped with
    zero-filled window edges, its centre stored.  ``tiles`` forces the
    tiling (tests); None takes :func:`ext_tiles`."""
    win, tiles, _, centre = _ext_windows(ext, turns, pad, xpad, tiles)
    for _ in range(turns):
        win = cuda_packed._window_gen(win, rule)
    return _stitch(win, turns, tiles, centre)


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


# -- K10: the skip form of K9 ------------------------------------------------------

# The skip proof's inner region of a window word row: all 32 cells but
# the first six of its first word and the last six of its last word
# (window.cuh::inner_stable's masks, as int32).
_FIRST_WORD_INNER = 0xFFFFFFC0 - (1 << 32)
_LAST_WORD_INNER = 0x03FFFFFF


def _check_skip_turns(turns: int) -> None:
    if not _adaptive_eligible(turns):
        raise ValueError(f"skip launches need a positive multiple of {SKIP_PERIOD} turns, "
                         f"got {turns}")


def ext_skip_launch_plain(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int
) -> torch.Tensor:
    """Plain version of K10: K9's plain version (the skip proof is exact,
    so a launch with it computes the same centre)."""
    _check_skip_turns(turns)
    return ext_launch_plain(ext, rule, turns, pad, xpad)


def _ext_skip_probe(ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int,
                    tiles: TiledPlan | None):
    """K10's skip proof in PyTorch: K9's windows, each stepped 6
    generations and compared with itself at generation 0 on its inner
    region (rows and cells at least 6 from its edge).  Returns (windows at
    generation 0, at generation 6, bool (ny, nx) stable, tiles, centre)."""
    _check_skip_turns(turns)
    win0, tiles, _, centre = _ext_windows(ext, turns, pad, xpad, tiles)
    win = win0
    for _ in range(SKIP_PERIOD):
        win = cuda_packed._window_gen(win, rule)
    diff = (win ^ win0)[:, :, SKIP_PERIOD : win.shape[2] - SKIP_PERIOD]
    mask = torch.full(diff.shape[-1:], -1, dtype=torch.int32, device=ext.device)
    mask[0] &= _FIRST_WORD_INNER
    mask[-1] &= _LAST_WORD_INNER
    stable = ((diff & mask) == 0).flatten(2).all(dim=2)
    return win0, win, stable, tiles, centre


def ext_skip_stable_tiles(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int
) -> torch.Tensor:
    """bool (tile rows, tile columns): the tiles of a K10 launch whose skip
    proof holds, which keep their input centre instead of computing (the
    work a launch on this block needs, for its bound)."""
    return _ext_skip_probe(ext, rule, turns, pad, xpad, None)[2]


def ext_skip_launch_mirror(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int,
    tiles: TiledPlan | None = None,
) -> torch.Tensor:
    """K10's arithmetic in PyTorch: K9's windows through the skip proof; a
    window that holds it keeps its input centre, any other steps on to
    ``turns``."""
    win0, win, stable, tiles, centre = _ext_skip_probe(ext, rule, turns, pad, xpad, tiles)
    for _ in range(turns - SKIP_PERIOD):
        win = cuda_packed._window_gen(win, rule)
    win = torch.where(stable[:, :, None, None], win0, win)
    return _stitch(win, turns, tiles, centre)


def ext_skip_launch(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int
) -> torch.Tensor:
    """K10: K9's launch with the skip proof, ``turns`` a positive multiple
    of 6; returns the centre in a fresh tensor, the input never written.
    A CPU tensor runs :func:`ext_skip_launch_plain`; a CUDA tensor
    launches K10 or raises."""
    _check_words(ext)
    _check_skip_turns(turns)
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    if ext.device.type == "cpu":
        return ext_skip_launch_plain(ext, rule, turns, pad, xpad)
    tiles = ext_tiles((h_loc, wpl), turns)
    lib, launch = _launcher("ext", "gol_ext_skip_launch", [_P, _P] + [_I] * 7 + [_U, _U, _P])
    born, surv = rule_masks(rule)
    out = torch.empty((h_loc, wpl), dtype=torch.int32, device=ext.device)
    with torch.cuda.device(ext.device):
        err = launch(ext.data_ptr(), out.data_ptr(), h_loc, wpl, pad, xpad, turns,
                     tiles.tile_h, tiles.tile_w, born, surv, _stream(ext))
    cuda_build.check(lib, err, "ext_skip")
    ext_skip_launch.launches += 1
    return out


ext_skip_launch.launches = 0


def _check_strip(local: torch.Tensor, north: torch.Tensor, south: torch.Tensor,
                 dst: torch.Tensor, halo: int) -> None:
    """Raise unless the strip, its neighbour rows and its write buffer are
    contiguous int32 words of one width on one device, with at least
    ``halo`` neighbour rows, and the buffer is the strip's shape."""
    for t in (local, north, south, dst):
        _check_words(t)
        if t.device != local.device or t.shape[1] != local.shape[1]:
            raise ValueError("a strip's tensors must share its device and width")
    if dst.shape != local.shape or north.shape != south.shape or north.shape[0] < halo:
        raise ValueError(
            f"strip {tuple(local.shape)}: write buffer {tuple(dst.shape)}, neighbour rows "
            f"{tuple(north.shape)} and {tuple(south.shape)} (at least {halo} needed)"
        )
    if dst.data_ptr() == local.data_ptr():
        raise ValueError("a strip launch cannot write the strip it reads")


def _extended(local: torch.Tensor, north: torch.Tensor, south: torch.Tensor,
              halo: int) -> torch.Tensor:
    """The strip with ``halo`` neighbour rows above and below."""
    return torch.cat([north[north.shape[0] - halo :], local, south[:halo]])


# -- K11: the probing strip launch --------------------------------------------------


def strip_probing_launch_plain(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, st: torch.Tensor, rule: LifeRule, plan: AdaptivePlan,
) -> torch.Tensor:
    """Plain version of K11 (``_ext_kernel_adaptive``) on one strip:
    stripe i elides when entries i, i + 1 and i + 2 of ``prev_ext`` (the
    previous bitmap with the neighbour strips' edge flags at both ends)
    are all 1, leaving its rows of ``dst`` (the strip of two launches
    ago) as they are; otherwise it probes rows [6, stripe_h + 2·pad - 6)
    of its window (the strip with ``pad`` = round8(T) rows of ``north``
    and ``south``) and writes its input when they are period-6 stable,
    else its gen-T rows.  Writes ``dst`` and this launch's bitmap ``st``;
    returns ``dst``."""
    h = local.shape[0]
    sh, pad = plan.stripe_h, plan.pad
    grid = plan.grid(h)
    dev = local.device
    was = prev_ext.bool()
    elide = was[:-2] & was[1:-1] & was[2:]
    e = _extended(local, north, south, pad)
    g6 = packed.superstep(e, rule, SKIP_PERIOD)
    moved = (g6 != e).any(dim=1)
    probe_rows = (torch.arange(grid, device=dev)[:, None] * sh + SKIP_PERIOD
                  + torch.arange(sh + 2 * pad - 2 * SKIP_PERIOD, device=dev)[None, :])
    stable = ~moved[probe_rows].any(dim=1)
    g_t = packed.superstep(g6, rule, plan.t - SKIP_PERIOD)[pad : pad + h]
    of = torch.arange(h, device=dev) // sh
    dst.copy_(torch.where(elide[of, None], dst, torch.where(stable[of, None], local, g_t)))
    st.copy_((elide | stable).to(torch.int32))
    return dst


def strip_probing_launch(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, st: torch.Tensor, rule: LifeRule, plan: AdaptivePlan,
) -> torch.Tensor:
    """K11: one probing launch of ``plan.t`` generations on a strip of a
    row mesh, writing ``dst`` (the strip's buffer of two launches ago) and
    the int32[grid] bitmap ``st`` (all ones on entry); returns ``dst``.
    ``north``/``south`` hold at least round8(T) neighbour rows, and
    ``prev_ext`` is the previous bitmap extended with the neighbours' edge
    flags (int32[grid + 2]).  A CPU tensor runs
    :func:`strip_probing_launch_plain`; a CUDA tensor launches K11 or
    raises."""
    h, wp = local.shape
    grid = plan.grid(h)
    _check_strip(local, north, south, dst, plan.pad)
    if plan.pad > plan.stripe_h or h % plan.stripe_h:
        raise ValueError(f"plan {plan} does not fit a strip of {h} rows")
    if prev_ext.shape != (grid + 2,) or st.shape != (grid,):
        raise ValueError(f"bitmaps {tuple(prev_ext.shape)}, {tuple(st.shape)} for {grid} stripes")
    if local.device.type == "cpu":
        return strip_probing_launch_plain(local, north, south, dst, prev_ext, st, rule, plan)
    tiles = cuda_adaptive.stripe_tiles((h, wp), plan.stripe_h, plan.pad)
    lib, launch = _launcher("probing", "gol_strip_probing_launch",
                            [_P] * 6 + [_I] * 9 + [_U, _U, _P])
    born, surv = rule_masks(rule)
    err = launch(local.data_ptr(), north.data_ptr(), south.data_ptr(), dst.data_ptr(),
                 prev_ext.data_ptr(), st.data_ptr(), h, wp, north.shape[0], plan.t,
                 plan.stripe_h, tiles.tile_h, tiles.tile_w, tiles.xpad, tiles.t, born, surv,
                 _stream(local))
    cuda_build.check(lib, err, "strip_probing")
    strip_probing_launch.launches += 1
    return dst


strip_probing_launch.launches = 0


# -- K12: the frontier strip launch -------------------------------------------------


@dataclasses.dataclass
class FrontierState:
    """One strip's frontier state over a dispatch, on its device: the
    previous and the current launch's int32 (5, grid) state (rows lo0,
    hi0, lo1, hi1 in the strip's row frame, and whether the stripe
    computed), the kernel's row flags, and the skip count and per-stripe
    activity accumulated over the dispatch's launches."""

    prev: torch.Tensor
    cur: torch.Tensor
    rowflag: torch.Tensor
    skipped: torch.Tensor
    act: torch.Tensor

    @classmethod
    def start(cls, h_loc: int, plan: AdaptivePlan, device) -> "FrontierState":
        """The state before a dispatch's first launch: every stripe's own
        rows as its interval (so every stripe computes and measures), as
        the JAX package's make_superstep starts it."""
        lo = torch.arange(plan.grid(h_loc), dtype=torch.int32, device=device) * plan.stripe_h
        prev = torch.stack([lo, lo + plan.stripe_h - 1, torch.full_like(lo, _EMPTY_LO),
                            torch.full_like(lo, -1), torch.ones_like(lo)])
        return cls(prev, torch.empty_like(prev), torch.zeros(h_loc, dtype=torch.int32, device=device),
                   torch.zeros(1, dtype=torch.int32, device=device), torch.zeros_like(lo))

    def advance(self) -> None:
        """After a launch: its state becomes the previous one."""
        self.prev, self.cur = self.cur, self.prev


def strip_frontier_launch_plain(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, state: FrontierState, rule: LifeRule, plan: AdaptivePlan,
) -> torch.Tensor:
    """Plain version of K12 (``_ext_kernel_frontier``) on one strip:
    ``_hit_union`` over ``prev_ext`` (the previous launch's row intervals
    of the strip's stripes, int32[4][grid + 2], the neighbour strips' edge
    stripes at both ends, in this strip's frame); a stripe that hits
    computes T generations of its window (the strip with T + 6 rows of
    ``north`` and ``south``) and measures gen T + 6 against gen T on its
    measure rows (``_measure2``); one that does not skips, copying its
    input into ``dst`` if it computed last launch.  Writes ``dst`` and
    ``state.cur``, adds to ``state.skipped`` and ``state.act``; returns
    ``dst``."""
    h = local.shape[0]
    sh = plan.stripe_h
    grid = plan.grid(h)
    dev = local.device
    halo = plan.t + SKIP_PERIOD
    idx = torch.arange(grid, device=dev)
    c_lo = idx * sh
    c_hi = c_lo + sh - 1
    ext = prev_ext.to(torch.int64)
    ivals = [(ext[2 * k][idx + 1 + slot], ext[2 * k + 1][idx + 1 + slot])
             for slot in (-1, 0, 1) for k in (0, 1)]
    hit, m_lo, m_hi = cuda_adaptive.hit_union(ivals, c_lo, c_hi, plan)
    e = _extended(local, north, south, halo)
    g_t = packed.superstep(e, rule, plan.t)
    g_t6 = packed.superstep(g_t, rule, SKIP_PERIOD)[halo : halo + h]
    g_t = g_t[halo : halo + h]
    rows = torch.arange(h, device=dev)
    of = rows // sh
    hot = (g_t6 != g_t).any(dim=1) & hit[of] & (rows >= m_lo[of]) & (rows <= m_hi[of])
    intervals = cuda_adaptive.measure2(hot.view(grid, sh), rows.view(grid, sh))
    copy = ~hit & state.prev[4].bool()
    dst.copy_(torch.where(hit[of, None], g_t, torch.where(copy[of, None], local, dst)))
    state.cur.copy_(torch.cat([intervals, hit[None].to(intervals.dtype)]))
    state.skipped += (~hit).sum().to(torch.int32)
    state.act += (intervals[0] <= intervals[1]).to(torch.int32)
    return dst


def strip_frontier_launch(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, state: FrontierState, rule: LifeRule, plan: AdaptivePlan,
) -> torch.Tensor:
    """K12: one frontier launch of ``plan.t`` generations on a strip of a
    row mesh, writing ``dst`` (the strip's buffer of two launches ago) and
    ``state.cur``, accumulating ``state.skipped`` and ``state.act``;
    returns ``dst``.  ``north``/``south`` hold at least T + 6 neighbour
    rows.  A CPU tensor runs :func:`strip_frontier_launch_plain`; a CUDA
    tensor launches K12 or raises."""
    h, wp = local.shape
    grid = plan.grid(h)
    _check_strip(local, north, south, dst, plan.t + SKIP_PERIOD)
    if not plan.frontier or h % plan.stripe_h:
        raise ValueError(f"plan {plan} has no frontier form on a strip of {h} rows")
    if prev_ext.shape != (4, grid + 2) or state.prev.shape != (5, grid):
        raise ValueError(f"frontier state {tuple(prev_ext.shape)}, {tuple(state.prev.shape)} "
                         f"for {grid} stripes")
    if local.device.type == "cpu":
        return strip_frontier_launch_plain(local, north, south, dst, prev_ext, state, rule, plan)
    tiles = cuda_adaptive.stripe_tiles((h, wp), plan.stripe_h, plan.t + SKIP_PERIOD)
    lib, launch = _launcher("frontier", "gol_strip_frontier_launch",
                            [_P] * 10 + [_I] * 10 + [_U, _U, _P])
    born, surv = rule_masks(rule)
    err = launch(local.data_ptr(), north.data_ptr(), south.data_ptr(), dst.data_ptr(),
                 prev_ext.data_ptr(), state.prev[4].data_ptr(), state.cur.data_ptr(),
                 state.rowflag.data_ptr(), state.skipped.data_ptr(), state.act.data_ptr(),
                 h, wp, north.shape[0], plan.t, plan.stripe_h, tiles.tile_h, tiles.tile_w,
                 tiles.xpad, tiles.t, plan.pad_f, born, surv, _stream(local))
    cuda_build.check(lib, err, "strip_frontier")
    strip_frontier_launch.launches += 1
    return dst


strip_frontier_launch.launches = 0


# -- K13: the probing tile launch ---------------------------------------------------


def _check_tile(ext: torch.Tensor, elig: torch.Tensor, dst: torch.Tensor, st: torch.Tensor,
                plan: AdaptivePlan, xpad: int) -> tuple[int, int]:
    """(h_loc, wpl) of a K13 launch's pre-extended tile, after checking the
    launch: int32 words on one device, a centre of whole stripes whose
    probe halo fits one stripe, an x-halo within the tile holding T + 6
    cells, a write buffer of the centre's shape that is not the input,
    and bitmaps of one entry a stripe."""
    for t, ndim in ((ext, 2), (elig, 1), (dst, 2), (st, 1)):
        _check_words(t, ndim)
        if t.device != ext.device:
            raise ValueError("a tile launch's tensors must share one device")
    h_loc, wpl = ext.shape[0] - 2 * plan.pad, ext.shape[1] - 2 * xpad
    if (h_loc < 1 or wpl < 1 or h_loc % plan.stripe_h or plan.pad > plan.stripe_h
            or not 1 <= xpad <= wpl or plan.t + SKIP_PERIOD > WORD * xpad):
        raise ValueError(f"plan {plan} with xpad {xpad} does not fit the extended tile "
                         f"{tuple(ext.shape)}: need whole stripes of at least round8(T) rows "
                         "and 1 <= xpad <= wpl with T + 6 <= 32 * xpad")
    grid = plan.grid(h_loc)
    if dst.shape != (h_loc, wpl) or elig.shape != (grid,) or st.shape != (grid,):
        raise ValueError(f"tile {h_loc}x{wpl} with {grid} stripes: write buffer "
                         f"{tuple(dst.shape)}, bitmaps {tuple(elig.shape)}, {tuple(st.shape)}")
    if dst.data_ptr() == ext.data_ptr():
        raise ValueError("a tile launch cannot write the block it reads")
    return h_loc, wpl


def tile_probing_launch_plain(
    ext: torch.Tensor, elig: torch.Tensor, dst: torch.Tensor, st: torch.Tensor, rule: LifeRule,
    plan: AdaptivePlan, xpad: int,
) -> torch.Tensor:
    """Plain version of K13 (``_ext_kernel_adaptive_2d``) on one tile:
    ``ext`` is the tile pre-extended by pad = round8(T) rows and ``xpad``
    words a side.  Stripe i elides when ``elig[i]`` is 1, leaving its rows
    of ``dst`` (the tile of two launches ago) as they are; otherwise its
    window (extended rows [i·stripe_h, i·stripe_h + stripe_h + 2·pad), the
    whole extended width, columns wrapping modulo it as the JAX kernel's
    lane rotate does) is stepped 6 generations and compared with itself
    on rows [6, stripe_h + 2·pad - 6) and every column; a stable stripe
    writes its input centre, any other its gen-T centre.  Writes ``dst``
    and this launch's bitmap ``st``; returns ``dst``."""
    h, wpl = _check_tile(ext, elig, dst, st, plan, xpad)
    sh, pad = plan.stripe_h, plan.pad
    dev = ext.device
    g6 = packed.superstep(ext, rule, SKIP_PERIOD)
    moved = (g6 != ext).any(dim=1)
    probe_rows = (torch.arange(plan.grid(h), device=dev)[:, None] * sh + SKIP_PERIOD
                  + torch.arange(sh + 2 * pad - 2 * SKIP_PERIOD, device=dev)[None, :])
    stable = ~moved[probe_rows].any(dim=1)
    centre = (slice(pad, pad + h), slice(xpad, xpad + wpl))
    g_t = packed.superstep(g6, rule, plan.t - SKIP_PERIOD)[centre]
    elide = elig.bool()
    of = torch.arange(h, device=dev) // sh
    dst.copy_(torch.where(elide[of, None], dst,
                          torch.where(stable[of, None], ext[centre], g_t)))
    st.copy_((elide | stable).to(torch.int32))
    return dst


def tile_probing_launch_mirror(
    ext: torch.Tensor, elig: torch.Tensor, dst: torch.Tensor, st: torch.Tensor, rule: LifeRule,
    plan: AdaptivePlan, xpad: int, tiles: TiledPlan | None = None,
) -> torch.Tensor:
    """K13's window decomposition in PyTorch: K4's blocks
    (``cuda_adaptive.stripe_tiles`` over the extended width; ``tiles``
    forces them) tile the extended tile's centre rows and its whole
    width; each window (the block with pad rows and ``tiles.xpad`` words
    a side, columns modulo the extended width, zero past its edges) is
    stepped 6 generations and compared with its input on its inner region
    (rows and cells at least 6 from its edge); a block that agrees keeps
    its input, any other steps on to T, and only centre columns are
    stored.  A stripe's flag is the AND of its blocks'; an eligible stripe
    does nothing.  Writes ``dst`` and ``st``; returns ``dst``."""
    h, wpl = _check_tile(ext, elig, dst, st, plan, xpad)
    pad, wpe = plan.pad, wpl + 2 * xpad
    tiles = tiles or cuda_adaptive.stripe_tiles((h, wpe), plan.stripe_h, pad)
    xw = tiles.xpad
    dev = ext.device
    ny, nx = h // tiles.tile_h, -(-wpe // tiles.tile_w)
    rows = (torch.arange(ny, device=dev)[:, None] * tiles.tile_h
            + torch.arange(tiles.tile_h + 2 * pad, device=dev))
    cols = torch.remainder(torch.arange(nx, device=dev)[:, None] * tiles.tile_w - xw
                           + torch.arange(tiles.tile_w + 2 * xw, device=dev), wpe)
    win0 = ext[rows[:, None, :, None], cols[None, :, None, :]]
    win = win0
    for _ in range(SKIP_PERIOD):
        win = cuda_packed._window_gen(win, rule)
    diff = (win ^ win0)[:, :, SKIP_PERIOD : win.shape[2] - SKIP_PERIOD]
    mask = torch.full(diff.shape[-1:], -1, dtype=torch.int32, device=dev)
    mask[0] &= _FIRST_WORD_INNER
    mask[-1] &= _LAST_WORD_INNER
    block_stable = ((diff & mask) == 0).flatten(2).all(dim=2)
    for _ in range(plan.t - SKIP_PERIOD):
        win = cuda_packed._window_gen(win, rule)
    win = torch.where(block_stable[:, :, None, None], win0, win)
    c = win[:, :, pad : pad + tiles.tile_h, xw : xw + tiles.tile_w]
    out = c.permute(0, 2, 1, 3).reshape(ny * tiles.tile_h, nx * tiles.tile_w)[:, xpad : xpad + wpl]
    stable = block_stable.view(plan.grid(h), -1).all(dim=1)
    elide = elig.bool()
    of = torch.arange(h, device=dev) // plan.stripe_h
    dst.copy_(torch.where(elide[of, None], dst, out))
    st.copy_((elide | stable).to(torch.int32))
    return dst


def tile_probing_launch(
    ext: torch.Tensor, elig: torch.Tensor, dst: torch.Tensor, st: torch.Tensor, rule: LifeRule,
    plan: AdaptivePlan, xpad: int,
) -> torch.Tensor:
    """K13: one probing launch of ``plan.t`` generations on a tile of a
    2-D mesh, pre-extended by pad = round8(T) rows and ``xpad`` words a
    side (``halo.extend``), writing ``dst`` (the tile's buffer of two
    launches ago) and the int32[grid] bitmap ``st`` (all ones on entry);
    returns ``dst``.  ``elig`` (int32[grid]) is this launch's elision, the
    3x3 conjunction of :func:`tile_elision`.  A CPU tensor runs
    :func:`tile_probing_launch_plain`; a CUDA tensor launches K13 or
    raises."""
    h_loc, wpl = _check_tile(ext, elig, dst, st, plan, xpad)
    if ext.device.type == "cpu":
        return tile_probing_launch_plain(ext, elig, dst, st, rule, plan, xpad)
    tiles = cuda_adaptive.stripe_tiles((h_loc, wpl + 2 * xpad), plan.stripe_h, plan.pad)
    lib, launch = _launcher("probing", "gol_tile_probing_launch",
                            [_P] * 4 + [_I] * 9 + [_U, _U, _P])
    born, surv = rule_masks(rule)
    err = launch(ext.data_ptr(), dst.data_ptr(), elig.data_ptr(), st.data_ptr(), h_loc, wpl,
                 xpad, plan.t, plan.stripe_h, tiles.tile_h, tiles.tile_w, tiles.xpad, plan.pad,
                 born, surv, _stream(ext))
    cuda_build.check(lib, err, "tile_probing")
    tile_probing_launch.launches += 1
    return dst


tile_probing_launch.launches = 0


def reset_launches() -> None:
    """Set the launch counters of K9, K10, K11, K12 and K13 to 0."""
    ext_launch.launches = 0
    ext_skip_launch.launches = 0
    strip_probing_launch.launches = 0
    strip_frontier_launch.launches = 0
    tile_probing_launch.launches = 0


# -- the drivers ------------------------------------------------------------------


def edge_flags(flags: list[torch.Tensor]) -> list[torch.Tensor]:
    """The flag exchange of K11: each strip's bitmap (top to bottom)
    extended with its north neighbour's last flag and its south
    neighbour's first, on its own device (int32[grid + 2])."""
    ny = len(flags)
    return [torch.cat([flags[(i - 1) % ny][-1:].to(f.device), f,
                       flags[(i + 1) % ny][:1].to(f.device)]) for i, f in enumerate(flags)]


def edge_intervals(states: list[torch.Tensor], h_loc: int) -> list[torch.Tensor]:
    """The interval exchange of K12: each strip's row intervals (rows 0-3
    of its (5, grid) state) extended with its north neighbour's last
    stripe, shifted by -h_loc into this strip's row frame, and its south
    neighbour's first, shifted by +h_loc (int32[4][grid + 2]).  An empty
    interval (lo > hi) stays empty: both ends move by the same offset."""
    ny = len(states)
    return [torch.cat([states[(i - 1) % ny][:4, -1:].to(s.device) - h_loc, s[:4],
                       states[(i + 1) % ny][:4, :1].to(s.device) + h_loc], dim=1)
            for i, s in enumerate(states)]


def probing_launches(strips, rule, plan, nlaunch, launch=None):
    """``nlaunch`` K11 launches on every strip from a zero bitmap (launch
    0 probes every stripe), each strip writing its buffer of two launches
    ago (the second starts as a copy of the input, which is never
    written).  Returns (strips, skipped, activity): the stable flags after
    each launch summed, and per stripe the launches it was not proved
    stable, in top-to-bottom order.  ``launch`` replaces the wrapper
    (:func:`strip_probing_launch_plain`: the plain dispatch on any
    device)."""
    launch = launch or strip_probing_launch
    grid = plan.grid(strips[0].shape[0])
    flags = []
    for t in strips:
        f = torch.ones((nlaunch + 1, grid), dtype=torch.int32, device=t.device)
        f[0] = 0
        flags.append(f)
    bufs = [(torch.empty_like(t), t.clone()) for t in strips]
    for k in range(nlaunch):
        rows = edge_rows(strips, plan.pad)
        exts = edge_flags([f[k] for f in flags])
        strips = [launch(t, n, s, b[k % 2], e, f[k + 1], rule, plan)
                  for t, (n, s), b, e, f in zip(strips, rows, bufs, exts, flags)]
    stats = [cuda_adaptive._probing_stats(f[1:]) for f in flags]
    return strips, psum(sk for sk, _ in stats), torch.cat([a.to(stats[0][1].device)
                                                           for _, a in stats])


def frontier_launches(strips, rule, plan, nlaunch, launch=None):
    """``nlaunch`` K12 launches on every strip, the first from full
    intervals, each strip writing its buffer of two launches ago.  Returns
    (strips, skipped, activity) as :func:`probing_launches` does;
    ``launch`` replaces the wrapper (:func:`strip_frontier_launch_plain`)."""
    launch = launch or strip_frontier_launch
    h_loc = strips[0].shape[0]
    states = [FrontierState.start(h_loc, plan, t.device) for t in strips]
    bufs = [(torch.empty_like(t), torch.empty_like(t)) for t in strips]
    for k in range(nlaunch):
        rows = edge_rows(strips, plan.pad_f)
        exts = edge_intervals([st.prev for st in states], h_loc)
        strips = [launch(t, n, s, b[k % 2], e, st, rule, plan)
                  for t, (n, s), b, e, st in zip(strips, rows, bufs, exts, states)]
        for st in states:
            st.advance()
    dev = states[0].act.device
    return (strips, psum(st.skipped[0] for st in states),
            torch.cat([st.act.to(dev) for st in states]))


def tile_elision(flags: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
    """The flag exchange of K13 on an (ny, nx) grid of tiles' bitmaps:
    each tile's bitmap extended with its y-neighbours' edge flags
    (:func:`edge_flags` down each mesh column), the vertical triple AND,
    then the AND with both x-neighbours' triples, whose edge flags bring
    the corners (``make_superstep``'s ``step`` in the JAX package).  Each
    result (int32[grid], 1 where the stripe and its eight neighbours were
    stable) lies on its tile's device.  On a torus axis of 1 or 2 tiles a
    neighbour is the tile itself or the same tile on both sides."""
    ny, nx = len(flags), len(flags[0])
    cols = [edge_flags([flags[iy][ix] for iy in range(ny)]) for ix in range(nx)]
    v3 = [[e[:-2] & e[1:-1] & e[2:] for e in (cols[ix][iy] for ix in range(nx))]
          for iy in range(ny)]
    return [[v & v3[iy][(ix - 1) % nx].to(v.device) & v3[iy][(ix + 1) % nx].to(v.device)
             for ix, v in enumerate(row)] for iy, row in enumerate(v3)]


def tile_probing_launches(board: ShardedBoard, rule, plan: AdaptivePlan, xpad: int,
                          nlaunch: int, launch=None):
    """``nlaunch`` K13 launches on every tile of a 2-D mesh from a zero
    bitmap (launch 0 probes every stripe), each launch one exchange
    (``halo.extend`` by round8(T) rows and ``xpad`` words) and one launch a
    tile writing its buffer of two launches ago (the second starts as a
    copy of the input, which is never written).  Returns (board, skipped,
    activity): the stable flags after each launch summed over every
    (stripe, x-tile) cell, and int32 (ny·grid, nx), the launches each cell
    was not proved stable, stripes top to bottom and tiles left to right
    (the JAX package's 2-D activity grid).  ``launch`` replaces the
    wrapper (:func:`tile_probing_launch_plain`: the plain dispatch on any
    device)."""
    launch = launch or tile_probing_launch
    grid = plan.grid(board.shard_shape[0])
    flags, bufs = [], []
    for row in board.shards:
        flags.append([torch.ones((nlaunch + 1, grid), dtype=torch.int32, device=t.device)
                      for t in row])
        bufs.append([(torch.empty_like(t), t.clone()) for t in row])
    for row in flags:
        for f in row:
            f[0] = 0
    for k in range(nlaunch):
        exts = extend(board, plan.pad, xpad)
        elig = tile_elision([[f[k] for f in row] for row in flags])
        board = ShardedBoard(board.mesh, [
            [launch(e, el, b[k % 2], f[k + 1], rule, plan, xpad)
             for e, el, b, f in zip(*cells)]
            for cells in zip(exts, elig, bufs, flags)
        ])
    stats = [[cuda_adaptive._probing_stats(f[1:]) for f in row] for row in flags]
    dev = stats[0][0][1].device
    act = torch.stack([torch.cat([row[ix][1].to(dev) for row in stats])
                       for ix in range(len(stats[0]))], dim=1)
    return board, psum(sk for row in stats for sk, _ in row), act


def _ext_step(board: ShardedBoard, rule: LifeRule, turns: int, launch) -> ShardedBoard:
    """One exchange of ``turns`` rows (and on a 2-D mesh ceil(turns / 32)
    word columns) and one ``launch`` (K9 or K10, or a plain version) per
    shard."""
    xpad = -(-turns // WORD) if len(board.shards[0]) > 1 else 0
    return ShardedBoard(board.mesh, [[launch(e, rule, turns, turns, xpad) for e in row]
                                     for row in extend(board, turns, xpad)])


def make_superstep(mesh: Mesh, rule: LifeRule = CONWAY, skip_stable: bool = False,
                   skip_tile_cap: int = 0, with_stats: bool = False):
    """``(packed ShardedBoard, turns) -> packed ShardedBoard`` on the mesh;
    with ``with_stats``, ``(board, skipped, activity)``.

    Without ``skip_stable``: the launches of :func:`launch_plan`, each one
    exchange (``halo.extend``: rows on a row mesh, the counterpart of
    ``_extend_rows``; rows then word columns on a 2-D mesh, of
    ``_extend_tile_2d``) plus one K9 launch per shard into a fresh output
    shard.

    With ``skip_stable`` (``skip_tile_cap`` bounds the stripe height, 0 =
    the port's default): on a row mesh the full launches of
    :func:`adaptive_strip_plan` on K12 or K11, on a 2-D mesh those of
    :func:`adaptive_tile_plan` on K13 (K10 on a strip or tile with no
    plan), then one K10 launch for the period-multiple part of the
    remainder and one K9 launch for the rest.  ``skipped`` (an int32 0-d
    tensor) counts the stripe-launches skipped or proved stable over all
    shards, and ``activity`` the launches each stripe was active, as the
    JAX package's ``with_stats`` does: int32[ny·grid] top to bottom on a
    row mesh, the (ny·grid, nx) grid of (stripe, x-tile) cells on a 2-D
    mesh, empty when no adaptive launch ran."""
    mesh_shape = (mesh.shape["y"], mesh.shape["x"])

    two_d = mesh_shape[1] > 1

    def k9_only(board: ShardedBoard, turns: int) -> ShardedBoard:
        for plan in launch_plan(board.shard_shape, mesh_shape, turns):
            ext = extend(board, plan.pad, plan.xpad)
            board = ShardedBoard(board.mesh, [
                [ext_launch(e, rule, plan.t, plan.pad, plan.xpad) for e in row] for row in ext
            ])
        return board

    def adaptive(board: ShardedBoard, turns: int):
        skipped, act = _no_stats(board)
        if two_d:
            plan, xpad = adaptive_tile_plan(board.shard_shape, turns, skip_tile_cap) or (None, 0)
        else:
            plan = adaptive_strip_plan(board.shard_shape, turns, skip_tile_cap)
        if plan is None:
            t, skip = skip_launch_depth(board.shard_shape, turns)
            full, rem = divmod(turns, t)
            for _ in range(full):
                board = _ext_step(board, rule, t, ext_skip_launch if skip else ext_launch)
        elif two_d:
            full, rem = divmod(turns, plan.t)
            board, skipped, act = tile_probing_launches(board, rule, plan, xpad, full)
        else:
            full, rem = divmod(turns, plan.t)
            strips = [row[0] for row in board.shards]
            if plan.frontier:
                strips, skipped, act = frontier_launches(strips, rule, plan, full)
            else:
                strips, skipped, act = probing_launches(strips, rule, plan, full)
            board = ShardedBoard(board.mesh, [[t] for t in strips])
        rem6 = rem - rem % SKIP_PERIOD
        if rem6:
            board = _ext_step(board, rule, rem6, ext_skip_launch)
        if rem > rem6:
            board = _ext_step(board, rule, rem - rem6, ext_launch)
        return board, skipped, act

    def run(board: ShardedBoard, turns: int):
        if not skip_stable:
            board = k9_only(board, turns)
            return (board, *_no_stats(board)) if with_stats else board
        out = adaptive(board, turns)
        return out if with_stats else out[0]

    return run


def _no_stats(board: ShardedBoard) -> tuple[torch.Tensor, torch.Tensor]:
    """(skipped, activity) of a dispatch with no adaptive launch."""
    dev = board.shards[0][0].device
    return (torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev))


def make_superstep_bytes(mesh: Mesh, rule: LifeRule = CONWAY, skip_stable: bool = False,
                         skip_tile_cap: int = 0, with_stats: bool = False):
    """``(uint8 ShardedBoard, turns) -> uint8 ShardedBoard`` (with
    ``with_stats``, plus the skip count and the activity of
    :func:`make_superstep`): each shard packed and unpacked on its own
    device around :func:`make_superstep`."""
    inner = make_superstep(mesh, rule, skip_stable, skip_tile_cap, with_stats)

    def run(board: ShardedBoard, turns: int):
        if not turns:
            return (board, *_no_stats(board)) if with_stats else board
        out = inner(board.map(packed.pack), turns)
        if with_stats:
            return (out[0].map(packed.unpack), *out[1:])
        return out.map(packed.unpack)

    return run
