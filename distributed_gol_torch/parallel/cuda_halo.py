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
  mesh, then one remainder launch; K9's blocks are
  :func:`ext_reg_plan`'s (register-resident runs, ``csrc/regwin.cuh``),
  sized to fill the device's SMs.  The TPU's
  ``launch_turns``, ``_tile_for_pad``, ``_LAUNCH_COST`` and
  ``_xpad_words`` are v5e ratios and are not carried over.
- :func:`ext_launch` is K9's wrapper with its launch counter; a CPU tensor
  runs :func:`ext_launch_plain`, a CUDA tensor launches K9 or raises.
  :func:`ext_launch_mirror` replays K9's decomposition in PyTorch
  (blocks, runs, light-cone trimming).

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

``skip_stable`` on a row mesh whose strips all lie on one device takes
the in-kernel exchange tier where :func:`tier_policy` allows it (the
counterpart of ``make_superstep``'s in-kernel branch and of
``_kernel_frontier_mega_strip``): the full launches run in canonical
chunks (``_nlaunch_chunks``), each launch one K14 launch over every strip
(``csrc/frontier.cu``, :func:`strip_mega_launches`), whose windows read
the neighbour strips' rows and whose edge stripes read the neighbours'
intervals in place, with no exchange between launches; the loose tail
runs K11 from a zero bitmap, the remainders K10 and K9.  A 2-D mesh whose
tiles share one device takes the same tier (the counterpart of
``_kernel_frontier_mega_2d``): canonical chunks of K15 launches over every
tile (:func:`tile_mega_chunks`), whose windows read the neighbour tiles'
rows, words and corners and whose stripes decide from their own and both
x-neighbours' intervals, the edge stripes from their 3x3-tile
neighbourhood (the JAX kernel forces them; one proved stable is elided,
counted as computed); a K13 loose tail; :func:`make_superstep_virtual_2d`
runs it on a whole board.  K12, K14 and K15 step register-resident
windows (``csrc/regwin.cuh``) on the blocks of
``cuda_adaptive.frontier_blocks``; :func:`strip_frontier_launch_mirror`,
:func:`strip_mega_launch_mirror` and :func:`tile_mega_launch_mirror`
replay those blocks, and K15's elision, in PyTorch.  K13 and K11 share one
register probing block (``csrc/probing.cu::probe_reg_block``, K4's too) on
the blocks of ``cuda_adaptive.stripe_reg_plan`` (:func:`tile_reg_plan`,
:func:`strip_reg_plan`); :func:`tile_probing_launch_mirror` and
:func:`strip_probing_launch_mirror` replay them
(``cuda_adaptive._probing_blocks``).
The peer form for shards on several devices (ROADMAP B10p) is not
ported: those meshes take the ppermute forms.

A row mesh that spans processes (``parallel/multihost.py``) takes the
ppermute forms too (:func:`tier_policy`): each process launches K9-K12 on
its own strips, and the exchanges of :func:`edge_flags`,
:func:`edge_intervals` and ``halo.edge_rows`` take the band's end edges
from the neighbouring ranks; the skip count is summed and the activity
gathered over the ranks.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule
from distributed_gol_torch.ops import cuda_adaptive, cuda_build, cuda_packed, packed
from distributed_gol_torch.ops.cuda_adaptive import (
    _EMPTY_LO, H100_SMS, REG_LANES, REG_MAX_WARPS, REG_RULES, REG_RUN, SKIP_PERIOD,
    _FIRST_WORD_INNER, _LAST_WORD_INNER, AdaptivePlan, RegPlan, _adaptive_eligible,
    _check_frontier_blocks, _frontier_blocks, _probing_blocks, _reg_launcher, _reg_steps,
    _reg_stitch, _reg_windows, best_reg_plan, device_sms, frontier_blocks, reg_rule, skip_plan)
from distributed_gol_torch.ops.cuda_packed import TILED_MAX_T, _check_words, _stream
from distributed_gol_torch.ops.packed import WORD
from distributed_gol_torch.parallel.halo import (
    ShardedBoard, edge_rows, extend, neighbour_edges, psum)
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


@functools.lru_cache(maxsize=256)
def ext_reg_plan(strip: tuple[int, int], t: int, sms: int) -> RegPlan:
    """K9's blocks for a ``t``-generation launch on an (h_loc, wpl) centre
    (``csrc/regwin.cuh``): of ``cuda_adaptive.torus_reg_plans``' column
    groups of 32 - 2·border centre words and, for each block height of 1
    to ``REG_MAX_WARPS`` warps, the tallest tile it holds evened over the
    centre's rows, the grid of least :meth:`RegPlan.cost` on ``sms`` SMs:
    the fewest, fullest waves of the least work."""
    return best_reg_plan(cuda_adaptive.torus_reg_plans(strip, t), sms)


@functools.lru_cache(maxsize=256)
def ext_skip_plan(strip: tuple[int, int], t: int, sms: int) -> RegPlan:
    """K10's blocks for a ``t``-generation launch (a multiple of 6) on an
    (h_loc, wpl) centre: K9's (:func:`ext_reg_plan`) with the probe after 6
    generations, for each block height of 1 to ``REG_MAX_WARPS`` warps the
    tallest tile it holds, no taller than the centre, evened over its rows;
    of those the grid of least :meth:`RegPlan.cost` on ``sms`` SMs.  The
    kernel shifts the last row tile up and the last column group left to
    end at the centre's edge (:func:`ext_skip_origins`), so no window reads
    past the extended block where the block is a window wide."""
    h_loc, wpl = strip
    border = -(-t // WORD)
    if t < SKIP_PERIOD or t % SKIP_PERIOD or 2 * border >= REG_LANES:
        raise ValueError(f"no K10 window for {t} generations")
    cols = -(-wpl // (REG_LANES - 2 * border))
    plans = set()
    for warps in range(1, REG_MAX_WARPS + 1):
        tallest = min(warps * REG_RUN - 2 * t, h_loc)
        if tallest < 1:
            continue
        tile_h = -(-h_loc // -(-h_loc // tallest))
        plans.add(RegPlan(t, t, tile_h, -(-(tile_h + 2 * t) // REG_RUN),
                          (-(-h_loc // tile_h), cols), border, SKIP_PERIOD))
    if not plans:
        raise ValueError(f"no K10 window for {t} generations: {REG_MAX_WARPS} warps of "
                         f"{REG_RUN} rows")
    return best_reg_plan(sorted(plans, key=lambda p: p.tile_h), sms)


def ext_skip_origins(plan: RegPlan, strip: tuple[int, int]) -> tuple[list[int], list[int]]:
    """(first centre row of each row tile, first centre word of each
    column group) of a K10 launch of ``plan`` on an (h_loc, wpl) centre:
    tile after tile, the last shifted to end at the centre's edge (a
    centre narrower than a group has one group, from word 0)."""
    h_loc, wpl = strip
    if plan.tile_h > h_loc:
        raise ValueError(f"plan {plan} has tiles taller than the {h_loc}-row centre")
    ys = [min(by * plan.tile_h, h_loc - plan.tile_h) for by in range(plan.grid[0])]
    xs = [min(bx * plan.centre, max(wpl - plan.centre, 0)) for bx in range(plan.grid[1])]
    return ys, xs


@dataclasses.dataclass(frozen=True)
class ExtPlan:
    """One sharded launch: an exchange of ``pad`` rows and ``xpad`` word
    columns per side, then K9 advancing each extended shard ``t``
    generations (its blocks: :func:`ext_reg_plan`)."""

    t: int
    pad: int
    xpad: int

    def halo_bytes(self, strip: tuple[int, int]) -> int:
        """Bytes one shard receives in the exchange: its pad rows and its
        xpad columns of the row-extended block."""
        h_loc, wpl = strip
        return 4 * (2 * self.pad * wpl + 2 * self.xpad * (h_loc + 2 * self.pad))


def _plan_for(nx: int, t: int) -> ExtPlan:
    return ExtPlan(t, t, -(-t // WORD) if nx > 1 else 0)


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
    launches = [_plan_for(nx, t)] * full
    if rem:
        launches.append(_plan_for(nx, rem))
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


# The JAX package's reasons for its ppermute tier on a mesh of several
# interpret-mode devices and on a mesh that spans processes
# (``ici_tier_policy``): the port reports them where they hold, so that
# the two packages' run records agree.
INTERPRET_REASON = (
    "interpret-mode multi-device: no remote-DMA emulation "
    "(hermetic coverage runs the loopback/virtual builds — "
    "make_superstep_virtual_2d emulates (ny, nx) on one device; "
    "hardware lowering is gated by tools/hw_compile_gate.py)"
)
MULTIHOST_REASON = (
    "multi-host mesh: the exchange crosses DCN, remote DMA is "
    "ICI-only (parallel/multihost.py keeps the ppermute form)"
)


def tier_policy(mesh: Mesh, strip: tuple[int, int] | None = None, tile_cap: int = 0,
                in_kernel: bool | None = None) -> tuple[bool, str]:
    """Whether a ``skip_stable`` run on ``mesh`` takes the in-kernel
    exchange tier, with the reason when it does not; the counterpart of
    ``ici_tier_policy``, whose order of checks and reasons it copies.
    ``in_kernel=False`` forces the ppermute form; ``in_kernel=True``
    outranks ``DGOL_ICI=0`` but no capability.  ``strip`` (the shard's
    packed (h_loc, wpl), with ``tile_cap``) also checks that the shard
    hosts a frontier plan (on a 2-D mesh the plan of
    :func:`adaptive_tile_plan`, the geometry the 2-D megakernel will
    ride).  A mesh of several CPU shards gives the JAX package's
    interpret-mode reason, so the two packages' CPU records agree.  A
    mesh that spans processes gives the JAX package's multi-host reason,
    whatever cards its strips sit on: the in-kernel tier reads neighbours
    in place, in memory this process does not hold.  Then the port's own
    limit: strips or tiles on several CUDA devices (B10p: the peer form
    is not ported).  Every other mesh takes the tier: a
    (1, 1) mesh on any device (the loopback form) and a row or 2-D mesh
    whose shards share one card."""
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    if in_kernel is False:
        return False, "forced-ppermute (in_kernel=False)"
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
    if in_kernel is not True and os.environ.get("DGOL_ICI", "").lower() in ("0", "off", "false"):
        return False, "forced-ppermute (DGOL_ICI=0)"
    if ny * nx > 1 and all(d.type == "cpu" for d in mesh.flat):
        return False, INTERPRET_REASON
    if ny * nx > 1 and mesh.spans_ranks:
        return False, MULTIHOST_REASON
    cards = {(d.type, d.index or 0) for d in mesh.flat}
    if len(cards) > 1:
        shards, form = ("tiles", "tile") if nx > 1 else ("strips", "strip")
        return False, (
            "the in-kernel tier's peer form is not ported (ROADMAP B10p): "
            f"{shards} on {len(cards)} devices need peer copies and a "
            f"cross-device barrier between launches; the ppermute {form} form "
            "runs, its exchange by tensor copies"
        )
    return True, "in-kernel"


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
    plan: RegPlan | None = None,
) -> torch.Tensor:
    """K9's decomposition in PyTorch: the blocks of ``plan`` (None: the
    :func:`ext_reg_plan` of an H100), each window (warps·32 rows from T
    rows above its tile, 32 words from ``border`` left of its column group;
    rows as they are, columns modulo the width when xpad = 0, zero outside
    the block and past the window) stepped T generations with its columns
    wrapping within it and only the rows each run's light cone steps
    (:meth:`RegPlan.live`), its centre stored."""
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    plan = plan or ext_reg_plan((h_loc, wpl), turns, H100_SMS)
    if (plan.t, plan.halo) != (turns, turns) or plan.grid[0] * plan.tile_h < h_loc \
            or plan.grid[1] * plan.centre < wpl:
        raise ValueError(f"plan {plan} does not cover a {turns}-generation launch on "
                         f"{h_loc}x{wpl}")
    win = _reg_windows(ext, plan, pad - turns, xpad - plan.border, xpad == 0)
    win = _reg_steps(win, rule, plan, range(1, turns + 1))
    return _reg_stitch(win, plan)[:h_loc, :wpl].contiguous()


def ext_launch(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int
) -> torch.Tensor:
    """K9: ``turns`` generations of a halo-extended (h_loc + 2·pad,
    wpl + 2·xpad) block of packed words, returning its (h_loc, wpl) centre
    in a fresh tensor; the input is never written.  A CPU tensor runs
    :func:`ext_launch_plain`; a CUDA tensor launches K9 on the blocks of
    :func:`ext_reg_plan` for its device's SMs, in the rule's instantiation
    (counted in ``ext_launch.rules``), or raises."""
    _check_words(ext)
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    if ext.device.type == "cpu":
        return ext_launch_plain(ext, rule, turns, pad, xpad)
    plan = ext_reg_plan((h_loc, wpl), turns, device_sms(ext.device))
    lib, launch = _reg_launcher("ext", "gol_ext_launch", 2)
    born, surv, variant = reg_rule(rule)
    out = torch.empty((h_loc, wpl), dtype=torch.int32, device=ext.device)
    with torch.cuda.device(ext.device):
        err = launch(ext.data_ptr(), out.data_ptr(), h_loc, wpl, pad, xpad, turns, plan.tile_h,
                     plan.warps, plan.border, variant, born, surv, _stream(ext))
    cuda_build.check(lib, err, "ext")
    ext_launch.launches += 1
    ext_launch.rules[REG_RULES[variant]] += 1
    return out


ext_launch.launches = 0
ext_launch.rules = collections.Counter()


# -- K10: the skip form of K9 ------------------------------------------------------

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


def _ext_skip_blocks(ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int,
                     plan: RegPlan | None):
    """K10's blocks through the skip proof in PyTorch: each window of
    ``plan`` (None: :func:`ext_skip_plan` on an H100) at the origins of
    :func:`ext_skip_origins` (rows as they are, columns modulo the width
    when xpad = 0, zero outside the block and past the window), stepped 6
    generations (:meth:`RegPlan.live`) and compared with itself at
    generation 0 on its inner region: rows at least 6 from its edge, cells
    at least 6 from its x edge and, at xpad > 0, from the block's.
    Returns (windows at generation 6, bool (nby, nbx) stable, plan,
    origins)."""
    _check_skip_turns(turns)
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    plan = plan or ext_skip_plan((h_loc, wpl), turns, H100_SMS)
    if ((plan.t, plan.halo, plan.probe) != (turns, turns, SKIP_PERIOD)
            or (xpad and plan.border > xpad) or plan.grid[0] * plan.tile_h < h_loc
            or plan.grid[1] * plan.centre < wpl):
        raise ValueError(f"plan {plan} is not a K10 launch of {turns} generations on "
                         f"{h_loc}x{wpl} at xpad {xpad}")
    ys, xs = ext_skip_origins(plan, (h_loc, wpl))
    rows_in, cols_in = ext.shape
    dev = ext.device
    r = torch.arange(plan.warps * REG_RUN, device=dev)
    rows = pad - turns + torch.tensor(ys, device=dev)[:, None] + r
    cols = (xpad - plan.border + torch.tensor(xs, device=dev)[:, None]
            + torch.arange(REG_LANES, device=dev))
    if xpad == 0:
        cols = torch.remainder(cols, cols_in)
    row_ok = (rows >= 0) & (rows < rows_in) & (r < plan.rows)
    col_ok = (cols >= 0) & (cols < cols_in)
    win0 = ext[rows.clamp(0, rows_in - 1)[:, None, :, None],
               cols.clamp(0, cols_in - 1)[None, :, None, :]]
    win0 = win0 * (row_ok[:, None, :, None] & col_ok[None, :, None, :])
    win = _reg_steps(win0, rule, plan, range(1, SKIP_PERIOD + 1))
    mask = torch.full(cols.shape, -1, dtype=torch.int32, device=dev)
    mask[:, 0] &= _FIRST_WORD_INNER
    mask[:, -1] &= _LAST_WORD_INNER
    if xpad:
        mask = torch.where(col_ok, mask, 0)
        mask = torch.where(cols == 0, mask & _FIRST_WORD_INNER, mask)
        mask = torch.where(cols == cols_in - 1, mask & _LAST_WORD_INNER, mask)
    diff = (win ^ win0)[:, :, SKIP_PERIOD : plan.rows - SKIP_PERIOD] & mask[None, :, None, :]
    stable = (diff == 0).flatten(2).all(dim=2)
    return win, stable, plan, (ys, xs)


def ext_skip_stable_tiles(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int,
    plan: RegPlan | None = None,
) -> torch.Tensor:
    """bool (row tiles, column groups): the blocks of a K10 launch of
    ``plan`` (None: :func:`ext_skip_plan` on an H100) whose skip proof
    holds, which compute no generation past the probe."""
    return _ext_skip_blocks(ext, rule, turns, pad, xpad, plan)[1]


def ext_skip_launch_mirror(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int,
    plan: RegPlan | None = None,
) -> torch.Tensor:
    """K10's decomposition in PyTorch: its blocks through the skip proof
    (:func:`ext_skip_stable_tiles`); a block that holds it keeps its window
    at generation 6, any other steps on to ``turns``; each block's centre
    is stored at its origin, the overlaps of the shifted last tiles
    written twice."""
    win, stable, plan, (ys, xs) = _ext_skip_blocks(ext, rule, turns, pad, xpad, plan)
    win = _reg_steps(win, rule, plan, range(SKIP_PERIOD + 1, turns + 1), frozen=stable)
    h_loc, wpl = ext.shape[0] - 2 * pad, ext.shape[1] - 2 * xpad
    dev = ext.device
    centre = win[:, :, turns : turns + plan.tile_h, plan.border : REG_LANES - plan.border]
    rows = torch.tensor(ys, device=dev)[:, None] + torch.arange(plan.tile_h, device=dev)
    cols = torch.tensor(xs, device=dev)[:, None] + torch.arange(plan.centre, device=dev)
    rr = rows[:, None, :, None].expand_as(centre)
    cc = cols[None, :, None, :].expand_as(centre)
    keep = cc < wpl
    out = torch.empty((h_loc, wpl), dtype=ext.dtype, device=dev)
    out[rr[keep], cc[keep]] = centre[keep]
    return out


def ext_skip_launch(
    ext: torch.Tensor, rule: LifeRule, turns: int, pad: int, xpad: int
) -> torch.Tensor:
    """K10: the skip proof on the blocks of :func:`ext_skip_plan` for the
    device's SMs, ``turns`` a positive multiple of 6; returns the centre in
    a fresh tensor, the input never written.  A CPU tensor runs
    :func:`ext_skip_launch_plain`; a CUDA tensor launches K10 in the rule's
    instantiation (counted in ``ext_skip_launch.rules``) or raises, and
    leaves the blocks' decisions (int (row tiles, column groups), 1 where
    the proof held) in ``ext_skip_launch.last_stable``."""
    _check_words(ext)
    _check_skip_turns(turns)
    h_loc, wpl = _centre(ext, turns, pad, xpad)
    if ext.device.type == "cpu":
        return ext_skip_launch_plain(ext, rule, turns, pad, xpad)
    plan = ext_skip_plan((h_loc, wpl), turns, device_sms(ext.device))
    lib, launch = _reg_launcher("ext", "gol_ext_skip_launch", 3)
    born, surv, variant = reg_rule(rule)
    out = torch.empty((h_loc, wpl), dtype=torch.int32, device=ext.device)
    stable = torch.empty(plan.grid, dtype=torch.int32, device=ext.device)
    with torch.cuda.device(ext.device):
        err = launch(ext.data_ptr(), out.data_ptr(), stable.data_ptr(), h_loc, wpl, pad, xpad,
                     turns, plan.tile_h, plan.warps, plan.border, variant, born, surv,
                     _stream(ext))
    cuda_build.check(lib, err, "ext_skip")
    ext_skip_launch.launches += 1
    ext_skip_launch.rules[REG_RULES[variant]] += 1
    ext_skip_launch.last_stable = stable
    return out


ext_skip_launch.launches = 0
ext_skip_launch.rules = collections.Counter()
ext_skip_launch.last_stable = None


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


def _check_strip_probing(local: torch.Tensor, north: torch.Tensor, south: torch.Tensor,
                         dst: torch.Tensor, prev_ext: torch.Tensor, st: torch.Tensor,
                         plan: AdaptivePlan) -> None:
    """Raise unless a K11 launch of ``plan`` fits the strip: whole stripes
    of at least round8(T) rows, that many neighbour rows, and bitmaps of
    grid + 2 and grid entries."""
    h = local.shape[0]
    grid = plan.grid(h)
    _check_strip(local, north, south, dst, plan.pad)
    if plan.pad > plan.stripe_h or h % plan.stripe_h:
        raise ValueError(f"plan {plan} does not fit a strip of {h} rows")
    if prev_ext.shape != (grid + 2,) or st.shape != (grid,):
        raise ValueError(f"bitmaps {tuple(prev_ext.shape)}, {tuple(st.shape)} for {grid} stripes")


def _elide(prev_ext: torch.Tensor) -> torch.Tensor:
    """K11's elision: stripe i elides where entries i, i + 1 and i + 2 of
    the previous bitmap extended with the neighbour strips' edge flags are
    all 1."""
    was = prev_ext.bool()
    return was[:-2] & was[1:-1] & was[2:]


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
    elide = _elide(prev_ext)
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


def strip_reg_plan(plan: AdaptivePlan, strip: tuple[int, int], sms: int) -> RegPlan:
    """K11's blocks for a launch of ``plan`` on an (h, wp) strip:
    K4's plan (:func:`cuda_adaptive.probing_reg_plan`) over the strip's
    width (no x-halo: its columns wrap modulo wp), a block within one
    stripe or spanning up to ``REG_PROBE_STRIPES`` whole ones: path (g)'s 16-row
    stripes with a 16-row halo take 8 a block, whose 160-row window
    steps 14 rows for each of its 128 where a stripe's own 48-row window
    steps 29 for each of its 16."""
    return cuda_adaptive.probing_reg_plan(plan, strip, sms)


def strip_probing_launch_mirror(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, st: torch.Tensor, rule: LifeRule, plan: AdaptivePlan,
    blocks: RegPlan | None = None,
) -> torch.Tensor:
    """K11's decomposition in PyTorch: K13's blocks (:func:`_probing_blocks`)
    on the strip with round8(T) rows of ``north`` and ``south`` a side and
    no x-halo, its columns wrapping modulo wp (the true torus), on the
    blocks of ``blocks`` (None: the :func:`strip_reg_plan` of an H100); the
    elision of :func:`strip_probing_launch_plain`.  Writes ``dst`` and
    ``st``; returns ``dst``."""
    _check_strip_probing(local, north, south, dst, prev_ext, st, plan)
    h, wp = local.shape
    blocks = blocks or strip_reg_plan(plan, (h, wp), H100_SMS)
    elide = _elide(prev_ext)
    out, stable = _probing_blocks(_extended(local, north, south, plan.pad), rule, plan, 0, blocks,
                                  elide)
    of = torch.arange(h, device=local.device) // plan.stripe_h
    dst.copy_(torch.where(elide[of, None], dst, out))
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
    :func:`strip_probing_launch_plain`; a CUDA tensor launches K11 on the
    blocks of :func:`strip_reg_plan` for its device's SMs, in the rule's
    instantiation (counted in ``strip_probing_launch.rules``), or
    raises."""
    _check_strip_probing(local, north, south, dst, prev_ext, st, plan)
    if local.device.type == "cpu":
        return strip_probing_launch_plain(local, north, south, dst, prev_ext, st, rule, plan)
    h, wp = local.shape
    blocks = strip_reg_plan(plan, (h, wp), device_sms(local.device))
    lib, launch = _reg_launcher("probing", "gol_strip_probing_launch", 6)
    born, surv, variant = reg_rule(rule)
    err = launch(local.data_ptr(), north.data_ptr(), south.data_ptr(), dst.data_ptr(),
                 prev_ext.data_ptr(), st.data_ptr(), h, wp, north.shape[0], plan.t,
                 plan.stripe_h, blocks.tile_h, blocks.warps, plan.pad, variant, born, surv,
                 _stream(local))
    cuda_build.check(lib, err, "strip_probing")
    strip_probing_launch.launches += 1
    strip_probing_launch.rules[REG_RULES[variant]] += 1
    return dst


strip_probing_launch.launches = 0
strip_probing_launch.rules = collections.Counter()


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


def _strip_frontier(local, north, south, dst, prev_ext, state: FrontierState, plan: AdaptivePlan,
                    advance) -> torch.Tensor:
    """One K12 launch's decision, measure and bookkeeping in PyTorch, its
    generations from ``advance(e, hit)``: (gen T, gen T + 6) of the
    strip's rows, from ``e``, the strip with T + 6 rows of ``north`` and
    ``south`` a side (the rows of stripes that do not ``hit`` unused)."""
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
    g_t, g_t6 = advance(_extended(local, north, south, halo), hit)
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
    halo, h = plan.t + SKIP_PERIOD, local.shape[0]

    def advance(e, _hit):
        g_t = packed.superstep(e, rule, plan.t)
        return g_t[halo : halo + h], packed.superstep(g_t, rule, SKIP_PERIOD)[halo : halo + h]

    return _strip_frontier(local, north, south, dst, prev_ext, state, plan, advance)


def strip_frontier_launch_mirror(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, state: FrontierState, rule: LifeRule, plan: AdaptivePlan,
    blocks: RegPlan | None = None,
) -> torch.Tensor:
    """K12's decomposition in PyTorch: the decision and bookkeeping of
    :func:`strip_frontier_launch_plain`, the generations on the blocks of
    ``blocks`` (None: the ``frontier_blocks`` of an H100) through
    :func:`_frontier_blocks`, the strip's words wrapping modulo its
    width."""
    h, wp = local.shape
    blocks = blocks or frontier_blocks((h, wp), plan)
    _check_frontier_blocks(blocks, plan, (h, wp))
    cols = torch.remainder(torch.arange(blocks.grid[1] * blocks.centre + 2) - 1, wp)

    def advance(e, hit):
        return _frontier_blocks(e[:, cols.to(e.device)], rule, blocks, plan.t, (h, wp), hit)

    return _strip_frontier(local, north, south, dst, prev_ext, state, plan, advance)


def strip_frontier_launch(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, state: FrontierState, rule: LifeRule, plan: AdaptivePlan,
) -> torch.Tensor:
    """K12: one frontier launch of ``plan.t`` generations on a strip of a
    row mesh, writing ``dst`` (the strip's buffer of two launches ago) and
    ``state.cur``, accumulating ``state.skipped`` and ``state.act``;
    returns ``dst``.  ``north``/``south`` hold at least T + 6 neighbour
    rows.  A CPU tensor runs :func:`strip_frontier_launch_plain`; a CUDA
    tensor launches K12 on the blocks of ``frontier_blocks`` for its
    device's SMs, in the rule's instantiation (counted in
    ``strip_frontier_launch.rules``), or raises."""
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
    blocks = frontier_blocks((h, wp), plan, 1, device_sms(local.device))
    lib, launch = _reg_launcher("frontier", "gol_strip_frontier_launch", 10)
    born, surv, variant = reg_rule(rule)
    err = launch(local.data_ptr(), north.data_ptr(), south.data_ptr(), dst.data_ptr(),
                 prev_ext.data_ptr(), state.prev[4].data_ptr(), state.cur.data_ptr(),
                 state.rowflag.data_ptr(), state.skipped.data_ptr(), state.act.data_ptr(),
                 h, wp, north.shape[0], plan.t, plan.stripe_h, blocks.tile_h, blocks.warps,
                 plan.pad_f, variant, born, surv, _stream(local))
    cuda_build.check(lib, err, "strip_frontier")
    strip_frontier_launch.launches += 1
    strip_frontier_launch.rules[REG_RULES[variant]] += 1
    return dst


strip_frontier_launch.launches = 0
strip_frontier_launch.rules = collections.Counter()


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


def tile_reg_plan(plan: AdaptivePlan, tile: tuple[int, int], xpad: int, sms: int) -> RegPlan:
    """K13's blocks for a launch of ``plan`` on an (h_loc, wpl) tile with an
    ``xpad``-word x-halo: :func:`cuda_adaptive.stripe_reg_plan` over the
    extended width."""
    return cuda_adaptive.stripe_reg_plan((tile[0], tile[1] + 2 * xpad), plan.stripe_h, plan.pad,
                                         plan.t, sms)


def tile_probing_launch_mirror(
    ext: torch.Tensor, elig: torch.Tensor, dst: torch.Tensor, st: torch.Tensor, rule: LifeRule,
    plan: AdaptivePlan, xpad: int, blocks: RegPlan | None = None,
) -> torch.Tensor:
    """K13's decomposition in PyTorch: :func:`_probing_blocks` on the
    extended tile at the blocks of ``blocks`` (None: the
    :func:`tile_reg_plan` of an H100), whose column groups cover the whole
    extended width, columns modulo it; only centre columns are stored.  An
    eligible stripe does nothing.  Writes ``dst`` and ``st``; returns
    ``dst``."""
    h, wpl = _check_tile(ext, elig, dst, st, plan, xpad)
    blocks = blocks or tile_reg_plan(plan, (h, wpl), xpad, H100_SMS)
    if blocks.tile_h > plan.stripe_h:  # K13's blocks lie within a stripe
        raise ValueError(f"blocks {blocks} do not cover {plan} stripe by stripe")
    elide = elig.bool()
    out, stable = _probing_blocks(ext, rule, plan, xpad, blocks, elide)
    of = torch.arange(h, device=ext.device) // plan.stripe_h
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
    :func:`tile_probing_launch_plain`; a CUDA tensor launches K13 on the
    blocks of :func:`tile_reg_plan` for its device's SMs, in the rule's
    instantiation (counted in ``tile_probing_launch.rules``), or raises."""
    h_loc, wpl = _check_tile(ext, elig, dst, st, plan, xpad)
    if ext.device.type == "cpu":
        return tile_probing_launch_plain(ext, elig, dst, st, rule, plan, xpad)
    blocks = tile_reg_plan(plan, (h_loc, wpl), xpad, device_sms(ext.device))
    lib, launch = _reg_launcher("probing", "gol_tile_probing_launch", 4)
    born, surv, variant = reg_rule(rule)
    err = launch(ext.data_ptr(), dst.data_ptr(), elig.data_ptr(), st.data_ptr(), h_loc, wpl,
                 xpad, plan.t, plan.stripe_h, blocks.tile_h, blocks.warps, plan.pad, variant,
                 born, surv, _stream(ext))
    cuda_build.check(lib, err, "tile_probing")
    tile_probing_launch.launches += 1
    tile_probing_launch.rules[REG_RULES[variant]] += 1
    return dst


tile_probing_launch.launches = 0
tile_probing_launch.rules = collections.Counter()


# -- K14: the strip megakernel -------------------------------------------------------


@dataclasses.dataclass
class MeshState:
    """The frontier state of every shard of a mesh (the strips of a row
    mesh, K14, or the tiles of a 2-D mesh, K15, row-major) over one chunk
    of launches, on the shards' device: int32 (2, 5, n·grid) by launch
    parity (rows lo0, hi0, lo1, hi1 in each shard's row frame, and whether
    the stripe computed; stripe i of shard s at s·grid + i), the kernel's
    row flags (int32[n·h_loc], zero between launches), and the skip count
    of each shard (int32[n]) and the activity of each stripe
    (int32[n·grid]) accumulated over the chunk."""

    state: torch.Tensor
    rowflag: torch.Tensor
    skipped: torch.Tensor
    act: torch.Tensor

    @classmethod
    def start(cls, n: int, h_loc: int, plan: AdaptivePlan, device) -> "MeshState":
        """The state of ``n`` shards before a chunk's first launch, which
        forces every stripe to compute and so reads none of it."""
        total = n * plan.grid(h_loc)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return cls(zeros(2, 5, total), zeros(n * h_loc), zeros(n), zeros(total))


def _check_mega(reads, writes, st: MeshState, plan: AdaptivePlan) -> tuple[int, int]:
    """(ny, h_loc) of a K14 launch, after checking it: one write buffer a
    strip, all contiguous int32 words of one shape on one device, no
    buffer written twice or both read and written, a frontier plan of
    whole stripes whose decision reach round8(T + 6) fits one stripe (so
    no window or decision reaches past the adjacent strip), and state of
    the mesh's size."""
    ny = len(reads)
    if ny < 1 or len(writes) != ny:
        raise ValueError(f"a mesh launch needs one write buffer a strip: {ny} strips, "
                         f"{len(writes)} buffers")
    shape, dev = reads[0].shape, reads[0].device
    for t in (*reads, *writes):
        _check_words(t)
        if t.shape != shape or t.device != dev:
            raise ValueError("a mesh launch's strips and buffers must share one shape and device")
    out = {t.data_ptr() for t in writes}
    if len(out) != ny or out & {t.data_ptr() for t in reads}:
        raise ValueError("a mesh launch writes each buffer once and no strip it reads")
    h = shape[0]
    if not plan.frontier or h % plan.stripe_h or plan.pad_f > plan.stripe_h:
        raise ValueError(f"plan {plan} has no frontier form within one stripe of a strip of "
                         f"{h} rows: K14 reads no further than the adjacent strip")
    total = ny * plan.grid(h)
    if (st.state.shape != (2, 5, total) or st.rowflag.shape != (ny * h,)
            or st.skipped.shape != (ny,) or st.act.shape != (total,)):
        raise ValueError(f"mesh state {tuple(st.state.shape)} for {ny} strips of "
                         f"{plan.grid(h)} stripes")
    return ny, h


def _strip_mega(reads, writes, st: MeshState, plan: AdaptivePlan, parity: int, first: bool,
                advance):
    """One K14 launch's decisions, measure and bookkeeping in PyTorch, each
    strip's generations from ``advance(e, hit)``: (gen T, gen T + 6) of the
    strip's rows, from ``e``, the strip with T + 6 rows of the neighbour
    strips' read buffers a side (the rows of its stripes that do not
    ``hit`` unused)."""
    ny, h = _check_mega(reads, writes, st, plan)
    sh, grid = plan.stripe_h, plan.grid(h)
    total = ny * grid
    dev = reads[0].device
    halo = plan.t + SKIP_PERIOD
    g = torch.arange(total, device=dev)
    c_lo = g % grid * sh
    c_hi = c_lo + sh - 1
    prev = st.state[1 - parity].to(torch.int64)
    if first:
        hit = torch.ones(total, dtype=torch.bool, device=dev)
        m_lo, m_hi = c_lo, c_hi
    else:
        ivals = []
        for slot in (-1, 0, 1):
            j = g + slot
            # The neighbour's strip less this stripe's, in rows.
            off = (torch.div(j, grid, rounding_mode="floor") - g // grid) * h
            j = torch.remainder(j, total)
            ivals += [(prev[2 * k][j] + off, prev[2 * k + 1][j] + off) for k in (0, 1)]
        hit, m_lo, m_hi = cuda_adaptive.hit_union(ivals, c_lo, c_hi, plan)
    copy = ~hit & prev[4].bool()
    rows = torch.arange(h, device=dev)
    of = rows // sh
    outs, hots = [], []
    for s, local in enumerate(reads):
        mine = slice(s * grid, (s + 1) * grid)
        e = torch.cat([reads[(s - 1) % ny][h - halo :], local, reads[(s + 1) % ny][:halo]])
        g_t, g_t6 = advance(e, hit[mine])
        hit_s = hit[mine][of]
        hots.append(((g_t6 != g_t).any(dim=1) & hit_s & (rows >= m_lo[mine][of])
                     & (rows <= m_hi[mine][of])).view(grid, sh))
        outs.append(torch.where(hit_s[:, None], g_t,
                                torch.where(copy[mine][of, None], local, writes[s])))
    intervals = cuda_adaptive.measure2(torch.cat(hots), rows.view(grid, sh).repeat(ny, 1))
    for w, o in zip(writes, outs):
        w.copy_(o)
    st.state[parity].copy_(torch.cat([intervals, hit[None].to(intervals.dtype)]))
    st.skipped += (~hit).view(ny, grid).sum(dim=1).to(torch.int32)
    st.act += (intervals[0] <= intervals[1]).to(torch.int32)
    return writes


def strip_mega_launch_plain(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                            parity: int, first: bool):
    """Plain version of K14 (one launch of ``_kernel_frontier_mega_strip``
    over every strip of a row mesh, ``reads`` top to bottom): stripe i of
    strip s decides with ``_hit_union`` over the previous parity's row
    intervals of stripes i - 1, i and i + 1, read straight from the shared
    state (past the strip's edge the neighbour strip's edge stripe, moved
    by -/+ h_loc into this strip's frame), or with ``first`` (launch 0 of a
    chunk) hits with the maximal union; a stripe that hits computes T
    generations of its window (the strip with T + 6 rows of the
    neighbour strips' read buffers) and measures gen T + 6 against gen T
    on its measure rows (``_measure2``); one that does not copies its
    input into ``writes[s]`` if it computed last launch.  Writes
    ``writes`` and ``st.state[parity]``, adds to ``st.skipped`` and
    ``st.act``; returns ``writes``."""
    halo, h = plan.t + SKIP_PERIOD, reads[0].shape[0]

    def advance(e, _hit):
        g_t = packed.superstep(e, rule, plan.t)
        return g_t[halo : halo + h], packed.superstep(g_t, rule, SKIP_PERIOD)[halo : halo + h]

    return _strip_mega(reads, writes, st, plan, parity, first, advance)


def strip_mega_launch_mirror(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                             parity: int, first: bool, blocks: RegPlan | None = None):
    """K14's decomposition in PyTorch: the decisions and bookkeeping of
    :func:`strip_mega_launch_plain`, each strip's generations on the blocks
    of ``blocks`` (one strip's; None: the ``frontier_blocks`` of an H100
    for all the strips) through ``_frontier_blocks``, the strip's words
    wrapping modulo its width.  Writes what the plain version writes;
    returns ``writes``."""
    ny, h = _check_mega(reads, writes, st, plan)
    wp = reads[0].shape[1]
    blocks = blocks or frontier_blocks((h, wp), plan, ny)
    _check_frontier_blocks(blocks, plan, (h, wp))
    cols = torch.remainder(torch.arange(blocks.grid[1] * blocks.centre + 2) - 1, wp)

    def advance(e, hit):
        return _frontier_blocks(e[:, cols.to(e.device)], rule, blocks, plan.t, (h, wp), hit)

    return _strip_mega(reads, writes, st, plan, parity, first, advance)


def _k14(sets, rule: LifeRule, plan: AdaptivePlan):
    """``(reads, writes, st, parity, first)`` -> one K14 launch on the
    strips' device and current stream, ``reads`` and ``writes`` two of
    ``sets`` (lists of buffers of one shape, one a strip, top to bottom),
    whose device pointer tables (int64[ny] each) are built here once,
    copied without a wait from pinned memory, and live as long as the
    launcher (freed, the allocator could hand their memory to a tensor
    made between two launches); its blocks ``frontier_blocks``'s for all
    the strips on the device's SMs, in the rule's instantiation; counted
    on ``strip_mega_launch.launches`` and ``.rules``."""
    like = sets[0][0]
    ny, (h, wp) = len(sets[0]), like.shape
    tabs = torch.tensor([[t.data_ptr() for t in bufs] for bufs in sets],
                        dtype=torch.int64).pin_memory().to(like.device, non_blocking=True)
    row = {tuple(t.data_ptr() for t in bufs): tab for bufs, tab in zip(sets, tabs)}
    blocks = frontier_blocks((h, wp), plan, ny, device_sms(like.device))
    lib, launch = _reg_launcher("frontier", "gol_strip_mega_launch", 6, 11)
    born, surv, variant = reg_rule(rule)
    stream = _stream(like)

    def k14(reads, writes, st: MeshState, parity: int, first: bool) -> None:
        rd, wr = (row[tuple(t.data_ptr() for t in bufs)].data_ptr() for bufs in (reads, writes))
        err = launch(rd, wr, st.state.data_ptr(), st.rowflag.data_ptr(), st.skipped.data_ptr(),
                     st.act.data_ptr(), len(reads), h, wp, plan.t, plan.stripe_h, blocks.tile_h,
                     blocks.warps, plan.pad_f, parity, int(first), variant, born, surv, stream)
        cuda_build.check(lib, err, "strip_mega")
        strip_mega_launch.launches += 1
        strip_mega_launch.rules[REG_RULES[variant]] += 1

    return k14


def strip_mega_launch(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                      parity: int, first: bool, k14=None):
    """K14: one launch of ``plan.t`` generations over every strip of a row
    mesh whose strips share one device (``reads`` top to bottom), writing
    ``writes`` (each strip's buffer of two launches ago) and
    ``st.state[parity]`` and accumulating ``st.skipped`` and ``st.act``;
    returns ``writes``.  ``first`` marks launch 0 of a chunk.  ``k14`` is a
    chunk's launcher (:func:`_k14`, its buffer sets holding ``reads`` and
    ``writes``, the launch checked with the chunk); without it the launch
    is checked here, CPU tensors run :func:`strip_mega_launch_plain` and
    CUDA tensors launch K14 or raise."""
    if k14 is None:
        _check_mega(reads, writes, st, plan)
        if reads[0].device.type == "cpu":
            return strip_mega_launch_plain(reads, writes, st, rule, plan, parity, first)
        k14 = _k14([reads, writes], rule, plan)
    k14(reads, writes, st, parity, first)
    return writes


strip_mega_launch.launches = 0
strip_mega_launch.rules = collections.Counter()


def strip_mega_launches(strips, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
                        plain: bool = False, each=None):
    """One chunk of the in-kernel tier: ``nlaunch`` K14 launches over
    every strip of a row mesh whose strips share one device, from a
    restarted state (launch 0 forces every stripe to compute), each launch
    writing the strips' buffers of two launches ago (two fresh buffers a
    strip; the input is never written).  Returns (strips,
    :class:`MeshState`): the chunk's final state, its skip count per strip
    and its activity per stripe, all left on the device.  On the card the
    chunk is checked and its launcher (:func:`_k14`: the pointer tables)
    built once, then each launch is one wrapper call, nothing read back
    between launches.  ``plain`` runs :func:`strip_mega_launch_plain`
    instead (on the CPU the wrapper runs it anyway); ``each(strips, st)``
    is called after every launch (the launch-by-launch check)."""
    ny, h = len(strips), strips[0].shape[0]
    dev = strips[0].device
    st = MeshState.start(ny, h, plan, dev)
    bufs = [[torch.empty_like(t) for t in strips] for _ in range(2)]
    k14 = None
    if dev.type == "cuda" and not plain:
        _check_mega(strips, bufs[0], st, plan)
        k14 = _k14([strips, *bufs], rule, plan)
    cur = strips
    for k in range(nlaunch):
        args = (cur, bufs[k % 2], st, rule, plan, k % 2, k == 0)
        cur = strip_mega_launch_plain(*args) if plain else strip_mega_launch(*args, k14)
        if each is not None:
            each(cur, st)
    return cur, st


# -- K15: the 2-D megakernel ---------------------------------------------------------


def _check_tile_mega(reads, writes, st: MeshState, plan: AdaptivePlan) -> tuple[int, int, int, int]:
    """(ny, nx, h_loc, wpl) of a K15 launch, after checking it: ``reads``
    and ``writes`` are rows of tiles, one write buffer a tile, all
    contiguous int32 words of one shape on one device, no buffer written
    twice or both read and written, a frontier plan of whole stripes whose
    decision reach round8(T + 6) fits one stripe (so no window or decision
    reaches past the adjacent tiles), T + 6 <= 32·wpl (the window's word
    halo within the adjacent tiles), and state of the mesh's size."""
    ny = len(reads)
    nx = len(reads[0]) if ny else 0
    if ny < 1 or nx < 1 or any(len(r) != nx for r in reads) or [len(r) for r in writes] != [nx] * ny:
        raise ValueError("a 2-D mesh launch needs rows of tiles and one write buffer a tile")
    flat_r = [t for r in reads for t in r]
    flat_w = [t for r in writes for t in r]
    shape, dev = flat_r[0].shape, flat_r[0].device
    for t in (*flat_r, *flat_w):
        _check_words(t)
        if t.shape != shape or t.device != dev:
            raise ValueError("a 2-D mesh launch's tiles and buffers must share one shape and device")
    out = {t.data_ptr() for t in flat_w}
    if len(out) != ny * nx or out & {t.data_ptr() for t in flat_r}:
        raise ValueError("a 2-D mesh launch writes each buffer once and no tile it reads")
    h, wpl = shape
    if (not plan.frontier or h % plan.stripe_h or plan.pad_f > plan.stripe_h
            or plan.t + SKIP_PERIOD > WORD * wpl):
        raise ValueError(f"plan {plan} has no frontier form within one stripe and one tile of "
                         f"{h}x{wpl} words: K15 reads no further than the adjacent tiles")
    total = ny * nx * plan.grid(h)
    if (st.state.shape != (2, 5, total) or st.rowflag.shape != (ny * nx * h,)
            or st.skipped.shape != (ny * nx,) or st.act.shape != (total,)):
        raise ValueError(f"mesh state {tuple(st.state.shape)} for {ny}x{nx} tiles of "
                         f"{plan.grid(h)} stripes")
    return ny, nx, h, wpl


def _tile_window(tiles, dy: int, dx: int, halo: int, xw: int) -> torch.Tensor:
    """Tile (dy, dx) of a torus of tiles with ``halo`` rows and ``xw``
    words of its neighbours on each side, the corners from the diagonal
    tiles."""
    ny, nx = len(tiles), len(tiles[0])
    h, w = tiles[0][0].shape
    band = [torch.cat([r[(dx - 1) % nx][:, w - xw :], r[dx], r[(dx + 1) % nx][:, :xw]], dim=1)
            for r in (tiles[(dy + sy) % ny] for sy in (-1, 0, 1))]
    return torch.cat([band[0][h - halo :], band[1], band[2][:halo]])


def _tile_mega(reads, writes, st: MeshState, plan: AdaptivePlan, parity: int, first: bool,
               advance, elide: bool):
    """One K15 launch's decisions, measure and bookkeeping in PyTorch, each
    tile's generations from ``advance(ty, tx, computes)``: (gen T,
    gen T + 6) of tile (ty, tx), whose stripes that do not ``compute``
    (bool, one a stripe) are unused.  Every stripe's nine neighbours are its own stripes
    i - 1..i + 1 and those of the W and E tiles, past the tile's edge the
    N or S tile row's edge stripe moved by -/+ h_loc (for an interior
    stripe the JAX kernel's nine).  The edge stripes hit with the maximal
    union; with ``elide``, an edge stripe whose neighbours do not hit is
    elided instead: counted computed, not computed, its intervals empty.
    Returns the elided stripes (bool, tile-major)."""
    ny, nx, h, wpl = _check_tile_mega(reads, writes, st, plan)
    sh, grid = plan.stripe_h, plan.grid(h)
    total = ny * nx * grid
    dev = reads[0][0].device
    g = torch.arange(total, device=dev)
    v, i = g // grid, g % grid
    dy, dx = v // nx, v % nx
    c_lo = i * sh
    c_hi = c_lo + sh - 1
    prev = st.state[1 - parity].to(torch.int64)
    ivals = []
    for tx in ((dx - 1) % nx, dx, (dx + 1) % nx):
        for slot in (-1, 0, 1):
            j = i + slot
            shift = torch.div(j, grid, rounding_mode="floor")  # -1 above the tile, 1 below
            at = (((dy + shift) % ny) * nx + tx) * grid + torch.remainder(j, grid)
            ivals += [(prev[2 * k][at] + shift * h, prev[2 * k + 1][at] + shift * h)
                      for k in (0, 1)]
    hit, m_lo, m_hi = cuda_adaptive.hit_union(ivals, c_lo, c_hi, plan)
    edge = (i == 0) | (i == grid - 1)
    elided = edge & ~hit if elide and not first else torch.zeros_like(edge)
    forced = edge | first
    counted = hit | forced
    computes = counted & ~elided
    m_lo, m_hi = torch.where(forced, c_lo, m_lo), torch.where(forced, c_hi, m_hi)
    copy = ~computes & prev[4].bool()
    rows = torch.arange(h, device=dev)
    of = rows // sh
    outs, hots = [], []
    for ty in range(ny):
        for tx in range(nx):
            mine = slice((ty * nx + tx) * grid, (ty * nx + tx + 1) * grid)
            g_t, g_t6 = advance(ty, tx, computes[mine])
            comp = computes[mine][of]
            hots.append(((g_t6 != g_t).any(dim=1) & comp & (rows >= m_lo[mine][of])
                         & (rows <= m_hi[mine][of])).view(grid, sh))
            outs.append(torch.where(comp[:, None], g_t, torch.where(
                copy[mine][of, None], reads[ty][tx], writes[ty][tx])))
    intervals = cuda_adaptive.measure2(torch.cat(hots), rows.view(grid, sh).repeat(ny * nx, 1))
    for w, o in zip((t for r in writes for t in r), outs):
        w.copy_(o)
    st.state[parity].copy_(torch.cat([intervals, counted[None].to(intervals.dtype)]))
    st.skipped += (~counted).view(ny * nx, grid).sum(dim=1).to(torch.int32)
    st.act += (intervals[0] <= intervals[1]).to(torch.int32)
    return elided


def tile_mega_launch_plain(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                           parity: int, first: bool):
    """Plain version of K15 (one launch of ``_kernel_frontier_mega_2d``
    over every tile of a 2-D mesh, ``reads`` as rows of tiles): stripe i
    of tile (dy, dx) decides with ``_hit_union`` over the previous
    parity's row intervals of nine stripes, read straight from the shared
    state: its own stripes i - 1, i and i + 1 and the same stripes of the
    W and E tiles (whose row frames are its own); the edge stripes (i = 0,
    grid - 1), and every stripe with ``first`` (launch 0 of a chunk), hit
    with the maximal union, as the JAX kernel forces them.  A stripe that
    hits computes T generations of its window (the tile with T + 6 rows
    and ceil((T + 6) / 32) words of the neighbour tiles' read buffers,
    corners included) and measures gen T + 6 against gen T on its measure
    rows (``_measure2``); one that does not copies its input into
    ``writes`` if it computed last launch.  Writes ``writes`` and
    ``st.state[parity]``, adds to ``st.skipped`` and ``st.act``; returns
    ``writes``."""
    halo = plan.t + SKIP_PERIOD
    xw = -(-halo // WORD)
    h, wpl = reads[0][0].shape
    centre = (slice(halo, halo + h), slice(xw, xw + wpl))

    def advance(ty, tx, _computes):
        g_t = packed.superstep(_tile_window(reads, ty, tx, halo, xw), rule, plan.t)
        return g_t[centre], packed.superstep(g_t, rule, SKIP_PERIOD)[centre]

    _tile_mega(reads, writes, st, plan, parity, first, advance, False)
    return writes


def tile_mega_launch_mirror(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                            parity: int, first: bool, blocks: RegPlan | None = None):
    """K15's decomposition in PyTorch: the blocks of ``blocks`` (one
    tile's; None: the ``frontier_blocks`` of an H100 for all the tiles) through
    :func:`_frontier_blocks`, each tile's window from the tiles' torus,
    and the kernel's decisions: an edge stripe decides from its 3x3-tile
    neighbourhood and is elided where that proves it stable (counted in
    ``tile_mega_launch_mirror.elided``; the last launch's elided stripes,
    tile-major, in ``.last_elided``), every other decision as
    :func:`tile_mega_launch_plain`'s.  Writes what the plain version
    writes; returns ``writes``."""
    ny, nx, h, wpl = _check_tile_mega(reads, writes, st, plan)
    blocks = blocks or frontier_blocks((h, wpl), plan, ny * nx)
    _check_frontier_blocks(blocks, plan, (h, wpl))
    whole = torch.cat([torch.cat(r, dim=1) for r in reads])
    halo, dev = plan.t + SKIP_PERIOD, whole.device
    rows = torch.arange(h + 2 * halo, device=dev) - halo
    cols = torch.arange(blocks.grid[1] * blocks.centre + 2, device=dev) - 1

    def advance(ty, tx, computes):
        src = whole[torch.remainder(ty * h + rows, ny * h)][:, torch.remainder(
            tx * wpl + cols, nx * wpl)]
        return _frontier_blocks(src, rule, blocks, plan.t, (h, wpl), computes)

    elided = _tile_mega(reads, writes, st, plan, parity, first, advance, True)
    tile_mega_launch_mirror.elided += int(elided.sum())
    tile_mega_launch_mirror.last_elided = elided
    return writes


tile_mega_launch_mirror.elided = 0
tile_mega_launch_mirror.last_elided = None


def _k15(sets, rule: LifeRule, plan: AdaptivePlan):
    """``(reads, writes, st, parity, first)`` -> one K15 launch on the
    tiles' device and current stream, ``reads`` and ``writes`` two of
    ``sets`` (rows of tiles of one shape), whose device pointer tables
    (int64[ny·nx] each, row-major) are built here once, copied without a
    wait from pinned memory, and live as long as the launcher (as
    :func:`_k14`'s); its blocks ``frontier_blocks``' for all the tiles
    on the device's SMs, in the rule's instantiation; counted on
    ``tile_mega_launch.launches`` and ``.rules``."""
    like = sets[0][0][0]
    ny, nx = len(sets[0]), len(sets[0][0])
    h, wpl = like.shape

    def key(bufs):
        return tuple(t.data_ptr() for r in bufs for t in r)

    tabs = torch.tensor([key(bufs) for bufs in sets],
                        dtype=torch.int64).pin_memory().to(like.device, non_blocking=True)
    row = {key(bufs): tab for bufs, tab in zip(sets, tabs)}
    blocks = frontier_blocks((h, wpl), plan, ny * nx, device_sms(like.device))
    lib, launch = _reg_launcher("frontier", "gol_tile_mega_launch", 6, 12)
    born, surv, variant = reg_rule(rule)
    stream = _stream(like)

    def k15(reads, writes, st: MeshState, parity: int, first: bool) -> None:
        rd, wr = (row[key(bufs)].data_ptr() for bufs in (reads, writes))
        err = launch(rd, wr, st.state.data_ptr(), st.rowflag.data_ptr(), st.skipped.data_ptr(),
                     st.act.data_ptr(), ny, nx, h, wpl, plan.t, plan.stripe_h, blocks.tile_h,
                     blocks.warps, plan.pad_f, parity, int(first), variant, born, surv, stream)
        cuda_build.check(lib, err, "tile_mega")
        tile_mega_launch.launches += 1
        tile_mega_launch.rules[REG_RULES[variant]] += 1

    return k15


def tile_mega_launch(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                     parity: int, first: bool, k15=None):
    """K15: one launch of ``plan.t`` generations over every tile of a 2-D
    mesh whose tiles share one device (``reads`` as rows of tiles),
    writing ``writes`` (each tile's buffer of two launches ago) and
    ``st.state[parity]`` and accumulating ``st.skipped`` and ``st.act``;
    returns ``writes``.  ``first`` marks launch 0 of a chunk.  ``k15`` is a
    chunk's launcher (:func:`_k15`); without it the launch is checked
    here, CPU tensors run :func:`tile_mega_launch_plain` and CUDA tensors
    launch K15 or raise."""
    if k15 is None:
        _check_tile_mega(reads, writes, st, plan)
        if reads[0][0].device.type == "cpu":
            return tile_mega_launch_plain(reads, writes, st, rule, plan, parity, first)
        k15 = _k15([reads, writes], rule, plan)
    k15(reads, writes, st, parity, first)
    return writes


tile_mega_launch.launches = 0
tile_mega_launch.rules = collections.Counter()


def tile_mega_launches(tiles, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
                       plain: bool = False, each=None):
    """One chunk of the in-kernel tier on a 2-D mesh: ``nlaunch`` K15
    launches over every tile (``tiles``: rows of tiles on one device),
    from a restarted state, each launch writing the tiles' buffers of two
    launches ago (two fresh buffers a tile; the input is never written).
    Returns (tiles, :class:`MeshState`): the chunk's final tiles, state,
    skip count per tile and activity per stripe (tile-major), all left on
    the device.  On the card the chunk is checked and its launcher
    (:func:`_k15`) built once, then each launch is one wrapper call.
    ``plain`` runs :func:`tile_mega_launch_plain` instead (on the CPU the
    wrapper runs it anyway); ``each(tiles, st)`` is called after every
    launch (the launch-by-launch check)."""
    ny, nx = len(tiles), len(tiles[0])
    dev = tiles[0][0].device
    st = MeshState.start(ny * nx, tiles[0][0].shape[0], plan, dev)
    bufs = [[[torch.empty_like(t) for t in r] for r in tiles] for _ in range(2)]
    k15 = None
    if dev.type == "cuda" and not plain:
        _check_tile_mega(tiles, bufs[0], st, plan)
        k15 = _k15([tiles, *bufs], rule, plan)
    cur = tiles
    for k in range(nlaunch):
        args = (cur, bufs[k % 2], st, rule, plan, k % 2, k == 0)
        cur = tile_mega_launch_plain(*args) if plain else tile_mega_launch(*args, k15)
        if each is not None:
            each(cur, st)
    return cur, st


def tile_activity(act: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """A chunk's tile-major per-stripe activity (int32[ny·nx·grid]) as the
    (ny·grid, nx) grid of (stripe, x-tile) cells, stripes top to bottom
    and tiles left to right (the JAX package's 2-D activity)."""
    return act.view(ny, nx, -1).permute(0, 2, 1).reshape(-1, nx)


def reset_launches() -> None:
    """Set the launch counters of K9-K15 to 0, and the counts by rule
    instantiation of K9, K12, K13, K14 and K15."""
    ext_launch.launches = 0
    ext_launch.rules.clear()
    tile_probing_launch.rules.clear()
    strip_frontier_launch.rules.clear()
    strip_mega_launch.rules.clear()
    tile_mega_launch.rules.clear()
    ext_skip_launch.launches = 0
    strip_probing_launch.launches = 0
    strip_frontier_launch.launches = 0
    tile_probing_launch.launches = 0
    strip_mega_launch.launches = 0
    tile_mega_launch.launches = 0


# -- the drivers ------------------------------------------------------------------


def edge_flags(flags: list[torch.Tensor], span=None) -> list[torch.Tensor]:
    """The flag exchange of K11: each strip's bitmap (top to bottom)
    extended with its north neighbour's last flag and its south
    neighbour's first, on its own device (int32[grid + 2];
    ``halo.neighbour_edges``, ``span`` for a process-spanning mesh)."""
    edges = neighbour_edges(flags, lambda f: f[-1:], lambda f: f[:1], span)
    return [torch.cat([north.to(f.device), f, south.to(f.device)])
            for f, (north, south) in zip(flags, edges)]


def edge_intervals(states: list[torch.Tensor], h_loc: int, span=None) -> list[torch.Tensor]:
    """The interval exchange of K12: each strip's row intervals (rows 0-3
    of its (5, grid) state) extended with its north neighbour's last
    stripe, shifted by -h_loc into this strip's row frame, and its south
    neighbour's first, shifted by +h_loc (int32[4][grid + 2];
    ``halo.neighbour_edges``, ``span`` for a process-spanning mesh).  An
    empty interval (lo > hi) stays empty: both ends move by the same
    offset."""
    edges = neighbour_edges(states, lambda s: s[:4, -1:], lambda s: s[:4, :1], span)
    return [torch.cat([north.to(s.device) - h_loc, s[:4], south.to(s.device) + h_loc], dim=1)
            for s, (north, south) in zip(states, edges)]


def _gather_activity(acts: list[torch.Tensor], span) -> torch.Tensor:
    """Per-strip activity vectors in strip order, on the first one's
    device (every rank's, in rank order, on a process-spanning mesh)."""
    local = torch.cat([a.to(acts[0].device) for a in acts])
    return local if span is None else span.gather(local)


def probing_launches(strips, rule, plan, nlaunch, launch=None, span=None):
    """``nlaunch`` K11 launches on every strip from a zero bitmap (launch
    0 probes every stripe), each strip writing its buffer of two launches
    ago (the second starts as a copy of the input, which is never
    written).  Returns (strips, skipped, activity): the stable flags after
    each launch summed, and per stripe the launches it was not proved
    stable, in top-to-bottom order (over every rank's strips with a
    ``span``).  ``launch`` replaces the wrapper
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
        rows = edge_rows(strips, plan.pad, span)
        exts = edge_flags([f[k] for f in flags], span)
        strips = [launch(t, n, s, b[k % 2], e, f[k + 1], rule, plan)
                  for t, (n, s), b, e, f in zip(strips, rows, bufs, exts, flags)]
    stats = [cuda_adaptive._probing_stats(f[1:]) for f in flags]
    return (strips, psum((sk for sk, _ in stats), span),
            _gather_activity([a for _, a in stats], span))


def frontier_launches(strips, rule, plan, nlaunch, launch=None, span=None):
    """``nlaunch`` K12 launches on every strip, the first from full
    intervals, each strip writing its buffer of two launches ago.  Returns
    (strips, skipped, activity) as :func:`probing_launches` does;
    ``launch`` replaces the wrapper (:func:`strip_frontier_launch_plain`)."""
    launch = launch or strip_frontier_launch
    h_loc = strips[0].shape[0]
    states = [FrontierState.start(h_loc, plan, t.device) for t in strips]
    bufs = [(torch.empty_like(t), torch.empty_like(t)) for t in strips]
    for k in range(nlaunch):
        rows = edge_rows(strips, plan.pad_f, span)
        exts = edge_intervals([st.prev for st in states], h_loc, span)
        strips = [launch(t, n, s, b[k % 2], e, st, rule, plan)
                  for t, (n, s), b, e, st in zip(strips, rows, bufs, exts, states)]
        for st in states:
            st.advance()
    return (strips, psum((st.skipped[0] for st in states), span),
            _gather_activity([st.act for st in states], span))


def mega_launches(strips, rule, plan: AdaptivePlan, full: int):
    """The ``full`` launches of a dispatch on the in-kernel tier, split as
    the JAX package's in-kernel branch splits them: the canonical chunks
    (``_nlaunch_chunks``) on K14 (:func:`strip_mega_launches`), the loose
    tail of fewer than 8 launches on K11 from a zero bitmap
    (:func:`probing_launches`).  Returns (strips, skipped, activity), the
    chunks' and the tail's summed."""
    chunks, loose = cuda_adaptive._nlaunch_chunks(full)
    dev = strips[0].device
    skipped = torch.zeros((), dtype=torch.int32, device=dev)
    act = torch.zeros((len(strips) * plan.grid(strips[0].shape[0]),), dtype=torch.int32,
                      device=dev)
    for c in chunks:
        strips, st = strip_mega_launches(strips, rule, plan, c)
        skipped, act = skipped + st.skipped.sum().to(torch.int32), act + st.act
    if loose:
        strips, sk, a = probing_launches(strips, rule, plan, loose)
        skipped, act = skipped + sk, act + a
    return strips, skipped, act


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


def tile_mega_chunks(board: ShardedBoard, rule, plan: AdaptivePlan, xpad: int, full: int):
    """The ``full`` launches of a dispatch on the in-kernel tier of a 2-D
    mesh, split as the JAX package's in-kernel branch splits them: the
    canonical chunks (``_nlaunch_chunks``) on K15
    (:func:`tile_mega_launches`), the loose tail of fewer than 8 launches
    on K13 from a zero bitmap (:func:`tile_probing_launches`, ``xpad`` its
    x-halo).  Returns (board, skipped, activity), the chunks' and the
    tail's summed, the activity as the (ny·grid, nx) grid."""
    chunks, loose = cuda_adaptive._nlaunch_chunks(full)
    ny, nx = len(board.shards), len(board.shards[0])
    dev = board.shards[0][0].device
    skipped = torch.zeros((), dtype=torch.int32, device=dev)
    act = torch.zeros((ny * plan.grid(board.shard_shape[0]), nx), dtype=torch.int32, device=dev)
    for c in chunks:
        tiles, st = tile_mega_launches(board.shards, rule, plan, c)
        board = ShardedBoard(board.mesh, tiles)
        skipped, act = skipped + st.skipped.sum().to(torch.int32), act + tile_activity(st.act, ny, nx)
    if loose:
        board, sk, a = tile_probing_launches(board, rule, plan, xpad, loose)
        skipped, act = skipped + sk, act + a
    return board, skipped, act


def _ext_step(board: ShardedBoard, rule: LifeRule, turns: int, launch) -> ShardedBoard:
    """One exchange of ``turns`` rows (and on a 2-D mesh ceil(turns / 32)
    word columns) and one ``launch`` (K9 or K10, or a plain version) per
    shard."""
    xpad = -(-turns // WORD) if len(board.shards[0]) > 1 else 0
    return ShardedBoard(board.mesh, [[launch(e, rule, turns, turns, xpad) for e in row]
                                     for row in extend(board, turns, xpad)])


def make_superstep(mesh: Mesh, rule: LifeRule = CONWAY, skip_stable: bool = False,
                   skip_tile_cap: int = 0, with_stats: bool = False,
                   in_kernel: bool | None = None):
    """``(packed ShardedBoard, turns) -> packed ShardedBoard`` on the mesh;
    with ``with_stats``, ``(board, skipped, activity)``.

    Without ``skip_stable``: the launches of :func:`launch_plan`, each one
    exchange (``halo.extend``: rows on a row mesh, the counterpart of
    ``_extend_rows``; rows then word columns on a 2-D mesh, of
    ``_extend_tile_2d``) plus one K9 launch per shard into a fresh output
    shard.

    With ``skip_stable`` (``skip_tile_cap`` bounds the stripe height, 0 =
    the port's default): on a row mesh the full launches of
    :func:`adaptive_strip_plan` on the in-kernel tier where the plan has a
    frontier form and :func:`tier_policy` (with ``in_kernel``) allows it
    (:func:`mega_launches`: K14 chunks, a K11 tail), else on K12 or K11
    with the exchange between launches; on a 2-D mesh those of
    :func:`adaptive_tile_plan` on the in-kernel tier under the same two
    conditions (:func:`tile_mega_chunks`: K15 chunks, a K13 tail), else on
    K13 (K10 on a strip or tile with no plan), then one K10 launch for the
    period-multiple part of the remainder and one K9 launch for the rest.  ``skipped`` (an int32 0-d
    tensor) counts the stripe-launches skipped or proved stable over all
    shards, and ``activity`` the launches each stripe was active, as the
    JAX package's ``with_stats`` does: int32[ny·grid] top to bottom on a
    row mesh, the (ny·grid, nx) grid of (stripe, x-tile) cells on a 2-D
    mesh, empty when no adaptive launch ran."""
    mesh_shape = (mesh.shape["y"], mesh.shape["x"])
    two_d = mesh_shape[1] > 1
    in_kernel_tier = skip_stable and tier_policy(mesh, in_kernel=in_kernel)[0]

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
            if plan.frontier and in_kernel_tier:
                board, skipped, act = tile_mega_chunks(board, rule, plan, xpad, full)
            else:
                board, skipped, act = tile_probing_launches(board, rule, plan, xpad, full)
        else:
            full, rem = divmod(turns, plan.t)
            strips = [row[0] for row in board.shards]
            if plan.frontier and in_kernel_tier:
                strips, skipped, act = mega_launches(strips, rule, plan, full)
            elif plan.frontier:
                strips, skipped, act = frontier_launches(strips, rule, plan, full,
                                                         span=mesh.span)
            else:
                strips, skipped, act = probing_launches(strips, rule, plan, full,
                                                        span=mesh.span)
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
                         skip_tile_cap: int = 0, with_stats: bool = False,
                         in_kernel: bool | None = None):
    """``(uint8 ShardedBoard, turns) -> uint8 ShardedBoard`` (with
    ``with_stats``, plus the skip count and the activity of
    :func:`make_superstep`): each shard packed and unpacked on its own
    device around :func:`make_superstep`."""
    inner = make_superstep(mesh, rule, skip_stable, skip_tile_cap, with_stats, in_kernel)

    def run(board: ShardedBoard, turns: int):
        if not turns:
            return (board, *_no_stats(board)) if with_stats else board
        out = inner(board.map(packed.pack), turns)
        if with_stats:
            return (out[0].map(packed.unpack), *out[1:])
        return out.map(packed.unpack)

    return run


def make_superstep_virtual_2d(mesh_shape: tuple[int, int], rule: LifeRule = CONWAY,
                              skip_tile_cap: int = 0, with_stats: bool = False):
    """``(packed board, turns) -> packed board`` (with ``with_stats``,
    ``(board, skipped, activity)``): the in-kernel tier of an (ny, nx)
    mesh run on a whole packed board on one device, the counterpart of
    ``pallas_halo.make_superstep_virtual_2d``.  The board is cut into its
    (ny, nx) tiles; the full launches of :func:`adaptive_tile_plan` run
    in canonical chunks on K15 (:func:`tile_mega_launches`; its plain
    version on the CPU), and the loose tail and the remainder on
    ``packed.superstep``, as the JAX build's do, so ``skipped`` and the
    (ny·grid, nx) ``activity`` cover the chunks alone.  Raises where the
    tile has no frontier plan."""
    ny, nx = mesh_shape

    def run(p: torch.Tensor, turns: int):
        h, wp = p.shape
        if h % ny or wp % nx:
            raise ValueError(f"board {tuple(p.shape)} does not divide {mesh_shape}")
        tile = (h // ny, wp // nx)
        plan = (adaptive_tile_plan(tile, turns, skip_tile_cap) or (None,))[0]
        if plan is None or not plan.frontier:
            raise ValueError(f"no 2-D frontier plan for {tuple(p.shape)} on mesh {mesh_shape}")
        full, rem = divmod(turns, plan.t)
        chunks, loose = cuda_adaptive._nlaunch_chunks(full)
        skipped = torch.zeros((), dtype=torch.int32, device=p.device)
        act = torch.zeros((ny * plan.grid(tile[0]), nx), dtype=torch.int32, device=p.device)
        tiles = [[t.contiguous() for t in r.chunk(nx, dim=1)] for r in p.chunk(ny)]
        for c in chunks:
            tiles, st = tile_mega_launches(tiles, rule, plan, c)
            skipped, act = skipped + st.skipped.sum().to(torch.int32), act + tile_activity(
                st.act, ny, nx)
        board = torch.cat([torch.cat(r, dim=1) for r in tiles])
        tail = loose * plan.t + rem
        if tail:
            board = packed.superstep(board, rule, tail)
        return (board, skipped, act) if with_stats else board

    return run
