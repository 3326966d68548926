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
  their edge stripes' skip flags (K11) or tracked intervals, the rows
  shifted into its row frame, the column interval as it is (K12).  Each
  strip keeps two buffers, and a launch writes the one of two launches
  ago (write elision).  K12 takes the JAX kernel's compute tiers (the
  column window, the row tier, the full window) at the plan geometry
  (``cuda_adaptive.frontier_geometry``).

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
intervals in place, with no exchange between launches, and whose
stripes take K5's routes and change-rectangle writes (the rectangle
route's window inside the strip); the loose tail runs K11 from a zero
bitmap, the remainders K10 and K9.  A 2-D mesh whose
tiles share one device takes the same tier (the counterpart of
``_kernel_frontier_mega_2d``): canonical chunks of K15 launches over every
tile (:func:`tile_mega_chunks`), whose windows read the neighbour tiles'
rows, words and corners and whose stripes decide from their own and both
x-neighbours' intervals (the column intervals moved by -/+ wpl into the
tile's words) and take K5's routes and writes (the rectangle route's
window inside the tile), the edge stripes from their 3x3-tile
neighbourhood (the JAX kernel forces them to the full route; one proved
stable is elided, counted as computed); a K13 loose tail; :func:`make_superstep_virtual_2d`
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

The same tier runs on a mesh whose shards lie on several CUDA devices of
this process (the peer form, the counterpart of the JAX kernels' remote
builds on a mesh of chips): :func:`peer_groups` gives each card its
shards, and a launch of the chunk is one K14 or K15 launch a card over its
own shards (the kernels' table of shard ids), whose windows read the
neighbour cards' buffers and whose stripes read and write the one
interval state array on the mesh's first card through CUDA peer access
(:func:`enable_peer_access`); the other per-stripe arrays lie on each card
at full size, each touching its own entries, and are summed onto the
first card at the chunk's end (:func:`merge_states`).  Between launches
each card's stream waits on the previous launch's event of the cards its
shards read (:func:`peer_waits`): launch l + 1 reads what they wrote in
launch l and overwrites the buffer and the state parity they read in it,
the JAX kernels' slot-reuse argument with an event for the receive
semaphore.  The loose tail and the remainders take the ppermute forms'
launches a shard, as on any mesh.

A row mesh that spans processes (``parallel/multihost.py``) takes the
ppermute forms (:func:`tier_policy`): each process launches K9-K12 on
its own strips, and the exchanges of :func:`edge_flags`,
:func:`edge_intervals` and ``halo.edge_rows`` take the band's end edges
from the neighbouring ranks; the skip count is summed and the activity
gathered over the ranks.
"""

from __future__ import annotations

import collections
import ctypes
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


def _card(d) -> torch.device:
    """A device with its index: ``cuda`` is ``cuda:0``."""
    d = torch.device(d)
    return torch.device(d.type, d.index or 0)


def peer_groups(devices) -> dict[torch.device, tuple[int, ...]]:
    """Card -> the ids of the shards that lie on it (``devices``: the
    shards' devices in row-major shard order, ``Mesh.flat``), any number
    of shards a card, the cards in the order of their first shard: the
    launch groups of the in-kernel tier's peer form."""
    groups: dict[torch.device, list[int]] = {}
    for s, d in enumerate(devices):
        groups.setdefault(_card(d), []).append(s)
    return {card: tuple(ids) for card, ids in groups.items()}


def shard_reads(s: int, mesh_shape: tuple[int, int]) -> set[int]:
    """The other shards whose buffers and interval state shard ``s``'s
    K14 or K15 launch reads: on a row mesh (nx = 1) its N and S strips, on
    a 2-D mesh its eight neighbour tiles, corners included
    (``MeshTileSource``, ``TorusTileIntervals``); modulo the mesh."""
    ny, nx = mesh_shape
    dy, dx = divmod(s, nx)
    if nx == 1:
        return {(dy - 1) % ny, (dy + 1) % ny} - {s}
    return {((dy + a) % ny) * nx + (dx + b) % nx
            for a in (-1, 0, 1) for b in (-1, 0, 1)} - {s}


def peer_waits(groups: dict, mesh_shape: tuple[int, int]) -> dict:
    """For each card of ``groups`` (card -> shard ids, :func:`peer_groups`;
    any keys), the other cards whose shards its shards read
    (:func:`shard_reads`), in the order of ``groups``: the cards whose
    previous launch its next launch waits on."""
    owner = {s: card for card, ids in groups.items() for s in ids}
    return {card: tuple(other for other in groups if other != card and any(
        owner[r] == other for s in ids for r in shard_reads(s, mesh_shape)))
        for card, ids in groups.items()}


def peer_access(card: torch.device, peer: torch.device) -> bool:
    """Whether ``card`` can read and write ``peer``'s memory (CUDA peer
    access, ``torch.cuda.can_device_access_peer``): the one capability
    the peer form needs, behind one function that tests replace."""
    return torch.cuda.can_device_access_peer(card, peer)


def peer_pairs(groups: dict, mesh_shape: tuple[int, int], first=None) -> list[tuple]:
    """(card, peer) for every access the peer form makes across cards:
    each card of ``groups`` (card -> shard ids, :func:`peer_groups`) to the
    cards its shards read (:func:`peer_waits`) and to ``first`` (None: the
    first card of ``groups``), which holds the interval state."""
    first = next(iter(groups)) if first is None else first
    return [(card, peer) for card, waits in peer_waits(groups, mesh_shape).items()
            for peer in dict.fromkeys((*waits, first)) if peer != card]


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
    in place, in memory this process does not hold.  Every other mesh
    takes the tier, ``ici_tier_policy``'s answer on a mesh of chips: a
    (1, 1) mesh on any device (the loopback form), a row or 2-D mesh whose
    shards share one card, and one whose shards lie on several CUDA
    devices of this process (the peer form), with the port's own check
    last: a card that cannot reach a card it reads (:func:`peer_pairs`,
    :func:`peer_access`) gives the ppermute form, the reason naming
    both."""
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
    groups = peer_groups(mesh.flat)
    if len(groups) > 1:
        form = "tile" if nx > 1 else "strip"
        if any(card.type != "cuda" for card in groups):
            return False, (f"shards on {', '.join(map(str, groups))}: the in-kernel tier's peer "
                           f"form takes CUDA devices alone (the ppermute {form} form runs)")
        for card, peer in peer_pairs(groups, (ny, nx)):
            if not peer_access(card, peer):
                return False, (
                    f"no CUDA peer access from {card} to {peer}: the in-kernel tier's peer "
                    "form reads the neighbour cards' buffers and the mesh's state in place "
                    f"(the ppermute {form} form runs, its exchange by tensor copies)")
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
    with torch.cuda.device(local.device):
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
    previous and the current launch's int32 (7, grid) state (rows lo0,
    hi0, lo1, hi1 in the strip's row frame, clo, chi in board words, and
    whether the stripe computed), the kernel's row flags and column
    extremes, the current launch's routes (``cuda_adaptive.ROUTE_*``), and
    the skip count and per-stripe activity accumulated over the dispatch's
    launches."""

    prev: torch.Tensor
    cur: torch.Tensor
    rowflag: torch.Tensor
    colspan: torch.Tensor
    route: torch.Tensor
    skipped: torch.Tensor
    act: torch.Tensor

    @classmethod
    def start(cls, strip: tuple[int, int], plan: AdaptivePlan, device) -> "FrontierState":
        """The state before a dispatch's first launch on a strip of
        ``strip`` = (h_loc, wp) words: every stripe's own rows as its row
        interval and the whole width [0, wp - 1] as its column interval (so
        every stripe computes and measures), as the JAX package's
        make_superstep starts it."""
        h_loc, wp = strip
        lo = torch.arange(plan.grid(h_loc), dtype=torch.int32, device=device) * plan.stripe_h
        prev = torch.stack([lo, lo + plan.stripe_h - 1, torch.full_like(lo, _EMPTY_LO),
                            torch.full_like(lo, -1), torch.zeros_like(lo),
                            torch.full_like(lo, wp - 1), torch.ones_like(lo)])
        return cls(prev, torch.empty_like(prev),
                   torch.zeros(h_loc, dtype=torch.int32, device=device),
                   cuda_adaptive.column_span(lo.numel(), device), torch.zeros_like(lo),
                   torch.zeros(1, dtype=torch.int32, device=device), torch.zeros_like(lo))

    def advance(self) -> None:
        """After a launch: its state becomes the previous one."""
        self.prev, self.cur = self.cur, self.prev


def _strip_frontier(local, north, south, dst, prev_ext, state: FrontierState, plan: AdaptivePlan,
                    advance) -> torch.Tensor:
    """One K12 launch's decisions, routes, writes and measure in PyTorch,
    its generations from ``advance(e, cells)``: (gen T, gen T + 6) of the
    strip's rows, from ``e``, the strip with T + 6 rows of ``north`` and
    ``south`` a side, exact on ``cells`` (bool (h, wp): where the launch
    writes gen T) and on the measure region."""
    h, wp = local.shape
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
    cvals = [(ext[4][idx + 1 + slot], ext[5][idx + 1 + slot]) for slot in (-1, 0, 1)]
    hit, *union = cuda_adaptive.hit_union(ivals, cvals, c_lo, c_hi, plan)
    rt = cuda_adaptive.frontier_routes(hit, *union, c_lo, plan, (h, wp), None)
    # The ps protocol: a stripe that skips after a launch that computed
    # copies its whole centre.
    copied = ~hit & state.prev[6].bool()
    zero = torch.zeros_like(c_lo)
    copy = (c_lo, torch.where(copied, c_lo + sh, c_lo), zero, zero + wp)
    masks = cuda_adaptive.routed_masks(rt, copy, h, wp, sh)
    g_t, g_t6 = advance(_extended(local, north, south, halo), masks[0] & masks[1])
    out, intervals = cuda_adaptive.routed_launch(local, dst, g_t, g_t6, masks, sh)
    dst.copy_(out)
    state.cur.copy_(torch.cat([intervals, hit[None].to(intervals.dtype)]))
    state.route.copy_(rt.route)
    state.skipped += (~hit).sum().to(torch.int32)
    state.act += (intervals[0] <= intervals[1]).to(torch.int32)
    return dst


def strip_frontier_launch_plain(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, state: FrontierState, rule: LifeRule, plan: AdaptivePlan,
) -> torch.Tensor:
    """Plain version of K12 (``_ext_kernel_frontier``) on one strip:
    ``_hit_union`` over ``prev_ext`` (the previous launch's interval state
    of the strip's stripes, int32[6][grid + 2]: row intervals in this
    strip's frame, column intervals in words, the neighbour strips' edge
    stripes at both ends); a stripe that hits takes ``_frontier_body``'s
    route (``cuda_adaptive.frontier_routes``: the column tier, the row
    tier or the full window, at the active geometry), writes its whole
    centre (gen T where the route's window holds it, its input elsewhere)
    and measures gen T + 6 against gen T on its measure region
    (``_measure2``: rows, and words); one that does not skips, copying its
    input into ``dst`` if it computed last launch.  Writes ``dst``,
    ``state.cur`` and ``state.route``, adds to ``state.skipped`` and
    ``state.act``; returns ``dst``."""
    halo, h = plan.t + SKIP_PERIOD, local.shape[0]

    def advance(e, _cells):
        g_t = packed.superstep(e, rule, plan.t)
        return g_t[halo : halo + h], packed.superstep(g_t, rule, SKIP_PERIOD)[halo : halo + h]

    return _strip_frontier(local, north, south, dst, prev_ext, state, plan, advance)


def strip_frontier_launch_mirror(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, state: FrontierState, rule: LifeRule, plan: AdaptivePlan,
    blocks: RegPlan | None = None,
) -> torch.Tensor:
    """K12's decomposition in PyTorch: the decisions and bookkeeping of
    :func:`strip_frontier_launch_plain`, the generations on the blocks of
    ``blocks`` (None: the ``frontier_blocks`` of an H100) through
    :func:`_frontier_blocks`, only the blocks whose tile meets the cells
    their stripe's route writes as gen T stepping, the strip's words
    wrapping modulo its width."""
    h, wp = local.shape
    blocks = blocks or frontier_blocks((h, wp), plan)
    _check_frontier_blocks(blocks, plan, (h, wp))
    cols = torch.remainder(torch.arange(blocks.grid[1] * blocks.centre + 2) - 1, wp)

    def advance(e, cells):
        return _frontier_blocks(e[:, cols.to(e.device)], rule, blocks, plan.t, (h, wp),
                                cuda_adaptive._block_mask(cells, blocks))

    return _strip_frontier(local, north, south, dst, prev_ext, state, plan, advance)


def strip_frontier_launch(
    local: torch.Tensor, north: torch.Tensor, south: torch.Tensor, dst: torch.Tensor,
    prev_ext: torch.Tensor, state: FrontierState, rule: LifeRule, plan: AdaptivePlan,
) -> torch.Tensor:
    """K12: one frontier launch of ``plan.t`` generations on a strip of a
    row mesh, writing ``dst`` (the strip's buffer of two launches ago),
    ``state.cur`` and ``state.route``, accumulating ``state.skipped`` and
    ``state.act``; returns ``dst``.  ``north``/``south`` hold at least
    T + 6 neighbour rows.  A CPU tensor runs
    :func:`strip_frontier_launch_plain`; a CUDA tensor launches K12 on the
    blocks of ``frontier_blocks`` for its device's SMs, at the active
    geometry, in the rule's instantiation (counted in
    ``strip_frontier_launch.rules``), or raises."""
    h, wp = local.shape
    grid = plan.grid(h)
    _check_strip(local, north, south, dst, plan.t + SKIP_PERIOD)
    if not plan.frontier or h % plan.stripe_h:
        raise ValueError(f"plan {plan} has no frontier form on a strip of {h} rows")
    if prev_ext.shape != (6, grid + 2) or state.prev.shape != (7, grid):
        raise ValueError(f"frontier state {tuple(prev_ext.shape)}, {tuple(state.prev.shape)} "
                         f"for {grid} stripes")
    if local.device.type == "cpu":
        return strip_frontier_launch_plain(local, north, south, dst, prev_ext, state, rule, plan)
    blocks = frontier_blocks((h, wp), plan, 1, device_sms(local.device))
    sub_rows, col_window = cuda_adaptive.frontier_geometry(plan, (h, wp))
    lib, launch = _reg_launcher("frontier", "gol_strip_frontier_launch", 12, 11)
    born, surv, variant = reg_rule(rule)
    with torch.cuda.device(local.device):
        err = launch(local.data_ptr(), north.data_ptr(), south.data_ptr(), dst.data_ptr(),
                     prev_ext.data_ptr(), state.prev[6].data_ptr(), state.cur.data_ptr(),
                     state.rowflag.data_ptr(), state.colspan.data_ptr(),
                     state.skipped.data_ptr(), state.act.data_ptr(), state.route.data_ptr(), h,
                     wp, north.shape[0], plan.t, plan.stripe_h, blocks.tile_h, blocks.warps,
                     plan.pad_f, sub_rows or 0, col_window or 0, variant, born, surv,
                     _stream(local))
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
    with torch.cuda.device(ext.device):
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
    of launches, on the shards' device: int32 (2, 10, n·grid) by launch
    parity (``cuda_adaptive.STATE_FIELDS``: rows lo0, hi0, lo1, hi1 in each
    shard's row frame, clo, chi in its words, and the change rectangle
    r8, n8, c128, n128 in chunk units; stripe i of shard s at s·grid + i),
    the kernel's row flags (int32[n·h_loc], zero between launches) and
    column extremes (``cuda_adaptive.column_span``), the last launch's
    route of each stripe (int32[n·grid], ``cuda_adaptive.ROUTE_*``), and
    the skip count of each shard (int32[n]) and the activity of each
    stripe (int32[n·grid]) accumulated over the chunk."""

    state: torch.Tensor
    rowflag: torch.Tensor
    colspan: torch.Tensor
    route: torch.Tensor
    skipped: torch.Tensor
    act: torch.Tensor

    @classmethod
    def start(cls, n: int, h_loc: int, plan: AdaptivePlan, device) -> "MeshState":
        """The state of ``n`` shards before a chunk's first launch, which
        forces every stripe to compute and so reads none of it."""
        total = n * plan.grid(h_loc)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return cls(zeros(2, len(cuda_adaptive.STATE_FIELDS), total), zeros(n * h_loc),
                   cuda_adaptive.column_span(total, device), zeros(total), zeros(n), zeros(total))


def peer_states(n: int, h_loc: int, plan: AdaptivePlan, devices: list) -> list[MeshState]:
    """The state of ``n`` shards for launch groups on ``devices`` (one a
    group; the first holds the mesh's first shard): one interval state
    array on ``devices[0]``, which every group reads and writes (the peer
    form: through peer access), and each group's own row flags, column
    extremes, routes, skip counts and activity on its device, at full size
    so the kernels' indexing is the one-card form's, each group touching
    its own shards' entries alone.  One group is :meth:`MeshState.start`."""
    first = MeshState.start(n, h_loc, plan, devices[0])
    return [first] + [dataclasses.replace(MeshState.start(n, h_loc, plan, d), state=first.state)
                      for d in devices[1:]]


def merge_states(states: list[MeshState], stats_only: bool = False) -> MeshState:
    """The launch groups' states as one, on the first group's device: the
    one interval state array, and each stripe's row flags, route, skip
    count and activity from the group that owns it (the sum: every other
    group left its entry at 0) and its column extremes (the least and the
    greatest: every other group left (2^30, -2^30)).  ``stats_only``: the
    skip counts and activity alone (what a dispatch reads), the row flags,
    column extremes and routes left the first group's."""
    if len(states) == 1:
        return states[0]
    dev = states[0].state.device

    def summed(field):
        return sum(getattr(st, field).to(dev) for st in states)

    if stats_only:
        return dataclasses.replace(states[0], skipped=summed("skipped"), act=summed("act"))
    spans = torch.stack([st.colspan.to(dev) for st in states])
    colspan = torch.stack([spans[..., 0].amin(0), spans[..., 1].amax(0)], dim=-1)
    return MeshState(states[0].state, summed("rowflag"), colspan.contiguous(), summed("route"),
                     summed("skipped"), summed("act"))


def _shard_cols(ids, grid: int, device) -> torch.Tensor:
    """The state columns (stripes s·grid + i) of the shards ``ids``."""
    return (torch.tensor(list(ids), device=device)[:, None] * grid
            + torch.arange(grid, device=device)).flatten()


def _check_shards(reads, writes, what: str) -> None:
    """Contiguous int32 words of one shape and one device kind, each
    shard's write buffer on its read buffer's device."""
    shape, kind = reads[0].shape, reads[0].device.type
    for t in (*reads, *writes):
        _check_words(t)
        if t.shape != shape or t.device.type != kind:
            raise ValueError(f"a mesh launch's {what} and buffers must share one shape and "
                             "device kind")
    if any(r.device != w.device for r, w in zip(reads, writes)):
        raise ValueError(f"a mesh launch writes each of its {what} on its own device")


def _check_ids(ids, n: int, devices: list) -> tuple[int, ...]:
    """The shard ids of one launch (None: all ``n``), after checking them:
    each in range, none twice, all on one device."""
    ids = tuple(range(n)) if ids is None else tuple(ids)
    if not ids or len(set(ids)) != len(ids) or not all(0 <= s < n for s in ids):
        raise ValueError(f"launch shard ids {ids} do not name distinct shards of {n}")
    if len({devices[s] for s in ids}) != 1:
        raise ValueError(f"launch shard ids {ids} lie on several devices")
    return ids


def _check_mega(reads, writes, st: MeshState, plan: AdaptivePlan) -> tuple[int, int]:
    """(ny, h_loc) of a K14 launch, after checking it: one write buffer a
    strip, all contiguous int32 words of one shape (each strip's buffers
    on its own device), no buffer written twice or both read and written,
    a frontier plan of whole stripes whose decision reach round8(T + 6)
    fits one stripe (so no window or decision reaches past the adjacent
    strip), and state of the mesh's size."""
    ny = len(reads)
    if ny < 1 or len(writes) != ny:
        raise ValueError(f"a mesh launch needs one write buffer a strip: {ny} strips, "
                         f"{len(writes)} buffers")
    shape = reads[0].shape
    _check_shards(reads, writes, "strips")
    out = {t.data_ptr() for t in writes}
    if len(out) != ny or out & {t.data_ptr() for t in reads}:
        raise ValueError("a mesh launch writes each buffer once and no strip it reads")
    h = shape[0]
    if not plan.frontier or h % plan.stripe_h or plan.pad_f > plan.stripe_h:
        raise ValueError(f"plan {plan} has no frontier form within one stripe of a strip of "
                         f"{h} rows: K14 reads no further than the adjacent strip")
    total = ny * plan.grid(h)
    if (st.state.shape != (2, len(cuda_adaptive.STATE_FIELDS), total)
            or st.rowflag.shape != (ny * h,)
            or st.skipped.shape != (ny,) or st.act.shape != (total,)):
        raise ValueError(f"mesh state {tuple(st.state.shape)} for {ny} strips of "
                         f"{plan.grid(h)} stripes")
    return ny, h


def _strip_mega(reads, writes, st: MeshState, plan: AdaptivePlan, parity: int, first: bool,
                advance, ids=None):
    """One K14 launch's decisions, routes, writes and measure in PyTorch,
    each strip's generations from ``advance(e, cells)``: (gen T, gen T + 6)
    of the strip's rows, from ``e``, the strip with T + 6 rows of the
    neighbour strips' read buffers a side, exact on ``cells`` (bool (h, wp):
    where the launch writes gen T) and on the measure region.  ``ids``
    (None: every strip) are the strips this launch covers, the kernel's
    table: only they are written, and only their entries of ``st``."""
    ny, h = _check_mega(reads, writes, st, plan)
    ids = _check_ids(ids, ny, [t.device for t in reads])
    sh, grid = plan.stripe_h, plan.grid(h)
    wp = reads[0].shape[1]
    total = ny * grid
    dev = reads[0].device
    halo = t6 = plan.t + SKIP_PERIOD
    g = torch.arange(total, device=dev)
    c_lo = g % grid * sh
    c_hi = c_lo + sh - 1
    prev = st.state[1 - parity].to(device=dev, dtype=torch.int64)
    if first:
        hit = torch.ones(total, dtype=torch.bool, device=dev)
        union = (c_lo - t6, c_hi + t6, torch.full_like(c_lo, _EMPTY_LO),
                 torch.full_like(c_lo, -_EMPTY_LO))
    else:
        ivals, cvals = [], []
        for slot in (-1, 0, 1):
            j = g + slot
            # The neighbour's strip less this stripe's, in rows.
            off = (torch.div(j, grid, rounding_mode="floor") - g // grid) * h
            j = torch.remainder(j, total)
            ivals += [(prev[2 * k][j] + off, prev[2 * k + 1][j] + off) for k in (0, 1)]
            cvals.append((prev[4][j], prev[5][j]))
        hit, *union = cuda_adaptive.hit_union(ivals, cvals, c_lo, c_hi, plan)
    rt = cuda_adaptive.frontier_routes(hit, *union, c_lo, plan, (h, wp), (0, h))
    copy = list(cuda_adaptive.rect_region(prev[6:10], plan, (h, wp)))
    moved = (rt.route == cuda_adaptive.ROUTE_SKIP) | (rt.route == cuda_adaptive.ROUTE_TIER)
    copy[1] = torch.where(moved, copy[1], copy[0])
    intervals = []
    for s in ids:
        mine = slice(s * grid, (s + 1) * grid)
        masks = cuda_adaptive.routed_masks(rt.part(mine), [c[mine] for c in copy], h, wp, sh)
        e = torch.cat([reads[(s - 1) % ny][h - halo :], reads[s], reads[(s + 1) % ny][:halo]])
        g_t, g_t6 = advance(e, masks[0] & masks[1])
        out, part = cuda_adaptive.routed_launch(reads[s], writes[s], g_t, g_t6, masks, sh)
        writes[s].copy_(out)
        intervals.append(part)
    _publish(st, parity, ids, grid, torch.cat(intervals, dim=1), rt.rect, rt.route,
             (~hit).view(ny, grid).sum(dim=1))
    return writes


def _publish(st: MeshState, parity: int, ids, grid: int, intervals: torch.Tensor,
             rect: torch.Tensor, route: torch.Tensor, skips: torch.Tensor) -> None:
    """A plain launch's bookkeeping for the shards ``ids``: their
    ``intervals`` (6 rows, their stripes in ``ids`` order) and change
    rectangles into ``st.state[parity]``, their routes into ``st.route``,
    their skip counts (``skips``, one a shard of the mesh) added to
    ``st.skipped`` and a launch of activity to each stripe whose first
    row interval is nonempty; every other entry is left as it is."""
    cols = _shard_cols(ids, grid, rect.device)
    st.state[parity][:, cols.to(st.state.device)] = torch.cat([intervals, rect[:, cols]]).to(
        st.state)
    st.route[cols] = route[cols].to(st.route)
    at = torch.tensor(list(ids), device=skips.device)
    st.skipped[at] += skips[at].to(torch.int32)
    st.act[cols] += (intervals[0] <= intervals[1]).to(torch.int32)


def strip_mega_launch_plain(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                            parity: int, first: bool, ids=None):
    """Plain version of K14 (one launch of ``_kernel_frontier_mega_strip``
    over every strip of a row mesh, ``reads`` top to bottom): stripe i of
    strip s decides with ``_hit_union`` over the previous parity's row
    and column intervals of stripes i - 1, i and i + 1, read straight from
    the shared state (past the strip's edge the neighbour strip's edge
    stripe, its rows moved by -/+ h_loc into this strip's frame), or with
    ``first`` (launch 0 of a chunk) hits with the maximal union; a stripe
    that hits takes its route (``cuda_adaptive.frontier_routes``: the
    rectangle route where its column window lies inside the strip, else
    the row tier or the full window, on the strip with T + 6 rows of the
    neighbour strips' read buffers a side), writes its change rectangle
    and its previous one as ``_kernel_frontier_mega_strip`` does, and
    measures gen T + 6 against gen T on its measure region
    (``_measure2``); one that does not copies its previous change
    rectangle.  Writes ``writes``, ``st.state[parity]`` and ``st.route``,
    adds to ``st.skipped`` and ``st.act``; returns ``writes``.  ``ids``
    (None: every strip) are the strips the launch covers (the peer form's
    launch on one card): only their buffers and entries are written, and
    running the launches of a partition of the strips gives the one
    launch's result."""
    halo, h = plan.t + SKIP_PERIOD, reads[0].shape[0]

    def advance(e, _cells):
        g_t = packed.superstep(e, rule, plan.t)
        return g_t[halo : halo + h], packed.superstep(g_t, rule, SKIP_PERIOD)[halo : halo + h]

    return _strip_mega(reads, writes, st, plan, parity, first, advance, ids)


def strip_mega_launch_mirror(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                             parity: int, first: bool, blocks: RegPlan | None = None, ids=None):
    """K14's decomposition in PyTorch: the decisions and bookkeeping of
    :func:`strip_mega_launch_plain`, each strip's generations on the blocks
    of ``blocks`` (one strip's; None: the ``frontier_blocks`` of an H100
    for the launch's strips) through ``_frontier_blocks``, the strip's
    words wrapping modulo its width.  Writes what the plain version
    writes (``ids`` as there); returns ``writes``."""
    ny, h = _check_mega(reads, writes, st, plan)
    wp = reads[0].shape[1]
    blocks = blocks or frontier_blocks((h, wp), plan, ny if ids is None else len(ids))
    _check_frontier_blocks(blocks, plan, (h, wp))
    cols = torch.remainder(torch.arange(blocks.grid[1] * blocks.centre + 2) - 1, wp)

    def advance(e, cells):
        return _frontier_blocks(e[:, cols.to(e.device)], rule, blocks, plan.t, (h, wp),
                                cuda_adaptive._block_mask(cells, blocks))

    return _strip_mega(reads, writes, st, plan, parity, first, advance, ids)


def _launch_tables(sets, ids, device, flatten):
    """A group launcher's device tables, built once: a row of every shard's
    buffer pointers for each buffer set of ``sets`` (int64, keyed by the
    set's pointers), the launch's shard ids (int32) on ``device`` and on
    the host; copied without a wait from pinned memory on the device's
    current stream, and kept as long as the launcher (freed, the
    allocator could hand their memory to a tensor made between two
    launches)."""
    keys = [tuple(t.data_ptr() for t in flatten(bufs)) for bufs in sets]
    tabs = torch.tensor(keys, dtype=torch.int64).pin_memory().to(device, non_blocking=True)
    host_ids = torch.tensor(ids, dtype=torch.int32)
    dev_ids = host_ids.pin_memory().to(device, non_blocking=True)
    return dict(zip(keys, tabs)), dev_ids, host_ids


def _k14(sets, rule: LifeRule, plan: AdaptivePlan, ids=None, stream=None):
    """``(reads, writes, st, parity, first)`` -> one K14 launch over the
    strips ``ids`` (None: all) on their device, on ``stream`` (None: the
    device's current stream), ``reads`` and ``writes`` two of ``sets``
    (lists of buffers of one shape, one a strip, top to bottom, on any
    cards) whose pointer tables, and the ids' table, are built here once
    (:func:`_launch_tables`); its blocks ``frontier_blocks``'s for the
    launch's strips on the device's SMs, in the rule's instantiation;
    counted on ``strip_mega_launch.launches`` and ``.rules``."""
    ny = len(sets[0])
    ids = tuple(range(ny)) if ids is None else tuple(ids)
    like = sets[0][ids[0]]
    (h, wp), dev = like.shape, like.device
    row, dev_ids, host_ids = _launch_tables(sets, ids, dev, list)
    blocks = frontier_blocks((h, wp), plan, len(ids), device_sms(dev))
    sub_rows, col_window = cuda_adaptive.frontier_geometry(plan, (h, wp))
    lib, launch = _reg_launcher("frontier", "gol_strip_mega_launch", 10, 14)
    born, surv, variant = reg_rule(rule)
    stream = ctypes.c_void_p((stream or torch.cuda.current_stream(dev)).cuda_stream)

    def k14(reads, writes, st: MeshState, parity: int, first: bool) -> None:
        rd, wr = (row[tuple(t.data_ptr() for t in bufs)].data_ptr() for bufs in (reads, writes))
        with torch.cuda.device(dev):
            err = launch(rd, wr, dev_ids.data_ptr(), host_ids.data_ptr(), st.state.data_ptr(),
                         st.rowflag.data_ptr(), st.colspan.data_ptr(), st.skipped.data_ptr(),
                         st.act.data_ptr(), st.route.data_ptr(), len(ids), ny, h, wp, plan.t,
                         plan.stripe_h, blocks.tile_h, blocks.warps, plan.pad_f, sub_rows or 0,
                         col_window or 0, parity, int(first), variant, born, surv, stream)
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
    ``writes``, the launch checked with the chunk; in the peer form one
    card's); without it the launch is checked here, CPU tensors run
    :func:`strip_mega_launch_plain` and CUDA tensors launch K14 or raise
    (strips on several cards take :func:`strip_mega_launches`)."""
    if k14 is None:
        _check_mega(reads, writes, st, plan)
        if reads[0].device.type == "cpu":
            return strip_mega_launch_plain(reads, writes, st, rule, plan, parity, first)
        _check_ids(None, len(reads), [t.device for t in reads])
        k14 = _k14([reads, writes], rule, plan)
    k14(reads, writes, st, parity, first)
    return writes


strip_mega_launch.launches = 0
strip_mega_launch.rules = collections.Counter()


# -- the chunk of K14 or K15 launches, on one card or on several ------------------------


@functools.lru_cache(maxsize=None)
def enable_peer_access(card: torch.device, peer: torch.device) -> None:
    """Let ``card`` read and write ``peer``'s memory
    (``csrc/frontier.cu::gol_enable_peer_access``: access already enabled,
    by PyTorch's own copies among others, counts as done); once a pair.
    Raises where CUDA refuses (no peer path, too many peers)."""
    lib, enable = cuda_adaptive._launcher("frontier", "gol_enable_peer_access",
                                          [ctypes.c_int, ctypes.c_int])
    cuda_build.check(lib, enable(card.index, peer.index),
                     f"peer access from {card} to {peer}: the enabling")


class _Lanes:
    """The cross-card ordering of a chunk's launch groups, one stream a
    group (on several cards each card's current stream; on one card the
    streams stand in for cards): :meth:`enter` makes every group wait on
    what every device's current stream has enqueued (the chunk's inputs,
    buffers, state and tables: the TPU kernels' entry barrier); before
    each launch a group waits on the previous launch's events of the
    groups it reads (``waits``), and records its own after it;
    :meth:`join` makes every device's current stream wait on every
    group's last event, before anything is read, summed or freed there."""

    def __init__(self, devices: list, streams: list, waits: dict):
        self.devices, self.streams, self.waits = devices, streams, waits
        self.done = [None] * len(streams)  # each group's newest launch
        self.last = list(self.done)  # each group's launch before the current one

    def _current(self) -> list:
        return [torch.cuda.current_stream(d) for d in dict.fromkeys(self.devices)]

    def enter(self) -> None:
        entry = [torch.cuda.Event() for _ in self._current()]
        for ev, cur in zip(entry, self._current()):
            ev.record(cur)
        for s in self.streams:
            for ev in entry:
                s.wait_event(ev)

    def launch(self, g: int, fn) -> None:
        """Group ``g``'s launch ``fn`` (which enqueues on its stream), after
        the previous launch of the groups it reads."""
        stream = self.streams[g]
        for w in self.waits[g]:
            if self.last[w] is not None:
                stream.wait_event(self.last[w])
        fn()
        ev = torch.cuda.Event()
        ev.record(stream)
        self.done[g] = ev

    def advance(self) -> None:
        """After every group's launch l: launch l + 1 waits on these."""
        self.last = list(self.done)

    def join(self) -> None:
        for cur in self._current():
            for ev in self.done:
                cur.wait_event(ev)


def _mega_chunk(flat, nest, mesh_shape, rule, plan, nlaunch, plain, each, groups, streams,
                stats_only, check, launcher, plain_launch):
    """One chunk of ``nlaunch`` K14 or K15 launches over the shards
    ``flat`` (row-major; ``nest`` gives them the launch's layout) of a
    ``mesh_shape`` mesh, launch 0 forced, each launch writing the shards'
    buffers of two launches ago (two fresh buffers a shard; the input is
    never written).  ``groups`` (shard ids a group; None: one group a
    device, :func:`peer_groups`) partition the shards, each group's on one
    device; a launch is one launch a group, in group order (``launcher``:
    :func:`_k14` or :func:`_k15` for the group's ids on ``streams[g]``,
    None: each device's current stream), ordered across groups by
    :class:`_Lanes` where there are several, the peer access of several
    cards enabled first (:func:`enable_peer_access`); with ``plain``, or
    on the CPU, ``plain_launch`` runs each group's launch in turn.  Returns
    (shards in the launch's layout, :func:`merge_states` of the groups'
    states, with ``stats_only``); ``each(shards, state)`` is called after
    every launch with the groups' streams joined and their states merged
    in full, and the groups' next launches wait on what it enqueued."""
    n, h = len(flat), flat[0].shape[0]
    devices = [t.device for t in flat]
    groups = list(peer_groups(devices).values()) if groups is None else groups
    groups = [_check_ids(g, n, devices) for g in groups]
    if sorted(s for g in groups for s in g) != list(range(n)):
        raise ValueError(f"launch groups {groups} do not partition the {n} shards")
    lane_devices = [devices[g[0]] for g in groups]
    sts = peer_states(n, h, plan, lane_devices)
    bufs = [[torch.empty_like(t) for t in flat] for _ in range(2)]
    whole = len(groups) == 1
    lanes = None
    if devices[0].type == "cuda" and not plain:
        own_streams = streams is not None
        check(nest(flat), nest(bufs[0]), sts[0], plan)
        cards = peer_groups(devices)
        if len(cards) > 1:
            for card, peer in peer_pairs(cards, mesh_shape, _card(lane_devices[0])):
                enable_peer_access(card, peer)
        streams = streams or [torch.cuda.current_stream(d) for d in lane_devices]
        if len(streams) != len(groups):
            raise ValueError(f"{len(streams)} streams for {len(groups)} launch groups")
        launchers = [launcher([flat, *bufs], g, s) for g, s in zip(groups, streams)]
        if not whole or own_streams:
            lanes = _Lanes(lane_devices, streams, peer_waits(dict(enumerate(groups)), mesh_shape))
            lanes.enter()
    cur = flat
    for k in range(nlaunch):
        rd, wr = nest(cur), nest(bufs[k % 2])
        for g, ids in enumerate(groups):
            if devices[0].type == "cpu" or plain:
                args = (rd, wr, sts[g], rule, plan, k % 2, k == 0)
                plain_launch(*args) if whole else plain_launch(*args, ids=ids)
            elif lanes is None:
                launchers[g](rd, wr, sts[g], k % 2, k == 0)
            else:
                lanes.launch(g, functools.partial(launchers[g], rd, wr, sts[g], k % 2, k == 0))
        if lanes is not None:
            lanes.advance()
        cur = bufs[k % 2]
        if each is not None:
            if lanes is not None:
                lanes.join()
            each(nest(cur), merge_states(sts))
            if lanes is not None:
                lanes.enter()  # what each enqueued reads the buffers the next launches write
    if lanes is not None:
        lanes.join()
    return nest(cur), merge_states(sts, stats_only)


def strip_mega_launches(strips, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
                        plain: bool = False, each=None, groups=None, streams=None,
                        stats_only: bool = False):
    """One chunk of the in-kernel tier: ``nlaunch`` K14 launches over
    every strip of a row mesh, from a restarted state (launch 0 forces
    every stripe to compute), each launch writing the strips' buffers of
    two launches ago (two fresh buffers a strip; the input is never
    written).  Returns (strips, :class:`MeshState`): the chunk's final
    state, its skip count per strip and its activity per stripe, all left
    on the first strip's device.  On the card the chunk is checked and its
    launchers (:func:`_k14`: the pointer tables) built once, then each
    launch is one wrapper call a group, nothing read back between
    launches; strips on several cards run the peer form, one launch a
    card over its own strips (:func:`_mega_chunk`; ``groups`` and
    ``streams`` split one card's strips into groups on streams of their
    own, standing in for cards).  ``plain`` runs
    :func:`strip_mega_launch_plain` instead (on the CPU the wrapper runs
    it anyway, a group at a time); ``each(strips, st)`` is called after
    every launch (the launch-by-launch check).  ``stats_only``: of the
    groups' states only the skip counts and activity are merged
    (:func:`merge_states`; a dispatch reads nothing else)."""
    return _mega_chunk(
        list(strips), list, (len(strips), 1), rule, plan, nlaunch, plain, each, groups, streams,
        stats_only, _check_mega, lambda sets, ids, stream: _k14(sets, rule, plan, ids, stream),
        lambda *a, **kw: strip_mega_launch_plain(*a, **kw))


# -- K15: the 2-D megakernel ---------------------------------------------------------


def _check_tile_mega(reads, writes, st: MeshState, plan: AdaptivePlan) -> tuple[int, int, int, int]:
    """(ny, nx, h_loc, wpl) of a K15 launch, after checking it: ``reads``
    and ``writes`` are rows of tiles, one write buffer a tile, all
    contiguous int32 words of one shape (each tile's buffers on its own
    device), no buffer written
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
    shape = flat_r[0].shape
    _check_shards(flat_r, flat_w, "tiles")
    out = {t.data_ptr() for t in flat_w}
    if len(out) != ny * nx or out & {t.data_ptr() for t in flat_r}:
        raise ValueError("a 2-D mesh launch writes each buffer once and no tile it reads")
    h, wpl = shape
    if (not plan.frontier or h % plan.stripe_h or plan.pad_f > plan.stripe_h
            or plan.t + SKIP_PERIOD > WORD * wpl):
        raise ValueError(f"plan {plan} has no frontier form within one stripe and one tile of "
                         f"{h}x{wpl} words: K15 reads no further than the adjacent tiles")
    total = ny * nx * plan.grid(h)
    if (st.state.shape != (2, len(cuda_adaptive.STATE_FIELDS), total)
            or st.rowflag.shape != (ny * nx * h,)
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


def tile_mega_routes(prev: torch.Tensor, mesh_shape: tuple[int, int], shape: tuple[int, int],
                     plan: AdaptivePlan, first: bool, elide: bool = False):
    """Every stripe's decision and route in a K15 launch from ``prev``, the
    previous parity's (10, ny·nx·grid) state of a ``mesh_shape`` mesh of
    tiles of ``shape`` = (h_loc, wpl) words (int64).  Stripe i of tile (dy,
    dx) folds nine neighbours (``hit_union``): its own stripes i - 1, i
    and i + 1 and the same stripes of the W and E tiles, whose row frames
    are its own and whose column intervals move by -wpl (W) and +wpl (E)
    into its words, by side and not by tile (a (1, 2) mesh sees its one
    other tile at both shifts); past the tile's edge the N or S tile row's
    edge stripe, its rows moved by -/+ h_loc (for an interior stripe the
    JAX kernel's nine).  An interior stripe takes
    ``cuda_adaptive.frontier_routes`` on the tile, the rectangle route's
    window inside its rows; the edge stripes and, with ``first``, every
    stripe hit with the maximal union, which takes the full route, as
    ``_kernel_frontier_mega_2d`` forces them; with ``elide``, an edge stripe
    whose neighbours do not hit is elided instead: counted computed, not
    computed, writing nothing, publishing its whole centre.  Returns
    (``Routes``, (hit, u_lo, u_hi, u_clo, u_chi) of the nine before the
    forcing, the elided stripes: bool, tile-major)."""
    ny, nx = mesh_shape
    h, wpl = shape
    sh, grid = plan.stripe_h, plan.grid(h)
    t6 = plan.t + SKIP_PERIOD
    g = torch.arange(ny * nx * grid, device=prev.device)
    v, i = g // grid, g % grid
    dy, dx = v // nx, v % nx
    c_lo = i * sh
    c_hi = c_lo + sh - 1
    ivals, cvals = [], []
    for side in (-1, 0, 1):  # the W, own and E tiles
        tx = (dx + side) % nx
        for slot in (-1, 0, 1):
            j = i + slot
            shift = torch.div(j, grid, rounding_mode="floor")  # -1 above the tile, 1 below
            at = (((dy + shift) % ny) * nx + tx) * grid + torch.remainder(j, grid)
            ivals += [(prev[2 * k][at] + shift * h, prev[2 * k + 1][at] + shift * h)
                      for k in (0, 1)]
            cvals.append((prev[4][at] + side * wpl, prev[5][at] + side * wpl))
    union = cuda_adaptive.hit_union(ivals, cvals, c_lo, c_hi, plan)
    hit, u_lo, u_hi, u_clo, u_chi = union
    edge = (i == 0) | (i == grid - 1)
    forced = edge | first
    rt = cuda_adaptive.frontier_routes(hit | forced, torch.where(forced, c_lo - t6, u_lo),
                                       torch.where(forced, c_hi + t6, u_hi), u_clo, u_chi, c_lo,
                                       plan, shape, (0, h))
    elided = edge & ~hit if elide and not first else torch.zeros_like(edge)
    zero = torch.zeros_like(c_lo)
    rt.route = torch.where(elided, cuda_adaptive.ROUTE_ELIDED, rt.route)
    rt.w_lo = torch.where(elided, zero, rt.w_lo)
    rt.w_hi = torch.where(elided, zero, rt.w_hi)
    return rt, union, elided


def _tile_mega(reads, writes, st: MeshState, plan: AdaptivePlan, parity: int, first: bool,
               advance, elide: bool, ids=None):
    """One K15 launch's decisions, routes, writes and measure in PyTorch,
    each tile's generations from ``advance(ty, tx, cells)``: (gen T, gen
    T + 6) of tile (ty, tx), exact on ``cells`` (bool (h_loc, wpl): where
    the launch writes gen T) and on the measure region.  Each stripe takes
    its route (:func:`tile_mega_routes`, with ``elide`` the kernel's
    elision of quiet edge stripes), writes its change rectangle, copies
    its previous one where it skips, takes the rectangle route or is
    elided, and measures gen T + 6 against gen T on its measure region in
    the tile's own words (``_measure2``).  ``ids`` (None: every tile,
    row-major) are the tiles the launch covers: only they are written,
    and only their entries of ``st``.  Returns the elided stripes (bool,
    tile-major; those of the launch's tiles)."""
    ny, nx, h, wpl = _check_tile_mega(reads, writes, st, plan)
    ids = _check_ids(ids, ny * nx, [t.device for r in reads for t in r])
    sh, grid = plan.stripe_h, plan.grid(h)
    dev = reads[0][0].device
    prev = st.state[1 - parity].to(device=dev, dtype=torch.int64)
    rt, _, elided = tile_mega_routes(prev, (ny, nx), (h, wpl), plan, first, elide)
    mine = torch.zeros_like(elided)
    mine[_shard_cols(ids, grid, dev)] = True
    elided &= mine
    copy = list(cuda_adaptive.rect_region(prev[6:10], plan, (h, wpl)))
    moved = ((rt.route == cuda_adaptive.ROUTE_SKIP) | (rt.route == cuda_adaptive.ROUTE_TIER)
             | elided)
    copy[1] = torch.where(moved, copy[1], copy[0])
    intervals = []
    for v in ids:
        ty, tx = divmod(v, nx)
        part_of = slice(v * grid, (v + 1) * grid)
        masks = cuda_adaptive.routed_masks(rt.part(part_of), [c[part_of] for c in copy], h, wpl,
                                           sh)
        g_t, g_t6 = advance(ty, tx, masks[0] & masks[1])
        out, part = cuda_adaptive.routed_launch(reads[ty][tx], writes[ty][tx], g_t, g_t6, masks,
                                                sh)
        writes[ty][tx].copy_(out)
        intervals.append(part)
    _publish(st, parity, ids, grid, torch.cat(intervals, dim=1), rt.rect, rt.route,
             (rt.route == cuda_adaptive.ROUTE_SKIP).view(ny * nx, grid).sum(dim=1))
    return elided


def tile_mega_launch_plain(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                           parity: int, first: bool, ids=None):
    """Plain version of K15 (one launch of ``_kernel_frontier_mega_2d``
    over every tile of a 2-D mesh, ``reads`` as rows of tiles): stripe i
    of tile (dy, dx) decides with ``_hit_union`` over the previous
    parity's row and column intervals of nine stripes, read straight from
    the shared state: its own stripes i - 1, i and i + 1 and the same
    stripes of the W and E tiles (whose row frames are its own, whose
    column intervals move by -/+ wpl into its words); the edge stripes (i
    = 0, grid - 1), and every stripe with ``first`` (launch 0 of a chunk),
    hit with the maximal union and take the full route, as the JAX kernel
    forces them.  An interior stripe that hits takes its route
    (``cuda_adaptive.frontier_routes`` on the tile: the rectangle route
    where its window lies inside the tile, else the row tier or the full
    window), each on the tile with T + 6 rows and ceil((T + 6) / 32) words
    of the neighbour tiles' read buffers, corners included, writes its
    change rectangle and its previous one as the JAX kernel does, and
    measures gen T + 6 against gen T on its measure region (``_measure2``;
    the column interval in the tile's own words); one that does not copies
    its previous change rectangle.  Writes ``writes``, ``st.state[parity]``
    and ``st.route``, adds to ``st.skipped`` and ``st.act``; returns
    ``writes``.  ``ids`` (None: every tile) are the tiles the launch
    covers (the peer form's launch on one card), as K14's plain version
    takes its strips."""
    halo = plan.t + SKIP_PERIOD
    xw = -(-halo // WORD)
    h, wpl = reads[0][0].shape
    centre = (slice(halo, halo + h), slice(xw, xw + wpl))

    def advance(ty, tx, _cells):
        g_t = packed.superstep(_tile_window(reads, ty, tx, halo, xw), rule, plan.t)
        return g_t[centre], packed.superstep(g_t, rule, SKIP_PERIOD)[centre]

    _tile_mega(reads, writes, st, plan, parity, first, advance, False, ids)
    return writes


def tile_mega_launch_mirror(reads, writes, st: MeshState, rule: LifeRule, plan: AdaptivePlan,
                            parity: int, first: bool, blocks: RegPlan | None = None, ids=None):
    """K15's decomposition in PyTorch: the blocks of ``blocks`` (one
    tile's; None: the ``frontier_blocks`` of an H100 for the launch's
    tiles, ``ids`` as in the plain version)
    through :func:`_frontier_blocks`, only the blocks whose tile meets the
    cells their stripe's route writes as gen T stepping
    (``cuda_adaptive._block_mask``), each tile's window from the tiles'
    torus, and the kernel's decisions: an edge stripe decides from its
    3x3-tile neighbourhood and is elided where that proves it stable
    (counted in ``tile_mega_launch_mirror.elided``; the last launch's
    elided stripes, tile-major, in ``.last_elided``), every other decision
    as :func:`tile_mega_launch_plain`'s.  Writes what the plain version
    writes; returns ``writes``."""
    ny, nx, h, wpl = _check_tile_mega(reads, writes, st, plan)
    blocks = blocks or frontier_blocks((h, wpl), plan, ny * nx if ids is None else len(ids))
    _check_frontier_blocks(blocks, plan, (h, wpl))
    whole = torch.cat([torch.cat(r, dim=1) for r in reads])
    halo, dev = plan.t + SKIP_PERIOD, whole.device
    rows = torch.arange(h + 2 * halo, device=dev) - halo
    cols = torch.arange(blocks.grid[1] * blocks.centre + 2, device=dev) - 1

    def advance(ty, tx, cells):
        src = whole[torch.remainder(ty * h + rows, ny * h)][:, torch.remainder(
            tx * wpl + cols, nx * wpl)]
        return _frontier_blocks(src, rule, blocks, plan.t, (h, wpl),
                                cuda_adaptive._block_mask(cells, blocks))

    elided = _tile_mega(reads, writes, st, plan, parity, first, advance, True, ids)
    tile_mega_launch_mirror.elided += int(elided.sum())
    tile_mega_launch_mirror.last_elided = elided
    return writes


tile_mega_launch_mirror.elided = 0
tile_mega_launch_mirror.last_elided = None


def _k15(sets, rule: LifeRule, plan: AdaptivePlan, ids=None, stream=None):
    """``(reads, writes, st, parity, first)`` -> one K15 launch over the
    tiles ``ids`` (row-major; None: all) on their device, on ``stream``
    (None: the device's current stream), ``reads`` and ``writes`` two of
    ``sets`` (rows of tiles of one shape, on any cards) whose pointer
    tables (int64[ny·nx] each, row-major), and the ids' table, are built
    here once (:func:`_launch_tables`); its blocks ``frontier_blocks``'
    for the launch's tiles on the device's SMs, at the active geometry on
    one tile (``cuda_adaptive.frontier_geometry``), in the rule's
    instantiation; counted on ``tile_mega_launch.launches`` and
    ``.rules``."""
    ny, nx = len(sets[0]), len(sets[0][0])
    ids = tuple(range(ny * nx)) if ids is None else tuple(ids)
    like = sets[0][ids[0] // nx][ids[0] % nx]
    (h, wpl), dev = like.shape, like.device

    def flatten(bufs):
        return [t for r in bufs for t in r]

    row, dev_ids, host_ids = _launch_tables(sets, ids, dev, flatten)
    blocks = frontier_blocks((h, wpl), plan, len(ids), device_sms(dev))
    sub_rows, col_window = cuda_adaptive.frontier_geometry(plan, (h, wpl))
    lib, launch = _reg_launcher("frontier", "gol_tile_mega_launch", 10, 15)
    born, surv, variant = reg_rule(rule)
    stream = ctypes.c_void_p((stream or torch.cuda.current_stream(dev)).cuda_stream)

    def k15(reads, writes, st: MeshState, parity: int, first: bool) -> None:
        rd, wr = (row[tuple(t.data_ptr() for t in flatten(bufs))].data_ptr()
                  for bufs in (reads, writes))
        with torch.cuda.device(dev):
            err = launch(rd, wr, dev_ids.data_ptr(), host_ids.data_ptr(), st.state.data_ptr(),
                         st.rowflag.data_ptr(), st.colspan.data_ptr(), st.skipped.data_ptr(),
                         st.act.data_ptr(), st.route.data_ptr(), len(ids), ny, nx, h, wpl,
                         plan.t, plan.stripe_h, blocks.tile_h, blocks.warps, plan.pad_f,
                         sub_rows or 0, col_window or 0, parity, int(first), variant, born, surv,
                         stream)
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
    chunk's launcher (:func:`_k15`; in the peer form one card's); without
    it the launch is checked here, CPU tensors run
    :func:`tile_mega_launch_plain` and CUDA tensors launch K15 or raise
    (tiles on several cards take :func:`tile_mega_launches`)."""
    if k15 is None:
        _check_tile_mega(reads, writes, st, plan)
        if reads[0][0].device.type == "cpu":
            return tile_mega_launch_plain(reads, writes, st, rule, plan, parity, first)
        _check_ids(None, len(reads) * len(reads[0]), [t.device for r in reads for t in r])
        k15 = _k15([reads, writes], rule, plan)
    k15(reads, writes, st, parity, first)
    return writes


tile_mega_launch.launches = 0
tile_mega_launch.rules = collections.Counter()


def tile_mega_launches(tiles, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
                       plain: bool = False, each=None, groups=None, streams=None,
                       stats_only: bool = False):
    """One chunk of the in-kernel tier on a 2-D mesh: ``nlaunch`` K15
    launches over every tile (``tiles``: rows of tiles), from a restarted
    state, each launch writing the tiles' buffers of two launches ago (two
    fresh buffers a tile; the input is never written).  Returns (tiles,
    :class:`MeshState`): the chunk's final tiles, state, skip count per
    tile and activity per stripe (tile-major), all left on the first
    tile's device.  On the card the chunk is checked and its launchers
    (:func:`_k15`) built once, then each launch is one wrapper call a
    group; tiles on several cards run the peer form (:func:`_mega_chunk`,
    ``groups`` (tile ids, row-major), ``streams`` and ``stats_only`` as
    for :func:`strip_mega_launches`).  ``plain`` runs
    :func:`tile_mega_launch_plain` instead (on the CPU the wrapper runs it
    anyway); ``each(tiles, st)`` is called after every launch (the
    launch-by-launch check)."""
    ny, nx = len(tiles), len(tiles[0])

    def nest(flat):
        return [flat[r * nx : (r + 1) * nx] for r in range(ny)]

    return _mega_chunk(
        [t for r in tiles for t in r], nest, (ny, nx), rule, plan, nlaunch, plain, each, groups,
        streams, stats_only, _check_tile_mega, lambda sets, ids, stream: _k15(
            [nest(s) for s in sets], rule, plan, ids, stream),
        lambda *a, **kw: tile_mega_launch_plain(*a, **kw))


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
    """The interval exchange of K12: each strip's interval state (rows 0-5
    of its (7, grid) state: the row intervals, then the column interval)
    extended with its north neighbour's last stripe, its rows shifted by
    -h_loc into this strip's row frame, and its south neighbour's first,
    its rows shifted by +h_loc (int32[6][grid + 2]; the column intervals
    are board words and cross unshifted; ``halo.neighbour_edges``,
    ``span`` for a process-spanning mesh).  An empty interval (lo > hi)
    stays empty: both ends move by the same offset."""
    edges = neighbour_edges(states, lambda s: s[:6, -1:], lambda s: s[:6, :1], span)
    shift = torch.tensor([[1], [1], [1], [1], [0], [0]], dtype=torch.int32) * h_loc
    return [torch.cat([north.to(s.device) - shift.to(s.device), s[:6],
                       south.to(s.device) + shift.to(s.device)], dim=1)
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
    states = [FrontierState.start(tuple(t.shape), plan, t.device) for t in strips]
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
        strips, st = strip_mega_launches(strips, rule, plan, c, stats_only=True)
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
        tiles, st = tile_mega_launches(board.shards, rule, plan, c, stats_only=True)
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
            tiles, st = tile_mega_launches(tiles, rule, plan, c, stats_only=True)
            skipped, act = skipped + st.skipped.sum().to(torch.int32), act + tile_activity(
                st.act, ny, nx)
        board = torch.cat([torch.cat(r, dim=1) for r in tiles])
        tail = loose * plan.t + rem
        if tail:
            board = packed.superstep(board, rule, tail)
        return (board, skipped, act) if with_stats else board

    return run
