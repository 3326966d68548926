"""The adaptive (``skip_stable``) tier of the packed engine on an H100.

Counterpart of the adaptive half of ``distributed_gol_tpu/ops/pallas_packed.py``
(``_run_tiled`` with ``skip_stable=True``).  A dispatch is split as the
JAX package splits it: the full launches of T generations go through the
frontier kernel in canonical chunks (``_nlaunch_chunks``), the loose tail
through the probing kernel, the period-multiple part of the remainder
through the skip form of the tiled kernel, and the last < 6 generations
through the plain tiled kernel (K2).  Four CUDA kernels (``csrc/``), each
with a wrapper, a launch counter (and one by rule instantiation) and a
plain PyTorch version, each stepping register-resident windows
(``csrc/regwin.cuh``):

- **K3, tiled_skip** (``csrc/tiled_skip.cu``; replaces ``_kernel`` in its
  ``skip_stable=True`` form): K2's register-resident window over the torus
  in place with the 6-generation probe, on the blocks of
  :func:`tiled_skip_reg_plan`.  Plain version:
  :func:`tiled_skip_superstep_plain`; :func:`tiled_skip_reg_mirror`
  replays its blocks.
- **K4, probing** (``csrc/probing.cu``; replaces ``_kernel_adaptive``):
  one launch per call of the JAX per-launch form, with its stripe bitmap,
  probe elision and write elision, on K11's register probing block over
  the board in place (the blocks of :func:`probing_reg_plan`).  Plain
  version: :func:`probing_launch_mirror`; :func:`probing_launch_reg_mirror`
  replays its blocks.
- **K5, frontier** (``csrc/frontier.cu``; replaces
  ``_kernel_frontier_mega``): the tracked-interval skip/compute/measure
  state machine, one CUDA launch per generation launch, state on the
  device, on the blocks of :func:`frontier_blocks`, with the JAX kernel's
  compute routes (the rectangle route, the row tier, the full window) at
  the plan geometry (:class:`PlanGeometry`, :func:`frontier_geometry`)
  and its change-rectangle writes; the decisions' one Python home is
  :func:`hit_union`, :func:`frontier_placement`, :func:`col_placement`
  and :func:`frontier_routes`.  Plain version:
  :func:`frontier_launch_mirror`; :func:`frontier_launch_reg_mirror`
  replays its blocks.
- **K8, frontier batched** (``csrc/frontier.cu``,
  ``gol_frontier_batched_launch``; replaces the ``nboards > 1`` form of
  ``_kernel_frontier_mega``): K5 over a (B, H, wp) stack, each board its
  own torus, with a skip count per board.  Plain version:
  :func:`frontier_superstep_batched_mirror`; :func:`frontier_batched_reg_mirror`
  replays its blocks.  :func:`run_tiled_batched` is
  ``_run_tiled_batched``: the canonical chunks of a dispatch on K8, the
  rest per slot on the solo kernels.

The mirrors replay the stripe decomposition, the decision regions and the
state machine (and the kernels' ping-pong buffer protocol), so they give
the skip count and the per-stripe activity as well as the board, at any
plan — the JAX package's included (``plan=``).  A wrapper given a CPU
tensor runs its plain version; given a CUDA tensor it launches its kernel
or raises.  :func:`adaptive_superstep` drives the kernels,
:func:`adaptive_superstep_mirror` the plain versions.

The plan (:class:`AdaptivePlan`) is the port's own; the TPU's tuning
constants (``_FRONTIER_T``, ``_SETTLED_T``, ``_SKIP_TILE_CAP*``,
``_LAUNCH_COST``, ``_vmem_budget``) are v5e measurements and are not
carried over.  The plan geometry is the JAX package's, with its API.  No
state survives a dispatch (it lives in the wrappers' buffers), so
checkpoints carry nothing new.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools

import torch

from distributed_gol_torch.models.life import CONWAY, HIGHLIFE, LifeRule
from distributed_gol_torch.ops import cuda_build, cuda_packed, packed
from distributed_gol_torch.ops.cuda_packed import (
    H100_SMS, TILED_MAX_T, _check_words, _stream, rule_masks,
)
from distributed_gol_torch.ops.packed import WORD

# -- the plan vocabulary (copies of pallas_packed.py's) ------------------------

#: The skip proof's stability window: launches are multiples of it.
SKIP_PERIOD = 6
_NLAUNCH_CANON = (512, 64, 8)
_EMPTY_LO = 1 << 30  # an empty interval is (_EMPTY_LO, -1)

# Deepest adaptive launch: the frontier kernel runs T + 6 generations, and
# one halo word per side (32 cells) must cover them.
ADAPTIVE_MAX_T = 24
# The port's plan for this card, from ``chip_smoke.py --sweep`` on an
# H100 (PERF.md, PR 2): T = 24 beat 6, 12 and 18 on the fresh soup, on
# settled ash with gliders and on the whole 16384² x 100,000 run; 256-row
# stripes tied larger ones on the fresh soup and beat them with gliders.
ADAPTIVE_T = 24
SKIP_TILE_CAP = 256


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _adaptive_eligible(turns: int) -> bool:
    """Whether a launch of ``turns`` generations may use the skip proof."""
    return turns >= SKIP_PERIOD and turns % SKIP_PERIOD == 0


def skip_plan(t: int) -> tuple[int, bool]:
    """Round a launch depth to the adaptive contract (period-multiple
    launches).  Returns (rounded t, adaptive?)."""
    if t > SKIP_PERIOD:
        t -= t % SKIP_PERIOD
    return t, _adaptive_eligible(t)


def skip_covers_rule(rule: LifeRule) -> bool:
    """Whether the stability window covers ``rule``'s settled debris: its
    ash period is known and divides the window.  False means stripes of
    common ash would never prove stable (the skip stays exact but pays its
    probe for nothing), which the Backend warns about."""
    period = rule.ash_period
    return period is not None and SKIP_PERIOD % period == 0


def _nlaunch_chunks(full: int) -> tuple[list[int], int]:
    """Decompose ``full`` frontier launches into canonical chunk sizes plus
    a loose tail (< min(_NLAUNCH_CANON)) for the probing form.  Each chunk
    starts with its state reset and its launch 0 forced full."""
    chunks: list[int] = []
    for c in _NLAUNCH_CANON:
        n, full = divmod(full, c)
        chunks.extend([c] * n)
    return chunks, full


# -- the port's plan -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdaptivePlan:
    """One adaptive dispatch's geometry: launches of ``t`` generations on
    row stripes of ``stripe_h`` rows; ``frontier`` says whether the full
    launches run the frontier kernel (else all of them probe)."""

    t: int
    stripe_h: int
    frontier: bool

    def __post_init__(self):
        if not _adaptive_eligible(self.t) or self.t > ADAPTIVE_MAX_T or self.stripe_h < 1:
            raise ValueError(
                f"invalid adaptive plan {self}: t must be a multiple of "
                f"{SKIP_PERIOD} in [{SKIP_PERIOD}, {ADAPTIVE_MAX_T}]"
            )
        if self.frontier and self.pad_f > self.stripe_h:
            raise ValueError(f"invalid adaptive plan {self}: round8(t + 6) > stripe_h")

    @property
    def pad(self) -> int:
        """The probe's halo, the JAX kernel's round8(t): its inner region
        is the one ``_probe_state`` tests."""
        return _round8(self.t)

    @property
    def pad_f(self) -> int:
        """The frontier decision's reach past the centre, round8(t + 6)."""
        return _round8(self.t + SKIP_PERIOD)

    def grid(self, h: int) -> int:
        return h // self.stripe_h


def supports(shape: tuple[int, int]) -> bool:
    """Packed (H, wp) shapes the adaptive tier takes: H a multiple of 8, so
    that a multiple-of-8 stripe height divides it."""
    h, wp = shape
    return h >= 8 and h % 8 == 0 and wp >= 1


def stripe_height(h: int, cap: int = 0) -> int | None:
    """The largest multiple-of-8 divisor of ``h`` no greater than ``cap``
    (0 = ``SKIP_TILE_CAP``), or None."""
    cap = cap or SKIP_TILE_CAP
    best = None
    for d in range(8, min(h, cap) + 1, 8):
        if h % d == 0:
            best = d
    return best


def fit_probe_halo(t: int, stripe_h: int) -> int:
    """The launch depth ``t`` (a multiple of 6) lowered in steps of 6 until
    the probe halo round8(T) fits in one stripe of ``stripe_h`` rows (at
    least 8): the JAX plan's rule (``_tile_for_pad``: pad <= tile_h).  A
    stripe's elision reads only its neighbours' flags (three on a board or
    a strip, nine on a 2-D tile), so no window may reach further than the
    adjacent stripes."""
    while _round8(t) > stripe_h:
        t -= SKIP_PERIOD
    return t


def adaptive_plan(shape: tuple[int, int], turns: int, cap: int = 0) -> AdaptivePlan | None:
    """The port's plan for a ``turns``-generation dispatch of a packed
    (H, wp) board, or None when it runs no adaptive launch (fewer than 6
    turns, or no stripe height): T = min(24, turns) rounded down to a
    multiple of 6, then lowered until its probe halo fits a stripe
    (:func:`fit_probe_halo`)."""
    stripe_h = stripe_height(shape[0], cap) if supports(shape) else None
    t, adaptive = skip_plan(min(ADAPTIVE_T, turns))
    if not adaptive or stripe_h is None:
        return None
    t = fit_probe_halo(t, stripe_h)
    return AdaptivePlan(t, stripe_h, frontier=_round8(t + SKIP_PERIOD) <= stripe_h)


def adaptive_tile_launches(
    shape: tuple[int, int], turns: int, cap: int = 0, plan: AdaptivePlan | None = None
) -> int:
    """How many stripe-launches an adaptive dispatch performs: the skip
    fraction's denominator, from the plan the dispatch runs (the remainder
    launches are excluded, as in the JAX package)."""
    plan = plan if plan is not None else adaptive_plan(shape, turns, cap)
    if plan is None:
        return 0
    return (turns // plan.t) * plan.grid(shape[0])


# -- the plan geometry (a copy of pallas_packed.py's geometry API) ---------------

#: The column tier's shipped width in words: two 128-word placement quanta.
_COL_WINDOW = 256


class PlanGeometry(tuple):
    """The two static levers of the frontier kernels' compute tiers:
    ``(sub_margin, col_window)``.  The row tier steps a sub-window of
    ``round8(4·T + sub_margin)`` rows of a stripe's window at full width;
    the column tier (K12) and the rectangle route (K5, K8, K14) step that
    sub-window only ``col_window`` words wide (0: no column tier).  Always
    sound: every stripe checks exactly whether its activity fits, and a
    geometry only changes which route computes it."""

    __slots__ = ()

    def __new__(cls, sub_margin: int, col_window: int):
        if sub_margin < 48 or sub_margin % 8:
            raise ValueError(
                f"sub_margin must be a multiple of 8 >= 48, got {sub_margin}"
            )
        if col_window and (col_window < 128 or col_window % 128):
            raise ValueError(
                f"col_window must be 0 (off) or a multiple of 128, got {col_window}"
            )
        return super().__new__(cls, (int(sub_margin), int(col_window)))

    @property
    def sub_margin(self) -> int:
        return self[0]

    @property
    def col_window(self) -> int:
        return self[1]

    @property
    def label(self) -> str:
        return f"m{self.sub_margin}c{self.col_window or 'off'}"


_GEOMETRY_SHIPPED = PlanGeometry(96, _COL_WINDOW)
_plan_geometry = _GEOMETRY_SHIPPED


def plan_geometry() -> PlanGeometry:
    """The process-wide frontier plan geometry."""
    return _plan_geometry


def geometry_candidates() -> list[PlanGeometry]:
    """The candidate geometries, the shipped one first: the row margin
    96 or 64, the column window 256 or 128 words."""
    return [
        _GEOMETRY_SHIPPED,
        PlanGeometry(64, 256),
        PlanGeometry(96, 128),
        PlanGeometry(64, 128),
    ]


def set_plan_geometry(geometry: PlanGeometry | None) -> PlanGeometry:
    """Install ``geometry`` (None: the shipped one) process-wide and return
    the one it replaces.  What is cached on a plan's geometry is cleared;
    the kernels read the geometry at every launch."""
    global _plan_geometry
    prev = _plan_geometry
    if geometry is None:
        geometry = _GEOMETRY_SHIPPED
    if not isinstance(geometry, PlanGeometry):
        geometry = PlanGeometry(*geometry)
    _plan_geometry = geometry
    _frontier_geometry.cache_clear()
    return prev


@contextlib.contextmanager
def plan_geometry_override(geometry: PlanGeometry | tuple):
    """:func:`set_plan_geometry` for the block's duration."""
    prev = set_plan_geometry(
        geometry if isinstance(geometry, PlanGeometry) else PlanGeometry(*geometry)
    )
    try:
        yield plan_geometry()
    finally:
        set_plan_geometry(prev)


@functools.lru_cache(maxsize=256)
def _frontier_geometry(plan: AdaptivePlan, shape: tuple[int, int], geometry: PlanGeometry):
    sub_rows = _round8(4 * plan.t + geometry.sub_margin)
    if not plan.frontier or sub_rows + 64 > plan.stripe_h + 2 * plan.pad_f:
        return None, None
    cw = geometry.col_window
    return sub_rows, (cw if cw and shape[1] >= 2 * cw else None)


def frontier_geometry(plan: AdaptivePlan, shape: tuple[int, int]) -> tuple[int | None, int | None]:
    """(sub_rows, col_window) of the frontier kernels' compute tiers on a
    board, strip or tile of ``shape`` = (rows, wp) words at ``plan``, by
    ``_frontier_plan``'s rules at the active :class:`PlanGeometry`: the row
    tier's sub-window of round8(4·T + sub_margin) rows exists only where it
    and 64 rows more fit a stripe's window (stripe_h + 2·round8(T + 6)
    rows), the column tier only where the board is at least two windows
    wide.  (None, None): the tiers are off and every stripe that hits
    computes its whole window; the port keeps its frontier plan there,
    where the JAX package has none."""
    return _frontier_geometry(plan, tuple(shape), _plan_geometry)


# -- the register-resident plans (csrc/regwin.cuh) ---------------------------------

#: Word columns of one warp's window, rows one thread holds in registers,
#: rows of the light-cone trimming's unit, and the most warps a block
#: stacks (``regwin.cuh``: kLanes, kRun, kChunk, kMaxWarps).
REG_LANES, REG_RUN, REG_CHUNK, REG_MAX_WARPS = 32, 32, 8, 16
#: Warps one SM holds at the kernels' register cap: 65,536 registers over
#: 64 a thread (``__launch_bounds__(512, 2)``) and 32 threads a warp; and
#: the most blocks an SM holds (Hopper).
REG_WARPS_PER_SM, REG_BLOCKS_PER_SM = 32, 32
#: Static shared memory of a block: the run edges' exchange (``reg::Edges``:
#: two parities x 16 warps x two rows x 32 words).  An SM's shared memory,
#: of which the card reserves 1 KiB a block (Hopper).
REG_EDGE_BYTES = 2 * REG_MAX_WARPS * 2 * REG_LANES * 4
REG_SMEM_PER_SM, REG_SMEM_RESERVED = 228 * 1024, 1024


@dataclasses.dataclass(frozen=True)
class RegPlan:
    """One launch of K9 or K13 on register-resident runs: ``grid`` =
    (row blocks, column groups) blocks of ``warps`` warps stacked, each warp
    a run of ``REG_RUN`` rows of one ``REG_LANES``-word window column whose
    middle ``centre`` words (``border`` a side outside them) belong to the
    block.  A block's window starts ``halo`` rows above its tile of
    ``tile_h`` centre rows; ``t`` generations, the window probed after
    ``probe`` of them (K13: 6; K9: 0, no probe); ``keep``: each thread
    keeps its run of one generation in shared memory (K12 and K15: gen T,
    the measure's comparand).  Generation g computes the light cone
    (:meth:`cone`), each run rounding its share out to whole
    ``REG_CHUNK``-row chunks (:meth:`live`)."""

    t: int
    halo: int
    tile_h: int
    warps: int
    grid: tuple[int, int]
    border: int = 1
    probe: int = 0
    keep: bool = False

    def __post_init__(self):
        if not (1 <= self.t <= WORD * self.border and self.halo >= self.t and self.tile_h >= 1
                and 1 <= self.warps <= REG_MAX_WARPS and self.rows <= self.warps * REG_RUN
                and 1 <= self.border and self.centre >= 2):
            raise ValueError(f"invalid register plan {self}")

    @property
    def centre(self) -> int:
        """Centre words of a warp's window."""
        return REG_LANES - 2 * self.border

    @property
    def rows(self) -> int:
        """Window rows that matter: the tile and ``halo`` rows a side."""
        return self.tile_h + 2 * self.halo

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def threads(self) -> int:
        return REG_LANES * self.warps

    @property
    def smem_bytes(self) -> int:
        """Shared memory of a block: the edge exchange, and where it probes
        or keeps a generation (K12, K13, K15) every thread's run
        (``reg::keep``)."""
        kept = self.probe or self.keep
        return REG_EDGE_BYTES + (self.warps * REG_RUN * REG_LANES * 4 if kept else 0)

    @property
    def occupancy(self) -> int:
        """Blocks one SM holds at once: its registers, its shared memory and
        its block cap allow so many."""
        return min(REG_WARPS_PER_SM // self.warps, REG_BLOCKS_PER_SM,
                   REG_SMEM_PER_SM // (self.smem_bytes + REG_SMEM_RESERVED))

    def waves(self, sms: int) -> int:
        """Blocks the busiest of ``sms`` SMs runs: a block keeps an SM's
        integer pipes busy, so an SM's time is its blocks' work, whether
        they share it (up to :attr:`occupancy` at once) or follow."""
        return -(-self.blocks // sms)

    def fill(self, sms: int) -> float:
        """The share of ``sms`` SMs' time over :meth:`waves` blocks each
        that holds a block."""
        return self.blocks / (self.waves(sms) * sms)

    def cone(self, g: int) -> tuple[int, int]:
        """Window rows [lo, hi) whose state at generation g (1..t) the
        launch needs: every row but g a side until the probe, then the tile
        and t - g rows a side."""
        d = g if g <= self.probe else self.halo - self.t + g
        return d, self.rows - d

    def live(self, g: int, warp: int) -> tuple[int, int]:
        """The rows [lo, hi) of ``warp``'s run that generation g steps: its
        share of :meth:`cone`, out to whole chunks (lo == hi: none)."""
        lo, hi = self.cone(g)
        top = warp * REG_RUN
        lo, hi = max(lo - top, 0), min(hi - top, REG_RUN)
        if lo >= hi:
            return 0, 0
        return lo // REG_CHUNK * REG_CHUNK, min(-(-hi // REG_CHUNK) * REG_CHUNK, REG_RUN)

    def live_rows(self, device=None) -> torch.Tensor:
        """bool (t, warps·REG_RUN): whether generation g (row g - 1) steps
        window row r."""
        live = torch.zeros((self.t, self.warps * REG_RUN), dtype=torch.bool)
        for g in range(1, self.t + 1):
            for w in range(self.warps):
                lo, hi = self.live(g, w)
                live[g - 1, w * REG_RUN + lo : w * REG_RUN + hi] = True
        return live.to(device)

    def work(self) -> int:
        """Row-generations one block steps (each REG_LANES words)."""
        return sum(hi - lo for g in range(1, self.t + 1) for w in range(self.warps)
                   for lo, hi in [self.live(g, w)])

    def cost(self, sms: int) -> float:
        """The plan's time in row-generations of the busiest SM, where an SM
        whose resident blocks hold fewer than 4 warps (one a scheduler) runs
        at that share of its rate."""
        warps = self.warps * min(self.waves(sms), self.occupancy)
        return self.waves(sms) * self.work() * 4 / min(4, warps)


def best_reg_plan(candidates, sms: int) -> RegPlan:
    """The candidate plan of least :meth:`RegPlan.cost` on ``sms`` SMs; on a
    tie, the one of fewer blocks."""
    return min(candidates, key=lambda p: (p.cost(sms), p.blocks))


def _stripe_reg_plan(shape: tuple[int, int], stripe_h: int, t: int, halo: int, sms: int,
                     stripes: int = 1, **kw) -> RegPlan:
    """The blocks of a register-resident stripe kernel (K11, K12, K13, K15)
    on ``shape`` = (rows, wp) words in stripes of ``stripe_h`` rows: column
    groups of 30 words, a window of the tile and ``halo`` rows a side, and
    the row tile, a divisor of the stripe (a stripe's blocks decide or
    measure it together) or, up to ``stripes`` stripes, a run of whole
    stripes that divides the rows (each decided on its own), whose grid has
    the least :meth:`RegPlan.cost` on ``sms`` SMs; ``kw`` the plan's probe
    or keep."""
    h, wp = shape
    cols = -(-wp // (REG_LANES - 2))
    tiles = [d for d in range(1, stripe_h + 1) if stripe_h % d == 0]
    tiles += [k * stripe_h for k in range(2, stripes + 1) if h % (k * stripe_h) == 0]
    plans = [RegPlan(t, halo, tile_h, -(-(tile_h + 2 * halo) // REG_RUN), (h // tile_h, cols),
                     **kw)
             for tile_h in tiles if tile_h + 2 * halo <= REG_MAX_WARPS * REG_RUN]
    if not plans:
        raise ValueError(f"no register-resident block for a {halo}-row halo")
    return best_reg_plan(plans, sms)


#: Stripes one register probing block may span (``probing.cu``: a probe's
#: bits, one a stripe).
REG_PROBE_STRIPES = 32


@functools.lru_cache(maxsize=256)
def stripe_reg_plan(shape: tuple[int, int], stripe_h: int, pad: int, t: int,
                    sms: int, stripes: int = 1) -> RegPlan:
    """The blocks of the register probing kernels (K13; K11 with
    ``stripes`` = ``REG_PROBE_STRIPES``) for a launch of ``t`` generations
    (probe at 6) on ``shape`` = (rows, width) words (K13: a pre-extended
    tile's centre rows and extended width), in stripes of ``stripe_h`` rows
    with a ``pad``-row halo, a block spanning up to ``stripes`` whole
    stripes (:func:`_stripe_reg_plan`)."""
    return _stripe_reg_plan(shape, stripe_h, t, pad, sms, stripes, probe=SKIP_PERIOD)


def probing_reg_plan(plan: AdaptivePlan, shape: tuple[int, int], sms: int) -> RegPlan:
    """The blocks of K4 (a whole (h, wp) board) and K11 (an (h, wp) strip)
    for a launch of ``plan``: :func:`stripe_reg_plan` over the full width
    (no x-halo: columns wrap modulo wp), a block within one stripe or
    spanning up to ``REG_PROBE_STRIPES`` whole ones.  At 16384² on 132 SMs,
    1,152 blocks of one 256-row stripe and 10 warps."""
    return stripe_reg_plan(shape, plan.stripe_h, plan.pad, plan.t, sms, REG_PROBE_STRIPES)


def torus_reg_plans(strip: tuple[int, int], t: int, probe: int = 0) -> list[RegPlan]:
    """The candidate blocks of a ``t``-generation launch on an (h, wp)
    centre of K9 (``cuda_halo.ext_reg_plan``), K2 and, with ``probe`` = 6,
    K3 (:func:`tiled_skip_reg_plan`): column groups of 32 - 2·border
    centre words, border = ceil(T / 32); for each block height of 1 to
    ``REG_MAX_WARPS`` warps, the tallest tile it holds (window rows = the
    tile and T a side), evened over the centre's rows."""
    h, wp = strip
    border = -(-t // WORD)
    if t < 1 or 2 * border >= REG_LANES:
        raise ValueError(f"no register window for {t} generations")
    cols = -(-wp // (REG_LANES - 2 * border))
    plans = []
    for warps in range(1, REG_MAX_WARPS + 1):
        tallest = warps * REG_RUN - 2 * t
        if tallest < 1:
            continue
        nrb = -(-h // tallest)
        tile_h = -(-h // nrb)
        plans.append(RegPlan(t, t, tile_h, -(-(tile_h + 2 * t) // REG_RUN), (nrb, cols), border,
                             probe))
    if not plans:
        raise ValueError(f"no register window for {t} generations: {REG_MAX_WARPS} warps of "
                         f"{REG_RUN} rows")
    return plans


@functools.lru_cache(maxsize=256)
def tiled_skip_reg_plan(shape: tuple[int, int], t: int, sms: int) -> RegPlan:
    """K3's blocks for a ``t``-generation launch (a multiple of 6) on a
    packed (h, wp) torus: K2's (:func:`torus_reg_plans`) with the probe
    after 6 generations, the grid of least :meth:`RegPlan.cost` on ``sms``
    SMs.  Tiles are evened over the torus and the last one overhangs: rows
    wrap, so no origin is shifted, and a tile's window may be taller than
    the torus."""
    if not _adaptive_eligible(t):
        raise ValueError(f"no K3 window for {t} generations: a multiple of {SKIP_PERIOD}")
    return best_reg_plan(torus_reg_plans(shape, t, SKIP_PERIOD), sms)


@functools.lru_cache(maxsize=256)
def frontier_reg_plan(shape: tuple[int, int], stripe_h: int, t: int, sms: int) -> RegPlan:
    """The frontier kernels' blocks (K5/K8, K12, K14, K15) for a launch of
    ``t`` generations on ``shape`` = (rows, wp) packed words in stripes of
    ``stripe_h`` rows (K8, K14 and K15: every shard's rows, stacked:
    :func:`frontier_blocks`): ``t`` + 6 generations stepped (the
    measure compares gen t + 6 with gen t) on a window of the tile and
    ``t`` + 6 rows a side, one border word a side (t + 6 <= 32), each
    thread keeping gen t in shared memory (:func:`_stripe_reg_plan`).  The
    fresh cost decides settled launches too: there a launch's time is its
    many idle blocks' decisions, which shorter tiles multiply, more than
    the few stripes that compute (``tools/regwin_ab.py --sweep-frontier``
    on an H100 measures each block height)."""
    return _stripe_reg_plan(shape, stripe_h, t + SKIP_PERIOD, t + SKIP_PERIOD, sms, keep=True)


@functools.lru_cache(maxsize=16)
def device_sms(device: torch.device) -> int:
    """The SM count of a CUDA device (``multi_processor_count``)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def frontier_blocks(shape: tuple[int, int], plan: AdaptivePlan, shards: int = 1,
                    sms: int = H100_SMS) -> RegPlan:
    """The blocks of one shard of a register-resident frontier launch over
    ``shards`` shards of ``shape`` = (h, wp) words (K5: one board; K8: the
    boards of a stack; K14: the strips of a row mesh), each shard its own
    blockIdx.z: :func:`frontier_reg_plan` on every shard's rows stacked
    (the launch's blocks share the card's ``sms`` SMs), its grid's rows
    taken back to one shard's."""
    h, wp = shape
    blocks = frontier_reg_plan((shards * h, wp), plan.stripe_h, plan.t, sms)
    return dataclasses.replace(blocks, grid=(h // blocks.tile_h, blocks.grid[1]))


def _run_gen(win: torch.Tensor, rule: LifeRule) -> torch.Tensor:
    """One generation of register-resident windows (..., rows, 32): each
    window's columns wrap within it (a warp's lanes, ``regwin.cuh::hsum``),
    rows past it read as zero."""
    west, east = packed._west(win), packed._east(win)
    h0 = win ^ west ^ east
    h1 = packed._maj(win, west, east)
    n0, s0 = cuda_packed._shift(h0, -2, 1), cuda_packed._shift(h0, -2, -1)
    n1, s1 = cuda_packed._shift(h1, -2, 1), cuda_packed._shift(h1, -2, -1)
    t0 = h0 ^ n0 ^ s0
    c = packed._maj(h0, n0, s0)
    p1 = h1 ^ n1 ^ s1
    q = packed._maj(h1, n1, s1)
    k = p1 & c
    return packed.apply_rule_planes((t0, p1 ^ c, q ^ k, q & k), win, rule)


def _reg_steps(win: torch.Tensor, rule: LifeRule, plan: RegPlan, gens, frozen=None):
    """Generations ``gens`` of every block's window (nby, nbx, warps·32, 32),
    each stepping only the rows :meth:`RegPlan.live` steps; the blocks
    where ``frozen`` (bool (nby, nbx)) is set keep their state."""
    live = plan.live_rows(win.device)
    for g in gens:
        step = live[g - 1][:, None]
        if frozen is not None:
            step = step & ~frozen[:, :, None, None]
        win = torch.where(step, _run_gen(win, rule), win)
    return win


def _reg_windows(src: torch.Tensor, plan: RegPlan, top: int, left: int, wrap_cols: bool,
                 wrap_rows: bool = False):
    """Every block's window from ``src``: block (by, bx) reads rows
    ``top`` + by·tile_h + [0, warps·32) and columns ``left`` + bx·centre +
    [0, 32), the columns modulo the width when ``wrap_cols`` and the rows
    modulo the height when ``wrap_rows`` (K2: the torus in place); zero
    outside ``src`` and past the window's :attr:`RegPlan.rows`."""
    nby, nbx = plan.grid
    rows_in, cols_in = src.shape
    dev = src.device
    r = torch.arange(plan.warps * REG_RUN, device=dev)
    rows = top + torch.arange(nby, device=dev)[:, None] * plan.tile_h + r
    cols = (left + torch.arange(nbx, device=dev)[:, None] * plan.centre
            + torch.arange(REG_LANES, device=dev))
    if wrap_rows:
        rows = torch.remainder(rows, rows_in)
    if wrap_cols:
        cols = torch.remainder(cols, cols_in)
    row_ok = (rows >= 0) & (rows < rows_in) & (r < plan.rows)
    col_ok = (cols >= 0) & (cols < cols_in)
    win = src[rows.clamp(0, rows_in - 1)[:, None, :, None],
              cols.clamp(0, cols_in - 1)[None, :, None, :]]
    return win * (row_ok[:, None, :, None] & col_ok[None, :, None, :])


def _reg_stitch(win: torch.Tensor, plan: RegPlan) -> torch.Tensor:
    """Every block's centre (rows ``halo`` .. ``halo`` + tile_h, its
    ``centre`` middle words) side by side: (nby·tile_h, nbx·centre)."""
    nby, nbx = plan.grid
    c = win[:, :, plan.halo : plan.halo + plan.tile_h, plan.border : REG_LANES - plan.border]
    return c.permute(0, 2, 1, 3).reshape(nby * plan.tile_h, nbx * plan.centre)


def _frontier_blocks(src: torch.Tensor, rule: LifeRule, blocks: RegPlan, t: int,
                     centre: tuple[int, int], computes: torch.Tensor):
    """The frontier kernels' blocks (K5/K8, K12, K14, K15:
    ``csrc/regwin.cuh``'s frontier window) in PyTorch: ``src`` is the
    board, strip or tile with T + 6 rows a side and the
    words of its torus from one left of its first column group to one
    right of its last; the window of every block that ``computes`` (bool,
    one a stripe, or one a block: (row blocks, column groups)) — warps·32
    rows from its tile's row less T + 6, 32 words from one left of its
    group, zero past the window — steps T generations and then 6 more,
    each only the rows of its run's light cone (:meth:`RegPlan.live`).
    Returns (gen T, gen T + 6) of the ``centre`` = (h, wp) words, zero on
    the blocks that do not compute."""
    h, wp = centre
    win = _reg_windows(src, blocks, 0, 0, False)
    rows = computes
    if computes.dim() == 1:
        rows = computes.repeat_interleave(win.shape[0] // computes.numel())
    out = torch.zeros((2, *win.shape), dtype=win.dtype, device=win.device)
    if rows.any():
        part = _reg_steps(win[rows], rule, blocks, range(1, t + 1))
        out[0][rows] = part
        out[1][rows] = _reg_steps(part, rule, blocks, range(t + 1, t + SKIP_PERIOD + 1))
    return _reg_stitch(out[0], blocks)[:h, :wp], _reg_stitch(out[1], blocks)[:h, :wp]


def _check_frontier_blocks(blocks: RegPlan, plan: AdaptivePlan, shape: tuple[int, int]) -> None:
    """Raise unless ``blocks`` are frontier blocks of ``plan`` that cover
    ``shape`` = (rows, wp) words: T + 6 generations and rows a side, a
    row tile that divides the stripe, every row and every word."""
    halo = plan.t + SKIP_PERIOD
    nby, nbx = blocks.grid
    if ((blocks.t, blocks.halo, blocks.border, blocks.probe) != (halo, halo, 1, 0)
            or plan.stripe_h % blocks.tile_h or nby * blocks.tile_h != shape[0]
            or nbx * blocks.centre < shape[1]):
        raise ValueError(f"blocks {blocks} do not cover {plan} on {shape[0]}x{shape[1]} words")


#: The probe's masks of a window's edge words (``reg::inner_stable``): all
#: but cells 0..5 of lane 0 and all but the last six cells of lane 31, as
#: int32.
_FIRST_WORD_INNER = 0xFFFFFFC0 - (1 << 32)
_LAST_WORD_INNER = 0x03FFFFFF


def _inner_mask(device) -> torch.Tensor:
    """The cells of each of a window's ``REG_LANES`` words that a probe
    compares: all but the 6 next to the window's x edge."""
    mask = torch.full((REG_LANES,), -1, dtype=torch.int32, device=device)
    mask[0] &= _FIRST_WORD_INNER
    mask[-1] &= _LAST_WORD_INNER
    return mask


def _probing_blocks(ext: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, xpad: int,
                    blocks: RegPlan, elide: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The register probing blocks of K13, K11 and K4 in PyTorch on ``ext``,
    a centre of whole stripes with pad = round8(T) rows and ``xpad`` words
    (K11, K4: 0) a side: the blocks of ``blocks`` tile its centre rows,
    ``tile_h`` rows each (a divisor of a stripe, or whole stripes), and
    its whole width in groups of 30 words; each window (warps·32 rows from
    pad rows above its tile, 32 words from one left of its group, columns
    modulo the width, zero past the window) is stepped 6 generations
    (every row it needs) and compared with its input on each of its
    stripes' regions (a block within a stripe: its inner region, rows and
    cells at least 6 from its edge; a block of several stripes: each
    stripe's rows [6, stripe_h + 2·pad - 6) of its own window, cells at
    least 6 from the x edge); a block whose stripes that compute (not
    ``elide``) all agree keeps its generation-6 state, any other steps on
    to T, only the rows of its light cone (:meth:`RegPlan.live`).  Returns
    (the blocks' centre words inside the centre columns: (h, wpl), bool
    per stripe: the AND of its blocks' probes)."""
    pad, sh = plan.pad, plan.stripe_h
    h, wpl = ext.shape[0] - 2 * pad, ext.shape[1] - 2 * xpad
    wpe = wpl + 2 * xpad
    nby, nbx = blocks.grid
    if ((blocks.t, blocks.halo, blocks.probe, blocks.border) != (plan.t, pad, SKIP_PERIOD, 1)
            or (sh % blocks.tile_h and blocks.tile_h % sh)
            or blocks.tile_h // sh > REG_PROBE_STRIPES
            or nby * blocks.tile_h != h or nbx * blocks.centre < wpe):
        raise ValueError(f"blocks {blocks} do not cover {plan} on an extended {h}x{wpe} tile")
    dev = ext.device
    win0 = _reg_windows(ext, blocks, 0, -1, True)
    win = _reg_steps(win0, rule, blocks, range(1, SKIP_PERIOD + 1))
    changed = ((win ^ win0) & _inner_mask(dev)).ne(0).any(dim=3)  # (nby, nbx, window rows)
    ns, span = max(blocks.tile_h // sh, 1), min(blocks.tile_h, sh)
    lo = torch.arange(ns, device=dev)[:, None] * span + SKIP_PERIOD
    r = torch.arange(changed.shape[2], device=dev)
    region = (r >= lo) & (r < lo + span + 2 * pad - 2 * SKIP_PERIOD)  # (ns, window rows)
    unstable = (changed[:, :, None, :] & region).any(dim=3)  # (nby, nbx, ns)
    stripe = ((torch.arange(nby, device=dev) * blocks.tile_h // sh)[:, None]
              + torch.arange(ns, device=dev))  # (nby, ns)
    failed = torch.zeros(plan.grid(h), dtype=torch.int32, device=dev)
    failed.index_add_(0, stripe.flatten(), unstable.any(dim=1).flatten().to(torch.int32))
    step = (unstable & ~elide[stripe][:, None, :]).any(dim=2)
    win = _reg_steps(win, rule, blocks, range(SKIP_PERIOD + 1, plan.t + 1), ~step)
    out = _reg_stitch(win, blocks)[:, xpad : xpad + wpl]
    return out, failed == 0


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


def _launcher(kernel: str, symbol: str, argtypes: list) -> tuple[ctypes.CDLL, object]:
    """(library, launch function) of ``kernel``, the function's C signature
    declared: pointers as ``void*``, sizes as ``int``, rule masks as
    ``unsigned``; it returns a ``cudaError_t``."""
    lib = cuda_build.load(kernel)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


#: The rule instantiations of every kernel but K6 (``regwin.cuh::by_rule``): B3/S23 and B36/S23 evaluated at
#: compile time, every other rule by its masks at run time ("generic").
REG_RULES = ("generic", "conway", "highlife")


@functools.lru_cache(maxsize=64)
def reg_rule(rule: LifeRule) -> tuple[int, int, int]:
    """(born, surv, instantiation) of ``rule`` for a register-resident
    kernel: its masks, and the index in :data:`REG_RULES` of the
    instantiation they select."""
    masks = rule_masks(rule)
    return (*masks, {rule_masks(CONWAY): 1, rule_masks(HIGHLIFE): 2}.get(masks, 0))


@functools.lru_cache(maxsize=8)
def _reg_launcher(kernel: str, symbol: str, pointers: int, ints: int = 9):
    """The launch function of a register-resident kernel, its C
    signature declared once: ``pointers`` pointers, ``ints`` ints, the rule masks and
    the stream."""
    return _launcher(kernel, symbol, [_P] * pointers + [_I] * ints + [_U, _U, _P])


# -- K3: the skip form of the tiled kernel --------------------------------------


def tiled_skip_superstep_plain(p: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """Plain version of K3: ``packed.superstep``."""
    return packed.superstep(p, rule, turns)


def _check_skip_launch(turns: int) -> None:
    if not _adaptive_eligible(turns) or turns > TILED_MAX_T:
        raise ValueError(f"skip launches need a positive multiple of {SKIP_PERIOD} turns up to "
                         f"{TILED_MAX_T}, got {turns}")


def tiled_skip_reg_mirror(p: torch.Tensor, rule: LifeRule, turns: int,
                          plan: RegPlan | None = None, sms: int = H100_SMS) -> torch.Tensor:
    """K3's decomposition in PyTorch on the blocks of ``plan`` (None:
    :func:`tiled_skip_reg_plan` on ``sms`` SMs): each block's window
    (warps·32 rows from T above its tile, 32 words from ``border`` left of
    its column group, rows modulo h and words modulo wp: the torus in
    place, zero past the window's rows) stepped 6 generations and compared
    with itself at generation 0 on its inner region (rows [6, rows - 6),
    all but the 6 cells next to its x edge); a block that agrees keeps its
    generation-6 state, any other steps on to T on its light cone
    (:meth:`RegPlan.live`); each block's centre stored where it lies on the
    board."""
    _check_skip_launch(turns)
    h, wp = p.shape
    plan = plan or tiled_skip_reg_plan((h, wp), turns, sms)
    if ((plan.t, plan.halo, plan.probe) != (turns, turns, SKIP_PERIOD)
            or plan.grid[0] * plan.tile_h < h or plan.grid[1] * plan.centre < wp):
        raise ValueError(f"plan {plan} does not cover a {turns}-generation skip launch on "
                         f"{h}x{wp}")
    win0 = _reg_windows(p, plan, -turns, -plan.border, True, wrap_rows=True)
    win = _reg_steps(win0, rule, plan, range(1, SKIP_PERIOD + 1))
    diff = ((win ^ win0) & _inner_mask(p.device))[:, :, SKIP_PERIOD : plan.rows - SKIP_PERIOD]
    stable = (diff == 0).flatten(2).all(dim=2)
    win = _reg_steps(win, rule, plan, range(SKIP_PERIOD + 1, turns + 1), frozen=stable)
    return _reg_stitch(win, plan)[:h, :wp].contiguous()


def tiled_skip_superstep(p: torch.Tensor, rule: LifeRule, turns: int,
                         plan: RegPlan | None = None) -> torch.Tensor:
    """K3: one launch of ``turns`` generations (a multiple of 6, at most
    ``cuda_packed.TILED_MAX_T``) of the torus with the skip proof, into a
    fresh tensor; the input is never written.  A CPU tensor runs
    :func:`tiled_skip_superstep_plain`; a CUDA tensor launches K3 on the
    blocks of :func:`tiled_skip_reg_plan` for its device's SMs (``plan``
    forces them: tests), in the rule's instantiation (counted in
    ``tiled_skip_superstep.rules``), or raises."""
    _check_words(p)
    _check_skip_launch(turns)
    if p.device.type == "cpu":
        return tiled_skip_superstep_plain(p, rule, turns)
    h, wp = p.shape
    plan = plan or tiled_skip_reg_plan((h, wp), turns, device_sms(p.device))
    lib, launch = _reg_launcher("tiled_skip", "gol_tiled_skip_launch", 2, 7)
    born, surv, variant = reg_rule(rule)
    out = torch.empty_like(p)
    err = launch(p.data_ptr(), out.data_ptr(), h, wp, turns, plan.tile_h, plan.warps, plan.border,
                 variant, born, surv, _stream(p))
    cuda_build.check(lib, err, "tiled_skip")
    tiled_skip_superstep.launches += 1
    tiled_skip_superstep.rules[REG_RULES[variant]] += 1
    return out


tiled_skip_superstep.launches = 0
tiled_skip_superstep.rules = collections.Counter()


# -- K4: the probing kernel ----------------------------------------------------


def _stripe_rows(h: int, stripe_h: int, device) -> torch.Tensor:
    """Stripe index of every board row."""
    return torch.arange(h, device=device) // stripe_h


def probing_launch_mirror(
    r: torch.Tensor, w: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, prev: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one K4 launch (``_kernel_adaptive``): board ``r`` in,
    ``w`` the buffer it writes (the board of two launches ago), ``prev``
    the previous launch's int32 stable bitmap.  Returns (written buffer,
    this launch's bitmap).  A stripe elides when it and both neighbours
    were stable; otherwise it probes rows [6, stripe_h + 2*pad - 6) of its
    window and keeps its input when they are period-6 stable."""
    h = r.shape[0]
    grid = plan.grid(h)
    dev = r.device
    was = prev.bool()
    elide = was & torch.roll(was, 1) & torch.roll(was, -1)
    g6 = packed.superstep(r, rule, SKIP_PERIOD)
    moved = (g6 != r).any(dim=1)
    inner = plan.stripe_h + 2 * plan.pad - 2 * SKIP_PERIOD
    probe_rows = torch.remainder(
        torch.arange(grid, device=dev)[:, None] * plan.stripe_h - plan.pad + SKIP_PERIOD
        + torch.arange(inner, device=dev)[None, :],
        h,
    )
    stable = ~moved[probe_rows].any(dim=1)
    g_t = packed.superstep(g6, rule, plan.t - SKIP_PERIOD)
    of = _stripe_rows(h, plan.stripe_h, dev)
    out = torch.where(elide[of, None], w, torch.where(stable[of, None], r, g_t))
    return out, (elide | stable).to(torch.int32)


def _probing_stats(flags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(skipped, activity) of a run of probing launches from their stable
    bitmaps: the flags summed (elided stripes included) and, per stripe,
    the launches it was not proved stable (conservative activity)."""
    return flags.sum().to(torch.int32), (1 - flags).sum(dim=0).to(torch.int32)


def probing_superstep_mirror(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
    launch=probing_launch_mirror,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``nlaunch`` launches of ``launch`` (the plain version, or
    :func:`probing_launch_reg_mirror`) on K4's buffer protocol, from a zero
    bitmap.  Returns (board, skipped, activity)."""
    flags = torch.ones((nlaunch + 1, plan.grid(p.shape[0])), dtype=torch.int32, device=p.device)
    flags[0] = 0
    bufs = [torch.zeros_like(p), p.clone()]
    cur = p
    for k in range(nlaunch):
        cur, flags[k + 1] = launch(cur, bufs[k % 2], rule, plan, flags[k])
        bufs[k % 2] = cur
    return (cur, *_probing_stats(flags[1:]))


def probing_launch_reg_mirror(
    r: torch.Tensor, w: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, prev: torch.Tensor,
    blocks: RegPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's decomposition in PyTorch, one launch: :func:`_probing_blocks` on
    the board extended by its own last and first round8(T) rows (its
    windows read the torus in place), no x-halo, on the blocks of
    ``blocks`` (None: the :func:`probing_reg_plan` of an H100), with the
    elision of :func:`probing_launch_mirror`.  Returns (written buffer,
    this launch's bitmap)."""
    h, wp = r.shape
    blocks = blocks or probing_reg_plan(plan, (h, wp), H100_SMS)
    was = prev.bool()
    elide = was & torch.roll(was, 1) & torch.roll(was, -1)
    rows = torch.remainder(torch.arange(h + 2 * plan.pad, device=r.device) - plan.pad, h)
    out, stable = _probing_blocks(r[rows], rule, plan, 0, blocks, elide)
    of = _stripe_rows(h, plan.stripe_h, r.device)
    return torch.where(elide[of, None], w, out), (elide | stable).to(torch.int32)


def probing_superstep_reg_mirror(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
    blocks: RegPlan | None = None, sms: int = H100_SMS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's decomposition in PyTorch over ``nlaunch`` launches:
    :func:`probing_superstep_mirror` on :func:`probing_launch_reg_mirror` at
    the blocks of ``blocks`` (None: :func:`probing_reg_plan` on ``sms``
    SMs).  Returns (board, skipped, activity)."""
    blocks = blocks or probing_reg_plan(plan, tuple(p.shape), sms)
    return probing_superstep_mirror(
        p, rule, plan, nlaunch, functools.partial(probing_launch_reg_mirror, blocks=blocks))


def probing_superstep(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
    blocks: RegPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: ``nlaunch`` probing launches of ``plan.t`` generations from a
    zero bitmap; returns (board, skipped, activity), all left on the
    device.  Launch k writes the buffer of launch k - 2 (the second buffer
    starts as a copy of the input), so an elided stripe writes nothing; the
    input is never written.  CPU tensors run
    :func:`probing_superstep_mirror`; a CUDA tensor launches K4 on the
    blocks of :func:`probing_reg_plan` for its device's SMs (``blocks``
    forces them: tests), in the rule's instantiation (counted in
    ``probing_superstep.rules``), or raises."""
    _check_words(p)
    if p.device.type == "cpu":
        return probing_superstep_mirror(p, rule, plan, nlaunch)
    h, wp = p.shape
    blocks = blocks or probing_reg_plan(plan, (h, wp), device_sms(p.device))
    lib, launch = _reg_launcher("probing", "gol_probing_launch", 4, 7)
    born, surv, variant = reg_rule(rule)
    flags = torch.ones((nlaunch + 1, plan.grid(h)), dtype=torch.int32, device=p.device)
    flags[0] = 0
    bufs = (torch.empty_like(p), p.clone())
    stream = _stream(p)
    cur = p
    for k in range(nlaunch):
        dst = bufs[k % 2]
        err = launch(
            cur.data_ptr(), dst.data_ptr(), flags[k].data_ptr(), flags[k + 1].data_ptr(),
            h, wp, plan.t, plan.stripe_h, blocks.tile_h, blocks.warps, plan.pad, variant,
            born, surv, stream,
        )
        cuda_build.check(lib, err, "probing")
        probing_superstep.launches += 1
        probing_superstep.rules[REG_RULES[variant]] += 1
        cur = dst
    return (cur, *_probing_stats(flags[1:]))


probing_superstep.launches = 0
probing_superstep.rules = collections.Counter()


# -- the frontier kernels' decisions (K5, K8, K12, K14, K15) ---------------------

#: A stripe's route in a frontier launch, as the kernels record it: skip;
#: the rectangle route (K5, K8, K14) or the column tier (K12); the row
#: tier; the full window; and K15's elided edge stripe.
ROUTE_SKIP, ROUTE_TIER, ROUTE_ROW, ROUTE_FULL, ROUTE_ELIDED = range(5)
ROUTES = ("skip", "tier", "row", "full", "elided")
#: A stripe's frontier state (``_kernel_frontier_mega``'s SMEM scratch):
#: its two row intervals, its column interval in words, and its change
#: rectangle in chunk units of 8 rows and 128 words.
STATE_FIELDS = ("lo0", "hi0", "lo1", "hi1", "clo", "chi", "r8", "n8", "c128", "n128")


def hit_union(ivals, cvals, c_lo: torch.Tensor, c_hi: torch.Tensor, plan: AdaptivePlan):
    """``_hit_union`` for every stripe at once: ``ivals`` are the (lo, hi)
    tensors of the row intervals of each stripe's neighbourhood, placed in
    its row frame, ``cvals`` their stripes' (clo, chi) column pairs.
    Returns (hit, u_lo, u_hi, u_clo, u_chi): whether a row interval (and
    the 6-row pin margin) reaches the stripe's window of round8(T + 6) rows
    a side, the union of the row intervals clamped to T + 6 rows of the
    stripe, and the union of the nonempty column pairs."""
    t6 = plan.t + SKIP_PERIOD
    w_lo, w_hi = c_lo - plan.pad_f, c_hi + plan.pad_f
    hit = torch.zeros(c_lo.shape, dtype=torch.bool, device=c_lo.device)
    u_lo = torch.full_like(c_lo, _EMPTY_LO)
    u_hi = torch.full_like(c_lo, -_EMPTY_LO)
    for lo, hi in ivals:
        nonempty = lo <= hi
        hit |= nonempty & (lo - SKIP_PERIOD <= w_hi) & (hi + SKIP_PERIOD >= w_lo)
        clo = torch.maximum(lo, c_lo - t6)
        chi = torch.minimum(hi, c_hi + t6)
        keep = nonempty & (clo <= chi)
        u_lo = torch.where(keep, torch.minimum(u_lo, clo), u_lo)
        u_hi = torch.where(keep, torch.maximum(u_hi, chi), u_hi)
    u_clo = torch.full_like(c_lo, _EMPTY_LO)
    u_chi = torch.full_like(c_lo, -_EMPTY_LO)
    for cl, ch in cvals:
        ne = cl <= ch
        u_clo = torch.where(ne, torch.minimum(u_clo, cl), u_clo)
        u_chi = torch.where(ne, torch.maximum(u_chi, ch), u_chi)
    return hit, u_lo, u_hi, u_clo, u_chi


def frontier_placement(u_lo: torch.Tensor, u_hi: torch.Tensor, c_lo: torch.Tensor,
                       plan: AdaptivePlan, sub_rows: int | None):
    """``_frontier_placement`` for every stripe: in the frame of the
    stripe's window (its first row c_lo less round8(T + 6)), the row tier's
    sub-window top ``win_lo`` (a multiple of 8), the measure rows [m_lo,
    m_hi] and whether the measure lies in the sub-window's gen-(T + 6)
    validity rows (``windowed_ok``).  ``sub_rows`` None (the tiers are
    off): win_lo 0 and never windowed."""
    pad, t6 = plan.pad_f, plan.t + SKIP_PERIOD
    w_lo = c_lo - pad
    d_lo, d_hi = u_lo - w_lo, u_hi - w_lo
    m_lo = torch.clamp(d_lo - t6, min=pad)
    m_hi = torch.clamp(d_hi + t6, max=pad + plan.stripe_h - 1)
    if sub_rows is None:
        return torch.zeros_like(m_lo), m_lo, m_hi, torch.zeros_like(m_lo, dtype=torch.bool)
    h_ext = plan.stripe_h + 2 * pad
    win_lo = torch.clamp(d_lo - 2 * plan.t - 16, 0, h_ext - sub_rows) // 8 * 8
    ok = (win_lo + t6 <= m_lo) & (m_hi < win_lo + sub_rows - t6)
    return win_lo, m_lo, m_hi, ok


def col_placement(u_clo: torch.Tensor, u_chi: torch.Tensor, plan: AdaptivePlan,
                  col_window: int, wp: int):
    """``_col_placement`` for every stripe: the column window's first word
    ``win_c`` (a multiple of 128), whether the column union and its reach
    of cw = ceil((T + 6) / 32) words lie in the window's validity words
    [win_c + cw, win_c + col_window - cw), and cw."""
    cw = (plan.t + SKIP_PERIOD + 31) // 32
    need_lo, need_hi = u_clo - cw, u_chi + cw
    win_c = torch.clamp(need_lo - cw, 0, wp - col_window) // 128 * 128
    ok = (win_c + cw <= need_lo) & (need_hi < win_c + col_window - cw)
    return win_c, ok, cw


@dataclasses.dataclass
class Routes:
    """What each stripe of a frontier launch does, per stripe (tensors):
    its ``route`` (``ROUTE_*``), its measure rows [m_lo, m_hi] and words
    [vc_lo, vc_hi), the region [v_lo, v_hi) x [vc_lo, vc_hi) where its
    window holds the true generation T, the region [w_lo, w_hi) x [wc_lo,
    wc_hi) it writes (gen T inside the validity region, its input
    elsewhere), and the change rectangle it publishes, (4, n) in chunk
    units.  Rows are in the frame of the stripe's board, strip or tile."""

    route: torch.Tensor
    m_lo: torch.Tensor
    m_hi: torch.Tensor
    v_lo: torch.Tensor
    v_hi: torch.Tensor
    vc_lo: torch.Tensor
    vc_hi: torch.Tensor
    w_lo: torch.Tensor
    w_hi: torch.Tensor
    wc_lo: torch.Tensor
    wc_hi: torch.Tensor
    rect: torch.Tensor

    @property
    def computes(self) -> torch.Tensor:
        return (self.route != ROUTE_SKIP) & (self.route != ROUTE_ELIDED)

    def part(self, stripes: slice) -> "Routes":
        """The routes of ``stripes`` (one shard's)."""
        return Routes(**{f.name: getattr(self, f.name)[..., stripes]
                         for f in dataclasses.fields(self)})


def frontier_routes(hit, u_lo, u_hi, u_clo, u_chi, c_lo: torch.Tensor, plan: AdaptivePlan,
                    shape: tuple[int, int], rect_rows: tuple[int, int] | None) -> Routes:
    """Each stripe's route from its decision (:func:`hit_union`) on a
    board, strip or tile of ``shape`` words, at the active geometry
    (:func:`frontier_geometry`): skip where it does not hit; else the
    column window (rows ``sub_rows`` x ``col_window`` words) where the
    row and column placements are both eligible, and for the rectangle
    route of K5, K8 and K14 (``rect_rows``: the rows its window must stay
    within) the window lies in them; else the row tier where the row
    placement is; else the full window.  The rectangle route writes the
    window's rows of its own centre, ``col_window`` words, and publishes
    them; the column tier of K12 (``rect_rows`` None) and every other
    route write the whole centre, which the classic routes publish."""
    sh, t = plan.stripe_h, plan.t
    wp = shape[1]
    sub_rows, cwin = frontier_geometry(plan, shape)
    s_rows = sub_rows or 0
    w_lo = c_lo - plan.pad_f
    win_lo, m_lo, m_hi, row_ok = frontier_placement(u_lo, u_hi, c_lo, plan, sub_rows)
    g_lo = w_lo + win_lo
    tier = torch.zeros_like(hit)
    win_c, cw = torch.zeros_like(c_lo), 0
    if cwin:
        win_c, col_ok, cw = col_placement(u_clo, u_chi, plan, cwin, wp)
        tier = row_ok & col_ok
        if rect_rows is not None:
            tier = tier & (g_lo >= rect_rows[0]) & (g_lo + s_rows <= rect_rows[1])
    route = torch.where(~hit, ROUTE_SKIP, torch.where(
        tier, ROUTE_TIER, torch.where(row_ok, ROUTE_ROW, ROUTE_FULL)))
    windowed = (route == ROUTE_TIER) | (route == ROUTE_ROW)
    is_tier = route == ROUTE_TIER
    rect = is_tier & (rect_rows is not None)
    skip = route == ROUTE_SKIP
    zero = torch.zeros_like(c_lo)
    r_lo = torch.where(rect, torch.maximum(g_lo, c_lo), c_lo)
    r_hi = torch.where(rect, torch.minimum(g_lo + s_rows, c_lo + sh), c_lo + sh)
    wc_lo = torch.where(rect, win_c, zero)
    wc_hi = torch.where(rect, win_c + (cwin or 0), zero + wp)
    r_lo, r_hi = torch.where(skip, zero, r_lo), torch.where(skip, zero, r_hi)
    published = torch.stack([r_lo // 8, (r_hi - r_lo) // 8, wc_lo // 128,
                             torch.where(rect, zero + (cwin or 0) // 128, zero + wp // 128)])
    return Routes(
        route=route, m_lo=m_lo + w_lo, m_hi=m_hi + w_lo,
        v_lo=torch.where(windowed, g_lo + t, c_lo), v_hi=torch.where(windowed, g_lo + s_rows - t,
                                                                     c_lo + sh),
        vc_lo=torch.where(is_tier, win_c + cw, zero),
        vc_hi=torch.where(is_tier, win_c + (cwin or 0) - cw, zero + wp),
        w_lo=r_lo, w_hi=r_hi, wc_lo=wc_lo, wc_hi=wc_hi,
        rect=torch.where(skip, zero, published))


def rect_region(rect: torch.Tensor, plan: AdaptivePlan, shape: tuple[int, int]):
    """The cells of published change rectangles ((4, n): r8, n8, c128,
    n128) as (rows lo, rows hi, words lo, words hi), half-open, by
    ``_copy_rect``'s two families: a rectangle ``col_window`` words wide
    (the rectangle route's) spans its columns, any other (the classic
    routes' whole centre) the whole width; n8 <= 0 is empty."""
    _, cwin = frontier_geometry(plan, shape)
    r8, n8, c128, n128 = rect
    windowed = (n128 == cwin // 128) if cwin else torch.zeros_like(n8, dtype=torch.bool)
    lo, hi = r8 * 8, (r8 + n8.clamp(min=0)) * 8
    c_lo = torch.where(windowed, c128 * 128, 0)
    return lo, hi, c_lo, torch.where(windowed, c_lo + (cwin or 0), shape[1])


def _stripe_mask(lo: torch.Tensor, hi: torch.Tensor, h: int, sh: int) -> torch.Tensor:
    """bool (h,): row y in [lo, hi) of its stripe (y // sh)."""
    rows = torch.arange(h, device=lo.device)
    of = rows // sh
    return (rows >= lo[of]) & (rows < hi[of])


def _word_mask(lo: torch.Tensor, hi: torch.Tensor, h: int, wp: int, sh: int) -> torch.Tensor:
    """bool (h, wp): word x in [lo, hi) of row y's stripe."""
    of = torch.arange(h, device=lo.device) // sh
    cols = torch.arange(wp, device=lo.device)
    return (cols >= lo[of, None]) & (cols < hi[of, None])


def routed_masks(rt: Routes, copy: tuple, h: int, wp: int, sh: int):
    """(written, valid, copied, measured): bool (h, wp) masks of one
    board, strip or tile of ``h`` rows in stripes of ``sh``, from its
    stripes' :class:`Routes` and ``copy``, the (rows lo, rows hi, words
    lo, words hi) each stripe copies from its input (its previous change
    rectangle)."""
    written = _stripe_mask(rt.w_lo, rt.w_hi, h, sh)[:, None] & _word_mask(rt.wc_lo, rt.wc_hi, h,
                                                                         wp, sh)
    valid = _stripe_mask(rt.v_lo, rt.v_hi, h, sh)[:, None] & _word_mask(rt.vc_lo, rt.vc_hi, h,
                                                                       wp, sh)
    copied = _stripe_mask(copy[0], copy[1], h, sh)[:, None] & _word_mask(copy[2], copy[3], h, wp,
                                                                        sh)
    m_rows = _stripe_mask(rt.m_lo, rt.m_hi + 1, h, sh) & rt.computes[torch.arange(
        h, device=rt.route.device) // sh]
    measured = m_rows[:, None] & _word_mask(rt.vc_lo, rt.vc_hi, h, wp, sh)
    return written, valid, copied, measured


def measure2(hot: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``_measure2`` per stripe: ``hot`` (n, r, c) the cells where gen
    T + 6 differs from gen T in each stripe's measure region, at rows
    ``rows`` ((n, r) or (r,)) and words ``cols`` ((n, c) or (c,)) of its
    frame.  Returns (6, n): the rows split into two intervals at the
    midpoint of their span (lo0, hi0, lo1, hi1) and the column interval
    (clo, chi); empty = (_EMPTY_LO, -1)."""
    n = hot.shape[0]
    rows = rows.expand(n, hot.shape[1])
    cols = cols.expand(n, hot.shape[2])
    big = torch.full_like(rows, _EMPTY_LO)
    rhot = hot.any(dim=2)
    lo = torch.where(rhot, rows, big).amin(dim=1)
    hi = torch.where(rhot, rows, -big).amax(dim=1)
    split = torch.div(lo + hi, 2, rounding_mode="floor")[:, None]
    hi0 = torch.where(rhot & (rows <= split), rows, -big).amax(dim=1)
    lo1 = torch.where(rhot & (rows > split), rows, big).amin(dim=1)
    chot = hot.any(dim=1)
    cbig = torch.full_like(cols, _EMPTY_LO)
    clo = torch.where(chot, cols, cbig).amin(dim=1)
    chi = torch.where(chot, cols, -cbig).amax(dim=1)
    empty = lo > hi
    one = empty | (lo1 > hi)
    return torch.stack([
        torch.where(empty, _EMPTY_LO, lo),
        torch.where(empty, -1, torch.where(lo1 > hi, hi, hi0)),
        torch.where(one, _EMPTY_LO, lo1),
        torch.where(one, -1, hi),
        torch.where(empty, _EMPTY_LO, clo),
        torch.where(empty, -1, chi),
    ])


def routed_launch(r: torch.Tensor, w: torch.Tensor, g_t: torch.Tensor, g_t6: torch.Tensor,
                  masks, sh: int):
    """One shard's writes and measure in a frontier launch, from its
    :func:`routed_masks`: the written buffer (``w`` as it was outside the
    written and copied cells) and the measure, (6, stripes)."""
    written, valid, copied, measured = masks
    out = torch.where(written, torch.where(valid, g_t, r), torch.where(copied, r, w))
    h, wp = r.shape
    hot = ((g_t6 != g_t) & measured).view(h // sh, sh, wp)
    rows = torch.arange(h, device=r.device).view(h // sh, sh)
    return out, measure2(hot, rows, torch.arange(wp, device=r.device))


def _block_mask(cells: torch.Tensor, blocks: RegPlan) -> torch.Tensor:
    """bool (row blocks, column groups): the blocks of ``blocks`` whose
    tile meets the cells (bool (h, wp)) of a shard."""
    nby, nbx = blocks.grid
    h, wp = cells.shape
    grid = torch.zeros((nby * blocks.tile_h, nbx * blocks.centre), dtype=torch.bool,
                       device=cells.device)
    grid[:h, :wp] = cells
    return grid.view(nby, blocks.tile_h, nbx, blocks.centre).any(dim=3).any(dim=1)


# -- K5: the frontier kernel ---------------------------------------------------


def _frontier_launch(r: torch.Tensor, w: torch.Tensor, plan: AdaptivePlan,
                     state: torch.Tensor | None, advance):
    """One K5 launch's decisions, routes, writes and measure in PyTorch,
    its generations from ``advance(cells)``: (gen T, gen T + 6) of the
    board, exact on ``cells`` (bool (h, wp): where the launch writes gen T)
    and on the measure region.  Returns (written buffer, new state, skips,
    per-stripe activity, routes)."""
    h, wp = r.shape
    sh = plan.stripe_h
    grid = plan.grid(h)
    dev = r.device
    t6 = plan.t + SKIP_PERIOD
    idx = torch.arange(grid, device=dev)
    c_lo = idx * sh
    c_hi = c_lo + sh - 1
    if state is None:
        hit = torch.ones(grid, dtype=torch.bool, device=dev)
        u_lo, u_hi = c_lo - t6, c_hi + t6
        u_clo, u_chi = torch.full_like(c_lo, _EMPTY_LO), torch.full_like(c_lo, -_EMPTY_LO)
        prev_rect = torch.zeros((4, grid), dtype=torch.int64, device=dev)
    else:
        # The neighbours' intervals, placed in this stripe's frame across
        # the torus wrap; their column pairs as they are.
        ivals, cvals = [], []
        for slot in (-1, 0, 1):
            j = torch.remainder(idx + slot, grid)
            off = (idx + slot - j) * sh
            ivals += [(state[2 * k][j] + off, state[2 * k + 1][j] + off) for k in (0, 1)]
            cvals.append((state[4][j], state[5][j]))
        hit, u_lo, u_hi, u_clo, u_chi = hit_union(ivals, cvals, c_lo, c_hi, plan)
        prev_rect = state[6:10]
    rt = frontier_routes(hit, u_lo, u_hi, u_clo, u_chi, c_lo, plan, (h, wp), (0, h))
    copy = list(rect_region(prev_rect, plan, (h, wp)))
    moved = (rt.route == ROUTE_SKIP) | (rt.route == ROUTE_TIER)
    copy[1] = torch.where(moved, copy[1], copy[0])
    masks = routed_masks(rt, copy, h, wp, sh)
    g_t, g_t6 = advance(masks[0] & masks[1])
    out, intervals = routed_launch(r, w, g_t, g_t6, masks, sh)
    new_state = torch.cat([intervals, rt.rect])
    act = (new_state[0] <= new_state[1]).to(torch.int32)
    return out, new_state, (~hit).sum().to(torch.int32), act, rt.route.to(torch.int32)


def frontier_launch_mirror(
    r: torch.Tensor,
    w: torch.Tensor,
    rule: LifeRule,
    plan: AdaptivePlan,
    state: torch.Tensor | None,
):
    """Plain version of one K5 launch (one grid row of
    ``_kernel_frontier_mega``): board ``r`` in, ``w`` the buffer it writes
    (the board of two launches ago), ``state`` the previous launch's int64
    (10, stripes) state (``STATE_FIELDS``) or None on launch 0 of a chunk,
    which forces every stripe to compute.  Each stripe takes its route
    (:func:`frontier_routes`) and writes its change rectangle and its
    previous one: the written buffer keeps ``w`` everywhere else.  Returns
    (written buffer, new state, skips, per-stripe activity, int32 routes)."""

    def advance(_cells):
        g_t = packed.superstep(r, rule, plan.t)
        return g_t, packed.superstep(g_t, rule, SKIP_PERIOD)

    return _frontier_launch(r, w, plan, state, advance)


def frontier_launch_reg_mirror(
    r: torch.Tensor,
    w: torch.Tensor,
    rule: LifeRule,
    plan: AdaptivePlan,
    state: torch.Tensor | None,
    blocks: RegPlan | None = None,
):
    """K5's decomposition in PyTorch: the decisions, routes and bookkeeping
    of :func:`frontier_launch_mirror`, the generations on the blocks of
    ``blocks`` (None: the :func:`frontier_blocks` of an H100) through
    :func:`_frontier_blocks`, only the blocks whose tile meets the cells
    their stripe's route writes as gen T stepping, each window's rows
    wrapping around the board (``reg::column`` of a ``BoardSource``) and
    its words modulo its width.  K8 runs it a board at a time, at its
    stack's blocks."""
    h, wp = r.shape
    blocks = blocks or frontier_blocks((h, wp), plan)
    _check_frontier_blocks(blocks, plan, (h, wp))
    halo, dev = plan.t + SKIP_PERIOD, r.device
    rows = torch.remainder(torch.arange(h + 2 * halo, device=dev) - halo, h)
    cols = torch.remainder(torch.arange(blocks.grid[1] * blocks.centre + 2, device=dev) - 1, wp)

    def advance(cells):
        return _frontier_blocks(r[rows][:, cols], rule, blocks, plan.t, (h, wp),
                                _block_mask(cells, blocks))

    return _frontier_launch(r, w, plan, state, advance)


def frontier_superstep_mirror(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
    launch=frontier_launch_mirror, each=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of ``nlaunch`` launches of ``launch`` (the plain version,
    or :func:`frontier_launch_reg_mirror`) on K5's buffer protocol.
    ``each(board, state, routes)`` is called after every launch.  Returns
    (board, skipped, activity)."""
    bufs = [torch.zeros_like(p), torch.zeros_like(p)]
    skipped = torch.zeros((), dtype=torch.int32, device=p.device)
    act = torch.zeros((plan.grid(p.shape[0]),), dtype=torch.int32, device=p.device)
    state = None
    cur = p
    for k in range(nlaunch):
        cur, state, sk, a, routes = launch(cur, bufs[k % 2], rule, plan, state)
        bufs[k % 2] = cur
        skipped, act = skipped + sk, act + a
        if each is not None:
            each(cur, state, routes)
    return cur, skipped, act


def _frontier_chunk(
    stack: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int, wrapper, each=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of ``nlaunch`` frontier launches on a CUDA (B, H, wp)
    stack (K5 is the stack of one board) on the blocks of
    :func:`frontier_blocks` for the stack and its device's SMs, at the
    active geometry, in the rule's instantiation, each counted on
    ``wrapper.launches`` and ``wrapper.rules``; returns (stack, int32[B]
    skipped, int32[B * grid] activity), all left on the device — nothing
    is read back between launches.  The launches ping-pong between two
    fresh stacks; the input is never written.  ``each(stack, state,
    routes)`` is called after every launch with the launch's int32 (10,
    B * grid) state and routes (the launch-by-launch check)."""
    nb, h, wp = stack.shape
    grid = plan.grid(h)
    dev = stack.device
    blocks = frontier_blocks((h, wp), plan, nb, device_sms(dev))
    sub_rows, col_window = frontier_geometry(plan, (h, wp))
    lib, launch = _reg_launcher("frontier", "gol_frontier_batched_launch", 8, 13)
    born, surv, variant = reg_rule(rule)
    state = torch.empty((2, len(STATE_FIELDS), nb * grid), dtype=torch.int32, device=dev)
    rowflag = torch.zeros((nb * h,), dtype=torch.int32, device=dev)
    colspan = column_span(nb * grid, dev)
    skipped = torch.zeros((nb,), dtype=torch.int32, device=dev)
    act = torch.zeros((nb * grid,), dtype=torch.int32, device=dev)
    routes = torch.empty((nlaunch, nb * grid), dtype=torch.int32, device=dev)
    bufs = (torch.empty_like(stack), torch.empty_like(stack))
    stream = _stream(stack)
    cur = stack
    for k in range(nlaunch):
        dst = bufs[k % 2]
        err = launch(
            cur.data_ptr(), dst.data_ptr(), state.data_ptr(), rowflag.data_ptr(),
            colspan.data_ptr(), skipped.data_ptr(), act.data_ptr(), routes[k].data_ptr(), nb, h,
            wp, plan.t, plan.stripe_h, blocks.tile_h, blocks.warps, plan.pad_f, sub_rows or 0,
            col_window or 0, k % 2, int(k == 0), variant, born, surv, stream,
        )
        cuda_build.check(lib, err, "frontier")
        wrapper.launches += 1
        wrapper.rules[REG_RULES[variant]] += 1
        cur = dst
        if each is not None:
            each(cur, state[k % 2], routes[k])
    return cur, skipped, act


def column_span(stripes: int, device) -> torch.Tensor:
    """A frontier kernel's column extremes, int32[stripes][2]: each
    stripe's least and greatest measured word, (_EMPTY_LO, -_EMPTY_LO)
    between launches (``frontier_finalize`` restores them)."""
    span = torch.empty((stripes, 2), dtype=torch.int32, device=device)
    span[:, 0], span[:, 1] = _EMPTY_LO, -_EMPTY_LO
    return span


def frontier_superstep(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int, each=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: one chunk of ``nlaunch`` frontier launches of ``plan.t``
    generations, launch 0 forced full; returns (board, skipped, activity),
    all left on the device.  The input is never written.  CPU tensors run
    :func:`frontier_superstep_mirror`; a CUDA tensor launches K5 (counted
    by rule instantiation in ``frontier_superstep.rules``) or raises.
    ``each(board, state, routes)`` is called after every launch."""
    _check_words(p)
    if not plan.frontier:
        raise ValueError(f"plan {plan} has no frontier form")
    if p.device.type == "cpu":
        return frontier_superstep_mirror(p, rule, plan, nlaunch, each=each)
    solo = None if each is None else (lambda b, s, r: each(b[0], s, r))
    cur, skipped, act = _frontier_chunk(p[None], rule, plan, nlaunch, frontier_superstep, solo)
    return cur[0], skipped.reshape(()), act


frontier_superstep.launches = 0
frontier_superstep.rules = collections.Counter()


# -- K8: the batched frontier kernel --------------------------------------------


def frontier_superstep_batched_mirror(
    stack: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int,
    launch=frontier_launch_mirror, each=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8: one chunk of :func:`frontier_superstep_mirror`
    on each board of a (B, H, wp) stack, each its own torus, the boards
    launch by launch together.  ``each(stack, state, routes)`` is called
    after every launch (state (10, B * grid), board b's stripes at b * grid
    + i).  Returns (stack, int32[B] skipped per board, int32[B * grid]
    activity)."""
    nb = stack.shape[0]
    grid = plan.grid(stack.shape[1])
    bufs = [torch.zeros_like(stack), torch.zeros_like(stack)]
    skipped = torch.zeros((nb,), dtype=torch.int32, device=stack.device)
    act = torch.zeros((nb * grid,), dtype=torch.int32, device=stack.device)
    states = [None] * nb
    cur = stack
    for k in range(nlaunch):
        outs, routes = [], []
        for b in range(nb):
            out, states[b], sk, a, rt = launch(cur[b], bufs[k % 2][b], rule, plan, states[b])
            outs.append(out)
            routes.append(rt)
            skipped[b] += sk
            act[b * grid : (b + 1) * grid] += a
        cur = bufs[k % 2] = torch.stack(outs)
        if each is not None:
            each(cur, torch.cat(states, dim=1), torch.cat(routes))
    return cur, skipped, act


def frontier_batched_reg_mirror(
    stack: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int, sms: int = H100_SMS,
    each=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's decomposition in PyTorch: :func:`frontier_superstep_batched_mirror`
    on :func:`frontier_launch_reg_mirror` at the blocks K8 takes for the
    whole stack on ``sms`` SMs (:func:`frontier_blocks`)."""
    blocks = frontier_blocks(tuple(stack.shape[1:]), plan, stack.shape[0], sms)
    return frontier_superstep_batched_mirror(
        stack, rule, plan, nlaunch, functools.partial(frontier_launch_reg_mirror, blocks=blocks),
        each)


def frontier_superstep_batched(
    stack: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int, each=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: one chunk of ``nlaunch`` frontier launches of ``plan.t``
    generations on every board of a (B, H, wp) stack, launch 0 forced full
    for every board; returns (stack, int32[B] skipped per board,
    int32[B * grid] activity), all left on the device.  One CUDA launch
    (and its finalize) per generation launch covers all B boards; with
    B = 1 it computes exactly K5.  CPU tensors run
    :func:`frontier_superstep_batched_mirror`; a CUDA tensor launches K8
    (counted by rule instantiation in ``frontier_superstep_batched.rules``)
    or raises.  ``each(stack, state, routes)`` is called after every
    launch."""
    _check_words(stack, 3)
    if not plan.frontier:
        raise ValueError(f"plan {plan} has no frontier form")
    if stack.device.type == "cpu":
        return frontier_superstep_batched_mirror(stack, rule, plan, nlaunch, each=each)
    return _frontier_chunk(stack, rule, plan, nlaunch, frontier_superstep_batched, each)


frontier_superstep_batched.launches = 0
frontier_superstep_batched.rules = collections.Counter()


def reset_launches() -> None:
    """Set the four kernels' launch counters, and their counts by rule
    instantiation, to 0."""
    for wrapper in (tiled_skip_superstep, probing_superstep, frontier_superstep,
                    frontier_superstep_batched):
        wrapper.launches = 0
        wrapper.rules.clear()


# -- the dispatch driver -------------------------------------------------------


def _drive(p, rule, turns, plan, frontier, probing, tiled_skip, tiled):
    """``_run_tiled``'s adaptive split of one dispatch over the four forms."""
    dev = p.device
    skipped = torch.zeros((), dtype=torch.int32, device=dev)
    act = torch.zeros((0,), dtype=torch.int32, device=dev)
    if plan is None:
        return (tiled(p, rule, turns) if turns else p), skipped, act
    full, rem = divmod(turns, plan.t)
    board = p
    if full:
        act = torch.zeros((plan.grid(p.shape[0]),), dtype=torch.int32, device=dev)
        chunks, loose = _nlaunch_chunks(full) if plan.frontier else ([], full)
        for c in chunks:
            board, sk, a = frontier(board, rule, plan, c)
            skipped, act = skipped + sk, act + a
        if loose:
            board, sk, a = probing(board, rule, plan, loose)
            skipped, act = skipped + sk, act + a
    rem6 = rem - rem % SKIP_PERIOD
    if rem6:
        board = tiled_skip(board, rule, rem6)
    if rem > rem6:
        board = tiled(board, rule, rem - rem6)
    return board, skipped, act


def adaptive_superstep(
    p: torch.Tensor, rule: LifeRule, turns: int, plan: AdaptivePlan | None = None, cap: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``turns`` generations of a packed (H, wp) board through the adaptive
    tier: (board, skipped, activity), ``skipped`` an int32 0-d tensor and
    ``activity`` an int32 per-stripe vector (empty when no adaptive launch
    ran), both left on the device.  ``plan`` forces the geometry (None:
    :func:`adaptive_plan` with ``cap``).  On a CUDA tensor every form is a
    kernel (the < 6-generation remainder is K2)."""
    if plan is None:
        plan = adaptive_plan(tuple(p.shape), turns, cap)
    return _drive(p, rule, turns, plan, frontier_superstep, probing_superstep,
                  tiled_skip_superstep, cuda_packed.tiled_superstep)


def adaptive_superstep_mirror(
    p: torch.Tensor, rule: LifeRule, turns: int, plan: AdaptivePlan | None = None, cap: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`adaptive_superstep` through the plain versions, on any
    device: the card's yardstick and the CPU tests' subject."""
    if plan is None:
        plan = adaptive_plan(tuple(p.shape), turns, cap)
    return _drive(p, rule, turns, plan, frontier_superstep_mirror, probing_superstep_mirror,
                  tiled_skip_superstep_plain, cuda_packed.tiled_superstep_plain)


# -- the batched dispatch ----------------------------------------------------------


def batched_supports(shape: tuple[int, int]) -> bool:
    """Whether a batched kernel takes per-board packed (H, wp) shape: K7
    (the board fits one block's shared memory, as for K1) or K8 (the
    adaptive tier hosts a frontier plan for it).  The port's own gates:
    the TPU's resident gate (H % 256 == 0 and a VMEM budget,
    ``pallas_packed.batched_supports``) does not carry over."""
    h, wp = shape
    if wp < 1:
        return False
    if cuda_packed.resident_shape(h, wp * WORD) is not None:
        return True
    plan = adaptive_plan(shape, 10**6) if supports(shape) else None
    return plan is not None and plan.frontier


def run_tiled_batched(
    stack: torch.Tensor,
    rule: LifeRule,
    turns: int,
    plan: AdaptivePlan | None = None,
    cap: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``_run_tiled_batched``: ``turns`` generations of a (B, H, wp) packed
    stack.  With a frontier plan the canonical chunks run on K8, all
    boards in one launch each; the rest (the loose launches and the
    remainder, fewer than min(_NLAUNCH_CANON) launches) runs per slot
    through :func:`adaptive_superstep`'s split on the solo kernels (K4, K3,
    K2).  Returns (stack, int32[B] skipped per board, counting the chunks'
    skips only, as the JAX package does).  ``plan`` forces the geometry
    (None: :func:`adaptive_plan` with ``cap``).  On the CPU the wrappers
    run their plain versions."""
    nb, h, wp = stack.shape
    if plan is None:
        plan = adaptive_plan((h, wp), turns, cap)
    skipped = torch.zeros((nb,), dtype=torch.int32, device=stack.device)
    tail = turns
    if plan is not None and plan.frontier:
        chunks, _ = _nlaunch_chunks(turns // plan.t)
        for c in chunks:
            stack, sk, _act = frontier_superstep_batched(stack, rule, plan, c)
            skipped = skipped + sk
        tail = turns - sum(chunks) * plan.t
    if tail:
        stack = torch.stack([adaptive_superstep(board, rule, tail, plan)[0] for board in stack])
    return stack, skipped
