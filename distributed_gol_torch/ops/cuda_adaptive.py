"""The adaptive (``skip_stable``) tier of the packed engine on an H100.

Counterpart of the adaptive half of ``distributed_gol_tpu/ops/pallas_packed.py``
(``_run_tiled`` with ``skip_stable=True``).  A dispatch is split as the
JAX package splits it: the full launches of T generations go through the
frontier kernel in canonical chunks (``_nlaunch_chunks``), the loose tail
through the probing kernel, the period-multiple part of the remainder
through the skip form of the tiled kernel, and the last < 6 generations
through the plain tiled kernel (K2).  Three CUDA kernels (``csrc/``), each
with a wrapper, a launch counter and a plain PyTorch version:

- **K3, tiled_skip** (``csrc/tiled_skip.cu``; replaces ``_kernel`` in its
  ``skip_stable=True`` form): K2 with the 6-generation probe.  Plain
  version: :func:`tiled_skip_superstep_plain`.
- **K4, probing** (``csrc/probing.cu``; replaces ``_kernel_adaptive``):
  one launch per call of the JAX per-launch form, with its stripe bitmap,
  probe elision and write elision.  Plain version:
  :func:`probing_launch_mirror`.
- **K5, frontier** (``csrc/frontier.cu``; replaces
  ``_kernel_frontier_mega``): the tracked-interval skip/compute/measure
  state machine, one CUDA launch per generation launch, state on the
  device.  Plain version: :func:`frontier_launch_mirror`.
- **K8, frontier batched** (``csrc/frontier.cu``,
  ``gol_frontier_batched_launch``; replaces the ``nboards > 1`` form of
  ``_kernel_frontier_mega``): K5 over a (B, H, wp) stack, each board its
  own torus, with a skip count per board.  Plain version:
  :func:`frontier_superstep_batched_mirror`.  :func:`run_tiled_batched`
  is ``_run_tiled_batched``: the canonical chunks of a dispatch on K8, the
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
carried over.  No state survives a dispatch (it lives in the wrappers'
buffers), so checkpoints carry nothing new.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from distributed_gol_torch.models.life import LifeRule
from distributed_gol_torch.ops import cuda_build, cuda_packed, packed
from distributed_gol_torch.ops.cuda_packed import (
    SMEM_BYTES, TILED_COLS, _check_words, _stream, rule_masks,
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


def stripe_tiles(shape: tuple[int, int], stripe_h: int, halo: int) -> cuda_packed.TiledPlan:
    """The CUDA blocks of K4 and K5, as a ``TiledPlan`` whose ``t`` is the
    window's row halo: K2's tile width with an ``xpad``-word border, and
    the tallest divisor of the stripe whose two window buffers fit
    ``SMEM_BYTES`` (a stripe's tiles together decide for it)."""
    xpad = -(-halo // WORD)
    tile_w = cuda_packed.tile_width(shape[1], xpad)
    for k in range(1, stripe_h + 1):
        if stripe_h % k == 0:
            tiles = cuda_packed.TiledPlan(halo, stripe_h // k, tile_w, xpad)
            if tiles.smem_bytes <= SMEM_BYTES:
                return tiles
    raise ValueError(f"no stripe tiling of {shape} with a {halo}-row halo fits shared memory")


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


# -- K3: the skip form of the tiled kernel --------------------------------------


def tiled_skip_superstep_plain(p: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """Plain version of K3: ``packed.superstep``."""
    return packed.superstep(p, rule, turns)


def tiled_skip_superstep(p: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """K3: one launch of ``turns`` generations (a multiple of 6, at most
    ``cuda_packed.TILED_MAX_T``) on K2's tiles, with the skip proof.  CPU
    tensors run :func:`tiled_skip_superstep_plain`."""
    _check_words(p)
    if not _adaptive_eligible(turns):
        raise ValueError(f"skip launches need a positive multiple of {SKIP_PERIOD} turns")
    if p.device.type == "cpu":
        return tiled_skip_superstep_plain(p, rule, turns)
    h, wp = p.shape
    plan = cuda_packed.tiled_plan((h, wp), turns)
    if plan.t != turns or plan.cols_w > TILED_COLS or plan.smem_bytes > SMEM_BYTES:
        raise ValueError(f"no single skip launch of {turns} turns on {h}x{wp} words")
    lib, launch = _launcher("tiled_skip", "gol_tiled_skip_launch", [_P, _P] + [_I] * 6 + [_U, _U, _P])
    born, surv = rule_masks(rule)
    out = torch.empty_like(p)
    err = launch(p.data_ptr(), out.data_ptr(), h, wp, turns, plan.tile_h, plan.tile_w, plan.xpad,
                 born, surv, _stream(p))
    cuda_build.check(lib, err, "tiled_skip")
    tiled_skip_superstep.launches += 1
    return out


tiled_skip_superstep.launches = 0


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
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``nlaunch`` launches of :func:`probing_launch_mirror` on K4's buffer
    protocol, from a zero bitmap.  Returns (board, skipped, activity)."""
    flags = torch.ones((nlaunch + 1, plan.grid(p.shape[0])), dtype=torch.int32, device=p.device)
    flags[0] = 0
    bufs = [torch.zeros_like(p), p.clone()]
    cur = p
    for k in range(nlaunch):
        cur, flags[k + 1] = probing_launch_mirror(cur, bufs[k % 2], rule, plan, flags[k])
        bufs[k % 2] = cur
    return (cur, *_probing_stats(flags[1:]))


def probing_superstep(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: ``nlaunch`` probing launches of ``plan.t`` generations from a
    zero bitmap; returns (board, skipped, activity), all left on the
    device.  Launch k writes the buffer of launch k - 2 (the second buffer
    starts as a copy of the input), so an elided stripe writes nothing; the
    input is never written.  CPU tensors run
    :func:`probing_superstep_mirror`."""
    _check_words(p)
    if p.device.type == "cpu":
        return probing_superstep_mirror(p, rule, plan, nlaunch)
    h, wp = p.shape
    tiles = stripe_tiles((h, wp), plan.stripe_h, plan.pad)
    lib, launch = _launcher("probing", "gol_probing_launch", [_P] * 4 + [_I] * 8 + [_U, _U, _P])
    born, surv = rule_masks(rule)
    flags = torch.ones((nlaunch + 1, plan.grid(h)), dtype=torch.int32, device=p.device)
    flags[0] = 0
    bufs = (torch.empty_like(p), p.clone())
    cur = p
    for k in range(nlaunch):
        dst = bufs[k % 2]
        err = launch(
            cur.data_ptr(), dst.data_ptr(), flags[k].data_ptr(), flags[k + 1].data_ptr(),
            h, wp, plan.t, plan.stripe_h, tiles.tile_h, tiles.tile_w, tiles.xpad, tiles.t,
            born, surv, _stream(p),
        )
        cuda_build.check(lib, err, "probing")
        probing_superstep.launches += 1
        cur = dst
    return (cur, *_probing_stats(flags[1:]))


probing_superstep.launches = 0


# -- K5: the frontier kernel ---------------------------------------------------


def hit_union(ivals, c_lo: torch.Tensor, c_hi: torch.Tensor, plan: AdaptivePlan):
    """``_hit_union`` for every stripe at once: ``ivals`` are the (lo, hi)
    int tensors of the intervals of each stripe's neighbourhood, placed in
    its row frame.  Returns (hit, measure lo, measure hi) per stripe."""
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
    return hit, torch.maximum(u_lo - t6, c_lo), torch.minimum(u_hi + t6, c_hi)


def measure2(hot: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``_measure2`` per stripe: the (grid, stripe_h) ``hot`` rows (gen
    T + 6 differs from gen T in the measure region) at their ``rows``, as
    the two intervals (lo0, hi0, lo1, hi1), a (4, grid) tensor: the
    stripe-wide span split at its midpoint; empty = (_EMPTY_LO, -1)."""
    big = torch.full_like(rows, _EMPTY_LO)
    lo = torch.where(hot, rows, big).amin(dim=1)
    hi = torch.where(hot, rows, -big).amax(dim=1)
    split = torch.div(lo + hi, 2, rounding_mode="floor")[:, None]
    hi0 = torch.where(hot & (rows <= split), rows, -big).amax(dim=1)
    lo1 = torch.where(hot & (rows > split), rows, big).amin(dim=1)
    empty = lo > hi
    one = empty | (lo1 > hi)
    return torch.stack([
        torch.where(empty, _EMPTY_LO, lo),
        torch.where(empty, -1, torch.where(lo1 > hi, hi, hi0)),
        torch.where(one, _EMPTY_LO, lo1),
        torch.where(one, -1, hi),
    ])


def frontier_launch_mirror(
    r: torch.Tensor,
    w: torch.Tensor,
    rule: LifeRule,
    plan: AdaptivePlan,
    state: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of one K5 launch (one grid row of
    ``_kernel_frontier_mega``): board ``r`` in, ``w`` the buffer it writes
    (the board of two launches ago), ``state`` the previous launch's int64
    (5, stripes) state — rows lo0, hi0, lo1, hi1, computed — or None on
    launch 0 of a chunk, which forces every stripe to compute.  Returns
    (written buffer, new state, skips, per-stripe activity)."""
    h = r.shape[0]
    sh = plan.stripe_h
    grid = plan.grid(h)
    dev = r.device
    t6 = plan.t + SKIP_PERIOD
    idx = torch.arange(grid, device=dev)
    c_lo = idx * sh
    c_hi = c_lo + sh - 1
    if state is None:
        hit = torch.ones(grid, dtype=torch.bool, device=dev)
        m_lo, m_hi = c_lo, c_hi
    else:
        # The neighbours' intervals, placed in this stripe's frame across
        # the torus wrap.
        ivals = []
        for slot in (-1, 0, 1):
            j = torch.remainder(idx + slot, grid)
            off = (idx + slot - j) * sh
            ivals += [(state[2 * k][j] + off, state[2 * k + 1][j] + off) for k in (0, 1)]
        hit, m_lo, m_hi = hit_union(ivals, c_lo, c_hi, plan)

    g_t = packed.superstep(r, rule, plan.t)
    g_t6 = packed.superstep(g_t, rule, SKIP_PERIOD)
    rows = torch.arange(h, device=dev)
    of = rows // sh
    hot = (g_t6 != g_t).any(dim=1) & hit[of] & (rows >= m_lo[of]) & (rows <= m_hi[of])
    new_state = torch.cat([measure2(hot.view(grid, sh), rows.view(grid, sh)),
                           hit.to(torch.int64)[None]])
    copy = ~hit & (state[4].bool() if state is not None else hit)
    out = torch.where(hit[of, None], g_t, torch.where(copy[of, None], r, w))
    act = (new_state[0] <= new_state[1]).to(torch.int32)
    return out, new_state, (~hit).sum().to(torch.int32), act


def frontier_superstep_mirror(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of ``nlaunch`` launches of :func:`frontier_launch_mirror`
    on K5's buffer protocol.  Returns (board, skipped, activity)."""
    bufs = [torch.zeros_like(p), torch.zeros_like(p)]
    skipped = torch.zeros((), dtype=torch.int32, device=p.device)
    act = torch.zeros((plan.grid(p.shape[0]),), dtype=torch.int32, device=p.device)
    state = None
    cur = p
    for k in range(nlaunch):
        cur, state, sk, a = frontier_launch_mirror(cur, bufs[k % 2], rule, plan, state)
        bufs[k % 2] = cur
        skipped, act = skipped + sk, act + a
    return cur, skipped, act


def _frontier_chunk(
    stack: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int, wrapper
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of ``nlaunch`` frontier launches on a CUDA (B, H, wp)
    stack (K5 is the stack of one board), each counted on
    ``wrapper.launches``; returns (stack, int32[B] skipped, int32[B * grid]
    activity), all left on the device — nothing is read back between
    launches.  The launches ping-pong between two fresh stacks; the input
    is never written."""
    nb, h, wp = stack.shape
    grid = plan.grid(h)
    tiles = stripe_tiles((h, wp), plan.stripe_h, plan.t + SKIP_PERIOD)
    lib, launch = _launcher(
        "frontier", "gol_frontier_batched_launch", [_P] * 6 + [_I] * 11 + [_U, _U, _P])
    born, surv = rule_masks(rule)
    dev = stack.device
    state = torch.empty((2, 5, nb * grid), dtype=torch.int32, device=dev)
    rowflag = torch.zeros((nb * h,), dtype=torch.int32, device=dev)
    skipped = torch.zeros((nb,), dtype=torch.int32, device=dev)
    act = torch.zeros((nb * grid,), dtype=torch.int32, device=dev)
    bufs = (torch.empty_like(stack), torch.empty_like(stack))
    cur = stack
    for k in range(nlaunch):
        dst = bufs[k % 2]
        err = launch(
            cur.data_ptr(), dst.data_ptr(), state.data_ptr(), rowflag.data_ptr(),
            skipped.data_ptr(), act.data_ptr(), nb, h, wp, plan.t, plan.stripe_h, tiles.tile_h,
            tiles.tile_w, tiles.xpad, tiles.t, k % 2, int(k == 0), born, surv, _stream(stack),
        )
        cuda_build.check(lib, err, "frontier")
        wrapper.launches += 1
        cur = dst
    return cur, skipped, act


def frontier_superstep(
    p: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: one chunk of ``nlaunch`` frontier launches of ``plan.t``
    generations, launch 0 forced full; returns (board, skipped, activity),
    all left on the device.  The input is never written.  CPU tensors run
    :func:`frontier_superstep_mirror`."""
    _check_words(p)
    if not plan.frontier:
        raise ValueError(f"plan {plan} has no frontier form")
    if p.device.type == "cpu":
        return frontier_superstep_mirror(p, rule, plan, nlaunch)
    cur, skipped, act = _frontier_chunk(p[None], rule, plan, nlaunch, frontier_superstep)
    return cur[0], skipped.reshape(()), act


frontier_superstep.launches = 0


# -- K8: the batched frontier kernel --------------------------------------------


def frontier_superstep_batched_mirror(
    stack: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8: one chunk of :func:`frontier_superstep_mirror`
    on each board of a (B, H, wp) stack, each its own torus.  Returns
    (stack, int32[B] skipped per board, int32[B * grid] activity, board b's
    stripes at b * grid + i)."""
    outs = [frontier_superstep_mirror(board, rule, plan, nlaunch) for board in stack]
    return (
        torch.stack([o[0] for o in outs]),
        torch.stack([o[1] for o in outs]),
        torch.cat([o[2] for o in outs]),
    )


def frontier_superstep_batched(
    stack: torch.Tensor, rule: LifeRule, plan: AdaptivePlan, nlaunch: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: one chunk of ``nlaunch`` frontier launches of ``plan.t``
    generations on every board of a (B, H, wp) stack, launch 0 forced full
    for every board; returns (stack, int32[B] skipped per board,
    int32[B * grid] activity), all left on the device.  One CUDA launch
    (and its finalize) per generation launch covers all B boards; with
    B = 1 it computes exactly K5.  CPU tensors run
    :func:`frontier_superstep_batched_mirror`."""
    _check_words(stack, 3)
    if not plan.frontier:
        raise ValueError(f"plan {plan} has no frontier form")
    if stack.device.type == "cpu":
        return frontier_superstep_batched_mirror(stack, rule, plan, nlaunch)
    return _frontier_chunk(stack, rule, plan, nlaunch, frontier_superstep_batched)


frontier_superstep_batched.launches = 0


def reset_launches() -> None:
    """Set the four kernels' launch counters to 0."""
    tiled_skip_superstep.launches = 0
    probing_superstep.launches = 0
    frontier_superstep.launches = 0
    frontier_superstep_batched.launches = 0


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
