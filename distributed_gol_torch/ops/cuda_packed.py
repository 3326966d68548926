"""The packed engine's hand-written kernel tier on an H100.

Counterpart of ``distributed_gol_tpu/ops/pallas_packed.py`` for the plain
(non-adaptive) main path; the adaptive (``skip_stable``) tier is
``ops/cuda_adaptive.py``.  Three CUDA kernels (``csrc/``), each with a
wrapper, a launch counter and a plain PyTorch version:

- **K1, resident** (``csrc/resident.cu``, ``gol_resident_reg_launch``;
  replaces ``pallas_packed.py::_vmem_kernel``): the whole vertically
  packed board in registers across a thread-block cluster for all
  generations of a superstep, one column run a thread.  Gate:
  :func:`resident_shape` — the board must fit the 227 KB of dynamic
  shared memory a Hopper block may hold (512² is 32 KB), as K7's does.
  Plan: :func:`resident_reg_plan`; :func:`resident_superstep_mirror`
  replays its sub-runs and exchange in PyTorch.
- **K2, tiled** (``csrc/tiled.cu``; replaces ``pallas_packed.py::_kernel``
  in its ``skip_stable=False`` form): T generations per launch of the
  horizontally packed board, read in place as the torus, on
  ``csrc/regwin.cuh``'s register-resident window (K9's), so every H and
  every W % 32 == 0 qualifies.  Plan: :func:`tiled_reg_plan`, launches
  :func:`tiled_reg_launches`; :func:`tiled_reg_mirror` replays its blocks,
  runs, light cone and torus load in PyTorch.
- **K7, resident batched** (``csrc/resident.cu``, the same
  ``gol_resident_reg_launch`` with a board axis; replaces
  ``pallas_packed.py::_vmem_kernel_batched``): a (B, H/32, W) stack of
  same-shape boards, one cluster a board.  Gate: :func:`resident_shape`
  per board.  Plan: :func:`resident_batched_plan`, K1's priced by the
  waves the stack takes on the card's active clusters;
  :func:`resident_superstep_batched_mirror` replays it.
  :func:`make_batched_superstep_bytes` is the serving plane's batched
  engine over K7 and the batched frontier kernel (K8,
  ``ops/cuda_adaptive.py``).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises — it never falls back.  Each wrapper
counts its launches in its ``launches`` attribute, and in ``rules`` by
the rule's instantiation.  The mirrors run only in tests, where they
show on the CPU the decomposition the CUDA kernels cannot.

The TPU's tuning constants (``_VMEM_BUDGET``, ``_VRESIDENT_BUDGET``,
``_LAUNCH_COST``, ``_MAX_T``) are v5e ratios and are not carried over;
the gates and the plan here are sized for Hopper's shared memory.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule
from distributed_gol_torch.ops import cuda_build, packed
from distributed_gol_torch.ops.packed import WORD, _maj, _shr, apply_rule_planes

# Dynamic shared memory one Hopper block may hold (227 KB).
SMEM_BYTES = 232448
#: SMs of an NVIDIA H100 SXM: the card the plans are made for where no
#: device is at hand (the mirrors on the CPU, the tests).
H100_SMS = 132
# Deepest launch of K2 and K3: one border word a side covers it.
TILED_MAX_T = 32


def rule_masks(rule: LifeRule) -> tuple[int, int]:
    """(born, surv): the rule as two masks over the 9-cell total, the
    kernels' runtime rule argument.  Bit k of ``born`` = a dead cell with
    total k is born; bit k of ``surv`` = a live cell with total k (k - 1
    neighbours) survives."""
    born = sum(1 << b for b in rule.birth)
    surv = sum(1 << (s + 1) for s in rule.survive)
    return born, surv


# -- gates and launch plan (pure Python) --------------------------------------


def resident_shape(h: int, w: int) -> tuple[int, int] | None:
    """The vertically packed (H // 32, W) shape if a board of H x W cells
    runs on K1, else None: H and W multiples of 32 and the packed board
    within one block's shared memory."""
    if h <= 0 or w <= 0 or h % WORD or w % WORD:
        return None
    if (h // WORD) * w * 4 > SMEM_BYTES:
        return None
    return (h // WORD, w)


def kernel_for(shape: tuple[int, int]) -> str | None:
    """Which kernel runs an H x W board: "resident" (K1), "tiled" (K2), or
    None when W is not a multiple of 32 (no packed words at all)."""
    h, w = shape
    if not packed.supports(shape) or h <= 0:
        return None
    return "resident" if resident_shape(h, w) is not None else "tiled"


#: K1's instantiations (``csrc/resident.cu``): a sub-run's registers H
#: (8 or 2), each with 32 / H sub-runs a thread.
RESIDENT_RUNS = (8, 2)
#: Most centre columns of a warp (lanes 1..30; lanes 0 and q + 1 are halo),
#: most warps of a CTA (512 threads, so a thread may hold 128 registers:
#: at 1,024 threads and 64 the sub-runs' bookkeeping spilled) and most CTAs
#: of a cluster (16 needs the card's non-portable cluster size).
RESIDENT_GROUP, RESIDENT_MAX_WARPS, RESIDENT_MAX_CLUSTER = 30, 16, 16
#: The plan's price of a generation, in SM cycles: a warp-row (12 integer
#: instructions at 2 warp-instructions a cycle, ``chip_smoke.py::
#: ops_per_word``; the 4 shuffles issue on their own pipe), one more on a
#: ragged run's row (its bounds), a sub-run's exchange (its table reads,
#: edge stores, ballots and halo loads), and the barrier of one CTA, of a
#: portable cluster (up to 8 CTAs) and of a larger one.  Sized from the
#: card's rates, not measured; ``tools/regwin_ab.py --sweep`` times every
#: cluster size the plan weighs.
_ROW_CYCLES, _RAGGED_ROW_CYCLES, _SUBRUN_CYCLES = 6.0, 1.0, 40.0
_BARRIER_CYCLES = (60.0, 400.0, 800.0)


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """One K1 launch on a vertically packed (hw, w) board ``shape``: the
    board's columns evened over ``groups`` = ceil(w / 30) column groups, its
    word rows cut into runs of ``rh`` rows (the last may hold fewer), one
    sub-run a (run, group); a warp holds ``vs`` sub-runs of at most
    ``h_run`` rows (the instantiation), a CTA ``wpc`` warps, the cluster
    ``cluster`` CTAs, each holding sub-runs."""

    shape: tuple[int, int]
    h_run: int
    rh: int
    vs: int
    wpc: int
    cluster: int

    def __post_init__(self):
        hw, w = self.shape
        if not (hw >= 1 and w >= WORD and w % WORD == 0 and self.h_run in RESIDENT_RUNS
                and 1 <= self.rh <= self.h_run and 1 <= self.vs <= WORD // self.h_run
                and 1 <= self.wpc <= RESIDENT_MAX_WARPS
                and 1 <= self.cluster <= RESIDENT_MAX_CLUSTER
                and self.cluster * self.spc >= self.nsub > (self.cluster - 1) * self.spc):
            raise ValueError(f"invalid resident plan {self}")

    @property
    def groups(self) -> int:
        return -(-self.shape[1] // RESIDENT_GROUP)

    @property
    def runs(self) -> int:
        return -(-self.shape[0] // self.rh)

    @property
    def nsub(self) -> int:
        return self.groups * self.runs

    @property
    def spc(self) -> int:
        """Sub-runs a CTA holds (its last ones may lie past the board)."""
        return self.wpc * self.vs

    @property
    def ragged(self) -> bool:
        """Whether some run holds fewer than ``h_run`` rows: the
        instantiation that bounds its rows at run time."""
        return self.rh != self.h_run or self.shape[0] % self.rh != 0

    @property
    def smem_bytes(self) -> int:
        """A CTA's shared memory: two parities of its sub-runs' slots (two
        edge columns and two ballots each) and its sub-runs' table."""
        return 4 * self.spc * (2 * (2 * self.h_run + 2) + 12)

    def cost(self, ctas: int = 1) -> float:
        """SM cycles of one generation on the busiest SM, which holds
        ``ctas`` CTAs of the plan at once (K7: boards side by side): their
        warp-rows and sub-run exchanges at the share of its 4 schedulers
        their warps fill, then the barrier."""
        rows = self.wpc * self.vs * self.rh * ctas
        row = _ROW_CYCLES + (_RAGGED_ROW_CYCLES if self.ragged else 0.0)
        fill = 4 / min(4, self.wpc * ctas)
        barrier = _BARRIER_CYCLES[(self.cluster > 1) + (self.cluster > 8)]
        return (rows * row + self.spc * ctas * _SUBRUN_CYCLES) * fill + barrier


def resident_reg_candidates(hw: int, w: int) -> list[ResidentPlan]:
    """Every K1 plan :func:`resident_reg_plan` weighs for a packed (hw, w)
    board: each instantiation, each run height of a power of two up to it
    (or the board's height), each count of sub-runs a warp, and each
    cluster size that leaves no CTA empty and at most ``RESIDENT_MAX_WARPS``
    warps a CTA."""
    plans = []
    for h_run in RESIDENT_RUNS:
        for rh in sorted({min(d, hw) for d in (1, 2, 4, 8, 16, 32) if d <= h_run}):
            groups, runs = -(-w // RESIDENT_GROUP), -(-hw // rh)
            for vs in range(1, WORD // h_run + 1):
                warps = -(-groups * runs // vs)
                for cluster in range(1, RESIDENT_MAX_CLUSTER + 1):
                    wpc = -(-warps // cluster)
                    if wpc <= RESIDENT_MAX_WARPS and (cluster - 1) * wpc < warps:
                        plans.append(ResidentPlan((hw, w), h_run, rh, vs, wpc, cluster))
    return plans


@functools.lru_cache(maxsize=256)
def resident_reg_plan(hw: int, w: int) -> ResidentPlan:
    """K1's plan for a packed (hw, w) board that :func:`resident_shape`
    takes: of :func:`resident_reg_candidates`, the least
    :meth:`ResidentPlan.cost`, then the fewest CTAs, then the fewest warps.
    Raises for a board the gate refuses."""
    if resident_shape(hw * WORD, w) is None:
        raise ValueError(f"packed board {hw}x{w} does not fit the resident kernel")
    return min(resident_reg_candidates(hw, w),
               key=lambda p: (p.cost(), p.cluster, p.wpc * p.cluster))


def resident_batched_cost(plan: ResidentPlan, nb: int, active: int, sms: int) -> float:
    """SM cycles of one generation of a K7 launch of ``nb`` boards on
    ``plan``, where the card holds ``active`` of its clusters at once on
    ``sms`` SMs: the waves the stack takes, ceil(nb / active), each at
    K1's :meth:`ResidentPlan.cost` with the CTAs a wave puts on the
    busiest SM."""
    at_once = min(nb, active)
    return -(-nb // active) * plan.cost(-(-at_once * plan.cluster // sms))


def resident_batched_plan(nb: int, hw: int, w: int, active=None,
                          sms: int = H100_SMS) -> ResidentPlan:
    """K7's plan for a stack of ``nb`` packed (hw, w) boards that
    :func:`resident_shape` takes: of :func:`resident_reg_candidates`, the
    least :func:`resident_batched_cost`, then the fewest CTAs, then the
    fewest warps.  ``active(plan)`` is how many clusters of a plan the card
    holds at once (on the card ``cudaOccupancyMaxActiveClusters``,
    :func:`card_active_clusters`); None takes one CTA an SM, ``sms`` //
    cluster, on ``sms`` SMs (an H100's 132 where no card is at hand, as
    the other plans assume).  With one board it is K1's plan; with many, small
    clusters win, since a wave of clusters costs a cluster's time.  Raises
    for a board the gate refuses and where the card holds no cluster of
    any plan."""
    if resident_shape(hw * WORD, w) is None:
        raise ValueError(f"packed board {hw}x{w} does not fit the resident kernel")
    if nb < 1:
        raise ValueError(f"a stack of {nb} boards")
    active = active or (lambda p: sms // p.cluster)
    scored = []
    for p in resident_reg_candidates(hw, w):
        n = active(p)
        if n >= 1:
            scored.append(((resident_batched_cost(p, nb, n, sms), p.cluster, p.wpc * p.cluster), p))
    if not scored:
        raise ValueError(f"the card holds no cluster of any resident plan for a stack of {nb} "
                         f"{hw}x{w}-word boards")
    return min(scored, key=lambda kp: kp[0])[1]


@functools.lru_cache(maxsize=256)
def tiled_reg_plan(shape: tuple[int, int], turns: int, sms: int):
    """K2's launch of ``turns`` generations on a packed (h, wp) torus: T =
    min(turns, 32), so one border word a side, on K9's blocks
    (``cuda_halo.ext_reg_plan``: column groups of 30 words, row tiles with
    T rows a side filling ``sms`` SMs).  T = 64, two border words and 128
    halo rows, costs more a generation (``tools/regwin_ab.py
    --sweep-k2-k7``).  Every board qualifies: the kernel takes rows modulo
    h, so a tile's window may be taller than the torus."""
    from distributed_gol_torch.parallel.cuda_halo import ext_reg_plan

    return ext_reg_plan(shape, min(turns, TILED_MAX_T), sms)


def tiled_reg_launches(shape: tuple[int, int], turns: int, sms: int = H100_SMS,
                       plan=None) -> list:
    """The launches of a ``turns``-generation K2 superstep on a packed
    (h, wp) torus on ``sms`` SMs: full launches of :func:`tiled_reg_plan`,
    then one remainder launch of its own depth, so the superstep's
    generation count is exact.  ``plan`` (a ``RegPlan``) forces the full
    launches' blocks (tests); its remainder keeps its row tiles, with the
    border and column groups of its own depth."""
    base = plan or tiled_reg_plan(shape, turns, sms)
    full, rem = divmod(turns, base.t)
    launches = [base] * full
    if rem:
        if plan is None:
            launches.append(tiled_reg_plan(shape, rem, sms))
        else:
            border = -(-rem // WORD)
            launches.append(dataclasses.replace(
                plan, t=rem, halo=rem, border=border,
                grid=(plan.grid[0], -(-shape[1] // (WORD - 2 * border)))))
    return launches


# -- plain versions -----------------------------------------------------------


def _gen_vertical(a: torch.Tensor, rule: LifeRule) -> torch.Tensor:
    """One generation of a whole vertically packed board (or of each board
    of a (B, H/32, W) stack); both wraps are exact.  Plain version of one
    K1 (and K7) generation."""
    up = torch.roll(a, 1, -2)  # word row above, wrapping: carries for bit 0
    dn = torch.roll(a, -1, -2)
    north = (a << 1) | _shr(up, 31)
    south = _shr(a, 1) | (dn << 31)
    v0 = a ^ north ^ south
    v1 = _maj(a, north, south)

    def hsum(v):
        west = torch.roll(v, 1, -1)  # one cell column per word here
        east = torch.roll(v, -1, -1)
        return v ^ west ^ east, _maj(v, west, east)

    s0, c0 = hsum(v0)
    s1, c1 = hsum(v1)
    k = c0 & s1
    return apply_rule_planes((s0, c0 ^ s1, c1 ^ k, c1 & k), a, rule)


def resident_superstep_plain(v: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """Plain version of K1: ``turns`` generations of a vertically packed
    board."""
    for _ in range(turns):
        v = _gen_vertical(v, rule)
    return v


def resident_superstep_mirror(
    v: torch.Tensor, rule: LifeRule, turns: int, plan: ResidentPlan | None = None
) -> torch.Tensor:
    """K1's decomposition in PyTorch: the sub-runs of ``plan`` (None:
    :func:`resident_reg_plan`), each a warp's 32 lanes of ``h_run`` rows
    whose lanes 1..q hold its group's columns and lanes 0 and q + 1 the
    halo columns; every generation each sub-run publishes its first and
    last centre columns and the ballots of its first row's bit 0 and its
    last row's bit 31, then refreshes its halo lanes from its west and east
    neighbours' edges, takes its carries from the runs above and below (a
    halo lane's from the diagonal runs, at its column's lane there), and
    steps its rows with the lanes wrapping within the warp."""
    hw, w = v.shape
    plan = plan or resident_reg_plan(hw, w)
    if plan.shape != (hw, w):
        raise ValueError(f"plan {plan} is not for a {hw}x{w} board")
    ng, rh, h = plan.groups, plan.rh, plan.h_run
    dev = v.device
    gy = torch.arange(plan.runs, device=dev).repeat_interleave(ng)
    gx = torch.arange(ng, device=dev).repeat(plan.runs)
    first = gx * w // ng
    q = (gx + 1) * w // ng - first
    rows = torch.clamp(hw - gy * rh, max=rh)
    lanes = torch.arange(WORD, device=dev)
    cols = torch.remainder(first[:, None] - 1 + lanes, w)  # (nsub, 32)
    r = gy[:, None] * rh + torch.arange(h, device=dev)  # (nsub, h)
    live = torch.arange(h, device=dev) < rows[:, None]

    def at(dy: int, dx: int) -> torch.Tensor:
        return torch.remainder(gy + dy, plan.runs) * ng + torch.remainder(gx + dx, ng)

    west, east, north, south = at(0, -1), at(0, 1), at(-1, 0), at(1, 0)
    nw, ne, sw, se = at(-1, -1), at(-1, 1), at(1, -1), at(1, 1)
    u = torch.arange(plan.nsub, device=dev)
    last = rows - 1
    s = v[r.clamp(max=hw - 1)[:, :, None], cols[:, None, :]] * live[:, :, None]
    for _ in range(turns):
        edge_w, edge_e = s[:, :, 1], s[u, :, q]  # (nsub, h): lanes 1 and q
        top, bot = s[:, 0, :] & 1, _shr(s[u, last, :], 31)  # (nsub, 32): the ballots
        s = s.clone()
        s[:, :, 0] = torch.where(live, edge_e[west], s[:, :, 0])
        s[u, :, q + 1] = torch.where(live, edge_w[east], s[u, :, q + 1])
        up, dn = bot[north].clone(), top[south].clone()
        up[:, 0], dn[:, 0] = bot[nw, q[west]], top[sw, q[west]]
        up[u, q + 1], dn[u, q + 1] = bot[ne, 1], top[se, 1]
        prev = torch.cat([(up << 31)[:, None, :], s[:, :-1, :]], dim=1)
        below = torch.cat([s[:, 1:, :], torch.zeros_like(s[:, :1, :])], dim=1)
        below[u, last] = dn
        nrt = (s << 1) | _shr(prev, 31)
        sth = _shr(s, 1) | (below << 31)
        v0, v1 = s ^ nrt ^ sth, _maj(s, nrt, sth)

        def hsum(x):
            xw, xe = torch.roll(x, 1, -1), torch.roll(x, -1, -1)  # the warp's lanes wrap
            return x ^ xw ^ xe, _maj(x, xw, xe)

        s0, c0 = hsum(v0)
        s1, c1 = hsum(v1)
        k = c0 & s1
        nxt = apply_rule_planes((s0, c0 ^ s1, c1 ^ k, c1 & k), s, rule)
        s = torch.where(live[:, :, None], nxt, s)
    out = torch.empty_like(v)
    keep = live[:, :, None] & (lanes >= 1) & (lanes <= q[:, None, None])
    rr = r[:, :, None].expand_as(s)
    cc = cols[:, None, :].expand_as(s)
    out[rr[keep], cc[keep]] = s[keep]
    return out


def resident_superstep_batched_plain(
    v: torch.Tensor, rule: LifeRule, turns: int
) -> torch.Tensor:
    """Plain version of K7: ``turns`` generations of each board of a
    vertically packed (B, H/32, W) stack, per slot (the rotates of
    :func:`_gen_vertical` stay inside each board)."""
    return resident_superstep_plain(v, rule, turns)


def tiled_superstep_plain(p: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """Plain version of K2: ``packed.superstep``."""
    return packed.superstep(p, rule, turns)


# -- the block mirrors of K2 and K7 ------------------------------------------


def _shift(a: torch.Tensor, dim: int, by: int) -> torch.Tensor:
    """``out[i] = a[i - by]`` along ``dim``, zero where that is outside."""
    n = a.shape[dim]
    out = torch.zeros_like(a)
    if abs(by) < n:
        if by > 0:
            out.narrow(dim, by, n - by).copy_(a.narrow(dim, 0, n - by))
        else:
            out.narrow(dim, 0, n + by).copy_(a.narrow(dim, -by, n + by))
    return out


def _tiled_reg_launch_mirror(p: torch.Tensor, rule: LifeRule, plan) -> torch.Tensor:
    from distributed_gol_torch.ops.cuda_adaptive import _reg_stitch, _reg_steps, _reg_windows

    h, wp = p.shape
    if plan.halo != plan.t or plan.grid[0] * plan.tile_h < h or plan.grid[1] * plan.centre < wp:
        raise ValueError(f"plan {plan} does not cover a {plan.t}-generation launch on {h}x{wp}")
    win = _reg_windows(p, plan, -plan.t, -plan.border, True, wrap_rows=True)
    win = _reg_steps(win, rule, plan, range(1, plan.t + 1))
    return _reg_stitch(win, plan)[:h, :wp].contiguous()


def tiled_reg_mirror(p: torch.Tensor, rule: LifeRule, turns: int, plan=None,
                     sms: int = H100_SMS) -> torch.Tensor:
    """K2's decomposition in PyTorch: the launches of
    :func:`tiled_reg_launches` (``plan`` forces the blocks, ``sms`` the SMs
    the plan fills), each block's window (warps·32 rows
    from T above its tile, 32 words from ``border`` left of its column
    group, rows modulo h and words modulo wp: the torus in place, zero
    past the window's rows) stepped T generations with its columns
    wrapping within it and only the rows each run's light cone steps
    (``RegPlan.live``), its centre stored."""
    for launch in tiled_reg_launches(tuple(p.shape), turns, sms, plan):
        p = _tiled_reg_launch_mirror(p, rule, launch)
    return p


def resident_superstep_batched_mirror(v: torch.Tensor, rule: LifeRule, turns: int,
                                      plan: ResidentPlan | None = None) -> torch.Tensor:
    """K7's decomposition in PyTorch: each board of the (B, H/32, W) stack
    through K1's block mirror (:func:`resident_superstep_mirror`) on the
    batched plan (``plan``; None: :func:`resident_batched_plan` with one
    CTA an SM of an H100), since a board's cluster reads nothing of
    another's."""
    nb, hw, w = v.shape
    plan = plan or resident_batched_plan(nb, hw, w)
    return torch.stack([resident_superstep_mirror(b, rule, turns, plan) for b in v])


# -- the kernel wrappers ------------------------------------------------------


def _check_words(t: torch.Tensor, ndim: int = 2) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``ndim``
    dimensions (a board, or with 3 a (B, H, W) stack) on the CPU or CUDA."""
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"packed words must be a contiguous {ndim}-D int32 tensor, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _resident_launch(v: torch.Tensor, rule: LifeRule, turns: int,
                     plan: ResidentPlan) -> tuple[torch.Tensor, str]:
    """One launch of K1 (a (H/32, W) board) or K7 (a (B, H/32, W) stack,
    one cluster a board) on a CUDA tensor at ``plan``; (a fresh output, the
    name of the rule's instantiation).  A cluster the card cannot schedule
    raises, naming its shape."""
    from distributed_gol_torch.ops.cuda_adaptive import REG_RULES, _reg_launcher, reg_rule

    nb, hw, w = v.shape if v.dim() == 3 else (1, *v.shape)
    lib, launch = _reg_launcher("resident", "gol_resident_reg_launch", 2, 11)
    out = torch.empty_like(v)
    born, surv, variant = reg_rule(rule)
    with torch.cuda.device(v.device):
        err = launch(v.data_ptr(), out.data_ptr(), nb, hw, w, turns, plan.h_run,
                     int(plan.ragged), plan.rh, plan.vs, plan.wpc, plan.cluster, variant, born,
                     surv, _stream(v))
    cuda_build.check(lib, err, f"resident (clusters of {plan.cluster} CTAs of {plan.wpc} warps "
                               f"on {nb} {hw}x{w}-word board(s))")
    return out, REG_RULES[variant]


@functools.lru_cache(maxsize=1024)
def _active_clusters(device: int, plan: ResidentPlan, born: int, surv: int, variant: int) -> int:
    from distributed_gol_torch.ops.cuda_adaptive import _launcher

    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib, query = _launcher("resident", "gol_resident_reg_clusters", [P] + [I] * 9 + [U, U])
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = query(ctypes.addressof(n), *plan.shape, plan.h_run, int(plan.ragged), plan.rh,
                    plan.vs, plan.wpc, plan.cluster, variant, born, surv)
    cuda_build.check(lib, err, f"resident occupancy ({plan})")
    return n.value


def card_active_clusters(device, rule: LifeRule):
    """``active(plan)`` for :func:`resident_batched_plan` on the CUDA
    ``device``: how many clusters of ``plan`` the card holds at once in
    ``rule``'s instantiation (``cudaOccupancyMaxActiveClusters``, through
    ``gol_resident_reg_clusters``), cached per plan."""
    from distributed_gol_torch.ops.cuda_adaptive import reg_rule

    index = torch.device(device).index or 0
    born, surv, variant = reg_rule(rule)
    return lambda plan: _active_clusters(index, plan, born, surv, variant)


@functools.lru_cache(maxsize=256)
def _card_batched_plan(device: int, rule: LifeRule, nb: int, hw: int, w: int) -> ResidentPlan:
    from distributed_gol_torch.ops.cuda_adaptive import device_sms

    dev = torch.device("cuda", device)
    return resident_batched_plan(nb, hw, w, card_active_clusters(dev, rule), device_sms(dev))


def card_batched_plan(v: torch.Tensor, rule: LifeRule) -> ResidentPlan:
    """The plan K7 launches on the CUDA stack ``v`` under ``rule``:
    :func:`resident_batched_plan` with the card's SMs and active clusters,
    cached per (B, H/32, W), since a serving cohort's B varies."""
    return _card_batched_plan(v.device.index or 0, rule, *v.shape)


def resident_superstep(v: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """K1: ``turns`` generations of a vertically packed (H/32, W) board in
    one launch on the cluster of :func:`resident_reg_plan`, in the rule's
    instantiation (counted in ``resident_superstep.rules``).  CPU tensors
    run :func:`resident_superstep_plain`; the input is never written."""
    _check_words(v)
    if turns == 0:
        return v
    if v.device.type == "cpu":
        return resident_superstep_plain(v, rule, turns)
    out, instantiation = _resident_launch(v, rule, turns, resident_reg_plan(*v.shape))
    resident_superstep.launches += 1
    resident_superstep.rules[instantiation] += 1
    return out


resident_superstep.launches = 0
resident_superstep.rules = collections.Counter()


def resident_superstep_batched(v: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """K7: ``turns`` generations of every board of a vertically packed
    (B, H/32, W) stack in one launch, one cluster a board, on
    :func:`card_batched_plan`, in the rule's instantiation (counted in
    ``resident_superstep_batched.rules``).  CPU tensors run
    :func:`resident_superstep_batched_plain`.  The input is never
    written."""
    _check_words(v, 3)
    if turns == 0:
        return v
    if v.device.type == "cpu":
        return resident_superstep_batched_plain(v, rule, turns)
    nb, hw, w = v.shape
    if resident_shape(hw * WORD, w) is None:
        raise ValueError(f"packed board {hw}x{w} does not fit the resident kernel")
    out, instantiation = _resident_launch(v, rule, turns, card_batched_plan(v, rule))
    resident_superstep_batched.launches += 1
    resident_superstep_batched.rules[instantiation] += 1
    return out


resident_superstep_batched.launches = 0
resident_superstep_batched.rules = collections.Counter()


def tiled_superstep(p: torch.Tensor, rule: LifeRule, turns: int, plan=None) -> torch.Tensor:
    """K2: ``turns`` generations of a horizontally packed (H, W/32) board,
    launched as :func:`tiled_reg_launches` says for its device's SMs
    (``plan``, a ``RegPlan``, forces the full launches' blocks), each in the
    rule's instantiation (counted in ``tiled_superstep.rules``).  CPU
    tensors run :func:`tiled_superstep_plain`.  The input is never
    written: the launches ping-pong between two fresh buffers."""
    from distributed_gol_torch.ops.cuda_adaptive import (
        REG_RULES, _reg_launcher, device_sms, reg_rule)

    _check_words(p)
    if turns == 0:
        return p
    if p.device.type == "cpu":
        return tiled_superstep_plain(p, rule, turns)
    h, wp = p.shape
    launches = tiled_reg_launches((h, wp), turns, device_sms(p.device), plan)
    for launch in launches:
        if (launch.halo != launch.t or launch.grid[0] * launch.tile_h < h
                or launch.grid[1] * launch.centre < wp):
            raise ValueError(f"tiled plan {launch} does not cover a {h}x{wp}-word board")
    lib, fn = _reg_launcher("tiled", "gol_tiled_launch", 2, 7)
    born, surv, variant = reg_rule(rule)
    bufs = (torch.empty_like(p), torch.empty_like(p))
    cur = p
    with torch.cuda.device(p.device):
        for i, launch in enumerate(launches):
            dst = bufs[i % 2]
            err = fn(cur.data_ptr(), dst.data_ptr(), h, wp, launch.t, launch.tile_h, launch.warps,
                     launch.border, variant, born, surv, _stream(p))
            cuda_build.check(lib, err, f"tiled ({launch} on a {h}x{wp}-word board)")
            tiled_superstep.launches += 1
            tiled_superstep.rules[REG_RULES[variant]] += 1
            cur = dst
    return cur


tiled_superstep.launches = 0
tiled_superstep.rules = collections.Counter()


def reset_launches() -> None:
    """Set the three kernels' launch counters, and their counts by rule, to 0."""
    for wrapper in (resident_superstep, tiled_superstep, resident_superstep_batched):
        wrapper.launches = 0
        wrapper.rules.clear()


def supports(shape: tuple[int, int]) -> bool:
    """Board shapes (cells) the kernel tier takes: every W % 32 == 0."""
    return kernel_for(shape) is not None


def make_superstep_bytes(
    rule: LifeRule = CONWAY,
    device="cuda",
    skip_stable: bool = False,
    skip_tile_cap: int = 0,
    with_stats: bool = False,
    plan=None,
):
    """``(board_u8, turns) -> board_u8`` engine-layer drop-in: the board
    moves to ``device``, then one packing pass each way around the kernel —
    K1 boards go straight to the vertical layout.

    ``skip_stable`` sends every board the adaptive tier takes
    (``cuda_adaptive.supports``) through it, K1 boards included, with
    stripes capped at ``skip_tile_cap`` (0 = the default) or the forced
    ``plan`` (a ``cuda_adaptive.AdaptivePlan``).  ``with_stats`` returns
    ``(board_u8, skipped, activity)``; a dispatch with no adaptive launch
    returns ``(board, 0, empty)``."""
    from distributed_gol_torch.ops import cuda_adaptive

    dev = torch.device(device)

    def stats(board):
        if not with_stats:
            return board
        return (
            board,
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev),
        )

    def run(board, turns: int):
        board = torch.as_tensor(board, device=dev)
        if not turns:
            return stats(board)
        h, w = board.shape
        kernel = kernel_for((h, w))
        if kernel is None:
            raise ValueError(f"no packed kernel takes a {(h, w)} board")
        if skip_stable and cuda_adaptive.supports((h, w // WORD)):
            p, skipped, act = cuda_adaptive.adaptive_superstep(
                packed.pack(board), rule, turns, plan, skip_tile_cap
            )
            out = packed.unpack(p)
            return (out, skipped, act) if with_stats else out
        if kernel == "resident":
            v = resident_superstep(packed.pack_vertical(board), rule, turns)
            return stats(packed.unpack_vertical(v))
        return stats(packed.unpack(tiled_superstep(packed.pack(board), rule, turns)))

    return run


def make_batched_superstep_bytes(rule: LifeRule = CONWAY, device="cuda", skip_tile_cap: int = 0):
    """``(stack_u8 (B, H, W), turns) -> (stack_u8, counts (B,))``: the
    batched engine-layer drop-in, B same-shape boards per dispatch, split
    as ``pallas_packed.make_batched_superstep_bytes`` splits it.  A board K7
    takes (:func:`resident_shape`) runs the whole dispatch in one K7 launch,
    its counts taken on the vertical stack (the popcount does not depend on
    the packing); a board of the adaptive tier runs its canonical frontier
    chunks on K8 and the rest of the dispatch per slot on the solo kernels
    (``cuda_adaptive.run_tiled_batched``, stripes capped at
    ``skip_tile_cap``, 0 = the default); any other board the plain batched
    engine (``packed.batched_superstep``).  On the CPU the wrappers run
    their plain versions.  The stack moves to ``device``."""
    from distributed_gol_torch.ops import cuda_adaptive

    dev = torch.device(device)

    def run(stack, turns: int):
        stack = torch.as_tensor(stack, device=dev)
        _, h, w = stack.shape
        if turns and resident_shape(h, w) is not None:
            v = resident_superstep_batched(packed.pack_vertical(stack).contiguous(), rule, turns)
            return packed.unpack_vertical(v), packed.batched_alive_counts(v)
        p = packed.pack(stack).contiguous()
        if turns and cuda_adaptive.supports((h, w // WORD)):
            p, _ = cuda_adaptive.run_tiled_batched(p, rule, turns, cap=skip_tile_cap)
        elif turns:
            p = packed.batched_superstep(p, rule, turns)
        return packed.unpack(p), packed.batched_alive_counts(p)

    return run
