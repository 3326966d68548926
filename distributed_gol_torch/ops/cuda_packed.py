"""The packed engine's hand-written kernel tier on an H100.

Counterpart of ``distributed_gol_tpu/ops/pallas_packed.py`` for the plain
(non-adaptive) main path; the adaptive (``skip_stable``) tier is
``ops/cuda_adaptive.py``.  Three CUDA kernels (``csrc/``), each with a
wrapper, a launch counter and a plain PyTorch version:

- **K1, resident** (``csrc/resident.cu``; replaces
  ``pallas_packed.py::_vmem_kernel``): the whole vertically packed board
  in one block's shared memory for all generations of a superstep.
  Gate: :func:`resident_shape` — the board must fit the 227 KB of dynamic
  shared memory a Hopper block may hold (512² is 32 KB).
- **K2, tiled** (``csrc/tiled.cu``; replaces ``pallas_packed.py::_kernel``
  in its ``skip_stable=False`` form): T generations per launch on 2-D
  tiles with a T-row and ``xpad``-word halo gathered modulo the board, so
  every H and every W % 32 == 0 qualifies.  Plan: :func:`tiled_plan`.
- **K7, resident batched** (``csrc/resident.cu``,
  ``gol_resident_batched_launch``; replaces
  ``pallas_packed.py::_vmem_kernel_batched``): a (B, H/32, W) stack of
  same-shape boards, one block per board.  Gate: :func:`resident_shape`
  per board, as K1's.  :func:`make_batched_superstep_bytes` is the
  serving plane's batched engine over K7 and the batched frontier kernel
  (K8, ``ops/cuda_adaptive.py``).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises — it never falls back.  Each wrapper
counts its launches in its ``launches`` attribute.
:func:`tiled_superstep_mirror` replays K2's exact window decomposition
(the same plan, halo gather and zero-filled window edges) in PyTorch, so
the halo arithmetic the CUDA kernel cannot show on a CPU is tested there.

The TPU's tuning constants (``_VMEM_BUDGET``, ``_VRESIDENT_BUDGET``,
``_LAUNCH_COST``, ``_MAX_T``) are v5e ratios and are not carried over;
the gates and the plan here are sized for Hopper's shared memory.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule
from distributed_gol_torch.ops import cuda_build, packed
from distributed_gol_torch.ops.packed import WORD, _maj, _shr, apply_rule_planes

# Dynamic shared memory one Hopper block may hold (227 KB).
SMEM_BYTES = 232448
# Deepest K2 launch the plan asks for: one halo word per side covers it.
TILED_MAX_T = 32
# Widest K2 window in words: blockDim.x of csrc/tiled.cu (kCols).
TILED_COLS = 64


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


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """One K2 launch: ``t`` generations on tiles of ``tile_h`` rows x
    ``tile_w`` words, with a ``t``-row and ``xpad``-word halo per side."""

    t: int
    tile_h: int
    tile_w: int
    xpad: int

    def __post_init__(self):
        if min(self.t, self.tile_h, self.tile_w) < 1 or self.xpad * WORD < self.t:
            raise ValueError(f"invalid tiled plan {self}: need xpad * 32 >= t >= 1")

    @property
    def rows_w(self) -> int:
        return self.tile_h + 2 * self.t

    @property
    def cols_w(self) -> int:
        return self.tile_w + 2 * self.xpad

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one block: two window buffers (ping-pong)."""
        return 2 * self.rows_w * self.cols_w * 4

    def grid(self, shape: tuple[int, int]) -> tuple[int, int]:
        """(tile rows, tile columns) covering a packed (H, wp) board."""
        h, wp = shape
        return -(-h // self.tile_h), -(-wp // self.tile_w)


def tile_width(wp: int, xpad: int) -> int:
    """Words per tile: the widest window that fits ``TILED_COLS`` words with
    an ``xpad``-word border, split evenly over a ``wp``-word board."""
    nx = -(-wp // (TILED_COLS - 2 * xpad))
    return -(-wp // nx)


def tiled_plan(shape: tuple[int, int], turns: int) -> TiledPlan:
    """K2's plan for a packed (H, wp) board: T = min(turns, 32), so one
    halo word per side; the widest window that fits ``TILED_COLS`` words,
    split evenly over the board's width; then the tallest tile whose two
    window buffers fit ``SMEM_BYTES``, split evenly over the height."""
    h, wp = shape
    t = max(1, min(turns, TILED_MAX_T))
    xpad = -(-t // WORD)
    tile_w = tile_width(wp, xpad)
    max_tile_h = SMEM_BYTES // (2 * 4 * (tile_w + 2 * xpad)) - 2 * t
    ny = -(-h // max_tile_h)
    return TiledPlan(t, -(-h // ny), tile_w, xpad)


def tiled_launches(
    shape: tuple[int, int], turns: int, plan: TiledPlan | None = None
) -> list[TiledPlan]:
    """The launches of a ``turns``-generation K2 superstep: full launches of
    ``plan.t`` generations, then one remainder launch on the same tiles.
    ``plan`` forces the tiling (tests); None takes :func:`tiled_plan`."""
    base = plan if plan is not None else tiled_plan(shape, turns)
    full, rem = divmod(turns, base.t)
    launches = [base] * full
    if rem:
        launches.append(dataclasses.replace(base, t=rem, xpad=-(-rem // WORD)))
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


# -- the tiling mirror of K2 --------------------------------------------------


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


def _window_gen(a: torch.Tensor, rule: LifeRule) -> torch.Tensor:
    """One generation of K2's windows (..., rows_w, cols_w), reading zero
    outside each window exactly as the kernel does."""
    west = (a << 1) | _shr(_shift(a, -1, 1), 31)
    east = _shr(a, 1) | (_shift(a, -1, -1) << 31)
    h0 = a ^ west ^ east
    h1 = _maj(a, west, east)
    n0, s0 = _shift(h0, -2, 1), _shift(h0, -2, -1)
    n1, s1 = _shift(h1, -2, 1), _shift(h1, -2, -1)
    t0 = h0 ^ n0 ^ s0
    c = _maj(h0, n0, s0)
    p1 = h1 ^ n1 ^ s1
    q = _maj(h1, n1, s1)
    k = p1 & c
    return apply_rule_planes((t0, p1 ^ c, q ^ k, q & k), a, rule)


def _tiled_launch_mirror(p: torch.Tensor, rule: LifeRule, plan: TiledPlan) -> torch.Tensor:
    h, wp = p.shape
    ny, nx = plan.grid((h, wp))
    dev = p.device
    rows = torch.remainder(
        torch.arange(ny, device=dev)[:, None] * plan.tile_h
        - plan.t
        + torch.arange(plan.rows_w, device=dev),
        h,
    )
    cols = torch.remainder(
        torch.arange(nx, device=dev)[:, None] * plan.tile_w
        - plan.xpad
        + torch.arange(plan.cols_w, device=dev),
        wp,
    )
    win = p[rows[:, None, :, None], cols[None, :, None, :]]  # (ny, nx, rows_w, cols_w)
    for _ in range(plan.t):
        win = _window_gen(win, rule)
    centre = win[:, :, plan.t : plan.t + plan.tile_h, plan.xpad : plan.xpad + plan.tile_w]
    out = centre.permute(0, 2, 1, 3).reshape(ny * plan.tile_h, nx * plan.tile_w)
    return out[:h, :wp].contiguous()


def tiled_superstep_mirror(
    p: torch.Tensor, rule: LifeRule, turns: int, plan: TiledPlan | None = None
) -> torch.Tensor:
    """K2's exact window decomposition in PyTorch: the launches of
    :func:`tiled_launches`, each gathering every tile's window modulo the
    board and stepping it with zero-filled window edges."""
    for launch in tiled_launches(tuple(p.shape), turns, plan):
        p = _tiled_launch_mirror(p, rule, launch)
    return p


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


def _resident_launch(v: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """One launch of the resident kernel on a CUDA (B, H/32, W) stack, one
    block per board (K1 is the stack of one board); a fresh output."""
    nb, hw, w = v.shape
    if resident_shape(hw * WORD, w) is None:
        raise ValueError(f"packed board {hw}x{w} does not fit the resident kernel")
    lib = cuda_build.load("resident")
    fn = lib.gol_resident_batched_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(v)
    born, surv = rule_masks(rule)
    err = fn(v.data_ptr(), out.data_ptr(), nb, hw, w, turns, born, surv, _stream(v))
    cuda_build.check(lib, err, "resident")
    return out


def resident_superstep(v: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """K1: ``turns`` generations of a vertically packed (H/32, W) board in
    one launch.  CPU tensors run :func:`resident_superstep_plain`."""
    _check_words(v)
    if turns == 0:
        return v
    if v.device.type == "cpu":
        return resident_superstep_plain(v, rule, turns)
    out = _resident_launch(v[None], rule, turns)[0]
    resident_superstep.launches += 1
    return out


resident_superstep.launches = 0


def resident_superstep_batched(v: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """K7: ``turns`` generations of every board of a vertically packed
    (B, H/32, W) stack in one launch, one block per board.  CPU tensors run
    :func:`resident_superstep_batched_plain`.  The input is never written."""
    _check_words(v, 3)
    if turns == 0:
        return v
    if v.device.type == "cpu":
        return resident_superstep_batched_plain(v, rule, turns)
    out = _resident_launch(v, rule, turns)
    resident_superstep_batched.launches += 1
    return out


resident_superstep_batched.launches = 0


def tiled_superstep(
    p: torch.Tensor, rule: LifeRule, turns: int, plan: TiledPlan | None = None
) -> torch.Tensor:
    """K2: ``turns`` generations of a horizontally packed (H, W/32) board,
    launched as :func:`tiled_launches` says (``plan`` forces the tiling).
    CPU tensors run :func:`tiled_superstep_plain`.  The input is never
    written: the launches ping-pong between two fresh buffers."""
    _check_words(p)
    if turns == 0:
        return p
    if p.device.type == "cpu":
        return tiled_superstep_plain(p, rule, turns)
    h, wp = p.shape
    launches = tiled_launches((h, wp), turns, plan)
    for launch in launches:
        if launch.cols_w > TILED_COLS or launch.smem_bytes > SMEM_BYTES:
            raise ValueError(f"tiled plan {launch} exceeds the kernel's window")
    lib = cuda_build.load("tiled")
    born, surv = rule_masks(rule)
    bufs = (torch.empty_like(p), torch.empty_like(p))
    cur = p
    for i, launch in enumerate(launches):
        dst = bufs[i % 2]
        err = lib.gol_tiled_launch(
            ctypes.c_void_p(cur.data_ptr()), ctypes.c_void_p(dst.data_ptr()),
            h, wp, launch.t, launch.tile_h, launch.tile_w, launch.xpad,
            ctypes.c_uint(born), ctypes.c_uint(surv), _stream(p),
        )
        cuda_build.check(lib, err, "tiled")
        tiled_superstep.launches += 1
        cur = dst
    return cur


tiled_superstep.launches = 0


def reset_launches() -> None:
    """Set the three kernels' launch counters to 0."""
    resident_superstep.launches = 0
    tiled_superstep.launches = 0
    resident_superstep_batched.launches = 0


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
