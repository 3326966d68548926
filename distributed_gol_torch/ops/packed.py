"""Bit-packed SWAR generation engine on PyTorch tensors.

PyTorch counterpart of ``distributed_gol_tpu/ops/packed.py``: 32 cells
per word (bit ``k`` of ``packed[y, wx]`` is the cell at ``(y, 32*wx + k)``,
LSB first), the Moore-neighbourhood sum as bit-plane full adders, and the
B/S rule applied directly on the 9-cell total planes.  It is the plain
version of both hand-written kernels (``ops/cuda_packed.py``) and the
``packed`` engine of the Backend.  Every function takes a board or a
``(B, H, Wp)`` stack of same-shape boards: the rolls run along the last two
axes, so each board of a stack is its own torus (the batched forms).

Words are int32 tensors holding the uint32 bit pattern: this PyTorch
build has no ``<<``, ``>>`` or ``~`` on ``torch.uint32`` on the CPU, and
``>>`` on int32 is arithmetic, so every right shift here is masked to a
logical one (``_shr``).  Compare words with the JAX package on
``.numpy().view(np.uint32)``.
"""

from __future__ import annotations

import torch

from distributed_gol_torch.models.life import CONWAY, LifeRule

WORD = 32
_LOW31 = 0x7FFFFFFF


def supports(shape: tuple[int, int]) -> bool:
    _, w = shape
    return w % WORD == 0 and w > 0


def _shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words by ``k`` (1..31)."""
    return (a >> k) & (_LOW31 >> (k - 1))


def _to_words(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 words with the same bit pattern."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _weights(device) -> torch.Tensor:
    return torch.ones(WORD, dtype=torch.int64, device=device) << torch.arange(
        WORD, device=device
    )


# -- packing ------------------------------------------------------------------


def pack(board: torch.Tensor) -> torch.Tensor:
    """uint8 {0,255} board (..., H, W) → int32 words (..., H, W // 32);
    only the LSB of each byte is read."""
    *lead, h, w = board.shape
    if w % WORD:
        raise ValueError(f"width {w} not a multiple of {WORD}")
    bits = (board & 1).to(torch.int64).reshape(*lead, h, w // WORD, WORD)
    return _to_words((bits * _weights(board.device)).sum(dim=-1))


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """int32 words (..., H, Wp) → uint8 {0,255} board (..., H, 32 * Wp)."""
    *lead, h, wp = packed.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    # The arithmetic shift only smears copies of bit 31 above bit 31 - k;
    # the & 1 reads bit k exactly.
    bits = (packed[..., None] >> shifts) & 1
    return (bits.to(torch.uint8) * 255).reshape(*lead, h, wp * WORD)


def pack_vertical(board: torch.Tensor) -> torch.Tensor:
    """uint8 {0,255} board (..., H, W) → int32 words (..., H // 32, W),
    bit ``k`` of word (wy, x) = cell (32*wy + k, x) — the resident
    kernel's layout."""
    *lead, h, w = board.shape
    if h % WORD:
        raise ValueError(f"height {h} not a multiple of {WORD}")
    bits = (board & 1).to(torch.int64).reshape(*lead, h // WORD, WORD, w)
    return _to_words((bits * _weights(board.device)[:, None]).sum(dim=-2))


def unpack_vertical(packed_v: torch.Tensor) -> torch.Tensor:
    """int32 words (..., H // 32, W) → uint8 {0,255} board (..., H, W)."""
    *lead, hw, w = packed_v.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed_v.device)
    bits = (packed_v[..., :, None, :] >> shifts[:, None]) & 1
    return (bits.to(torch.uint8) * 255).reshape(*lead, hw * WORD, w)


# -- the adder network --------------------------------------------------------


def _maj(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Bitwise majority — the carry of a 3-input full adder."""
    return (a & b) | (c & (a ^ b))


def _west(a: torch.Tensor) -> torch.Tensor:
    """Plane whose bit at cell x holds the bit at x-1 (torus wrap)."""
    return (a << 1) | _shr(torch.roll(a, 1, -1), 31)


def _east(a: torch.Tensor) -> torch.Tensor:
    """Plane whose bit at cell x holds the bit at x+1 (torus wrap)."""
    return _shr(a, 1) | (torch.roll(a, -1, -1) << 31)


def total_planes(a: torch.Tensor):
    """The 9-cell (centre + 8 neighbours) sum as 4 bit planes, T ∈ [0, 9]:
    the horizontal 3-column sum first, then the vertical sum of its two
    planes."""
    w = _west(a)
    e = _east(a)
    h0 = a ^ w ^ e
    h1 = _maj(a, w, e)
    n0 = torch.roll(h0, 1, -2)
    s0 = torch.roll(h0, -1, -2)
    n1 = torch.roll(h1, 1, -2)
    s1 = torch.roll(h1, -1, -2)
    t0 = h0 ^ n0 ^ s0
    c = _maj(h0, n0, s0)
    p1 = h1 ^ n1 ^ s1
    q = _maj(h1, n1, s1)
    k = p1 & c
    return t0, p1 ^ c, q ^ k, q & k


_MAX_TOTAL = 9  # centre + 8 neighbours


def _match(planes, k: int) -> torch.Tensor:
    """Plane that is all-ones where the 4-bit plane number equals ``k``,
    given the number is ≤ ``_MAX_TOTAL``; a zero bit ``i`` of ``k`` is
    tested only if the alias ``k + 2^i`` is a reachable total."""
    acc = None
    for i, n in enumerate(planes):
        if k & (1 << i):
            term = n
        elif k + (1 << i) <= _MAX_TOTAL:
            term = ~n
        else:
            continue
        acc = term if acc is None else acc & term
    return acc


def apply_rule_planes(totals, centre: torch.Tensor, rule: LifeRule) -> torch.Tensor:
    """Next-generation words from the 9-cell total planes and the centre
    plane: birth terms match ``T == b``, survive terms ``T == s + 1``, and
    a total in both sets is centre-independent."""
    birth = set(rule.birth)
    survive = {s + 1 for s in rule.survive}
    out = None

    def _or(acc, term):
        return term if acc is None else acc | term

    for k in sorted(birth & survive):
        out = _or(out, _match(totals, k))
    for k in sorted(birth - survive):
        out = _or(out, _match(totals, k) & ~centre)
    for k in sorted(survive - birth):
        out = _or(out, _match(totals, k) & centre)
    return torch.zeros_like(centre) if out is None else out


def step(a: torch.Tensor, rule: LifeRule = CONWAY) -> torch.Tensor:
    """One generation on a packed board."""
    return apply_rule_planes(total_planes(a), a, rule)


def popcount(a: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts of int32-held uint32 words (int64)."""
    x = a.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def alive_count(a: torch.Tensor) -> torch.Tensor:
    """Alive cells in a packed board (unsynced 0-d int64 tensor)."""
    return popcount(a).sum()


def superstep(a: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """``turns`` generations on a packed board."""
    for _ in range(turns):
        a = step(a, rule)
    return a


def steps_with_counts(a: torch.Tensor, rule: LifeRule, turns: int):
    """``turns`` generations -> (packed board, per-turn alive counts of
    :func:`count_dtype`): ``counts[i]`` is the count after generation
    ``i + 1``."""
    dtype = count_dtype(a.numel() * WORD)
    counts = []
    for _ in range(turns):
        a = step(a, rule)
        counts.append(alive_count(a).to(dtype))
    if not counts:
        return a, torch.zeros(0, dtype=dtype, device=a.device)
    return a, torch.stack(counts)


def make_superstep(rule: LifeRule = CONWAY):
    """``(board_u8, turns) -> board_u8`` with all generations packed."""

    def run(board: torch.Tensor, turns: int) -> torch.Tensor:
        return unpack(superstep(pack(board), rule, turns))

    return run


def make_steps_with_counts(rule: LifeRule = CONWAY):
    """``(board_u8, turns) -> (board_u8, per-turn counts)``."""

    def run(board: torch.Tensor, turns: int):
        final, counts = steps_with_counts(pack(board), rule, turns)
        return unpack(final), counts

    return run


# -- batched forms: a leading board axis --------------------------------------
#
# One dispatch advances B independent same-shape boards, each its own torus
# (the rolls above act on the last two axes only).  This is the portable
# form of the serving plane's cohort launch and, on the CPU, the plain
# version of the batched kernels (ops/cuda_packed.py, ops/cuda_adaptive.py).


def batched_superstep(stack: torch.Tensor, rule: LifeRule, turns: int) -> torch.Tensor:
    """``turns`` generations of a (B, H, Wp) packed stack in one dispatch,
    each slot an independent torus."""
    return superstep(stack, rule, turns)


def _needs_wide_counts(ncells: int) -> bool:
    """Boards whose alive population could exceed 2^31 (>= 46341² dense)."""
    return ncells >= 2**31


def count_dtype(ncells: int) -> torch.dtype:
    """The JAX package's accumulator policy for a board of ``ncells``
    cells: int32, and int64 only where the count could pass 2^31."""
    return torch.int64 if _needs_wide_counts(ncells) else torch.int32


def batched_alive_counts(stack: torch.Tensor) -> torch.Tensor:
    """Per-board alive counts of a (B, H, Wp) packed stack (or of a
    vertically packed one: the popcount does not depend on the packing),
    an unsynced length-B vector of :func:`count_dtype`."""
    ncells = stack.shape[-2] * stack.shape[-1] * WORD
    return popcount(stack).sum(dim=(-2, -1)).to(count_dtype(ncells))


def make_batched_superstep(rule: LifeRule = CONWAY):
    """``(stack_u8 (B, H, W), turns) -> (stack_u8, counts (B,))``: pack,
    all generations, unpack and the per-board counts."""

    def run(stack: torch.Tensor, turns: int):
        p = pack(stack)
        if turns:
            p = batched_superstep(p, rule, turns)
        return unpack(p), batched_alive_counts(p)

    return run
