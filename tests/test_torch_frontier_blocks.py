"""The blocks of the register-resident frontier kernels K5, K8 and K14
(``csrc/frontier.cu``: ``frontier_reg_kernel`` and
``strip_mega_reg_kernel``) replayed in PyTorch, against their plain
versions.

``cuda_adaptive.frontier_launch_reg_mirror`` (K5, and K8 a board at a
time through ``frontier_batched_reg_mirror``) and
``cuda_halo.strip_mega_launch_mirror`` (K14) keep the plain versions'
decisions and bookkeeping and run the generations as the kernels do:
blocks of one row tile of a stripe with T + 6 rows a side and one
32-word column group (30 centre words), each run stepping only its
light cone's chunks.  Each must equal its plain version exactly, launch
by launch (board or strips, state), and in the chunk's skip counts and
activity, at several plans and block heights, on ragged column groups
and on boards narrower than one group, under both compiled-in rules and
one that takes the generic instantiation.  A copy of the blocks whose
light cone is one chunk short must not.  The JAX comparisons are in
``tests/test_torch_adaptive.py`` (K5's mirror against
``_kernel_frontier_mega``) and ``tests/test_torch_strip_mega.py`` (K14's
against the loopback build of ``_kernel_frontier_mega_strip``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.parallel import cuda_halo

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=bool)  # heads down-right
BLOCK = np.ones((2, 2), dtype=bool)
RULES = ["conway", "highlife", "day-and-night"]
KINDS = ["ash", "glider", "pulsar", "soup"]
PLANS = {"T24-s64": cuda_adaptive.AdaptivePlan(24, 64, True),
         "T18-s32": cuda_adaptive.AdaptivePlan(18, 32, True),
         "T6-s16": cuda_adaptive.AdaptivePlan(6, 16, True)}
# Board widths in words: 64 leaves a ragged last column group (two groups
# of 30 and one of 4); 2 is narrower than one group, so a window's 32
# lanes wrap around the board many times.
WIDTHS = (64, 2)


def _pulsar() -> np.ndarray:
    p = np.zeros((13, 13), dtype=bool)
    for c in (2, 3, 4, 8, 9, 10):
        for r in (0, 5, 7, 12):
            p[r, c] = p[c, r] = True
    return p


def _put(b: np.ndarray, cells: np.ndarray, y: int, x: int) -> None:
    ys, xs = np.nonzero(cells)
    b[(ys + y) % b.shape[0], (xs + x) % b.shape[1]] = True


def board(kind: str, h: int, wp: int, stripe: int) -> torch.Tensor:
    """A packed (h, wp) board: "ash" (blocks); "glider" (ash, a glider
    crossing a stripe seam and one crossing the torus wrap in both axes);
    "pulsar" (on a stripe seam); "soup" (density 0.3, seeded)."""
    w = wp * 32
    if kind == "soup":
        b = np.random.default_rng(h + w).random((h, w)) < 0.3
    else:
        b = np.zeros((h, w), dtype=bool)
        if kind in ("ash", "glider"):
            for y in range(stripe // 2, h, 3 * stripe // 2):
                for x in range(9 + y % 7, w, 300):
                    _put(b, BLOCK, y, x)
        if kind == "glider":
            _put(b, GLIDER, stripe - 5, w // 2)
            _put(b, GLIDER, h - 2, w - 2)
        if kind == "pulsar":
            _put(b, _pulsar(), stripe - 6, w // 3)
    return tpacked.pack(torch.from_numpy(b.astype(np.uint8) * 255))


def other_blocks(shape, plan) -> cuda_adaptive.RegPlan:
    """Frontier blocks of ``plan`` on ``shape`` at a row tile other than
    the H100's pick: the shortest divisor of the stripe of 8 rows or more
    that it did not take."""
    h, wp = shape
    chosen = cuda_adaptive.frontier_blocks(shape, plan)
    halo = plan.t + 6
    tile_h = next(d for d in range(8, plan.stripe_h + 1)
                  if plan.stripe_h % d == 0 and d != chosen.tile_h)
    return cuda_adaptive.RegPlan(halo, halo, tile_h, -(-(tile_h + 2 * halo) // 32),
                                 (h // tile_h, -(-wp // 30)), keep=True)


def k5_chunk(p, rule, plan, n, launch):
    """``n`` launches of ``launch`` on K5's buffer protocol: each launch's
    (board, state), then the chunk's skip count and activity."""
    seen = []

    def record(r, w, rule_, plan_, state):
        out = launch(r, w, rule_, plan_, state)
        seen.append((out[0].clone(), out[1].clone()))
        return out

    _, sk, act = cuda_adaptive.frontier_superstep_mirror(p, rule, plan, n, record)
    return seen, sk, act


def assert_same_k5(a, b):
    for (x, sx), (y, sy) in zip(a[0], b[0]):
        assert torch.equal(x, y) and torch.equal(sx, sy)
    assert len(a[0]) == len(b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


# -- K5 ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks", ["h100", "other"])
@pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rule", RULES)
def test_k5_block_mirror_matches_plain(rule, kind, plan, blocks):
    """Four launches of K5's block mirror against the plain version on a
    board of two to four stripes, 64 words wide (a ragged column group)
    and 2 words wide (narrower than a group), at the H100's blocks and at
    another row tile: each launch's board and state, the skip count and
    the activity, tolerance 0."""
    r = tlife.RULES[rule]
    h = max(2 * plan.stripe_h, 64)
    for wp in WIDTHS:
        p = board(kind, h, wp, plan.stripe_h)
        bl = (cuda_adaptive.frontier_blocks((h, wp), plan) if blocks == "h100"
              else other_blocks((h, wp), plan))
        plain = k5_chunk(p, r, plan, 4, cuda_adaptive.frontier_launch_mirror)
        mirror = k5_chunk(p, r, plan, 4, functools.partial(
            cuda_adaptive.frontier_launch_reg_mirror, blocks=bl))
        assert_same_k5(plain, mirror)
        assert torch.equal(plain[0][-1][0], tpacked.superstep(p, r, 4 * plan.t))


def test_k5_block_mirror_refuses_blocks_that_miss_the_board():
    plan = PLANS["T18-s32"]
    p = board("soup", 64, 64, plan.stripe_h)
    good = cuda_adaptive.frontier_blocks((64, 64), plan)
    for bad in (dataclasses.replace(good, grid=(good.grid[0] - 1, good.grid[1])),
                dataclasses.replace(good, grid=(good.grid[0], good.grid[1] - 1)),
                dataclasses.replace(good, t=good.t - 6, halo=good.halo - 6)):
        with pytest.raises(ValueError):
            cuda_adaptive.frontier_launch_reg_mirror(p, torch.zeros_like(p), tlife.CONWAY, plan,
                                                     None, bad)


class ShortCone(cuda_adaptive.RegPlan):
    """Frontier blocks whose light cone is one chunk short at each end: a
    mirror that steps too little."""

    def cone(self, g):
        lo, hi = super().cone(g)
        return lo + cuda_adaptive.REG_CHUNK, hi - cuda_adaptive.REG_CHUNK


@pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
def test_a_light_cone_one_chunk_short_fails(plan):
    """The mutation check: the block mirror with :class:`ShortCone`
    blocks (the same row tiles and grid) must differ from the plain
    version on a soup, where the unmutated mirror equals it."""
    h, wp = max(2 * plan.stripe_h, 64), 64
    p = board("soup", h, wp, plan.stripe_h)
    good = cuda_adaptive.frontier_blocks((h, wp), plan)
    short = ShortCone(**dataclasses.asdict(good))
    plain = k5_chunk(p, tlife.CONWAY, plan, 2, cuda_adaptive.frontier_launch_mirror)
    right = k5_chunk(p, tlife.CONWAY, plan, 2, functools.partial(
        cuda_adaptive.frontier_launch_reg_mirror, blocks=good))
    wrong = k5_chunk(p, tlife.CONWAY, plan, 2, functools.partial(
        cuda_adaptive.frontier_launch_reg_mirror, blocks=short))
    assert_same_k5(plain, right)
    assert not torch.equal(plain[0][0][0], wrong[0][0][0])


# -- K8 ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
@pytest.mark.parametrize("rule", RULES)
def test_k8_block_mirror_on_a_stack_with_a_dead_board(rule, plan):
    """K8's block mirror (each board on the blocks K8 takes for the whole
    stack) on a 3-board stack whose middle board is dead, between a board
    with gliders crossing its own row wrap and a soup: boards, per-board
    skip counts and activity equal the plain version's, the dead board
    skips every launch but the forced first and the live boards never
    read it; with one board it equals K5's block mirror."""
    r = tlife.RULES[rule]
    h, wp = max(2 * plan.stripe_h, 64), 64
    stack = torch.stack([board("glider", h, wp, plan.stripe_h), torch.zeros((h, wp), dtype=torch.int32),
                         board("soup", h, wp, plan.stripe_h)])
    want = cuda_adaptive.frontier_superstep_batched_mirror(stack, r, plan, 4)
    got = cuda_adaptive.frontier_batched_reg_mirror(stack, r, plan, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    grid = plan.grid(h)
    assert int(got[1][1]) == 3 * grid and int(got[2][grid : 2 * grid].sum()) == 0
    for i in (0, 2):
        assert torch.equal(got[0][i], tpacked.superstep(stack[i], r, 4 * plan.t))
    one = cuda_adaptive.frontier_batched_reg_mirror(stack[:1], r, plan, 4)
    k5 = cuda_adaptive.frontier_superstep_mirror(stack[0], r, plan, 4,
                                                 cuda_adaptive.frontier_launch_reg_mirror)
    assert torch.equal(one[0][0], k5[0]) and int(one[1][0]) == int(k5[1])
    assert torch.equal(one[2], k5[2])


def test_frontier_blocks_are_the_stacked_plan():
    """The blocks of one shard of a K5, K8 or K14 launch: the
    ``frontier_reg_plan`` of every shard's rows stacked, its grid's rows one
    shard's, every row and word of the shard stored once."""
    for shape, shards in (((16384, 512), 1), ((4096, 128), 4), ((4096, 512), 4), ((64, 3), 1)):
        plan = cuda_adaptive.adaptive_plan(shape, 10**6)
        blocks = cuda_adaptive.frontier_blocks(shape, plan, shards)
        stacked = cuda_adaptive.frontier_reg_plan((shards * shape[0], shape[1]), plan.stripe_h,
                                                  plan.t, cuda_adaptive.H100_SMS)
        assert dataclasses.replace(blocks, grid=stacked.grid) == stacked
        assert blocks.grid[0] * blocks.tile_h == shape[0]
        assert (blocks.grid[1] - 1) * blocks.centre < shape[1] <= blocks.grid[1] * blocks.centre
        assert plan.stripe_h % blocks.tile_h == 0 and blocks.keep and blocks.t == plan.t + 6


# -- K14 --------------------------------------------------------------------------


def k14_chunk(monkeypatch, strips, rule, plan, n, mirror, blocks=None):
    """An ``n``-launch K14 chunk through the plain version, or with
    ``mirror`` through the block mirror in its place: each launch's strips
    and state, then the final skip counts and activity."""
    if mirror:
        monkeypatch.setattr(cuda_halo, "strip_mega_launch_plain", functools.partial(
            cuda_halo.strip_mega_launch_mirror, blocks=blocks))
    seen = []
    _, st = cuda_halo.strip_mega_launches(
        strips, rule, plan, n, True,
        lambda out, st: seen.append(([t.clone() for t in out], st.state.clone())))
    monkeypatch.undo()
    return seen, st.skipped.clone(), st.act.clone()


@functools.lru_cache(maxsize=None)
def seam_board(ny: int, h_loc: int, wp: int) -> torch.Tensor:
    """A soup of ny strips of h_loc rows after 3,000 generations, with a
    glider heading down across every strip seam."""
    p = tpacked.superstep(board("soup", ny * h_loc, wp, 8), tlife.CONWAY, 3000)
    b = tpacked.unpack(p).numpy() > 0
    for k in range(1, ny + 1):
        y, x = k * h_loc - 5, (17 * k) % (wp * 32)
        b[y - 3 : y + 6, x : x + 9] = False
        _put(b, GLIDER, y, x + 3)
    return tpacked.pack(torch.from_numpy(b.astype(np.uint8) * 255))


@pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
@pytest.mark.parametrize("ny", [4, 2, 1])
@pytest.mark.parametrize("rule", RULES)
def test_k14_block_mirror_matches_plain(monkeypatch, rule, ny, plan):
    """Four launches of K14's block mirror against the plain version on
    (ny, 1) strips of 64 rows, 64 and 2 words wide: each launch's strips
    and whole state, the skip counts and the activity, tolerance 0.  On
    (2, 1) north and south are one strip, on (1, 1) the strip itself."""
    r = tlife.RULES[rule]
    for wp in WIDTHS:
        strips = list(seam_board(ny, 64, wp).chunk(ny))
        plain = k14_chunk(monkeypatch, strips, r, plan, 4, False)
        mirror = k14_chunk(monkeypatch, strips, r, plan, 4, True)
        for (a, sa), (b, sb) in zip(plain[0], mirror[0]):
            assert all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(sa, sb)
        assert torch.equal(plain[1], mirror[1]) and torch.equal(plain[2], mirror[2])


@pytest.mark.parametrize("ny", [2, 4])
@pytest.mark.parametrize("rule", RULES)
def test_k14_block_mirror_chunk_equals_k5_block_mirror_on_the_whole_board(monkeypatch, rule, ny):
    """On one card K14 over (ny, 1) strips and K5 on the whole board at the
    same stripes compute the same function: an 8-launch chunk of K14's
    block mirror (at a row tile other than the H100's) equals one of K5's
    block mirror on the whole board in board, total skip count and
    activity."""
    r = tlife.RULES[rule]
    plan = PLANS["T6-s16"]
    whole = seam_board(ny, 64, 4)
    strips = list(whole.chunk(ny))
    seen, sk, act = k14_chunk(monkeypatch, strips, r, plan, 8, True,
                              other_blocks((64, 4), plan))
    want, wsk, wact = cuda_adaptive.frontier_superstep_mirror(
        whole, r, plan, 8, cuda_adaptive.frontier_launch_reg_mirror)
    assert torch.equal(torch.cat(seen[-1][0]), want)
    assert int(sk.sum()) == int(wsk) and torch.equal(act, wact)
    assert torch.equal(want, tpacked.superstep(whole, r, 8 * plan.t))
    if rule == "conway":
        assert 0 < int(wsk) < 8 * plan.grid(ny * 64)
