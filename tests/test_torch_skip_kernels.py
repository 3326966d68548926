"""K3 (``tiled_skip_superstep``) and K4 (``probing_superstep``) on their
register-resident blocks (``ops/cuda_adaptive.py``), against the JAX
package.

On the CPU the block mirrors replay the kernels' blocks in PyTorch: K4's
register probing blocks on the board read in place as the torus
(``probing_superstep_reg_mirror``) and K3's torus window with the probe
(``tiled_skip_reg_mirror``).  At forced plans (blocks that divide a
stripe, blocks of 2 to 32 whole stripes, a board of one stripe, a 3-word
board) K4's mirror must give the board, skip count and per-stripe
activity of the plain version and of the JAX package's
``_kernel_adaptive`` run in interpret mode, launch after launch on its
ping-pong buffers; K3's mirror must give the plain version's board and
the JAX package's, on tori shorter than its halo and with a glider just
outside a block's tile.  Every comparison is exact.  Tests marked ``gpu``
hold the CUDA kernels to their block mirrors at the card's SM count and
skip where there is none; the JAX package is imported inside the tests
that compare with it, so they also run on a machine without JAX:
``python -m pytest tests/test_torch_skip_kernels.py -m gpu --noconftest``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, packed as tpacked
from distributed_gol_torch.ops.cuda_adaptive import AdaptivePlan, RegPlan

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

RULES = ["conway", "highlife"]
GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=bool)  # heads down-right


def words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def ash_board(h: int, w: int, seed: int) -> np.ndarray:
    """Ash that proves period-6 stable (blocks, and blinkers of period 2,
    every 12 rows) with a glider across the torus wrap in both axes and
    one at a seeded spot: stripes that elide and stripes that compute,
    some only through the wrap."""
    b = np.zeros((h, w), dtype=np.uint8)
    for y in range(3, h - 3, 12):
        for x in range(3, w - 20, 29):
            b[y : y + 2, x : x + 2] = 255
            b[(y + 6) % h, x + 14 : x + 17] = 255
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(GLIDER)
    for y, x in ((h - 2, w - 2), (rng.integers(0, h), rng.integers(0, w))):
        b[(ys + y) % h, (xs + x) % w] = 255
    return b


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed, pallas_packed

    return SimpleNamespace(jnp=jnp, life=life, packed=packed, pallas=pallas_packed)


def jax_probing(ref, b: np.ndarray, rule: str, t: int, cap: int, nlaunch: int):
    """``nlaunch`` launches of the JAX package's ``_kernel_adaptive`` in
    interpret mode on ``_run_tiled``'s protocol (a zero bitmap, each launch
    writing the buffer of two launches ago, the first of them zero), its
    stripes the multiple-of-8 divisor of the height up to ``cap``:
    (board words, skipped, activity)."""
    pp = ref.pallas
    x = ref.packed.pack(ref.jnp.asarray(b))
    shape = tuple(x.shape)
    call = pp._build_launch_adaptive(shape, ref.life.RULES[rule], t, True, cap)
    grid = shape[0] // pp._plan_tile(shape, t, cap)
    st = ref.jnp.zeros((grid,), ref.jnp.int32)
    prev = ref.jnp.zeros_like(x)
    skipped, act = 0, np.zeros(grid, dtype=np.int32)
    for _ in range(nlaunch):
        nb, st = call(st, x, prev)
        x, prev = nb, x
        skipped += int(st.sum())
        act += 1 - np.asarray(st)
    return np.asarray(x), skipped, act


def forced(plan: AdaptivePlan, shape: tuple[int, int], tile_h: int) -> RegPlan:
    """K4's blocks at ``plan`` on an (h, wp) board with row tiles of
    ``tile_h`` rows, forced."""
    h, wp = shape
    return RegPlan(plan.t, plan.pad, tile_h, -(-(tile_h + 2 * plan.pad) // 32),
                   (h // tile_h, -(-wp // 30)), 1, cuda_adaptive.SKIP_PERIOD)


# (cells, T, stripe height, row tile): blocks that divide a stripe; blocks
# of 2, 8 and 30 whole 16-row stripes, and of 32 whole 8-row ones; a board
# of one stripe, whole and in quarters; a 3-word board (narrower than a
# warp's window, which wraps onto itself) in one block of 4 stripes and
# one within a stripe.
K4_FORCED = [
    ((64, 4096), 6, 16, 8),
    ((64, 4096), 12, 16, 16),
    ((128, 4096), 6, 16, 32),
    ((128, 4096), 12, 16, 128),
    ((480, 4096), 6, 16, 480),
    ((256, 4096), 6, 8, 256),
    ((64, 4096), 24, 64, 64),
    ((64, 4096), 24, 64, 16),
    ((64, 96), 12, 16, 64),
    ((64, 96), 12, 16, 8),
]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape,t,stripe_h,tile_h", K4_FORCED)
def test_k4_block_mirror_at_forced_plans(ref, shape, t, stripe_h, tile_h, rule):
    b = ash_board(*shape, seed=shape[0] + t + tile_h)
    p = tpacked.pack(torch.from_numpy(b))
    plan = AdaptivePlan(t, stripe_h, False)
    blocks = forced(plan, tuple(p.shape), tile_h)
    assert (blocks.tile_h // stripe_h or 1) <= cuda_adaptive.REG_PROBE_STRIPES
    got, sk, act = cuda_adaptive.probing_superstep_reg_mirror(p, tlife.RULES[rule], plan, 5,
                                                              blocks)
    want, wsk, wact = cuda_adaptive.probing_superstep_mirror(p, tlife.RULES[rule], plan, 5)
    assert torch.equal(got, want) and int(sk) == int(wsk) and torch.equal(act, wact)
    jb, jsk, jact = jax_probing(ref, b, rule, t, stripe_h, 5)
    np.testing.assert_array_equal(words(got), jb)
    assert int(sk) == jsk
    np.testing.assert_array_equal(act.numpy(), jact)
    if shape[0] > stripe_h and rule == "conway":
        assert 0 < jsk < 5 * plan.grid(shape[0])  # stripes both elide and compute


def test_k4_block_mirror_refuses_blocks_that_do_not_cover_the_board():
    p = torch.zeros((64, 128), dtype=torch.int32)
    plan = AdaptivePlan(6, 16, False)
    for blocks in (forced(plan, (32, 128), 16), forced(plan, (64, 128), 12),
                   forced(plan, (64, 60), 16)):
        with pytest.raises(ValueError, match="do not cover"):
            cuda_adaptive.probing_superstep_reg_mirror(p, tlife.CONWAY, plan, 1, blocks)


# K3's short tori (cells, T): shorter than the halo, one word wide, one
# row, three rows.
K3_SHORT = [((8, 96), 18), ((16, 32), 30), ((1, 32), 6), ((3, 64), 24), ((24, 4096), 12)]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape,turns", K3_SHORT)
def test_k3_block_mirror_on_short_tori(ref, shape, turns, rule):
    """K3's mirror at an H100's blocks, whose windows hold the torus's
    periodic cover, against the plain version and the JAX package's
    packed engine, on a soup and on the soup after 300 generations."""
    rng = np.random.default_rng(shape[0] * shape[1] + turns)
    b = np.where(rng.random(shape) < 0.3, 255, 0).astype(np.uint8)
    r = tlife.RULES[rule]
    for p in (tpacked.pack(torch.from_numpy(b)),
              tpacked.superstep(tpacked.pack(torch.from_numpy(b)), r, 300)):
        got = cuda_adaptive.tiled_skip_reg_mirror(p, r, turns)
        assert torch.equal(got, cuda_adaptive.tiled_skip_superstep_plain(p, r, turns))
        want = ref.packed.superstep(ref.jnp.asarray(words(p)), ref.life.RULES[rule], turns)
        np.testing.assert_array_equal(words(got), np.asarray(want))


# A lightweight spaceship heading down (c/2): it reaches a tile from
# further away within a launch than a glider (c/4) does.
LWSS = np.array([[0, 1, 1, 1, 1], [1, 0, 0, 0, 1], [0, 0, 0, 0, 1], [1, 0, 0, 1, 0]],
                dtype=bool).T
# (pattern, T, gap): patterns gap rows above a block's tile, 6 <= gap < T,
# that reach the tile within T generations.
OUTSIDE = [(GLIDER, 30, 6), (GLIDER, 30, 7), (LWSS, 18, 8), (LWSS, 24, 11), (LWSS, 30, 14)]


def outside_board(pattern: np.ndarray, gap: int, h: int = 128, w: int = 4096,
                  tile_h: int = 32) -> np.ndarray:
    """An empty board with ``pattern`` ending ``gap`` rows above row 2 ·
    ``tile_h``, the first row of the third row tile."""
    b = np.zeros((h, w), dtype=np.uint8)
    ys, xs = np.nonzero(pattern)
    b[ys + 2 * tile_h - gap - pattern.shape[0], xs + 500] = 255
    return b


def outside_plan(turns: int, h: int = 128, tile_h: int = 32) -> RegPlan:
    return RegPlan(turns, turns, tile_h, -(-(tile_h + 2 * turns) // 32), (h // tile_h, 5), 1,
                   cuda_adaptive.SKIP_PERIOD)


@pytest.mark.parametrize("pattern,turns,gap", OUTSIDE)
def test_k3_block_mirror_sees_a_glider_outside_its_tile(pattern, turns, gap):
    """A glider or spaceship ``gap`` rows above a block's tile (6 <= gap <
    T), heading into it, on an empty board: the tile itself is period-6
    stable, so a probe that looked at the tile alone would keep it; the
    block's window holds the pattern, its probe fails, and the pattern
    enters the tile."""
    p = tpacked.pack(torch.from_numpy(outside_board(pattern, gap)))
    got = cuda_adaptive.tiled_skip_reg_mirror(p, tlife.CONWAY, turns, outside_plan(turns))
    want = tpacked.superstep(p, tlife.CONWAY, turns)
    assert torch.equal(got, want)
    tile = slice(64, 96)
    assert not torch.equal(want[tile], p[tile])  # a tile-only probe would have kept it


@pytest.mark.parametrize("turns", [6, 18, 24])
@pytest.mark.parametrize("tile_h,warps", [(32, 3), (100, 5), (416, 16)])
def test_k3_block_mirror_matches_pallas_at_forced_plans(ref, turns, tile_h, warps):
    """K3's mirror at forced blocks (the last row tile overhanging the
    board) against the JAX package's ``_kernel`` in its skip form, run in
    interpret mode, on settled ash with a glider."""
    b = ash_board(256, 4096, seed=turns)
    p = tpacked.pack(torch.from_numpy(b))
    plan = RegPlan(turns, turns, tile_h, warps, (-(-256 // tile_h), 5), 1,
                   cuda_adaptive.SKIP_PERIOD)
    got = cuda_adaptive.tiled_skip_reg_mirror(p, tlife.CONWAY, turns, plan)
    call = ref.pallas._build_launch(tuple(p.shape), ref.life.CONWAY, turns, True, True, None)
    np.testing.assert_array_equal(words(got), np.asarray(call(ref.jnp.asarray(words(p)))))


def test_k3_block_mirror_refuses_other_launches():
    p = torch.zeros((64, 128), dtype=torch.int32)
    plan = cuda_adaptive.tiled_skip_reg_plan((64, 128), 12, 132)
    with pytest.raises(ValueError, match="does not cover"):
        cuda_adaptive.tiled_skip_reg_mirror(p, tlife.CONWAY, 18, plan)
    with pytest.raises(ValueError, match="does not cover"):
        cuda_adaptive.tiled_skip_reg_mirror(torch.zeros((256, 128), dtype=torch.int32),
                                            tlife.CONWAY, 12, plan)
    with pytest.raises(ValueError):
        cuda_adaptive.tiled_skip_reg_mirror(p, tlife.CONWAY, 36)


# -- the plans --------------------------------------------------------------------


@pytest.mark.parametrize("sms", [132, 114])
def test_k4_plan_at_the_headline_board(sms):
    """K4's blocks at 16384² (the port's plan: T = 24 on 256-row stripes):
    one stripe a block, 10 warps, 64 x 18 blocks, 3 an SM."""
    plan = cuda_adaptive.adaptive_plan((16384, 512), 10**6)
    assert plan == AdaptivePlan(24, 256, True)
    blocks = cuda_adaptive.probing_reg_plan(plan, (16384, 512), sms)
    assert blocks == RegPlan(24, 24, 256, 10, (64, 18), 1, cuda_adaptive.SKIP_PERIOD)
    assert blocks.occupancy == 3 and blocks.blocks == 1152


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("turns", [6, 12, 18, 24, 30])
def test_k3_plan_at_the_headline_board(sms, turns):
    """K3's blocks at 16384²: K2's candidates with the probe, at most 16
    warps covering the torus once (the last tile overhangs it), one border
    word a side, and a grid that fills ``sms`` SMs."""
    plan = cuda_adaptive.tiled_skip_reg_plan((16384, 512), turns, sms)
    assert (plan.t, plan.halo, plan.border, plan.probe) == (turns, turns, 1, 6)
    assert plan.warps <= 16 and plan.rows <= plan.warps * 32
    ny, nx = plan.grid
    assert ny * plan.tile_h >= 16384 and (ny - 1) * plan.tile_h < 16384
    assert nx == 18 and plan.blocks >= sms and plan.fill(sms) > 0.9
    assert plan == min(cuda_adaptive.torus_reg_plans((16384, 512), turns, 6),
                       key=lambda p: (p.cost(sms), p.blocks))


def test_k3_plan_refuses_other_depths():
    for t in (0, 5, 8, 31):
        with pytest.raises(ValueError):
            cuda_adaptive.tiled_skip_reg_plan((64, 128), t, 132)


# -- the CUDA kernels on the card -------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def instantiation(rule) -> str:
    return cuda_adaptive.REG_RULES[cuda_adaptive.reg_rule(rule)[2]]


@pytest.mark.gpu
@pytest.mark.parametrize("rule", [*RULES, "day-and-night"])
@pytest.mark.parametrize("shape,t,stripe_h,tile_h", [*K4_FORCED, ((1024, 4096), 24, 256, None)])
def test_gpu_k4_matches_its_block_mirror(cuda_device, shape, t, stripe_h, tile_h, rule):
    """K4 at the forced blocks (and at the card's own on 1024²) against its
    block mirror and its plain version: board, skip count and activity,
    every launch counted in the rule's instantiation."""
    r = tlife.RULES[rule]
    p = tpacked.pack(torch.from_numpy(ash_board(*shape, seed=shape[0] + t))).to(cuda_device)
    plan = AdaptivePlan(t, stripe_h, False)
    blocks = (forced(plan, tuple(p.shape), tile_h) if tile_h else
              cuda_adaptive.probing_reg_plan(plan, tuple(p.shape),
                                             cuda_adaptive.device_sms(cuda_device)))
    cuda_adaptive.reset_launches()
    got = cuda_adaptive.probing_superstep(p, r, plan, 6, blocks)
    torch.cuda.synchronize()
    assert cuda_adaptive.probing_superstep.rules == {instantiation(r): 6}
    for want in (cuda_adaptive.probing_superstep_reg_mirror(p, r, plan, 6, blocks),
                 cuda_adaptive.probing_superstep_mirror(p, r, plan, 6)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("rule", [*RULES, "day-and-night"])
@pytest.mark.parametrize("shape,turns", [*K3_SHORT, ((1024, 4096), 24), ((200, 4096), 30)])
def test_gpu_k3_matches_its_block_mirror(cuda_device, shape, turns, rule):
    """K3 at the card's blocks against its block mirror and its plain
    version, on a soup and on settled ash, counted in the rule's
    instantiation."""
    r = tlife.RULES[rule]
    sms = cuda_adaptive.device_sms(cuda_device)
    rng = np.random.default_rng(shape[0] + turns)
    b = np.where(rng.random(shape) < 0.3, 255, 0).astype(np.uint8)
    cuda_adaptive.reset_launches()
    for p in (tpacked.pack(torch.from_numpy(b)).to(cuda_device),
              tpacked.pack(torch.from_numpy(ash_board(*shape, seed=turns))).to(cuda_device)
              if shape[0] * shape[1] >= 4096 else None):
        if p is None:
            continue
        got = cuda_adaptive.tiled_skip_superstep(p, r, turns)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_adaptive.tiled_skip_reg_mirror(p, r, turns, sms=sms))
        assert torch.equal(got, cuda_adaptive.tiled_skip_superstep_plain(p, r, turns))
    assert set(cuda_adaptive.tiled_skip_superstep.rules) == {instantiation(r)}


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,turns,gap", OUTSIDE)
def test_gpu_k3_sees_a_glider_outside_its_tile(cuda_device, pattern, turns, gap):
    p = tpacked.pack(torch.from_numpy(outside_board(pattern, gap))).to(cuda_device)
    got = cuda_adaptive.tiled_skip_superstep(p, tlife.CONWAY, turns, outside_plan(turns))
    torch.cuda.synchronize()
    assert torch.equal(got, tpacked.superstep(p, tlife.CONWAY, turns))
