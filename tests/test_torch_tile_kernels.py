"""The 2-D tile kernels of the port (``parallel/cuda_halo.py``: K13 and K10
at ``xpad > 0``) against the JAX package's, launch by launch.

On the CPU the wrappers run their plain versions.  The JAX side runs its
Pallas kernels in interpret mode, made by the functions that make them for
its ``make_superstep`` on a 2-D mesh: ``_build_ext_launch_adaptive_2d``
(``_ext_kernel_adaptive_2d``) and ``_build_ext_launch(..., skip_stable=True,
xpad=...)`` (``_ext_kernel``'s skip form on a tile), at the JAX package's
interpret-mode plan (its ``_xpad_words`` x-halo of several words, its
``_plan_tile_2d`` stripes).  Both get the same pre-extended tile, cut from
a seeded board on a CPU mesh by ``halo.extend``, the same elision flags and
the same buffer of two launches ago; boards, stable flags and activity
must be equal, tolerance 0.  K13's window mirror
(``tile_probing_launch_mirror``) is held to the same kernels.  Tests
marked ``gpu`` hold the CUDA kernels against their plain versions on the
card.

The JAX package is imported inside the tests that compare with it:
``python -m pytest tests/test_torch_tile_kernels.py -m gpu --noconftest``
runs the card's tests on a machine without JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, packed as tpacked
from distributed_gol_torch.parallel import cuda_halo, halo, mesh as tmesh

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

GLIDER_SE = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=bool)  # heads down-right
BLOCK = np.ones((2, 2), dtype=bool)
BOARDS = ["soup", "ash", "settled", "glider_y", "glider_x", "glider_corner"]
# (tile in packed words, T, stripe cap): the JAX interpret plan's tiles.
PLANS = [((32, 2), 6, 16), ((32, 4), 12, 16), ((64, 4), 18, None), ((48, 3), 6, 8)]


def _put(b: np.ndarray, cells: np.ndarray, y: int, x: int) -> None:
    ys, xs = np.nonzero(cells)
    b[(ys + y) % b.shape[0], (xs + x) % b.shape[1]] = True


def mesh_board(kind: str, tile: tuple[int, int], mesh_shape=(2, 2)) -> np.ndarray:
    """A (ny·h, nx·wpl·32) cell board for a mesh of ``tile``-word tiles.
    "soup": density 0.3; "ash": blocks everywhere; "settled": the soup
    after 600 generations; "glider_y", "glider_x", "glider_corner": ash
    cleared around a glider about to cross the seam below tile (0, 0),
    the seam on its right, or its bottom-right corner (and, through the
    torus, a second one at its top-left corner)."""
    h, wpl = tile
    rows, cols = mesh_shape[0] * h, mesh_shape[1] * wpl * 32
    rng = np.random.default_rng(rows + cols + wpl)
    if kind in ("soup", "settled"):
        b = rng.random((rows, cols)) < 0.3
        if kind == "settled":
            p = tpacked.pack(torch.from_numpy(b.astype(np.uint8) * 255))
            b = tpacked.unpack(tpacked.superstep(p, tlife.CONWAY, 600)).numpy() > 0
        return b
    b = np.zeros((rows, cols), dtype=bool)
    for y in range(3, rows - 3, 11):
        for x in range(5 + (y % 3) * 7, cols - 3, 29):
            _put(b, BLOCK, y, x)
    seam_y, seam_x = h, wpl * 32
    at = {"glider_y": [(seam_y - 4, seam_x // 2)], "glider_x": [(h // 2, seam_x - 4)],
          "glider_corner": [(seam_y - 4, seam_x - 4), (-4, -4)]}.get(kind, [])
    for y, x in at:
        for dy in range(-6, 10):
            for dx in range(-6, 10):
                b[(y + dy) % rows, (x + dx) % cols] = False
        _put(b, GLIDER_SE, y, x)
    return b


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def cpu_mesh(shape):
    return tmesh.make_mesh(shape, [torch.device("cpu")] * (shape[0] * shape[1]))


def extended_tile(cells: np.ndarray, mesh_shape, pad: int, xpad: int, at=(0, 0)) -> np.ndarray:
    """Tile ``at``'s block of ``cells`` on a CPU mesh, extended by ``pad``
    rows and ``xpad`` words a side by the exchange."""
    p = tpacked.pack(torch.from_numpy(cells.astype(np.uint8) * 255))
    sb = halo.board_sharding(cpu_mesh(mesh_shape)).shard(p)
    return u32(halo.extend(sb, pad, xpad)[at[0]][at[1]])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.parallel import pallas_halo

    return SimpleNamespace(jnp=jnp, life=life, ph=pallas_halo)


def jax_tile_plan(ref, tile, turns, cap):
    """(AdaptivePlan, xpad) of the JAX package's interpret-mode 2-D plan."""
    xpad = ref.ph._xpad_words(tile[1], True)
    tile_h = ref.ph._plan_tile_2d(tile, turns, cap, xpad)
    return cuda_adaptive.AdaptivePlan(turns, tile_h, False), xpad


# -- K13: the probing tile launch --------------------------------------------------


def k13_all(ref, rule, ext, elig, dst, plan, xpad, cap):
    """One K13 launch in the JAX package and through the port's plain
    version and mirror: [(board, flags)] in that order."""
    tile = (ext.shape[0] - 2 * plan.pad, ext.shape[1] - 2 * xpad)
    call = ref.ph._build_ext_launch_adaptive_2d(tile, ref.life.RULES[rule], plan.t, True, cap,
                                                xpad)
    jnp = ref.jnp
    jb, jst = call(jnp.asarray(elig[:, None], dtype=jnp.int32), jnp.asarray(ext),
                   jnp.asarray(dst))
    out = [(np.asarray(jb), np.asarray(jst)[:, 0])]
    for fn in (cuda_halo.tile_probing_launch, cuda_halo.tile_probing_launch_mirror):
        st = torch.ones(plan.grid(tile[0]), dtype=torch.int32)
        got = fn(t32(ext), torch.from_numpy(elig.astype(np.int32)), t32(dst), st,
                 tlife.RULES[rule], plan, xpad)
        out.append((u32(got), st.numpy()))
    return out


@pytest.mark.parametrize("rule", ["conway", "highlife"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("tile,turns,cap", PLANS)
def test_k13_plain_and_mirror_match_interpret_kernel_over_two_launches(ref, rule, kind, tile,
                                                                       turns, cap):
    """Two launches of the ping-pong protocol (both parities) on tile (0, 0)
    of a (2, 2) mesh: the first from zero flags into a zeroed buffer, the
    second on the first's centre (the halo as it was) from the 3x3
    conjunction of its flags (the neighbour tiles' flags 1) into the
    input's buffer.  Boards, flags and activity (1 - flags) are equal
    after each."""
    plan, xpad = jax_tile_plan(ref, tile, turns, cap)
    ext = extended_tile(mesh_board(kind, tile), (2, 2), plan.pad, xpad)
    centre = (slice(plan.pad, plan.pad + tile[0]), slice(xpad, xpad + tile[1]))
    grid = plan.grid(tile[0])
    elig = np.zeros(grid, np.int32)
    bufs = [np.zeros(tile, np.uint32), ext[centre].copy()]
    for k in range(2):
        (jb, jst), *ports = k13_all(ref, rule, ext, elig, bufs[k % 2], plan, xpad, cap)
        for name, (tb, tst) in zip(("plain", "mirror"), ports):
            assert np.array_equal(tb, jb), f"{name} board, launch {k}"
            assert np.array_equal(tst, jst) and np.array_equal(1 - tst, 1 - jst), f"{name} flags"
        ext = ext.copy()
        ext[centre] = jb
        f = np.concatenate([[1], jst, [1]])
        elig = (f[:-2] & f[1:-1] & f[2:]).astype(np.int32)
    if kind == "ash":  # still; where the wrap cuts a block, not proved so
        assert np.array_equal(jb, bufs[1])
    if kind in ("soup", "glider_corner"):
        assert not jst.all()


@pytest.mark.parametrize("flags", ["all", "none", "first", "last", "alternate"])
def test_k13_elision_keeps_the_buffer_rows(ref, flags):
    """An eligible stripe writes nothing and reports stable; the others
    probe.  The buffer of two launches ago is a different board, so kept
    rows show."""
    tile, turns, cap = (48, 3), 6, 8
    plan, xpad = jax_tile_plan(ref, tile, turns, cap)
    ext = extended_tile(mesh_board("glider_x", tile), (2, 2), plan.pad, xpad)
    grid = plan.grid(tile[0])
    elig = np.zeros(grid, np.int32)
    elig[{"all": slice(None), "none": [], "first": [0], "last": [-1],
          "alternate": slice(0, None, 2)}[flags]] = 1
    dst = tpacked.pack(torch.from_numpy(
        mesh_board("soup", tile, (1, 1)).astype(np.uint8) * 255)).numpy().view(np.uint32)
    (jb, jst), *ports = k13_all(ref, "conway", ext, elig, dst, plan, xpad, cap)
    for tb, tst in ports:
        assert np.array_equal(tb, jb) and np.array_equal(tst, jst)
    kept = np.repeat(elig.astype(bool), plan.stripe_h)
    assert np.array_equal(jb[kept], dst[kept]) and jst[elig == 1].all()


def test_k13_probe_reads_the_wrapped_halo_columns(ref):
    """An empty tile whose west and east halos each hold a block at their
    outer edge: each block is still, but the extended tile's wrap joins
    them into a 2 x 4 rectangle, which is not.  The JAX probe compares
    every extended column, wrap included, so the stripe whose window holds
    them is not proved stable; the port agrees (a probe reading zero
    outside the block, as K10's does, would call it stable)."""
    tile, turns, cap = (32, 2), 6, 16
    plan, xpad = jax_tile_plan(ref, tile, turns, cap)
    wpe = (tile[1] + 2 * xpad) * 32
    ext = np.zeros((tile[0] + 2 * plan.pad, wpe), dtype=bool)
    rows = [plan.pad + 28, plan.pad + 29]  # in stripe 1's window only
    ext[np.ix_(rows, [wpe - 2, wpe - 1, 0, 1])] = True
    ext = ext.reshape(ext.shape[0], -1, 32).astype(np.uint64)
    ext = (ext << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    (jb, jst), *ports = k13_all(ref, "conway", ext, np.zeros(2, np.int32),
                               np.zeros(tile, np.uint32), plan, xpad, cap)
    assert jst.tolist() == [1, 0]
    for tb, tst in ports:
        assert np.array_equal(tb, jb) and np.array_equal(tst, jst)


def forced_blocks(plan, tile, xpad, tile_h, extra=0):
    """K13's blocks forced to ``tile_h`` rows of a stripe, ``extra`` warps
    more than the window needs."""
    wpe = tile[1] + 2 * xpad
    warps = -(-(tile_h + 2 * plan.pad) // 32) + extra
    return cuda_adaptive.RegPlan(plan.t, plan.pad, tile_h, warps,
                                 (tile[0] // tile_h, -(-wpe // 30)), 1, 6)


@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("tile,turns,stripe,xpad,tile_h,extra", [
    ((32, 2), 6, 16, 1, 16, 0), ((32, 2), 6, 16, 1, 8, 1), ((64, 31), 12, 32, 1, 4, 0),
    ((64, 61), 24, 32, 1, 16, 0), ((48, 3), 6, 24, 3, 3, 2)])
def test_k13_mirror_with_forced_blocks_matches_plain(kind, tile, turns, stripe, xpad, tile_h,
                                                     extra):
    """K13's decomposition with a stripe split into blocks of ``tile_h``
    rows (a stripe's flag the AND of its blocks' probes), extended widths
    of one to three column groups with a ragged last one, and windows
    taller than they need, over two launches of the ping-pong protocol:
    boards, flags and activity equal the plain version's."""
    plan = cuda_adaptive.AdaptivePlan(turns, stripe, False)
    blocks = forced_blocks(plan, tile, xpad, tile_h, extra)
    ext0 = t32(extended_tile(mesh_board(kind, tile), (2, 2), plan.pad, xpad, at=(1, 1)))
    centre = (slice(plan.pad, plan.pad + tile[0]), slice(xpad, xpad + tile[1]))
    runs = []
    for k13 in (lambda *a: cuda_halo.tile_probing_launch_mirror(*a, blocks),
                cuda_halo.tile_probing_launch_plain):
        ext, elig = ext0, torch.zeros(plan.grid(tile[0]), dtype=torch.int32)
        bufs = [torch.zeros(tile, dtype=torch.int32), ext[centre].clone()]
        seen = []
        for k in range(2):
            st = torch.ones_like(elig)
            out = k13(ext, elig, bufs[k % 2], st, tlife.CONWAY, plan, xpad)
            seen.append((out.clone(), st.clone(), 1 - st))
            ext = ext.clone()
            ext[centre] = out
            f = torch.cat([st.new_ones(1), st, st.new_ones(1)])
            elig = f[:-2] & f[1:-1] & f[2:]
        runs.append(seen)
    for got, want in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k13_mirror_refuses_blocks_across_stripes():
    plan = cuda_adaptive.AdaptivePlan(6, 16, False)
    ext = torch.zeros((32 + 16, 4), dtype=torch.int32)
    dst, elig, st = torch.zeros((32, 2), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), \
        torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not cover"):
        cuda_halo.tile_probing_launch_mirror(ext, elig, dst, st, tlife.CONWAY, plan, 1,
                                             forced_blocks(plan, (32, 2), 1, 32))


# Pre-extended tile shapes (h_loc, wpe) from one stripe to the 16384² soup's
# (2, 2) and (2, 4) tiles, with their stripe plans (stripe_h, pad, T).
TILE_PLANS = [((8, 3), 8, 8, 6), ((16, 31), 16, 16, 12), ((64, 61), 32, 24, 18),
              ((256, 66), 64, 24, 24), ((520, 20), 8, 8, 6), ((8192, 258), 256, 24, 24),
              ((8192, 130), 16, 16, 12), ((8192, 514), 256, 32, 30), ((4096, 258), 1024, 32, 30)]


@pytest.mark.parametrize("shape,stripe_h,pad,turns", TILE_PLANS)
def test_stripe_reg_plan_stores_every_centre_word_once(shape, stripe_h, pad, turns):
    """K13's plan on 132 SMs: blocks of a divisor of the stripe, so none
    straddles two stripes; their tiles cover the centre rows and their
    column groups the extended width with no block empty, so every word
    is probed and stored by exactly one block; the window holds the tile
    and pad rows a side; the probe sees every window row at generation 6
    and the last generation's cone is the tile (or holds it, at T = 6), each generation's inside
    the one before with a row a side."""
    plan = cuda_adaptive.stripe_reg_plan(shape, stripe_h, pad, turns, 132)
    h, wpe = shape
    nby, nbx = plan.grid
    assert stripe_h % plan.tile_h == 0 and nby * plan.tile_h == h
    assert (nbx - 1) * 30 < wpe <= nbx * 30 and plan.centre == 30
    assert plan.rows == plan.tile_h + 2 * pad <= plan.warps * 32
    assert plan.cone(6) == (6, plan.rows - 6) and plan.probe == 6
    lo, hi = plan.cone(turns)
    if turns > 6:
        assert (lo, hi) == (pad, pad + plan.tile_h)
    else:
        assert lo <= pad < pad + plan.tile_h <= hi
    # each generation's cone lies, with a row a side, in the one before
    assert all(plan.cone(g + 1)[0] >= plan.cone(g)[0] + 1 for g in range(1, turns))


@pytest.mark.parametrize("shape,stripe_h,pad,turns", TILE_PLANS)
def test_stripe_reg_plan_fits_hopper(shape, stripe_h, pad, turns):
    """Threads, registers and shared memory of K13's blocks within an H100
    SM's (as K9's: at most 512 threads and 64 registers a thread, the
    blocks an SM holds at once within its 65,536 registers; 8 KiB of edge
    exchange, 4 KiB a warp for the probe's generation-0 copy and the 1 KiB
    the card reserves, the blocks an SM holds at once within its 228
    KiB)."""
    plan = cuda_adaptive.stripe_reg_plan(shape, stripe_h, pad, turns, 132)
    assert 32 <= plan.threads <= 512
    assert plan.occupancy >= 2 and plan.occupancy * plan.threads * 64 <= 65536
    assert plan.smem_bytes == 8192 + plan.warps * 4096 <= 227 * 1024
    assert plan.occupancy * (plan.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("shape,stripe_h,fill", [((8192, 258), 256, 0.87), ((8192, 130), 16, 0.96)])
def test_stripe_reg_plan_fills_the_card_at_16384(shape, stripe_h, fill):
    """Path (h)/(l)'s (2, 2) tile at T = 24 on 256-row stripes and path
    (j)'s (2, 4) tile at T = 12 on 16-row stripes, on 132 SMs: the plan
    states its fill, the share of the busiest SM's block rounds that hold a
    block; the first port's grid held 160 blocks of 1,024 threads (two
    rounds of 132, one block a SM) on (h)'s tile."""
    pad = 24 if stripe_h == 256 else 16
    turns = 24 if stripe_h == 256 else 12
    plan = cuda_adaptive.stripe_reg_plan(shape, stripe_h, pad, turns, 132)
    assert plan.fill(132) >= fill
    assert plan.fill(132) == plan.blocks / (plan.waves(132) * 132)


def test_k13_refuses_a_plan_that_does_not_fit():
    ext = torch.zeros((16 + 2 * 8, 4 + 2), dtype=torch.int32)
    dst, elig, st = torch.zeros((16, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), \
        torch.ones(2, dtype=torch.int32)
    plan = cuda_adaptive.AdaptivePlan(6, 8, False)
    cuda_halo.tile_probing_launch(ext, elig, dst, st, tlife.CONWAY, plan, 1)
    with pytest.raises(ValueError, match="does not fit"):  # T + 6 > 32 * xpad
        cuda_halo.tile_probing_launch(ext, elig, dst, st, tlife.CONWAY,
                                      cuda_adaptive.AdaptivePlan(6, 8, False), 0)
    with pytest.raises(ValueError, match="does not fit"):  # round8(T) > stripe_h
        cuda_halo.tile_probing_launch(torch.zeros((16 + 32, 6), dtype=torch.int32), elig, dst,
                                      st, tlife.CONWAY, cuda_adaptive.AdaptivePlan(12, 8, False),
                                      1)
    with pytest.raises(ValueError, match="write buffer"):
        cuda_halo.tile_probing_launch(ext, elig, dst[:8], st, tlife.CONWAY, plan, 1)
    with pytest.raises(ValueError, match="cannot write"):
        cuda_halo.tile_probing_launch(ext, elig, ext.view(-1)[:64].view(16, 4), st,
                                      tlife.CONWAY, plan, 1)


# -- K10 at xpad > 0: the skip form on a 2-D tile ------------------------------------


@pytest.mark.parametrize("rule", ["conway", "highlife"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("tile,turns", [((32, 2), 6), ((32, 4), 12), ((64, 4), 18),
                                        ((48, 3), 24)])
def test_k10_at_xpad_matches_interpret_ext_kernel(ref, rule, kind, tile, turns):
    """The tile extended at the JAX plan's pad = round8(T) and its
    interpret-mode x-halo; the port's plain version and its window mirror
    give the JAX skip-form kernel's centre."""
    pad = -(-turns // 8) * 8
    xpad = ref.ph._xpad_words(tile[1], True)
    ext = extended_tile(mesh_board(kind, tile), (2, 2), pad, xpad, at=(1, 1))
    call = ref.ph._build_ext_launch(tile, ref.life.RULES[rule], turns, True, True, None, xpad)
    want = np.asarray(call(ref.jnp.asarray(ext)))
    got = cuda_halo.ext_skip_launch(t32(ext), tlife.RULES[rule], turns, pad, xpad)
    assert np.array_equal(u32(got), want)
    mirror = cuda_halo.ext_skip_launch_mirror(t32(ext), tlife.RULES[rule], turns, pad, xpad)
    assert np.array_equal(u32(mirror), want)
    if kind == "ash":
        assert np.array_equal(want, ext[pad:-pad, xpad:-xpad])


# -- the flag exchange and the launch sequence ----------------------------------------


@pytest.mark.parametrize("kind", ["ash", "glider_x"])
def test_k10_stable_tiles_are_the_tiles_its_skip_proof_holds_on(kind):
    """``ext_skip_stable_tiles`` (the K10 blocks that keep their input
    centre: the work a launch needs, for its bound) on a (2, 2) tile of 160
    words at xpad 1, whose six column groups end at the tile's edge: on ash
    every block holds the proof; with a glider at the tile's right edge
    the groups it reaches do not (the last one, shifted to end at the
    edge, among them)."""
    ext = t32(extended_tile(mesh_board(kind, (32, 160)), (2, 2), 12, 1))
    plan = cuda_halo.ext_skip_plan((32, 160), 12, 132)
    assert plan.grid[1] == 6
    assert cuda_halo.ext_skip_origins(plan, (32, 160))[1] == [0, 30, 60, 90, 120, 130]
    stable = cuda_halo.ext_skip_stable_tiles(ext, tlife.CONWAY, 12, 12, 1)
    assert stable.shape == plan.grid
    if kind == "ash":
        assert stable.all()
    else:
        assert stable[:, :4].all() and not stable[:, -1].any()


@pytest.mark.parametrize("tile,turns", [((100, 17), 6), ((130, 16), 30), ((70, 45), 18)])
def test_k10_every_block_of_a_ragged_tile_on_ash_proves_stable(tile, turns):
    """Ragged 2-D tiles at xpad 1 (rows and words no block divides; 16
    and 17 words narrower than a column group, whose window reads past
    the extended width and whose probe leaves out the cells next to the
    block's edge): on ash every block proves stable, and the launch keeps
    the tile's centre."""
    ext = t32(extended_tile(mesh_board("ash", tile), (2, 2), turns, 1))
    assert cuda_halo.ext_skip_stable_tiles(ext, tlife.CONWAY, turns, turns, 1).all()
    got = cuda_halo.ext_skip_launch_mirror(ext, tlife.CONWAY, turns, turns, 1)
    assert np.array_equal(u32(got), u32(ext)[turns:-turns, 1:-1])


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 3), (2, 4), (4, 2)])
def test_tile_elision_is_the_3x3_conjunction_on_the_torus(mesh_shape):
    """Every stripe's elision flag is the AND of the previous flags of the
    3x3 (stripe, x-tile) cells around it on the board's torus of cells,
    whatever the mesh: a tile alone on an axis is its own neighbour, and
    on an axis of two the same tile is both."""
    ny, nx = mesh_shape
    grid = 3
    rng = np.random.default_rng(ny * 10 + nx)
    cells = (rng.random((ny * grid, nx)) < 0.8).astype(np.int32)
    flags = [[torch.from_numpy(cells[iy * grid : (iy + 1) * grid, ix].copy()) for ix in range(nx)]
             for iy in range(ny)]
    got = cuda_halo.tile_elision(flags)
    want = np.ones_like(cells)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            want &= np.roll(cells, (dy, dx), axis=(0, 1))
    for iy in range(ny):
        for ix in range(nx):
            assert got[iy][ix].tolist() == want[iy * grid : (iy + 1) * grid, ix].tolist()


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (4, 2)])
@pytest.mark.parametrize("kind", ["settled", "glider_corner"])
def test_tile_launch_sequence_mirror_equals_plain(mesh_shape, kind):
    """Seven launches of K13's protocol on every tile (exchange, elision,
    write elision into the buffer of two launches ago) through the mirror
    and through the plain version: equal boards, skip counts and (ny·grid,
    nx) activity grids, and the board equals the packed engine's."""
    tile = (32, 2)
    plan, xpad = cuda_adaptive.AdaptivePlan(6, 8, False), 1
    cells = mesh_board(kind, tile, mesh_shape)
    p = tpacked.pack(torch.from_numpy(cells.astype(np.uint8) * 255))
    sb = halo.board_sharding(cpu_mesh(mesh_shape)).shard(p)
    runs = [cuda_halo.tile_probing_launches(sb, tlife.CONWAY, plan, xpad, 7, launch)
            for launch in (cuda_halo.tile_probing_launch_mirror,
                           cuda_halo.tile_probing_launch_plain)]
    (b1, s1, a1), (b2, s2, a2) = runs
    assert torch.equal(b1.gather(), b2.gather()) and int(s1) == int(s2) and torch.equal(a1, a2)
    assert a1.shape == (mesh_shape[0] * plan.grid(tile[0]), mesh_shape[1])
    assert torch.equal(b1.gather(), tpacked.superstep(p, tlife.CONWAY, 7 * plan.t))
    assert int(s1) + int(a1.sum()) == 7 * a1.numel()
    if kind == "settled":
        assert int(s1) > 0


def test_cpu_wrappers_run_plain_versions_without_counting():
    cuda_halo.reset_launches()
    sb = halo.board_sharding(cpu_mesh((2, 2))).shard(
        tpacked.pack(torch.from_numpy(mesh_board("ash", (32, 2)).astype(np.uint8) * 255)))
    cuda_halo.make_superstep(sb.mesh, tlife.CONWAY, skip_stable=True, skip_tile_cap=8)(sb, 31)
    assert cuda_halo.tile_probing_launch.launches == 0
    assert cuda_halo.ext_skip_launch.launches == 0


# -- the kernels on the card -----------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("tile,turns,stripe,xpad", [((256, 64), 24, 64, 1), ((96, 3), 6, 8, 3),
                                                    ((128, 131), 12, 16, 1),
                                                    ((512, 61), 24, 256, 1), ((64, 29), 24, 32, 2),
                                                    ((32, 16), 12, 16, 1)])
def test_gpu_k13_matches_plain(cuda_device, rule, kind, tile, turns, stripe, xpad):
    """K13 against its plain version over two launches on tile (1, 0) of a
    (2, 2) mesh, elision flags from the first: windows several blocks wide
    (a ragged last block past the extended width), a narrow tile whose
    windows wrap onto themselves, path (h)'s 256-row stripes, a 2-word x-halo and
    path (j)'s 16-row stripes at T = 12; under both compile-time rules and
    one through the generic instantiation."""
    plan = cuda_adaptive.AdaptivePlan(turns, stripe, False)
    ext0 = t32(extended_tile(mesh_board(kind, tile), (2, 2), plan.pad, xpad, at=(1, 0)))
    centre = (slice(plan.pad, plan.pad + tile[0]), slice(xpad, xpad + tile[1]))
    results = []
    for dev in ("cpu", cuda_device):
        ext, elig = ext0.to(dev), torch.zeros(plan.grid(tile[0]), dtype=torch.int32, device=dev)
        bufs = [torch.zeros(tile, dtype=torch.int32, device=dev), ext[centre].clone()]
        seen = []
        for k in range(2):
            st = torch.ones_like(elig)
            out = cuda_halo.tile_probing_launch(ext, elig, bufs[k % 2], st, tlife.RULES[rule],
                                                plan, xpad)
            seen.append((out.cpu().clone(), st.cpu()))
            ext = ext.clone()
            ext[centre] = out
            f = torch.cat([st.new_ones(1), st, st.new_ones(1)])
            elig = f[:-2] & f[1:-1] & f[2:]
        results.append(seen)
    for (a, fa), (b, fb) in zip(*results):
        assert torch.equal(a, b) and torch.equal(fa, fb)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("tile,turns", [((256, 64), 24), ((100, 17), 6), ((33, 3), 30)])
def test_gpu_k10_at_xpad_matches_plain(cuda_device, kind, tile, turns):
    xpad = -(-turns // 32)
    ext = t32(extended_tile(mesh_board(kind, tile), (2, 2), turns, xpad, at=(0, 1)))
    want = cuda_halo.ext_skip_launch_plain(ext, tlife.CONWAY, turns, turns, xpad)
    got = cuda_halo.ext_skip_launch(ext.to(cuda_device), tlife.CONWAY, turns, turns, xpad)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_gpu_tile_dispatch_matches_plain(cuda_device, mesh_shape):
    """A whole skip_stable dispatch on a 2-D mesh on the ppermute tier
    (``in_kernel=False``: K13 launches, then K10 and K9) on the card
    against the same dispatch on the CPU: boards, skip counts and activity
    grids."""
    cells = mesh_board("glider_corner", (128, 8), mesh_shape)
    p = tpacked.pack(torch.from_numpy(cells.astype(np.uint8) * 255))
    out = []
    for dev in ("cpu", cuda_device):
        m = tmesh.make_mesh(mesh_shape, [torch.device(dev)] * (mesh_shape[0] * mesh_shape[1]))
        b, sk, act = cuda_halo.make_superstep(m, tlife.CONWAY, True, 32, True, False)(
            halo.board_sharding(m).shard(p.to(dev)), 9 * 24 - 5)
        out.append((b.gather().cpu(), int(sk), act.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    assert torch.equal(out[0][2], out[1][2])
