"""The port's mesh layer (``distributed_gol_torch/parallel``) against the
JAX package's, module by module.

On the CPU every shard of a mesh lies on the CPU, and the K9 wrapper runs
its plain version; the JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``, its Pallas kernels in interpret mode.  Every
comparison is exact.  K9's plain version is held against the
interpret-mode ``pallas_halo._ext_kernel`` on the same extended input, and
K9's window decomposition (``cuda_halo.ext_launch_mirror``) against both.
Tests marked ``gpu`` hold K9 against its plain version on the card and
skip where there is none.

The JAX package is imported inside the tests that compare with it, so the
``gpu`` tests also run on a machine without JAX:
``python -m pytest tests/test_torch_halo.py -m gpu --noconftest``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, packed as tpacked, stencil as tstencil
from distributed_gol_torch.parallel import cuda_halo, halo, mesh as tmesh, packed_halo

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

MESHES = [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (2, 4)]
SHAPE = (128, 256)  # every mesh above divides it into shards of whole words


def random_board(rng: np.random.Generator, h: int, w: int, p: float = 0.3) -> np.ndarray:
    return np.where(rng.random((h, w)) < p, 255, 0).astype(np.uint8)


def random_words(rng: np.random.Generator, h: int, wp: int) -> np.ndarray:
    return rng.integers(0, 2**32, size=(h, wp), dtype=np.uint64).astype(np.uint32)


def cpu_mesh(shape):
    return tmesh.make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def shard(board: np.ndarray, shape) -> halo.ShardedBoard:
    arr = np.array(board.view(np.int32) if board.dtype == np.uint32 else board)
    return halo.board_sharding(cpu_mesh(shape)).shard(torch.from_numpy(arr))


def whole(b: halo.ShardedBoard) -> np.ndarray:
    out = b.gather("cpu").numpy()
    return out.view(np.uint32) if out.dtype == np.int32 else out


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed
    from distributed_gol_tpu.parallel import halo as jhalo
    from distributed_gol_tpu.parallel import mesh, packed_halo as jpacked_halo, pallas_halo

    def put(board: np.ndarray, shape):
        return jax.device_put(board, jhalo.board_sharding(mesh.make_mesh(shape)))

    return SimpleNamespace(jnp=jnp, life=life, packed=packed, halo=jhalo, mesh=mesh,
                           packed_halo=jpacked_halo, pallas_halo=pallas_halo, put=put)


# -- K9's plain version against the interpret-mode _ext_kernel ---------------


@pytest.mark.parametrize("rule", ["conway", "highlife"])
@pytest.mark.parametrize(
    "strip,xpad,turns",
    [
        ((32, 4), 0, 1), ((32, 4), 0, 3), ((32, 4), 0, 13), ((32, 4), 0, 32),
        ((24, 2), 1, 1), ((24, 2), 1, 5), ((24, 2), 1, 19), ((32, 3), 2, 26),
        ((40, 33), 1, 16), ((32, 61), 0, 32), ((24, 62), 2, 7), ((16, 31), 0, 1),
    ],
)
def test_ext_plain_matches_interpret_ext_kernel(ref, rule, strip, xpad, turns):
    """The same extended input, built with the JAX plan's pad = round8(T)
    and the given xpad, through ``_build_ext_launch`` and through K9's
    plain version and its decomposition mirror; the turns below a full
    launch are the remainder launches, and shards wider than one column
    group (30 words) end in a ragged group."""
    h_loc, wp = strip
    pad = -(-turns // 8) * 8
    ext = random_words(np.random.default_rng(turns + xpad), h_loc + 2 * pad, wp + 2 * xpad)
    call = ref.pallas_halo._build_ext_launch(strip, ref.life.RULES[rule], turns, True, xpad=xpad)
    want = np.asarray(call(ref.jnp.asarray(ext)))
    t_ext = torch.from_numpy(ext.view(np.int32))
    got = cuda_halo.ext_launch_plain(t_ext, tlife.RULES[rule], turns, pad, xpad)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    mirror = cuda_halo.ext_launch_mirror(t_ext, tlife.RULES[rule], turns, pad, xpad)
    assert np.array_equal(mirror.numpy().view(np.uint32), want)


def forced_ext_plan(h_loc: int, wpl: int, turns: int, tile_h: int, extra: int = 0):
    """K9's blocks forced to ``tile_h`` centre rows, ``extra`` warps more
    than the window needs."""
    border = -(-turns // 32)
    warps = -(-(tile_h + 2 * turns) // 32) + extra
    return cuda_adaptive.RegPlan(turns, turns, tile_h, warps,
                                 (-(-h_loc // tile_h), -(-wpl // (32 - 2 * border))), border)


@pytest.mark.parametrize("xpad", [0, 1, 2])
@pytest.mark.parametrize("turns", [1, 7, 16, 32])
@pytest.mark.parametrize("tile_h,tile_w", [(5, 3), (11, 4), (40, 62)])
def test_ext_mirror_forced_tiles(xpad, turns, tile_h, tile_w):
    """K9's decomposition with forced blocks of ``tile_h`` centre rows on a
    37-row shard ``tile_w`` words wide (a ragged last block and column
    group, zero past the block, columns wrapped only when xpad = 0, one warp
    more than the window needs where tile_h is odd) equals the plain
    version."""
    pad = turns + 2
    ext = torch.from_numpy(random_words(np.random.default_rng(tile_h), 37 + 2 * pad,
                                        tile_w + 2 * xpad).view(np.int32))
    plan = forced_ext_plan(37, tile_w, turns, tile_h, tile_h % 2)
    got = cuda_halo.ext_launch_mirror(ext, tlife.HIGHLIFE, turns, pad, xpad, plan)
    assert torch.equal(got, cuda_halo.ext_launch_plain(ext, tlife.HIGHLIFE, turns, pad, xpad))


def test_ext_mirror_refuses_blocks_that_miss_the_centre():
    ext = torch.zeros((37 + 2 * 9, 7), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not cover"):
        cuda_halo.ext_launch_mirror(ext, tlife.CONWAY, 9, 9, 0, forced_ext_plan(30, 7, 9, 10))


# Shard shapes (h_loc, wpl) from one word to the 16384² soup's (4, 1) and
# (2, 2) shards (8192 x 512 words: a (2, 1) split), with ragged widths.
PLAN_SHAPES = [(1, 1), (3, 2), (64, 16), (65, 16), (130, 16), (190, 18), (1000, 61),
               (4096, 512), (8192, 256), (8192, 512)]


@pytest.mark.parametrize("strip", PLAN_SHAPES)
@pytest.mark.parametrize("turns", [1, 5, 6, 13, 24, 31, 32])
def test_ext_reg_plan_stores_every_centre_word_once(strip, turns):
    """K9's plan on 132 SMs: its blocks' centres (``tile_h`` rows by
    ``centre`` words, cut at the shard's edge) cover the shard with no
    block empty, so every centre word is stored by exactly one block; the
    window holds the tile and T rows a side, and its last generation's
    cone is exactly the tile."""
    plan = cuda_halo.ext_reg_plan(strip, turns, 132)
    h_loc, wpl = strip
    (nby, nbx), tile_h, centre = plan.grid, plan.tile_h, plan.centre
    assert (nby - 1) * tile_h < h_loc <= nby * tile_h
    assert (nbx - 1) * centre < wpl <= nbx * centre
    if h_loc * wpl <= 4096:
        count = np.zeros((nby * tile_h, nbx * centre), np.int64)
        for by in range(nby):
            for bx in range(nbx):
                count[by * tile_h : (by + 1) * tile_h, bx * centre : (bx + 1) * centre] += 1
        assert (count[:h_loc, :wpl] == 1).all()
    assert plan.t == plan.halo == turns and plan.border == 1 and plan.centre == 30
    assert plan.rows == tile_h + 2 * turns <= plan.warps * 32
    assert plan.cone(turns) == (turns, turns + tile_h)


@pytest.mark.parametrize("strip", PLAN_SHAPES)
@pytest.mark.parametrize("turns", [1, 16, 32])
def test_ext_reg_plan_fits_hopper(strip, turns):
    """Threads, registers and shared memory of K9's blocks within an H100
    SM's: at most 512 threads (``__launch_bounds__(512, 2)``, so at most 64
    registers a thread), the SM's 65,536 registers shared by the blocks it
    holds at once, and the edge exchange's 8 KiB of static shared memory
    (two parities x 16 warps x two rows x 32 words), and the 1 KiB the card
    reserves, times those blocks within its 228 KiB."""
    plan = cuda_halo.ext_reg_plan(strip, turns, 132)
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    assert plan.occupancy >= 2 and plan.occupancy * plan.threads * 64 <= 65536
    assert plan.occupancy <= 32 and plan.occupancy * plan.threads <= 2048
    assert plan.smem_bytes == 8192 and plan.occupancy * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.grid[1] <= 2**31 - 1 and plan.grid[0] <= 65535


@pytest.mark.parametrize("strip,turns,fill", [((4096, 512), 32, 1.0), ((8192, 256), 32, 0.98)])
def test_ext_reg_plan_fills_the_card_at_16384(strip, turns, fill):
    """The 16384² soup's (4, 1) and (2, 2) shards at the full launch depth
    on 132 SMs: every SM holds its share of the plan's blocks at once (no
    more blocks than its occupancy) and runs all but a stated share of the busiest SM's
    blocks."""
    plan = cuda_halo.ext_reg_plan(strip, turns, 132)
    assert plan.waves(132) <= plan.occupancy
    assert plan.fill(132) >= fill
    assert plan.fill(132) == plan.blocks / (plan.waves(132) * 132)


@pytest.mark.parametrize("strip,turns,xpad,fill", [
    ((4096, 512), 18, 0, 1.0), ((8192, 256), 18, 1, 0.98), ((4096, 512), 30, 0, 0.95),
    ((65, 16), 30, 0, 0.0), ((130, 16), 30, 1, 0.0), ((100, 17), 6, 1, 0.0)])
def test_ext_skip_plan_ends_at_the_block_edge(strip, turns, xpad, fill):
    """K10's blocks (``ext_skip_plan``): K9's blocks with the probe, the
    16384² soup's (4, 1) and (2, 2) shards filling the card; on every shape
    the row tiles and column groups cover each centre word, the last of
    each ends at the centre's edge, and every window's rows lie inside the
    extended block (on a 2-D tile its columns too, where the centre is a
    group wide)."""
    h_loc, wpl = strip
    plan = cuda_halo.ext_skip_plan(strip, turns, 132)
    assert (plan.t, plan.halo, plan.probe, plan.border) == (turns, turns, 6, 1)
    assert plan.fill(132) >= fill and plan.waves(132) <= max(plan.occupancy, 1)
    ys, xs = cuda_halo.ext_skip_origins(plan, strip)
    rows = np.zeros(h_loc, dtype=int)
    cols = np.zeros(wpl, dtype=int)
    for y in ys:
        rows[y : y + plan.tile_h] += 1
        assert 0 <= (h_loc + 2 * turns) - (y + plan.tile_h + 2 * turns) and y >= 0
    for x in xs:
        cols[x : x + plan.centre] += 1
        if xpad and wpl >= plan.centre:  # a row mesh's columns wrap: the torus
            assert x - plan.border + xpad >= 0 and x + plan.centre + plan.border <= wpl + 2 * xpad
    assert rows.min() >= 1 and cols.min() >= 1
    assert ys[-1] + plan.tile_h == h_loc
    assert xs[-1] + min(plan.centre, wpl) == wpl


@pytest.mark.parametrize("rule,variant", [("conway", "conway"), ("highlife", "highlife"),
                                          ("day-and-night", "generic"), ("seeds", "generic"),
                                          ("life-without-death", "generic")])
def test_reg_rule_picks_the_instantiation_by_masks(rule, variant):
    """B3/S23 and B36/S23 take their compile-time instantiations of K9 and
    K13, every other rule (and a B/S spelling of another) the generic one;
    the choice follows the masks, not the name."""
    assert cuda_halo.REG_RULES[cuda_halo.reg_rule(tlife.RULES[rule])[2]] == variant
    assert cuda_halo.reg_rule(tlife.parse_rule("B3/S23"))[2] == 1
    assert cuda_halo.reg_rule(tlife.parse_rule("B36/S23"))[2] == 2


def test_ext_launch_refuses_a_halo_too_shallow():
    ext = torch.zeros((20, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="turns <= pad"):
        cuda_halo.ext_launch(ext, tlife.CONWAY, 5, 4, 0)
    with pytest.raises(ValueError, match="xpad"):
        cuda_halo.ext_launch(ext, tlife.CONWAY, 40, 4, 1)


def test_ext_launch_on_the_cpu_runs_the_plain_version():
    ext = torch.from_numpy(random_words(np.random.default_rng(3), 48, 4).view(np.int32))
    before = cuda_halo.ext_launch.launches
    got = cuda_halo.ext_launch(ext, tlife.CONWAY, 8, 8, 0)
    assert cuda_halo.ext_launch.launches == before  # counts kernel launches only
    assert torch.equal(got, cuda_halo.ext_launch_plain(ext, tlife.CONWAY, 8, 8, 0))


# -- the sharded engines against the JAX package's ----------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("turns", [1, 37])
def test_sharded_roll_matches_jax(ref, mesh_shape, turns):
    b = random_board(np.random.default_rng(turns), *SHAPE)
    table = ref.jnp.asarray(ref.life.CONWAY.table)
    want = np.asarray(ref.halo.sharded_superstep(ref.mesh.make_mesh(mesh_shape))(
        ref.put(b, mesh_shape), table, turns))
    run = halo.sharded_superstep(cpu_mesh(mesh_shape))
    got = run(shard(b, mesh_shape), tstencil.rule_table(tlife.CONWAY, "cpu"), turns)
    assert np.array_equal(whole(got), want)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (2, 4)])
def test_parallel_sharded_step_matches_jax(ref, mesh_shape):
    """The package export ``parallel.sharded_step``: one generation, as the
    JAX package's."""
    from distributed_gol_torch import parallel
    from distributed_gol_tpu import parallel as jparallel

    b = random_board(np.random.default_rng(11), *SHAPE)
    table = ref.jnp.asarray(ref.life.CONWAY.table)
    want = np.asarray(jparallel.sharded_step(ref.mesh.make_mesh(mesh_shape))(
        ref.put(b, mesh_shape), table))
    got = parallel.sharded_step(cpu_mesh(mesh_shape))(
        shard(b, mesh_shape), tstencil.rule_table(tlife.CONWAY, "cpu"))
    assert np.array_equal(whole(got), want)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("turns", [1, 37])
def test_sharded_packed_matches_jax(ref, mesh_shape, turns):
    b = random_board(np.random.default_rng(turns + 1), *SHAPE)
    p = np.asarray(ref.packed.pack(ref.jnp.asarray(b)))
    jm = ref.mesh.make_mesh(mesh_shape)
    want = np.asarray(ref.packed_halo.sharded_superstep(jm, ref.life.CONWAY)(
        ref.put(p, mesh_shape), turns))
    got = packed_halo.sharded_superstep(cpu_mesh(mesh_shape), tlife.CONWAY)(
        shard(p, mesh_shape), turns)
    assert np.array_equal(whole(got), want)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("turns", [1, 3, 37, 67])
def test_cuda_halo_superstep_matches_pallas_halo(ref, mesh_shape, turns):
    """Full launches and the remainder launch: 67 is a prime above twice the
    port's deepest launch (T = 32), 37 a full launch plus a remainder."""
    b = random_board(np.random.default_rng(turns + 2), *SHAPE)
    p = np.asarray(ref.packed.pack(ref.jnp.asarray(b)))
    jm = ref.mesh.make_mesh(mesh_shape)
    want = np.asarray(ref.pallas_halo.make_superstep(jm, ref.life.CONWAY)(
        ref.put(p, mesh_shape), turns))
    got = cuda_halo.make_superstep(cpu_mesh(mesh_shape), tlife.CONWAY)(
        shard(p, mesh_shape), turns)
    assert np.array_equal(whole(got), want)


def test_cuda_halo_highlife_on_a_2d_mesh(ref):
    b = random_board(np.random.default_rng(9), 64, 128)
    p = np.asarray(ref.packed.pack(ref.jnp.asarray(b)))
    want = np.asarray(ref.pallas_halo.make_superstep(ref.mesh.make_mesh((2, 2)),
                                                     ref.life.HIGHLIFE)(ref.put(p, (2, 2)), 40))
    got = cuda_halo.make_superstep(cpu_mesh((2, 2)), tlife.HIGHLIFE)(shard(p, (2, 2)), 40)
    assert np.array_equal(whole(got), want)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 4)])
def test_steps_with_counts_match_jax(ref, mesh_shape):
    b = random_board(np.random.default_rng(5), 32, 128)
    jm = ref.mesh.make_mesh(mesh_shape)
    table = ref.jnp.asarray(ref.life.CONWAY.table)
    jb, jc = ref.halo.sharded_steps_with_counts(jm)(ref.put(b, mesh_shape), table, 12)
    tb, tc = halo.sharded_steps_with_counts(cpu_mesh(mesh_shape))(
        shard(b, mesh_shape), tstencil.rule_table(tlife.CONWAY, "cpu"), 12)
    assert np.array_equal(whole(tb), np.asarray(jb))
    assert tc.dtype == torch.int32 and tc.tolist() == np.asarray(jc).tolist()
    p = np.asarray(ref.packed.pack(ref.jnp.asarray(b)))
    jpb, jpc = ref.packed_halo.sharded_steps_with_counts(jm, ref.life.CONWAY)(
        ref.put(p, mesh_shape), 12)
    tpb, tpc = packed_halo.sharded_steps_with_counts(cpu_mesh(mesh_shape), tlife.CONWAY)(
        shard(p, mesh_shape), 12)
    assert np.array_equal(whole(tpb), np.asarray(jpb))
    assert tpc.tolist() == np.asarray(jpc).tolist() == tc.tolist()
    jbb, jbc = ref.packed_halo.make_steps_with_counts_bytes(jm, ref.life.CONWAY)(
        ref.put(b, mesh_shape), 12)
    tbb, tbc = packed_halo.make_steps_with_counts_bytes(cpu_mesh(mesh_shape), tlife.CONWAY)(
        shard(b, mesh_shape), 12)
    assert np.array_equal(whole(tbb), np.asarray(jbb))
    assert tbc.tolist() == np.asarray(jbc).tolist()


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 4)])
def test_byte_drivers_match_the_single_device_engine(mesh_shape):
    b = random_board(np.random.default_rng(6), *SHAPE)
    want = tpacked.make_superstep(tlife.CONWAY)(torch.from_numpy(b), 45).numpy()
    m = cpu_mesh(mesh_shape)
    for make in (packed_halo.make_superstep_bytes, cuda_halo.make_superstep_bytes):
        assert np.array_equal(whole(make(m, tlife.CONWAY)(shard(b, mesh_shape), 45)), want)


def test_exchange_copies_corners_and_never_writes_its_input():
    """A (2, 2) mesh of distinct words: the extended block of each shard is
    the torus neighbourhood of the shard, corners included."""
    board = np.arange(8 * 6, dtype=np.int32).reshape(8, 6)
    sb = shard(board, (2, 2))
    before = [t.clone() for t in sb.flat]
    ext = halo.extend(sb, 2, 1)
    padded = np.pad(board, ((2, 2), (1, 1)), mode="wrap")
    for iy in range(2):
        for ix in range(2):
            want = padded[4 * iy : 4 * iy + 8, 3 * ix : 3 * ix + 5]
            assert np.array_equal(ext[iy][ix].numpy(), want)
    assert all(torch.equal(a, b) for a, b in zip(before, sb.flat))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("start,n", [(0, 8), (5, 30), (-7, 20), (60, 64), (13, 3)])
def test_rows_take_the_torus_rows_from_the_shards(mesh_shape, start, n):
    """``ShardedBoard.rows`` and ``WholeBoard.rows``: rows start .. start+n-1
    modulo the height, whatever shards they span."""
    board = np.arange(64 * 8, dtype=np.int32).reshape(64, 8)
    want = np.roll(board, -start, axis=0)[:n]
    assert np.array_equal(shard(board, mesh_shape).rows(start, n).numpy(), want)
    assert np.array_equal(halo.as_board(torch.from_numpy(board)).rows(start, n).numpy(), want)


def test_reduce_hands_each_shard_its_offset():
    board = np.arange(8 * 6, dtype=np.int32).reshape(8, 6)
    seen = []
    total = shard(board, (2, 2)).reduce(
        lambda t, y0, x0: seen.append((y0, x0)) or t[0, 0].to(torch.int64))
    assert seen == [(0, 0), (0, 3), (4, 0), (4, 3)]
    assert int(total) == board[0, 0] + board[0, 3] + board[4, 0] + board[4, 3]
    assert halo.as_board(halo.as_board(torch.from_numpy(board))).reduce(
        lambda t, y0, x0: t.sum()) == board.sum()


# -- the plan and the gate ------------------------------------------------------


def test_launch_plan_caps_t_at_the_strip_and_ends_with_the_remainder():
    plans = cuda_halo.launch_plan((16, 8), (8, 1), 67)
    assert [p.t for p in plans] == [16] * 4 + [3]
    assert all(p.pad == p.t and p.xpad == 0 for p in plans)
    two_d = cuda_halo.launch_plan((4096, 256), (2, 2), 70)
    assert [(p.t, p.xpad) for p in two_d] == [(32, 1), (32, 1), (6, 1)]
    assert two_d[0].halo_bytes((4096, 256)) == 4 * (2 * 32 * 256 + 2 * (4096 + 64))
    assert cuda_halo.launch_plan((64, 8), (2, 1), 0) == []


def test_gate_takes_short_strips_the_tpu_gate_refuses(ref):
    # 4-row strips: the port caps T at 4; the TPU's gate wants 8k rows.
    assert cuda_halo.supports((32, 16), (8, 1))
    assert not ref.pallas_halo.supports((32, 16), (8, 1))
    assert not cuda_halo.supports((512, 16), (3, 1))  # does not divide
    assert not cuda_halo.supports((64, 2), (1, 4))  # shards narrower than a word


@pytest.mark.parametrize("strip,t,xpad", [((4096, 512), 32, 0), ((8192, 256), 32, 1),
                                          ((16, 8), 16, 0), ((64, 4), 3, 1)])
def test_k9_bound_counts_only_the_centres_light_cone(strip, t, xpad):
    """``chip_smoke.py``'s K9 bound: generation k of T computes the centre
    plus T - k rows a side (and on a 2-D mesh ceil((T - k) / 32) words a
    side), never the whole extended block; it reads the extended block once
    and writes the centre once."""
    import chip_smoke

    h, w = strip
    cone = sum((h + 2 * (t - k)) * (w + 2 * xpad * -(-(t - k) // 32)) for k in range(1, t + 1))
    assert cone < t * (h + 2 * t) * (w + 2 * xpad)  # the extended block's count
    if not xpad:
        assert cone == t * h * w + t * (t - 1) * w
    ops = chip_smoke.ops_per_word(tlife.CONWAY)
    assert chip_smoke.ext_bound_ms(strip, t, t, xpad, tlife.CONWAY, 1.0) == (
        cone * ops * 1e3, "operations")
    moved = (h + 2 * t) * (w + 2 * xpad) + h * w
    assert chip_smoke.ext_bound_ms(strip, t, t, xpad, tlife.CONWAY, 1e30) == (
        moved * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes")


def test_skip_stable_on_a_mesh_names_its_roadmap_item():
    """Row meshes run the adaptive strip tier and 2-D meshes the adaptive
    tile tier: a (2, 2) dispatch with skip_stable equals the (2, 1) one."""
    from distributed_gol_torch.utils.soup import random_soup

    p = tpacked.pack(torch.from_numpy(random_soup(64, 128, 0.3, 7)))
    out = []
    for shape in ((2, 2), (2, 1)):
        m = cpu_mesh(shape)
        step = cuda_halo.make_superstep(m, tlife.CONWAY, skip_stable=True, skip_tile_cap=16)
        out.append(step(halo.board_sharding(m).shard(p), 41).gather())
    assert torch.equal(out[0], out[1])
    assert torch.equal(out[0], tpacked.superstep(p, tlife.CONWAY, 41))


# -- mesh arithmetic ------------------------------------------------------------

BOARDS = [(64, 64), (48, 96), (100, 60), (4096, 4128), (1, 32), (512, 16384)]


@pytest.mark.parametrize("shape", BOARDS)
def test_mesh_shape_arithmetic_matches_jax(ref, shape):
    for n in range(1, 17):
        for fn in ("mesh_shape_for", "largest_mesh_shape"):
            try:
                want = getattr(ref.mesh, fn)(n, *shape)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(tmesh, fn)(n, *shape)
                continue
            assert getattr(tmesh, fn)(n, *shape) == want, (fn, n, shape)
        assert tmesh.largest_mesh_shape(n, *shape, word_aligned=False) == \
            ref.mesh.largest_mesh_shape(n, *shape, word_aligned=False)


def test_make_mesh_raises_on_too_few_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tmesh.clear_blacklist()
    assert tmesh.healthy_devices() == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match=r"mesh \(4, 1\) needs 4 devices, have 1"):
        tmesh.make_mesh((4, 1))
    try:
        tmesh.condemn([0])
        with pytest.raises(ValueError, match=r"have 0 \(1 blacklisted\)"):
            tmesh.make_mesh((2, 1))
    finally:
        tmesh.clear_blacklist()
    virtual = tmesh.make_mesh((2, 2), [torch.device("cuda", 0)] * 4)
    assert virtual.shape == {"y": 2, "x": 2} and len(set(virtual.flat)) == 1


def test_make_mesh_without_cuda_never_takes_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        tmesh.make_mesh((2, 1))


def test_probe_devices_classifies_the_cpu_healthy():
    healthy, condemned = tmesh.probe_devices([torch.device("cpu")])
    assert healthy == [torch.device("cpu")] and condemned == []


# -- K9 on the card -------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_condemned_cpu_device_leaves_the_card_alone(cuda_device, tmp_path):
    """The blacklist keys a device by type and index: a condemned virtual
    cpu:0 leaves a CUDA Backend's default placement on cuda:0."""
    from distributed_gol_torch import Params
    from distributed_gol_torch.engine.backend import Backend

    tmesh.clear_blacklist()
    try:
        assert tmesh.condemn([torch.device("cpu", 0)]) == [0]
        assert not tmesh.blacklisted("cuda") and tmesh.blacklisted("cpu") == {0}
        assert tmesh.lost_device_count() == 0
        p = Params(image_width=64, image_height=64, out_dir=tmp_path, device="cuda")
        assert tmesh.device_key(Backend(p).device) == ("cuda", 0)
        assert tmesh.healthy_devices() == tmesh.device_pool("cuda")
    finally:
        tmesh.clear_blacklist()


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
@pytest.mark.parametrize(
    "strip,pad,xpad,turns",
    [((256, 64), 32, 0, 32), ((256, 64), 32, 0, 5), ((100, 17), 9, 1, 9),
     ((1000, 128), 20, 1, 20), ((7, 3), 40, 2, 40), ((1, 1), 1, 0, 1),
     # shards shorter than one run or one block: path (c)'s 512² on (8, 1),
     # path (f)'s 65-row strips, path (i)'s 130-row tiles
     ((64, 16), 32, 0, 32), ((65, 16), 5, 0, 5), ((130, 16), 5, 1, 5),
     # widths off the warp's 30 centre words, a deeper pad than T
     ((300, 61), 24, 0, 17), ((97, 95), 32, 1, 31), ((4096, 512), 32, 0, 32)],
)
def test_gpu_ext_kernel_matches_plain(cuda_device, rule, strip, pad, xpad, turns):
    h_loc, wpl = strip
    ext = torch.from_numpy(random_words(np.random.default_rng(turns), h_loc + 2 * pad,
                                        wpl + 2 * xpad).view(np.int32)).to(cuda_device)
    before_in = ext.clone()
    launches = cuda_halo.ext_launch.launches
    got = cuda_halo.ext_launch(ext, tlife.RULES[rule], turns, pad, xpad)
    torch.cuda.synchronize()
    assert cuda_halo.ext_launch.launches == launches + 1
    assert torch.equal(got, cuda_halo.ext_launch_plain(ext, tlife.RULES[rule], turns, pad, xpad))
    assert torch.equal(ext, before_in)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (8, 1), (1, 4)])
def test_gpu_virtual_mesh_matches_single_device(cuda_device, mesh_shape):
    b = random_board(np.random.default_rng(7), 512, 1024)
    p = tpacked.pack(torch.from_numpy(b)).to(cuda_device)
    m = tmesh.make_mesh(mesh_shape, [cuda_device] * (mesh_shape[0] * mesh_shape[1]))
    got = cuda_halo.make_superstep(m, tlife.CONWAY)(halo.board_sharding(m).shard(p), 77)
    torch.cuda.synchronize()
    assert torch.equal(got.gather(), tpacked.superstep(p, tlife.CONWAY, 77))


@pytest.mark.gpu
@pytest.mark.parametrize("xpad", [0, 1])
@pytest.mark.parametrize("turns", range(1, 33))
def test_gpu_ext_kernel_matches_plain_at_every_depth(cuda_device, xpad, turns):
    """K9 at every launch depth (the remainders' included) on a ragged
    shard, 97 rows by 61 words, against its plain version."""
    ext = torch.from_numpy(random_words(np.random.default_rng(turns), 97 + 2 * turns,
                                        61 + 2 * xpad).view(np.int32)).to(cuda_device)
    got = cuda_halo.ext_launch(ext, tlife.CONWAY, turns, turns, xpad)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_halo.ext_launch_plain(ext, tlife.CONWAY, turns, turns, xpad))


@pytest.mark.gpu
@pytest.mark.parametrize("rule,variant", [("conway", "conway"), ("highlife", "highlife"),
                                          ("day-and-night", "generic"), ("seeds", "generic")])
def test_gpu_rules_reach_their_instantiation(cuda_device, rule, variant):
    """Each rule's K9 and K13 launches run the instantiation meant for it
    (the launchers' counts by instantiation), and each equals its plain
    version."""
    from distributed_gol_torch.ops.cuda_adaptive import AdaptivePlan

    r = tlife.RULES[rule]
    cuda_halo.reset_launches()
    ext = torch.from_numpy(random_words(np.random.default_rng(4), 64 + 2 * 16, 40)
                           .view(np.int32)).to(cuda_device)
    got = cuda_halo.ext_launch(ext, r, 12, 16, 1)
    assert torch.equal(got, cuda_halo.ext_launch_plain(ext, r, 12, 16, 1))
    plan = AdaptivePlan(12, 16, False)
    outs = []
    for launch in (cuda_halo.tile_probing_launch, cuda_halo.tile_probing_launch_plain):
        dst = torch.zeros((64, 38), dtype=torch.int32, device=cuda_device)
        st = torch.ones(4, dtype=torch.int32, device=cuda_device)
        outs.append((launch(ext, torch.zeros_like(st), dst, st, r, plan, 1), st))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert dict(cuda_halo.ext_launch.rules) == {variant: 1}
    assert dict(cuda_halo.tile_probing_launch.rules) == {variant: 1}
