"""The in-kernel exchange tier of ``skip_stable`` on 2-D meshes
(``parallel/cuda_halo.py``: K15 ``tile_mega_launch``, the chunk function
``tile_mega_launches``, the dispatch split ``tile_mega_chunks``, the
virtual build ``make_superstep_virtual_2d`` and the policy
``tier_policy``) against the JAX package's.

On the CPU the wrappers run their plain versions.  The JAX package runs
the 2-D megakernel ``_kernel_frontier_mega_2d`` on CPU only in its virtual
build (``pallas_halo.make_superstep_virtual_2d``, interpret mode: a whole
(ny, nx) mesh on one device), so the port's virtual build, put on the JAX
plan, must give its board, skip count and (ny·grid, nx) activity grid,
tolerance 0.  A mesh of several CPU shards takes the ppermute tier in both
packages (the interpret-mode reason); with the policy answering as it does
on one card, a CPU ``gol.run`` runs the tier end to end and must write the
JAX package's PGM.  Tests marked ``gpu`` hold K15 to its plain version on
the card.

The JAX package is imported inside the tests that compare with it:
``python -m pytest tests/test_torch_tile_mega.py -m gpu --noconftest``
runs the card's tests on a machine without JAX."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.parallel import cuda_halo, halo
from distributed_gol_torch.parallel import mesh as tmesh
from test_torch_tile_kernels import GLIDER_SE, _put, mesh_board  # tests/ is on the path

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = [(2, 2), (2, 4), (4, 2), (1, 2)]
PLAIN_K15 = cuda_halo.tile_mega_launch_plain
TURNS = [8 * 18, 8 * 18 + 2 * 18 + 7]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax
    import jax.numpy as jnp

    from distributed_gol_tpu.engine.backend import Backend as JBackend
    from distributed_gol_tpu.engine.params import Params as JParams
    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed
    from distributed_gol_tpu.parallel import pallas_halo
    from distributed_gol_tpu.parallel.mesh import make_mesh

    return SimpleNamespace(jax=jax, jnp=jnp, life=life, packed=packed, ph=pallas_halo,
                           make_mesh=make_mesh, Backend=JBackend, Params=JParams)


def jax_tile_plan(ph, tile, turns, cap=0):
    """The JAX package's interpret-mode 2-D plan as the port's (plan,
    xpad): its T, its ``_plan_tile_2d`` stripes (the megakernel's
    ``_plan_2d`` tile height), a frontier form where ``_plan_2d`` has one,
    and its ``_xpad_words``."""
    cap, t, adaptive, plan2 = ph._adaptive_plan_2d(tile, turns, cap or None, True)
    if not adaptive:
        return None
    xpad = ph._xpad_words(tile[1], True)
    return cuda_adaptive.AdaptivePlan(t, ph._plan_tile_2d(tile, t, cap, xpad),
                                      plan2 is not None), xpad


@pytest.fixture()
def jax_plan(monkeypatch, ref):
    """Put the port on the JAX package's 2-D plan."""
    monkeypatch.setattr(cuda_halo, "adaptive_tile_plan",
                        lambda tile, turns, cap=0: jax_tile_plan(ref.ph, tile, turns, cap))


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of the calls of the 2-D tiers' plain versions (what the
    wrappers run on the CPU), by kernel."""
    counts = dict.fromkeys(("K9", "K10", "K13", "K15"), 0)
    names = {"K9": "ext_launch_plain", "K10": "ext_skip_launch_plain",
             "K13": "tile_probing_launch_plain", "K15": "tile_mega_launch_plain"}
    for k, name in names.items():
        fn = getattr(cuda_halo, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            counts[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cuda_halo, name, counted)
    return counts


def mesh2d_board() -> np.ndarray:
    """``tests/test_pallas_halo.py::TestMesh2D``'s 4096 x 128 board: a
    glider, a block and a period-3 pulsar."""
    b = np.zeros((4096, 128), dtype=np.uint8)
    for dy, dx in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[2030 + dy, 60 + dx] = 255
    b[100:102, 20:22] = 255
    for c in [2, 3, 4, 8, 9, 10]:
        for r in (0, 5, 7, 12):
            b[3000 + r, 40 + c] = 255
            b[3000 + c, 40 + r] = 255
    return b


def seam_glider_board() -> np.ndarray:
    """``test_virtual_skip_and_activity_match_solo_regions``' 4096²
    board: a glider near the column seam of (2, 2) and a block."""
    b = np.zeros((4096, 4096), dtype=np.uint8)
    for dy, dx in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[2000 + dy, 2040 + dx] = 255
    b[40:42, 20:22] = 255
    return b


def packed_of(b: np.ndarray, device=CPU) -> torch.Tensor:
    return tpacked.pack(torch.from_numpy(b)).to(device)


@pytest.fixture(scope="module")
def jax_virtual(ref):
    """The JAX virtual build's (board, skipped, activity), cached per
    (board name, mesh, turns, cap): each runs the megakernel in interpret
    mode once for the module."""
    boards = {"mesh2d": mesh2d_board, "seam": seam_glider_board}

    @functools.lru_cache(maxsize=None)
    def run(name, mesh_shape, turns, cap=None):
        p = ref.jnp.asarray(np.asarray(ref.packed.pack(ref.jnp.asarray(boards[name]()))))
        fn = ref.ph.make_superstep_virtual_2d(mesh_shape, ref.life.CONWAY, skip_tile_cap=cap,
                                              with_stats=True)
        out, sk, act = fn(p, turns)
        return np.asarray(out).view(np.int32), int(sk), np.asarray(act)

    return run


def port_virtual(board: np.ndarray, mesh_shape, turns, cap=0, rule=tlife.CONWAY, device=CPU):
    """The port's virtual build: (packed board, skipped, activity) on the
    CPU."""
    out, sk, act = cuda_halo.make_superstep_virtual_2d(mesh_shape, rule, cap, True)(
        packed_of(board, device), turns)
    return out.cpu().numpy(), int(sk), act.cpu().numpy()


# -- the virtual build against the JAX package's ------------------------------------------


@pytest.mark.parametrize("turns", TURNS, ids=["one-chunk", "chunk-tail-remainder"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_virtual_matches_jax(jax_virtual, jax_plan, plain_calls, mesh_shape, turns):
    """``TestMesh2D``'s board and turns at the JAX plan (T = 18): one
    8-launch K15 chunk, then with 2·18 + 7 more turns a loose tail and a
    remainder on ``packed.superstep``.  Board, skip count and (ny·grid,
    nx) activity equal the JAX virtual build's, and the board the straight
    single-device one."""
    b = mesh2d_board()
    got = port_virtual(b, mesh_shape, turns)
    want = jax_virtual("mesh2d", mesh_shape, turns)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    straight = tpacked.superstep(packed_of(b), tlife.CONWAY, turns)
    np.testing.assert_array_equal(got[0], straight.numpy())
    assert plain_calls["K15"] == 8 and not plain_calls["K13"]
    plan, _ = cuda_halo.adaptive_tile_plan((4096 // mesh_shape[0], 4 // mesh_shape[1]), turns)
    grid = plan.grid(4096 // mesh_shape[0])
    assert got[2].shape == (mesh_shape[0] * grid, mesh_shape[1])


def test_virtual_activity_matches_the_solo_regions(jax_virtual, jax_plan):
    """The 4096² board with a glider at the column seam, cap 256 on (2, 2)
    (16 stripes of the board): the JAX virtual build's board, skip count
    and activity; the activity's any-over-x equals the single-device
    frontier chunk's per-stripe activity at the same stripes (both measure
    the same gen-T against gen-(T + 6) rows of each region), and ash
    stripes skip."""
    b, turns, cap = seam_glider_board(), 8 * 18, 256
    got = port_virtual(b, (2, 2), turns, cap)
    want = jax_virtual("seam", (2, 2), turns, cap)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[1] > 0
    np.testing.assert_array_equal(got[2], want[2])
    plan, _ = cuda_halo.adaptive_tile_plan((2048, 64), turns, cap)
    solo = cuda_adaptive.frontier_superstep_mirror(packed_of(b), tlife.CONWAY, plan, 8)[2]
    assert got[2].shape == (16, 2) and (solo > 0).any()
    np.testing.assert_array_equal((got[2] > 0).any(axis=1), solo.numpy() > 0)


def test_virtual_refuses_a_tile_without_a_frontier_plan():
    """A plan-less tile raises (never another tier): 16-row tiles at cap
    16 have stripes too short for round8(T + 6)."""
    with pytest.raises(ValueError, match="no 2-D frontier plan"):
        cuda_halo.make_superstep_virtual_2d((2, 2), tlife.CONWAY, 16)(
            torch.zeros((32, 4), dtype=torch.int32), 8 * 12)


# -- chunks on soups: the exchange inside the launch ----------------------------------------

TILE_PLANS = {"T18-s32": cuda_adaptive.AdaptivePlan(18, 32, True),
              "T6-s16": cuda_adaptive.AdaptivePlan(6, 16, True)}


def tiles_of(p: torch.Tensor, mesh_shape) -> list[list[torch.Tensor]]:
    ny, nx = mesh_shape
    return [[t.contiguous() for t in r.chunk(nx, dim=1)] for r in p.chunk(ny)]


def whole(tiles) -> torch.Tensor:
    return torch.cat([torch.cat(r, dim=1) for r in tiles])


@pytest.mark.parametrize("plan", list(TILE_PLANS.values()), ids=list(TILE_PLANS))
@pytest.mark.parametrize("kind", ["soup", "ash", "glider_corner", "glider_x", "glider_y"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
@pytest.mark.parametrize("rule", ["conway", "highlife"])
def test_chunk_matches_the_whole_board(rule, mesh_shape, kind, plan):
    """On 128 x 4-word tiles of soups, ash and ash with gliders crossing
    the row seam, the column seam and a corner (and the torus corner): the
    plain K15 chunk (8 launches) equals ``packed.superstep`` on the whole
    board; on ash every interior stripe skips after launch 0."""
    r = tlife.RULES[rule]
    cells = mesh_board(kind, (128, 4), mesh_shape)
    p = packed_of(cells.astype(np.uint8) * 255)
    tiles, st = cuda_halo.tile_mega_launches(tiles_of(p, mesh_shape), r, plan, 8)
    assert torch.equal(whole(tiles), tpacked.superstep(p, r, 8 * plan.t))
    ntiles, grid = mesh_shape[0] * mesh_shape[1], plan.grid(128)
    assert st.skipped.shape == (ntiles,) and st.act.shape == (ntiles * grid,)
    assert int(st.skipped.sum()) <= 7 * ntiles * (grid - 2)  # edges and launch 0 compute
    if kind == "ash":
        assert int(st.skipped.sum()) == 7 * ntiles * (grid - 2)
    assert not st.rowflag.any()


def test_two_tiles_across_see_one_neighbour_twice():
    """On (1, 2) each tile's N and S neighbour is itself and its W and E
    neighbours the one other tile: a board of two identical tiles evolves
    as the single tile's torus, and both tiles keep equal telemetry."""
    cells = mesh_board("glider_corner", (128, 4), (1, 1))
    p = packed_of(np.tile(cells, (1, 2)).astype(np.uint8) * 255)
    plan = TILE_PLANS["T18-s32"]
    tiles, st = cuda_halo.tile_mega_launches(tiles_of(p, (1, 2)), tlife.CONWAY, plan, 8)
    single = tpacked.superstep(packed_of(cells.astype(np.uint8) * 255), tlife.CONWAY, 8 * 18)
    assert all(torch.equal(t, single) for t in tiles[0])
    assert st.skipped[0] == st.skipped[1]
    assert torch.equal(st.act[:4], st.act[4:])


def test_chunk_never_writes_its_input():
    p = packed_of(mesh_board("settled", (128, 4)).astype(np.uint8) * 255)
    tiles = tiles_of(p, (2, 2))
    before = [t.clone() for r in tiles for t in r]
    cuda_halo.tile_mega_launches(tiles, tlife.CONWAY, TILE_PLANS["T6-s16"], 3)
    assert all(torch.equal(a, b) for a, b in zip((t for r in tiles for t in r), before))


def test_launch_refuses_what_k15_cannot_take():
    """The geometry gate raises, never quietly takes another tier: a plan
    with no frontier form, stripes that do not divide the tile, a write
    buffer that is a read buffer or written twice, rows of unequal length,
    state of another mesh's size."""
    p = packed_of(mesh_board("settled", (64, 4)).astype(np.uint8) * 255)
    tiles = tiles_of(p, (2, 2))
    bufs = [[torch.empty_like(t) for t in r] for r in tiles]
    plan = TILE_PLANS["T6-s16"]
    st = cuda_halo.MeshState.start(4, 64, plan, CPU)
    bad = [
        (tiles, bufs, st, cuda_adaptive.AdaptivePlan(6, 8, False)),
        (tiles, bufs, st, cuda_adaptive.AdaptivePlan(6, 48, True)),
        (tiles, [bufs[0], [bufs[1][0], tiles[1][1]]], st, plan),
        (tiles, [bufs[0], [bufs[1][0], bufs[1][0]]], st, plan),
        (tiles, [bufs[0], bufs[1][:1]], st, plan),
        (tiles, bufs, cuda_halo.MeshState.start(2, 64, plan, CPU), plan),
    ]
    for reads, writes, state, pl in bad:
        with pytest.raises(ValueError):
            cuda_halo.tile_mega_launch(reads, writes, state, tlife.CONWAY, pl, 0, True)


def test_activity_grid_order():
    """Tile-major per-stripe activity becomes (stripe, x-tile) cells:
    stripe i of tile (dy, dx) lands at row dy·grid + i, column dx."""
    ny, nx, grid = 2, 3, 4
    act = torch.arange(ny * nx * grid, dtype=torch.int32)
    grid2 = cuda_halo.tile_activity(act, ny, nx)
    assert grid2.shape == (ny * grid, nx)
    for dy in range(ny):
        for dx in range(nx):
            for i in range(grid):
                assert grid2[dy * grid + i, dx] == (dy * nx + dx) * grid + i


# -- K15's mirror: the kernel's blocks and its edge-stripe elision --------------------------


@pytest.fixture()
def k15_mirror(monkeypatch):
    """The K15 wrapper's CPU path on K15's mirror
    (``tile_mega_launch_mirror``: the kernel's blocks, light cone and
    edge-stripe elision) in place of the plain version; the mirror's
    elision count starts at 0."""
    monkeypatch.setattr(cuda_halo, "tile_mega_launch_plain", cuda_halo.tile_mega_launch_mirror)
    monkeypatch.setattr(cuda_halo.tile_mega_launch_mirror, "elided", 0)


@pytest.mark.parametrize("turns", TURNS, ids=["one-chunk", "chunk-tail-remainder"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_virtual_mirror_matches_jax(jax_virtual, jax_plan, k15_mirror, mesh_shape, turns):
    """``test_virtual_matches_jax`` with K15's mirror in the chunk: board,
    skip count and (ny·grid, nx) activity equal the JAX virtual build's,
    although the mirror elides the edge stripes the JAX kernel forces
    wherever their 3x3-tile neighbourhood is quiet."""
    got = port_virtual(mesh2d_board(), mesh_shape, turns)
    want = jax_virtual("mesh2d", mesh_shape, turns)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert cuda_halo.tile_mega_launch_mirror.elided > 0


def chunk_through(fn, tiles, rule, plan, nlaunch, monkeypatch):
    """An ``nlaunch`` K15 chunk with ``fn`` as the wrapper's CPU path,
    recorded launch by launch: [(tiles, state, skipped, activity)]."""
    monkeypatch.setattr(cuda_halo, "tile_mega_launch_plain", fn)
    seen = []
    cuda_halo.tile_mega_launches(tiles, rule, plan, nlaunch, each=lambda out, st: seen.append((
        [t.clone() for r in out for t in r], st.state.clone(), st.skipped.clone(),
        st.act.clone())))
    return seen


MIRROR_CASES = [(rule, mesh_shape) for rule in ("conway", "highlife")
                for mesh_shape in ((2, 2), (1, 2), (2, 4))] + [("day-and-night", (2, 2))]


@pytest.mark.parametrize("plan", list(TILE_PLANS.values()), ids=list(TILE_PLANS))
@pytest.mark.parametrize("kind", ["soup", "settled", "glider_corner"])
@pytest.mark.parametrize("rule,mesh_shape", MIRROR_CASES,
                         ids=[f"{r}-{m[0]}x{m[1]}" for r, m in MIRROR_CASES])
def test_mirror_matches_plain_launch_by_launch(monkeypatch, rule, mesh_shape, kind, plan):
    """K15's mirror against the plain version over an 8-launch chunk of
    128 x 4-word tiles, launch by launch: tiles, the whole state (row and
    column intervals and change rectangles), skip counts and activity,
    tolerance 0,
    under both compiled-in rules and one that takes the generic
    instantiation."""
    r = tlife.RULES[rule]
    p = packed_of(mesh_board(kind, (128, 4), mesh_shape).astype(np.uint8) * 255)
    plain = chunk_through(cuda_halo.tile_mega_launch_plain, tiles_of(p, mesh_shape), r, plan, 8,
                          monkeypatch)
    mirror = chunk_through(cuda_halo.tile_mega_launch_mirror, tiles_of(p, mesh_shape), r, plan,
                           8, monkeypatch)
    assert len(plain) == len(mirror) == 8
    for a, b in zip(plain, mirror):
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
        assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


def still_lifes_and_blinkers(rows: int, cols: int) -> np.ndarray:
    """Blocks and blinkers (period 2) spread over a (rows, cols) board,
    every one at least five cells from the rows and columns that are
    multiples of 64 (the seams of the tiles below)."""
    b = np.zeros((rows, cols), dtype=bool)
    for y in range(6, rows - 6, 13):
        if not 5 <= y % 64 <= 58:
            continue
        for x in range(6, cols - 6, 17):
            if not 5 <= x % 64 <= 56:
                continue
            if (x // 4) % 2:
                b[y : y + 2, x : x + 2] = True  # block
            else:
                b[y, x : x + 3] = True  # blinker
    return b


def jax_chunk(ref, cells: np.ndarray, mesh_shape, rule: str, t: int, cap: int, nlaunch: int):
    """One ``nlaunch``-launch chunk of the JAX 2-D megakernel's virtual
    build (``_build_dispatch_frontier_2d``, interpret mode) at launch depth
    ``t`` and stripe cap ``cap`` on the whole board, as
    ``make_superstep_virtual_2d`` runs a chunk: (packed board, skipped,
    (ny·grid, nx) activity)."""
    ny, nx = mesh_shape
    jnp = ref.jnp
    p = jnp.asarray(np.asarray(ref.packed.pack(jnp.asarray(cells.astype(np.uint8) * 255))))
    strip = (p.shape[0] // ny, p.shape[1] // nx)
    grid = strip[0] // ref.ph._plan_2d(strip, t, cap, True)[4]
    call = ref.ph._build_dispatch_frontier_2d(strip, mesh_shape, ref.life.RULES[rule], t, nlaunch,
                                              True, cap, False)
    na, nb, sk, act = call(p, jnp.zeros_like(p))
    board = nb if nlaunch % 2 else na
    act = np.asarray(act).reshape(ny, nx, grid).transpose(0, 2, 1).reshape(ny * grid, nx)
    return np.asarray(board).view(np.int32), int(sk[0]), act


def port_chunk(cells: np.ndarray, mesh_shape, rule: str, plan, nlaunch: int, each=None):
    """The port's K15 chunk on the board's tiles: (packed board, skipped,
    (ny·grid, nx) activity)."""
    p = packed_of(cells.astype(np.uint8) * 255)
    tiles, st = cuda_halo.tile_mega_launches(tiles_of(p, mesh_shape), tlife.RULES[rule], plan,
                                             nlaunch, each=each)
    return (whole(tiles).numpy(), int(st.skipped.sum()),
            cuda_halo.tile_activity(st.act, *mesh_shape).numpy())


# The JAX 2-D megakernel's plan at a stripe cap of 256 and T = 6 on 1024 x
# 2-word tiles: four 256-row stripes a tile (its shortest frontier
# stripes: its plan declines shorter ones), and the port's shortest
# frontier stripes, 16 rows at T = 6.
JAX_EDGE_PLAN = cuda_adaptive.AdaptivePlan(6, 256, True)
EDGE_PLAN = cuda_adaptive.AdaptivePlan(6, 16, True)


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_elision_on_settled_tiles_keeps_the_jax_counts(ref, monkeypatch, k15_mirror):
    """Still lifes and blinkers on (2, 2) tiles of 1024 x 2 words with
    256-row stripes (T = 6): after launch 0 every stripe is quiet, so the
    mirror elides both edge stripes of every tile on launches 1-7, while
    board, skip count (the interior stripes) and activity equal the JAX
    kernel's, which computes them, and the plain version's."""
    cells = still_lifes_and_blinkers(2048, 128)
    assert ref.ph._plan_2d((1024, 2), 6, 256, True)[4] == JAX_EDGE_PLAN.stripe_h
    got = port_chunk(cells, (2, 2), "conway", JAX_EDGE_PLAN, 8)
    assert_same(got, jax_chunk(ref, cells, (2, 2), "conway", 6, 256, 8))
    assert got[1] == 7 * 4 * 2 and cuda_halo.tile_mega_launch_mirror.elided == 7 * 4 * 2
    monkeypatch.setattr(cuda_halo, "tile_mega_launch_plain", PLAIN_K15)
    assert_same(port_chunk(cells, (2, 2), "conway", JAX_EDGE_PLAN, 8), got)


@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
def test_elision_on_64_row_tiles_keeps_the_plain_counts(monkeypatch, k15_mirror, rule):
    """The same on (2, 2) 64-row tiles with 16-row stripes (T = 6), where
    the JAX package builds no 2-D megakernel: the mirror elides both edge
    stripes of every tile on launches 1-7, and board, skip count and
    activity equal the plain version's (the JAX kernel's decisions)."""
    cells = still_lifes_and_blinkers(128, 256)
    got = port_chunk(cells, (2, 2), rule, EDGE_PLAN, 8)
    assert cuda_halo.tile_mega_launch_mirror.elided == 7 * 4 * 2
    monkeypatch.setattr(cuda_halo, "tile_mega_launch_plain", PLAIN_K15)
    want = port_chunk(cells, (2, 2), rule, EDGE_PLAN, 8)
    assert_same(got, want)
    assert want[1] == 7 * 4 * 2


CORNER_CASES = {"jax-256-row-stripes": ((1024, 2), JAX_EDGE_PLAN),
                "16-row-stripes": ((64, 4), EDGE_PLAN)}


def corner_glider(tile: tuple[int, int], mesh_shape) -> np.ndarray:
    """A board of (h, wpl)-word tiles with one glider and nothing else,
    eight cells up and left of tile (0, 0)'s bottom-right corner, heading
    for tile (1, 1) across that corner."""
    h, wpl = tile
    b = np.zeros((mesh_shape[0] * h, mesh_shape[1] * wpl * 32), dtype=bool)
    _put(b, GLIDER_SE, h - 8, wpl * 32 - 8)
    return b


@pytest.mark.parametrize("case", list(CORNER_CASES), ids=list(CORNER_CASES))
@pytest.mark.parametrize("rule", ["conway", "highlife"])
def test_corner_glider_makes_the_diagonal_tile_compute_its_edge(ref, monkeypatch, k15_mirror,
                                                              rule, case):
    """A lone glider near the bottom-right corner of tile (0, 0) of a
    (2, 4) mesh, T = 6: from launch 1 on, stripe 0 of tile (1, 1), which it
    will enter across the corner, finds activity in its 3x3-tile
    neighbourhood only in the NW tile's last stripe, and computes, while
    quiet edge stripes elsewhere are elided.
    Board, skip count and activity equal the plain version's, and at the
    JAX plan's stripes the JAX kernel's."""
    tile, plan = CORNER_CASES[case]
    cells = corner_glider(tile, (2, 4))
    grid = plan.grid(tile[0])
    elided = []
    got = port_chunk(cells, (2, 4), rule, plan, 8, each=lambda out, st: elided.append(
        cuda_halo.tile_mega_launch_mirror.last_elided.view(8, grid).clone()))
    if plan is JAX_EDGE_PLAN:
        assert_same(got, jax_chunk(ref, cells, (2, 4), rule, 6, 256, 8))
    monkeypatch.setattr(cuda_halo, "tile_mega_launch_plain", PLAIN_K15)
    assert_same(port_chunk(cells, (2, 4), rule, plan, 8), got)
    assert not any(bool(e[4 + 1, 0]) for e in elided[1:])  # tile (1, 1), stripe 0
    assert all(e.any() for e in elided[1:])


def test_frontier_reg_plan_takes_the_least_fresh_cost():
    """``frontier_reg_plan``: column groups of 30 words, the row tile a
    divisor of the stripe whose window (the tile and T + 6 rows a side)
    fits its warps, each thread keeping gen T in shared memory, and of the
    candidates the least ``RegPlan.cost`` on 132 SMs: path (h)'s four
    stacked 8192 x 256-word tiles take 256-row tiles of 10 warps, path
    (k)'s 4096 x 512-word strip 128-row tiles of 6."""
    plan = cuda_adaptive.frontier_reg_plan
    h = plan((4 * 8192, 256), 256, 24, 132)
    k = plan((4096, 512), 256, 24, 132)
    assert (h.tile_h, h.warps, h.grid, h.t, h.halo, h.keep) == (256, 10, (128, 9), 30, 30, True)
    assert (k.tile_h, k.warps, k.grid) == (128, 6, (32, 18))
    assert h.smem_bytes == cuda_adaptive.REG_EDGE_BYTES + 10 * 32 * 32 * 4
    for shape, stripe, t in (((256, 4), 32, 18), ((64, 2), 16, 6), ((4096, 512), 16, 6)):
        p = plan(shape, stripe, t, 132)
        assert stripe % p.tile_h == 0 and p.warps * 32 >= p.tile_h + 2 * (t + 6)
        assert p.grid == (shape[0] // p.tile_h, -(-shape[1] // 30))
        others = [cuda_adaptive.RegPlan(t + 6, t + 6, d, -(-(d + 2 * t + 12) // 32),
                                        (shape[0] // d, p.grid[1]), keep=True)
                  for d in range(1, stripe + 1) if stripe % d == 0 and d + 2 * t + 12 <= 512]
        assert p.cost(132) == min(o.cost(132) for o in others)
    with pytest.raises(ValueError):
        plan((256, 4), 32, 30, 132)  # T + 6 = 36 > one border word


# -- the sharded dispatch ------------------------------------------------------------------


def sharded(p: torch.Tensor, mesh_shape):
    m = tmesh.make_mesh(mesh_shape, [CPU] * (mesh_shape[0] * mesh_shape[1]))
    return m, halo.board_sharding(m).shard(p)


@pytest.mark.parametrize("full,k13", [(8, 0), (12, 16)], ids=["chunk", "chunk-and-tail"])
def test_dispatch_on_the_tier(monkeypatch, plain_calls, full, k13):
    """``make_superstep`` on a (2, 2) CPU mesh with the policy answering as
    it does on one card: ``full`` launches of T = 18 on 32-row stripes (one
    8-launch K15 chunk, and with 12 a 4-launch K13 tail a tile from a zero
    bitmap), then a K10 and a K9 remainder a tile.  The board is the
    straight one; without a tail the skip count and activity are the
    virtual build's; the tail's are added from its own K13 launches."""
    monkeypatch.setattr(cuda_halo, "tier_policy", lambda *a, **k: (True, "in-kernel"))
    plan = TILE_PLANS["T18-s32"]
    monkeypatch.setattr(cuda_halo, "adaptive_tile_plan", lambda *a, **k: (plan, 1))
    p = packed_of(mesh_board("glider_corner", (128, 4)).astype(np.uint8) * 255)
    m, sb = sharded(p, (2, 2))
    turns = full * 18 + 12 + 5
    out, sk, act = cuda_halo.make_superstep(m, tlife.CONWAY, True, 0, True)(sb, turns)
    assert torch.equal(out.gather(), tpacked.superstep(p, tlife.CONWAY, turns))
    n = plain_calls
    # K10's plain version is K9's: 4 K10 remainders count 4 K9 calls more.
    assert (n["K15"], n["K13"], n["K10"], n["K9"]) == (8, k13, 4, 8)
    assert act.shape == (2 * 4, 2)
    vb, vsk, vact = cuda_halo.make_superstep_virtual_2d((2, 2), tlife.CONWAY, 0, True)(
        p, 8 * 18)
    if full == 8:
        assert int(sk) == int(vsk) and torch.equal(act, vact)
    else:
        chunk = halo.board_sharding(m).shard(vb)
        _, tsk, tact = cuda_halo.tile_probing_launches(chunk, tlife.CONWAY, plan, 1, 4)
        assert int(sk) == int(vsk) + int(tsk) and torch.equal(act, vact + tact)


def test_dispatch_forced_off_runs_k13(monkeypatch, plain_calls):
    """``in_kernel=False`` outranks the one-card policy: the same dispatch
    on K13 with its exchange between launches, the same board."""
    monkeypatch.setattr(cuda_halo, "adaptive_tile_plan",
                        lambda *a, **k: (TILE_PLANS["T18-s32"], 1))
    p = packed_of(mesh_board("glider_corner", (128, 4)).astype(np.uint8) * 255)
    m, sb = sharded(p, (2, 2))
    out = cuda_halo.make_superstep(m, tlife.CONWAY, True, 0, False, False)(sb, 8 * 18)
    assert torch.equal(out.gather(), tpacked.superstep(p, tlife.CONWAY, 8 * 18))
    assert plain_calls["K13"] == 32 and not plain_calls["K15"]


# -- the policy ------------------------------------------------------------------------------


def cpu_mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * (shape[0] * shape[1]))


@pytest.mark.parametrize("shape,kw,env", [
    ((2, 2), {}, None),
    ((2, 4), dict(in_kernel=True), None),
    ((1, 2), {}, None),
    ((2, 2), dict(in_kernel=False), None),
    ((2, 2), {}, "0"),
    ((2, 2), dict(strip=(16, 2)), None),
    ((2, 2), dict(strip=(16, 2), in_kernel=False), None),
], ids=["interpret", "interpret-capability", "one-row", "forced", "env", "no-plan",
        "forced-before-plan"])
def test_policy_matches_ici_tier_policy(monkeypatch, ref, shape, kw, env):
    """On CPU 2-D meshes both packages give the same answer (the JAX one
    in interpret mode): the forced reasons, the missing plan, and the
    interpret-mode reason, which ``in_kernel=True`` does not outrank."""
    if env is None:
        monkeypatch.delenv("DGOL_ICI", raising=False)
    else:
        monkeypatch.setenv("DGOL_ICI", env)
    want = ref.ph.ici_tier_policy(ref.make_mesh(shape), interpret=True, **kw)
    assert cuda_halo.tier_policy(cpu_mesh(shape), **kw) == want
    assert not want[0]


def card(*indices):
    return [torch.device("cuda", i) for i in indices]


@pytest.mark.parametrize("shape,devices,kw,reach,want", [
    ((2, 2), card(0, 0, 0, 0), {}, True, "in-kernel"),
    ((2, 4), card(*[0] * 8), {}, True, "in-kernel"),
    ((1, 2), card(0, 0), {}, True, "in-kernel"),
    ((2, 2), card(0, 0, 0, 0), dict(strip=(8192, 256)), True, "in-kernel"),
    ((2, 2), card(0, 0, 0, 0), dict(in_kernel=False), True, "forced-ppermute (in_kernel=False)"),
    ((2, 2), card(0, 1, 0, 1), {}, True, "in-kernel"),
    ((2, 2), card(0, 1, 2, 3), dict(in_kernel=True), False,
     "no CUDA peer access from cuda:0 to cuda:1"),
    ((2, 4), card(*[0] * 8), dict(strip=(64, 2), tile_cap=16), True, "no frontier plan"),
], ids=["one-card", "one-card-2x4", "one-card-1x2", "one-card-plan", "forced", "two-cards",
        "four-cards-forced-in", "no-plan"])
def test_policy_on_cards(monkeypatch, shape, devices, kw, reach, want):
    """On device descriptors (no card needed; ``reach`` replaces the
    peer-access check): a 2-D mesh whose tiles share one card, or lie on
    cards that reach each other (the peer form), takes the tier; cards
    that cannot give the reason naming both; no reason names B12 or
    B10p."""
    monkeypatch.delenv("DGOL_ICI", raising=False)
    monkeypatch.setattr(cuda_halo, "peer_access", lambda card, peer: reach)
    use, reason = cuda_halo.tier_policy(tmesh.make_mesh(shape, devices), **kw)
    assert use == (reason == "in-kernel")
    assert want in reason and "B12" not in reason and "B10p" not in reason


# -- the slice end to end ------------------------------------------------------------------


def test_run_on_the_tier_writes_the_jax_pgm(monkeypatch, tmp_path, plain_calls):
    """``gol.run`` on a (2, 2) mesh with the policy answering as it does on
    one card (CPU shards otherwise take the ppermute tier): the Backend
    records the in-kernel tier, each 200-turn dispatch runs one 8-launch
    K15 chunk (T = 24 on 256-row stripes of 512-row tiles) and a K10 and a
    K9 remainder a tile (the controller's probes add K9 launches), and the
    run writes the PGM of the JAX package's run (on its ppermute tier
    there)."""
    import distributed_gol_tpu as jgol
    from distributed_gol_torch.engine.session import Session as TSession
    from distributed_gol_tpu.engine.session import Session as JSession
    from tests.test_torch_run import SOUP, pgms, run

    monkeypatch.setattr(cuda_halo, "tier_policy", lambda *a, **k: (True, "in-kernel"))
    kw = dict(turns=2 * 200, superstep=200, image_height=1024, image_width=128,
              engine="pallas-packed", skip_stable=True, mesh_shape=(2, 2), turn_events="batch",
              **SOUP)
    t_events, t_out = run(tgol, tmp_path, "torch", None, TSession(), **kw)
    _, j_out = run(jgol, tmp_path, "jax", None, JSession(), **kw)
    assert pgms(t_out) == pgms(j_out)
    report = dict([f for n, f in t_events if n == "MetricsReport"][0])
    assert report["info"]["backend.sharded_tier"] == "ici-megakernel"
    assert report["info"]["backend.sharded_tier_policy"] == "in-kernel"
    n = plain_calls
    assert (n["K15"], n["K13"], n["K10"]) == (16, 0, 8) and n["K9"] >= 8


@pytest.mark.parametrize("policy,want", [(None, False), ((True, "in-kernel"), True)],
                         ids=["interpret-reason", "one-card"])
def test_backend_hands_its_tier_down(monkeypatch, policy, want):
    """On a 2-D mesh too the Backend asks the policy once and gives its
    answer to the engine as ``in_kernel``."""
    if policy is not None:
        monkeypatch.setattr(cuda_halo, "tier_policy", lambda *a, **k: policy)
    seen = {}
    real = cuda_halo.make_superstep_bytes

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(cuda_halo, "make_superstep_bytes", spy)
    be = Backend(tgol.Params(device="cpu", image_height=1024, image_width=128,
                             engine="pallas-packed", skip_stable=True, mesh_shape=(2, 2)))
    assert seen["in_kernel"] is want
    assert be.sharded_tier == ("ici-megakernel" if want else "ppermute")


# -- on the card -----------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def chunk_on(tiles, plan, rule, nlaunch, plain=False, each=None):
    out, st = cuda_halo.tile_mega_launches(tiles, rule, plan, nlaunch, plain, each)
    return [t.cpu() for r in out for t in r], st.state.cpu(), st.skipped.cpu(), st.act.cpu()


def assert_same_chunk(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", list(TILE_PLANS.values()), ids=list(TILE_PLANS))
@pytest.mark.parametrize("kind", ["soup", "settled", "glider_corner"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (1, 2)], ids=["2x2", "2x4", "1x2"])
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
def test_gpu_k15_matches_plain(cuda_device, rule, mesh_shape, kind, plan):
    """The chunk on the card (its launcher once, one wrapper call a
    launch) against the plain chunk on the card and on the CPU: tiles,
    final state, skip counts and activity, and tiles and state launch by
    launch."""
    r = tlife.RULES[rule]
    p = packed_of(mesh_board(kind, (128, 4), mesh_shape).astype(np.uint8) * 255)
    tiles = tiles_of(p, mesh_shape)
    on_card = [[t.to(cuda_device) for t in row] for row in tiles]
    want = chunk_on(tiles, plan, r, 8)
    assert_same_chunk(chunk_on(on_card, plan, r, 8), want)
    assert_same_chunk(chunk_on(on_card, plan, r, 8, plain=True), want)
    seen = {}
    for key, ts in (("card", on_card), ("cpu", tiles)):
        seen[key] = []
        chunk_on(ts, plan, r, 8, each=lambda out, st, _s=seen[key]: _s.append(
            ([t.to(CPU, copy=True) for row in out for t in row], st.state.to(CPU, copy=True))))
    for (a, sa), (b, sb) in zip(seen["card"], seen["cpu"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(sa, sb)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["settled-16-row-stripes", "corner-glider"])
def test_gpu_k15_matches_its_mirror_where_it_elides(cuda_device, monkeypatch, case):
    """K15 on the card against its mirror on the CPU where edge stripes are
    elided: still lifes and blinkers on 64-row tiles with 16-row stripes,
    and the lone corner glider on (2, 4) 64 x 4-word tiles; tiles and
    state launch by launch."""
    cells, mesh_shape = ((still_lifes_and_blinkers(128, 256), (2, 2))
                         if case.startswith("settled") else
                         (corner_glider((64, 4), (2, 4)), (2, 4)))
    p = packed_of(cells.astype(np.uint8) * 255)
    tiles = tiles_of(p, mesh_shape)
    on_card = [[t.to(cuda_device) for t in row] for row in tiles]
    seen = {}
    for key, ts in (("card", on_card), ("cpu", tiles)):
        if key == "cpu":
            monkeypatch.setattr(cuda_halo, "tile_mega_launch_plain",
                                cuda_halo.tile_mega_launch_mirror)
        seen[key] = []
        chunk_on(ts, EDGE_PLAN, tlife.CONWAY, 8, each=lambda out, st, _s=seen[key]: _s.append(
            ([t.to(CPU, copy=True) for row in out for t in row], st.state.to(CPU, copy=True))))
    for (a, sa), (b, sb) in zip(seen["card"], seen["cpu"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(sa, sb)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (2, 4)], ids=["2x2", "1x2", "2x4"])
def test_gpu_virtual_build_matches_the_cpu(cuda_device, mesh_shape):
    b = mesh2d_board()
    got = port_virtual(b, mesh_shape, TURNS[1], device=cuda_device)
    want = port_virtual(b, mesh_shape, TURNS[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.gpu
def test_gpu_backend_on_a_virtual_2d_mesh(cuda_device, monkeypatch, tmp_path):
    """On a virtual (2, 2) mesh of the card the Backend records the
    in-kernel tier; ``DGOL_ICI=0`` records the ppermute tier."""
    monkeypatch.delenv("DGOL_ICI", raising=False)
    params = tgol.Params(image_height=1024, image_width=128, skip_stable=True, mesh_shape=(2, 2),
                         out_dir=tmp_path)
    devices = [cuda_device] * 4
    be = Backend(params, devices)
    assert (be.sharded_tier, be.sharded_tier_policy) == ("ici-megakernel", "in-kernel")
    monkeypatch.setenv("DGOL_ICI", "0")
    env = Backend(params, devices)
    assert (env.sharded_tier, env.sharded_tier_policy) == (
        "ppermute", "forced-ppermute (DGOL_ICI=0)")


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [(96, 128), (96, 256)], ids=["narrow", "shipped"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_gpu_k15_tiers_match_plain_and_mirror(cuda_device, monkeypatch, mesh_shape, geometry):
    """K15's compute tiers on the card: ``test_torch_tile_tiers``' sparse
    boards with their tile gliders (320-word tiles, T = 18 on 256-row
    stripes) under the (96, 128) geometry, where the rectangle route runs,
    and the shipped one, against the plain version on the card launch by
    launch (tiles, the whole state, skip counts, activity, and the routes
    with the edge stripes K15 elides as the full route the plain version
    forces) and against the mirror on the card (the routes exactly)."""
    from test_torch_tile_tiers import BOARDS, STRIPE, W

    from distributed_gol_torch.testing.boards import sparse_board

    h, slots = BOARDS[mesh_shape]
    p = packed_of(sparse_board(h, W, STRIPE, slots, mesh_shape), cuda_device)
    plan = cuda_adaptive.AdaptivePlan(18, STRIPE, True)
    seen = {}
    with cuda_adaptive.plan_geometry_override(geometry):
        for key in ("card", "plain", "mirror"):
            if key == "mirror":
                monkeypatch.setattr(cuda_halo, "tile_mega_launch_plain",
                                    cuda_halo.tile_mega_launch_mirror)
            seen[key] = []
            chunk_on(tiles_of(p, mesh_shape), plan, tlife.CONWAY, 8, key != "card",
                     lambda out, st, _s=seen[key]: _s.append(
                         ([t.to(CPU, copy=True) for row in out for t in row],
                          *(x.to(CPU, copy=True) for x in (st.state, st.skipped, st.act,
                                                            st.route)))))
    for card, plain, mirror in zip(*seen.values()):
        assert all(torch.equal(x, y) for x, y in zip(card[0], plain[0]))
        assert all(torch.equal(x, y) for x, y in zip(card[1:4], plain[1:4]))
        assert torch.equal(torch.where(card[4] == cuda_adaptive.ROUTE_ELIDED,
                                       cuda_adaptive.ROUTE_FULL, card[4]), plain[4])
        assert torch.equal(card[4], mirror[4])
    routes = torch.stack([r[4] for r in seen["card"]]).unique().tolist()
    assert (cuda_adaptive.ROUTE_TIER in routes) == (geometry == (96, 128))
