"""K15's compute tiers against the JAX package's 2-D megakernel.

``cuda_halo.tile_mega_routes`` (each stripe's nine neighbours, their
column intervals moved by -/+ wpl into its tile's words, and its route)
against ``_hit_union``, ``_frontier_placement`` and ``_col_placement`` on
the nine intervals ``_kernel_frontier_mega_2d`` builds, under every plan
geometry; the forced stripes (launch 0, the tiles' edge stripes), which
take the full route under every geometry; then K15's plain version and
its block mirror over a chunk of 8 launches against
``_build_dispatch_frontier_2d``'s virtual build in interpret mode, on a
(1, 2) and a (2, 2) mesh of 320-word tiles of
``testing.boards.sparse_board`` with its tile gliders, under the (96, 128)
geometry (both packages' override), where the 128-word column window
engages, and under the shipped one, where it does not.  Boards, skip
counts and activity are compared exactly, the route record shows each
route on named stripes, and the mirror's state and routes equal the plain
version's launch by launch.  The JAX package is imported inside the
tests."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive as ca
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.parallel import cuda_halo
from distributed_gol_torch.testing.boards import sparse_board

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

EMPTY = ca._EMPTY_LO
T, STRIPE, NLAUNCH = 18, 256, 8
W = 20480  # cells: two tiles of 320 words, each hosting the 128-word column window
NARROW = (96, 128)
SHIPPED = tuple(ca.geometry_candidates()[0])
# A mesh's board: its rows and the slots of ``sparse_board`` it holds.
BOARDS = {(1, 2): (1536, ("spark",)), (2, 2): (2048, ("mid", "spark"))}
# The routes named stripes (tile, stripe) take over a chunk under (96,
# 128) ("after": a skip right after a rectangle): the seam glider's
# stripe the row tier (its column union reaches past the tile), the
# spark's the rectangle route until it dies, the edge stripe with the
# seam and corner gliders the full route, a quiet stripe beside them skip.
EXPECTED = {(1, 2): {(0, 1): {"row"}, (0, 3): {"tier", "after"}, (0, 5): {"full"},
                     (0, 2): {"skip"}},
            (2, 2): {(0, 1): {"row"}, (2, 2): {"tier", "after"}, (0, 3): {"full"},
                     (2, 1): {"skip"}}}


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed, pallas_packed
    from distributed_gol_tpu.parallel import pallas_halo

    return SimpleNamespace(jnp=jnp, life=life, packed=packed, pp=pallas_packed, ph=pallas_halo)


@contextlib.contextmanager
def both_geometries(ref, geometry):
    with ca.plan_geometry_override(geometry), ref.pp.plan_geometry_override(geometry):
        yield


def geometry(label: str) -> ca.PlanGeometry:
    return next(g for g in ca.geometry_candidates() if g.label == label)


# -- the decisions --------------------------------------------------------------------


def random_state(rng, n: int, grid: int, h: int, wpl: int) -> torch.Tensor:
    """A previous launch's int64 (10, n·grid) state of n tiles of ``grid``
    stripes of h // grid rows and wpl words: in each stripe two row
    intervals inside it (each empty in 6 of 7 stripes) and a column
    interval in its tile's words a few words wide (empty where both row
    intervals are); the change rectangles the whole centre."""
    sh = h // grid
    total = n * grid
    i = np.arange(total) % grid
    st = np.zeros((10, total), dtype=np.int64)
    for k in (0, 1):
        lo = i * sh + rng.integers(0, sh, total)
        hi = np.minimum(lo + rng.integers(0, 40, total), (i + 1) * sh - 1)
        empty = rng.random(total) < 6 / 7
        st[2 * k], st[2 * k + 1] = np.where(empty, EMPTY, lo), np.where(empty, -1, hi)
    lo = rng.integers(0, wpl, total)
    hi = np.minimum(lo + rng.integers(0, 6, total), wpl - 1)
    quiet = (st[0] > st[1]) & (st[2] > st[3])
    st[4], st[5] = np.where(quiet, EMPTY, lo), np.where(quiet, -1, hi)
    st[6], st[7], st[8], st[9] = i * sh // 8, sh // 8, 0, wpl // 128
    return torch.from_numpy(st)


def jax_nine(prev: np.ndarray, v: int, i: int, mesh_shape, grid: int, wpl: int):
    """The nine (rows, columns) of stripe i of tile v as
    ``_kernel_frontier_mega_2d`` builds them (``pallas_halo.py:1478-1496``):
    its own stripes max(i - 1, 0), i, min(i + 1, grid - 1), then the same
    of the W and E tiles, their column entries moved by -wpl and +wpl."""
    ny, nx = mesh_shape
    dy, dx = divmod(v, nx)
    ivals, cvals = [], []
    stripes = (max(i - 1, 0), i, min(i + 1, grid - 1))
    for tile, coff in ((v, 0), (dy * nx + (dx - 1) % nx, -wpl), (dy * nx + (dx + 1) % nx, wpl)):
        for j in stripes:
            g = tile * grid + j
            ivals += [(prev[0, g], prev[1, g]), (prev[2, g], prev[3, g])]
            cvals.append((prev[4, g] + coff, prev[5, g] + coff))
    return ivals, cvals


def jax_route(ref, hit, u_lo, u_hi, u_clo, u_chi, i, plan, shape, sub_rows, cwin):
    """The JAX kernel's route of stripe i (``ROUTE_*``) and its measure rows
    in the tile's frame: skip where it does not hit, the rectangle route
    where ``rect_ok`` holds (``:1565-1580``), else ``_frontier_body``'s
    row tier where its placement is eligible, else the full window."""
    jnp = ref.jnp
    h, wpl = shape
    pad = plan.pad_f
    win_lo, m_lo, m_hi, ok = ref.pp._frontier_placement(
        jnp.int32(u_lo), jnp.int32(u_hi), i, plan.stripe_h, pad, plan.t, sub_rows)
    g_lo = i * plan.stripe_h - pad + int(win_lo)
    rect = False
    if cwin is not None:
        _, c_ok, _ = ref.pp._col_placement(jnp.int32(u_clo), jnp.int32(u_chi), plan.t, cwin, wpl)
        rect = bool(hit and ok and c_ok and g_lo >= 0 and g_lo + sub_rows <= h)
    route = (ca.ROUTE_SKIP if not hit else ca.ROUTE_TIER if rect
             else ca.ROUTE_ROW if bool(ok) else ca.ROUTE_FULL)
    w_lo = i * plan.stripe_h - pad
    return route, int(m_lo) + w_lo, int(m_hi) + w_lo


@pytest.mark.parametrize("label", [g.label for g in ca.geometry_candidates()])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (2, 3)], ids=["2x2", "1x2", "2x3"])
def test_decisions_match_jax(ref, mesh_shape, label):
    """On 40 seeded previous states of a mesh of 1024 x 320-word tiles
    (T = 18, 256-row stripes): every interior stripe's hit and unions, its
    route and its measure rows from ``tile_mega_routes`` equal
    ``_hit_union``, ``_frontier_placement`` and ``_col_placement`` on the
    nine intervals the JAX kernel builds, whose W and E column entries
    move by -/+ wpl (on (1, 2) the one other tile at both shifts); every
    route is seen; and no stripe writes, measures or copies a cell outside
    its tile."""
    geom = geometry(label)
    ny, nx = mesh_shape
    shape = (1024, 320)
    h, wpl = shape
    plan = ca.AdaptivePlan(T, STRIPE, True)
    grid = plan.grid(h)
    rng = np.random.default_rng(ny * 10 + nx + len(label))
    seen = set()
    with both_geometries(ref, geom):
        sub_rows, cwin = ca.frontier_geometry(plan, shape)
        assert ref.ph._plan_2d(shape, T, STRIPE, True)[2:] == (sub_rows, cwin, STRIPE)
        for _ in range(40):
            prev = random_state(rng, ny * nx, grid, h, wpl)
            rt, union, _ = cuda_halo.tile_mega_routes(prev, mesh_shape, shape, plan, False)
            p = prev.numpy()
            for v in range(ny * nx):
                for i in range(1, grid - 1):
                    g = v * grid + i
                    ivals, cvals = jax_nine(p, v, i, mesh_shape, grid, wpl)
                    c_lo = i * STRIPE
                    want = ref.pp._hit_union(
                        [(ref.jnp.int32(a), ref.jnp.int32(b)) for a, b in ivals],
                        [(ref.jnp.int32(a), ref.jnp.int32(b)) for a, b in cvals],
                        c_lo - plan.pad_f, c_lo + STRIPE - 1 + plan.pad_f, c_lo,
                        c_lo + STRIPE - 1, T + 6)
                    assert [int(u[g]) for u in union] == [int(w) for w in want]
                    route, m_lo, m_hi = jax_route(ref, *(int(w) for w in want), i, plan, shape,
                                                  sub_rows, cwin)
                    assert int(rt.route[g]) == route
                    assert (int(rt.m_lo[g]), int(rt.m_hi[g])) == (m_lo, m_hi)
                    seen.add(route)
            for lo, hi, limit in ((rt.w_lo, rt.w_hi, h), (rt.v_lo, rt.v_hi, h),
                                  (rt.wc_lo, rt.wc_hi, wpl), (rt.vc_lo, rt.vc_hi, wpl)):
                assert (lo >= 0).all() and (hi <= limit).all()
            copy = ca.rect_region(rt.rect, plan, shape)
            assert (copy[0] >= 0).all() and (copy[1] <= h).all()
            assert (copy[2] >= 0).all() and (copy[3] <= wpl).all()
    want = {ca.ROUTE_SKIP, ca.ROUTE_ROW, ca.ROUTE_FULL}
    assert want | ({ca.ROUTE_TIER} if cwin else set()) == seen


def test_one_other_tile_is_seen_at_both_shifts():
    """On a (1, 2) mesh each tile's W and E neighbour is the other tile: with
    stripe 1 of tile 0 at words [50, 52] and stripe 1 of tile 1 at [100,
    104], tile 0's stripe sees tile 1's at [100 - wpl, 104 - wpl] and
    [100 + wpl, 104 + wpl] beside its own, so its column union is [100 -
    wpl, 104 + wpl]; tile 1's is [50 - wpl, 52 + wpl]."""
    shape = (1024, 320)
    plan = ca.AdaptivePlan(T, STRIPE, True)
    prev = torch.zeros((10, 8), dtype=torch.int64)
    prev[0:6] = torch.tensor([EMPTY, -1, EMPTY, -1, EMPTY, -1])[:, None]
    prev[0:6, 1] = torch.tensor([300, 310, EMPTY, -1, 50, 52])
    prev[0:6, 5] = torch.tensor([300, 310, EMPTY, -1, 100, 104])
    _, (hit, _, _, u_clo, u_chi), _ = cuda_halo.tile_mega_routes(prev, (1, 2), shape, plan,
                                                                 False)
    assert bool(hit[1]) and (int(u_clo[1]), int(u_chi[1])) == (100 - 320, 104 + 320)
    assert bool(hit[5]) and (int(u_clo[5]), int(u_chi[5])) == (50 - 320, 52 + 320)


@pytest.mark.parametrize("label", [g.label for g in ca.geometry_candidates()])
def test_forced_stripes_take_the_full_route(ref, label):
    """A forced stripe (launch 0 of a chunk, or a tile's edge stripe) takes
    the full route under every geometry, at every depth and stripe height
    whose row tier fits: the JAX kernel's forced union (T + 6 rows past the
    centre on both sides) never places its row window, and
    ``tile_mega_routes`` gives launch 0's stripes and the plain version's
    edge stripes the full route with the maximal measure rows; the mirror's
    edge stripes are full or, where their nine do not hit, elided."""
    geom = geometry(label)
    rng = np.random.default_rng(len(label))
    with both_geometries(ref, geom):
        for turns in (6, 12, 18, 24):
            for stripe in (64, 128, 192, 256, 512):
                plan = ca.AdaptivePlan(turns, stripe, ca._round8(turns + 6) <= stripe)
                sub_rows, _ = ca.frontier_geometry(plan, (4 * stripe, 512))
                if sub_rows is None:
                    continue
                t6 = turns + 6
                for i in range(4):
                    c_lo = i * stripe
                    win = ref.pp._frontier_placement(ref.jnp.int32(c_lo - t6),
                                                     ref.jnp.int32(c_lo + stripe - 1 + t6), i,
                                                     stripe, plan.pad_f, turns, sub_rows)
                    assert not bool(win[3])
                prev = random_state(rng, 4, 4, 4 * stripe, 512)
                for first in (True, False):
                    for elide in (False, True):
                        rt, (hit, *_), elided = cuda_halo.tile_mega_routes(
                            prev, (2, 2), (4 * stripe, 512), plan, first, elide)
                        forced = torch.ones(16, dtype=torch.bool) if first else (
                            torch.arange(16) % 4 == 0) | (torch.arange(16) % 4 == 3)
                        want = torch.where(elided, ca.ROUTE_ELIDED, ca.ROUTE_FULL)
                        assert torch.equal(rt.route[forced], want[forced])
                        quiet = forced & ~hit if elide and not first else torch.zeros_like(hit)
                        assert torch.equal(elided, quiet)
                        c_lo = torch.arange(16) % 4 * stripe
                        assert torch.equal(rt.m_lo[forced], c_lo[forced])
                        assert torch.equal(rt.m_hi[forced], (c_lo + stripe - 1)[forced])
                        assert (rt.rect[1][forced] == stripe // 8).all()


# -- K15's chunk against _build_dispatch_frontier_2d -------------------------------------


def words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def tiles_of(p: torch.Tensor, mesh_shape) -> list[list[torch.Tensor]]:
    ny, nx = mesh_shape
    return [[t.contiguous() for t in r.chunk(nx, dim=1)] for r in p.chunk(ny)]


def route_names(routes: torch.Tensor) -> set:
    seq = routes.tolist()
    names = {ca.ROUTES[r] for r in seq}
    if any(a == ca.ROUTE_TIER and b == ca.ROUTE_SKIP for a, b in zip(seq, seq[1:])):
        names.add("after")
    return names


def jax_chunk(ref, p: torch.Tensor, mesh_shape):
    """``_build_dispatch_frontier_2d``'s virtual chunk of NLAUNCH launches
    (interpret mode, T = 18, 256-row stripes) on the packed board ``p``:
    (board, skipped, (ny·grid, nx) activity)."""
    ny, nx = mesh_shape
    strip = (p.shape[0] // ny, p.shape[1] // nx)
    grid = strip[0] // ref.ph._plan_2d(strip, T, STRIPE, True)[4]
    call = ref.ph._build_dispatch_frontier_2d(strip, mesh_shape, ref.life.CONWAY, T, NLAUNCH,
                                              True, STRIPE, False)
    pw = ref.jnp.asarray(words(p))
    na, nb, sk, act = call(pw, ref.jnp.zeros_like(pw))
    act = np.asarray(act).reshape(ny, nx, grid).transpose(0, 2, 1).reshape(ny * grid, nx)
    return np.asarray(nb if NLAUNCH % 2 else na), int(sk[0]), act


def port_chunk(p: torch.Tensor, mesh_shape, launch):
    """K15's chunk with ``launch`` as the wrapper's CPU path: (board,
    skipped, (ny·grid, nx) activity) and the launches' records (tiles,
    state, routes, skip counts, activity)."""
    seen = []
    saved = cuda_halo.tile_mega_launch_plain
    cuda_halo.tile_mega_launch_plain = launch
    try:
        tiles, st = cuda_halo.tile_mega_launches(
            tiles_of(p, mesh_shape), tlife.CONWAY, ca.AdaptivePlan(T, STRIPE, True), NLAUNCH,
            each=lambda out, s: seen.append(([t.clone() for r in out for t in r], s.state.clone(),
                                             s.route.clone(), s.skipped.clone(), s.act.clone())))
    finally:
        cuda_halo.tile_mega_launch_plain = saved
    board = torch.cat([torch.cat(r, dim=1) for r in tiles])
    return (words(board), int(st.skipped.sum()),
            cuda_halo.tile_activity(st.act, *mesh_shape).numpy()), seen


@pytest.mark.parametrize("label", ["m96c128", "m96c256"], ids=["narrow", "shipped"])
@pytest.mark.parametrize("mesh_shape", list(BOARDS), ids=["1x2", "2x2"])
def test_chunk_matches_jax(ref, mesh_shape, label):
    """K15's plain version and block mirror over a chunk of 8 launches on
    the mesh's sparse board with its tile gliders, against the JAX virtual
    build in interpret mode: board, skip count and activity, tolerance 0.
    Under (96, 128) the named stripes take the routes of ``EXPECTED``;
    under the shipped geometry the 320-word tiles host no column window, so
    no stripe takes the rectangle route and the spark's takes the row tier.
    Launch 0 is full everywhere.  The mirror's tiles, state, skip counts
    and activity equal the plain version's launch by launch, and its routes
    where it does not elide an edge stripe that the plain version forces
    (on (2, 2) it elides some)."""
    h, slots = BOARDS[mesh_shape]
    p = tpacked.pack(torch.from_numpy(sparse_board(h, W, STRIPE, slots, mesh_shape)))
    with both_geometries(ref, geometry(label)):
        want = jax_chunk(ref, p, mesh_shape)
        got, plain = port_chunk(p, mesh_shape, cuda_halo.tile_mega_launch_plain)
        mirrored, mirror = port_chunk(p, mesh_shape, cuda_halo.tile_mega_launch_mirror)
    for g in (got, mirrored):
        np.testing.assert_array_equal(g[0], want[0])
        assert g[1] == want[1]
        np.testing.assert_array_equal(g[2], want[2])
    assert len(plain) == len(mirror) == NLAUNCH
    elided = 0
    for (a, sa, ra, ka, aa), (b, sb, rb, kb, ab) in zip(plain, mirror):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(sa, sb) and torch.equal(ka, kb) and torch.equal(aa, ab)
        assert torch.equal(ra, torch.where(rb == ca.ROUTE_ELIDED, ca.ROUTE_FULL, rb))
        elided += int((rb == ca.ROUTE_ELIDED).sum())
    routes = torch.stack([r for _, _, r, _, _ in plain])
    assert (routes[0] == ca.ROUTE_FULL).all()
    grid = (h // mesh_shape[0]) // STRIPE
    names = {k: route_names(routes[:, k[0] * grid + k[1]]) for k in EXPECTED[mesh_shape]}
    if label == "m96c128":
        assert all(EXPECTED[mesh_shape][k] <= names[k] for k in names)
    else:
        assert ca.ROUTE_TIER not in routes.unique().tolist()
        assert all({n for n in EXPECTED[mesh_shape][k] if n not in ("tier", "after")} | (
            {"row"} if "tier" in EXPECTED[mesh_shape][k] else set()) <= names[k] for k in names)
    # On (1, 2) the seam gliders reach both edge stripes of each tile (the
    # torus' y seam is the tile row's); on (2, 2) tile row 1's last stripes
    # are quiet and elided.
    assert (elided > 0) == (mesh_shape == (2, 2))
