"""The frontier kernels' compute tiers in the port against the JAX package.

The decisions (``cuda_adaptive.hit_union``, ``frontier_placement``,
``col_placement``) and the measure (``measure2``) against
``_hit_union``, ``_frontier_placement``, ``_col_placement`` and
``_measure2`` on the same inputs, for every plan geometry; the rectangle
route's writes against ``_col_compute``'s merge; then K5's and K8's plain
versions and K5's block mirror against ``_build_dispatch_frontier``, K14's
chunk against ``_build_dispatch_frontier_strip`` (its loopback build) and
K12 against ``_build_ext_launch_frontier``, all in interpret mode, on the
sparse boards of ``distributed_gol_torch.testing.boards`` about 8192 cells
wide, where the 128-word column window engages (geometry (96, 128) under
both packages' override).  Boards, skip counts, activity and K12's six
interval arrays are compared exactly, and the route record shows that each
route ran.  The JAX package is imported inside the tests."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive as ca
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.parallel import cuda_halo
from distributed_gol_torch.testing.boards import SLOTS, sparse_board

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

EMPTY = ca._EMPTY_LO
T, STRIPE, NLAUNCH = 18, 256, 8
SHAPE = (1024, 256)  # words: four stripes, 8192 cells wide
NARROW = (96, 128)  # the geometry whose column window a 256-word board hosts


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


def words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def packed_board(slots, h=SHAPE[0]) -> torch.Tensor:
    return tpacked.pack(torch.from_numpy(sparse_board(h, SHAPE[1] * 32, STRIPE, slots)))


# -- the decisions and the measure -----------------------------------------------------


def neighbourhoods(rng, n: int, c_lo: int, stripe: int, wp: int):
    """``n`` random neighbourhoods of a stripe at row c_lo: six row
    intervals around it (a third of them empty) and three column pairs
    (a quarter empty)."""
    ivals, cvals = [], []
    for _ in range(6):
        lo = rng.integers(c_lo - 2 * stripe - 80, c_lo + 2 * stripe + 80, n)
        hi = lo + rng.integers(0, stripe + 16, n)
        empty = rng.random(n) < 1 / 3
        ivals.append((np.where(empty, EMPTY, lo), np.where(empty, -1, hi)))
    for _ in range(3):
        lo = rng.integers(0, wp, n)
        hi = np.minimum(lo + rng.integers(0, 40, n), wp - 1)
        empty = rng.random(n) < 1 / 4
        cvals.append((np.where(empty, EMPTY, lo), np.where(empty, -1, hi)))
    return ivals, cvals


@pytest.mark.parametrize("stripe", [16, 64, 256])
@pytest.mark.parametrize("turns", [12, 18, 24])
@pytest.mark.parametrize("geometry", ["m96c256", "m64c256", "m96c128", "m64c128"])
def test_decisions_match_jax(ref, geometry, turns, stripe):
    """``hit_union``, ``frontier_placement`` and ``col_placement`` against
    ``_hit_union``, ``_frontier_placement`` and ``_col_placement`` on the
    same 400 seeded neighbourhoods of stripe 3, every output exactly."""
    geom = next(g for g in ca.geometry_candidates() if g.label == geometry)
    plan = ca.AdaptivePlan(turns, stripe, ca._round8(turns + 6) <= stripe)
    jnp = ref.jnp
    rng = np.random.default_rng(turns * 1000 + stripe)
    i, wp = 3, 600
    c_lo = i * stripe
    ivals, cvals = neighbourhoods(rng, 400, c_lo, stripe, wp)
    t6, pad = turns + 6, plan.pad_f
    assert pad == ref.pp._round8(turns + ref.pp._SKIP_PERIOD)
    cl = torch.full((400,), c_lo, dtype=torch.int64)
    got = ca.hit_union([(torch.from_numpy(lo), torch.from_numpy(hi)) for lo, hi in ivals],
                       [(torch.from_numpy(lo), torch.from_numpy(hi)) for lo, hi in cvals],
                       cl, cl + stripe - 1, plan)
    want = ref.pp._hit_union([(jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32))
                              for lo, hi in ivals],
                             [(jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32))
                              for lo, hi in cvals],
                             c_lo - pad, c_lo + stripe - 1 + pad, c_lo, c_lo + stripe - 1, t6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.broadcast_to(np.asarray(w), (400,)))
    hit, u_lo, u_hi, u_clo, u_chi = got
    assert hit.any() and not hit.all()
    sub_rows = ca._round8(4 * turns + geom.sub_margin)
    got = ca.frontier_placement(u_lo, u_hi, cl, plan, sub_rows)
    want = ref.pp._frontier_placement(jnp.asarray(u_lo.numpy(), jnp.int32),
                                      jnp.asarray(u_hi.numpy(), jnp.int32), i, stripe, pad,
                                      turns, sub_rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for width in (2 * geom.col_window + 37, 1024):
        got = ca.col_placement(u_clo, u_chi, plan, geom.col_window, width)
        want = ref.pp._col_placement(jnp.asarray(u_clo.numpy(), jnp.int32),
                                     jnp.asarray(u_chi.numpy(), jnp.int32), turns,
                                     geom.col_window, width)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2] == want[2]
        assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("case", ["plain", "col_valid", "col_off", "empty", "one_row"])
def test_measure_matches_jax(ref, case):
    """``measure2`` against ``_measure2`` on a seeded (48, 40) window's
    cells in its measure rows (and ``col_valid`` words): its rows, split at
    the midpoint, and its words, with and without ``col_valid`` and
    ``col_off``."""
    rng = np.random.default_rng(len(case))
    g_t = rng.integers(0, 2**32, (48, 40), dtype=np.uint32)
    g_t6 = g_t.copy()
    flips = {"plain": [(5, 3), (6, 30), (40, 9)], "col_valid": [(10, 1), (20, 38), (30, 12)],
             "col_off": [(7, 7), (44, 2)], "empty": [], "one_row": [(22, 4), (22, 31)]}[case]
    for y, x in flips:
        g_t6[y, x] ^= 1 << (y % 32)
    kw = {"col_valid": dict(col_valid=(2, 36)), "col_off": dict(col_off=4096)}.get(case, {})
    base_row, m_lo, m_hi, frame_off = 8, 12, 50, -16
    rows = np.arange(48) + base_row
    cols = np.arange(40)
    hot = (g_t6 != g_t) & ((rows >= m_lo) & (rows <= m_hi))[:, None]
    if "col_valid" in kw:
        hot &= (cols >= 2) & (cols < 36)
    got = ca.measure2(torch.from_numpy(hot)[None], torch.from_numpy(rows + frame_off),
                      torch.from_numpy(cols + kw.get("col_off", 0)))
    want = ref.pp._measure2(ref.jnp.asarray(g_t), ref.jnp.asarray(g_t6), base_row, m_lo, m_hi,
                            frame_off, **kw)
    np.testing.assert_array_equal(got[:, 0].numpy(), [int(w) for w in want])


def test_rectangle_writes_match_col_compute(ref):
    """One K5 launch in which stripe 2 takes the rectangle route (its
    state put where its glider is): the cells it writes equal
    ``_col_compute``'s merge (gen T in the window's validity region, the
    input elsewhere) on the window's rows of its centre, its copy of the
    previous change rectangle (a column window of stripe 1's) holds the
    input, and every other cell of the written buffer is left as it was."""
    r = packed_board(("mid",))
    h, wp = SHAPE
    w = torch.from_numpy(np.random.default_rng(5).integers(
        -2**31, 2**31, SHAPE, dtype=np.int64).astype(np.int32))
    plan = ca.AdaptivePlan(T, STRIPE, True)
    ys, xs = np.nonzero(tpacked.unpack(r).numpy()[2 * STRIPE : 3 * STRIPE] != 0)
    ys, xs = ys[xs < 7 * wp * 4], xs[xs < 7 * wp * 4]  # the glider, not the ash (7/8 across)
    state = torch.zeros((10, 4), dtype=torch.int64)
    state[0], state[1] = EMPTY, -1
    state[2], state[3], state[4], state[5] = EMPTY, -1, EMPTY, -1
    state[0, 2], state[1, 2] = 2 * STRIPE + ys.min(), 2 * STRIPE + ys.max()
    state[4, 2], state[5, 2] = xs.min() // 32, xs.max() // 32
    state[6:10, 1] = torch.tensor([STRIPE // 8 + 3, 10, 1, 1])  # stripe 1's last rectangle
    with both_geometries(ref, NARROW):
        out, new, _, _, routes = ca.frontier_launch_mirror(r, w.clone(), tlife.CONWAY, plan, state)
        sub_rows, cwin = ca.frontier_geometry(plan, SHAPE)
    assert routes.tolist() == [ca.ROUTE_SKIP, ca.ROUTE_SKIP, ca.ROUTE_TIER, ca.ROUTE_SKIP]
    r8, n8, c128, n128 = new[6:10, 2].tolist()
    g_lo = next(g for g in range(2 * STRIPE - 24, 3 * STRIPE, 8)
                if r8 * 8 == max(g, 2 * STRIPE) and (r8 + n8) * 8 == min(g + sub_rows, 3 * STRIPE))
    win_c = c128 * 128
    assert n128 * 128 == cwin == 128
    cw = (T + 6 + 31) // 32
    _, _, merged = ref.pp._col_compute(
        ref.jnp.asarray(words(r)[g_lo : g_lo + sub_rows, win_c : win_c + cwin]), T,
        ref.life.CONWAY, cw, cwin, sub_rows)
    lo, hi = r8 * 8 - g_lo, (r8 + n8) * 8 - g_lo
    np.testing.assert_array_equal(words(out)[r8 * 8 : (r8 + n8) * 8, win_c : win_c + cwin],
                                  np.asarray(merged)[lo:hi])
    copied = slice((STRIPE // 8 + 3) * 8, (STRIPE // 8 + 13) * 8), slice(128, 256)
    np.testing.assert_array_equal(words(out)[copied], words(r)[copied])
    untouched = np.ones(SHAPE, dtype=bool)
    untouched[r8 * 8 : (r8 + n8) * 8, win_c : win_c + cwin] = False
    untouched[copied] = False
    np.testing.assert_array_equal(words(out)[untouched], words(w)[untouched])


# -- K5 and K8 against _build_dispatch_frontier -------------------------------------

# The routes each slot's stripe must take in a chunk at the JAX plan, 8192
# cells wide, under the (96, 128) geometry ("after": a skip right after a
# rectangle).
EXPECTED = {"board_top": {"row"}, "mid": {"tier"}, "stripe_top": {"tier"},
            "stripe_bottom": {"tier"}, "quantum": {"row"}, "seam_left": {"row"},
            "seam_right": {"row"}, "two_columns": {"row"}, "spark": {"tier", "after"},
            "two_rows": {"full"}}


def jax_chunk(ref, p: torch.Tensor):
    """``_build_dispatch_frontier``'s chunk of NLAUNCH launches on ``p``:
    (board, skipped, activity)."""
    call = ref.pp._build_dispatch_frontier(SHAPE, ref.life.CONWAY, T, NLAUNCH, True, STRIPE)
    pw = ref.jnp.asarray(words(p))
    out = [np.asarray(o) for o in call(pw, ref.jnp.zeros_like(pw))]
    return out[NLAUNCH % 2], out[2], out[3]


@pytest.fixture(scope="module")
def jax_slots(ref):
    """The JAX chunk on each slot's board under the (96, 128) geometry,
    computed at once (each override clears the JAX kernel caches)."""
    with both_geometries(ref, NARROW):
        return {slot: jax_chunk(ref, packed_board((slot,))) for slot in SLOTS}


def route_names(routes: torch.Tensor) -> set:
    """The routes a stripe took over a chunk (int32[nlaunch]), by name,
    and "after" where a skip followed a rectangle."""
    seq = routes.tolist()
    names = {ca.ROUTES[r] for r in seq}
    if any(a == ca.ROUTE_TIER and b == ca.ROUTE_SKIP for a, b in zip(seq, seq[1:])):
        names.add("after")
    return names


@pytest.mark.parametrize("slot", SLOTS)
def test_k5_plain_and_block_mirror_match_jax_on_sparse_slots(ref, jax_slots, slot):
    """K5's plain version and block mirror over a chunk of 8 launches on
    the slot's board against ``_build_dispatch_frontier`` (interpret
    mode): board, skip count and activity, tolerance 0; the slot's stripe
    takes the routes of ``EXPECTED``; the block mirror's state and routes
    equal the plain version's launch by launch."""
    p = packed_board((slot,))
    plan = ca.AdaptivePlan(T, STRIPE, True)
    seen = {}
    want = jax_slots[slot]
    with ca.plan_geometry_override(NARROW):
        for name, launch in (("plain", ca.frontier_launch_mirror),
                             ("block", ca.frontier_launch_reg_mirror)):
            rec = seen.setdefault(name, [])
            got = ca.frontier_superstep_mirror(
                p, tlife.CONWAY, plan, NLAUNCH, launch,
                lambda b, s, r, _rec=rec: _rec.append((b.clone(), s.clone(), r.clone())))
            np.testing.assert_array_equal(words(got[0]), want[0])
            assert int(got[1]) == int(want[1][0])
            np.testing.assert_array_equal(got[2].numpy(), want[2])
    for (b1, s1, r1), (b2, s2, r2) in zip(seen["plain"], seen["block"]):
        assert torch.equal(b1, b2) and torch.equal(s1, s2) and torch.equal(r1, r2)
    routes = torch.stack([r for _, _, r in seen["plain"]])
    stripe = 0 if slot == "board_top" else 2
    assert EXPECTED[slot] <= route_names(routes[:, stripe])
    assert (routes[0] == ca.ROUTE_FULL).all()  # launch 0 is forced full


@pytest.mark.parametrize("geometry", [g.label for g in ca.geometry_candidates()])
def test_k5_matches_jax_under_every_geometry(ref, geometry):
    """K5's plain version against ``_build_dispatch_frontier`` under each
    geometry candidate (both packages' override), on a board of the
    mid-stripe glider and the spark: board, skip count and activity; the
    margin changes which stripes the row tier takes, the column window
    whether a 256-word board hosts the rectangle route at all."""
    geom = next(g for g in ca.geometry_candidates() if g.label == geometry)
    p = packed_board(("mid", "spark"))
    plan = ca.AdaptivePlan(T, STRIPE, True)
    routes = []
    with both_geometries(ref, geom):
        want = jax_chunk(ref, p)
        got = ca.frontier_superstep_mirror(p, tlife.CONWAY, plan, NLAUNCH,
                                           each=lambda b, st, r: routes.append(r.clone()))
        tiers = ca.frontier_geometry(plan, SHAPE)
    np.testing.assert_array_equal(words(got[0]), want[0])
    assert int(got[1]) == int(want[1][0])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    names = route_names(torch.stack(routes)[:, 1])
    assert ("tier" in names) == (tiers[1] is not None) and "skip" in route_names(
        torch.stack(routes)[:, 3])


def test_k5_at_the_shipped_geometry_keeps_the_column_tier_off_at_256_words(ref):
    """At the shipped (96, 256) geometry a 256-word board hosts no column
    window (the JAX plan's col_window is None), so the mid-stripe glider
    takes the row tier, and K5 still equals the JAX kernel."""
    p = packed_board(("mid",))
    plan = ca.AdaptivePlan(T, STRIPE, True)
    assert ca.frontier_geometry(plan, SHAPE) == (168, None)
    assert ref.pp._frontier_plan(SHAPE, T, STRIPE) == (24, 168, None)
    routes = []
    got = ca.frontier_superstep_mirror(p, tlife.CONWAY, plan, NLAUNCH,
                                       each=lambda b, s, r: routes.append(r.clone()))
    want = jax_chunk(ref, p)
    np.testing.assert_array_equal(words(got[0]), want[0])
    assert int(got[1]) == int(want[1][0])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert route_names(torch.stack(routes)[:, 2]) == {"full", "row"}


def test_k8_stack_with_a_dead_board_matches_jax(ref):
    """K8's plain version on a stack of a sparse board (the spark, the
    mid-stripe glider and the two clusters) beside a dead one against the
    nboards = 2 form of ``_build_dispatch_frontier``: stack, per-board
    skip counts and activity; the dead board skips every stripe after
    launch 0 and the sparse one takes the rectangle route and skips after
    it."""
    sparse = packed_board(("mid", "spark"), h=SHAPE[0])
    stack = torch.stack([sparse, torch.zeros_like(sparse)])
    plan = ca.AdaptivePlan(T, STRIPE, True)
    routes = []
    with both_geometries(ref, NARROW):
        got = ca.frontier_superstep_batched_mirror(
            stack, tlife.CONWAY, plan, NLAUNCH, each=lambda b, s, r: routes.append(r.clone()))
        call = ref.pp._build_dispatch_frontier(SHAPE, ref.life.CONWAY, T, NLAUNCH, True, STRIPE,
                                               2)
        pw = ref.jnp.asarray(words(stack.reshape(-1, SHAPE[1])))
        out = [np.asarray(o) for o in call(pw, ref.jnp.zeros_like(pw))]
    np.testing.assert_array_equal(words(got[0]).reshape(-1, SHAPE[1]), out[NLAUNCH % 2])
    np.testing.assert_array_equal(got[1].numpy(), out[2])
    np.testing.assert_array_equal(got[2].numpy(), out[3])
    routes = torch.stack(routes)
    assert (routes[1:, 4:] == ca.ROUTE_SKIP).all()
    assert int(got[1][1]) == 4 * (NLAUNCH - 1)
    assert {"tier", "after"} <= set().union(*(route_names(routes[:, k]) for k in range(4)))


# -- K14 and K12 -----------------------------------------------------------------


def test_k14_loopback_chunk_matches_jax(ref):
    """K14 on one strip (the loopback build: the strip its own neighbour)
    of a board with a glider inside it and one at its bottom edge, against
    ``_build_dispatch_frontier_strip``: board, skip count and activity;
    the edge stripe's window would cross the strip, so it takes the row
    tier, the inside one the rectangle route."""
    p = packed_board(("mid", "stripe_bottom"))
    plan = ca.AdaptivePlan(T, STRIPE, True)
    routes = []
    with both_geometries(ref, NARROW):
        strips, st = cuda_halo.strip_mega_launches(
            [p], tlife.CONWAY, plan, NLAUNCH, each=lambda s, m: routes.append(m.route.clone()))
        call = ref.ph._build_dispatch_frontier_strip(SHAPE, ref.life.CONWAY, T, NLAUNCH, True,
                                                     STRIPE, False)
        pw = ref.jnp.asarray(words(p))
        a, _, sk, act = call(ref.jnp.zeros(3, ref.jnp.int32), pw, ref.jnp.zeros_like(pw))
    np.testing.assert_array_equal(words(strips[0]), np.asarray(a))
    assert st.skipped.tolist() == [int(sk[0])]
    np.testing.assert_array_equal(st.act.numpy(), np.asarray(act))
    routes = torch.stack(routes)
    assert "tier" in route_names(routes[:, 1]) and "row" in route_names(routes[:, 3])


def test_k12_column_tier_and_interval_arrays_match_jax(ref):
    """Two K12 launches on a strip of the mid-stripe glider and the two
    clusters (its own torus: north and south its own edges), from full
    intervals, against ``_build_ext_launch_frontier``: board, skip flags
    and the six interval arrays after each; the glider's stripe takes the
    column tier at launch 2, the two clusters' the row tier."""
    local = words(packed_board(("mid", "two_columns")))
    h, wp = SHAPE
    plan = ca.AdaptivePlan(T, STRIPE, True)
    pad = plan.pad_f
    north, south = local[-pad:], local[:pad]
    grid = plan.grid(h)
    state = cuda_halo.FrontierState.start(SHAPE, plan, "cpu")
    dst = np.zeros_like(local)
    ps = np.zeros(grid, np.int32)
    cur = local
    with both_geometries(ref, NARROW):
        call = ref.ph._build_ext_launch_frontier(SHAPE, ref.life.CONWAY, T, True, STRIPE)
        jivals = [np.concatenate([[v[-1]], v, [v[0]]]) for v in state.prev[:6].numpy()]
        for k in range(4):  # the rows, not the words, move into the frame
            jivals[k][0] -= h
            jivals[k][-1] += h
        routes = []
        for _ in range(2):
            out = [np.asarray(o) for o in call(
                ref.jnp.asarray(ps), *[ref.jnp.asarray(a, ref.jnp.int32) for a in jivals],
                ref.jnp.asarray(cur), ref.jnp.asarray(north), ref.jnp.asarray(south),
                ref.jnp.asarray(dst))]
            ext = cuda_halo.edge_intervals([state.prev], h)[0]
            np.testing.assert_array_equal(ext.numpy(), np.stack(jivals))
            got = cuda_halo.strip_frontier_launch(
                *(torch.from_numpy(a.view(np.int32).copy()) for a in (cur, north, south, dst)),
                ext, state, tlife.CONWAY, plan)
            np.testing.assert_array_equal(words(got), out[0])
            np.testing.assert_array_equal(1 - state.cur[6].numpy(), out[1])
            np.testing.assert_array_equal(state.cur[:6].numpy(), np.stack(out[2:8]))
            routes.append(state.route.clone())
            state.advance()
            ps = out[1]
            e = [np.concatenate([[v[-1]], v, [v[0]]]) for v in out[2:8]]
            for k in range(4):
                e[k][0] -= h
                e[k][-1] += h
            jivals = e
            dst, cur = cur, out[0]
            north, south = cur[-pad:], cur[:pad]
    assert routes[0].tolist() == [ca.ROUTE_FULL] * grid
    assert routes[1][1].item() == ca.ROUTE_TIER and routes[1][3].item() == ca.ROUTE_ROW


# -- the geometry API -------------------------------------------------------------------


@pytest.mark.parametrize("args", [(40, 256), (97, 256), (96, 100), (96, 200), (96, -128),
                                  (48, 0), (96, 384)])
def test_plan_geometry_validates_as_jax(ref, args):
    """``PlanGeometry``'s errors, messages and labels are the JAX ones."""
    try:
        want = ref.pp.PlanGeometry(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            ca.PlanGeometry(*args)
    else:
        got = ca.PlanGeometry(*args)
        assert tuple(got) == tuple(want) and got.label == want.label
        assert (got.sub_margin, got.col_window) == (want.sub_margin, want.col_window)


def test_geometry_candidates_and_override_restore_as_jax(ref):
    """The candidates (the shipped one first), the process-wide setting,
    and the override's restore, also when its block raises, as in the
    JAX package; setting the geometry clears what is cached on it."""
    assert [tuple(g) for g in ca.geometry_candidates()] == [
        tuple(g) for g in ref.pp.geometry_candidates()]
    assert tuple(ca.plan_geometry()) == tuple(ref.pp.plan_geometry()) == (96, 256)
    plan = ca.AdaptivePlan(24, 256, True)
    assert ca.frontier_geometry(plan, (16384, 512)) == (192, 256)
    with pytest.raises(RuntimeError):
        with ca.plan_geometry_override((64, 128)) as g:
            assert g == ca.plan_geometry() == ca.PlanGeometry(64, 128)
            assert ca.frontier_geometry(plan, (16384, 512)) == (160, 128)
            raise RuntimeError("inside")
    assert ca.plan_geometry() == ca.PlanGeometry(96, 256)
    assert ca.frontier_geometry(plan, (16384, 512)) == (192, 256)
    prev = ca.set_plan_geometry((64, 0))
    try:
        assert prev == ca.PlanGeometry(96, 256)
        assert ca.frontier_geometry(plan, (16384, 512)) == (160, None)
    finally:
        assert ca.set_plan_geometry(None) == ca.PlanGeometry(64, 0)
    assert ca.plan_geometry() == ca.PlanGeometry(96, 256)


@pytest.mark.parametrize("shape,stripe,turns", [((16384, 512), 256, 24), ((4096, 512), 256, 24),
                                                ((1024, 256), 256, 18), ((512, 4), 64, 24),
                                                ((2048, 128), 256, 18), ((4096, 64), 128, 12),
                                                ((8192, 256), 256, 24), ((1024, 320), 256, 18),
                                                ((1024, 128), 256, 18), ((2048, 640), 256, 12)])
def test_frontier_geometry_follows_the_jax_plan(ref, shape, stripe, turns):
    """Where the JAX plan has a frontier plan at the same stripes, the
    port's tiers are its (sub_rows, col_window) under every candidate, on
    a board or strip (``_frontier_plan``) and on a tile of a 2-D mesh
    (``_plan_2d``: the row tier from the x-extended tile, the column
    window gated on the tile's own width, which K15 takes from the same
    ``frontier_geometry`` of its tile); where the row tier does not fit,
    the port's tiers are off."""
    plan = ca.AdaptivePlan(turns, stripe, True)
    for geom in ca.geometry_candidates():
        with both_geometries(ref, geom):
            want = ref.pp._frontier_plan(shape, turns, stripe)
            got = ca.frontier_geometry(plan, shape)
            if want is not None and ref.pp._plan_tile(shape, turns, stripe) == stripe:
                assert got == want[1:]
            want_2d = ref.ph._plan_2d(shape, turns, stripe, True)
            if want_2d is not None and want_2d[4] == stripe:
                assert got == want_2d[2:4]
            sub = ca._round8(4 * turns + geom.sub_margin)
            if sub + 64 > stripe + 2 * plan.pad_f:
                assert got == (None, None)
