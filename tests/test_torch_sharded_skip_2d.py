"""``gol.run`` with ``skip_stable`` on 2-D meshes against the JAX package's.

The port's tiles all lie on the CPU (the plain versions of K13, K10 and
K9); the JAX package runs the same mesh on the 8 virtual CPU devices of
``tests/conftest.py``, its tile kernels in interpret mode.  Both must emit
equal event streams (the MetricsReport's ``backend.*`` and
``controller.*`` counters and labels included: the engine, the exchange
tier and its policy) and byte-identical PGMs, through
``tests/test_torch_run.py``'s harness, whatever plan each package runs.
With the port forced onto the JAX package's 2-D plan (its T, its stripes
and its interpret-mode x-halo of several words), the two packages' skip
counts and (stripe, x-tile) activity grids agree dispatch by dispatch, and
so do the two Backends' skip fractions and activity bitmaps."""

import warnings

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol
from distributed_gol_torch.engine.session import Session as TSession
from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, packed as tpacked
from distributed_gol_torch.parallel import cuda_halo, halo, mesh as tmesh
from distributed_gol_tpu.engine.session import Session as JSession
from tests.test_torch_cli import cli
from tests.test_torch_run import SOUP, assert_same_run, pgms, run
from tests.test_torch_sharded import info
from tests.test_torch_sharded_skip import images_of

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

MESHES = [(2, 2), (2, 4), (4, 2)]
# The boards whose tiles host a frontier plan in both packages on every
# mesh above, so that the tier records agree.
TILES = (1024, 128)


def tile_board(shape=TILES, at=(492, 58)) -> np.ndarray:
    """The JAX package's ``TestMesh2D`` board at ``shape``: a glider heading
    down and right for the point ``at`` + 20 (by default the corner where
    four tiles meet on (2, 2) and (2, 4), a row seam on (4, 2)), a block,
    and a period-3 pulsar that must be proved stable; most stripes stay
    empty."""
    b = np.zeros(shape, dtype=np.uint8)
    for dy, dx in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[at[0] + dy, at[1] + dx] = 255
    b[100:102, 20:22] = 255
    for c in [2, 3, 4, 8, 9, 10]:
        for r in (0, 5, 7, 12):
            b[shape[0] * 3 // 4 + r, 40 + c] = 255
            b[shape[0] * 3 // 4 + c, 40 + r] = 255
    return b


@pytest.fixture(scope="module")
def ph():
    from distributed_gol_tpu.parallel import pallas_halo

    return pallas_halo


def jax_tile_plan(ph, tile, turns, cap=0):
    """The JAX package's interpret-mode plan of a 2-D dispatch, as the
    port's (plan, xpad): its T, its ``_plan_tile_2d`` stripes, a frontier
    form where its ``_plan_2d`` has one, and its ``_xpad_words``."""
    cap, t, adaptive, plan2 = ph._adaptive_plan_2d(tile, turns, cap or None, True)
    if not adaptive:
        return None
    xpad = ph._xpad_words(tile[1], True)
    return cuda_adaptive.AdaptivePlan(t, ph._plan_tile_2d(tile, t, cap, xpad),
                                      plan2 is not None), xpad


def force_tile_plan(monkeypatch, ph):
    """Make the port plan every 2-D dispatch as the JAX package does."""
    monkeypatch.setattr(cuda_halo, "adaptive_tile_plan",
                        lambda tile, turns, cap=0: jax_tile_plan(ph, tile, turns, cap))


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of the calls of the tile tier's plain versions (what the
    wrappers run on the CPU), by kernel."""
    counts = dict.fromkeys(("K9", "K10", "K13"), 0)
    names = {"K9": "ext_launch_plain", "K10": "ext_skip_launch_plain",
             "K13": "tile_probing_launch_plain"}
    for k, name in names.items():
        fn = getattr(cuda_halo, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            counts[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cuda_halo, name, counted)
    return counts


# -- streams and PGMs at each package's own plan ----------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_frontier_geometry_matches(tmp_path, plain_calls, mesh_shape):
    """The frontier board on every 2-D mesh: superstep 89 is three full
    launches of the port's T = 24 and a remainder of 12 + 5 (the JAX
    package's T = 18: four, a rem6 of 12 and 5), so every dispatch runs
    K13, K10 and K9 here; both packages record the interpret-mode reason
    for the ppermute tier (both plans have a frontier form)."""
    events = assert_same_run(
        tmp_path, turns=2 * 89, superstep=89, image_height=TILES[0], image_width=TILES[1],
        images_dir=images_of(tmp_path, tile_board()), engine="pallas-packed",
        skip_stable=True, mesh_shape=mesh_shape, turn_events="batch",
    )
    labels = info(events)
    assert labels["backend.engine"] == "pallas-packed"
    assert labels["backend.sharded_tier"] == "ppermute"
    assert labels["backend.sharded_tier_policy"] == cuda_halo.INTERPRET_REASON
    n = plain_calls
    assert n["K13"] and n["K10"] and n["K9"]


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2)])
def test_probing_geometry_matches(tmp_path, plain_calls, mesh_shape):
    """A soup at skip_tile_cap 16: 16-row stripes and no frontier plan in
    either package; both record why there is no in-kernel tier."""
    events = assert_same_run(
        tmp_path, turns=2 * 60, superstep=60, image_height=256, image_width=256,
        engine="pallas-packed", skip_stable=True, skip_tile_cap=16, mesh_shape=mesh_shape,
        turn_events="batch", **SOUP,
    )
    policy = info(events)["backend.sharded_tier_policy"]
    assert policy.startswith("no frontier plan for tile") and f"on {mesh_shape}" in policy
    assert plain_calls["K13"]


@pytest.mark.parametrize("superstep", [6, 13, 47])
def test_tails_match(tmp_path, superstep):
    """Dispatches of one skip launch, of a rem6 and a < 6 tail, and of two
    full launches and a tail, on (2, 2)."""
    assert_same_run(
        tmp_path, turns=4 * superstep, superstep=superstep, image_height=TILES[0],
        image_width=TILES[1], engine="pallas-packed", skip_stable=True, mesh_shape=(2, 2),
        turn_events="batch", **SOUP,
    )


def test_tiles_with_no_plan_run_k10(tmp_path, plain_calls):
    """26-row tiles (104 x 256 on (4, 2)) have no multiple-of-8 stripe: the
    port runs K10 at xpad > 0 for every full launch, where the JAX
    package's gate refuses the tiles and falls back to packed with its
    warning; the PGMs agree."""
    kw = dict(turns=100, superstep=50, image_height=104, image_width=256,
              engine="pallas-packed", skip_stable=True, mesh_shape=(4, 2), **SOUP)
    with pytest.warns(RuntimeWarning, match="falling back to 'packed'"):
        _, j_out = run(jgol, tmp_path, "jax", None, JSession(), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_events, t_out = run(tgol, tmp_path, "torch", None, TSession(), **kw)
    assert pgms(t_out) == pgms(j_out)
    assert info(t_events)["backend.engine"] == "pallas-packed"
    assert cuda_halo.adaptive_tile_plan((26, 4), 50) is None
    n = plain_calls
    assert n["K10"] == 8 * 2 * 2 and not n["K13"]


@pytest.mark.parametrize("keys", [{2: "s", 3: "q"}, {2: "pp", 4: "k"}],
                         ids=["snap-detach", "pause-kill"])
def test_keys_match(tmp_path, keys):
    assert_same_run(
        tmp_path, keys=keys, turns=300, superstep=30, engine="pallas-packed",
        skip_stable=True, mesh_shape=(2, 2), image_height=TILES[0], image_width=TILES[1], **SOUP,
    )


def test_cli_mesh_skip_stable_matches_jax_cli(tmp_path):
    """``--mesh 2x2 -noVis --skip-stable`` on the tile tier (``--engine
    pallas-packed``; ``--device cpu`` for the port): equal PGMs and last
    lines."""
    args = ["-w", "128", "-h", "64", "-turns", "100", "-noVis", "--soup", "0.3", "--soup-seed",
            "7", "--mesh", "2x2", "--skip-stable", "--engine", "pallas-packed"]
    t = cli("distributed_gol_torch", *args, "--device", "cpu", "--out-dir", "t", cwd=tmp_path)
    j = cli("distributed_gol_tpu", *args, "--out-dir", "j", cwd=tmp_path)
    assert t.returncode == 0, t.stderr
    assert j.returncode == 0, j.stderr
    name = "128x64x100.pgm"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert t.stdout.splitlines()[-1] == j.stdout.splitlines()[-1]


# -- the skip telemetry at the JAX package's plan -----------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_dispatch_stats_match_at_the_jax_plan(monkeypatch, ph, mesh_shape):
    """``make_superstep(..., with_stats=True)`` in both packages at the JAX
    plan, the frontier board: equal boards, skip counts and (ny·grid, nx)
    activity grids, through both launch parities and the remainders.  (On
    (2, 2) the JAX plan's 512-row stripes are whole tiles, and the glider
    at the corner of all four keeps every one active.)"""
    import jax

    from distributed_gol_tpu.models.life import CONWAY
    from distributed_gol_tpu.ops import packed as jpacked
    from distributed_gol_tpu.parallel.mesh import make_mesh
    from distributed_gol_tpu.parallel.packed_halo import packed_sharding

    force_tile_plan(monkeypatch, ph)
    board = tile_board()
    p = tpacked.pack(torch.from_numpy(board))
    m = tmesh.make_mesh(mesh_shape, [torch.device("cpu")] * (mesh_shape[0] * mesh_shape[1]))
    jm = make_mesh(mesh_shape)
    for turns in (4 * 18, 5 * 18 + 20):
        got, sk, act = cuda_halo.make_superstep(m, tlife.CONWAY, True, 0, True)(
            halo.board_sharding(m).shard(p), turns)
        pb = jax.device_put(np.asarray(jpacked.pack(board)), packed_sharding(jm))
        want, wsk, wact = ph.make_superstep(jm, CONWAY, skip_stable=True, with_stats=True)(
            pb, turns)
        assert np.array_equal(got.gather().numpy().view(np.uint32), np.asarray(want))
        assert int(sk) == int(wsk) and act.numpy().tolist() == np.asarray(wact).tolist()
        total = cuda_halo.adaptive_strip_launches(tuple(p.shape), mesh_shape, turns)
        assert total == ph.adaptive_strip_launches(tuple(p.shape), mesh_shape, turns, None)
        assert 0 <= int(sk) < total and act.shape[1] == mesh_shape[1]


@pytest.mark.parametrize(
    "mesh_shape,board,cap",
    [((2, 4), tile_board(), 1024), ((4, 2), tile_board((256, 128), (40, 60)), 16)],
    ids=["frontier", "probing"],
)
def test_backends_report_the_same_skip_telemetry(tmp_path, monkeypatch, ph, mesh_shape, board,
                                                 cap):
    """At the JAX plan the two Backends give equal skip fractions, activity
    bitmaps (H / stripe_h entries: any over each stripe's tiles),
    active-tile counts and tier labels, dispatch for dispatch, with the
    two-dispatch lag."""
    from distributed_gol_torch.engine.backend import Backend as TB
    from distributed_gol_tpu.engine.backend import Backend as JB

    force_tile_plan(monkeypatch, ph)
    kw = dict(image_height=board.shape[0], image_width=board.shape[1], engine="pallas-packed",
              skip_stable=True, skip_tile_cap=cap, mesh_shape=mesh_shape, out_dir=tmp_path)
    jb, tb = JB(jgol.Params(**kw)), TB(tgol.Params(device="cpu", **kw))
    assert (tb.sharded_tier, tb.sharded_tier_policy) == (jb.sharded_tier, jb.sharded_tier_policy)
    jboard, tboard = jb.put(board), tb.put(board)
    seen = []
    for step in (211, 30, 97, 211):
        assert tb.skip_fraction() == jb.skip_fraction()
        tbm, jbm = tb.activity_bitmap(), jb.activity_bitmap()
        assert (tbm is None) == (jbm is None)
        if tbm is not None:
            np.testing.assert_array_equal(tbm, jbm)
            assert tb.activity_tile_rows() == jb.activity_tile_rows()
            assert tb._active_tiles() == jb._active_tiles()
        seen.append(tb.skip_fraction())
        jboard, jc = jb.run_turns(jboard, step)
        tboard, tc = tb.run_turns(tboard, step)
        assert tc == jc
        np.testing.assert_array_equal(tb.fetch(tboard), jb.fetch(jboard))
    assert seen[:3] == [None, None, None] and 0 < seen[3] <= 1


def test_skip_stable_on_a_2d_mesh_is_served(tmp_path):
    """A (2, 2) mesh with skip_stable, explicit and auto, builds the tile
    tier at the port's own plan: the activity bitmap has one entry a
    stripe of the board (H / stripe_h), the any-over-x of the (ny·grid,
    nx) grid, and the skip fraction's denominator spans every (stripe,
    x-tile) cell.  Without skip_stable the plain path runs."""
    from distributed_gol_torch.engine.backend import Backend

    for skip in (True, None):
        p = tgol.Params(mesh_shape=(2, 2), skip_stable=skip, turns=10**6, image_height=256,
                        image_width=128, engine="pallas-packed", device="cpu", out_dir=tmp_path)
        be = Backend(p)
        assert be._superstep == be._skip_superstep and be._skip_cap == cuda_adaptive.SKIP_TILE_CAP
    plan, _ = cuda_halo.adaptive_tile_plan((128, 2), 10**6)
    assert cuda_halo.adaptive_strip_launches((256, 4), (2, 2), 96) == 4 * 4 * plan.grid(128)
    board = be.put(tile_board((256, 128), (40, 60)))
    for _ in range(3):
        board, _ = be.run_turns(board, 96)
    bm = be.activity_bitmap()
    assert bm.shape == (256 // plan.stripe_h,) and bm.any() and not bm.all()
    act = be._skip_stats[-3][2]
    assert act.shape == (2 * plan.grid(128), 2)
    assert bm.tolist() == (act > 0).any(dim=1).tolist()
    assert be.activity_tile_rows() == plan.stripe_h
    off = Backend(tgol.Params(mesh_shape=(2, 2), skip_stable=False, image_height=256,
                              image_width=128, engine="pallas-packed", device="cpu",
                              out_dir=tmp_path))
    assert getattr(off, "_skip_fn", None) is None and off.activity_bitmap() is None


def test_tier_record_where_only_the_port_has_a_frontier_plan(ph):
    """A recorded divergence: 128-row tiles 2 words wide (512 x 128 on
    (4, 2)) host the port's frontier plan (T = 24 on 128-row stripes) but
    not the JAX package's (its interpret x-halo and VMEM plan give T = 6
    and no frontier form), so the CPU tier records differ: the port gives
    the interpret-mode reason, the JAX package "no frontier plan".  The
    boards agree (``test_frontier_geometry_matches`` and the tests
    above)."""
    m = tmesh.make_mesh((4, 2), [torch.device("cpu")] * 8)
    assert cuda_halo.adaptive_tile_plan((128, 2), 10**6)[0].frontier
    assert cuda_halo.tier_policy(m, (128, 2)) == (False, cuda_halo.INTERPRET_REASON)
    assert ph._adaptive_plan_2d((128, 2), 10**6, None, True)[3] is None
