"""``gol.run`` with ``skip_stable`` on row meshes against the JAX package's.

The port's strips all lie on the CPU (the plain versions of K10, K11 and
K12); the JAX package runs the same mesh on the 8 virtual CPU devices of
``tests/conftest.py``, its strip kernels in interpret mode.  Both must
emit equal event streams (the MetricsReport's ``backend.*`` and
``controller.*`` counters and labels included: the engine, the exchange
tier and its policy) and byte-identical PGMs, through
``tests/test_torch_run.py``'s harness, whatever plan each package runs.
With the port forced onto the JAX package's strip plan, the two Backends'
skip fractions, activity bitmaps and tier labels agree dispatch by
dispatch."""

import warnings

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol
from distributed_gol_torch.engine import pgm
from distributed_gol_torch.engine.session import Session as TSession
from distributed_gol_torch.ops import cuda_adaptive
from distributed_gol_torch.parallel import cuda_halo
from distributed_gol_tpu.engine.session import Session as JSession
from tests.test_torch_run import SOUP, ScriptedKeys, assert_same_run, pgms, run
from tests.test_torch_sharded import info

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

FRONTIER = (4096, 128)  # the JAX package's TestShardedFrontier board


def frontier_board(shape=FRONTIER, glider=2030, pulsar=3000) -> np.ndarray:
    """``tests/test_pallas_halo.py::TestShardedFrontier``'s board: a glider
    heading for the (2, 1) strip seam at H/2, a block, and a period-3
    pulsar that must be proved stable; most stripes stay empty.  Other
    shapes move the glider's and the pulsar's rows."""
    b = np.zeros(shape, dtype=np.uint8)
    for dy, dx in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[glider + dy, 60 + dx] = 255
    b[100:102, 20:22] = 255
    for c in [2, 3, 4, 8, 9, 10]:
        for r in (0, 5, 7, 12):
            b[pulsar + r, 40 + c] = 255
            b[pulsar + c, 40 + r] = 255
    return b


def images_of(tmp_path, board: np.ndarray):
    images = tmp_path / "images"
    images.mkdir(exist_ok=True)
    pgm.write_pgm(images / f"{board.shape[1]}x{board.shape[0]}.pgm", board)
    return images


@pytest.fixture(scope="module")
def ph():
    from distributed_gol_tpu.parallel import pallas_halo

    return pallas_halo


def force_strip_plan(monkeypatch, ph):
    """Make the port plan every strip dispatch as the JAX package does."""

    def plan(strip, turns, cap=0):
        cap, t, adaptive, fplan = ph._adaptive_strip_plan(strip, turns, cap or None)
        if not adaptive:
            return None
        return cuda_adaptive.AdaptivePlan(t, ph._strip_plan_tile(strip, t, cap), fplan is not None)

    monkeypatch.setattr(cuda_halo, "adaptive_strip_plan", plan)


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of the calls of the four strip kernels' plain versions (what
    the wrappers run on the CPU), by kernel."""
    counts = dict.fromkeys(("K9", "K10", "K11", "K12"), 0)
    names = {"K9": "ext_launch_plain", "K10": "ext_skip_launch_plain",
             "K11": "strip_probing_launch_plain", "K12": "strip_frontier_launch_plain"}
    for k, name in names.items():
        fn = getattr(cuda_halo, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            counts[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cuda_halo, name, counted)
    return counts


# -- streams and PGMs at each package's own plan ----------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1), (8, 1)])
def test_frontier_geometry_matches(tmp_path, plain_calls, mesh_shape):
    """The frontier board on every row mesh: superstep 89 is three full
    launches of the port's T = 24 and a remainder of 12 + 5 (the JAX
    package's T = 18: four, a rem6 of 12 and 5), so every dispatch runs
    K12, K10 and K9 here."""
    events = assert_same_run(
        tmp_path, turns=3 * 89, superstep=89, image_height=FRONTIER[0],
        image_width=FRONTIER[1], images_dir=images_of(tmp_path, frontier_board()),
        engine="pallas-packed", skip_stable=True, mesh_shape=mesh_shape, turn_events="batch",
    )
    labels = info(events)
    assert labels["backend.engine"] == "pallas-packed"
    assert labels["backend.sharded_tier"] == "ppermute"
    assert labels["backend.sharded_tier_policy"] == cuda_halo.INTERPRET_REASON
    n = plain_calls
    assert n["K12"] and n["K10"] and n["K9"] and not n["K11"]


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1)])
def test_probing_geometry_matches(tmp_path, plain_calls, mesh_shape):
    """A soup at skip_tile_cap 16: 16-row stripes, T = 12 in both packages
    and no frontier plan, so K11 runs every full launch; both packages
    record why there is no in-kernel tier."""
    events = assert_same_run(
        tmp_path, turns=2 * 60, superstep=60, image_height=256, image_width=128,
        engine="pallas-packed", skip_stable=True, skip_tile_cap=16, mesh_shape=mesh_shape,
        turn_events="batch", **SOUP,
    )
    assert info(events)["backend.sharded_tier_policy"].startswith("no frontier plan for tile")
    n = plain_calls
    assert n["K11"] and not n["K12"]


# A soup whose 256-row strips on (4, 1) host a frontier plan in both
# packages (the JAX plan's needs 184 rows or more), so the tier records
# agree too.
STRIPS = dict(image_height=1024, image_width=64, **SOUP)


@pytest.mark.parametrize("superstep", [6, 13, 47])
def test_tails_match(tmp_path, superstep):
    """Dispatches of one skip launch, of a rem6 and a < 6 tail, and of two
    full launches and a tail, on (4, 1)."""
    assert_same_run(
        tmp_path, turns=4 * superstep, superstep=superstep,
        engine="pallas-packed", skip_stable=True, mesh_shape=(4, 1), turn_events="batch",
        **STRIPS,
    )


def test_strips_with_no_plan_run_k10(tmp_path, plain_calls):
    """12-row strips (96 x 128 on (8, 1)) have no multiple-of-8 stripe:
    the port runs K10 for every full launch, where the JAX package's gate
    refuses the strips and falls back to packed with its warning; the PGMs
    agree."""
    kw = dict(turns=100, superstep=50, image_height=96, image_width=128,
              engine="pallas-packed", skip_stable=True, mesh_shape=(8, 1), **SOUP)
    with pytest.warns(RuntimeWarning, match="falling back to 'packed'"):
        _, j_out = run(jgol, tmp_path, "jax", None, JSession(), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_events, t_out = run(tgol, tmp_path, "torch", None, TSession(), **kw)
    assert pgms(t_out) == pgms(j_out)
    assert info(t_events)["backend.engine"] == "pallas-packed"
    assert cuda_halo.adaptive_strip_plan((12, 4), 50) is None
    n = plain_calls
    assert n["K10"] == 8 * 2 * 4 and not (n["K11"] or n["K12"])


@pytest.mark.parametrize("keys", [{2: "s", 3: "q"}, {2: "pp", 4: "k"}],
                         ids=["snap-detach", "pause-kill"])
def test_keys_match(tmp_path, keys):
    assert_same_run(
        tmp_path, keys=keys, turns=300, superstep=30, engine="pallas-packed",
        skip_stable=True, mesh_shape=(4, 1), **STRIPS,
    )


@pytest.mark.parametrize("parker,resumer", [(jgol, tgol), (tgol, jgol)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_detach_resumes_across_packages(tmp_path, parker, resumer):
    """'q' parks a (4, 1) skip_stable run in one package; the other
    resumes it to the straight single-device board."""
    kw = dict(turns=300, superstep=30, engine="pallas-packed", skip_stable=True,
              mesh_shape=(4, 1), **STRIPS)
    session_of = {jgol: JSession, tgol: TSession}
    _, straight = run(tgol, tmp_path, "straight", None, TSession(),
                      **dict(kw, mesh_shape=(1, 1), skip_stable=False))
    ckpt = tmp_path / "ckpt"
    run(parker, tmp_path, "park", ScriptedKeys({3: "q"}), session_of[parker](ckpt), **kw)
    assert (ckpt / "checkpoint.json").is_file()
    _, resumed = run(resumer, tmp_path, "resume", None, session_of[resumer](ckpt), **kw)
    assert pgms(resumed) == pgms(straight)


# -- the skip telemetry at the JAX package's plan -----------------------------------


@pytest.mark.parametrize(
    "mesh_shape,board,cap",
    [((2, 1), frontier_board(), 1024), ((4, 1), frontier_board((256, 128), 58, 180), 16)],
    ids=["frontier", "probing"],
)
def test_backends_report_the_same_skip_telemetry(tmp_path, monkeypatch, ph, mesh_shape, board,
                                                 cap):
    """At the JAX plan the two Backends give equal skip fractions, activity
    bitmaps (every strip's stripes, top to bottom), active-tile counts and
    tier labels, dispatch for dispatch, with the two-dispatch lag."""
    from distributed_gol_torch.engine.backend import Backend as TB
    from distributed_gol_tpu.engine.backend import Backend as JB

    force_strip_plan(monkeypatch, ph)
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


def test_skip_stable_on_a_row_mesh_is_served(tmp_path):
    """A (4, 1) mesh with skip_stable, explicit and auto, builds the strip
    tier; a cycle probe leaves the telemetry alone."""
    from distributed_gol_torch.engine.backend import Backend

    for skip in (True, None):
        p = tgol.Params(mesh_shape=(4, 1), skip_stable=skip, turns=10**6, image_height=256,
                        image_width=64, engine="pallas-packed", device="cpu", out_dir=tmp_path)
        be = Backend(p)
        assert be._superstep == be._skip_superstep and be._skip_cap == cuda_adaptive.SKIP_TILE_CAP
    board = be.put(np.zeros((256, 64), np.uint8))
    assert bool(be.cycle_probe_async(board))
    assert be._skip_stats == []
