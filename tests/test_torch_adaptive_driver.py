"""The adaptive (``skip_stable``) tier's driver, plan and Backend on the
CPU: ``ops/cuda_adaptive.py`` at the port's own plan against the plain
packed engine, then ``gol.run`` and the ``Backend`` of the port against the
JAX package's.

``gol.run`` with ``skip_stable=True`` must emit the same event stream and
PGMs in both packages (the JAX package in interpret mode), and at a shared
plan the two Backends must report the same skip fraction and activity
bitmap.  The Backend's own surface — when the tier engages, its warnings,
its gauges, and cycle probes that leave the skip telemetry alone — is
pinned here too.  The kernel-level comparison with the JAX package is
``tests/test_torch_adaptive.py``."""

import warnings

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, cuda_packed, packed as tpacked
from test_torch_adaptive import (  # noqa: F401
    BOARDS, GLIDER, PATHS, RULES, _put, jax_plan, make_board, ref, words,
)

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


# -- the board at the port's own plan ---------------------------------


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("path", list(PATHS))
def test_default_plan_board_matches_packed(path, kind, rule):
    (h, w), cap = PATHS[path]
    turns = 211
    plan = cuda_adaptive.adaptive_plan((h, w // 32), turns, cap)
    b = make_board(kind, h, w, plan.stripe_h)
    p = tpacked.pack(torch.from_numpy(b))
    got, sk, act = cuda_adaptive.adaptive_superstep(p, tlife.RULES[rule], turns, cap=cap)
    np.testing.assert_array_equal(words(got), words(tpacked.superstep(p, tlife.RULES[rule], turns)))
    assert act.shape == (plan.grid(h),)
    assert 0 <= int(sk) <= cuda_adaptive.adaptive_tile_launches((h, w // 32), turns, cap)
    if kind == "dead":
        assert not act.any()


@pytest.mark.parametrize("turns", [0, 1, 5, 6, 7, 13, 18, 30, 47])
def test_short_dispatches_and_remainders(turns):
    """Dispatches below one launch, a lone skip launch, rem6 + plain tails."""
    b = make_board("glider", 64, 256, 16)
    p = tpacked.pack(torch.from_numpy(b))
    got, sk, act = cuda_adaptive.adaptive_superstep(p, tlife.CONWAY, turns, cap=16)
    np.testing.assert_array_equal(words(got), words(tpacked.superstep(p, tlife.CONWAY, turns)))
    plan = cuda_adaptive.adaptive_plan((64, 8), turns, 16)
    assert act.numel() == (plan.grid(64) if plan and turns >= plan.t else 0)


@pytest.mark.parametrize("stripe_h", [8, 16, 32, 64])
@pytest.mark.parametrize("t", [6, 12, 18, 24])
def test_mirror_board_at_forced_plans(t, stripe_h):
    """Every launch depth, stripes as short as the frontier's reach allows,
    a single stripe, and boards whose windows wrap onto themselves."""
    frontier = cuda_adaptive._round8(t + 6) <= stripe_h
    plan = cuda_adaptive.AdaptivePlan(t, stripe_h, frontier)
    b = make_board("glider", 64, 128, stripe_h)
    _put(b, np.ones((1, 3), dtype=bool), 40, 70)
    p = tpacked.pack(torch.from_numpy(b))
    turns = t * 10 + 11
    got, _, _ = cuda_adaptive.adaptive_superstep(p, tlife.HIGHLIFE, turns, plan)
    np.testing.assert_array_equal(words(got), words(tpacked.superstep(p, tlife.HIGHLIFE, turns)))


def test_superstep_bytes_with_stats():
    b = make_board("glider", 160, 4096, 16)
    fn = cuda_packed.make_superstep_bytes(tlife.CONWAY, "cpu", skip_stable=True,
                                          skip_tile_cap=16, with_stats=True)
    got, sk, act = fn(b, 100)
    want = cuda_packed.make_superstep_bytes(tlife.CONWAY, "cpu")(b, 100)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert act.shape == (10,) and int(sk) > 0
    # A board the adaptive tier does not take (H % 8 != 0) returns empty stats.
    odd = make_board("soup", 60, 64, 8)
    got, sk, act = fn(odd, 20)
    np.testing.assert_array_equal(got.numpy(), cuda_packed.make_superstep_bytes(device="cpu")(odd, 20).numpy())
    assert int(sk) == 0 and act.numel() == 0
    # A forced plan reaches the adaptive driver.
    plan = cuda_adaptive.AdaptivePlan(6, 16, False)
    forced = cuda_packed.make_superstep_bytes(tlife.CONWAY, "cpu", skip_stable=True,
                                              with_stats=True, plan=plan)
    got, sk, act = forced(b, 100)
    _, wsk, wact = cuda_adaptive.adaptive_superstep_mirror(
        tpacked.pack(torch.from_numpy(b)), tlife.CONWAY, 100, plan)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(sk) == int(wsk) and torch.equal(act, wact)
    # Without skip_stable a resident board returns (board, 0, empty).
    plain = cuda_packed.make_superstep_bytes(tlife.CONWAY, "cpu", with_stats=True)
    got, sk, act = plain(b, 30)
    assert int(sk) == 0 and act.numel() == 0


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,turns,cap,plan",
    [
        ((16384, 512), 10**5, 0, cuda_adaptive.AdaptivePlan(
            cuda_adaptive.ADAPTIVE_T, cuda_adaptive.SKIP_TILE_CAP, True)),
        ((64, 128), 211, 16, cuda_adaptive.AdaptivePlan(12, 16, False)),
        ((72, 128), 12, 0, cuda_adaptive.AdaptivePlan(12, 72, True)),
        ((1000, 96), 6, 0, cuda_adaptive.AdaptivePlan(6, 200, True)),
        ((64, 128), 5, 0, None),
        ((60, 128), 100, 0, None),
    ],
)
def test_adaptive_plan(shape, turns, cap, plan):
    assert cuda_adaptive.adaptive_plan(shape, turns, cap) == plan
    if plan is not None:
        assert shape[0] % plan.stripe_h == 0 and plan.stripe_h % 8 == 0
        assert plan.stripe_h <= (cap or cuda_adaptive.SKIP_TILE_CAP)


@pytest.mark.parametrize("cap", [0, 8, 16, 256])
def test_every_plan_keeps_its_probe_halo_within_a_stripe(cap):
    """The one plan rule of K4, K11 and K13 (the JAX plan's pad <= tile_h):
    round8(T) <= stripe_h for every plan of a board, a strip and a 2-D
    tile, at every height from 8 to 4096 rows; T is the deepest multiple
    of 6 (up to 24) that fits (so never 18: round8(18) = 24 fits 24), and
    the 2-D plan's x-halo holds T + 6.  The strip plan is the same
    function as the board's."""
    from distributed_gol_torch.parallel import cuda_halo

    assert cuda_halo.adaptive_strip_plan is cuda_adaptive.adaptive_plan
    seen = set()
    for h in range(8, 4097):
        tile = cuda_halo.adaptive_tile_plan((h, 4), 10**6, cap)
        plans = [cuda_adaptive.adaptive_plan((h, 4), 10**6, cap), tile[0] if tile else None]
        assert len(set(plans)) == 1 and (plans[0] is None) == (h % 8 != 0)
        plan = plans[0]
        if plan is None:
            continue
        assert cuda_adaptive._round8(plan.t) <= plan.stripe_h
        assert plan.t == min(cuda_adaptive.ADAPTIVE_T, plan.stripe_h // 6 * 6)
        assert tile[1] * 32 >= plan.t + cuda_adaptive.SKIP_PERIOD
        seen.add(plan.t)
    assert seen == {8: {6}, 16: {6, 12}}.get(cap, {6, 12, 24})


@pytest.mark.parametrize(
    "kw", [dict(t=5, stripe_h=16, frontier=False), dict(t=30, stripe_h=64, frontier=True),
           dict(t=18, stripe_h=16, frontier=True), dict(t=6, stripe_h=0, frontier=False)],
)
def test_invalid_plans_raise(kw):
    with pytest.raises(ValueError):
        cuda_adaptive.AdaptivePlan(**kw)


def test_stripe_tiles_fit_shared_memory():
    for shape, stripe_h, halo in [((16384, 512), 256, 24), ((16384, 512), 1024, 30),
                                  ((64, 128), 16, 8), ((2048, 1), 2048, 30)]:
        tiles = cuda_adaptive.stripe_tiles(shape, stripe_h, halo)
        assert stripe_h % tiles.tile_h == 0 and tiles.t == halo
        assert tiles.smem_bytes <= cuda_packed.SMEM_BYTES
        assert tiles.cols_w <= cuda_packed.TILED_COLS
        assert tiles.xpad * 32 >= halo


def test_cpu_wrappers_run_plain_versions_without_counting():
    cuda_adaptive.reset_launches()
    b = make_board("glider", 64, 256, 16)
    p = tpacked.pack(torch.from_numpy(b))
    cuda_adaptive.adaptive_superstep(p, tlife.CONWAY, 211, cuda_adaptive.AdaptivePlan(6, 16, True))
    cuda_adaptive.tiled_skip_superstep(p, tlife.CONWAY, 12)
    counts = (cuda_adaptive.frontier_superstep.launches, cuda_adaptive.probing_superstep.launches,
              cuda_adaptive.tiled_skip_superstep.launches)
    assert counts == (0, 0, 0)


def test_wrappers_reject_bad_input():
    p = tpacked.pack(torch.from_numpy(make_board("dead", 64, 64, 16)))
    with pytest.raises(ValueError):
        cuda_adaptive.tiled_skip_superstep(p, tlife.CONWAY, 8)
    with pytest.raises(ValueError):
        cuda_adaptive.frontier_superstep(p, tlife.CONWAY, cuda_adaptive.AdaptivePlan(6, 8, False), 8)
    with pytest.raises(ValueError):
        cuda_adaptive.probing_superstep(p.to(torch.int64), tlife.CONWAY,
                                        cuda_adaptive.AdaptivePlan(6, 8, False), 1)


# -- gol.run and the Backend, end to end ------------------------------------


def force_plan(monkeypatch, ref):
    """Make the port plan every dispatch as the JAX package does."""

    def plan(shape, turns, cap=0):
        t, adaptive = ref.pallas.adaptive_launch_depth(shape, turns, cap)
        if not adaptive:
            return None
        return jax_plan(ref, shape, turns, cap)

    monkeypatch.setattr(cuda_adaptive, "adaptive_plan", plan)


@pytest.mark.parametrize(
    "shape,cap,superstep,forced",
    [((256, 4096), 256, 211, False), ((64, 4096), 16, 79, True)],
    ids=["frontier", "probing"],
)
def test_run_matches_jax_with_skip_stable(tmp_path, monkeypatch, ref, shape, cap, superstep, forced):
    """``gol.run`` with ``skip_stable=True``: the same event stream and PGMs
    in both packages, through the frontier path (the port at its own plan)
    and the probing path (the port at the JAX plan; 64x4096 is a K1 board
    here, so the explicit request warns)."""
    from test_torch_run import SOUP, assert_same_run

    if forced:
        force_plan(monkeypatch, ref)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "skip_stable forces", UserWarning)
        events = assert_same_run(
            tmp_path, turns=3 * superstep, superstep=superstep, image_height=shape[0],
            image_width=shape[1], engine="pallas-packed", skip_stable=True,
            skip_tile_cap=cap, turn_events="batch", **SOUP,
        )
    report = [f for n, f in events if n == "MetricsReport"][0]
    assert dict(report)["info"]["backend.engine"] == "pallas-packed"


def test_backends_report_the_same_skip_telemetry(tmp_path, monkeypatch, ref):
    """At a shared plan the two Backends give equal skip fractions and
    activity bitmaps, dispatch for dispatch, with the two-dispatch lag."""
    import distributed_gol_torch as tgol
    import distributed_gol_tpu as jgol
    from distributed_gol_torch.engine.backend import Backend as TB
    from distributed_gol_tpu.engine.backend import Backend as JB

    force_plan(monkeypatch, ref)
    h, w, cap = 512, 4096, 256
    kw = dict(image_height=h, image_width=w, engine="pallas-packed", skip_stable=True,
              skip_tile_cap=cap, out_dir=tmp_path)
    with warnings.catch_warnings():
        # 512x4096 is resident on the TPU (not here): the JAX Backend warns.
        warnings.filterwarnings("ignore", "skip_stable forces", UserWarning)
        jb = JB(jgol.Params(**kw))
    tb = TB(tgol.Params(device="cpu", **kw))
    b = make_board("ash", h, w, cap)
    _put(b, GLIDER, 100, 200)  # wakes stripe 0 only
    jboard, tboard = ref.jnp.asarray(b), tb.put(b)
    seen = []
    for _ in range(4):
        assert tb.skip_fraction() == jb.skip_fraction()
        tbm, jbm = tb.activity_bitmap(), jb.activity_bitmap()
        assert (tbm is None) == (jbm is None)
        if tbm is not None:
            np.testing.assert_array_equal(tbm, jbm)
            assert tb.activity_tile_rows() == jb.activity_tile_rows() == cap
            assert tb._active_tiles() == jb._active_tiles()
        seen.append(tb.skip_fraction())
        jboard, _ = jb.run_turns(jboard, 211)
        tboard, _ = tb.run_turns(tboard, 211)
        np.testing.assert_array_equal(tb.fetch(tboard), np.asarray(jboard))
    assert seen[:3] == [None, None, None] and 0 < seen[3] < 1


# -- the Backend surface ----------------------------------------------------


def backend(tmp_path, **kw):
    import distributed_gol_torch as tgol
    from distributed_gol_torch.engine.backend import Backend

    kw = dict(dict(engine="pallas-packed", device="cpu", out_dir=tmp_path), **kw)
    return Backend(tgol.Params(**kw))


def test_auto_engages_at_long_runs(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = backend(tmp_path, turns=10**5, image_height=72, image_width=4096)
        short = backend(tmp_path, turns=10**5 - 1, image_height=72, image_width=4096)
    assert b._superstep == b._skip_superstep and b._skip_cap == cuda_adaptive.SKIP_TILE_CAP
    assert short._superstep != short._skip_superstep


def test_auto_never_trades_the_resident_kernel(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = backend(tmp_path, turns=10**6, image_height=512, image_width=512)
    assert getattr(b, "_skip_fn", None) is None
    assert b.skip_fraction() is None and b.activity_bitmap() is None


def test_explicit_skip_stable_on_a_resident_board_warns(tmp_path):
    with pytest.warns(UserWarning, match="skip_stable forces"):
        b = backend(tmp_path, skip_stable=True, image_height=512, image_width=512)
    assert b._superstep == b._skip_superstep


def test_uncovered_rule_warns(tmp_path):
    with pytest.warns(UserWarning, match="ash period"):
        b = backend(tmp_path, skip_stable=True, image_height=72, image_width=4096,
                    rule=tlife.parse_rule("B2/S"))
    assert b._superstep == b._skip_superstep


def test_skip_gauges_and_cycle_probes(tmp_path):
    """The two gauges read the lagged stats; cycle probes and the SDC probe
    leave ``_skip_stats`` alone."""
    from distributed_gol_torch.obs import metrics as obs_metrics

    b = backend(tmp_path, skip_stable=True, image_height=80, image_width=256,
                skip_tile_cap=16)
    board = b.put(make_board("glider", 80, 256, 16))
    for _ in range(3):
        board, _ = b.run_turns(board, 60)
    stats = list(b._skip_stats)
    assert len(stats) == 3
    b.cycle_probe_async(board)
    b.cycle_counts(board)
    assert b._skip_stats == stats
    snap = obs_metrics.REGISTRY.snapshot().data
    assert snap["gauges"]["backend.skip_fraction"] == b.skip_fraction()
    assert snap["gauges"]["backend.active_tiles"] == float(b.activity_bitmap().sum())
    assert b.activity_tile_rows() == 16


def test_skip_fraction_reads_only_the_oldest_stats(tmp_path):
    """Only ``stats[-3]`` is forced: newer entries may still be in flight."""

    class Poisoned:
        def __int__(self):
            raise AssertionError("forced a dispatch still in flight")

    b = backend(tmp_path, skip_stable=True, image_height=80, image_width=256,
                skip_tile_cap=16)
    b._skip_stats = [(torch.tensor(3, dtype=torch.int32), 12, torch.tensor([1, 0, 0, 1])),
                     (Poisoned(), 12, None), (Poisoned(), 12, None)]
    assert b.skip_fraction() == 0.25
    np.testing.assert_array_equal(b.activity_bitmap(), [True, False, False, True])
