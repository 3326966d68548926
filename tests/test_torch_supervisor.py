"""The port's supervisor and fault harness against the JAX package's: the
rows of ``tests/test_supervisor.py`` and ``tests/test_retry.py``.

Units (the restart budget in both modes, the ladder's rungs and tiers,
the elastic plan, the fault plans and the corrupted cells) are compared
value for value; whole runs (``supervise`` and ``gol.run`` with
``restart_limit > 0``, the retry policy under every fault kind) by their
event streams, PGMs, ``Supervisor.history`` without ``t``, and counters
(``tests/resilience_pair.py``), with tolerance 0.
"""

import queue
import time

import numpy as np
import pytest
import torch

from tests.resilience_pair import (
    JAX,
    TORCH,
    Outcome,
    counters_during,
    flight_kinds,
    history,
    pair,
    params,
    run_events,
    supervise_events,
)

pytestmark = pytest.mark.filterwarnings("ignore:skip_stable forces")


def small(pk, d=None, **kw):
    cfg = dict(turns=24, image_width=16, image_height=16, engine="roll", superstep=4,
               soup_density=0.25, soup_seed=11, cycle_check=0, ticker_period=60.0)
    if d is not None:
        cfg["out_dir"] = d
    cfg.update(kw)
    return params(pk, **cfg)


@pytest.fixture(autouse=True)
def clean_blacklists():
    yield
    JAX.mesh.clear_blacklist()
    TORCH.mesh.clear_blacklist()


# -- the restart budget and the ladder -----------------------------------------------


def budget_script(pk):
    sup = pk.supervisor.Supervisor(small(pk, restart_limit=2), queue.Queue())
    now = time.monotonic()
    got = [sup._budget_allows(now)]
    sup.history = [{}, {}]
    got.append(sup._budget_allows(now))
    win = pk.supervisor.Supervisor(small(pk, restart_limit=2, restart_window_seconds=10.0),
                                   queue.Queue())
    win.history = [{}, {}, {}]
    win._restart_times = [now - 60.0, now - 30.0, now - 2.0]
    got.append(win._budget_allows(now))
    win._restart_times = [now - 8.0, now - 2.0]
    got.append(win._budget_allows(now))
    return got


def test_budget_modes_match_jax():
    assert budget_script(TORCH) == budget_script(JAX) == [True, False, True, False]


@pytest.mark.parametrize("factory", [False, True], ids=["default", "factory"])
def test_ladder_tiers_match_jax(factory):
    tiers = []
    for pk in (TORCH, JAX):
        f = (lambda p, a: pk.Backend(p)) if factory else None
        sup = pk.supervisor.Supervisor(small(pk, restart_limit=4), queue.Queue(),
                                       backend_factory=f)
        tiers.append([sup._ladder_tier(a) for a in range(1, 5)])
        assert (sup._ESCALATE_AT, sup._ELASTIC_AT) == (2, 3)
    assert tiers[0] == tiers[1]


def test_ladder_escalates_to_forced_ppermute(tmp_path):
    """Restart 2 rebuilds with ``in_kernel=False``: the tier policy records
    the forced fallback in both packages (an adaptive (2, 1) mesh)."""
    got = []
    for pk in (TORCH, JAX):
        p = small(pk, tmp_path, engine="pallas-packed", mesh_shape=(2, 1), skip_stable=True,
                  image_width=128, image_height=64, superstep=6, turns=36, restart_limit=3)
        sup = pk.supervisor.Supervisor(p, queue.Queue())
        b1, b2 = sup._build_backend(1), sup._build_backend(2)
        got.append((b1.sharded_tier, b2.sharded_tier, b2.sharded_tier_policy))
    assert got[0] == got[1] == ("ppermute", "ppermute", "forced-ppermute (in_kernel=False)")


def test_first_attempt_uses_given_backend():
    for pk in (TORCH, JAX):
        p = small(pk, restart_limit=1)
        backend = pk.Backend(p)
        sup = pk.supervisor.Supervisor(p, queue.Queue(), backend=backend)
        assert sup._build_backend(0) is backend
        assert sup._build_backend(1) is not backend


@pytest.mark.parametrize("survivors", ["all", "none"])
def test_plan_elastic_matches_jax(survivors):
    """All healthy: the run keeps its own mesh and records the probe; none:
    :class:`AllDevicesCondemned`."""
    got = []
    for pk in (TORCH, JAX):
        probe = ((lambda devs: (list(devs), [])) if survivors == "all"
                 else (lambda devs: ([], list(devs))))
        sup = pk.supervisor.Supervisor(small(pk, restart_limit=4), queue.Queue(),
                                       device_probe=probe)
        try:
            result = sup._plan_elastic(3)
        except pk.supervisor.AllDevicesCondemned:
            result = "AllDevicesCondemned"
        rows = [{k: v for k, v in r.items() if k != "t"} for r in sup.flight.records()]
        got.append((result, rows))
        pk.mesh.clear_blacklist()
    assert got[0] == got[1]


def test_single_device_sidesteps_a_blacklisted_default():
    """A (1, 1) Backend whose default device was condemned moves to the
    first healthy one (the virtual CPU devices here), as the JAX
    Backend moves to the next virtual host device; explicit placement
    pins; every device condemned refuses the build."""
    p = small(TORCH)
    assert TORCH.mesh.device_id(TORCH.Backend(p).device) == 0
    TORCH.mesh.condemn([0])
    JAX.mesh.condemn([0])
    assert TORCH.mesh.device_id(TORCH.Backend(p).device) == 1
    assert JAX.Backend(small(JAX)).devices[0].id == 1
    pinned = TORCH.Backend(p, devices=[TORCH.mesh.cpu_devices()[2]])
    assert TORCH.mesh.device_id(pinned.device) == 2
    # A CPU mesh's default placement is the CPU for every shard, whatever
    # is condemned: a run that needs named CPU shards passes them.
    q = small(TORCH, mesh_shape=(2, 1), image_height=32)
    assert TORCH.Backend(q).devices == [torch.device("cpu")] * 2
    TORCH.mesh.condemn(range(TORCH.mesh.CPU_DEVICE_COUNT))
    with pytest.raises(ValueError, match="blacklisted"):
        TORCH.Backend(p)


def test_blacklist_keeps_device_kinds_apart():
    """The blacklist keys a device by type and index: a condemned card
    leaves the virtual CPU device of the same index, and so every CPU
    placement, alone."""
    p = small(TORCH)
    named = TORCH.mesh.cpu_devices(2)
    assert TORCH.mesh.condemn([torch.device("cuda", 0)]) == [0]
    assert TORCH.mesh.blacklisted("cuda") == {0} and not TORCH.mesh.blacklisted("cpu")
    assert TORCH.mesh.lost_device_count() == 0
    assert TORCH.Backend(p).device == torch.device("cpu")
    assert TORCH.mesh.healthy_devices(named) == named
    assert TORCH.mesh.healthy_devices([torch.device("cuda", 0), torch.device("cpu", 0)]) == [
        torch.device("cpu", 0)]


# -- the fault plans and the harness ---------------------------------------------------


PLANS = [
    '{"faults": [{"at": 3, "kind": "issue"}, {"at": 7, "kind": "latency", "seconds": 0.05}]}',
    '{"faults": [{"at": 2, "kind": "corrupt", "cells": 5}, {"at": 4, "kind": "device_down", '
    '"device": 3}]}',
    '{"seed": 0, "n_dispatches": 64, "p_fault": 0.1, "kinds": ["issue", "resolve"], "burst": 2}',
    '{"seed": 7, "n_dispatches": 200, "p_fault": 0.3, "kinds": ["hang", "corrupt", "issue"]}',
    "{}",
]


def plan_tuple(plan):
    return [(f.at, f.kind, f.seconds, f.cells, f.device) for f in plan.faults]


@pytest.mark.parametrize("spec", PLANS)
def test_fault_plans_match_jax(spec, tmp_path):
    """The same JSON (inline and from a file) gives the same schedule."""
    path = tmp_path / "plan.json"
    path.write_text(spec)
    for source in (spec, str(path)):
        assert plan_tuple(TORCH.faults.FaultPlan.from_json(source)) == plan_tuple(
            JAX.faults.FaultPlan.from_json(source))
    t = TORCH.faults.FaultPlan.random(11, 50, p_fault=0.2, kinds=("issue", "hang"), burst=3)
    j = JAX.faults.FaultPlan.random(11, 50, p_fault=0.2, kinds=("issue", "hang"), burst=3)
    assert plan_tuple(t) == plan_tuple(j) and len(t) == len(j)
    assert TORCH.faults.FAULT_KINDS == JAX.faults.FAULT_KINDS


@pytest.mark.parametrize(
    "kw", [dict(at=-1, kind="issue"), dict(at=0, kind="nope"), dict(at=0, kind="latency", seconds=-1),
           dict(at=0, kind="corrupt", cells=0), dict(at=0, kind="device_down", device=-2)])
def test_fault_validation_matches_jax(kw):
    for pk in (TORCH, JAX):
        with pytest.raises(ValueError):
            pk.faults.Fault(**kw)
    for pk in (TORCH, JAX):
        with pytest.raises(ValueError, match="two faults"):
            pk.faults.FaultPlan([pk.faults.Fault(1, "issue"), pk.faults.Fault(1, "resolve")])
        for kind in ("flood", "pod_down"):
            with pytest.raises(ValueError):
                pk.faults.FaultInjectionBackend(
                    pk.Backend(small(pk)), pk.faults.FaultPlan([pk.faults.Fault(0, kind)]))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 1)])
def test_corrupt_fault_flips_the_jax_cells(mesh_shape):
    """The same plan corrupts the same cells: a whole board or a sharded
    one (flipped shard by shard on the port), silently."""
    b = np.where(np.random.default_rng(42).random((32, 64)) < 0.3, 255, 0).astype(np.uint8)
    boards = []
    for pk in (TORCH, JAX):
        p = small(pk, image_height=32, image_width=64, mesh_shape=mesh_shape, engine="packed")
        plan = pk.faults.FaultPlan([pk.faults.Fault(1, "corrupt", cells=7)])
        h = pk.faults.FaultInjectionBackend(pk.Backend(p), plan)
        x = h.put(b)
        x, _ = h.run_turns(x, 4)
        x, count = h.run_turns(x, 4)
        boards.append((np.asarray(h.fetch(x)), count, [f.kind for f in h.injected]))
    assert np.array_equal(boards[0][0], boards[1][0])
    assert boards[0][1:] == boards[1][1:] == (boards[0][1], ["corrupt"])


def test_device_down_strikes_the_named_device():
    """``device_down`` fails every dispatch of a Backend that computes on
    the dead device, retries and rebound Backends included, and leaves
    a Backend on other devices alone."""
    p = small(TORCH, mesh_shape=(4, 1), image_height=32, image_width=64, engine="packed")
    devs = TORCH.mesh.cpu_devices(4)
    h = TORCH.faults.FaultInjectionBackend(
        TORCH.Backend(p, devices=devs),
        TORCH.faults.FaultPlan([TORCH.faults.Fault(1, "device_down", device=3)]))
    x = h.put(np.zeros((32, 64), np.uint8))
    h.run_turns(x, 1)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device_down"):
            h.run_turns(x, 1)
    healthy, condemned = h.device_probe(devs)
    assert [TORCH.mesh.device_id(d) for d in condemned] == [3]
    q = small(TORCH, mesh_shape=(2, 1), image_height=32, image_width=64, engine="packed")
    h.rebind(TORCH.Backend(q, devices=healthy[:2]))
    h.run_turns(h.put(np.zeros((32, 64), np.uint8)), 1)
    assert h.down_devices == {("cpu", 3)}


# -- whole runs: retry, supervise, gol.run --------------------------------------------


def retry_run(pk, d, faults, **kw):
    p = small(pk, d, turns=20, superstep=5, soup_density=0.3, soup_seed=7, **kw)
    plan = pk.faults.FaultPlan([pk.faults.Fault(*f) if isinstance(f, tuple) else f(pk)
                                for f in faults])
    backend = pk.faults.FaultInjectionBackend(pk.Backend(p), plan)
    session = pk.Session()
    (events, error), counters = counters_during(
        pk, lambda: run_events(pk, p, session=session, backend=backend))
    ckpt = session.check_states(p.image_width, p.image_height)
    return Outcome(events, d, counters=counters, error=error,
                   extra=dict(ckpt_turn=None if ckpt is None else ckpt.turn,
                              injected=[(f.at, f.kind) for f in backend.injected],
                              dispatches=backend.dispatches))


RETRY_ROWS = {
    "single-issue": ([(1, "issue")], {}),
    "double-issue": ([(1, "issue"), (2, "issue")], {}),
    "resolve": ([(1, "resolve")], {}),
    "resolve-terminal": ([(2, "resolve"), (3, "resolve")], {}),
    "mid-run": ([(3, "issue"), (4, "issue")], {}),
    "retry-limit-3": ([(1, "issue"), (2, "issue"), (3, "issue"), (4, "issue")],
                      dict(retry_limit=3)),
    "retry-limit-0": ([(2, "issue")], dict(retry_limit=0)),
    "failure-budget": ([(0, "issue"), (2, "issue"), (4, "issue")], dict(failure_budget=2)),
    "latency": ([lambda pk: pk.faults.Fault(1, "latency", seconds=0.05)], {}),
    "backoff": ([(1, "issue"), (2, "issue")], dict(retry_limit=2,
                                                    retry_backoff_seconds=0.01)),
}


@pytest.mark.parametrize("row", RETRY_ROWS)
def test_retry_policy_matches_jax(row, tmp_path):
    faults, kw = RETRY_ROWS[row]
    _, t = pair(retry_run, tmp_path, faults=faults, **kw)
    assert t.extra["injected"]


def test_supervise_preserves_clean_runs(tmp_path):
    def scenario(pk, d):
        p = small(pk, d, restart_limit=2, checkpoint_every_turns=4)
        events, sup, error = supervise_events(pk, p, session=pk.Session())
        return Outcome(events, d, history=history(sup), error=error,
                       kinds=flight_kinds(d))

    _, t = pair(scenario, tmp_path)
    assert t.history == [] and t.kinds is None and t.error is None


@pytest.mark.parametrize("restart_limit", [1, 2])
def test_gol_run_routes_to_the_supervisor(restart_limit, tmp_path):
    """``gol.run`` with ``restart_limit > 0`` (a refusal until the
    supervisor was ported) survives a terminal burst through the DEFAULT
    ladder, as the JAX package does."""

    def scenario(pk, d):
        p = small(pk, d, restart_limit=restart_limit, checkpoint_every_turns=4)
        backend = pk.faults.FaultInjectionBackend(
            pk.Backend(p), pk.faults.FaultPlan([pk.faults.Fault(2, "issue"),
                                                pk.faults.Fault(3, "issue")]))
        (events, error), counters = counters_during(
            pk, lambda: run_events(pk, p, session=pk.Session(), backend=backend))
        return Outcome(events, d, counters=counters, error=error)

    _, t = pair(scenario, tmp_path)
    assert t.error is None and t.counters["supervisor.restarts"] == 1


def test_sentinel_abort_unsupervised_is_terminal_but_clean(tmp_path):
    def scenario(pk, d):
        p = small(pk, d, sdc_check_every_turns=4)
        backend = pk.faults.FaultInjectionBackend(
            pk.Backend(p), pk.faults.FaultPlan([pk.faults.Fault(1, "corrupt", cells=3)]))
        session = pk.Session()
        events, error = run_events(pk, p, session=session, backend=backend)
        return Outcome(events, d, error=error, kinds=flight_kinds(d),
                       extra=dict(parked=session.check_states(16, 16) is not None))

    _, t = pair(scenario, tmp_path)
    assert t.error == "CorruptionDetected" and not t.extra["parked"]
    assert "sdc_mismatch" in t.kinds


def test_telemetry_sampler_rides_a_supervised_run(tmp_path, monkeypatch):
    """``telemetry_sample_seconds > 0`` (a refusal until the sampler was
    armed by ``gol.run``) samples the registry for the run's lifetime,
    through a restart, and is stopped when the run ends; the stream is
    the JAX package's."""
    from distributed_gol_torch.obs import timeseries as tts

    made = []

    class Recorded(tts.TelemetrySampler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tts, "TelemetrySampler", Recorded)

    def scenario(pk, d):
        p = small(pk, d, restart_limit=1, checkpoint_every_turns=4,
                  telemetry_sample_seconds=0.02)
        plan = pk.faults.FaultPlan([pk.faults.Fault(2, "issue"), pk.faults.Fault(3, "issue")]
                                   + [pk.faults.Fault(i, "latency", seconds=0.03)
                                      for i in range(4, 9)])
        backend = pk.faults.FaultInjectionBackend(pk.Backend(p), plan)
        (events, error), counters = counters_during(
            pk, lambda: run_events(pk, p, session=pk.Session(), backend=backend))
        return Outcome(events, d, counters=counters, error=error)

    _, t = pair(scenario, tmp_path)
    assert t.error is None and t.counters["supervisor.restarts"] == 1
    assert len(made) == 1 and made[0].interval == 0.02
    assert made[0].samples(), "the sampler's ring is empty"
    assert made[0]._thread is None or not made[0]._thread.is_alive()
