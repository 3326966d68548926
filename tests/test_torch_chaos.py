"""The chaos matrix for the port: execution tier x fault kind, held to the
JAX package's outcomes (the rows of ``tests/test_chaos.py`` and
``tests/test_elastic.py``).

Every row runs the same seeded soup under the same ``FaultPlan`` in both
packages and compares (``tests/resilience_pair.py``, tolerance 0): the
event streams, the PGMs, ``Supervisor.history`` without ``t``, the
counters, the flight dump's record kinds and the parked checkpoint.
Each row also holds the recovered or resumed board to the fault-free
run's.  A hang is bounded by the dispatch watchdog, and each row that
waits on one runs under its own time limit (``within``); injected hangs
are released before the row ends.  Device faults use the virtual CPU
devices (``parallel.mesh.cpu_devices``) and clear the blacklist after
each row.
"""

import queue
import time
import warnings

import numpy as np
import pytest

from tests.resilience_pair import (
    JAX,
    TORCH,
    Outcome,
    counters_during,
    flight_kinds,
    history,
    pair,
    params,
    pgms,
    run_events,
    supervise_events,
    within,
)

pytestmark = [pytest.mark.chaos, pytest.mark.filterwarnings("ignore:skip_stable forces")]

# Each tier: 6 dispatches of `superstep` turns on a seeded soup; explicit
# superstep and cycle_check=0 keep the dispatch schedule (the fault-plan
# indices) exact and the same in both packages.
TIERS = {
    "single": dict(engine="roll", mesh_shape=(1, 1), image_width=16, image_height=16,
                   superstep=4, turns=24),
    "sharded-ppermute": dict(engine="packed", mesh_shape=(8, 1), image_width=64,
                             image_height=64, superstep=5, turns=30),
    # The adaptive strip tier; at cap 16 neither package's plan has a
    # frontier form on these 32-row strips, so their tier records agree.
    "sharded-adaptive": dict(engine="pallas-packed", mesh_shape=(2, 1), skip_stable=True,
                             skip_tile_cap=16, image_width=128, image_height=64,
                             superstep=6, turns=36),
}


def tier_params(pk, tier, out_dir, **kw):
    cfg = dict(TIERS[tier])
    cfg.update(soup_density=0.25, soup_seed=11, out_dir=out_dir, cycle_check=0,
               ticker_period=60.0)
    cfg.update(kw)
    return params(pk, **cfg)


@pytest.fixture(autouse=True)
def clean_blacklists():
    yield
    JAX.mesh.clear_blacklist()
    TORCH.mesh.clear_blacklist()


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The fault-free run's final PGM per tier (the port's; the JAX
    package's is compared with it in ``test_fault_free_runs_match``)."""
    cache = {}

    def get(tier):
        if tier not in cache:
            out = tmp_path_factory.mktemp(f"oracle-{tier}")
            run_events(TORCH, tier_params(TORCH, tier, out))
            cache[tier] = pgms(out)
        return cache[tier]

    return get


def plan(pk, *faults):
    return pk.faults.FaultPlan([pk.faults.Fault(*f) if isinstance(f, tuple)
                                else pk.faults.Fault(**f) for f in faults])


def harness(pk, p, *faults):
    return pk.faults.FaultInjectionBackend(pk.Backend(p), plan(pk, *faults))


def warmed(backend, p):
    """``backend`` with its SDC probe for ``p``'s dispatch depth already
    run once, on an all-dead board.  The JAX Backend compiles that probe
    per instance (the adaptive tier's in interpret mode), and the probe
    runs under the dispatch watchdog, so on a loaded worker a rebuilt
    Backend's first probe can outlast a short deadline.  A row that
    rebuilds under one warms each Backend before the supervisor takes
    it, so that only an injected hang outlasts the deadline.  The probe
    counts nothing, so both packages are warmed alike."""
    dead = backend.put(np.zeros((p.image_height, p.image_width), np.uint8))
    backend.sdc_probe(dead, dead, p.superstep, 0)
    return backend


def parked_turn(pk, session, p):
    ckpt = session.check_states(p.image_width, p.image_height)
    if ckpt is None:
        return None
    session.pause(True, world=ckpt.world, turn=ckpt.turn)  # re-park (consumed)
    return ckpt.turn


def resume(pk, tier, d, session):
    out = d / "resumed"
    out.mkdir()
    events, error = run_events(pk, tier_params(pk, tier, out), session=session)
    assert error is None
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_fault_free_runs_match(tier, tmp_path):
    def scenario(pk, d):
        events, error = run_events(pk, tier_params(pk, tier, d))
        return Outcome(events, d, error=error)

    pair(scenario, tmp_path)


@pytest.mark.parametrize("kind", ["issue", "resolve"])
@pytest.mark.parametrize("tier", TIERS)
def test_transient_fault_recovers_bit_identically(tier, kind, tmp_path, oracle):
    def scenario(pk, d):
        p = tier_params(pk, tier, d)
        session = pk.Session()
        (events, error), counters = counters_during(
            pk, lambda: run_events(pk, p, session=session, backend=harness(pk, p, (1, kind))))
        return Outcome(events, d, counters=counters, error=error, kinds=flight_kinds(d),
                       extra=dict(parked=parked_turn(pk, session, p)))

    _, t = pair(scenario, tmp_path)
    errors = [e for e in t.events if type(e).__name__ == "DispatchError"]
    assert [e.will_retry for e in errors] == [True]
    assert t.kinds is None and t.extra["parked"] is None and t.error is None
    assert pgms(t.out) == oracle(tier)


@pytest.mark.parametrize("tier", TIERS)
def test_burst_aborts_cleanly_and_resumes(tier, tmp_path, oracle):
    """A 2-failure burst defeats the retry budget: sentinel-terminated
    abort, last good board parked, resume lands on the fault-free board."""

    def scenario(pk, d):
        p = tier_params(pk, tier, d)
        session = pk.Session()
        events, error = run_events(pk, p, session=session,
                                   backend=harness(pk, p, (2, "issue"), (3, "issue")))
        turn = parked_turn(pk, session, p)
        out = resume(pk, tier, d, session)
        return Outcome(events, d, error=error, kinds=flight_kinds(d),
                       extra=dict(parked=turn, resumed=pgms(out)))

    _, t = pair(scenario, tmp_path)
    assert t.error == "RuntimeError" and "abort" in t.kinds
    assert 0 < t.extra["parked"] < TIERS[tier]["turns"]
    assert t.extra["resumed"] == oracle(tier)


@pytest.mark.parametrize("tier", TIERS)
def test_hang_is_bounded_by_the_watchdog(tier, tmp_path, oracle):
    """A dispatch that never resolves aborts by DispatchTimeout within the
    deadline — sentinel, parked checkpoint, resumable — in both packages."""

    def scenario(pk, d):
        p = tier_params(pk, tier, d, dispatch_deadline_seconds=1.0)
        h = harness(pk, p, dict(at=1, kind="hang", seconds=90.0))
        session = pk.Session()
        t0 = time.monotonic()
        try:
            events, error = within(60, lambda: run_events(pk, p, session=session, backend=h))
        finally:
            h.release_hangs()
        elapsed = time.monotonic() - t0
        turn = parked_turn(pk, session, p)
        out = resume(pk, tier, d, session)
        return Outcome(events, d, error=error, kinds=flight_kinds(d),
                       extra=dict(parked=turn, resumed=pgms(out), bounded=elapsed < 45))

    _, t = pair(scenario, tmp_path)
    assert t.error == "DispatchTimeout" and t.extra["bounded"]
    assert "watchdog_fire" in t.kinds
    assert t.extra["parked"] == TIERS[tier]["superstep"]
    assert t.extra["resumed"] == oracle(tier)


@pytest.mark.parametrize("tier", TIERS)
def test_torn_checkpoint_skipped_for_older_intact_pair(tier, tmp_path, oracle):
    """Tearing the newest checkpoint worlds makes a fresh session fall back
    to the newest intact pair, warn, and land on the fault-free board."""
    s = TIERS[tier]["superstep"]

    def scenario(pk, d):
        ckpt = d / "ckpt"
        p = tier_params(pk, tier, d, checkpoint_every_turns=s)
        events, error = run_events(pk, p, session=pk.Session(ckpt),
                                   backend=harness(pk, p, (2, "issue"), (3, "issue")))
        kinds = flight_kinds(ckpt)
        for path in (ckpt / "checkpoint.pgm", ckpt / f"checkpoint-{2 * s:012d}.pgm"):
            path.write_bytes(path.read_bytes()[: max(8, path.stat().st_size // 2)])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = resume(pk, tier, d, pk.Session(ckpt))
        torn = sum(issubclass(w.category, RuntimeWarning) for w in caught)
        return Outcome(events, d, error=error, kinds=kinds,
                       extra=dict(resumed=pgms(out), warned=torn > 0))

    _, t = pair(scenario, tmp_path)
    assert "checkpoint" in t.kinds and t.extra["warned"]
    assert t.extra["resumed"] == oracle(tier)


# -- the supervisor rows ----------------------------------------------------------------


def first_attempt_faulty(pk, *faults):
    def factory(p, attempt):
        b = pk.Backend(p)
        return pk.faults.FaultInjectionBackend(b, plan(pk, *faults)) if attempt == 0 else b

    return factory


def supervised(pk, d, p, factory, **kw):
    session = pk.Session()
    (events, sup, error), counters = counters_during(
        pk, lambda: supervise_events(pk, p, session=session, backend_factory=factory, **kw))
    return Outcome(events, d, history=history(sup) if sup else None, counters=counters,
                   error=error, kinds=flight_kinds(d),
                   extra=dict(parked=parked_turn(pk, session, p),
                              recovered=bool(sup and sup.recovery_times())))


@pytest.mark.parametrize("tier", TIERS)
def test_supervisor_survives_terminal_burst(tier, tmp_path, oracle):
    s = TIERS[tier]["superstep"]

    def scenario(pk, d):
        p = tier_params(pk, tier, d, checkpoint_every_turns=s, restart_limit=2)
        return supervised(pk, d, p, first_attempt_faulty(pk, (2, "issue"), (3, "issue")))

    _, t = pair(scenario, tmp_path)
    assert [r["cause"] for r in t.history] == ["RuntimeError"]
    assert [r["tier"] for r in t.history] == ["factory"]
    assert t.extra["recovered"] and t.kinds is None and t.extra["parked"] is None
    assert t.counters["supervisor.restarts"] == 1 and t.counters["faults.retries"] == 1
    assert pgms(t.out) == oracle(tier)


@pytest.mark.parametrize("tier", TIERS)
def test_corrupt_is_detected_and_rolled_back(tier, tmp_path, oracle):
    s = TIERS[tier]["superstep"]

    def scenario(pk, d):
        p = tier_params(pk, tier, d, checkpoint_every_turns=s, sdc_check_every_turns=s,
                        restart_limit=2)
        return supervised(pk, d, p, first_attempt_faulty(pk, dict(at=2, kind="corrupt",
                                                                  cells=3)))

    _, t = pair(scenario, tmp_path)
    assert t.history[0]["cause"] == "CorruptionDetected"
    assert (t.history[0]["from_turn"], t.history[0]["resume_turn"]) == (3 * s, 2 * s)
    assert t.counters["sdc.mismatches"] == 1 and t.counters["supervisor.rollback_turns"] == s
    assert pgms(t.out) == oracle(tier)


@pytest.mark.parametrize("tier", ["single", "sharded-adaptive"])
def test_every_fault_kind_through_the_ladder(tier, tmp_path, oracle):
    """One harness across the attempts: a corrupt fault (caught by the
    sentinel, rolled back), a hang past the watchdog (rebuilt), then an
    issue burst — three restarts, the third on the elastic rung with every
    device healthy."""
    s = TIERS[tier]["superstep"]
    faults = [dict(at=1, kind="corrupt", cells=3), dict(at=4, kind="hang", seconds=60.0),
              (7, "issue"), (8, "issue")]

    def scenario(pk, d):
        p = tier_params(pk, tier, d, checkpoint_every_turns=s, sdc_check_every_turns=s,
                        restart_limit=3, dispatch_deadline_seconds=1.0)
        h = pk.faults.FaultInjectionBackend(warmed(pk.Backend(p), p), plan(pk, *faults))
        factory = (lambda q, attempt: h if attempt == 0 else h.rebind(warmed(pk.Backend(q), q)))
        session = pk.Session()
        try:
            (events, sup, error), counters = within(60, lambda: counters_during(
                pk, lambda: supervise_events(pk, p, session=session, backend_factory=factory)))
        finally:
            h.release_hangs()
        return Outcome(events, d, history=history(sup) if sup else None, counters=counters,
                       error=error, kinds=flight_kinds(d),
                       extra=dict(injected=[f.kind for f in h.injected]))

    _, t = pair(scenario, tmp_path)
    assert t.error is None and t.extra["injected"] == ["corrupt", "hang", "issue", "issue"]
    assert [r["cause"] for r in t.history] == ["CorruptionDetected", "DispatchTimeout",
                                               "RuntimeError"]
    assert [r["tier"] for r in t.history] == ["factory", "factory", "elastic"]
    assert pgms(t.out) == oracle(tier)


def test_default_ladder_keeps_the_callers_placement(tmp_path):
    """The default ladder rebuilds on the devices the caller placed the
    first attempt on (a virtual mesh of the virtual CPU devices here), and
    forces the ppermute tier from its second restart."""
    p = tier_params(TORCH, "sharded-adaptive", tmp_path, restart_limit=3)
    devs = TORCH.mesh.cpu_devices(2)
    sup = TORCH.supervisor.Supervisor(p, queue.Queue(), backend=TORCH.Backend(p, devices=devs))
    for attempt, policy_forced in ((1, False), (2, True)):
        b = sup._build_backend(attempt)
        assert b.devices == devs
        assert (b.sharded_tier_policy == "forced-ppermute (in_kernel=False)") == policy_forced


def test_restart_exhaustion_degrades_to_clean_abort(tmp_path):
    def scenario(pk, d):
        p = tier_params(pk, "single", d, checkpoint_every_turns=4, restart_limit=2)

        def always_faulty(q, attempt):
            return pk.faults.FaultInjectionBackend(pk.Backend(q),
                                                   plan(pk, (0, "issue"), (1, "issue")))

        return supervised(pk, d, p, always_faulty)

    _, t = pair(scenario, tmp_path)
    assert t.error == "RuntimeError" and t.history is None
    assert t.kinds.count("restart") == 2 and "supervisor_exhausted" in t.kinds


class _StopAfter:
    """A graceful-stop latch that reads raised from its ``n``-th read on:
    the same turn boundary in both packages."""

    def __init__(self, n: int):
        self.n, self.reads, self.signum = n, 0, None

    @property
    def requested(self) -> bool:
        self.reads += 1
        return self.reads >= self.n


@pytest.mark.parametrize("tier", TIERS)
def test_preempt_mid_run_yields_resumable_checkpoint(tier, tmp_path, oracle):
    def scenario(pk, d):
        ckpt = d / "ckpt"
        p = tier_params(pk, tier, d)
        events, error = run_events(pk, p, session=pk.Session(ckpt), stop=_StopAfter(3))
        out = resume(pk, tier, d, pk.Session(ckpt))
        return Outcome(events, d, ckpt_dir=None, error=error, kinds=flight_kinds(ckpt),
                       extra=dict(resumed=pgms(out)))

    _, t = pair(scenario, tmp_path)
    final = [e for e in t.events if type(e).__name__ == "FinalTurnComplete"][0]
    assert final.alive == () and 0 < final.completed_turns < TIERS[tier]["turns"]
    assert t.kinds is None and t.extra["resumed"] == oracle(tier)


def test_wallclock_checkpoint_is_verified_before_park(tmp_path, oracle):
    def scenario(pk, d):
        p = tier_params(pk, "single", d, checkpoint_every_seconds=1e-6,
                        sdc_check_every_turns=10**6, restart_limit=2)
        return supervised(pk, d, p, first_attempt_faulty(pk, dict(at=2, kind="corrupt",
                                                                  cells=3)))

    _, t = pair(scenario, tmp_path)
    assert t.history[0]["cause"] == "CorruptionDetected"
    assert (t.history[0]["from_turn"], t.history[0]["resume_turn"]) == (12, 8)
    assert pgms(t.out) == oracle("single")


# -- the elastic rung on the virtual CPU devices ----------------------------------------


def persistent(pk, p, *faults):
    """ONE harness across every attempt (``rebind``), so a ``device_down``
    stays down; the port's Backends are placed on the virtual CPU
    devices, which the blacklist can name (the JAX package's default
    placement uses its 8 virtual host devices)."""

    def build(q):
        if not pk.torch:
            return pk.Backend(q)
        return pk.Backend(q, devices=pk.mesh.healthy_devices(pk.mesh.cpu_devices()))

    h = pk.faults.FaultInjectionBackend(build(p), plan(pk, *faults))
    return h, (lambda q, attempt: h if attempt == 0 else h.rebind(build(q)))


SHARDED = dict(engine="packed", mesh_shape=(8, 1), image_width=64, image_height=64,
               superstep=5, turns=30)


@pytest.mark.parametrize(
    "cfg,shrunk",
    [(SHARDED, [2, 2]),
     (dict(SHARDED, mesh_shape=(2, 4), image_width=128), [2, 2])],
    ids=["8x1", "2x4"],
)
def test_device_down_recovers_on_a_shrunken_mesh(cfg, shrunk, tmp_path):
    """A persistent ``device_down`` defeats the same-tier and forced rungs;
    the elastic rung condemns the device and rebuilds on the largest
    healthy mesh, restoring the checkpoint resharded."""

    def scenario(pk, d):
        p = params(pk, **cfg, soup_density=0.25, soup_seed=11, out_dir=d, cycle_check=0,
                   ticker_period=60.0, checkpoint_every_turns=5, restart_limit=3)
        h, factory = persistent(pk, p, dict(at=2, kind="device_down", device=7))
        out = supervised(pk, d, p, factory, device_probe=h.device_probe)
        out.extra["blacklist"] = sorted(pk.mesh.blacklisted())
        pk.mesh.clear_blacklist()
        fresh = d / "fault-free"
        fresh.mkdir()
        run_events(pk, params(pk, **cfg, soup_density=0.25, soup_seed=11, out_dir=fresh,
                              cycle_check=0, ticker_period=60.0))
        out.extra["fault_free"] = pgms(fresh)
        return out

    _, t = pair(scenario, tmp_path)
    assert [r["tier"] for r in t.history] == ["factory", "factory", "elastic"]
    assert t.history[2]["mesh_shape"] == shrunk and t.history[2]["excluded_devices"] == [7]
    assert t.extra["blacklist"] == [7] and t.counters["mesh.devices_lost"] == 1
    assert pgms(t.out) == t.extra["fault_free"]


def test_device_down_unsupervised_is_the_sentinel_abort(tmp_path):
    def scenario(pk, d):
        p = params(pk, **SHARDED, soup_density=0.25, soup_seed=11, out_dir=d,
                   cycle_check=0, ticker_period=60.0)
        h, _ = persistent(pk, p, dict(at=2, kind="device_down", device=7))
        session = pk.Session()
        events, error = run_events(pk, p, session=session, backend=h)
        return Outcome(events, d, error=error, kinds=flight_kinds(d),
                       extra=dict(parked=parked_turn(pk, session, p),
                                  blacklist=sorted(pk.mesh.blacklisted())))

    _, t = pair(scenario, tmp_path)
    assert t.error == "RuntimeError" and "device_blacklist" not in t.kinds
    assert t.extra["blacklist"] == [] and 0 < t.extra["parked"] < SHARDED["turns"]


@pytest.mark.parametrize("row", ["all-condemned", "budget-denied", "probe-fails"])
def test_the_ladder_ends_in_a_clean_abort(row, tmp_path):
    """Every device condemned (AllDevicesCondemned), the budget spent
    before the elastic rung, and a device probe that raises: each ends in
    the sentinel abort with the same flight record as the JAX package's."""

    def scenario(pk, d):
        n = pk.mesh.CPU_DEVICE_COUNT if pk.torch else 8
        limit = 2 if row == "budget-denied" else 5
        p = tier_params(pk, "single", d, checkpoint_every_turns=4, restart_limit=limit)
        faults = ([dict(at=2 + i, kind="device_down", device=i) for i in range(n)]
                  if row == "all-condemned" else [dict(at=2, kind="device_down", device=0)])
        h, factory = persistent(pk, p, *faults)

        def broken(devs):
            raise KeyError("probe transport died")

        out = supervised(pk, d, p, factory,
                         device_probe=broken if row == "probe-fails" else h.device_probe)
        out.extra["blacklist"] = sorted(pk.mesh.blacklisted())
        pk.mesh.clear_blacklist()
        return out

    _, t = pair(scenario, tmp_path)
    assert t.error == "RuntimeError" and t.kinds[-1] == "abort"
    if row == "all-condemned":
        assert t.extra["blacklist"] == list(range(8)) and "elastic_exhausted" in t.kinds
    elif row == "budget-denied":
        assert t.kinds.count("restart") == 2 and "device_blacklist" not in t.kinds
    else:
        assert "elastic_exhausted" in t.kinds
