"""The port's time-compression tier against the JAX package's
(``engine/timecomp.py`` and the controller's fast-forward), on the
acceptance rows of ``tests/test_timecomp.py``.

Each row runs the same settled board in both packages and compares, with
tolerance 0: the event streams, the PGMs, the checkpoint sidecars
(``computed_turns``/``effective_turns`` included, timing fields dropped),
the ``timecomp.*`` counters and the flight kinds — on ``packed`` and on
``pallas-packed`` with ``skip_stable`` (the JAX kernels in interpret
mode, the port's plain versions), under Conway and HighLife.  Each row
also holds the final board to the numpy oracle's phase board.
"""

import queue
import warnings

import numpy as np
import pytest

from tests.oracle import oracle_run
from tests.resilience_pair import (
    JAX,
    TORCH,
    Outcome,
    counters_during,
    drain,
    pair,
    params,
    run_events,
    supervise_events,
    history,
    within,
)

pytestmark = pytest.mark.filterwarnings("ignore:skip_stable forces")

#: The ash board settles by generation ~10; 36 is the first multiple of 6
#: safely past it, so board(t) == board(36 + (t - 36) % 6) for t >= 36.
SETTLE = 36


def ash_board(h: int, w: int) -> np.ndarray:
    """``tests/test_timecomp.py``'s lattice of blocks and blinkers with a
    T-tetromino in a cleared centre, on an h x w torus: active at t = 0,
    whole-board period-6 ash well before ``SETTLE``, glider-free."""
    b = np.zeros((h, w), np.uint8)
    for y in range(2, h - 8, 16):
        for x in range(2, w - 8, 16):
            b[y : y + 2, x : x + 2] = 255
    for y in range(10, h - 8, 16):
        for x in range(8, w - 8, 16):
            b[y, x : x + 3] = 255
    cy, cx = h // 2, w // 2
    b[cy - 16 : cy + 16, cx - 16 : cx + 16] = 0
    b[cy, cx - 1 : cx + 2] = 255
    b[cy + 1, cx] = 255
    return b


def expected_final(board: np.ndarray, turns: int, rule) -> np.ndarray:
    out = oracle_run(board, SETTLE + (turns - SETTLE) % 6, rule)
    assert np.array_equal(out, oracle_run(out, 6, rule))  # truly periodic by SETTLE
    return out


def make(pk, d, h, w, rule="conway", **kw):
    """Write the ash board, clear the process-wide cache, and build the
    package's Params for it (compressed, probing every 2 dispatches)."""
    from importlib import import_module

    life = import_module(f"{pk.root.__name__}.models.life")
    images = d / "images"
    images.mkdir(exist_ok=True)
    pk.pgm.write_pgm(images / f"{w}x{h}.pgm", ash_board(h, w))
    pk.timecomp.CACHE.clear()
    cfg = dict(turns=10**9, image_height=h, image_width=w, images_dir=images, out_dir=d,
               engine="packed", superstep=4, cycle_check=2, time_compression=True,
               ticker_period=3600, rule=life.parse_rule(rule))
    cfg.update(kw)
    return params(pk, **cfg)


def controller_run(pk, p, backend=None, keys=None, session=None, events=None):
    """One Controller run (so its flight ring can be read): (stream, kinds,
    exception name or None)."""
    events = events if events is not None else queue.Queue()
    session = session if session is not None else pk.Session()
    ctl = pk.Controller(p, events, keys, session, backend)
    error = None
    try:
        ctl.run()
    except Exception as e:  # noqa: BLE001 — compared by type
        error = type(e).__name__
    return drain(events), [r["kind"] for r in ctl.flight.records()], error


# -- the oracle matrix -----------------------------------------------------------

MATRIX = [
    ("packed", (256, 256), "conway", 0),
    ("packed", (256, 256), "highlife", 1),
    ("pallas-packed", (256, 4096), "conway", 2),
    ("pallas-packed", (256, 4096), "highlife", 5),
]


@pytest.mark.parametrize("engine,shape,rule,offset", MATRIX,
                         ids=[f"{e}-{s[0]}x{s[1]}-{r}" for e, s, r, _ in MATRIX])
def test_compressed_run_matches_jax(tmp_path, engine, shape, rule, offset):
    turns = 10**9 + offset

    def scenario(pk, d):
        p = make(pk, d, *shape, rule=rule, turns=turns, engine=engine,
                 skip_stable=engine == "pallas-packed", superstep=48, turn_events="batch")
        (events, kinds, error), counters = counters_during(pk, lambda: controller_run(pk, p))
        return Outcome(events, d, counters=counters, kinds=kinds, error=error)

    _, t = pair(scenario, tmp_path)
    assert t.error is None
    assert [type(e).__name__ for e in t.events].count("CycleDetected") == 1
    assert t.counters["timecomp.skipped_turns"] > turns - 10_000
    assert t.counters["timecomp.guard_checks"] >= 1
    assert "timecomp.guard_mismatches" not in t.counters
    assert "timecomp_skip" in t.kinds
    final = TORCH.pgm.read_pgm(t.out / f"{shape[1]}x{shape[0]}x{turns}.pgm")
    from distributed_gol_tpu.models.life import parse_rule

    assert np.array_equal(final, expected_final(ash_board(*shape), turns, parse_rule(rule)))


def test_probe_cadence_is_forced_when_cycle_check_is_off(tmp_path):
    """An armed tier with ``cycle_check=0`` probes at the default cadence
    (the JAX controller's rule), so it still compresses."""

    def scenario(pk, d):
        p = make(pk, d, 64, 64, turns=10**7 + 3, cycle_check=0, superstep=16,
                 turn_events="batch")
        (events, error), counters = counters_during(pk, lambda: run_events(pk, p))
        return Outcome(events, d, counters=counters, error=error)

    _, t = pair(scenario, tmp_path)
    assert t.counters["timecomp.skips"] >= 1


# -- per-turn streams, detach mid-interval, resume ---------------------------------


class _Trip(queue.Queue):
    """An event queue that arms ``keys`` when CycleDetected goes by."""

    def __init__(self, keys):
        super().__init__()
        self.keys = keys

    def put(self, item, *a, **kw):
        if type(item).__name__ == "CycleDetected":
            self.keys.armed = True
        super().put(item, *a, **kw)


class _QAfterCycle(queue.Queue):
    """Keys: 'q' on the ``after``-th poll once the fast-forward began —
    the same chunk boundary in both packages."""

    def __init__(self, after: int):
        super().__init__()
        self.after, self.polls, self.armed = after, 0, False

    def empty(self) -> bool:
        if self.armed:
            self.polls += 1
            if self.polls == self.after:
                self.put("q")
        return super().empty()


def test_per_turn_detach_mid_interval_and_resume(tmp_path):
    """Per-turn mode keeps every TurnComplete; a 'q' inside the compressed
    interval parks a sidecar that splits computed from effective turns; a
    resumed run restores the split (``TimeCompressor.restore``), so a
    second detach parks the CUMULATIVE computed count; the last resume
    lands on the oracle — every sidecar and event equal to the JAX
    package's but for timing."""
    import json

    turns = 300_007

    def scenario(pk, d):
        ckpt = d / "ckpt"
        p = make(pk, d, 256, 256, turns=turns)
        events, kinds, metas, error = [], [], [], None
        for leg in range(3):
            keys = _QAfterCycle(2) if leg < 2 else None
            ev, k, err = controller_run(pk, p, keys=keys, session=pk.Session(ckpt),
                                        events=_Trip(keys) if keys else None)
            events, kinds, error = events + ev, kinds + k, error or err
            if leg < 2:
                metas.append(json.loads((ckpt / "checkpoint.json").read_text()))
        return Outcome(events, d, ckpt_dir=ckpt, kinds=kinds, error=error,
                       extra=dict(metas=metas))

    _, t = pair(scenario, tmp_path)
    assert t.error is None
    names = [type(e).__name__ for e in t.events]
    assert names.count("CycleDetected") == 3  # detected again after each resume
    tcs = [e.completed_turns for e in t.events if type(e).__name__ == "TurnComplete"]
    assert tcs == list(range(1, turns + 1))
    first, second = t.extra["metas"]
    assert 0 < first["turn"] < second["turn"] < turns
    for m in (first, second):
        assert m["effective_turns"] == m["turn"] and m["computed_turns"] < 10_000
    # Restored, not restarted: the second split counts the first run's work.
    assert first["computed_turns"] < second["computed_turns"]
    final = TORCH.pgm.read_pgm(t.out / f"256x256x{turns}.pgm")
    from distributed_gol_tpu.models.life import CONWAY

    assert np.array_equal(final, expected_final(ash_board(256, 256), turns, CONWAY))


def test_detach_sidecar_splits_computed_from_effective(tmp_path):
    """The parked sidecar alone: ``effective_turns == turn`` and
    ``computed_turns`` far below it, the same bytes in both packages."""

    def scenario(pk, d):
        ckpt = d / "ckpt"
        p = make(pk, d, 256, 256, turns=10**6)
        keys = _QAfterCycle(3)
        events, kinds, error = controller_run(pk, p, keys=keys, session=pk.Session(ckpt),
                                              events=_Trip(keys))
        return Outcome(events, d, ckpt_dir=ckpt, kinds=kinds, error=error)

    j, t = pair(scenario, tmp_path)
    import json

    meta = json.loads((t.ckpt_dir / "checkpoint.json").read_text())
    assert (t.ckpt_dir / "checkpoint.json").read_bytes() == (
        j.ckpt_dir / "checkpoint.json").read_bytes()
    assert meta["paused"] is True and meta["effective_turns"] == meta["turn"]
    assert 0 < meta["computed_turns"] < min(10_000, meta["effective_turns"])


def test_default_off_leaves_no_footprint(tmp_path):
    """With the knob off the tier leaves no trace: no ``timecomp.*``
    counter, no split in the detach sidecar; the dense cycle fast-forward
    still runs, identically in both packages."""

    def scenario(pk, d):
        ckpt = d / "ckpt"
        p = make(pk, d, 256, 256, turns=10**6, time_compression=False)
        assert pk.timecomp.maybe_create(p, None, None) is None
        keys = _QAfterCycle(2)
        (events, kinds, error), counters = counters_during(
            pk, lambda: controller_run(pk, p, keys=keys, session=pk.Session(ckpt),
                                       events=_Trip(keys)))
        return Outcome(events, d, ckpt_dir=ckpt, counters=counters, kinds=kinds, error=error)

    _, t = pair(scenario, tmp_path)
    assert not any(k.startswith("timecomp.") for k in t.counters)
    import json

    meta = json.loads((t.ckpt_dir / "checkpoint.json").read_text())
    assert "computed_turns" not in meta and "effective_turns" not in meta


# -- the exactness guard ---------------------------------------------------------


def test_corrupt_exit_dispatch_falls_back_to_dense_replay(tmp_path):
    """A ``corrupt`` fault on the interval's terminal phase advance fails
    the exit guard: one dense replay from the verified periodic board, a
    counted mismatch, and the oracle board — the same in both packages."""
    turns = 10**9 + 3

    def scenario(pk, d):
        p = make(pk, d, 256, 256, turns=turns, turn_events="batch")
        clean = pk.faults.FaultInjectionBackend(pk.Backend(p), pk.faults.FaultPlan())
        controller_run(pk, p, backend=clean)
        exit_dispatch = clean.dispatches - 1
        pk.timecomp.CACHE.clear()
        plan = pk.faults.FaultPlan([pk.faults.Fault(exit_dispatch, "corrupt", cells=3)])
        faulty = pk.faults.FaultInjectionBackend(pk.Backend(p), plan)
        (events, kinds, error), counters = counters_during(
            pk, lambda: controller_run(pk, p, backend=faulty))
        return Outcome(events, d, counters=counters, kinds=kinds, error=error,
                       extra=dict(exit_dispatch=exit_dispatch,
                                  injected=[(f.at, f.kind) for f in faulty.injected]))

    _, t = pair(scenario, tmp_path)
    assert t.error is None and t.extra["injected"] == [(t.extra["exit_dispatch"], "corrupt")]
    assert t.counters["timecomp.guard_mismatches"] == 1
    assert t.counters["timecomp.dense_replays"] == 1
    assert "timecomp_guard_mismatch" in t.kinds and "timecomp_dense_replay" in t.kinds
    from distributed_gol_tpu.models.life import CONWAY

    final = TORCH.pgm.read_pgm(t.out / f"256x256x{turns}.pgm")
    assert np.array_equal(final, expected_final(ash_board(256, 256), turns, CONWAY))


def test_supervisor_restart_preserves_exactness(tmp_path):
    """A terminal burst in the dense phase forces a rollback and a rebuild;
    the fresh controller re-proves the ash and still compresses."""
    turns = 10**9 + 1

    def scenario(pk, d):
        p = make(pk, d, 256, 256, turns=turns, turn_events="batch",
                 checkpoint_every_turns=4, restart_limit=2)
        plan = pk.faults.FaultPlan([pk.faults.Fault(2, "issue"), pk.faults.Fault(3, "issue")])

        def factory(q, attempt):
            b = pk.Backend(q)
            return pk.faults.FaultInjectionBackend(b, plan) if attempt == 0 else b

        (events, sup, error), counters = counters_during(
            pk, lambda: supervise_events(pk, p, session=pk.Session(), backend_factory=factory))
        return Outcome(events, d, history=history(sup), counters=counters, error=error)

    _, t = pair(scenario, tmp_path)
    errors = [e for e in t.events if type(e).__name__ == "DispatchError"]
    assert [e.will_retry for e in errors] == [True, False]
    assert t.counters["supervisor.restarts"] == 1
    assert t.counters["timecomp.skipped_turns"] > turns - 10_000


# -- rung 2: the ash cache -------------------------------------------------------


def test_cache_recognizes_ash_across_runs(tmp_path):
    """The second run of the same settled board hits the process-wide
    cache: a miss then a hit, in both packages."""

    def scenario(pk, d):
        p = make(pk, d, 256, 256, turns=10**6, turn_events="batch")
        (ev1, _), c1 = counters_during(pk, lambda: run_events(pk, p))
        (ev2, _), c2 = counters_during(pk, lambda: run_events(pk, p))
        return Outcome(ev1 + ev2, d, counters={"first": c1, "second": c2},
                       extra=dict(entries=len(pk.timecomp.CACHE)))

    _, t = pair(scenario, tmp_path)
    assert t.counters["first"]["timecomp.cache_misses"] >= 1
    assert t.counters["second"]["timecomp.cache_hits"] >= 1
    assert "timecomp.cache_misses" not in t.counters["second"]


def _cache_script(tc):
    """LRU order, the smallest bound and the counters of one AshCache."""
    cache = tc.AshCache(slots=2)
    e = tc.AshEntry(1, (7,))
    cache.put(("a",), e)
    cache.put(("b",), e)
    got = [cache.get(("a",)) is e]
    cache.put(("c",), e)
    got += [len(cache), cache.evictions, cache.get(("b",)) is None,
            cache.get(("a",)) is e, cache.get(("c",)) is e, cache.hits, cache.misses]
    big = tc.AshCache(slots=8)
    for i in range(5):
        big.put((i,), e)
    big.put((5,), e, slots=2)
    got += [len(big), big.evictions]
    big.clear()
    got += [len(big), big.hits, big.misses, big.evictions]
    return got


def test_ash_cache_behaves_as_jax():
    assert _cache_script(TORCH.timecomp) == _cache_script(JAX.timecomp)
    for tc in (TORCH.timecomp, JAX.timecomp):
        with pytest.raises(ValueError):
            tc.AshEntry(6, (1, 2, 3))
    assert TORCH.timecomp.MAX_SKIP_LOG2 == JAX.timecomp.MAX_SKIP_LOG2


def test_collision_cross_check_recaptures(tmp_path):
    """A hit whose counts disagree with the board's popcount is a
    fingerprint collision: dropped, recaptured, counted as a miss."""
    out = []
    for pk in (TORCH, JAX):
        p = params(pk, turns=10**9, image_width=16, image_height=16, out_dir=tmp_path,
                   time_compression=True)
        reg = pk.metrics.MetricsRegistry()
        tc = pk.timecomp.maybe_create(p, reg, pk.flight.FlightRecorder(16))
        key = tc.cache_key(fingerprint=0xDEAD, popcount=7)
        pk.timecomp.CACHE.put(key, pk.timecomp.AshEntry(6, (9,) * 6))
        first = tc.resolve_counts(key, popcount=7, capture=lambda: [7] * 6)
        again = tc.resolve_counts(key, popcount=7, capture=lambda: pytest.fail("recaptured"))
        pk.timecomp.CACHE.drop(key)
        out.append((tc.period, key, first, again, reg.snapshot().to_dict()["counters"]))
    assert out[0] == out[1]
    assert out[0][4]["timecomp.cache_misses"] == 1 and out[0][4]["timecomp.cache_hits"] == 1


def test_unknown_rule_warns_once_and_runs_dense(tmp_path):
    """A rule with no known ash period warns once and runs dense, with the
    same stream as the JAX package's."""

    def scenario(pk, d):
        p = make(pk, d, 64, 64, rule="B2/S23", turns=30, superstep=10)
        with pk.timecomp._warned_lock:
            pk.timecomp._warned_rules.discard(p.rule.notation)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert pk.timecomp.maybe_create(p, None, None) is None
            assert pk.timecomp.maybe_create(p, None, None) is None
            (events, error), counters = counters_during(pk, lambda: run_events(pk, p))
        scoped = [str(x.message) for x in w if issubclass(x.category, RuntimeWarning)
                  and "ash period" in str(x.message)]
        return Outcome(events, d, counters=counters, error=error, extra=dict(warned=scoped))

    _, t = pair(scenario, tmp_path)
    assert len(t.extra["warned"]) == 1 and "B2/S23" in t.extra["warned"][0]
    assert not any(k.startswith("timecomp.") for k in t.counters)


def test_time_compression_through_gol_run_is_bounded(tmp_path):
    """``gol.run`` with ``time_compression=True`` (a refusal until this
    tier was ported) delivers 10^9 turns of a 64² soup in bounded time."""

    def scenario(pk, d):
        p = params(pk, turns=10**9, image_height=64, image_width=64, superstep=64,
                   engine="packed", turn_events="batch", soup_density=0.3, soup_seed=7,
                   out_dir=d, ticker_period=3600, time_compression=True)
        pk.timecomp.CACHE.clear()
        (events, error), counters = within(
            120, lambda: counters_during(pk, lambda: run_events(pk, p)))
        return Outcome(events, d, counters=counters, error=error)

    _, t = pair(scenario, tmp_path)
    assert t.error is None and t.counters["timecomp.skips"] >= 1
