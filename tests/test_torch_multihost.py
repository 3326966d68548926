"""The port's multi-host runs (``parallel/multihost.py``) against the JAX
package, on the CPU.

Each multi-process case launches ranks of ``tests/torch_multihost_worker.py``
(gloo at a ``file://`` store in ``tmp_path``, a fresh one each attempt;
two ranks of four virtual CPU devices each, the (8, 1) mesh, unless the
case says otherwise).  The test then holds process 0's event stream, PGMs
and alive counts to the JAX package's one-process run of the same seeded
input on conftest's eight virtual devices (mesh (8, 1)), tolerance 0.  A
multi-host ``MetricsReport`` aggregates every process's snapshot: it must
count ``processes`` ranks, carry the JAX run's info labels, and each of
its counters must be the ranks times the JAX run's (every rank runs the
same dispatch schedule).
"""

import pickle
import queue
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol
from distributed_gol_tpu.engine.session import Session as JSession
from tests.test_torch_run import SOUP, ScriptedKeys, normalise, pgms, run
from tests.test_torch_telemetry import time_limit  # noqa: F401 — autouse fixture
from tests.torch_multihost_worker import launch

#: Each test's own time limit (``test_torch_telemetry.time_limit``): the
#: cases start and wait for rank processes.
TIME_LIMIT = 200

torch.set_num_threads(1)


def stream(out, phase: str) -> list:
    """Process 0's events of ``phase``, as pickled by the worker."""
    return pickle.loads((out / f"{phase}.pkl").read_bytes())


def hold_to_jax(got_raw: list, want: list, ranks: int = 2) -> list:
    """Process 0's stream against the JAX one-process stream ``want``
    (already normalised): equal but for the MetricsReport, which must
    aggregate ``ranks`` processes of the JAX run's report."""
    got = normalise(got_raw)
    assert [e for e in got if e[0] != "MetricsReport"] == [e for e in want
                                                            if e[0] != "MetricsReport"]
    mine = [dict(f) for n, f in got if n == "MetricsReport"]
    theirs = [dict(f) for n, f in want if n == "MetricsReport"]
    assert len(mine) == len(theirs) == 1
    assert (mine[0]["processes"], theirs[0]["processes"]) == (ranks, 1)
    assert mine[0]["info"] == theirs[0]["info"]
    assert mine[0]["counters"] == {k: ranks * v for k, v in theirs[0]["counters"].items()}
    return got


def jax_run(tmp_path, tag, keys=None, session=None, mesh=(8, 1), **kw):
    return run(jgol, tmp_path, tag, ScriptedKeys(keys) if keys else None,
               session if session is not None else JSession(), mesh_shape=mesh, **kw)


# -- the data plane ---------------------------------------------------------------


def test_data_plane_matches_one_process(tmp_path):
    """The packed and roll engines (boards and per-turn counts), K9's
    plain version, and K11's and K12's plain versions with their skip
    counts and activity, over the process-spanning (8, 1) mesh: every rank
    gets the board of the JAX package's packed engine; the skip counts and
    activity equal the port's one-process run on a virtual (8, 1) mesh."""
    import jax.numpy as jnp

    from distributed_gol_torch.models.life import CONWAY
    from distributed_gol_torch.ops import packed
    from distributed_gol_torch.parallel import cuda_halo, halo, mesh as mesh_lib
    from distributed_gol_tpu.models.life import CONWAY as JCONWAY
    from distributed_gol_tpu.ops import packed as jpacked

    out = launch(tmp_path, "dataplane")
    rng = np.random.default_rng(42)
    board = np.where(rng.random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
    want, want_counts = jpacked.make_steps_with_counts(JCONWAY)(jnp.asarray(board), 100)
    tall = np.zeros((512, 128), np.uint8)
    tall[200:320] = np.where(np.random.default_rng(43).random((120, 128)) < 0.3, 255, 0)
    one = mesh_lib.make_mesh((8, 1), [torch.device("cpu")] * 8)
    local = halo.board_sharding(one).shard(torch.from_numpy(tall)).map(packed.pack)
    for rank in range(2):
        got = pickle.loads((out / f"dataplane{rank}.pkl").read_bytes())
        assert got["mesh"][0] == {"y": 8, "x": 1} and got["mesh"][1].rank == rank
        for engine in ("packed", "roll"):
            assert np.array_equal(got[engine][0], np.asarray(want))
            assert np.array_equal(got[engine][1], np.asarray(want_counts))
        assert np.array_equal(got["k9"], np.asarray(want))
        for name, cap in (("k11", 16), ("k12", 0)):
            plan = cuda_halo.adaptive_strip_plan((64, 4), 150, cap)
            assert plan.frontier == (name == "k12")
            fn = cuda_halo.make_superstep(one, CONWAY, skip_stable=True, skip_tile_cap=cap,
                                          with_stats=True)
            b, skipped, act = fn(local, 150)
            board_np, got_skipped, got_act = got[name]
            assert np.array_equal(board_np, b.map(packed.unpack).gather("cpu").numpy())
            assert got_skipped == int(skipped) > 0
            assert np.array_equal(got_act, act.numpy())
        assert got["tier"] == (False, cuda_halo.INTERPRET_REASON)
        assert got["snaps"] == [{"counters": {"rank": 0}}, {"counters": {"rank": 1}}]


# -- the controller contract ------------------------------------------------------


def test_controller_contract(tmp_path):
    """An 's' snapshot broadcast from process 0's keys, a 'q' detach into
    process 0's session and the negotiated resume: each phase's stream
    and PGMs equal the JAX package's, the follower writes no file."""
    out = launch(tmp_path, "controller")
    kw = dict(turns=100, image_width=64, image_height=64, superstep=10, **SOUP)
    want, j_out = jax_run(tmp_path, "j-snap", {3: "s"}, **kw)
    hold_to_jax(stream(out, "snapshot"), want)
    ses = JSession(tmp_path / "j-ckpt")
    want, _ = jax_run(tmp_path, "j-detach", {4: "q"}, ses, **dict(kw, turns=90))
    got = hold_to_jax(stream(out, "detach"), want)
    assert dict(got[-1][1])["alive"] == ()  # detached, not completed
    want, j_resume = jax_run(tmp_path, "j-resume", None, ses, **kw)
    got = hold_to_jax(stream(out, "resume"), want)
    assert dict([f for n, f in got if n == "TurnComplete"][0])["completed_turns"] > 1
    assert pgms(out / "p0") == {**pgms(j_out), **pgms(j_resume)}
    assert not (out / "p1").exists()


@pytest.mark.parametrize("mode", ["cycle", "adaptive"])
def test_cycle_and_adaptive_superstep(tmp_path, mode):
    """Cycle fast-forward (the probe's verdict all-reduced) and the
    adaptive superstep with auto ``skip_stable`` (process 0 sizes and
    broadcasts each dispatch): 64² soup x 10^6, batch events."""
    out = launch(tmp_path, mode)
    kw = dict(turns=10**6, image_width=64, image_height=64, turn_events="batch", **SOUP)
    if mode == "cycle":
        kw.update(superstep=10)
    else:
        kw.update(superstep=0, skip_stable=None, max_dispatch_seconds=1e6, cycle_check=2)
    want, j_out = jax_run(tmp_path, "jax", **kw)
    got = hold_to_jax(stream(out, mode), want)
    assert [n for n, _ in got].count("CycleDetected") == 1
    assert pgms(out / "p0") == pgms(j_out)


def test_frontier_across_ranks(tmp_path):
    """K12's plain version with the rows and the intervals crossing the
    process boundary: 128 x 4096 x 600, skip_stable, superstep 0, 512-row
    strips on the frontier plan.  Stream and PGM equal the JAX package's
    packed one-process run (every engine is bit-identical); the tier is
    ppermute by policy, and process 0's skip counts and activity equal
    the port's one-process run on a virtual (8, 1) mesh."""
    from distributed_gol_torch.engine.backend import Backend

    out = launch(tmp_path, "frontier")
    kw = dict(turns=600, image_width=128, image_height=4096, soup_density=0.3,
              superstep=0, max_dispatch_seconds=1e6, turn_events="batch")
    want, j_out = jax_run(tmp_path, "jax", mesh=(1, 1), engine="packed", **kw)
    got = normalise(stream(out, "frontier"))
    assert [e for e in got if e[0] != "MetricsReport"] == [e for e in want
                                                            if e[0] != "MetricsReport"]
    assert pgms(out / "p0") == pgms(j_out)
    rec = pickle.loads((out / "frontier_backend.pkl").read_bytes())
    assert rec["tier"] == "ppermute"
    params = tgol.Params(device="cpu", mesh_shape=(8, 1), engine="pallas-packed",
                         skip_stable=True, out_dir=tmp_path / "one", ticker_period=3600, **kw)
    one = Backend(params)
    events: queue.Queue = queue.Queue()
    tgol.run(params, events, backend=one)
    while events.get(timeout=60) is not None:
        pass
    assert rec["policy"] == one.sharded_tier_policy
    want_stats = [(int(sk), total, np.asarray(act)) for sk, total, act in one._skip_stats]
    assert len(rec["stats"]) == len(want_stats) == 3
    for (sk, total, act), (wsk, wtotal, wact) in zip(rec["stats"], want_stats):
        assert (sk, total) == (wsk, wtotal) and np.array_equal(act, wact)


# -- three ranks; a checkpoint the JAX package parked ------------------------------


def test_three_ranks(tmp_path):
    """Three ranks of two devices, the (6, 1) mesh on a 64 x 96 board:
    north and south neighbours are different ranks.  K9's plain version
    (pallas-packed) and the packed engine, each against the JAX package."""
    out = launch(tmp_path, "three", nprocs=3, devices=2)
    for engine in ("pallas-packed", "packed"):
        want, j_out = jax_run(tmp_path, f"jax-{engine}", mesh=(6, 1), turns=100,
                              image_width=64, image_height=96, superstep=10, engine=engine,
                              **SOUP)
        hold_to_jax(stream(out, f"three-{engine}"), want, ranks=3)
        assert pgms(out / f"p0-{engine}") == pgms(j_out)


def test_adopts_a_jax_checkpoint(tmp_path):
    """The JAX package's 'q' detach parks a checkpoint; a two-rank port
    run adopts it through process 0's session and ends on the JAX
    package's straight-run PGM."""
    kw = dict(turns=100, image_width=64, image_height=64, superstep=10, **SOUP)
    _, straight = jax_run(tmp_path, "straight", mesh=(1, 1), **kw)
    out_dir = tmp_path / "adopt-0"
    out_dir.mkdir()
    jax_run(tmp_path, "park", {3: "q"}, JSession(out_dir / "ckpt"), mesh=(1, 1), **kw)
    assert (out_dir / "ckpt" / "checkpoint.json").is_file()
    out = launch(tmp_path, "adopt", retries=0)
    assert out == out_dir
    first = [e for e in stream(out, "adopt") if type(e).__name__ == "TurnComplete"][0]
    assert first.completed_turns > 1
    assert pgms(out / "p0") == pgms(straight)


# -- unit rows --------------------------------------------------------------------


class TestPeerHeartbeat:
    """``tests/test_elastic.py::TestPeerHeartbeat``, on the port's monitor."""

    def test_two_monitors_keep_each_other_alive(self):
        from distributed_gol_torch.parallel.multihost import PeerHeartbeat

        a = PeerHeartbeat(0.1, process_id=0, num_processes=2)
        b = PeerHeartbeat(0.1, process_id=1, num_processes=2)
        try:
            _, pa = a._bind()
            _, pb = b._bind()
            addrs = {0: ("127.0.0.1", pa), 1: ("127.0.0.1", pb)}
            a.start(addrs)
            b.start(addrs)
            time.sleep(0.8)  # well past the 3-interval timeout
            assert a.dead_peers() == [] and b.dead_peers() == []
        finally:
            a.stop()
            b.stop()

    def test_dead_peer_detected_within_the_bound(self):
        from distributed_gol_torch.parallel.multihost import HEARTBEAT_MISS_FACTOR, PeerHeartbeat

        a = PeerHeartbeat(0.1, process_id=0, num_processes=2)
        b = PeerHeartbeat(0.1, process_id=1, num_processes=2)
        try:
            _, pa = a._bind()
            _, pb = b._bind()
            addrs = {0: ("127.0.0.1", pa), 1: ("127.0.0.1", pb)}
            a.start(addrs)
            b.start(addrs)
            time.sleep(0.3)
            assert a.dead_peers() == []
            b.stop()  # the "SIGKILL": b goes silent
            t0 = time.monotonic()
            bound = 10 * HEARTBEAT_MISS_FACTOR * 0.1
            while a.dead_peers() != [1] and time.monotonic() < t0 + bound:
                time.sleep(0.02)
            assert a.dead_peers() == [1], "silent peer never declared dead"
            assert time.monotonic() - t0 < bound
        finally:
            a.stop()
            b.stop()

    def test_single_process_run_has_no_peers(self):
        from distributed_gol_torch.parallel.multihost import PeerHeartbeat

        hb = PeerHeartbeat(0.1, process_id=0, num_processes=1)
        try:
            host, port = hb._bind()
            assert host == "127.0.0.1"  # no TCP rendezvous: loopback
            hb.start({0: (host, port)})
            assert hb.dead_peers() == []
        finally:
            hb.stop()

    def test_interval_validated(self):
        from distributed_gol_torch.parallel.multihost import PeerHeartbeat

        with pytest.raises(ValueError):
            PeerHeartbeat(0.0, process_id=0, num_processes=2)


def test_gather_metrics_snapshots_at_world_size_one():
    """``tests/test_obs.py``'s row: with no process group the gather is
    this process's snapshot, and the aggregate equals it."""
    from distributed_gol_torch.obs import metrics as m
    from distributed_gol_torch.parallel.multihost import gather_metrics_snapshots

    snap = {"schema": m.SCHEMA, "counters": {"c": 2}, "gauges": {}, "histograms": {},
            "info": {}}
    got = gather_metrics_snapshots(snap)
    assert got == [snap]
    assert m.aggregate_snapshots(got)["counters"]["c"] == 2


@pytest.mark.parametrize(
    "kw,match",
    [(dict(restart_limit=1), "restart_limit"),
     (dict(no_vis=False), "headless"),
     (dict(checkpoint_every_seconds=5.0), "turn cadence")],
    ids=["restart-limit", "viewer", "wall-clock-checkpoints"],
)
def test_refusals_match_jax(kw, match):
    """``tests/test_supervisor.py::test_multihost_refuses_restart_limit``
    and its siblings: validation precedes any collective (no process group
    needed), the message is the JAX package's word for word, and the
    stream still ends with its sentinel."""
    from distributed_gol_torch.parallel import multihost as tmh
    from distributed_gol_tpu.parallel import multihost as jmh

    base = dict(turns=4, image_width=16, image_height=16, **kw)
    messages = []
    for mod, params in ((tmh, tgol.Params(device="cpu", **base)), (jmh, jgol.Params(**base))):
        events: queue.Queue = queue.Queue()
        with pytest.raises(ValueError, match=match) as err:
            mod.run_distributed(params, events)
        assert events.get(timeout=5) is None
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_tier_policy_on_a_mesh_that_spans_ranks():
    """A process-spanning mesh takes the ppermute tier with the JAX
    package's multi-host reason, even where every strip sits on one card
    (on the card each rank's strips are on ``cuda:0``); the same mesh in
    one process takes the in-kernel tier.  Built without a card."""
    from distributed_gol_torch.parallel import cuda_halo, mesh as mesh_lib

    card = torch.device("cuda", 0)
    spanning = mesh_lib.Mesh(((card,),), mesh_lib.RankSpan(rank=0, world=2, local=1))
    assert spanning.shape == {"y": 2, "x": 1} and spanning.spans_ranks
    assert cuda_halo.tier_policy(spanning) == (False, cuda_halo.MULTIHOST_REASON)
    one = mesh_lib.make_mesh((2, 1), [card, card])
    assert cuda_halo.tier_policy(one) == (True, "in-kernel")
    alone = mesh_lib.Mesh(((card,), (card,)), mesh_lib.RankSpan(rank=0, world=1, local=2))
    assert not alone.spans_ranks and cuda_halo.tier_policy(alone) == (True, "in-kernel")


def test_the_port_imports_no_jax():
    """``multihost.py``, ``utils/profiling.py`` and the rest of the port,
    imported in a fresh interpreter, leave no ``jax`` in ``sys.modules``."""
    code = (
        "import sys, pkgutil, importlib, distributed_gol_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'distributed_gol_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import distributed_gol_torch.parallel.multihost, distributed_gol_torch.utils.profiling\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'distributed_gol_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
