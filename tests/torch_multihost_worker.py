"""One rank of the port's multi-host runs on the CPU (gloo), for
``tests/test_torch_multihost.py`` and ``tests/test_torch_multihost_faults.py``.

Each process joins a gloo process group at a ``file://`` store, holds
``DGOL_CPU_DEVICES`` virtual CPU devices (the launcher sets it), runs one
mode and writes what the test compares into ``out_dir``: ``ok<pid>`` when
its own checks pass, and on process 0 ``<phase>.pkl`` (the raw event
stream) beside the PGMs.  Imports no JAX: the tests hold these results
to the JAX package's one-process runs in their own process.

Run: python tests/torch_multihost_worker.py <store> <nprocs> <pid> <out_dir> <mode>
"""

import os
import pickle
import queue
import signal
import sys
import threading
import time
import traceback
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

#: The process group's bound on every gloo operation in these runs.
COLLECTIVE_TIMEOUT = 60.0

#: The 64² soup every small mode starts from (as ``tests/test_torch_run.py``).
SOUP = dict(soup_density=0.3, soup_seed=7)


class ScriptedKeys(queue.Queue):
    """``tests/test_torch_run.py::ScriptedKeys``: the n-th ``empty()``
    poll releases the keys scheduled for it, so a key lands at the same
    dispatch boundary in every run."""

    def __init__(self, schedule: dict):
        super().__init__()
        self._schedule = dict(schedule)
        self._polls = 0

    def empty(self) -> bool:
        self._polls += 1
        for k in self._schedule.pop(self._polls, ""):
            self.put(k)
        return super().empty()


def params(out: Path, **kw):
    import distributed_gol_torch as gol

    return gol.Params(**dict(dict(device="cpu", out_dir=out, ticker_period=3600), **kw))


def drain(events: queue.Queue, seen: list, timeout: float = 120.0):
    """Collect ``events`` until the sentinel (on a thread: the run blocks)."""
    def pump():
        while (e := events.get(timeout=timeout)) is not None:
            seen.append(e)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def run(p, pid: int, out: Path, phase: str, keys=None, session=None, stop=None):
    """One ``run_distributed`` on every rank; process 0 pickles its
    stream as ``<phase>.pkl``.  Returns process 0's events (else [])."""
    from distributed_gol_torch.parallel import multihost

    if pid != 0:
        multihost.run_distributed(p, stop=stop)
        return []
    events: queue.Queue = queue.Queue()
    seen: list = []
    t = drain(events, seen)
    multihost.run_distributed(p, events, keys, session, stop=stop)
    t.join(timeout=30)
    (out / f"{phase}.pkl").write_bytes(pickle.dumps(seen))
    return seen


def follower_wrote_nothing(p, pid: int):
    if pid != 0:
        assert not any(Path(p.out_dir).glob("*")), "a follower wrote files"


def dataplane(pid: int, out: Path):
    """The engines over the process-spanning row mesh, without the
    controller: the packed word-halo engine's and the roll engine's
    boards and per-turn counts, K9's plain version, K11's (a stripe cap
    of 16 leaves the 64-row strips no frontier form) and K12's with their
    skip counts and activity, and a metrics-snapshot gather."""
    from distributed_gol_torch.models.life import CONWAY
    from distributed_gol_torch.ops import packed, stencil
    from distributed_gol_torch.parallel import cuda_halo, halo, multihost, packed_halo

    mesh = multihost.global_row_mesh("cpu")
    rng = np.random.default_rng(42)  # same seed everywhere: the shared "PGM"
    board = np.where(rng.random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
    sharding = halo.board_sharding(mesh)
    res = {}
    b = multihost.put_global(board, sharding)
    final, counts = packed_halo.make_steps_with_counts_bytes(mesh, CONWAY)(b, 100)
    res["packed"] = (multihost.fetch_global(final), counts.numpy())
    table = stencil.rule_table(CONWAY, torch.device("cpu"))
    final, counts = halo.sharded_steps_with_counts(mesh)(b, table, 100)
    res["roll"] = (multihost.fetch_global(final), counts.numpy())
    res["k9"] = multihost.fetch_global(cuda_halo.make_superstep_bytes(mesh, CONWAY)(b, 100))
    # A soup band across the ranks' seam (row 256) on a dead board: the
    # dead stripes prove stable, so the skip counts are not all zero.
    tall = np.zeros((512, 128), np.uint8)
    tall[200:320] = np.where(np.random.default_rng(43).random((120, 128)) < 0.3, 255, 0)
    tb = multihost.put_global(tall, sharding)
    for name, cap in (("k11", 16), ("k12", 0)):
        fn = cuda_halo.make_superstep(mesh, CONWAY, skip_stable=True, skip_tile_cap=cap,
                                      with_stats=True)
        pb, skipped, act = fn(tb.map(packed.pack), 150)
        res[name] = (multihost.fetch_global(pb.map(packed.unpack)), int(skipped), act.numpy())
    res["tier"] = cuda_halo.tier_policy(mesh, strip=(64, 4))
    res["snaps"] = multihost.gather_metrics_snapshots({"counters": {"rank": pid}})
    res["mesh"] = (mesh.shape, mesh.span)
    (out / f"dataplane{pid}.pkl").write_bytes(pickle.dumps(res))


def controller(pid: int, out: Path):
    """The controller contract: 64² x 100 with an 's' snapshot broadcast
    from process 0's keys, then a 'q' detach into process 0's session and
    the negotiated resume to the end."""
    from distributed_gol_torch.engine.session import Session

    mine = out / f"p{pid}"
    p = params(mine, turns=100, image_width=64, image_height=64, superstep=10, **SOUP)
    run(p, pid, out, "snapshot", ScriptedKeys({3: "s"}) if pid == 0 else None)
    follower_wrote_nothing(p, pid)
    ses = Session(out / "ckpt") if pid == 0 else None
    run(replace(p, turns=90), pid, out, "detach", ScriptedKeys({4: "q"}) if pid == 0 else None, ses)
    run(p, pid, out, "resume", session=ses)
    follower_wrote_nothing(p, pid)


def cycle(pid: int, out: Path):
    """Cycle fast-forward: the collective probe proves period-6 ash and
    every rank fast-forwards to 10^6 in lockstep."""
    p = params(out / f"p{pid}", turns=10**6, image_width=64, image_height=64, superstep=10,
               turn_events="batch", **SOUP)
    run(p, pid, out, "cycle")
    follower_wrote_nothing(p, pid)


def adaptive(pid: int, out: Path):
    """superstep 0 with the auto skip_stable policy: process 0 sizes the
    dispatches and broadcasts them (a target no dispatch nears makes the
    sizes a pure function of the schedule: every size doubles once warm;
    a cycle probe every 2 dispatches ends the run once the soup settles,
    before the doubled dispatches grow long)."""
    p = params(out / f"p{pid}", turns=10**6, image_width=64, image_height=64, superstep=0,
               skip_stable=None, max_dispatch_seconds=1e6, cycle_check=2, turn_events="batch",
               **SOUP)
    assert p.skip_stable_requested()
    run(p, pid, out, "adaptive")
    follower_wrote_nothing(p, pid)


def frontier(pid: int, out: Path):
    """K12's plain version across ranks: 128 x 4096 x 600, skip_stable,
    superstep 0, the (8, 1) mesh's 512-row strips on the frontier plan,
    with the rows and the intervals crossing the process boundary.
    Process 0 also records the skip count and activity its backend
    reports and the tier it took."""
    from distributed_gol_torch.parallel import multihost

    p = params(out / f"p{pid}", turns=600, image_width=128, image_height=4096,
               soup_density=0.3, engine="pallas-packed", skip_stable=True, superstep=0,
               max_dispatch_seconds=1e6, turn_events="batch")
    made = []
    real = multihost.make_backend

    def keep(params_):
        made.append(real(params_))
        return made[-1]

    multihost.make_backend = keep
    run(p, pid, out, "frontier")
    b = made[0]
    if pid == 0:
        stats = [(int(sk), total, np.asarray(act)) for sk, total, act in b._skip_stats]
        (out / "frontier_backend.pkl").write_bytes(pickle.dumps(dict(
            tier=b.sharded_tier, policy=b.sharded_tier_policy, stats=stats)))


def three(pid: int, out: Path):
    """Three ranks: the controller on a (3·DGOL_CPU_DEVICES, 1) mesh, K9's
    plain version (pallas-packed) and the packed engine."""
    for engine in ("pallas-packed", "packed"):
        p = params(out / f"p{pid}-{engine}", turns=100, image_width=64, image_height=96,
                   superstep=10, engine=engine, **SOUP)
        run(p, pid, out, f"three-{engine}")
        follower_wrote_nothing(p, pid)


def adopt(pid: int, out: Path):
    """A checkpoint the JAX package's 'q' detach parked in ``out/ckpt``,
    adopted by this run through process 0's session."""
    from distributed_gol_torch.engine.session import Session

    p = params(out / f"p{pid}", turns=100, image_width=64, image_height=64, superstep=10,
               **SOUP)
    run(p, pid, out, "adopt", session=Session(out / "ckpt") if pid == 0 else None)


def preempt(pid: int, out: Path):
    """A SIGTERM on a FOLLOWER mid-run: the stop poll is an allgather, so
    every rank drains at the same turn, process 0 parks the emergency
    checkpoint, and a resumed run completes."""
    import distributed_gol_torch as gol
    from distributed_gol_torch.engine.session import Session
    from distributed_gol_torch.engine.supervisor import GracefulStop

    p = params(out / f"p{pid}", turns=10**6, image_width=64, image_height=64, superstep=10,
               cycle_check=0, turn_events="batch", **SOUP)
    stop = GracefulStop()
    stop.install((signal.SIGTERM,))
    marker = out / "started"
    if pid == 1:
        def sigterm():
            deadline = time.time() + 60
            while not marker.exists() and time.time() < deadline:
                time.sleep(0.02)
            time.sleep(0.2)
            os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=sigterm, daemon=True).start()
    t0 = time.monotonic()
    ses = Session(out / "ckpt") if pid == 0 else None
    if pid == 0:
        events: queue.Queue = queue.Queue()
        seen: list = []

        def pump():
            while (e := events.get(timeout=120)) is not None:
                seen.append(e)
                if isinstance(e, gol.TurnsCompleted):
                    marker.touch()

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        from distributed_gol_torch.parallel import multihost

        multihost.run_distributed(p, events, None, ses, stop=stop)
        t.join(timeout=30)
        (out / "preempt.pkl").write_bytes(pickle.dumps(seen))
    else:
        run(p, pid, out, "preempt", stop=stop)
        assert stop.requested and stop.signum == signal.SIGTERM
    assert time.monotonic() - t0 < 60, "the drain took too long"
    run(replace(p, cycle_check=8), pid, out, "preempt-resume", session=ses)


def peerloss(pid: int, out: Path, paced: bool = True):
    """A FOLLOWER SIGKILLs itself once process 0 has a periodic
    checkpoint: process 0 must abort with PeerLost within a bound, with
    the stream's sentinel — from its heartbeat at a turn boundary or in a
    wait, or from the heartbeat's verdict on a collective that gloo
    failed when the peer's connection closed; the test resumes the
    checkpoint on one device.  ``paced``: every dispatch sleeps, so the
    kill mostly lands outside a collective; unpaced, the ranks dispatch
    back to back and it mostly lands inside one."""
    import distributed_gol_torch as gol
    from distributed_gol_torch.engine.session import Session
    from distributed_gol_torch.parallel import multihost
    from distributed_gol_torch.testing.faults import Fault, FaultInjectionBackend, FaultPlan

    p = params(out / f"p{pid}", turns=10**6, image_width=64, image_height=64, superstep=10,
               cycle_check=0, checkpoint_every_turns=10, peer_heartbeat_seconds=0.1,
               dispatch_deadline_seconds=10.0, turn_events="batch", **SOUP)
    if paced:
        # Symmetric pacing: every dispatch from the first sleeps 0.3 s on
        # both ranks.
        real = multihost.make_backend
        plan = FaultPlan([Fault(i, "latency", seconds=0.3) for i in range(1, 400)])
        multihost.make_backend = lambda p_: FaultInjectionBackend(real(p_), plan)
    marker = out / "started"
    if pid == 1:
        def die():
            deadline = time.time() + 60
            while not marker.exists() and time.time() < deadline:
                time.sleep(0.02)
            time.sleep(0.15)
            (out / "killed").write_text(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)

        threading.Thread(target=die, daemon=True).start()
        try:
            multihost.run_distributed(p)
        except BaseException:  # noqa: BLE001 — the victim's teardown does not matter
            pass
        time.sleep(120)
        os._exit(1)
    events: queue.Queue = queue.Queue()
    seen: list = []
    sentinel = threading.Event()

    def pump():
        while (e := events.get(timeout=120)) is not None:
            seen.append(e)
            if isinstance(e, gol.CheckpointSaved):
                marker.touch()
        sentinel.set()

    threading.Thread(target=pump, daemon=True).start()
    t0 = time.monotonic()
    err = None
    try:
        multihost.run_distributed(p, events, None, Session(out / "ckpt"))
    except BaseException as e:  # noqa: BLE001 — the abort under test
        err = e
    aborted_at, elapsed = time.time(), time.monotonic() - t0
    assert err is not None, "a peer's SIGKILL must abort the survivor"
    assert sentinel.wait(10), "the stream did not end with its sentinel"
    (out / "peerloss.pkl").write_bytes(pickle.dumps(dict(
        killed_at=float((out / "killed").read_text()), aborted_at=aborted_at,
        error=type(err).__name__, message=str(err), elapsed=elapsed,
        peer_lost=isinstance(err, multihost.PeerLost),
        saved=[e.completed_turns for e in seen if isinstance(e, gol.CheckpointSaved)],
        reports=[e.snapshot["counters"] for e in seen if isinstance(e, gol.MetricsReport)])))


def busy_peerloss(pid: int, out: Path):
    peerloss(pid, out, paced=False)


def faults(pid: int, out: Path):
    """A one-sided dispatch failure: process 1's backend raises at its
    fourth issue (retry_limit 0), process 0 stays healthy; both must end
    their streams with the sentinel and abort within a bound."""
    import distributed_gol_torch as gol
    from distributed_gol_torch.parallel import multihost
    from distributed_gol_torch.testing.faults import Fault, FaultInjectionBackend, FaultPlan

    p = params(out / f"p{pid}", turns=400, image_width=64, image_height=64, superstep=10,
               retry_limit=0, dispatch_deadline_seconds=3.0, cycle_check=0,
               turn_events="batch", soup_density=0.3)
    real = multihost.make_backend
    if pid == 1:
        multihost.make_backend = lambda p_: FaultInjectionBackend(
            real(p_), FaultPlan([Fault(4, "issue")]))
    events: queue.Queue = queue.Queue()
    seen: list = []
    sentinel = threading.Event()

    def pump():
        while (e := events.get(timeout=120)) is not None:
            seen.append(e)
        sentinel.set()

    threading.Thread(target=pump, daemon=True).start()
    t0 = time.monotonic()
    err = None
    try:
        multihost.run_distributed(p, events)
    except BaseException as e:  # noqa: BLE001 — the abort under test
        err = e
    elapsed = time.monotonic() - t0
    assert err is not None, "a one-sided failure must abort the run"
    assert sentinel.wait(10), "the stream did not end with its sentinel"
    errors = [e for e in seen if isinstance(e, gol.DispatchError)]
    assert all(not e.will_retry and not e.checkpointed for e in errors[-1:]), errors
    (out / f"faults{pid}.pkl").write_bytes(pickle.dumps(dict(
        error=type(err).__name__, message=str(err), elapsed=elapsed)))


MODES = {f.__name__: f for f in (dataplane, controller, cycle, adaptive, frontier, three,
                                  adopt, preempt, peerloss, busy_peerloss, faults)}


def main():
    store, nprocs, pid, out, mode = sys.argv[1:6]
    nprocs, pid, out = int(nprocs), int(pid), Path(out)
    try:
        from distributed_gol_torch.parallel import multihost

        multihost.initialize(store, nprocs, pid, timeout=COLLECTIVE_TIMEOUT)
        MODES[mode](pid, out)
        (out / f"ok{pid}").write_text("ok")
    except BaseException:  # noqa: BLE001 — reported, then a hard exit
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    if mode == "faults":
        # Keep this rank's transport up until its peer has aborted too.
        peer = out / f"ok{1 - pid}"
        deadline = time.time() + 20
        while not peer.exists() and time.time() < deadline:
            time.sleep(0.2)
    # A hard exit: abandoned watchdog waits and gloo's threads must not
    # hold the interpreter's shutdown.
    os._exit(0)


if __name__ == "__main__":
    main()


# -- the launcher (the tests' side) -------------------------------------------

#: What a gloo transport failure prints: one attempt that fails with one
#: of these (or runs out of time) gets one more, on a fresh store.
TRANSPORT_SIGNS = ("Connection closed", "Connection reset", "Connection refused",
                   "Broken pipe", "Timed out", "gloo")


def launch(tmp_path: Path, mode: str, nprocs: int = 2, devices: int = 4, retries: int = 1,
           timeout: float = 80.0, expect_rc=None) -> Path:
    """Run ``mode`` on ``nprocs`` ranks of ``devices`` CPU devices each,
    each attempt at a fresh ``file://`` store in its own directory and
    bounded by ``timeout`` seconds, and return that directory once every
    rank exited with its expected code (``expect_rc``: rank -> code,
    default 0) and wrote its ok-file.  No rank outlives the call."""
    import subprocess

    expect_rc = expect_rc or {}
    for attempt in range(retries + 1):
        out = tmp_path / f"{mode}-{attempt}"
        out.mkdir(parents=True, exist_ok=True)  # a test may seed it (a checkpoint)
        env = dict(os.environ, DGOL_CPU_DEVICES=str(devices))
        procs = [subprocess.Popen(
            [sys.executable, __file__, f"file://{out}/store", str(nprocs), str(i), str(out),
             mode], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(nprocs)]
        deadline = time.monotonic() + timeout
        outs, timed_out = [], False
        try:
            for p in procs:
                try:
                    o, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    timed_out = True
                    for q in procs:
                        q.kill()
                    o, _ = p.communicate()
                outs.append(o or "")
        finally:  # the test's own time limit may cut the wait
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        good = not timed_out and all(
            p.returncode == expect_rc.get(i, 0) and (expect_rc.get(i, 0) != 0
                                                     or (out / f"ok{i}").exists())
            for i, p in enumerate(procs))
        if good:
            return out
        blob = "\n".join(outs)
        if attempt < retries and (timed_out or any(s in blob for s in TRANSPORT_SIGNS)):
            print(f"[{mode}] attempt {attempt} hit the transport signature "
                  f"(timed out: {timed_out}); once more on a fresh store:\n{blob[-2000:]}")
            continue
        detail = "\n".join(f"rank {i} rc={p.returncode}:\n{o[-2500:]}"
                           for i, (p, o) in enumerate(zip(procs, outs)))
        raise AssertionError(f"{mode} failed (timed out: {timed_out}):\n{detail}")
