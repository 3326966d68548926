"""The port's multi-host runs under faults, and its multi-host CLI, on the
CPU (gloo).

Ranks of ``tests/torch_multihost_worker.py`` (two ranks of four virtual
CPU devices, the (8, 1) mesh) are preempted, killed or failed one-sidedly;
every rank must end in bounded time, whatever its peer did, and what the
run left must resume to the JAX package's one-process board.  The CLI's
``--coordinator`` runs two ``python -m distributed_gol_torch`` ranks.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol
from distributed_gol_torch.engine.session import Session as TSession
from distributed_gol_tpu.engine.session import Session as JSession
from tests.test_torch_run import SOUP, pgms, run
from tests.test_torch_telemetry import time_limit  # noqa: F401 — autouse fixture
from tests.torch_multihost_worker import TRANSPORT_SIGNS, launch

#: Each test's own time limit (``test_torch_telemetry.time_limit``).
TIME_LIMIT = 200

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def events_of(out, phase: str) -> list:
    return pickle.loads((out / f"{phase}.pkl").read_bytes())


def test_sigterm_on_a_follower_drains_every_rank_and_resumes(tmp_path):
    """A real SIGTERM on process 1 mid-run: the allgathered stop poll
    makes both ranks stop at the same turn, process 0 parks the emergency
    checkpoint and reports the one signal in the aggregated counters; the
    resumed two-rank run starts at the next turn and ends on the JAX
    package's one-process PGM."""
    out = launch(tmp_path, "preempt")
    seen = events_of(out, "preempt")
    final = [e for e in seen if isinstance(e, tgol.FinalTurnComplete)][0]
    assert final.alive == (), "a preempted run exits paused, not completed"
    turn = final.completed_turns
    assert 0 < turn < 10**6
    saved = [e for e in seen if isinstance(e, tgol.CheckpointSaved)]
    assert saved and saved[-1].completed_turns == turn
    report = [e for e in seen if isinstance(e, tgol.MetricsReport)][0]
    assert report.processes == 2
    assert report.snapshot["counters"]["preempt.signals"] == 2
    resumed = events_of(out, "preempt-resume")
    first = [e for e in resumed if isinstance(e, tgol.TurnsCompleted)][0]
    assert first.first_turn == turn + 1
    _, want = run(jgol, tmp_path, "jax", None, JSession(), turns=10**6, image_width=64,
                  image_height=64, superstep=10, cycle_check=8, turn_events="batch", **SOUP)
    assert pgms(out / "p0") == pgms(want)


@pytest.mark.parametrize("mode", ["peerloss", "busy_peerloss"], ids=["paced", "busy"])
def test_peer_sigkill_bounded_abort_then_resume(tmp_path, mode):
    """Process 1 SIGKILLs itself once process 0 holds a periodic
    checkpoint (heartbeat 0.1 s, so a bound of 0.3 s): process 0 aborts
    with PeerLost naming rank 1 and its sentinel, within three heartbeat
    intervals, one dispatch (0.3 s of injected latency when paced) and
    the watchdog's poll of the kill; the newest checkpoint resumes on one
    device to the JAX package's PGM."""
    out = launch(tmp_path, mode, expect_rc={1: -9})
    rec = pickle.loads((out / "peerloss.pkl").read_bytes())
    assert rec["peer_lost"] and "[1]" in rec["message"], rec
    assert rec["aborted_at"] - rec["killed_at"] < 3 * 0.1 + 0.3 + 0.25 + 2.0, rec
    assert rec["saved"], "no periodic checkpoint before the kill"
    kw = dict(turns=10**6, image_width=64, image_height=64, superstep=10, cycle_check=8,
              turn_events="batch", **SOUP)
    _, resumed = run(tgol, tmp_path, "resume", None, TSession(out / "ckpt"), **kw)
    _, want = run(jgol, tmp_path, "jax", None, JSession(), **kw)
    assert pgms(resumed) == pgms(want)


def test_one_sided_failure_aborts_every_rank(tmp_path):
    """Process 1's backend fails at its fourth issue (no retries) and
    process 1 aborts; process 0, healthy, waits in an exchange its peer
    never joins until its watchdog (3 s) ends it.  Both end their streams
    with the sentinel, in bounded time."""
    out = launch(tmp_path, "faults")
    for rank in range(2):
        rec = pickle.loads((out / f"faults{rank}.pkl").read_bytes())
        assert rec["elapsed"] < 60, rec
    survivor = pickle.loads((out / "faults0.pkl").read_bytes())
    assert survivor["error"] == "DispatchTimeout", survivor


def free_port() -> int:
    with socket.socket() as s:
        s.settimeout(5.0)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CLI_ARGS = ("-w", "64", "-h", "64", "-turns", "100", "-noVis", "--superstep", "10",
            "--soup", "0.3", "--soup-seed", "7", "--device", "cpu")


def test_cli_two_ranks(tmp_path):
    """``python -m distributed_gol_torch ... --coordinator H:P
    --num-processes 2 --process-id i``, four CPU devices a rank: process
    0 prints the final line and writes the JAX package's PGM, process 1
    writes nothing."""
    env = dict(os.environ, DGOL_CPU_DEVICES="4")
    for attempt in range(2):
        coordinator = f"127.0.0.1:{free_port()}"
        outs = [tmp_path / f"out{attempt}-{i}" for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "distributed_gol_torch", *CLI_ARGS, "--out-dir", str(outs[i]),
             "--coordinator", coordinator, "--num-processes", "2", "--process-id", str(i)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)]
        texts = []
        try:
            for p in procs:
                try:
                    texts.append(p.communicate(timeout=60)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    texts.append(p.communicate()[0])
        finally:  # the test's own time limit may cut the wait
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        if all(p.returncode == 0 for p in procs):
            break
        blob = "\n".join(texts)
        if attempt == 0 and any(s in blob for s in TRANSPORT_SIGNS + ("Address already in use",)):
            continue
        pytest.fail(f"CLI ranks failed: {[p.returncode for p in procs]}\n{blob[-3000:]}")
    events, want = run(jgol, tmp_path, "jax", None, JSession(), turns=100, image_width=64,
                       image_height=64, superstep=10, mesh_shape=(8, 1), **SOUP)
    alive = len(dict([f for n, f in events if n == "FinalTurnComplete"][0])["alive"])
    assert texts[0].splitlines()[-1] == f"Final turn 100: {alive} alive"
    assert pgms(outs[0]) == pgms(want)
    assert not outs[1].exists() or not any(outs[1].iterdir()), "the follower wrote files"


@pytest.mark.parametrize(
    "extra",
    [(), ("-noVis", "--restart-limit", "1")],
    ids=["not-headless", "restart-limit"],
)
def test_cli_multihost_refusals_match_jax(tmp_path, extra):
    """The JAX CLI's multi-host usage rows: a run with a viewer, and
    ``--restart-limit`` with ``--coordinator``, exit 2 with the JAX CLI's
    message, before any rendezvous."""
    args = ("-w", "64", "-h", "64", "-turns", "10", *extra, "--coordinator", "127.0.0.1:1",
            "--num-processes", "2", "--process-id", "0")
    got = {}
    for pkg, more in (("distributed_gol_torch", ("--device", "cpu")), ("distributed_gol_tpu", ())):
        r = subprocess.run([sys.executable, "-m", pkg, *args, *more], cwd=tmp_path,
                           env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                           text=True, timeout=120)
        got[pkg] = (r.returncode, r.stderr.strip().splitlines()[-1])
    assert got["distributed_gol_torch"] == got["distributed_gol_tpu"]
    assert got["distributed_gol_torch"][0] == 2
