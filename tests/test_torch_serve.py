"""The port's serving pod (``distributed_gol_torch.serve``) against the JAX
package's, on the CPU.

- **Admission**: the capacity budget's decision ladder, run on both
  packages' classes (each case a test of its own).
- **The plane**: ``ServePlane(ServeConfig(batched=True))`` with three
  64² tenants in both packages gives every tenant the same final PGM and
  the same event stream (normalised as ``tests/test_torch_run.py``
  normalises a run's), and one batched launch carries every tenant's
  dispatch (``serve.batched_boards`` = tenants x dispatches).
- **Drain and re-adoption**: queue promotion and shedding, a SIGTERM
  drain that parks every resident resumable, and re-adoption — by the
  same package and across the two packages in both directions — that
  completes to the straight run's board.
- **Demotion**: a failed batched launch demotes its round to solo
  launches, bit-identically.
- **The CLI**: ``python -m distributed_gol_torch serve --device cpu
  --batched ...`` end to end, and the refusals of what is not ported.
- The ported pieces the plane stands on: ``gol.run``'s
  ``backend_factory`` seam, the ``GracefulStop`` latch, the device
  blacklist (``parallel/mesh.py``) and the telemetry sampler."""

import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.engine.params import Params as TParams
from distributed_gol_torch.obs import metrics as tmetrics
from distributed_gol_torch.serve import (
    AdmissionController as TAdmission,
    AdmissionRejected as TRejected,
    ServeConfig as TConfig,
    ServePlane as TPlane,
)
from test_torch_run import normalise

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
W = H = 64
SUPERSTEP = 20
TURNS = 200
SEEDS = {"alice": 11, "bob": 22, "carol": 33}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's serving plane and engine (the reference)."""
    import distributed_gol_tpu as jgol
    from distributed_gol_tpu.engine.backend import BatchedBackend
    from distributed_gol_tpu.engine.params import Params
    from distributed_gol_tpu.obs import metrics
    from distributed_gol_tpu.serve import (
        AdmissionController, AdmissionRejected, ServeConfig, ServePlane, cohort_key,
    )

    return SimpleNamespace(
        gol=jgol, Params=Params, metrics=metrics, BatchedBackend=BatchedBackend,
        AdmissionController=AdmissionController, AdmissionRejected=AdmissionRejected,
        ServeConfig=ServeConfig, ServePlane=ServePlane, cohort_key=cohort_key,
    )


def port():
    from distributed_gol_torch.engine.backend import BatchedBackend
    from distributed_gol_torch.serve import cohort_key

    return SimpleNamespace(
        gol=tgol, Params=lambda **kw: TParams(device="cpu", **kw), metrics=tmetrics,
        BatchedBackend=BatchedBackend, AdmissionController=TAdmission,
        AdmissionRejected=TRejected, ServeConfig=TConfig, ServePlane=TPlane,
        cohort_key=cohort_key,
    )


@pytest.fixture(params=["torch", "jax"])
def pkg(request, jx):
    """Each package's serving classes: a case runs on both."""
    return port() if request.param == "torch" else jx


def tenant_params(pk, out_dir, seed, turns=TURNS, **kw):
    cfg = dict(image_width=W, image_height=H, superstep=SUPERSTEP, turns=turns,
               soup_density=0.3, soup_seed=seed, out_dir=out_dir, ticker_period=60.0)
    cfg.update(kw)
    return pk.Params(**cfg)


def final_pgm(params) -> bytes:
    return (Path(params.out_dir) / f"{params.final_output_name}.pgm").read_bytes()


def straight_run(pk, out_dir, seed, turns) -> bytes:
    """An uninterrupted solo run: the oracle a pod's tenant must match."""
    p = tenant_params(pk, out_dir, seed, turns=turns)
    events = queue.Queue()
    pk.gol.run(p, events)
    while events.get(timeout=60) is not None:
        pass
    return final_pgm(p)


def drain_queue(q) -> list:
    out = []
    while True:
        e = q.get(timeout=60)
        if e is None:
            return out
        out.append(e)


def tenant_stream(events, tenant):
    """``normalise`` of a tenant's stream, its MetricsReport cut to the
    tenant's own labelled instruments: the registry is process-wide, so
    a pod's other tenants (and the cohort's shared launches) land in
    every report's delta, at times that vary from run to run."""
    label = f"{{tenant={tenant}}}"
    out = []
    for name, fields in normalise(events):
        if name == "MetricsReport":
            fields = tuple(
                (k, {n: v for n, v in v.items() if n.endswith(label)})
                if k in ("counters", "info") else (k, v)
                for k, v in fields
            )
        out.append((name, fields))
    return out


def counters_since(pk, before) -> dict:
    return pk.metrics.REGISTRY.snapshot().delta(before).to_dict()["counters"]


# -- admission: the decision ladder on both packages' classes --------------------


CFG = dict(max_sessions=2, max_queued=2, max_cells_per_session=100, max_total_cells=500,
           retry_after_seconds=2.5)


def test_admission_ladder_is_deterministic(pkg):
    """run, run, queue, queue, shed — down to the retry-after hint."""
    ac = pkg.AdmissionController(pkg.ServeConfig(**CFG))
    assert [ac.admit(t, 10) for t in "abcd"] == ["run", "run", "queue", "queue"]
    with pytest.raises(pkg.AdmissionRejected) as ei:
        ac.admit("e", 10)
    assert ei.value.retry_after == 2.5
    assert ac.queued == 2 and len(ac.resident) == 2


def test_admission_oversized_board_is_permanent(pkg):
    ac = pkg.AdmissionController(pkg.ServeConfig(**CFG))
    with pytest.raises(pkg.AdmissionRejected) as ei:
        ac.admit("big", 101)
    assert ei.value.retry_after is None
    assert not ac.resident and not ac.waiting


def test_admission_cell_budget_frees_on_release(pkg):
    ac = pkg.AdmissionController(pkg.ServeConfig(
        max_sessions=4, max_queued=4, max_cells_per_session=100, max_total_cells=150,
        retry_after_seconds=1.0))
    assert ac.admit("a", 100) == "run"
    with pytest.raises(pkg.AdmissionRejected) as ei:
        ac.admit("b", 100)
    assert ei.value.retry_after == 1.0 and ac.total_cells == 100
    ac.release("a")
    assert ac.admit("b", 100) == "run"


def test_admission_degraded_capacity_scales_the_budget(pkg):
    ac = pkg.AdmissionController(pkg.ServeConfig(
        max_sessions=4, max_queued=4, max_cells_per_session=100, max_total_cells=200))
    ac.capacity_factor = 0.5
    assert ac.effective_total_cells == 100
    assert ac.admit("a", 100) == "run"
    with pytest.raises(pkg.AdmissionRejected, match="degraded: 50%"):
        ac.admit("b", 100)
    unbounded = pkg.AdmissionController(pkg.ServeConfig(max_total_cells=0))
    unbounded.capacity_factor = 0.25
    assert unbounded.effective_total_cells == 0


def test_admission_duplicate_tenant_is_shed(pkg):
    ac = pkg.AdmissionController(pkg.ServeConfig(**CFG))
    ac.admit("a", 10)
    with pytest.raises(pkg.AdmissionRejected, match="live session"):
        ac.admit("a", 10)


def test_admission_promotion_is_fifo(pkg):
    ac = pkg.AdmissionController(pkg.ServeConfig(**CFG))
    for t in "abcd":
        ac.admit(t, 10)
    ac.release("a")
    assert ac.pop_waiting() == ("c", 10)
    assert ac.pop_waiting() is None
    ac.release("b")
    assert ac.pop_waiting() == ("d", 10)


def test_admission_drain_closes_and_sheds(pkg):
    ac = pkg.AdmissionController(pkg.ServeConfig(**CFG))
    for t in "abc":
        ac.admit(t, 10)
    ac.draining = True
    with pytest.raises(pkg.AdmissionRejected) as ei:
        ac.admit("d", 10)
    assert ei.value.retry_after is None
    assert ac.shed_waiting() == ["c"]
    assert not ac.has_room()


@pytest.mark.parametrize("field,bad", [
    ("max_sessions", 0), ("max_queued", -1), ("max_cells_per_session", 0),
    ("max_total_cells", -1), ("drain_timeout_seconds", 0.0), ("cohort_grace_seconds", 0.0),
    ("cohort_evict_misses", 0), ("telemetry_sample_seconds", -1.0),
])
def test_serve_config_rejects_bad_budgets(pkg, field, bad):
    with pytest.raises(ValueError):
        pkg.ServeConfig(**{field: bad})


def test_serve_config_defaults_match(jx):
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(jx.ServeConfig())
    assert TConfig().telemetry_sample_seconds == 1.0


def test_cohort_key_splits_on_dispatch_relevant_fields(pkg, tmp_path):
    a = tenant_params(pkg, tmp_path / "a", 1, tenant="alice")
    assert pkg.cohort_key(a) == pkg.cohort_key(tenant_params(pkg, tmp_path / "b", 2, tenant="bob"))
    for override in ({"superstep": 2 * SUPERSTEP}, {"turns": 2 * TURNS}, {"image_width": 32},
                     {"engine": "roll"}, {"sdc_check_every_turns": SUPERSTEP}):
        assert pkg.cohort_key(a) != pkg.cohort_key(dataclasses.replace(a, **override))


# -- the plane against the JAX package's ------------------------------------------


def run_pod(pk, tmp, batched, engine, **cfg):
    """Three 64² tenants through one pod; returns ({tenant: (stream,
    PGM bytes)}, the counter delta, the pod's health)."""
    before = pk.metrics.REGISTRY.snapshot()
    queues = {t: queue.Queue() for t in SEEDS}
    with pk.ServePlane(pk.ServeConfig(max_sessions=3, batched=batched, **cfg)) as plane:
        handles = {
            t: plane.submit(t, tenant_params(pk, tmp / t, s, engine=engine), events=queues[t])
            for t, s in SEEDS.items()
        }
        streams = {t: tenant_stream(drain_queue(q), t) for t, q in queues.items()}
        assert plane.wait_idle(timeout=120)
        health = plane.health()
    for t, h in handles.items():
        assert h.status == "completed", (t, h.status, h.error)
    out = {t: (streams[t], final_pgm(h.params)) for t, h in handles.items()}
    return out, counters_since(pk, before), health


@pytest.mark.parametrize("batched,engine", [
    (True, "auto"),
    # The JAX package's solo Backend warns that its TPU gate sends a 64²
    # board to the packed tier; the port's gate takes it (ROADMAP §C).
    pytest.param(True, "pallas-packed",
                 marks=pytest.mark.filterwarnings("ignore:engine 'pallas-packed':RuntimeWarning")),
    (True, "roll"),
    (False, "auto"),
])
def test_pod_matches_the_jax_pod(jx, tmp_path, batched, engine):
    """Every tenant's final PGM and normalised event stream equal the JAX
    pod's; batched, every dispatch of every tenant rides a batched launch
    (on the CPU, ``pallas-packed`` runs K7's plain version)."""
    # No eviction however late a member is: every dispatch rides a batched
    # launch, so the launch economics below are exact.
    cfg = dict(cohort_evict_misses=10**6)
    got, counters, health = run_pod(port(), tmp_path / "torch", batched, engine, **cfg)
    want, jcounters, _ = run_pod(jx, tmp_path / "jax", batched, engine, **cfg)
    for t in SEEDS:
        assert got[t][1] == want[t][1], f"{t}: final PGM differs from the JAX pod's"
        assert got[t][1] == straight_run(port(), tmp_path / "solo" / t, SEEDS[t], TURNS)
        assert got[t][0] == want[t][0], f"{t}: event stream differs from the JAX pod's"
    dispatches = TURNS // SUPERSTEP
    if batched:
        for c in (counters, jcounters):
            assert c.get("serve.batched_boards") == len(SEEDS) * dispatches, c
            # How the boards split into rounds depends on thread timing (a
            # round fires partial when a member is late past the grace
            # window, as at start-up or behind a first-use compile).
            assert dispatches <= c["serve.batched_launches"] <= c["serve.batched_boards"], c
            assert not c.get("serve.cohort_evictions"), c
            assert not c.get("serve.batched_launch_failures"), c
        ran = {k for k in counters if k.startswith("backend.batched_dispatches.")}
        want_engine = {"auto": "packed"}.get(engine, engine)
        assert ran == {f"backend.batched_dispatches.{want_engine}"}
        assert health["batched"] and health["batched_boards"] == len(SEEDS) * dispatches
    else:
        assert not counters.get("serve.batched_launches")
    assert {t: v["turns"] for t, v in health["tenants"].items()} == {t: TURNS for t in SEEDS}
    assert health["telemetry"]["sampling"] is True  # the sampler is armed by default


def test_health_surface_matches_the_jax_pod(jx):
    with TPlane(TConfig()) as plane, jx.ServePlane(jx.ServeConfig()) as jplane:
        got, want = plane.health(), jplane.health()
    assert got.keys() == want.keys()
    assert got["capacity"] == want["capacity"]
    assert got["ready"] and got["live"] and not got["degraded"]


def test_queue_promotion_and_shedding(tmp_path):
    """A one-slot pod: the second tenant waits and is promoted when the
    first completes; a third is shed with a retry-after hint; both run to
    their straight runs' boards."""
    with TPlane(TConfig(max_sessions=1, max_queued=1, retry_after_seconds=0.5)) as plane:
        first = plane.submit("a", tenant_params(port(), tmp_path / "a", 1))
        second = plane.submit("b", tenant_params(port(), tmp_path / "b", 2))
        with pytest.raises(TRejected) as ei:
            plane.submit("c", tenant_params(port(), tmp_path / "c", 3))
        assert ei.value.retry_after == 0.5
        assert second.admitted_as == "queue"
        assert plane.wait_idle(timeout=120)
        assert plane.health()["rejected"] == 1
    for h, seed in ((first, 1), (second, 2)):
        assert h.status == "completed"
        assert final_pgm(h.params) == straight_run(port(), tmp_path / f"solo{seed}", seed, TURNS)


def test_drain_sheds_the_waiting_queue(tmp_path):
    with TPlane(TConfig(max_sessions=1, max_queued=2)) as plane:
        running = plane.submit("run", tenant_params(port(), tmp_path / "run", 1, turns=10**6))
        queued = [plane.submit(f"q{i}", tenant_params(port(), tmp_path / f"q{i}", i))
                  for i in range(2)]
        plane.begin_drain()
        for h in queued:
            assert h.wait(timeout=30) and h.status == "shed" and not h.resumable
            assert h.events.get(timeout=10) is None
        assert running.wait(timeout=60) and running.status == "drained"
        with pytest.raises(TRejected, match="draining"):
            plane.submit("late", tenant_params(port(), tmp_path / "late", 9))


def drain_pod(pk, root, tmp, batched=True, signal_it=False) -> dict:
    """Start three long tenants, let each make progress, drain the pod
    (with a real SIGTERM through ``install`` when ``signal_it``), and
    return the tenants' park turns; every resident must end drained and
    resumable."""
    plane = pk.ServePlane(pk.ServeConfig(max_sessions=3, batched=batched,
                                         cohort_grace_seconds=0.05), checkpoint_root=root)
    restore = plane.install(signals=(signal.SIGTERM,)) if signal_it else None
    try:
        handles = {t: plane.submit(t, tenant_params(pk, tmp / t, s, turns=10**6))
                   for t, s in SEEDS.items()}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
                h.last_turn >= 2 * SUPERSTEP for h in handles.values()):
            time.sleep(0.02)
        if signal_it:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not all(h.done for h in handles.values()):
                time.sleep(0.02)
        summary = plane.drain(timeout=60)
    finally:
        if restore is not None:
            restore()
        plane.close()
    for t, h in handles.items():
        assert h.status == "drained" and h.resumable, (t, h.status, h.error)
        assert summary[t]["resumable"] and 0 < h.last_turn < 10**6
    return {t: h.last_turn for t, h in handles.items()}


def readopt_pod(pk, root, tmp, parked: dict) -> dict:
    """A fresh pod re-adopts every parked tenant toward two more
    supersteps; returns {tenant: final PGM bytes}."""
    with pk.ServePlane(pk.ServeConfig(max_sessions=3, batched=True,
                                      cohort_grace_seconds=0.05), checkpoint_root=root) as plane:
        adoptable = plane.resumable_tenants()
        assert {t: a["turn"] for t, a in adoptable.items()} == parked
        assert all(a["shape"] == [H, W] for a in adoptable.values())
        handles = {t: plane.submit(t, tenant_params(pk, tmp / t, SEEDS[t],
                                                    turns=parked[t] + 2 * SUPERSTEP))
                   for t in parked}
        assert plane.wait_idle(timeout=120)
    for t, h in handles.items():
        assert h.status == "completed" and h.last_turn == parked[t] + 2 * SUPERSTEP
    return {t: final_pgm(h.params) for t, h in handles.items()}


def test_sigterm_drain_parks_every_resident_and_readopts(tmp_path):
    """A real SIGTERM against a batched pod parks all three residents
    resumable; a fresh pod re-adopts them to the straight runs' boards."""
    root = tmp_path / "ckpt"
    parked = drain_pod(port(), root, tmp_path / "first", signal_it=True)
    boards = readopt_pod(port(), root, tmp_path / "second", parked)
    for t, b in boards.items():
        assert b == straight_run(port(), tmp_path / "oracle" / t, SEEDS[t], parked[t] + 2 * SUPERSTEP)


@pytest.mark.parametrize("direction", ["torch-to-jax", "jax-to-torch"])
def test_drain_and_readoption_across_packages(jx, tmp_path, direction):
    """A pod drained by one package is re-adopted by the other, and every
    tenant resumes to the straight run's final board."""
    first, second = (port(), jx) if direction == "torch-to-jax" else (jx, port())
    root = tmp_path / "ckpt"
    parked = drain_pod(first, root, tmp_path / "first")
    boards = readopt_pod(second, root, tmp_path / "second", parked)
    for t, b in boards.items():
        assert b == straight_run(first, tmp_path / "oracle" / t, SEEDS[t], parked[t] + 2 * SUPERSTEP)


def test_failed_batched_launch_demotes_to_solo(tmp_path, monkeypatch):
    """A batched launch that raises demotes its round to solo launches for
    good: one doomed attempt, not one per superstep, and every tenant
    still completes bit-identical."""
    from distributed_gol_torch.engine.backend import BatchedBackend

    def boom(self, boards, turns):
        raise RuntimeError("forced batched-launch failure")

    monkeypatch.setattr(BatchedBackend, "run_boards", boom)
    oracle = {t: straight_run(port(), tmp_path / "solo" / t, s, TURNS) for t, s in SEEDS.items()}
    before = tmetrics.REGISTRY.snapshot()
    with TPlane(TConfig(max_sessions=3, batched=True)) as plane:
        handles = {t: plane.submit(t, tenant_params(port(), tmp_path / t, s))
                   for t, s in SEEDS.items()}
        assert plane.wait_idle(timeout=120)
    counters = counters_since(port(), before)
    for t, h in handles.items():
        assert h.status == "completed" and final_pgm(h.params) == oracle[t]
    # One doomed attempt per round its members were in (the start-up may
    # split them), never one per superstep.
    assert 1 <= counters.get("serve.batched_launch_failures", 0) <= len(SEEDS)
    assert not counters.get("serve.batched_launches")
    assert sum(v for k, v in counters.items() if k.startswith("backend.dispatches.")) == (
        len(SEEDS) * TURNS // SUPERSTEP)


# -- the serve CLI ------------------------------------------------------------------


TENANTS = ["--tenant", "a:64x64x200", "--tenant", "b:64x64x120", "--tenant", "c:64x64x200"]


def test_serve_cli_matches_the_jax_cli(tmp_path, capsys):
    from distributed_gol_torch.__main__ import serve_main
    from distributed_gol_tpu.__main__ import serve_main as jserve_main

    args = [*TENANTS, "--superstep", str(SUPERSTEP), "--batched"]
    assert serve_main([*args, "--device", "cpu", "--checkpoint-root", str(tmp_path / "t")]) == 0
    receipt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jserve_main([*args, "--checkpoint-root", str(tmp_path / "j")]) == 0
    jreceipt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert receipt["sessions"] == jreceipt["sessions"]
    assert receipt["sessions"]["b"] == {"status": "completed", "turn": 120, "resumable": False}
    assert receipt["health"]["batched_boards"] == jreceipt["health"]["batched_boards"] > 0
    for t, turns in (("a", 200), ("b", 120), ("c", 200)):
        name = f"{t}/64x64x{turns}.pgm"
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("batched", [False, True], ids=["solo", "batched"])
def test_serve_restart_limit_runs_tenants_like_the_jax_cli(tmp_path, capsys, batched):
    """``serve --restart-limit 1`` (a refusal until the supervisor was
    ported) runs each tenant supervised to its final PGM, byte-equal to
    the JAX CLI's, with the same receipt."""
    from distributed_gol_torch.__main__ import serve_main
    from distributed_gol_tpu.__main__ import serve_main as jserve_main

    args = ["--tenant", "a:64x64x200", "--tenant", "b:64x64x120", "--superstep",
            str(SUPERSTEP), "--restart-limit", "1", "--checkpoint-every-turns", "40",
            *(["--batched"] if batched else [])]
    assert serve_main([*args, "--device", "cpu", "--checkpoint-root", str(tmp_path / "t")]) == 0
    receipt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jserve_main([*args, "--checkpoint-root", str(tmp_path / "j")]) == 0
    jreceipt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert receipt["sessions"] == jreceipt["sessions"]
    assert {t: s["status"] for t, s in receipt["sessions"].items()} == {"a": "completed",
                                                                         "b": "completed"}
    for name in ("a/64x64x200.pgm", "b/64x64x120.pgm"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_serve_cli_subprocess_end_to_end(tmp_path):
    cmd = [sys.executable, "-m", "distributed_gol_torch", "serve", "--device", "cpu", "--batched",
           "--superstep", str(SUPERSTEP), "--tenant", "a:64x64x200", "--tenant", "b:64x64x200",
           "--checkpoint-root", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    receipt = json.loads(r.stdout.strip().splitlines()[-1])
    assert {t: s["status"] for t, s in receipt["sessions"].items()} == {"a": "completed",
                                                                         "b": "completed"}
    assert receipt["health"]["batched_boards"] == 2 * TURNS // SUPERSTEP
    for t in "ab":
        assert (tmp_path / t / "64x64x200.pgm").is_file()


@pytest.mark.parametrize("argv", [
    ["broker"],
    ["broker", "--pod", "http://127.0.0.1:1", "--probe-miss-threshold", "0"],
    ["broker", "--pod", "http://127.0.0.1:1", "--probe-interval", "-1"],
    ["broker", "--pod", "http://127.0.0.1:1", "--bogus"],
    ["relay"],
    ["relay", "--upstream", "http://127.0.0.1:1/v1/frames", "--port", "x"],
    ["collector"],
    ["collector", "--node", "http://127.0.0.1:1", "--interval", "0"],
    ["collector", "--node", "http://127.0.0.1:1", "--slo-latency", "1",
     "--slo-latency-percentile", "2"],
], ids=["broker-no-pod", "broker-threshold", "broker-interval", "broker-unknown-flag",
        "relay-no-upstream", "relay-bad-port", "collector-no-node", "collector-interval",
        "collector-slo"])
def test_wire_subcommand_usage_errors_match_the_jax_cli(argv, capsys):
    """Each subcommand's usage errors exit 2 with the JAX CLI's message."""
    from distributed_gol_torch.__main__ import main as tmain
    from distributed_gol_tpu.__main__ import main as jmain

    errors = []
    for main in (jmain, tmain):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1]


@pytest.mark.parametrize("sub", ["broker", "relay", "collector"])
def test_wire_subcommand_help_lists_the_jax_flags(sub, capsys):
    """``--help`` of each subcommand lists the JAX CLI's flags, no more."""
    import re

    from distributed_gol_torch.__main__ import main as tmain
    from distributed_gol_tpu.__main__ import main as jmain

    flags = []
    for main in (jmain, tmain):
        with pytest.raises(SystemExit) as e:
            main([sub, "--help"])
        assert e.value.code == 0
        flags.append(set(re.findall(r"(?<![\w-])--[a-z][\w-]*", capsys.readouterr().out)))
    assert flags[0] == flags[1] and "--port" in flags[1]


def test_tenant_spec_parse_matches_jax():
    from distributed_gol_torch.__main__ import _parse_tenant_spec
    from distributed_gol_tpu.__main__ import _parse_tenant_spec as jparse

    assert _parse_tenant_spec("a:16x32x100") == jparse("a:16x32x100") == ("a", 16, 32, 100)
    for bad in ("a", "a:16x32", "a:16x32xfoo", ":16x16x1"):
        with pytest.raises(ValueError, match="NAME:WxHxTURNS"):
            _parse_tenant_spec(bad)


def test_serve_cli_without_a_gpu_fails_cleanly(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA GPU")
    from distributed_gol_torch.__main__ import serve_main

    assert serve_main(["--tenant", "a:16x16x8"]) == 1
    assert "no CUDA GPU" in capsys.readouterr().err


# -- what the plane stands on ----------------------------------------------------------


def test_run_takes_a_backend_factory_and_refuses_a_frame_plane(tmp_path):
    from distributed_gol_torch.engine.backend import Backend

    calls = []

    def factory(params, attempt):
        calls.append(attempt)
        return Backend(params)

    p = tenant_params(port(), tmp_path, 5, turns=40)
    events = queue.Queue()
    tgol.run(p, events, backend_factory=factory)
    assert drain_queue(events)[-1].completed_turns == 40 and calls == [0]
    events = queue.Queue()
    tgol.run(p, events, backend=Backend(p), backend_factory=factory)
    drain_queue(events)
    assert calls == [0]  # an explicit backend wins
    # A frame plane and a telemetry port, refused before the wire tier
    # was ported, are taken: the plane is bound to the board, and the
    # run's endpoints are published while it runs.
    from distributed_gol_torch.obs import metrics as obs_metrics
    from distributed_gol_torch.serve import FramePlane

    plane = FramePlane()
    events = queue.Queue()
    tgol.run(p, events, frame_plane=plane)
    assert drain_queue(events)[-1].completed_turns == 40
    assert plane._board_shape == (p.image_height, p.image_width)
    before = obs_metrics.REGISTRY.snapshot().to_dict()["info"].get("telemetry.endpoint")
    events = queue.Queue()
    tgol.run(p, events, telemetry_port=0)
    assert drain_queue(events)[-1].completed_turns == 40
    after = obs_metrics.REGISTRY.snapshot().to_dict()["info"].get("telemetry.endpoint")
    assert after and after != before


def test_graceful_stop_latch_is_shared_by_cli_and_plane():
    import distributed_gol_torch.__main__ as cli
    from distributed_gol_torch.engine import supervisor
    from distributed_gol_torch.serve import plane

    assert cli.GracefulStop is supervisor.GracefulStop is plane.GracefulStop
    stop = supervisor.GracefulStop()
    restore = stop.install((signal.SIGUSR1,))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 10
        while not stop.requested and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        restore()
    assert stop.requested and stop.signum == signal.SIGUSR1
    assert signal.getsignal(signal.SIGUSR1) is not stop.request


def test_device_blacklist_scales_the_pod_budget(tmp_path):
    """Condemning this process's one device (the CPU here) marks the pod
    degraded and its cell budget shrinks to nothing; clearing restores."""
    from distributed_gol_torch.parallel import mesh

    mesh.clear_blacklist()
    assert mesh.capacity_fraction() == 1.0 and mesh.lost_device_count() == 0
    before = tmetrics.REGISTRY.snapshot()
    try:
        assert mesh.condemn([0]) == [0] and mesh.condemn([0]) == []
        assert mesh.blacklisted() == {0} and mesh.lost_device_count() == 1
        assert mesh.capacity_fraction() == 0.0
        assert counters_since(port(), before)["mesh.devices_lost"] == 1
        with TPlane(TConfig(max_total_cells=2 * W * H)) as plane:
            with pytest.raises(TRejected, match="degraded"):
                plane.submit("a", tenant_params(port(), tmp_path, 1))
            hl = plane.health()
            assert hl["degraded"] and hl["devices_lost"] == 1
            assert hl["capacity"]["effective_total_cells"] == 1
    finally:
        mesh.clear_blacklist()
    assert mesh.capacity_fraction() == 1.0
