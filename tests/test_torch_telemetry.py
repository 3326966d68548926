"""The port's telemetry endpoints (``serve/telemetry.py``) on the CPU.

Ported rows of the JAX ``tests/test_telemetry.py`` that need no broker,
relay or fleet: a pod's ``/metrics``, ``/healthz`` and ``/slo``, the
single run's ``gol.run(telemetry_port=)``, the ``--telemetry-port`` flag
of both CLIs, ``tools/pod_top.py`` (which imports the JAX package)
scraping a port pod unchanged, and the scrape bound under a hang-faulted
tenant.  Every ``/metrics`` answer is parsed and put through
``openmetrics.check_roundtrip``; the port pod's health document and
metric families are held to a JAX pod's running the same tenants.  Every
server binds port 0, is closed in ``finally`` (a ``with`` block), and
every request carries its own deadline."""

import contextlib
import io
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.gol import start
from distributed_gol_torch.engine.session import Session
from distributed_gol_torch.obs import metrics as obs_metrics
from distributed_gol_torch.obs import openmetrics
from distributed_gol_torch.serve import ServeConfig, ServePlane, serve_plane_telemetry
from distributed_gol_torch.testing.faults import Fault, FaultInjectionBackend, FaultPlan

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

W = H = 16
SUPERSTEP = 4
TURNS = 24


#: Each test's own time limit, in seconds; a module that imports the
#: fixture may set its own ``TIME_LIMIT``.
LIMIT = 90


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fail the test (``TimeoutError``) once it has run ``LIMIT`` seconds
    (its module's ``TIME_LIMIT``, where set): a socket that never answers
    must not hold the suite."""
    limit = getattr(request.module, "TIME_LIMIT", LIMIT)

    def expire(signum, frame):
        raise TimeoutError(f"the test ran past its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def tenant_params(out_dir, seed, turns=TURNS, pkg=tgol, **kw):
    cfg = dict(engine="roll", image_width=W, image_height=H, superstep=SUPERSTEP, turns=turns,
               soup_density=0.25, soup_seed=seed, out_dir=out_dir, cycle_check=0,
               ticker_period=60.0)
    if pkg is tgol:
        cfg["device"] = "cpu"
    cfg.update(kw)
    return pkg.Params(**cfg)


def drain(events, timeout=60):
    seen = []
    while (e := events.get(timeout=timeout)) is not None:
        seen.append(e)
    return seen


def get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def check_metrics(body: bytes) -> dict:
    """``/metrics`` text: parsed, schema-clean, and round-tripping."""
    parsed = openmetrics.parse(body.decode())
    assert obs_metrics.check_metrics_snapshot(parsed) == []
    assert openmetrics.check_roundtrip(parsed) == []
    return parsed


def wait_label(name: str, before, timeout=60.0) -> str:
    """The registry's ``name`` info label once it differs from ``before``
    (a server publishing its bound endpoint)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = obs_metrics.REGISTRY.snapshot().to_dict()["info"].get(name)
        if got and got != before:
            return got
        time.sleep(0.05)
    raise AssertionError(f"{name} was never published")


def label(name):
    return obs_metrics.REGISTRY.snapshot().to_dict()["info"].get(name)


def test_plane_endpoints_end_to_end(tmp_path):
    cfg = ServeConfig(max_sessions=2, telemetry_sample_seconds=0.1, slo_latency_seconds=10.0,
                      slo_fast_window_seconds=0.5, slo_slow_window_seconds=2.0)
    with ServePlane(cfg, checkpoint_root=tmp_path / "ckpt") as plane:
        with serve_plane_telemetry(plane, port=0) as srv:
            plane.submit("alice", tenant_params(tmp_path / "a", 1))
            assert plane.wait_idle(timeout=60)
            status, body = get(srv.url + "/metrics")
            assert status == 200
            check_metrics(body)
            assert "gol_controller_turns_total" in body.decode()
            status, body = get(srv.url + "/healthz")
            hz = json.loads(body)
            assert status == 200 and hz["ready"] and hz["live"]
            assert hz["telemetry"]["sampling"]
            assert hz["tenants"]["alice"]["turns"] == TURNS
            assert hz["slo"] is not None
            status, body = get(srv.url + "/slo")
            assert status == 200 and json.loads(body)["alerting"] == []
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(srv.url + "/nope")
            assert ei.value.code == 404


def test_healthz_503_when_not_ready():
    with ServePlane(ServeConfig(max_sessions=1, telemetry_sample_seconds=0.2)) as plane:
        with serve_plane_telemetry(plane, port=0) as srv:
            plane.begin_drain()
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(srv.url + "/healthz")
            assert ei.value.code == 503
            assert json.loads(ei.value.read())["draining"] is True


def test_slo_404_without_objectives():
    with ServePlane(ServeConfig(telemetry_sample_seconds=0.2)) as plane:
        with serve_plane_telemetry(plane, port=0) as srv:
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(srv.url + "/slo")
            assert ei.value.code == 404


#: Tenant names no other test of this file uses.
TENANTS = ("surface-a", "surface-b")


def test_pod_surface_matches_a_jax_pod(tmp_path):
    """The same tenants on a port pod and on a JAX pod: the same health
    document (keys, statuses, turn counts) and the same metric families
    on ``/metrics``, each text round-tripping through its own package."""
    from distributed_gol_tpu import serve as jserve
    from distributed_gol_tpu.obs import openmetrics as jopenmetrics
    import distributed_gol_tpu as jgol

    got = {}
    for pkg, serve in ((tgol, None), (jgol, jserve)):
        tag = "t" if serve is None else "j"
        mod = serve or __import__("distributed_gol_torch.serve", fromlist=["x"])
        with mod.ServePlane(mod.ServeConfig(max_sessions=2, telemetry_sample_seconds=0.1),
                            checkpoint_root=tmp_path / tag) as plane:
            with mod.serve_plane_telemetry(plane, port=0) as srv:
                for i, name in enumerate(TENANTS):
                    plane.submit(name, tenant_params(tmp_path / tag / name, i + 1, pkg=pkg))
                assert plane.wait_idle(timeout=60)
                time.sleep(0.3)  # a sample after the runs ended
                hz = json.loads(get(srv.url + "/healthz")[1])
                body = get(srv.url + "/metrics")[1].decode()
        parser = openmetrics if serve is None else jopenmetrics
        parsed = parser.parse(body)
        assert parser.check_roundtrip(parsed) == []
        # The registry is process-wide: only this test's tenants' families.
        families = {n for part in ("counters", "gauges", "histograms") for n in parsed[part]
                    if any(f"tenant={t}" in n.replace('"', '') for t in TENANTS)}
        assert families
        got[tag] = (sorted(hz), {t: (r["status"], r["turns"]) for t, r in hz["tenants"].items()},
                    families)
    assert got["t"] == got["j"]


def test_gol_run_telemetry_port(tmp_path):
    """``gol.run(..., telemetry_port=0)``: the endpoints live for the run,
    discoverable from the ``telemetry.endpoint`` label, and go down with
    it."""
    events, keys = queue.Queue(), queue.Queue()
    before = label("telemetry.endpoint")
    params = tenant_params(tmp_path, 5, turns=100_000, telemetry_sample_seconds=0.05)
    t = start(params, events, keys, Session(), telemetry_port=0)
    try:
        base = wait_label("telemetry.endpoint", before)
        status, body = get(base + "/healthz", timeout=10)
        hz = json.loads(body)
        assert status == 200 and hz["live"] and hz["sampling"]
        status, body = get(base + "/metrics", timeout=10)
        assert status == 200
        check_metrics(body)
    finally:
        keys.put("q")
        drain(events, timeout=60)
        t.join(timeout=30)
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        get(base + "/healthz", timeout=2)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_run_cli_telemetry_port(tmp_path):
    """The run CLI's ``--telemetry-port``, in a subprocess: the endpoints
    answer while the run runs, and a SIGTERM (the preemption notice) ends
    it cleanly."""
    port = free_port()
    cmd = [sys.executable, "-m", "distributed_gol_torch", "-w", "16", "-h", "16", "-turns",
           "100000000", "-noVis", "--soup", "0.3", "--device", "cpu", "--superstep", "4",
           "--turn-events", "batch", "--cycle-check", "0", "--telemetry-port", str(port),
           "--telemetry-sample-seconds", "0.05", "--out-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        base, body, deadline = f"http://127.0.0.1:{port}", None, time.monotonic() + 60
        while body is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                body = get(base + "/metrics", timeout=5)[1]
            except OSError:
                time.sleep(0.1)
        assert body is not None, "the run never served /metrics"
        check_metrics(body)
        assert json.loads(get(base + "/healthz", timeout=5)[1])["live"]
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert f"telemetry: /metrics + /healthz on {base}" in err


def test_serve_cli_telemetry_port(tmp_path):
    """``serve --telemetry-port 0 --gateway-port 0``: the banner names the
    bound telemetry endpoint, which answers ``/metrics`` while the pod
    serves; a drain over the wire ends the pod."""
    from distributed_gol_torch.__main__ import serve_main

    before = {n: label(n) for n in ("telemetry.endpoint", "gateway.endpoint")}
    out, err, rc = io.StringIO(), io.StringIO(), []
    argv = ["--device", "cpu", "--tenant", "a:16x16x400", "--superstep", "4",
            "--engine", "roll", "--checkpoint-root", str(tmp_path), "--telemetry-port", "0",
            "--gateway-port", "0", "--telemetry-sample-seconds", "0.1"]

    def run():
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc.append(serve_main(argv))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        base = wait_label("telemetry.endpoint", before["telemetry.endpoint"])
        gateway = wait_label("gateway.endpoint", before["gateway.endpoint"])
        check_metrics(get(base + "/metrics", timeout=10)[1])
        assert json.loads(get(base + "/healthz", timeout=10)[1])["live"]
    finally:
        req = urllib.request.Request(gateway + "/v1/drain", method="POST")
        urllib.request.urlopen(req, timeout=30).close()
        thread.join(timeout=60)
    assert rc == [0] and not thread.is_alive()
    assert f"telemetry: {base}/metrics /healthz /slo" in err.getvalue()
    receipt = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(receipt["sessions"]) == {"a"} and receipt["gateway"]["endpoint"] == gateway


def test_pod_top_scrapes_a_port_pod(tmp_path):
    """``tools/pod_top.py``, unchanged, against the port's endpoints."""
    from tools import pod_top

    with ServePlane(ServeConfig(max_sessions=2, telemetry_sample_seconds=0.1)) as plane:
        with serve_plane_telemetry(plane, port=0) as srv:
            plane.submit("alice", tenant_params(tmp_path / "a", 1))
            assert plane.wait_idle(timeout=60)
            cur = pod_top.scrape(srv.url)
            frame = pod_top.render_frame(cur)
            assert "alice" in frame and "completed" in frame
            assert pod_top.main([srv.url, "--once"]) == 0


def test_scrape_stays_bounded_with_a_wedged_tenant(tmp_path):
    """While one tenant's dispatch hangs (bounded by its own watchdog),
    every ``/metrics`` and ``/healthz`` answer lands within 2 s and the
    final statuses are truthful."""
    hang_params = tenant_params(tmp_path / "hang", 31, turns=100_000,
                                dispatch_deadline_seconds=2.0)
    hang_backend = FaultInjectionBackend(Backend(hang_params),
                                         FaultPlan([Fault(1, "hang", seconds=60.0)]))
    try:
        with ServePlane(ServeConfig(max_sessions=2, telemetry_sample_seconds=0.1),
                        checkpoint_root=tmp_path / "ckpt") as plane:
            with serve_plane_telemetry(plane, port=0) as srv:
                healthy = plane.submit("healthy", tenant_params(tmp_path / "ok", 34))
                hang = plane.submit("hang", hang_params, backend=hang_backend)
                worst, deadline = 0.0, time.monotonic() + 60
                while time.monotonic() < deadline and not (healthy.done and hang.done):
                    t0 = time.monotonic()
                    check_metrics(get(srv.url + "/metrics", timeout=10)[1])
                    get(srv.url + "/healthz", timeout=10)
                    worst = max(worst, time.monotonic() - t0)
                    time.sleep(0.1)
                assert healthy.done and hang.done
                assert worst < 2.0
                hz = json.loads(get(srv.url + "/healthz")[1])
                assert hz["tenants"]["healthy"]["status"] == "completed"
                assert hz["tenants"]["hang"]["status"] == "parked"
                assert hz["watchdog_fires"] >= 1
    finally:
        hang_backend.release_hangs()
