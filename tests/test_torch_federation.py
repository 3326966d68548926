"""The pod federation on the port (``serve/broker.py``,
``serve/podclient.py``), on the CPU over real loopback sockets.

The rows of ``tests/test_federation.py`` against the port's broker and
pods: the backoff shape, ``PodChaos``'s ``pod_down`` rows, the fleet view,
config validation, condemn/rejoin with an honest Retry-After, relayed 4xx
verdicts, the migration guards, and the four robustness legs: SIGKILL
failover of a real ``python -m distributed_gol_torch serve --device cpu``
child, SIGSTOP partition heal without split brain, drain migration under
load, and broker restart with orphan recovery.  After each leg the
tenant's final board and PGM must equal the JAX package's solo run of the
same spec (tolerance 0).  Then mixed fleets: a JAX broker in front of a
port pod, a port broker in front of a JAX pod, and a tenant checkpointed
by a JAX pod that a port pod adopts; and the ``broker`` subcommand in a
subprocess.  Every server binds port 0 and is closed in ``finally``; child
pods are killed (or SIGCONTed) in ``finally``; every test has its own
time limit (``tests/test_torch_telemetry.py::time_limit``).
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_gol_torch.obs import metrics as obs_metrics
from distributed_gol_torch.serve import (
    GatewayServer,
    ServeConfig,
    ServePlane,
)
from distributed_gol_torch.serve import wire
from distributed_gol_torch.serve.broker import (
    Broker,
    BrokerConfig,
    scan_resumable,
)
from distributed_gol_torch.serve.httpd import StdlibHTTPServer, read_body
from distributed_gol_torch.serve.podclient import backoff_delay
from distributed_gol_torch.testing.faults import (
    Fault,
    FaultInjectionBackend,
    FaultPlan,
    PodChaos,
)
from tests.test_torch_telemetry import time_limit  # noqa: F401 — autouse fixture
from tools.gol_client import GatewayError, GolClient

W = H = 32
SUPERSTEP = 4
REPO = Path(__file__).resolve().parent.parent

#: Each test's time limit (``test_torch_telemetry.time_limit``): these
#: drive pods, relays and child processes, which a loaded machine slows.
TIME_LIMIT = 240

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


def spec_doc(turns: int, seed: int, checkpoint_every: int = 0) -> dict:
    """One wire session spec (no tenant key — POST adds it)."""
    params = {
        "width": W, "height": H, "turns": turns, "engine": "roll",
        "superstep": SUPERSTEP, "cycle_check": 0, "ticker_period": 60.0,
    }
    if checkpoint_every:
        params["checkpoint_every_turns"] = checkpoint_every
    return {"params": params, "soup": {"density": 0.3, "seed": seed}}


def submit_via(client: GolClient, tenant: str, spec: dict) -> dict:
    return client._request(
        "POST", "/v1/sessions", {"tenant": tenant, **json.loads(json.dumps(spec))}
    )


def wait_for(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def broker_state(client: GolClient, tenant: str) -> dict | None:
    """A state poll that tolerates the mid-failover gap (no placement /
    pod unreachable for a beat)."""
    try:
        return client.state(tenant)
    except (GatewayError, OSError):
        return None


def event_board(final, size: int) -> np.ndarray:
    """A FinalTurnComplete's alive-cell list as a 0/255 board."""
    board = np.zeros((size, size), np.uint8)
    for x, y in final.alive:
        board[y, x] = 255
    return board


def jax_solo(tmp_path: Path, tenant: str, spec: dict) -> tuple[np.ndarray, bytes]:
    """The JAX package's fault-free solo run of one wire spec: (final
    board as 0/255, final PGM bytes)."""
    from distributed_gol_tpu.serve import ServeConfig as JConfig
    from distributed_gol_tpu.serve import ServePlane as JPlane
    from distributed_gol_tpu.serve import wire as jwire

    root = tmp_path / f"jax-solo-{tenant}-{len(list(tmp_path.glob('jax-solo-*')))}"
    params, _ = jwire.params_from_spec(tenant, json.loads(json.dumps(spec)), root=root / "up")
    with JPlane(JConfig(max_sessions=1), checkpoint_root=root / "ckpt") as plane:
        handle = plane.submit(tenant, params)
        assert handle.wait(timeout=120)
        assert handle.status == "completed"
        board = event_board(handle.final, params.image_width)
    return board, final_pgm(root / "up", tenant)


def final_pgm(root: Path, tenant: str) -> bytes:
    """The one final PGM a session of ``tenant`` wrote under ``root``."""
    (path,) = [p for p in sorted((root / tenant).glob("*.pgm"))
               if not p.name.startswith("checkpoint")]
    return path.read_bytes()


def assert_solo_equal(tmp_path: Path, tenant: str, spec: dict, final, root: Path):
    """The port's final (event and PGM under ``root``) equals the JAX
    package's solo run of the same spec, byte for byte."""
    board, pgm = jax_solo(tmp_path, tenant, spec)
    assert np.array_equal(event_board(final, W), board)
    assert final_pgm(root, tenant) == pgm


def counter(name: str) -> float:
    return (
        obs_metrics.REGISTRY.snapshot().to_dict()["counters"].get(name, 0)
    )


# -- satellite units -----------------------------------------------------------


class TestBackoffDelay:
    def test_retry_shape(self):
        assert backoff_delay(1, 0.05, 1.0) == pytest.approx(0.05)
        assert backoff_delay(2, 0.05, 1.0) == pytest.approx(0.1)
        assert backoff_delay(3, 0.05, 1.0) == pytest.approx(0.2)

    def test_capped(self):
        assert backoff_delay(30, 0.05, 1.0) == 1.0


class TestPodDownFaultKind:
    def test_schedulable_like_device_down(self):
        plan = FaultPlan.from_json(
            '{"faults": [{"at": 12, "kind": "pod_down", "device": 1}]}'
        )
        (fault,) = plan.faults
        assert (fault.at, fault.kind, fault.device) == (12, "pod_down", 1)

    def test_dispatch_harness_refuses_pod_down(self):
        plan = FaultPlan([Fault(0, "pod_down")])
        with pytest.raises(ValueError, match="pod_down"):
            FaultInjectionBackend(object(), plan)

    def test_pod_chaos_validates_pod_index(self):
        with pytest.raises(ValueError, match="only 1 pod"):
            PodChaos([object()], FaultPlan([Fault(0, "pod_down", device=3)]))

    def test_sigkill_and_partition_against_real_children(self):
        procs = [
            subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
            for _ in range(2)
        ]
        try:
            chaos = PodChaos(
                procs,
                FaultPlan([
                    Fault(10, "pod_down", device=0),  # SIGKILL
                    Fault(20, "pod_down", device=1, seconds=2.0),  # partition
                ]),
            )
            assert chaos.maybe_fire(5) == []
            struck = chaos.maybe_fire(25)  # both thresholds passed
            assert len(struck) == 2 and chaos.done
            wait_for(lambda: procs[0].poll() is not None, 10, "SIGKILL")
            # The partitioned pod is stopped now and heals afterwards.
            # (Poll, don't one-shot: on a loaded rig the process-table
            # read can land after the SIGCONT timer.)
            wait_for(
                lambda: Path(f"/proc/{procs[1].pid}/stat")
                .read_text().split()[2] == "T",
                10, "partition should SIGSTOP",
            )
            wait_for(
                lambda: Path(f"/proc/{procs[1].pid}/stat")
                .read_text().split()[2] != "T",
                10, "partition heal",
            )
            assert procs[1].poll() is None
            assert [f.at for f, _ in chaos.fired] == [10, 20]
            assert chaos.maybe_fire(99) == []  # nothing left to fire
            chaos.stop()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=10)


class TestFleetView:
    def test_render_fleet_rows(self):
        cur = {
            "t": 10.0,
            "health": {
                "broker": True, "ready": True, "pods_ready": 1,
                "pods_condemned": 1, "placements": 2,
                "resident_sessions": 2, "queued_sessions": 1,
                "resident_cells": 2048,
                "pods": [
                    {"endpoint": "http://a:1", "status": "ready",
                     "condemned": False, "resident_sessions": 2,
                     "queued_sessions": 1, "resident_cells": 2048,
                     "effective_total_cells": 4096,
                     "slo_alerting": ["latency"],
                     "placed": ["alice", "bob"]},
                    {"endpoint": "http://b:2", "status": "condemned",
                     "condemned": True, "misses": 2,
                     "resident_sessions": 0, "queued_sessions": 0,
                     "resident_cells": 0},
                ],
            },
        }
        prev = json.loads(json.dumps(cur))
        prev["t"] = 9.0
        prev["health"]["pods"][0]["resident_cells"] = 1024
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
        from pod_top import render_fleet

        out = render_fleet(cur, prev)
        assert "http://a:1" in out and "http://b:2" in out
        assert "condemned(2)" in out
        assert "!latency" in out
        assert "alice,bob" in out
        assert "2,048/4,096 (50%)" in out
        assert "1,024" in out  # cells/s from the two scrapes


class TestBrokerConfigValidation:
    def test_bad_thresholds_refused(self):
        with pytest.raises(ValueError):
            BrokerConfig(probe_miss_threshold=0)
        with pytest.raises(ValueError):
            BrokerConfig(probe_interval_seconds=0)


# -- a toggleable stub pod (condemn/rejoin row; no jax) ------------------------


class StubPod(StdlibHTTPServer):
    """A pod-shaped HTTP server the test scripts: health toggles,
    POST /v1/sessions answers from a scripted queue, session control
    is recorded, and per-tenant state answers from ``state_doc``."""

    thread_name = "gol-stub-pod"

    def __init__(self):
        self.healthy = True
        self.posts = 0
        self.scripted: list[tuple[int, dict]] = []
        self.controls: list[str] = []
        self.state_doc: dict = {"status": "running"}
        super().__init__(port=0)

    def handle(self, request, method, path, query):
        if path == "/healthz" and method == "GET":
            if not self.healthy:
                request._send_json(503, {"error": "down"})
                return True
            request._send_json(200, {
                "ready": True, "live": True, "degraded": False,
                "draining": False, "devices_lost": 0,
                "resident_sessions": 0, "queued_sessions": 0,
                "resident_cells": 0,
                "capacity": {"effective_total_cells": 1_000_000},
                "slo": {"alerting": []}, "tenants": {},
            })
            return True
        if path == "/v1/sessions" and method == "GET":
            request._send_json(200, {"sessions": {}})
            return True
        if path == "/v1/sessions" and method == "POST":
            doc = json.loads(read_body(request) or b"{}")
            self.posts += 1
            code, body = (
                self.scripted.pop(0)
                if self.scripted
                else (201, {"tenant": doc.get("tenant"), "status": "running"})
            )
            headers = []
            if code == 429 and "retry_after" in body:
                headers = [("Retry-After", f"{body['retry_after']:g}")]
            request._send_json(code, body, headers=headers)
            return True
        if path.startswith("/v1/sessions/") and method == "GET":
            request._send_json(200, dict(self.state_doc))
            return True
        if path.startswith("/v1/sessions/") and method == "POST":
            self.controls.append(path.rsplit("/", 1)[-1])
            request._send_json(200, {"ok": True})
            return True
        return False


class TestCondemnRejoin:
    def test_condemned_pod_rejoins_and_retry_after_is_honest(self, tmp_path):
        stub = StubPod()
        config = BrokerConfig(
            probe_interval_seconds=60.0,  # probes are driven by hand
            probe_miss_threshold=2,
            rejoin_threshold=2,
            checkpoint_root=tmp_path,
            retry_after_seconds=1.0,
        )
        broker = Broker([stub.url], config=config)
        client = GolClient(broker.url)
        try:
            broker.probe_once()
            base_condemned = counter("broker.pods_condemned")
            base_rejoined = counter("broker.pods_rejoined")

            # A pod 429 hint propagates verbatim through the broker.
            stub.scripted.append(
                (429, {"error": "shed", "retry_after": 2.5})
            )
            with pytest.raises(GatewayError) as ei:
                submit_via(client, "t1", spec_doc(100, 1))
            assert ei.value.status == 429
            assert ei.value.retry_after == pytest.approx(2.5)

            # The client's bounded backoff loop lands the retried POST.
            stub.scripted.append(
                (429, {"error": "shed", "retry_after": 0.01})
            )
            posts_before = stub.posts
            retrier = GolClient(broker.url, retries=2)
            receipt = submit_via(retrier, "t2", spec_doc(100, 2))
            assert receipt["pod"] == stub.url
            assert stub.posts == posts_before + 2

            # Miss-threshold condemnation mirrors the device blacklist.
            stub.healthy = False
            broker.probe_once()
            broker.probe_once()
            states = broker.pod_states()
            assert states[0]["condemned"] and states[0]["misses"] == 2
            assert counter("broker.pods_condemned") == base_condemned + 1
            kinds = [r["kind"] for r in broker.flight.records()]
            assert "pod_condemned" in kinds
            # With no answering pod the Retry-After hint comes from the
            # fleet's own recovery horizon, not a made-up constant.
            with pytest.raises(GatewayError) as ei:
                submit_via(client, "t3", spec_doc(100, 3))
            assert ei.value.status == 429
            horizon = config.probe_interval_seconds * (
                config.probe_miss_threshold + config.rejoin_threshold
            )
            assert ei.value.retry_after == pytest.approx(
                max(config.retry_after_seconds, horizon)
            )

            # A healthy streak past the threshold rejoins the pod.
            stub.healthy = True
            broker.probe_once()
            assert broker.pod_states()[0]["condemned"]  # streak of 1
            broker.probe_once()
            assert not broker.pod_states()[0]["condemned"]
            assert counter("broker.pods_rejoined") == base_rejoined + 1
            assert "pod_rejoined" in [
                r["kind"] for r in broker.flight.records()
            ]
            receipt = submit_via(client, "t4", spec_doc(100, 4))
            assert receipt["pod"] == stub.url
            assert broker.placement("t4") == stub.url
        finally:
            broker.close()
            stub.close()


class TestPermanentRejectionRelay:
    def test_pod_4xx_relays_verbatim_not_429(self, tmp_path):
        """A pod that REFUSES a spec (409 duplicate, 400 bad spec) is
        a permanent verdict: the broker relays the pod's status and
        body instead of masking it as a retryable 429 — and the
        client's --retries loop therefore does NOT sleep and re-send
        the same doomed spec."""
        stub = StubPod()
        broker = Broker(
            [stub.url],
            BrokerConfig(
                probe_interval_seconds=60.0, checkpoint_root=tmp_path
            ),
        )
        try:
            broker.probe_once()
            stub.scripted.append((409, {"error": "tenant exists"}))
            posts_before = stub.posts
            client = GolClient(broker.url, retries=3)
            with pytest.raises(GatewayError) as ei:
                submit_via(client, "dup", spec_doc(100, 1))
            assert ei.value.status == 409
            assert ei.value.body["error"] == "tenant exists"
            assert ei.value.body["pod"] == stub.url
            assert stub.posts == posts_before + 1, "no client retry loop"
        finally:
            broker.close()
            stub.close()


class TestMigrationGuards:
    def test_migrate_refuses_before_quit_when_no_target(self, tmp_path):
        """With no admitting target in the ring the migrate answers
        503 WITHOUT quitting the source — a healthy session is never
        stopped just to discover the fleet is full."""
        stub = StubPod()
        broker = Broker(
            [stub.url],
            BrokerConfig(
                probe_interval_seconds=60.0, checkpoint_root=tmp_path
            ),
        )
        client = GolClient(broker.url)
        try:
            broker.probe_once()
            assert submit_via(client, "t1", spec_doc(100, 1))
            with pytest.raises(GatewayError) as ei:
                client._request("POST", "/v1/migrate", {"tenant": "t1"})
            assert ei.value.status == 503
            assert stub.controls == [], "source must not be quit"
            assert broker.placement("t1") == stub.url
        finally:
            broker.close()
            stub.close()

    def test_failed_placement_restores_the_source(self, tmp_path):
        """If placement fails AFTER the source was quit (the target
        filled up in the race window), the spec is re-submitted to the
        source — the parked checkpoint resumes where the aborted
        migration stopped it, and the placement stays honest."""
        stub_a, stub_b = StubPod(), StubPod()
        stub_a.state_doc = {"status": "parked", "resumable": True}
        broker = Broker(
            [stub_a.url, stub_b.url],
            BrokerConfig(
                probe_interval_seconds=60.0, checkpoint_root=tmp_path
            ),
        )
        client = GolClient(broker.url)
        try:
            broker.probe_once()
            assert submit_via(client, "t1", spec_doc(100, 1))["pod"] == (
                stub_a.url
            )
            stub_b.scripted.append((503, {"error": "draining"}))
            with pytest.raises(GatewayError) as ei:
                client._request(
                    "POST", "/v1/migrate",
                    {"tenant": "t1", "to": stub_b.url},
                )
            assert ei.value.status == 502
            assert ei.value.body["restored"] is True
            assert stub_a.controls == ["quit"]
            assert stub_a.posts == 2, "initial submit + rollback submit"
            assert broker.placement("t1") == stub_a.url
            assert "migration_failed" in [
                r["kind"] for r in broker.flight.records()
            ]
        finally:
            broker.close()
            stub_a.close()
            stub_b.close()


# -- SIGKILL failover (subprocess pod + survivor) ------------------------------


def start_banner_process(argv: list, banner: str) -> tuple[subprocess.Popen, str]:
    """Start ``python -m distributed_gol_torch <argv>`` and return (proc,
    url) once a stderr line ``<banner>: <url>/v1/sessions ...`` names the
    bound endpoint.  The stderr pump thread rides on ``proc.pump``;
    :func:`reap` joins it."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_gol_torch", *argv],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
        env=env,
        text=True,
        cwd=str(REPO),
    )
    lines: list[str] = []

    def pump():
        for line in proc.stderr:
            lines.append(line)

    proc.pump = threading.Thread(target=pump, name="test-stderr-pump", daemon=True)
    proc.pump.start()
    marker = f"{banner}: "
    try:
        url = wait_for(
            lambda: next(
                (
                    ln.split(marker, 1)[1].split("/v1/sessions", 1)[0]
                    for ln in list(lines)
                    if ln.startswith(marker) and "/v1/sessions" in ln
                ),
                None,
            ),
            timeout=120,
            what=f"subprocess {banner} banner",
        )
    except BaseException:
        reap(proc)
        raise
    return proc, url


def reap(proc: subprocess.Popen) -> None:
    """Kill a child that is still running, wait for it, join its pump."""
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=10)
    proc.pump.join(timeout=10)


def start_subprocess_pod(root: Path, *extra: str) -> tuple[subprocess.Popen, str]:
    """A REAL port pod process (``serve --gateway-port 0 --device cpu``)
    on the shared checkpoint root; returns (proc, gateway url) once the
    banner names the bound endpoint."""
    return start_banner_process(
        ["serve", "--device", "cpu", "--gateway-port", "0",
         "--checkpoint-root", str(root), "--telemetry-sample-seconds", "0.1",
         *extra],
        "gateway",
    )


class TestSigkillFailover:
    def test_pod_sigkill_mid_run_fails_over_bit_identical(self, tmp_path):
        root = tmp_path / "ckpt"
        alice_spec = spec_doc(20_000, seed=5, checkpoint_every=16)
        bob_spec = spec_doc(12_000, seed=9)

        proc, pod_a = start_subprocess_pod(root)
        plane_b = ServePlane(
            ServeConfig(
                max_sessions=4,
                max_total_cells=300_000,  # A's bigger headroom wins placement
                telemetry_sample_seconds=0.1,
            ),
            checkpoint_root=root,
        )
        gw_b = GatewayServer(plane_b, port=0, device="cpu")
        broker = None
        chaos = None
        try:
            # The survivor's own tenant, submitted before the broker
            # exists — discovery must pick it up.
            bob_params, _ = wire.params_from_spec(
                "bob", json.loads(json.dumps(bob_spec)), root=root,
                device="cpu",
            )
            bob_handle = plane_b.submit("bob", bob_params)

            base_failovers = counter("broker.failovers")
            base_condemned = counter("broker.pods_condemned")
            broker = Broker(
                [pod_a, gw_b.url],
                BrokerConfig(
                    probe_interval_seconds=0.1,
                    probe_miss_threshold=2,
                    checkpoint_root=root,
                ),
            )
            client = GolClient(broker.url)
            assert broker.placement("bob") == gw_b.url  # re-discovered
            wait_for(
                lambda: all(
                    p["ready"] and p["status"] == "ready"
                    for p in broker.pod_states()
                ),
                30, "both pods probed ready",
            )

            receipt = submit_via(client, "alice", alice_spec)
            assert receipt["pod"] == pod_a, "headroom placement: A first"
            assert receipt["broker_trace_id"]

            # PodChaos SIGKILLs the pod once alice crosses the
            # scripted turn threshold — mid-run, no drain, no shutdown
            # hooks.
            chaos = PodChaos(
                [proc],
                FaultPlan([Fault(32, "pod_down", device=0)]),
                turn_fn=lambda: (broker_state(client, "alice") or {}).get(
                    "turn"
                ),
            )
            watcher = chaos.watch(interval=0.05)
            wait_for(lambda: chaos.done, 60, "scripted SIGKILL")
            (fault, fired_turn) = chaos.fired[0]
            assert fault.kind == "pod_down" and fired_turn >= 32
            wait_for(lambda: proc.poll() is not None, 10, "pod death")

            # Prober condemns; failover re-adopts alice on the survivor.
            wait_for(
                lambda: broker.placement("alice") == gw_b.url,
                60, "failover placement",
            )
            assert counter("broker.pods_condemned") == base_condemned + 1
            assert counter("broker.failovers") == base_failovers + 1
            records = broker.flight.records()
            condemned = [r for r in records if r["kind"] == "pod_condemned"]
            assert condemned and condemned[0]["pod"] == pod_a
            assert "alice" in condemned[0]["stranded"]
            failover = [r for r in records if r["kind"] == "failover"][0]
            assert failover["tenant"] == "alice"
            assert failover["from_pod"] == pod_a
            assert failover["to_pod"] == gw_b.url
            assert failover["checkpoint_turn"] > 0
            assert failover["checkpoint_turn"] % 16 == 0

            st = wait_for(
                lambda: (
                    (s := broker_state(client, "alice"))
                    and s["status"] in ("completed", "failed")
                    and s
                ),
                120, "alice completion on the survivor",
            )
            assert st["status"] == "completed" and st["turn"] == 20_000
            assert st["pod"] == gw_b.url

            # Bit-identical to the fault-free oracle: the resumed run
            # replayed from the newest intact durable checkpoint.
            assert_solo_equal(
                tmp_path, "alice", alice_spec,
                plane_b.handle("alice").final, root,
            )

            # The healthy pod's tenant was undisturbed throughout.
            assert bob_handle.wait(timeout=120)
            assert bob_handle.status == "completed"
            assert_solo_equal(
                tmp_path, "bob", bob_spec, bob_handle.final, root
            )

            # One trace across the hop: the flagged broker-side failover
            # trace and the pod-side request trace share the trace id.
            doc = client._request("GET", "/traces?limit=200")
            same_id = [
                t for t in doc["traces"]
                if t["trace_id"] == failover["trace_id"]
            ]
            names = {
                s["name"] for t in same_id for s in t.get("spans", ())
            }
            assert "gol.broker.place" in names, "broker-side spans retained"
            assert "gol.admission" in names, "pod-side spans share the id"
        finally:
            if chaos is not None:
                chaos.stop()
                watcher.join(timeout=10)
            if broker is not None:
                broker.close()
            gw_b.close()
            plane_b.close()
            reap(proc)


# -- SIGSTOP partition heal (the split-brain row) ------------------------------


class TestPartitionHealRejoin:
    def test_sigstop_partition_heals_without_split_brain(self, tmp_path):
        """The nastier cousin of SIGKILL: a SIGSTOP-partitioned pod is
        condemned and its tenant fails over to the survivor — but the
        pod is NOT dead, and on SIGCONT it resumes running the same
        tenant a survivor now owns (two writers on root/<tenant>).
        The broker must quit the stale resident on the healed pod
        BEFORE readmitting it to the ring."""
        root = tmp_path / "ckpt"
        alice_spec = spec_doc(20_000, seed=7, checkpoint_every=16)
        proc, pod_a = start_subprocess_pod(root)
        plane_b = ServePlane(
            ServeConfig(
                max_sessions=4,
                max_total_cells=300_000,  # A's bigger headroom wins
                telemetry_sample_seconds=0.1,
            ),
            checkpoint_root=root,
        )
        gw_b = GatewayServer(plane_b, port=0, device="cpu")
        broker = None
        stopped = False
        try:
            base_rejoined = counter("broker.pods_rejoined")
            base_quits = counter("broker.rejoin_quits")
            broker = Broker(
                [pod_a, gw_b.url],
                BrokerConfig(
                    probe_interval_seconds=0.1,
                    probe_timeout_seconds=0.5,
                    probe_miss_threshold=2,
                    rejoin_threshold=2,
                    checkpoint_root=root,
                ),
            )
            client = GolClient(broker.url)
            wait_for(
                lambda: all(p["ready"] for p in broker.pod_states()),
                30, "both pods probed ready",
            )
            assert submit_via(client, "alice", alice_spec)["pod"] == pod_a
            wait_for(
                lambda: (broker_state(client, "alice") or {}).get("turn", 0)
                >= 32,
                60, "alice past her first durable checkpoints",
            )

            # Partition: the pod freezes but does NOT die — the exact
            # split-brain shape, because it will resume running alice
            # the instant it thaws.
            os.kill(proc.pid, signal.SIGSTOP)
            stopped = True
            wait_for(
                lambda: broker.pod_states()[0]["condemned"],
                30, "partitioned pod condemned",
            )
            wait_for(
                lambda: broker.placement("alice") == gw_b.url,
                60, "failover placement onto the survivor",
            )

            # Heal.  Readmission must be preceded by the reconcile
            # quit of the healed pod's stale alice.
            os.kill(proc.pid, signal.SIGCONT)
            stopped = False
            wait_for(
                lambda: not broker.pod_states()[0]["condemned"],
                30, "pod rejoined after reconcile",
            )
            assert counter("broker.pods_rejoined") == base_rejoined + 1
            assert counter("broker.rejoin_quits") == base_quits + 1
            records = broker.flight.records()
            quit_rec = [
                r for r in records if r["kind"] == "rejoin_quit"
            ][0]
            assert quit_rec["tenant"] == "alice"
            assert quit_rec["pod"] == pod_a
            assert quit_rec["owner"] == gw_b.url
            kinds = [r["kind"] for r in records]
            assert kinds.index("rejoin_quit") < kinds.index("pod_rejoined")

            # One owner: placement still points at the survivor, and
            # the healed pod's stale alice is parked, not computing.
            assert broker.placement("alice") == gw_b.url
            pod_client = GolClient(pod_a)
            wait_for(
                lambda: (
                    pod_client._request("GET", "/v1/sessions")["sessions"]
                    .get("alice", {}).get("status")
                    not in ("running", "queued", "paused")
                ),
                30, "stale alice stopped on the healed pod",
            )

            # The survivor's run is undisturbed by the brief overlap:
            # bit-identical to the fault-free oracle.
            st = wait_for(
                lambda: (
                    (s := broker_state(client, "alice"))
                    and s["status"] in ("completed", "failed")
                    and s
                ),
                120, "alice completion on the survivor",
            )
            assert st["status"] == "completed" and st["turn"] == 20_000
            assert st["pod"] == gw_b.url
            assert_solo_equal(
                tmp_path, "alice", alice_spec,
                plane_b.handle("alice").final, root,
            )
        finally:
            if stopped:
                os.kill(proc.pid, signal.SIGCONT)
            if broker is not None:
                broker.close()
            gw_b.close()
            plane_b.close()
            reap(proc)


# -- drain migration under load ------------------------------------------------


class TestDrainMigration:
    def test_pod_drain_migrates_parked_and_spills_queued(self, tmp_path):
        root = tmp_path / "ckpt"
        plane_a = ServePlane(
            ServeConfig(
                max_sessions=2, max_queued=4, telemetry_sample_seconds=0.1
            ),
            checkpoint_root=root,
        )
        gw_a = GatewayServer(plane_a, port=0, device="cpu")
        plane_b = ServePlane(
            ServeConfig(
                max_sessions=4,
                max_total_cells=300_000,
                telemetry_sample_seconds=0.1,
            ),
            checkpoint_root=root,
        )
        gw_b = GatewayServer(plane_b, port=0, device="cpu")
        broker = Broker(
            [gw_a.url, gw_b.url],
            BrokerConfig(
                probe_interval_seconds=0.1,
                probe_miss_threshold=3,
                checkpoint_root=root,
            ),
        )
        client = GolClient(broker.url)
        dave_spec = spec_doc(2_000, seed=11)
        erin_spec = spec_doc(2_000, seed=12)
        try:
            wait_for(
                lambda: all(p["ready"] for p in broker.pod_states()),
                30, "pods probed",
            )
            base_migrations = counter("broker.migrations")
            # carol computes THROUGH the drain (the load); dave parks
            # paused; erin waits in A's admission queue.
            assert submit_via(
                client, "carol", spec_doc(200_000, seed=10)
            )["pod"] == gw_a.url
            assert submit_via(client, "dave", dave_spec)["pod"] == gw_a.url
            wait_for(
                lambda: (broker_state(client, "dave") or {}).get("turn", 0)
                > 0,
                30, "dave progress",
            )
            client.pause("dave")
            erin = submit_via(client, "erin", erin_spec)
            assert erin["pod"] == gw_a.url and erin["status"] == "queued"
            wait_for(
                lambda: (broker_state(client, "carol") or {}).get("turn", 0)
                > 0,
                30, "carol progress",
            )

            out = client._request("POST", "/v1/migrate", {"pod": gw_a.url})
            assert out["migrated"] == ["carol", "dave"]
            assert out["spilled"] == ["erin"]
            assert out["lost"] == []
            for tenant in ("carol", "dave", "erin"):
                assert broker.placement(tenant) == gw_b.url
            assert counter("broker.migrations") == base_migrations + 3
            records = broker.flight.records()
            kinds = [
                r["kind"] for r in records
                if r["kind"] in ("migration", "spill")
            ]
            assert sorted(kinds) == ["migration", "migration", "spill"]
            spill = [r for r in records if r["kind"] == "spill"][0]
            assert spill["tenant"] == "erin"
            carol_rec = [
                r for r in records
                if r["kind"] == "migration" and r["tenant"] == "carol"
            ][0]
            assert carol_rec["turn"] > 0  # drained mid-compute

            # The drained pod routes away once the next probe sees it.
            wait_for(
                lambda: broker.pod_states()[0]["status"] == "draining",
                30, "probe observes the drained pod",
            )
            frank = submit_via(client, "frank", spec_doc(400, seed=13))
            assert frank["pod"] == gw_b.url

            # Migrated sessions finish on B, bit-identical to fault-free
            # oracles; the under-load tenant keeps computing past its
            # drain turn.
            for tenant, spec in (("dave", dave_spec), ("erin", erin_spec)):
                st = wait_for(
                    lambda t=tenant: (
                        (s := broker_state(client, t))
                        and s["status"] == "completed"
                        and s
                    ),
                    120, f"{tenant} completion on B",
                )
                assert st["turn"] == 2_000
                assert_solo_equal(
                    tmp_path, tenant, spec, plane_b.handle(tenant).final,
                    root,
                )
            wait_for(
                lambda: (broker_state(client, "carol") or {}).get("turn", 0)
                > carol_rec["turn"],
                60, "carol computing again on B",
            )
            client.quit("carol")
        finally:
            broker.close()
            gw_a.close()
            gw_b.close()
            plane_a.close()
            plane_b.close()


# -- broker restart re-discovery + orphan recovery -----------------------------


class TestBrokerRestart:
    def test_restarted_broker_rediscovers_and_recovers_orphans(
        self, tmp_path
    ):
        root = tmp_path / "ckpt"
        plane_a = ServePlane(
            ServeConfig(max_sessions=4, telemetry_sample_seconds=0.1),
            checkpoint_root=root,
        )
        gw_a = GatewayServer(plane_a, port=0, device="cpu")
        cfg = BrokerConfig(
            probe_interval_seconds=0.1,
            probe_miss_threshold=3,
            checkpoint_root=root,
        )
        broker1 = Broker([gw_a.url], cfg)
        client1 = GolClient(broker1.url)
        oscar_spec = spec_doc(200_000, seed=21, checkpoint_every=16)
        try:
            wait_for(
                lambda: all(p["ready"] for p in broker1.pod_states()),
                30, "pod probed",
            )
            submit_via(client1, "tina", spec_doc(200_000, seed=20))
            wait_for(
                lambda: (broker_state(client1, "tina") or {}).get("turn", 0)
                > 0,
                30, "tina progress",
            )
        finally:
            broker1.close()  # the broker dies; the pod keeps computing

        # An orphan: a second pod parks a resumable checkpoint on the
        # shared root and is gone before any broker sees it.
        oscar_params, _ = wire.params_from_spec(
            "oscar", json.loads(json.dumps(oscar_spec)), root=root, device="cpu"
        )
        with ServePlane(
            ServeConfig(max_sessions=2), checkpoint_root=root
        ) as plane_c:
            plane_c.submit("oscar", oscar_params)
            wait_for(
                lambda: (plane_c.handle("oscar").last_turn or 0) > 32,
                60, "oscar progress",
            )
            receipt = plane_c.drain(timeout=60)
            assert receipt["oscar"]["resumable"]
        parked = scan_resumable(root)["oscar"]
        assert parked["turn"] > 0

        base_failovers = counter("broker.failovers")
        broker2 = Broker([gw_a.url], cfg)
        client2 = GolClient(broker2.url)
        try:
            # Soft state rebuilt from the pod's own session list.
            assert broker2.placement("tina") == gw_a.url
            assert "discover" in [
                r["kind"] for r in broker2.flight.records()
            ]
            wait_for(
                lambda: all(p["ready"] for p in broker2.pod_states()),
                30, "restarted broker probes the pod",
            )

            out = client2._request("POST", "/v1/recover", {})
            assert out["adopted"] == ["oscar"] and out["lost"] == []
            assert broker2.placement("oscar") == gw_a.url
            assert counter("broker.failovers") == base_failovers + 1
            failover = [
                r for r in broker2.flight.records()
                if r["kind"] == "failover"
            ][0]
            assert failover["from_pod"] is None
            assert failover["checkpoint_turn"] == parked["turn"]

            # The sidecar-reconstructed spec resumes to EXACTLY the
            # parked turn: no lost work, no invented work — and the
            # board is bit-identical to a fault-free run to that turn.
            st = wait_for(
                lambda: (
                    (s := broker_state(client2, "oscar"))
                    and s["status"] == "completed"
                    and s
                ),
                120, "oscar re-adopted to the parked turn",
            )
            assert st["turn"] == parked["turn"]
            to_turn = json.loads(json.dumps(oscar_spec))
            to_turn["params"]["turns"] = parked["turn"]
            assert_solo_equal(
                tmp_path, "oscar", to_turn, plane_a.handle("oscar").final,
                root,
            )
            client2.quit("tina")
        finally:
            broker2.close()
            gw_a.close()
            plane_a.close()


# -- mixed fleets: the port's broker and pods beside the JAX package's ---------


@contextlib.contextmanager
def pod(pkg: str, root: Path, **config):
    """(plane, gateway) of an in-process pod of ``pkg`` ("jax" or
    "torch", on the CPU) on ``root``; both closed on exit."""
    config = dict(dict(max_sessions=4, telemetry_sample_seconds=0.1), **config)
    if pkg == "jax":
        from distributed_gol_tpu.serve import GatewayServer as G, ServeConfig as C
        from distributed_gol_tpu.serve import ServePlane as P

        kw = {}
    else:
        G, C, P, kw = GatewayServer, ServeConfig, ServePlane, dict(device="cpu")
    plane = P(C(**config), checkpoint_root=root)
    gw = G(plane, port=0, **kw)
    try:
        yield plane, gw
    finally:
        gw.close()
        plane.close()


def broker_of(pkg: str, pods: list, config_kw: dict):
    if pkg == "jax":
        from distributed_gol_tpu.serve.broker import Broker as B, BrokerConfig as BC
    else:
        B, BC = Broker, BrokerConfig
    return B(pods, BC(**config_kw))


def wait_completed(client: GolClient, tenant: str, timeout: float = 120) -> dict:
    return wait_for(
        lambda: (
            (s := broker_state(client, tenant))
            and s["status"] in ("completed", "failed")
            and s
        ),
        timeout, f"{tenant} completion",
    )


class TestMixedFleet:
    @pytest.mark.parametrize("broker_pkg,pod_pkg", [("jax", "torch"), ("torch", "jax")],
                             ids=["jax-broker-port-pod", "port-broker-jax-pod"])
    def test_a_broker_fronts_a_pod_of_the_other_package(self, broker_pkg, pod_pkg, tmp_path):
        """The broker speaks only the gateway's wire, so either
        package's broker places and completes a tenant on either
        package's pod, with the JAX package's solo PGM."""
        root = tmp_path / "ckpt"
        spec = spec_doc(600, seed=17, checkpoint_every=16)
        with pod(pod_pkg, root) as (plane, gw):
            broker = broker_of(broker_pkg, [gw.url], dict(
                probe_interval_seconds=0.1, probe_miss_threshold=3, checkpoint_root=root))
            try:
                client = GolClient(broker.url)
                wait_for(lambda: all(p["ready"] for p in broker.pod_states()),
                         30, "pod probed")
                receipt = submit_via(client, "mia", spec)
                assert receipt["pod"] == gw.url and receipt["broker_trace_id"]
                st = wait_completed(client, "mia")
                assert st["status"] == "completed" and st["turn"] == 600
                board, pgm = jax_solo(tmp_path, "mia", spec)
                assert np.array_equal(event_board(plane.handle("mia").final, W), board)
                assert final_pgm(root, "mia") == pgm
            finally:
                broker.close()

    def test_a_port_pod_adopts_a_tenant_a_jax_pod_checkpointed(self, tmp_path):
        """A tenant runs on a JAX pod, is migrated (quit, parked
        checkpoint, readopt) by the port's broker onto a port pod on the
        same root, and finishes with the JAX package's solo PGM."""
        root = tmp_path / "ckpt"
        spec = spec_doc(20_000, seed=5, checkpoint_every=16)
        with pod("jax", root) as (_, gw_a), pod("torch", root, max_total_cells=300_000) as (
            plane_b, gw_b
        ):
            broker = broker_of("torch", [gw_a.url, gw_b.url], dict(
                probe_interval_seconds=0.1, probe_miss_threshold=3, checkpoint_root=root))
            try:
                client = GolClient(broker.url)
                wait_for(lambda: all(p["ready"] for p in broker.pod_states()),
                         30, "pods probed")
                assert submit_via(client, "alice", spec)["pod"] == gw_a.url
                wait_for(lambda: (broker_state(client, "alice") or {}).get("turn", 0) >= 64,
                         60, "alice past her first checkpoints on the JAX pod")
                out = client._request("POST", "/v1/migrate", {"tenant": "alice", "to": gw_b.url})
                assert out["to"] == gw_b.url and out["turn"] > 0
                assert broker.placement("alice") == gw_b.url
                st = wait_completed(client, "alice")
                assert st["status"] == "completed" and st["turn"] == 20_000
                assert_solo_equal(tmp_path, "alice", spec, plane_b.handle("alice").final, root)
            finally:
                broker.close()


def test_broker_subcommand_routes_a_tenant_to_completion(tmp_path):
    """``python -m distributed_gol_torch broker --pod <a port pod>``
    prints its endpoint and routes a tenant to completion."""
    root = tmp_path / "ckpt"
    spec = spec_doc(400, seed=23)
    with pod("torch", root) as (plane, gw):
        proc, url = start_banner_process(
            ["broker", "--pod", gw.url, "--checkpoint-root", str(root),
             "--probe-interval", "0.1"],
            "broker",
        )
        try:
            client = GolClient(url)
            wait_for(lambda: all(p["ready"] for p in client._request("GET", "/v1/pods")["pods"]),
                     30, "the broker's pod probed ready")
            assert submit_via(client, "zed", spec)["pod"] == gw.url
            st = wait_completed(client, "zed")
            assert st["status"] == "completed" and st["turn"] == 400
            assert_solo_equal(tmp_path, "zed", spec, plane.handle("zed").final, root)
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=30) == 0
        finally:
            reap(proc)
