"""The fleet observability plane on the port (``obs/fleet.py``), on the
CPU.

The rows of ``tests/test_fleet_obs.py`` against the port's collector,
broker, relay and pods: node names, node-labelled OpenMetrics round trips,
trace stitching, the scrape plane's aggregation and never-block contract,
budget continuity across a dead pod, the stitched-trace fan-out, the
collector's HTTP surface, the in-broker collector, the tools' pure
renderers, and the SIGKILL failover of a real ``python -m
distributed_gol_torch serve --device cpu`` child read off the fleet plane.
Then the port against the JAX package: over the same fixed node
snapshots, ``/fleet/metrics`` is the JAX collector's text with timestamps
masked; and the operator tools run unchanged against the port's servers
(``pod_top`` on the collector and the broker, ``trace_export`` and
``flight_report`` on the broker's stitched traces, merged flight and a
flight dump, ``gol_client`` watching through a relay).  Every server binds
port 0 and is closed in ``finally``; child pods are killed in ``finally``;
every test has its own time limit
(``tests/test_torch_telemetry.py::time_limit``).
"""

import json
import signal
import time
import urllib.error
import urllib.request

import pytest
import torch

from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import openmetrics, tracing
from distributed_gol_torch.obs.fleet import (
    FLEET_FLIGHT_SCHEMA,
    CollectorServer,
    FleetCollector,
    node_name,
)
from distributed_gol_torch.obs.slo import SLOObjectives
from distributed_gol_torch.serve.broker import Broker, BrokerConfig
from distributed_gol_torch.serve.httpd import StdlibHTTPServer
from distributed_gol_torch.serve.relay import RelayServer
from tests.test_torch_federation import (
    broker_state,
    counter,
    reap,
    spec_doc,
    start_subprocess_pod,
    submit_via,
    wait_for,
)
from tests.test_torch_telemetry import time_limit  # noqa: F401 — autouse fixture
from tools import flight_report, pod_top, trace_export
from tools.gol_client import GolClient

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

#: Each test's time limit (``test_torch_telemetry.time_limit``): these
#: drive pods, relays and child processes, which a loaded machine slows.
TIME_LIMIT = 240


def http_get(url: str, timeout: float = 10.0) -> tuple[int, bytes]:
    """One bounded GET; the body comes back on error codes too (a 503
    ``/fleet/healthz`` still reports)."""
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url), timeout=timeout
        ) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def node_snapshot(
    dispatches: float = 0,
    tenant: str = "alice",
    queue_depth: float = 0.0,
    latency: dict | None = None,
) -> dict:
    """One pod-shaped ``gol-metrics-v1`` snapshot a stub node exposes."""
    snap = {
        "schema": metrics_lib.SCHEMA,
        "counters": {f"controller.dispatches{{tenant={tenant}}}": dispatches},
        "gauges": {"frames.queue_depth": queue_depth},
        "histograms": {},
        "info": {"run.backend": "stub"},
    }
    if latency is not None:
        snap["histograms"][
            f"controller.dispatch_seconds{{tenant={tenant}}}"
        ] = latency
    return snap


class StubNode(StdlibHTTPServer):
    """One scrape-target-shaped server: ``/metrics`` renders a settable
    snapshot, ``/healthz``/``/flight``/``/traces`` answer from fields,
    ``delay`` wedges every response (the never-block row's victim), and
    the pod surfaces a broker's prober + discovery need are stubbed so
    the same class rides the ``broker --collector`` test."""

    thread_name = "gol-stub-node"

    def __init__(self, snapshot: dict | None = None):
        self.snapshot = snapshot or node_snapshot()
        self.healthz: dict = {"ready": True, "live": True, "tenants": {}}
        self.flight_records: list[dict] = []
        self.traces: dict[str, dict] = {}
        self.delay = 0.0
        super().__init__(port=0)

    def handle(self, request, method, path, query):
        if self.delay:
            time.sleep(self.delay)
        if path == "/metrics" and method == "GET":
            text = openmetrics.render(self.snapshot)
            request._send(200, text.encode(), openmetrics.CONTENT_TYPE)
            return True
        if path == "/healthz" and method == "GET":
            request._send_json(200, dict(self.healthz))
            return True
        if path == "/flight" and method == "GET":
            request._send_json(200, {"records": list(self.flight_records)})
            return True
        if path == "/traces" and method == "GET":
            prefix = query.get("trace_id", "")
            hit = next(
                (
                    doc
                    for tid, doc in self.traces.items()
                    if prefix and tid.startswith(prefix)
                ),
                None,
            )
            if hit is None:
                request._send_json(404, {"error": "no retained trace"})
            else:
                request._send_json(200, hit)
            return True
        if path == "/v1/sessions" and method == "GET":
            request._send_json(200, {"sessions": {}})
            return True
        return False


def trace_doc(trace_id: str, name: str, t0_unix: float, spans: list) -> dict:
    """One per-process ``gol-trace-v1`` doc for the stitcher."""
    return {
        "schema": "gol-trace-v1",
        "trace_id": trace_id,
        "name": name,
        "tenant": "alice",
        "status": "ok",
        "flagged": None,
        "t0_unix": t0_unix,
        "spans": spans,
        "events": [],
        "marks": {},
    }


# -- satellite units -----------------------------------------------------------


class TestNodeName:
    def test_host_port(self):
        assert node_name("http://127.0.0.1:9500") == "127.0.0.1:9500"

    def test_bare_fallback(self):
        assert node_name("not-a-url") == "not-a-url"


class TestFleetOpenMetrics:
    def test_node_labelled_snapshot_roundtrips(self):
        """The acceptance pin: a ``node=``-labelled page survives
        render -> parse with every label and value intact."""
        snap = {
            "schema": metrics_lib.SCHEMA,
            "counters": {
                "gol_controller_dispatches{node=pod-a,tenant=alice}": 7,
                "gol_controller_dispatches{tenant=alice}": 7,
            },
            "gauges": {"gol_fleet_nodes": 2.0},
            "histograms": {
                "gol_relay_frame_staleness_seconds{node=relay-1}": {
                    "buckets": [0.01, 0.1],
                    "counts": [3, 1, 0],
                    "sum": 0.09,
                    "count": 4,
                }
            },
            "info": {},
        }
        assert openmetrics.check_roundtrip(snap) == []
        parsed = openmetrics.parse(openmetrics.render(snap))
        assert (
            parsed["counters"][
                "gol_controller_dispatches{node=pod-a,tenant=alice}"
            ]
            == 7
        )
        hist = parsed["histograms"][
            "gol_relay_frame_staleness_seconds{node=relay-1}"
        ]
        assert hist["counts"] == [3, 1, 0] and hist["count"] == 4

    def test_spell_inverts_split_all(self):
        key = "gol_x{node=a,tenant=b}"
        base, labels = openmetrics.split_all(key)
        assert base == "gol_x" and labels == {"node": "a", "tenant": "b"}
        assert openmetrics.spell(base, labels) == key


class TestStitchTraces:
    def test_two_processes_one_axis(self):
        tid = "ab" * 16
        broker = trace_doc(
            tid, "gol.broker.failover", t0_unix=100.0,
            spans=[{"name": "gol.broker.place", "span_id": "1",
                    "parent_id": None, "t0_ns": 1000, "dur_ns": 500}],
        )
        pod = trace_doc(
            tid, "gol.request", t0_unix=100.5,
            spans=[{"name": "gol.admission", "span_id": "1",
                    "parent_id": None, "t0_ns": 2000, "dur_ns": 100}],
        )
        doc = tracing.stitch_traces({"broker": [broker], "pod-b": [pod]})
        assert doc["schema"] == tracing.FLEET_SCHEMA
        assert doc["trace_id"] == tid
        assert set(doc["nodes"]) == {"broker", "pod-b"}
        by_name = {s["name"]: s for s in doc["spans"]}
        # pod-b's clock is 0.5 s later: its span re-bases onto broker's.
        assert by_name["gol.broker.place"]["t0_ns"] == 1000
        assert by_name["gol.admission"]["t0_ns"] == 500_000_000 + 2000
        # Span ids are namespaced per process (both root at "1").
        assert by_name["gol.broker.place"]["span_id"] == "broker:1"
        assert by_name["gol.admission"]["span_id"] == "pod-b:1"
        assert doc["spans"] == sorted(
            doc["spans"], key=lambda s: s["t0_ns"]
        )

    def test_empty_is_none(self):
        assert tracing.stitch_traces({}) is None
        assert tracing.stitch_traces({"a": []}) is None


class TestScrapePlane:
    def test_aggregate_semantics_and_node_labels(self):
        """Counters sum, gauges max, histogram buckets sum — and the
        exported page carries both forms (aggregate + ``node=``)."""
        h = {"buckets": [0.1, 1.0], "counts": [2, 1, 0], "sum": 0.4,
             "count": 3}
        n1 = StubNode(node_snapshot(dispatches=10, queue_depth=3.0,
                                    latency=h))
        n2 = StubNode(node_snapshot(dispatches=5, queue_depth=7.0,
                                    latency=h))
        collector = None
        try:
            collector = FleetCollector(
                {"n1": n1.url, "n2": n2.url},
                interval=0.05, scrape_timeout=2.0, start=False,
            )
            collector.scrape_once()
            text = collector.render_metrics()
            parsed = openmetrics.parse(text)
            agg_key = "gol_controller_dispatches{tenant=alice}"
            assert parsed["counters"][agg_key] == 15  # counters SUM
            assert parsed["counters"][
                "gol_controller_dispatches{node=n1,tenant=alice}"
            ] == 10
            assert parsed["gauges"][
                "gol_frames_queue_depth"
            ] == 7.0  # gauges MAX
            agg_h = parsed["histograms"][
                "gol_controller_dispatch_seconds{tenant=alice}"
            ]
            assert agg_h["counts"] == [4, 2, 0]  # buckets SUM
            assert agg_h["count"] == 6
        finally:
            if collector is not None:
                collector.close()
            n1.close()
            n2.close()

    def test_wedged_node_is_one_bounded_miss(self):
        """The never-block bugfix row: a node that stops answering
        inside the timeout costs one bounded miss per round; its
        last-good snapshot stays aggregated and its staleness is
        surfaced (and eventually flagged) in ``/fleet/healthz``."""
        victim = StubNode(node_snapshot(dispatches=100))
        healthy = StubNode(node_snapshot(dispatches=1))
        collector = None
        try:
            collector = FleetCollector(
                {"victim": victim.url, "healthy": healthy.url},
                interval=0.05, scrape_timeout=0.25, start=False,
            )
            collector.scrape_once()
            assert collector.fleet_health()["ready"]
            base_miss = counter("fleet.scrape_misses{node=victim}")

            victim.delay = 5.0  # wedged: answers WAY past the timeout
            t0 = time.monotonic()
            collector.scrape_once()
            elapsed = time.monotonic() - t0
            assert elapsed < 2.0, f"scrape blocked {elapsed:.2f}s on a wedge"
            assert (
                counter("fleet.scrape_misses{node=victim}") == base_miss + 1
            )
            health = collector.fleet_health()
            row = health["nodes"]["victim"]
            assert row["consecutive_misses"] == 1
            assert row["last_error"]
            assert health["staleness_bound_seconds"] == pytest.approx(0.3)
            # Last-good retention: the wedged node's counters still ride
            # the aggregate (its history is history).
            parsed = openmetrics.parse(collector.render_metrics())
            assert parsed["counters"][
                "gol_controller_dispatches{tenant=alice}"
            ] == 101
            # Past 2x the bound the node is flagged stale and the fleet
            # goes not-ready.
            time.sleep(0.7)
            collector.scrape_once()
            health = collector.fleet_health()
            assert health["nodes"]["victim"]["stale"]
            assert not health["ready"]
        finally:
            if collector is not None:
                collector.close()
            victim.close()
            healthy.close()

    def test_dead_pod_keeps_tenant_budget_continuous(self):
        """The fleet SLO continuity row, unit-sized: a tenant's fleet
        dispatch series is MONOTONE across its pod dying and the work
        moving elsewhere — no reset, one budget."""
        first = StubNode(node_snapshot(dispatches=100))
        second = StubNode(node_snapshot(dispatches=40))
        collector = None
        try:
            collector = FleetCollector(
                {"first": first.url, "second": second.url},
                interval=0.05, scrape_timeout=0.25, start=False,
            )
            collector.scrape_once()
            slo = collector.fleet_slo()
            assert slo["schema"] == "gol-fleet-slo-v1"
            assert slo["tenants"]["alice"]["dispatches_total"] == 140

            first.close()  # the pod dies; alice "migrates" to second
            second.snapshot = node_snapshot(dispatches=90)
            collector.scrape_once()
            total = collector.fleet_slo()["tenants"]["alice"][
                "dispatches_total"
            ]
            assert total == 190, "dead pod's last-good must stay summed"
            assert total >= 140, "the budget series must never reset"
        finally:
            if collector is not None:
                collector.close()
            second.close()


class TestStitchedTraceFanout:
    def test_fans_to_every_node_and_merges(self):
        tid = "cd" * 16
        n1 = StubNode()
        n2 = StubNode()
        n1.traces[tid] = trace_doc(
            tid, "gol.request", 50.0,
            [{"name": "gol.admission", "span_id": "1", "parent_id": None,
              "t0_ns": 10, "dur_ns": 5}],
        )
        n2.traces[tid] = trace_doc(
            tid, "gol.relay.subscribe", 50.1,
            [{"name": "gol.relay.subscribe", "span_id": "1",
              "parent_id": None, "t0_ns": 20, "dur_ns": 5}],
        )
        collector = None
        try:
            collector = FleetCollector(
                {"n1": n1.url, "n2": n2.url},
                interval=0.05, scrape_timeout=2.0, start=False,
            )
            doc = collector.stitched_trace(tid[:6])  # prefix lookup
            assert doc is not None
            assert set(doc["nodes"]) == {"n1", "n2"}
            assert {s["name"] for s in doc["spans"]} == {
                "gol.admission", "gol.relay.subscribe",
            }
            assert collector.stitched_trace("ffff" * 8) is None
        finally:
            if collector is not None:
                collector.close()
            n1.close()
            n2.close()


class TestCollectorServerHTTP:
    def test_endpoints_and_aliases(self, tmp_path):
        node = StubNode()
        node.flight_records.append(
            {"t": 5.0, "kind": "dispatch", "turn": 3}
        )
        server = None
        try:
            collector = FleetCollector(
                {"n1": node.url}, interval=0.05, scrape_timeout=2.0,
                checkpoint_root=tmp_path, start=False,
            )
            collector.scrape_once()
            server = CollectorServer(collector, port=0)
            code, body = http_get(server.url + "/fleet/metrics")
            assert code == 200
            parsed = openmetrics.parse(body.decode())
            assert any("node=n1" in k for k in parsed["counters"])
            # /metrics and /healthz alias the fleet forms.
            code2, body2 = http_get(server.url + "/metrics")
            assert (code2, body2) == (code, body)
            code, body = http_get(server.url + "/healthz")
            assert code == 200
            health = json.loads(body)
            assert health["fleet"] is True and "n1" in health["nodes"]
            code, body = http_get(server.url + "/fleet/slo")
            assert code == 200
            assert json.loads(body)["schema"] == "gol-fleet-slo-v1"
            code, body = http_get(server.url + "/fleet/flight")
            assert code == 200
            doc = json.loads(body)
            assert doc["schema"] == FLEET_FLIGHT_SCHEMA
            assert doc["records"][0]["node"] == "n1"
            code, _ = http_get(server.url + "/fleet/flight?limit=zap")
            assert code == 400
            code, _ = http_get(server.url + "/fleet/traces")
            assert code == 400  # no id
            code, _ = http_get(server.url + "/fleet/traces/feedface")
            assert code == 404  # nobody retains it
        finally:
            if server is not None:
                server.close()  # closes the collector too
            node.close()


class TestBrokerCollectorRider:
    def test_config_validation(self):
        with pytest.raises(ValueError):
            BrokerConfig(collector_interval_seconds=0.0)
        with pytest.raises(ValueError):
            BrokerConfig(collector_scrape_timeout_seconds=-1.0)

    def test_broker_serves_fleet_surface(self, tmp_path):
        """``broker --collector``: the /fleet/* plane rides the broker's
        own port, scraping the broker's pods, with the broker's flight
        ring as the local postmortem source."""
        pod = StubNode()
        broker = None
        try:
            broker = Broker(
                [pod.url],
                BrokerConfig(
                    probe_interval_seconds=60.0,
                    checkpoint_root=tmp_path,
                    collector=True,
                    collector_interval_seconds=0.05,
                ),
            )
            assert broker.collector is not None
            broker.collector.scrape_once()
            code, body = http_get(broker.url + "/fleet/metrics")
            assert code == 200
            parsed = openmetrics.parse(body.decode())
            name = node_name(pod.url)
            assert any(f"node={name}" in k for k in parsed["counters"])
            code, body = http_get(broker.url + "/fleet/healthz")
            health = json.loads(body)
            assert health["fleet"] is True and name in health["nodes"]
            # The broker's own /metrics (its registry) works beside it.
            code, body = http_get(broker.url + "/metrics")
            assert code == 200
            own = openmetrics.parse(body.decode())
            assert "gol_broker_pods_ready" in own["gauges"]
            # The broker ring is the merged postmortem's local source.
            broker.flight.record("discover", tenants=0)
            code, body = http_get(broker.url + "/fleet/flight")
            doc = json.loads(body)
            assert any(
                r["node"] == "broker" and r["kind"] == "discover"
                for r in doc["records"]
            )
        finally:
            if broker is not None:
                broker.close()
            pod.close()


# -- tool purity pins ----------------------------------------------------------


class TestPodTopCollectorRender:
    CUR = {
        "t": 20.0,
        "health": {
            "fleet": True, "ready": False,
            "scrape_interval_seconds": 0.5,
            "staleness_bound_seconds": 2.5,
            "aggregate_sample_age_seconds": 0.2,
            "nodes": {
                "pod-a": {"ready": True, "stale": False,
                          "sample_age_seconds": 0.4,
                          "consecutive_misses": 0, "last_error": None},
                "pod-b": {"ready": False, "stale": True,
                          "sample_age_seconds": 9.1,
                          "consecutive_misses": 3,
                          "last_error": "PodUnreachable: refused"},
                "relay-1": {"ready": True, "stale": False,
                            "sample_age_seconds": 0.3,
                            "consecutive_misses": 0, "last_error": None},
            },
        },
        "metrics": {
            "counters": {
                "gol_fleet_scrape_rounds": 12,
                "gol_fleet_scrape_misses{node=pod-b}": 3,
                "gol_controller_dispatches{node=pod-a,tenant=alice}": 100,
                "gol_relay_frames_out{node=relay-1}": 500,
            },
            "gauges": {},
            "histograms": {
                "gol_relay_frame_staleness_seconds{node=relay-1}": {
                    "buckets": [0.01, 0.05, 0.1],
                    "counts": [10, 5, 1, 0], "sum": 0.3, "count": 16,
                },
            },
            "info": {},
        },
    }
    PREV = {
        "t": 10.0,
        "health": CUR["health"],
        "metrics": {
            "counters": {
                "gol_controller_dispatches{node=pod-a,tenant=alice}": 50,
                "gol_relay_frames_out{node=relay-1}": 100,
            },
            "gauges": {},
            "histograms": {
                "gol_relay_frame_staleness_seconds{node=relay-1}": {
                    "buckets": [0.01, 0.05, 0.1],
                    "counts": [0, 0, 0, 0], "sum": 0.0, "count": 0,
                },
            },
            "info": {},
        },
    }

    def test_pinned_frame(self):
        assert pod_top.render_fleet_collector(self.CUR, self.PREV) == (
            "collector NOT-READY | 3 node(s) | scrape every 0.5s "
            "(staleness bound 2.5s) | rounds 12 misses 3 | "
            "aggregate sample 0.2s old\n"
            "NODE               STATE         AGE  MISS  DISP/S "
            " FRAMES/S  STALE-P99  LAST ERROR\n"
            "pod-a              ready        0.4s     0       5 "
            "        -          -  -\n"
            "pod-b              STALE        9.1s     3       - "
            "        -          -  PodUnreachable: refused\n"
            "relay-1            ready        0.3s     0       - "
            "       40       92ms  -"
        )

    def test_first_frame_has_no_rates(self):
        frame = pod_top.render_fleet_collector(self.CUR)
        assert " 5 " not in frame.splitlines()[2]
        assert "92ms" in frame  # since-start staleness p99 still renders


class TestFlightReportFleet:
    DOC = {
        "schema": "gol-fleet-flight-v1",
        "sources": ["broker", "pod-a"],
        "records": [
            {"t": 10.0, "kind": "pod_condemned", "node": "broker",
             "pod": "http://x", "misses": 2, "stranded": ["alice"]},
            {"t": 10.5, "kind": "failover", "node": "broker",
             "tenant": "alice", "from_pod": "http://x",
             "to_pod": "http://y", "checkpoint_turn": 42,
             "trace_id": "deadbeefcafe"},
            {"t": 10.6, "kind": "dispatch", "node": "dump:flight-1.json",
             "turn": 7, "cause": "Boom"},
        ],
    }

    def test_pinned_timeline(self):
        assert flight_report.render_fleet(self.DOC).splitlines() == [
            "fleet flight timeline (3 record(s) from 2 source(s): "
            "broker, pod-a)",
            "  +   0.000s  broker              pod_condemned    "
            "pod http://x CONDEMNED after 2 missed probe(s), "
            "stranding ['alice']",
            "  +   0.500s  broker              failover         "
            "tenant alice FAILED OVER http://x -> http://y "
            "from checkpoint turn 42 [trace deadbeef]",
            "  +   0.600s  dump:flight-1.json  dispatch         "
            "turn=7 cause=Boom",
        ]

    def test_wrong_schema_refused(self):
        with pytest.raises(ValueError):
            flight_report.render_fleet({"schema": "gol-flight-v1"})


class TestTraceExportFleetLanes:
    def test_one_process_lane_per_node(self):
        doc = tracing.stitch_traces({
            "broker": [trace_doc(
                "ee" * 16, "gol.broker.failover", 10.0,
                [{"name": "gol.broker.place", "span_id": "1",
                  "parent_id": None, "t0_ns": 0, "dur_ns": 1000}],
            )],
            "pod-b": [trace_doc(
                "ee" * 16, "gol.request", 10.1,
                [{"name": "gol.admission", "span_id": "1",
                  "parent_id": None, "t0_ns": 0, "dur_ns": 1000}],
            )],
        })
        chrome = trace_export.to_chrome(doc)
        lanes = {
            e["args"]["name"]: e["pid"]
            for e in chrome["traceEvents"]
            if e["ph"] == "M"
        }
        assert lanes == {
            "broker [gol.broker.failover]": 1, "pod-b [gol.request]": 2,
        }
        span_pids = {
            e["name"]: e["pid"]
            for e in chrome["traceEvents"]
            if e["ph"] == "X"
        }
        assert span_pids["gol.broker.place"] == 1
        assert span_pids["gol.admission"] == 2
        json.dumps(chrome)  # Chrome-loadable


# -- the chaos row -------------------------------------------------------------


class TestFleetChaos:
    def test_sigkill_failover_is_one_fleet_story(self, tmp_path):
        """Broker + two REAL subprocess pods + one relay under a live
        collector; SIGKILL the pod running alice mid-run and read the
        whole incident off the fleet plane."""
        root = tmp_path / "ckpt"
        alice_spec = spec_doc(12_000, seed=5, checkpoint_every=16)
        bob_spec = {
            **spec_doc(8_000, seed=9),
            "spectate": True,
            "viewport": [0, 0, 32, 32],
        }

        proc_a, pod_a = start_subprocess_pod(root)
        proc_b, pod_b = start_subprocess_pod(root)
        procs = {pod_a: proc_a, pod_b: proc_b}
        broker = relay = server = None
        try:
            broker = Broker(
                [pod_a, pod_b],
                BrokerConfig(
                    probe_interval_seconds=0.1,
                    probe_miss_threshold=2,
                    checkpoint_root=root,
                ),
            )
            client = GolClient(broker.url)
            wait_for(
                lambda: all(
                    p["ready"] and p["status"] == "ready"
                    for p in broker.pod_states()
                ),
                60, "both pods probed ready",
            )

            receipt = submit_via(client, "alice", alice_spec)
            victim = receipt["pod"]
            survivor = pod_b if victim == pod_a else pod_a
            # Placement scores the last PROBED health — wait for the
            # prober to see alice's cells before the second submit, so
            # headroom puts bob on the other pod.
            wait_for(
                lambda: any(
                    p["endpoint"] == victim and p["resident_cells"] > 0
                    for p in broker.pod_states()
                ),
                60, "the probe to reflect alice's placement",
            )
            bob_receipt = submit_via(client, "bob", bob_spec)
            assert bob_receipt["pod"] == survivor, (
                "headroom placement should spread the tenants"
            )
            bob_tid = bob_receipt["broker_trace_id"]

            # The relay leg: subscribed to bob's stream on the survivor,
            # scraped as a fleet node like any pod.
            relay = RelayServer(
                f"{survivor}/v1/sessions/bob/frames?queue=256",
                cache_deltas=4096, queue_depth=4096,
                backoff_initial=0.05, backoff_max=0.2,
            )
            wait_for(
                lambda: relay.health()["frames_in"] > 0,
                60, "relay ingesting bob's frames",
            )

            collector = FleetCollector(
                {
                    "pod-a": pod_a,
                    "pod-b": pod_b,
                    "relay": relay.url,
                },
                interval=0.1,
                scrape_timeout=1.0,
                checkpoint_root=root,
                objectives=SLOObjectives(
                    latency_seconds=30.0,
                    error_rate=0.5,
                    fast_window_seconds=2.0,
                    slow_window_seconds=6.0,
                    budget_window_seconds=60.0,
                ),
                local_name="broker",
                local_flight=broker.flight,
            )
            server = CollectorServer(collector, port=0)

            def alice_fleet_dispatches():
                row = collector.fleet_slo()["tenants"].get("alice")
                return row["dispatches_total"] if row else 0

            wait_for(
                lambda: alice_fleet_dispatches() > 0,
                60, "alice's dispatches visible on the fleet plane",
            )
            d0 = alice_fleet_dispatches()
            # Frame-header publish stamps observed end to end: the
            # relay's staleness histogram rides /fleet/metrics under
            # its node label.
            stale_key = (
                "gol_relay_frame_staleness_seconds{node=relay}"
            )
            wait_for(
                lambda: openmetrics.parse(collector.render_metrics())
                .get("histograms", {})
                .get(stale_key, {})
                .get("count", 0)
                > 0,
                60, "relay staleness histogram on the fleet page",
            )

            # SIGKILL alice's pod mid-run (past a durable checkpoint).
            wait_for(
                lambda: (broker_state(client, "alice") or {}).get(
                    "turn", 0
                ) >= 64,
                60, "alice past turn 64",
            )
            base_miss = counter("fleet.scrape_misses{node="
                                + ("pod-a" if victim == pod_a else "pod-b")
                                + "}")
            procs[victim].send_signal(signal.SIGKILL)
            wait_for(
                lambda: procs[victim].poll() is not None, 10, "pod death"
            )
            wait_for(
                lambda: broker.placement("alice") == survivor,
                60, "failover placement",
            )
            st = wait_for(
                lambda: (
                    (s := broker_state(client, "alice"))
                    and s["status"] in ("completed", "failed")
                    and s
                ),
                120, "alice completion on the survivor",
            )
            assert st["status"] == "completed"

            # (1) Budget continuity: the fleet series never reset.
            wait_for(
                lambda: alice_fleet_dispatches() >= d0,
                30, "fleet dispatch series monotone across failover",
            )

            # (2) The merged postmortem reads condemn -> failover in
            # one node-stamped sequence.
            merged = wait_for(
                lambda: (
                    (m := collector.merged_flight())
                    and any(
                        r["kind"] == "failover" for r in m["records"]
                    )
                    and m
                ),
                30, "failover in the merged flight timeline",
            )
            kinds = [
                r["kind"] for r in merged["records"]
                if r["node"] == "broker"
            ]
            assert kinds.index("pod_condemned") < kinds.index("failover")
            assert "broker" in merged["sources"]
            report = flight_report.render_fleet(merged)
            assert "CONDEMNED" in report and "FAILED OVER" in report

            # (3) The stitched failover trace spans >= 2 processes on
            # one shared id, and exports to Chrome lanes.
            failover = next(
                r for r in broker.flight.records()
                if r["kind"] == "failover"
            )
            tid = failover["trace_id"]
            stitched = wait_for(
                lambda: (
                    (d := collector.stitched_trace(tid))
                    and len(
                        {
                            n for n in d["nodes"]
                            if n == "broker" or n.startswith("pod-")
                        }
                    ) >= 2
                    and d
                ),
                30, "stitched trace across broker + survivor pod",
            )
            names = {s["name"] for s in stitched["spans"]}
            assert "gol.broker.place" in names
            assert "gol.admission" in names, "pod-side spans on the id"
            chrome = trace_export.to_chrome(stitched)
            span_pids = {
                e["pid"] for e in chrome["traceEvents"] if e["ph"] == "X"
            }
            assert len(span_pids) >= 2, "Chrome lanes span processes"

            # The relay joined bob's request trace via the re-exported
            # traceparent: one id from pod publish to relay subscribe.
            bob_stitched = collector.stitched_trace(bob_tid)
            assert bob_stitched is not None
            assert "gol.relay.subscribe" in {
                s["name"] for s in bob_stitched["spans"]
            }

            # (4) Never-block, fleet-sized: with one pod DEAD, every
            # /fleet/* endpoint answers in bounded time.
            assert counter(
                "fleet.scrape_misses{node="
                + ("pod-a" if victim == pod_a else "pod-b")
                + "}"
            ) > base_miss
            for path in (
                "/fleet/metrics",
                "/fleet/healthz",
                "/fleet/slo",
                "/fleet/flight",
                f"/fleet/traces/{tid}",
            ):
                t0 = time.monotonic()
                code, _ = http_get(server.url + path, timeout=10.0)
                elapsed = time.monotonic() - t0
                assert code in (200, 503), f"{path}: HTTP {code}"
                assert elapsed < 2.0, (
                    f"{path} took {elapsed:.2f}s with a dead pod"
                )
        finally:
            if server is not None:
                server.close()  # closes the collector too
            if relay is not None:
                relay.close()
            if broker is not None:
                broker.close()
            for proc in procs.values():
                reap(proc)


# -- the port's collector against the JAX package's ----------------------------


def mask_ages(obj):
    """A health/SLO doc with its clock readings masked (sample ages,
    timestamps): what is left must agree between the packages."""
    if isinstance(obj, dict):
        return {
            k: ("<t>" if ("age" in k or k.endswith("_t") or k in ("t", "ts", "now"))
                else mask_ages(v))
            for k, v in obj.items()
        }
    if isinstance(obj, list):
        return [mask_ages(v) for v in obj]
    return obj


def both_collectors(nodes: dict, **kw):
    """(JAX collector, port collector) over the same nodes, each on a
    registry of its own so that no other test's instruments ride the
    page."""
    from distributed_gol_tpu.obs import metrics as jmetrics
    from distributed_gol_tpu.obs.fleet import FleetCollector as JCollector

    jc = JCollector(nodes, start=False, registry=jmetrics.MetricsRegistry(), **kw)
    tc = FleetCollector(nodes, start=False, registry=metrics_lib.MetricsRegistry(), **kw)
    return jc, tc


HIST = {"buckets": [0.1, 1.0], "counts": [2, 1, 0], "sum": 0.4, "count": 3}


class TestAgainstTheJaxCollector:
    @pytest.mark.parametrize(
        "snapshots",
        [
            [node_snapshot(dispatches=10, queue_depth=3.0, latency=HIST),
             node_snapshot(dispatches=5, queue_depth=7.0, latency=HIST)],
            [node_snapshot(dispatches=100, tenant="alice"),
             node_snapshot(dispatches=40, tenant="bob", latency=HIST),
             node_snapshot(dispatches=1, tenant="carol", queue_depth=2.5)],
        ],
        ids=["two-nodes", "three-tenants"],
    )
    def test_fleet_metrics_text_equals_the_jax_collectors(self, snapshots):
        """Over the same fixed node snapshots, the port's
        ``/fleet/metrics`` text, ``/fleet/healthz`` (clock readings
        masked) and ``/fleet/slo`` are the JAX collector's; again after
        one node dies and costs a miss."""
        nodes = [StubNode(s) for s in snapshots]
        collectors = ()
        try:
            collectors = both_collectors(
                {f"n{i}": n.url for i, n in enumerate(nodes)},
                interval=0.05, scrape_timeout=0.5,
            )
            for c in collectors:
                c.scrape_once()
            jc, tc = collectors
            assert tc.render_metrics() == jc.render_metrics()
            assert openmetrics.parse(tc.render_metrics())["counters"]
            assert mask_ages(tc.fleet_health()) == mask_ages(jc.fleet_health())
            assert mask_ages(tc.fleet_slo()) == mask_ages(jc.fleet_slo())

            nodes[0].close()
            for c in collectors:
                c.scrape_once()
            assert tc.render_metrics() == jc.render_metrics()
            th, jh = tc.fleet_health(), jc.fleet_health()
            assert th["nodes"]["n0"]["consecutive_misses"] == 1
            for h in (th, jh):
                h["nodes"]["n0"]["last_error"] = "<masked>"
            assert mask_ages(th) == mask_ages(jh)
        finally:
            for c in collectors:
                c.close()
            for n in nodes:
                n.close()

    def test_merged_flight_and_stitched_trace_equal_the_jax_collectors(self, tmp_path):
        tid = "ab" * 16
        n1, n2 = StubNode(), StubNode()
        n1.flight_records += [{"t": 5.0, "kind": "dispatch", "turn": 3},
                              {"t": 7.0, "kind": "abort", "cause": "Boom", "turn": 4}]
        n2.flight_records += [{"t": 6.0, "kind": "pod_condemned", "pod": "http://x"}]
        n1.traces[tid] = trace_doc(tid, "gol.request", 50.0, [
            {"name": "gol.admission", "span_id": "1", "parent_id": None,
             "t0_ns": 10, "dur_ns": 5}])
        n2.traces[tid] = trace_doc(tid, "gol.relay.subscribe", 50.25, [
            {"name": "gol.relay.subscribe", "span_id": "1", "parent_id": None,
             "t0_ns": 20, "dur_ns": 5}])
        collectors = ()
        try:
            collectors = both_collectors({"n1": n1.url, "n2": n2.url}, interval=0.05,
                                         scrape_timeout=2.0, checkpoint_root=tmp_path)
            jc, tc = collectors
            assert tc.merged_flight() == jc.merged_flight()
            assert tc.stitched_trace(tid[:8]) == jc.stitched_trace(tid[:8])
        finally:
            for c in collectors:
                c.close()
            n1.close()
            n2.close()


# -- the operator tools, unchanged, against the port's servers -----------------


def run_tool(main, argv, capsys) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out


class TestToolsAgainstThePort:
    def test_tools_read_the_ports_broker_collector_relay_and_flight(self, tmp_path, capsys):
        """A port pod behind a port broker with its collector, a port
        relay on the pod's spectator leg and a standalone port collector:
        ``pod_top`` renders the fleet, the relay and the collector views;
        ``trace_export --fleet`` stitches the submission's broker and pod
        spans into Chrome lanes; ``flight_report`` renders the merged
        fleet flight and a flight dump of the broker's ring;
        ``gol_client`` watches through the relay, on its own
        ``/v1/frames`` and on the ``/v1/sessions/<x>/frames`` alias."""
        from distributed_gol_torch.serve import GatewayServer, ServeConfig, ServePlane
        from tools import gol_client

        root = tmp_path / "ckpt"
        plane = ServePlane(ServeConfig(max_sessions=4, telemetry_sample_seconds=0.1),
                           checkpoint_root=root)
        gw = GatewayServer(plane, port=0, device="cpu")
        broker = relay = server = None
        try:
            broker = Broker([gw.url], BrokerConfig(
                probe_interval_seconds=0.1, checkpoint_root=root, collector=True,
                collector_interval_seconds=0.1))
            client = GolClient(broker.url)
            wait_for(lambda: all(p["ready"] for p in broker.pod_states()), 30, "pod probed")
            spec = {**spec_doc(400, seed=3), "spectate": True, "viewport": [0, 0, 32, 32]}
            receipt = submit_via(client, "alice", spec)
            tid = receipt["broker_trace_id"]
            gw._sessions["alice"].pause()
            relay = RelayServer(f"{gw.url}/v1/sessions/alice/frames?queue=512",
                                cache_deltas=512, queue_depth=512,
                                backoff_initial=0.05, backoff_max=0.2)
            wait_for(lambda: relay.health()["connected"], 30, "relay connected")
            collector = FleetCollector({"pod": gw.url, "relay": relay.url}, interval=0.1,
                                       scrape_timeout=1.0, checkpoint_root=root)
            server = CollectorServer(collector, port=0)
            client.resume("alice")
            wait_for(lambda: (broker_state(client, "alice") or {}).get("status") == "completed",
                     60, "alice completed")
            wait_for(lambda: relay.health()["ended"], 30, "end reached the relay")

            rc, out = run_tool(pod_top.main, [broker.url, "--once", "--fleet"], capsys)
            assert rc == 0 and gw.url in out
            rc, out = run_tool(pod_top.main, [broker.url, "--once", "--collector"], capsys)
            assert rc == 0 and out.startswith("collector ") and node_name(gw.url) in out
            wait_for(lambda: collector.fleet_health()["nodes"]["relay"]["ready"], 30,
                     "the collector scraped the relay")
            rc, out = run_tool(pod_top.main, [server.url, "--once"], capsys)
            assert rc == 0 and "relay" in out and "pod" in out
            rc, out = run_tool(pod_top.main, [relay.url, "--once"], capsys)
            assert rc == 0 and "relay" in out

            out_path = tmp_path / "trace.json"
            rc, _ = run_tool(trace_export.main, [
                "--url", broker.url, "--fleet", "--trace-id", tid, "-o", str(out_path)], capsys)
            assert rc == 0
            chrome = json.loads(out_path.read_text())
            lanes = {e["args"]["name"] for e in chrome["traceEvents"] if e["ph"] == "M"}
            assert any(n.startswith("broker") for n in lanes) and len(lanes) >= 2

            rc, out = run_tool(flight_report.main, ["--fleet", broker.url], capsys)
            assert rc == 0 and "fleet flight timeline" in out
            dump = broker.flight.dump(tmp_path / "dumps", cause="Drill", turn=400)
            rc, out = run_tool(flight_report.main, [str(dump.parent)], capsys)
            assert rc == 0 and "cause: Drill" in out

            for argv in (["--relay", relay.url, "watch", "-", "--no-render"],
                         [relay.url, "watch", "alice", "--no-render"]):
                rc, out = run_tool(gol_client.main, argv, capsys)
                lines = out.strip().splitlines()
                assert rc == 0 and lines[0].startswith("turn ") and "keyframe" in lines[0]
                assert lines[-1].startswith("turn 400:")
        finally:
            if server is not None:
                server.close()
            if relay is not None:
                relay.close()
            if broker is not None:
                broker.close()
            gw.close()
            plane.close()
