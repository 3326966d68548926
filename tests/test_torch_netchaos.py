"""Wire chaos on the port: ``distributed_gol_torch.testing.netchaos`` and
every wire hop of the port's serving tier under it, on the CPU.

The rows of ``tests/test_netchaos.py`` run against the port's modules:
the proxy itself, one fault kind at a time; WebSocket keepalive and
malformed frames; httpd hardening (408/413/503); gateway idempotency;
client deadlines; half-open stall detection for the relay and the broker's
probe loop; the socket-hygiene lint over the port's package; and the
chaos matrix (a broker, two pods and a depth-2 relay chain, every hop
behind a seeded ``ChaosProxy``), whose finals must equal the JAX
package's fault-free solo runs.  Then the port's plans and proxies are
held to the JAX package's: a seeded ``WirePlan`` and its JSON give the
same faults, and every fault kind strikes the same ``fired`` list against
one echo server.  Pods run on the CPU (``device="cpu"``); every server
binds port 0 and is closed in ``finally``; every test has its own time
limit (``tests/test_torch_telemetry.py::time_limit``).
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_gol_torch.engine import frames as frames_lib
from distributed_gol_torch.engine.events import FrameReady
from distributed_gol_torch.obs import metrics as obs_metrics
from distributed_gol_torch.serve import (
    GatewayServer,
    RelayServer,
    ServeConfig,
    ServePlane,
)
from distributed_gol_torch.serve import wire
from distributed_gol_torch.serve import ws as ws_lib
from distributed_gol_torch.serve.broker import Broker, BrokerConfig
from distributed_gol_torch.serve.httpd import StdlibHTTPServer, read_body
from distributed_gol_torch.serve.podclient import (
    IDEMPOTENCY_HEADER,
    PodClient,
    PodHTTPError,
)
from distributed_gol_torch.testing.netchaos import (
    WIRE_FAULT_KINDS,
    ChaosProxy,
    WireFault,
    WirePlan,
)
from tests.test_torch_federation import event_board, jax_solo
from tests.test_torch_telemetry import time_limit  # noqa: F401 — autouse fixture
from tools.gol_client import GolClient

REPO = Path(__file__).resolve().parent.parent

W = H = 32

pytestmark = pytest.mark.chaos

#: Each test's time limit (``test_torch_telemetry.time_limit``): these
#: drive pods, relays and child processes, which a loaded machine slows.
TIME_LIMIT = 240

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def spec_doc(turns, seed, spectate=False, checkpoint_every=0):
    doc = {
        "params": {
            "width": W,
            "height": H,
            "turns": turns,
            "engine": "roll",
            "superstep": 4,
            "cycle_check": 0,
            "ticker_period": 60.0,
        },
        "soup": {"seed": seed, "density": 0.3},
    }
    if spectate:
        doc["spectate"] = True
        doc["viewport"] = [0, 0, W, H]
    if checkpoint_every:
        doc["checkpoint_every"] = checkpoint_every
    return doc


def submit_via(client, tenant, spec):
    body = dict(json.loads(json.dumps(spec)))
    body["tenant"] = tenant
    return client._request("POST", "/v1/sessions", body)


def wait_for(predicate, timeout=30.0, what="condition", interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def counter(name):
    snap = obs_metrics.REGISTRY.snapshot().to_dict()
    return snap["counters"].get(name, 0)


def broker_state(client, tenant):
    """State poll that survives a chaotic wire: any transport error or
    corrupted body reads as "not there yet"."""
    try:
        st = client.state(tenant)
    except Exception:
        return None
    if not isinstance(st, dict) or "status" not in st:
        return None
    return st


def chaos_submit(client, tenant, spec, timeout=60.0):
    """Submit through a faulty wire.  A retried POST after an eaten 201
    lands a 409 from the pod — any exception falls back to a state
    poll; success == the session exists."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            return submit_via(client, tenant, spec)
        except Exception as exc:  # noqa: BLE001 - chaos path
            last = exc
            st = broker_state(client, tenant)
            if st is not None:
                return st
            time.sleep(0.2)
    raise AssertionError(
        f"chaos submit for {tenant!r} never landed: {last!r}"
    )


def oracle_final(tmp_path, tenant, spec):
    """Fault-free oracle: the JAX package's solo run of the same spec,
    as a 0/255 board."""
    return jax_solo(tmp_path, tenant, spec)[0]


def chaos_threads():
    return [
        t.name
        for t in threading.enumerate()
        if t.name.startswith("gol-netchaos")
    ]


def want_board(final):
    return (np.asarray(final) != 0).astype(np.uint8) * np.uint8(255)


def final_board(client, tenant, size):
    """The final board via the controller replay ring (the oracle a
    frame-stream drain never touches)."""
    with client.controller(tenant) as ctrl:
        while True:
            msg = ctrl.recv(timeout=30)
            if msg["type"] == "final":
                board = np.zeros((size, size), np.uint8)
                for x, y in msg["alive"]:
                    board[y, x] = 255
                return board
            if msg["type"] == "end":
                raise AssertionError("stream ended without a final")


def pause_session(gateway, tenant, timeout=30.0):
    wait_for(
        lambda: tenant in gateway._sessions,
        timeout,
        f"session {tenant!r}",
    )
    s = gateway._sessions[tenant]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s.pause()
        if s.paused:
            return s
        time.sleep(0.002)
    raise AssertionError(f"could not pause {tenant!r}")


class Echo:
    """Tiny TCP echo server — the proxy unit tests' upstream."""

    def __init__(self):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(16)
        self._srv.settimeout(0.2)
        self.host, self.port = self._srv.getsockname()
        self.accepted = 0
        self._closing = False
        self._threads = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="test-echo-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.accepted += 1
            t = threading.Thread(
                target=self._serve, args=(conn,),
                name="test-echo-conn", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve(self, conn):
        conn.settimeout(0.2)
        try:
            while not self._closing:
                try:
                    data = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                conn.sendall(data)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        self._accept_thread.join(2.0)
        for t in self._threads:
            t.join(2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StreamDrain:
    """Drains a frame stream into a board, folding keyframes + deltas."""

    def __init__(self, host, port, path, sock_timeout=120.0):
        self.host, self.port, self.path = host, port, path
        self.sock_timeout = sock_timeout
        self.buf = None
        self.turn = -1
        self.frames = 0
        self.ended = False
        self.error = None
        self._ws = None
        self.thread = threading.Thread(
            target=self._run, name="test-stream-drain", daemon=True
        )

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        try:
            ws = ws_lib.client_connect(
                self.host, self.port, self.path, timeout=30.0
            )
            self._ws = ws
            ws._sock.settimeout(self.sock_timeout)
            while True:
                op, payload = ws.recv()
                if op == ws_lib.OP_TEXT:
                    doc = json.loads(payload.decode("utf-8"))
                    if doc.get("type") == "end":
                        self.ended = True
                        return
                    continue
                ev = wire.decode_frame_event(bytes(payload))
                if isinstance(ev, FrameReady):
                    self.buf = np.array(
                        ev.frame, dtype=np.uint8, copy=True
                    )
                elif self.buf is not None:
                    frames_lib.apply_bands(self.buf, ev.bands)
                self.turn = ev.completed_turns
                self.frames += 1
        except Exception as exc:  # noqa: BLE001 - surfaced via .error
            self.error = exc
        finally:
            if self._ws is not None:
                try:
                    self._ws.abort()
                except OSError:
                    pass

    def join(self, timeout=120.0):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "drain thread stuck"
        if self.error is not None:
            raise self.error


# ---------------------------------------------------------------------------
# WireFault / WirePlan: the deterministic schedule
# ---------------------------------------------------------------------------


class TestWirePlan:
    def test_fault_validation(self):
        with pytest.raises(ValueError):
            WireFault(0, "gremlins")
        with pytest.raises(ValueError):
            WireFault(-1, "latency")
        with pytest.raises(ValueError):
            WireFault(0, "latency", seconds=-0.1)
        with pytest.raises(ValueError):
            WireFault(0, "corrupt", after_bytes=-1)

    def test_duplicate_connection_index_rejected(self):
        with pytest.raises(ValueError):
            WirePlan(
                [WireFault(2, "latency"), WireFault(2, "disconnect")]
            )

    def test_lookup_and_ordering(self):
        plan = WirePlan(
            [WireFault(5, "stall"), WireFault(1, "latency", seconds=0.2)]
        )
        assert [f.at for f in plan.faults] == [1, 5]
        assert plan.fault_at(1).kind == "latency"
        assert plan.fault_at(5).kind == "stall"
        assert plan.fault_at(0) is None
        assert plan.fault_at(3) is None

    def test_random_is_seed_deterministic(self):
        a = WirePlan.random(7, 64, p_fault=0.4)
        b = WirePlan.random(7, 64, p_fault=0.4)
        c = WirePlan.random(8, 64, p_fault=0.4)
        assert a.faults == b.faults
        assert a.faults != c.faults

    def test_random_edges_and_kinds(self):
        assert WirePlan.random(3, 32, p_fault=0.0).faults == ()
        dense = WirePlan.random(3, 32, p_fault=1.0)
        assert len(dense.faults) == 32
        only = WirePlan.random(5, 64, p_fault=1.0, kinds=("corrupt",))
        assert {f.kind for f in only.faults} == {"corrupt"}
        for kind in WIRE_FAULT_KINDS:
            assert isinstance(kind, str)

    def test_from_json_scripted_and_seeded(self, tmp_path):
        scripted = WirePlan.from_json(
            json.dumps(
                {
                    "faults": [
                        {"at": 0, "kind": "latency", "seconds": 0.1},
                        {"at": 2, "kind": "corrupt", "after_bytes": 9},
                    ]
                }
            )
        )
        assert scripted.fault_at(0).seconds == 0.1
        assert scripted.fault_at(2).after_bytes == 9

        p = tmp_path / "plan.json"
        p.write_text(
            json.dumps({"seed": 7, "n_connections": 64, "p_fault": 0.4})
        )
        assert (
            WirePlan.from_json(str(p)).faults
            == WirePlan.random(7, 64, p_fault=0.4).faults
        )
        assert WirePlan.from_json("{}").faults == ()
        with pytest.raises(ValueError):
            WirePlan.from_json(json.dumps([1, 2, 3]))


# ---------------------------------------------------------------------------
# ChaosProxy semantics, one fault kind at a time (against a TCP echo)
# ---------------------------------------------------------------------------


def echo_rtt(proxy, payload=b"ping-pong", timeout=5.0):
    """One connect + echo round trip through the proxy; returns
    (reply, elapsed_seconds)."""
    t0 = time.monotonic()
    with socket.create_connection(
        (proxy.host, proxy.port), timeout=timeout
    ) as s:
        s.settimeout(timeout)
        s.sendall(payload)
        got = b""
        while len(got) < len(payload):
            chunk = s.recv(4096)
            if not chunk:
                break
            got += chunk
    return got, time.monotonic() - t0


class TestChaosProxy:
    def test_clean_passthrough(self):
        with Echo() as echo:
            with ChaosProxy((echo.host, echo.port)) as proxy:
                got, _ = echo_rtt(proxy, b"hello wire")
                assert got == b"hello wire"
                assert proxy.fired == []
                assert proxy.connections == 1
            assert proxy.open_connections() == 0

    def test_latency_delays_but_delivers(self):
        plan = WirePlan([WireFault(0, "latency", seconds=0.3)])
        with Echo() as echo, ChaosProxy(
            (echo.host, echo.port), plan
        ) as proxy:
            got, dt = echo_rtt(proxy)
            assert got == b"ping-pong"
            assert 0.3 <= dt < 5.0
            assert [f.kind for f in proxy.fired] == ["latency"]

    def test_trickle_preserves_bytes(self):
        plan = WirePlan([WireFault(0, "trickle", seconds=0.002)])
        payload = bytes(range(64))
        with Echo() as echo, ChaosProxy(
            (echo.host, echo.port), plan
        ) as proxy:
            got, _ = echo_rtt(proxy, payload, timeout=10.0)
            assert got == payload
            assert [f.kind for f in proxy.fired] == ["trickle"]

    def test_corrupt_flips_exactly_one_byte(self):
        plan = WirePlan([WireFault(0, "corrupt", after_bytes=5)])
        payload = bytes(range(16))
        with Echo() as echo, ChaosProxy(
            (echo.host, echo.port), plan
        ) as proxy:
            got, _ = echo_rtt(proxy, payload)
            assert len(got) == 16
            want = bytearray(payload)
            want[5] ^= 0xFF
            assert got == bytes(want)

    def test_disconnect_cuts_after_offset(self):
        plan = WirePlan([WireFault(0, "disconnect", after_bytes=8)])
        with Echo() as echo, ChaosProxy(
            (echo.host, echo.port), plan
        ) as proxy:
            with socket.create_connection(
                (proxy.host, proxy.port), timeout=5.0
            ) as s:
                s.settimeout(5.0)
                s.sendall(bytes(range(32)))
                got = b""
                while True:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    got += chunk
            assert len(got) == 8

    def test_disconnect_at_accept(self):
        plan = WirePlan([WireFault(0, "disconnect")])
        with Echo() as echo, ChaosProxy(
            (echo.host, echo.port), plan
        ) as proxy:
            with socket.create_connection(
                (proxy.host, proxy.port), timeout=5.0
            ) as s:
                s.settimeout(5.0)
                assert s.recv(1) == b""
            assert echo.accepted == 0

    def test_blackhole_never_reaches_upstream(self):
        plan = WirePlan([WireFault(0, "blackhole")])
        with Echo() as echo:
            proxy = ChaosProxy((echo.host, echo.port), plan)
            try:
                with socket.create_connection(
                    (proxy.host, proxy.port), timeout=5.0
                ) as s:
                    s.settimeout(0.4)
                    s.sendall(b"anyone home?")
                    with pytest.raises(socket.timeout):
                        s.recv(1)
                assert echo.accepted == 0
                assert proxy.open_connections() == 1
            finally:
                proxy.close()
            assert proxy.open_connections() == 0

    def test_stall_goes_half_open_and_pins(self):
        plan = WirePlan([WireFault(0, "stall", after_bytes=4)])
        with Echo() as echo:
            proxy = ChaosProxy((echo.host, echo.port), plan)
            try:
                with socket.create_connection(
                    (proxy.host, proxy.port), timeout=5.0
                ) as s:
                    s.settimeout(0.5)
                    s.sendall(bytes(range(16)))
                    got = b""
                    with pytest.raises(socket.timeout):
                        while True:
                            chunk = s.recv(4096)
                            if not chunk:
                                break
                            got += chunk
                    assert len(got) == 4
                    assert proxy.stalled_connections() == 1
            finally:
                proxy.close()
            assert proxy.stalled_connections() == 0
            assert proxy.open_connections() == 0

    def test_stall_self_releases_after_hang_seconds(self):
        plan = WirePlan([WireFault(0, "stall")])
        with Echo() as echo, ChaosProxy(
            (echo.host, echo.port), plan, hang_seconds=0.4
        ) as proxy:
            with socket.create_connection(
                (proxy.host, proxy.port), timeout=5.0
            ) as s:
                s.settimeout(5.0)
                s.sendall(b"x")
                t0 = time.monotonic()
                assert s.recv(1) == b""  # hang timer tore the pair down
                assert time.monotonic() - t0 < 5.0
            wait_for(
                lambda: proxy.stalled_connections() == 0,
                5.0,
                "stall self-release",
            )

    def test_url_and_upstream_forms(self):
        with Echo() as echo:
            with ChaosProxy(f"http://{echo.host}:{echo.port}") as proxy:
                assert proxy.url.startswith("http://127.0.0.1:")
                got, _ = echo_rtt(proxy, b"via-url")
                assert got == b"via-url"

    def test_set_plan_relative_rebases_to_next_connection(self):
        with Echo() as echo, ChaosProxy((echo.host, echo.port)) as proxy:
            for _ in range(3):
                echo_rtt(proxy)
            proxy.set_plan(
                WirePlan([WireFault(0, "disconnect")]), relative=True
            )
            with socket.create_connection(
                (proxy.host, proxy.port), timeout=5.0
            ) as s:
                s.settimeout(5.0)
                assert s.recv(1) == b""
            got, _ = echo_rtt(proxy)  # fault consumed; next conn clean
            assert got == b"ping-pong"


# ---------------------------------------------------------------------------
# WS keepalive + malformed frames, unit level (socketpair, no HTTP)
# ---------------------------------------------------------------------------


def ws_pair(max_payload=1 << 20):
    """(websocket, peer raw socket) over a socketpair — the peer plays
    an arbitrary (possibly hostile) remote."""
    a, b = socket.socketpair()
    ws = ws_lib.WebSocket(
        a.makefile("rb"), a.makefile("wb"), mask=False, sock=a,
        max_payload=max_payload,
    )
    b.settimeout(5.0)
    return ws, a, b


class TestWsKeepaliveUnit:
    def test_silent_peer_times_out_within_budget(self):
        ws, a, b = ws_pair()
        try:
            ws.enable_keepalive(0.15, misses=2)
            t0 = time.monotonic()
            with pytest.raises(ws_lib.WsTimeout):
                ws.recv()
            dt = time.monotonic() - t0
            assert 0.2 <= dt <= 1.5
        finally:
            a.close()
            b.close()

    def test_live_peer_survives_silence_past_budget(self):
        ws, a, b = ws_pair()
        stop = threading.Event()

        peer_ws = ws_lib.WebSocket(
            b.makefile("rb"), b.makefile("wb"), mask=True, sock=b
        )

        def peer():
            """Pongs every ping from t=0 — alive, just no data."""
            try:
                while not stop.is_set():
                    peer_ws.recv()  # auto-pong keeps us honest
            except (ws_lib.WsClosed, OSError):
                pass

        t = threading.Thread(target=peer, daemon=True)
        t.start()
        speak = threading.Timer(
            0.8, lambda: peer_ws.send_text("late but alive")
        )
        speak.start()
        try:
            ws.enable_keepalive(0.15, misses=2)
            op, payload = ws.recv()
            assert op == ws_lib.OP_TEXT
            assert payload == b"late but alive"
        finally:
            stop.set()
            # shutdown (not just close) wakes the peer thread blocked in
            # recv — close() alone leaves it parked until the join cap.
            for s in (a, b):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            a.close()
            b.close()
            t.join(5.0)
            speak.cancel()
            speak.join(5.0)

    def test_keepalive_toggle_remembers_policy(self):
        ws, a, b = ws_pair()
        try:
            assert ws.keepalive is None
            ws.enable_keepalive(0.25, misses=4)
            assert ws.keepalive == (0.25, 4)
            # Suspending hands the deadline to explicit settimeout
            # polls but REMEMBERS the policy for re-arming.
            ws.disable_keepalive()
            assert ws.keepalive == (0.25, 4)
            ws.enable_keepalive(*ws.keepalive)
            assert ws.keepalive == (0.25, 4)
            with pytest.raises(ValueError):
                ws.enable_keepalive(0.0)
            with pytest.raises(ValueError):
                ws.enable_keepalive(1.0, misses=0)
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize(
        "blob,reason",
        [
            (bytes([0x91, 0x00]), "reserved RSV bits"),
            (bytes([0x09, 0x00]), "fragmented control frame"),
            (bytes([0x89, 0x7E, 0x00, 0x80]), "oversize control frame"),
        ],
    )
    def test_malformed_unit_frames_close_cleanly(self, blob, reason):
        ws, a, b = ws_pair()
        try:
            b.sendall(blob)
            with pytest.raises(ws_lib.WsClosed):
                ws.recv()
        finally:
            a.close()
            b.close()

    def test_oversize_declaration_closes(self):
        ws, a, b = ws_pair(max_payload=256)
        try:
            b.sendall(bytes([0x82, 0x7F]) + struct.pack(">Q", 1 << 30))
            with pytest.raises(ws_lib.WsClosed):
                ws.recv()
        finally:
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# httpd hardening: 408 slow-loris, 413 oversize, 503 shed
# ---------------------------------------------------------------------------


class PingServer(StdlibHTTPServer):
    """Minimal wire target: GET /ping, POST /echo."""

    def handle(self, request, method, path, query):
        if method == "GET" and path == "/ping":
            request._send_json(200, {"ok": True})
            return True
        if method == "POST" and path == "/echo":
            body = read_body(request)
            request._send_json(200, {"n": len(body)})
            return True
        return False


def raw_get(host, port, path="/ping", timeout=5.0):
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(
            f"GET {path} HTTP/1.1\r\nHost: x\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        data = b""
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
    return data


class TestHttpdHardening:
    def test_slowloris_reaped_with_408(self):
        srv = PingServer(port=0, read_timeout=0.3)
        try:
            base = counter("net.slowloris_reaped")
            with socket.create_connection(
                (srv.host, srv.port), timeout=5.0
            ) as s:
                s.settimeout(5.0)
                s.sendall(b"GET /pi")  # ...and then never finishes
                data = b""
                while True:
                    try:
                        chunk = s.recv(4096)
                    except socket.timeout:
                        break
                    if not chunk:
                        break
                    data += chunk
            assert b"408" in data
            assert counter("net.slowloris_reaped") == base + 1
        finally:
            srv.close()

    def test_oversize_body_rejected_with_413(self):
        srv = PingServer(port=0, body_cap=1024)
        try:
            base = counter("net.oversize_rejected")
            conn = http.client.HTTPConnection(
                srv.host, srv.port, timeout=5.0
            )
            try:
                conn.request(
                    "POST", "/echo", body=b"x" * 4096,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                assert resp.status == 413
                resp.read()
            finally:
                conn.close()
            assert counter("net.oversize_rejected") == base + 1

            conn = http.client.HTTPConnection(
                srv.host, srv.port, timeout=5.0
            )
            try:
                conn.request("POST", "/echo", body=b"y" * 512)
                resp = conn.getresponse()
                assert resp.status == 200
                assert json.loads(resp.read())["n"] == 512
            finally:
                conn.close()
        finally:
            srv.close()

    def test_connection_shed_with_503(self):
        srv = PingServer(port=0, max_connections=1)
        try:
            base = counter("net.connections_shed")
            # Conn 1 parks mid-request on the only slot: with no read
            # deadline configured the handler blocks in readline and
            # the slot stays held for as long as we like.
            hog = socket.create_connection(
                (srv.host, srv.port), timeout=5.0
            )
            try:
                hog.sendall(b"GET /pi")  # never finished
                # The slot is acquired on the accept thread; give it a
                # few attempts to have landed before the shed probe.
                for attempt in range(5):
                    data = raw_get(srv.host, srv.port)
                    if b"503" in data.split(b"\r\n", 1)[0]:
                        break
                    time.sleep(0.05)
                else:
                    raise AssertionError(f"no 503 over 5 sheds: {data!r}")
                assert counter("net.connections_shed") >= base + 1
            finally:
                hog.close()
        finally:
            srv.close()

    def test_hardening_defaults_off(self):
        srv = PingServer(port=0)
        try:
            with socket.create_connection(
                (srv.host, srv.port), timeout=5.0
            ) as s:
                s.settimeout(5.0)
                s.sendall(b"GET /ping HTTP/1.1\r\nHost: x\r\n")
                time.sleep(0.5)  # no read_timeout: slow is tolerated
                s.sendall(b"Connection: close\r\n\r\n")
                data = b""
                while True:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    data += chunk
            assert b"200" in data.split(b"\r\n", 1)[0]
        finally:
            srv.close()


# ---------------------------------------------------------------------------
# Gateway idempotency: replayed receipts instead of double placement
# ---------------------------------------------------------------------------


def post_sessions(gw, doc, key=None):
    """Raw POST /v1/sessions with an optional idempotency key; returns
    (status, body-dict, replay-header-or-None)."""
    conn = http.client.HTTPConnection(gw.host, gw.port, timeout=10.0)
    try:
        headers = {"Content-Type": "application/json"}
        if key:
            headers[IDEMPOTENCY_HEADER] = key
        conn.request(
            "POST", "/v1/sessions",
            body=json.dumps(doc).encode(), headers=headers,
        )
        resp = conn.getresponse()
        body = json.loads(resp.read() or b"{}")
        return resp.status, body, resp.getheader("X-Gol-Idempotent-Replay")
    finally:
        conn.close()


class TestGatewayIdempotency:
    def test_same_key_replays_identical_receipt(self, tmp_path):
        plane = ServePlane(
            ServeConfig(max_sessions=4), checkpoint_root=tmp_path / "c"
        )
        gw = GatewayServer(plane, port=0, device="cpu")
        try:
            base = counter("net.idempotent_replays")
            # Long enough that the session is still live for every POST
            # below — a completed session frees the tenant slot and a
            # keyless resubmit would be honestly re-ADMITTED (201).
            doc = {"tenant": "alice", **spec_doc(3000, 3)}
            st1, body1, rp1 = post_sessions(gw, doc, key="k-alice-1")
            assert st1 == 201
            assert rp1 is None
            st2, body2, rp2 = post_sessions(gw, doc, key="k-alice-1")
            assert (st2, body2) == (st1, body1)
            assert rp2 == "1"
            assert counter("net.idempotent_replays") == base + 1
            # One session, not two: a keyless resubmit is a real
            # rejection (409 permanent or 429 shed), never a replay.
            st3, _, rp3 = post_sessions(gw, doc)
            assert st3 in (409, 429)
            assert rp3 is None
        finally:
            gw.close()
            plane.close()

    def test_receipt_ring_evicts_oldest(self, tmp_path):
        plane = ServePlane(
            ServeConfig(max_sessions=4, idempotency_cache_size=2),
            checkpoint_root=tmp_path / "c",
        )
        gw = GatewayServer(plane, port=0, device="cpu")
        try:
            for i, tenant in enumerate(("t0", "t1", "t2")):
                doc = {"tenant": tenant, **spec_doc(8, 3 + i)}
                st, _, _ = post_sessions(gw, doc, key=f"k-{tenant}")
                assert st == 201
            # k-t0 was evicted (ring holds 2): the retry falls through
            # to admission — whatever admission says, it is NOT a
            # replayed receipt.
            st, _, rp = post_sessions(
                gw, {"tenant": "t0", **spec_doc(8, 3)}, key="k-t0"
            )
            assert st in (201, 409, 429)
            assert rp is None
            # k-t2 is still in the ring.
            st, _, rp = post_sessions(
                gw, {"tenant": "t2", **spec_doc(8, 5)}, key="k-t2"
            )
            assert st == 201
            assert rp == "1"
        finally:
            gw.close()
            plane.close()


class FlakyPod(StdlibHTTPServer):
    """Eats the first POST /v1/sessions mid-response, answers the
    retry — records the idempotency key each attempt carried."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.keys = []

    def handle(self, request, method, path, query):
        if method == "POST" and path == "/v1/sessions":
            read_body(request)
            self.keys.append(request.headers.get(IDEMPOTENCY_HEADER))
            if len(self.keys) == 1:
                request.connection.shutdown(socket.SHUT_RDWR)
                raise BrokenPipeError("chaos: ate the response")
            request._send_json(201, {"tenant": "alice"})
            return True
        if method == "GET" and path == "/big":
            request._send_json(200, {"pad": "x" * 4096})
            return True
        return False


class TestPodClientHardening:
    def test_retry_reuses_one_idempotency_key(self):
        pod = FlakyPod(port=0)
        try:
            client = PodClient(
                pod.url, attempts=2, backoff_seconds=0.01,
                backoff_max_seconds=0.05,
            )
            doc = client.submit({"tenant": "alice", **spec_doc(8, 3)})
            assert doc == {"tenant": "alice"}
            assert len(pod.keys) == 2
            assert pod.keys[0] is not None
            assert pod.keys[0] == pod.keys[1]
        finally:
            pod.close()

    def test_response_cap_rejects_oversize_body(self):
        pod = FlakyPod(port=0)
        try:
            client = PodClient(pod.url, response_cap=512)
            with pytest.raises(PodHTTPError) as exc:
                client.request("GET", "/big")
            assert "cap" in str(exc.value)
        finally:
            pod.close()


# ---------------------------------------------------------------------------
# Client deadlines (satellite: tools/gol_client.py hardening)
# ---------------------------------------------------------------------------


class TestClientDeadlines:
    def test_stalled_gateway_fails_fast_not_forever(self, tmp_path):
        plane = ServePlane(
            ServeConfig(max_sessions=1), checkpoint_root=tmp_path / "c"
        )
        gw = GatewayServer(plane, port=0, device="cpu")
        proxy = ChaosProxy(
            (gw.host, gw.port),
            WirePlan([WireFault(0, "stall")]),
            hang_seconds=30.0,
        )
        try:
            client = GolClient(
                proxy.url, timeout=1.0, connect_timeout=1.0
            )
            t0 = time.monotonic()
            with pytest.raises((OSError, TimeoutError)):
                client.state("nobody")
            assert time.monotonic() - t0 < 3.0
        finally:
            proxy.close()
            gw.close()
            plane.close()

    def test_connect_timeout_defaults(self):
        assert GolClient("http://127.0.0.1:9", timeout=3.0).connect_timeout == 3.0
        assert (
            GolClient("http://127.0.0.1:9", timeout=60.0).connect_timeout
            == 10.0
        )


# ---------------------------------------------------------------------------
# WS fuzz: seeded malformed frames against a live gateway (satellite)
# ---------------------------------------------------------------------------


def _fuzz_blobs(rng):
    """One malformed wire blob per call, seeded — every shape the
    wire can carry: truncated headers, torn payloads, RSV bits,
    fragmented control frames, over-length declarations, garbage."""
    shapes = (
        lambda: bytes([rng.randrange(256)]),                    # truncated header
        lambda: bytes([0x81, 10]) + bytes(3),                   # torn payload
        lambda: bytes(
            [0x80 | rng.choice((0x10, 0x20, 0x40, 0x70)) | 0x1, 0x00]
        ),                                                      # RSV bits
        lambda: bytes([0x09, 0x00]),                            # fragmented ctrl
        lambda: bytes([0x82, 0x7F])
        + struct.pack(">Q", (1 << 40) + rng.randrange(1 << 20)),  # oversize decl
        lambda: bytes([0x89, 0x7E, 0x00, 0xFE]),                # oversize ctrl
        lambda: bytes(
            rng.randrange(256) for _ in range(rng.randrange(8, 160))
        ),                                                      # garbage
    )
    return rng.choice(shapes)()


class TestWsFuzz:
    def test_malformed_frames_never_wedge_the_gateway(self, tmp_path):
        plane = ServePlane(
            ServeConfig(max_sessions=2), checkpoint_root=tmp_path / "c"
        )
        gw = GatewayServer(plane, port=0, device="cpu")
        try:
            client = GolClient(gw.url)
            submit_via(client, "alice", spec_doc(4000, 11, spectate=True))
            pause_session(gw, "alice")

            def reader_threads():
                return sum(
                    1
                    for t in threading.enumerate()
                    if t.name.startswith("gol-gateway-ws-reader")
                )

            rng = random.Random(0x600D5EED)
            path = "/v1/sessions/alice/frames?queue=64"
            # Two full passes over every malformed shape (the blob menu
            # is 7 entries sampled round-robin-ish by the seeded rng).
            for _ in range(14):
                ws = ws_lib.client_connect(
                    gw.host, gw.port, path, timeout=10.0
                )
                try:
                    ws._sock.sendall(_fuzz_blobs(rng))
                    ws._sock.settimeout(0.2)
                    try:
                        while ws._sock.recv(4096):
                            pass
                    except socket.timeout:
                        pass
                finally:
                    ws.abort()

            # The gateway still answers health in bounded time...
            t0 = time.monotonic()
            with urllib.request.urlopen(
                f"{gw.url}/healthz", timeout=2.0
            ) as resp:
                assert resp.status == 200
            assert time.monotonic() - t0 < 2.0

            # ...still serves a clean spectator...
            ws = ws_lib.client_connect(
                gw.host, gw.port, path, timeout=10.0
            )
            try:
                ws._sock.settimeout(10.0)
                op, payload = ws.recv()
                assert op == ws_lib.OP_TEXT
                assert json.loads(payload)["type"] == "hello"
            finally:
                ws.abort()

            # ...and its reader threads drained back to zero.
            wait_for(
                lambda: reader_threads() == 0,
                15.0,
                "gateway ws-reader threads to drain",
            )
        finally:
            gw.close()
            plane.close()


# ---------------------------------------------------------------------------
# Half-open stall detection pins (acceptance): relay upstream + broker probe
# ---------------------------------------------------------------------------


class TestRelayStallHalfOpen:
    def test_stalled_upstream_detected_within_keepalive_bound(
        self, tmp_path
    ):
        turns = 300
        ka = 0.5
        plane = ServePlane(
            ServeConfig(max_sessions=2), checkpoint_root=tmp_path / "c"
        )
        gw = GatewayServer(plane, port=0, device="cpu")
        proxy = relay = drain = None
        try:
            client = GolClient(gw.url)
            submit_via(
                client, "alice", spec_doc(turns, 17, spectate=True)
            )
            pause_session(gw, "alice")
            # The relay's FIRST upstream leg goes half-open just past
            # the upgrade (the ~129-byte handshake response), inside
            # the hello — the classic silent half-open: TCP happy,
            # peer never speaks again.
            proxy = ChaosProxy(
                (gw.host, gw.port),
                WirePlan([WireFault(0, "stall", after_bytes=200)]),
                hang_seconds=60.0,
            )
            relay = RelayServer(
                proxy.url + f"/v1/sessions/alice/frames?queue={turns + 8}",
                cache_deltas=turns + 16,
                queue_depth=turns + 8,
                backoff_initial=0.05,
                backoff_max=0.2,
                connect_timeout=5.0,
                keepalive_seconds=ka,
                registry=obs_metrics.REGISTRY,
            )
            base_drops = counter("net.keepalive_drops")
            base_resub = counter("relay.resubscribes")
            # The stall strikes inside the hello, right after connect.
            wait_for(
                lambda: proxy.stalled_connections() == 1,
                30.0,
                "stall to strike",
            )
            t0 = time.monotonic()
            wait_for(
                lambda: counter("net.keepalive_drops") > base_drops,
                ka * 3 + 5.0,
                "keepalive drop",
            )
            detect = time.monotonic() - t0
            assert detect <= ka * 3 + 2.0, (
                f"half-open detection took {detect:.2f}s "
                f"(budget {ka * 3:.2f}s + 2s slack)"
            )
            # Recovery: the clean second connection carries the whole
            # stream end to end, bit-exact.
            wait_for(
                lambda: proxy.connections >= 2
                and relay.health()["connected"],
                30.0,
                "resubscribe on a clean connection",
            )
            drain = StreamDrain(
                relay.host, relay.port, "/v1/frames?queue=4096"
            ).start()
            client.resume("alice")
            drain.join(120.0)
            assert drain.ended
            assert drain.turn == turns
            assert np.array_equal(
                drain.buf, final_board(client, "alice", W)
            )
            assert counter("relay.resubscribes") > base_resub
        finally:
            if drain is not None and drain.thread.is_alive():
                drain.thread.join(5.0)
            if relay is not None:
                relay.close()
            if proxy is not None:
                proxy.close()
            gw.close()
            plane.close()


class TestBrokerProbeStall:
    def test_stalled_probe_condemns_within_probe_bound(self, tmp_path):
        interval, probe_timeout, misses = 0.1, 0.5, 2
        plane = ServePlane(
            ServeConfig(max_sessions=2), checkpoint_root=tmp_path / "c"
        )
        gw = GatewayServer(plane, port=0, device="cpu")
        proxy = ChaosProxy((gw.host, gw.port), hang_seconds=2.0)
        broker = None
        try:
            broker = Broker(
                [proxy.url],
                BrokerConfig(
                    probe_interval_seconds=interval,
                    probe_timeout_seconds=probe_timeout,
                    probe_miss_threshold=misses,
                    rejoin_threshold=2,
                ),
            )
            wait_for(
                lambda: broker.pod_states()[0]["ready"],
                30.0,
                "pod ready via probes",
            )
            base = counter("broker.pods_condemned")
            # Every probe connection from NOW stalls half-open (the
            # probe's read deadline, not TCP, must notice).
            proxy.set_plan(
                WirePlan([WireFault(i, "stall") for i in range(6)]),
                relative=True,
            )
            t0 = time.monotonic()
            wait_for(
                lambda: counter("broker.pods_condemned") > base,
                misses * (interval + probe_timeout) + 10.0,
                "condemnation",
            )
            detect = time.monotonic() - t0
            assert detect <= misses * (interval + probe_timeout) + 2.0, (
                f"probe-stall detection took {detect:.2f}s (budget "
                f"{misses * (interval + probe_timeout):.2f}s + 2s slack)"
            )
            # The stall burst exhausts; healthy probes rejoin the pod.
            wait_for(
                lambda: broker.pod_states()[0]["ready"]
                and not broker.pod_states()[0]["condemned"],
                30.0,
                "pod rejoin after the burst",
            )
        finally:
            if broker is not None:
                broker.close()
            proxy.close()
            gw.close()
            plane.close()


# ---------------------------------------------------------------------------
# Socket-hygiene lint (satellite): tier-1 gate, both directions
# ---------------------------------------------------------------------------


class TestSocketHygiene:
    """``tools/check_socket_hygiene.py`` scans the JAX package and
    tools/; these rows point its roots at the port's package, with no
    allowlist."""

    @pytest.fixture
    def lint(self, monkeypatch):
        from tools import check_socket_hygiene

        monkeypatch.setattr(
            check_socket_hygiene, "SCAN_ROOTS", ("distributed_gol_torch",)
        )
        monkeypatch.setattr(check_socket_hygiene, "ALLOWLIST", {})
        return check_socket_hygiene

    def test_repo_is_clean(self, lint):
        assert lint.check(REPO) == []
        new = {
            "distributed_gol_torch/serve/podclient.py",
            "distributed_gol_torch/testing/netchaos.py",
        }
        assert new <= {rel for rel, *_ in lint.sites(REPO)}

    def test_checker_catches_drift_both_directions(self, lint, tmp_path):
        pkg = tmp_path / "distributed_gol_torch"
        pkg.mkdir()
        (pkg / "mod.py").write_text(
            "import socket\n"
            "conn = socket.create_connection((host, port))\n"
        )
        lint.ALLOWLIST[
            ("distributed_gol_torch/gone.py", "s = socket.socket()")
        ] = "a ghost"
        problems = lint.check(tmp_path)
        assert any("undeadlined socket" in p for p in problems)
        assert any("stale allowlist entry" in p for p in problems)

        # Deadline the site and drop the ghost: clean.
        (pkg / "mod.py").write_text(
            "import socket\n"
            "conn = socket.create_connection((host, port), timeout=5)\n"
        )
        lint.ALLOWLIST.clear()
        assert lint.check(tmp_path) == []

    def test_cli_entrypoint_reports_clean(self):
        import subprocess
        import sys

        code = (
            "import sys; sys.path.insert(0, 'tools'); "
            "import check_socket_hygiene as c; "
            "c.SCAN_ROOTS = ('distributed_gol_torch',); c.ALLOWLIST = {}; "
            "sys.exit(c.main())"
        )
        proc = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=60,
            cwd=str(REPO),
        )
        assert proc.returncode == 0, proc.stderr
        assert "socket hygiene clean" in proc.stdout


# ---------------------------------------------------------------------------
# The chaos matrix (tentpole acceptance): broker + 2 pods + depth-2
# relay chain, EVERY hop behind a seeded proxy — bit-identical finals,
# bounded health, no leaks.
# ---------------------------------------------------------------------------


class TestChaosMatrix:
    def test_full_cluster_converges_under_wire_chaos(self, tmp_path):
        # Control hops (client→broker, broker→pod A/B) take the full
        # fault alphabet at request-sized offsets; the relay hops skip
        # trickle (a per-byte crawl on a multi-KB frame stream) and
        # strike at byte 120 — inside the 129-byte WS handshake
        # response, so every breaking fault lands mid-handshake.
        CONTROL = dict(
            p_fault=0.3,
            kinds=("latency", "trickle", "disconnect", "corrupt", "stall"),
            seconds=0.003,
            after_bytes=200,
        )
        # Relay-hop faults are all BREAKING ones: a non-breaking fault
        # (latency) would park the relay mid-burst — with the stream
        # paused nothing ever disturbs a live connection, so it would
        # never advance past the remaining scheduled faults.
        RELAY = dict(
            p_fault=1.0,
            kinds=("stall", "disconnect", "corrupt"),
            seconds=0.0005,
            after_bytes=120,
        )
        BREAKING = ("stall", "disconnect", "corrupt")

        def settled(proxy, plan):
            """The proxy's CURRENT connection (= connections - 1; the
            relay is its only client) is past every breaking fault."""
            last = max(
                (f.at for f in plan.faults if f.kind in BREAKING),
                default=-1,
            )
            return proxy.connections - 1 > last

        alice_spec = spec_doc(600, 5, spectate=True)
        bob_spec = spec_doc(600, 9)
        carol_spec = spec_doc(500, 13)

        baseline_threads = threading.active_count()
        stack = []

        def push(obj):
            stack.append(obj)
            return obj

        # Health watchdog: every plane answers /healthz (via its
        # DIRECT url — the bound is on the server, not the chaos) in
        # under 2 s for the whole run.
        watch_stop = threading.Event()
        watch_urls = []
        watch_worst = [0.0]
        watch_failures = []

        def watchdog():
            while not watch_stop.is_set():
                for url in list(watch_urls):
                    t0 = time.monotonic()
                    try:
                        try:
                            with urllib.request.urlopen(
                                f"{url}/healthz", timeout=2.0
                            ):
                                pass
                        except urllib.error.HTTPError:
                            pass  # 503-with-a-body is an answer
                    except Exception as exc:  # noqa: BLE001
                        watch_failures.append(f"{url}: {exc!r}")
                    dt = time.monotonic() - t0
                    watch_worst[0] = max(watch_worst[0], dt)
                watch_stop.wait(0.25)

        watch_thread = threading.Thread(
            target=watchdog, name="test-healthz-watchdog", daemon=True
        )

        try:
            # -- the cluster, every hop proxied ---------------------------
            # Pod A gets the most headroom: placement sorts on free
            # capacity, so alice (the relay leg's tenant) lands there.
            plane_a = push(
                ServePlane(
                    ServeConfig(max_sessions=4),
                    checkpoint_root=tmp_path / "ca",
                )
            )
            gw_a = push(GatewayServer(plane_a, port=0, device="cpu"))
            plane_b = push(
                ServePlane(
                    ServeConfig(max_sessions=4, max_total_cells=300_000),
                    checkpoint_root=tmp_path / "cb",
                )
            )
            gw_b = push(GatewayServer(plane_b, port=0, device="cpu"))
            proxy_a = push(
                ChaosProxy(
                    (gw_a.host, gw_a.port),
                    WirePlan.random(101, 4096, **CONTROL),
                    hang_seconds=1.0,
                )
            )
            proxy_b = push(
                ChaosProxy(
                    (gw_b.host, gw_b.port),
                    WirePlan.random(202, 4096, **CONTROL),
                    hang_seconds=1.0,
                )
            )
            broker = push(
                Broker(
                    [proxy_a.url, proxy_b.url],
                    BrokerConfig(
                        probe_interval_seconds=0.2,
                        probe_timeout_seconds=1.0,
                        probe_miss_threshold=8,
                        rejoin_threshold=1,
                        request_timeout_seconds=10.0,
                        connect_timeout_seconds=2.0,
                        attempts=3,
                        backoff_seconds=0.05,
                        backoff_max_seconds=0.2,
                        failover=False,
                    ),
                )
            )
            proxy_c = push(
                ChaosProxy(
                    (broker.host, broker.port),
                    WirePlan.random(303, 4096, **CONTROL),
                    hang_seconds=1.0,
                )
            )
            client = GolClient(proxy_c.url, timeout=5.0, connect_timeout=3.0)
            direct_a = GolClient(gw_a.url)

            watch_urls.extend([gw_a.url, gw_b.url, broker.url])
            watch_thread.start()

            wait_for(
                lambda: all(p["ready"] for p in broker.pod_states()),
                60.0,
                "both pods ready through chaotic probes",
            )

            # -- submissions through the chaotic control path -------------
            # A spectate run with no subscriber burns thousands of
            # turns per second; the watcher pauses alice within a few
            # turns of creation so the relay leg has a stream to join.
            paused_evt = threading.Event()

            def pause_watcher():
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline:
                    s = gw_a._sessions.get("alice")
                    if s is not None:
                        try:
                            s.pause()
                        except Exception:  # noqa: BLE001
                            pass
                        if getattr(s, "paused", False):
                            paused_evt.set()
                            return
                    time.sleep(0.002)

            pw = threading.Thread(
                target=pause_watcher, name="test-pause-watcher",
                daemon=True,
            )
            pw.start()

            chaos_submit(client, "alice", alice_spec)
            assert paused_evt.wait(30.0), "alice never paused"
            pw.join(5.0)
            wait_for(
                lambda: any(
                    "alice" in p["placed"] and p["endpoint"] == proxy_a.url
                    for p in broker.pod_states()
                ),
                30.0,
                "alice placed on pod A",
            )
            chaos_submit(client, "bob", bob_spec)
            chaos_submit(client, "carol", carol_spec)

            # -- the depth-2 relay chain, both hops chaotic ---------------
            plan_f1 = WirePlan.random(404, 6, **RELAY)
            plan_f2 = WirePlan.random(505, 6, **RELAY)
            proxy_f1 = push(
                ChaosProxy(
                    (gw_a.host, gw_a.port), plan_f1, hang_seconds=1.5
                )
            )
            r1 = push(
                RelayServer(
                    proxy_f1.url + "/v1/sessions/alice/frames?queue=1024",
                    cache_deltas=1400,
                    queue_depth=1024,
                    backoff_initial=0.05,
                    backoff_max=0.2,
                    connect_timeout=3.0,
                    keepalive_seconds=1.0,
                    registry=obs_metrics.REGISTRY,
                )
            )
            proxy_f2 = push(
                ChaosProxy((r1.host, r1.port), plan_f2, hang_seconds=1.5)
            )
            r2 = push(
                RelayServer(
                    proxy_f2.url + "/v1/frames?queue=1024",
                    cache_deltas=1400,
                    queue_depth=1024,
                    backoff_initial=0.05,
                    backoff_max=0.2,
                    connect_timeout=3.0,
                    keepalive_seconds=1.0,
                    registry=obs_metrics.REGISTRY,
                )
            )
            watch_urls.extend([r1.url, r2.url])

            # Both relays fight through their 6-connection fault burst
            # and settle on a clean steady-state connection BEFORE the
            # run resumes (a resubscribe after session end would never
            # re-anchor: keyframes only ride published turns).
            wait_for(
                lambda: r1.health()["connected"]
                and settled(proxy_f1, plan_f1),
                90.0,
                "relay 1 settled past its fault burst",
            )
            wait_for(
                lambda: r2.health()["connected"]
                and settled(proxy_f2, plan_f2),
                90.0,
                "relay 2 settled past its fault burst",
            )

            drain = StreamDrain(
                r2.host, r2.port, "/v1/frames?queue=4096"
            ).start()
            direct_a.resume("alice")

            # -- convergence ----------------------------------------------
            for tenant in ("alice", "bob", "carol"):
                wait_for(
                    lambda t=tenant: (
                        (broker_state(client, t) or {}).get("status")
                        == "completed"
                    ),
                    120.0,
                    f"{tenant} completed through the chaotic path",
                )
            drain.join(120.0)
            assert drain.ended
            assert drain.turn == 600

            # Bit-identity against the fault-free oracle, all tenants.
            alice_fb = final_board(direct_a, "alice", W)
            assert np.array_equal(drain.buf, alice_fb)
            assert np.array_equal(
                alice_fb, oracle_final(tmp_path, "alice", alice_spec)
            )
            for tenant, spec in (
                ("bob", bob_spec), ("carol", carol_spec)
            ):
                handle = plane_a.handle(tenant) or plane_b.handle(tenant)
                assert handle is not None, f"{tenant} on neither pod"
                assert np.array_equal(
                    event_board(handle.final, W),
                    oracle_final(tmp_path, tenant, spec),
                )

            # Chaos actually struck, across hops and kinds.
            all_proxies = (
                proxy_a, proxy_b, proxy_c, proxy_f1, proxy_f2
            )
            fired = [f for p in all_proxies for f in p.fired]
            assert len(fired) >= 5, f"chaos barely fired: {fired}"
            assert len({f.kind for f in fired}) >= 3
            assert len(proxy_f1.fired) >= 1

            # Health stayed bounded the whole run.
            watch_stop.set()
            watch_thread.join(5.0)
            assert not watch_failures, watch_failures[:5]
            assert watch_worst[0] < 2.0, (
                f"worst /healthz answer {watch_worst[0]:.2f}s"
            )

            # -- teardown + leak pin --------------------------------------
            while stack:
                stack.pop().close()
            wait_for(
                lambda: chaos_threads() == [],
                20.0,
                "chaos proxy threads to drain",
            )
            for p in all_proxies:
                assert p.open_connections() == 0
            wait_for(
                lambda: threading.active_count()
                <= baseline_threads + 4,
                20.0,
                f"thread count to settle (baseline {baseline_threads}, "
                f"now {threading.active_count()})",
            )
        finally:
            watch_stop.set()
            while stack:
                try:
                    stack.pop().close()
                except Exception:  # noqa: BLE001
                    pass


# ---------------------------------------------------------------------------
# The port's plans and proxies against the JAX package's
# ---------------------------------------------------------------------------


def fault_rows(faults):
    return [(f.at, f.kind, f.seconds, f.after_bytes) for f in faults]


class TestAgainstTheJaxPackage:
    @pytest.mark.parametrize(
        "args,kw",
        [
            ((7, 64), dict(p_fault=0.4)),
            ((101, 4096), dict(p_fault=0.3, kinds=WIRE_FAULT_KINDS[:5],
                               seconds=0.003, after_bytes=200)),
            ((404, 6), dict(p_fault=1.0, kinds=("stall", "disconnect", "corrupt"),
                            seconds=0.0005, after_bytes=120)),
            ((9, 50), dict(p_fault=0.5, kinds=WIRE_FAULT_KINDS, burst=3)),
        ],
        ids=["default-kinds", "control-hops", "relay-hops", "bursts"],
    )
    def test_seeded_plan_equals_the_jax_plan(self, args, kw, tmp_path):
        from distributed_gol_tpu.testing.netchaos import WirePlan as JPlan

        ours, theirs = WirePlan.random(*args, **kw), JPlan.random(*args, **kw)
        assert fault_rows(ours.faults) == fault_rows(theirs.faults)
        doc = dict(kw, seed=args[0], n_connections=args[1])
        doc["kinds"] = list(doc.get("kinds", ("latency", "trickle")))
        path = tmp_path / "plan.json"
        path.write_text(json.dumps(doc))
        for spec in (json.dumps(doc), str(path)):
            assert fault_rows(WirePlan.from_json(spec).faults) == fault_rows(
                JPlan.from_json(spec).faults
            ) == fault_rows(ours.faults)

    def test_scripted_json_plan_equals_the_jax_plan(self):
        from distributed_gol_tpu.testing.netchaos import WirePlan as JPlan

        text = json.dumps({"faults": [
            {"at": 3, "kind": "stall", "after_bytes": 40},
            {"at": 0, "kind": "latency", "seconds": 0.1},
            {"at": 2, "kind": "corrupt", "after_bytes": 9},
            {"at": 5, "kind": "blackhole"},
        ]})
        ours, theirs = WirePlan.from_json(text), JPlan.from_json(text)
        assert fault_rows(ours.faults) == fault_rows(theirs.faults)
        assert [f.at for f in ours.faults] == [0, 2, 3, 5]

    @pytest.mark.parametrize("kind", WIRE_FAULT_KINDS)
    def test_each_kind_fires_as_the_jax_proxy_fires(self, kind):
        """One echo server, two proxies (the JAX package's, then the
        port's) with the same one-fault plan and the same client
        exchange: the same bytes come back and the same faults fire."""
        from distributed_gol_tpu.testing import netchaos as jnet

        payload = bytes(range(48))
        fault = dict(seconds=0.001 if kind in ("latency", "trickle") else 0.0,
                     after_bytes=0 if kind == "blackhole" else 16)
        results = []
        with Echo() as echo:
            for mod in (jnet, None):
                Plan, Fault, Proxy = (
                    (mod.WirePlan, mod.WireFault, mod.ChaosProxy)
                    if mod is not None
                    else (WirePlan, WireFault, ChaosProxy)
                )
                plan = Plan([Fault(0, kind, **fault), Fault(1, "latency")])
                proxy = Proxy((echo.host, echo.port), plan, hang_seconds=0.5)
                try:
                    got = b""
                    with socket.create_connection(
                        (proxy.host, proxy.port), timeout=5.0
                    ) as s:
                        s.settimeout(1.0)
                        s.sendall(payload)
                        try:
                            while len(got) < len(payload):
                                chunk = s.recv(4096)
                                if not chunk:
                                    break
                                got += chunk
                        except socket.timeout:
                            pass
                    clean, _ = echo_rtt(proxy, b"second")
                finally:
                    proxy.close()
                results.append((got, clean, fault_rows(proxy.fired),
                                proxy.connections, proxy.open_connections()))
        assert results[0] == results[1]
        got, clean, fired, conns, still_open = results[1]
        assert fired == [(0, kind, fault["seconds"], fault["after_bytes"]),
                         (1, "latency", 0.0, 0)]
        assert clean == b"second" and conns == 2 and still_open == 0
