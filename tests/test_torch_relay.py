"""The spectator relay tier on the port (``serve/relay.py``), on the CPU
over real loopback sockets.

The rows of ``tests/test_relay.py`` against the port's relay and pods:
the depth-3 chain byte-identical to a direct gateway spectator, 256
viewers behind two relays on one upstream socket, a stalled downstream
isolated, a killed mid-chain relay resubscribed and re-keyframed, gap
deltas refused until a keyframe, a late joiner served from the cache (and
from a compacted keyframe), one encode a frame for any client count, the
FramePlane's one delta encode a distinct rect, and the WebSocket codec
against a plain RFC 6455 framer.  Then the port's relay against the JAX
package's on the same port gateway upstream: every frame, live and from a
late joiner's cache (compacted or not), is the same bytes.  Pods run on
the CPU; every server binds port 0 and is closed in ``finally``; every
test has its own time limit (``tests/test_torch_telemetry.py::time_limit``).
"""

import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from distributed_gol_torch.engine import frames as frames_lib
from distributed_gol_torch.engine.events import FrameDelta, FrameReady
from distributed_gol_torch.obs import metrics as obs_metrics
from distributed_gol_torch.serve import (
    GatewayServer,
    RelayServer,
    ServeConfig,
    ServePlane,
)
from distributed_gol_torch.serve import wire
from distributed_gol_torch.serve import ws as ws_lib
from distributed_gol_torch.serve.frames import FramePlane
from tests.test_torch_telemetry import time_limit  # noqa: F401 — autouse fixture
from tools.gol_client import GolClient

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

#: Each test's time limit (``test_torch_telemetry.time_limit``): these
#: drive pods, relays and child processes, which a loaded machine slows.
TIME_LIMIT = 240

#: Tight resubscribe knobs for chaos tests — outages heal in ~0.1 s
#: instead of the production 0.25 s → 5 s curve.
TIGHT = {"backoff_initial": 0.05, "backoff_max": 0.2,
         "connect_timeout": 5.0}


def spectate_spec(size: int, turns: int, seed: int = 11) -> dict:
    """A spectate-enabled wire spec: full-board viewport, cycle probe
    off so frame streams tile the whole run deterministically."""
    return {
        "params": {
            "width": size,
            "height": size,
            "turns": turns,
            "engine": "roll",
            "superstep": 4,
            "cycle_check": 0,
            "ticker_period": 60.0,
        },
        "soup": {"density": 0.3, "seed": seed},
        "spectate": True,
        "viewport": [0, 0, size, size],
    }


@pytest.fixture
def pod(tmp_path):
    plane = ServePlane(
        ServeConfig(max_sessions=4, telemetry_sample_seconds=0.1),
        checkpoint_root=tmp_path / "ckpt",
    )
    gateway = GatewayServer(plane, port=0, device="cpu")
    client = GolClient(gateway.url)
    yield plane, gateway, client
    gateway.close()
    plane.close()


def submit_spec(client: GolClient, tenant: str, spec: dict) -> dict:
    return client._request(
        "POST", "/v1/sessions", {"tenant": tenant, **spec}
    )


def wait_status(client, tenant, statuses, timeout=120.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = client.state(tenant)
        if st["status"] in statuses:
            return st
        time.sleep(0.05)
    raise AssertionError(
        f"{tenant} never reached {statuses}: {client.state(tenant)}"
    )


def pause_run(client, gateway, tenant, timeout=60.0) -> dict:
    """REST-pause the run and wait for the engine's authoritative
    ``StateChange("Paused")`` echo (not just the pause TARGET) — the
    deterministic attach point every relay/subscriber test anchors
    at, so streams compare exactly."""
    client.pause(tenant)
    session = gateway._sessions[tenant]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = client.state(tenant)
        assert st["status"] != "completed", (
            "run completed before the pause landed — spec turns too low"
        )
        if session.paused:
            return st
        time.sleep(0.05)
    raise AssertionError(f"{tenant} never quiesced after pause")


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def final_board(client, tenant: str, size: int) -> np.ndarray:
    """The final board via the controller replay ring (the oracle the
    relay tree never touches)."""
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


def make_relay(upstream: str, turns: int, **kw) -> RelayServer:
    """A test relay sized so a full post-pause run fits its cache and
    queues (no drops, no compaction unless a test asks for them)."""
    opts = dict(
        cache_deltas=turns + 16, queue_depth=turns + 8, **TIGHT
    )
    opts.update(kw)
    return RelayServer(upstream, **opts)


class RawDrain:
    """One raw spectator socket, upstream-format bookkeeping included:
    every binary frame is recorded as ``(turn, kind, wire blob)`` and
    folded into a reconstruction buffer — the byte-level oracle the
    bit-identity assertions compare."""

    def __init__(self, host: str, port: int, path: str,
                 recv_buffer=None):
        self.ws = ws_lib.client_connect(
            host, port, path, timeout=30.0, recv_buffer=recv_buffer
        )
        self.hello = None
        self.frames: list[tuple[int, str, bytes]] = []
        self.buf = None
        self.turn = 0
        self.keyframes = 0
        self.ended = False
        self.error = None

    def step(self, timeout=60.0) -> bool:
        """Consume one ws message; False once the stream ended."""
        if self.ended:
            return False
        self.ws.settimeout(timeout)
        op, payload = self.ws.recv()
        if op == ws_lib.OP_TEXT:
            msg = json.loads(payload)
            if msg.get("type") == "hello":
                self.hello = msg
            elif msg.get("type") == "end":
                self.ended = True
            return not self.ended
        blob = bytes(payload)
        ev = wire.decode_frame_event(blob)
        if isinstance(ev, FrameReady):
            self.buf = np.array(ev.frame, dtype=np.uint8, copy=True)
            self.keyframes += 1
            kind = "keyframe"
        else:
            if self.buf is not None:
                frames_lib.apply_bands(self.buf, ev.bands)
            kind = "delta"
        self.turn = ev.completed_turns
        self.frames.append((ev.completed_turns, kind, blob))
        return True

    def drain(self, timeout=60.0):
        try:
            while self.step(timeout=timeout):
                pass
        except Exception as e:  # joined and re-raised by the caller
            self.error = e

    def by_turn(self) -> dict[int, tuple[str, bytes]]:
        out: dict[int, tuple[str, bytes]] = {}
        for turn, kind, blob in self.frames:
            assert turn not in out, f"duplicate frame for turn {turn}"
            out[turn] = (kind, blob)
        return out

    def close(self):
        self.ws.close()


def want_board(final: np.ndarray) -> np.ndarray:
    return (final != 0) * np.uint8(255)


# -- the broadcast tree --------------------------------------------------------


class TestRelayTree:
    def test_depth3_chain_bit_identical_vs_direct_oracle(self, pod):
        """gateway → r1 → r2 → r3: the leaf of a depth-3 chain and a
        direct gateway spectator attached at the same pause point see
        the SAME stream — identical turn sets, kinds, and wire blobs —
        and the pod carries one spectator socket per subtree edge."""
        plane, gateway, client = pod
        size, turns = 32, 400
        submit_spec(client, "alice", spectate_spec(size, turns))
        pause_run(client, gateway, "alice")

        upstream = (
            f"{gateway.url}/v1/sessions/alice/frames?queue={turns + 8}"
        )
        r1 = make_relay(upstream, turns)
        r2 = make_relay(r1.url + "/v1/frames", turns)
        r3 = make_relay(r2.url + "/v1/frames", turns)
        direct = leaf = None
        try:
            for r in (r1, r2, r3):
                wait_until(
                    lambda r=r: r.health()["connected"],
                    msg=f"relay {r.url} connected",
                )
            wait_until(
                lambda: gateway._n_spectators == 1,
                msg="r1's one upstream subscription",
            )
            direct = RawDrain(
                gateway.host, gateway.port,
                f"/v1/sessions/alice/frames?queue={turns + 8}",
            )
            leaf = RawDrain(
                r3.host, r3.port, f"/v1/frames?queue={turns + 8}"
            )
            wait_until(
                lambda: gateway._n_spectators == 2,
                msg="direct spectator registered",
            )
            # One spectator socket per subtree edge, all the way down
            # (asserted while paused — sockets tear down after `end`).
            wait_until(
                lambda: r1.health()["clients"] == 1
                and r2.health()["clients"] == 1
                and r3.health()["clients"] == 1,
                msg="one downstream per relay edge",
            )
            client.resume("alice")
            threads = [
                threading.Thread(target=d.drain) for d in (direct, leaf)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "drain wedged"
            for d in (direct, leaf):
                if d.error is not None:
                    raise d.error
            wait_status(client, "alice", ("completed",))

            assert leaf.hello is not None and leaf.hello.get("relay")
            assert leaf.hello.get("tenant") == "alice"
            # The bit-identity: both subscribers anchored at the same
            # paused turn, so the maps must agree on EVERYTHING —
            # including the one initial keyframe each.
            assert direct.keyframes == 1
            assert leaf.keyframes == 1
            assert leaf.by_turn() == direct.by_turn()
            assert leaf.turn == direct.turn == turns
            want = want_board(final_board(client, "alice", size))
            assert np.array_equal(direct.buf, want)
            assert np.array_equal(leaf.buf, want)
            # Relay economics: every relay ingested each published
            # frame exactly once.
            n = len(leaf.frames)
            for r in (r1, r2, r3):
                assert r.health()["frames_in"] == n
        finally:
            for d in (direct, leaf):
                if d is not None:
                    d.close()
            for r in (r3, r2, r1):
                r.close()

    def test_256_clients_behind_two_relays_one_upstream_socket(
        self, pod
    ):
        """The fan-out economics pin: 256 viewers split across a
        chained relay pair cost the pod ONE spectator socket and 1.00
        fetches per published frame, and every viewer reconstructs
        bit-identically to the final board."""
        plane, gateway, client = pod
        size, turns, n_clients = 16, 300, 256
        submit_spec(client, "alice", spectate_spec(size, turns))
        pause_run(client, gateway, "alice")

        upstream = (
            f"{gateway.url}/v1/sessions/alice/frames?queue={turns + 8}"
        )
        r1 = make_relay(upstream, turns)
        r2 = make_relay(r1.url + "/v1/frames", turns)
        leaves: list[RawDrain] = []
        try:
            for r in (r1, r2):
                wait_until(
                    lambda r=r: r.health()["connected"],
                    msg=f"relay {r.url} connected",
                )
            reg = obs_metrics.REGISTRY
            fetches0 = reg.counter("frames.fetches").value
            publishes0 = reg.counter("frames.publishes").value
            # Sequential connects: socketserver's default accept
            # backlog is 5, so a thundering herd would need retries.
            for i in range(n_clients):
                r = r2 if i % 2 else r1
                leaves.append(
                    RawDrain(
                        r.host, r.port, f"/v1/frames?queue={turns + 8}"
                    )
                )
            # The whole tree still costs the pod ONE spectator socket.
            wait_until(
                lambda: r1.health()["clients"] == n_clients // 2 + 1
                and r2.health()["clients"] == n_clients // 2,
                msg="all leaves registered",
            )
            assert gateway._n_spectators == 1

            threads = [
                threading.Thread(target=d.drain) for d in leaves
            ]
            for t in threads:
                t.start()
            client.resume("alice")
            wait_status(client, "alice", ("completed",))
            for t in threads:
                t.join(timeout=180)
                assert not t.is_alive(), "leaf drain wedged"
            for d in leaves:
                if d.error is not None:
                    raise d.error

            # Pod economics, measured: fetches/frame == 1.00 for the
            # whole post-pause tail, and the relay ingested each
            # published frame exactly once.
            fetches = reg.counter("frames.fetches").value - fetches0
            publishes = (
                reg.counter("frames.publishes").value - publishes0
            )
            assert publishes > 0
            assert fetches == publishes, "fetches/frame != 1.00"
            assert r1.health()["frames_in"] == publishes
            # Egress amplification: the tree multiplied one upstream
            # stream into 256 client streams.
            assert (
                r1.health()["frames_out"] + r2.health()["frames_out"]
                >= n_clients * publishes
            )
            want = want_board(final_board(client, "alice", size))
            for d in leaves:
                assert d.turn == turns
                assert np.array_equal(d.buf, want)
        finally:
            for d in leaves:
                d.close()
            r2.close()
            r1.close()


# -- chaos ---------------------------------------------------------------------


class TestRelayChaos:
    def test_stalled_downstream_is_isolated(self, pod):
        """One viewer that attaches and reads NOTHING while the run
        completes: siblings stay on schedule with zero drops (exactly
        one keyframe, contiguous turns), the run finishes on time, and
        the stalled viewer re-anchors from the relay's cache —
        observed as >=2 keyframes on its wire — still converging to
        the final board."""
        plane, gateway, client = pod
        size, turns = 64, 150
        submit_spec(client, "alice", spectate_spec(size, turns))
        upstream = (
            f"{gateway.url}/v1/sessions/alice/frames?queue={turns + 8}"
        )
        r1 = make_relay(upstream, turns)
        siblings: list[RawDrain] = []
        stalled = None
        try:
            wait_until(
                lambda: r1.health()["connected"], msg="relay connected"
            )
            siblings = [
                RawDrain(
                    r1.host, r1.port, f"/v1/frames?queue={turns + 8}"
                )
                for _ in range(2)
            ]
            threads = [
                threading.Thread(target=d.drain) for d in siblings
            ]
            for t in threads:
                t.start()
            # The stall, deterministically: a pinned 4 KiB receive
            # buffer against the relay's bounded SO_SNDBUF wedges the
            # socket after a handful of keyframe-sized writes, and the
            # depth-2 queue must drop-oldest long before the run ends.
            stalled = RawDrain(
                r1.host, r1.port, "/v1/frames?queue=2",
                recv_buffer=4096,
            )
            st = wait_status(client, "alice", ("completed",))
            assert st["turn"] == turns, "stalled viewer wedged the run"
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive(), "sibling drain wedged"
            for d in siblings:
                if d.error is not None:
                    raise d.error

            want = want_board(final_board(client, "alice", size))
            for d in siblings:
                # On schedule, no drops: one keyframe, then every
                # turn in order.
                assert d.keyframes == 1
                seen = [turn for turn, _, _ in d.frames]
                assert seen == list(range(seen[0], turns + 1))
                assert np.array_equal(d.buf, want)

            # The stalled viewer finally drains: it lost frames
            # (drop-oldest), re-anchored via the cache resync
            # keyframe, and still converges.
            stalled.drain(timeout=60)
            if stalled.error is not None:
                raise stalled.error
            assert stalled.keyframes >= 2, "no re-keyframe on the wire"
            assert stalled.turn == turns
            assert np.array_equal(stalled.buf, want)
            health = r1.health()
            assert health["drops"] > 0
            assert health["cache_serves"] > 0
        finally:
            if stalled is not None:
                stalled.close()
            for d in siblings:
                d.close()
            r1.close()

    def test_upstream_kill_resubscribes_and_rekeyframes(self, pod):
        """Kill the MIDDLE of a gateway → r1 → r2 chain: r2's
        capped-backoff resubscribe finds the replacement relay on the
        same port, and the replacement's first keyframe — relayed
        verbatim — re-keyframes r2's whole subtree (the leaf observes
        a second FrameReady and still converges)."""
        plane, gateway, client = pod
        size, turns = 32, 400
        submit_spec(client, "alice", spectate_spec(size, turns))
        pause_run(client, gateway, "alice")

        upstream = (
            f"{gateway.url}/v1/sessions/alice/frames?queue={turns + 8}"
        )
        r1 = make_relay(upstream, turns)
        r2 = make_relay(r1.url + "/v1/frames", turns)
        r1b = leaf = None
        try:
            for r in (r1, r2):
                wait_until(
                    lambda r=r: r.health()["connected"],
                    msg=f"relay {r.url} connected",
                )
            leaf = RawDrain(
                r2.host, r2.port, f"/v1/frames?queue={turns + 8}"
            )
            client.resume("alice")
            # Let frames flow through the intact chain first.
            while len(leaf.frames) < 5:
                assert leaf.step(timeout=60)
            assert leaf.keyframes == 1
            turn_before_kill = leaf.turn

            # Quiesce, then kill r1 and rebind a replacement on the
            # SAME port (what a supervisor restart looks like to r2).
            pause_run(client, gateway, "alice")
            old_port = r1.port
            r1.close()
            r1b = make_relay(upstream, turns, port=old_port)
            wait_until(
                lambda: r2.health()["resubscribes"] >= 1
                and r2.health()["connected"],
                msg="r2 resubscribed to the replacement",
            )
            wait_until(
                lambda: r1b.health()["connected"],
                msg="replacement relay connected upstream",
            )

            client.resume("alice")
            leaf.drain(timeout=120)
            if leaf.error is not None:
                raise leaf.error
            # The seq-gap re-keyframe, observed at the leaf: a SECOND
            # FrameReady, later in the run than everything before the
            # kill, then contiguous deltas to the end.
            assert leaf.keyframes >= 2
            rekey_turns = [
                turn for turn, kind, _ in leaf.frames
                if kind == "keyframe"
            ]
            assert rekey_turns[-1] > turn_before_kill
            tail = [
                turn for turn, _, _ in leaf.frames
                if turn >= rekey_turns[-1]
            ]
            assert tail == list(range(rekey_turns[-1], turns + 1))
            assert leaf.turn == turns
            want = want_board(final_board(client, "alice", size))
            assert np.array_equal(leaf.buf, want)
        finally:
            if leaf is not None:
                leaf.close()
            for r in (r2, r1b, r1):
                if r is not None:
                    r.close()

    def test_gap_deltas_refused_until_keyframe(self):
        """The seq-gap latch, pinned at the ingest seam: a delta with
        no contiguous anchor is dropped (counted, never relayed); the
        next keyframe re-anchors, after which deltas relay verbatim."""
        rng = np.random.default_rng(3)
        prev = (rng.random((8, 8)) < 0.4).astype(np.uint8) * 255
        new = prev.copy()
        new[2, :] ^= 255
        kb = wire.encode_frame_event(
            FrameReady(3, prev, rect=(0, 0, 8, 8))
        )
        db = wire.encode_frame_event(
            FrameDelta(
                4, bands=frames_lib.delta_bands(prev, new),
                rect=(0, 0, 8, 8),
            )
        )
        # Port 9 (discard) refuses instantly: the upstream loop spins
        # harmlessly while the test feeds the ingest seam directly.
        r = RelayServer("http://127.0.0.1:9/v1/frames", **TIGHT)
        leaf = None
        try:
            leaf = RawDrain(r.host, r.port, "/v1/frames?queue=8")
            r._ingest(db)  # pre-anchor: refused
            assert r.health()["drops"] == 1
            assert not r.health()["cache"]["anchored"]
            r._ingest(kb)
            r._ingest(db)
            r._on_text(json.dumps({"type": "end"}).encode())
            leaf.drain(timeout=30)
            if leaf.error is not None:
                raise leaf.error
            # The refused delta never reached the wire; the relayed
            # pair is verbatim.
            assert [
                (turn, kind) for turn, kind, _ in leaf.frames
            ] == [(3, "keyframe"), (4, "delta")]
            assert leaf.frames[0][2] == kb
            assert leaf.frames[1][2] == db
            assert np.array_equal(leaf.buf, new)
            health = r.health()
            assert health["frames_in"] == 3
            assert health["cache"] == {
                "anchored": True, "keyframe_turn": 3, "deltas": 1,
            }
        finally:
            if leaf is not None:
                leaf.close()
            r.close()

    def test_late_joiner_served_from_cache_zero_upstream(self, pod):
        """A viewer joining AFTER the session ended is served the
        whole stream from the relay cache: first event a keyframe,
        zero new upstream frames, the pod's fetch counter untouched —
        and a small-cache relay serves the same board off its
        COMPACTED synthesized keyframe."""
        plane, gateway, client = pod
        size, turns = 32, 300
        submit_spec(client, "alice", spectate_spec(size, turns))
        pause_run(client, gateway, "alice")
        upstream = (
            f"{gateway.url}/v1/sessions/alice/frames?queue={turns + 8}"
        )
        r_full = make_relay(upstream, turns)
        r_small = make_relay(upstream, turns, cache_deltas=8)
        late = late_small = None
        try:
            for r in (r_full, r_small):
                wait_until(
                    lambda r=r: r.health()["connected"],
                    msg=f"relay {r.url} connected",
                )
            client.resume("alice")
            wait_status(client, "alice", ("completed",))
            for r in (r_full, r_small):
                wait_until(
                    lambda r=r: r.health()["ended"],
                    msg="end propagated to the relay",
                )
            want = want_board(final_board(client, "alice", size))
            reg = obs_metrics.REGISTRY
            fetches0 = reg.counter("frames.fetches").value
            frames_in0 = r_full.health()["frames_in"]
            serves0 = r_full.health()["cache_serves"]

            late = RawDrain(r_full.host, r_full.port, "/v1/frames")
            late.drain(timeout=60)
            if late.error is not None:
                raise late.error
            assert late.frames[0][1] == "keyframe"
            assert late.turn == turns
            assert np.array_equal(late.buf, want)
            # Zero upstream round trips: no new relay ingests, no new
            # pod fetches — every frame came off the cache.
            health = r_full.health()
            assert health["frames_in"] == frames_in0
            assert (
                health["cache_serves"] - serves0 == len(late.frames)
            )
            assert reg.counter("frames.fetches").value == fetches0

            # The compaction path: the small cache folded its tail
            # into a synthesized keyframe and still serves a correct
            # board in <= 1 + cache_deltas frames.
            assert r_small.health()["cache"]["deltas"] <= 8
            late_small = RawDrain(
                r_small.host, r_small.port, "/v1/frames"
            )
            late_small.drain(timeout=60)
            if late_small.error is not None:
                raise late_small.error
            assert late_small.frames[0][1] == "keyframe"
            assert len(late_small.frames) <= 9
            assert late_small.turn == turns
            assert np.array_equal(late_small.buf, want)
            assert reg.counter("frames.fetches").value == fetches0
        finally:
            for d in (late, late_small):
                if d is not None:
                    d.close()
            r_small.close()
            r_full.close()


# -- hot-path pins -------------------------------------------------------------


class TestHotPathPins:
    def test_relay_encodes_each_frame_once_for_any_client_count(
        self, pod, monkeypatch
    ):
        """The single-serialize/multi-write pin: with 3 viewers
        attached, ``encode_server_frame`` runs exactly once per
        upstream frame (spied), while ``frames_out`` shows each of
        those encodes written 3 times."""
        plane, gateway, client = pod
        size, turns = 16, 200
        submit_spec(client, "alice", spectate_spec(size, turns))
        pause_run(client, gateway, "alice")

        calls = {"binary": 0}
        count_lock = threading.Lock()
        real = ws_lib.encode_server_frame

        def spy(opcode, payload):
            if opcode == ws_lib.OP_BINARY:
                with count_lock:
                    calls["binary"] += 1
            return real(opcode, payload)

        monkeypatch.setattr(ws_lib, "encode_server_frame", spy)
        upstream = (
            f"{gateway.url}/v1/sessions/alice/frames?queue={turns + 8}"
        )
        r1 = make_relay(upstream, turns)
        leaves = []
        try:
            wait_until(
                lambda: r1.health()["connected"], msg="relay connected"
            )
            leaves = [
                RawDrain(
                    r1.host, r1.port, f"/v1/frames?queue={turns + 8}"
                )
                for _ in range(3)
            ]
            threads = [
                threading.Thread(target=d.drain) for d in leaves
            ]
            for t in threads:
                t.start()
            client.resume("alice")
            wait_status(client, "alice", ("completed",))
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "leaf drain wedged"
            for d in leaves:
                if d.error is not None:
                    raise d.error
            health = r1.health()
            assert health["frames_in"] > 0
            # ONE binary encode per upstream frame — not one per
            # (frame, client) pair.
            assert calls["binary"] == health["frames_in"]
            assert health["frames_out"] == 3 * health["frames_in"]
            for d in leaves:
                assert len(d.frames) == health["frames_in"]
        finally:
            for d in leaves:
                d.close()
            r1.close()

    def test_frame_plane_one_delta_encode_per_distinct_rect(
        self, monkeypatch
    ):
        """The dedup pin: N same-rect subscribers share
        ONE ``delta_bands`` call per publish (and the very bands
        object), so a publish costs one encode per DISTINCT rect."""
        calls = {"n": 0}
        real = frames_lib.delta_bands

        def spy(prev, new, *a, **kw):
            calls["n"] += 1
            return real(prev, new, *a, **kw)

        monkeypatch.setattr(frames_lib, "delta_bands", spy)
        h = w = 32
        rng = np.random.default_rng(9)
        board = (rng.random((h, w)) < 0.4).astype(np.uint8) * 255

        def fetch(rect):
            y0, x0, vh, vw = rect
            rows = (np.arange(vh) + y0) % h
            cols = (np.arange(vw) + x0) % w
            return board[rows[:, None], cols[None, :]]

        hub = FramePlane(board_shape=(h, w), metrics=False)
        same = [hub.subscribe((0, 0, 16, 16)) for _ in range(5)]
        others = [
            hub.subscribe((8, 8, 8, 8)), hub.subscribe((4, 4, 12, 12))
        ]
        hub.publish(1, fetch)
        assert calls["n"] == 0  # everyone keyframes first

        board[3, :] ^= 255
        hub.publish(2, fetch)
        assert calls["n"] == 3  # one encode per DISTINCT rect
        board[9, :] ^= 255
        hub.publish(3, fetch)
        assert calls["n"] == 6

        # The shared encode is the SAME bands object across same-rect
        # subscribers, and every stream still reconstructs exactly.
        deltas = []
        for sub in same:
            evs = []
            while not sub.events.empty():
                evs.append(sub.events.get_nowait())
            assert [type(e) for e in evs] == [
                FrameReady, FrameDelta, FrameDelta
            ]
            deltas.append(evs[1].bands)
            buf = np.array(evs[0].frame, np.uint8, copy=True)
            frames_lib.apply_bands(buf, evs[1].bands)
            frames_lib.apply_bands(buf, evs[2].bands)
            assert np.array_equal(buf, fetch((0, 0, 16, 16)))
        assert all(b is deltas[0] for b in deltas[1:])
        for sub in others:
            buf = sub.reconstruct()
            assert np.array_equal(buf, fetch(sub.rect))

    def test_ws_codec_byte_for_byte_vs_reference_framer(
        self, monkeypatch
    ):
        """The codec regression pin: the in-place mask/unmask +
        readinto rewrite emits EXACTLY the bytes of a naive RFC 6455
        framer, across every length-field regime, masked and
        unmasked — and ``encode_server_frame`` matches the server
        endpoint's ``_send`` verbatim."""
        import struct as struct_mod

        def reference_frame(opcode, payload, key=None):
            head = bytearray([0x80 | opcode])
            mask_bit = 0x80 if key is not None else 0
            n = len(payload)
            if n < 126:
                head.append(mask_bit | n)
            elif n < 1 << 16:
                head.append(mask_bit | 126)
                head += struct_mod.pack(">H", n)
            else:
                head.append(mask_bit | 127)
                head += struct_mod.pack(">Q", n)
            if key is None:
                return bytes(head) + bytes(payload)
            body = bytes(
                b ^ key[i % 4] for i, b in enumerate(payload)
            )
            return bytes(head) + bytes(key) + body

        rng = np.random.default_rng(17)
        sizes = [0, 1, 125, 126, 4096, 65535, 65536, 70001]
        payloads = [bytes(rng.integers(0, 256, n, np.uint8))
                    for n in sizes]

        # Server (unmasked) endpoint: _send == encode_server_frame ==
        # the reference, for every size regime.
        for payload in payloads:
            out = io.BytesIO()
            wsock = ws_lib.WebSocket(io.BytesIO(), out, mask=False)
            wsock.send_binary(payload)
            wire_bytes = out.getvalue()
            assert wire_bytes == reference_frame(
                ws_lib.OP_BINARY, payload
            )
            assert wire_bytes == ws_lib.encode_server_frame(
                ws_lib.OP_BINARY, payload
            )

        # Client (masked) endpoint, deterministic key: byte-for-byte
        # the reference masked frame — and the caller's buffer is NOT
        # scrambled by the in-place mask (it masks a copy).
        key = b"\xa1\x07\x5c\xf3"
        monkeypatch.setattr(ws_lib.os, "urandom",
                            lambda n: (key * 8)[:n])
        for payload in payloads:
            keep = bytearray(payload)
            out = io.BytesIO()
            wsock = ws_lib.WebSocket(io.BytesIO(), out, mask=True)
            wsock.send_binary(keep)
            assert out.getvalue() == reference_frame(
                ws_lib.OP_BINARY, payload, key=key
            )
            assert bytes(keep) == payload, "caller buffer scrambled"

        # The in-place bytearray contract: same object back, involutive.
        data = bytearray(payloads[4])
        ret = ws_lib._mask(data, key)
        assert ret is data
        assert bytes(data) != payloads[4]
        assert bytes(ws_lib._mask(data, key)) == payloads[4]
        # bytes stay immutable-in, fresh-out.
        frozen = payloads[4]
        masked = ws_lib._mask(frozen, key)
        assert isinstance(masked, bytes) and frozen == payloads[4]
        assert ws_lib._mask(masked, key) == frozen

        # Round-trip through the receive path (readinto + in-place
        # unmask): a masked reference frame decodes to the payload.
        for payload in payloads:
            raw = reference_frame(ws_lib.OP_BINARY, payload, key=key)
            wsock = ws_lib.WebSocket(
                io.BytesIO(raw), io.BytesIO(), mask=False
            )
            op, got = wsock.recv()
            assert op == ws_lib.OP_BINARY
            assert bytes(got) == payload


# -- the port's relay against the JAX package's --------------------------------


def jax_relay(upstream: str, turns: int, **kw):
    from distributed_gol_tpu.serve.relay import RelayServer as JRelay

    opts = dict(cache_deltas=turns + 16, queue_depth=turns + 8, **TIGHT)
    opts.update(kw)
    return JRelay(upstream, **opts)


def masked_hello(hello: dict) -> dict:
    """A relay's hello without its traceparent (each relay joins the
    trace with a span id of its own)."""
    return {k: v for k, v in hello.items() if k != "traceparent"}


class TestAgainstTheJaxRelay:
    @pytest.mark.parametrize("cache_deltas", [None, 8], ids=["full-cache", "compacted"])
    def test_port_relay_sends_the_jax_relays_bytes(self, pod, cache_deltas):
        """A port relay and a JAX relay subscribe to the same port
        gateway leg at the same pause point: the live leaves of both see
        the same frames byte for byte, and so do late joiners served from
        each relay's cache after the session ended (with a small cache,
        the compacted keyframe the relay synthesized)."""
        plane, gateway, client = pod
        size, turns = 32, 240
        submit_spec(client, "alice", spectate_spec(size, turns, seed=5))
        pause_run(client, gateway, "alice")
        upstream = f"{gateway.url}/v1/sessions/alice/frames?queue={turns + 8}"
        kw = {} if cache_deltas is None else {"cache_deltas": cache_deltas}
        ours = make_relay(upstream, turns, **kw)
        theirs = jax_relay(upstream, turns, **kw)
        leaves, lates = [], []
        try:
            for r in (ours, theirs):
                wait_until(lambda r=r: r.health()["connected"], msg=f"relay {r.url} connected")
            wait_until(lambda: gateway._n_spectators == 2, msg="both relays subscribed")
            leaves = [RawDrain(r.host, r.port, f"/v1/frames?queue={turns + 8}")
                      for r in (ours, theirs)]
            threads = [threading.Thread(target=d.drain) for d in leaves]
            for t in threads:
                t.start()
            client.resume("alice")
            wait_status(client, "alice", ("completed",))
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "leaf drain wedged"
            for d in leaves:
                if d.error is not None:
                    raise d.error
            assert leaves[0].frames == leaves[1].frames
            assert masked_hello(leaves[0].hello) == masked_hello(leaves[1].hello)
            want = want_board(final_board(client, "alice", size))
            assert leaves[0].turn == turns and np.array_equal(leaves[0].buf, want)

            for r in (ours, theirs):
                wait_until(lambda r=r: r.health()["ended"], msg="end propagated")
            assert ours.health()["cache"] == theirs.health()["cache"]
            lates = [RawDrain(r.host, r.port, "/v1/frames") for r in (ours, theirs)]
            for d in lates:
                d.drain(timeout=60)
                if d.error is not None:
                    raise d.error
            assert lates[0].frames == lates[1].frames
            assert lates[0].frames[0][1] == "keyframe" and lates[0].turn == turns
            assert np.array_equal(lates[0].buf, want)
            if cache_deltas is not None:
                assert len(lates[0].frames) <= cache_deltas + 1
        finally:
            for d in leaves + lates:
                d.close()
            theirs.close()
            ours.close()
