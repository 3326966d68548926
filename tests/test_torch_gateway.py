"""The port's network gateway (``serve/gateway.py``) on the CPU, over real
loopback sockets.

Ported rows of the JAX ``tests/test_gateway.py`` that need no broker,
relay or fleet, driven by ``tools/gol_client.py`` unchanged (it imports
the JAX package's codecs, so every exchange is also a check that the
port's wire is the JAX package's): submit, pause/resume/quit, the 429 and
409 answers, detach and reconnect, spectators (one fetch a frame, a
stalled spectator, a mid-stream viewport change), a wedged tenant, drain
over the wire and re-adoption, and ``serve --gateway-port``.  Then the
same sessions on a JAX gateway: the controller transcripts are equal
once run and trace ids and the timing fields are masked, and the
spectators rebuild the same frames.  Every server binds port 0 and is
closed in ``finally``; every test has its own time limit
(``tests/test_torch_telemetry.py::time_limit``).  Last, the socket
hygiene lint (``tools/check_socket_hygiene.py``) applied to the port."""

import contextlib
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.obs import metrics as obs_metrics
from distributed_gol_torch.serve import GatewayServer, ServeConfig, ServePlane, wire
from distributed_gol_torch.testing.faults import Fault, FaultInjectionBackend, FaultPlan
from distributed_gol_tpu.engine.events import FrameReady
from tests.test_torch_telemetry import time_limit  # noqa: F401 — autouse fixture
from tools.gol_client import GatewayError, GolClient

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

W = H = 16
SUPERSTEP = 4
TURNS = 24


def base_spec(**kw):
    """A small fast wire session spec (soup-seeded, cycle probe off so
    control tests race nothing)."""
    spec = {"params": {"width": W, "height": H, "turns": TURNS, "engine": "roll",
                       "superstep": SUPERSTEP, "cycle_check": 0, "ticker_period": 60.0},
            "soup": {"density": 0.25, "seed": 7}}
    spec["params"].update(kw.pop("params", {}))
    spec.update(kw)
    return spec


@contextlib.contextmanager
def gateway(tmp_path, jax: bool = False, **config):
    """(plane, gateway, client) of a pod with a gateway on port 0, the
    port's (CPU sessions) or the JAX package's; both closed on exit."""
    if jax:
        from distributed_gol_tpu.serve import GatewayServer as G, ServeConfig as C
        from distributed_gol_tpu.serve import ServePlane as P
        kw = {}
    else:
        G, C, P, kw = GatewayServer, ServeConfig, ServePlane, dict(device="cpu")
    config = dict(dict(max_sessions=4, telemetry_sample_seconds=0.1), **config)
    plane = P(C(**config), checkpoint_root=tmp_path / ("j" if jax else "t") / "ckpt")
    gw = G(plane, port=0, **kw)
    try:
        yield plane, gw, GolClient(gw.url, timeout=30)
    finally:
        gw.close()
        plane.close()


@pytest.fixture
def pod(tmp_path):
    with gateway(tmp_path) as got:
        yield got


def submit_spec(client, tenant, spec) -> dict:
    return client._request("POST", "/v1/sessions", {"tenant": tenant, **spec})


def wait_status(client, tenant, statuses, timeout=60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = client.state(tenant)
        if st["status"] in statuses:
            return st
        time.sleep(0.05)
    raise AssertionError(f"{tenant} never reached {statuses}: {client.state(tenant)}")


def oracle_final(tmp_path, tenant, spec):
    """The in-process ServePlane.submit oracle for one wire spec."""
    params, _ = wire.params_from_spec(tenant, json.loads(json.dumps(spec)),
                                      root=tmp_path / "oracle-up", device="cpu")
    with ServePlane(ServeConfig(max_sessions=1), checkpoint_root=tmp_path / "oracle") as plane:
        handle = plane.submit(tenant, params)
        assert handle.wait(timeout=60) and handle.status == "completed"
        return handle.final


def transcript(client, tenant) -> list:
    """The whole controller leg of an ended session (hello, the replayed
    ring, the end receipt)."""
    out = []
    with client.controller(tenant) as ctrl:
        while True:
            msg = ctrl.recv(timeout=30)
            out.append(msg)
            if msg["type"] == "end":
                return out


def crop(board, rect):
    y0, x0, vh, vw = rect
    h, w = board.shape
    return board[((np.arange(vh) + y0) % h)[:, None], ((np.arange(vw) + x0) % w)[None, :]]


def final_board(msgs, size) -> np.ndarray:
    (final,) = [m for m in msgs if m["type"] == "final"]
    board = np.zeros((size, size), np.uint8)
    for x, y in final["alive"]:
        board[y, x] = 255
    return board


# -- the broker contract over a real socket ------------------------------------------


def test_two_tenants_submit_control_quit_bit_identical(pod, tmp_path):
    """alice runs to completion, bit-identical to the in-process oracle;
    bob is paused, resumed, then quit, leaving a parked checkpoint."""
    plane, gw, client = pod
    alice = base_spec()
    assert submit_spec(client, "alice", alice)["status"] in ("queued", "running")
    submit_spec(client, "bob", base_spec(params={"turns": 500_000, "ticker_period": 0.2},
                                         soup={"density": 0.3, "seed": 11}))
    assert client.pause("bob")["ok"]
    wait_status(client, "bob", ("running",), timeout=30)
    time.sleep(0.5)
    st1 = client.state("bob")
    time.sleep(0.5)
    st2 = client.state("bob")
    assert st2["paused"] and st2["turn"] == st1["turn"]
    client.resume("bob")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and client.state("bob")["turn"] <= st2["turn"]:
        time.sleep(0.05)
    assert client.state("bob")["turn"] > st2["turn"]
    client.quit("bob")
    assert wait_status(client, "bob", ("parked",), timeout=30)["resumable"]
    wait_status(client, "alice", ("completed",), timeout=60)
    msgs = transcript(client, "alice")
    assert msgs[-1]["status"] == "completed"
    (final,) = [m for m in msgs if m["type"] == "final"]
    assert final["turn"] == TURNS
    oracle = oracle_final(tmp_path, "alice", alice)
    assert set(map(tuple, final["alive"])) == {(c.x, c.y) for c in oracle.alive}


def test_shed_submission_is_429_with_retry_after(tmp_path):
    with gateway(tmp_path, max_sessions=1, max_queued=0) as (plane, gw, client):
        submit_spec(client, "a", base_spec(params={"turns": 500_000}))
        with pytest.raises(GatewayError) as ei:
            submit_spec(client, "b", base_spec())
        assert ei.value.status == 429 and ei.value.retry_after is not None
        with pytest.raises(GatewayError) as ei:
            submit_spec(client, "c", base_spec(params={"width": 1 << 14, "height": 1 << 14}))
        assert ei.value.status == 409
        client.quit("a")


def test_errors_are_json_not_tracebacks(pod, tmp_path):
    plane, gw, client = pod
    for call, status in ((lambda: client.state("nobody"), 404),
                         (lambda: submit_spec(client, "bad name!", base_spec()), 400),
                         (lambda: submit_spec(client, "x", {"params": {"warp_factor": 9}}), 400)):
        with pytest.raises(GatewayError) as ei:
            call()
        assert ei.value.status == status
    plane.submit("direct", Params(image_width=W, image_height=H, turns=SUPERSTEP, engine="roll",
                                  superstep=SUPERSTEP, soup_density=0.2, turn_events="batch",
                                  cycle_check=0, out_dir=tmp_path / "direct", device="cpu"))
    wait_status(client, "direct", ("completed",), timeout=60)
    with pytest.raises(GatewayError) as ei:
        client.pause("direct")
    assert ei.value.status == 409


def test_ended_sessions_are_pruned_with_the_plane_eviction_ring(tmp_path):
    with gateway(tmp_path, max_sessions=1, max_retained_handles=2) as (plane, gw, client):
        for i in range(5):
            submit_spec(client, f"churn-{i}", base_spec(params={"turns": SUPERSTEP}))
            wait_status(client, f"churn-{i}", ("completed",), timeout=60)
        with gw._lock:
            assert len(gw._sessions) <= 1 + plane.config.max_retained_handles


def test_disconnect_is_detach_and_reconnect_reads_the_same_tail(pod):
    plane, gw, client = pod
    submit_spec(client, "alice", base_spec(params={"turns": 400}))
    seen = []
    with client.controller("alice") as ctrl:
        assert ctrl.recv(timeout=30)["type"] == "hello"
        while len(seen) < 2:
            msg = ctrl.recv(timeout=30)
            if msg["type"] == "turns":
                seen.append(msg)
    last_seq = seen[-1]["seq"]
    wait_status(client, "alice", ("completed",), timeout=60)
    assert client.state("alice")["turn"] == 400
    with client.controller("alice", since=last_seq) as ctrl:
        hello = ctrl.recv(timeout=30)
        assert hello["type"] == "hello" and hello["replay"] > 0
        while (msg := ctrl.recv(timeout=30))["type"] != "end":
            seen.append(msg)
    seqs = [m["seq"] for m in seen]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    expect = 1
    for msg in (m for m in seen if m["type"] == "turns"):
        assert msg["first"] == expect
        expect = msg["turn"] + 1
    assert expect == 401


# -- spectators -----------------------------------------------------------------------

SIZE = 64


def spectate_spec(turns=20, **kw):
    return base_spec(params={"width": SIZE, "height": SIZE, "turns": turns},
                     soup={"density": 0.3, "seed": 17}, spectate=True,
                     viewport=[0, 0, 32, 32], **kw)


def watch(stream) -> list:
    """Fold a spectator stream to its end: every frame event seen."""
    events = []
    while not stream.ended:
        event = stream.recv(timeout=30)
        if not isinstance(event, dict):
            events.append(event)
            stream.feed(event)
    return events


def paused_at_once(gw, tenant, timeout=30.0):
    """Pause ``tenant``'s session as soon as the gateway holds it: a run
    of a few turns can end before a spectator's handshake does on a
    loaded machine."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        session = gw._sessions.get(tenant)
        if session is not None:
            session.pause()
            if session.paused:
                return session
        time.sleep(0.001)
    raise AssertionError(f"could not pause {tenant}")


def test_n_spectators_cost_one_fetch_per_frame_and_reconstruct(pod):
    plane, gw, client = pod
    reg = obs_metrics.REGISTRY
    fetches0 = reg.counter("frames.fetches").value
    publishes0 = reg.counter("frames.publishes").value
    submit_spec(client, "alice", spectate_spec())
    session = paused_at_once(gw, "alice")
    rects = [(60, 50, 24, 24), (5, 61, 24, 24), (30, 30, 24, 24)]
    streams = [client.spectate("alice", rect=r, queue_depth=22) for r in rects]
    session.resume()
    try:
        firsts = [watch(s)[0].completed_turns for s in streams]
    finally:
        for s in streams:
            s.close()
    wait_status(client, "alice", ("completed",), timeout=30)
    assert reg.counter("frames.publishes").value - publishes0 == 20
    # One fetch for each turn published while anyone watched, however
    # many watched (the run may publish a few turns before the first
    # spectator attaches).
    assert reg.counter("frames.fetches").value - fetches0 == 20 - min(firsts) + 1
    board = final_board(transcript(client, "alice"), SIZE)
    for s, r in zip(streams, rects):
        assert s.turn == 20
        np.testing.assert_array_equal(s.buf, crop(board, r))


def test_stalled_spectator_never_wedges_the_producer(pod):
    plane, gw, client = pod
    turns = 150
    submit_spec(client, "alice", spectate_spec(turns=turns))
    stream = client.spectate("alice", rect=(0, 0, SIZE, SIZE), queue_depth=2,
                             recv_buffer=4096)
    try:
        assert wait_status(client, "alice", ("completed",), timeout=60)["turn"] == turns
        events = watch(stream)
        assert len(events) < turns
        assert sum(isinstance(e, FrameReady) for e in events) >= 2
        assert stream.turn == turns
        np.testing.assert_array_equal(stream.buf, final_board(transcript(client, "alice"), SIZE))
    finally:
        stream.close()


def test_set_viewport_rekeyframes_midstream(pod):
    plane, gw, client = pod
    submit_spec(client, "alice", spectate_spec(turns=200))
    with client.spectate("alice", rect=(0, 0, 16, 16)) as stream:
        first = stream.recv(timeout=30)
        while isinstance(first, dict):
            first = stream.recv(timeout=30)
        assert isinstance(first, FrameReady) and first.rect == (0, 0, 16, 16)
        stream.set_viewport((8, 8, 24, 24))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            event = stream.recv(timeout=30)
            if not isinstance(event, dict) and event.rect == (8, 8, 24, 24):
                assert isinstance(event, FrameReady)
                break
        else:
            raise AssertionError("new viewport never arrived")
    client.quit("alice")
    wait_status(client, "alice", ("parked",), timeout=30)


# -- faults and the drain ---------------------------------------------------------------


def test_bounded_time_with_a_hang_faulted_tenant_resident(pod, tmp_path):
    plane, gw, client = pod
    hang_params = Params(image_width=W, image_height=H, turns=500_000, engine="roll",
                         superstep=SUPERSTEP, soup_density=0.25, soup_seed=31,
                         turn_events="batch", cycle_check=0, dispatch_deadline_seconds=2.0,
                         out_dir=tmp_path / "hang", device="cpu")
    hang_backend = FaultInjectionBackend(Backend(hang_params),
                                         FaultPlan([Fault(1, "hang", seconds=60.0)]))
    try:
        plane.submit("hang", hang_params, backend=hang_backend)
        submit_spec(client, "healthy", base_spec())
        worst, done, deadline = 0.0, False, time.monotonic() + 60
        while time.monotonic() < deadline and not done:
            for fn in (client.sessions, lambda: client.state("hang"), client.health):
                t0 = time.monotonic()
                fn()
                worst = max(worst, time.monotonic() - t0)
            hang = plane.handle("hang")
            done = client.state("healthy")["status"] == "completed" and hang.done
            time.sleep(0.1)
        assert done and worst < 2.0
        st = client.state("hang")
        assert st["status"] == "parked" and "DispatchTimeout" in (st["error"] or "")
    finally:
        hang_backend.release_hangs()


def test_drain_over_the_wire_and_readopt(tmp_path):
    root = tmp_path / "t" / "ckpt"
    with gateway(tmp_path) as (plane, gw, client):
        for name, seed in (("alice", 1), ("bob", 2)):
            submit_spec(client, name, base_spec(params={"turns": 500_000},
                                                soup={"density": 0.3, "seed": seed}))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(
                client.state(t)["turn"] > 0 for t in ("alice", "bob")):
            time.sleep(0.05)
        receipt = client.drain(timeout=60)
        assert receipt["draining"]
        for name in ("alice", "bob"):
            row = receipt["sessions"][name]
            assert row["status"] == "drained" and row["resumable"] and row["turn"] > 0
        with pytest.raises(GatewayError) as ei:
            submit_spec(client, "late", base_spec())
        assert ei.value.status == 503
    with ServePlane(ServeConfig(max_sessions=4), checkpoint_root=root) as fresh:
        adoptable = fresh.resumable_tenants()
        assert set(adoptable) == {"alice", "bob"}
        target = adoptable["alice"]["turn"] + 2 * SUPERSTEP
        handle = fresh.submit("alice", Params(image_width=W, image_height=H, turns=target,
                                              engine="roll", superstep=SUPERSTEP,
                                              turn_events="batch", cycle_check=0,
                                              out_dir=root / "alice", device="cpu"))
        assert handle.wait(timeout=60) and handle.status == "completed"
        assert handle.last_turn == target


# -- the serve CLI with a gateway ---------------------------------------------------------


def test_gateway_pod_serves_until_drained_and_prints_endpoints(tmp_path):
    from distributed_gol_torch.__main__ import serve_main

    before = obs_metrics.REGISTRY.snapshot().to_dict()["info"].get("gateway.endpoint")
    out, err, rc = io.StringIO(), io.StringIO(), []

    def run():
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc.append(serve_main(["--device", "cpu", "--tenant", f"scripted:{W}x{H}x500000",
                                  "--checkpoint-root", str(tmp_path / "ckpt"),
                                  "--superstep", str(SUPERSTEP), "--engine", "roll",
                                  "--gateway-port", "0"]))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    url, deadline = None, time.monotonic() + 60
    while url is None and time.monotonic() < deadline:
        got = obs_metrics.REGISTRY.snapshot().to_dict()["info"].get("gateway.endpoint")
        url = got if got and got != before else None
        time.sleep(0.05)
    assert url is not None, "the pod never published its gateway endpoint"
    client = GolClient(url, timeout=30)
    try:
        st = wait_status(client, "scripted", ("running", "completed"), timeout=60)
        assert st["controllable"]
    finally:
        receipt = client.drain(timeout=60)
        thread.join(timeout=60)
    assert "scripted" in receipt["sessions"]
    assert not thread.is_alive() and rc == [0]
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    assert doc["gateway"]["endpoint"] == url
    assert f"gateway: {url}/v1/sessions" in err.getvalue()


def test_serve_with_no_tenant_needs_a_gateway(capsys):
    from distributed_gol_torch.__main__ import serve_main

    with pytest.raises(SystemExit) as ei:
        serve_main(["--device", "cpu"])
    assert ei.value.code == 2
    assert "--gateway-port" in capsys.readouterr().err


def test_gol_client_cli_drives_a_port_pod(tmp_path, capsys):
    """``tools/gol_client.py``'s own command line, unchanged, against the
    port's gateway: submit, state, list, health."""
    from tools import gol_client

    with gateway(tmp_path) as (plane, gw, client):
        assert gol_client.main([gw.url, "submit", "cli", "--size", "16", "--turns", "8",
                                "--soup", "0.3", "--engine", "roll", "--superstep", "4"]) == 0
        wait_status(client, "cli", ("completed",), timeout=60)
        for verb in (["state", "cli"], ["list"], ["health"]):
            assert gol_client.main([gw.url, *verb]) == 0
        out = capsys.readouterr().out
        assert "cli" in out and "completed" in out


# -- the same sessions on a JAX gateway -------------------------------------------------

#: Fields that carry ids or wall-clock readings.
MASKED = ("run_id", "trace_id", "traceparent")


def masked(msgs) -> list:
    return [{k: ("*" if k in MASKED else v) for k, v in m.items()} for m in msgs]


@pytest.mark.parametrize("spec", [
    base_spec(),
    base_spec(params={"turns": 40, "rule": "B36/S23", "superstep": 8}),
    base_spec(params={"turn_events": "per-turn", "turns": 12}),
], ids=["conway", "highlife", "per-turn"])
def test_controller_transcripts_match_jax(tmp_path, spec):
    got = {}
    for jax in (False, True):
        with gateway(tmp_path, jax=jax) as (plane, gw, client):
            receipt = submit_spec(client, "alice", json.loads(json.dumps(spec)))
            wait_status(client, "alice", ("completed",), timeout=60)
            state = client.state("alice")
            got[jax] = (sorted(receipt), masked(transcript(client, "alice")),
                        {k: v for k, v in state.items() if k != "controllers"})
    assert got[False] == got[True]


def test_spectators_rebuild_the_jax_frames(tmp_path):
    """Spectators of the same session on both gateways, with rects that
    wrap the torus: the same hello, and the same rebuilt last frame."""
    got = {}
    rects = [(60, 50, 24, 24), (5, 61, 9, 30)]
    for jax in (False, True):
        with gateway(tmp_path, jax=jax) as (plane, gw, client):
            submit_spec(client, "alice", spectate_spec(turns=30))
            streams = [client.spectate("alice", rect=r, queue_depth=40) for r in rects]
            try:
                hellos = [streams[i].recv(timeout=30) for i in range(len(rects))]
                for s in streams:
                    watch(s)
            finally:
                for s in streams:
                    s.close()
            got[jax] = ([sorted(h) for h in hellos], [h["rect"] for h in hellos],
                        [(s.turn, s.buf.tobytes()) for s in streams])
    assert got[False] == got[True]


# -- socket hygiene -------------------------------------------------------------------------


def test_port_sockets_all_carry_a_deadline(monkeypatch):
    """``tools/check_socket_hygiene.py``'s rule applied to the port's
    package (the tool scans only the JAX package and tools/): every
    construction site shows a deadline, and the port needs no
    allowlist."""
    from tools import check_socket_hygiene as lint

    monkeypatch.setattr(lint, "SCAN_ROOTS", ("distributed_gol_torch",))
    monkeypatch.setattr(lint, "ALLOWLIST", {})
    assert lint.check() == []
    found = lint.sites()
    assert found and all(has_deadline for *_, has_deadline in found)
    assert {rel for rel, *_ in found} == {
        "distributed_gol_torch/__main__.py", "distributed_gol_torch/serve/podclient.py",
        "distributed_gol_torch/serve/ws.py", "distributed_gol_torch/testing/netchaos.py"}
