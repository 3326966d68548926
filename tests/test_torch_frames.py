"""The port's spectator fan-out hub (``serve/frames.py``) against the JAX
package's, on the CPU.

Both ``FramePlane``\\ s are fed the same boards through the same fetch and
must ship the same event streams to the same subscribers: keyframes and
delta bands compared as arrays, the publish stamps (``ts``, wall clock)
left out, tolerance 0.  Then the controller's half: a run with
``frame_plane=`` publishes one coalesced fetch a rendered turn, through
``gol.run``, through the supervisor, through the serving plane and on a
mesh, and every spectator's stream rebuilds the final board's crop.
Ported rows of the JAX ``tests/test_viewport.py``: the cyclic bound and
the fan-out economics."""

import queue

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.events import FinalTurnComplete, FrameReady
from distributed_gol_torch.obs import metrics as obs_metrics
from distributed_gol_torch.serve import FramePlane, ServeConfig, ServePlane
from distributed_gol_torch.serve.frames import _cyclic_bound
from distributed_gol_torch.utils.soup import random_soup
from distributed_gol_tpu.serve import frames as jframes
from tests.test_torch_run import SOUP

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


def crop(board, rect):
    y0, x0, vh, vw = rect
    h, w = board.shape
    return board[((np.arange(vh) + y0) % h)[:, None], ((np.arange(vw) + x0) % w)[None, :]]


def drain(sub) -> list:
    """A subscriber's pending events as comparable tuples (no ``ts``)."""
    out = []
    while True:
        try:
            e = sub.events.get_nowait()
        except queue.Empty:
            return out
        if type(e).__name__ == "FrameReady":
            out.append(("key", e.completed_turns, e.rect, np.asarray(e.frame).tobytes()))
        else:
            out.append(("delta", e.completed_turns, e.rect,
                        tuple((int(y), np.asarray(r).tobytes()) for y, r in e.bands)))


def oracle_boards(size: int, turns: int, seed: int) -> list:
    """The seeded soup and its next ``turns`` generations (the port's roll
    stencil on the CPU)."""
    be = Backend(tgol.Params(device="cpu", image_width=size, image_height=size, engine="roll"))
    dev = be.put(random_soup(size, size, 0.3, seed))
    boards = [be.fetch(dev)]
    for _ in range(turns):
        dev, _ = be.run_turns(dev, 1)
        boards.append(be.fetch(dev))
    return boards


# -- the cyclic bound -------------------------------------------------------------


@pytest.mark.parametrize("intervals,n,want", [
    ([(10, 20), (40, 10)], 100, (10, 40)),
    ([(90, 8), (2, 8)], 100, (90, 20)),
    ([(0, 10), (30, 10), (60, 10)], 90, (0, 70)),
    ([(0, 30), (30, 30), (60, 30)], 90, (0, 90)),
    ([(95, 10)], 100, (95, 10)),
])
def test_cyclic_bound_rows(intervals, n, want):
    assert _cyclic_bound(intervals, n) == want == jframes._cyclic_bound(intervals, n)


def test_cyclic_bound_matches_jax_on_random_rings():
    rng = np.random.default_rng(3)
    for _ in range(300):
        n = int(rng.integers(1, 200))
        ivs = [(int(rng.integers(-300, 300)), int(rng.integers(1, n + 5)))
               for _ in range(int(rng.integers(1, 6)))]
        assert _cyclic_bound(ivs, n) == jframes._cyclic_bound(ivs, n)


# -- both planes fed the same boards -------------------------------------------------


@pytest.mark.parametrize("maxsize", [64, 2, 3])
def test_plane_streams_match_jax(maxsize):
    """Same subscribers (wrapping, overlapping, one rect shared by two),
    same boards, a viewport change and a late subscriber mid-stream; a
    queue of 2 or 3 makes both planes drop oldest and re-keyframe."""
    size, turns = 96, 12
    boards = oracle_boards(size, turns, seed=5)
    rects = [(90, 80, 20, 30), (0, 0, 96, 96), (40, 40, 8, 8), (40, 40, 8, 8), (5, 91, 33, 7)]
    planes = (FramePlane(board_shape=(size, size)), jframes.FramePlane(board_shape=(size, size)))
    subs = [[p.subscribe(r, maxsize=maxsize) for r in rects] for p in planes]
    streams = [[[] for _ in rects] for _ in planes]
    stats = [[], []]
    for turn in range(1, turns + 1):
        board = boards[turn]
        if turn == 5:
            for p, ss in zip(planes, subs):
                p.set_viewport(ss[0], (10, 85, 40, 30))
        if turn == 7:
            for p, ss in zip(planes, subs):
                ss.append(p.subscribe((60, 20, 50, 90), maxsize=maxsize))
            for s in streams:
                s.append([])
        for i, p in enumerate(planes):
            got = p.publish(turn, lambda r: crop(board, r))
            stats[i].append(got)
            if maxsize > 8 or turn % 4 == 0:
                for k, sub in enumerate(subs[i]):
                    streams[i][k].extend(drain(sub))
    for i in range(2):
        for k, sub in enumerate(subs[i]):
            streams[i][k].extend(drain(sub))
    assert streams[0] == streams[1]
    assert stats[0] == stats[1]
    assert any(e[0] == "delta" for s in streams[0] for e in s)
    if maxsize < 8:
        assert len(streams[0][0]) < turns  # both planes dropped the same frames


def test_reconstruct_matches_jax_after_drops():
    size = 64
    boards = oracle_boards(size, 7, seed=22)
    planes = (FramePlane(board_shape=(size, size)), jframes.FramePlane(board_shape=(size, size)))
    subs = [p.subscribe((50, 40, 32, 32), maxsize=3) for p in planes]
    for turn in range(1, 8):
        for p in planes:
            p.publish(turn, lambda r: crop(boards[turn], r))
    got, want = (s.reconstruct() for s in subs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (crop(boards[7], (50, 40, 32, 32)) != 0) * np.uint8(255))


# -- the fan-out economics (ported rows of test_viewport.py) ----------------------------


@pytest.mark.parametrize("n_subs", [1, 8, 32])
def test_one_fetch_per_frame_any_subscriber_count(n_subs):
    size, turns = 128, 4
    rng = np.random.default_rng(13)
    be = Backend(tgol.Params(device="cpu", image_width=size, image_height=size, engine="roll"))
    dev = be.put(random_soup(size, size, 0.3, 13))
    plane = FramePlane(board_shape=(size, size))
    subs = [plane.subscribe((int(rng.integers(0, size)), int(rng.integers(0, size)), 48, 48),
                            maxsize=turns + 1) for _ in range(n_subs)]
    reg = obs_metrics.REGISTRY
    fetches0 = reg.counter("frames.fetches").value
    for turn in range(1, turns + 1):
        dev, _ = be.run_turns(dev, 1)
        assert plane.publish(turn, lambda r: be.fetch_viewport(dev, r))["subscribers"] == n_subs
    assert reg.counter("frames.fetches").value - fetches0 == turns
    full = be.fetch(dev)
    for s in subs:
        np.testing.assert_array_equal(s.reconstruct(), (crop(full, s.rect) != 0) * np.uint8(255))


def test_mid_stream_viewport_change_rekeyframes():
    size = 64
    be = Backend(tgol.Params(device="cpu", image_width=size, image_height=size, engine="roll",
                             metrics=False))
    dev = be.put(random_soup(size, size, 0.3, 21))
    plane = FramePlane(board_shape=(size, size))
    sub = plane.subscribe((0, 0, 32, 32), maxsize=16)
    plane.publish(1, lambda r: be.fetch_viewport(dev, r))
    plane.set_viewport(sub, (50, 50, 30, 30))
    plane.publish(2, lambda r: be.fetch_viewport(dev, r))
    evs = [sub.events.get_nowait() for _ in range(2)]
    assert [type(e) for e in evs] == [FrameReady, FrameReady]
    np.testing.assert_array_equal(np.asarray(evs[-1].frame),
                                  (crop(be.fetch(dev), (50, 50, 30, 30)) != 0) * np.uint8(255))


def test_unbound_publish_refuses():
    plane = FramePlane()
    plane.subscribe((0, 0, 8, 8))
    with pytest.raises(ValueError, match="unbound"):
        plane.publish(1, lambda r: np.zeros((8, 8), np.uint8))


def test_bad_rects_refused_as_jax_refuses():
    for plane in (FramePlane(), jframes.FramePlane()):
        for rect in [(0, 0, 0, 4), (0, 0, 4), (1, 2, 3, -1)]:
            with pytest.raises(ValueError):
                plane.subscribe(rect)


# -- the controller's half: one publish a rendered turn ------------------------------------


def final_board(events, size) -> np.ndarray:
    (final,) = [e for e in events if isinstance(e, (FinalTurnComplete,
                                                    jgol.FinalTurnComplete))]
    board = np.zeros((size, size), np.uint8)
    for c in final.alive:
        board[c.y, c.x] = 255
    return board


def collect(q) -> list:
    got = []
    while (e := q.get(timeout=60)) is not None:
        got.append(e)
    return got


RUN = dict(turns=6, image_width=64, image_height=64, no_vis=False, viewport=(0, 0, 32, 32),
           frame_stride=1, engine="roll", ticker_period=3600, **SOUP)
RECTS = [(50, 40, 24, 30), (0, 0, 16, 16), (16, 8, 32, 32)]


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 1)])
def test_run_publishes_the_jax_stream(tmp_path, mesh_shape):
    """``gol.run(frame_plane=)`` in both packages (the port also on a
    mesh): one fetch a rendered turn, and subscriber streams equal."""
    streams, finals = [], []
    for pkg, plane_cls, tag in ((tgol, FramePlane, "t"), (jgol, jframes.FramePlane, "j")):
        kw = dict(RUN, out_dir=tmp_path / tag)
        if pkg is tgol:
            kw.update(device="cpu", mesh_shape=mesh_shape)
        plane = plane_cls()
        subs = [plane.subscribe(r, maxsize=16) for r in RECTS]
        q = queue.Queue()
        fetches0 = obs_metrics.REGISTRY.counter("frames.fetches").value
        pkg.run(pkg.Params(**kw), q, frame_plane=plane)
        if pkg is tgol:
            assert obs_metrics.REGISTRY.counter("frames.fetches").value - fetches0 == 6
        finals.append(final_board(collect(q), 64))
        streams.append([drain(s) for s in subs])
    assert streams[0] == streams[1]
    np.testing.assert_array_equal(*finals)
    for stream, rect in zip(streams[0], RECTS):
        assert stream[-1][1] == 6 and [e[0] for e in stream].count("key") == 1


def test_supervised_run_keeps_publishing(tmp_path):
    """``supervise(frame_plane=)``: a supervised run (``restart_limit``)
    publishes to the plane its caller attached."""
    plane = FramePlane()
    sub = plane.subscribe(RECTS[0], maxsize=16)
    q = queue.Queue()
    tgol.run(tgol.Params(device="cpu", out_dir=tmp_path, restart_limit=1,
                         checkpoint_every_turns=2, **RUN), q, frame_plane=plane)
    board = final_board(collect(q), 64)
    np.testing.assert_array_equal(sub.reconstruct(), crop(board, RECTS[0]))


def test_serve_plane_session_publishes(tmp_path):
    """``ServePlane.submit(frame_plane=)``: the resident session publishes
    every rendered turn to the plane the gateway would hand it."""
    plane = FramePlane()
    subs = [plane.subscribe(r, maxsize=16) for r in RECTS]
    with ServePlane(ServeConfig(max_sessions=1), checkpoint_root=tmp_path) as pod:
        events = queue.Queue()
        handle = pod.submit("alice", tgol.Params(device="cpu", out_dir=tmp_path / "alice",
                                                 **RUN), events=events, frame_plane=plane)
        assert handle.wait(timeout=120) and handle.status == "completed"
        board = final_board(collect(events), 64)
    for s, r in zip(subs, RECTS):
        np.testing.assert_array_equal(s.reconstruct(), crop(board, r))
