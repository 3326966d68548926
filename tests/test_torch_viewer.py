"""The port's viewer path against the JAX package's, end to end on the CPU.

Both packages run the same seeded input with viewers attached — exact
per-turn flips, device-pooled frames, a viewport with delta-encoded frames
and pan/zoom keys — and must emit equal event streams and byte-identical
PGMs.  ``FrameReady.frame`` and ``FrameDelta.bands`` are excluded from the
events' equality (``compare=False``), so the normaliser compares those
arrays explicitly.  Also excluded, as in ``tests/test_torch_run.py``: run
and trace ids, ``TurnTiming`` and ``AliveCellsCount`` (wall-clock), and the
timing values of ``MetricsReport``.  On the CPU ``auto`` runs the roll
stencil in both packages; ``engine="pallas"`` runs the JAX byte kernel in
interpret mode and the port's K6 wrapper's plain version.  The frame
stride is pinned wherever the packages are compared: the adaptive stride
reads the wall clock.

The JAX package is imported inside the tests (the ``jax`` fixture)."""

import dataclasses
import enum
import io
import os
import queue
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.engine import backend as tbackend
from distributed_gol_torch.engine import pgm
from distributed_gol_torch.engine import frames as tframes
from distributed_gol_torch.engine.backend import Backend as TBackend
from distributed_gol_torch.engine.controller import Controller as TController
from distributed_gol_torch.engine.session import Session as TSession
from distributed_gol_torch.ops import stencil as tstencil
from distributed_gol_torch.utils import visualise as tvisualise
from distributed_gol_torch.utils.soup import random_soup
from distributed_gol_torch.viewer import render as trender
from distributed_gol_torch.viewer.loop import run_terminal

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOUP = dict(soup_density=0.3, soup_seed=7)


@pytest.fixture(scope="module")
def jax():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    import distributed_gol_tpu as gol
    from distributed_gol_tpu.engine import frames
    from distributed_gol_tpu.engine.backend import Backend
    from distributed_gol_tpu.engine.controller import Controller
    from distributed_gol_tpu.engine.session import Session
    from distributed_gol_tpu.utils import visualise
    from distributed_gol_tpu.viewer import render

    return SimpleNamespace(gol=gol, jnp=jnp, frames=frames, Backend=Backend,
                           Controller=Controller, Session=Session,
                           visualise=visualise, render=render)


class KeysAtPolls(queue.Queue):
    """A key queue fed by the controller's own polling: ``schedule`` maps
    the n-th ``get`` to the keys that arrive just before it.  The viewer
    loop polls once per turn in both packages, so a key lands at the same
    turn in both."""

    def __init__(self, schedule: dict[int, str]):
        super().__init__()
        self._schedule = dict(schedule)
        self._gets = 0

    def get(self, block=True, timeout=None):
        self._gets += 1
        for k in self._schedule.pop(self._gets, ""):
            self.put(k)
        return super().get(block, timeout)


def _norm_value(name, v):
    if isinstance(v, enum.Enum):
        return v.value
    if name in ("alive", "cells"):
        return tuple(sorted(tuple(c) for c in v))
    return v


def _array(a) -> tuple:
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def normalise(events):
    out = []
    for e in events:
        name = type(e).__name__
        if name in ("TurnTiming", "AliveCellsCount"):
            continue
        fields = tuple(
            (f.name, _norm_value(f.name, getattr(e, f.name)))
            for f in dataclasses.fields(e)
            if f.compare
        )
        if name == "FrameReady":
            fields += (("frame", _array(e.frame)),)
        elif name == "FrameDelta":
            fields += (("bands", tuple((int(y0), _array(rows)) for y0, rows in e.bands)),)
        elif name == "MetricsReport":
            own = ("backend.", "controller.")
            fields += tuple(
                (part, {k: v for k, v in e.snapshot.get(part, {}).items() if k.startswith(own)})
                for part in ("counters", "info")
            )
        out.append((name, fields))
    return out


def run(pkg, tmp_path, tag, keys=None, session=None, **kw):
    """One ``gol.run`` of ``pkg``; returns (events, out_dir)."""
    out = tmp_path / tag
    kw = dict(dict(ticker_period=3600, out_dir=out), **kw)
    if pkg is tgol:
        kw["device"] = "cpu"
    events: queue.Queue = queue.Queue()
    pkg.run(pkg.Params(**kw), events, keys, session)
    got = []
    while (e := events.get(timeout=60)) is not None:
        got.append(e)
    return got, out


def pgms(out):
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.pgm"))}


def assert_same_run(jax, tmp_path, keys=None, **kw):
    """Both packages' runs; the streams and PGMs must be equal.  Returns
    the port's events."""
    j_events, j_out = run(jax.gol, tmp_path, "jax", KeysAtPolls(keys) if keys else None,
                          jax.Session(), **kw)
    t_events, t_out = run(tgol, tmp_path, "torch", KeysAtPolls(keys) if keys else None,
                          TSession(), **kw)
    assert normalise(t_events) == normalise(j_events)
    assert pgms(t_out) == pgms(j_out)
    return t_events


def engine_of(events) -> str:
    (report,) = [e for e in events if isinstance(e, tgol.MetricsReport)]
    return report.snapshot["info"]["backend.engine"]


def counts_by_turn(board: np.ndarray, turns: int) -> list[int]:
    """Alive counts after each generation, from the port's roll stencil."""
    table = tstencil.rule_table(tgol.Params(device="cpu").rule, "cpu")
    _, counts = tstencil.steps_with_counts(torch.from_numpy(board), table, turns)
    return counts.tolist()


def check_shadow_board(events, shape, counts):
    """The viewer contract (``gol/event.go:55-58``): a shadow board built
    only from the flips has the true alive count at every TurnComplete and
    equals the final alive set."""
    shadow = np.zeros(shape, dtype=np.uint8)
    turns_seen = 0
    for e in events:
        if isinstance(e, tgol.CellFlipped):
            shadow[e.cell.y, e.cell.x] ^= 255
        elif isinstance(e, tgol.CellsFlipped):
            for c in e.cells:
                shadow[c.y, c.x] ^= 255
        elif isinstance(e, tgol.TurnComplete):
            turns_seen += 1
            assert e.completed_turns == turns_seen
            assert int(np.count_nonzero(shadow)) == counts[turns_seen - 1]
        elif isinstance(e, tgol.FinalTurnComplete):
            assert {(c.x, c.y) for c in e.alive} == {
                (int(x), int(y)) for y, x in zip(*np.nonzero(shadow))
            }
    assert turns_seen == len(counts)


# -- whole runs against the JAX package ------------------------------------------


@pytest.mark.parametrize("flip_events", ["auto", "batch"])
def test_flip_streams_match(jax, tmp_path, flip_events):
    """``no_vis=False`` on a 64² soup: per-cell CellFlipped (auto) or one
    CellsFlipped per turn, identical in both packages; the port's shadow
    board holds the viewer contract."""
    turns = 30
    events = assert_same_run(jax, tmp_path, turns=turns, image_height=64, image_width=64,
                             no_vis=False, flip_events=flip_events, **SOUP)
    kind = tgol.CellFlipped if flip_events == "auto" else tgol.CellsFlipped
    assert any(isinstance(e, kind) for e in events)
    assert engine_of(events) == "roll"
    board = random_soup(64, 64, SOUP["soup_density"], SOUP["soup_seed"])
    check_shadow_board(events, (64, 64), counts_by_turn(board, turns))


def test_pallas_engine_flips_match(jax, tmp_path):
    """``engine="pallas"`` with flips: the JAX byte kernel (interpret mode)
    against the port's K6 wrapper (plain version), one dispatch a turn."""
    events = assert_same_run(jax, tmp_path, turns=20, image_height=64, image_width=256,
                             no_vis=False, engine="pallas", **SOUP)
    assert engine_of(events) == "pallas"


def test_pallas_engine_headless_match(jax, tmp_path):
    events = assert_same_run(jax, tmp_path, turns=50, superstep=10, image_height=64,
                             image_width=256, engine="pallas", **SOUP)
    assert engine_of(events) == "pallas"


@pytest.mark.parametrize(
    "shape,engine,stride",
    [((64, 64), "auto", 1), ((64, 64), "auto", 3), ((64, 256), "pallas", 2)],
)
def test_frame_streams_match(jax, tmp_path, shape, engine, stride):
    """Full-board pooled frames (``view_mode="frame"``) at a pinned stride:
    every frame array equal, TurnComplete dense."""
    turns = 20
    events = assert_same_run(jax, tmp_path, turns=turns, image_height=shape[0],
                             image_width=shape[1], no_vis=False, view_mode="frame",
                             frame_max=(16, 16), frame_stride=stride, engine=engine, **SOUP)
    frames = [e.completed_turns for e in events if isinstance(e, tgol.FrameReady)]
    assert frames == [0, *range(stride, turns, stride), turns]
    tc = [e.completed_turns for e in events if isinstance(e, tgol.TurnComplete)]
    assert tc == list(range(1, turns + 1))


def test_viewport_stream_matches(jax, tmp_path):
    """A viewport that wraps both axes of a 128x256 board, deltas on, panned
    and zoomed mid-run: keyframes, every delta band and the rects equal."""
    keys = {3: "d", 6: "x", 9: "+", 12: "a", 15: "w", 18: "-", 21: "-", 24: "="}
    events = assert_same_run(jax, tmp_path, keys=keys, turns=30, image_height=128,
                             image_width=256, no_vis=False, viewport=(100, 200, 48, 96),
                             frame_max=(16, 16), frame_stride=1, **SOUP)
    kinds = [type(e).__name__ for e in events]
    assert kinds.count("FrameDelta") > 10
    assert len({e.rect for e in events if isinstance(e, (tgol.FrameReady, tgol.FrameDelta))}) > 5
    # The stream rebuilds the pooled crop of the final board at the final rect.
    buf = None
    for e in events:
        if isinstance(e, tgol.FrameReady):
            buf, rect, factors = np.array(e.frame), e.rect, e.factors
        elif isinstance(e, tgol.FrameDelta):
            tframes.apply_bands(buf, e.bands)
    board = torch.from_numpy(pgm.read_pgm(tmp_path / "torch" / "256x128x30.pgm"))
    want = tstencil.frame_pool(tstencil.viewport(board, *rect), *factors).numpy()
    np.testing.assert_array_equal(buf, want)


@pytest.mark.parametrize(
    "keys",
    [{2: "s", 4: "pp", 6: "s"}, {3: "k"}, {3: "q"}, {1: "s", 5: "q"}],
    ids=["snap-pause", "kill", "detach", "snap-detach"],
)
def test_keys_in_flips_mode_match(jax, tmp_path, keys):
    events = assert_same_run(jax, tmp_path, keys=keys, turns=20, image_height=64,
                             image_width=64, no_vis=False, flip_events="batch", **SOUP)
    states = [e.new_state.value for e in events if isinstance(e, tgol.StateChange)]
    pressed = "".join(keys.values())
    assert sum(isinstance(e, tgol.ImageOutputComplete) for e in events) == (
        pressed.count("s") + pressed.count("k"))
    assert states.count("Paused") == pressed.count("p") // 2
    assert states[-1] == "Quitting"


@pytest.mark.parametrize("parker", ["jax", "torch"])
def test_viewer_detach_resumes_in_the_other_package(jax, tmp_path, parker):
    """'q' mid-run in a viewer run parks a durable checkpoint; the other
    package resumes it (with its viewer) to the straight run's board."""
    kw = dict(turns=40, image_height=64, image_width=64, no_vis=False,
              flip_events="batch", **SOUP)
    pkgs = {"jax": (jax.gol, jax.Session), "torch": (tgol, TSession)}
    resumer = "torch" if parker == "jax" else "jax"
    _, straight = run(jax.gol, tmp_path, "straight", None, jax.Session(), **kw)
    ckpt = tmp_path / "ckpt"
    pkg, session = pkgs[parker]
    events, _ = run(pkg, tmp_path, "park", KeysAtPolls({10: "q"}), session(ckpt), **kw)
    assert (ckpt / "checkpoint.json").is_file()
    pkg, session = pkgs[resumer]
    events, resumed = run(pkg, tmp_path, "resume", None, session(ckpt), **kw)
    assert pgms(resumed) == pgms(straight)
    first_turn = min(e.completed_turns for e in events if type(e).__name__ == "TurnComplete")
    assert first_turn > 1


# -- the latency-adaptive frame stride (the port's own properties) ---------------


def test_auto_stride_policy_matches_jax(jax):
    for rtt in (0.0, 0.001, 0.019, 0.02, 0.03, 0.05, 0.11, 0.5, 10.0):
        for dispatch_s in (0.0, 0.001, 0.02, 0.04, 0.112, 0.33, 1.0, 20.0):
            assert TController._auto_frame_stride(rtt, dispatch_s) == (
                jax.Controller._auto_frame_stride(rtt, dispatch_s)), (rtt, dispatch_s)
    assert (TController._STRIDE_RTT_ENGAGE, TController._STRIDE_MAX) == (
        jax.Controller._STRIDE_RTT_ENGAGE, jax.Controller._STRIDE_MAX)


class TestLatencyAdaptiveStride:
    """``frame_stride=0``: the controller measures the frame-fetch round
    trip at viewer start and raises the effective stride on slow links.
    The link is faked via ``_measure_frame_rtt``."""

    TURNS = 12
    KW = dict(image_width=64, image_height=64, no_vis=False, view_mode="frame",
              frame_max=(16, 16), device="cpu", ticker_period=3600, **SOUP)

    def _run(self, tmp_path, monkeypatch, fake_rtt, **kw):
        if fake_rtt is None:
            def probe(self, *a, **k):
                raise AssertionError("the RTT probe must not run with an explicit frame_stride")
        else:
            def probe(self, *a, **k):
                return fake_rtt
        monkeypatch.setattr(TController, "_measure_frame_rtt", probe)
        params = tgol.Params(turns=self.TURNS, out_dir=tmp_path / "viewer", **self.KW, **kw)
        events: queue.Queue = queue.Queue()
        ctl = TController(params, events, session=TSession())
        ctl.run()
        stream = []
        while (e := events.get(timeout=60)) is not None:
            stream.append(e)
        tc = [e.completed_turns for e in stream if isinstance(e, tgol.TurnComplete)]
        frames = [e.completed_turns for e in stream if isinstance(e, tgol.FrameReady)]
        return ctl, tc, frames

    def _headless_pgm(self, tmp_path):
        kw = {k: v for k, v in self.KW.items() if k not in ("no_vis", "view_mode", "frame_max")}
        events: queue.Queue = queue.Queue()
        tgol.run(tgol.Params(turns=self.TURNS, out_dir=tmp_path / "headless", **kw), events)
        while events.get(timeout=60) is not None:
            pass
        return (tmp_path / "headless" / "64x64x12.pgm").read_bytes()

    def test_slow_link_raises_stride_stream_stays_dense(self, tmp_path, monkeypatch):
        ctl, tc, frames = self._run(tmp_path, monkeypatch, fake_rtt=10.0)
        assert ctl.frame_stride_effective == TController._STRIDE_MAX
        assert tc == list(range(1, self.TURNS + 1))
        assert frames == [0, 1, 2, self.TURNS]  # two warm frames, then strided
        assert (tmp_path / "viewer" / "64x64x12.pgm").read_bytes() == self._headless_pgm(tmp_path)

    def test_local_link_keeps_frame_per_turn(self, tmp_path, monkeypatch):
        ctl, tc, frames = self._run(tmp_path, monkeypatch, fake_rtt=0.0)
        assert ctl.frame_stride_effective == 1
        assert frames == list(range(0, self.TURNS + 1))
        assert tc == list(range(1, self.TURNS + 1))

    def test_explicit_stride_wins(self, tmp_path, monkeypatch):
        ctl, tc, frames = self._run(tmp_path, monkeypatch, fake_rtt=None, frame_stride=4)
        assert ctl.frame_stride_effective == 4
        assert frames == [0, 4, 8, 12]
        assert tc == list(range(1, self.TURNS + 1))
        assert (tmp_path / "viewer" / "64x64x12.pgm").read_bytes() == self._headless_pgm(tmp_path)


# -- the Backend's viewer surface against the JAX Backend ------------------------


@pytest.fixture()
def backends(jax, tmp_path):
    kw = dict(image_height=96, image_width=128, engine="roll", out_dir=tmp_path)
    b = np.where(np.random.default_rng(8).random((96, 128)) < 0.3, 255, 0).astype(np.uint8)
    jb, tb = jax.Backend(jax.gol.Params(**kw)), TBackend(tgol.Params(device="cpu", **kw))
    return jb, tb, jax.jnp.asarray(b), torch.from_numpy(b)


@pytest.mark.parametrize(
    "rect", [(0, 0, 96, 128), (90, 120, 20, 30), (-5, -7, 33, 65), (200, 300, 1, 1)]
)
def test_normalize_rect_matches(jax, rect):
    assert TBackend.normalize_rect(rect, 96, 128) == jax.Backend.normalize_rect(rect, 96, 128)


@pytest.mark.parametrize("rect", [(0, 0, 97, 8), (0, 0, 8, 0)])
def test_normalize_rect_refuses_what_jax_refuses(jax, rect):
    with pytest.raises(ValueError):
        jax.Backend.normalize_rect(rect, 96, 128)
    with pytest.raises(ValueError):
        TBackend.normalize_rect(rect, 96, 128)


@pytest.mark.parametrize("rect", [(90, 120, 20, 30), (-5, -7, 33, 65), (10, 20, 96, 128)])
def test_viewport_methods_match(backends, rect):
    """Wrap-crossing rects: the fetch, the fused frame (2 generations, pooled
    by (3, 4)), and the probe, which advances nothing."""
    jb, tb, jboard, tboard = backends
    np.testing.assert_array_equal(tb.fetch_viewport(tboard, rect), jb.fetch_viewport(jboard, rect))
    jn, jc, jf = jb.run_turn_with_viewport(jboard, rect, 3, 4, 2)
    tn, tc, tf = tb.run_turn_with_viewport(tboard, rect, 3, 4, 2)
    assert tc == jc
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tb.probe_frame_fetch(tboard, 3, 4, rect=rect) is None
    assert tb.probe_frame_fetch(tboard, 5, 7) is None


def test_frame_and_flips_methods_match(backends):
    jb, tb, jboard, tboard = backends
    for fy, fx, turns in [(1, 1, 1), (5, 7, 3), (96, 128, 1)]:
        jn, jc, jf = jb.run_turn_with_frame(jboard, fy, fx, turns)
        tn, tc, tf = tb.run_turn_with_frame(tboard, fy, fx, turns)
        assert tc == jc
        np.testing.assert_array_equal(tf, jf)
    jn, jc, jcoords = jb.run_turn_with_flips(jboard)
    tn, tc, tcoords = tb.run_turn_with_flips(tboard)
    assert tc == jc and len(tcoords) > 0
    np.testing.assert_array_equal(tcoords, jcoords)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


# -- engine resolution on the viewer path ----------------------------------------


@pytest.mark.parametrize(
    "kw,native,engine",
    [
        (dict(no_vis=False), False, "roll"),  # CPU: auto per-turn stays roll
        (dict(no_vis=False), True, "pallas"),  # the card: auto per-turn takes K6
        (dict(no_vis=False, image_width=100), True, "pallas"),  # beyond the TPU gate
        (dict(no_vis=False, image_width=66), True, "roll"),  # W % 4 != 0
        (dict(image_width=100, superstep=10), True, "pallas"),  # headless, no packed word
        (dict(superstep=10), True, "pallas-packed"),
        (dict(superstep=10), False, "packed"),
        (dict(engine="pallas"), False, "pallas"),  # explicit: honoured on the CPU
    ],
)
def test_engine_resolution(monkeypatch, kw, native, engine):
    monkeypatch.setattr(tbackend, "kernels_native", lambda device: native)
    params = tgol.Params(**dict(dict(image_height=64, image_width=64, device="cpu"), **kw))
    assert TBackend._resolve_single(params, (64, params.image_width), None) == engine


def test_auto_viewer_run_on_cpu_is_silent(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = TBackend(tgol.Params(no_vis=False, device="cpu", out_dir=tmp_path))
    assert b.engine_used == "roll"


def test_pallas_outside_the_gate_falls_back_with_a_warning(jax, tmp_path):
    with pytest.warns(RuntimeWarning, match="falling back to 'roll'"):
        b = TBackend(tgol.Params(image_width=66, image_height=64, engine="pallas",
                                 device="cpu", out_dir=tmp_path))
    assert b.engine_used == "roll"


def test_pallas_gate_divergence_from_the_tpu(jax, tmp_path):
    """The port's gate is K6's own (W % 4 == 0): a 64² board runs the byte
    kernel here, where the TPU's gate (W % 128 == 0) falls back to roll
    with its downgrade warning.  Boards agree either way."""
    kw = dict(image_width=64, image_height=64, engine="pallas", out_dir=tmp_path)
    with pytest.warns(RuntimeWarning, match="falling back to 'roll'"):
        assert jax.Backend(jax.gol.Params(**kw)).engine_used == "roll"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TBackend(tgol.Params(device="cpu", **kw)).engine_used == "pallas"


def test_viewer_request_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TBackend(tgol.Params(no_vis=False, out_dir=tmp_path))


# -- the viewers' own modules against the JAX package's --------------------------


def test_frames_codec_matches(jax):
    rng = np.random.default_rng(4)
    prev = np.where(rng.random((37, 20)) < 0.3, 255, 0).astype(np.uint8)
    new = prev.copy()
    new[3, 4] ^= 255
    new[17:19, :] ^= 255
    new[36, 19] ^= 255
    tb, jb = tframes.delta_bands(prev, new), jax.frames.delta_bands(prev, new)
    assert [(y, _array(r)) for y, r in tb] == [(y, _array(r)) for y, r in jb]
    assert [y for y, _ in tb] == [0, 16, 32]
    assert tframes.bands_nbytes(tb) == jax.frames.bands_nbytes(jb)
    assert tframes.pack_bands(tb) == jax.frames.pack_bands(jb)
    meta, payload = tframes.pack_bands(tb)
    np.testing.assert_array_equal(
        tframes.apply_bands(prev.copy(), tframes.unpack_bands(meta, payload)), new)
    assert tframes.delta_bands(prev, prev) == ()
    with pytest.raises(ValueError):
        tframes.unpack_bands(meta, payload[:-1])


def test_renderers_match(jax):
    rng = np.random.default_rng(6)
    b = np.where(rng.random((45, 70)) < 0.2, 255, 0).astype(np.uint8)
    for size in [(4, 4), (10, 33), (100, 100)]:
        np.testing.assert_array_equal(trender.downsample(b, *size), jax.render.downsample(b, *size))
        assert trender.render(b, term_size=size) == jax.render.render(b, term_size=size)
    other = b.copy()
    other[:3, :5] ^= 255
    small = b[:12, :16]
    assert tvisualise.boards_to_string(small, other[:12, :16]) == (
        jax.visualise.boards_to_string(small, other[:12, :16]))
    assert tvisualise.board_to_string(small) == jax.visualise.board_to_string(small)
    cells = [tgol.Cell(1, 2), tgol.Cell(5, 0)]
    assert tvisualise.alive_cells_to_string(cells, cells[:1], 8, 4) == (
        jax.visualise.alive_cells_to_string(cells, cells[:1], 8, 4))


def test_terminal_viewer_renders_frames_and_deltas(tmp_path):
    """``run_terminal`` over a viewport run's stream: it applies keyframes
    and deltas, draws, and returns the final event."""
    params = tgol.Params(turns=6, image_width=64, image_height=64, no_vis=False,
                         viewport=(50, 50, 32, 32), frame_stride=1, device="cpu",
                         out_dir=tmp_path, ticker_period=3600, **SOUP)
    events: queue.Queue = queue.Queue()
    tgol.run(params, events, session=TSession())
    out = io.StringIO()
    final = run_terminal(params, events, max_fps=1e9, out=out)
    assert final is not None and final.completed_turns == 6
    assert trender.HALF in out.getvalue() and "turn 6" in out.getvalue()


# -- the pygame window (SDL's dummy video driver) ---------------------------------


@pytest.fixture()
def pygame(monkeypatch):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    return pytest.importorskip("pygame")


def test_window_flip_pixel_xor_and_bounds(pygame):
    from distributed_gol_torch.viewer.window import Window

    w = Window(16, 8)
    w.flip_pixel(3, 2)
    assert w.count_pixels() == 1
    w.flip_pixel(3, 2)
    assert w.count_pixels() == 0
    for x, y in [(16, 0), (0, 8), (-1, 0)]:
        with pytest.raises(IndexError):
            w.flip_pixel(x, y)
    w.render_frame()
    w.destroy()


def test_window_key_mapping(pygame):
    from distributed_gol_torch.viewer.window import Window

    w = Window(8, 8)
    for key in (pygame.K_s, pygame.K_p, pygame.K_q, pygame.K_k, pygame.K_z,
                pygame.K_a, pygame.K_d, pygame.K_w, pygame.K_x, pygame.K_LEFT,
                pygame.K_RIGHT, pygame.K_UP, pygame.K_DOWN, pygame.K_EQUALS, pygame.K_MINUS):
        pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=key))
    pygame.event.post(pygame.event.Event(pygame.QUIT))
    assert w.poll_keys() == ["s", "p", "q", "k", "a", "d", "w", "x", "a", "d", "w", "x",
                             "+", "-", "q"]
    w.destroy()


def test_run_window_shadow_equals_final_board(pygame, tmp_path):
    from distributed_gol_torch.viewer.window import Window, run_window

    params = tgol.Params(turns=20, image_width=64, image_height=64, no_vis=False,
                         flip_events="cell", device="cpu", out_dir=tmp_path,
                         ticker_period=3600, **SOUP)
    events: queue.Queue = queue.Queue()
    tgol.run(params, events, session=TSession())
    win = Window(64, 64)
    final = run_window(params, events, max_fps=1e9, window=win)
    assert final is not None and final.completed_turns == 20
    want = np.zeros((64, 64), np.uint8)
    for c in final.alive:
        want[c.y, c.x] = 255
    np.testing.assert_array_equal(win._pixels, want)


# -- the command line -----------------------------------------------------------

ARGS = ["-w", "64", "-h", "64", "-turns", "20", "--soup", "0.3", "--soup-seed", "7"]


def cli(pkg, *args, cwd, **env):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT), **env)
    return subprocess.run(
        [sys.executable, "-m", pkg, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=180,
    )


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's terminal-viewer run: (final stdout line, final PGM)."""
    cwd = tmp_path_factory.mktemp("jax_cli")
    r = cli("distributed_gol_tpu", *ARGS, "--out-dir", "j", cwd=cwd)
    assert r.returncode == 0, r.stderr
    return r.stdout.splitlines()[-1], (cwd / "j" / "64x64x20.pgm").read_bytes()


def test_cli_terminal_viewer_matches_jax_cli(tmp_path, jax_cli):
    r = cli("distributed_gol_torch", *ARGS, "--device", "cpu", "--out-dir", "t", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "\x1b[" in r.stdout  # the ANSI renderer drew
    assert (r.stdout.splitlines()[-1], (tmp_path / "t" / "64x64x20.pgm").read_bytes()) == jax_cli


def test_cli_window_viewer_matches_jax_cli(tmp_path, jax_cli):
    pytest.importorskip("pygame")
    r = cli("distributed_gol_torch", *ARGS, "--device", "cpu", "--window", "--out-dir", "t",
            cwd=tmp_path, SDL_VIDEODRIVER="dummy")
    assert r.returncode == 0, r.stderr
    assert (r.stdout.splitlines()[-1], (tmp_path / "t" / "64x64x20.pgm").read_bytes()) == jax_cli
