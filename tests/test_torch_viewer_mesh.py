"""The viewer paths on a device mesh against the JAX package's and the
port's one-device runs, on the CPU.

The port's shards all lie on the CPU (``Params(device="cpu",
mesh_shape=...)``); the JAX package runs the same mesh on the 8 virtual CPU
devices of ``tests/conftest.py``.  Every viewer mode (per-cell flips,
pooled frames, a viewport with delta frames and pan/zoom keys) must give
the JAX package's event stream (frames and delta bands compared as
arrays, through ``tests/test_torch_viewer.py``'s normaliser) and PGMs, and
the port's one-device stream, tolerance 0.  The boards are chosen so that
pool windows and viewport rects cross shard seams (``h_loc % fy != 0``)
and shard widths are not whole bytes (``w_loc % 8 != 0``).  The frame and
viewport dispatches on a mesh must never gather the whole board."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.engine import backend as tbackend
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.session import Session as TSession
from distributed_gol_torch.ops import stencil
from distributed_gol_torch.parallel import halo
from distributed_gol_torch.parallel import mesh as mesh_lib
from distributed_gol_torch.utils.soup import random_soup
from tests.test_torch_viewer import (  # noqa: F401 — ``jax`` is a fixture
    ROOT, SOUP, KeysAtPolls, assert_same_run, jax, normalise, pgms, run)

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

MESHES = [(2, 2), (4, 1), (1, 2), (2, 4)]
# 48 x 40: shards 24 x 20, 12 x 40, 48 x 20 and 24 x 10 cells — every
# shard width but (4, 1)'s is not a whole number of bytes.
SHAPE = (48, 40)


def assert_mesh_run(jax, tmp_path, mesh_shape, keys=None, **kw):
    """The port's run on ``mesh_shape`` against the JAX package's on the
    same mesh (``assert_same_run``) and against the port's one-device run
    (stream and PGMs).  Returns the port's mesh events."""
    events = assert_same_run(jax, tmp_path, keys=keys, mesh_shape=mesh_shape, **kw)
    one, out = run(tgol, tmp_path, "one", KeysAtPolls(keys) if keys else None, TSession(),
                   **kw)
    assert normalise(events) == normalise(one)
    assert pgms(tmp_path / "torch") == pgms(out)
    return events


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_flip_streams_on_a_mesh(jax, tmp_path, mesh_shape):
    events = assert_mesh_run(jax, tmp_path, mesh_shape, turns=6, image_height=SHAPE[0],
                             image_width=SHAPE[1], no_vis=False, **SOUP)
    assert sum(isinstance(e, tgol.CellFlipped) for e in events) > 100


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_frame_streams_on_a_mesh(jax, tmp_path, mesh_shape, stride):
    """Pool windows of 7 x 7 cells: no shard height or width is a multiple,
    so windows straddle every seam."""
    events = assert_mesh_run(jax, tmp_path, mesh_shape, turns=8, image_height=SHAPE[0],
                             image_width=SHAPE[1], no_vis=False, view_mode="frame",
                             frame_max=(7, 6), frame_stride=stride, **SOUP)
    frames = [e for e in events if isinstance(e, tgol.FrameReady)]
    assert frames[0].factors == (7, 7) and frames[0].frame.shape == (7, 6)
    assert [e.completed_turns for e in frames] == [0, *range(stride, 8, stride), 8]


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_viewport_streams_on_a_mesh(jax, tmp_path, mesh_shape):
    """A rect over the torus seam on both axes and across shard seams,
    panned and zoomed mid-run: keyframes, delta bands and rects equal."""
    keys = {3: "d", 5: "x", 7: "+", 9: "a", 11: "-"}
    events = assert_mesh_run(jax, tmp_path, mesh_shape, keys=keys, turns=14,
                             image_height=SHAPE[0], image_width=SHAPE[1], no_vis=False,
                             viewport=(40, 30, 20, 22), frame_max=(6, 6), frame_stride=1,
                             **SOUP)
    assert sum(isinstance(e, tgol.FrameDelta) for e in events) > 3
    assert len({e.rect for e in events if isinstance(e, (tgol.FrameReady, tgol.FrameDelta))}) > 3


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 2)])
def test_strided_frames_on_the_packed_engine(jax, tmp_path, mesh_shape):
    """A frame stride above 1 takes the packed engine on a mesh (``auto``
    off the card), in both packages; the pool windows still cross the
    seams."""
    events = assert_mesh_run(jax, tmp_path, mesh_shape, turns=12, image_height=128,
                             image_width=128, no_vis=False, view_mode="frame",
                             frame_max=(11, 13), frame_stride=4, **SOUP)
    (report,) = [e for e in events if isinstance(e, tgol.MetricsReport)]
    assert report.snapshot["info"]["backend.engine"] == "packed"


# -- the Backend's viewer dispatches on a sharded board -----------------------------


def backends(mesh_shape, h=SHAPE[0], w=SHAPE[1]):
    """(mesh Backend, one-device Backend, sharded board, whole board) on a
    seeded soup."""
    kw = dict(device="cpu", image_height=h, image_width=w, no_vis=False, engine="roll")
    mesh = Backend(tgol.Params(mesh_shape=mesh_shape, **kw))
    one = Backend(tgol.Params(**kw))
    b = random_soup(h, w, 0.3, 11)
    return mesh, one, mesh.put(b), one.put(b)


@pytest.fixture
def no_gather(monkeypatch):
    """``ShardedBoard.gather`` raises while the test runs."""

    def refuse(self, device=None):
        raise AssertionError("a viewer dispatch gathered the whole board")

    monkeypatch.setattr(halo.ShardedBoard, "gather", refuse)


@pytest.mark.parametrize("fy,fx,turns", [(1, 1, 1), (7, 7, 2), (5, 3, 1), (48, 40, 1),
                                         (13, 11, 3)])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_frame_dispatch_never_gathers(no_gather, mesh_shape, fy, fx, turns):
    mesh, one, sb, b = backends(mesh_shape)
    sn, sc, sf = mesh.run_turn_with_frame(sb, fy, fx, turns)
    n, c, f = one.run_turn_with_frame(b, fy, fx, turns)
    assert sc == c
    np.testing.assert_array_equal(sf, f)
    assert isinstance(sn, halo.ShardedBoard)
    assert mesh.probe_frame_fetch(sn, fy, fx) is None


@pytest.mark.parametrize("rect", [(40, 30, 20, 22), (-5, -7, 9, 33), (0, 0, 48, 40),
                                  (23, 19, 2, 2), (11, 9, 26, 31)])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_viewport_dispatch_never_gathers(no_gather, mesh_shape, rect):
    mesh, one, sb, b = backends(mesh_shape)
    np.testing.assert_array_equal(mesh.fetch_viewport(sb, rect), one.fetch_viewport(b, rect))
    sn, sc, sf = mesh.run_turn_with_viewport(sb, rect, 3, 2, 2)
    n, c, f = one.run_turn_with_viewport(b, rect, 3, 2, 2)
    assert sc == c
    np.testing.assert_array_equal(sf, f)
    assert mesh.probe_frame_fetch(sn, 3, 2, rect=rect) is None


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_flip_dispatch_matches_one_device(mesh_shape):
    """The flip mask of shards whose widths are not whole bytes is packed
    after each band of shards is put together."""
    mesh, one, sb, b = backends(mesh_shape)
    sn, sc, scoords = mesh.run_turn_with_flips(sb)
    n, c, coords = one.run_turn_with_flips(b)
    assert sc == c and len(coords) > 0
    np.testing.assert_array_equal(scoords, coords)
    np.testing.assert_array_equal(mesh.fetch(sn), one.fetch(n))


@pytest.mark.parametrize("f", [(1, 1), (2, 2), (3, 5), (7, 4), (16, 9), (33, 3), (64, 64)])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 4), (2, 4), (4, 2), (8, 1)])
def test_pool_and_window_of_a_sharded_board(mesh_shape, f):
    """``ShardedBoard.pool`` and ``window`` are ``frame_pool`` and
    ``viewport`` of the whole board, windows wider than a shard
    included."""
    board = torch.from_numpy(random_soup(64, 96, 0.2, 3))
    sharded = halo.board_sharding(mesh_lib.make_mesh(
        mesh_shape, [torch.device("cpu")] * (mesh_shape[0] * mesh_shape[1]))).shard(board)
    assert torch.equal(sharded.pool(*f), stencil.frame_pool(board, *f))
    fy, fx = f
    for rect in [(61, 90, fy, fx), (5, 7, 65 - fy, 97 - fx), (fy, fx, 17, 33)]:
        assert torch.equal(sharded.window(*rect), stencil.viewport(board, *rect))


# -- engine selection and the CLI ---------------------------------------------------


@pytest.mark.parametrize("kw,native,engine", [
    (dict(no_vis=False), True, "roll"),  # per-turn dispatches: roll
    (dict(no_vis=False, view_mode="frame", frame_stride=32), True, "pallas-packed"),  # K9
    (dict(no_vis=False, view_mode="frame", frame_stride=32), False, "packed"),
    (dict(no_vis=False, viewport=(0, 0, 64, 64), frame_stride=4), True, "pallas-packed"),
])
def test_auto_on_a_mesh(monkeypatch, kw, native, engine):
    monkeypatch.setattr(tbackend, "kernels_native", lambda device: native)
    p = tgol.Params(device="cpu", mesh_shape=(2, 2), image_height=256, image_width=256, **kw)
    assert Backend(p).engine_used == engine


def test_pallas_stays_refused_on_a_mesh():
    p = tgol.Params(device="cpu", mesh_shape=(2, 2), no_vis=False, engine="pallas")
    with pytest.raises(NotImplementedError, match="single-device"):
        Backend(p)


MESH_ARGS = ["-w", "64", "-h", "64", "-turns", "12", "--soup", "0.3", "--soup-seed", "7",
             "--mesh", "2x4"]


def cli(pkg, *args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.run([sys.executable, "-m", pkg, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=180)


def test_cli_mesh_with_the_default_viewer_matches_jax_cli(tmp_path):
    """``--mesh 2x4`` with the CLI's default viewer (the terminal renderer),
    in both packages: the same last line and final PGM."""
    j = cli("distributed_gol_tpu", *MESH_ARGS, "--out-dir", "j", cwd=tmp_path)
    assert j.returncode == 0, j.stderr
    t = cli("distributed_gol_torch", *MESH_ARGS, "--device", "cpu", "--out-dir", "t",
            cwd=tmp_path)
    assert t.returncode == 0, t.stderr
    assert "\x1b[" in t.stdout  # the ANSI renderer drew
    assert t.stdout.splitlines()[-1] == j.stdout.splitlines()[-1]
    assert (tmp_path / "t" / "64x64x12.pgm").read_bytes() == \
        (tmp_path / "j" / "64x64x12.pgm").read_bytes()
