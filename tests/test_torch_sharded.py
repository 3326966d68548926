"""The port's ``gol.run`` on a device mesh against the JAX package's.

The port's shards all lie on the CPU (``Params(device="cpu",
mesh_shape=...)``); the JAX package runs the same mesh on the 8 virtual
CPU devices of ``tests/conftest.py``, ``pallas-packed`` in interpret
mode.  Both must emit equal event streams (the MetricsReport's
``backend.*`` and ``controller.*`` counters and labels included: the
engine, the exchange tier and its policy) and byte-identical PGMs, through
``tests/test_torch_run.py``'s harness.
"""

import warnings

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.session import Session as TSession
from distributed_gol_tpu.engine.session import Session as JSession
from tests.test_torch_run import SOUP, ScriptedKeys, assert_same_run, pgms, run

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


def info(events) -> dict:
    report = [f for n, f in events if n == "MetricsReport"][0]
    return dict(report)["info"]


@pytest.mark.parametrize("engine", ["packed", "pallas-packed"])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("turn_events", ["per-turn", "batch"])
def test_mesh_streams_and_pgms_match(tmp_path, engine, mesh_shape, turn_events):
    events = assert_same_run(
        tmp_path, turns=100, superstep=20, image_height=64, image_width=64,
        engine=engine, mesh_shape=mesh_shape, turn_events=turn_events, **SOUP,
    )
    labels = info(events)
    assert labels["backend.engine"] == engine
    if engine == "pallas-packed":
        assert labels["backend.sharded_tier"] == "ppermute"
        assert "plain (non-adaptive) path" in labels["backend.sharded_tier_policy"]
    else:
        assert "backend.sharded_tier" not in labels


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 4)])
def test_larger_meshes_match(tmp_path, mesh_shape):
    """A 128 x 256 board with a superstep that is not a multiple of the
    launch depth (full launches and remainders in every dispatch)."""
    assert_same_run(tmp_path, turns=90, superstep=45, image_height=128, image_width=256,
                    engine="pallas-packed", mesh_shape=mesh_shape, turn_events="batch",
                    **SOUP)


def test_narrow_shards_fall_back_to_roll_with_a_warning(tmp_path):
    """64 wide on (1, 4): 16 cells a shard, no packed word; both packages
    warn and run roll."""
    with pytest.warns(RuntimeWarning) as caught:
        events = assert_same_run(tmp_path, turns=40, superstep=10, image_height=64,
                                 image_width=64, engine="packed", mesh_shape=(1, 4), **SOUP)
    falls = [str(w.message) for w in caught if "falling back to 'roll'" in str(w.message)]
    assert len(falls) == 2 and all("on mesh 1x4" in m for m in falls)
    assert falls[0] == falls[1]
    assert info(events)["backend.engine"] == "roll"


def test_auto_on_narrow_shards_runs_roll_silently(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        events = assert_same_run(tmp_path, turns=20, superstep=10, image_height=64,
                                 image_width=64, engine="auto", mesh_shape=(1, 4), **SOUP)
    assert info(events)["backend.engine"] == "roll"


def test_roll_on_a_mesh(tmp_path):
    assert_same_run(tmp_path, turns=30, superstep=10, image_height=48, image_width=40,
                    engine="roll", mesh_shape=(2, 2), **SOUP)


@pytest.mark.parametrize(
    "keys",
    [{2: "s", 4: "pp", 6: "s"}, {3: "k"}, {1: "s", 4: "q"}],
    ids=["snap-pause", "kill", "snap-detach"],
)
def test_keys_on_a_mesh_match(tmp_path, keys):
    events = assert_same_run(tmp_path, keys=keys, turns=200, superstep=20, image_height=64,
                             image_width=64, engine="pallas-packed", mesh_shape=(2, 2), **SOUP)
    assert [dict(f)["new_state"] for n, f in events if n == "StateChange"][-1] == "Quitting"


@pytest.mark.parametrize("parker,resumer", [(jgol, tgol), (tgol, jgol)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_detach_on_a_mesh_resumes_across_packages(tmp_path, parker, resumer):
    """'q' parks a checkpoint of a (2, 1) run in one package; the other
    resumes it on the same mesh to the straight single-device board."""
    kw = dict(turns=300, superstep=20, image_height=64, image_width=64,
              engine="pallas-packed", mesh_shape=(2, 1), **SOUP)
    session_of = {jgol: JSession, tgol: TSession}
    _, straight = run(tgol, tmp_path, "straight", None, TSession(), **dict(kw, mesh_shape=(1, 1)))
    ckpt = tmp_path / "ckpt"
    run(parker, tmp_path, "park", ScriptedKeys({3: "q"}), session_of[parker](ckpt), **kw)
    assert (ckpt / "checkpoint.json").is_file()
    _, resumed = run(resumer, tmp_path, "resume", None, session_of[resumer](ckpt), **kw)
    assert pgms(resumed) == pgms(straight)


def test_cycle_fast_forward_on_a_mesh(tmp_path):
    """The 64² soup at 10^9 turns on (2, 1): the cycle probes and phase
    counts run on the sharded board; one CycleDetected in both packages."""
    events = assert_same_run(tmp_path, turns=10**9, superstep=64, image_height=64,
                             image_width=64, engine="pallas-packed", skip_stable=False,
                             mesh_shape=(2, 1), turn_events="batch", **SOUP)
    assert [n for n, _ in events].count("CycleDetected") == 1


def test_sdc_probe_on_a_mesh_matches(tmp_path):
    assert_same_run(tmp_path, turns=120, superstep=20, image_height=64, image_width=64,
                    engine="packed", mesh_shape=(2, 2), sdc_check_every_turns=20, **SOUP)


def test_k9_gate_divergence_from_the_tpu(tmp_path):
    """32 x 512 on (8, 1): 4-row strips.  The port's gate takes them (T
    capped at 4) where the TPU's wants 8k rows and falls back to packed
    with its warning; the boards agree."""
    kw = dict(turns=30, superstep=10, image_height=32, image_width=512,
              engine="pallas-packed", mesh_shape=(8, 1), **SOUP)
    with pytest.warns(RuntimeWarning, match="falling back to 'packed'"):
        j_events, j_out = run(jgol, tmp_path, "jax", None, JSession(), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_events, t_out = run(tgol, tmp_path, "torch", None, TSession(), **kw)
    assert info(j_events)["backend.engine"] == "packed"
    assert info(t_events)["backend.engine"] == "pallas-packed"
    assert pgms(t_out) == pgms(j_out)


# -- the Backend's sharded surface ----------------------------------------------


def test_sharded_backend_surface(tmp_path):
    """put/fetch, counts, the cycle probes and the SDC probe on a (2, 2)
    sharded board equal the single-device Backend's."""
    from distributed_gol_torch.utils.soup import random_soup

    kw = dict(image_height=64, image_width=64, engine="pallas-packed", device="cpu",
              out_dir=tmp_path)
    mesh_be = Backend(tgol.Params(mesh_shape=(2, 2), **kw))
    solo_be = Backend(tgol.Params(**kw))
    assert mesh_be.devices == [torch.device("cpu")] * 4 and mesh_be.sharded_tier == "ppermute"
    board = random_soup(64, 64, 0.3, 7)
    mb, sb = mesh_be.put(board), solo_be.put(board)
    assert np.array_equal(mesh_be.fetch(mb), board)
    mb2, mc = mesh_be.run_turns(mb, 37)
    sb2, sc = solo_be.run_turns(sb, 37)
    assert mc == sc and np.array_equal(mesh_be.fetch(mb2), solo_be.fetch(sb2))
    assert mesh_be.count(mb2) == solo_be.count(sb2)
    assert bool(mesh_be.cycle_probe_async(mb2)) == bool(solo_be.cycle_probe_async(sb2))
    assert np.array_equal(mesh_be.cycle_counts(mb2), solo_be.cycle_counts(sb2))
    assert mesh_be.sdc_probe(mb, mb2, 37, 5) == solo_be.sdc_probe(sb, sb2, 37, 5)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("y0,turns", [(5, 9), (60, 3), (0, 40)])
def test_sdc_probe_on_a_mesh_copies_only_the_window(tmp_path, monkeypatch, mesh_shape, y0, turns):
    """The mesh's SDC probe never gathers a whole board: popcount and
    fingerprint are sums over the shards, and the stripe's window (the
    whole torus at 40 turns, a wrapping one at y0 = 60) is copied from
    the shards that hold it.  It answers as the single-device probe does,
    and a flipped cell inside the stripe fails both."""
    from distributed_gol_torch.parallel import halo
    from distributed_gol_torch.utils.soup import random_soup

    kw = dict(image_height=64, image_width=64, engine="packed", device="cpu", out_dir=tmp_path)
    mesh_be = Backend(tgol.Params(mesh_shape=mesh_shape, **kw))
    solo_be = Backend(tgol.Params(**kw))
    board = random_soup(64, 64, 0.3, 7)
    mb, sb = mesh_be.put(board), solo_be.put(board)
    mb2, sb2 = mesh_be.run_turns(mb, turns)[0], solo_be.run_turns(sb, turns)[0]
    bad = solo_be.fetch(sb2).copy()
    bad[(y0 + 1) % 64, 17] ^= 255
    mbad, sbad = mesh_be.put(bad), solo_be.put(bad)

    def refuse(self, device=None):
        raise AssertionError("the SDC probe gathered a whole sharded board")

    monkeypatch.setattr(halo.ShardedBoard, "gather", refuse)
    assert mesh_be.sdc_probe(mb, mb2, turns, y0) == solo_be.sdc_probe(sb, sb2, turns, y0)
    got = mesh_be.sdc_probe(mb, mbad, turns, y0)
    assert got == solo_be.sdc_probe(sb, sbad, turns, y0) and got[0] is False


def test_sharded_backend_on_cuda_needs_the_cards(tmp_path, monkeypatch):
    """Too few CUDA devices raises; the mesh never moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"mesh \(4, 1\) needs 4 devices, have 1"):
        Backend(tgol.Params(mesh_shape=(4, 1), out_dir=tmp_path))


def test_byte_engine_refuses_a_mesh(tmp_path):
    with pytest.raises(NotImplementedError, match="single-device"):
        Backend(tgol.Params(mesh_shape=(2, 1), engine="pallas", device="cpu", out_dir=tmp_path))


def test_mesh_that_does_not_divide_the_board_raises(tmp_path):
    with pytest.raises(ValueError, match="does not divide"):
        Backend(tgol.Params(mesh_shape=(3, 1), image_height=64, image_width=64,
                            device="cpu", out_dir=tmp_path))
