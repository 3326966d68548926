"""The port's ``gol.run`` against the JAX package's, end to end on the CPU.

Both packages run the same seeded input with a pinned ``superstep`` (so
dispatch boundaries are deterministic) and must emit equal event streams
and byte-identical PGMs.  Excluded from the comparison: run and trace ids
(``compare=False`` on the events), ``TurnTiming`` and ``AliveCellsCount``
(wall-clock), and the timing values of ``MetricsReport`` (its counters and
info labels are compared).  ``engine="pallas-packed"`` runs the JAX
kernels in interpret mode and the port's kernel wrappers' plain versions.
"""

import dataclasses
import enum
import queue
import warnings

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol
from distributed_gol_torch.engine import pgm
from distributed_gol_torch.engine.session import Session as TSession
from distributed_gol_torch.utils.soup import random_soup
from distributed_gol_tpu.engine.session import Session as JSession

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

SOUP = dict(soup_density=0.3, soup_seed=7)


class ScriptedKeys(queue.Queue):
    """A key queue fed by the controller's own polling: ``schedule`` maps
    the n-th ``empty()`` poll to the keys that arrive at it, so a key lands
    at the same dispatch boundary in both packages."""

    def __init__(self, schedule: dict[int, str]):
        super().__init__()
        self._schedule = dict(schedule)
        self._polls = 0

    def empty(self) -> bool:
        self._polls += 1
        for k in self._schedule.pop(self._polls, ""):
            self.put(k)
        return super().empty()


def _norm_value(name, v):
    if isinstance(v, enum.Enum):
        return v.value
    if name in ("alive", "cells"):
        return tuple(sorted(tuple(c) for c in v))
    return v


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
        if name == "MetricsReport":
            # The run's own instruments only: the registry is process-wide,
            # and labels other runs in this process set (gateways, relays)
            # are not this run's.
            own = ("backend.", "controller.")
            fields += tuple(
                (part, {k: v for k, v in e.snapshot.get(part, {}).items() if k.startswith(own)})
                for part in ("counters", "info")
            )
        out.append((name, fields))
    return out


def run(pkg, tmp_path, tag, keys=None, session=None, **kw):
    """One ``gol.run`` of ``pkg``; returns (normalised events, out_dir)."""
    out = tmp_path / tag
    kw = dict(dict(ticker_period=3600, out_dir=out), **kw)
    if pkg is tgol:
        kw["device"] = "cpu"
    events: queue.Queue = queue.Queue()
    pkg.run(pkg.Params(**kw), events, keys, session)
    got = []
    while (e := events.get(timeout=60)) is not None:
        got.append(e)
    return normalise(got), out


def pgms(out):
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.pgm"))}


def assert_same_run(tmp_path, keys=None, **kw):
    j_events, j_out = run(jgol, tmp_path, "jax", ScriptedKeys(keys) if keys else None,
                          JSession(), **kw)
    t_events, t_out = run(tgol, tmp_path, "torch", ScriptedKeys(keys) if keys else None,
                          TSession(), **kw)
    assert t_events == j_events
    assert pgms(t_out) == pgms(j_out)
    return t_events


@pytest.mark.parametrize("turn_events", ["per-turn", "batch"])
@pytest.mark.parametrize("engine", ["packed", "pallas-packed"])
@pytest.mark.parametrize(
    "shape,turns,superstep",
    [((512, 512), 100, 25), ((64, 4096), 60, 20)],
)
def test_streams_and_pgms_match(tmp_path, engine, turn_events, shape, turns, superstep):
    events = assert_same_run(
        tmp_path, turns=turns, superstep=superstep, image_height=shape[0],
        image_width=shape[1], engine=engine, turn_events=turn_events, **SOUP,
    )
    report = [f for n, f in events if n == "MetricsReport"][0]
    assert dict(report)["info"]["backend.engine"] == engine


def test_roll_on_unpackable_width(tmp_path):
    assert_same_run(tmp_path, turns=40, superstep=8, image_height=20, image_width=36,
                    engine="auto", **SOUP)


def test_cycle_fast_forward(tmp_path):
    """64² soup at 10^9 turns, batch events: exactly one CycleDetected and
    the remaining turns fast-forwarded, identically in both packages."""
    events = assert_same_run(tmp_path, turns=10**9, superstep=64, image_height=64,
                             image_width=64, engine="packed", turn_events="batch", **SOUP)
    assert [n for n, _ in events].count("CycleDetected") == 1
    assert ("FinalTurnComplete" in [n for n, _ in events])


def test_cycle_fast_forward_through_kernel_tier(tmp_path):
    """The cycle probes drive the kernels with turns = 6 and turns = 1,
    against the JAX package's interpret-mode kernel tier.  The 64² soup
    tiled 8 x 8 is a 512² board both packages run resident, and it evolves
    as the 64² torus does, so it settles into the same ash."""
    images = tmp_path / "images"
    images.mkdir()
    tile = random_soup(64, 64, SOUP["soup_density"], SOUP["soup_seed"])
    pgm.write_pgm(images / "512x512.pgm", np.tile(tile, (8, 8)))
    events = assert_same_run(tmp_path, turns=10**9, superstep=64, image_height=512,
                             image_width=512, engine="pallas-packed", turn_events="batch",
                             images_dir=images)
    assert [n for n, _ in events].count("CycleDetected") == 1
    report = [f for n, f in events if n == "MetricsReport"][0]
    assert dict(report)["info"]["backend.engine"] == "pallas-packed"


@pytest.mark.parametrize(
    "keys",
    [{2: "s", 4: "pp", 6: "s"}, {3: "k"}, {3: "q"}, {1: "s", 5: "q"}],
    ids=["snap-pause", "kill", "detach", "snap-detach"],
)
def test_keys_match(tmp_path, keys):
    events = assert_same_run(tmp_path, keys=keys, turns=200, superstep=20,
                             image_height=512, image_width=512, engine="pallas-packed",
                             **SOUP)
    states = [dict(f)["new_state"] for n, f in events if n == "StateChange"]
    pressed = "".join(keys.values())
    assert [n for n, _ in events].count("ImageOutputComplete") == pressed.count("s") + pressed.count("k")
    assert states.count("Paused") == pressed.count("p") // 2
    assert states[-1] == "Quitting"


@pytest.mark.parametrize("parker,resumer", [(jgol, tgol), (tgol, jgol)], ids=["jax-to-torch", "torch-to-jax"])
def test_detach_resumes_across_packages(tmp_path, parker, resumer):
    """'q' parks a durable checkpoint in one package; the other resumes it
    to the JAX package's straight-run board."""
    kw = dict(turns=300, superstep=20, image_height=64, image_width=64,
              engine="packed", **SOUP)
    session_of = {jgol: JSession, tgol: TSession}
    _, straight = run(jgol, tmp_path, "straight", None, JSession(), **kw)
    ckpt = tmp_path / "ckpt"
    run(parker, tmp_path, "park", ScriptedKeys({3: "q"}), session_of[parker](ckpt), **kw)
    assert (ckpt / "checkpoint.json").is_file()
    _, resumed = run(resumer, tmp_path, "resume", None, session_of[resumer](ckpt), **kw)
    assert pgms(resumed) == pgms(straight)


def test_parked_checkpoints_are_byte_identical(tmp_path):
    kw = dict(turns=300, superstep=20, image_height=64, image_width=64,
              engine="packed", **SOUP)
    run(jgol, tmp_path, "j", ScriptedKeys({3: "q"}), JSession(tmp_path / "cj"), **kw)
    run(tgol, tmp_path, "t", ScriptedKeys({3: "q"}), TSession(tmp_path / "ct"), **kw)
    for name in ("checkpoint.pgm", "checkpoint.json"):
        assert (tmp_path / "ct" / name).read_bytes() == (tmp_path / "cj" / name).read_bytes()


# -- the port's own contracts ----------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(time_compression=True, turns=10**6 + 5, turn_events="batch"),
        dict(restart_limit=1, checkpoint_every_turns=40),
        dict(telemetry_sample_seconds=1.0),
    ],
    ids=["time-compression", "restart-limit", "telemetry-sampler"],
)
def test_resilience_requests_run_and_match_jax(tmp_path, kw):
    """The requests the port once refused (time compression, the
    supervisor, the run's telemetry sampler) run through ``gol.run`` and
    give the JAX package's stream and PGM."""
    from distributed_gol_torch.engine import timecomp as ttc
    from distributed_gol_tpu.engine import timecomp as jtc

    ttc.CACHE.clear()
    jtc.CACHE.clear()
    base = dict(turns=200, superstep=20, image_height=64, image_width=64, engine="packed",
                **SOUP)
    events = assert_same_run(tmp_path, **dict(base, **kw))
    final = [dict(f) for n, f in events if n == "FinalTurnComplete"][0]
    assert final["completed_turns"] == dict(base, **kw)["turns"]


def test_cuda_request_without_gpu_raises(tmp_path, monkeypatch):
    from distributed_gol_torch.engine.backend import Backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Backend(tgol.Params(out_dir=tmp_path))


def test_auto_skip_stable_runs_plain_tiled_kernel_and_warns(tmp_path):
    """Auto ``skip_stable`` on a long tiled run engages the adaptive tier,
    silently; its telemetry reads None until dispatches have run."""
    from distributed_gol_torch.engine.backend import Backend

    p = tgol.Params(turns=10**6, image_height=72, image_width=4096,
                    engine="pallas-packed", device="cpu", out_dir=tmp_path)
    assert p.skip_stable_requested() and tgol.Params(device="cpu", skip_stable=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = Backend(p)
    assert b.engine_used == "pallas-packed"
    assert b._superstep == b._skip_superstep
    assert b.skip_fraction() is None and b.activity_bitmap() is None


def test_auto_takes_packed_on_cpu_without_warning(tmp_path):
    from distributed_gol_torch.engine.backend import Backend

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = Backend(tgol.Params(device="cpu", out_dir=tmp_path))
    assert b.engine_used == "packed"


def test_explicit_kernel_tier_on_unpackable_width_warns(tmp_path):
    from distributed_gol_torch.engine.backend import Backend

    with pytest.warns(RuntimeWarning, match="falling back to 'roll'"):
        b = Backend(tgol.Params(image_width=48, image_height=48, engine="pallas-packed",
                                device="cpu", out_dir=tmp_path))
    assert b.engine_used == "roll"


def test_sdc_probe_and_cycle_surface_match(tmp_path):
    """The Backend's probe surface against the JAX Backend's on one board."""
    import jax.numpy as jnp

    from distributed_gol_torch.engine.backend import Backend as TB
    from distributed_gol_tpu.engine.backend import Backend as JB

    kw = dict(image_height=96, image_width=64, engine="packed", out_dir=tmp_path)
    jb, tb = JB(jgol.Params(**kw)), TB(tgol.Params(device="cpu", **kw))
    b = np.where(np.random.default_rng(3).random((96, 64)) < 0.3, 255, 0).astype(np.uint8)
    jo, _ = jb.run_turns(jnp.asarray(b), 9)
    to, _ = tb.run_turns(torch.from_numpy(b), 9)
    for y0, stripe in [(0, True), (50, True), (90, False)]:
        assert tb.sdc_probe(torch.from_numpy(b), to, 9, y0, stripe=stripe) == jb.sdc_probe(
            jnp.asarray(b), jo, 9, y0, stripe=stripe
        )
    assert bool(tb.cycle_probe_async(to)) == bool(jb.cycle_probe_async(jo))
    np.testing.assert_array_equal(tb.cycle_counts(to), jb.cycle_counts(jo))
    assert tb.cycle_period == jb.cycle_period
