"""The port's ``utils/measure.py`` against the JAX package's, on the rows
of ``tests/test_measure.py``: the same statistics, amplification sizing
and artifact lint, and the repeat loop computing the chained supersteps'
board (its CUDA-graph form runs on the card:
``tests/test_torch_kernels.py::test_gpu_device_repeat_replays_a_cuda_graph``)."""

import math

import numpy as np
import pytest
import torch

from distributed_gol_torch.models.life import CONWAY as TCONWAY
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.utils import measure as tm
from distributed_gol_tpu.utils import measure as jm

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


def both(name, *args, **kw):
    """``name`` called in both packages: (port result, JAX result), or the
    exception type each raised."""
    out = []
    for mod in (tm, jm):
        try:
            out.append(getattr(mod, name)(*args, **kw))
        except Exception as e:  # noqa: BLE001 — compared by type
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("xs", [[3.0, 1.0, 2.0], [4.0, 1.0, 2.0, 3.0], [5.0], []])
def test_median_matches(xs):
    ours, theirs = both("median", xs)
    assert ours == theirs


@pytest.mark.parametrize("xs", [[100.0, 90.0, 110.0], [7.0], [0.0, 0.0], [2.0, 1.0, 4.0, 8.0]])
def test_spread_matches(xs):
    ours, theirs = both("spread", xs)
    assert ours == theirs


@pytest.mark.parametrize(
    "rates",
    [[90.0, 110.0, 100.0], [42.0], [], [100.0, 0.0], [100.0, float("nan")], [-5.0],
     [3, 1, 2, 9]],
)
def test_summarize_matches(rates):
    ours, theirs = both("summarize", rates)
    if isinstance(theirs, str):
        assert ours == theirs == "MalformedRecord"
    else:
        assert ours == theirs


@pytest.mark.parametrize(
    "args,kw",
    [((0.001, 0.010), {}), ((0.001, 0.110), {}), ((2.0, 0.110), {}), ((10.0, 0.0), {}),
     ((1e-9, 0.1), dict(cap=4096)), ((0.0, 0.1), {}),
     ((0.001, 0.0), dict(target_seconds=0.25, cap=100))],
)
def test_pick_amplification_matches(args, kw):
    ours, theirs = both("pick_amplification", *args, **kw)
    assert ours == theirs


def _row(**kw):
    row = {"metric": "m", "value": 1.0, "reps": 3, "median": 10.0, "spread": 0.1,
           "rates": [9.0, 10.0, 11.0]}
    row.update(kw)
    return row


RECORDS = {
    "clean": _row(nested=_row(), rows=[_row(), {"no": 1}]),
    "bare": {"metric": "m", "value": 123.0},
    "reps0": _row(reps=0),
    "negative-median": _row(median=-1.0),
    "no-median": _row(median=None),
    "negative-spread": _row(spread=-0.1),
    "no-spread": _row(spread=None),
    "short-rates": _row(rates=[1.0]),
    "single-rep": _row(reps=1, spread=None, rates=[10.0]),
    "nested": {"metric": "top", **_row(), "inner": {"metric": "bad", "value": 1.0}},
    "effective-bare": _row(unit="effective gens/s"),
    "effective-full": _row(unit="effective gens/s", computed_gens_per_s=5.0,
                           effective_turns=10, computed_turns=4),
}


@pytest.mark.parametrize("name", RECORDS)
def test_headline_lint_matches(name):
    record = RECORDS[name]
    ours, theirs = both("check_headline_stats", record)
    assert ours == theirs
    raised = both("require_headline_stats", record)
    assert raised[0] == raised[1]
    assert (raised[0] == "MalformedRecord") == bool(ours)


def test_malformed_record_is_a_value_error():
    assert issubclass(tm.MalformedRecord, ValueError)


def test_chain_issues_n_calls():
    calls = []

    def run(x):
        calls.append(x)
        return x + 1

    assert tm.chain(run, 0, 5) == jm.chain(lambda x: x + 1, 0, 5) == 5
    assert calls == [0, 1, 2, 3, 4]


def test_sync_noise_is_the_median_of_its_probes():
    calls = []
    noise = tm.sync_noise(lambda: calls.append(1), probes=4)
    assert len(calls) == 4 and noise >= 0
    assert math.isfinite(noise)


@pytest.mark.parametrize("turns,reps", [(6, 4), (1, 3), (5, 1)])
def test_device_repeat_matches_chained_supersteps(turns, reps):
    """The repeat loop is the SAME simulation: ``reps`` supersteps of
    ``turns`` generations equal one superstep of their product, and the
    JAX package's ``lax.fori_loop`` form, bit for bit."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models.life import CONWAY as JCONWAY
    from distributed_gol_tpu.ops import packed as jpacked

    b = np.where(np.random.default_rng(42).random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
    tp = tpacked.pack(torch.from_numpy(b))
    trun = lambda x, t: tpacked.superstep(x, TCONWAY, t)  # noqa: E731
    got = tm.device_repeat(trun, turns, reps)(tp)
    assert torch.equal(got, trun(tp, turns * reps))
    jp = jpacked.pack(jnp.asarray(b))
    want = jm.device_repeat(lambda x, t: jpacked.superstep(x, JCONWAY, t), turns, reps)(jp)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_quiet_rates_shape_and_accounting():
    """End to end on a real (tiny, CPU) engine: the stats block is
    well-formed, rates are positive, and the protocol fields record how
    quiet the measurement was — the JAX package's lint accepts it."""
    b = np.where(np.random.default_rng(42).random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
    p = tpacked.pack(torch.from_numpy(b))
    _, stats = tm.quiet_rates(lambda x: tpacked.superstep(x, TCONWAY, 6), p, gens_per_call=6,
                              sync=lambda x: int(x[0, 0]), reps=3, target_seconds=0.02)
    assert stats["reps"] == 3 and len(stats["rates"]) == 3
    assert stats["median"] > 0 and stats["spread"] >= 0
    assert stats["amp"] >= 1 and stats["unit_s"] > 0
    assert tm.check_headline_stats({"metric": "m", **stats}) == []
    assert jm.check_headline_stats({"metric": "m", **stats}) == []
