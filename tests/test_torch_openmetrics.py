"""The port's ``obs/openmetrics.py`` against the JAX package's: the same
exposition text and the same parsed dict for one snapshot, the same
name-mangling helpers, and a clean round trip of every snapshot — a
registry built by hand, and the MetricsReport of a real port run."""

import queue

import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.obs import metrics as tmetrics
from distributed_gol_torch.obs import openmetrics as tom
from distributed_gol_tpu.obs import openmetrics as jom

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


def built_snapshot() -> dict:
    """A registry with every instrument kind, tenant labels, a multi-label
    name, engine tiers with dashes and an info label that needs escaping."""
    reg = tmetrics.MetricsRegistry()
    reg.counter("controller.dispatches").inc(7)
    reg.counter("backend.dispatches.pallas-packed").inc(3)
    reg.counter(tmetrics.labelled("controller.turns", "alice")).inc(100)
    reg.counter(tmetrics.labelled("controller.turns", "bob")).inc(40)
    reg.counter("fleet.turns{node=a,tenant=b}").inc(2)
    reg.gauge("timecomp.cache_entries").set(3.5)
    reg.gauge(tmetrics.labelled("serve.queue_depth", "alice")).set(2)
    h = reg.histogram("controller.dispatch_seconds")
    for v in (0.0004, 0.003, 0.02, 0.5, 7.0):
        h.observe(v)
    reg.histogram(tmetrics.labelled("sli.time_to_first_frame_seconds", "bob")).observe(0.1)
    reg.info("backend.engine", "pallas-packed")
    reg.info("backend.sharded_tier_policy", 'forced-ppermute "in_kernel=False"\nline')
    return reg.snapshot().to_dict()


def run_snapshot(tmp_path) -> dict:
    events: queue.Queue = queue.Queue()
    tgol.run(tgol.Params(turns=40, superstep=8, image_height=64, image_width=64,
                         engine="packed", soup_density=0.3, soup_seed=7, device="cpu",
                         out_dir=tmp_path, ticker_period=3600), events)
    report = None
    while (e := events.get(timeout=60)) is not None:
        if isinstance(e, tgol.MetricsReport):
            report = e
    assert report is not None
    return report.snapshot


@pytest.fixture(params=["built", "run"])
def snapshot(request, tmp_path):
    return built_snapshot() if request.param == "built" else run_snapshot(tmp_path)


def test_render_and_parse_match_jax(snapshot):
    text = tom.render(snapshot)
    assert text == jom.render(snapshot)
    assert text.endswith("# EOF\n")
    assert tom.parse(text) == jom.parse(text)


def test_roundtrip_is_clean(snapshot):
    assert tom.check_roundtrip(snapshot) == []
    assert jom.check_roundtrip(snapshot) == []
    assert tmetrics.check_metrics_snapshot(tom.parse(tom.render(snapshot))) == []


@pytest.mark.parametrize(
    "name",
    ["controller.dispatch_seconds", "backend.dispatches.pallas-packed", "gol_already_mangled",
     "gol_bad.name", "controller.turns{tenant=alice}", "fleet.turns{node=a,tenant=b}",
     "odd{brace", "not{label}", "x{a=1,b}"],
)
def test_name_helpers_match_jax(name):
    assert tom.metric_name(name.split("{")[0]) == jom.metric_name(name.split("{")[0])
    assert tom.split_all(name) == jom.split_all(name)
    assert tom.split_name(name) == jom.split_name(name)
    base, labels = tom.split_all(name)
    assert tom.spell(base, labels) == jom.spell(base, labels)


def test_parse_rejects_what_jax_rejects():
    for bad in ("gol_x_total 1\n", "# TYPE gol_x counter\n!!! 1\n"):
        with pytest.raises(ValueError):
            jom.parse(bad)
        with pytest.raises(ValueError):
            tom.parse(bad)
    assert tom.CONTENT_TYPE == jom.CONTENT_TYPE


def test_roundtrip_reports_a_broken_snapshot():
    snap = built_snapshot()
    snap["histograms"]["controller.dispatch_seconds"]["counts"][0] += 1
    assert tom.check_roundtrip(snap) == jom.check_roundtrip(snap)
