"""``distributed_gol_torch/utils/profiling.py``: a traced run leaves the
port's ``trace.json`` with the controller's ``gol.*`` ranges in it, and a
build without a profiler degrades with the JAX module's warning."""

import json
import queue

import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.utils import profiling

torch.set_num_threads(1)


def run_64(out_dir):
    events: queue.Queue = queue.Queue()
    tgol.run(tgol.Params(device="cpu", turns=20, image_width=64, image_height=64,
                         superstep=10, soup_density=0.3, soup_seed=7, out_dir=out_dir,
                         ticker_period=3600), events)
    while events.get(timeout=60) is not None:
        pass


def test_traced_run_leaves_output(tmp_path):
    log_dir = tmp_path / "trace"
    assert profiling.profiler() is torch.profiler
    assert not profiling.has_trace_output(log_dir)
    with profiling.trace(log_dir):
        run_64(tmp_path / "out")
    assert profiling.has_trace_output(log_dir)
    names = {e.get("name", "") for e in json.loads((log_dir / "trace.json").read_text())[
        "traceEvents"]}
    assert any(n.startswith("gol.issue") for n in names)
    assert (tmp_path / "out" / "64x64x20.pgm").is_file()


def test_no_profiler_warns_and_runs_untraced(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_PROFILER", None)
    log_dir = tmp_path / "trace"
    with pytest.warns(RuntimeWarning, match="profiler unavailable"):
        with profiling.trace(log_dir):
            run_64(tmp_path / "out")
    assert not profiling.has_trace_output(log_dir)
    assert (tmp_path / "out" / "64x64x20.pgm").is_file()
    profiling._reset_profiler_cache()
    assert profiling.profiler() is torch.profiler
