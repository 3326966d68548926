"""Run one resilience scenario in both packages and compare the outcomes.

Shared by ``test_torch_timecomp.py``, ``test_torch_supervisor.py`` and
``test_torch_chaos.py``.  A scenario is a function of a :func:`package`
namespace (the JAX package's or the port's modules under one set of
names) that runs ``gol.run``/``supervise`` and returns an
:class:`Outcome`; :func:`pair` runs it for both packages and asserts that
the streams (normalised as ``test_torch_run.normalise`` does, with the
resilience counters added), the PGMs, the checkpoint sidecars (the
metrics snapshot and run id dropped), the
supervisor's history (without ``t``), the counters and the flight kinds
are equal.  The port runs on the CPU (its kernels' plain versions), the
JAX package on its 8 virtual CPU devices (Pallas in interpret mode).
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import json
import queue
import threading
from pathlib import Path
from types import SimpleNamespace

import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

#: Counter and info prefixes a MetricsReport is compared on: the run's
#: own instruments (the registry is process-wide).
OWN = ("backend.", "controller.", "faults.", "supervisor.", "sdc.", "timecomp.",
       "preempt.", "mesh.")
#: Sidecar fields that differ by run: the metrics snapshot (its timings)
#: and the run id.
SIDECAR_VOLATILE = {"metrics", "run_id"}


def _module(root, name):
    return importlib.import_module(f"{root.__name__}.{name}")


def package(root) -> SimpleNamespace:
    """``root``'s modules under the names the scenarios use."""
    m = lambda name: _module(root, name)  # noqa: E731
    return SimpleNamespace(
        root=root,
        torch=root is tgol,
        Params=root.Params,
        run=root.run,
        Backend=m("engine.backend").Backend,
        Controller=m("engine.controller").Controller,
        Session=m("engine.session").Session,
        supervisor=m("engine.supervisor"),
        timecomp=m("engine.timecomp"),
        faults=m("testing.faults"),
        metrics=m("obs.metrics"),
        flight=m("obs.flight"),
        mesh=m("parallel.mesh"),
        pgm=m("engine.pgm"),
    )


JAX, TORCH = package(jgol), package(tgol)


def params(pk: SimpleNamespace, **kw):
    """``pk.Params(**kw)``, on the CPU for the port."""
    if pk.torch:
        kw.setdefault("device", "cpu")
    return pk.Params(**kw)


def drain(events, timeout=120) -> list:
    out = []
    while (e := events.get(timeout=timeout)) is not None:
        out.append(e)
    return out


def _norm_value(name, v):
    if isinstance(v, enum.Enum):
        return v.value
    if name in ("alive", "cells"):
        return tuple(sorted(tuple(c) for c in v))
    return v


def normalise(events) -> list:
    """``test_torch_run.normalise`` with the resilience counters: events
    by their compared fields (no TurnTiming/AliveCellsCount), a
    MetricsReport by its own counters and info labels.  An empty info
    label is left out: the registry is process-wide, and a blacklist that
    an earlier test in the process condemned and cleared leaves
    ``mesh.device_blacklist`` empty in one package and unset in the
    other, both meaning no device is condemned."""
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
            fields += tuple(
                (part, {k: v for k, v in e.snapshot.get(part, {}).items()
                        if k.startswith(OWN) and v != ""})
                for part in ("counters", "info")
            )
        out.append((name, fields))
    return out


def sidecars(directory) -> dict:
    """Every checkpoint sidecar under ``directory`` without its
    ``SIDECAR_VOLATILE`` fields, and every checkpoint world's bytes."""
    out = {}
    if directory is None or not Path(directory).is_dir():
        return out
    for p in sorted(Path(directory).glob("checkpoint*")):
        if p.suffix == ".json":
            meta = json.loads(p.read_text())
            out[p.name] = {k: v for k, v in meta.items() if k not in SIDECAR_VOLATILE}
        else:
            out[p.name] = p.read_bytes()
    return out


def pgms(out) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(out).glob("*.pgm"))}


def history(sup) -> list:
    return [{k: v for k, v in row.items() if k != "t"} for row in sup.history]


@dataclasses.dataclass
class Outcome:
    events: list
    out: Path
    ckpt_dir: Path | None = None
    history: list | None = None
    counters: dict | None = None
    kinds: list | None = None
    error: str | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    def compared(self) -> dict:
        return dict(
            events=normalise(self.events),
            pgms=pgms(self.out),
            sidecars=sidecars(self.ckpt_dir),
            history=self.history,
            counters=self.counters,
            kinds=self.kinds,
            error=self.error,
            extra=self.extra,
        )


def counters_during(pk, fn, prefix=OWN):
    """``fn()``'s result and the process-wide registry's counter delta over
    it, restricted to ``prefix``."""
    before = pk.metrics.REGISTRY.snapshot()
    result = fn()
    delta = pk.metrics.REGISTRY.snapshot().delta(before).to_dict()["counters"]
    return result, {k: v for k, v in delta.items() if k.startswith(prefix)}


def pair(scenario, tmp_path, **kw) -> tuple[Outcome, Outcome]:
    """``scenario(pk, dir, **kw)`` for the JAX package, then the port, each
    in its own directory; asserts their outcomes are equal and returns
    them (JAX's first)."""
    results = []
    for pk, tag in ((JAX, "jax"), (TORCH, "torch")):
        # Both start with nothing condemned, whatever earlier tests in
        # the process left.
        pk.mesh.clear_blacklist()
        d = tmp_path / tag
        d.mkdir()
        results.append(scenario(pk, d, **kw))
    j, t = results
    jc, tc = j.compared(), t.compared()
    for key in jc:
        assert tc[key] == jc[key], f"{key} differs between the packages"
    return j, t


def within(seconds: float, fn):
    """``fn()`` in a daemon thread, failing the test when it has not
    returned after ``seconds`` (a hung run must fail, not eat the suite's
    budget); its exception, if any, is re-raised here."""
    box = {}

    def body():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=body, name="gol-bounded", daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"scenario still running after {seconds} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def run_events(pk, p, **kw) -> tuple[list, str | None]:
    """``pk.run(p, events, **kw)``: the drained stream and the name of the
    exception the run raised (None on success).  The sentinel arrives on
    every path, so the drain ending is itself part of the contract."""
    events: queue.Queue = queue.Queue()
    error = None
    try:
        pk.run(p, events, **kw)
    except Exception as e:  # noqa: BLE001 — compared by type
        error = type(e).__name__
    return drain(events), error


def supervise_events(pk, p, **kw):
    """``pk.supervisor.supervise(p, events, **kw)``: (stream, supervisor or
    None, exception name or None)."""
    events: queue.Queue = queue.Queue()
    sup, error = None, None
    try:
        sup = pk.supervisor.supervise(p, events, **kw)
    except Exception as e:  # noqa: BLE001 — compared by type
        error = type(e).__name__
    return drain(events), sup, error


def flight_kinds(directory) -> list | None:
    """The record kinds of the newest flight dump under ``directory``
    (None when there is none) — the same reader for both packages."""
    from distributed_gol_tpu.obs import flight

    path = flight.latest_flight_record(directory)
    if path is None:
        return None
    return [r["kind"] for r in flight.load_flight_record(path)["records"]]
