"""Crash flight recorder: the postmortem artifact.

A bounded in-memory ring of structured records — the last N dispatches
with timings, retries, watchdog transitions, checkpoint commits, tier
decisions — that costs one ``deque.append`` per record while the run is
healthy and is dumped as ``flight-<ts>.json`` next to the checkpoint dir
by every terminal path (``DispatchTimeout``, ``DispatchError``
exhaustion, any sentinel abort) just before the run dies.  A clean run
writes nothing: the absence of a flight record IS the "nothing went
wrong" signal (asserted by the chaos matrix).

Schema (``gol-flight-v1``; linted by :func:`check_flight_record` the same
way ``measure.check_headline_stats`` lints bench records)::

    {"schema": "gol-flight-v1",
     "cause": "<exception class>",      # what killed the run
     "error": "<str(exception)>",
     "turn": <last completed turn>,
     "written_at": <unix seconds>,
     "records": [{"kind": ..., "t": <unix seconds>, ...}, ...],  # oldest first
     "metrics": {...}}                  # gol-metrics-v1 snapshot, optional

The ring's tail must explain the abort: the dumping path appends one
``{"kind": "abort", "cause": ...}`` record before writing, so
``records[-1]`` names the cause even when the ring wrapped.
``tools/flight_report.py`` renders one of these for humans.
"""

from __future__ import annotations

import collections
import json
import time
from pathlib import Path
from typing import Mapping

from distributed_gol_torch.obs.metrics import check_metrics_snapshot

SCHEMA = "gol-flight-v1"


class MalformedFlightRecord(ValueError):
    """A flight record violated the ``gol-flight-v1`` schema."""


class FlightRecorder:
    """The bounded ring.  ``depth == 0`` disables recording entirely
    (``record`` and ``dump`` become no-ops) — the ``Params.
    flight_recorder_depth=0`` spelling."""

    def __init__(self, depth: int = 256):
        if depth < 0:
            raise ValueError("flight recorder depth must be >= 0")
        self.depth = depth
        self._ring: collections.deque = collections.deque(maxlen=depth or 1)

    @property
    def enabled(self) -> bool:
        return self.depth > 0

    def record(self, kind: str, **fields) -> None:
        """Append one structured record; a deque append under the GIL, no
        lock (records may interleave across threads — each is atomic)."""
        if not self.depth:
            return
        entry = {"kind": kind, "t": round(time.time(), 6)}
        entry.update(fields)
        self._ring.append(entry)

    def records(self) -> list[dict]:
        return list(self._ring)

    def dump(
        self,
        directory: str | Path,
        cause: str,
        error: str = "",
        turn: int = 0,
        metrics: dict | None = None,
        run_id: str | None = None,
        tenant: str | None = None,
        trace_id: str | None = None,
    ) -> Path | None:
        """Write the postmortem ``flight-<ts>.json`` into ``directory``
        (created if needed).  Appends the terminal ``abort`` record first
        so the tail always explains the abort.  ``run_id``/``tenant``
        stamp the correlation id shared with the run's
        MetricsReport and checkpoint sidecars; ``trace_id``
        joins the dump to the request's ``/traces`` timeline.
        Best-effort by contract:
        a failing dump (ENOSPC, perms) returns None — the postmortem
        artifact must never mask the abort it is documenting."""
        if not self.depth:
            return None
        self.record("abort", cause=cause, error=error[:500], turn=turn)
        doc = {
            "schema": SCHEMA,
            "cause": cause,
            "error": error[:2000],
            "turn": turn,
            "written_at": round(time.time(), 6),
            "records": self.records(),
        }
        if run_id:
            doc["run_id"] = run_id
        if tenant is not None:
            doc["tenant"] = tenant
        if trace_id:
            doc["trace_id"] = trace_id
        if metrics is not None:
            doc["metrics"] = metrics
        try:
            directory = Path(directory)
            directory.mkdir(parents=True, exist_ok=True)
            path = directory / f"flight-{time.time_ns()}.json"
            path.write_text(json.dumps(doc, default=str))
            return path
        except OSError:
            return None


def check_flight_record(obj, path: str = "$") -> list[str]:
    """Lint one flight-record dict; returns violations (empty = clean)."""
    problems: list[str] = []
    if not isinstance(obj, Mapping):
        return [f"{path}: flight record is not a dict ({type(obj).__name__})"]
    if obj.get("schema") != SCHEMA:
        problems.append(f"{path}.schema: want {SCHEMA!r}, got {obj.get('schema')!r}")
    cause = obj.get("cause")
    if not isinstance(cause, str) or not cause:
        problems.append(f"{path}.cause: missing or empty ({cause!r})")
    if not isinstance(obj.get("turn"), int):
        problems.append(f"{path}.turn: not an int ({obj.get('turn')!r})")
    records = obj.get("records")
    if not isinstance(records, list) or not records:
        problems.append(f"{path}.records: missing or empty")
    else:
        for i, r in enumerate(records):
            if not isinstance(r, Mapping) or not isinstance(r.get("kind"), str):
                problems.append(f"{path}.records[{i}]: no 'kind' string")
            elif not isinstance(r.get("t"), (int, float)):
                problems.append(f"{path}.records[{i}]: no numeric 't'")
        tail = records[-1]
        if isinstance(tail, Mapping) and tail.get("kind") != "abort":
            problems.append(
                f"{path}.records[-1]: tail must be the 'abort' record, "
                f"got kind={tail.get('kind')!r}"
            )
    if "metrics" in obj:
        problems.extend(check_metrics_snapshot(obj["metrics"], f"{path}.metrics"))
    return problems


def require_flight_record(obj) -> None:
    problems = check_flight_record(obj)
    if problems:
        raise MalformedFlightRecord("; ".join(problems))


def load_flight_record(path: str | Path) -> dict:
    """Read + schema-check one ``flight-*.json`` (the test/tooling entry)."""
    doc = json.loads(Path(path).read_text())
    require_flight_record(doc)
    return doc


def latest_flight_record(directory: str | Path) -> Path | None:
    """The newest ``flight-*.json`` under ``directory``, or None."""
    paths = sorted(Path(directory).glob("flight-*.json"))
    return paths[-1] if paths else None
