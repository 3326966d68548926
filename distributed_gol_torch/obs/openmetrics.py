"""OpenMetrics rendering of ``gol-metrics-v1`` snapshots.

A copy of ``distributed_gol_tpu/obs/openmetrics.py`` (standard library
only) over the port's registry (``obs/metrics.py``).

The registry's snapshot dict is the internal truth; this module is the
wire adapter an external scraper (Prometheus & friends) understands.
Mapping rules (documented in docs/API.md "Telemetry export"):

- **Names** — ``gol_`` prefix, every char outside ``[a-zA-Z0-9_]``
  becomes ``_`` (``controller.dispatch_seconds`` →
  ``gol_controller_dispatch_seconds``; the engine tier in
  ``backend.dispatches.pallas-packed`` mangles the same way).
- **Tenant labels** — the flat registry spells a tenant-labelled
  instrument ``name{tenant=x}`` (:func:`obs.metrics.labelled`); the
  renderer parses that suffix back into a REAL OpenMetrics label
  (``gol_controller_turns_total{tenant="x"}``), so one scrape separates
  tenants the way the serving plane promised.
- **Counters** — ``# TYPE ... counter`` with the ``_total`` sample name.
- **Gauges** — ``# TYPE ... gauge``.
- **Histograms** — ``# TYPE ... histogram``: cumulative ``_bucket``
  samples with ``le`` labels (upper bounds rendered via ``repr`` so they
  re-parse to the identical float), the ``le="+Inf"`` bucket, ``_sum``
  and ``_count``.
- **Info** — each registry info label becomes its own info family:
  ``# TYPE gol_backend_engine info`` +
  ``gol_backend_engine_info{value="pallas-packed"} 1``.

:func:`parse` is the inverse (modulo the lossy name mangling: dots came
back as underscores), producing a schema-valid ``gol-metrics-v1`` dict —
:func:`check_roundtrip` renders + re-parses + lints + value-compares a
snapshot in one call, which is what the property tests run on every
snapshot the suite produces.
"""

from __future__ import annotations

import re
from typing import Mapping

from distributed_gol_torch.obs.metrics import (
    SCHEMA,
    check_metrics_snapshot,
    tenant_of,
)

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
#: Sample-scoped labels :func:`parse` must NOT fold back into the
#: registry key (``le`` belongs to a bucket, ``value`` to an info line).
_RESERVED_LABELS = frozenset({"le", "value"})

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def metric_name(name: str) -> str:
    """The OpenMetrics family name for one registry instrument name
    (WITHOUT its ``{tenant=...}`` suffix — strip via :func:`split_name`
    first).  Idempotent: an already-mangled family name (as the fleet
    collector re-renders after :func:`parse`) passes through unchanged
    instead of growing a second ``gol_`` prefix."""
    if name.startswith("gol_") and not _NAME_BAD.search(name):
        return name
    return "gol_" + _NAME_BAD.sub("_", name)


def split_all(name: str) -> tuple[str, dict[str, str]]:
    """Registry name → (base name, labels dict).  The generalised form of
    :func:`split_name` for the fleet plane's multi-label spelling
    (``name{node=a,tenant=b}``): the trailing ``{k=v,...}`` suffix is
    parsed into a dict; a name whose brace suffix is not label-shaped
    (every comma-part carrying ``=``) comes back unlabelled."""
    if not name.endswith("}") or "{" not in name:
        return name, {}
    base, _, suffix = name.rpartition("{")
    labels: dict[str, str] = {}
    for part in suffix[:-1].split(","):
        k, eq, v = part.partition("=")
        if not eq or not k:
            return name, {}
        labels[k] = v
    return base, labels


def spell(base: str, labels: Mapping[str, str]) -> str:
    """Inverse of :func:`split_all`: the registry spelling of a labelled
    instrument, label keys sorted so one (base, labels) set always maps
    to one snapshot key (``{node=...}`` sorts before ``{tenant=...}``)."""
    if not labels:
        return base
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{base}{{{inner}}}"


def split_name(name: str) -> tuple[str, str | None]:
    """Registry name → (base name, tenant or None)."""
    t = tenant_of(name)
    if t is not None:
        return name[: name.rindex("{")], t
    base, labels = split_all(name)
    return (base, labels["tenant"]) if "tenant" in labels else (name, None)


def _esc(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: Mapping[str, str], extra: str | None = None) -> str:
    parts = []
    if extra:
        parts.append(extra)
    for k in sorted(labels):
        parts.append(f'{k}="{_esc(str(labels[k]))}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v) -> str:
    # repr round-trips floats exactly; ints render without a dot.
    return repr(int(v)) if isinstance(v, int) or float(v).is_integer() else repr(
        float(v)
    )


def render(snapshot: Mapping) -> str:
    """One ``gol-metrics-v1`` snapshot dict → OpenMetrics exposition
    text (ends with ``# EOF``).  Pure function of the dict: bounded-time
    by construction, never touches a device."""
    families: dict[str, dict] = {}

    def family(base: str, kind: str) -> list:
        fam = families.setdefault(
            metric_name(base), {"kind": kind, "lines": []}
        )
        return fam["lines"]

    for name, v in snapshot.get("counters", {}).items():
        base, labels = split_all(name)
        family(base, "counter").append((labels, None, v))
    for name, v in snapshot.get("gauges", {}).items():
        base, labels = split_all(name)
        family(base, "gauge").append((labels, None, v))
    for name, h in snapshot.get("histograms", {}).items():
        base, labels = split_all(name)
        family(base, "histogram").append((labels, None, h))
    for name, v in snapshot.get("info", {}).items():
        base, labels = split_all(name)
        family(base, "info").append((labels, None, v))

    out: list[str] = []
    for fname in sorted(families):
        fam = families[fname]
        kind = fam["kind"]
        out.append(f"# TYPE {fname} {kind}")
        for labels, _, v in fam["lines"]:
            if kind == "counter":
                out.append(f"{fname}_total{_labels(labels)} {_num(v)}")
            elif kind == "gauge":
                out.append(f"{fname}{_labels(labels)} {_num(v)}")
            elif kind == "info":
                value_label = 'value="' + _esc(str(v)) + '"'
                out.append(f"{fname}_info{_labels(labels, value_label)} 1")
            else:  # histogram
                cum = 0
                for bound, count in zip(v["buckets"], v["counts"]):
                    cum += count
                    le = 'le="' + repr(float(bound)) + '"'
                    out.append(f"{fname}_bucket{_labels(labels, le)} {cum}")
                inf_le = 'le="+Inf"'
                out.append(
                    f"{fname}_bucket{_labels(labels, inf_le)} {v['count']}"
                )
                out.append(f"{fname}_sum{_labels(labels)} {_num(v['sum'])}")
                out.append(f"{fname}_count{_labels(labels)} {v['count']}")
    out.append("# EOF")
    return "\n".join(out) + "\n"


def parse(text: str) -> dict:
    """OpenMetrics exposition text (as :func:`render` produces) back into
    a ``gol-metrics-v1`` dict.  Names stay in their mangled form (the
    dot→underscore mapping is lossy by design); tenant — and, on the
    fleet plane, ``node=`` — labels are folded back into the registry's
    ``name{k=v,...}`` spelling via :func:`spell`, so the result
    round-trips through :func:`obs.metrics.check_metrics_snapshot`."""
    kinds: dict[str, str] = {}
    # family -> tenant -> accumulated state
    hists: dict[str, dict] = {}
    out = {
        "schema": SCHEMA,
        "counters": {},
        "gauges": {},
        "histograms": {},
        "info": {},
    }
    for line in text.splitlines():
        line = line.strip()
        if not line or line == "# EOF":
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            fam, _, kind = rest.partition(" ")
            kinds[fam] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"unparseable OpenMetrics sample: {line!r}")
        sample, labelstr, value = m.group(1), m.group(2) or "", m.group(3)
        labels = {
            k: v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")
            for k, v in _LABEL.findall(labelstr)
        }
        key_labels = {
            k: v for k, v in labels.items() if k not in _RESERVED_LABELS
        }
        # Resolve the family by stripping the kind-specific suffix and
        # checking the TYPE line registered that family with the kind
        # the suffix implies; bare names resolve as gauges last, so a
        # histogram's `_sum` can never be read as a gauge named `.._sum`.
        resolved = None
        for suffix, want in (
            ("_bucket", "histogram"),
            ("_total", "counter"),
            ("_info", "info"),
            ("_sum", "histogram"),
            ("_count", "histogram"),
            ("", "gauge"),
        ):
            fam = sample[: -len(suffix)] if suffix else sample
            if (suffix == "" or sample.endswith(suffix)) and kinds.get(
                fam
            ) == want:
                resolved = (fam, want, suffix)
                break
        if resolved is None:
            raise ValueError(f"sample names no declared family: {line!r}")
        fam, kind, hit = resolved
        key = spell(fam, key_labels)
        if kind == "counter":
            out["counters"][key] = float(value)
        elif kind == "gauge":
            out["gauges"][key] = float(value)
        elif kind == "info":
            out["info"][key] = labels.get("value", "")
        else:
            h = hists.setdefault(key, {"buckets": [], "cum": [], "inf": 0})
            if hit == "_bucket":
                le = labels.get("le", "")
                if le == "+Inf":
                    h["inf"] = int(float(value))
                else:
                    h["buckets"].append(float(le))
                    h["cum"].append(int(float(value)))
            elif hit == "_sum":
                h["sum"] = float(value)
            else:
                h["cnt"] = int(float(value))
    for key, h in hists.items():
        pairs = sorted(zip(h["buckets"], h["cum"]))
        bounds = [b for b, _ in pairs]
        cum = [c for _, c in pairs]
        counts = [c - (cum[i - 1] if i else 0) for i, c in enumerate(cum)]
        counts.append(h["inf"] - (cum[-1] if cum else 0))
        out["histograms"][key] = {
            "buckets": bounds,
            "counts": counts,
            "sum": h.get("sum", 0.0),
            "count": h.get("cnt", h["inf"]),
        }
    # Counters that came back integral stay ints (histogram counts already
    # are): the schema allows floats, but value comparison in round-trip
    # tests is cleaner this way.
    out["counters"] = {
        k: int(v) if v.is_integer() else v for k, v in out["counters"].items()
    }
    return out


def check_roundtrip(snapshot: Mapping) -> list[str]:
    """Render ``snapshot``, re-parse the text, lint the result against
    the ``gol-metrics-v1`` schema, and compare every value through the
    name mangling.  Returns violations (empty = clean) — the property
    check the test suite runs on every snapshot it produces."""
    problems = []
    try:
        text = render(snapshot)
    except Exception as e:  # noqa: BLE001
        return [f"render failed: {type(e).__name__}: {e}"]
    try:
        parsed = parse(text)
    except Exception as e:  # noqa: BLE001
        return [f"parse failed: {type(e).__name__}: {e}"]
    problems.extend(check_metrics_snapshot(parsed, "$roundtrip"))

    def mangled(name: str) -> str:
        base, labels = split_all(name)
        return spell(metric_name(base), labels)

    for section in ("counters", "gauges"):
        for name, v in snapshot.get(section, {}).items():
            got = parsed[section].get(mangled(name))
            if got is None or abs(float(got) - float(v)) > 1e-9:
                problems.append(f"{section}.{name}: {v!r} came back as {got!r}")
    for name, h in snapshot.get("histograms", {}).items():
        got = parsed["histograms"].get(mangled(name))
        if got is None:
            problems.append(f"histograms.{name}: lost in round-trip")
            continue
        if list(got["buckets"]) != [float(b) for b in h["buckets"]]:
            problems.append(f"histograms.{name}: bucket bounds changed")
        if list(got["counts"]) != list(h["counts"]):
            problems.append(f"histograms.{name}: counts changed")
        if abs(got["sum"] - h["sum"]) > 1e-9 or got["count"] != h["count"]:
            problems.append(f"histograms.{name}: sum/count changed")
    for name, v in snapshot.get("info", {}).items():
        got = parsed["info"].get(mangled(name))
        if got != str(v):
            problems.append(f"info.{name}: {v!r} came back as {got!r}")
    return problems
