"""Quiet-measurement protocol: repeat-loop amplification + rate statistics.

A copy of ``distributed_gol_tpu/utils/measure.py`` for the port: the same
median and spread conventions, the same amplification sizing and the same
artifact lint, so a rate from the card and one from the JAX package are
published in one shape.  Only :func:`device_repeat` changes: on a CUDA
board it is a CUDA graph of ``reps`` supersteps, replayed in one launch
(or, where the launcher cannot be captured, ``reps`` launches and one
``torch.cuda.synchronize``); on the CPU a plain loop.

A single-sample, single-dispatch timing measures the host and the
launch queue, not the device, and run rates move between runs by more
than many of the effects under test.  So every published rate rides
this protocol:

- **Amplify**: multiply the term under test — chained asynchronous
  dispatches (:func:`chain`) or a replayed graph of supersteps
  (:func:`device_repeat`) — until one timed rep dwarfs the measured sync
  noise (:func:`pick_amplification`).
- **Repeat**: time ``reps`` independent amplified reps, one
  data-dependent sync each (:func:`quiet_rates`).
- **Record**: publish ``{reps, median, spread, rates}``
  (:func:`summarize`), never a bare single sample;
  :func:`check_headline_stats` is the artifact lint that enforces this on
  every headline row of a record (``require_headline_stats`` is the
  raising form).

Median convention: ``sorted(rates)[len(rates) // 2]`` — the upper median,
the JAX package's convention, so the two packages' rows stay comparable.
``spread`` is ``(max - min) / median``: the full observed envelope,
deliberately pessimistic (a regression must beat the envelope, not a
standard error).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Sequence


class MalformedRecord(ValueError):
    """A bench record violated the headline-row stats contract."""


def median(xs: Sequence[float]) -> float:
    """Upper median (``sorted[n // 2]``) — the one convention every
    artifact row uses (see module docstring)."""
    if not xs:
        raise ValueError("median of an empty sequence")
    return sorted(xs)[len(xs) // 2]


def spread(xs: Sequence[float]) -> float:
    """Full relative envelope: ``(max - min) / median``."""
    m = median(xs)
    if not m:
        raise ValueError("spread undefined for zero median")
    return (max(xs) - min(xs)) / m


def summarize(rates: Sequence[float]) -> dict:
    """The ``{reps, median, spread, rates}`` block of one headline row.

    ``rates`` must be non-empty, finite and positive — a non-positive
    rate means the measurement harness failed, and publishing statistics
    over it would dress a broken run as data."""
    rates = [float(r) for r in rates]
    if not rates:
        raise MalformedRecord("no rates to summarize")
    for r in rates:
        if not math.isfinite(r) or r <= 0:
            raise MalformedRecord(f"non-positive or non-finite rate {r!r}")
    return {
        "reps": len(rates),
        "median": median(rates),
        "spread": spread(rates) if len(rates) > 1 else 0.0,
        "rates": sorted(rates),
    }


def sync_noise(sync: Callable[[], object], probes: int = 5) -> float:
    """Median wall-clock of ``sync()`` on an ALREADY-SETTLED value — the
    per-measurement noise floor the amplification must dwarf.  ``sync``
    must be a data-dependent fetch (one element copied to the host, or
    ``torch.cuda.synchronize``)."""
    times = []
    for _ in range(max(1, probes)):
        t0 = time.perf_counter()
        sync()
        times.append(time.perf_counter() - t0)
    return median(times)


def pick_amplification(
    unit_seconds: float,
    noise_seconds: float,
    target_seconds: float = 0.5,
    noise_mult: float = 20.0,
    cap: int = 4096,
) -> int:
    """How many chained units one timed rep needs so the rep wall-clock
    dwarfs both the dispatch-overhead target and ``noise_mult``× the
    measured sync noise.  ``unit_seconds`` is one warm unit (dispatch +
    sync) — amplification can only shrink the per-unit share of the
    noise, so sizing from the synced unit is conservative."""
    want = max(target_seconds, noise_mult * noise_seconds)
    if unit_seconds <= 0:
        return cap
    return max(1, min(cap, math.ceil(want / unit_seconds)))


def chain(run: Callable, board, n: int):
    """Issue ``n`` chained dispatches of ``run`` WITHOUT syncing — the
    host-side amplification form (an asynchronous launch costs far less
    than a sync, so chaining n dispatches under ONE data-dependent sync
    amortises the noise n×).  Returns the final (unforced) value."""
    for _ in range(n):
        board = run(board)
    return board


def device_repeat(run: Callable, turns: int, reps: int) -> Callable:
    """Device-side amplification: ``reps`` supersteps of ``turns``
    generations with no host work between them — the strongest quiet
    form, isolating per-launch terms from dispatch cost.  ``run`` must be
    a pure ``(board, turns) -> board`` superstep (the with_stats forms
    must be unwrapped first).

    On a CUDA board the first call captures the ``reps`` supersteps as
    one CUDA graph and every call replays it (the result is the graph's
    own output buffer, overwritten by the next call); where the launcher
    cannot be captured it issues the ``reps`` launches and synchronises
    once.  On the CPU it is a plain loop."""
    import torch

    graph = {}

    def loop(board):
        for _ in range(reps):
            board = run(board, turns)
        return board

    def repeated(board):
        if board.device.type != "cuda":
            return loop(board)
        key = (tuple(board.shape), board.dtype, board.device)
        if key not in graph:
            graph[key] = _capture(loop, board)
        captured = graph[key]
        if captured is None:
            out = loop(board)
            torch.cuda.synchronize(board.device)
            return out
        g, static_in, static_out = captured
        static_in.copy_(board)
        g.replay()
        return static_out

    return repeated


def _capture(loop: Callable, board):
    """``(graph, input buffer, output)`` of ``loop`` captured on a
    side stream after one warm-up run, or None where the launcher
    cannot be captured (a host sync, a launch on the legacy stream)."""
    import torch

    static_in = board.clone()
    stream = torch.cuda.Stream(board.device)
    stream.wait_stream(torch.cuda.current_stream(board.device))
    try:
        with torch.cuda.stream(stream):
            loop(static_in)  # warm-up: builds and loads what the launcher needs
        torch.cuda.current_stream(board.device).wait_stream(stream)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            static_out = loop(static_in)
    except Exception:  # noqa: BLE001 — not capturable: the launch loop
        torch.cuda.synchronize(board.device)
        return None
    return g, static_in, static_out


def quiet_rates(
    run: Callable,
    board,
    *,
    gens_per_call: int,
    sync: Callable[[object], object],
    reps: int = 5,
    target_seconds: float = 0.5,
    noise_mult: float = 20.0,
    amp_cap: int = 4096,
) -> tuple[object, dict]:
    """The whole protocol for one row: measure the sync noise, time one
    warm unit, pick the amplification, then time ``reps`` amplified reps
    (one data-dependent sync each).  Returns ``(board, stats)`` where
    ``stats`` is the :func:`summarize` block plus the protocol fields
    ``{amp, sync_noise_s, unit_s}`` so the artifact records HOW quiet the
    measurement was, not just its result."""
    noise = sync_noise(lambda: sync(board))
    t0 = time.perf_counter()
    board = run(board)
    sync(board)
    unit = time.perf_counter() - t0
    amp = pick_amplification(unit, noise, target_seconds, noise_mult, amp_cap)
    rates = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        board = chain(run, board, amp)
        sync(board)
        rates.append(amp * gens_per_call / (time.perf_counter() - t0))
    stats = summarize(rates)
    stats.update(amp=amp, sync_noise_s=round(noise, 6), unit_s=round(unit, 6))
    return board, stats


# -- artifact lint ------------------------------------------------------------

def _check_row(row: dict, path: str, problems: list[str]) -> None:
    reps = row.get("reps")
    if not isinstance(reps, int) or reps < 1:
        problems.append(f"{path}: reps missing or not a positive int ({reps!r})")
        return
    med = row.get("median")
    if not isinstance(med, (int, float)) or not math.isfinite(med) or med <= 0:
        problems.append(f"{path}: median missing or non-positive ({med!r})")
    spr = row.get("spread")
    if spr is None:
        if reps > 1:
            problems.append(f"{path}: spread None with reps > 1")
    elif not isinstance(spr, (int, float)) or not math.isfinite(spr) or spr < 0:
        problems.append(f"{path}: spread not a finite non-negative number ({spr!r})")
    rates = row.get("rates")
    if rates is not None:
        if not isinstance(rates, (list, tuple)) or len(rates) != reps:
            problems.append(
                f"{path}: rates length {len(rates) if isinstance(rates, (list, tuple)) else 'n/a'}"
                f" != reps {reps}"
            )
    if "effective" in str(row.get("unit", "")):
        # Time-compression honesty: a row claiming EFFECTIVE
        # throughput (generations delivered, not dispatched) must also
        # publish the computed side — the dispatched-generations rate and
        # both turn totals — or the headline is a dressed-up skip count.
        cgs = row.get("computed_gens_per_s")
        if (
            not isinstance(cgs, (int, float))
            or not math.isfinite(cgs)
            or cgs <= 0
        ):
            problems.append(
                f"{path}: effective-rate row lacks a positive "
                f"computed_gens_per_s ({cgs!r})"
            )
        for fld in ("effective_turns", "computed_turns"):
            v = row.get(fld)
            if not isinstance(v, int) or v < 0:
                problems.append(
                    f"{path}: effective-rate row lacks integer {fld} ({v!r})"
                )


def check_headline_stats(record, path: str = "$") -> list[str]:
    """Walk a bench record; every headline row — any dict carrying a
    ``metric`` key — must carry a well-formed ``{reps, median, spread}``
    block (``rates``, when present, must have ``reps`` entries).  Returns
    the list of violations (empty = clean): no bare single-sample rate
    passes."""
    problems: list[str] = []
    if isinstance(record, dict):
        if "metric" in record:
            _check_row(record, path, problems)
        for k, v in record.items():
            problems.extend(check_headline_stats(v, f"{path}.{k}"))
    elif isinstance(record, (list, tuple)):
        for i, v in enumerate(record):
            problems.extend(check_headline_stats(v, f"{path}[{i}]"))
    return problems


def require_headline_stats(record) -> None:
    """Raise :class:`MalformedRecord` when a headline row lacks its
    stats block — a harness runs this on its own output before printing
    (``chip_smoke.py`` does), so a protocol regression fails the run
    instead of shipping a bare number."""
    problems = check_headline_stats(record)
    if problems:
        raise MalformedRecord("; ".join(problems))
