"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``.
It builds the port's kernels from ``distributed_gol_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel bit for bit
against its plain PyTorch version at the main path's shapes (the adaptive
kernels' skip counts and activity too), and drives the main paths through
``gol.run`` with ``engine="auto"``: the default 512² x 100 headless run
and a 16384² soup x 2,000 turns (plus a 'q'-detach and resume of the
latter), whose final boards must equal an ``engine="packed"`` rerun, and
a 16384² soup x 100,000 turns, where ``skip_stable`` engages by itself and
whose final board must equal a ``skip_stable=False`` rerun.  It checks
that every kernel of each path launched in it, times every kernel against
its plain version and its bound, and prints one ``{"kernels": [...]}``
line, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.  ``--profile`` adds a ``torch.profiler`` breakdown of the two
16384² runs; ``--sweep`` times the adaptive tier over launch depths and
stripe heights (the sweep that chose ``cuda_adaptive.ADAPTIVE_T`` and
``SKIP_TILE_CAP``).  Every phase raises on failure; without a CUDA GPU it
exits non-zero before printing any result.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import distributed_gol_torch as gol
from distributed_gol_torch.engine import pgm
from distributed_gol_torch.engine.session import Session
from distributed_gol_torch.models.life import CONWAY, HIGHLIFE, LifeRule
from distributed_gol_torch.ops import cuda_adaptive, cuda_build, cuda_packed, packed
from distributed_gol_torch.utils.soup import random_soup

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # Hopper: 64 INT32 lanes per SM per clock
RULES = (CONWAY, HIGHLIFE)
BIG = 16384
TILED_ODD = (1004, 3072)  # H % 8 != 0 and W/32 % 128 != 0: refused by the TPU gate
KERNELS = {
    "resident": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/resident.cu",
        replaces="distributed_gol_tpu/ops/pallas_packed.py:373 _vmem_kernel",
    ),
    "tiled": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/tiled.cu",
        replaces="distributed_gol_tpu/ops/pallas_packed.py:554 _kernel",
    ),
    "tiled_skip": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/tiled_skip.cu",
        replaces="distributed_gol_tpu/ops/pallas_packed.py:554 _kernel (skip_stable=True form)",
    ),
    "probing": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/probing.cu",
        replaces="distributed_gol_tpu/ops/pallas_packed.py:1833 _kernel_adaptive",
    ),
    "frontier": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/frontier.cu",
        replaces="distributed_gol_tpu/ops/pallas_packed.py:1368 _kernel_frontier_mega",
    ),
}
WRAPPERS = {
    "resident": cuda_packed.resident_superstep,
    "tiled": cuda_packed.tiled_superstep,
    "tiled_skip": cuda_adaptive.tiled_skip_superstep,
    "probing": cuda_adaptive.probing_superstep,
    "frontier": cuda_adaptive.frontier_superstep,
}
ADAPTIVE = ("tiled_skip", "probing", "frontier")
LONG_TURNS = 100_000  # the auto skip_stable threshold (Params._SKIP_AUTO_TURNS)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def board(h: int, w: int, seed: int, device) -> torch.Tensor:
    return torch.from_numpy(random_soup(h, w, 0.3, seed)).to(device)


def ops_per_word(rule: LifeRule) -> int:
    """The fewest Hopper integer instructions one generation of one packed
    word needs, counted as the card executes them: any 3-input bitwise
    function is one LOP3, and a neighbour shift across a word boundary is
    one SHF funnel shift.

    The adder network of ``ops/packed.py::total_planes`` then takes 2 SHF
    (west and east) and a LOP3 for h0, plus a LOP3 for t0 if the rule reads
    it, plus h1, c, p1, q and one LOP3 per plane of t1..t3 that the rule
    reads.  The rule reads the smallest set of (t0, t1, t2, t3, centre)
    that decides it on every reachable (total, centre) pair, and n inputs
    need at least n // 2 LOP3s to meet in one output.  Conway's B3/S23
    reads t0, t1, t2 and the centre: 10 + 2 = 12."""
    states = [(t, c) for c in (0, 1) for t in range(c, 9 + c)]

    def out(t: int, c: int) -> bool:
        return (t - 1 in rule.survive) if c else (t in rule.birth)

    best = None
    for mask in range(32):
        decided: dict = {}
        if any(decided.setdefault(tuple((t | c << 4) >> i & 1 for i in range(5)
                                        if mask >> i & 1), out(t, c)) != out(t, c)
               for t, c in states):
            continue  # two states these inputs cannot tell apart differ
        upper = bin(mask & 0b1110).count("1")  # t1..t3
        adder = 0
        if mask & 0b1111:
            adder = 3 + (mask & 1) + (4 + upper if upper else 0)
        cost = adder + bin(mask).count("1") // 2
        best = cost if best is None else min(best, cost)
    return best


def bound_ms(words: int, gens: int, launches: int, rule: LifeRule, int_rate: float):
    """The least time the card could take: the larger of the bytes (one
    read and one write of the packed board per launch) over the memory
    rate and the instructions (``ops_per_word``) over the int32 rate."""
    t_bytes = launches * 2 * words * 4 / HBM_BYTES_PER_S
    t_ops = words * gens * ops_per_word(rule) / int_rate
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def numpy_life(b: np.ndarray, turns: int, rule: LifeRule) -> np.ndarray:
    """An independent NumPy oracle: padded-slice neighbour counts."""
    alive = (b == 255).astype(np.int64)
    for _ in range(turns):
        p = np.pad(alive, 1, mode="wrap")
        h, w = alive.shape
        n = sum(p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)) - alive
        born = np.isin(n, list(rule.birth)) & (alive == 0)
        keep = np.isin(n, list(rule.survive)) & (alive == 1)
        alive = (born | keep).astype(np.int64)
    return (alive * 255).astype(np.uint8)


# -- phase 2: every kernel against its plain version -------------------------


def check_resident(device, errs: dict) -> None:
    for rule in RULES:
        v = packed.pack_vertical(board(512, 512, 11, device))
        for turns in (1, 6, 100, 1000):
            got = cuda_packed.resident_superstep(v, rule, turns)
            want = cuda_packed.resident_superstep_plain(v, rule, turns)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            errs["resident"] = max(errs["resident"], err)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 != plain at 512^2 x {turns} under {rule.notation}")
            log(f"K1 512^2 x {turns} {rule.notation}: identical")
    b = board(512, 512, 12, device)
    got = cuda_packed.make_superstep_bytes(CONWAY, device)(b, 100).cpu().numpy()
    if not np.array_equal(got, numpy_life(b.cpu().numpy(), 100, CONWAY)):
        raise AssertionError("K1 512^2 x 100 disagrees with the NumPy oracle")
    log("K1 512^2 x 100: equals the independent NumPy oracle")


def check_tiled(device, errs: dict) -> None:
    t = cuda_packed.tiled_plan((BIG, BIG // 32), 10**6).t
    cases = [((BIG, BIG), n) for n in (1, 6, t, t + 5, 1000)] + [(TILED_ODD, 75)]
    for rule in RULES:
        for shape, turns in cases:
            p = packed.pack(board(*shape, 13, device))
            got = cuda_packed.tiled_superstep(p, rule, turns)
            want = cuda_packed.tiled_superstep_plain(p, rule, turns)
            torch.cuda.synchronize()
            errs["tiled"] = max(errs["tiled"], max_abs_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"K2 != plain at {shape} x {turns} under {rule.notation}")
            log(f"K2 {shape[0]}x{shape[1]} x {turns} {rule.notation}: identical")


def reset_launches() -> None:
    cuda_packed.reset_launches()
    cuda_adaptive.reset_launches()


def launch_counts() -> dict:
    return {k: WRAPPERS[k].launches for k in KERNELS}


def settled_board(device) -> torch.Tensor:
    """The 16384² soup (density 0.3, seed 7) after ``LONG_TURNS``
    generations of K2: ash, oscillators and the odd glider."""
    p = packed.pack(board(BIG, BIG, 7, device))
    return cuda_packed.tiled_superstep(p, CONWAY, LONG_TURNS)


def check_adaptive(errs: dict, boards: dict) -> None:
    """K3, K4 and K5 against their plain versions at 16384²: board, skip
    count and per-stripe activity, on each board under both rules, through
    one dispatch of t·(512 + 3) + 13 turns (a 512-launch frontier chunk, a
    3-launch probing tail, a skip launch and a plain remainder), then K3
    alone at every launch depth and K4 alone over 8 launches."""
    plan = cuda_adaptive.adaptive_plan((BIG, BIG // 32), 10**6)
    turns = plan.t * (512 + 3) + 13
    want_counts = {"frontier": 512, "probing": 3, "tiled_skip": 1}
    for rule in RULES:
        for name, p in boards.items():
            reset_launches()
            got, sk, act = cuda_adaptive.adaptive_superstep(p, rule, turns, plan)
            torch.cuda.synchronize()
            counts = {k: WRAPPERS[k].launches for k in want_counts}
            if counts != want_counts:
                raise AssertionError(f"adaptive dispatch launched {counts}, not {want_counts}")
            want, wsk, wact = cuda_adaptive.adaptive_superstep_mirror(p, rule, turns, plan)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            for k in ADAPTIVE:
                errs[k] = max(errs[k], err)
            if not torch.equal(got, want) or int(sk) != int(wsk) or not torch.equal(act, wact):
                raise AssertionError(f"adaptive dispatch != plain on the {name} board under "
                                     f"{rule.notation}: skipped {int(sk)} vs {int(wsk)}")
            log(f"K5+K4+K3 {BIG}^2 x {turns} ({plan}) {name} {rule.notation}: identical, "
                f"skipped {int(sk)} of {cuda_adaptive.adaptive_tile_launches((BIG, BIG // 32), turns, plan=plan)}, "
                f"active stripes {int((act > 0).sum())}")
            for t in (6, 12, 18, 24):
                got = cuda_adaptive.tiled_skip_superstep(p, rule, t)
                want = cuda_adaptive.tiled_skip_superstep_plain(p, rule, t)
                errs["tiled_skip"] = max(errs["tiled_skip"], max_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"K3 != plain at {t} turns, {name}, {rule.notation}")
            got, sk, act = cuda_adaptive.probing_superstep(p, rule, plan, 8)
            want, wsk, wact = cuda_adaptive.probing_superstep_mirror(p, rule, plan, 8)
            errs["probing"] = max(errs["probing"], max_abs_err(got, want))
            if not torch.equal(got, want) or int(sk) != int(wsk) or not torch.equal(act, wact):
                raise AssertionError(f"K4 x 8 launches != plain, {name}, {rule.notation}")
            log(f"K3 x {{6, 12, 18, 24}} and K4 x 8 launches, {name} {rule.notation}: identical")


# -- phase 3: the main path ----------------------------------------------------


class KeysAfter(queue.Queue):
    """A key queue that receives ``keys`` once the controller has polled it
    ``polls`` times: a keypress that lands mid-run, at a dispatch boundary."""

    def __init__(self, polls: int, keys: str):
        super().__init__()
        self._polls, self._keys = polls, keys

    def empty(self) -> bool:
        self._polls -= 1
        if self._polls == 0:
            for k in self._keys:
                self.put(k)
        return super().empty()


def run_main_path(params: gol.Params, keys=None, session=None):
    """One ``gol.run``; returns (events, final PGM bytes or None, seconds)."""
    events: queue.Queue = queue.Queue()
    t0 = time.perf_counter()
    gol.run(params, events, keys, session)
    seconds = time.perf_counter() - t0
    out = []
    while (e := events.get(timeout=60)) is not None:
        out.append(e)
    final = params.out_dir / f"{params.final_output_name}.pgm"
    return out, (final.read_bytes() if final.is_file() else None), seconds


def engine_of(events) -> str:
    (report,) = [e for e in events if isinstance(e, gol.MetricsReport)]
    return report.snapshot["info"]["backend.engine"]


def final_alive(events) -> int:
    (final,) = [e for e in events if isinstance(e, gol.FinalTurnComplete)]
    return len(final.alive)


def dispatch_seconds(events) -> float:
    """Wall-clock the run spent in its dispatch loop (issue to resolve),
    from the run's own MetricsReport."""
    (report,) = [e for e in events if isinstance(e, gol.MetricsReport)]
    return report.snapshot["histograms"]["controller.dispatch_seconds"]["sum"]


def metrics_report(events):
    (report,) = [e for e in events if isinstance(e, gol.MetricsReport)]
    return report.snapshot


def drive(name: str, params: gol.Params, kernels: tuple, launches: dict, reference: dict) -> dict:
    """Drive one main path through the kernels, with every launch count set
    to 0 just before and read just after, then once more with the
    ``reference`` overrides (``engine="packed"``, or ``skip_stable=False``);
    the final boards and alive counts must agree.  Returns the kernel
    run's end-to-end numbers."""
    reset_launches()
    events, final, seconds = run_main_path(params)
    counts = launch_counts()
    for k in kernels:
        launches[k] = counts[k]
    log(f"{name}: {seconds:.3f} s, launches {counts}, engine {engine_of(events)}")
    if engine_of(events) != "pallas-packed":
        raise AssertionError(f"{name}: engine_used {engine_of(events)!r}, not pallas-packed")
    for k in kernels:
        if counts[k] == 0:
            raise AssertionError(f"{name}: the {k} kernel never launched")
    ref_params = dataclasses.replace(params, out_dir=params.out_dir / "reference", **reference)
    ref_events, ref_final, ref_seconds = run_main_path(ref_params)
    if final is None or final != ref_final or final_alive(events) != final_alive(ref_events):
        raise AssertionError(f"{name}: final board differs from the {reference} run")
    log(f"{name}: final board and alive count ({final_alive(events)}) equal the {reference} "
        f"run ({ref_seconds:.3f} s)")
    loop = dispatch_seconds(events)
    out = dict(seconds=seconds, gens_per_s=params.turns / seconds, dispatch_loop_s=loop,
               dispatch_loop_gens_per_s=params.turns / loop if loop else None,
               launches=counts, reference=dict(overrides=reference, seconds=ref_seconds,
                                                gens_per_s=params.turns / ref_seconds,
                                                dispatch_loop_s=dispatch_seconds(ref_events)))
    gauges = metrics_report(events)["gauges"]
    if "backend.skip_fraction" in gauges:
        out.update(skip_fraction=gauges["backend.skip_fraction"],
                   active_stripes=gauges.get("backend.active_tiles"))
    return out


def detach_and_resume(params: gol.Params, straight: bytes, tmp: Path) -> None:
    """'q' mid-run parks a checkpoint on a durable session; a second run
    resumes it to the straight run's final board."""
    session = Session(tmp / "ckpt")
    events, final, _ = run_main_path(params, KeysAfter(3, "q"), session)
    quit_turns = [e.completed_turns for e in events if isinstance(e, gol.StateChange)
                  and e.new_state == gol.State.QUITTING]
    if final is not None or not quit_turns or not 0 < quit_turns[0] < params.turns:
        raise AssertionError(f"detach did not land mid-run: {quit_turns}")
    resumed = Session(tmp / "ckpt")
    _, final, _ = run_main_path(params, None, resumed)
    if final != straight:
        raise AssertionError("the resumed run's final board differs from the straight run")
    log(f"detach at turn {quit_turns[0]} and resume: final board equals the straight run")


def profile_run(turns: int) -> dict:
    """Where the time of a 16384² main-path run goes: the seeded soup's
    generation on the host, then the whole ``gol.run`` under
    ``torch.profiler`` (device time by kernel, and the device's busy share
    of the run's wall-clock)."""
    t0 = time.perf_counter()
    random_soup(BIG, BIG, 0.3, 7)
    soup_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        params = gol.Params(turns=turns, image_width=BIG, image_height=BIG, soup_density=0.3,
                            soup_seed=7, turn_events="batch", out_dir=Path(tmp),
                            ticker_period=3600)
        with torch.profiler.profile(activities=acts) as prof:
            events, _, wall = run_main_path(params)
    rows = []
    for a in prof.key_averages():
        # Kernel and copy rows only: a host op's row repeats its kernels'
        # time, and the gol.* ranges (obs/spans.py) span them on the device.
        if "CUDA" not in str(getattr(a, "device_type", "")) or a.key.startswith("gol."):
            continue
        dev_us = getattr(a, "self_device_time_total", None)
        if dev_us is None:
            dev_us = a.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, a.key, a.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    return dict(
        turns=turns, wall_s=wall, soup_host_s=soup_s, dispatch_loop_s=dispatch_seconds(events),
        device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
        top_device=[dict(name=k[:80], device_ms=us / 1e3, calls=n) for us, k, n in rows[:12]],
    )


# -- phase 4: times and bounds -------------------------------------------------


def work_bound_ms(words_moved: float, words_computed: float, gens: int, rule: LifeRule,
                  int_rate: float):
    """The least time for the work a launch's data needs: the
    ``words_computed`` packed words it must advance ``gens`` generations
    (``ops_per_word`` instructions each) over the int32 rate, against one
    read and one write of the ``words_moved`` words it must move over the
    memory rate."""
    t_bytes = 2 * words_moved * 4 / HBM_BYTES_PER_S
    t_ops = words_computed * gens * ops_per_word(rule) / int_rate
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def time_adaptive(boards: dict, int_rate: float) -> dict:
    """Per-launch times of K3, K4 and K5 at 16384² on each board, beside
    K2 at the same T and the plain versions, with each launch's bound from
    its own skip telemetry: K5 over a 64-launch chunk, K4 over 8 launches
    from a zero bitmap (both move only the stripes they compute), K3 one
    launch (it writes the whole board; its computed stripes are those K4's
    first launch does not prove stable).  The ``dead`` board's times are
    the launch floor: it has no work."""
    plan = cuda_adaptive.adaptive_plan((BIG, BIG // 32), 10**6)
    grid = plan.grid(BIG)
    stripe_words = plan.stripe_h * BIG // 32
    out = {}
    for name, p in boards.items():
        _, sk5, _ = cuda_adaptive.frontier_superstep(p, CONWAY, plan, 64)
        _, sk4, _ = cuda_adaptive.probing_superstep(p, CONWAY, plan, 8)
        _, sk1, _ = cuda_adaptive.probing_superstep(p, CONWAY, plan, 1)
        computed = {"frontier": (64 * grid - int(sk5)) / 64, "probing": (8 * grid - int(sk4)) / 8,
                    "tiled_skip": grid - int(sk1)}
        gens = {"frontier": plan.t + 6, "probing": plan.t, "tiled_skip": plan.t}
        row = {
            "tiled_same_t_ms": cuda_ms(lambda: cuda_packed.tiled_superstep(p, CONWAY, plan.t), 10),
            "tiled_skip": dict(
                ms=cuda_ms(lambda: cuda_adaptive.tiled_skip_superstep(p, CONWAY, plan.t), 10),
                plain_ms=cuda_ms(lambda: cuda_adaptive.tiled_skip_superstep_plain(p, CONWAY, plan.t), 2)),
            "probing": dict(
                ms=cuda_ms(lambda: cuda_adaptive.probing_superstep(p, CONWAY, plan, 8), 5) / 8,
                plain_ms=cuda_ms(lambda: cuda_adaptive.probing_superstep_mirror(p, CONWAY, plan, 8), 1) / 8),
            "frontier": dict(
                ms=cuda_ms(lambda: cuda_adaptive.frontier_superstep(p, CONWAY, plan, 64), 3) / 64,
                plain_ms=cuda_ms(lambda: cuda_adaptive.frontier_superstep_mirror(p, CONWAY, plan, 64), 1) / 64),
        }
        for k in ADAPTIVE:
            moved = p.numel() if k == "tiled_skip" else computed[k] * stripe_words
            b_ms, b_by = work_bound_ms(moved, computed[k] * stripe_words, gens[k], CONWAY, int_rate)
            row[k].update(computed_stripes_per_launch=computed[k], bound_ms=b_ms, bound_by=b_by)
        out[name] = row
        log(f"{name} board, {plan}: K2 {row['tiled_same_t_ms']:.4f} ms per {plan.t}-gen launch; "
            + "; ".join(f"{k} {row[k]['ms']:.4f} ms (plain {row[k]['plain_ms']:.3f}, bound "
                        f"{row[k]['bound_ms']:.4f} by {row[k]['bound_by']}, "
                        f"{row[k]['computed_stripes_per_launch']:.2f} of {grid} stripes computed)"
                        for k in ADAPTIVE))
    return dict(plan=dataclasses.asdict(plan), boards=out)


def with_gliders(p: torch.Tensor, n: int = 16) -> torch.Tensor:
    """``p`` with ``n`` gliders ORed in at seeded places: residual
    activity on settled ash."""
    b = packed.unpack(p).cpu().numpy()
    rng = np.random.default_rng(3)
    glider = np.array([[0, 255, 0], [0, 0, 255], [255, 255, 255]], dtype=np.uint8)
    for y, x in rng.integers(0, BIG - 3, size=(n, 2)):
        b[y:y + 3, x:x + 3] |= glider
    return packed.pack(torch.from_numpy(b).to(p.device))


def sweep(boards: dict, tmp: Path) -> dict:
    """The adaptive plan over launch depths and stripe heights: gens/s of
    one dispatch on the fresh soup (64 launches), on the settled board and
    on the settled board with 16 gliders (512 launches: one frontier
    chunk each), then the whole 16384² x 100,000 main path at the best
    candidates (``ADAPTIVE_T`` and ``SKIP_TILE_CAP`` set for the run)."""
    cases = {"fresh": (boards["fresh"], 64), "settled": (boards["settled"], 512),
             "gliders": (with_gliders(boards["settled"]), 512)}
    rows = []
    for t in (6, 12, 18, 24):
        for stripe_h in (64, 128, 256, 512, 1024):
            plan = cuda_adaptive.AdaptivePlan(t, stripe_h, cuda_adaptive._round8(t + 6) <= stripe_h)
            row = dict(t=t, stripe_h=stripe_h)
            for name, (p, nlaunch) in cases.items():
                n = t * nlaunch
                ms = cuda_ms(lambda: cuda_adaptive.adaptive_superstep(p, CONWAY, n, plan), 1)
                row[f"{name}_gens_per_s"] = n / ms * 1e3
            log(f"sweep {row}")
            rows.append(row)
    runs = []
    saved = cuda_adaptive.ADAPTIVE_T, cuda_adaptive.SKIP_TILE_CAP
    try:
        for t, cap in ((18, 256), (24, 256), (18, 1024), (24, 1024), (12, 256)):
            cuda_adaptive.ADAPTIVE_T, cuda_adaptive.SKIP_TILE_CAP = t, cap
            params = gol.Params(turns=LONG_TURNS, image_width=BIG, image_height=BIG,
                                soup_density=0.3, soup_seed=7, turn_events="batch",
                                out_dir=tmp / f"sweep_{t}_{cap}", ticker_period=3600)
            events, _, seconds = run_main_path(params)
            loop = dispatch_seconds(events)
            runs.append(dict(t=t, stripe_cap=cap, seconds=seconds, gens_per_s=LONG_TURNS / seconds,
                             dispatch_loop_s=loop, dispatch_loop_gens_per_s=LONG_TURNS / loop))
            log(f"sweep main path {runs[-1]}")
    finally:
        cuda_adaptive.ADAPTIVE_T, cuda_adaptive.SKIP_TILE_CAP = saved
    return dict(dispatches=rows, main_path=runs)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)")
        return 1
    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 1: build every kernel from source, in parallel.
    t0 = time.perf_counter()
    cuda_build.build(*KERNELS)
    log(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for k in KERNELS:
        for line in cuda_build.build_log(k).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {k}: {line.strip()}")
    plan = cuda_packed.tiled_plan((BIG, BIG // 32), 10**6)
    log(f"dynamic shared memory: resident {512 // 32 * 512 * 4} B per block at 512^2 "
        f"(1 block of 1024 threads); tiled {plan.smem_bytes} B per block at {BIG}^2 "
        f"({plan}, grid {plan.grid((BIG, BIG // 32))}, 64x16 threads)")

    # Phase 2: each kernel against its plain version, bit for bit.
    errs = {k: 0 for k in KERNELS}
    check_resident(device, errs)
    check_tiled(device, errs)
    boards = {"fresh": packed.pack(board(BIG, BIG, 13, device)), "settled": settled_board(device)}
    check_adaptive(errs, boards)

    # Phase 3: the main paths, with every count set to 0 just before each run.
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        tmp = Path(tmp)
        images = tmp / "images"
        images.mkdir()
        pgm.write_pgm(images / "512x512.pgm", random_soup(512, 512, 0.3, 7))
        packed_ref = dict(engine="packed")
        default = gol.Params(images_dir=images, out_dir=tmp / "default", ticker_period=3600)
        e2e = {"default_512x512x100": drive("default 512^2 x 100", default, ("resident",),
                                            launches, packed_ref)}
        big = gol.Params(turns=2000, image_width=BIG, image_height=BIG, soup_density=0.3,
                         soup_seed=7, turn_events="batch", out_dir=tmp / "big",
                         ticker_period=3600)
        e2e[f"soup_{BIG}x{BIG}x2000"] = drive(f"{BIG}^2 x 2000", big, ("tiled",), launches,
                                              packed_ref)
        straight = (big.out_dir / f"{big.final_output_name}.pgm").read_bytes()
        detach_and_resume(dataclasses.replace(big, out_dir=tmp / "detach"), straight, tmp)
        long = dataclasses.replace(big, turns=LONG_TURNS, out_dir=tmp / "long")
        if not long.skip_stable_requested():
            raise AssertionError("auto skip_stable does not engage at the long run")
        e2e[f"soup_{BIG}x{BIG}x{LONG_TURNS}"] = run_long = drive(
            f"{BIG}^2 x {LONG_TURNS}", long, ADAPTIVE, launches, dict(skip_stable=False))
        if run_long.get("skip_fraction") is None:
            raise AssertionError("skip_fraction() is None at the end of the long run")
        log(f"{BIG}^2 x {LONG_TURNS}: {run_long['gens_per_s']:.1f} gens/s run, "
            f"{run_long['dispatch_loop_gens_per_s']:.1f} gens/s dispatch loop, final skip "
            f"fraction {run_long['skip_fraction']}, launches {run_long['launches']}")

    # Phase 4: time each kernel at the main path's shapes.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    v = packed.pack_vertical(board(512, 512, 21, device))
    p = packed.pack(board(BIG, BIG, 22, device))
    t_big = cuda_packed.tiled_plan(tuple(p.shape), 10**6).t
    timings = {
        "resident": dict(
            ms=cuda_ms(lambda: cuda_packed.resident_superstep(v, CONWAY, 50), 20),
            plain_ms=cuda_ms(lambda: cuda_packed.resident_superstep_plain(v, CONWAY, 50), 3),
            bound=bound_ms(v.numel(), 50, 1, CONWAY, int_rate),
        ),
        "tiled": dict(
            ms=cuda_ms(lambda: cuda_packed.tiled_superstep(p, CONWAY, t_big), 10),
            plain_ms=cuda_ms(lambda: cuda_packed.tiled_superstep_plain(p, CONWAY, t_big), 2),
            bound=bound_ms(p.numel(), t_big, 1, CONWAY, int_rate),
        ),
    }
    log(f"timed K1 at 512^2 x 50 gens (one launch), K2 at {BIG}^2 x {t_big} gens "
        f"(one launch); int32 rate {int_rate / 1e12:.2f} Tops/s ({sms} SMs, {clock_mhz} MHz); "
        f"card {card}")
    boards["dead"] = torch.zeros_like(boards["fresh"])
    adaptive = time_adaptive(boards, int_rate)
    for k in ADAPTIVE:
        # The fresh soup leads (every stripe computes, so the bound is the
        # kernel's roofline); the settled and dead boards follow.
        fresh = adaptive["boards"]["fresh"][k]
        timings[k] = dict(ms=fresh["ms"], plain_ms=fresh["plain_ms"],
                          bound=(fresh["bound_ms"], fresh["bound_by"]),
                          extra=dict(board="fresh", per_board={
                              name: row[k] for name, row in adaptive["boards"].items()},
                              tiled_same_t_ms={name: row["tiled_same_t_ms"]
                                               for name, row in adaptive["boards"].items()}))

    kernels = []
    for k, meta in KERNELS.items():
        tm = timings[k]
        b_ms, b_by = tm["bound"]
        kernels.append(dict(
            name=k, **meta, launches=launches[k], max_abs_err=errs[k], identical=True,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **tm.get("extra", {}),
        ))
    print(json.dumps({"end_to_end": e2e, "card": card}))
    if "--sweep" in sys.argv[1:]:
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
            print(json.dumps({"sweep": sweep(boards, Path(tmp)), "card": card}))
    if "--profile" in sys.argv[1:]:
        for turns in (2000, LONG_TURNS):
            print(json.dumps({"profile": profile_run(turns), "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
