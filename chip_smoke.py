"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``.
It builds the port's kernels from ``distributed_gol_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel bit for bit
against its plain PyTorch version at the main path's shapes, drives the
main path through ``gol.run`` with ``engine="auto"`` (the default 512² x
100 headless run and a 16384² soup x 2,000 turns, plus a 'q'-detach and
resume of the latter), checks that every kernel of the path launched and
that the final boards equal an ``engine="packed"`` rerun, times every
kernel against its plain version and its bound, and prints one
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  ``--profile`` adds a
``torch.profiler`` breakdown of the 16384² run.  Every phase raises on failure; without
a CUDA GPU it exits non-zero before printing any result.

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
from distributed_gol_torch.ops import cuda_build, cuda_packed, packed
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
}


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


def drive(name: str, params: gol.Params, kernel: str, launches: dict) -> dict:
    """Drive the main path once through the kernels, then once with
    ``engine="packed"``; returns the kernel run's end-to-end numbers."""
    cuda_packed.reset_launches()
    events, final, seconds = run_main_path(params)
    launches[kernel] += getattr(cuda_packed, f"{kernel}_superstep").launches
    counts = {k: getattr(cuda_packed, f"{k}_superstep").launches for k in KERNELS}
    log(f"{name}: {seconds:.3f} s, launches {counts}, engine {engine_of(events)}")
    if engine_of(events) != "pallas-packed":
        raise AssertionError(f"{name}: engine_used {engine_of(events)!r}, not pallas-packed")
    if counts[kernel] == 0:
        raise AssertionError(f"{name}: the {kernel} kernel never launched")
    ref_params = dataclasses.replace(params, engine="packed", out_dir=params.out_dir / "packed")
    ref_events, ref_final, _ = run_main_path(ref_params)
    if final is None or final != ref_final or final_alive(events) != final_alive(ref_events):
        raise AssertionError(f"{name}: final board differs from the engine='packed' run")
    log(f"{name}: final board and alive count ({final_alive(events)}) equal the packed run")
    loop = dispatch_seconds(events)
    return dict(seconds=seconds, gens_per_s=params.turns / seconds, dispatch_loop_s=loop,
                dispatch_loop_gens_per_s=params.turns / loop if loop else None)


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


def profile_big() -> dict:
    """Where the time of the 16384² x 2,000 main-path run goes: the seeded
    soup's generation on the host, then the whole ``gol.run`` under
    ``torch.profiler`` (device time by kernel, and the device's busy
    share of the run's wall-clock)."""
    t0 = time.perf_counter()
    random_soup(BIG, BIG, 0.3, 7)
    soup_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        params = gol.Params(turns=2000, image_width=BIG, image_height=BIG, soup_density=0.3,
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
        wall_s=wall, soup_host_s=soup_s, dispatch_loop_s=dispatch_seconds(events),
        device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
        top_device=[dict(name=k[:80], device_ms=us / 1e3, calls=n) for us, k, n in rows[:12]],
    )


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

    # Phase 3: the main path, with every count set to 0 just before each run.
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        tmp = Path(tmp)
        images = tmp / "images"
        images.mkdir()
        pgm.write_pgm(images / "512x512.pgm", random_soup(512, 512, 0.3, 7))
        default = gol.Params(images_dir=images, out_dir=tmp / "default", ticker_period=3600)
        e2e = {"default_512x512x100": drive("default 512^2 x 100", default, "resident", launches)}
        big = gol.Params(turns=2000, image_width=BIG, image_height=BIG, soup_density=0.3,
                         soup_seed=7, turn_events="batch", out_dir=tmp / "big",
                         ticker_period=3600)
        e2e[f"soup_{BIG}x{BIG}x2000"] = drive(f"{BIG}^2 x 2000", big, "tiled", launches)
        straight = (big.out_dir / f"{big.final_output_name}.pgm").read_bytes()
        detach_and_resume(dataclasses.replace(big, out_dir=tmp / "detach"), straight, tmp)

    # Phase 4: time each kernel at the main path's shapes.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    v = packed.pack_vertical(board(512, 512, 21, device))
    p = packed.pack(board(BIG, BIG, 22, device))
    t_big = cuda_packed.tiled_plan(tuple(p.shape), 10**6).t
    timings = {
        "resident": (
            cuda_ms(lambda: cuda_packed.resident_superstep(v, CONWAY, 50), 20),
            cuda_ms(lambda: cuda_packed.resident_superstep_plain(v, CONWAY, 50), 3),
            bound_ms(v.numel(), 50, 1, CONWAY, int_rate),
        ),
        "tiled": (
            cuda_ms(lambda: cuda_packed.tiled_superstep(p, CONWAY, t_big), 10),
            cuda_ms(lambda: cuda_packed.tiled_superstep_plain(p, CONWAY, t_big), 2),
            bound_ms(p.numel(), t_big, 1, CONWAY, int_rate),
        ),
    }
    log(f"timed K1 at 512^2 x 50 gens (one launch), K2 at {BIG}^2 x {t_big} gens "
        f"(one launch); int32 rate {int_rate / 1e12:.2f} Tops/s ({sms} SMs, {clock_mhz} MHz); "
        f"card {card}")

    kernels = []
    for k, meta in KERNELS.items():
        ms, plain_ms, (b_ms, b_by) = timings[k]
        kernels.append(dict(
            name=k, **meta, launches=launches[k], max_abs_err=errs[k], identical=True,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
    print(json.dumps({"end_to_end": e2e, "card": card}))
    if "--profile" in sys.argv[1:]:
        print(json.dumps({"profile": profile_big(), "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
