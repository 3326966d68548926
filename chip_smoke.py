"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--sweep]

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``.
It builds the port's kernels from ``distributed_gol_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel bit for bit
against its plain PyTorch version at the main path's shapes (the adaptive
kernels' skip counts and activity too), and drives the main paths through
``gol.run`` with ``engine="auto"``: the default 512² x 100 headless run
and a 16384² soup x 2,000 turns (plus a 'q'-detach and resume of the
latter), whose final boards must equal an ``engine="packed"`` rerun, and
a 16384² soup x 100,000 turns, where ``skip_stable`` engages by itself and
whose final board must equal a ``skip_stable=False`` rerun.  Then the
viewer paths, where ``auto`` takes the byte kernel: per-cell flips of the
512² board x 2, pooled full-board frames of the 16384² soup x 500, a
1024² viewport of it x 1,000 with delta frames and pan/zoom keys, and the
CLI's terminal viewer in a subprocess (and, traced, one generation of a
128² soup, for its count of K6 launches); each final board must equal a
headless ``engine="packed"`` rerun and each stream must rebuild its final
view.  Then the serving paths, through ``ServePlane`` in process: (a) 16
tenants of 512² x 10,000 turns, ``batched=True``, superstep 64 (K7), (b)
the same pod unbatched (K1 per tenant), (c) 4 tenants of 4096² x 10,000,
``batched=True``, superstep 192 (K8, the last dispatch's tail on K3 and
K2), and the ``serve`` CLI in a subprocess (4 tenants of 512² x 2,000,
``--batched``); every tenant's final PGM must equal a solo
``engine="pallas-packed"`` rerun.  It checks that every kernel of each
path launched in it, times every kernel against its plain version and its
bound (and a viewer turn's parts at 16384², K6 beside a byte copy of the
board and beside a build of K6 without the modulo in its ring index, and
K7 beside 16 sequential K1 launches), and prints one ``{"kernels": [...]}``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
``--profile`` adds a ``torch.profiler`` breakdown of the two headless
16384² runs and of the three viewer paths; ``--sweep`` times the adaptive
tier over launch depths and stripe heights (the sweep that chose
``cuda_adaptive.ADAPTIVE_T`` and ``SKIP_TILE_CAP``).  Every phase raises
on failure; without a CUDA GPU it exits non-zero before printing any
result.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import queue
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import zlib

import numpy as np
import torch

import distributed_gol_torch as gol
from distributed_gol_torch.engine import frames, pgm
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.session import Session
from distributed_gol_torch.obs import metrics
from distributed_gol_torch.serve import ServeConfig, ServePlane
from distributed_gol_torch.models.life import CONWAY, HIGHLIFE, LifeRule
from distributed_gol_torch.ops import (
    cuda_adaptive, cuda_build, cuda_packed, cuda_stencil, packed, stencil)
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
    "stencil": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/stencil.cu",
        replaces="distributed_gol_tpu/ops/pallas_stencil.py:88 _stencil_kernel",
    ),
    "resident_batched": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/resident.cu",
        replaces="distributed_gol_tpu/ops/pallas_packed.py:393 _vmem_kernel_batched",
    ),
    "frontier_batched": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/frontier.cu",
        replaces="distributed_gol_tpu/ops/pallas_packed.py:1368 _kernel_frontier_mega "
                 "(nboards > 1 form)",
    ),
}
WRAPPERS = {
    "resident": cuda_packed.resident_superstep,
    "tiled": cuda_packed.tiled_superstep,
    "tiled_skip": cuda_adaptive.tiled_skip_superstep,
    "probing": cuda_adaptive.probing_superstep,
    "frontier": cuda_adaptive.frontier_superstep,
    "stencil": cuda_stencil.stencil_step,
    "resident_batched": cuda_packed.resident_superstep_batched,
    "frontier_batched": cuda_adaptive.frontier_superstep_batched,
}
ADAPTIVE = ("tiled_skip", "probing", "frontier")
LONG_TURNS = 100_000  # the auto skip_stable threshold (Params._SKIP_AUTO_TURNS)
STENCIL_ODD = (1004, 3076)  # W % 128 != 0 and H % 8 != 0: refused by the TPU gate
VIEWPORT = (8000, 8000, 1024, 1024)  # the viewport path's starting rect
# Depth of the two per-cell flip paths (512²: the run and the CLI).  Each
# CellFlipped event costs the host of an H100 machine about 20 µs while
# the stream is consumed (PERF.md), and the seeded board and its first 2
# generations emit 243,954 of them.
FLIP_TURNS = 2
# The serving pods: (tenants, side, turns, superstep).
POD_K7 = (16, 512, 10_000, 64)
POD_K8 = (4, 4096, 10_000, 192)
CLI_POD = (4, 512, 2_000, 64)


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


# Integer instructions K6 spends per cell, counted from csrc/stencil.cu
# (loads, stores and address arithmetic not counted): per 4-cell word, 3
# IADD3 for the three-row sums of the word and of its west and east cells,
# 3 shifts and 1 OR for the column neighbours, 1 IADD3 for the 9-cell total
# (8 per word, 2 per cell); per cell, 8 for the rule: extract the total and
# the alive bit, select the mask, shift it by the total, take bit 0, scale
# to 0/255, place and merge the byte.
STENCIL_OPS_PER_CELL = 10


def stencil_bound_ms(h: int, w: int, int_rate: float):
    """K6's least time for one generation of an H x W board: one read and
    one write of the board (2·H·W bytes) over the memory rate, against
    ``STENCIL_OPS_PER_CELL`` integer instructions per cell over the int32
    rate; the larger, and which."""
    t_bytes = 2 * h * w / HBM_BYTES_PER_S
    t_ops = h * w * STENCIL_OPS_PER_CELL / int_rate
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# K6's ring index, and the same with a subtraction for the modulo: exact
# while every index stays below twice the board's side, as at 16384².
WRAP_MOD = "(i >= n ? i % n : i)"
WRAP_SUB = "(i >= n ? i - n : i)"


def build_kernels() -> Path:
    """Build every kernel from source, and with them (one more ``nvcc``,
    started first) a copy of ``csrc/stencil.cu`` whose ``wrap`` subtracts
    instead of taking ``%``, into ``build/kernels/``; returns the path of
    that wrap-free K6's library."""
    src = (cuda_build.CSRC / "stencil.cu").read_text()
    if src.count(WRAP_MOD) != 1:
        raise AssertionError("csrc/stencil.cu has no single wrap() modulo for the witness to edit")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / "stencil_wrap_free.cu"
    cu.write_text(src.replace(WRAP_MOD, WRAP_SUB))
    lib = cu.with_suffix(".so")
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        cuda_build.build(*cuda_build.KERNELS)
    finally:
        out_log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the wrap-free K6 build failed:\n{out_log}")
    return lib


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


def check_stencil(device, errs: dict) -> None:
    """K6 against its plain version: 512² and 16384², 1 and 8 generations,
    Conway and HighLife, and a shape only the port's gate takes."""
    for shape, depths in [((512, 512), (1, 8)), ((BIG, BIG), (1, 8)), (STENCIL_ODD, (8,))]:
        b = board(*shape, 17, device)
        before = b.clone()
        for rule in RULES:
            want = b
            for turns in range(1, max(depths) + 1):
                want = cuda_stencil.stencil_step_plain(want, rule)
                if turns not in depths:
                    continue
                got = cuda_stencil.make_superstep(rule)(b, turns)
                torch.cuda.synchronize()
                errs["stencil"] = max(errs["stencil"], max_abs_err(got, want))
                if not torch.equal(got, want) or not torch.equal(b, before):
                    raise AssertionError(f"K6 != plain (or its input written) at {shape} x "
                                         f"{turns} under {rule.notation}")
                log(f"K6 {shape[0]}x{shape[1]} x {turns} {rule.notation}: identical")


def soup_stack(nb: int, side: int, seed: int, device) -> torch.Tensor:
    """A (nb, side, side) stack of soups (density 0.3, seeds seed..)."""
    return torch.stack([board(side, side, seed + i, device) for i in range(nb)])


def check_resident_batched(device, errs: dict) -> None:
    """K7 against its plain version at the serving pod's 16 x 512² and at
    3 x 1024 x 1792 (the edge of the 227 KB gate), 1, 9 and 64
    generations under both rules; slot 0 against K1 too."""
    for nb, h, w in ((16, 512, 512), (3, 1024, 1792)):
        if cuda_packed.resident_shape(h, w) is None:
            raise AssertionError(f"{h}x{w} is outside K7's gate")
        v = packed.pack_vertical(torch.stack([board(h, w, 31 + i, device) for i in range(nb)]))
        v = v.contiguous()
        for rule in RULES:
            for turns in (1, 9, 64):
                got = cuda_packed.resident_superstep_batched(v, rule, turns)
                want = cuda_packed.resident_superstep_batched_plain(v, rule, turns)
                solo = cuda_packed.resident_superstep(v[0].contiguous(), rule, turns)
                torch.cuda.synchronize()
                errs["resident_batched"] = max(errs["resident_batched"], max_abs_err(got, want))
                if not torch.equal(got, want) or not torch.equal(got[0], solo):
                    raise AssertionError(f"K7 != plain (or K1) at {nb} x {h}x{w} x {turns} "
                                         f"under {rule.notation}")
            log(f"K7 {nb} x {h}x{w} x {{1, 9, 64}} {rule.notation}: identical (slot 0 = K1)")


def seam_stack(side: int, device) -> torch.Tensor:
    """The cross-board seam case: board 0 holds two gliders crossing its
    own row wrap and a block, board 1 is dead, board 2 a soup.  A board
    axis that leaked across the seam would let board 0's edge stripes read
    board 1's "no activity" and skip."""
    b0 = np.zeros((side, side), np.uint8)
    for y, x in ((side - 3, 100), (side - 4, 2000)):
        for dy, dx in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
            b0[(y + dy) % side, x + dx] = 255
    b0[side // 2 : side // 2 + 2, 50:52] = 255
    stack = np.stack([b0, np.zeros_like(b0), random_soup(side, side, 0.3, 41)])
    return torch.from_numpy(stack).to(device)


def check_frontier_batched(device, errs: dict) -> dict:
    """K8 against its plain version over one canonical chunk (8 launches)
    of 4 x 4096², fresh and settled (each soup after ``LONG_TURNS``
    generations of K2), and on the seam stack: boards, per-board skip
    counts and activity, under both rules; and K8 with one board against
    K5.  Returns the packed stacks (phase 4 times them)."""
    side, nb = POD_K8[1], POD_K8[0]
    plan = cuda_adaptive.adaptive_plan((side, side // 32), 10**6)
    fresh = packed.pack(soup_stack(nb, side, 51, device)).contiguous()
    settled = torch.stack([cuda_packed.tiled_superstep(b.contiguous(), CONWAY, LONG_TURNS)
                           for b in fresh])
    stacks = {"fresh": fresh, "settled": settled,
              "seam": packed.pack(seam_stack(side, device)).contiguous()}
    for rule in RULES:
        for name, st in stacks.items():
            got, sk, act = cuda_adaptive.frontier_superstep_batched(st, rule, plan, 8)
            want, wsk, wact = cuda_adaptive.frontier_superstep_batched_mirror(st, rule, plan, 8)
            torch.cuda.synchronize()
            errs["frontier_batched"] = max(errs["frontier_batched"], max_abs_err(got, want))
            if not (torch.equal(got, want) and torch.equal(sk, wsk) and torch.equal(act, wact)):
                raise AssertionError(f"K8 != plain on the {name} stack under {rule.notation}: "
                                     f"skipped {sk.tolist()} vs {wsk.tolist()}")
            if name == "seam" and not torch.equal(got, packed.superstep(st, rule, 8 * plan.t)):
                raise AssertionError("K8's seam stack differs from the plain packed engine")
            log(f"K8 {st.shape[0]} x {side}^2 x 8 launches ({plan}) {name} {rule.notation}: "
                f"identical, skipped {sk.tolist()}, active stripes {int((act > 0).sum())}")
        one = cuda_adaptive.frontier_superstep_batched(fresh[:1].contiguous(), rule, plan, 8)
        k5 = cuda_adaptive.frontier_superstep(fresh[0].contiguous(), rule, plan, 8)
        if not (torch.equal(one[0][0], k5[0]) and int(one[1][0]) == int(k5[1])
                and torch.equal(one[2], k5[2])):
            raise AssertionError(f"K8 with one board != K5 under {rule.notation}")
    log("K8 with one board: equals K5 (board, skip count, activity)")
    return {"fresh": fresh, "settled": settled}


def reset_launches() -> None:
    cuda_packed.reset_launches()
    cuda_adaptive.reset_launches()
    cuda_stencil.reset_launches()


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
    """A key queue fed by the controller's own polling: ``schedule`` maps
    the n-th poll (``empty`` or ``get``) to the keys that arrive then — a
    keypress that lands mid-run, at a dispatch boundary."""

    def __init__(self, schedule: dict):
        super().__init__()
        self._schedule, self._polls = dict(schedule), 0

    def _tick(self) -> None:
        self._polls += 1
        for k in self._schedule.pop(self._polls, ""):
            self.put(k)

    def empty(self) -> bool:
        self._tick()
        return super().empty()

    def get(self, block=True, timeout=None):
        self._tick()
        return super().get(block, timeout)


class Sink:
    """Consumes a run's stream as it is produced, keeping only what the
    checks need: the MetricsReport snapshot, the final event, the turn of
    a 'q' detach, the counts of turns, frames and flips, the flips XOR-ed
    into a shadow board of ``shape`` (flip runs), and the view rebuilt
    from keyframes and deltas with its rect and pooling factors (frame
    runs)."""

    def __init__(self, shape=None):
        self.shadow = None if shape is None else np.zeros(shape, np.uint8)
        self.report = self.final = self.view = self.rect = self.factors = None
        self.quit_turn = None
        self.turns = self.frames = self.deltas = self.flips = 0

    def loop_seconds(self) -> float:
        """Wall-clock the run spent in its dispatch loop (issue to
        resolve), from the run's own MetricsReport."""
        return self.report["histograms"]["controller.dispatch_seconds"]["sum"]

    def __call__(self, e) -> None:
        kind = type(e)
        if kind is gol.CellFlipped:
            self.shadow[e.cell.y, e.cell.x] ^= 1
            self.flips += 1
        elif kind is gol.TurnComplete:
            self.turns += 1
        elif kind is gol.TurnsCompleted:
            self.turns += e.turns
        elif kind is gol.FrameReady:
            # A copy: deltas apply in place, and the producer keeps the
            # delivered keyframe as its delta base.
            self.view = np.array(e.frame, dtype=np.uint8, copy=True)
            self.rect, self.factors = e.rect, e.factors
            self.frames += 1
        elif kind is gol.FrameDelta:
            frames.apply_bands(self.view, e.bands)
            self.rect, self.factors = e.rect, e.factors
            self.frames += 1
            self.deltas += 1
        elif (kind is gol.StateChange and e.new_state == gol.State.QUITTING
              and self.quit_turn is None):
            self.quit_turn = e.completed_turns
        elif kind is gol.MetricsReport:
            self.report = e.snapshot
        elif kind is gol.FinalTurnComplete:
            self.final = e


def stream_run(params: gol.Params, sink: Sink, keys=None, session=None):
    """One ``gol.run`` on the engine thread while this thread consumes the
    stream as it is produced, as the CLI does; returns (seconds, final PGM
    bytes or None)."""
    events = gol.EventQueue()
    t0 = time.perf_counter()
    engine = gol.start(params, events, keys, session)
    done = False
    while not done:
        for e in events.get_many(timeout=300):
            if e is None:
                done = True
                break
            sink(e)
    seconds = time.perf_counter() - t0
    engine.join(timeout=60)
    final = params.out_dir / f"{params.final_output_name}.pgm"
    return seconds, (final.read_bytes() if final.is_file() else None)


def drive(name: str, params: gol.Params, kernels: tuple, launches: dict, reference: dict,
          engine: str = "pallas-packed", keys=None, shadow=None):
    """Drive one main path through the kernels, with every launch count set
    to 0 just before and read just after, then once more with the
    ``reference`` overrides (``engine="packed"``, ``skip_stable=False``, or
    headless); the final boards and alive counts must agree, and the path
    must have run on ``engine``.  Both streams are consumed as they are
    produced (``Sink``; ``shadow`` is the board shape of a flip run).
    Returns (the kernel run's end-to-end numbers, its sink)."""
    sink = Sink(shadow)
    reset_launches()
    seconds, final = stream_run(params, sink, keys)
    counts = launch_counts()
    for k in kernels:
        launches[k] += counts[k]
    got = sink.report["info"]["backend.engine"]
    log(f"{name}: {seconds:.3f} s, launches {counts}, engine {got}")
    if got != engine:
        raise AssertionError(f"{name}: engine_used {got!r}, not {engine}")
    for k in kernels:
        if counts[k] == 0:
            raise AssertionError(f"{name}: the {k} kernel never launched")
    ref_params = dataclasses.replace(params, out_dir=params.out_dir / "reference", **reference)
    ref = Sink()
    ref_seconds, ref_final = stream_run(ref_params, ref)
    if final is None or final != ref_final or len(sink.final.alive) != len(ref.final.alive):
        raise AssertionError(f"{name}: final board differs from the {reference} run")
    log(f"{name}: final board and alive count ({len(sink.final.alive)}) equal the {reference} "
        f"run ({ref_seconds:.3f} s)")
    loop = sink.loop_seconds()
    out = dict(seconds=seconds, gens_per_s=params.turns / seconds, dispatch_loop_s=loop,
               dispatch_loop_gens_per_s=params.turns / loop if loop else None,
               launches=counts, reference=dict(
                   overrides=reference, seconds=ref_seconds, gens_per_s=params.turns / ref_seconds,
                   dispatch_loop_s=ref.loop_seconds()))
    gauges = sink.report["gauges"]
    if "backend.skip_fraction" in gauges:
        out.update(skip_fraction=gauges["backend.skip_fraction"],
                   active_stripes=gauges.get("backend.active_tiles"))
    if not params.no_vis:
        out.update(frames=sink.frames, frames_per_s=sink.frames / seconds, deltas=sink.deltas,
                   flips=sink.flips, flips_per_s=sink.flips / seconds)
        print(f"viewer path {name}: {seconds:.3f} s, {params.turns / seconds:.1f} gens/s, "
              f"{sink.frames / seconds:.1f} frames/s ({sink.frames} frames, {sink.deltas} "
              f"deltas), {sink.flips} flips, K6 launches {counts['stencil']}", flush=True)
    return out, sink


def final_board(params: gol.Params, device) -> torch.Tensor:
    return torch.from_numpy(pgm.read_pgm(params.out_dir / f"{params.final_output_name}.pgm")).to(device)


def viewer_paths(images: Path, tmp: Path, launches: dict, device) -> dict:
    """Phase 3's viewer paths: ``no_vis=False`` under ``engine="auto"``,
    which takes the byte kernel (K6) for per-turn dispatches on the card.
    Each final board must equal a headless ``engine="packed"`` rerun, and
    each stream must rebuild its final view."""
    headless = dict(engine="packed", no_vis=True)
    e2e = {}
    flips = gol.Params(turns=FLIP_TURNS, images_dir=images, out_dir=tmp / "flips", no_vis=False,
                       ticker_period=3600)
    if not flips.wants_flips():
        raise AssertionError("a 512^2 viewer run is not fed per-cell flips")
    e2e[f"flips_512x512x{FLIP_TURNS}"], sink = drive(
        f"flips 512^2 x {FLIP_TURNS}", flips, ("stencil",), launches, headless, engine="pallas",
        shadow=(512, 512))
    want = np.zeros((512, 512), np.uint8)
    for c in sink.final.alive:
        want[c.y, c.x] = 1
    if not np.array_equal(sink.shadow, want):
        raise AssertionError("the flips' shadow board differs from FinalTurnComplete.alive")
    log(f"flips: the shadow board of {sink.flips} CellFlipped events equals the final alive set")
    alive_512 = len(sink.final.alive)

    frame_p = gol.Params(turns=500, image_width=BIG, image_height=BIG, soup_density=0.3,
                         soup_seed=7, no_vis=False, out_dir=tmp / "frames", ticker_period=3600)
    if not frame_p.wants_frames():
        raise AssertionError(f"a {BIG}^2 viewer run is not fed frames")
    e2e[f"frames_{BIG}x{BIG}x500"], sink = drive(f"frames {BIG}^2 x 500", frame_p, ("stencil",),
                                                 launches, headless, engine="pallas")
    want = stencil.frame_pool(final_board(frame_p, device), *sink.factors).cpu().numpy()
    if not np.array_equal(sink.view, want):
        raise AssertionError("the last frame differs from frame_pool of the final board")
    log(f"frames: the last of {sink.frames} frames equals frame_pool{sink.factors} of the final board")

    roi = dataclasses.replace(frame_p, turns=1000, viewport=VIEWPORT, out_dir=tmp / "viewport")
    keys = KeysAfter({250: "d", 500: "+", 750: "-"})
    e2e[f"viewport_{BIG}x{BIG}x1000"], sink = drive(
        f"viewport {BIG}^2 x 1000", roi, ("stencil",), launches, headless, engine="pallas",
        keys=keys)
    crop = stencil.viewport(final_board(roi, device), *sink.rect)
    want = stencil.frame_pool(crop, *sink.factors).cpu().numpy()
    if sink.rect == VIEWPORT or not np.array_equal(sink.view, want):
        raise AssertionError(f"the viewport stream's rebuilt view at {sink.rect} differs from the "
                             "pooled crop of the final board (or the keys never moved it)")
    log(f"viewport: {sink.frames} frames ({sink.deltas} deltas) rebuild the pooled crop "
        f"{sink.factors} of the final board at the final rect {sink.rect}")
    e2e[f"cli_512x512x{FLIP_TURNS}"] = cli_path(tmp, FLIP_TURNS, alive_512)
    return e2e


def cli_run(tmp: Path, side: int, turns: int, alive: int, *extra: str):
    """``python -m distributed_gol_torch`` on the ``side``² soup (density
    0.3, seed 7), ``turns`` generations, the terminal viewer's stdout
    captured; it must exit 0 with ``alive`` in its final line.  Returns
    (seconds with process start, stdout)."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "distributed_gol_torch", "-w", str(side), "-h", str(side),
           "-turns", str(turns), "--soup", "0.3", "--soup-seed", "7", *extra]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])]))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the CLI {extra} exited {r.returncode}: {r.stderr[-3000:]}")
    last = r.stdout.splitlines()[-1]
    if last != f"Final turn {turns}: {alive} alive":
        raise AssertionError(f"the CLI ended {last!r}, not 'Final turn {turns}: {alive} alive'")
    return seconds, r.stdout


def cli_path(tmp: Path, turns: int, alive: int) -> dict:
    """The CLI as users run it — the terminal viewer in a subprocess — on
    the flips path's 512² board and depth, untraced; then, for the count
    of K6 launches a subprocess makes, one generation of a 128² soup with
    a profiler trace (``--trace``), held against the NumPy oracle."""
    seconds, stdout = cli_run(tmp, 512, turns, alive)
    trace, small = tmp / "cli_trace", 128
    small_alive = int((numpy_life(random_soup(small, small, 0.3, 7), 1, CONWAY) == 255).sum())
    traced_seconds, _ = cli_run(tmp, small, 1, small_alive, "--trace", str(trace))
    kernels = [e for e in json.loads((trace / "trace.json").read_text()).get("traceEvents", [])
               if e.get("cat") == "kernel"]
    k6 = sum("stencil_kernel" in e.get("name", "") for e in kernels)
    if k6 != 1:
        raise AssertionError(f"the CLI's trace of one generation shows {k6} K6 launches among "
                             f"{len(kernels)} kernels")
    print(f"viewer path CLI 512^2 x {turns} (terminal viewer): {seconds:.3f} s with process "
          f"start, {turns / seconds:.2f} gens/s, {len(stdout)} bytes of terminal output; "
          f"K6 launches {k6} in a traced {small}^2 x 1 run ({traced_seconds:.3f} s)", flush=True)
    return dict(seconds=seconds, gens_per_s=turns / seconds, stdout_bytes=len(stdout),
                last_line=stdout.splitlines()[-1], traced=dict(
                    side=small, turns=1, seconds=traced_seconds, k6_launches=k6))


def detach_and_resume(params: gol.Params, straight: bytes, tmp: Path) -> None:
    """'q' mid-run parks a checkpoint on a durable session; a second run
    resumes it to the straight run's final board."""
    detached = Sink()
    _, final = stream_run(params, detached, KeysAfter({3: "q"}), Session(tmp / "ckpt"))
    turn = detached.quit_turn
    if final is not None or turn is None or not 0 < turn < params.turns:
        raise AssertionError(f"detach did not land mid-run: quit at turn {turn}")
    _, final = stream_run(params, Sink(), None, Session(tmp / "ckpt"))
    if final != straight:
        raise AssertionError("the resumed run's final board differs from the straight run")
    log(f"detach at turn {turn} and resume: final board equals the straight run")


def solo_rerun(params: gol.Params, out_dir: Path) -> bytes:
    """A tenant's run outside the pod, solo on the already-built packed
    kernels (``engine="pallas-packed"``, ``skip_stable=False``): its final
    PGM is what the pod's tenant must equal."""
    ref = dataclasses.replace(params, tenant=None, engine="pallas-packed", skip_stable=False,
                              superstep=0, out_dir=out_dir)
    _, final = stream_run(ref, Sink())
    if final is None:
        raise AssertionError(f"the solo rerun of {params.tenant} wrote no final PGM")
    return final


def pod_path(name: str, shape: tuple, batched: bool, kernels: tuple, launches: dict,
             tmp: Path) -> dict:
    """One serving pod through ``ServePlane`` in process: ``shape`` =
    (tenants, side, turns, superstep) soups (density 0.3, seed 100 + i),
    every launch count set to 0 just before and read just after.  Every
    tenant must complete with the final PGM of its solo rerun; each of
    ``kernels`` must have launched; a batched pod must show no failed
    batched launch and no eviction.  Returns the pod's numbers."""
    nt, side, turns, superstep = shape
    params = [gol.Params(turns=turns, image_width=side, image_height=side, soup_density=0.3,
                         soup_seed=100 + i, superstep=superstep, turn_events="batch",
                         ticker_period=3600, out_dir=tmp / name / f"t{i}") for i in range(nt)]
    config = ServeConfig(max_sessions=nt, batched=batched, max_total_cells=nt * side * side)
    before = metrics.REGISTRY.snapshot()
    reset_launches()
    t0 = time.perf_counter()
    with ServePlane(config) as plane:
        handles = [plane.submit(f"t{i}", p) for i, p in enumerate(params)]
        if not plane.wait_idle(timeout=900):
            raise AssertionError(f"pod {name}: tenants still resident after 900 s")
        wall = time.perf_counter() - t0
        health = plane.health()
    counts = launch_counts()
    counters = metrics.REGISTRY.snapshot().delta(before).to_dict()["counters"]
    for k in kernels:
        launches[k] += counts[k]
        if counts[k] == 0:
            raise AssertionError(f"pod {name}: the {k} kernel never launched")
    for h in handles:
        if h.status != "completed":
            raise AssertionError(f"pod {name}: tenant {h.tenant} ended {h.status} ({h.error})")
    failures = counters.get("serve.batched_launch_failures", 0)
    evictions = counters.get("serve.cohort_evictions", 0)
    if failures or evictions:
        raise AssertionError(f"pod {name}: {failures} batched-launch failures, "
                             f"{evictions} cohort evictions")
    for i, (h, p) in enumerate(zip(handles, params)):
        got = (p.out_dir / f"{p.final_output_name}.pgm").read_bytes()
        if got != solo_rerun(p, tmp / name / f"solo{i}"):
            raise AssertionError(f"pod {name}: tenant {h.tenant}'s final PGM differs from its "
                                 "solo rerun")
    supersteps = -(-turns // superstep)
    rates = sorted(turns / h.duration for h in handles)
    boards, rounds = counters.get("serve.batched_boards", 0), counters.get("serve.batched_launches", 0)
    out = dict(
        tenants=nt, side=side, turns=turns, superstep=superstep, batched=batched, wall_s=wall,
        aggregate_gens_per_s=nt * turns / wall, median_tenant_gens_per_s=rates[len(rates) // 2],
        launches={k: counts[k] for k in WRAPPERS if counts[k]},
        launches_per_superstep={k: counts[k] / supersteps for k in kernels},
        batched_rounds=rounds, batched_boards=boards,
        mean_cohort_size=boards / rounds if rounds else None,
        batched_launch_failures=failures, cohort_evictions=evictions,
        batched_engine=next((k.rsplit(".", 1)[1] for k in counters
                             if k.startswith("backend.batched_dispatches.")), None),
    )
    if batched and out["batched_engine"] != "pallas-packed":
        raise AssertionError(f"pod {name}: batched engine {out['batched_engine']!r}, "
                             f"not pallas-packed ({health['batched_launches']} launches)")
    print(f"serving pod {name}: {nt} x {side}^2 x {turns}, superstep {superstep}, "
          f"batched={batched}: {wall:.3f} s, {out['aggregate_gens_per_s']:.1f} gens/s aggregate, "
          f"median tenant {out['median_tenant_gens_per_s']:.1f} gens/s, launches per superstep "
          f"{out['launches_per_superstep']}, mean cohort size {out['mean_cohort_size']}, "
          f"launches {out['launches']}", flush=True)
    return out


def serve_cli_path(tmp: Path) -> dict:
    """The ``serve`` CLI as an operator runs it, in a subprocess: 4
    tenants of 512² x 2,000, ``--batched --superstep 64``; it must exit 0
    with a receipt of every tenant completed, and each tenant's PGM must
    equal its solo rerun."""
    nt, side, turns, superstep = CLI_POD
    root = Path(__file__).resolve().parent
    names = [f"cli{i}" for i in range(nt)]
    cmd = [sys.executable, "-m", "distributed_gol_torch", "serve", "--batched",
           "--superstep", str(superstep), "--checkpoint-root", str(tmp / "pod"),
           "--max-sessions", str(nt)]
    for n in names:
        cmd += ["--tenant", f"{n}:{side}x{side}x{turns}"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])]))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the serve CLI exited {r.returncode}: {r.stderr[-3000:]}")
    receipt = json.loads(r.stdout.strip().splitlines()[-1])
    statuses = {t: v["status"] for t, v in receipt["sessions"].items()}
    if statuses != {n: "completed" for n in names}:
        raise AssertionError(f"the serve CLI's receipt: {statuses}")
    health = receipt["health"]
    if not health["batched_boards"] or health["cohort_evictions"]:
        raise AssertionError(f"the serve CLI's pod did not batch cleanly: {health}")
    for n in names:
        p = gol.Params(turns=turns, image_width=side, image_height=side, soup_density=0.3,
                       soup_seed=zlib.crc32(n.encode()) & 0x7FFFFFFF, out_dir=tmp / "rerun" / n,
                       ticker_period=3600)
        got = (tmp / "pod" / n / f"{p.final_output_name}.pgm").read_bytes()
        if got != solo_rerun(p, tmp / "rerun" / n):
            raise AssertionError(f"the serve CLI's tenant {n} differs from its solo rerun")
    print(f"serving pod CLI {nt} x {side}^2 x {turns} --batched: {seconds:.3f} s with process "
          f"start, {health['batched_launches']} batched launches carrying "
          f"{health['batched_boards']} boards", flush=True)
    return dict(seconds=seconds, tenants=nt, side=side, turns=turns,
                batched_launches=health["batched_launches"],
                batched_boards=health["batched_boards"])


def serving_paths(tmp: Path, launches: dict) -> dict:
    """Phase 3's serving paths: the K7 pod batched and unbatched, the K8
    pod, and the ``serve`` CLI."""
    e2e = {}
    nt, side, turns, step = POD_K7
    e2e[f"pod_a_{nt}x{side}^2x{turns}_batched"] = pod_path(
        "a", POD_K7, True, ("resident_batched",), launches, tmp)
    e2e[f"pod_b_{nt}x{side}^2x{turns}_solo"] = pod_path(
        "b", POD_K7, False, ("resident",), launches, tmp)
    nt, side, turns, step = POD_K8
    e2e[f"pod_c_{nt}x{side}^2x{turns}_batched"] = pod_path(
        "c", POD_K8, True, ("frontier_batched",), launches, tmp)
    e2e["serve_cli"] = serve_cli_path(tmp)
    return e2e


def profile_run(turns: int, side: int = BIG, **viewer) -> dict:
    """Where the time of a main-path run on the ``side``² soup goes: the
    seeded soup's generation on the host, then the whole run under
    ``torch.profiler`` (device time by kernel, and the device's busy share
    of the run's wall-clock), its stream consumed as it is produced.
    ``viewer`` holds the Params of a viewer path (``no_vis=False``, ...);
    without it the run is headless with batch turn events."""
    t0 = time.perf_counter()
    random_soup(side, side, 0.3, 7)
    soup_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        params = gol.Params(turns=turns, image_width=side, image_height=side, soup_density=0.3,
                            soup_seed=7, out_dir=Path(tmp), ticker_period=3600,
                            **(viewer or dict(turn_events="batch")))
        sink = Sink((side, side) if params.wants_flips() else None)
        with torch.profiler.profile(activities=acts) as prof:
            wall, _ = stream_run(params, sink)
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
        side=side, turns=turns, viewer=viewer, wall_s=wall, soup_host_s=soup_s,
        dispatch_loop_s=sink.loop_seconds(),
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


def time_batched(k8_stacks: dict, int_rate: float) -> dict:
    """K7 and K8 at the serving pods' shapes.  K7: one launch of 16 x 512²
    x 64 generations (a superstep of pod a) beside 16 sequential K1
    launches of the same boards (what the unbatched pod b launches per
    superstep), its plain version, and its bound over all 16 boards.  K8:
    one chunk of 8 launches of 4 x 4096² (a superstep of pod c) on the
    fresh and the settled stack, per launch, with the bound of the work
    that chunk's data needs (the stripes it computed, T + 6 generations
    each)."""
    nt, side, _, step = POD_K7
    v = packed.pack_vertical(soup_stack(nt, side, 61, torch.device("cuda", 0))).contiguous()
    k1_sequential = cuda_ms(lambda: [cuda_packed.resident_superstep(b, CONWAY, step)
                                     for b in v], 5)
    k7 = dict(
        ms=cuda_ms(lambda: cuda_packed.resident_superstep_batched(v, CONWAY, step), 20),
        plain_ms=cuda_ms(lambda: cuda_packed.resident_superstep_batched_plain(v, CONWAY, step), 2),
        bound=bound_ms(v.numel(), step, 1, CONWAY, int_rate),
        extra=dict(shape=[nt, side, side], gens=step, k1_sequential_ms=k1_sequential),
    )
    log(f"K7 {nt} x {side}^2 x {step} gens: {k7['ms']:.4f} ms in one launch, {nt} x K1 "
        f"{k1_sequential:.4f} ms, plain {k7['plain_ms']:.3f} ms, bound "
        f"{k7['bound'][0]:.5f} ms by {k7['bound'][1]}")
    nb, side = POD_K8[0], POD_K8[1]
    plan = cuda_adaptive.adaptive_plan((side, side // 32), 10**6)
    grid = plan.grid(side)
    stripe_words = plan.stripe_h * side // 32
    rows = {}
    for name, st in k8_stacks.items():
        _, sk, _ = cuda_adaptive.frontier_superstep_batched(st, CONWAY, plan, 8)
        computed = (8 * nb * grid - int(sk.sum())) / 8
        b_ms, b_by = work_bound_ms(computed * stripe_words, computed * stripe_words,
                                   plan.t + 6, CONWAY, int_rate)
        rows[name] = dict(
            ms=cuda_ms(lambda: cuda_adaptive.frontier_superstep_batched(st, CONWAY, plan, 8), 3) / 8,
            plain_ms=cuda_ms(lambda: cuda_adaptive.frontier_superstep_batched_mirror(
                st, CONWAY, plan, 8), 1) / 8,
            computed_stripes_per_launch=computed, bound_ms=b_ms, bound_by=b_by)
        log(f"K8 {nb} x {side}^2, {plan}, {name}: {rows[name]['ms']:.4f} ms per launch "
            f"(plain {rows[name]['plain_ms']:.3f}, bound {b_ms:.4f} by {b_by}, "
            f"{computed:.2f} of {nb * grid} stripes computed)")
    fresh = rows["fresh"]
    k8 = dict(ms=fresh["ms"], plain_ms=fresh["plain_ms"],
              bound=(fresh["bound_ms"], fresh["bound_by"]),
              extra=dict(board="fresh", shape=[nb, side, side], plan=dataclasses.asdict(plan),
                         per_board=rows))
    return {"resident_batched": k7, "frontier_batched": k8}


def host_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean ms of ``fn()`` on the host clock, after a warm-up call unless
    ``warm`` is False; ``fn`` ends in a host copy, which waits for the
    device."""
    if warm:
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def time_viewer_turn(b: torch.Tensor) -> dict:
    """Where one per-turn viewer dispatch of the 16384² board ``b`` goes:
    each device part (CUDA events), each host copy (host clock), and each
    Backend viewer method whole (host clock: step + view + count +
    bit-pack + copies + the host's unpacking)."""
    be = Backend(gol.Params(image_width=BIG, image_height=BIG, no_vis=False, engine="pallas"))
    nb = be._device_superstep(b, 1)
    fy, fx = be.params.frame_factors()
    y0, x0, vh, vw = VIEWPORT
    vfy, vfx = be.params.factors_for(vh, vw)
    pooled, mask = stencil.frame_pool(nb, fy, fx), stencil.flip_mask(b, nb)
    count, frame_bits, mask_bits = (stencil.alive_count(nb), stencil.packbits(pooled),
                                    stencil.packbits(mask))
    out = dict(
        frame_factors=[fy, fx], viewport=list(VIEWPORT), viewport_factors=[vfy, vfx],
        step_ms=cuda_ms(lambda: be._device_superstep(b, 1), 20),
        alive_count_ms=cuda_ms(lambda: stencil.alive_count(nb), 20),
        frame_pool_ms=cuda_ms(lambda: stencil.frame_pool(nb, fy, fx), 20),
        packbits_frame_ms=cuda_ms(lambda: stencil.packbits(pooled), 20),
        viewport_pool_ms=cuda_ms(
            lambda: stencil.frame_pool(stencil.viewport(nb, y0, x0, vh, vw), vfy, vfx), 20),
        flip_mask_ms=cuda_ms(lambda: stencil.flip_mask(b, nb), 20),
        packbits_mask_ms=cuda_ms(lambda: stencil.packbits(mask), 5),
        count_copy_ms=host_ms(lambda: count.cpu(), 50),
        frame_bits_copy_ms=host_ms(lambda: frame_bits.cpu(), 50),
        mask_bits_copy_ms=host_ms(lambda: mask_bits.cpu(), 5),
        run_turn_with_frame_ms=host_ms(lambda: be.run_turn_with_frame(b, fy, fx), 10),
        run_turn_with_viewport_ms=host_ms(
            lambda: be.run_turn_with_viewport(b, VIEWPORT, vfy, vfx), 10),
        # Its parts are warm already, and one call unpacks the flips of a
        # whole fresh soup on the host.
        run_turn_with_flips_ms=host_ms(lambda: be.run_turn_with_flips(b), 1, warm=False),
    )
    log(f"a viewer turn at {BIG}^2: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items() if k.endswith("_ms")))
    return out


def k6_witnesses(b: torch.Tensor, wrap_free_lib: Path) -> dict:
    """Two witnesses of what limits K6 on the 16384² board ``b``, each
    timed with CUDA events beside K6 itself: a byte copy of the board
    (``out.copy_(b)``: the same 2·H·W bytes, no arithmetic), and K6 built
    with ``wrap`` free of ``%`` (``build_kernels``), held bit for bit
    against K6's plain version first."""
    lib = ctypes.CDLL(str(wrap_free_lib))
    h, w = b.shape
    born, surv = cuda_packed.rule_masks(CONWAY)
    out = torch.empty_like(b)

    def wrap_free():
        err = lib.gol_stencil_launch(ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                                     h, w, ctypes.c_uint(born), ctypes.c_uint(surv),
                                     cuda_packed._stream(b))
        if err:
            raise RuntimeError(f"the wrap-free K6 launch failed: cudaError {err}")

    wrap_free()
    torch.cuda.synchronize()
    if not torch.equal(out, cuda_stencil.stencil_step_plain(b, CONWAY)):
        raise AssertionError("the wrap-free K6 differs from K6's plain version at 16384^2")
    k6_out = torch.empty_like(b)
    res = dict(
        shape=[h, w],
        k6_ms=cuda_ms(lambda: cuda_stencil.stencil_step(b, CONWAY, out=k6_out), 50),
        wrap_free_k6_ms=cuda_ms(wrap_free, 50),
        copy_ms=cuda_ms(lambda: out.copy_(b), 50),
    )
    res["copy_bytes_per_s"] = 2 * h * w / (res["copy_ms"] / 1e3)
    res["k6_bytes_per_s"] = 2 * h * w / (res["k6_ms"] / 1e3)
    log(f"K6 witnesses at {h}x{w}: K6 {res['k6_ms']:.4f} ms, wrap-free K6 "
        f"{res['wrap_free_k6_ms']:.4f} ms, byte copy {res['copy_ms']:.4f} ms "
        f"({res['copy_bytes_per_s'] / 1e12:.3f} TB/s; K6 {res['k6_bytes_per_s'] / 1e12:.3f} TB/s)")
    return res


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
            sink = Sink()
            seconds, _ = stream_run(params, sink)
            loop = sink.loop_seconds()
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
    started = time.perf_counter()
    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 1: build every kernel from source, in parallel (and the
    # wrap-free K6 of phase 4's witness).
    t0 = time.perf_counter()
    wrap_free = build_kernels()
    log(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for k in cuda_build.KERNELS:
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
    check_stencil(device, errs)
    check_resident_batched(device, errs)
    k8_stacks = check_frontier_batched(device, errs)

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
                                            launches, packed_ref)[0]}
        big = gol.Params(turns=2000, image_width=BIG, image_height=BIG, soup_density=0.3,
                         soup_seed=7, turn_events="batch", out_dir=tmp / "big",
                         ticker_period=3600)
        e2e[f"soup_{BIG}x{BIG}x2000"] = drive(f"{BIG}^2 x 2000", big, ("tiled",), launches,
                                              packed_ref)[0]
        straight = (big.out_dir / f"{big.final_output_name}.pgm").read_bytes()
        detach_and_resume(dataclasses.replace(big, out_dir=tmp / "detach"), straight, tmp)
        long = dataclasses.replace(big, turns=LONG_TURNS, out_dir=tmp / "long")
        if not long.skip_stable_requested():
            raise AssertionError("auto skip_stable does not engage at the long run")
        e2e[f"soup_{BIG}x{BIG}x{LONG_TURNS}"] = run_long = drive(
            f"{BIG}^2 x {LONG_TURNS}", long, ADAPTIVE, launches, dict(skip_stable=False))[0]
        if run_long.get("skip_fraction") is None:
            raise AssertionError("skip_fraction() is None at the end of the long run")
        log(f"{BIG}^2 x {LONG_TURNS}: {run_long['gens_per_s']:.1f} gens/s run, "
            f"{run_long['dispatch_loop_gens_per_s']:.1f} gens/s dispatch loop, final skip "
            f"fraction {run_long['skip_fraction']}, launches {run_long['launches']}")
        e2e.update(viewer_paths(images, tmp, launches, device))
        e2e.update(serving_paths(tmp, launches))

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
    # K6 at the viewer paths' shapes, one generation a launch into a
    # preallocated buffer (as a superstep's ping-pong does); 16384² leads.
    k6, soups = {}, {n: board(n, n, 23, device) for n in (BIG, 512)}
    for n, b in soups.items():
        out = torch.empty((n, n), dtype=torch.uint8, device=device)
        k6[n] = dict(ms=cuda_ms(lambda: cuda_stencil.stencil_step(b, CONWAY, out=out), 50),
                     plain_ms=cuda_ms(lambda: cuda_stencil.stencil_step_plain(b, CONWAY), 5),
                     bound=stencil_bound_ms(n, n, int_rate))
    timings["stencil"] = dict(k6[BIG], extra=dict(shape=[BIG, BIG], at_512=dict(
        ms=k6[512]["ms"], plain_ms=k6[512]["plain_ms"], bound_ms=k6[512]["bound"][0],
        bound_by=k6[512]["bound"][1])))
    log(f"timed K1 at 512^2 x 50 gens (one launch), K2 at {BIG}^2 x {t_big} gens "
        f"(one launch), K6 one generation at {BIG}^2 ({k6[BIG]['ms']:.4f} ms, bound "
        f"{k6[BIG]['bound'][0]:.4f} by {k6[BIG]['bound'][1]}) and 512^2 ({k6[512]['ms']:.4f} ms); "
        f"int32 rate {int_rate / 1e12:.2f} Tops/s ({sms} SMs, {clock_mhz} MHz); card {card}")
    timings.update(time_batched(k8_stacks, int_rate))
    witness = k6_witnesses(soups[BIG], wrap_free)
    e2e[f"viewer_turn_{BIG}"] = time_viewer_turn(soups[BIG])
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
    print(json.dumps({"k6_witness": witness, "card": card}))
    if "--sweep" in sys.argv[1:]:
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
            print(json.dumps({"sweep": sweep(boards, Path(tmp)), "card": card}))
    if "--profile" in sys.argv[1:]:
        runs = [(2000, BIG, {}), (LONG_TURNS, BIG, {}), (FLIP_TURNS, 512, dict(no_vis=False)),
                (500, BIG, dict(no_vis=False)), (1000, BIG, dict(no_vis=False, viewport=VIEWPORT))]
        for turns, side, viewer in runs:
            print(json.dumps({"profile": profile_run(turns, side, **viewer), "card": card}))
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, kernel builds included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
