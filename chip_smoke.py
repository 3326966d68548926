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
``engine="pallas-packed"`` rerun.  Then the sharded paths on virtual
meshes of the one card (``Backend(params, devices=[cuda:0] * n)``): the
16384² soup x 2,000 on (4, 1) (plus a 'q'-detach and resume) and on
(2, 2), the default 512² x 100 on (8, 1), each under ``auto`` on K9 and
equal to its single-device run, and ``engine="packed"`` on (2, 1) at
4096² x 100, equal to a single-device rerun without a K9 launch.  Then
the ``skip_stable`` runs on row meshes (the adaptive strip tier, K10-K12,
first held bit for bit against their plain versions on (4, 1) strips of
the 16384² soup, skip counts and activity too, and K10 and K9 on path
(f)'s (8, 1) strips at every depth that path launches): (e) the 16384² soup x
100,000 on (4, 1) under auto (K12, with K10 and K9 for the remainders),
equal to the single-device 100,000-turn PGM; (f) 520 x 512 x 3,000 on
(8, 1), whose strips have no adaptive plan (K10 on every launch), equal to
a single-device rerun; (g) the soup x 2,000 on (4, 1) at a stripe cap of
16 (K11), equal to the single-device 2,000-turn PGM.  Then the
``skip_stable`` runs on 2-D meshes (the adaptive tile tier, K13 and K10
at xpad > 0, first held bit for bit against their plain versions on
(2, 2) and (2, 4) tiles of the 16384² soup, fresh, settled and with
gliders across the seams and a corner, skip counts and activity grids
too, and K10 and K9 on path (i)'s (4, 2) tiles at every depth that path
launches): (h) the 16384² soup x 100,000 on (2, 2) under auto (K13, with
K10 and K9 for the remainders), equal to the single-device 100,000-turn
PGM, and again with ``skip_stable=False`` (K9 alone); (i) 520 x 1024 x
3,000 on (4, 2), whose tiles have no adaptive plan (K10 at xpad 1 on
every launch), equal to a single-device rerun; (j) the soup x 2,000 on
(2, 4) at a stripe cap of 16 (K13), equal to the single-device
2,000-turn PGM.  It
checks that every kernel of each path launched in it, times every kernel
against its plain version and its bound (and a viewer turn's parts at
16384², K6 beside a byte copy of the board and beside a build of K6
without the modulo in its ring index, K7 beside 16 sequential K1
launches, and K9 on a (4, 1) strip and a (2, 2) tile beside K2 on the
whole board and beside the halo exchange, K10-K12 on a (4, 1) strip
and K13 and K10 on a (2, 2) tile beside their plain versions), and
prints one
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  ``--profile`` adds a
``torch.profiler`` breakdown of the two headless 16384² runs, of the
three viewer paths, of the sharded (4, 1) run and of paths (e) and (h)
(with the exchange's memcpy time per launch); ``--sweep`` times the adaptive tier over launch
depths and stripe heights (the sweep that chose
``cuda_adaptive.ADAPTIVE_T`` and ``SKIP_TILE_CAP``).  Every phase raises
on failure; without a CUDA GPU it exits non-zero before printing any
result.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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
from distributed_gol_torch.parallel import cuda_halo, halo, mesh as mesh_lib
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
    "ext": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/ext.cu",
        replaces="distributed_gol_tpu/parallel/pallas_halo.py:149 _ext_kernel",
    ),
    "ext_skip": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/ext.cu",
        replaces="distributed_gol_tpu/parallel/pallas_halo.py:149 _ext_kernel (skip_stable=True form)",
    ),
    "strip_probing": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/probing.cu",
        replaces="distributed_gol_tpu/parallel/pallas_halo.py:181 _ext_kernel_adaptive",
    ),
    "strip_frontier": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/frontier.cu",
        replaces="distributed_gol_tpu/parallel/pallas_halo.py:287 _ext_kernel_frontier",
    ),
    "tile_probing": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/probing.cu",
        replaces="distributed_gol_tpu/parallel/pallas_halo.py:1104 _ext_kernel_adaptive_2d",
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
    "ext": cuda_halo.ext_launch,
    "ext_skip": cuda_halo.ext_skip_launch,
    "strip_probing": cuda_halo.strip_probing_launch,
    "strip_frontier": cuda_halo.strip_frontier_launch,
    "tile_probing": cuda_halo.tile_probing_launch,
}
ADAPTIVE = ("tiled_skip", "probing", "frontier")
STRIPS = ("ext_skip", "strip_probing", "strip_frontier")
HALO = ("ext", *STRIPS, "tile_probing")  # the sharded drivers' kernels
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
# The sharded runs' meshes, virtual on the one card: (a) the 16384² soup
# on row strips, (b) on 2-D tiles, (c) the default 512² run, (d) the
# packed word-halo engine at 4096².
MESH_A, MESH_B, MESH_C, MESH_D = (4, 1), (2, 2), (8, 1), (2, 1)
PACKED_SIDE = 4096
# The skip_stable runs on row meshes: (e) the 16384² soup x 100,000 on
# (4, 1) under auto (K12, the remainders on K10 and K9); (f) 520 x 512 x
# 3,000 on (8, 1), whose 65-row strips have no multiple-of-8 stripe and so
# no adaptive plan (K10 carries every full launch; a 512² board's 64-row
# strips host a frontier plan at the port's plan); (g) the soup x 2,000 on
# (4, 1) at a stripe cap of 16, which leaves a strip 16-row stripes, T =
# 12 and no frontier plan (K11).
MESH_E, MESH_F = (4, 1), (8, 1)
PLAN_LESS = (520, 512, 3_000)
PROBE_CAP = 16
# The skip_stable runs on 2-D meshes: (h) the 16384² soup x 100,000 on
# (2, 2) under auto (K13, the remainders on K10 and K9 at xpad 1); (i) 520
# x 1024 x 3,000 on (4, 2), whose 130-row tiles have no multiple-of-8
# stripe (K10 at xpad 1 on every launch, no K13); (j) the soup x 2,000 on
# (2, 4) at ``PROBE_CAP`` (16-row stripes, T = 12: K13).
MESH_H, MESH_I, MESH_J = (2, 2), (4, 2), (2, 4)
TILE_PLAN_LESS = (520, 1024, 3_000)


def virtual(mesh_shape: tuple, device) -> list:
    """A virtual mesh's device list: every shard on ``device``."""
    return [device] * (mesh_shape[0] * mesh_shape[1])


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


def larger_ms(t_bytes: float, t_ops: float):
    """(ms, "bytes" or "operations"): the larger of a byte time and an
    operation time in seconds, and which it is."""
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def bound_ms(words: int, gens: int, launches: int, rule: LifeRule, int_rate: float):
    """The least time the card could take: the larger of the bytes (one
    read and one write of the packed board per launch) over the memory
    rate and the instructions (``ops_per_word``) over the int32 rate."""
    return larger_ms(launches * 2 * words * 4 / HBM_BYTES_PER_S,
                     words * gens * ops_per_word(rule) / int_rate)


def ext_bound_ms(strip: tuple[int, int], t: int, pad: int, xpad: int, rule: LifeRule,
                 int_rate: float, share: float = 1.0):
    """K9's least time for one T-generation launch on an (h_loc, wpl)
    centre: only the centre's light cone is work.  Generation k (1..T)
    needs the centre plus T - k rows on each side and, on a 2-D mesh
    (``xpad`` > 0), ceil((T - k) / 32) words on each side (a row mesh's
    columns wrap: wpl words); ``ops_per_word`` instructions a word over the
    int32 rate, scaled by the ``share`` of the centre that must compute
    (K10: ``k10_share``), against one read of the (h_loc + 2·pad,
    wpl + 2·xpad) extended block and one write of the centre over the
    memory rate."""
    h_loc, wpl = strip
    words = sum((h_loc + 2 * (t - k)) * (wpl + (2 * -(-(t - k) // 32) if xpad else 0))
                for k in range(1, t + 1))
    moved = (h_loc + 2 * pad) * (wpl + 2 * xpad) + h_loc * wpl
    return larger_ms(moved * 4 / HBM_BYTES_PER_S, share * words * ops_per_word(rule) / int_rate)


def k10_share(ext: torch.Tensor, strip: tuple[int, int], t: int, xpad: int):
    """(share, stable tiles) of a K10 launch of ``t`` generations on the
    extended block ``ext`` of an (h_loc, wpl) centre: the centre words of
    K10's own tiles whose skip proof fails (``ext_skip_stable_tiles``, the
    kernel's arithmetic in PyTorch) over all the centre's words, and the
    (tile rows, tile columns) grid of 1 where the proof holds."""
    stable = cuda_halo.ext_skip_stable_tiles(ext, CONWAY, t, t, xpad).cpu()
    tiles = cuda_halo.ext_tiles(strip, t)
    h_loc, wpl = strip
    rows = torch.tensor([min(tiles.tile_h, h_loc - i * tiles.tile_h)
                         for i in range(stable.shape[0])])
    cols = torch.tensor([min(tiles.tile_w, wpl - j * tiles.tile_w)
                         for j in range(stable.shape[1])])
    share = int((rows[:, None] * cols[None, :])[~stable].sum()) / (h_loc * wpl)
    return share, stable.int().tolist()


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
    return larger_ms(2 * h * w / HBM_BYTES_PER_S, h * w * STENCIL_OPS_PER_CELL / int_rate)


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
    cuda_halo.reset_launches()


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


def check_ext(device, errs: dict) -> dict:
    """K9 against its plain version, tolerance 0, at the sharded runs'
    shapes: the 16384² soup (density 0.3, seed 7) split (4, 1) and (2, 2)
    on a virtual mesh, every shard's extended block through one full launch
    and one remainder launch, under both rules; then the whole sharded
    superstep (two full launches and a remainder) against K2 on the whole
    board.  Returns each mesh's (sharded board, full-launch plan)."""
    p = packed.pack(board(BIG, BIG, 7, device))
    cases = {}
    for mesh_shape in (MESH_A, MESH_B):
        m = mesh_lib.make_mesh(mesh_shape, virtual(mesh_shape, device))
        sb = halo.board_sharding(m).shard(p)
        full = cuda_halo.launch_plan(sb.shard_shape, mesh_shape, 10**6)[0]
        rem = cuda_halo.launch_plan(sb.shard_shape, mesh_shape, full.t + 13)[-1]
        for plan in (full, rem):
            exts = [e for row in halo.extend(sb, plan.pad, plan.xpad) for e in row]
            for rule in RULES:
                for e in exts:
                    got = cuda_halo.ext_launch(e, rule, plan.t, plan.pad, plan.xpad)
                    want = cuda_halo.ext_launch_plain(e, rule, plan.t, plan.pad, plan.xpad)
                    torch.cuda.synchronize()
                    errs["ext"] = max(errs["ext"], max_abs_err(got, want))
                    if not torch.equal(got, want):
                        raise AssertionError(f"K9 != plain on {mesh_shape}, {plan}, {rule.notation}")
                log(f"K9 {mesh_shape} shards {sb.shard_shape} x {plan.t} (pad {plan.pad}, xpad "
                    f"{plan.xpad}, {plan.tiles}, grid {plan.grid(sb.shard_shape)}) "
                    f"{rule.notation}: identical on all {len(exts)} shards")
        turns = 2 * full.t + 13
        got = cuda_halo.make_superstep(m, CONWAY)(sb, turns).gather()
        if not torch.equal(got, cuda_packed.tiled_superstep(p, CONWAY, turns)):
            raise AssertionError(f"the sharded superstep on {mesh_shape} differs from K2")
        log(f"sharded superstep {mesh_shape} x {turns}: equals K2 on the whole board")
        cases[mesh_shape] = (sb, full)
    return cases


def seam_gliders(p: torch.Tensor) -> torch.Tensor:
    """``p`` with a glider ORed in just above each strip seam of a (4, 1)
    split and above the torus wrap, heading down across it."""
    b = packed.unpack(p).cpu().numpy()
    glider = np.array([[0, 255, 0], [0, 0, 255], [255, 255, 255]], dtype=np.uint8)
    for k in range(1, MESH_E[0] + 1):
        y, x = k * BIG // MESH_E[0] - 5, k * BIG // 8
        b[y - 3 : y + 6, x - 3 : x + 6] = 0
        b[y : y + 3, x : x + 3] |= glider
    return packed.pack(torch.from_numpy(b).to(p.device))


def check_strip_launches(sb, rule: LifeRule, errs: dict, plans, name: str) -> None:
    """K12 and K11 against their plain versions launch by launch: three
    launches of each on the four strips of ``sb`` (both parities), each
    launch's strip and its K12 state (row intervals and computed flags) or
    K11 bitmap recorded and compared, tolerance 0."""
    strips = [row[0] for row in sb.shards]
    for plan, kernel, seq in ((plans[0], "strip_frontier", cuda_halo.frontier_launches),
                              (plans[1], "strip_probing", cuda_halo.probing_launches)):
        runs = []
        for fn in (WRAPPERS[kernel], getattr(cuda_halo, f"{kernel}_launch_plain")):
            seen = []

            def record(*args, _fn=fn, _seen=seen):
                out = _fn(*args)
                flags = args[5].cur if isinstance(args[5], cuda_halo.FrontierState) else args[5]
                _seen.append((out.clone(), flags.clone()))
                return out

            seq(strips, rule, plan, 3, record)
            runs.append(seen)
        torch.cuda.synchronize()
        for (board, flags), (want_board, want_flags) in zip(*runs):
            err = max(max_abs_err(board, want_board), max_abs_err(flags, want_flags))
            errs[kernel] = max(errs[kernel], err)
            if err:
                raise AssertionError(f"{kernel} != plain launch by launch ({plan}) on the {name} "
                                     f"strips under {rule.notation}")
    log(f"K12 and K11 x 3 launches on the 4 {name} strips {rule.notation}: identical strips, "
        f"intervals and bitmaps at every launch")


@contextlib.contextmanager
def plain_strip_kernels():
    """The sharded tiers' five wrappers (K9-K13) replaced by their plain
    versions while the block runs: a whole ``make_superstep`` dispatch on
    the card through no kernel, the yardstick of the dispatch check."""
    names = ("ext_launch", "ext_skip_launch", "strip_probing_launch", "strip_frontier_launch",
             "tile_probing_launch")
    saved = {n: getattr(cuda_halo, n) for n in names}
    for n in names:
        setattr(cuda_halo, n, getattr(cuda_halo, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cuda_halo, n, fn)


def check_strips(device, errs: dict, boards: dict) -> dict:
    """K10, K11 and K12 against their plain versions, tolerance 0, on the
    16384² soup split (4, 1) on a virtual mesh: fresh, settled (after
    ``LONG_TURNS`` generations) and settled with a glider crossing each
    strip seam.  Whole ``skip_stable`` dispatches of the strip tier, both
    rules: 9·t - 5 turns at the port's plan (8 K12 launches a strip, so
    both launch parities, then a K10 remainder of t - 6 and a K9 of 1) and
    4·t - 5 at ``PROBE_CAP`` (3 K11 launches a strip), each against the
    same dispatch through the plain versions on the card
    (``plain_strip_kernels``): boards, skip counts and activity;
    then K12 and K11 launch by launch (``check_strip_launches``), and K10
    alone at depths 6 to 30 on every strip's extended block.
    Returns the sharded boards (phase 4 times them)."""
    m = mesh_lib.make_mesh(MESH_E, virtual(MESH_E, device))
    sharding = halo.board_sharding(m)
    strip = (BIG // MESH_E[0], BIG // 32)
    fplan = cuda_halo.adaptive_strip_plan(strip, 10**6)
    pplan = cuda_halo.adaptive_strip_plan(strip, 10**6, PROBE_CAP)
    if not fplan.frontier or pplan.frontier:
        raise AssertionError(f"strip plans {fplan}, {pplan}: not a frontier and a probing plan")
    cases = {name: sharding.shard(p) for name, p in (
        ("fresh", boards["fresh"]), ("settled", boards["settled"]),
        ("seam", seam_gliders(boards["settled"])))}
    for rule in RULES:
        for name, sb in cases.items():
            for plan, cap, kernel, n in ((fplan, 0, "strip_frontier", 8),
                                         (pplan, PROBE_CAP, "strip_probing", 3)):
                turns = plan.t * (n + 1) - 5  # n full launches, then K10 and K9
                reset_launches()
                got, sk, act = cuda_halo.make_superstep(m, rule, True, cap, True)(sb, turns)
                torch.cuda.synchronize()
                counts = {k: WRAPPERS[k].launches for k in (kernel, "ext_skip", "ext")}
                want_counts = {kernel: 4 * n, "ext_skip": 4, "ext": 4}
                if counts != want_counts:
                    raise AssertionError(f"strip dispatch launched {counts}, not {want_counts}")
                with plain_strip_kernels():
                    want, wsk, wact = cuda_halo.make_superstep(m, rule, True, cap, True)(
                        sb, turns)
                torch.cuda.synchronize()
                err = max(max_abs_err(a, b) for a, b in zip(got.flat, want.flat))
                for k in (kernel, "ext_skip", "ext"):
                    errs[k] = max(errs[k], err)
                if err or int(sk) != int(wsk) or not torch.equal(act, wact):
                    raise AssertionError(f"strip dispatch != plain ({plan}) on the {name} board "
                                         f"under {rule.notation}: skipped {int(sk)} vs {int(wsk)}")
                total = cuda_halo.adaptive_strip_launches((BIG, BIG // 32), MESH_E, turns, cap)
                log(f"K{12 if plan.frontier else 11}+K10+K9 {MESH_E} {BIG}^2 x {turns} ({plan}) "
                    f"{name} {rule.notation}: identical, skipped {int(sk)} of {total}, "
                    f"active stripes {int((act > 0).sum())}")
            check_strip_launches(sb, rule, errs, (fplan, pplan), name)
            for t in (6, 12, 18, 24, 30):
                for e in (e for row in halo.extend(sb, t, 0) for e in row):
                    got = cuda_halo.ext_skip_launch(e, rule, t, t, 0)
                    want = cuda_halo.ext_skip_launch_plain(e, rule, t, t, 0)
                    errs["ext_skip"] = max(errs["ext_skip"], max_abs_err(got, want))
                    if not torch.equal(got, want):
                        raise AssertionError(f"K10 != plain at {t} turns, {name}, {rule.notation}")
            log(f"K10 x {{6, 12, 18, 24, 30}} on the 4 {name} strips {rule.notation}: identical")
    return cases


def check_plan_less(device, errs: dict, dims: tuple, mesh_shape: tuple, tag: str
                    ) -> halo.ShardedBoard:
    """K10 and K9 against their plain versions, tolerance 0, at the shapes
    of path (f) (``PLAN_LESS`` on ``MESH_F``) or (i) (``TILE_PLAN_LESS`` on
    ``MESH_I``): the soup of ``dims`` split ``mesh_shape`` on a virtual
    mesh, fresh and after the path's turns, both rules, on every shard's
    extended block at each depth the path launches: K10 from 6 to the full
    launches' T (``skip_launch_depth``) in steps of 6 (the full launches
    of shorter dispatches and the rem6 remainders), K9 from 1 to 5 (the
    remainders' tail), each with the path's x-halo (ceil(T / 32) words on
    a 2-D mesh, none on a row mesh).  Returns the fresh sharded board
    (phase 4 times K10 on it)."""
    h, w, turns = dims
    m = mesh_lib.make_mesh(mesh_shape, virtual(mesh_shape, device))
    shard = (h // mesh_shape[0], w // 32 // mesh_shape[1])
    two_d = mesh_shape[1] > 1
    t_full, skip = cuda_halo.skip_launch_depth(shard, turns)
    plan = (cuda_halo.adaptive_tile_plan if two_d else cuda_halo.adaptive_strip_plan)(shard, turns)
    if plan is not None or not skip:
        raise AssertionError(f"path ({tag})'s {shard} shards have an adaptive plan or no K10 launch")
    fresh = halo.board_sharding(m).shard(packed.pack(board(h, w, 7, device)))
    cases = {"fresh": fresh, "settled": cuda_halo.make_superstep(m, CONWAY, True)(fresh, turns)}
    depths = [(t, cuda_halo.ext_launch, cuda_halo.ext_launch_plain, "ext") for t in range(1, 6)]
    depths += [(t, cuda_halo.ext_skip_launch, cuda_halo.ext_skip_launch_plain, "ext_skip")
               for t in range(6, t_full + 1, 6)]
    for rule in RULES:
        for name, sb in cases.items():
            for t, fn, plain, k in depths:
                xpad = -(-t // 32) if two_d else 0
                for e in (e for row in halo.extend(sb, t, xpad) for e in row):
                    got, want = fn(e, rule, t, t, xpad), plain(e, rule, t, t, xpad)
                    errs[k] = max(errs[k], max_abs_err(got, want))
                    if not torch.equal(got, want):
                        raise AssertionError(f"{k} != plain at {t} turns (xpad {xpad}) on path "
                                             f"({tag})'s {name} shards under {rule.notation}")
            log(f"K10 x {{6..{t_full}}} and K9 x {{1..5}} on the {mesh_shape} {name} "
                f"{shard[0]}x{shard[1]}-word shards of {h}x{w} {rule.notation}: identical")
    return fresh


def tile_seam_gliders(p: torch.Tensor) -> torch.Tensor:
    """``p`` with gliders ORed in on the seams of a (2, 2) split, each
    heading down and right across it: one across the row seam, one across
    the column seam, one across the corner where the four tiles meet, and
    one across the torus corner."""
    b = packed.unpack(p).cpu().numpy()
    glider = np.array([[0, 255, 0], [0, 0, 255], [255, 255, 255]], dtype=np.uint8)
    half = BIG // 2
    for y, x in ((half - 5, BIG // 4), (BIG // 4, half - 5), (half - 5, half - 5),
                 (BIG - 5, BIG - 5)):
        b[y - 3 : y + 6, x - 3 : x + 6] = 0
        b[y : y + 3, x : x + 3] |= glider
    return packed.pack(torch.from_numpy(b).to(p.device))


def check_tile_launches(sb, rule: LifeRule, errs: dict, plan, xpad: int, name: str) -> None:
    """K13 against its plain version launch by launch: three launches on
    every tile of ``sb`` (both parities of the buffer), each launch's tile
    and stable flags recorded and compared, tolerance 0."""
    runs = []
    for fn in (WRAPPERS["tile_probing"], cuda_halo.tile_probing_launch_plain):
        seen = []

        def record(*args, _fn=fn, _seen=seen):
            out = _fn(*args)
            _seen.append((out.clone(), args[3].clone()))
            return out

        cuda_halo.tile_probing_launches(sb, rule, plan, xpad, 3, record)
        runs.append(seen)
    torch.cuda.synchronize()
    for (tile, flags), (want_tile, want_flags) in zip(*runs):
        err = max(max_abs_err(tile, want_tile), max_abs_err(flags, want_flags))
        errs["tile_probing"] = max(errs["tile_probing"], err)
        if err:
            raise AssertionError(f"K13 != plain launch by launch ({plan}) on the {name} tiles "
                                 f"under {rule.notation}")


def check_tiles(device, errs: dict, boards: dict) -> dict:
    """K13 and K10 at xpad > 0 against their plain versions, tolerance 0,
    on the 16384² soup split ``MESH_H`` (paths (h) and (j)'s shapes split
    ``MESH_J`` too) on a virtual mesh: fresh, settled (after
    ``LONG_TURNS`` generations) and settled with gliders across the row
    seam, the column seam and a corner (``tile_seam_gliders``).  Whole
    ``skip_stable`` dispatches of the tile tier, both rules: on
    ``MESH_H`` 9·t - 5 turns at the port's plan (8 K13 launches a tile,
    both parities of the buffer, then a K10 remainder of t - 6 and a K9
    of 1, at xpad 1), and on both meshes 4·t - 5 at ``PROBE_CAP`` (3 K13
    launches a tile, then K10 at 6 and K9 at 1), each against the same
    dispatch through the plain versions on the card: boards, skip counts
    and (stripe, x-tile) activity; then K13 launch by launch
    (``check_tile_launches``), and on ``MESH_H`` K10 alone at depths 6 to
    30 on every tile's extended block (pad = T, xpad = ceil(T / 32)).
    Returns the ``MESH_H`` sharded boards (phase 4 times them)."""
    boards = {"fresh": boards["fresh"], "settled": boards["settled"],
              "seam": tile_seam_gliders(boards["settled"])}
    sharded = {}
    for mesh_shape, caps in ((MESH_H, (0, PROBE_CAP)), (MESH_J, (PROBE_CAP,))):
        m = mesh_lib.make_mesh(mesh_shape, virtual(mesh_shape, device))
        sharding = halo.board_sharding(m)
        ntiles = mesh_shape[0] * mesh_shape[1]
        tile = (BIG // mesh_shape[0], BIG // 32 // mesh_shape[1])
        plans = [cuda_halo.adaptive_tile_plan(tile, 10**6, cap) + (cap,) for cap in caps]
        cases = {name: sharding.shard(p) for name, p in boards.items()}
        for rule in RULES:
            for name, sb in cases.items():
                for plan, xpad, cap in plans:
                    n = 8 if cap == 0 else 3
                    turns = plan.t * (n + 1) - 5  # n full launches, then K10 and K9
                    reset_launches()
                    got, sk, act = cuda_halo.make_superstep(m, rule, True, cap, True)(sb, turns)
                    torch.cuda.synchronize()
                    counts = {k: WRAPPERS[k].launches for k in ("tile_probing", "ext_skip", "ext")}
                    want_counts = {"tile_probing": ntiles * n, "ext_skip": ntiles, "ext": ntiles}
                    if counts != want_counts:
                        raise AssertionError(f"tile dispatch launched {counts}, not {want_counts}")
                    with plain_strip_kernels():
                        want, wsk, wact = cuda_halo.make_superstep(m, rule, True, cap, True)(
                            sb, turns)
                    torch.cuda.synchronize()
                    err = max(max_abs_err(a, b) for a, b in zip(got.flat, want.flat))
                    for k in ("tile_probing", "ext_skip", "ext"):
                        errs[k] = max(errs[k], err)
                    if err or int(sk) != int(wsk) or not torch.equal(act, wact):
                        raise AssertionError(
                            f"tile dispatch != plain ({plan}) on the {mesh_shape} {name} board "
                            f"under {rule.notation}: skipped {int(sk)} vs {int(wsk)}")
                    total = cuda_halo.adaptive_strip_launches((BIG, BIG // 32), mesh_shape,
                                                              turns, cap)
                    log(f"K13+K10+K9 {mesh_shape} {BIG}^2 x {turns} ({plan}, xpad {xpad}) "
                        f"{name} {rule.notation}: identical, skipped {int(sk)} of {total}, "
                        f"active cells {int((act > 0).sum())} of {act.numel()}")
                    check_tile_launches(sb, rule, errs, plan, xpad, name)
                if mesh_shape != MESH_H:
                    log(f"K13 x 3 launches on the {ntiles} {name} tiles of {mesh_shape} "
                        f"{rule.notation}: identical")
                    continue
                for t in (6, 12, 18, 24, 30):
                    xpad = -(-t // 32)
                    for e in (e for row in halo.extend(sb, t, xpad) for e in row):
                        got = cuda_halo.ext_skip_launch(e, rule, t, t, xpad)
                        want = cuda_halo.ext_skip_launch_plain(e, rule, t, t, xpad)
                        errs["ext_skip"] = max(errs["ext_skip"], max_abs_err(got, want))
                        if not torch.equal(got, want):
                            raise AssertionError(f"K10 != plain at {t} turns, xpad {xpad}, "
                                                 f"{name} tiles, {rule.notation}")
                log(f"K13 x 3 launches and K10 x {{6, 12, 18, 24, 30}} (xpad 1) on the "
                    f"{ntiles} {name} tiles of {mesh_shape} {rule.notation}: identical")
        sharded[mesh_shape] = cases
    return sharded[MESH_H]


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


def stream_run(params: gol.Params, sink: Sink, keys=None, session=None, devices=None):
    """One ``gol.run`` on the engine thread while this thread consumes the
    stream as it is produced, as the CLI does; returns (seconds, final PGM
    bytes or None).  ``devices`` places the board (a virtual mesh): the run
    gets ``backend=Backend(params, devices)``."""
    events = gol.EventQueue()
    t0 = time.perf_counter()
    backend = Backend(params, devices) if devices else None
    engine = gol.start(params, events, keys, session, backend)
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


def drive(name: str, params: gol.Params, kernels: tuple, launches: dict, reference,
          engine: str = "pallas-packed", keys=None, shadow=None, devices=None):
    """Drive one main path through the kernels, with every launch count set
    to 0 just before and read just after, then once more with the
    ``reference`` overrides (``engine="packed"``, ``skip_stable=False``,
    headless, or single-device); the final boards and alive counts must
    agree, and the path must have run on ``engine``.  A ``reference`` of
    bytes is the final PGM the run must write, from a run made before.
    Both streams are consumed as they are produced (``Sink``; ``shadow``
    is the board shape of a flip run); ``devices`` places the kernel run's
    board (a virtual mesh).  Returns (the kernel run's end-to-end numbers,
    its sink)."""
    sink = Sink(shadow)
    reset_launches()
    seconds, final = stream_run(params, sink, keys, devices=devices)
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
    if isinstance(reference, bytes):
        if final != reference:
            raise AssertionError(f"{name}: final board differs from the single-device run's")
        log(f"{name}: final board equals the single-device run's")
        out = dict(seconds=seconds, gens_per_s=params.turns / seconds, launches=counts,
                   dispatch_loop_s=sink.loop_seconds(),
                   reference="the single-device run's final PGM")
        out.update(skip_gauges(sink))
        return out, sink
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
    out.update(skip_gauges(sink))
    if not params.no_vis:
        out.update(frames=sink.frames, frames_per_s=sink.frames / seconds, deltas=sink.deltas,
                   flips=sink.flips, flips_per_s=sink.flips / seconds)
        print(f"viewer path {name}: {seconds:.3f} s, {params.turns / seconds:.1f} gens/s, "
              f"{sink.frames / seconds:.1f} frames/s ({sink.frames} frames, {sink.deltas} "
              f"deltas), {sink.flips} flips, K6 launches {counts['stencil']}", flush=True)
    return out, sink


def skip_gauges(sink: Sink) -> dict:
    """A run's final skip fraction and active stripes, where it ran the
    adaptive tier."""
    gauges = sink.report["gauges"]
    if "backend.skip_fraction" not in gauges:
        return {}
    return dict(skip_fraction=gauges["backend.skip_fraction"],
                active_stripes=gauges.get("backend.active_tiles"))


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


def detach_and_resume(params: gol.Params, straight: bytes, tmp: Path, devices=None) -> None:
    """'q' mid-run parks a checkpoint on a durable session; a second run
    resumes it to the straight run's final board (``devices``: both runs
    on that virtual mesh)."""
    detached, ckpt = Sink(), tmp / f"ckpt_{params.out_dir.name}"
    _, final = stream_run(params, detached, KeysAfter({3: "q"}), Session(ckpt), devices)
    turn = detached.quit_turn
    if final is not None or turn is None or not 0 < turn < params.turns:
        raise AssertionError(f"detach did not land mid-run: quit at turn {turn}")
    _, final = stream_run(params, Sink(), None, Session(ckpt), devices)
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


def sharded_paths(tmp: Path, straight: bytes, launches: dict, device) -> dict:
    """Phase 3's sharded paths, each on a virtual mesh of the one card
    through ``gol.run(..., backend=Backend(params, devices))``: (a) the
    16384² soup x 2,000 on (4, 1), batch turn events, and a 'q'-detach and
    resume of it; (b) the same on (2, 2); (c) the default 512² x 100 on
    (8, 1).  Each runs ``auto``, must report ``pallas-packed`` on the
    ``ppermute`` tier, launch K9 and write the single-device run's PGM.
    (d) ``engine="packed"`` on (2, 1) at 4096² x 100 must launch no K9 and
    equal a single-device rerun."""
    e2e = {}
    big = gol.Params(turns=2000, image_width=BIG, image_height=BIG, soup_density=0.3,
                     soup_seed=7, turn_events="batch", ticker_period=3600, out_dir=tmp)
    default_pgm = (tmp / "default" / "512x512x100.pgm").read_bytes()
    runs = [("a", dataclasses.replace(big, mesh_shape=MESH_A), straight),
            ("b", dataclasses.replace(big, mesh_shape=MESH_B), straight),
            ("c", gol.Params(images_dir=tmp / "images", ticker_period=3600, out_dir=tmp,
                             mesh_shape=MESH_C), default_pgm)]
    for tag, params, want in runs:
        params = dataclasses.replace(params, out_dir=tmp / f"sharded_{tag}")
        ny, nx = params.mesh_shape
        name = (f"sharded ({tag}) {params.image_width}^2 x {params.turns} on {ny}x{nx}")
        out, sink = drive(name, params, ("ext",), launches, want,
                          devices=virtual(params.mesh_shape, device))
        tier = sink.report["info"].get("backend.sharded_tier")
        if tier != "ppermute":
            raise AssertionError(f"{name}: backend.sharded_tier {tier!r}, not 'ppermute'")
        e2e[f"sharded_{tag}_{params.image_width}^2x{params.turns}_{ny}x{nx}"] = out
        print(f"sharded path {name}: {out['seconds']:.3f} s, {out['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {out['dispatch_loop_s']:.3f} s, K9 launches "
              f"{out['launches']['ext']}", flush=True)
    detach_and_resume(dataclasses.replace(big, mesh_shape=MESH_A, out_dir=tmp / "sharded_q"),
                      straight, tmp, virtual(MESH_A, device))
    pk = gol.Params(turns=100, image_width=PACKED_SIDE, image_height=PACKED_SIDE,
                    soup_density=0.3, soup_seed=7, turn_events="batch", ticker_period=3600,
                    engine="packed", mesh_shape=MESH_D, out_dir=tmp / "sharded_d")
    name = f"sharded (d) {PACKED_SIDE}^2 x 100 packed on 2x1"
    out, _ = drive(name, pk, (), launches, dict(mesh_shape=(1, 1)), engine="packed",
                   devices=virtual(MESH_D, device))
    if out["launches"]["ext"]:
        raise AssertionError(f"{name}: K9 launched {out['launches']['ext']} times")
    e2e[f"sharded_d_{PACKED_SIDE}^2x100_2x1_packed"] = out
    return e2e


def strip_paths(tmp: Path, long_pgm: bytes, straight: bytes, launches: dict, device) -> dict:
    """Phase 3's ``skip_stable`` runs on row meshes, each on a virtual mesh
    of the one card: (e) the 16384² soup x 100,000 on (4, 1) under auto,
    equal to the single-device run's PGM; (f) ``PLAN_LESS`` on (8, 1),
    ``skip_stable=True``, equal to a single-device rerun; (g) the soup x
    2,000 on (4, 1) at ``PROBE_CAP``, equal to the single-device 2,000-turn
    PGM.  Each must report ``pallas-packed`` on the ``ppermute`` tier and
    launch its kernel: (e) K12, (f) K10 and no K11 or K12, (g) K11; the
    remainders' K10 and K9 launches are counted where they ran."""
    e2e = {}
    soup = dict(image_width=BIG, image_height=BIG, soup_density=0.3, soup_seed=7,
                turn_events="batch", ticker_period=3600)
    h, w, turns = PLAN_LESS
    runs = [
        ("e", gol.Params(turns=LONG_TURNS, mesh_shape=MESH_E, out_dir=tmp / "strips_e", **soup),
         ("strip_frontier",), long_pgm),
        ("f", gol.Params(turns=turns, image_height=h, image_width=w, soup_density=0.3,
                         soup_seed=7, turn_events="batch", ticker_period=3600, skip_stable=True,
                         mesh_shape=MESH_F, out_dir=tmp / "strips_f"),
         ("ext_skip",), dict(mesh_shape=(1, 1), skip_stable=False)),
        ("g", gol.Params(turns=2000, skip_stable=True, skip_tile_cap=PROBE_CAP,
                         mesh_shape=MESH_E, out_dir=tmp / "strips_g", **soup),
         ("strip_probing",), straight),
    ]
    for tag, params, kernels, want in runs:
        if not params.skip_stable_requested():
            raise AssertionError(f"skip_stable is not requested on path ({tag})")
        ny, nx = params.mesh_shape
        name = f"strips ({tag}) {params.image_height}x{params.image_width} x {params.turns} on {ny}x{nx}"
        out, sink = drive(name, params, kernels, launches, want,
                          devices=virtual(params.mesh_shape, device))
        for k in ("ext", *STRIPS):  # the remainders' launches count too
            if k not in kernels:
                launches[k] += out["launches"][k]
        tier = sink.report["info"].get("backend.sharded_tier")
        if tier != "ppermute":
            raise AssertionError(f"{name}: backend.sharded_tier {tier!r}, not 'ppermute'")
        if tag == "f" and (out["launches"]["strip_probing"] or out["launches"]["strip_frontier"]):
            raise AssertionError(f"{name}: a strip without a plan launched K11 or K12")
        out["sharded_tier_policy"] = sink.report["info"].get("backend.sharded_tier_policy")
        e2e[f"strips_{tag}_{params.image_height}x{params.image_width}x{params.turns}_{ny}x{nx}"] = out
        print(f"strip path {name}: {out['seconds']:.3f} s, {out['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {out['dispatch_loop_s']:.3f} s, skip fraction "
              f"{out.get('skip_fraction')}, launches "
              f"{ {k: out['launches'][k] for k in ('ext', *STRIPS)} }", flush=True)
    return e2e


def tile_paths(tmp: Path, long_pgm: bytes, straight: bytes, launches: dict, device) -> dict:
    """Phase 3's ``skip_stable`` runs on 2-D meshes, each on a virtual
    mesh of the one card: (h) the 16384² soup x 100,000 on ``MESH_H``
    under auto, equal to the single-device run's PGM; (i)
    ``TILE_PLAN_LESS`` on ``MESH_I``, ``skip_stable=True``, equal to a
    single-device rerun; (j) the soup x 2,000 on ``MESH_J`` at
    ``PROBE_CAP``, equal to the single-device 2,000-turn PGM.  Each must
    report ``pallas-packed`` on the ``ppermute`` tier; (h) and (j) must
    launch K13, (i) K10 and no K13; the remainders' K10 and K9 launches
    are counted where they ran.  Then (h)'s board on ``MESH_H`` with
    ``skip_stable=False``, K9 alone, equal to the same PGM."""
    e2e = {}
    soup = dict(image_width=BIG, image_height=BIG, soup_density=0.3, soup_seed=7,
                turn_events="batch", ticker_period=3600)
    h, w, turns = TILE_PLAN_LESS
    runs = [
        ("h", gol.Params(turns=LONG_TURNS, mesh_shape=MESH_H, out_dir=tmp / "tiles_h", **soup),
         ("tile_probing",), long_pgm),
        ("i", gol.Params(turns=turns, image_height=h, image_width=w, soup_density=0.3,
                         soup_seed=7, turn_events="batch", ticker_period=3600, skip_stable=True,
                         mesh_shape=MESH_I, out_dir=tmp / "tiles_i"),
         ("ext_skip",), dict(mesh_shape=(1, 1), skip_stable=False)),
        ("j", gol.Params(turns=2000, skip_stable=True, skip_tile_cap=PROBE_CAP,
                         mesh_shape=MESH_J, out_dir=tmp / "tiles_j", **soup),
         ("tile_probing",), straight),
    ]
    for tag, params, kernels, want in runs:
        if not params.skip_stable_requested():
            raise AssertionError(f"skip_stable is not requested on path ({tag})")
        ny, nx = params.mesh_shape
        name = f"tiles ({tag}) {params.image_height}x{params.image_width} x {params.turns} on {ny}x{nx}"
        out, sink = drive(name, params, kernels, launches, want,
                          devices=virtual(params.mesh_shape, device))
        for k in ("ext", "ext_skip"):  # the remainders' launches count too
            if k not in kernels:
                launches[k] += out["launches"][k]
        tier = sink.report["info"].get("backend.sharded_tier")
        if tier != "ppermute":
            raise AssertionError(f"{name}: backend.sharded_tier {tier!r}, not 'ppermute'")
        if tag == "i" and out["launches"]["tile_probing"]:
            raise AssertionError(f"{name}: a tile without a plan launched K13")
        out["sharded_tier_policy"] = sink.report["info"].get("backend.sharded_tier_policy")
        e2e[f"tiles_{tag}_{params.image_height}x{params.image_width}x{params.turns}_{ny}x{nx}"] = out
        print(f"tile path {name}: {out['seconds']:.3f} s, {out['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {out['dispatch_loop_s']:.3f} s, skip fraction "
              f"{out.get('skip_fraction')}, active stripes {out.get('active_stripes')}, "
              f"launches { {k: out['launches'][k] for k in ('ext', 'ext_skip', 'tile_probing')} }",
              flush=True)
    # (h) again without skip_stable (K9 alone): what auto's tile tier
    # costs or saves on a 2-D mesh.
    params = gol.Params(turns=LONG_TURNS, mesh_shape=MESH_H, skip_stable=False,
                        out_dir=tmp / "tiles_h_k9", **soup)
    name = f"tiles (h) {BIG}x{BIG} x {LONG_TURNS} on {MESH_H[0]}x{MESH_H[1]}, skip_stable=False"
    out, _ = drive(name, params, ("ext",), launches, long_pgm, devices=virtual(MESH_H, device))
    if out["launches"]["tile_probing"] or out["launches"]["ext_skip"]:
        raise AssertionError(f"{name}: launched a skip_stable kernel")
    e2e[f"tiles_h_{BIG}x{BIG}x{LONG_TURNS}_{MESH_H[0]}x{MESH_H[1]}_no_skip"] = out
    print(f"tile path {name}: {out['seconds']:.3f} s, {out['gens_per_s']:.1f} gens/s, dispatch "
          f"loop {out['dispatch_loop_s']:.3f} s, K9 launches {out['launches']['ext']}", flush=True)
    return e2e


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


def profile_run(turns: int, side: int = BIG, devices=None, **viewer) -> dict:
    """Where the time of a main-path run on the ``side``² soup goes: the
    seeded soup's generation on the host, then the whole run under
    ``torch.profiler`` (device time by kernel, and the device's busy share
    of the run's wall-clock), its stream consumed as it is produced.
    ``viewer`` holds the Params of a viewer path (``no_vis=False``, ...)
    or a ``mesh_shape`` (run on the virtual mesh ``devices``); a headless
    run has batch turn events.  ``loop_idle_share_at_least`` bounds the
    device's idle share of the dispatch loop from below: all of the run's
    device time, loop or not, over the loop's seconds.  A sharded run also
    reports its K9-K13 launches and the device time per sharded launch
    (one launch per shard) of its device-to-device memcpys: on a row mesh
    these are the halo exchange's copies and nothing else
    (``halo.extend`` copies contiguous row blocks; packing and the gather
    run as kernels or host copies)."""
    t0 = time.perf_counter()
    random_soup(side, side, 0.3, 7)
    soup_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        opts = dict(viewer)
        if opts.get("no_vis", True):
            opts.setdefault("turn_events", "batch")
        params = gol.Params(turns=turns, image_width=side, image_height=side, soup_density=0.3,
                            soup_seed=7, out_dir=Path(tmp), ticker_period=3600, **opts)
        sink = Sink((side, side) if params.wants_flips() else None)
        reset_launches()
        with torch.profiler.profile(activities=acts) as prof:
            wall, _ = stream_run(params, sink, devices=devices)
        halo_launches = {k: WRAPPERS[k].launches for k in HALO}
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
    out = dict(
        side=side, turns=turns, viewer={k: v for k, v in viewer.items() if k != "mesh_shape"},
        wall_s=wall, soup_host_s=soup_s, dispatch_loop_s=sink.loop_seconds(),
        device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
        loop_idle_share_at_least=1 - busy_s / sink.loop_seconds(),
        top_device=[dict(name=k[:80], device_ms=us / 1e3, calls=n, ms_per_call=us / 1e3 / n)
                    for us, k, n in rows[:12]],
    )
    if devices:
        dtod = [(us, n) for us, k, n in rows if k.startswith("Memcpy DtoD")]
        total = sum(halo_launches.values())
        launches = total / len(devices)
        exchange_ms = sum(us for us, _ in dtod) / 1e3
        out.update(mesh_shape=list(viewer["mesh_shape"]), launches=halo_launches,
                   sharded_launches=launches, exchange_copies=sum(n for _, n in dtod),
                   exchange_device_ms=exchange_ms,
                   exchange_device_ms_per_launch=exchange_ms / launches if total else None)
    return out


# -- phase 4: times and bounds -------------------------------------------------


def work_bound_ms(words_moved: float, words_computed: float, gens: int, rule: LifeRule,
                  int_rate: float):
    """The least time for the work a launch's data needs: the
    ``words_computed`` packed words it must advance ``gens`` generations
    (``ops_per_word`` instructions each) over the int32 rate, against one
    read and one write of the ``words_moved`` words it must move over the
    memory rate."""
    return larger_ms(2 * words_moved * 4 / HBM_BYTES_PER_S,
                     words_computed * gens * ops_per_word(rule) / int_rate)


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


def time_ext(cases: dict, int_rate: float) -> dict:
    """K9 per launch on one shard of the 16384² soup split (4, 1) and
    (2, 2), at the full launch depth, beside one K2 launch of the whole
    board at the same T, its plain version and its bound over the centre's
    light cone (``ext_bound_ms``); the exchange alone (``halo.extend``)
    and a whole sharded launch (exchange plus one K9 per shard) per
    launch.  CUDA events."""
    rows = {}
    for mesh_shape, (sb, plan) in cases.items():
        e0 = halo.extend(sb, plan.pad, plan.xpad)[0][0]
        whole = sb.gather()
        step = cuda_halo.make_superstep(sb.mesh, CONWAY)
        b_ms, b_by = ext_bound_ms(sb.shard_shape, plan.t, plan.pad, plan.xpad, CONWAY, int_rate)
        row = dict(
            shard=list(sb.shard_shape), extended=list(e0.shape), t=plan.t, pad=plan.pad,
            xpad=plan.xpad, tiles=dataclasses.asdict(plan.tiles),
            grid=list(plan.grid(sb.shard_shape)), halo_bytes=plan.halo_bytes(sb.shard_shape),
            ms=cuda_ms(lambda: cuda_halo.ext_launch(e0, CONWAY, plan.t, plan.pad, plan.xpad), 20),
            plain_ms=cuda_ms(lambda: cuda_halo.ext_launch_plain(
                e0, CONWAY, plan.t, plan.pad, plan.xpad), 2),
            bound_ms=b_ms, bound_by=b_by,
            exchange_ms=cuda_ms(lambda: halo.extend(sb, plan.pad, plan.xpad), 20),
            sharded_launch_ms=cuda_ms(lambda: step(sb, plan.t), 10),
            k2_whole_board_ms=cuda_ms(lambda: cuda_packed.tiled_superstep(whole, CONWAY, plan.t), 10),
        )
        rows[f"{mesh_shape[0]}x{mesh_shape[1]}"] = row
        log(f"K9 {mesh_shape} shard {sb.shard_shape} x {plan.t}: {row['ms']:.4f} ms per shard "
            f"launch (plain {row['plain_ms']:.3f}, bound {b_ms:.4f} by {b_by}); exchange "
            f"{row['exchange_ms']:.4f} ms ({row['halo_bytes']} halo bytes a shard); sharded "
            f"launch {row['sharded_launch_ms']:.4f} ms vs K2 on the whole board "
            f"{row['k2_whole_board_ms']:.4f} ms")
    lead = rows[f"{MESH_A[0]}x{MESH_A[1]}"]
    return dict(ms=lead["ms"], plain_ms=lead["plain_ms"], bound=(lead["bound_ms"], lead["bound_by"]),
                extra=dict(shape=lead["extended"], per_mesh=rows))


def timed(fn, spans: list):
    """``fn`` with a pair of CUDA events recorded around every call, into
    ``spans``."""

    def call(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    return call


def span_ms(spans: list) -> float:
    """Mean ms of the calls ``timed`` recorded."""
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans) / len(spans)


def time_strips(cases: dict, int_rate: float) -> dict:
    """Per-launch times of K10, K11 and K12 on the (4, 1) strips of the
    16384² soup, fresh and settled, each call between CUDA events inside
    the strip tier's own launch sequence (so every launch sees the
    exchange's inputs), beside the plain versions the same way, with each
    launch's bound from its own skip telemetry: K12 over 64 launches a
    strip and K11 over 8 from a zero bitmap (each moves and computes only
    the stripes it computes, T + 6 and T generations); K10 one launch of
    18 generations (a remainder depth of path (e)) on strip 0's extended
    block, its computed share that of K10's own tiles whose skip proof
    fails (``k10_share``), of the centre's light cone (``ext_bound_ms``'
    count); it reads the block and writes the centre; then K10 at path (f)'s
    shape (strip 0's block of ``cases["plan_less"]``, the fresh soup, at
    the full launches' T; bound as K9's, every tile computing)."""
    strip = (BIG // MESH_E[0], BIG // 32)
    fplan = cuda_halo.adaptive_strip_plan(strip, 10**6)
    pplan = cuda_halo.adaptive_strip_plan(strip, 10**6, PROBE_CAP)
    ny = MESH_E[0]
    out = {}
    for name in ("fresh", "settled"):
        sb = cases[name]
        strips = [row[0] for row in sb.shards]
        row = {}
        for kernel, plan, seq, n, gens in (
                ("strip_frontier", fplan, cuda_halo.frontier_launches, 64, fplan.t + 6),
                ("strip_probing", pplan, cuda_halo.probing_launches, 8, pplan.t)):
            seq(strips, CONWAY, plan, 2)  # warm-up
            spans, plain = [], []
            _, sk, _ = seq(strips, CONWAY, plan, n, timed(WRAPPERS[kernel], spans))
            seq(strips, CONWAY, plan, 2, timed(getattr(cuda_halo, f"{kernel}_launch_plain"), plain))
            grid = plan.grid(strip[0])
            computed = (n * ny * grid - int(sk)) / (n * ny)
            words = computed * plan.stripe_h * strip[1]
            b_ms, b_by = work_bound_ms(words, words, gens, CONWAY, int_rate)
            row[kernel] = dict(ms=span_ms(spans), plain_ms=span_ms(plain), plan=str(plan),
                               computed_stripes_per_launch=computed, stripes=grid,
                               bound_ms=b_ms, bound_by=b_by)
        t = 18
        e = halo.extend(sb, t, 0)[0][0]
        share, stable = k10_share(e, strip, t, 0)
        b_ms, b_by = ext_bound_ms(strip, t, t, 0, CONWAY, int_rate, share)
        row["ext_skip"] = dict(
            ms=cuda_ms(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, 0), 20),
            plain_ms=cuda_ms(lambda: cuda_halo.ext_skip_launch_plain(e, CONWAY, t, t, 0), 2),
            t=t, computed_share=share, stable_tiles=stable, bound_ms=b_ms, bound_by=b_by,
            ext_same_t_ms=cuda_ms(lambda: cuda_halo.ext_launch(e, CONWAY, t, t, 0), 20))
        out[name] = row
        log(f"{name} strips of {MESH_E}: " + "; ".join(
            f"{k} {row[k]['ms']:.4f} ms (plain {row[k]['plain_ms']:.3f}, bound "
            f"{row[k]['bound_ms']:.4f} by {row[k]['bound_by']})" for k in STRIPS)
            + f"; K9 at T = {t} {row['ext_skip']['ext_same_t_ms']:.4f} ms; K10 computed share "
            f"{share:.4f}, stable tiles {stable}")
    h, w, turns = PLAN_LESS
    t = cuda_halo.skip_launch_depth((h // MESH_F[0], w // 32), turns)[0]
    e = halo.extend(cases["plan_less"], t, 0)[0][0]
    b_ms, b_by = ext_bound_ms((h // MESH_F[0], w // 32), t, t, 0, CONWAY, int_rate)
    path_f = dict(shape=list(e.shape), t=t, bound_ms=b_ms, bound_by=b_by,
                  ms=cuda_ms(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, 0), 50),
                  plain_ms=cuda_ms(lambda: cuda_halo.ext_skip_launch_plain(e, CONWAY, t, t, 0), 5))
    log(f"K10 at path (f)'s {tuple(e.shape)} block, T = {t}: {path_f['ms']:.4f} ms "
        f"(plain {path_f['plain_ms']:.3f}, bound {b_ms:.5f} by {b_by})")
    timings = {k: dict(ms=out["fresh"][k]["ms"], plain_ms=out["fresh"][k]["plain_ms"],
                       bound=(out["fresh"][k]["bound_ms"], out["fresh"][k]["bound_by"]),
                       extra=dict(board="fresh", shape=list(strip), per_board={
                           name: row[k] for name, row in out.items()}))
               for k in STRIPS}
    timings["ext_skip"]["extra"]["path_f"] = path_f
    return timings


def time_tiles(cases: dict, int_rate: float) -> dict:
    """Per-launch times of K13 and of K10 at xpad > 0 on the (2, 2) tiles
    of the 16384² soup, fresh and settled.  K13 at the port's plan (the
    plan of path (h)), each call between CUDA events inside the tile
    tier's own launch sequence (so every launch sees the exchange's
    inputs), 8 launches a tile from a zero bitmap, beside its plain
    version the same way; its bound is the work of the stripes it
    computed (its own skip telemetry), T generations of the stripes'
    centre words, each read and written once.  K10 one launch of 18
    generations at xpad 1 on tile (0, 0)'s extended block, beside K9 at
    the same T and its plain version; its bound is ``ext_bound_ms``' light
    cone scaled by the share of K10's own tiles whose skip proof fails
    (``k10_share``), against the block's read and the centre's write."""
    tile = (BIG // MESH_H[0], BIG // 32 // MESH_H[1])
    plan, xpad = cuda_halo.adaptive_tile_plan(tile, 10**6)
    cells = MESH_H[0] * MESH_H[1] * plan.grid(tile[0])
    out = {}
    for name in ("fresh", "settled"):
        sb = cases[name]
        cuda_halo.tile_probing_launches(sb, CONWAY, plan, xpad, 2)  # warm-up
        spans, plain = [], []
        n = 8
        _, sk, _ = cuda_halo.tile_probing_launches(
            sb, CONWAY, plan, xpad, n, timed(WRAPPERS["tile_probing"], spans))
        cuda_halo.tile_probing_launches(sb, CONWAY, plan, xpad, 2,
                                        timed(cuda_halo.tile_probing_launch_plain, plain))
        computed = (n * cells - int(sk)) / (n * MESH_H[0] * MESH_H[1])
        words = computed * plan.stripe_h * tile[1]
        b_ms, b_by = work_bound_ms(words, words, plan.t, CONWAY, int_rate)
        row = {"tile_probing": dict(ms=span_ms(spans), plain_ms=span_ms(plain), plan=str(plan),
                                    xpad=xpad, computed_stripes_per_launch=computed,
                                    stripes=plan.grid(tile[0]), bound_ms=b_ms, bound_by=b_by)}
        t, xw = 18, 1
        e = halo.extend(sb, t, xw)[0][0]
        share, stable = k10_share(e, tile, t, xw)
        b_ms, b_by = ext_bound_ms(tile, t, t, xw, CONWAY, int_rate, share)
        row["ext_skip"] = dict(
            ms=cuda_ms(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, xw), 20),
            plain_ms=cuda_ms(lambda: cuda_halo.ext_skip_launch_plain(e, CONWAY, t, t, xw), 2),
            t=t, xpad=xw, shape=list(e.shape), computed_share=share, stable_tiles=stable,
            bound_ms=b_ms, bound_by=b_by,
            ext_same_t_ms=cuda_ms(lambda: cuda_halo.ext_launch(e, CONWAY, t, t, xw), 20))
        out[name] = row
        log(f"{name} tiles of {MESH_H}: " + "; ".join(
            f"{k} {row[k]['ms']:.4f} ms (plain {row[k]['plain_ms']:.3f}, bound "
            f"{row[k]['bound_ms']:.4f} by {row[k]['bound_by']})" for k in ("tile_probing", "ext_skip"))
            + f"; K9 at T = {t} {row['ext_skip']['ext_same_t_ms']:.4f} ms; K13 computed "
            f"{row['tile_probing']['computed_stripes_per_launch']:.2f} of {plan.grid(tile[0])} "
            f"stripes a tile launch; K10 computed share {share:.4f}, stable tiles {stable}")
    h, w, turns = TILE_PLAN_LESS
    strip = (h // MESH_I[0], w // 32 // MESH_I[1])
    t = cuda_halo.skip_launch_depth(strip, turns)[0]
    xw = -(-t // 32)
    e = halo.extend(cases["plan_less"], t, xw)[0][0]
    b_ms, b_by = ext_bound_ms(strip, t, t, xw, CONWAY, int_rate)
    path_i = dict(shape=list(e.shape), t=t, xpad=xw, bound_ms=b_ms, bound_by=b_by,
                  ms=cuda_ms(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, xw), 50),
                  plain_ms=cuda_ms(lambda: cuda_halo.ext_skip_launch_plain(e, CONWAY, t, t, xw), 5))
    log(f"K10 at path (i)'s {tuple(e.shape)} block, T = {t}, xpad {xw}: {path_i['ms']:.4f} ms "
        f"(plain {path_i['plain_ms']:.3f}, bound {b_ms:.5f} by {b_by})")
    fresh = out["fresh"]["tile_probing"]
    return dict(
        tile_probing=dict(ms=fresh["ms"], plain_ms=fresh["plain_ms"],
                          bound=(fresh["bound_ms"], fresh["bound_by"]),
                          extra=dict(board="fresh", shape=list(tile), per_board={
                              name: row["tile_probing"] for name, row in out.items()})),
        ext_skip_2d=dict(per_board={name: row["ext_skip"] for name, row in out.items()},
                         path_i=path_i),
    )


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
    ext_cases = check_ext(device, errs)
    strip_cases = check_strips(device, errs, boards)
    strip_cases["plan_less"] = check_plan_less(device, errs, PLAN_LESS, MESH_F, "f")
    tile_cases = check_tiles(device, errs, boards)
    tile_cases["plan_less"] = check_plan_less(device, errs, TILE_PLAN_LESS, MESH_I, "i")

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
        e2e.update(sharded_paths(tmp, straight, launches, device))
        a = next(v for k, v in e2e.items() if k.startswith("sharded_a_"))
        log(f"sharded (a) on {MESH_A}: {a['gens_per_s']:.1f} gens/s, K9 launches "
            f"{a['launches']['ext']}; single-device {BIG}^2 x 2000: "
            f"{e2e[f'soup_{BIG}x{BIG}x2000']['gens_per_s']:.1f} gens/s")
        long_pgm = (long.out_dir / f"{long.final_output_name}.pgm").read_bytes()
        e2e.update(strip_paths(tmp, long_pgm, straight, launches, device))
        e = next(v for k, v in e2e.items() if k.startswith("strips_e_"))
        print(f"strip path (e) on {MESH_E}: {e['gens_per_s']:.1f} gens/s, dispatch loop "
              f"{e['dispatch_loop_s']:.3f} s, skip fraction {e.get('skip_fraction')}; "
              f"single-device {BIG}^2 x {LONG_TURNS}: {run_long['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {run_long['dispatch_loop_s']:.3f} s, skip fraction "
              f"{run_long.get('skip_fraction')}", flush=True)
        e2e.update(tile_paths(tmp, long_pgm, straight, launches, device))
        hh = next(v for k, v in e2e.items() if k.startswith("tiles_h_"))
        print(f"tile path (h) on {MESH_H}: {hh['gens_per_s']:.1f} gens/s, dispatch loop "
              f"{hh['dispatch_loop_s']:.3f} s, skip fraction {hh.get('skip_fraction')}; strip "
              f"path (e) on {MESH_E}: {e['gens_per_s']:.1f} gens/s; single-device "
              f"{run_long['gens_per_s']:.1f} gens/s", flush=True)

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
    timings["ext"] = time_ext(ext_cases, int_rate)
    timings.update(time_strips(strip_cases, int_rate))
    tiles = time_tiles(tile_cases, int_rate)
    timings["tile_probing"] = tiles["tile_probing"]
    timings["ext_skip"]["extra"]["tile_2d"] = tiles["ext_skip_2d"]
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
        print(json.dumps({"profile": profile_run(2000, BIG, virtual(MESH_A, device),
                                                 mesh_shape=MESH_A), "card": card}))
        print(json.dumps({"profile": profile_run(LONG_TURNS, BIG, virtual(MESH_E, device),
                                                 mesh_shape=MESH_E), "card": card}))
        print(json.dumps({"profile": profile_run(LONG_TURNS, BIG, virtual(MESH_H, device),
                                                 mesh_shape=MESH_H), "card": card}))
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, kernel builds included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
