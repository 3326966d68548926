"""Time K1-K4, K6, K7, K9-K11, K13 and the frontier kernels of a checkout of the PyTorch port on one CUDA card.

    python3 tools/regwin_ab.py [--root DIR] [--label NAME] [--out FILE] [--paths [--path NAME ...]]
                               [--trace-long] [--frontier]
                               [--sweep | --sweep-frontier | --sweep-k2-k7 | --sweep-k3-k4]

Imports ``distributed_gol_torch`` from ``--root`` (default: the checkout
holding this script), builds its ``resident``, ``ext``, ``probing``,
``tiled`` and ``frontier`` kernels there, and
times K9 (``cuda_halo.ext_launch``) and K13 (``cuda_halo.tile_probing_launch``)
through their wrappers, whose signatures every slice of the port shares, at
the shapes the main paths give them: the 16384² soup (density 0.3, seed 7)
split (4, 1) and (2, 2) at the full depth of 32 generations and at the
remainder depths 5 and 18; path (c)'s 512² board on (8, 1); path (f)'s
520 x 512 board on (8, 1) and path (i)'s 520 x 1024 board on (4, 2) at
depth 5; K13 on the (2, 2) tiles at the port's plan (T = 24, 256-row
stripes) and on path (j)'s (2, 4) tiles at a stripe cap of 16 (T = 12),
fresh (seed 13) and settled (seed 7 after 100,000 generations).  Each time
is the median, min and max of 5 event-timed batches: K9 20 back-to-back
launches on shard (0, 0)'s extended block; K13 both back to back on tile
(0, 0) (elision flags 0, so every stripe probes) and, as ``PERF.md``'s
rows before this script were taken, each launch between CUDA events inside
the tile tier's own sequence of 8 launches a tile.  Where a launch is
shorter than its wrapper's host time, back-to-back batches time the host;
``device_ms`` is the kernel's own time from ``torch.profiler`` (20
launches).  The frontier kernels through the wrappers every slice
shares, at the port's plan, fresh, settled and sparse (``frontier_cases``;
the sparse boards are ``distributed_gol_torch/testing/boards.py`` of this
script's checkout, ``sparse_boards``): K15
(``cuda_halo.tile_mega_launches``) over the same (2, 2) tiles, K12
(``cuda_halo.strip_frontier_launch``, driven by
``cuda_halo.frontier_launches`` with its exchange) and K14
(``cuda_halo.strip_mega_launches``) on the (4, 1) strips, K5
(``cuda_adaptive.frontier_superstep``) on the whole 16384² board, each a
chunk or sequence of 64 launches, and K8
(``frontier_superstep_batched``) on serving path (c)'s stack of four
4096² soups (seeds 51-54; settled: each after 100,000 generations of
K2) and on the sparse stack (a 4096 x 16384 board beside a dead one),
chunks of 8, and K15 over the (2, 2) tiles of the sparse board with its
tile gliders, at the shipped geometry and under (96, 128): the median and spread of 5 event-timed batches per
launch (the host's calls and, for K12, the exchange included), each
kernel's device ms per launch from ``torch.profiler`` (the frontier
kernel and its finalize apart), and the SASS of their loops
(``frontier_sass``).  K1 (``cuda_packed.resident_superstep``) on a 512²
soup x 50 generations and 16 sequential launches of 16 512² soups x 64
(serving pod b's superstep), beside K7 (``resident_superstep_batched``)
on the same stack; K10 (``cuda_halo.ext_skip_launch``) at 18 generations
on the (4, 1) strip and the (2, 2) tile of the 16384² soup (xpad 1),
fresh and settled, and at 30 generations on path (f)'s (8, 1) and path
(i)'s (4, 2) shards of 520 x 512 and 520 x 1024 soups; each the median
and spread of 5 batches and its device ms, and the SASS of K1's and
K10's loops (``resident_ext_sass``).  K6 (``cuda_stencil.stencil_step``)
one generation of 16384² and 512² byte soups beside a byte copy of the
board, and with its count where the checkout's K6 counts (``time_k6``);
K11 (``cuda_halo.strip_probing_launch``) on the (4, 1) strips of the
fresh and settled boards at path (g)'s plan and path (e)'s loose-tail plan,
8 launches from a zero bitmap (``time_k11``); K4
(``cuda_adaptive.probing_superstep``) on the fresh and settled 16384²
boards at the port's plan, 8 launches from a zero bitmap (``time_k4``),
and K3 (``cuda_adaptive.tiled_skip_superstep``) on them at 24 and 18
generations (``time_k3``); and the SASS of K6's, K11's and K13's loops
(``probing_stencil_sass``) and of K3's and K4's (``skip_sass``).  K2
(``cuda_packed.tiled_superstep``) one launch of 32 generations of the
16384² soup and its remainder depth of 16, K3 at 24 generations beside
it (``time_k2``), K7 on the edge of its gate, 3 x 1024 x 1792 x 64
(``time_k1``), and the SASS of K2's loop (``tiled_sass``).
``--sweep-k3-k4`` times K4 and K3 at every block height their plans
weigh (``sweep_k3_k4``), on a checkout that has those plans;
``--trace-long`` traces the one-device 16384² x 100,000 run
(``chip_smoke.profile_run`` of the checkout: K5, K4, K3 and K2 launch by
launch).
``--frontier`` times the frontier kernels and their SASS alone.
``--sweep-frontier`` times each frontier
kernel at every row tile its plan weighs; ``--sweep`` also times K1 at
512² at each cluster size its plan weighs (the cheapest plan of each; the
exchange is every generation) and K10 at every block height of its plan,
and K6 at every run height and K11 at every block height
(``sweep_k6_k11``), and K2 at every block height at its plan's depth
(32) and at 64, and K7 at every cluster size of 16 x 512², 3 x 1024 x
1792 and 132 x 512² (``sweep_k2_k7``; ``--sweep-k2-k7`` these alone), on
a checkout that has those plans.
``--paths`` also runs the frames viewer, path (g), path (e), the 16384² x
2,000 and x 100,000 headless runs and serving pod (a) end to end
(``time_paths``; ``--path`` picks some of them).
Prints one JSON object with the card's name and power limit.

To compare two commits on one card, unpack the parent into a directory
that ``.gitignore`` lists and run parent, this, this, parent in one call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BIG = 16384
BATCHES = 5
# K8's sparse stack (``sparse_boards``): these slots of ``sparse_board``.
K8_SPARSE = ("mid", "spark", "two_columns", "two_rows")
# The plan geometry (sub_margin, col_window) under which K15 is also timed
# on the sparse board's (2, 2) tiles: their 256 words host its column
# window.
TIER_GEOMETRY = (96, 128)


def spread(per: list) -> dict:
    return dict(median=statistics.median(per), min=min(per), max=max(per), batches=per)


def batches(fn, reps: int) -> dict:
    """ms per call of ``fn()``: ``BATCHES`` batches of ``reps`` calls, each
    between CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(BATCHES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return spread(per)


def device_ms(fn, reps: int, kernel) -> float:
    """Device ms per launch of the kernels whose name ``kernel(name)``
    accepts: the median of ``BATCHES`` batches of ``reps`` calls of
    ``fn()``, each under ``torch.profiler`` (the kernel's own time,
    without the host's)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(BATCHES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for a in prof.key_averages():
            if kernel(a.key):
                t = getattr(a, "self_device_time_total", None)
                us += t if t is not None else a.self_cuda_time_total
                count += a.count
        per.append(us / count / 1e3 if count else float("nan"))
    return statistics.median(per)


def device_ms_by_kernel(fn, kernels: dict, per: int) -> dict:
    """Device ms per launch of each of ``kernels`` (name -> test of a
    kernel's name) over one call of ``fn()`` of ``per`` launches, under
    ``torch.profiler``: the median of ``BATCHES`` calls, after a warm-up
    call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_kernel = {k: [] for k in kernels}
    for _ in range(BATCHES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for k, test in kernels.items():
            us = 0.0
            for a in prof.key_averages():
                if test(a.key):
                    t = getattr(a, "self_device_time_total", None)
                    us += t if t is not None else a.self_cuda_time_total
            per_kernel[k].append(us / per / 1e3)
    return {k: statistics.median(v) for k, v in per_kernel.items()}


def kernels(*names: str) -> dict:
    """Profiler tests of a frontier kernel (any of ``names``: the
    register-resident form and the shared-memory one before it) and of
    its finalize."""
    return {"frontier": lambda k: any(f"::{n}" in k for n in names),
            "finalize": lambda k: "frontier_finalize" in k}


POD_C = (4, 4096)  # serving path (c): tenants, side
POD_RUNS = 3  # timed runs of serving pod (a) a checkout


def pod_stack(packed_soup, seed: int) -> torch.Tensor:
    """Serving path (c)'s stack: four 4096² soups, seeds ``seed``.."""
    return torch.stack([packed_soup(POD_C[1], POD_C[1], seed + i) for i in range(POD_C[0])])


def under(cuda_adaptive, geometry, fn):
    """``fn`` run under the frontier plan geometry ``geometry``
    (``cuda_adaptive.plan_geometry_override``)."""
    def run():
        with cuda_adaptive.plan_geometry_override(geometry):
            return fn()

    return run


def frontier_cases(cuda_adaptive, cuda_halo, shards, boards, pods, rule, tile_board=None):
    """The frontier kernels at the main paths' shapes and the port's plan,
    on each board: (key, plan, one shard's shape and the shards one launch
    covers, a call of 64 launches (K8: 8), launches a call, profiler
    tests).  K15 over the (2, 2) tiles, K12 on the (4, 1) strips (a call is
    64 rounds of 4 strip launches with the exchange), K5 on the whole
    board, K14 over the (4, 1) strips, K8 on pod (c)'s stacks and on the
    sparse stack, each at its own plan; and K15 over the (2, 2) tiles of
    ``tile_board`` (the sparse board with its tile gliders) at the shipped
    geometry and under ``TIER_GEOMETRY``, whose column window the 256-word
    tiles host."""
    out = []
    tile = (BIG // 2, BIG // 64)
    strip = (BIG // 4, BIG // 32)
    plan15 = cuda_halo.adaptive_tile_plan(tile, 10**6)[0]
    plan12 = plan14 = cuda_halo.adaptive_strip_plan(strip, 10**6)
    plan5 = cuda_adaptive.adaptive_plan((BIG, BIG // 32), 10**6)
    for name, p in boards.items():
        tiles = shards(p, (2, 2)).shards
        strips = [row[0] for row in shards(p, (4, 1)).shards]
        out += [
            (f"k15_{name}", plan15, tile, 4, lambda tiles=tiles: cuda_halo.tile_mega_launches(
                tiles, rule, plan15, 64), 64, kernels("tile_mega_reg_kernel")),
            (f"k12_{name}", plan12, strip, 1, lambda strips=strips: cuda_halo.frontier_launches(
                strips, rule, plan12, 64), 64 * 4, kernels("strip_frontier_reg_kernel")),
            (f"k5_{name}", plan5, (BIG, BIG // 32), 1, lambda p=p: cuda_adaptive.frontier_superstep(
                p, rule, plan5, 64), 64, kernels("frontier_reg_kernel", "frontier_kernel")),
            (f"k14_{name}", plan14, strip, 4, lambda strips=strips: cuda_halo.strip_mega_launches(
                strips, rule, plan14, 64), 64, kernels("strip_mega_reg_kernel", "strip_mega_kernel")),
        ]
    if tile_board is not None:
        tiles = shards(tile_board, (2, 2)).shards

        def k15(tiles=tiles):
            return cuda_halo.tile_mega_launches(tiles, rule, plan15, 64)

        for key, fn in (("k15_sparse_tiles", k15),
                        ("k15_sparse_tiles_c128", under(cuda_adaptive, TIER_GEOMETRY, k15))):
            out.append((key, plan15, tile, 4, fn, 64, kernels("tile_mega_reg_kernel")))
    for name, st in pods.items():
        plan = cuda_adaptive.adaptive_plan(tuple(st.shape[1:]), 10**6)
        out.append((f"k8_{name}", plan, tuple(st.shape[1:]), st.shape[0], lambda st=st, plan=plan:
                    cuda_adaptive.frontier_superstep_batched(st, rule, plan, 8), 8,
                    kernels("frontier_reg_kernel", "frontier_kernel")))
    return out


def sparse_boards(packed, dev):
    """``distributed_gol_torch/testing/boards.py::sparse_board`` of this
    script's checkout (loaded by path, so a parent checkout that lacks it
    is timed on the same boards), packed on ``dev``: the 16384² board of
    all its slots, K8's stack of a 4096 x 16384 board of four slots
    beside a dead one, and the 16384² board with its gliders across the
    seams and a corner of (2, 2) tiles."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "distributed_gol_torch" / "testing" / "boards.py"
    spec = importlib.util.spec_from_file_location("sparse_boards", path)
    boards = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(boards)

    def pack(b):
        return packed.pack(torch.from_numpy(b).to(dev))

    stack = pack(boards.sparse_board(POD_C[1], BIG, 256, K8_SPARSE))
    return (pack(boards.sparse_board(BIG, BIG, 256)),
            torch.stack([stack, torch.zeros_like(stack)]).contiguous(),
            pack(boards.sparse_board(BIG, BIG, 256, tiles=(2, 2))))


def time_frontier(cases) -> dict:
    """Each of ``frontier_cases``: per launch, the median and spread of
    ``BATCHES`` event-timed calls, and the device ms of the frontier kernel
    and of its finalize."""
    out = {}
    for key, plan, _shape, _n, fn, per, tests in cases:
        timed = batches(fn, 1)
        out[key] = dict(plan=str(plan), ms_per_launch=spread([t / per for t in timed["batches"]]),
                        device_ms=device_ms_by_kernel(fn, tests, per))
    return out


def frontier_sass(cuda_build) -> dict:
    """The SASS of K5's, K12's, K14's and K15's loops in this checkout's ``frontier``
    build (``cuobjdump -sass``, read by ``tools/sass_loop_count.py``'s
    functions): for a register-resident kernel (``*_reg_kernel``, B3/S23)
    its generation loop (a 32-row run), for a shared-memory one its row
    loop (``window.cuh::advance``); each loop's instructions in all and a
    row, and its opcodes."""
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import sass_loop_count as slc

    cuobjdump = str(Path(cuda_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cuda_build.library_path("frontier"))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for name, code in slc.functions(sass).items():
        for key, kernel in (("K12", "strip_frontier"), ("K15", "tile_mega"), ("K5", "frontier"),
                            ("K14", "strip_mega")):
            # The mangled name spells each name's length first: "frontier"
            # alone is the tail of "strip_frontier".
            reg, old = f"{kernel}_reg_kernel", f"{kernel}_kernel"
            if f"{len(reg)}{reg}" in name and slc.CONWAY in name:
                out[key] = slc.summary(code, slc.generation_loop(code), slc.RUN_ROWS)
            elif f"{len(old)}{old}" in name:
                out[key] = slc.summary(code, slc.row_loop(code), 1)
    return out


def time_k1(cuda_packed, packed, soup, rule) -> dict:
    """K1 at 512² x 50 and 16 sequential launches of 16 512² soups x 64,
    K7 on the same stack: median and spread of ``BATCHES`` batches, and
    device ms a launch."""
    v = packed.pack_vertical(soup(512, 512, 21, vertical=True))
    stack = packed.pack_vertical(torch.stack([soup(512, 512, 61 + i, vertical=True)
                                              for i in range(16)])).contiguous()

    def k1():
        return cuda_packed.resident_superstep(v, rule, 50)

    def sixteen():
        return [cuda_packed.resident_superstep(b, rule, 64) for b in stack]

    def k7():
        return cuda_packed.resident_superstep_batched(stack, rule, 64)

    edge = packed.pack_vertical(torch.stack([soup(1024, 1792, 41 + i, vertical=True)
                                             for i in range(3)])).contiguous()

    def k7_edge():
        return cuda_packed.resident_superstep_batched(edge, rule, 64)

    def k1_edge():
        return [cuda_packed.resident_superstep(b, rule, 64) for b in edge]

    resident = (lambda k: "resident" in k and "batched" not in k)
    out = dict(
        k1_512_x50=dict(**batches(k1, 20), device_ms=device_ms(k1, 20, resident)),
        k1_16x512_x64_sequential=dict(**batches(sixteen, 5),
                                      device_ms_per_launch=device_ms(sixteen, 5, resident)),
        k7_16x512_x64=dict(**batches(k7, 20), device_ms=device_ms(k7, 20, resident)),
        k7_3x1024x1792_x64=dict(**batches(k7_edge, 10), device_ms=device_ms(k7_edge, 10, resident)),
        k1_3x1024x1792_x64_sequential=dict(**batches(k1_edge, 5),
                                           device_ms_per_launch=device_ms(k1_edge, 5, resident)))
    plan = getattr(cuda_packed, "resident_reg_plan", None)
    if plan is not None:
        out["plan"] = str(plan(16, 512))
    if hasattr(cuda_packed, "card_batched_plan"):
        out["k7_plans"] = {"16x512": str(cuda_packed.card_batched_plan(stack, rule)),
                           "3x1024x1792": str(cuda_packed.card_batched_plan(edge, rule))}
    return out


def tiled_kernel(k: str) -> bool:
    """Whether a profiler key is K2's kernel, the register form or the
    first port's."""
    return "tiled_reg_kernel" in k or "::tiled_kernel" in k


def time_k2(cuda_adaptive, cuda_packed, big, rule) -> dict:
    """K2 one launch of 32 generations of the 16384² soup and one of the
    main path's remainder depth (2,000 = 62 x 32 + 16), and K3 (24
    generations, the skip proof) as its control: median and spread of ``BATCHES`` batches of 10
    launches, and device ms a launch."""
    out = {}
    for t in (32, 16):
        def k2(t=t):
            return cuda_packed.tiled_superstep(big, rule, t)

        out[f"k2_x{t}"] = dict(**batches(k2, 10), device_ms=device_ms(k2, 10, tiled_kernel))
    if hasattr(cuda_packed, "tiled_reg_plan"):
        out["plan"] = str(cuda_packed.tiled_reg_plan(tuple(big.shape), 64, 132))

    def k3():
        return cuda_adaptive.tiled_skip_superstep(big, rule, 24)

    out["k3_x24"] = dict(**batches(k3, 10), device_ms=device_ms(k3, 10,
                                                                lambda k: "tiled_skip" in k))
    return out


def tiled_sass(cuda_build) -> dict:
    """The SASS of K2's loop in this checkout's ``tiled`` build
    (``tools/sass_loop_count.py``): the register kernel's generation loop,
    or the first port's shared-memory row loop."""
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import sass_loop_count as slc

    return {k: v for k, v in slc.kernel_loops(cuda_build, ("tiled",)).items()
            if k.startswith("K2")}


def sweep_k2_k7(cuda_adaptive, cuda_packed, packed, big, soup, rule) -> list:
    """K2 on the 16384² soup at every block height ``tiled_reg_plan``
    weighs, at its depth of 32 and at 64 (``ext_reg_plan``'s tallest tile
    of 1 to 16 warps, forced through the wrapper's ``plan``; 64
    generations a call),
    and K7 x 64 at every cluster size of 16 x 512², 3 x 1024 x 1792 and
    132 x 512² (the cheapest plan of each size by the batched cost on the
    card's active clusters, forced in place of ``card_batched_plan``):
    device ms, beside the plan's cost and pick."""
    from distributed_gol_torch.ops.cuda_adaptive import REG_MAX_WARPS, REG_RUN, RegPlan

    rows = []
    h, wp = big.shape
    pick = cuda_packed.tiled_reg_plan((h, wp), 64, 132)
    for t in (32, 64):
        border = -(-t // 32)
        for warps in range(1, REG_MAX_WARPS + 1):
            tallest = warps * REG_RUN - 2 * t
            if tallest < 1:
                continue
            nrb = -(-h // tallest)
            tile_h = -(-h // nrb)
            plan = RegPlan(t, t, tile_h, -(-(tile_h + 2 * t) // REG_RUN),
                           (nrb, -(-wp // (32 - 2 * border))), border)
            rows.append(dict(kernel="K2", t=t, plan=str(plan), cost_per_gen=plan.cost(132) / t,
                             chosen=plan == pick, device_ms_per_gen=device_ms(
                                 lambda: cuda_packed.tiled_superstep(big, rule, 64, plan), 5,
                                 tiled_kernel) / t))
    chosen = cuda_packed.card_batched_plan
    stacks = {"16x512": (16, 512, 512), "3x1024x1792": (3, 1024, 1792), "132x512": (132, 512, 512)}
    try:
        for key, (nb, hh, ww) in stacks.items():
            v = packed.pack_vertical(torch.stack([soup(hh, ww, 61 + i, vertical=True)
                                                  for i in range(nb)])).contiguous()
            active = cuda_packed.card_active_clusters(v.device, rule)
            pick = chosen(v, rule)
            best = {}
            for p in cuda_packed.resident_reg_candidates(hh // 32, ww):
                n = active(p)
                if n < 1:
                    continue
                cost = cuda_packed.resident_batched_cost(p, nb, n, 132)
                if p.cluster not in best or cost < best[p.cluster][0]:
                    best[p.cluster] = (cost, p, n)
            for cluster, (cost, plan, n) in sorted(best.items()):
                cuda_packed.card_batched_plan = lambda *a, _p=plan: _p
                rows.append(dict(kernel="K7", stack=key, cluster=cluster, plan=str(plan),
                                 cost=cost, active=n, waves=-(-nb // n), chosen=plan == pick,
                                 device_ms=device_ms(
                                     lambda: cuda_packed.resident_superstep_batched(v, rule, 64),
                                     10, lambda k: "resident" in k)))
    finally:
        cuda_packed.card_batched_plan = chosen
    return rows


def k10_cases(halo, shards, big, boards, soup) -> list:
    """K10's shapes: (key, extended block, T, xpad)."""
    cases = []
    for name, p in boards.items():
        cases.append((f"4x1_{name}", halo.extend(shards(p, (4, 1)), 18, 0)[0][0], 18, 0))
        cases.append((f"2x2_{name}", halo.extend(shards(p, (2, 2)), 18, 1)[0][0], 18, 1))
    cases.append(("f_8x1_520x512", halo.extend(shards(soup(520, 512, 7), (8, 1)), 30, 0)[0][0],
                  30, 0))
    cases.append(("i_4x2_520x1024", halo.extend(shards(soup(520, 1024, 7), (4, 2)), 30, 1)[0][0],
                  30, 1))
    return cases


def time_k10(cuda_halo, cases, rule) -> dict:
    """K10 on each of ``k10_cases``: median and spread of ``BATCHES``
    batches of 20 launches, and device ms a launch."""
    out = {}
    for key, e, t, xpad in cases:
        def k10(e=e, t=t, xpad=xpad):
            return cuda_halo.ext_skip_launch(e, rule, t, t, xpad)

        out[key] = dict(shape=list(e.shape), t=t, xpad=xpad, **batches(k10, 20),
                        device_ms=device_ms(k10, 20, lambda k: "ext_skip" in k))
        stable = getattr(cuda_halo.ext_skip_launch, "last_stable", None)
        if stable is not None:
            out[key]["blocks"] = stable.numel()
            out[key]["blocks_computed"] = int((stable == 0).sum())
    return out


def resident_ext_sass(cuda_build) -> dict:
    """The SASS of K1's and K10's loops in this checkout's ``resident``
    and ``ext`` builds, B3/S23 (``tools/sass_loop_count.py::kernel_loops``:
    K1's generation loop for each instantiation, K10's first, or in the
    first port's K10 its shared-memory row loop)."""
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import sass_loop_count as slc

    return {k: v for k, v in slc.kernel_loops(cuda_build, ("resident", "ext")).items()
            if k.startswith(("K1_", "K10"))}


def sweep_k1_k10(cuda_packed, cuda_halo, packed, soup, cases, rule) -> list:
    """K1 at 512² x 50 at each cluster size and instantiation its plan
    weighs (the cheapest candidate of each pair, forced in place of
    ``resident_reg_plan``), and K10
    on each of ``cases`` at every block height ``ext_skip_plan`` weighs
    (the tallest tile of 1 to 16 warps), each beside its cost."""
    from distributed_gol_torch.ops.cuda_adaptive import REG_MAX_WARPS, REG_RUN, RegPlan

    rows = []
    v = packed.pack_vertical(soup(512, 512, 21, vertical=True))
    chosen, chosen_k10 = cuda_packed.resident_reg_plan, cuda_halo.ext_skip_plan
    best = {}
    for p in cuda_packed.resident_reg_candidates(16, 512):
        key = (p.cluster, p.h_run)
        if key not in best or p.cost() < best[key].cost():
            best[key] = p
    try:
        for (cluster, _), plan in sorted(best.items()):
            cuda_packed.resident_reg_plan = lambda *a, _p=plan: _p
            try:
                ms = device_ms(lambda: cuda_packed.resident_superstep(v, rule, 50), 20,
                               lambda k: "resident" in k)
            except RuntimeError as exc:  # a cluster the card cannot schedule
                ms = f"refused: {exc}"
            rows.append(dict(kernel="K1", board="512x512", turns=50, cluster=cluster,
                             plan=str(plan), cost=plan.cost(), exchange_every=1,
                             chosen=plan == chosen(16, 512), device_ms=ms))
        cuda_packed.resident_reg_plan = chosen
        for key, e, t, xpad in cases:
            strip = (e.shape[0] - 2 * t, e.shape[1] - 2 * xpad)
            pick = chosen_k10(strip, t, 132)
            seen = set()
            for warps in range(1, REG_MAX_WARPS + 1):
                tile_h = min(warps * REG_RUN - 2 * t, strip[0])
                if tile_h < 1:
                    continue
                tile_h = -(-strip[0] // -(-strip[0] // tile_h))
                plan = RegPlan(t, t, tile_h, -(-(tile_h + 2 * t) // REG_RUN),
                               (-(-strip[0] // tile_h), -(-strip[1] // 30)), 1, 6)
                if plan in seen:
                    continue
                seen.add(plan)
                cuda_halo.ext_skip_plan = lambda *a, _p=plan: _p
                rows.append(dict(kernel="K10", case=key, plan=str(plan), cost=plan.cost(132),
                                 chosen=plan == pick, device_ms=device_ms(
                                     lambda: cuda_halo.ext_skip_launch(e, rule, t, t, xpad), 20,
                                     lambda k: "ext_skip" in k)))
    finally:
        cuda_packed.resident_reg_plan, cuda_halo.ext_skip_plan = chosen, chosen_k10
    return rows


def time_k6(cuda_stencil, byte_soup, rule) -> dict:
    """K6 (``cuda_stencil.stencil_step``, one generation into a second
    buffer) on byte soups of 16384² and 512² (seed 23), beside a byte copy
    of the board (the same 2·H·W bytes) and, where the checkout's K6
    counts, K6 with its count: the median and spread of ``BATCHES``
    batches of 20 launches and device ms a launch."""
    import inspect

    counts = "count" in inspect.signature(cuda_stencil.stencil_step).parameters
    out = {}
    for n in (BIG, 512):
        b = byte_soup(n, n, 23)
        dst, copy_dst = torch.empty_like(b), torch.empty_like(b)
        count = torch.zeros((), dtype=torch.int64, device=b.device)

        def k6(b=b, dst=dst):
            return cuda_stencil.stencil_step(b, rule, out=dst)

        def copy(b=b, copy_dst=copy_dst):
            return copy_dst.copy_(b)

        row = dict(k6=dict(**batches(k6, 20), device_ms=device_ms(
                       k6, 20, lambda k: "stencil_kernel" in k)),
                   copy=dict(**batches(copy, 20), device_ms=device_ms(
                       copy, 20, lambda k: "Memcpy" in k or "copy" in k.lower())))
        if counts:
            def counted(b=b, dst=dst, count=count):
                return cuda_stencil.stencil_step(b, rule, out=dst, count=count)

            row["k6_counted"] = dict(**batches(counted, 20), device_ms=device_ms(
                counted, 20, lambda k: "stencil_kernel" in k))
            row["run_rows"] = cuda_stencil.RUN_ROWS
        out[f"{n}x{n}"] = row
    return out


def k11_plans(cuda_halo):
    """K11's plans on path (e)'s and (g)'s (4, 1) strips of the 16384²
    board: (g)'s (a stripe cap of 16: T = 12 on 16-row stripes) and (e)'s
    loose tail (the port's plan, T = 24 on 256-row stripes)."""
    strip = (BIG // 4, BIG // 32)
    return strip, {"g": cuda_halo.adaptive_strip_plan(strip, 10**6, 16),
                   "e_tail": cuda_halo.adaptive_strip_plan(strip, 10**6)}


def time_k11(cuda_halo, shards, boards, rule) -> dict:
    """K11 (``cuda_halo.strip_probing_launch``) on the (4, 1) strips of the
    fresh and settled 16384² boards at both of ``k11_plans``, driven by
    ``cuda_halo.probing_launches`` (8 launches a strip from a zero bitmap,
    the exchange between launches): each launch between CUDA events, the
    median and spread of ``BATCHES`` sequences of its mean, and the device
    ms a launch (the first launch probes every stripe; on the settled
    board every later one elides all)."""
    _, plans = k11_plans(cuda_halo)
    out = {}
    for key, plan in plans.items():
        for name, p in boards.items():
            strips = [row[0] for row in shards(p, (4, 1)).shards]
            cuda_halo.probing_launches(strips, rule, plan, 2)  # warm-up
            per = []
            for _ in range(BATCHES):
                spans = []

                def timed(*a, _spans=spans):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    r = cuda_halo.strip_probing_launch(*a)
                    end.record()
                    _spans.append((start, end))
                    return r

                cuda_halo.probing_launches(strips, rule, plan, 8, timed)
                torch.cuda.synchronize()
                per.append(sum(s.elapsed_time(f) for s, f in spans) / len(spans))
            seq = (lambda strips=strips, plan=plan:
                   cuda_halo.probing_launches(strips, rule, plan, 8))
            out[f"{key}_{name}"] = dict(plan=str(plan), in_sequence=spread(per),
                                        device_ms=device_ms(seq, 1, lambda k: "strip_probing" in k))
    return out


def k4_kernel(k: str) -> bool:
    """Whether a profiler key is K4's kernel, the register form or the
    first port's."""
    return "board_probing_reg_kernel" in k or "::probing_kernel" in k


def time_k4(cuda_adaptive, boards, rule) -> dict:
    """K4 (``cuda_adaptive.probing_superstep``) on the 16384² boards at the
    port's plan, 8 launches from a zero bitmap (on the settled board the
    first probes every stripe and the other seven elide nearly all):
    median and spread of ``BATCHES`` batches, per launch, and device ms a
    launch."""
    plan = cuda_adaptive.adaptive_plan((BIG, BIG // 32), 10**6)
    out = {}
    for name, p in boards.items():
        def k4(p=p):
            return cuda_adaptive.probing_superstep(p, rule, plan, 8)

        timed = batches(k4, 1)
        out[name] = dict(plan=str(plan), ms_per_launch=spread([t / 8 for t in timed["batches"]]),
                         device_ms=device_ms(k4, 1, k4_kernel))
        if hasattr(cuda_adaptive, "probing_reg_plan"):
            out[name]["blocks"] = str(cuda_adaptive.probing_reg_plan(plan, tuple(p.shape), 132))
    return out


def time_k3(cuda_adaptive, boards, rule) -> dict:
    """K3 (``cuda_adaptive.tiled_skip_superstep``) one launch on the 16384²
    boards at 24 generations (the loose depth of the port's plan) and 18
    (the deepest remainder a dispatch gives it): median and spread of
    ``BATCHES`` batches of 10 launches, and device ms a launch."""
    out = {}
    for name, p in boards.items():
        for t in (24, 18):
            def k3(p=p, t=t):
                return cuda_adaptive.tiled_skip_superstep(p, rule, t)

            out[f"{name}_x{t}"] = dict(**batches(k3, 10),
                                       device_ms=device_ms(k3, 10, lambda k: "tiled_skip" in k))
            if hasattr(cuda_adaptive, "tiled_skip_reg_plan"):
                out[f"{name}_x{t}"]["blocks"] = str(
                    cuda_adaptive.tiled_skip_reg_plan(tuple(p.shape), t, 132))
    return out


def skip_sass(cuda_build) -> dict:
    """The SASS of K3's and K4's loops in this checkout's ``tiled_skip``
    and ``probing`` builds (``tools/sass_loop_count.py``): the register
    kernels' generation loops, or the first port's shared-memory row
    loops."""
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import sass_loop_count as slc

    return {k: v for k, v in slc.kernel_loops(cuda_build, ("tiled_skip", "probing")).items()
            if k.startswith(("K3", "K4"))}


def sweep_k3_k4(cuda_adaptive, boards, rule) -> list:
    """K4 on the 16384² boards at every block height ``probing_reg_plan``
    weighs (each divisor of the 256-row stripe of 8 rows or more, and runs
    of 2 to 32 whole stripes whose window fits 16 warps; 8 launches from a
    zero bitmap), and K3 at 24 generations at every block height
    ``tiled_skip_reg_plan`` weighs (``torus_reg_plans``), each forced
    through the wrapper: device ms a launch beside the plan's cost on 132
    SMs and its pick."""
    from distributed_gol_torch.ops.cuda_adaptive import REG_MAX_WARPS, REG_RUN, RegPlan

    rows = []
    shape = (BIG, BIG // 32)
    plan = cuda_adaptive.adaptive_plan(shape, 10**6)
    pick4 = cuda_adaptive.probing_reg_plan(plan, shape, 132)
    heights = [d for d in range(8, plan.stripe_h + 1) if plan.stripe_h % d == 0]
    heights += [k * plan.stripe_h for k in range(2, 33) if BIG % (k * plan.stripe_h) == 0]
    pick3 = cuda_adaptive.tiled_skip_reg_plan(shape, 24, 132)
    for name, p in boards.items():
        for tile_h in heights:
            warps = -(-(tile_h + 2 * plan.pad) // REG_RUN)
            if warps > REG_MAX_WARPS:
                continue
            blocks = RegPlan(plan.t, plan.pad, tile_h, warps, (BIG // tile_h, pick4.grid[1]), 1, 6)
            rows.append(dict(kernel="K4", board=name, plan=str(blocks), cost=blocks.cost(132),
                             chosen=blocks == pick4, device_ms=device_ms(
                                 lambda: cuda_adaptive.probing_superstep(p, rule, plan, 8,
                                                                         blocks),
                                 1, k4_kernel)))
        for blocks in cuda_adaptive.torus_reg_plans(shape, 24, 6):
            rows.append(dict(kernel="K3", board=name, plan=str(blocks), cost=blocks.cost(132),
                             chosen=blocks == pick3, device_ms=device_ms(
                                 lambda: cuda_adaptive.tiled_skip_superstep(p, rule, 24, blocks),
                                 10, lambda k: "tiled_skip" in k)))
    return rows


def trace_long(root: Path) -> dict:
    """The one-device 16384² x 100,000 run under ``torch.profiler``
    (``chip_smoke.profile_run`` of the checkout at ``root``): device ms by
    kernel, launch by launch, and the loop's seconds."""
    sys.path.insert(0, str(root))
    import chip_smoke

    out = chip_smoke.profile_run(100_000)
    keep = ("frontier_reg_kernel", "board_probing_reg_kernel", "probing_kernel",
            "tiled_skip_reg_kernel", "tiled_skip_kernel", "tiled_reg_kernel")
    out["port_kernels"] = {k: v for k, v in out["port_kernels"].items() if k in keep}
    return out


def probing_stencil_sass(cuda_build) -> dict:
    """The SASS of K6's, K11's and K13's loops in this checkout's
    ``stencil`` and ``probing`` builds (``tools/sass_loop_count.py``)."""
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import sass_loop_count as slc

    return {k: v for k, v in slc.kernel_loops(cuda_build, ("stencil", "probing")).items()
            if k.startswith(("K6", "K11", "K13"))}


def sweep_k6_k11(cuda_stencil, cuda_halo, shards, boards, byte_soup, rule) -> list:
    """K6 at 16384² and 512² at every run height from 4 to 128 rows
    (forced in place of ``cuda_stencil.RUN_ROWS``), and K11 at both of
    ``k11_plans`` on the fresh and settled (4, 1) strips at every block
    height whose window fits 16 warps, a divisor of the stripe or up to 32
    whole stripes that divide the strip (forced in place of
    ``cuda_halo.strip_reg_plan``): device ms a launch, beside the plan's
    pick."""
    from distributed_gol_torch.ops.cuda_adaptive import REG_MAX_WARPS, REG_RUN, RegPlan

    rows = []
    chosen_run, chosen_k11 = cuda_stencil.RUN_ROWS, cuda_halo.strip_reg_plan
    try:
        for n in (BIG, 512):
            b = byte_soup(n, n, 23)
            dst = torch.empty_like(b)
            for run in (4, 8, 16, 32, 64, 128):
                cuda_stencil.RUN_ROWS = run
                rows.append(dict(kernel="K6", board=f"{n}x{n}", run_rows=run,
                                 chosen=run == chosen_run, device_ms=device_ms(
                                     lambda: cuda_stencil.stencil_step(b, rule, out=dst), 20,
                                     lambda k: "stencil_kernel" in k)))
        cuda_stencil.RUN_ROWS = chosen_run
        strip, plans = k11_plans(cuda_halo)
        for key, plan in plans.items():
            best = chosen_k11(plan, strip, 132)
            tiles = [d for d in range(1, plan.stripe_h + 1) if plan.stripe_h % d == 0]
            tiles += [k * plan.stripe_h for k in range(2, 33) if strip[0] % (k * plan.stripe_h) == 0]
            for name, p in boards.items():
                strips = [row[0] for row in shards(p, (4, 1)).shards]
                for tile_h in tiles:
                    warps = -(-(tile_h + 2 * plan.pad) // REG_RUN)
                    if warps > REG_MAX_WARPS:
                        continue
                    forced = RegPlan(plan.t, plan.pad, tile_h, warps,
                                     (strip[0] // tile_h, -(-strip[1] // 30)), 1, 6)
                    cuda_halo.strip_reg_plan = lambda *a, _p=forced: _p
                    rows.append(dict(kernel="K11", plan=key, board=name, blocks=str(forced),
                                     cost=forced.cost(132), chosen=forced == best,
                                     device_ms=device_ms(
                                         lambda: cuda_halo.probing_launches(strips, rule, plan, 8),
                                         1, lambda k: "strip_probing" in k)))
    finally:
        cuda_stencil.RUN_ROWS, cuda_halo.strip_reg_plan = chosen_run, chosen_k11
    return rows


def time_pod(dev) -> dict:
    """Serving pod (a) through ``ServePlane`` in process: 16 tenants of
    512² soups (density 0.3, seeds 100..115) x 10,000 turns, batched,
    superstep 64 (K7), ``POD_RUNS`` times after one warm-up pod: each
    run's wall-clock, aggregate gens/s and K7 launches, and the median
    and spread of the aggregate rate."""
    import tempfile

    import distributed_gol_torch as gol
    from distributed_gol_torch.ops import cuda_packed
    from distributed_gol_torch.serve import ServeConfig, ServePlane

    nt, side, turns, superstep = 16, 512, 10_000, 64
    seen = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(POD_RUNS + 1):
            params = [gol.Params(turns=turns, image_width=side, image_height=side,
                                 soup_density=0.3, soup_seed=100 + i, superstep=superstep,
                                 turn_events="batch", ticker_period=3600, device=dev.type,
                                 out_dir=Path(tmp) / f"{rep}" / f"t{i}") for i in range(nt)]
            config = ServeConfig(max_sessions=nt, batched=True, max_total_cells=nt * side * side)
            before = cuda_packed.resident_superstep_batched.launches
            t0 = time.perf_counter()
            with ServePlane(config) as plane:
                handles = [plane.submit(f"t{i}", p) for i, p in enumerate(params)]
                if not plane.wait_idle(timeout=900):
                    raise RuntimeError("pod (a): tenants still resident after 900 s")
                wall = time.perf_counter() - t0
            if any(h.status != "completed" for h in handles):
                raise RuntimeError("pod (a): a tenant did not complete")
            seen.append(dict(wall_s=wall, aggregate_gens_per_s=nt * turns / wall,
                             k7_launches=cuda_packed.resident_superstep_batched.launches - before))
    return dict(runs=seen[1:], aggregate_gens_per_s=spread(
        [r["aggregate_gens_per_s"] for r in seen[1:]]))


def time_paths(dev, names=None) -> dict:
    """The main paths K2, K6, K7 and K11 carry, each through ``gol.run`` of
    the checkout on the card with its stream consumed as it is produced,
    on the 16384² soup (density 0.3, seed 7): the frames viewer x 500 (K6
    a turn), path (g) (x 2,000 on (4, 1) virtual strips at a stripe cap of
    16, ``skip_stable``: K11), path (e) (x 100,000 on (4, 1) under auto:
    K14 chunks, K11's loose tails) and the headless run x 2,000 on one
    device (K2); and serving pod (a) (K7, ``time_pod``).  Each run's
    seconds and its dispatch loop's (the MetricsReport's
    ``controller.dispatch_seconds``), after one warm-up run of each.
    ``names`` picks some of them (None: all)."""
    import tempfile

    import distributed_gol_torch as gol
    from distributed_gol_torch.engine.backend import Backend

    soup = dict(image_width=BIG, image_height=BIG, soup_density=0.3, soup_seed=7,
                ticker_period=3600)
    runs = {"frames_x500": dict(turns=500, no_vis=False),
            "g_4x1_cap16_x2000": dict(turns=2000, skip_stable=True, skip_tile_cap=16,
                                      mesh_shape=(4, 1), turn_events="batch"),
            "e_4x1_x100000": dict(turns=100_000, mesh_shape=(4, 1), turn_events="batch"),
            "one_device_x2000": dict(turns=2000, turn_events="batch"),
            "one_device_x100000": dict(turns=100_000, turn_events="batch")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, kw in runs.items():
            if names and key not in names:
                continue
            seen = []
            for rep in range(2):
                params = gol.Params(out_dir=Path(tmp) / f"{key}_{rep}", device=dev.type, **soup,
                                    **kw)
                ny, nx = params.mesh_shape
                backend = Backend(params, [dev] * (ny * nx)) if ny * nx > 1 else None
                events = gol.EventQueue()
                t0 = time.perf_counter()
                engine = gol.start(params, events, None, None, backend)
                report = None
                done = False
                while not done:
                    for e in events.get_many(timeout=300):
                        if e is None:
                            done = True
                            break
                        if isinstance(e, gol.MetricsReport):
                            report = e.snapshot
                seconds = time.perf_counter() - t0
                engine.join(timeout=60)
                seen.append(dict(seconds=seconds, loop_s=report["histograms"][
                    "controller.dispatch_seconds"]["sum"],
                    engine=report["info"]["backend.engine"]))
            out[key] = seen[-1]
            out[key]["gens_per_s"] = kw["turns"] / out[key]["seconds"]
            out[key]["loop_gens_per_s"] = kw["turns"] / out[key]["loop_s"]
    if not names or "pod_a" in names:
        out["pod_a"] = time_pod(dev)
    return out


def sweep(cuda_halo, halo, shards, big, boards, rule) -> dict:
    """K9 on the (4, 1) and (2, 2) shards at 32 generations, and K13 on the
    (2, 2) tile fresh and settled, at every block height the plans weigh
    (``ext_reg_plan``'s tallest tile for 1 to 16 warps; each divisor of
    K13's stripe), each forced in place of the plan the wrapper would take:
    the plan's cost on 132 SMs beside the kernel's device ms (the frontier
    kernels: ``sweep_frontier``)."""
    from distributed_gol_torch.ops.cuda_adaptive import REG_MAX_WARPS, REG_RUN, RegPlan

    rows = []
    chosen, chosen_tile = cuda_halo.ext_reg_plan, cuda_halo.tile_reg_plan
    try:
        for mesh_shape in ((4, 1), (2, 2)):
            sb = shards(big, mesh_shape)
            xpad = 1 if mesh_shape[1] > 1 else 0
            e = halo.extend(sb, 32, xpad)[0][0]
            for warps in range(3, REG_MAX_WARPS + 1):
                h_loc, wpl = sb.shard_shape
                nrb = -(-h_loc // (warps * REG_RUN - 64))
                tile_h = -(-h_loc // nrb)
                plan = RegPlan(32, 32, tile_h, -(-(tile_h + 64) // REG_RUN), (nrb, -(-wpl // 30)))
                cuda_halo.ext_reg_plan = lambda *a, _p=plan: _p
                rows.append(dict(kernel="K9", mesh=list(mesh_shape), plan=str(plan),
                                 cost=plan.cost(132), fill=plan.fill(132),
                                 chosen=plan == chosen(sb.shard_shape, 32, 132),
                                 device_ms=device_ms(
                                     lambda: cuda_halo.ext_launch(e, rule, 32, 32, xpad), 20,
                                     lambda k: "ext_" in k)))
        cuda_halo.ext_reg_plan = chosen
        tile = (BIG // 2, BIG // 64)
        aplan, xpad = cuda_halo.adaptive_tile_plan(tile, 10**6)
        for name, p in boards.items():
            e = halo.extend(shards(p, (2, 2)), aplan.pad, xpad)[0][0]
            grid = aplan.grid(tile[0])
            elig = torch.zeros(grid, dtype=torch.int32, device=e.device)
            st = torch.ones(grid, dtype=torch.int32, device=e.device)
            dst = torch.empty(tile, dtype=torch.int32, device=e.device)
            best = chosen_tile(aplan, tile, xpad, 132)
            for tile_h in [d for d in range(8, aplan.stripe_h + 1) if aplan.stripe_h % d == 0]:
                plan = RegPlan(aplan.t, aplan.pad, tile_h, -(-(tile_h + 2 * aplan.pad) // REG_RUN),
                               (tile[0] // tile_h, -(-(tile[1] + 2 * xpad) // 30)), 1, 6)
                if plan.warps > REG_MAX_WARPS:
                    continue
                cuda_halo.tile_reg_plan = lambda *a, _p=plan: _p
                rows.append(dict(kernel="K13", board=name, plan=str(plan), cost=plan.cost(132),
                                 fill=plan.fill(132), chosen=plan == best,
                                 device_ms=device_ms(
                                     lambda: cuda_halo.tile_probing_launch(e, elig, dst, st, rule,
                                                                           aplan, xpad),
                                     20, lambda k: "tile_probing" in k)))
    finally:
        cuda_halo.ext_reg_plan, cuda_halo.tile_reg_plan = chosen, chosen_tile
    return rows


def sweep_frontier(cuda_halo, cases) -> list:
    """Each of ``frontier_cases`` at every row tile of 8 rows or more that
    divides the stripe and whose window fits 16 warps, each forced in
    place of ``cuda_adaptive.frontier_blocks``' pick: the cost on 132 SMs
    of the plan of all the shards a launch covers, beside the frontier
    kernel's and the finalize's device ms a launch."""
    from distributed_gol_torch.ops import cuda_adaptive
    from distributed_gol_torch.ops.cuda_adaptive import REG_MAX_WARPS, REG_RUN, RegPlan

    chosen = cuda_adaptive.frontier_blocks
    rows = []
    try:
        for key, plan, shape, n, fn, per, tests in cases:
            best = chosen(shape, plan, n, 132)
            halo = plan.t + 6
            for tile_h in [d for d in range(8, plan.stripe_h + 1) if plan.stripe_h % d == 0]:
                warps = -(-(tile_h + 2 * halo) // REG_RUN)
                if warps > REG_MAX_WARPS:
                    continue
                forced = RegPlan(halo, halo, tile_h, warps, (shape[0] // tile_h, -(-shape[1] // 30)),
                                 keep=True)
                stacked = dataclasses.replace(forced, grid=(n * forced.grid[0], forced.grid[1]))
                cuda_adaptive.frontier_blocks = cuda_halo.frontier_blocks = (
                    lambda *a, _p=forced: _p)
                kernel, board = key.split("_", 1)
                rows.append(dict(kernel=kernel.upper(), board=board, plan=str(forced),
                                 cost=stacked.cost(132), chosen=forced == best,
                                 device_ms=device_ms_by_kernel(fn, tests, per)))
    finally:
        cuda_adaptive.frontier_blocks = cuda_halo.frontier_blocks = chosen
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K9, K10, K11, K13 and the frontier kernels at every block "
                         "height the plans weigh, K1 at every cluster size and K6 at every "
                         "run height")
    ap.add_argument("--sweep-k2-k7", action="store_true",
                    help="also time K2 at every block height and depth its plan weighs and K7 "
                         "at every cluster size")
    ap.add_argument("--sweep-k3-k4", action="store_true",
                    help="also time K4 and K3 at every block height their plans weigh")
    ap.add_argument("--trace-long", action="store_true",
                    help="also trace the one-device 16384^2 x 100,000 run (K5, K4, K3, K2)")
    ap.add_argument("--paths", action="store_true",
                    help="also time the frames viewer, paths (g) and (e), the 16384^2 x 2,000 "
                         "run and pod (a) end to end")
    ap.add_argument("--path", action="append", default=[],
                    help="with --paths, time only this path (frames_x500, g_4x1_cap16_x2000, "
                         "e_4x1_x100000, one_device_x2000, one_device_x100000, pod_a); may "
                         "repeat")
    ap.add_argument("--frontier", action="store_true",
                    help="time only the frontier kernels (K5, K8, K12, K14, K15), fresh, "
                         "settled and sparse, and their SASS")
    ap.add_argument("--sweep-frontier", action="store_true",
                    help="also time K15, K12, K5, K14 and K8 at every block height their "
                         "plan weighs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("regwin_ab: no CUDA GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from distributed_gol_torch.models.life import CONWAY
    from distributed_gol_torch.ops import (
        cuda_adaptive, cuda_build, cuda_packed, cuda_stencil, packed)
    from distributed_gol_torch.parallel import cuda_halo, halo, mesh as mesh_lib
    from distributed_gol_torch.utils.soup import random_soup

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    cuda_build.build("resident", "ext", "probing", "tiled", "tiled_skip", "frontier", "stencil")

    def soup(h, w, seed, vertical=False):
        b = torch.from_numpy(random_soup(h, w, 0.3, seed)).to(dev)
        return b if vertical else packed.pack(b)

    def byte_soup(h, w, seed):
        return torch.from_numpy(random_soup(h, w, 0.3, seed)).to(dev)

    def shards(p, mesh_shape):
        m = mesh_lib.make_mesh(mesh_shape, [dev] * (mesh_shape[0] * mesh_shape[1]))
        return halo.board_sharding(m).shard(p)

    out = dict(label=args.label, root=str(root), card=card, k9={}, k13={})
    big = soup(BIG, BIG, 7)
    if args.frontier:
        cases = []
    else:
        cases = [("4x1", big, (4, 1), (32, 18, 5)), ("2x2", big, (2, 2), (32, 18, 5)),
                 ("c_8x1_512", soup(512, 512, 7), (8, 1), (32,)),
                 ("f_8x1_520x512", soup(520, 512, 7), (8, 1), (5,)),
                 ("i_4x2_520x1024", soup(520, 1024, 7), (4, 2), (5,))]
    for name, p, mesh_shape, depths in cases:
        sb = shards(p, mesh_shape)
        for t in depths:
            xpad = -(-t // 32) if mesh_shape[1] > 1 else 0
            e = halo.extend(sb, t, xpad)[0][0]
            def k9(e=e, t=t, xpad=xpad):
                return cuda_halo.ext_launch(e, CONWAY, t, t, xpad)

            out["k9"][f"{name}_t{t}"] = dict(
                shape=list(e.shape), t=t, xpad=xpad, **batches(k9, 20),
                device_ms=device_ms(k9, 20, lambda k: "ext_" in k and "skip" not in k))

    # Made once (100,000 generations of K2) and kept beside this script's
    # checkout's builds for the next run.
    settled_path = Path(__file__).resolve().parents[1] / "build" / "regwin_ab_settled.pt"
    if settled_path.is_file():
        settled = torch.load(settled_path).to(dev)
    else:
        settled = cuda_packed.tiled_superstep(big, CONWAY, 100_000)
        settled_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(settled.cpu(), settled_path)
    boards = {"fresh": soup(BIG, BIG, 13), "settled": settled}
    for mesh_shape, cap in (() if args.frontier else (((2, 2), 0), ((2, 4), 16))):
        tile = (BIG // mesh_shape[0], BIG // 32 // mesh_shape[1])
        plan, xpad = cuda_halo.adaptive_tile_plan(tile, 10**6, cap)
        for name, p in boards.items():
            sb = shards(p, mesh_shape)
            e = halo.extend(sb, plan.pad, xpad)[0][0]
            grid = plan.grid(tile[0])
            elig = torch.zeros(grid, dtype=torch.int32, device=dev)
            st = torch.ones(grid, dtype=torch.int32, device=dev)
            dst = torch.empty(tile, dtype=torch.int32, device=dev)
            def k13(e=e, elig=elig, dst=dst, st=st, plan=plan, xpad=xpad):
                return cuda_halo.tile_probing_launch(e, elig, dst, st, CONWAY, plan, xpad)

            alone = batches(k13, 20)
            alone["device_ms"] = device_ms(k13, 20, lambda k: "tile_probing" in k)
            cuda_halo.tile_probing_launches(sb, CONWAY, plan, xpad, 2)  # warm-up
            per = []
            for _ in range(BATCHES):
                spans = []

                def timed(*a, _spans=spans):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    r = cuda_halo.tile_probing_launch(*a)
                    end.record()
                    _spans.append((start, end))
                    return r

                cuda_halo.tile_probing_launches(sb, CONWAY, plan, xpad, 8, timed)
                torch.cuda.synchronize()
                per.append(sum(s.elapsed_time(f) for s, f in spans) / len(spans))
            out["k13"][f"{mesh_shape[0]}x{mesh_shape[1]}_{name}"] = dict(
                plan=str(plan), xpad=xpad, alone=alone, in_sequence=spread(per))
    pods = {"fresh": pod_stack(soup, 51)}
    pod_path = settled_path.with_name("regwin_ab_pod_settled.pt")
    if pod_path.is_file():
        pods["settled"] = torch.load(pod_path).to(dev)
    else:
        pods["settled"] = torch.stack([cuda_packed.tiled_superstep(b.contiguous(), CONWAY, 100_000)
                                       for b in pods["fresh"]])
        torch.save(pods["settled"].cpu(), pod_path)
    boards["sparse"], pods["sparse"], tile_board = sparse_boards(packed, dev)
    frontier = frontier_cases(cuda_adaptive, cuda_halo, shards, boards, pods, CONWAY, tile_board)
    out["frontier"] = time_frontier(frontier)
    out["frontier_sass"] = frontier_sass(cuda_build)
    if args.frontier:
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out) + "\n")
        return 0
    out["k1"] = time_k1(cuda_packed, packed, soup, CONWAY)
    k10 = k10_cases(halo, shards, big, boards, soup)
    out["k10"] = time_k10(cuda_halo, k10, CONWAY)
    out["resident_ext_sass"] = resident_ext_sass(cuda_build)
    out["k6"] = time_k6(cuda_stencil, byte_soup, CONWAY)
    out["k11"] = time_k11(cuda_halo, shards, boards, CONWAY)
    out["k4"] = time_k4(cuda_adaptive, boards, CONWAY)
    out["k3"] = time_k3(cuda_adaptive, boards, CONWAY)
    out["k2"] = time_k2(cuda_adaptive, cuda_packed, boards["fresh"], CONWAY)
    out["tiled_sass"] = tiled_sass(cuda_build)
    try:
        out["skip_sass"] = skip_sass(cuda_build)
    except (ValueError, subprocess.CalledProcessError) as exc:  # a loop the parser cannot find
        out["skip_sass"] = dict(error=repr(exc))
    try:
        out["probing_stencil_sass"] = probing_stencil_sass(cuda_build)
    except (ValueError, subprocess.CalledProcessError) as exc:  # a loop the parser cannot find
        out["probing_stencil_sass"] = dict(error=repr(exc))
    if args.paths:
        out["paths"] = time_paths(dev, args.path)
    if args.trace_long:
        out["trace_long"] = trace_long(root)
    if args.sweep:
        out["sweep"] = sweep(cuda_halo, halo, shards, big, boards, CONWAY) + sweep_frontier(
            cuda_halo, frontier)
        if hasattr(cuda_packed, "resident_reg_plan"):
            out["sweep"] += sweep_k1_k10(cuda_packed, cuda_halo, packed, soup, k10, CONWAY)
        if hasattr(cuda_stencil, "RUN_ROWS") and hasattr(cuda_halo, "strip_reg_plan"):
            out["sweep"] += sweep_k6_k11(cuda_stencil, cuda_halo, shards, boards, byte_soup,
                                         CONWAY)
        if hasattr(cuda_packed, "tiled_reg_plan"):
            out["sweep"] += sweep_k2_k7(cuda_adaptive, cuda_packed, packed, boards["fresh"],
                                        soup, CONWAY)
    elif args.sweep_frontier:
        out["sweep"] = sweep_frontier(cuda_halo, frontier)
    elif args.sweep_k3_k4:
        out["sweep"] = sweep_k3_k4(cuda_adaptive, boards, CONWAY)
    elif args.sweep_k2_k7:
        out["sweep"] = sweep_k2_k7(cuda_adaptive, cuda_packed, packed, boards["fresh"], soup,
                                   CONWAY)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
