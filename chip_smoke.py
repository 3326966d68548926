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
512² board x 2, pooled full-board frames of the 16384² soup x 250, a
1024² viewport of it x 500 with delta frames and pan/zoom keys, and the
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
(f)'s (8, 1) strips at every depth that path launches; and the in-kernel
tier's K14, held to its plain version on the soup split (4, 1), (2, 1)
and (1, 1), fresh, settled and with gliders across every seam, in chunks
of 8 and 64 launches, and to K5 on the whole board): (e) the 16384² soup x
100,000 on (4, 1) under auto (the in-kernel tier: K14 chunks, K11 for the
loose tails, K10 and K9 for the remainders), equal to the single-device
100,000-turn PGM; (k) the same with ``DGOL_ICI=0``, on the ppermute tier
(K12), equal to the same PGM; (f) 520 x 512 x 3,000 on
(8, 1), whose strips have no adaptive plan (K10 on every launch), equal to
a single-device rerun; (g) the soup x 2,000 on (4, 1) at a stripe cap of
16 (K11), equal to the single-device 2,000-turn PGM.  Then the
``skip_stable`` runs on 2-D meshes (the adaptive tile tier, K13 and K10
at xpad > 0, first held bit for bit against their plain versions on
(2, 2) and (2, 4) tiles of the 16384² soup, fresh, settled and with
gliders across the seams and a corner, skip counts and activity grids
too, and K10 and K9 on path (i)'s (4, 2) tiles at every depth that path
launches; and the in-kernel tier's K15, held to its plain version on the
soup split (2, 2), (2, 4) and (1, 2), fresh, settled and with the seam
and corner gliders, in chunks of 8 and 64 launches and launch by launch,
and in whole dispatches with a K13 tail, and on the sparse board with
gliders across the (2, 2) tiles' seams and a corner, at the shipped
geometry (no rectangle route) and at (96, 128), where every route and
the elided edge stripe must run): (h) the 16384² soup x 100,000
on (2, 2) under auto (the in-kernel tier: K15 chunks, K13 for the loose
tails, K10 and K9 for the remainders), equal to the single-device
100,000-turn PGM; (l) the same with ``DGOL_ICI=0``, on the ppermute tier
(K13), equal to the same PGM; (h) again with ``skip_stable=False`` (K9
alone); (i) 520 x 1024 x 3,000 on (4, 2), whose tiles have no adaptive
plan (K10 at xpad 1 on every launch), equal to a single-device rerun;
(j) the soup x 2,000 on (2, 4) at a stripe cap of 16 (K13), equal to the
single-device 2,000-turn PGM.  Then the resilience paths: (m) time
compression (``time_compression=True``, superstep 240, a cycle probe
every 2 dispatches) on the 16384² soup x 100,000 under auto (K5, K4,
K3), a first run that misses the ``AshCache`` and a second that hits
it (repeated to ``REPS`` runs), each equal to the long run's PGM, turns
and final alive count, and two 'q'-detaches inside
the compressed interval whose sidecars carry the cumulative
computed-against-effective split before a last resume writes the long
run's PGM; (n) the 16384² soup x 2,000 (K2) through ``gol.run`` with
``restart_limit=3``, an SDC check every dispatch, periodic checkpoints
and a ``FaultInjectionBackend`` carried across
the attempts (a corrupt caught by the sentinel and rolled back, a hang
past the dispatch watchdog rebuilt, an issue burst rebuilt on the elastic
rung), equal to the unsupervised run's PGM, with the run's telemetry
sampler holding samples and its final snapshot round-tripping through
OpenMetrics; (o) the soup x 20,000 on (4, 1) with ``skip_stable`` and two
issue bursts that take the ladder to its forced-ppermute rung: K14 before
the escalation, K12 after it, equal to the single-device PGM.  Then the
viewers on a mesh, (p): the 16384² soup x 2,000 with the frames viewer
at a frame stride of 32 under ``auto``, pooled by 24 x 24 windows that
cross the shard seams, on one device (K2) and on (2, 2) and (4, 1) (K9
on every shard), each mesh's stream equal to the one-device stream frame
for frame and its PGM to the headless run's; a 1024² viewport over a
shard seam and the torus seam on (2, 2) against one device; and the 512²
flips on (4, 1) (roll, no kernel), whose XOR-rebuilt board equals the
final PGM.  And one pod's wire, (q): ``serve --gateway-port 0
--telemetry-port 0`` (the CLI's ``serve_main`` on a thread of this
process, so its launches count) with a 16384² tenant on per-turn frames
(K6) and a 512² tenant at a frame stride of 16 (K1), submitted over HTTP
and watched by two wire spectators each (``Spectator``: the port's own
``serve/ws.py`` and ``serve/wire.py``, never ``tools/gol_client.py``,
which imports the JAX package) whose rects wrap the torus; each
spectator's last frame must equal ``Backend.fetch_viewport`` of the final
board, each tenant's PGM its solo rerun, and ``/metrics`` must
round-trip through OpenMetrics.  And a federation on the one card, (r):
pod A ``python3 -m distributed_gol_torch serve --device cuda`` in a child
process and pod B ``serve_main`` on a thread, on one checkpoint root,
behind the port's ``Broker`` with its collector; alice (the 16384² soup x
2,000, a checkpoint every 400 turns, K2) is placed on A, which
``PodChaos`` SIGKILLs once she passes turn 600, and the broker readopts
her on B from her newest checkpoint; carol (512² x 8,000 at a frame
stride of 16, K1) runs on B, watched directly and at depth 2 through two
``RelayServer``s, the first behind a ``ChaosProxy`` that drops its first
connection.  Both PGMs must equal their solo reruns, every spectator's
last frame ``fetch_viewport`` of carol's final board, ``broker.failovers``
rise by one, and the collector's ``/fleet/metrics``, ``/fleet/flight`` and
``/fleet/traces/<id>`` must round-trip, read condemn before failover, and
join the broker's and pod B's spans.  And multi-host on the one card, (s):
two ranks of the CLI (``--coordinator``; ``rank_main``, each in its own
process with the card as its one device, so the mesh (2, 1) spans them,
gloo staging the edges through host memory): (s1) the 16384² soup x
2,000 at superstep 200 (K9 on each rank), process 0's PGM equal to path
(a)'s; (s2) the soup x 10,000 with ``--skip-stable`` at superstep 0 (K12
on each rank's 8192-row strip, the K10 and K9 remainders), the PGM equal
to a one-device skip_stable run's and process 0's skip count, dispatch
by dispatch, to the same dispatches' on one process; (s3) a 512² soup
with a 0.2 s peer heartbeat and a checkpoint every 100 turns, rank 1
SIGKILLed after the first checkpoint, rank 0 ending with PeerLost within
its bound, the newest checkpoint resumed on one device to the
never-killed run's PGM; no rank launches K14 or K15, and each leg prints
its wall-clock, each rank's start-up, launches and exchange ms.  And the
flagship board, (t): a seeded 65536² soup (4 GiB a board, made on the
card and read by every leg as its input PGM) through ``gol.run``: (t1) x
2,000 on one device (K2), its PGM checked against the run's own final
board, and x 256 on K2 beside ``engine="packed"``; (t2) x 100,000 where
``skip_stable`` engages by itself (K5, K4, K3) beside a K2 rerun; (t3)
both on BASELINE config 4's (4, 1) layout as a virtual mesh (K14, K11,
K10, K9; K9), held to (t2) and (t1); (t4) a 1024² viewport that wraps
the torus on both axes x 200 at stride 1 (K6), every frame held to its
light cone stepped on the roll engine; (t5) x 2,000 supervised with an
SDC check every 500 turns, a checkpoint every 1,000 and one corrupt,
rolled back once and equal to (t1); (t6) a 0.6 soup (past 2^31 alive) x
10 on one device and (4, 1), its turn-0 count read from the ticker while
paused and its final count from the PGM.  Each leg prints its run and
dispatch-loop gens/s, launches, host passes and peak
``max_memory_allocated``, which must stay below half the card's memory;
the packing passes those legs run beside the kernels (``ops/packed.py``,
the alive counts, the SDC fingerprint) are held to numpy on the card
first (``check_packing``), and phase 4 holds K2, K5, K9 and K14 to their
plain versions at the flagship's shapes and times them there
(``flagship_kernels``).  ``--flagship`` runs the build, ``check_packing``,
path (t) and ``flagship_kernels`` alone (``--profile`` adds traces of (t1)
and of (t2)'s K2 rerun).  Every run
row is published as ``{reps, median, spread}`` (``utils/measure.py``; a
run under 5 s is repeated to 2 runs) and the record is linted with
``measure.require_headline_stats`` before it prints.  It
checks that every kernel of each path launched in it, times every kernel
against its plain version and its bound (and a viewer turn's parts at
16384², K6 with and without its count beside a byte copy of the board,
K7 beside 16 sequential K1
launches (and at 3 x 1024 x 1792, with its plan's clusters and waves), K2
with its device ms and its 16-generation remainder launch, and K9 on a
(4, 1) strip and a (2, 2) tile beside K2 on the
whole board and beside the halo exchange, K10-K12 on a (4, 1) strip
and K13 and K10 on a (2, 2) tile beside their plain versions, K14 a
launch over the (4, 1) strips and K15 a launch over the (2, 2) tiles,
each beside its ppermute tier's launch and K5 on the whole board; K9,
K12, K13, K15 and their controls K2, K4, K5, K8, K10 and K14 as the
median and spread of 5 event-timed batches, K13 also back to back), and
prints the
seconds of each step of phases 2 and 3 (``step_seconds``), one
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  The build fails the run if any of the
fifteen kernels (``csrc/regwin.cuh``, K1's and K6's) spills a register
(``-Xptxas -v``).  K3 and K4 (with their skip counts and activity) are
held under every rule instantiation to their block mirrors on the card
(``cuda_adaptive.tiled_skip_reg_mirror``,
``probing_superstep_reg_mirror``) at 16384², fresh and settled, on narrow
boards, a board of one stripe and tori shorter than K3's halo, and timed
fresh and settled with their device ms.  K2 is held at every rule instantiation on
16384², the odd board and the small and degenerate tori, there also
against its block mirror on the card (``cuda_packed.tiled_reg_mirror``);
K7 at four stacks (132 x 512² among them) under every instantiation,
slot 0 against K1 and against its batched mirror at the card's plan
(``resident_superstep_batched_mirror``).  K6 and its count are held to its plain version at 512²,
16384² and the gate's odd shapes under three rules, and the viewer paths
must take each turn's count from K6 (no separate sum of the board); K11
is held to its block mirror on the card at paths (g)'s and (e)'s tail
plans, and its settled launch must elide every stripe.  K9 and K13 are
held at every depth 1-32, under a third
rule that takes their generic instantiation, and at paths (c), (f), (i)
and (j)'s shapes; K12 launch by launch also at path (g)'s frontier plan
(T = 6 on 16-row stripes) and under the third rule, and K15 under it too
and against its mirror on the card (``cuda_halo.tile_mega_launch_mirror``:
its blocks and the edge stripes it elides, which the bound of K15's
settled launch leaves out); K5, K8 and K14 under the third rule too and
against their block mirrors on the card
(``cuda_adaptive.frontier_launch_reg_mirror``,
``frontier_batched_reg_mirror``, ``cuda_halo.strip_mega_launch_mirror``).
``--profile`` adds a
``torch.profiler`` breakdown of the two headless 16384² runs, of the
three viewer paths, of the sharded (4, 1) run and of paths (e), (k) and
(h) (with the exchange's memcpy time per launch, and each of the port's
kernels launch by launch: ``launch_times``); ``--sweep`` times the adaptive tier over launch
depths and stripe heights (the sweep that chose
``cuda_adaptive.ADAPTIVE_T`` and ``SKIP_TILE_CAP``).  Every phase raises
on failure; without a CUDA GPU it exits non-zero before printing any
result.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock
from urllib.parse import urlsplit

import zlib

import numpy as np
import torch

import distributed_gol_torch as gol
from distributed_gol_torch.engine import frames, pgm, timecomp
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.engine.session import Session
from distributed_gol_torch.obs import metrics, openmetrics, timeseries
from distributed_gol_torch.obs.fleet import node_name
from distributed_gol_torch.serve import Broker, BrokerConfig, RelayServer, ServeConfig, ServePlane
from distributed_gol_torch.serve import wire
from distributed_gol_torch.serve import ws as ws_lib
from distributed_gol_torch.models.life import CONWAY, DAY_AND_NIGHT, HIGHLIFE, LifeRule
from distributed_gol_torch.ops import (
    cuda_adaptive, cuda_build, cuda_packed, cuda_stencil, packed, stencil)
from distributed_gol_torch.parallel import cuda_halo, halo, mesh as mesh_lib
from distributed_gol_torch.testing.faults import (
    Fault, FaultInjectionBackend, FaultPlan, PodChaos)
from distributed_gol_torch.testing.boards import sparse_board
from distributed_gol_torch.testing.netchaos import ChaosProxy, WireFault, WirePlan
from distributed_gol_torch.utils import measure
from distributed_gol_torch.utils.soup import random_soup

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # Hopper: 64 INT32 lanes per SM per clock
RULES = (CONWAY, HIGHLIFE)
# K9's and K13's checks add a rule that takes their generic instantiation
# (the other two are compiled in: regwin.cuh::by_rule).
REG_RULES = (*RULES, DAY_AND_NIGHT)
# Event-timed batches behind the median and spread of the K9 and K13 rows
# and of their controls (K2, K4, K5, K10).
BATCHES = 5
# The kernels of regwin.cuh (K2-K4 among them), K1's and K7's register
# kernel and K6, which must build without spills.
REG_KERNELS = ("ext_reg_kernel", "ext_skip_reg_kernel", "tile_probing_reg_kernel",
               "strip_probing_reg_kernel", "frontier_reg_kernel", "strip_frontier_reg_kernel",
               "strip_mega_reg_kernel", "tile_mega_reg_kernel", "resident_reg_kernel",
               "stencil_kernel", "tiled_reg_kernel", "board_probing_reg_kernel",
               "tiled_skip_reg_kernel")
# K1's boards beside the main path's 512²: (H, W) cells at the gate's
# ragged and extreme shapes (one word row 32, 96 and 58,112 wide, three
# word rows, 40 word rows of 32 columns, 1,816 of them, 64², a serving
# pod's 1024 x 1792), each held to its plain version.
K1_SHAPES = ((32, 32), (32, 96), (96, 64), (1280, 32), (64, 64), (1024, 1792), (32, 58112),
             (32 * 1816, 32))
# The register-resident kernel of each frontier wrapper, as its mangled
# name spells it (length, then name: "frontier_reg_kernel" alone is also
# the tail of "strip_frontier_reg_kernel").
FRONTIER_REG = {k: f"{len(n)}{n}" for k, n in (
    ("frontier", "frontier_reg_kernel"), ("frontier_batched", "frontier_reg_kernel"),
    ("strip_frontier", "strip_frontier_reg_kernel"), ("strip_mega", "strip_mega_reg_kernel"),
    ("tile_mega", "tile_mega_reg_kernel"))}
BIG = 16384
TILED_ODD = (1004, 3072)  # H % 8 != 0 and W/32 % 128 != 0: refused by the TPU gate
# K2's small and degenerate tori (cells): 1-, 2- and 3-row boards, boards
# shorter than their halo and narrower than a warp's window.
TILED_SMALL = ((1, 32), (3, 64), (16, 96), (2, 96), (72, 4096))
# K4's boards beside 16384² (cells, plan): a 3-word board of one stripe
# (narrower than a warp's window), 16-row stripes whose blocks span
# several, and 30 stripes of 16 rows on a board with no frontier plan.
K4_SMALL = (((64, 96), cuda_adaptive.AdaptivePlan(12, 64, True)),
            ((128, 2112), cuda_adaptive.AdaptivePlan(6, 16, True)),
            ((480, 4096), cuda_adaptive.AdaptivePlan(6, 16, False)))
# K3's tori shorter than its halo or narrower than a warp's window (cells,
# T): 8 x 96 at 18, one word at 30, one row, three rows.
K3_SHORT = (((8, 96), 18), ((16, 32), 30), ((1, 32), 6), ((3, 64), 24))
# K7's stacks: the serving pod's 16 x 512², the gate's edge 3 x 1024 x
# 1792, one board, and a full card's 132 x 512².
K7_STACKS = ((16, 512, 512), (3, 1024, 1792), (1, 512, 512), (132, 512, 512))
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
    "strip_mega": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/frontier.cu",
        replaces="distributed_gol_tpu/parallel/pallas_halo.py:454 _kernel_frontier_mega_strip",
    ),
    "tile_mega": dict(
        route="cuda",
        source="distributed_gol_torch/csrc/frontier.cu",
        replaces="distributed_gol_tpu/parallel/pallas_halo.py:1208 _kernel_frontier_mega_2d",
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
    "strip_mega": cuda_halo.strip_mega_launch,
    "tile_mega": cuda_halo.tile_mega_launch,
}
ADAPTIVE = ("tiled_skip", "probing", "frontier")
STRIPS = ("ext_skip", "strip_probing", "strip_frontier")
HALO = ("ext", *STRIPS, "tile_probing", "strip_mega", "tile_mega")  # the sharded forms' kernels
LONG_TURNS = 100_000  # the auto skip_stable threshold (Params._SKIP_AUTO_TURNS)
STENCIL_ODD = (1004, 3076)  # W % 128 != 0 and H % 8 != 0: refused by the TPU gate
# K6's odd shapes beside the main path's: refused by the TPU gate, with
# W % 16 != 0 (the 4-cell instantiation), one row, a board narrower than a
# warp's 30 centre words, and a ragged last run and column group.
STENCIL_SHAPES = (STENCIL_ODD, (1, 4), (3, 100), (7, 20), (1, 48), (33, 132), (130, 4096))
VIEWPORT = (8000, 8000, 1024, 1024)  # the viewport path's starting rect
# Depth of the 16384² frames viewer and of the viewport path, whose keys
# land at a quarter, a half and three quarters of it.
FRAME_TURNS, VIEW_TURNS = 250, 500
# Depth of the two per-cell flip paths (512²: the run and the CLI).  Each
# CellFlipped event costs the host of an H100 machine about 20 µs while
# the stream is consumed (PERF.md), and the seeded board and its first 2
# generations emit 243,954 of them.
FLIP_TURNS = 2
# The serving pods: (tenants, side, turns, superstep).
POD_K7 = (16, 512, 10_000, 64)
POD_K8 = (4, 4096, 10_000, 192)
# K8's sparse stack: these slots of ``testing.boards.sparse_board`` on a
# 4096 x 16384 board (512 words: the column window engages), beside a
# dead one.
K8_SPARSE = ("mid", "spark", "two_columns", "two_rows")
CLI_POD = (4, 512, 2_000, 64)
# The sharded runs' meshes, virtual on the one card: (a) the 16384² soup
# on row strips, (b) on 2-D tiles, (c) the default 512² run, (d) the
# packed word-halo engine at 4096².
MESH_A, MESH_B, MESH_C, MESH_D = (4, 1), (2, 2), (8, 1), (2, 1)
PACKED_SIDE = 4096
# The skip_stable runs on row meshes: (e) the 16384² soup x 100,000 on
# (4, 1) under auto (the in-kernel tier: K14 chunks, K11 for the loose
# tails, the remainders on K10 and K9), and (k) the same with DGOL_ICI=0
# (the ppermute tier: K12); (f) 520 x 512 x
# 3,000 on (8, 1), whose 65-row strips have no multiple-of-8 stripe and so
# no adaptive plan (K10 carries every full launch; a 512² board's 64-row
# strips host a frontier plan at the port's plan); (g) the soup x 2,000 on
# (4, 1) at a stripe cap of 16, which leaves a strip 16-row stripes, T =
# 12 and no frontier plan (K11).
MESH_E, MESH_F = (4, 1), (8, 1)
# K14's checks: the 16384² soup split (4, 1), (2, 1) (north and south the
# same strip) and (1, 1) (the strip its own neighbour).
MEGA_MESHES = (MESH_E, (2, 1), (1, 1))
PLAN_LESS = (520, 512, 3_000)
PROBE_CAP = 16
# The skip_stable runs on 2-D meshes: (h) the 16384² soup x 100,000 on
# (2, 2) under auto (the in-kernel tier: K15 chunks, K13 for the loose
# tails, the remainders on K10 and K9 at xpad 1), and (l) the same with
# DGOL_ICI=0 (the ppermute tier: K13); (i) 520 x 1024 x 3,000 on (4, 2),
# whose 130-row tiles have no multiple-of-8 stripe (K10 at xpad 1 on
# every launch, no K13); (j) the soup x 2,000 on (2, 4) at ``PROBE_CAP``
# (16-row stripes, T = 12: K13).
MESH_H, MESH_I, MESH_J = (2, 2), (4, 2), (2, 4)
TILE_PLAN_LESS = (520, 1024, 3_000)
# K15's checks: the 16384² soup split (2, 2), (2, 4) and (1, 2) (north and
# south the tile itself, west and east one tile); the sparse board split
# (2, 2) at the shipped geometry and at ``TIER_GEOMETRY``, whose 128-word
# column window the 256-word tiles host, launch by launch over
# ``SPARSE_EACH`` launches (its stripe_bottom glider leaves its stripe, a
# skip right after the rectangle route, at launch 8).
TILE_MEGA_MESHES = (MESH_H, MESH_J, (1, 2))
TIER_GEOMETRY = cuda_adaptive.PlanGeometry(96, 128)
SPARSE_EACH = 12
# K14's and K15's 16-launch chunks against their plain versions, by
# (first mesh, board): the boards whose skip state and gliders carry
# across launches.  Every board's 64-launch K14 chunk is also held to
# K5 on the whole board, and every board to 8-launch chunks of three rules.
LONG_RUNS = {(True, "settled"): [(CONWAY, 16)], (True, "seam"): [(CONWAY, 16)]}
# Every run row is published as {reps, median, spread} (utils/measure.py):
# a run shorter than REP_SECONDS is repeated to REPS runs.
REPS, REP_SECONDS = 2, 5.0
# The resilience paths.  (m) time compression on the 16384² soup x
# LONG_TURNS (its last gliders die by about turn 20,000, and the whole
# board repeats with period 6 from there).  (n) the 16384² soup x 2,000
# supervised, superstep N_STEP, every dispatch checked by the SDC
# sentinel, a checkpoint every N_CKPT turns, under N_FAULTS: a corrupt
# (caught, rolled back), a hang past the watchdog's N_DEADLINE seconds
# (rebuilt), and an issue burst (rebuilt on the elastic rung, every device
# healthy); the run's telemetry sampler at N_SAMPLE seconds.  (o) path
# (e)'s soup x O_TURNS on (4, 1) with skip_stable, superstep O_STEP, a
# checkpoint every O_CKPT turns, two issue bursts that take the ladder to
# its forced-ppermute rung: K14 before, K12 after.
# The fast-forward polls the keys at its chunk boundaries (chunks of 6·2^k
# turns): a 'q' at poll 12 lands 12,282 turns into the interval.
DETACH_POLL = 12
N_STEP, N_CKPT, N_DEADLINE, N_SAMPLE = 100, 200, 5.0, 0.25
N_FAULTS = (Fault(2, "corrupt", cells=3), Fault(6, "hang", seconds=120.0),
            Fault(10, "issue"), Fault(11, "issue"))
O_TURNS, O_STEP, O_CKPT = 20_000, 2_000, 4_000
O_FAULTS = (Fault(2, "issue"), Fault(3, "issue"), Fault(4, "issue"), Fault(5, "issue"))
# Path (p), the viewers on a mesh: the 16384² soup x 2,000 with frames at
# stride P_STRIDE (auto: K2 on one device, K9 on every shard), pooled into
# P_FRAME_MAX by windows of 24 x 24 cells, which 4096 and 8192 do not
# divide, so windows cross the shard seams of every mesh in P_MESHES; the
# viewport P_VIEWPORT (rows 16,000-17,023 wrap the torus, columns
# 7,900-8,923 cross the (2, 2) mesh's column seam) x P_VIEW_TURNS on the
# first mesh; and the 512² flips x P_FLIP_TURNS on P_FLIP_MESH (roll;
# host-bound, as the one-device flips are).
P_STRIDE, P_FRAME_MAX, P_MESHES = 32, (700, 700), ((2, 2), (4, 1))
P_VIEWPORT, P_VIEW_TURNS = (16000, 7900, 1024, 1024), 1000
P_FLIP_MESH, P_FLIP_TURNS = (4, 1), 1
# Path (q), one pod's wire: (tenant, side, turns, frame stride, the two
# spectators' rects, each wrapping the torus; the first is also the
# session's own viewport).  Per-turn frames of the 16384² soup run K6, a
# stride of 16 on the 512² soup runs K1.
Q_TENANTS = (("big", BIG, 300, 1, ((16100, 16200, 512, 512), (16300, 16000, 512, 768))),
             ("small", 512, 8_000, 16, ((400, 450, 256, 128), (480, 300, 64, 300))))
Q_KERNELS = ("stencil", "resident")
# Path (r), a federation on the one card: pod A a child process (``serve
# --device cuda``), pod B ``serve_main`` on a thread of this process, on one
# checkpoint root behind the port's broker and its collector.  Alice (side,
# turns, checkpoint every, superstep: every checkpoint turn a superstep
# boundary) runs K2 on A, which is SIGKILLed once she passes R_KILL_TURN;
# the broker readopts her on B from her newest checkpoint.  Carol (side,
# turns, frame stride, the spectators' rect, which wraps the torus) runs
# K1 on B, watched directly and at depth 2 through a relay chain whose
# first hop drops its first connection after R_DISCONNECT_BYTES (inside
# the WebSocket handshake's answer).  A's cell budget is the larger, so
# headroom places alice on A; with alice on A, B has the headroom for
# carol, and B holds both after the failover.
R_ALICE = (BIG, 2_000, 400, 200)
R_CAROL = (512, 8_000, 16, (400, 450, 256, 128))
R_KILL_TURN, R_DISCONNECT_BYTES = 600, 120
R_TOTAL_A, R_TOTAL_B = BIG * BIG + 8 * 512 * 512, BIG * BIG + 4 * 512 * 512
R_KERNELS = ("tiled", "resident")

# Path (s), multi-host on the one card: S_RANKS ranks of the CLI
# (``--coordinator``), each a child process with the card as its one
# device, so the global mesh is (S_RANKS, 1).  (s1) the 16384² soup x
# S1_TURNS at superstep S1_STEP (K9); (s2) x S2_TURNS with skip_stable at
# superstep 0 (K12, the K10 and K9 remainders); (s3) a S3_SIDE² soup x
# S3_TURNS at superstep S3_STEP, a heartbeat of S3_HEARTBEAT s and a
# checkpoint every S3_CKPT turns, rank 1 SIGKILLed once the first
# checkpoint lands.  S_LEG_SECONDS bounds each leg's children.
S_RANKS = 2
S1_TURNS, S1_STEP = 2_000, 200
S2_TURNS = 10_000
S3_SIDE, S3_TURNS, S3_STEP, S3_HEARTBEAT, S3_CKPT = 512, 50_000, 100, 0.2, 100
S_LEG_SECONDS = 300
S_KERNELS = ("ext", "ext_skip", "strip_frontier")

# Path (t), the flagship board (``utils/soup.py``; BASELINE config 4: a
# 65536² board over a (4, 1) mesh) on the one card, through ``gol.run``:
# (t1) one device x T1_TURNS (K2), and T1_PLAIN_TURNS on K2 beside the same
# on ``engine="packed"`` (the plain engine, 25 ms a generation at this
# size on an H100 80GB HBM3 at 700 W, PERF.md); (t2) x LONG_TURNS (auto skip_stable: K5, K4, K3) beside a
# ``skip_stable=False`` rerun on K2; (t3) both on T_MESH, a virtual mesh of
# the card (K14 chunks, K11, K10, K9; and K9), held to (t2)'s and (t1)'s
# boards; (t4) the viewport T4_RECT, which wraps the torus on both axes, x
# T4_TURNS at stride 1 (K6), each frame against the same turn's crop
# stepped on the roll engine from the rect's light cone; (t5) x T1_TURNS
# supervised: superstep T5_STEP, an SDC check every T5_STEP turns, a
# checkpoint every T5_CKPT, one corrupt (T5_FAULT) rolled back; (t6) a
# T6_DENSITY soup (past T6_PAST alive) x T6_TURNS on one device and on
# T_MESH, paused T6_PAUSE polls at turn 0 so that the ticker (T6_TICK s)
# reports the turn-0 count.  Each soup is made once, written as the legs'
# input PGM and deleted after its last leg; every leg's peak device
# memory must stay below half of the card's.
FLAG = 65536
T_SEED, T6_SEED = 7, 11
T1_TURNS, T1_PLAIN_TURNS = 2_000, 256
T_MESH = (4, 1)
T4_RECT, T4_TURNS = (FLAG - 512, FLAG - 512, 1024, 1024), 200
T5_STEP, T5_CKPT, T5_FAULT = 500, 1_000, Fault(2, "corrupt", cells=3)
T6_DENSITY, T6_TURNS, T6_TICK, T6_PAUSE, T6_PAST = 0.6, 10, 0.05, 20, 2**31
# Rows of the card's soup a block (``flagship_packed``).
FLAG_ROWS = 2048
# The peer form of K14 and K15 (``check_peer_mega``): the 16384² boards
# split by mesh shape into launch groups (shard ids, row-major): (4, 1) a
# strip a group, (8, 1) two strips a group, (2, 2) a tile a group and a
# tile row a group.  On one card a stream a group stands in for a card;
# on four cards (``--peer``) group g runs on card g.
PEER_CASES = (("4x1", (4, 1), ((0,), (1,), (2,), (3,))),
              ("8x1", (8, 1), ((0, 1), (2, 3), (4, 5), (6, 7))),
              ("2x2", (2, 2), ((0,), (1,), (2,), (3,))),
              ("2x2-rows", (2, 2), ((0, 1), (2, 3))))
PEER_LAUNCHES, PEER_CHUNK = 8, 64
# Path (u), ``--peer`` on four cards through ``gol.run``, a shard a card
# unless a leg says otherwise: (u1) the 16384² soup x U_TURNS with
# skip_stable on (4, 1), (u2) on (2, 2), (u3) on (8, 1), two strips a
# card; (u4) BASELINE config 4, the 65536² soup x LONG_TURNS with
# skip_stable on (4, 1); (u5) path (o) across the cards.  Each leg beside
# the same run on the ppermute tier across the cards and on one card, at a
# fixed superstep (U_STEP, U4_STEP turns): a chunk's launch 0 skips
# nothing, so only runs cut into the same dispatches skip alike, and the
# adaptive superstep cuts by each run's own timing.
U_TURNS, U_STEP, U4_STEP = 20_000, 2_000, 10_000
U_CARDS = 4


def virtual(mesh_shape: tuple, device) -> list:
    """A virtual mesh's device list: every shard on ``device``."""
    return [device] * (mesh_shape[0] * mesh_shape[1])


def stats_row(metric: str, rates: list, unit: str = "gens/s") -> dict:
    """One published rate row: ``measure.summarize`` of the runs' rates,
    tagged for ``measure.require_headline_stats``."""
    return {"metric": metric, "unit": unit, **measure.summarize(rates)}


def repeats(name: str, first_seconds: float, first_output, rerun, rep_dir: Path) -> list:
    """The seconds of a row's runs: the first, and ``rerun(rep_dir)``'s
    until there are ``REPS`` when the first took under ``REP_SECONDS``.
    ``rerun`` writes into ``rep_dir`` and returns (seconds, output); each
    output (the run's final PGMs) must equal ``first_output``, and
    ``rep_dir`` is removed after each."""
    runs = [first_seconds]
    while first_seconds < REP_SECONDS and len(runs) < REPS:
        seconds, output = rerun(rep_dir)
        shutil.rmtree(rep_dir, ignore_errors=True)
        if output != first_output:
            raise AssertionError(f"{name}: a repeated run's final PGMs differ from the first's")
        runs.append(seconds)
    return runs


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def record(obj) -> str:
    """``obj`` as one line of strict JSON: a measurement that came out
    NaN or infinite (``device_ms`` when the profiler saw no launch of its
    kernel) is written as null."""
    def finite(o):
        if isinstance(o, float):
            return o if o == o and abs(o) != float("inf") else None
        if isinstance(o, dict):
            return {k: finite(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [finite(v) for v in o]
        return o

    return json.dumps(finite(obj), allow_nan=False)


#: Seconds of each step of phases 2 and 3 (``step``), printed at the end.
STEP_SECONDS: dict = {}


def step(name: str, fn, *args):
    """``fn(*args)``, with its seconds logged and kept in ``STEP_SECONDS``."""
    t0 = time.perf_counter()
    out = fn(*args)
    STEP_SECONDS[name] = round(time.perf_counter() - t0, 1)
    log(f"step {name}: {STEP_SECONDS[name]} s")
    return out


def all_cards_smi(query: str) -> list:
    """``nvidia-smi``'s answer to ``query``, a line a card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def nvidia_smi(query: str) -> str:
    return all_cards_smi(query)[0]


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


def k10_yardstick(strip: tuple[int, int], t: int) -> cuda_adaptive.RegPlan:
    """The tiling K10's bound reads its share of work from, the same
    whatever blocks the kernel runs: the (h_loc, wpl) centre in tiles of 32
    rows (fewer on a shorter centre) by 30 words, each probed on its window
    of ``t`` rows and one word a side, the last row and column of tiles
    shifted to end at the centre's edge (``cuda_halo.ext_skip_origins``)."""
    h_loc, wpl = strip
    tile_h = min(32, h_loc)
    return cuda_adaptive.RegPlan(t, t, tile_h, -(-(tile_h + 2 * t) // 32),
                                 (-(-h_loc // tile_h), -(-wpl // 30)), 1, cuda_adaptive.SKIP_PERIOD)


def k10_share(ext: torch.Tensor, strip: tuple[int, int], t: int, xpad: int):
    """(share, stable tiles) of a K10 launch of ``t`` generations on the
    extended block ``ext`` of an (h_loc, wpl) centre: the centre words of
    the yardstick's tiles (``k10_yardstick``) whose skip proof fails
    (``ext_skip_stable_tiles``, the proof in PyTorch) over all the centre's
    words, and the count of tiles and of tiles where the proof holds."""
    plan = k10_yardstick(strip, t)
    stable = cuda_halo.ext_skip_stable_tiles(ext, CONWAY, t, t, xpad, plan).cpu()
    ys, xs = cuda_halo.ext_skip_origins(plan, strip)
    h_loc, wpl = strip
    work = torch.zeros(strip, dtype=torch.bool)
    for i, y in enumerate(ys):
        for j, x in enumerate(xs):
            if not stable[i, j]:
                work[y : y + plan.tile_h, x : x + plan.centre] = True
    share = int(work.sum()) / (h_loc * wpl)
    return share, dict(tiles=stable.numel(), stable=int(stable.sum()))


# Integer instructions K6 spends per cell, counted from csrc/stencil.cu
# (shuffles, loads, stores and addresses not counted): per 4-cell word, 1
# LOP3 for the alive bits, 1 IADD3 for the 3-row sum, 2 SHF funnel shifts
# for the west and east bytes, 2 for the live neighbours (IADD3, and the
# centre's subtraction), 3 for B3/S23's byte compare ((n | a) ^ 3 in a
# LOP3, the IADD and LOP3 of the zero-byte test), 1 SHF and 1 IMAD for the
# 0/255 bytes and 1 IADD for the count: 12 a word, 3 a cell.
STENCIL_OPS_PER_CELL = 3


def stencil_bound_ms(h: int, w: int, int_rate: float):
    """K6's least time for one generation of an H x W board: one read and
    one write of the board (2·H·W bytes) over the memory rate, against
    ``STENCIL_OPS_PER_CELL`` integer instructions per cell over the int32
    rate; the larger, and which."""
    return larger_ms(2 * h * w / HBM_BYTES_PER_S, h * w * STENCIL_OPS_PER_CELL / int_rate)


def card_int_rate() -> float:
    """The card's int32 instruction rate: its SMs x ``INT32_LANES_PER_SM``
    lanes x its maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def build_kernels() -> None:
    """Build every kernel from source into ``build/kernels/``, one ``nvcc``
    per source, all started together."""
    cuda_build.build(*cuda_build.KERNELS)


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


def spread(per_call: list) -> dict:
    """The median, min and max of per-call times, and the times."""
    return dict(median=statistics.median(per_call), min=min(per_call), max=max(per_call),
                batches=per_call)


def per_launch(times: dict, n: int) -> dict:
    """``spread`` of calls of ``n`` launches each, per launch."""
    return spread([t / n for t in times["batches"]])


def cuda_ms_spread(fn, reps: int, batches: int = BATCHES) -> dict:
    """ms per call of ``fn()`` over ``batches`` batches of ``reps`` calls,
    each batch between CUDA events, after warm-up: ``spread``."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return spread(per)


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device ms a launch of the kernel named ``kernel`` over ``reps``
    calls of ``fn()`` under ``torch.profiler`` (its own time, without the
    host's), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for a in prof.key_averages():
        if kernel in a.key:
            t = getattr(a, "self_device_time_total", None)
            us += t if t is not None else a.self_cuda_time_total
            count += a.count
    return us / count / 1e3 if count else float("nan")


def reg_build_report(log_text: str) -> dict:
    """Registers, spill stores and loads, and shared memory of each
    ``REG_KERNELS`` instantiation, from a build's ``-Xptxas -v`` output;
    raises if one spills or is missing."""
    report, entry = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if any(k in name for k in REG_KERNELS) else None
            if entry:
                report[entry] = dict(line=line.strip())
        elif entry and ("spill" in line or "registers" in line):
            report[entry]["line"] += " " + line.strip()
            if "spill" in line:
                stores, loads = (int(line.split()[i]) for i in (4, 8))
                report[entry].update(spill_stores=stores, spill_loads=loads)
            if "registers" in line:
                report[entry]["registers"] = int(line.split("Used ")[1].split()[0])
    if not report or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                         for r in report.values()):
        raise AssertionError(f"a register-resident kernel spills or was not built: {report}")
    return report


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
    """K1 against its plain version, tolerance 0: 512² (a cluster of
    several CTAs) at 1 to 1,000 generations under ``REG_RULES`` (each
    launch counted in its rule's instantiation) and against its block
    mirror on the card, then ``K1_SHAPES`` at 1, 9 and 50 generations;
    then the default run's board against the NumPy oracle."""
    cuda_packed.resident_superstep.rules.clear()
    plan = cuda_packed.resident_reg_plan(16, 512)
    if plan.cluster < 2:
        raise AssertionError(f"K1's plan for 512^2 is one CTA ({plan}), not a cluster")
    for rule in REG_RULES:
        v = packed.pack_vertical(board(512, 512, 11, device))
        for turns in (1, 6, 100, 1000):
            got = cuda_packed.resident_superstep(v, rule, turns)
            want = cuda_packed.resident_superstep_plain(v, rule, turns)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            errs["resident"] = max(errs["resident"], err)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 != plain at 512^2 x {turns} under {rule.notation}")
        mirror = cuda_packed.resident_superstep_mirror(v, rule, 50)
        if not torch.equal(cuda_packed.resident_superstep(v, rule, 50), mirror):
            raise AssertionError(f"K1 != its block mirror at 512^2 x 50 under {rule.notation}")
        log(f"K1 512^2 x {{1, 6, 100, 1000}} {rule.notation} ({plan}): identical to plain, "
            f"and to the block mirror at 50")
    if set(cuda_packed.resident_superstep.rules) != set(cuda_adaptive.REG_RULES):
        raise AssertionError(f"K1 ran {dict(cuda_packed.resident_superstep.rules)}, not every "
                             "instantiation")
    for h, w in K1_SHAPES:
        v = packed.pack_vertical(board(h, w, h + w, device))
        for rule in REG_RULES:
            for turns in (1, 9, 50):
                got = cuda_packed.resident_superstep(v, rule, turns)
                want = cuda_packed.resident_superstep_plain(v, rule, turns)
                errs["resident"] = max(errs["resident"], max_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 != plain at {h}x{w} x {turns} under "
                                         f"{rule.notation}")
        log(f"K1 {h}x{w} x {{1, 9, 50}} under {len(REG_RULES)} rules "
            f"({cuda_packed.resident_reg_plan(h // 32, w)}): identical")
    b = board(512, 512, 12, device)
    got = cuda_packed.make_superstep_bytes(CONWAY, device)(b, 100).cpu().numpy()
    if not np.array_equal(got, numpy_life(b.cpu().numpy(), 100, CONWAY)):
        raise AssertionError("K1 512^2 x 100 disagrees with the NumPy oracle")
    log("K1 512^2 x 100: equals the independent NumPy oracle")


def check_tiled(device, errs: dict) -> None:
    """K2 against its plain version, tolerance 0, under ``REG_RULES`` (each
    launch counted in its rule's instantiation): 16384² at 1, 6, 32 and 37
    generations and, under Conway, 1,000, ``TILED_ODD`` and ``TILED_SMALL``
    at 45 and 75; and
    against its block mirror on the card's blocks (``tiled_reg_mirror``)
    at ``TILED_ODD`` and ``TILED_SMALL`` under Conway (the blocks do not
    depend on the rule)."""
    cuda_packed.tiled_superstep.rules.clear()
    sms = cuda_adaptive.device_sms(device)
    t = cuda_packed.tiled_reg_plan((BIG, BIG // 32), 10**6, sms).t
    cases = [((BIG, BIG), n) for n in (1, 6, t, t + 5, 1000)] + [(TILED_ODD, 75)] + [
        (shape, 45) for shape in TILED_SMALL]
    # One soup a shape: a 16384² soup takes the host about 2 s to draw.
    soups = {shape: packed.pack(board(*shape, 13, device)) for shape, _ in cases}
    for rule in REG_RULES:
        # The plain version's 1,000 generations take about 2 s: Conway only.
        ran = [(shape, n) for shape, n in cases if n != 1000 or rule == CONWAY]
        for shape, turns in ran:
            p = soups[shape].clone()
            got = cuda_packed.tiled_superstep(p, rule, turns)
            want = cuda_packed.tiled_superstep_plain(p, rule, turns)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if shape[0] < BIG and rule == CONWAY:
                err = max(err, max_abs_err(got, cuda_packed.tiled_reg_mirror(p, rule, turns,
                                                                             sms=sms)))
            errs["tiled"] = max(errs["tiled"], err)
            if err:
                raise AssertionError(f"K2 != plain (or its mirror) at {shape} x {turns} under "
                                     f"{rule.notation}")
        log(f"K2 {[f'{s[0]}x{s[1]} x {n}' for s, n in ran]} {rule.notation}: identical to "
            f"plain" + (f", and to the block mirror below {BIG}^2" if rule == CONWAY else ""))
    if set(cuda_packed.tiled_superstep.rules) != set(cuda_adaptive.REG_RULES):
        raise AssertionError(f"K2 ran {dict(cuda_packed.tiled_superstep.rules)}, not every "
                             "instantiation")
    log(f"K2's plan at {BIG}^2: {cuda_packed.tiled_reg_plan((BIG, BIG // 32), 10**6, sms)}")


def check_stencil(device, errs: dict) -> None:
    """K6 and its count against its plain version, tolerance 0: 512² and
    16384² under ``REG_RULES`` (B3/S23 and B36/S23 compiled in, Day & Night
    by its masks; each launch counted in its rule's instantiation), and the
    gate's odd shapes (``STENCIL_SHAPES``: one row, odd heights, W % 16 != 0
    on the 4-cell instantiation, boards narrower than a warp) under
    B3/S23 and Day & Night.  Each over 8 generations of
    ``make_steps_with_counts`` (every launch's own count), the superstep at
    1 and 8, and the counted superstep at 8 (its last launch's count); the
    input never written."""
    cuda_stencil.stencil_step.rules.clear()
    for shape in ((512, 512), (BIG, BIG), *STENCIL_SHAPES):
        b = board(*shape, 17, device)
        before = b.clone()
        rules = REG_RULES if shape[0] == shape[1] else (CONWAY, DAY_AND_NIGHT)
        for rule in rules:
            want, want_counts, at = b, [], {}
            for turns in range(1, 9):
                c = torch.zeros((), dtype=torch.int64, device=device)
                want = cuda_stencil.stencil_step_plain(want, rule, c)
                want_counts.append(int(c))
                at[turns] = want
            got, counts = cuda_stencil.make_steps_with_counts(rule)(b, 8)
            one = cuda_stencil.make_superstep(rule)(b, 1)
            counted, last = cuda_stencil.make_counted_superstep(rule)(b, 8)
            torch.cuda.synchronize()
            err = max(max_abs_err(got, at[8]), max_abs_err(one, at[1]),
                      max_abs_err(counted, at[8]),
                      max(abs(int(x) - y) for x, y in zip(counts.cpu(), want_counts)),
                      abs(int(last) - want_counts[-1]))
            errs["stencil"] = max(errs["stencil"], err)
            if err or not torch.equal(b, before) or want_counts[-1] != int((at[8] & 1).sum()):
                raise AssertionError(f"K6 != plain (or its count, or its input written) at "
                                     f"{shape} under {rule.notation}: error {err}")
            log(f"K6 {shape[0]}x{shape[1]} x {{1, 8}} {rule.notation} "
                f"({cuda_stencil.words_per_thread(b) * 4} cells a thread, runs of "
                f"{cuda_stencil.RUN_ROWS} rows): "
                f"identical boards and counts (last {want_counts[-1]})")
    if set(cuda_stencil.stencil_step.rules) != set(cuda_adaptive.REG_RULES):
        raise AssertionError(f"K6 ran {dict(cuda_stencil.stencil_step.rules)}, not every "
                             "instantiation")


def soup_stack(nb: int, side: int, seed: int, device) -> torch.Tensor:
    """A (nb, side, side) stack of soups (density 0.3, seeds seed..)."""
    return torch.stack([board(side, side, seed + i, device) for i in range(nb)])


def check_resident_batched(device, errs: dict) -> None:
    """K7 against its plain version, tolerance 0, at ``K7_STACKS``, 1, 9 and
    64 generations under ``REG_RULES`` (each launch counted in its rule's
    instantiation); slot 0 against a lone K1 launch, and at 9 generations
    against its batched mirror at the card's plan; logs each plan's
    cluster size and the waves the stack takes."""
    cuda_packed.resident_superstep_batched.rules.clear()
    for nb, h, w in K7_STACKS:
        if cuda_packed.resident_shape(h, w) is None:
            raise AssertionError(f"{h}x{w} is outside K7's gate")
        v = packed.pack_vertical(torch.stack([board(h, w, 31 + i, device) for i in range(nb)]))
        v = v.contiguous()
        for rule in REG_RULES:
            for turns in (1, 9, 64):
                got = cuda_packed.resident_superstep_batched(v, rule, turns)
                want = cuda_packed.resident_superstep_batched_plain(v, rule, turns)
                solo = cuda_packed.resident_superstep(v[0].contiguous(), rule, turns)
                torch.cuda.synchronize()
                err = max(max_abs_err(got, want), max_abs_err(got[0], solo))
                if turns == 9:
                    plan = cuda_packed.card_batched_plan(v, rule)
                    err = max(err, max_abs_err(got, cuda_packed.resident_superstep_batched_mirror(
                        v, rule, turns, plan)))
                errs["resident_batched"] = max(errs["resident_batched"], err)
                if err:
                    raise AssertionError(f"K7 != plain (or K1, or its mirror) at {nb} x {h}x{w} "
                                         f"x {turns} under {rule.notation}")
            active = cuda_packed.card_active_clusters(device, rule)(plan)
            log(f"K7 {nb} x {h}x{w} x {{1, 9, 64}} {rule.notation}: identical (slot 0 = K1, "
                f"= the mirror at 9); plan {plan}: clusters of {plan.cluster}, {active} at once, "
                f"{-(-nb // active)} wave(s)")
    if set(cuda_packed.resident_superstep_batched.rules) != set(cuda_adaptive.REG_RULES):
        raise AssertionError(f"K7 ran {dict(cuda_packed.resident_superstep_batched.rules)}, not "
                             "every instantiation")


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


def sparse_packed(h: int, w: int, device, slots=None, tiles=None) -> torch.Tensor:
    """``testing.boards.sparse_board`` of h x w cells in the port's 256-row
    stripes (all its slots, or ``slots``; with ``tiles``, its gliders
    across the seams and a corner of that mesh's tiles), packed on the
    card."""
    kw = {} if slots is None else dict(slots=slots)
    return packed.pack(torch.from_numpy(sparse_board(h, w, 256, tiles=tiles, **kw)).to(device))


def route_names(routes: torch.Tensor) -> set:
    """The routes a (launches, stripes) record holds, by name
    (``cuda_adaptive.ROUTES``), and "after" where a stripe skipped right
    after the rectangle route (K12: the column tier)."""
    r = routes.cpu()
    names = {cuda_adaptive.ROUTES[k] for k in r.unique().tolist()}
    if ((r[:-1] == cuda_adaptive.ROUTE_TIER) & (r[1:] == cuda_adaptive.ROUTE_SKIP)).any():
        names.add("after")
    return names


ROUTES_NEEDED = ("skip", "tier", "row", "full", "after")


def require_routes(routes: torch.Tensor, what: str, need=ROUTES_NEEDED) -> set:
    """Raise unless the route record holds every route of ``need``."""
    names = route_names(routes)
    if not set(need) <= names:
        raise AssertionError(f"{what} took the routes {sorted(names)}, not all of {list(need)}")
    return names


def launch_records(run) -> tuple:
    """``run(each)`` with ``each`` recording every launch's (board, state,
    routes), cloned, the state as int64: (what ``run`` returns, the
    records)."""
    seen = []

    def each(board, state, routes):
        seen.append((board.clone(), state.to(torch.int64).clone(), routes.clone()))

    return run(each), seen


def records_err(got: list, want: list, what: str) -> int:
    """Max abs error between two launch-by-launch records (boards, whole
    states, routes); raises if they differ in length or anywhere."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} launches recorded against {len(want)}")
    err = max(max(max_abs_err(a, b) for a, b in zip(g, w)) for g, w in zip(got, want))
    if err:
        bad = next(k for k, (g, w) in enumerate(zip(got, want))
                   if any(max_abs_err(a, b) for a, b in zip(g, w)))
        items = [i for i, (a, b) in enumerate(zip(got[bad], want[bad])) if max_abs_err(a, b)]
        raise AssertionError(f"{what}: launch {bad} differs (board, state or routes: items "
                             f"{items} of {len(want[bad])})")
    return err


def route_words(routes: torch.Tensor, plan, shape: tuple) -> float:
    """The words a frontier launch's data needs advanced, on the mean
    launch of a (launches, stripes) route record on shards of ``shape``:
    each stripe the cells its route writes as gen T at most, the
    rectangle route (K12: the column tier) its window's validity region,
    (sub_rows - 2T) x (col_window - 2 ceil((T + 6) / 32)) words, the row
    tier its sub-window's validity rows at full width, the full window its
    centre (stripe_h x wp); a skip none, and an edge stripe K15 elides
    none.  So no route is counted for more than its kernel computes."""
    sub_rows, cwin = cuda_adaptive.frontier_geometry(plan, shape)
    wp = shape[1]
    cw = (plan.t + 6 + 31) // 32
    rows = (sub_rows or 0) - 2 * plan.t
    words = {cuda_adaptive.ROUTE_TIER: rows * ((cwin or 0) - 2 * cw),
             cuda_adaptive.ROUTE_ROW: rows * wp, cuda_adaptive.ROUTE_FULL: plan.stripe_h * wp}
    r = routes.cpu()
    return sum(int((r == k).sum()) * v for k, v in words.items()) / r.shape[0]


def chunk_routes(run) -> torch.Tensor:
    """The route record of ``run(record)``, whose ``record(routes)`` gets
    each launch's routes: (launches, stripes)."""
    seen = []
    run(lambda routes: seen.append(routes.clone()))
    return torch.stack(seen)


def route_mix(routes: torch.Tensor) -> dict:
    """The stripes a launch takes each route, on the mean launch of a
    (launches, stripes) record, by name."""
    r = routes.cpu()
    return {name: int((r == k).sum()) / r.shape[0] for k, name in enumerate(cuda_adaptive.ROUTES)
            if (r == k).any()}


def check_frontier_batched(device, errs: dict) -> dict:
    """K8 against its plain version over one canonical chunk (8 launches)
    of 4 x 4096², fresh and settled (each soup after ``LONG_TURNS``
    generations of K2), on the seam stack, and on ``K8_SPARSE`` (a sparse
    4096 x 16384 board beside a dead one, where the column window
    engages): after every launch the stack, the whole interval and
    rectangle state and the route record, then the per-board skip counts
    and activity, under ``REG_RULES`` (Day & Night takes the generic
    instantiation; each rule's launches counted in its own), and against
    K8's block mirror on the card (``frontier_batched_reg_mirror`` at the
    card's blocks); every route runs on the card; and K8 with one board
    against K5.  Returns the packed stacks (phase 4 times them)."""
    side, nb = POD_K8[1], POD_K8[0]
    fresh = packed.pack(soup_stack(nb, side, 51, device)).contiguous()
    settled = torch.stack([cuda_packed.tiled_superstep(b.contiguous(), CONWAY, LONG_TURNS)
                           for b in fresh])
    sparse = sparse_packed(side, BIG, device, K8_SPARSE)
    stacks = {"fresh": fresh, "settled": settled,
              "seam": packed.pack(seam_stack(side, device)).contiguous(),
              "sparse": torch.stack([sparse, torch.zeros_like(sparse)]).contiguous()}
    sms = cuda_adaptive.device_sms(device)
    routes = []
    for rule in REG_RULES:
        for name, st in stacks.items():
            plan = cuda_adaptive.adaptive_plan(tuple(st.shape[1:]), 10**6)
            reset_launches()
            (got, sk, act), seen = launch_records(
                lambda each: cuda_adaptive.frontier_superstep_batched(st, rule, plan, 8, each))
            torch.cuda.synchronize()
            if cuda_adaptive.frontier_superstep_batched.rules != {instantiation(rule): 8}:
                raise AssertionError(f"K8 under {rule.notation} ran "
                                     f"{dict(cuda_adaptive.frontier_superstep_batched.rules)}")
            (want, wsk, wact), wseen = launch_records(
                lambda each: cuda_adaptive.frontier_superstep_batched_mirror(
                    st, rule, plan, 8, each=each))
            blk, bseen = launch_records(lambda each: cuda_adaptive.frontier_batched_reg_mirror(
                st, rule, plan, 8, sms, each))
            torch.cuda.synchronize()
            where = f"the {name} stack under {rule.notation}"
            err = max(records_err(seen, wseen, f"K8 against its plain version on {where}"),
                      records_err(seen, bseen, f"K8 against its block mirror on {where}"),
                      max_abs_err(got, want), max_abs_err(got, blk[0]))
            errs["frontier_batched"] = max(errs["frontier_batched"], err)
            if not (torch.equal(sk, wsk) and torch.equal(act, wact) and torch.equal(sk, blk[1])
                    and torch.equal(act, blk[2])):
                raise AssertionError(f"K8 != plain on {where}: skipped {sk.tolist()} vs "
                                     f"{wsk.tolist()}")
            if name == "seam" and not torch.equal(got, packed.superstep(st, rule, 8 * plan.t)):
                raise AssertionError("K8's seam stack differs from the plain packed engine")
            if rule is CONWAY:
                routes.append(torch.stack([r for _, _, r in seen]))
            log(f"K8 {st.shape[0]} x {tuple(st.shape[1:])} words x 8 launches ({plan}) {name} "
                f"{rule.notation}: identical to the plain version and the block mirror after "
                f"every launch, skipped {sk.tolist()}, active stripes {int((act > 0).sum())}, "
                f"routes {sorted(route_names(seen[-1][2][None]))} at the last launch")
        plan = cuda_adaptive.adaptive_plan((side, side // 32), 10**6)
        one = cuda_adaptive.frontier_superstep_batched(fresh[:1].contiguous(), rule, plan, 8)
        k5 = cuda_adaptive.frontier_superstep(fresh[0].contiguous(), rule, plan, 8)
        if not (torch.equal(one[0][0], k5[0]) and int(one[1][0]) == int(k5[1])
                and torch.equal(one[2], k5[2])):
            raise AssertionError(f"K8 with one board != K5 under {rule.notation}")
    log(f"K8 with one board: equals K5 (board, skip count, activity); K8's routes on the card "
        f"under B3/S23: {sorted(require_routes(routes[-1], 'K8 on the sparse stack'))}")
    return {"fresh": fresh, "settled": settled, "sparse": stacks["sparse"]}


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


def check_adaptive(errs: dict, boards: dict, sparse: torch.Tensor) -> None:
    """K3, K4 and K5 against their plain versions at 16384²: board, skip
    count and per-stripe activity, on each board under both rules, through
    one dispatch of t·(64 + 3) + 13 turns (a 64-launch frontier chunk, a
    3-launch probing tail, a skip launch and a plain remainder); then K5
    alone over 8 launches on each board and on ``sparse`` under
    ``REG_RULES`` (Day & Night takes its generic instantiation) against its
    plain version and its block mirror on the card, launch by launch
    (``check_k5_blocks``).  K3 alone at every
    launch depth and K4 alone over 8 launches are held to their plain
    versions by ``check_skip_blocks``."""
    plan = cuda_adaptive.adaptive_plan((BIG, BIG // 32), 10**6)
    turns = plan.t * (64 + 3) + 13
    want_counts = {"frontier": 64, "probing": 3, "tiled_skip": 1}
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
    check_k5_blocks(errs, {**boards, "sparse": sparse}, plan)


def instantiation(rule: LifeRule) -> str:
    """The register-resident kernels' instantiation ``rule`` takes."""
    return cuda_adaptive.REG_RULES[cuda_adaptive.reg_rule(rule)[2]]


def check_k5_blocks(errs: dict, boards: dict, plan) -> None:
    """K5 over one chunk of 8 launches on each board (the fresh and
    settled soups and the sparse board) under ``REG_RULES``, each launch
    counted in the rule's instantiation, against its plain version and
    against its block mirror run on the card at the card's blocks
    (``cuda_adaptive.frontier_launch_reg_mirror``): after every launch the
    board, the whole interval and rectangle state and the route record,
    then the skip count and activity, tolerance 0; every route (skip,
    rectangle, row, full, and a skip right after a rectangle) runs on the
    card on the sparse board."""
    device = boards["fresh"].device
    blocks = cuda_adaptive.frontier_blocks((BIG, BIG // 32), plan, 1,
                                           cuda_adaptive.device_sms(device))
    mirror = functools.partial(cuda_adaptive.frontier_launch_reg_mirror, blocks=blocks)
    routes = {}
    for rule in REG_RULES:
        for name, p in boards.items():
            reset_launches()
            got, seen = launch_records(
                lambda each: cuda_adaptive.frontier_superstep(p, rule, plan, 8, each))
            torch.cuda.synchronize()
            if cuda_adaptive.frontier_superstep.rules != {instantiation(rule): 8}:
                raise AssertionError(f"K5 under {rule.notation} ran "
                                     f"{dict(cuda_adaptive.frontier_superstep.rules)}")
            for what, launch in (("plain version", cuda_adaptive.frontier_launch_mirror),
                                 ("block mirror", mirror)):
                want, wseen = launch_records(lambda each: cuda_adaptive.frontier_superstep_mirror(
                    p, rule, plan, 8, launch, each))
                where = f"K5 x 8 against its {what} on the {name} board under {rule.notation}"
                err = max(records_err(seen, wseen, where),
                          max(max_abs_err(a, b) for a, b in zip(got, want)))
                errs["frontier"] = max(errs["frontier"], err)
                if err:
                    raise AssertionError(where)
            r = torch.stack([k for _, _, k in seen])
            if rule is CONWAY:
                routes[name] = r
            log(f"K5 {BIG}^2 x 8 launches ({blocks}) {name} {rule.notation} "
                f"({instantiation(rule)}): identical to the plain version and the block mirror "
                f"after every launch, skipped {int(got[1])}, routes {sorted(route_names(r))}")
    log(f"K5's routes on the card under B3/S23: "
        f"{ {n: sorted(route_names(r)) for n, r in routes.items()} }; on the sparse board "
        f"{sorted(require_routes(routes['sparse'], 'K5 on the sparse board'))}")


def check_skip_blocks(device, errs: dict, boards: dict) -> None:
    """K4 and K3 against their block mirrors run on the card at the card's
    blocks (``probing_superstep_reg_mirror``, ``tiled_skip_reg_mirror``)
    and against their plain versions, tolerance 0 (K4: board, skip count
    and activity), under ``REG_RULES`` (Day & Night takes the generic
    instantiation), each launch counted in the rule's instantiation: K4
    over 8 launches from a zero bitmap on each 16384² board at the port's
    plan and on ``K4_SMALL`` (fresh, and after 300 generations), K3 at 6,
    12, 18 and 24 generations on each 16384² board and on ``K3_SHORT``."""
    sms = cuda_adaptive.device_sms(device)
    plan = cuda_adaptive.adaptive_plan((BIG, BIG // 32), 10**6)
    small = {}
    for shape, aplan in K4_SMALL:
        p = packed.pack(board(*shape, shape[0] + shape[1], device))
        small[shape] = (aplan, [p, cuda_packed.tiled_superstep(p, CONWAY, 300)])
    short = {shape: (t, packed.pack(board(*shape, 31 + shape[0], device))) for shape, t in K3_SHORT}
    for rule in REG_RULES:
        reset_launches()
        k4_cases = [(f"{BIG}^2 {name}", plan, p) for name, p in boards.items()] + [
            (f"{s[0]}x{s[1]} #{i}", ap, p) for s, (ap, ps) in small.items() for i, p in enumerate(ps)]
        for what, aplan, p in k4_cases:
            got = cuda_adaptive.probing_superstep(p, rule, aplan, 8)
            torch.cuda.synchronize()
            for how, want in (("block mirror", cuda_adaptive.probing_superstep_reg_mirror(
                                  p, rule, aplan, 8, sms=sms)),
                              ("plain", cuda_adaptive.probing_superstep_mirror(p, rule, aplan, 8))):
                err = max(max_abs_err(a, b) for a, b in zip(got, want))
                errs["probing"] = max(errs["probing"], err)
                if err:
                    raise AssertionError(f"K4 x 8 != its {how} on {what} under {rule.notation}")
        k3_cases = [(f"{BIG}^2 {name}", t, p) for name, p in boards.items() for t in (6, 12, 18, 24)]
        k3_cases += [(f"{s[0]}x{s[1]}", t, p) for s, (t, p) in short.items()]
        for what, t, p in k3_cases:
            got = cuda_adaptive.tiled_skip_superstep(p, rule, t)
            torch.cuda.synchronize()
            for how, want in (("block mirror", cuda_adaptive.tiled_skip_reg_mirror(p, rule, t,
                                                                                   sms=sms)),
                              ("plain", cuda_adaptive.tiled_skip_superstep_plain(p, rule, t))):
                err = max_abs_err(got, want)
                errs["tiled_skip"] = max(errs["tiled_skip"], err)
                if err:
                    raise AssertionError(f"K3 x {t} != its {how} on {what} under {rule.notation}")
        counts = (dict(cuda_adaptive.probing_superstep.rules),
                  dict(cuda_adaptive.tiled_skip_superstep.rules))
        if counts != ({instantiation(rule): 8 * len(k4_cases)},
                      {instantiation(rule): len(k3_cases)}):
            raise AssertionError(f"K4 and K3 under {rule.notation} ran {counts}")
        log(f"K4 x 8 launches on {[w for w, _, _ in k4_cases]} and K3 on "
            f"{[f'{w} x {t}' for w, t, _ in k3_cases]} {rule.notation} ({instantiation(rule)}): "
            f"identical to their block mirrors and plain versions")
    log(f"K4's blocks at {BIG}^2: {cuda_adaptive.probing_reg_plan(plan, (BIG, BIG // 32), sms)}; "
        f"K3's at 24: {cuda_adaptive.tiled_skip_reg_plan((BIG, BIG // 32), 24, sms)}")


def check_ext(device, errs: dict) -> dict:
    """K9 against its plain version, tolerance 0, at the sharded runs'
    shapes: the 16384² soup (density 0.3, seed 7) split (4, 1) and (2, 2)
    on a virtual mesh, every shard's extended block through one full launch
    and one remainder launch under ``REG_RULES`` (B3/S23 and B36/S23 in
    their compile-time instantiations, Day & Night in the generic one), and
    shard (0, 0)'s at every depth from 1 to 32 (every remainder); path
    (c)'s 512² board on (8, 1) (64-row shards, shorter than one block's
    window), full and remainder launches; then the whole sharded superstep
    (two full launches and a remainder) against K2 on the whole board.
    Returns each 16384² mesh's (sharded board, full-launch plan)."""
    p = packed.pack(board(BIG, BIG, 7, device))
    sms = cuda_halo.device_sms(device)
    cases = {}

    def same(e, rule, t, pad, xpad, where):
        got = cuda_halo.ext_launch(e, rule, t, pad, xpad)
        want = cuda_halo.ext_launch_plain(e, rule, t, pad, xpad)
        torch.cuda.synchronize()
        errs["ext"] = max(errs["ext"], max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"K9 != plain on {where}, T = {t}, xpad {xpad}, {rule.notation}")

    for mesh_shape, side in ((MESH_A, BIG), (MESH_B, BIG), (MESH_C, 512)):
        m = mesh_lib.make_mesh(mesh_shape, virtual(mesh_shape, device))
        whole = p if side == BIG else packed.pack(board(side, side, 7, device))
        sb = halo.board_sharding(m).shard(whole)
        full = cuda_halo.launch_plan(sb.shard_shape, mesh_shape, 10**6)[0]
        rem = cuda_halo.launch_plan(sb.shard_shape, mesh_shape, full.t + 13)[-1]
        for plan in (full, rem):
            exts = [e for row in halo.extend(sb, plan.pad, plan.xpad) for e in row]
            for rule in REG_RULES:
                for e in exts:
                    same(e, rule, plan.t, plan.pad, plan.xpad, f"{mesh_shape} shards")
                log(f"K9 {mesh_shape} shards {sb.shard_shape} x {plan.t} (pad {plan.pad}, xpad "
                    f"{plan.xpad}, {cuda_halo.ext_reg_plan(sb.shard_shape, plan.t, sms)}) "
                    f"{rule.notation}: identical on all {len(exts)} shards")
        if side != BIG:
            continue
        for t in range(1, 33):
            xpad = -(-t // 32) if mesh_shape[1] > 1 else 0
            same(halo.extend(sb, t, xpad)[0][0], CONWAY, t, t, xpad, f"{mesh_shape} shard (0, 0)")
        log(f"K9 {mesh_shape} shard (0, 0) x {{1..32}} {CONWAY.notation}: identical")
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


def check_strip_launches(sb, rule: LifeRule, errs: dict, plans, name: str, n: int = 3):
    """K12 and K11 against their plain versions launch by launch: ``n``
    launches of each on the four strips of ``sb`` (both parities), each
    launch's strip and its K12 state (row and column intervals and
    computed flags) and routes or K11 bitmap recorded and compared,
    tolerance 0.  K12 runs at the frontier plan ``plans[0]`` and at
    ``plans[2]`` where given (path (g)'s frontier plan: T = 6 on 16-row
    stripes), K11 at the probing plan ``plans[1]`` where given and at the
    frontier plan too (the in-kernel tier's loose tail, path (e)).
    Returns K12's route record at ``plans[0]`` on the card, (n, 4 *
    stripes)."""
    strips = [row[0] for row in sb.shards]
    checks = [(plans[0], "strip_frontier", cuda_halo.frontier_launches)]
    if len(plans) > 1:
        checks += [(plans[1], "strip_probing", cuda_halo.probing_launches),
                   (plans[0], "strip_probing", cuda_halo.probing_launches)]
    if len(plans) > 2:
        checks.append((plans[2], "strip_frontier", cuda_halo.frontier_launches))
    routes = None
    for plan, kernel, seq in checks:
        runs = []
        for fn in (WRAPPERS[kernel], getattr(cuda_halo, f"{kernel}_launch_plain")):
            seen = []

            def record(*args, _fn=fn, _seen=seen):
                out = _fn(*args)
                if isinstance(args[5], cuda_halo.FrontierState):
                    _seen.append((out.clone(), args[5].cur.clone(), args[5].route.clone()))
                else:
                    _seen.append((out.clone(), args[5].clone()))
                return out

            seq(strips, rule, plan, n, record)
            runs.append(seen)
        torch.cuda.synchronize()
        for got, want in zip(*runs):
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            errs[kernel] = max(errs[kernel], err)
            if err:
                raise AssertionError(f"{kernel} != plain launch by launch ({plan}) on the {name} "
                                     f"strips under {rule.notation}")
        if routes is None and kernel == "strip_frontier":
            routes = torch.stack([r for _, _, r in runs[0]]).view(n, -1)
    log(f"{', '.join(f'{WRAPPERS[k].__name__} at {p}' for p, k, _ in checks)} x {n} launches on "
        f"the 4 {name} strips {rule.notation}: identical strips, intervals, routes and bitmaps "
        f"at every launch; K12's routes {sorted(route_names(routes))}")
    return routes


@contextlib.contextmanager
def plain_strip_kernels():
    """The sharded tiers' seven wrappers (K9-K15) replaced by their plain
    versions while the block runs: a whole ``make_superstep`` dispatch on
    the card through no kernel, the yardstick of the dispatch check."""
    names = ("ext_launch", "ext_skip_launch", "strip_probing_launch", "strip_frontier_launch",
             "tile_probing_launch")
    chunks = ("strip_mega_launches", "tile_mega_launches")
    saved = {n: getattr(cuda_halo, n) for n in (*names, *chunks)}
    for n in names:
        setattr(cuda_halo, n, getattr(cuda_halo, f"{n}_plain"))
    # K14's and K15's chunks build their launchers themselves unless asked
    # for the plain ones.
    for n in chunks:
        setattr(cuda_halo, n, functools.partial(saved[n], plain=True))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cuda_halo, n, fn)


def check_k10_settled(e: torch.Tensor, t: int, xpad: int, where: str) -> dict:
    """K10 on a settled shard's extended block ``e``: its block map from
    the skip proof in PyTorch (``ext_skip_stable_tiles``) must be all true,
    the launch must compute no block (its own flags,
    ``ext_skip_launch.last_stable``, all 1) and copy its centre (the output
    equals the block's centre).  Returns the counts."""
    stable = cuda_halo.ext_skip_stable_tiles(e, CONWAY, t, t, xpad)
    got = cuda_halo.ext_skip_launch(e, CONWAY, t, t, xpad)
    flags = cuda_halo.ext_skip_launch.last_stable
    centre = e[t:-t, xpad : e.shape[1] - xpad] if xpad else e[t:-t]
    out = dict(blocks=stable.numel(), stable_map=int(stable.sum()),
               computed=int((flags == 0).sum()), copied=bool(torch.equal(got, centre)))
    if not (stable.all() and out["computed"] == 0 and out["copied"]):
        raise AssertionError(f"K10 on the settled {where} at T = {t}: {out}")
    return out


def check_strips(device, errs: dict, boards: dict, sparse: torch.Tensor) -> dict:
    """K10, K11, K12 and K14 against their plain versions, tolerance 0, on
    the 16384² soup split (4, 1) on a virtual mesh: fresh, settled (after
    ``LONG_TURNS`` generations) and settled with a glider crossing each
    strip seam.  Whole ``skip_stable`` dispatches of the strip tier, both
    rules: 9·t - 5 turns at the port's plan on the ppermute tier (8 K12
    launches a strip, so both launch parities, then a K10 remainder of
    t - 6 and a K9 of 1) and on the in-kernel tier (one 8-launch K14
    chunk, then the same remainders), 13·t - 5 on the in-kernel tier (the
    8-launch chunk, a loose tail of 4 K11 launches a strip from a zero
    bitmap, then the remainders: path (e)'s tail, its skip count and
    activity summed over chunk and tail), and 4·t - 5 at ``PROBE_CAP`` (3
    K11 launches a strip), each against the
    same dispatch through the plain versions on the card
    (``plain_strip_kernels``): boards, skip counts and activity;
    then K12 and K11 launch by launch (``check_strip_launches``), K12 also
    on the ``sparse`` board's strips, 4 launches, where every route must
    run on the card, and K10 alone at depths 6 to 30 on every strip's
    extended block.
    Returns the sharded boards (phase 4 times them)."""
    m = mesh_lib.make_mesh(MESH_E, virtual(MESH_E, device))
    sharding = halo.board_sharding(m)
    strip = (BIG // MESH_E[0], BIG // 32)
    fplan = cuda_halo.adaptive_strip_plan(strip, 10**6)
    pplan = cuda_halo.adaptive_strip_plan(strip, 10**6, PROBE_CAP)
    # Path (g)'s dispatches of 6 to 11 turns: T = 6 fits a frontier form on
    # its 16-row stripes.
    gplan = cuda_halo.adaptive_strip_plan(strip, 6, PROBE_CAP)
    if not fplan.frontier or pplan.frontier or not gplan.frontier:
        raise AssertionError(f"strip plans {fplan}, {pplan}, {gplan}: not a frontier, a probing "
                             "and a frontier plan")
    cases = {name: sharding.shard(p) for name, p in (
        ("fresh", boards["fresh"]), ("settled", boards["settled"]),
        ("seam", seam_gliders(boards["settled"])))}
    tag = {"strip_frontier": "K12", "strip_mega": "K14", "strip_probing": "K11"}
    for rule in RULES:
        for name, sb in cases.items():
            # The frontier plan on both tiers (in_kernel=False: K12 with
            # the exchange between launches; the policy's default on one
            # card: one 8-launch K14 chunk, and with 12 launches a 4-launch
            # K11 tail after it), the probing plan on K11.
            for plan, cap, n, in_kernel, want_counts in (
                    (fplan, 0, 8, False, {"strip_frontier": 32}),
                    (fplan, 0, 8, None, {"strip_mega": 8, "strip_probing": 0}),
                    (fplan, 0, 12, None, {"strip_mega": 8, "strip_probing": 16}),
                    (pplan, PROBE_CAP, 3, None, {"strip_probing": 12})):
                turns = plan.t * (n + 1) - 5  # n full launches, then K10 and K9
                want_counts = {**want_counts, "ext_skip": 4, "ext": 4}
                reset_launches()
                got, sk, act = cuda_halo.make_superstep(m, rule, True, cap, True, in_kernel)(
                    sb, turns)
                torch.cuda.synchronize()
                counts = {k: WRAPPERS[k].launches for k in want_counts}
                if counts != want_counts:
                    raise AssertionError(f"strip dispatch launched {counts}, not {want_counts}")
                with plain_strip_kernels():
                    want, wsk, wact = cuda_halo.make_superstep(m, rule, True, cap, True,
                                                               in_kernel)(sb, turns)
                torch.cuda.synchronize()
                err = max(max_abs_err(a, b) for a, b in zip(got.flat, want.flat))
                for k, v in want_counts.items():
                    if v:
                        errs[k] = max(errs[k], err)
                if err or int(sk) != int(wsk) or not torch.equal(act, wact):
                    raise AssertionError(f"strip dispatch != plain ({plan}) on the {name} board "
                                         f"under {rule.notation}: skipped {int(sk)} vs {int(wsk)}")
                total = cuda_halo.adaptive_strip_launches((BIG, BIG // 32), MESH_E, turns, cap)
                tags = "+".join(tag[k] for k, v in want_counts.items() if v and k in tag)
                log(f"{tags}+K10+K9 {MESH_E} {BIG}^2 x {turns} ({plan}) "
                    f"{name} {rule.notation}: identical, skipped {int(sk)} of {total}, "
                    f"active stripes {int((act > 0).sum())}")
            check_strip_launches(sb, rule, errs, (fplan, pplan, gplan), name)
            for t in (6, 12, 18, 24, 30):
                for e in (e for row in halo.extend(sb, t, 0) for e in row):
                    got = cuda_halo.ext_skip_launch(e, rule, t, t, 0)
                    want = cuda_halo.ext_skip_launch_plain(e, rule, t, t, 0)
                    errs["ext_skip"] = max(errs["ext_skip"], max_abs_err(got, want))
                    if not torch.equal(got, want):
                        raise AssertionError(f"K10 != plain at {t} turns, {name}, {rule.notation}")
            log(f"K10 x {{6, 12, 18, 24, 30}} on the 4 {name} strips {rule.notation}: identical")
            if name == "settled" and rule is CONWAY:
                e = halo.extend(sb, 18, 0)[0][0]
                log(f"K10 on settled strip 0 at T = 18: {check_k10_settled(e, 18, 0, 'strip 0')}")
    cases["sparse"] = sharding.shard(sparse)
    k12 = check_strip_launches(cases["sparse"], CONWAY, errs, (fplan,), "sparse", 4)
    log(f"K12's routes on the sparse strips: "
        f"{sorted(require_routes(k12, 'K12 on the sparse strips'))}")
    # K12's and K11's generic instantiations (Day & Night), launch by launch.
    cuda_halo.strip_frontier_launch.rules.clear()
    cuda_halo.strip_probing_launch.rules.clear()
    for name, sb in cases.items():
        check_strip_launches(sb, DAY_AND_NIGHT, errs, (fplan, pplan), name)
    for kernel in ("strip_frontier", "strip_probing"):
        if not WRAPPERS[kernel].rules["generic"]:
            raise AssertionError(f"{kernel}'s generic instantiation did not run: "
                                 f"{dict(WRAPPERS[kernel].rules)}")
    cases["k11_settled"] = check_k11_blocks(cases, (pplan, fplan), errs)
    return cases


def check_k11_blocks(cases: dict, plans, errs: dict) -> dict:
    """K11 against its block mirror run on the card at the card's blocks
    (``cuda_halo.strip_probing_launch_mirror`` on ``strip_reg_plan``), three
    launches on the four (4, 1) strips of the fresh and settled boards from
    a zero bitmap, at path (g)'s plan and (e)'s loose-tail plan (``plans``),
    both rules: each launch's strips and bitmaps, tolerance 0.  Then, at
    each plan on the settled strips (``check_k11_settled``), every stripe
    elides.  Returns the settled launches' counts."""
    strip = tuple(cases["fresh"].shards[0][0].shape)
    sms = cuda_adaptive.device_sms(cases["fresh"].shards[0][0].device)
    settled = {}
    for plan in plans:
        blocks = cuda_halo.strip_reg_plan(plan, strip, sms)
        mirror = functools.partial(cuda_halo.strip_probing_launch_mirror, blocks=blocks)
        for rule in RULES:
            for name in ("fresh", "settled"):
                strips = [row[0] for row in cases[name].shards]
                runs = []
                for fn in (cuda_halo.strip_probing_launch, mirror):
                    seen = []

                    def record(*args, _fn=fn, _seen=seen):
                        out = _fn(*args)
                        _seen.append((out.clone(), args[5].clone()))
                        return out

                    cuda_halo.probing_launches(strips, rule, plan, 3, record)
                    runs.append(seen)
                torch.cuda.synchronize()
                for (b, f), (wb, wf) in zip(*runs):
                    err = max(max_abs_err(b, wb), max_abs_err(f, wf))
                    errs["strip_probing"] = max(errs["strip_probing"], err)
                    if err:
                        raise AssertionError(f"K11 != its block mirror ({plan}, {blocks}) on the "
                                             f"{name} strips under {rule.notation}")
        log(f"K11 x 3 launches at {plan} ({blocks}) on the fresh and settled strips, "
            f"{len(RULES)} rules: identical to the block mirror")
        settled[str(plan)] = check_k11_settled([row[0] for row in cases["settled"].shards], plan)
    return settled


def check_k11_settled(strips: list, plan) -> dict:
    """K11 on the settled (4, 1) strips at ``plan``: a launch from a zero
    bitmap must prove every stripe stable, and the next, whose stripes and
    neighbours' edge flags are then all 1, must elide every stripe: write
    nothing (each strip's buffer keeps the sentinel it was given) and
    report every stripe stable.  Returns the counts."""
    grid = plan.grid(strips[0].shape[0])
    rows = halo.edge_rows(strips, plan.pad)
    dev = strips[0].device
    flags = []
    for s, (n, so) in zip(strips, rows):
        st = torch.ones(grid, dtype=torch.int32, device=dev)
        cuda_halo.strip_probing_launch(s, n, so, torch.empty_like(s),
                                       torch.zeros(grid + 2, dtype=torch.int32, device=dev), st,
                                       CONWAY, plan)
        flags.append(st)
    proved = sum(int(f.sum()) for f in flags)
    kept = stable = 0
    for s, (n, so), ext in zip(strips, rows, cuda_halo.edge_flags(flags)):
        dst = torch.full_like(s, 7)
        st = torch.ones(grid, dtype=torch.int32, device=dev)
        cuda_halo.strip_probing_launch(s, n, so, dst, ext, st, CONWAY, plan)
        kept += int((dst == 7).all(dim=1).sum())
        stable += int(st.sum())
    out = dict(stripes=grid * len(strips), proved_at_launch_0=proved, elided_stable=stable,
               rows_untouched=kept, rows=sum(s.shape[0] for s in strips))
    if not (proved == stable == out["stripes"] and kept == out["rows"]):
        raise AssertionError(f"K11's settled launch at {plan} computed a stripe: {out}")
    log(f"K11 at {plan} on the settled strips: launch 0 proved all {proved} stripes, launch 1 "
        f"elided every one (all {kept} rows untouched)")
    return out


def mega_chunks_equal(got, want, n: int) -> int:
    """Max abs error between two K14 or K15 chunks' (shards, MeshState):
    shards, the final launch's state, skip counts and activity; the row
    flags of ``got`` must be zero again (the kernel clears them every
    launch)."""
    (g, gst), (w, wst) = got, want
    last = (n - 1) % 2
    err = max([max_abs_err(a, b) for a, b in zip(g, w)]
              + [max_abs_err(gst.state[last], wst.state[last]),
                 max_abs_err(gst.skipped, wst.skipped), max_abs_err(gst.act, wst.act)])
    if int(gst.rowflag.abs().sum()):
        raise AssertionError("a mesh megakernel left row flags set after its launch")
    return err


def flat(shards) -> list:
    """A mesh's shards in row-major order: strips as they are, rows of
    tiles flattened."""
    return [t for r in shards for t in r] if isinstance(shards[0], list) else list(shards)


def check_mega_chunks(key: str, chunk, shards, plan, runs, errs: dict, where: str,
                      each_n: int = 4):
    """K14 or K15 (``key``: "strip_mega" or "tile_mega", ``chunk`` its
    chunk function) against its plain version, tolerance 0, on ``shards``
    (``where`` names them in the log): for each (rule, n) of ``runs`` the
    n-launch chunk on the card (its launcher once, one wrapper call a
    launch, exactly n launches counted, K14's and K15's in the rule's
    instantiation)
    against the plain chunk on the card, in shards, final state, skip
    counts and activity; then ``each_n``
    launches against the plain chunk launch by launch (shards, the whole
    state, the skip counts, the activity and the routes after each,
    through ``each``).  Returns the routes of those launches on the card,
    (each_n, stripes)."""
    tag = {"strip_mega": "K14", "tile_mega": "K15"}[key]
    for rule, n in runs:
        reset_launches()
        got = chunk(shards, rule, plan, n)
        torch.cuda.synchronize()
        if WRAPPERS[key].launches != n:
            raise AssertionError(f"a {n}-launch chunk launched {tag} {WRAPPERS[key].launches} times")
        rules = WRAPPERS[key].rules  # K14's and K15's instantiations
        if rules != {instantiation(rule): n}:
            raise AssertionError(f"{tag} under {rule.notation} ran {dict(rules)}")
        want = chunk(shards, rule, plan, n, plain=True)
        err = mega_chunks_equal((flat(got[0]), got[1]), (flat(want[0]), want[1]), n)
        errs[key] = max(errs[key], err)
        if err:
            raise AssertionError(f"{tag} != plain, {n} launches on {where} under {rule.notation}")
        log(f"{tag} {where} x {n} launches ({plan}) {rule.notation}: identical, skipped "
            f"{got[1].skipped.tolist()} of {n * plan.grid(flat(shards)[0].shape[0])} a shard, "
            f"active stripes {int((got[1].act > 0).sum())}")
    seen = {}
    for on_plain in (False, True):
        def record(out, st, _seen=seen.setdefault(on_plain, [])):
            _seen.append(([t.clone() for t in flat(out)],
                          *(x.clone() for x in (st.state, st.skipped, st.act, st.route))))

        chunk(shards, CONWAY, plan, each_n, on_plain, record)
    if len(seen[False]) != each_n or len(seen[True]) != each_n:
        raise AssertionError(f"{tag} on {where}: {len(seen[False])} and {len(seen[True])} "
                             f"launches recorded, not {each_n}")
    for (a, *ka, ra), (b, *kb, rb) in zip(*seen.values()):
        if key == "tile_mega":
            # The plain version forces the edge stripes K15 elides.
            ra = torch.where(ra == cuda_adaptive.ROUTE_ELIDED, cuda_adaptive.ROUTE_FULL, ra)
        err = max([max_abs_err(x, y) for x, y in zip(a, b)]
                  + [max_abs_err(x, y) for x, y in zip(ka, kb)] + [max_abs_err(ra, rb)])
        errs[key] = max(errs[key], err)
        if err:
            raise AssertionError(f"{tag} != plain launch by launch on {where}")
    routes = torch.stack([r[-1] for r in seen[False]])
    log(f"{tag} {where}: the chunk equals the plain chunk launch by launch ({each_n} launches, "
        f"shards, state, skip counts, activity and routes; routes "
        f"{sorted(route_names(routes))})")
    return routes


def check_strip_mega(device, errs: dict, boards: dict, sparse: torch.Tensor) -> dict:
    """K14 against its plain version, tolerance 0, on the 16384² soup split
    ``MEGA_MESHES`` on virtual meshes of the card ((4, 1); (2, 1), whose
    north and south neighbours are one strip; (1, 1), the strip its own
    neighbour): fresh, settled (after ``LONG_TURNS`` generations) and
    settled with a glider across every strip seam and the torus wrap
    (``seam_gliders``), through ``check_mega_chunks``: chunks of 8
    launches under both rules and Day & Night (K14's generic
    instantiation, which must have run) and, on the settled and seam
    strips, of 16 under Conway (``LONG_RUNS``), then launch by launch; on
    (2, 1) and (1, 1) only the fresh
    and seam strips, in chunks of 8 under Conway and Day & Night; and
    the 8-launch chunk
    against K14's block mirror run on the card (``strip_mirror_chunk``);
    on (4, 1) also the ``sparse`` board's strips, where every route must
    run on the card.
    On (4, 1), a K14 chunk of 8 and of 64 must also equal one K5 chunk
    (``cuda_adaptive.frontier_superstep``) on the whole board at the strip
    plan's stripes: on one card the two compute the same function (board,
    skip count, activity).  Returns the (4, 1) strips by board (phase 4
    times them)."""
    plan = cuda_halo.adaptive_strip_plan((BIG // MESH_E[0], BIG // 32), 10**6)
    whole = {"fresh": boards["fresh"], "settled": boards["settled"],
             "seam": seam_gliders(boards["settled"]), "sparse": sparse}
    cases = {}
    for mesh_shape in MEGA_MESHES:
        ny = mesh_shape[0]
        strip_plan = cuda_halo.adaptive_strip_plan((BIG // ny, BIG // 32), 10**6)
        if strip_plan != plan or not plan.frontier:
            raise AssertionError(f"the {mesh_shape} strips do not share the frontier plan {plan}")
        runs = [(CONWAY, 8), (DAY_AND_NIGHT, 8)]
        names = ("fresh", "seam")
        if mesh_shape == MESH_E:
            runs = [(CONWAY, 8), (HIGHLIFE, 8), (DAY_AND_NIGHT, 8)]
            names = tuple(whole)
        for name in names:
            p = whole[name]
            strips = list(p.chunk(ny))
            if name == "sparse":
                runs = [(CONWAY, 8), (DAY_AND_NIGHT, 8)]
            routes = check_mega_chunks(
                "strip_mega", cuda_halo.strip_mega_launches, strips, plan,
                runs + LONG_RUNS.get((mesh_shape == MESH_E, name), []), errs,
                f"the {mesh_shape} {name} strips")
            if name == "sparse":
                log(f"K14's routes on the sparse strips: "
                    f"{sorted(require_routes(routes, 'K14 on the sparse strips'))}")
            got = cuda_halo.strip_mega_launches(strips, CONWAY, plan, 8)
            err = mega_chunks_equal(got, strip_mirror_chunk(strips, plan, 8), 8)
            errs["strip_mega"] = max(errs["strip_mega"], err)
            if err:
                raise AssertionError(f"K14 != its block mirror on the {mesh_shape} {name} strips")
            log(f"K14 {mesh_shape} {name}: the 8-launch chunk equals its block mirror on the card")
            if mesh_shape != MESH_E:
                continue
            for n in (8, 64):
                got, st = cuda_halo.strip_mega_launches(strips, CONWAY, plan, n)
                k5, sk, act = cuda_adaptive.frontier_superstep(p, CONWAY, plan, n)
                err = max(max_abs_err(torch.cat(got), k5), max_abs_err(st.act, act),
                          abs(int(st.skipped.sum()) - int(sk)))
                errs["strip_mega"] = max(errs["strip_mega"], err)
                if err:
                    raise AssertionError(f"K14 != K5 on the whole board, {n} launches, {name}")
            log(f"K14 {mesh_shape} {name}: chunks of 8 and 64 equal K5 on the whole board")
            cases[name] = strips
    return cases


def check_plan_less(device, errs: dict, dims: tuple, mesh_shape: tuple, tag: str
                    ) -> halo.ShardedBoard:
    """K10 and K9 against their plain versions, tolerance 0, at the shapes
    of path (f) (``PLAN_LESS`` on ``MESH_F``) or (i) (``TILE_PLAN_LESS`` on
    ``MESH_I``): the soup of ``dims`` split ``mesh_shape`` on a virtual
    mesh, fresh and after the path's turns, under ``REG_RULES``, on every
    shard's extended block at each depth the path launches: K10 from 6 to the full
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
    cuda_halo.ext_skip_launch.rules.clear()
    for rule in REG_RULES:
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
    if set(cuda_halo.ext_skip_launch.rules) != set(cuda_adaptive.REG_RULES):
        raise AssertionError(f"K10 ran {dict(cuda_halo.ext_skip_launch.rules)}, not every "
                             "instantiation")
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


def tile_boards(boards: dict) -> dict:
    """The boards of the 2-D checks (``check_tiles``, ``check_tile_mega``):
    the fresh and settled 16384² soups, and the settled one with gliders
    across the seams of a (2, 2) split (``tile_seam_gliders``)."""
    return {"fresh": boards["fresh"], "settled": boards["settled"],
            "seam": tile_seam_gliders(boards["settled"])}


def check_tiles(device, errs: dict, boards: dict) -> dict:
    """K13, K15 and K10 at xpad > 0 against their plain versions, tolerance
    0, on ``tile_boards`` split ``MESH_H`` (paths (h) and (j)'s shapes
    split ``MESH_J`` too) on a virtual mesh.  Whole ``skip_stable``
    dispatches of the 2-D tiers, both rules: on ``MESH_H`` at the port's
    plan 9·t - 5 turns on the ppermute tier (``in_kernel=False``: 8 K13
    launches a tile, both parities of the buffer, then a K10 remainder of
    t - 6 and a K9 of 1, at xpad 1), and 13·t - 5 on the in-kernel tier
    (one 8-launch K15 chunk, a loose tail of 4 K13 launches a tile from a
    zero bitmap, then the same remainders: path (h)'s tail, its skip
    count and activity summed over chunk and tail); on both meshes 4·t - 5 at
    ``PROBE_CAP`` (3 K13 launches a tile, then K10 at 6 and K9 at 1).  Each
    against the same dispatch through the plain versions on the card
    (``plain_strip_kernels``): boards, skip counts and (stripe, x-tile)
    activity, with the launch counts asserted; then K13 launch by launch
    (``check_tile_launches``; Day & Night too, K13's generic
    instantiation), and on ``MESH_H`` K10 alone at depths 6 to
    30 on every tile's extended block (pad = T, xpad = ceil(T / 32)).
    Returns the ``MESH_H`` sharded boards (phase 4 times them)."""
    sharded = {}
    tag = {"tile_probing": "K13", "tile_mega": "K15"}
    for mesh_shape, caps in ((MESH_H, (0, PROBE_CAP)), (MESH_J, (PROBE_CAP,))):
        m = mesh_lib.make_mesh(mesh_shape, virtual(mesh_shape, device))
        sharding = halo.board_sharding(m)
        ntiles = mesh_shape[0] * mesh_shape[1]
        tile = (BIG // mesh_shape[0], BIG // 32 // mesh_shape[1])
        runs = []
        for cap in caps:
            plan, xpad = cuda_halo.adaptive_tile_plan(tile, 10**6, cap)
            if cap:
                runs.append((plan, xpad, cap, 3, None, {"tile_probing": ntiles * 3}))
                continue
            runs += [(plan, xpad, cap, 8, False, {"tile_probing": ntiles * 8, "tile_mega": 0}),
                     (plan, xpad, cap, 12, None, {"tile_mega": 8, "tile_probing": ntiles * 4})]
        cases = {name: sharding.shard(p) for name, p in boards.items()}
        for rule in RULES:
            for name, sb in cases.items():
                for plan, xpad, cap, n, in_kernel, want_counts in runs:
                    turns = plan.t * (n + 1) - 5  # n full launches, then K10 and K9
                    want_counts = {**want_counts, "ext_skip": ntiles, "ext": ntiles}
                    reset_launches()
                    got, sk, act = cuda_halo.make_superstep(m, rule, True, cap, True, in_kernel)(
                        sb, turns)
                    torch.cuda.synchronize()
                    counts = {k: WRAPPERS[k].launches for k in want_counts}
                    if counts != want_counts:
                        raise AssertionError(f"tile dispatch launched {counts}, not {want_counts}")
                    with plain_strip_kernels():
                        want, wsk, wact = cuda_halo.make_superstep(m, rule, True, cap, True,
                                                                   in_kernel)(sb, turns)
                    torch.cuda.synchronize()
                    err = max(max_abs_err(a, b) for a, b in zip(got.flat, want.flat))
                    for k, v in want_counts.items():
                        if v:
                            errs[k] = max(errs[k], err)
                    if err or int(sk) != int(wsk) or not torch.equal(act, wact):
                        raise AssertionError(
                            f"tile dispatch != plain ({plan}) on the {mesh_shape} {name} board "
                            f"under {rule.notation}: skipped {int(sk)} vs {int(wsk)}")
                    total = cuda_halo.adaptive_strip_launches((BIG, BIG // 32), mesh_shape,
                                                              turns, cap)
                    tags = "+".join(tag[k] for k, v in want_counts.items() if v and k in tag)
                    log(f"{tags}+K10+K9 {mesh_shape} {BIG}^2 x {turns} ({plan}, xpad {xpad}) "
                        f"{name} {rule.notation}: identical, skipped {int(sk)} of {total}, "
                        f"active cells {int((act > 0).sum())} of {act.numel()}")
                for plan, xpad in {(r[0], r[1]) for r in runs}:
                    check_tile_launches(sb, rule, errs, plan, xpad, name)
                    if rule is CONWAY:  # K13's generic instantiation
                        check_tile_launches(sb, DAY_AND_NIGHT, errs, plan, xpad, name)
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
                if name == "settled" and rule is CONWAY:
                    e = halo.extend(sb, 18, 1)[0][0]
                    log(f"K10 on settled tile (0, 0) at T = 18, xpad 1: "
                        f"{check_k10_settled(e, 18, 1, 'tile (0, 0)')}")
        sharded[mesh_shape] = cases
    return sharded[MESH_H]


def check_tile_mega(errs: dict, boards: dict) -> dict:
    """K15 against its plain version, tolerance 0, on ``tile_boards`` split
    ``TILE_MEGA_MESHES`` on virtual meshes of the card ((2, 2); (2, 4);
    (1, 2), whose N and S neighbours are the tile itself and whose W and E
    neighbours are one tile), through ``check_mega_chunks``: on (2, 2)
    chunks of 8 launches under both rules and Day & Night (K15's generic
    instantiation, which must have run) and, on the settled and seam
    tiles, of 16 under Conway (``LONG_RUNS``), on (2, 4)
    and (1, 2) the fresh and seam tiles in chunks of 8 under Conway and
    Day & Night; then launch by launch.  On (2, 2) the 8-launch chunk must also equal
    K15's mirror run on the card (its blocks and its elision of edge
    stripes replayed in PyTorch), whose elided stripes are logged.  Then
    the sparse board with its gliders across the (2, 2) tiles' seams and
    a corner (``sparse_packed``) split (2, 2), twice: at the shipped
    geometry, whose 256-word tiles host no column window, so the route
    record must show no rectangle route, and under ``TIER_GEOMETRY``,
    where every route of ``ROUTES_NEEDED`` and the elided edge stripe must
    run on the card; each an 8-launch chunk under Conway, ``SPARSE_EACH``
    launches launch by launch and the 8-launch chunk against the mirror.
    Returns the (2, 2) tiles by board (phase 4 times them)."""
    cases = {}
    for mesh_shape in TILE_MEGA_MESHES:
        ny, nx = mesh_shape
        tile = (BIG // ny, BIG // 32 // nx)
        plan = cuda_halo.adaptive_tile_plan(tile, 10**6)[0]
        if not plan.frontier:
            raise AssertionError(f"the {mesh_shape} tiles have no frontier plan ({plan})")
        runs = [(CONWAY, 8), (DAY_AND_NIGHT, 8)]
        names = ("fresh", "seam")
        if mesh_shape == MESH_H:
            runs = [(CONWAY, 8), (HIGHLIFE, 8), (DAY_AND_NIGHT, 8)]
            names = tuple(boards)
        for name in names:
            tiles = tiles_of(boards[name], mesh_shape)
            check_mega_chunks("tile_mega", cuda_halo.tile_mega_launches, tiles, plan,
                              runs + LONG_RUNS.get((mesh_shape == MESH_H, name), []),
                              errs, f"the {mesh_shape} {name} tiles")
            if mesh_shape != MESH_H:
                continue
            cases[name] = tiles
            check_tile_mirror(errs, tiles, plan, f"the {mesh_shape} {name} tiles")
    tile = (BIG // MESH_H[0], BIG // 32 // MESH_H[1])
    plan = cuda_halo.adaptive_tile_plan(tile, 10**6)[0]
    tiles = tiles_of(sparse_packed(BIG, BIG, boards["fresh"].device, tiles=MESH_H), MESH_H)
    shipped = cuda_adaptive.geometry_candidates()[0]
    for geometry in (shipped, TIER_GEOMETRY):
        where = f"the {MESH_H} sparse tiles at geometry {geometry.label}"
        with cuda_adaptive.plan_geometry_override(geometry):
            tiers = cuda_adaptive.frontier_geometry(plan, tile)
            routes = check_mega_chunks("tile_mega", cuda_halo.tile_mega_launches, tiles, plan,
                                       [(CONWAY, 8)], errs, where, SPARSE_EACH)
            if geometry == shipped:
                names = require_routes(routes, f"K15 on {where}", ("skip", "row", "full", "elided"))
                if tiers[1] is not None or "tier" in names:
                    raise AssertionError(f"K15 on {where} ({tiers}) took the rectangle route")
            else:
                names = require_routes(routes, f"K15 on {where}", (*ROUTES_NEEDED, "elided"))
            log(f"K15's routes on {where} (sub_rows, col_window {tiers}): {sorted(names)}; "
                f"a launch {route_mix(routes)}")
            check_tile_mirror(errs, tiles, plan, where)
    cases["sparse"] = tiles
    return cases


def tiles_of(p: torch.Tensor, mesh_shape: tuple) -> list:
    """A board cut into the rows of tiles of ``mesh_shape``, each tile
    contiguous."""
    ny, nx = mesh_shape
    return [[t.contiguous() for t in r.chunk(nx, dim=1)] for r in p.chunk(ny)]


def check_tile_mirror(errs: dict, tiles, plan, where: str) -> None:
    """K15's 8-launch chunk on ``tiles`` against its mirror run on the card
    (``mirror_chunk``): tiles, final state, skip counts and activity,
    tolerance 0; logs the edge stripes the mirror elided."""
    got = cuda_halo.tile_mega_launches(tiles, CONWAY, plan, 8)
    out, st, elided = mirror_chunk(tiles, plan, 8)
    err = mega_chunks_equal((flat(got[0]), got[1]), (flat(out), st), 8)
    errs["tile_mega"] = max(errs["tile_mega"], err)
    if err:
        raise AssertionError(f"K15 != its mirror on {where}")
    log(f"K15 on {where}: the 8-launch chunk equals its mirror on the card, which elided "
        f"{elided} edge stripes of {8 * len(flat(tiles)) * 2}")


# -- the peer form of K14 and K15 ----------------------------------------------


def sync_all() -> None:
    """Wait for every CUDA device of the process."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def split_shards(p: torch.Tensor, mesh_shape: tuple) -> list:
    """A board cut into ``mesh_shape``'s shards: strips on a row mesh,
    rows of tiles on a 2-D mesh."""
    return list(p.chunk(mesh_shape[0])) if mesh_shape[1] == 1 else tiles_of(p, mesh_shape)


def mega_plan(mesh_shape: tuple):
    """The port's frontier plan of a ``mesh_shape`` split of the 16384²
    board (K14's strip plan, K15's tile plan); raises without one."""
    ny, nx = mesh_shape
    if nx == 1:
        plan = cuda_halo.adaptive_strip_plan((BIG // ny, BIG // 32), 10**6)
    else:
        plan = (cuda_halo.adaptive_tile_plan((BIG // ny, BIG // 32 // nx), 10**6) or (None,))[0]
    if plan is None or not plan.frontier:
        raise AssertionError(f"the {mesh_shape} shards of {BIG}^2 have no frontier plan ({plan})")
    return plan


def placed(shards, groups, cards) -> list:
    """``shards`` with group g's on ``cards[g % len(cards)]`` (None: as
    they are), in the same layout."""
    if cards is None:
        return shards
    where = {s: cards[g % len(cards)] for g, ids in enumerate(groups) for s in ids}
    moved = [t.to(where[s]) for s, t in enumerate(flat(shards))]
    if not isinstance(shards[0], list):
        return moved
    nx = len(shards[0])
    return [moved[r * nx:(r + 1) * nx] for r in range(len(shards))]


def peer_records(chunk, shards, plan, n: int, **kw) -> list:
    """``chunk`` (``strip_mega_launches`` or ``tile_mega_launches``, its
    ``kw``: plain, groups, streams) over n launches, each launch's shards,
    whole state, routes, skip counts and activity cloned on the state's
    device (the first card)."""
    seen = []

    def each(out, st):
        dev = st.state.device
        seen.append([*(t.to(dev, copy=True) for t in flat(out)), st.state.clone(),
                     st.route.clone(), st.skipped.clone(), st.act.clone()])

    chunk(shards, CONWAY, plan, n, each=each, **kw)
    return seen


def as_plain_routes(records: list) -> list:
    """``peer_records`` with the routes as the plain version gives them:
    it forces the edge stripes K15 elides."""
    return [[*r[:-3], torch.where(r[-3] == cuda_adaptive.ROUTE_ELIDED, cuda_adaptive.ROUTE_FULL,
                                  r[-3]), *r[-2:]] for r in records]


def check_peer_mega(errs: dict, boards: dict, sparse: torch.Tensor, cards=None) -> dict:
    """The peer form of K14 and K15 (the launches a card over its own
    shards, the pointer and shard-id tables, the events between launches)
    against the one-launch K14 or K15 and its plain version, tolerance 0,
    launch by launch over ``PEER_LAUNCHES``: board, both state parities,
    routes, skip count per shard and activity; then a ``PEER_CHUNK``-launch
    chunk against the one-launch chunk (shards, final state, skip counts,
    activity), with no read between its launches.  Each case of
    ``PEER_CASES`` (a mesh shape and its launch groups) on the 16384²
    soup, fresh and settled, and on ``sparse``.  ``cards`` None: one
    stream a group on this card stands in for a card (kernels of
    different streams overlap, so a missing wait shows as a difference);
    else group g runs on ``cards[g % len(cards)]`` (``--peer``), its
    shards moved there.  The launch-by-launch run must launch its kernel
    once a group a launch.  Returns per case its launches, max abs error and groups."""
    out = {}
    for name, mesh_shape, groups in PEER_CASES:
        key = "strip_mega" if mesh_shape[1] == 1 else "tile_mega"
        chunk = {"strip_mega": cuda_halo.strip_mega_launches,
                 "tile_mega": cuda_halo.tile_mega_launches}[key]
        plan = mega_plan(mesh_shape)
        err, launched = 0, 0
        for bname, p in (("fresh", boards["fresh"]), ("settled", boards["settled"]),
                         ("sparse", sparse)):
            shards = split_shards(p, mesh_shape)
            want = peer_records(chunk, shards, plan, PEER_LAUNCHES)
            plain = peer_records(chunk, shards, plan, PEER_LAUNCHES, plain=True)
            kw = dict(groups=groups)
            if cards is None:
                kw["streams"] = [torch.cuda.Stream(p.device) for _ in groups]
            where = placed(shards, groups, cards)
            reset_launches()
            got = peer_records(chunk, where, plan, PEER_LAUNCHES, **kw)
            sync_all()
            n = WRAPPERS[key].launches
            if n != PEER_LAUNCHES * len(groups):
                raise AssertionError(f"the peer form on {name} {bname} launched {key} {n} times, "
                                     f"not {PEER_LAUNCHES} x {len(groups)} groups")
            launched += n
            what = f"the peer form on {name} {bname}"
            err = max(err, records_err(got, want, f"{what} against one launch"),
                      records_err(as_plain_routes(want), plain,
                                  f"{what}: one launch against the plain version"))
            del want, plain, got
            # The records join the groups after every launch; a chunk with
            # nothing read between its launches shows a missing wait.
            reset_launches()
            out_p, st_p = chunk(where, CONWAY, plan, PEER_CHUNK, **kw)
            sync_all()
            launched += WRAPPERS[key].launches
            one = chunk(shards, CONWAY, plan, PEER_CHUNK)
            e = mega_chunks_equal(([t.to(p.device) for t in flat(out_p)], st_p),
                                  (flat(one[0]), one[1]), PEER_CHUNK)
            if e:
                raise AssertionError(f"{what}: a {PEER_CHUNK}-launch chunk differs from one "
                                     "launch's")
            del out_p, st_p, one
        errs[key] = max(errs[key], err)
        out[name] = dict(mesh_shape=list(mesh_shape), groups=[list(g) for g in groups],
                         launches=launched, max_abs_err=err,
                         cards=None if cards is None else [str(c) for c in cards])
        log(f"{key} peer form {name} ({len(groups)} groups on "
            f"{'streams of one card' if cards is None else f'{len(cards)} cards'}): "
            f"{PEER_LAUNCHES} launches launch by launch on the fresh, settled and sparse boards "
            f"equal the one-launch chunk and its plain version (board, both state parities, "
            f"routes, skip counts, activity), and a {PEER_CHUNK}-launch chunk the one-launch "
            f"chunk; {launched} launches")
    return out


def union_ms(intervals: list) -> float:
    """The ms that (start, end) intervals in us cover, overlaps once."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def traced_cards(fn, launches: int, kernels: tuple) -> dict:
    """``fn()`` (after a warm-up call) under ``torch.profiler``: per device,
    the device ms a launch of the named ``kernels`` (summed), the ms a
    launch the device was busy with any kernel or copy (overlaps once),
    its span from the first activity's start to the last one's end, the
    idle share of that span and the idle ms a launch inside it (the
    card's waits on the events of the cards it reads, and the host's
    launch gaps)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync_all()
    act, named = collections.defaultdict(list), collections.defaultdict(float)
    for e in prof.events():
        if "CUDA" not in str(e.device_type):
            continue
        a, b = e.time_range.start, e.time_range.end
        act[e.device_index].append((a, b))
        if any(k in e.name for k in kernels):
            named[e.device_index] += (b - a) / 1e3
    out = {}
    for dev, spans in sorted(act.items()):
        span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
        busy = union_ms(spans)
        out[f"cuda:{dev}"] = dict(
            kernel_ms_per_launch=named[dev] / launches, busy_ms_per_launch=busy / launches,
            span_ms=span, idle_share=1 - busy / span if span else None,
            idle_ms_per_launch=(span - busy) / launches)
    return out


def link_bytes(mesh_shape: tuple, groups, cards, plan, shape: tuple) -> dict:
    """The bytes one launch of the peer form reads from and writes to
    another card's memory at most, from its geometry (every block
    stepping, as on a fresh board): each stepping block's window words
    that lie in a shard on another card (``frontier_blocks``' tiles of
    tile_h rows with T + 6 rows a side, 32-word column groups reading one
    word past each side of their 30), and, for a card other than the
    first, each block's gathered state (K14: 3 stripes, K15: 9, 6 fields
    each, and its 4-field rectangle), each stripe's published rectangle
    (4) and finalized intervals (6), all in the first card's state
    array."""
    ny, nx = mesh_shape
    h, wp = shape
    halo = plan.t + 6
    owner = {s: cards[g % len(cards)] for g, ids in enumerate(groups) for s in ids}
    per_card = collections.Counter()
    for g, ids in enumerate(groups):
        card = cards[g % len(cards)]
        blocks = cuda_adaptive.frontier_blocks(shape, plan, len(ids))
        rows = np.arange(blocks.grid[0] * blocks.tile_h + 2 * halo) - halo
        cols = np.arange(blocks.grid[1] * blocks.centre + 2) - 1
        sy = np.where(rows < 0, -1, np.where(rows >= h, 1, 0))
        sx = np.where(cols < 0, -1, np.where(cols >= wp, 1, 0)) if nx > 1 else np.zeros_like(cols)
        # Each block reads its own window (windows of neighbouring blocks
        # overlap by 2 (T + 6) rows and 2 words): its rows by side of the
        # shard (-1 north, 0 own, 1 south), its words by side (west, own,
        # east; on a row mesh the strip spans the board's width).
        win_rows = [collections.Counter(sy[y0:y0 + blocks.tile_h + 2 * halo].tolist())
                    for y0 in range(0, blocks.grid[0] * blocks.tile_h, blocks.tile_h)]
        win_cols = [collections.Counter(sx[x0:x0 + 32].tolist())
                    for x0 in range(0, blocks.grid[1] * blocks.centre, blocks.centre)]
        for s in ids:
            dy, dx = divmod(s, nx)
            for oy in (-1, 0, 1):
                for ox in ((-1, 0, 1) if nx > 1 else (0,)):
                    src = ((dy + oy) % ny) * nx + (dx + ox) % nx
                    if owner[src] != card:
                        per_card[str(card)] += 4 * (sum(r[oy] for r in win_rows)
                                                    * sum(c[ox] for c in win_cols))
            if card != owner[0]:
                nb = (9 if nx > 1 else 3) * 6 + 4
                per_card[str(card)] += 4 * (blocks.grid[0] * blocks.grid[1] * nb
                                            + plan.grid(h) * (4 + 6))
    return dict(per_card=dict(per_card), total=sum(per_card.values()))


def time_peer(boards: dict, cards=None) -> dict:
    """The peer form of K14 over the (4, 1) strips and of K15 over the
    (2, 2) tiles of the 16384² soup, fresh and settled, four groups of one
    shard: one 64-launch chunk between CUDA events on the first card,
    over 64 (the chunk joins every group's stream there), the median and
    spread of ``BATCHES`` batches of 2 chunks, and one chunk traced
    (``traced_cards``: each card's device ms, busy and idle a launch, the
    idle an upper bound on its waits on the events of the cards it reads);
    beside, in the same call, the one-launch chunk on the first card (timed
    and traced) and,
    across ``cards``, the ppermute tier's 64 launches (four K12 or K13
    launches a mesh launch with the exchange between launches).  ``cards``
    None: one stream a group on this card.  Across cards it also prints,
    on a record of its own and not in the kernels line, the bytes a launch
    moves across cards at most: a bound from the launch's geometry
    (``link_bytes``), not a reading of the links."""
    rows, links = {}, {}
    for key, mesh_shape in (("strip_mega", MESH_E), ("tile_mega", MESH_H)):
        groups = next(g for _, m, g in PEER_CASES if m == mesh_shape and len(g) == 4)
        plan = mega_plan(mesh_shape)
        chunk = {"strip_mega": cuda_halo.strip_mega_launches,
                 "tile_mega": cuda_halo.tile_mega_launches}[key]
        kernel = {"strip_mega": "strip_mega_reg_kernel", "tile_mega": "tile_mega_reg_kernel"}[key]
        shape = (BIG // mesh_shape[0], BIG // 32 // mesh_shape[1])
        for bname in ("fresh", "settled"):
            shards = split_shards(boards[bname], mesh_shape)
            where = placed(shards, groups, cards)
            dev = boards[bname].device
            streams = None if cards else [torch.cuda.Stream(dev) for _ in groups]

            def peer(n=64):
                return chunk(where, CONWAY, plan, n, groups=groups, streams=streams)

            spread_ms = per_launch(cuda_ms_spread(peer, 2), 64)
            row = dict(
                ms=spread_ms["median"], ms_spread=spread_ms,
                one_card_ms=cuda_ms(lambda: chunk(shards, CONWAY, plan, 64), 2) / 64,
                one_card_traced=traced_cards(lambda: chunk(shards, CONWAY, plan, 64), 64,
                                             (kernel, "frontier_finalize")),
                traced=traced_cards(peer, 64, (kernel, "frontier_finalize")),
                groups=[list(g) for g in groups], plan=str(plan))
            if cards:
                if key == "strip_mega":
                    def pp():
                        return cuda_halo.frontier_launches(where, CONWAY, plan, 64)
                    pp_kernel = "strip_frontier_reg_kernel"
                else:
                    xpad = cuda_halo.adaptive_tile_plan(shape, 10**6)[1]
                    board = halo.ShardedBoard(
                        mesh_lib.make_mesh(mesh_shape, [t.device for t in flat(where)]), where)

                    def pp():
                        return cuda_halo.tile_probing_launches(board, CONWAY, plan, xpad, 64)
                    pp_kernel = "tile_probing_reg_kernel"
                row["ppermute_ms"] = cuda_ms(pp, 2) / 64
                row["ppermute_traced"] = traced_cards(pp, 64, (pp_kernel, "frontier_finalize"))
            rows.setdefault(key, {})[bname] = row
            log(f"{key} peer form over {mesh_shape} {bname} in {len(groups)} groups "
                f"({'streams of one card' if cards is None else f'{len(cards)} cards'}): "
                f"{row['ms']:.4f} ms a launch ({spread_ms['min']:.4f}-{spread_ms['max']:.4f}); "
                f"one card, one launch {row['one_card_ms']:.4f}; ppermute tier "
                f"{row.get('ppermute_ms')}; by card {row['traced']}")
        if cards:
            links[key] = link_bytes(mesh_shape, groups, cards, plan, shape)
    if links:
        print(record({"peer_link_bytes_geometry_bound": links}), flush=True)
    return rows


def peer_entries(cases: dict, times: dict) -> dict:
    """The ``peer_*`` entries of K14's and K15's rows of the kernels line:
    the peer form's checks (``check_peer_mega``: its launches and max abs
    error over the cases of the kernel) and times (``time_peer``: the
    fresh soup leads, both boards under ``peer_per_board``)."""
    out = {}
    for key, rows in times.items():
        mine = {n: c for n, c in cases.items() if (c["mesh_shape"][1] == 1) == (key == "strip_mega")}
        fresh = rows["fresh"]
        out[key] = dict(
            peer_form=("one stream a launch group on one card" if fresh.get("ppermute_ms") is None
                       else "one card a launch group"),
            peer_launches=sum(c["launches"] for c in mine.values()),
            peer_max_abs_err=max(c["max_abs_err"] for c in mine.values()),
            peer_cases=mine, peer_ms=fresh["ms"], peer_one_card_ms=fresh["one_card_ms"],
            peer_ppermute_ms=fresh.get("ppermute_ms"), peer_per_board=rows)
    return out


# -- phase 3: the main path ----------------------------------------------------


class KeysAfter(queue.Queue):
    """A key queue fed by the controller's own polling: ``schedule`` maps
    the n-th poll (``empty`` or ``get``) to the keys that arrive then — a
    keypress that lands mid-run, at a dispatch boundary."""

    def __init__(self, schedule: dict):
        super().__init__()
        self._initial = dict(schedule)
        self._schedule, self._polls = dict(schedule), 0

    def fresh(self) -> "KeysAfter":
        """The same schedule, not yet polled (a repeat of the run)."""
        return KeysAfter(self._initial)

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

    def __init__(self, shape=None, record: bool = False):
        self.shadow = None if shape is None else np.zeros(shape, np.uint8)
        self.report = self.final = self.view = self.rect = self.factors = None
        self.quit_turn = None
        self.turns = self.frames = self.deltas = self.flips = 0
        # With ``record``, every frame event as (kind, turn, rect,
        # factors, bytes): the keyframe's cells or the delta's packed
        # bands, for comparing two runs' streams frame for frame.
        self.stream = [] if record else None

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
            if self.stream is not None:
                self.stream.append(("key", e.completed_turns, e.rect, e.factors,
                                    self.view.tobytes()))
        elif kind is gol.FrameDelta:
            frames.apply_bands(self.view, e.bands)
            self.rect, self.factors = e.rect, e.factors
            self.frames += 1
            self.deltas += 1
            if self.stream is not None:
                meta, payload = frames.pack_bands(e.bands)
                self.stream.append(("delta", e.completed_turns, e.rect, e.factors,
                                    json.dumps(meta).encode() + payload))
        elif (kind is gol.StateChange and e.new_state == gol.State.QUITTING
              and self.quit_turn is None):
            self.quit_turn = e.completed_turns
        elif kind is gol.MetricsReport:
            self.report = e.snapshot
        elif kind is gol.FinalTurnComplete:
            self.final = e


def stream_run(params: gol.Params, sink: Sink, keys=None, session=None, devices=None,
               events=None, backend_factory=None, backend=None, read_final: bool = True):
    """One ``gol.run`` on the engine thread while this thread consumes the
    stream as it is produced, as the CLI does; returns (seconds, final PGM
    bytes or None; with ``read_final=False`` its path or None).  ``devices`` places the board (a virtual mesh): the run
    gets ``backend=Backend(params, devices)``; ``backend`` and
    ``backend_factory`` are ``gol.run``'s (the first attempt's Backend, the
    supervisor's rebuild seam); ``events`` replaces the run's
    ``EventQueue``."""
    events = gol.EventQueue() if events is None else events
    t0 = time.perf_counter()
    backend = Backend(params, devices) if devices else backend
    engine = gol.start(params, events, keys, session, backend, None, backend_factory)
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
    if not final.is_file():
        return seconds, None
    return seconds, (final.read_bytes() if read_final else final)


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
    its sink); ``board_sums`` counts the kernel run's separate sums of a
    board (``stencil.alive_count``).  A kernel run shorter than
    ``REP_SECONDS`` is repeated (after its launches are read) to ``REPS``
    runs, each writing the first run's final board, and its rates are
    published as ``stats`` rows (``stats_row``)."""
    sink = Sink(shadow)
    reset_launches()
    with board_sums() as sums:
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
    loops, shown = [sink.loop_seconds()], [sink.frames]

    def rerun(rep_dir: Path):
        rep_sink = Sink(shadow)
        rep = stream_run(dataclasses.replace(params, out_dir=rep_dir), rep_sink,
                         keys.fresh() if keys else None, devices=devices)
        loops.append(rep_sink.loop_seconds())
        shown.append(rep_sink.frames)
        return rep

    runs = repeats(name, seconds, final, rerun,
                   params.out_dir.with_name(params.out_dir.name + "_rep"))
    stats = dict(run=stats_row("run gens/s", [params.turns / x for x in runs]),
                 loop=stats_row("dispatch-loop gens/s", [params.turns / x for x in loops]))
    if not params.no_vis and sink.frames:
        stats["frames"] = stats_row("frames/s", [f / x for f, x in zip(shown, runs)], "frames/s")
    log(f"{name}: run {stats['run']['median']:.1f} gens/s (spread {stats['run']['spread']:.3f}, "
        f"{stats['run']['reps']} runs), loop {stats['loop']['median']:.1f} gens/s")
    if isinstance(reference, bytes):
        if final != reference:
            raise AssertionError(f"{name}: final board differs from the single-device run's")
        log(f"{name}: final board equals the single-device run's")
        out = dict(seconds=seconds, gens_per_s=params.turns / seconds, launches=counts,
                   dispatch_loop_s=sink.loop_seconds(), board_sums=sums[0], stats=stats,
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
               launches=counts, board_sums=sums[0], stats=stats, reference=dict(
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


@contextlib.contextmanager
def board_sums():
    """Count the calls of ``stencil.alive_count`` (a separate sum of a
    board) while the block runs: ``yield``s a one-entry list."""
    calls, saved = [0], stencil.alive_count

    def counted(b):
        calls[0] += 1
        return saved(b)

    stencil.alive_count = counted
    try:
        yield calls
    finally:
        stencil.alive_count = saved


def viewer_drive(name: str, params: gol.Params, launches: dict, reference, **kw):
    """``drive`` of a viewer path on K6, which must take each turn's alive
    count from K6's epilogue: the run may make no separate sum of the
    board (``board_sums``)."""
    out, sink = drive(name, params, ("stencil",), launches, reference, engine="pallas", **kw)
    if out["board_sums"]:
        raise AssertionError(f"{name}: {out['board_sums']} separate sums of the board on K6's "
                             "path")
    return out, sink


def viewer_paths(images: Path, tmp: Path, launches: dict, device) -> dict:
    """Phase 3's viewer paths: ``no_vis=False`` under ``engine="auto"``,
    which takes the byte kernel (K6) for per-turn dispatches on the card,
    and its count (``viewer_drive``).  Each final board must equal a
    headless ``engine="packed"`` rerun, and each stream must rebuild its
    final view."""
    headless = dict(engine="packed", no_vis=True)
    e2e = {}
    flips = gol.Params(turns=FLIP_TURNS, images_dir=images, out_dir=tmp / "flips", no_vis=False,
                       ticker_period=3600)
    if not flips.wants_flips():
        raise AssertionError("a 512^2 viewer run is not fed per-cell flips")
    e2e[f"flips_512x512x{FLIP_TURNS}"], sink = viewer_drive(
        f"flips 512^2 x {FLIP_TURNS}", flips, launches, headless, shadow=(512, 512))
    want = np.zeros((512, 512), np.uint8)
    for c in sink.final.alive:
        want[c.y, c.x] = 1
    if not np.array_equal(sink.shadow, want):
        raise AssertionError("the flips' shadow board differs from FinalTurnComplete.alive")
    log(f"flips: the shadow board of {sink.flips} CellFlipped events equals the final alive set")
    alive_512 = len(sink.final.alive)

    frame_p = gol.Params(turns=FRAME_TURNS, image_width=BIG, image_height=BIG,
                         soup_density=0.3, soup_seed=7, no_vis=False, out_dir=tmp / "frames",
                         ticker_period=3600)
    if not frame_p.wants_frames():
        raise AssertionError(f"a {BIG}^2 viewer run is not fed frames")
    e2e[f"frames_{BIG}x{BIG}x{FRAME_TURNS}"], sink = viewer_drive(
        f"frames {BIG}^2 x {FRAME_TURNS}", frame_p, launches, headless)
    want = stencil.frame_pool(final_board(frame_p, device), *sink.factors).cpu().numpy()
    if not np.array_equal(sink.view, want):
        raise AssertionError("the last frame differs from frame_pool of the final board")
    log(f"frames: the last of {sink.frames} frames equals frame_pool{sink.factors} of the final board")

    roi = dataclasses.replace(frame_p, turns=VIEW_TURNS, viewport=VIEWPORT,
                              out_dir=tmp / "viewport")
    keys = KeysAfter({VIEW_TURNS // 4: "d", VIEW_TURNS // 2: "+", 3 * VIEW_TURNS // 4: "-"})
    e2e[f"viewport_{BIG}x{BIG}x{VIEW_TURNS}"], sink = viewer_drive(
        f"viewport {BIG}^2 x {VIEW_TURNS}", roi, launches, headless, keys=keys)
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
    pgm_name = f"512x512x{turns}.pgm"

    def rerun(rep_dir: Path):
        rep_s = cli_run(tmp, 512, turns, alive, "--out-dir", str(rep_dir))[0]
        return rep_s, (rep_dir / pgm_name).read_bytes()

    runs = repeats("the CLI", seconds, (tmp / "out" / pgm_name).read_bytes(), rerun,
                   tmp / "cli_rep")
    return dict(seconds=seconds, gens_per_s=turns / seconds, stdout_bytes=len(stdout),
                stats=dict(run=stats_row("run gens/s with process start",
                                         [turns / x for x in runs])),
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
    batched launch and no eviction.  A pod shorter than ``REP_SECONDS``
    runs again to ``REPS`` pods (after its launches are read), each tenant
    writing its first run's PGM.  Returns the pod's numbers."""
    nt, side, turns, superstep = shape
    config = ServeConfig(max_sessions=nt, batched=batched, max_total_cells=nt * side * side)

    def run_pod(root: Path):
        params = [gol.Params(turns=turns, image_width=side, image_height=side,
                             soup_density=0.3, soup_seed=100 + i, superstep=superstep,
                             turn_events="batch", ticker_period=3600, out_dir=root / f"t{i}")
                  for i in range(nt)]
        t0 = time.perf_counter()
        with ServePlane(config) as plane:
            handles = [plane.submit(f"t{i}", p) for i, p in enumerate(params)]
            if not plane.wait_idle(timeout=900):
                raise AssertionError(f"pod {name}: tenants still resident after 900 s")
            wall = time.perf_counter() - t0
            health = plane.health()
        for h in handles:
            if h.status != "completed":
                raise AssertionError(f"pod {name}: tenant {h.tenant} ended {h.status} ({h.error})")
        return params, handles, wall, health

    before = metrics.REGISTRY.snapshot()
    reset_launches()
    params, handles, wall, health = run_pod(tmp / name)
    counts = launch_counts()
    counters = metrics.REGISTRY.snapshot().delta(before).to_dict()["counters"]
    for k in kernels:
        launches[k] += counts[k]
        if counts[k] == 0:
            raise AssertionError(f"pod {name}: the {k} kernel never launched")
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
    aggregate, tenant_median = [nt * turns / wall], [median_tenant(handles, turns)]

    def pgms(ps) -> list:
        return [(p.out_dir / f"{p.final_output_name}.pgm").read_bytes() for p in ps]

    def rerun(root: Path):
        rep_params, rep_handles, rep_wall, _ = run_pod(root)
        aggregate.append(nt * turns / rep_wall)
        tenant_median.append(median_tenant(rep_handles, turns))
        return rep_wall, pgms(rep_params)

    walls = repeats(f"pod {name}", wall, pgms(params), rerun, tmp / f"{name}_rep")
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
        stats=dict(aggregate=stats_row("pod aggregate gens/s", aggregate),
                   median_tenant=stats_row("pod median tenant gens/s", tenant_median)),
        walls_s=walls,
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


def median_tenant(handles, turns: int) -> float:
    """The median tenant's gens/s of one pod (the upper median)."""
    return measure.median([turns / h.duration for h in handles])


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
    def pgms(pod: Path) -> list:
        return [(pod / n / f"{side}x{side}x{turns}.pgm").read_bytes() for n in names]

    def rerun(rep_pod: Path):
        rep_cmd = [str(rep_pod) if a == str(tmp / "pod") else a for a in cmd]
        t1 = time.perf_counter()
        rr = subprocess.run(rep_cmd, cwd=tmp, env=env, capture_output=True, text=True,
                            timeout=600)
        if rr.returncode:
            raise AssertionError(f"a repeated serve CLI run exited {rr.returncode}")
        return time.perf_counter() - t1, pgms(rep_pod)

    runs = repeats("the serve CLI", seconds, pgms(tmp / "pod"), rerun, tmp / "pod_rep")
    print(f"serving pod CLI {nt} x {side}^2 x {turns} --batched: {seconds:.3f} s with process "
          f"start, {health['batched_launches']} batched launches carrying "
          f"{health['batched_boards']} boards", flush=True)
    return dict(seconds=seconds, tenants=nt, side=side, turns=turns,
                batched_launches=health["batched_launches"],
                batched_boards=health["batched_boards"],
                stats=dict(aggregate=stats_row("pod aggregate gens/s with process start",
                                               [nt * turns / x for x in runs])))


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


@contextlib.contextmanager
def dgol_ici(value):
    """``DGOL_ICI`` set to ``value`` (None: unset) while the block runs,
    then restored."""
    saved = os.environ.pop("DGOL_ICI", None)
    if value is not None:
        os.environ["DGOL_ICI"] = value
    try:
        yield
    finally:
        os.environ.pop("DGOL_ICI", None)
        if saved is not None:
            os.environ["DGOL_ICI"] = saved


def strip_paths(tmp: Path, long_pgm: bytes, straight: bytes, launches: dict, device) -> dict:
    """Phase 3's ``skip_stable`` runs on row meshes, each on a virtual mesh
    of the one card: (e) the 16384² soup x 100,000 on (4, 1) under auto,
    equal to the single-device run's PGM, on the in-kernel tier; (k) the
    same with ``DGOL_ICI=0`` (set around the run), on the ppermute tier;
    (f) ``PLAN_LESS`` on (8, 1), ``skip_stable=True``, equal to a
    single-device rerun; (g) the soup x 2,000 on (4, 1) at ``PROBE_CAP``,
    equal to the single-device 2,000-turn PGM.  Each must report
    ``pallas-packed``, its tier and its policy, and launch its kernel: (e)
    K14 and no K12, (k) K12 and no K14, (f) K10 and no K11, K12 or K14,
    (g) K11; the loose tails' K11 and the remainders' K10 and K9 launches
    are counted where they ran."""
    e2e = {}
    soup = dict(image_width=BIG, image_height=BIG, soup_density=0.3, soup_seed=7,
                turn_events="batch", ticker_period=3600)
    h, w, turns = PLAN_LESS
    no_plan = "no frontier plan"
    long = gol.Params(turns=LONG_TURNS, mesh_shape=MESH_E, out_dir=tmp / "strips_e", **soup)
    runs = [
        ("e", long, ("strip_mega",), long_pgm, None, "ici-megakernel", "in-kernel"),
        ("k", dataclasses.replace(long, out_dir=tmp / "strips_k"), ("strip_frontier",), long_pgm,
         "0", "ppermute", "forced-ppermute (DGOL_ICI=0)"),
        ("f", gol.Params(turns=turns, image_height=h, image_width=w, soup_density=0.3,
                         soup_seed=7, turn_events="batch", ticker_period=3600, skip_stable=True,
                         mesh_shape=MESH_F, out_dir=tmp / "strips_f"),
         ("ext_skip",), dict(mesh_shape=(1, 1), skip_stable=False), None, "ppermute", no_plan),
        ("g", gol.Params(turns=2000, skip_stable=True, skip_tile_cap=PROBE_CAP,
                         mesh_shape=MESH_E, out_dir=tmp / "strips_g", **soup),
         ("strip_probing",), straight, None, "ppermute", no_plan),
    ]
    forbidden = {"e": ("strip_frontier",), "k": ("strip_mega",),
                 "f": ("strip_probing", "strip_frontier", "strip_mega"), "g": ("strip_mega",)}
    for tag, params, kernels, want, ici, tier_want, policy_want in runs:
        if not params.skip_stable_requested():
            raise AssertionError(f"skip_stable is not requested on path ({tag})")
        ny, nx = params.mesh_shape
        name = f"strips ({tag}) {params.image_height}x{params.image_width} x {params.turns} on {ny}x{nx}"
        if ici is not None:
            name += f", DGOL_ICI={ici}"
        with dgol_ici(ici):
            out, sink = drive(name, params, kernels, launches, want,
                              devices=virtual(params.mesh_shape, device))
        for k in ("ext", *STRIPS, "strip_mega"):  # the tails' launches count too
            if k not in kernels:
                launches[k] += out["launches"][k]
        tier = sink.report["info"].get("backend.sharded_tier")
        policy = sink.report["info"].get("backend.sharded_tier_policy")
        if tier != tier_want or not policy.startswith(policy_want):
            raise AssertionError(f"{name}: backend.sharded_tier {tier!r} ({policy!r}), not "
                                 f"{tier_want!r} ({policy_want!r}...)")
        ran = [k for k in forbidden[tag] if out["launches"][k]]
        if ran:
            raise AssertionError(f"{name}: launched {ran}")
        out["sharded_tier"], out["sharded_tier_policy"] = tier, policy
        e2e[f"strips_{tag}_{params.image_height}x{params.image_width}x{params.turns}_{ny}x{nx}"] = out
        print(f"strip path {name}: {out['seconds']:.3f} s, {out['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {out['dispatch_loop_s']:.3f} s, tier {tier}, skip fraction "
              f"{out.get('skip_fraction')}, launches "
              f"{ {k: out['launches'][k] for k in ('ext', *STRIPS, 'strip_mega')} }", flush=True)
    return e2e


def tile_paths(tmp: Path, long_pgm: bytes, straight: bytes, launches: dict, device) -> dict:
    """Phase 3's ``skip_stable`` runs on 2-D meshes, each on a virtual
    mesh of the one card: (h) the 16384² soup x 100,000 on ``MESH_H``
    under auto, equal to the single-device run's PGM, on the in-kernel
    tier; (l) the same with ``DGOL_ICI=0`` (set around the run), on the
    ppermute tier; (i) ``TILE_PLAN_LESS`` on ``MESH_I``,
    ``skip_stable=True``, equal to a single-device rerun; (j) the soup x
    2,000 on ``MESH_J`` at ``PROBE_CAP``, equal to the single-device
    2,000-turn PGM.  Each must report ``pallas-packed``, its tier and its
    policy ((i) and (j): "no frontier plan"), and launch its kernel: (h)
    K15 (K13 only in the loose tails), (l) K13 and no K15, (i) K10 and no
    K13 or K15, (j) K13 and no K15; the tails' K13 and the remainders' K10
    and K9 launches are counted where they ran.  Then (h)'s board on
    ``MESH_H`` with ``skip_stable=False``, K9 alone, equal to the same
    PGM."""
    e2e = {}
    soup = dict(image_width=BIG, image_height=BIG, soup_density=0.3, soup_seed=7,
                turn_events="batch", ticker_period=3600)
    h, w, turns = TILE_PLAN_LESS
    no_plan = "no frontier plan"
    long = gol.Params(turns=LONG_TURNS, mesh_shape=MESH_H, out_dir=tmp / "tiles_h", **soup)
    runs = [
        ("h", long, ("tile_mega",), long_pgm, None, "ici-megakernel", "in-kernel"),
        ("l", dataclasses.replace(long, out_dir=tmp / "tiles_l"), ("tile_probing",), long_pgm,
         "0", "ppermute", "forced-ppermute (DGOL_ICI=0)"),
        ("i", gol.Params(turns=turns, image_height=h, image_width=w, soup_density=0.3,
                         soup_seed=7, turn_events="batch", ticker_period=3600, skip_stable=True,
                         mesh_shape=MESH_I, out_dir=tmp / "tiles_i"),
         ("ext_skip",), dict(mesh_shape=(1, 1), skip_stable=False), None, "ppermute", no_plan),
        ("j", gol.Params(turns=2000, skip_stable=True, skip_tile_cap=PROBE_CAP,
                         mesh_shape=MESH_J, out_dir=tmp / "tiles_j", **soup),
         ("tile_probing",), straight, None, "ppermute", no_plan),
    ]
    forbidden = {"h": (), "l": ("tile_mega",), "i": ("tile_probing", "tile_mega"),
                 "j": ("tile_mega",)}
    for tag, params, kernels, want, ici, tier_want, policy_want in runs:
        if not params.skip_stable_requested():
            raise AssertionError(f"skip_stable is not requested on path ({tag})")
        ny, nx = params.mesh_shape
        name = f"tiles ({tag}) {params.image_height}x{params.image_width} x {params.turns} on {ny}x{nx}"
        if ici is not None:
            name += f", DGOL_ICI={ici}"
        with dgol_ici(ici):
            out, sink = drive(name, params, kernels, launches, want,
                              devices=virtual(params.mesh_shape, device))
        for k in ("ext", "ext_skip", "tile_probing", "tile_mega"):  # tails and remainders too
            if k not in kernels:
                launches[k] += out["launches"][k]
        tier = sink.report["info"].get("backend.sharded_tier")
        policy = sink.report["info"].get("backend.sharded_tier_policy")
        if tier != tier_want or not policy.startswith(policy_want):
            raise AssertionError(f"{name}: backend.sharded_tier {tier!r} ({policy!r}), not "
                                 f"{tier_want!r} ({policy_want!r}...)")
        ran = [k for k in forbidden[tag] if out["launches"][k]]
        if ran:
            raise AssertionError(f"{name}: launched {ran}")
        if tag == "h":
            # K13 only in loose tails: fewer than 8 launches a tile a dispatch.
            dispatches = sink.report["counters"]["backend.dispatches.pallas-packed"]
            k13, ntiles = out["launches"]["tile_probing"], ny * nx
            if k13 % ntiles or k13 > 7 * ntiles * dispatches:
                raise AssertionError(f"{name}: {k13} K13 launches in {dispatches} dispatches "
                                     "are more than the loose tails'")
        out["sharded_tier"], out["sharded_tier_policy"] = tier, policy
        e2e[f"tiles_{tag}_{params.image_height}x{params.image_width}x{params.turns}_{ny}x{nx}"] = out
        print(f"tile path {name}: {out['seconds']:.3f} s, {out['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {out['dispatch_loop_s']:.3f} s, tier {tier}, skip fraction "
              f"{out.get('skip_fraction')}, active stripes {out.get('active_stripes')}, launches "
              f"{ {k: out['launches'][k] for k in ('ext', 'ext_skip', 'tile_probing', 'tile_mega')} }",
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


# -- phase 3, the resilience paths: (m) time compression, (n) a supervised
# run under faults with the run's telemetry sampler, (o) the ladder's
# forced-ppermute rung on a virtual mesh.


class _ArmingEvents(gol.EventQueue):
    """An event queue that arms ``keys`` when ``CycleDetected`` goes by (in
    the engine's thread, so the arming is at a fixed point of the run)."""

    def __init__(self, keys):
        super().__init__()
        self.keys = keys

    def put(self, item, block=True, timeout=None):
        if type(item) is gol.CycleDetected:
            self.keys.armed = True
        super().put(item, block, timeout)


class _QAfterCycle(queue.Queue):
    """Keys: 'q' at the ``after``-th poll once the compressed interval has
    begun (the fast-forward polls at its chunk boundaries)."""

    def __init__(self, after: int):
        super().__init__()
        self.after, self.polls, self.armed = after, 0, False

    def empty(self) -> bool:
        if self.armed:
            self.polls += 1
            if self.polls == self.after:
                self.put("q")
        return super().empty()


def counted_run(params: gol.Params, **kw) -> dict:
    """``stream_run`` with the launch counts set to 0 just before and read
    just after, and the run's counter deltas (``timecomp.*``,
    ``supervisor.*``, ``faults.*``, ``sdc.*``) from the process-wide
    registry."""
    before = metrics.REGISTRY.snapshot()
    sink = Sink()
    reset_launches()
    seconds, final = stream_run(params, sink, **kw)
    counts = launch_counts()
    delta = metrics.REGISTRY.snapshot().delta(before).to_dict()["counters"]
    own = ("timecomp.", "supervisor.", "faults.", "sdc.", "backend.dispatches.")
    return dict(seconds=seconds, final=final, sink=sink, launches=counts,
                counters={k: v for k, v in delta.items() if k.startswith(own)})


def timecomp_path(tmp: Path, long_pgm: bytes, launches: dict) -> dict:
    """(m): the 16384² soup x ``LONG_TURNS`` under auto (``skip_stable``:
    K5, K4, K3) with ``time_compression=True``, superstep 240, a probe
    every 2 dispatches (the tier defers them while the activity bitmap
    shows live stripes).  Each run must write the long run's PGM (the
    dense run of the same board) with the same turns and final alive
    count; the first must compress with an ``AshCache`` miss (a row of
    one run), the second and its repeats (to ``REPS``) hit it (the
    ``compressed`` row).  Then a 'q' inside the compressed interval
    parks a sidecar whose ``computed_turns`` is far below its
    ``effective_turns``; a resumed run detached again parks the
    cumulative split (``TimeCompressor.restore``); a last resume writes
    the long run's PGM."""
    params = gol.Params(turns=LONG_TURNS, image_width=BIG, image_height=BIG, soup_density=0.3,
                        soup_seed=7, turn_events="batch", ticker_period=3600,
                        time_compression=True, superstep=240, cycle_check=2,
                        out_dir=tmp / "tc")
    alive = int((pgm.decode_pgm(long_pgm) == 255).sum())
    timecomp.CACHE.clear()
    runs = []

    def compressed(out_dir: Path):
        r = counted_run(dataclasses.replace(params, out_dir=out_dir))
        final = r["sink"].final
        if (r["sink"].turns != LONG_TURNS or final.completed_turns != LONG_TURNS
                or len(final.alive) != alive):
            raise AssertionError(f"(m) run {len(runs)}: turns or alive count differ from the "
                                 "long (dense) run's")
        runs.append(r)
        return r["seconds"], r["final"]

    # The first run misses the AshCache and captures the period; the
    # second hits it, and is repeated as a row of its own.
    for i in range(2):
        if compressed(tmp / f"tc{i}")[1] != long_pgm:
            raise AssertionError(f"(m) run {i}: the final board differs from the long run's")
        shutil.rmtree(tmp / f"tc{i}", ignore_errors=True)
    hit_seconds = repeats("(m)", runs[1]["seconds"], long_pgm, compressed, tmp / "tc_rep")
    first = runs[0]["counters"]
    if not first.get("timecomp.skips") or not first.get("timecomp.cache_misses"):
        raise AssertionError(f"(m): the first run did not compress: {first}")
    for r in runs[1:]:
        if not r["counters"].get("timecomp.cache_hits") or r["counters"].get(
                "timecomp.cache_misses"):
            raise AssertionError(f"(m): a later run did not hit the AshCache: {r['counters']}")
    if not runs[0]["launches"]["frontier"]:
        raise AssertionError("(m): K5 never launched before the board settled")
    for k in ADAPTIVE:
        launches[k] += runs[0]["launches"][k]

    def row(rs, seconds) -> dict:
        computed = LONG_TURNS - rs[0]["counters"]["timecomp.skipped_turns"]
        out = stats_row("run gens/s", [LONG_TURNS / x for x in seconds], "effective gens/s")
        out.update(computed_gens_per_s=measure.median([computed / x for x in seconds]),
                   effective_turns=LONG_TURNS, computed_turns=computed)
        return out

    stats = dict(compressed_miss=row(runs[:1], [runs[0]["seconds"]]),
                 compressed=row(runs[1:], hit_seconds))
    computed = stats["compressed_miss"]["computed_turns"]
    out = dict(seconds=[r["seconds"] for r in runs], launches=[r["launches"] for r in runs],
               counters=[r["counters"] for r in runs], computed_turns=computed,
               effective_turns=LONG_TURNS, stats=stats)
    print(f"time compression (m) {BIG}^2 x {LONG_TURNS}: {[round(r['seconds'], 3) for r in runs]} "
          f"s (a miss, then hits); computed {computed} of {LONG_TURNS} turns on the miss, "
          f"{stats['compressed']['computed_turns']} on a hit; counters "
          f"{[r['counters'] for r in runs[:2]]}; launches "
          f"{[r['launches'] for r in runs[:2]]}; equals the long run", flush=True)

    # Detach inside the interval twice, then resume to the end.
    ckpt, metas = tmp / "ckpt_tc", []
    per_turn = dataclasses.replace(params, turn_events="per-turn", out_dir=tmp / "tc_resume")
    for leg in range(3):
        keys = _QAfterCycle(DETACH_POLL) if leg < 2 else None
        r = counted_run(per_turn, keys=keys, session=Session(ckpt),
                        events=_ArmingEvents(keys) if keys else None)
        if leg < 2:
            if r["final"] is not None:
                raise AssertionError(f"(m) detach leg {leg}: the run did not detach")
            metas.append(json.loads((ckpt / "checkpoint.json").read_text()))
        elif r["final"] != long_pgm:
            raise AssertionError("(m) the resumed run's final board differs from the long run's")
    a, b = metas
    if not (0 < a["turn"] < b["turn"] < LONG_TURNS and a["effective_turns"] == a["turn"]
            and b["effective_turns"] == b["turn"] and a["computed_turns"] < b["computed_turns"]
            < a["turn"]):
        raise AssertionError(f"(m) the parked splits do not add up: {a}, {b}")
    out["detach"] = {f"leg{i}": {k: m[k] for k in ("turn", "computed_turns", "effective_turns")}
                     for i, m in enumerate(metas)}
    print(f"time compression (m): detached at {out['detach']}, resumed to the long run's board",
          flush=True)
    return out


@contextlib.contextmanager
def recorded(module, name: str):
    """While the block runs, ``module.name`` (a class or function) is
    wrapped so that every object it makes or returns lands in the yielded
    list."""
    made, original = [], getattr(module, name)

    if isinstance(original, type):
        class Recorded(original):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        wrapper = Recorded
    else:
        def wrapper(*a, **kw):
            made.append(original(*a, **kw))
            return made[-1]
    setattr(module, name, wrapper)
    try:
        yield made
    finally:
        setattr(module, name, original)


def supervised_path(tmp: Path, straight: bytes, launches: dict) -> dict:
    """(n): the 16384² soup x 2,000 (auto: K2) through ``gol.run`` with
    ``restart_limit=3``, an SDC check every dispatch, a checkpoint every
    ``N_CKPT`` turns, the dispatch watchdog at ``N_DEADLINE`` s, and ``N_FAULTS`` in one
    ``FaultInjectionBackend`` carried across the attempts (the factory
    rebinds it): the corrupt is caught by the sentinel and rolled back,
    the hang rebuilt after the watchdog, the issue burst rebuilt on the
    elastic rung.  The final PGM must equal the unsupervised run's; the
    run's telemetry sampler (``N_SAMPLE`` s) must hold samples, and the
    final snapshot must round-trip through OpenMetrics."""
    from distributed_gol_torch.engine import supervisor as supervisor_mod

    params = gol.Params(turns=2000, image_width=BIG, image_height=BIG, soup_density=0.3,
                        soup_seed=7, turn_events="batch", ticker_period=3600, superstep=N_STEP,
                        restart_limit=3, checkpoint_every_turns=N_CKPT,
                        sdc_check_every_turns=N_STEP, dispatch_deadline_seconds=N_DEADLINE,
                        telemetry_sample_seconds=N_SAMPLE, out_dir=tmp / "supervised")
    harness = FaultInjectionBackend(Backend(params), FaultPlan(N_FAULTS))

    def factory(p, attempt):
        return harness if attempt == 0 else harness.rebind(Backend(p))

    try:
        with recorded(supervisor_mod, "supervise") as sups, \
                recorded(timeseries, "TelemetrySampler") as samplers:
            run = counted_run(params, session=Session(tmp / "ckpt_n"), backend_factory=factory)
    finally:
        harness.release_hangs()
    sup, sink = sups[0], run["sink"]
    history = [{k: v for k, v in r.items() if k != "t"} for r in sup.history]
    causes = [r["cause"] for r in history]
    if run["final"] != straight:
        raise AssertionError(f"(n): the supervised run's PGM differs from the unsupervised "
                             f"run's (history {history})")
    if causes != ["CorruptionDetected", "DispatchTimeout", "RuntimeError"]:
        raise AssertionError(f"(n): restarts {causes}")
    if [f.kind for f in harness.injected] != [f.kind for f in N_FAULTS]:
        raise AssertionError(f"(n): injected {harness.injected}")
    if not run["launches"]["tiled"]:
        raise AssertionError("(n): K2 never launched")
    launches["tiled"] += run["launches"]["tiled"]
    samples = len(samplers[0].samples()) if samplers else 0
    if not samples:
        raise AssertionError("(n): the run's telemetry sampler holds no sample")
    problems = openmetrics.check_roundtrip(sink.report)
    if problems:
        raise AssertionError(f"(n): the final snapshot does not round-trip: {problems}")
    print(f"supervised (n) {BIG}^2 x 2000: {run['seconds']:.3f} s, history {history}, "
          f"recovery times {sup.recovery_times()} s, counters {run['counters']}, launches "
          f"{run['launches']}, {samples} telemetry samples; equals the unsupervised run",
          flush=True)
    return dict(seconds=run["seconds"], history=history, recovery_times_s=sup.recovery_times(),
                counters=run["counters"], launches=run["launches"], telemetry_samples=samples,
                openmetrics_lines=len(openmetrics.render(sink.report).splitlines()),
                stats=dict(run=stats_row("run gens/s", [2000 / run["seconds"]])))


def escalation_path(tmp: Path, launches: dict, device, devices=None) -> dict:
    """(o): path (e)'s soup x ``O_TURNS`` on ``MESH_E`` with ``skip_stable``
    (``devices`` places it: the virtual mesh of ``device`` by default; (u5)
    gives it four cards, where the first rung is the peer form),
    superstep ``O_STEP``, a checkpoint every ``O_CKPT`` turns,
    ``restart_limit=2`` and two issue bursts (``O_FAULTS``), under the
    supervisor's own rebuild ladder: the first attempt's Backend on the
    virtual mesh is wrapped in a ``FaultInjectionBackend``, and every
    Backend the ladder builds (``supervisor.Backend``, patched for the
    phase) is rebound into the same harness.  The ladder must rebuild on
    the first attempt's placement (``Supervisor._placement``): the same
    tier, then from ``Supervisor._ESCALATE_AT`` ``in_kernel=False``, so the
    history's tiers read same, forced-ppermute.  K14 must have launched
    before the escalation and K12 after it (and neither in the other
    phase); the last Backend's tier reads ``forced-ppermute
    (in_kernel=False)`` on the virtual mesh; the final PGM must equal the
    single-device run's."""
    from distributed_gol_torch.engine import supervisor as supervisor_mod

    soup = dict(image_width=BIG, image_height=BIG, soup_density=0.3, soup_seed=7,
                turn_events="batch", ticker_period=3600)
    straight = stream_run(gol.Params(turns=O_TURNS, out_dir=tmp / "escalate_ref", **soup),
                          Sink())[1]
    params = gol.Params(turns=O_TURNS, mesh_shape=MESH_E, skip_stable=True, superstep=O_STEP,
                        restart_limit=2, checkpoint_every_turns=O_CKPT,
                        out_dir=tmp / "escalate", **soup)
    devices = devices or virtual(MESH_E, device)
    harness = FaultInjectionBackend(Backend(params, devices), FaultPlan(O_FAULTS))
    marks, built = {}, []

    def rebuilt(p, devices=None, in_kernel=None):
        if in_kernel is False and "escalated" not in marks:
            marks["escalated"] = launch_counts()
        built.append(Backend(p, devices, in_kernel=in_kernel))
        return harness.rebind(built[-1])

    with recorded(supervisor_mod, "supervise") as sups, \
            mock.patch.object(supervisor_mod, "Backend", rebuilt):
        run = counted_run(params, session=Session(tmp / "ckpt_o"), backend=harness)
    history = [{k: v for k, v in r.items() if k != "t"} for r in sups[0].history]
    before = marks.get("escalated")
    if before is None or [r["tier"] for r in history] != ["same", "forced-ppermute"]:
        raise AssertionError(f"(o): the ladder did not escalate: {history}")
    if [b.devices for b in built] != [devices, devices]:
        raise AssertionError(f"(o): the ladder rebuilt on {[b.devices for b in built]}, not on "
                             f"the first attempt's virtual mesh")
    after = {k: run["launches"][k] - before[k] for k in KERNELS}
    info = run["sink"].report["info"]
    policy = info.get("backend.sharded_tier_policy")
    if run["final"] != straight:
        raise AssertionError("(o): the final PGM differs from the single-device run's")
    if not (before["strip_mega"] and not before["strip_frontier"] and after["strip_frontier"]
            and not after["strip_mega"]):
        raise AssertionError(f"(o): K14/K12 launches before {before}, after {after}")
    if info.get("backend.sharded_tier") != "ppermute" or policy != (
            "forced-ppermute (in_kernel=False)"):
        raise AssertionError(f"(o): the escalated tier is {info.get('backend.sharded_tier')} "
                             f"({policy})")
    for k in ("ext", *STRIPS, "strip_mega"):
        launches[k] += run["launches"][k]
    print(f"escalation (o) {BIG}^2 x {O_TURNS} on {MESH_E} of {sorted(set(map(str, devices)))}: "
          f"{run['seconds']:.3f} s, history "
          f"{history}, launches before the escalation "
          f"{ {k: before[k] for k in ('ext', *STRIPS, 'strip_mega')} }, after "
          f"{ {k: after[k] for k in ('ext', *STRIPS, 'strip_mega')} }, tier policy {policy!r}; "
          f"equals the single-device run", flush=True)
    return dict(seconds=run["seconds"], history=history, launches_before=before,
                launches_after=after, sharded_tier_policy=policy, counters=run["counters"],
                stats=dict(run=stats_row("run gens/s", [O_TURNS / run["seconds"]])))


def resilience_paths(tmp: Path, long_pgm: bytes, straight: bytes, launches: dict,
                     device) -> dict:
    """Phase 3's resilience paths (m), (n) and (o)."""
    return {f"timecomp_m_{BIG}x{BIG}x{LONG_TURNS}": timecomp_path(tmp, long_pgm, launches),
            f"supervised_n_{BIG}x{BIG}x2000": supervised_path(tmp, straight, launches),
            f"escalation_o_{BIG}x{BIG}x{O_TURNS}_{MESH_E[0]}x{MESH_E[1]}": escalation_path(
                tmp, launches, device)}


def recorded_run(name: str, params: gol.Params, kernels: tuple, engine: str, launches: dict,
                 devices=None, shadow=None) -> tuple:
    """One viewer run with every launch count set to 0 just before and read
    just after, its frame stream recorded (``Sink(record=True)``); each of
    ``kernels`` must have launched and the run must have taken ``engine``.
    Returns (seconds, final PGM bytes, sink, counts)."""
    sink = Sink(shadow, record=True)
    reset_launches()
    seconds, final = stream_run(params, sink, devices=devices)
    counts = launch_counts()
    got = sink.report["info"]["backend.engine"]
    log(f"{name}: {seconds:.3f} s, {sink.frames} frames ({sink.deltas} deltas), {sink.flips} "
        f"flips, engine {got}, launches {counts}")
    if got != engine:
        raise AssertionError(f"{name}: engine_used {got!r}, not {engine}")
    for k in kernels:
        if counts[k] == 0:
            raise AssertionError(f"{name}: the {k} kernel never launched")
        launches[k] += counts[k]
    if final is None:
        raise AssertionError(f"{name}: no final PGM")
    return seconds, final, sink, counts


def mesh_viewer_paths(tmp: Path, straight: bytes, launches: dict, device) -> dict:
    """Path (p), the viewers on a mesh: the 16384² soup x 2,000 with the
    frames viewer at a frame stride of ``P_STRIDE`` under ``auto``, whose
    pool windows (``P_FRAME_MAX``) cross the shard seams, on one device
    (K2) and on the virtual meshes (2, 2) and (4, 1) (K9 on every shard);
    each mesh's stream must equal the one-device stream frame for frame
    and its final PGM the headless run's.  Then the ``P_VIEWPORT`` rect,
    which crosses a shard seam and the torus seam, x ``P_VIEW_TURNS`` on
    (2, 2) against one device, delta frames included; and the 512²
    per-cell flips x ``P_FLIP_TURNS`` on (4, 1) (``auto`` takes roll for
    per-turn dispatches on a mesh: no kernel), whose XOR-rebuilt board
    must equal the final PGM."""
    e2e = {}
    frames_p = gol.Params(turns=2000, image_width=BIG, image_height=BIG, soup_density=0.3,
                          soup_seed=7, no_vis=False, view_mode="frame", frame_stride=P_STRIDE,
                          frame_max=P_FRAME_MAX, ticker_period=3600, out_dir=tmp / "p_one")
    fy, fx = frames_p.frame_factors()
    if any((BIG // ny) % fy == 0 or (nx > 1 and (BIG // nx) % fx == 0) for ny, nx in P_MESHES):
        raise AssertionError(f"pool windows {fy}x{fx} do not cross the shard seams")
    one_s, one_pgm, one, _ = recorded_run(f"(p) one device {BIG}^2 x 2000 frames", frames_p,
                                          ("tiled",), "pallas-packed", launches)
    if one_pgm != straight:
        raise AssertionError("(p) the one-device frames run's PGM differs from the headless run's")
    rows = {}
    for mesh_shape in P_MESHES:
        ny, nx = mesh_shape
        params = dataclasses.replace(frames_p, mesh_shape=mesh_shape,
                                     out_dir=tmp / f"p_{ny}x{nx}")
        name = f"(p) {BIG}^2 x 2000 frames on {ny}x{nx}"
        seconds, final, sink, counts = recorded_run(name, params, ("ext",), "pallas-packed",
                                                    launches, virtual(mesh_shape, device))
        if sink.stream != one.stream:
            raise AssertionError(f"{name}: the frame stream differs from the one-device run's")
        if final != one_pgm:
            raise AssertionError(f"{name}: the final PGM differs from the one-device run's")
        log(f"{name}: {sink.frames} frames of {fy}x{fx} pool windows equal the one-device "
            f"stream frame for frame, final PGM equal")
        rows[f"{ny}x{nx}"] = dict(seconds=seconds, frames=sink.frames, launches=counts,
                                  stats=dict(frames=stats_row(
                                      "frames/s", [sink.frames / seconds], "frames/s")))
    e2e[f"mesh_frames_p_{BIG}^2x2000"] = dict(
        factors=[fy, fx], stride=P_STRIDE, frames=one.frames, one_device=dict(
            seconds=one_s, stats=dict(frames=stats_row(
                "frames/s", [one.frames / one_s], "frames/s"))), meshes=rows)

    view_p = dataclasses.replace(frames_p, turns=P_VIEW_TURNS, viewport=P_VIEWPORT,
                                 out_dir=tmp / "p_view_one")
    v_s, v_pgm, v_one, _ = recorded_run(f"(p) one device viewport {P_VIEWPORT}", view_p,
                                        ("tiled",), "pallas-packed", launches)
    ny, nx = P_MESHES[0]
    params = dataclasses.replace(view_p, mesh_shape=(ny, nx), out_dir=tmp / "p_view_mesh")
    name = f"(p) viewport {P_VIEWPORT} x {P_VIEW_TURNS} on {ny}x{nx}"
    seconds, final, sink, counts = recorded_run(name, params, ("ext",), "pallas-packed",
                                                launches, virtual((ny, nx), device))
    if sink.stream != v_one.stream or final != v_pgm or not sink.deltas:
        raise AssertionError(f"{name}: the stream or final PGM differs from the one-device run's "
                             f"(or it has no deltas)")
    crop = stencil.viewport(final_board(params, device), *P_VIEWPORT)
    if not np.array_equal(sink.view, stencil.frame_pool(crop, *sink.factors).cpu().numpy()):
        raise AssertionError(f"{name}: the rebuilt view differs from the final board's crop")
    log(f"{name}: {sink.frames} frames ({sink.deltas} deltas) equal the one-device stream and "
        f"rebuild the pooled crop of the final board")
    e2e[f"mesh_viewport_p_{BIG}^2x{P_VIEW_TURNS}_{ny}x{nx}"] = dict(
        seconds=seconds, frames=sink.frames, deltas=sink.deltas, launches=counts,
        one_device_seconds=v_s, stats=dict(frames=stats_row(
            "frames/s", [sink.frames / seconds], "frames/s")))

    ny, nx = P_FLIP_MESH
    flips = gol.Params(turns=P_FLIP_TURNS, images_dir=tmp / "images", no_vis=False,
                       mesh_shape=P_FLIP_MESH, ticker_period=3600, out_dir=tmp / "p_flips")
    if not flips.wants_flips():
        raise AssertionError("a 512^2 viewer run on a mesh is not fed per-cell flips")
    name = f"(p) flips 512^2 x {P_FLIP_TURNS} on {ny}x{nx}"
    seconds, final, sink, counts = recorded_run(name, flips, (), "roll", launches,
                                                virtual(P_FLIP_MESH, device), shadow=(512, 512))
    if any(counts.values()):
        raise AssertionError(f"{name}: a kernel launched on the roll path: {counts}")
    # The stream opens with a CellFlipped for every live cell of the
    # input, so the shadow board starts from nothing.
    want = (pgm.decode_pgm(final) != 0).astype(np.uint8)
    if not np.array_equal(sink.shadow, want):
        raise AssertionError(f"{name}: the XOR-rebuilt board differs from the final PGM")
    log(f"{name}: {sink.flips} CellFlipped events XOR-rebuild the final PGM")
    e2e[f"mesh_flips_p_512^2x{P_FLIP_TURNS}_{ny}x{nx}"] = dict(
        seconds=seconds, flips=sink.flips, launches=counts, stats=dict(flips=stats_row(
            "CellFlipped events/s", [sink.flips / seconds], "events/s")))
    return e2e


def http_json(url: str, method: str = "GET", body=None, timeout: float = 60.0):
    """(status, decoded JSON or text) of one HTTP request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


class Spectator(threading.Thread):
    """A wire spectator, as ``tools/gol_client.py`` speaks it, through the
    port's own ``serve/ws.py`` and ``serve/wire.py``: it subscribes a rect
    of a tenant's FramePlane and folds the keyframes and deltas into a
    buffer until the ``end`` message, noting each frame's publish stamp
    and the time it arrived."""

    def __init__(self, base: str, tenant: str, rect: tuple):
        super().__init__(name=f"spectator-{tenant}", daemon=True)
        split = urlsplit(base)
        self.tenant, self.rect = tenant, tuple(rect)
        self.ws = ws_lib.client_connect(
            split.hostname, split.port,
            f"/v1/sessions/{tenant}/frames?rect={','.join(map(str, rect))}&queue=64",
            timeout=60)
        self.buf, self.turn, self.ended, self.error = None, 0, False, None
        self.arrivals, self.ages = [], []

    def run(self) -> None:
        try:
            self.ws.settimeout(120)
            while not self.ended:
                opcode, payload = self.ws.recv()
                now = time.time()
                if opcode == ws_lib.OP_TEXT:
                    self.ended = json.loads(payload).get("type") == "end"
                    continue
                event = wire.decode_frame_event(payload)
                if isinstance(event, gol.FrameReady):
                    self.buf = np.array(event.frame, dtype=np.uint8, copy=True)
                elif self.buf is not None:
                    frames.apply_bands(self.buf, event.bands)
                else:
                    continue  # an orphan delta before the first keyframe
                self.turn = event.completed_turns
                self.arrivals.append(now)
                if event.ts is not None:
                    self.ages.append(now - event.ts)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            self.error = e
        finally:
            self.ws.close()


def wire_pod_path(tmp: Path, launches: dict, device) -> dict:
    """Path (q), one pod's wire: ``serve --gateway-port 0 --telemetry-port
    0`` (the CLI's ``serve_main``, on a thread of this process so that its
    launches count) with two spectated tenants submitted over HTTP: the
    16384² soup on per-turn frames (K6) and a 512² soup at a frame stride
    of 16 (K1).  Two wire spectators a tenant subscribe rects that wrap the
    torus; each one's rebuilt last frame must be the final turn's and equal
    ``Backend.fetch_viewport`` of the final board, which must equal the
    tenant's solo rerun.  ``/metrics`` and ``/healthz`` are scraped from
    the telemetry server and the OpenMetrics text round-trips; a drain
    over the wire ends the pod."""
    from distributed_gol_torch.__main__ import serve_main

    root = tmp / "wire_pod"
    labels = ("gateway.endpoint", "telemetry.endpoint")
    before = {k: metrics.REGISTRY.snapshot().to_dict()["info"].get(k) for k in labels}
    out, rc = io.StringIO(), []

    def pod():
        with contextlib.redirect_stdout(out):
            rc.append(serve_main(["--gateway-port", "0", "--telemetry-port", "0",
                                  "--checkpoint-root", str(root), "--max-sessions", "2",
                                  "--max-cells", str(BIG * BIG), "--max-total-cells", "0",
                                  "--telemetry-sample-seconds", "0.25"]))

    reset_launches()
    t0 = time.perf_counter()
    thread = threading.Thread(target=pod, name="wire-pod", daemon=True)
    thread.start()
    urls, deadline = {}, time.monotonic() + 120
    while len(urls) < 2 and time.monotonic() < deadline and thread.is_alive():
        info = metrics.REGISTRY.snapshot().to_dict()["info"]
        urls = {k: info[k] for k in labels if info.get(k) and info[k] != before[k]}
        time.sleep(0.05)
    if len(urls) < 2:
        raise AssertionError(f"(q) the pod never published both endpoints: {urls}")
    gw, tel = urls["gateway.endpoint"], urls["telemetry.endpoint"]
    log(f"(q) pod up in {time.perf_counter() - t0:.3f} s: gateway {gw}, telemetry {tel}")
    specs = {}
    for tenant, side, turns, stride, rects in Q_TENANTS:
        spec = {"tenant": tenant, "params": {"width": side, "height": side, "turns": turns},
                "soup": {"density": 0.3, "seed": 7}, "spectate": True,
                "viewport": list(rects[0]), "frame_stride": stride}
        status, doc = http_json(gw + "/v1/sessions", "POST", spec)
        if status != 201:
            raise AssertionError(f"(q) POST /v1/sessions {tenant}: {status} {doc}")
        specs[tenant] = (side, turns, stride, [Spectator(gw, tenant, r) for r in rects])
        for sp in specs[tenant][3]:
            sp.start()
    for tenant, (_, _, _, spectators) in specs.items():
        for sp in spectators:
            sp.join(timeout=600)
            if sp.is_alive() or sp.error is not None or not sp.ended:
                raise AssertionError(f"(q) spectator {sp.rect} of {tenant}: {sp.error!r}")
    states = {t: http_json(f"{gw}/v1/sessions/{t}/state")[1] for t in specs}
    if any(st["status"] != "completed" for st in states.values()):
        raise AssertionError(f"(q) tenants did not complete: {states}")
    status, text = http_json(tel + "/metrics")
    parsed = openmetrics.parse(text) if status == 200 else None
    problems = ["/metrics answered " + str(status)] if parsed is None else (
        metrics.check_metrics_snapshot(parsed) + openmetrics.check_roundtrip(parsed))
    hz_status, health = http_json(tel + "/healthz")
    if problems or hz_status != 200 or not health.get("ready"):
        raise AssertionError(f"(q) telemetry: {problems[:5]}, /healthz {hz_status}")
    status, receipt = http_json(gw + "/v1/drain", "POST")
    thread.join(timeout=120)
    seconds = time.perf_counter() - t0
    if thread.is_alive() or rc != [0]:
        raise AssertionError(f"(q) the pod did not exit 0 after the drain: {rc}")
    counts = launch_counts()
    for k in Q_KERNELS:
        if counts[k] == 0:
            raise AssertionError(f"(q) the {k} kernel never launched")
        launches[k] += counts[k]
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    if last["gateway"]["endpoint"] != gw:
        raise AssertionError(f"(q) the receipt names {last['gateway']}, not {gw}")
    rows = {}
    for tenant, (side, turns, stride, spectators) in specs.items():
        p = gol.Params(turns=turns, image_width=side, image_height=side, soup_density=0.3,
                       soup_seed=7, ticker_period=3600, out_dir=tmp / "q_rerun" / tenant)
        got = (root / tenant / f"{p.final_output_name}.pgm").read_bytes()
        if got != solo_rerun(p, p.out_dir):
            raise AssertionError(f"(q) tenant {tenant}'s final PGM differs from its solo rerun")
        fetch = Backend(p)
        final = fetch.put(pgm.decode_pgm(got))
        for sp in spectators:
            if sp.turn != turns or not np.array_equal(sp.buf, fetch.fetch_viewport(final, sp.rect)):
                raise AssertionError(f"(q) {tenant} spectator {sp.rect}: the last frame (turn "
                                     f"{sp.turn}) differs from fetch_viewport of the final board")
        fps = [(len(sp.arrivals) - 1) / (sp.arrivals[-1] - sp.arrivals[0]) for sp in spectators]
        ages = [a for sp in spectators for a in sp.ages]
        rows[tenant] = dict(
            side=side, turns=turns, stride=stride,
            frames=[len(sp.arrivals) for sp in spectators], rects=[sp.rect for sp in spectators],
            stats=dict(frames=stats_row("frames/s a spectator", fps, "frames/s"),
                       age={k: v for k, v in stats_row("publish to receipt", ages, "s").items()
                            if k != "rates"}))
        log(f"(q) {tenant} {side}^2 x {turns}: spectators {rows[tenant]['frames']} frames, "
            f"{rows[tenant]['stats']['frames']['median']:.1f} frames/s each, publish to receipt "
            f"median {rows[tenant]['stats']['age']['median'] * 1e3:.3f} ms; last frames equal "
            f"fetch_viewport of the final board")
    print(f"wire pod (q): {seconds:.3f} s, launches {counts}, /metrics round-trips "
          f"({len(parsed['counters'])} counters), drain receipt {sorted(receipt['sessions'])}",
          flush=True)
    return {"wire_pod_q": dict(seconds=seconds, launches=counts, tenants=rows,
                               metrics_counters=len(parsed["counters"]),
                               healthz_ready=health["ready"])}


def wait_until(what: str, fn, timeout: float = 120.0, interval: float = 0.05):
    """``fn()``'s first truthy answer, polled until ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def start_pod_a(root: Path, device) -> tuple:
    """Pod A of path (r): ``python3 -m distributed_gol_torch serve`` in a
    child process on the script's device (``--device cuda``: with no GPU
    it exits, it never runs on the CPU).  Returns (process, gateway URL,
    the thread that reads its stderr) once its banner names the gateway."""
    repo = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "distributed_gol_torch", "serve", "--device", device.type,
           "--gateway-port", "0", "--telemetry-port", "0", "--checkpoint-root", str(root),
           "--max-sessions", "4", "--max-cells", str(BIG * BIG),
           "--max-total-cells", str(R_TOTAL_A), "--telemetry-sample-seconds", "0.25"]
    proc = subprocess.Popen(cmd, cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines: list = []
    pump = threading.Thread(target=lambda: lines.extend(proc.stderr), name="pod-a-stderr",
                            daemon=True)
    pump.start()

    def banner():
        if proc.poll() is not None:
            raise AssertionError(f"(r) pod A exited {proc.returncode}: {''.join(lines)[-2000:]}")
        return next((ln.split("gateway: ", 1)[1].split("/v1/sessions", 1)[0]
                     for ln in list(lines) if ln.startswith("gateway: ")), None)

    try:
        url = wait_until("pod A's gateway banner", banner)
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        pump.join(timeout=30)
        raise
    return proc, url, pump


def federation_path(tmp: Path, launches: dict, device, card: str) -> dict:
    """Path (r), a federation on the one card: pods A (a child process)
    and B (``serve_main`` on a thread here, so its launches count) on one
    checkpoint root, behind the port's ``Broker`` with its collector.
    Alice (the 16384² soup x 2,000, headless, a checkpoint every 400
    turns) is placed on A by headroom and runs K2 there; ``PodChaos``
    SIGKILLs A once she passes turn 600, and the broker condemns A and
    readopts her on B from her newest checkpoint, where K2 runs her to the
    end.  Carol (512² x 8,000, frames at a stride of 16) runs K1 on B,
    watched by one spectator on B and two behind a relay chain (R1 through
    a ``ChaosProxy`` that drops its first connection, R2 on R1).  Both
    final PGMs must equal their solo reruns, every spectator's last frame
    ``fetch_viewport`` of carol's final board, ``broker.failovers`` rise by
    exactly 1, and the collector's ``/fleet/metrics`` must round-trip, its
    ``/fleet/flight`` show A condemned before alice's failover, and its
    ``/fleet/traces/<id>`` join the broker's and pod B's spans of that
    failover on one id."""
    from distributed_gol_torch.__main__ import serve_main

    root = tmp / "federation"
    a_side, a_turns, a_ckpt, a_step = R_ALICE
    c_side, c_turns, c_stride, rect = R_CAROL
    before = metrics.REGISTRY.snapshot().to_dict()
    failovers0 = before["counters"].get("broker.failovers", 0)
    t0 = time.perf_counter()
    proc, a_url, a_pump = start_pod_a(root, device)
    out, rc, stack = io.StringIO(), [], []

    def pod_b():
        with contextlib.redirect_stdout(out):
            rc.append(serve_main([
                "--device", device.type, "--gateway-port", "0", "--telemetry-port", "0",
                "--checkpoint-root", str(root), "--max-sessions", "4",
                "--max-cells", str(BIG * BIG), "--max-total-cells", str(R_TOTAL_B),
                "--telemetry-sample-seconds", "0.25"]))

    reset_launches()
    b_thread = threading.Thread(target=pod_b, name="pod-b", daemon=True)
    try:
        b_thread.start()
        # B shares this process's registry with the broker and every
        # earlier path: its endpoint is the gateway label that changed.
        b_url = wait_until("pod B's gateway", lambda: (
            (u := metrics.REGISTRY.snapshot().to_dict()["info"].get("gateway.endpoint"))
            and u != before["info"].get("gateway.endpoint") and u))
        broker = Broker([a_url, b_url], BrokerConfig(
            probe_interval_seconds=0.1, probe_miss_threshold=2, checkpoint_root=str(root),
            collector=True, collector_interval_seconds=0.25))
        stack.append(broker)
        wait_until("both pods probed ready", lambda: all(
            p["ready"] and p["status"] == "ready" for p in broker.pod_states()))
        log(f"(r) pods up in {time.perf_counter() - t0:.3f} s: A {a_url} (pid {proc.pid}), "
            f"B {b_url}, broker {broker.url}")

        def submit(spec):
            status, doc = http_json(broker.url + "/v1/sessions", "POST", spec)
            if status != 201:
                raise AssertionError(f"(r) POST /v1/sessions {spec['tenant']}: {status} {doc}")
            return doc

        def state(tenant):
            try:
                status, doc = http_json(f"{broker.url}/v1/sessions/{tenant}/state", timeout=10)
            except OSError:
                return {}
            return doc if status == 200 and isinstance(doc, dict) else {}

        t_alice = time.perf_counter()
        alice = submit({"tenant": "alice", "params": {
            "width": a_side, "height": a_side, "turns": a_turns, "engine": "auto",
            "superstep": a_step, "checkpoint_every_turns": a_ckpt, "ticker_period": 3600},
            "soup": {"density": 0.3, "seed": 7}})
        if alice["pod"] != a_url:
            raise AssertionError(f"(r) headroom placed alice on {alice['pod']}, not A")
        kill: dict = {}

        def alice_turn():
            turn = state("alice").get("turn")
            if turn is not None and turn >= R_KILL_TURN and "t" not in kill:
                # A's own dispatches and checkpoint times, read off its
                # /metrics just before the kill.
                kill["a_metrics"] = openmetrics.parse(http_json(a_url + "/metrics")[1])
                kill["t"] = time.time()
            return turn

        chaos = PodChaos([proc], FaultPlan([Fault(R_KILL_TURN, "pod_down", device=0)]),
                         turn_fn=alice_turn)
        watcher = chaos.watch(interval=0.05)
        try:
            wait_until("the probe to see alice on A", lambda: any(
                p["endpoint"] == a_url and (p["resident_cells"] > 0 or p["condemned"])
                for p in broker.pod_states()))
            carol = submit({"tenant": "carol", "params": {
                "width": c_side, "height": c_side, "turns": c_turns, "ticker_period": 3600},
                "soup": {"density": 0.3, "seed": 7}, "spectate": True,
                "viewport": list(rect), "frame_stride": c_stride})
            if carol["pod"] != b_url:
                raise AssertionError(f"(r) carol was placed on {carol['pod']}, not B")
            # Paused at once, so that the relay chain and the spectators
            # are in place before her frames flow.
            status, doc = http_json(f"{broker.url}/v1/sessions/carol/pause", "POST")
            if status != 200:
                raise AssertionError(f"(r) pausing carol: {status} {doc}")
            wait_until("carol paused", lambda: state("carol").get("paused"))
            proxy = ChaosProxy(b_url, WirePlan([WireFault(0, "disconnect",
                                                          after_bytes=R_DISCONNECT_BYTES)]),
                               hang_seconds=1.0)
            stack.append(proxy)
            leg = f"/v1/sessions/carol/frames?rect={','.join(map(str, rect))}&queue=1024"
            relay_kw = dict(cache_deltas=1024, queue_depth=1024, backoff_initial=0.05,
                            backoff_max=0.2)
            r1 = RelayServer(proxy.url + leg, **relay_kw)
            stack.append(r1)
            wait_until("R1 resubscribed past the dropped connection", lambda: (
                proxy.connections >= 2 and proxy.fired and r1.health()["connected"]))
            r2 = RelayServer(r1.url + "/v1/frames?queue=1024", **relay_kw)
            stack.append(r2)
            wait_until("R2 subscribed to R1", lambda: r2.health()["connected"])
            spectators = {"direct": [Spectator(b_url, "carol", rect)],
                          "depth_2": [Spectator(r2.url, "carol", rect) for _ in range(2)]}
            for sp in (sp for group in spectators.values() for sp in group):
                sp.start()
            http_json(f"{broker.url}/v1/sessions/carol/resume", "POST")
            wait_until("A's SIGKILL", lambda: chaos.done, timeout=300)
            ends = {t: wait_until(f"{t} ended", lambda t=t: (
                (st := state(t)).get("status") in ("completed", "failed") and st), timeout=600)
                for t in ("alice", "carol")}
            alice_s = time.perf_counter() - t_alice
        finally:
            chaos.stop()
            watcher.join(timeout=30)
        counts = launch_counts()
        for t, st in ends.items():
            if st["status"] != "completed" or st["pod"] != b_url:
                raise AssertionError(f"(r) {t} ended {st['status']} on {st.get('pod')}")
        for group in spectators.values():
            for sp in group:
                sp.join(timeout=300)
                if sp.is_alive() or sp.error is not None or not sp.ended:
                    raise AssertionError(f"(r) a carol spectator: {sp.error!r}")
        proc.wait(timeout=60)
        (fault, fired_turn), = chaos.fired
        records = broker.flight.records()
        condemned = next(r for r in records if r["kind"] == "pod_condemned")
        failover = next(r for r in records if r["kind"] == "failover")
        if (condemned["pod"] != a_url or "alice" not in condemned["stranded"]
                or failover["tenant"] != "alice" or failover["from_pod"] != a_url
                or failover["to_pod"] != b_url):
            raise AssertionError(f"(r) flight: {condemned}, {failover}")
        ckpt_turn = failover["checkpoint_turn"]
        if ckpt_turn < a_ckpt or ckpt_turn % a_ckpt or ckpt_turn > fired_turn:
            raise AssertionError(f"(r) alice was readopted at turn {ckpt_turn}, fired at "
                                 f"{fired_turn}: not a checkpoint turn of hers")
        failovers = metrics.REGISTRY.snapshot().to_dict()["counters"].get("broker.failovers", 0)
        if failovers != failovers0 + 1:
            raise AssertionError(f"(r) broker.failovers rose by {failovers - failovers0}")
        for k in R_KERNELS:
            if counts[k] == 0:
                raise AssertionError(f"(r) the {k} kernel never launched on B")
            launches[k] += counts[k]

        # The collector, in the broker: the merged page, the merged
        # postmortem and the stitched failover trace.
        status, text = http_json(broker.url + "/fleet/metrics")
        parsed = openmetrics.parse(text) if status == 200 else None
        problems = ["/fleet/metrics answered " + str(status)] if parsed is None else (
            openmetrics.check_roundtrip(parsed))
        if problems:
            raise AssertionError(f"(r) /fleet/metrics: {problems[:5]}")
        status, merged = http_json(broker.url + "/fleet/flight")
        kinds = [(r["kind"], r.get("pod") or r.get("tenant")) for r in merged["records"]
                 if r["node"] == "broker"]
        if not kinds.index(("pod_condemned", a_url)) < kinds.index(("failover", "alice")):
            raise AssertionError(f"(r) /fleet/flight does not read condemn, then failover: {kinds}")
        status, stitched = http_json(f"{broker.url}/fleet/traces/{failover['trace_id']}")
        names = {sp["name"] for sp in stitched.get("spans", ())} if status == 200 else set()
        if (status != 200 or not {"broker", node_name(b_url)} <= set(stitched["nodes"])
                or not {"gol.broker.place", "gol.admission"} <= names):
            raise AssertionError(f"(r) /fleet/traces/{failover['trace_id']}: {status}, "
                                 f"nodes {stitched.get('nodes')}, spans {sorted(names)}")
        r2_hist = r2.registry.snapshot().to_dict()["histograms"].get(
            "relay.frame_staleness_seconds", {})
        if not r2_hist.get("count"):
            raise AssertionError("(r) R2 observed no frame staleness")
        http_json(b_url + "/v1/drain", "POST")
        b_thread.join(timeout=120)
        seconds = time.perf_counter() - t0
        if b_thread.is_alive() or rc != [0]:
            raise AssertionError(f"(r) pod B did not exit 0 after the drain: {rc}")
    finally:
        while stack:
            stack.pop().close()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        a_pump.join(timeout=60)

    # The answers: both tenants' PGMs against their solo reruns, every
    # spectator's last frame against fetch_viewport of carol's final board.
    finals = {}
    for t, side, turns in (("alice", a_side, a_turns), ("carol", c_side, c_turns)):
        p = gol.Params(turns=turns, image_width=side, image_height=side, soup_density=0.3,
                       soup_seed=7, ticker_period=3600, device=device.type,
                       out_dir=tmp / "r_rerun" / t)
        finals[t] = (p, (root / t / f"{p.final_output_name}.pgm").read_bytes())
        if finals[t][1] != solo_rerun(p, p.out_dir):
            raise AssertionError(f"(r) {t}'s final PGM differs from its solo rerun")
    p, got = finals["carol"]
    fetch = Backend(p)
    want = fetch.fetch_viewport(fetch.put(pgm.decode_pgm(got)), rect)
    for where, group in spectators.items():
        for sp in group:
            if sp.turn != c_turns or not np.array_equal(sp.buf, want):
                raise AssertionError(f"(r) a {where} spectator's last frame (turn {sp.turn}) "
                                     f"differs from fetch_viewport of carol's final board")
    fps = {where: [(len(sp.arrivals) - 1) / (sp.arrivals[-1] - sp.arrivals[0]) for sp in group]
           for where, group in spectators.items()}
    a_metrics = kill["a_metrics"]
    a_dispatches = {k: v for k, v in a_metrics["counters"].items()
                    if k.startswith("gol_backend_dispatches")}
    if not any(v > 0 for v in a_dispatches.values()):
        raise AssertionError(f"(r) pod A's /metrics shows no dispatch before the kill")
    # Checkpoint writes, apart from the run: A's whole process (alice's
    # alone), and B's during this path (alice's alone: carol takes none).
    b_hist = {k: (v, before["histograms"].get(k, {})) for k, v in
              metrics.REGISTRY.snapshot().to_dict()["histograms"].items()
              if "checkpoint_save_seconds" in k}
    ckpt_seconds = {
        "pod_a": {k: {"count": v["count"], "sum": v["sum"]}
                  for k, v in a_metrics["histograms"].items() if "checkpoint_save_seconds" in k},
        "pod_b": {k: {"count": v["count"] - b.get("count", 0), "sum": v["sum"] - b.get("sum", 0.0)}
                  for k, (v, b) in b_hist.items()}}
    condemn_s, failover_s = condemned["t"] - kill["t"], failover["t"] - kill["t"]
    rollback = fired_turn - ckpt_turn
    staleness = {k: r2_hist.get(k) for k in ("count", "sum", "buckets", "counts")}
    row = dict(
        seconds=seconds, card=card, launches=counts, kill_turn=fired_turn,
        checkpoint_turn=ckpt_turn, proxy_fired=[(f.at, f.kind) for f in proxy.fired],
        relay_resubscribes=r1.health()["resubscribes"], pod_a_dispatches=a_dispatches,
        checkpoint_save_seconds=ckpt_seconds, r2_frame_staleness_seconds=staleness,
        frames={w: [len(sp.arrivals) for sp in g] for w, g in spectators.items()},
        fleet_counters=len(parsed["counters"]), stitched_nodes=sorted(stitched["nodes"]),
        stats=dict(
            kill_to_condemned=stats_row("kill to condemnation", [condemn_s], "s"),
            kill_to_failover=stats_row("kill to failover placement", [failover_s], "s"),
            rollback_turns=dict(reps=1, median=rollback, spread=0.0),
            alice=stats_row("alice run gens/s across the failover", [a_turns / alice_s]),
            direct=stats_row("frames/s, direct spectator", fps["direct"], "frames/s"),
            depth_2=stats_row("frames/s, depth-2 spectators", fps["depth_2"], "frames/s")))
    mean_stale = staleness["sum"] / staleness["count"]
    print(f"federation (r) on {card}: {seconds:.3f} s; A SIGKILLed at alice's turn "
          f"{fired_turn}, condemned {condemn_s:.3f} s and alice placed on B {failover_s:.3f} s "
          f"after the kill, from her checkpoint at turn {ckpt_turn} (rollback {rollback} "
          f"turns); alice {a_turns / alice_s:.1f} gens/s across the failover; carol frames/s "
          f"direct {fps['direct'][0]:.1f}, depth 2 {[round(f, 1) for f in fps['depth_2']]}; "
          f"R2 frame staleness mean {mean_stale * 1e3:.3f} ms over {staleness['count']} "
          f"frames; "
          f"launches on B {counts}", flush=True)
    return {"federation_r": row}


# -- path (s): multi-host on the one card --------------------------------------


def rank_main(argv: list) -> int:
    """One rank of path (s), in its own process: the CLI's ``main(argv)``
    (``python3 -m distributed_gol_torch ... --coordinator``), its kernels'
    launches counted, its exchanges timed and its adaptive dispatches
    recorded, all written as JSON to the file ``CHIP_SMOKE_RANK_REPORT``
    names when it ends.  An exchange (``RankSpan.exchange``: device to
    host, gloo, host to device) is timed by CUDA events around it, host
    staging included; the spawn time comes from ``CHIP_SMOKE_SPAWNED``.
    Exits with the CLI's code, without the interpreter's teardown."""
    import traceback

    from distributed_gol_torch.__main__ import main as cli_main
    from distributed_gol_torch.parallel import multihost

    report = dict(spawned=float(os.environ["CHIP_SMOKE_SPAWNED"]), imported=time.time(),
                  first_exchange=None, exchange_ms=[], max_issue_s=0.0, run_start=None,
                  run_end=None, error=None)
    skips = []
    exchange, issue = mesh_lib.RankSpan.exchange, Backend.run_turns_async
    skip_superstep, run = Backend._skip_superstep, multihost.run_distributed

    def timed_exchange(self, southward, northward):
        if report["first_exchange"] is None:
            report["first_exchange"] = time.time()
        if not southward.is_cuda:  # a rehearsal on the CPU
            t0 = time.perf_counter()
            out = exchange(self, southward, northward)
            report["exchange_ms"].append((time.perf_counter() - t0) * 1e3)
        else:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = exchange(self, southward, northward)
            end.record()
            end.synchronize()
            report["exchange_ms"].append(start.elapsed_time(end))
        return out

    def timed_issue(self, board, turns):
        t0 = time.perf_counter()
        out = issue(self, board, turns)
        report["max_issue_s"] = max(report["max_issue_s"], time.perf_counter() - t0)
        return out

    def recorded_skip(self, board, turns):
        before = self._skip_stats[-1] if self._skip_stats else None
        out = skip_superstep(self, board, turns)
        last = self._skip_stats[-1] if self._skip_stats else None
        skips.append((turns, None if last is before else last[0]))
        return out

    def timed_run(*args, **kwargs):
        report["run_start"] = time.time()
        try:
            return run(*args, **kwargs)
        except BaseException as e:
            report["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            report["run_end"] = time.time()

    code = 1
    try:
        with mock.patch.object(mesh_lib.RankSpan, "exchange", timed_exchange), \
                mock.patch.object(Backend, "run_turns_async", timed_issue), \
                mock.patch.object(Backend, "_skip_superstep", recorded_skip), \
                mock.patch.object(multihost, "run_distributed", timed_run):
            code = cli_main(argv)
        report["launches"] = launch_counts()
        report["skips"] = [(k, None if s is None else int(s)) for k, s in skips]
        Path(os.environ["CHIP_SMOKE_RANK_REPORT"]).write_text(json.dumps(report))
    except BaseException:  # noqa: BLE001 — printed; the exit code says it
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as s:
        s.settimeout(5.0)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(leg: Path, args: list, device) -> list:
    """Start the ``S_RANKS`` ranks of one leg of path (s), each
    ``rank_main`` in a child process with ``args`` and the rendezvous, its
    output in ``leg/rank<i>.log``, its report in ``leg/rank<i>.json``, its
    files in ``leg/out<i>``."""
    repo = Path(__file__).resolve().parent
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for i in range(S_RANKS):
        env = dict(os.environ, PYTHONPATH=str(repo), CHIP_SMOKE_SPAWNED=repr(time.time()),
                   CHIP_SMOKE_RANK_REPORT=str(leg / f"rank{i}.json"))
        cmd = [sys.executable, "-c",
               "import sys, chip_smoke; sys.exit(chip_smoke.rank_main(sys.argv[1:]))",
               *map(str, args), "--device", device.type, "--out-dir", str(leg / f"out{i}"),
               "--coordinator", coordinator, "--num-processes", str(S_RANKS),
               "--process-id", str(i)]
        with open(leg / f"rank{i}.log", "w") as out:
            procs.append(subprocess.Popen(cmd, cwd=repo, env=env, stdin=subprocess.DEVNULL,
                                          stdout=out, stderr=subprocess.STDOUT))
    return procs


def wait_ranks(name: str, procs: list, leg: Path, codes: list) -> list:
    """Wait for one leg's ranks (at most ``S_LEG_SECONDS``, then every one
    is killed), check their exit codes against ``codes`` and return their
    reports (None for a rank that wrote none: a killed one)."""
    deadline = time.monotonic() + S_LEG_SECONDS
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"({name}) the ranks ran past {S_LEG_SECONDS} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    got = [p.returncode for p in procs]
    if got != codes:
        tails = "\n".join(f"rank {i}: {(leg / f'rank{i}.log').read_text()[-2500:]}"
                          for i in range(len(procs)))
        raise AssertionError(f"({name}) rank exit codes {got}, want {codes}:\n{tails}")
    return [json.loads(f.read_text()) if (f := leg / f"rank{i}.json").is_file() else None
            for i in range(len(procs))]


def require_launches(name: str, rank: int, launched: dict, kernels: tuple) -> None:
    """Fail unless a rank launched each of ``kernels``, and if it launched
    K14 or K15 (a mesh that spans processes takes the ppermute tier)."""
    for k in kernels:
        if not launched.get(k):
            raise AssertionError(f"({name}) rank {rank} never launched {k}: {launched}")
    if launched.get("strip_mega") or launched.get("tile_mega"):
        raise AssertionError(f"({name}) rank {rank} launched an in-kernel tier: {launched}")


def rank_numbers(name: str, turns: int, seconds: float, reports: list, kernels: tuple,
                 card: str) -> dict:
    """One leg's numbers: its wall-clock, each rank's start-up (spawn to
    ``run_distributed``), launches and exchange ms (the median exchange,
    and the exchanges' sum over the row kernels' launches, which counts
    the waits for the other rank), and process 0's run gens/s; fails
    unless every rank launched each of ``kernels``
    (``require_launches``)."""
    ranks = []
    for i, r in enumerate(reports):
        launched = {k: v for k, v in r["launches"].items() if v}
        require_launches(name, i, launched, kernels)
        row_launches = sum(r["launches"][k] for k in STRIPS + ("ext",))
        ms = r["exchange_ms"]
        ranks.append(dict(
            rank=i, start_up_s=r["run_start"] - r["spawned"],
            first_exchange_s=(r["first_exchange"] or r["spawned"]) - r["spawned"],
            launches=launched, exchanges=len(ms),
            exchange_ms_median=statistics.median(ms) if ms else None,
            exchange_ms_per_launch=sum(ms) / row_launches if row_launches else None,
            run_s=r["run_end"] - r["run_start"], max_issue_s=r["max_issue_s"]))
    lead = ranks[0]
    row = dict(seconds=seconds, card=card, ranks=ranks,
               stats=dict(run=stats_row("run gens/s (process 0)", [turns / lead["run_s"]])))
    for r in ranks:
        print(f"multi-host ({name}) on {card}: rank {r['rank']} up {r['start_up_s']:.2f} s, "
              f"first exchange {r['first_exchange_s']:.2f} s, run {r['run_s']:.3f} s, "
              f"launches {r['launches']}, {r['exchanges']} exchanges of median "
              f"{r['exchange_ms_median'] or 0:.4f} ms, their sum "
              f"{r['exchange_ms_per_launch'] or 0:.4f} ms a launch", flush=True)
    print(f"multi-host ({name}) on {card}: {seconds:.2f} s wall-clock, process 0 "
          f"{turns / lead['run_s']:.1f} gens/s run {row['stats']['run']}", flush=True)
    return row


def replay_dispatches(recorded: list, device) -> tuple:
    """Path (s2)'s dispatches, of the sizes process 0 recorded, on one
    process: the soup on a virtual (S_RANKS, 1) mesh of ``device`` on the
    ppermute tier (K12, the same strips and launches as the ranks').
    Returns (the final board, each dispatch's skip count or None)."""
    params = gol.Params(turns=S2_TURNS, image_width=BIG, image_height=BIG, skip_stable=True,
                        engine="pallas-packed", mesh_shape=(S_RANKS, 1), device=device.type)
    backend = Backend(params, virtual((S_RANKS, 1), device), in_kernel=False)
    if backend.sharded_tier != "ppermute":
        raise AssertionError(f"(s2) replay on the {backend.sharded_tier} tier")
    board = backend.put(random_soup(BIG, BIG, 0.3, 7))
    skips = []
    for k, _ in recorded:
        before = backend._skip_stats[-1] if backend._skip_stats else None
        board = backend.run_turns(board, k)[0]
        last = backend._skip_stats[-1] if backend._skip_stats else None
        skips.append(None if last is before else int(last[0]))
    return backend.fetch(board), skips


def follower_wrote_nothing(name: str, leg: Path) -> None:
    for i in range(1, S_RANKS):
        out = leg / f"out{i}"
        if out.exists() and any(out.iterdir()):
            raise AssertionError(f"({name}) rank {i} wrote files: {sorted(out.iterdir())}")


def multihost_path(tmp: Path, straight: bytes, launches: dict, device, card: str) -> dict:
    """Path (s), multi-host on the one card: ``S_RANKS`` ranks of the CLI
    (``rank_main``), each in its own process with the card as its one
    device, on the (S_RANKS, 1) mesh that spans them (gloo, edges staged
    through host memory).  (s1) the 16384² soup x ``S1_TURNS`` at
    superstep ``S1_STEP``: every rank launches K9, process 0's PGM equals
    path (a)'s one-device PGM.  (s2) the soup x ``S2_TURNS`` with
    skip_stable at superstep 0 (process 0 sizes the dispatches and
    broadcasts them): every rank launches K12 on its 8192-row strip and
    the K10 and K9 remainders, the PGM equals a one-device skip_stable
    run's, and process 0's skip count, dispatch by dispatch, equals the
    same dispatches' on one process (``replay_dispatches``).  (s3) a
    ``S3_SIDE``² soup with a peer heartbeat of ``S3_HEARTBEAT`` s and a
    checkpoint every ``S3_CKPT`` turns: rank 1 is SIGKILLed once the first
    checkpoint lands, rank 0 must exit with PeerLost within three
    heartbeat intervals, its longest dispatch and the watchdog's poll, and
    the newest checkpoint, resumed on one device, must end on the
    never-killed run's PGM.  No rank launches K14 or K15 (a mesh that
    spans processes takes the ppermute tier).  The ranks' launches join
    ``launches``."""
    from distributed_gol_torch.engine.controller import _Watchdog
    from distributed_gol_torch.parallel.multihost import HEARTBEAT_MISS_FACTOR

    root = tmp / "multihost"
    soup = ["--soup", "0.3", "--soup-seed", "7", "-noVis", "--turn-events", "batch"]
    rows = {}

    def leg(name: str, args: list, codes: list, during=None):
        where = root / name
        where.mkdir(parents=True)
        t0 = time.perf_counter()
        procs = spawn_ranks(where, args, device)
        try:
            extra = during(procs, where) if during else None
            reports = wait_ranks(name, procs, where, codes)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
        seconds = time.perf_counter() - t0
        for r in reports:
            if r is not None:
                for k, v in r["launches"].items():
                    launches[k] += v
        follower_wrote_nothing(name, where)
        return where, reports, seconds, extra

    where, reports, seconds, _ = leg("s1", ["-w", BIG, "-h", BIG, "-turns", S1_TURNS,
                                            "--superstep", S1_STEP, *soup], [0] * S_RANKS)
    if (where / "out0" / f"{BIG}x{BIG}x{S1_TURNS}.pgm").read_bytes() != straight:
        raise AssertionError("(s1) process 0's PGM differs from path (a)'s one-device PGM")
    rows["s1"] = rank_numbers("s1", S1_TURNS, seconds, reports, ("ext",), card)

    where, reports, seconds, _ = leg("s2", ["-w", BIG, "-h", BIG, "-turns", S2_TURNS,
                                            "--superstep", 0, "--skip-stable",
                                            "--engine", "pallas-packed", *soup],
                                     [0] * S_RANKS)
    got = (where / "out0" / f"{BIG}x{BIG}x{S2_TURNS}.pgm").read_bytes()
    one = gol.Params(turns=S2_TURNS, image_width=BIG, image_height=BIG, soup_density=0.3,
                     soup_seed=7, skip_stable=True, turn_events="batch", ticker_period=3600,
                     device=device.type, out_dir=where / "one")
    one_s, one_pgm = stream_run(one, Sink())
    if got != one_pgm:
        raise AssertionError("(s2) process 0's PGM differs from the one-device skip_stable run's")
    recorded = reports[0]["skips"]
    t0 = time.perf_counter()
    board, skips = replay_dispatches(recorded, device)
    replay_s = time.perf_counter() - t0
    if not np.array_equal(board, pgm.decode_pgm(got)):
        raise AssertionError("(s2) the one-process replay's board differs from process 0's PGM")
    if [s for _, s in recorded] != skips:
        raise AssertionError(f"(s2) process 0's skip counts {recorded} differ from the "
                             f"one-process replay's {skips}")
    rows["s2"] = rank_numbers("s2", S2_TURNS, seconds, reports, S_KERNELS, card)
    total = sum(s for s in skips if s)
    rows["s2"].update(dispatches=[k for k, _ in recorded], skipped=total, one_device_s=one_s,
                      replay_s=replay_s)
    print(f"multi-host (s2) on {card}: {len(recorded)} dispatches {[k for k, _ in recorded]}, "
          f"process 0's skip count {total} equals the one-process replay's "
          f"({replay_s:.2f} s); one-device skip_stable run {one_s:.2f} s", flush=True)

    def kill_after_checkpoint(procs, where):
        ckpt = where / "ckpt"

        def landed():
            for i, p in enumerate(procs):
                if p.poll() is not None:
                    raise AssertionError(f"(s3) rank {i} exited {p.returncode} before the kill")
            return any(ckpt.glob("checkpoint-*.json"))

        wait_until("(s3)'s first checkpoint", landed, timeout=S_LEG_SECONDS)
        procs[1].kill()
        return time.time()

    s3_args = ["-w", S3_SIDE, "-h", S3_SIDE, "-turns", S3_TURNS, "--superstep", S3_STEP,
               "--peer-heartbeat", S3_HEARTBEAT, "--checkpoint-every-turns", S3_CKPT, *soup]
    where, reports, seconds, killed = leg(
        "s3", [*s3_args, "--checkpoint-dir", root / "s3" / "ckpt"], [1, -9],
        kill_after_checkpoint)
    lead = reports[0]
    if not (lead["error"] or "").startswith("PeerLost"):
        raise AssertionError(f"(s3) rank 0 ended with {lead['error']!r}, not PeerLost")
    abort_s = lead["run_end"] - killed
    bound = (HEARTBEAT_MISS_FACTOR * S3_HEARTBEAT + lead["max_issue_s"]
             + _Watchdog.INTERRUPT_POLL_SECONDS)
    if abort_s > bound:
        raise AssertionError(f"(s3) rank 0 aborted {abort_s:.3f} s after the kill, past its "
                             f"bound {bound:.3f} s")
    params = gol.Params(turns=S3_TURNS, image_width=S3_SIDE, image_height=S3_SIDE,
                        soup_density=0.3, soup_seed=7, superstep=S3_STEP, turn_events="batch",
                        ticker_period=3600, device=device.type)
    resumed = Sink()
    _, resumed_pgm = stream_run(dataclasses.replace(params, out_dir=where / "resumed"), resumed,
                                session=Session(where / "ckpt"))
    _, straight3 = stream_run(dataclasses.replace(params, out_dir=where / "straight"), Sink())
    if resumed_pgm != straight3:
        raise AssertionError("(s3) the resumed run's PGM differs from the never-killed run's")
    launched = {k: v for k, v in lead["launches"].items() if v}
    require_launches("s3", 0, launched, ("ext",))
    rows["s3"] = dict(seconds=seconds, card=card, kill_to_abort_s=abort_s, bound_s=bound,
                      start_up_s=lead["run_start"] - lead["spawned"], launches=launched,
                      error=lead["error"], stats=dict(
                          kill_to_abort=stats_row("(s3) kill to PeerLost", [abort_s], "s")))
    print(f"multi-host (s3) on {card}: rank 1 SIGKILLed after the first checkpoint, rank 0 "
          f"exited with {lead['error'][:60]!r} {abort_s:.3f} s after the kill (bound "
          f"{bound:.3f} s: {HEARTBEAT_MISS_FACTOR} x {S3_HEARTBEAT} s, its longest dispatch "
          f"{lead['max_issue_s']:.3f} s, the watchdog's poll); the one-device resume equals "
          f"the never-killed run's PGM; {seconds:.2f} s", flush=True)
    return {f"multihost_{k}": v for k, v in rows.items()}


def pgm_raster(path: Path, h: int, w: int, mapped: bool = True) -> np.ndarray:
    """The (h, w) cells of a P5 PGM the port wrote, after its header and
    size are checked: mapped from the file, or (``mapped=False``) read
    into a writable array."""
    header = f"P5\n{w} {h}\n{pgm.MAXVAL}\n".encode()
    with open(path, "rb") as f:
        if f.read(len(header)) != header:
            raise AssertionError(f"{path}: not the header {header!r}")
    if path.stat().st_size != len(header) + h * w:
        raise AssertionError(f"{path}: {path.stat().st_size} bytes, not {len(header) + h * w}")
    if mapped:
        return np.memmap(path, np.uint8, "r", offset=len(header), shape=(h, w))
    return np.fromfile(path, np.uint8, offset=len(header)).reshape(h, w)


class ViewSink(Sink):
    """A ``Sink`` that keeps the rebuilt view after each frame, by turn:
    (rect, factors, view)."""

    def __init__(self):
        super().__init__()
        self.views = {}

    def __call__(self, e) -> None:
        super().__call__(e)
        if type(e) in (gol.FrameReady, gol.FrameDelta):
            self.views[e.completed_turns] = (self.rect, self.factors, self.view.copy())


class CountSink(Sink):
    """A ``Sink`` that keeps every ``AliveCellsCount`` as (turn, count)."""

    def __init__(self):
        super().__init__()
        self.counts = []

    def __call__(self, e) -> None:
        super().__call__(e)
        if type(e) is gol.AliveCellsCount:
            self.counts.append((e.completed_turns, e.cells_count))


@contextlib.contextmanager
def host_phases():
    """While the block runs, the seconds a run spends in its host-side
    passes over the whole board: reading and writing PGMs (the input, the
    final board, checkpoints), the board's put and fetch, and the final
    alive cells.  Yields the {pass: seconds} dict."""
    from distributed_gol_torch.utils.cell import AliveCells

    spent = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    saved = [(pgm, "read_pgm"), (pgm, "write_pgm"), (Backend, "put"), (Backend, "fetch")]
    originals = [getattr(o, n) for o, n in saved]
    from_board = AliveCells.__dict__["from_board"]
    for (owner, name), fn in zip(saved, originals):
        setattr(owner, name, timed(name, fn))
    AliveCells.from_board = classmethod(timed("alive_cells", from_board.__func__))
    try:
        yield spent
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)
        AliveCells.from_board = from_board


def gib(n: int) -> float:
    return round(n / 2**30, 3)


def flagship_leg(name: str, params: gol.Params, kernels: tuple, launches, engine: str,
                 sink=None, keep: bool = False, **kw) -> tuple:
    """One run of path (t) (``stream_run``; ``kw`` its keys, devices,
    session and backend factory), with every launch count set to 0 and the
    card's peak allocation reset just before and both read just after:
    the run must have taken ``engine`` and launched each of ``kernels``,
    and its peak ``max_memory_allocated`` must stay below half of the
    card's memory.  Its launches are added to ``launches`` (None: a
    reference run, not counted).  The final PGM is removed unless
    ``keep``: runs are held to each other by their final boards' alive
    cells (``FinalTurnComplete.alive``, ``same_board``).  Returns
    (numbers, sink)."""
    sink = Sink() if sink is None else sink
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with host_phases() as host:
        seconds, final = stream_run(params, sink, read_final=False, **kw)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    got = sink.report["info"]["backend.engine"]
    ran = {k: n for k, n in counts.items() if n}
    loop = sink.loop_seconds()
    stats = dict(run=stats_row("run gens/s", [params.turns / seconds]),
                 loop=stats_row("dispatch-loop gens/s", [params.turns / loop]))
    print(f"flagship {name}: {seconds:.3f} s, run gens/s {stats['run']}, dispatch-loop gens/s "
          f"{stats['loop']}, launches {ran}, engine {got}, peak max_memory_allocated "
          f"{gib(peak)} GiB of {gib(total)} GiB (mem_get_info total); host passes "
          f"{ {k: round(v, 2) for k, v in host.items()} } s", flush=True)
    if got != engine:
        raise AssertionError(f"(t) {name}: engine_used {got!r}, not {engine}")
    missing = [k for k in kernels if not counts[k]]
    if missing:
        raise AssertionError(f"(t) {name}: {missing} never launched")
    if peak >= total / 2:
        raise AssertionError(f"(t) {name}: peak {gib(peak)} GiB, not below half of "
                             f"{gib(total)} GiB")
    if launches is not None:
        for k, n in ran.items():
            launches[k] += n
    if final is None or sink.final is None:
        raise AssertionError(f"(t) {name}: no final PGM or no FinalTurnComplete")
    if not keep:
        final.unlink()
    return dict(seconds=seconds, dispatch_loop_s=loop, launches=ran, engine=got,
                peak_allocated_gib=gib(peak), card_total_gib=gib(total), stats=stats,
                host_s={k: round(v, 3) for k, v in host.items()},
                alive=len(sink.final.alive), **skip_gauges(sink)), sink


def same_board(a, b) -> bool:
    """Whether two runs' final boards are equal: their
    ``FinalTurnComplete.alive`` cells, in row-major order."""
    return np.array_equal(a.xy, b.xy)


def check_final_pgm(name: str, path: Path, side: int, alive) -> int:
    """The final PGM of a flagship run against the run's own final board
    (``FinalTurnComplete.alive``): its header, a byte of 0 or 255 a cell,
    and its alive cells those of the event, in row-major order.  Returns
    the int64 popcount of its cells."""
    cells = torch.from_numpy(pgm_raster(path, side, side, mapped=False))
    yx = torch.nonzero(cells).numpy()
    if int(torch.count_nonzero(cells == 255)) != len(yx):
        raise AssertionError(f"(t) {name}: a cell byte other than 0 and 255")
    xy = alive.xy
    if len(yx) != len(xy) or not (np.array_equal(yx[:, 1], xy[:, 0])
                                  and np.array_equal(yx[:, 0], xy[:, 1])):
        raise AssertionError(f"(t) {name}: the final PGM's alive cells differ from "
                             "FinalTurnComplete.alive")
    return len(yx)


def check_packing(device) -> None:
    """The whole-board passes the main path runs beside the kernels, on
    the card, against numpy on the host (tolerance 0): ``packed.pack`` and
    ``unpack`` (``np.packbits``/``unpackbits`` little-endian, as uint32
    words), ``pack_vertical`` and ``unpack_vertical``, ``stencil.alive_count``
    and ``packed.alive_count``, and the SDC fingerprint
    (``backend._board_fingerprint``, in uint64 numpy, at a block offset;
    it reads a nonzero byte as alive), on a board of every byte value (only the low bit is a cell) whose rows
    no block size divides, at the default row block and at one of a few
    rows (``stencil.BLOCK_CELLS``)."""
    from distributed_gol_torch.engine.backend import _board_fingerprint

    h, w, y0, x0 = 2000, 4096, 70001, 123
    host = np.random.default_rng(31).integers(0, 256, (h, w), dtype=np.uint8)
    bits = host & 1
    words = np.packbits(bits, axis=-1, bitorder="little").view("<u4")
    vert = np.packbits(np.ascontiguousarray(bits[:h // 32 * 32].T), axis=-1,
                       bitorder="little").view("<u4").T
    wy = (np.arange(h, dtype=np.uint64) + y0) * 2654435761 % 2**32
    wx = (np.arange(w, dtype=np.uint64) + x0) * 2246822519 % 2**32
    fp = int(((host != 0) * (wy[:, None] ^ wx[None, :])).sum() % 2**32)
    b = torch.from_numpy(host).to(device)
    saved = stencil.BLOCK_CELLS
    try:
        for cells in (saved, 7 * w + 5):
            stencil.BLOCK_CELLS = cells
            p = packed.pack(b)
            v = packed.pack_vertical(b[:h // 32 * 32])
            got = dict(
                pack=np.array_equal(p.cpu().numpy().view("<u4"), words),
                unpack=np.array_equal(packed.unpack(p).cpu().numpy(), bits * 255),
                pack_vertical=np.array_equal(v.cpu().numpy().view("<u4"), vert),
                unpack_vertical=np.array_equal(packed.unpack_vertical(v).cpu().numpy(),
                                               bits[:h // 32 * 32] * 255),
                counts=int(stencil.alive_count(b)) == int(packed.alive_count(p))
                == int(bits.sum()),
                fingerprint=int(_board_fingerprint(b, y0, x0)) == fp)
            if not all(got.values()):
                raise AssertionError(f"packing passes at {cells} cells a block: {got}")
            log(f"packing passes on the card at {cells} cells a block: {got}")
    finally:
        stencil.BLOCK_CELLS = saved


def card_soup_blocks(density: float, seed: int, device):
    """(first row, block) of a seeded soup of FLAG² cells made on the card
    ``FLAG_ROWS`` rows at a time: uint8 {0, 255} blocks."""
    g = torch.Generator(device=device).manual_seed(seed)
    for y in range(0, FLAG, FLAG_ROWS):
        alive = torch.rand((FLAG_ROWS, FLAG), generator=g, device=device) < density
        yield y, alive.to(torch.uint8).mul_(255)


def card_soup(density: float, seed: int, device) -> np.ndarray:
    """``card_soup_blocks`` on the host: path (t)'s soups, made on the
    card because ``random_soup``'s float randoms are slow on the host at
    4 GiB."""
    out = np.empty((FLAG, FLAG), np.uint8)
    for y, block in card_soup_blocks(density, seed, device):
        out[y:y + FLAG_ROWS] = block.cpu().numpy()
    return out


def flagship_packed(device, seed: int = 29) -> torch.Tensor:
    """``card_soup_blocks`` at density 0.3, packed on the card: the input
    of ``flagship_kernels``, which needs no host soup."""
    out = torch.empty((FLAG, FLAG // 32), dtype=torch.int32, device=device)
    for y, block in card_soup_blocks(0.3, seed, device):
        out[y:y + FLAG_ROWS] = packed.pack(block)
    return out


def flagship_kernels(errs: dict, int_rate: float, device) -> dict:
    """K2, K5, K9 and K14 at path (t)'s shapes, on ``flagship_packed``: each
    held to its plain version, tolerance 0 (K2 one full launch on the
    whole board, K5 a chunk of 2 launches with its skip count and
    activity, K9 one full launch on strip 0 of the ``T_MESH`` split, K14 a
    chunk of 2 launches over its four strips), then timed a launch from
    the fresh soup (the median and spread of ``BATCHES`` batches; K5 and
    K14 over chunks of 64) beside its bound (``bound_ms``; K9's over its
    light cone, ``ext_bound_ms``; K5's and K14's over the words of the
    routes their stripes took, ``route_words`` and ``work_bound_ms``).
    CUDA events."""
    p = flagship_packed(device)
    sms = cuda_adaptive.device_sms(device)
    shape = tuple(p.shape)
    rows = {}

    def hold(key: str, err: int, what: str) -> None:
        errs[key] = max(errs[key], err)
        if err:
            raise AssertionError(f"{what} at {FLAG}^2 differs from its plain version")

    def row(key: str, ms: dict, bound: tuple, **extra) -> None:
        rows[key] = dict(ms=ms["median"], ms_spread=ms, bound_ms=bound[0], bound_by=bound[1],
                         **extra)
        log(f"{key} at {FLAG}^2: {ms['median']:.4f} ms a launch ({ms['min']:.4f}-"
            f"{ms['max']:.4f}), bound {bound[0]:.4f} by {bound[1]}; {extra}")

    k2 = cuda_packed.tiled_reg_plan(shape, 10**6, sms)
    got = cuda_packed.tiled_superstep(p, CONWAY, k2.t)
    hold("tiled", max_abs_err(got, cuda_packed.tiled_superstep_plain(p, CONWAY, k2.t)), "K2")
    del got
    row("tiled", cuda_ms_spread(lambda: cuda_packed.tiled_superstep(p, CONWAY, k2.t), 3),
        bound_ms(p.numel(), k2.t, 1, CONWAY, int_rate), shape=list(shape), blocks=str(k2))

    plan = cuda_adaptive.adaptive_plan(shape, 10**6)
    (g, gsk, gact), (w, wsk, wact) = (
        f(p, CONWAY, plan, 2) for f in (cuda_adaptive.frontier_superstep,
                                        cuda_adaptive.frontier_superstep_mirror))
    hold("frontier", max(max_abs_err(g, w), abs(int(gsk) - int(wsk)), max_abs_err(gact, wact)),
         "K5")
    del g, w
    routes = chunk_routes(lambda rec: cuda_adaptive.frontier_superstep(
        p, CONWAY, plan, 64, lambda b, st, r: rec(r)))
    words = route_words(routes, plan, shape)
    row("frontier", per_launch(cuda_ms_spread(
        lambda: cuda_adaptive.frontier_superstep(p, CONWAY, plan, 64), 1), 64),
        work_bound_ms(words, words, plan.t + 6, CONWAY, int_rate), plan=str(plan),
        blocks=str(cuda_adaptive.frontier_blocks(shape, plan, 1, sms)),
        routes_per_launch=route_mix(routes), stripes=plan.grid(FLAG))

    m = mesh_lib.make_mesh(T_MESH, virtual(T_MESH, device))
    sb = halo.board_sharding(m).shard(p)
    full = cuda_halo.launch_plan(sb.shard_shape, T_MESH, 10**6)[0]
    e0 = halo.extend(sb, full.pad, full.xpad)[0][0]
    hold("ext", max_abs_err(cuda_halo.ext_launch(e0, CONWAY, full.t, full.pad, full.xpad),
                            cuda_halo.ext_launch_plain(e0, CONWAY, full.t, full.pad, full.xpad)),
         "K9")
    row("ext", cuda_ms_spread(
        lambda: cuda_halo.ext_launch(e0, CONWAY, full.t, full.pad, full.xpad), 5),
        ext_bound_ms(sb.shard_shape, full.t, full.pad, full.xpad, CONWAY, int_rate),
        shard=list(sb.shard_shape), extended=list(e0.shape),
        blocks=str(cuda_halo.ext_reg_plan(sb.shard_shape, full.t, sms)))
    del e0

    strips = [r[0] for r in sb.shards]
    splan = cuda_halo.adaptive_strip_plan(sb.shard_shape, 10**6)
    got = cuda_halo.strip_mega_launches(strips, CONWAY, splan, 2)
    want = cuda_halo.strip_mega_launches(strips, CONWAY, splan, 2, plain=True)
    hold("strip_mega", mega_chunks_equal(got, want, 2), "K14")
    del got, want
    routes = chunk_routes(lambda rec: cuda_halo.strip_mega_launches(
        strips, CONWAY, splan, 64, each=lambda out, st: rec(st.route)))
    words = route_words(routes, splan, sb.shard_shape)
    row("strip_mega", per_launch(cuda_ms_spread(
        lambda: cuda_halo.strip_mega_launches(strips, CONWAY, splan, 64), 1), 64),
        work_bound_ms(words, words, splan.t + 6, CONWAY, int_rate), plan=str(splan),
        strips=len(strips), routes_per_launch=route_mix(routes),
        stripes=T_MESH[0] * splan.grid(sb.shard_shape[0]))
    return rows


def flagship_path(tmp: Path, launches: dict, device, profile: bool = False) -> dict:
    """Path (t), the flagship board on the card (the comment on ``FLAG``):
    every leg through ``gol.run`` held to a run on another tier, its run
    and dispatch-loop gens/s, its launches, its peak device memory and its
    host passes (``host_phases``) printed.  ``profile`` adds a
    ``profile_run`` of (t1) and of (t2)'s K2 rerun."""
    from distributed_gol_torch.engine import supervisor as supervisor_mod

    e2e, side = {}, f"{FLAG}x{FLAG}"
    sparse, dense = tmp / "flagship_soup", tmp / "flagship_dense"
    t0 = time.perf_counter()
    pgm.write_pgm(sparse / f"{side}.pgm", card_soup(0.3, T_SEED, device))
    log(f"(t): the {side} soup made and written in {time.perf_counter() - t0:.1f} s")
    base = gol.Params(turns=T1_TURNS, image_width=FLAG, image_height=FLAG, images_dir=sparse,
                      skip_stable=False, turn_events="batch", ticker_period=3600,
                      out_dir=tmp / "t1")

    # (t1): K2, its PGM checked against the run's final board; then
    # T1_PLAIN_TURNS on K2 and on the plain engine.
    t1, sink = flagship_leg(f"(t1) {side} x {T1_TURNS}", base, ("tiled",), launches,
                            "pallas-packed", keep=True)
    final, board_t1 = base.out_dir / f"{base.final_output_name}.pgm", sink.final.alive
    check_final_pgm("(t1)", final, FLAG, board_t1)
    final.unlink()
    short = dataclasses.replace(base, turns=T1_PLAIN_TURNS, out_dir=tmp / "t1_short")
    t1_short, sink = flagship_leg(f"(t1) {side} x {T1_PLAIN_TURNS}", short, ("tiled",),
                                  launches, "pallas-packed")
    plain, ref = flagship_leg(f"(t1) {side} x {T1_PLAIN_TURNS}, engine=packed",
                              dataclasses.replace(short, engine="packed",
                                                  out_dir=tmp / "t1_plain"), (), None, "packed")
    if not same_board(sink.final.alive, ref.final.alive):
        raise AssertionError(f"(t1): {T1_PLAIN_TURNS} turns on K2 differ from the plain engine's")
    del sink, ref
    log(f"(t1): {T1_TURNS} turns' PGM equals the run's final board ({t1['alive']} alive); "
        f"{T1_PLAIN_TURNS} turns on K2 equal the plain engine's")
    e2e[f"flagship_t1_{side}x{T1_TURNS}"] = dict(
        t1, short=t1_short, plain=dict(plain, reference=f"engine='packed' x {T1_PLAIN_TURNS}"))
    if profile:
        e2e["profile_t1"] = profile_run(T1_TURNS, FLAG, images_dir=sparse, skip_stable=False)
        e2e["profile_t2_k2"] = profile_run(LONG_TURNS, FLAG, images_dir=sparse,
                                           skip_stable=False)

    # (t2): auto skip_stable at LONG_TURNS, beside skip_stable=False (K2).
    long = dataclasses.replace(base, turns=LONG_TURNS, skip_stable=None, out_dir=tmp / "t2")
    if not long.skip_stable_requested():
        raise AssertionError("(t2): auto skip_stable does not engage")
    t2, sink = flagship_leg(f"(t2) {side} x {LONG_TURNS}", long, ADAPTIVE, launches,
                            "pallas-packed")
    board_t2 = sink.final.alive
    dense_ref, ref = flagship_leg(f"(t2) {side} x {LONG_TURNS}, skip_stable=False",
                                  dataclasses.replace(long, skip_stable=False,
                                                      out_dir=tmp / "t2_ref"),
                                  ("tiled",), None, "pallas-packed")
    if not same_board(board_t2, ref.final.alive):
        raise AssertionError("(t2): the skip_stable board differs from the K2 rerun's")
    log(f"(t2): equals the skip_stable=False rerun; skip fraction {t2.get('skip_fraction')}")
    e2e[f"flagship_t2_{side}x{LONG_TURNS}"] = dict(t2, reference=dense_ref)

    # (t3): config 4's (4, 1) layout, a virtual mesh of the card.
    on_mesh, tag = virtual(T_MESH, device), f"{T_MESH[0]}x{T_MESH[1]}"
    t3_long, sink = flagship_leg(
        f"(t3) {side} x {LONG_TURNS} on {tag}",
        dataclasses.replace(long, mesh_shape=T_MESH, out_dir=tmp / "t3_long"), ("strip_mega",),
        launches, "pallas-packed", devices=on_mesh)
    tier = sink.report["info"].get("backend.sharded_tier")
    if tier != "ici-megakernel" or not same_board(sink.final.alive, board_t2):
        raise AssertionError(f"(t3): tier {tier!r}, or the board differs from (t2)'s")
    t3, sink = flagship_leg(f"(t3) {side} x {T1_TURNS} on {tag}",
                            dataclasses.replace(base, mesh_shape=T_MESH, out_dir=tmp / "t3"),
                            ("ext",), launches, "pallas-packed", devices=on_mesh)
    if not same_board(sink.final.alive, board_t1):
        raise AssertionError("(t3): the board differs from (t1)'s")
    log(f"(t3): {tag} equals (t2) with skip_stable ({tier}) and (t1) without")
    e2e[f"flagship_t3_{side}x{LONG_TURNS}_{tag}"] = dict(t3_long, sharded_tier=tier)
    e2e[f"flagship_t3_{side}x{T1_TURNS}_{tag}"] = t3

    # (t4): the viewport, each frame against its light cone on the roll
    # engine: after t <= T4_TURNS generations the rect's cells depend only
    # on the T4_TURNS-cell margin around it, which the window holds.
    view = dataclasses.replace(base, turns=T4_TURNS, no_vis=False, viewport=T4_RECT,
                               frame_stride=1, turn_events="per-turn", out_dir=tmp / "t4")
    t4, sink = flagship_leg(f"(t4) viewport {T4_RECT} x {T4_TURNS}", view, ("stencil",),
                            launches, "pallas", sink=ViewSink())
    y0, x0, vh, vw = T4_RECT
    m = T4_TURNS
    raster = pgm_raster(sparse / f"{side}.pgm", FLAG, FLAG)
    window = torch.from_numpy(np.ascontiguousarray(raster[np.ix_(
        np.arange(y0 - m, y0 + vh + m) % FLAG, np.arange(x0 - m, x0 + vw + m) % FLAG)]))
    window, table = window.to(device), stencil.rule_table(CONWAY, device)
    del raster
    for turn in range(m + 1):
        if turn:
            window = stencil.step(window, table)
        rect, factors, got = sink.views[turn]
        want = stencil.frame_pool(window[m:m + vh, m:m + vw], *factors).cpu().numpy()
        if tuple(rect) != T4_RECT or not np.array_equal(got, want):
            raise AssertionError(f"(t4): the frame of turn {turn} at {rect} differs from its "
                                 "light cone's crop")
    t4.update(frames=sink.frames, deltas=sink.deltas, frames_per_s=sink.frames / t4["seconds"])
    t4["stats"]["frames"] = stats_row("frames/s", [t4["frames_per_s"]], "frames/s")
    log(f"(t4): {sink.frames} frames ({sink.deltas} deltas) equal their light cones' crops")
    e2e[f"flagship_t4_viewport_{side}x{T4_TURNS}"] = t4
    del sink

    # (t5): supervised, one corrupt rolled back.
    sup = dataclasses.replace(base, superstep=T5_STEP, restart_limit=1,
                              checkpoint_every_turns=T5_CKPT, sdc_check_every_turns=T5_STEP,
                              out_dir=tmp / "t5")
    harness = FaultInjectionBackend(Backend(sup), FaultPlan([T5_FAULT]))

    def factory(p, attempt):
        return harness if attempt == 0 else harness.rebind(Backend(p))

    before = metrics.REGISTRY.snapshot()
    with recorded(supervisor_mod, "supervise") as sups:
        t5, sink = flagship_leg(f"(t5) {side} x {T1_TURNS} supervised", sup, ("tiled",), launches,
                             "pallas-packed", session=Session(tmp / "t5_ckpt"),
                             backend_factory=factory)
    delta = metrics.REGISTRY.snapshot().delta(before).to_dict()["counters"]
    history = [{k: v for k, v in r.items() if k != "t"} for r in sups[0].history]
    if [r["cause"] for r in history] != ["CorruptionDetected"] or \
            [f.kind for f in harness.injected] != ["corrupt"]:
        raise AssertionError(f"(t5): history {history}, injected {harness.injected}")
    if not same_board(sink.final.alive, board_t1):
        raise AssertionError("(t5): the supervised board differs from (t1)'s")
    t5.update(history=history, recovery_times_s=sups[0].recovery_times(), counters={
        k: v for k, v in delta.items() if k.startswith(("supervisor.", "sdc.", "faults."))})
    log(f"(t5): rolled back once ({history}), equals (t1); counters {t5['counters']}")
    e2e[f"flagship_t5_supervised_{side}x{T1_TURNS}"] = t5
    del harness, sups, sink, board_t1, board_t2
    shutil.rmtree(sparse)
    shutil.rmtree(tmp / "t5_ckpt", ignore_errors=True)

    # (t6): past 2^31 alive.  The turn-0 count comes from the ticker while
    # the run is paused at turn 0; the soup's count on the card too.
    t0 = time.perf_counter()
    soup = card_soup(T6_DENSITY, T6_SEED, device)
    alive0 = int(np.count_nonzero(soup))
    on_card = int(stencil.alive_count(torch.from_numpy(soup).to(device)))
    pgm.write_pgm(dense / f"{side}.pgm", soup)
    del soup
    log(f"(t6): the {T6_DENSITY} soup ({alive0} alive) made and written in "
        f"{time.perf_counter() - t0:.1f} s")
    if alive0 <= T6_PAST or on_card != alive0:
        raise AssertionError(f"(t6): {alive0} alive, counted {on_card} on the card")
    dense_p = dataclasses.replace(base, turns=T6_TURNS, images_dir=dense, ticker_period=T6_TICK)
    boards = []
    for where, shape, kernels in (("one device", (1, 1), ("tiled",)), (tag, T_MESH, ("ext",))):
        p = dataclasses.replace(dense_p, mesh_shape=shape, out_dir=tmp / f"t6_{shape[0]}")
        out, sink = flagship_leg(f"(t6) {side} x {T6_TURNS} density {T6_DENSITY}, {where}", p,
                                 kernels, launches, "pallas-packed", sink=CountSink(), keep=True,
                                 keys=KeysAfter({1: "p", T6_PAUSE: "p"}),
                                 devices=virtual(shape, device) if shape != (1, 1) else None)
        final = p.out_dir / f"{p.final_output_name}.pgm"
        check_final_pgm(f"(t6) {where}", final, FLAG, sink.final.alive)
        final.unlink()
        turn0 = sorted({c for t, c in sink.counts if t == 0})
        if turn0 != [alive0]:
            raise AssertionError(f"(t6) {where}: turn-0 counts {turn0}, not [{alive0}]")
        out.update(alive_turn0=alive0, alive_turn0_on_card=on_card)
        boards.append(sink.final.alive)
        e2e[f"flagship_t6_{side}x{T6_TURNS}_{shape[0]}x{shape[1]}"] = out
        del sink
    if not same_board(*boards):
        raise AssertionError(f"(t6): the {tag} board differs from one device's")
    log(f"(t6): turn 0 {alive0} alive (on the card {on_card}), final "
        f"{e2e[f'flagship_t6_{side}x{T6_TURNS}_1x1']['alive']}, each the PGM's int64 popcount")
    shutil.rmtree(dense)
    return e2e


# -- path (u): the peer form on four cards (``--peer``) ---------------------------


def count_skips(be: Backend) -> list:
    """Each adaptive dispatch's skip count (a device value, unread), in a
    list that ``be``'s ``skip_listener`` fills; the cycle probes are not
    dispatches."""
    seen = []
    be.skip_listener = lambda skipped, total, act: seen.append(skipped)
    return seen


def on_cards(mesh_shape: tuple, cards: list) -> list:
    """A shard-per-device list putting ``mesh_shape``'s shards on
    ``cards`` in contiguous runs (row-major): a shard a card on four
    shards, two strips a card on (8, 1)."""
    n = mesh_shape[0] * mesh_shape[1]
    return [cards[s * len(cards) // n] for s in range(n)]


def tier_forms(mesh_shape: tuple, cards: list) -> tuple:
    """(form, devices, in_kernel) of path (u)'s three runs of a leg: the
    peer form across ``cards``, the ppermute tier across them, and the
    in-kernel tier on the first card (a virtual mesh)."""
    spread_out = on_cards(mesh_shape, cards)
    return (("peer", spread_out, None), ("ppermute", spread_out, False),
            ("one_card", [cards[0]] * len(spread_out), None))


def check_tier_runs(name: str, runs: dict, key: str, same) -> None:
    """Path (u)'s checks of a leg's three runs: the peer and one-card
    runs on the in-kernel tier (``"ici-megakernel"``, policy
    ``"in-kernel"``) launching ``key``, the ppermute run on its forced
    tier launching no ``key``; all three finals ``same``, and the peer
    run's skip count the one-card run's, dispatch by dispatch (both cut
    into the same dispatches, so the same chunks and tails)."""
    for form, r in runs.items():
        tier, policy = r["sharded_tier"], r["sharded_tier_policy"]
        want = (("ppermute", "forced-ppermute (in_kernel=False)") if form == "ppermute"
                else ("ici-megakernel", "in-kernel"))
        if (tier, policy) != want:
            raise AssertionError(f"{name} {form}: tier {tier!r} ({policy!r}), not {want}")
        if bool(r["launches"].get(key)) == (form == "ppermute"):
            raise AssertionError(f"{name} {form}: {key} launches {r['launches'].get(key)}")
    if not (same("peer", "ppermute") and same("peer", "one_card")):
        raise AssertionError(f"{name}: the final boards differ between the tiers")
    a, b = runs["peer"]["dispatch_skips"], runs["one_card"]["dispatch_skips"]
    if a != b:
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        raise AssertionError(f"{name}: the peer form skipped {sum(a)} stripe-launches in "
                             f"{len(a)} dispatches, one card {sum(b)} in {len(b)}; first "
                             f"differing dispatch {first}")


def tier_row(params: gol.Params, seconds: float, sink, counts: dict, skips: list,
             devices: list) -> dict:
    info = sink.report["info"]
    loop = sink.loop_seconds()
    return dict(seconds=seconds, gens_per_s=params.turns / seconds, dispatch_loop_s=loop,
                stats=dict(run=stats_row("run gens/s", [params.turns / seconds]),
                           loop=stats_row("dispatch-loop gens/s", [params.turns / loop])),
                launches={k: n for k, n in counts.items() if n},
                sharded_tier=info.get("backend.sharded_tier"),
                sharded_tier_policy=info.get("backend.sharded_tier_policy"),
                skipped=sum(int(x) for x in skips), devices=[str(d) for d in devices],
                dispatch_skips=[int(x) for x in skips])


def peer_leg(name: str, params: gol.Params, cards: list, launches: dict) -> dict:
    """(u1)-(u3): ``params`` through ``gol.run`` on the peer form across
    ``cards`` (``tier_forms``), beside the ppermute tier across them and
    the in-kernel tier on one card; the three PGMs must be one and the
    peer run's skip count the one-card run's (``check_tier_runs``).  The
    peer run's launches are added to ``launches``."""
    key = "strip_mega" if params.mesh_shape[1] == 1 else "tile_mega"
    runs, finals = {}, {}
    for form, devices, in_kernel in tier_forms(params.mesh_shape, cards):
        p = dataclasses.replace(params, out_dir=params.out_dir / form)
        be = Backend(p, devices, in_kernel=in_kernel)
        skips, sink = count_skips(be), Sink()
        reset_launches()
        seconds, finals[form] = stream_run(p, sink, backend=be)
        counts = launch_counts()
        if finals[form] is None:
            raise AssertionError(f"{name} {form}: no final PGM")
        runs[form] = tier_row(p, seconds, sink, counts, skips, devices)
        if form == "peer":
            for k, n in counts.items():
                launches[k] += n
        del be
    check_tier_runs(name, runs, key, lambda a, b: finals[a] == finals[b])
    r = runs
    print(f"peer {name} {params.image_height}^2 x {params.turns} on {params.mesh_shape}: peer "
          f"form {r['peer']['gens_per_s']:.1f} gens/s (loop {r['peer']['dispatch_loop_s']:.3f} s, "
          f"skipped {r['peer']['skipped']}, launches {r['peer']['launches']}); ppermute tier "
          f"{r['ppermute']['gens_per_s']:.1f} gens/s (loop {r['ppermute']['dispatch_loop_s']:.3f} "
          f"s, skipped {r['ppermute']['skipped']}); one card {r['one_card']['gens_per_s']:.1f} "
          f"gens/s (loop {r['one_card']['dispatch_loop_s']:.3f} s); one PGM", flush=True)
    return runs


def peer_flagship(tmp: Path, cards: list, launches: dict) -> dict:
    """(u4), BASELINE config 4: the flagship's seeded 65536² soup (path
    (t)'s, made on the first card and written as the input PGM) x
    ``LONG_TURNS`` with auto ``skip_stable`` on ``T_MESH`` at superstep
    ``U4_STEP``: the peer form across the cards, the ppermute tier across
    them, and path (t3)'s run, the in-kernel tier on one card (at the same
    superstep); each through ``flagship_leg`` (its
    peak memory on the first card below half of it), held to one another
    by their final alive cells (``same_board``), the peer run's skip
    count to the one-card run's."""
    side = f"{FLAG}x{FLAG}"
    soup = tmp / "u4_soup"
    t0 = time.perf_counter()
    pgm.write_pgm(soup / f"{side}.pgm", card_soup(0.3, T_SEED, cards[0]))
    log(f"(u4): the {side} soup made and written in {time.perf_counter() - t0:.1f} s")
    base = gol.Params(turns=LONG_TURNS, image_width=FLAG, image_height=FLAG, images_dir=soup,
                      mesh_shape=T_MESH, turn_events="batch", ticker_period=3600,
                      superstep=U4_STEP, out_dir=tmp / "u4")
    if not base.skip_stable_requested():
        raise AssertionError("(u4): auto skip_stable does not engage")
    runs, boards = {}, {}
    for form, devices, in_kernel in tier_forms(T_MESH, cards):
        p = dataclasses.replace(base, out_dir=tmp / f"u4_{form}")
        be = Backend(p, devices, in_kernel=in_kernel)
        skips = count_skips(be)
        kernels = ("strip_frontier",) if form == "ppermute" else ("strip_mega",)
        row, sink = flagship_leg(f"(u4) {side} x {LONG_TURNS} on {T_MESH}, {form}", p, kernels,
                                 launches if form == "peer" else None, "pallas-packed",
                                 backend=be)
        info = sink.report["info"]
        row.update(sharded_tier=info.get("backend.sharded_tier"),
                   sharded_tier_policy=info.get("backend.sharded_tier_policy"),
                   skipped=sum(int(x) for x in skips), devices=[str(d) for d in devices],
                   dispatch_skips=[int(x) for x in skips])
        runs[form], boards[form] = row, sink.final.alive
        del sink, be
    check_tier_runs("(u4)", runs, "strip_mega",
                    lambda a, b: same_board(boards[a], boards[b]))
    shutil.rmtree(soup)
    print(f"peer (u4) config 4, {side} x {LONG_TURNS} on {T_MESH}: peer form "
          f"{runs['peer']['stats']['run']['median']:.2f} run gens/s, ppermute tier "
          f"{runs['ppermute']['stats']['run']['median']:.2f}, one card (t3) "
          f"{runs['one_card']['stats']['run']['median']:.2f}; one board "
          f"({runs['peer']['alive']} alive), skipped {runs['peer']['skipped']}", flush=True)
    return runs


def path_u(tmp: Path, cards: list, launches: dict, leg) -> None:
    """Path (u)'s legs across ``cards``, each through ``leg(name, fn,
    *args)``: (u1)-(u3) (``peer_leg``), (u4) (``peer_flagship``) and (u5),
    (o)'s ladder across the cards (``escalation_path``).  One card listed
    ``U_CARDS`` times runs the same code on a virtual mesh."""
    soup = dict(image_width=BIG, image_height=BIG, soup_density=0.3, soup_seed=7,
                turn_events="batch", ticker_period=3600, skip_stable=True, superstep=U_STEP)
    for tag, mesh_shape in (("u1", (4, 1)), ("u2", (2, 2)), ("u3", (8, 1))):
        params = gol.Params(turns=U_TURNS, mesh_shape=mesh_shape, out_dir=tmp / tag, **soup)
        leg(tag, peer_leg, f"({tag})", params, cards, launches)
    leg("u4", peer_flagship, tmp, cards, launches)
    leg("u5", escalation_path, tmp, launches, cards[0], on_cards(MESH_E, cards))


def peer_main(started: float) -> int:
    """``--peer``: the peer form on ``U_CARDS`` cards of this machine.
    Fails with a message where there are fewer cards or two of them
    cannot reach each other (CUDA peer access); else builds the kernels,
    runs ``check_peer_mega`` and ``time_peer`` across the cards, then
    path (u) (``peer_leg``, ``peer_flagship`` and (o)'s ladder across the
    cards).  Every leg runs even if one before it failed; any failure
    fails the run, after the record."""
    import traceback

    n = torch.cuda.device_count()
    smi = all_cards_smi("name,power.limit")
    log(f"cards: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if n < U_CARDS:
        log(f"chip_smoke --peer: needs {U_CARDS} CUDA devices, found {n}")
        return 1
    cards = [torch.device("cuda", i) for i in range(U_CARDS)]
    access = {f"cuda:{a}->cuda:{b}": bool(torch.cuda.can_device_access_peer(a, b))
              for a in range(U_CARDS) for b in range(U_CARDS) if a != b}
    print(record({"peer_access": access, "cards": smi}))
    if not all(access.values()):
        log(f"chip_smoke --peer: no CUDA peer access between {[k for k, v in access.items() if not v]}:"
            " the peer form cannot run here (its policy gives the ppermute tier)")
        return 1
    t0 = time.perf_counter()
    build_kernels()
    log(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.build_log("frontier").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  frontier: {line.strip()}")
    reg = reg_build_report(cuda_build.build_log("frontier"))
    errs = {k: 0 for k in KERNELS}
    boards = step("boards", lambda: {"fresh": packed.pack(board(BIG, BIG, 13, cards[0])),
                                     "settled": settled_board(cards[0])})
    sparse = sparse_packed(BIG, BIG, cards[0])
    results, failures = {}, []

    def leg(name, fn, *args):
        try:
            results[name] = step(name, fn, *args)
        except Exception as e:  # every leg runs; the run fails at the end
            failures.append(f"{name}: {type(e).__name__}: {e}")
            log(traceback.format_exc())

    leg("check_peer_mega", check_peer_mega, errs, boards, sparse, cards)
    leg("time_peer", time_peer, boards, cards)
    if "check_peer_mega" in results and "time_peer" in results:
        results["kernels"] = [
            dict(name=k, **KERNELS[k], max_abs_err=errs[k], **r)
            for k, r in peer_entries(results["check_peer_mega"], results["time_peer"]).items()]
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        path_u(Path(tmp), cards, launches, leg)
    print(record({"peer": results, "launches": launches, "max_abs_err": errs,
                  "frontier_build": reg, "step_seconds": STEP_SECONDS, "cards": smi}))
    log(f"chip_smoke --peer: {time.perf_counter() - started:.1f} s in all, kernel builds included")
    if failures:
        for f in failures:
            log(f"FAILED {f}")
        return 1
    print(smi[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


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


def profile_run(turns: int, side: int = BIG, devices=None, images_dir=None, **viewer) -> dict:
    """Where the time of a main-path run on the ``side``² soup goes: the
    seeded soup's generation on the host, then the whole run under
    ``torch.profiler`` (device time by kernel, and the device's busy share
    of the run's wall-clock), its stream consumed as it is produced.
    ``viewer`` holds the Params of a viewer path (``no_vis=False``, ...)
    or a ``mesh_shape`` (run on the virtual mesh ``devices``); a headless
    run has batch turn events; ``images_dir`` holds the input PGM in place
    of the soup.  ``loop_idle_share_at_least`` bounds the
    device's idle share of the dispatch loop from below (all of the run's
    device time, loop or not, over the loop's seconds), and
    ``loop_busy_share_at_least`` its busy share: the device time of the
    port's own kernels, which run only inside dispatches, over the loop's
    seconds.  A sharded run also
    reports its K9-K15 launches and the device time per sharded launch
    (one launch per shard) of its device-to-device memcpys: on a row mesh
    these are the halo exchange's copies and nothing else
    (``halo.extend`` copies contiguous row blocks; packing and the gather
    run as kernels or host copies)."""
    t0 = time.perf_counter()
    if images_dir is None:
        random_soup(side, side, 0.3, 7)
    soup_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        opts = dict(viewer)
        if opts.get("no_vis", True):
            opts.setdefault("turn_events", "batch")
        source = (dict(soup_density=0.3, soup_seed=7) if images_dir is None
                  else dict(images_dir=images_dir))
        params = gol.Params(turns=turns, image_width=side, image_height=side, out_dir=Path(tmp),
                            ticker_period=3600, **source, **opts)
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
    kernel_times = launch_times(prof, sink.loop_seconds())
    busy_s = sum(r[0] for r in rows) / 1e6
    # The port's own kernels (csrc/, all in an anonymous namespace; a
    # template's name starts with its return type) run only inside
    # dispatches, so their device time is loop time.
    kernel_s = sum(us for us, k, _ in rows if "(anonymous namespace)::" in k
                   and "at::native" not in k) / 1e6
    out = dict(
        side=side, turns=turns, viewer={k: v for k, v in viewer.items() if k != "mesh_shape"},
        wall_s=wall, soup_host_s=soup_s, dispatch_loop_s=sink.loop_seconds(),
        device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
        loop_idle_share_at_least=1 - busy_s / sink.loop_seconds(),
        kernel_device_s=kernel_s, loop_busy_share_at_least=kernel_s / sink.loop_seconds(),
        top_device=[dict(name=k[:80], device_ms=us / 1e3, calls=n, ms_per_call=us / 1e3 / n,
                         loop_share=us / 1e6 / sink.loop_seconds())
                    for us, k, n in rows[:12]],
        port_kernels=kernel_times,
    )
    if devices:
        dtod = [(us, n) for us, k, n in rows if k.startswith("Memcpy DtoD")]
        total = sum(halo_launches.values())
        # K14 and K15 cover every shard in one launch; the others one shard each.
        mega = halo_launches["strip_mega"] + halo_launches["tile_mega"]
        launches = (total - mega) / len(devices) + mega
        exchange_ms = sum(us for us, _ in dtod) / 1e3
        out.update(mesh_shape=list(viewer["mesh_shape"]), launches=halo_launches,
                   sharded_launches=launches, exchange_copies=sum(n for _, n in dtod),
                   exchange_device_ms=exchange_ms,
                   exchange_device_ms_per_launch=exchange_ms / launches if total else None,
                   loop_ms_per_launch=sink.loop_seconds() * 1e3 / launches if total else None)
    return out


# Launches of a traced run whose device times stand for a fresh board (the
# run's first) and a settled one (its last, before the cycle check
# fast-forwards).
FIRST_LAUNCHES, LAST_LAUNCHES = 8, 256


def launch_times(prof, loop_s: float) -> dict:
    """Each of the port's kernels (``csrc/``, anonymous namespace) in a
    trace, launch by launch: its launches, device ms in all and their
    share of the dispatch loop's ``loop_s``, the mean, median, 10th and
    90th percentile and largest device ms a launch, the mean of its first
    ``FIRST_LAUNCHES`` (the fresh soup) and last ``LAST_LAUNCHES`` launches
    (settled), in start order, and its heavy launches (at least half the
    largest: a frontier kernel's forced launch 0 of each chunk and the
    fresh soup's launches), their count and device ms."""
    times = collections.defaultdict(list)
    for e in prof.events():
        if ("CUDA" in str(e.device_type) and "(anonymous namespace)::" in e.name
                and "at::native" not in e.name):
            times[e.name.split("(anonymous namespace)::")[1].split("<")[0].split("(")[0]].append(
                (e.time_range.start, e.time_range.elapsed_us() / 1e3))
    out = {}
    for name, seq in times.items():
        ms = [t for _, t in sorted(seq)]
        q = statistics.quantiles(ms, n=10) if len(ms) > 1 else ms * 9
        heavy = [t for t in ms if t >= max(ms) / 2]
        out[name] = dict(launches=len(ms), device_ms=sum(ms), loop_share=sum(ms) / 1e3 / loop_s,
                         mean_ms=statistics.mean(ms), median_ms=statistics.median(ms),
                         p10_ms=q[0], p90_ms=q[-1], max_ms=max(ms),
                         first_ms=statistics.mean(ms[:FIRST_LAUNCHES]),
                         last_ms=statistics.mean(ms[-LAST_LAUNCHES:]),
                         heavy_launches=len(heavy), heavy_device_ms=sum(heavy))
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
    """Per-launch times of K3, K4 and K5 at 16384² on each board (the median
    and spread of ``BATCHES`` batches, and K3's and K4's device ms a launch
    from ``torch.profiler``), beside K2 at the same T and the plain
    versions (K5's over 8 launches), with each launch's bound from its own
    telemetry: K5 over the
    words of the routes its stripes took in a 64-launch chunk
    (``route_words``), K4 over 8 launches from a zero bitmap (it moves
    only the stripes it computes), K3 one launch (it writes the whole
    board; its computed stripes are those K4's first launch does not prove
    stable).  The ``dead`` board's times are the launch floor: it has no
    work."""
    plan = cuda_adaptive.adaptive_plan((BIG, BIG // 32), 10**6)
    sms = cuda_adaptive.device_sms(boards["fresh"].device)
    grid = plan.grid(BIG)
    stripe_words = plan.stripe_h * BIG // 32
    out = {}
    for name, p in boards.items():
        routes = chunk_routes(lambda rec: cuda_adaptive.frontier_superstep(
            p, CONWAY, plan, 64, lambda b, st, r: rec(r)))
        _, sk4, _ = cuda_adaptive.probing_superstep(p, CONWAY, plan, 8)
        _, sk1, _ = cuda_adaptive.probing_superstep(p, CONWAY, plan, 1)
        computed = {"frontier": route_words(routes, plan, tuple(p.shape)) / stripe_words,
                    "probing": (8 * grid - int(sk4)) / 8, "tiled_skip": grid - int(sk1)}
        gens = {"frontier": plan.t + 6, "probing": plan.t, "tiled_skip": plan.t}
        row = {
            "tiled_same_t_ms": cuda_ms(lambda: cuda_packed.tiled_superstep(p, CONWAY, plan.t), 10),
            "tiled_skip": dict(
                ms_spread=cuda_ms_spread(
                    lambda: cuda_adaptive.tiled_skip_superstep(p, CONWAY, plan.t), 10),
                device_ms=device_ms(lambda: cuda_adaptive.tiled_skip_superstep(p, CONWAY, plan.t),
                                    10, "tiled_skip_reg_kernel"),
                blocks=str(cuda_adaptive.tiled_skip_reg_plan((BIG, BIG // 32), plan.t, sms)),
                plain_ms=cuda_ms(lambda: cuda_adaptive.tiled_skip_superstep_plain(p, CONWAY, plan.t), 2)),
            "probing": dict(
                ms_spread=per_launch(cuda_ms_spread(
                    lambda: cuda_adaptive.probing_superstep(p, CONWAY, plan, 8), 5), 8),
                device_ms=device_ms(lambda: cuda_adaptive.probing_superstep(p, CONWAY, plan, 8),
                                    1, "board_probing_reg_kernel"),
                blocks=str(cuda_adaptive.probing_reg_plan(plan, (BIG, BIG // 32), sms)),
                plain_ms=cuda_ms(lambda: cuda_adaptive.probing_superstep_mirror(p, CONWAY, plan, 8), 1) / 8),
            "frontier": dict(
                ms_spread=per_launch(cuda_ms_spread(
                    lambda: cuda_adaptive.frontier_superstep(p, CONWAY, plan, 64), 3), 64),
                plain_ms=cuda_ms(lambda: cuda_adaptive.frontier_superstep_mirror(p, CONWAY, plan, 8), 1) / 8),
        }
        for k in ADAPTIVE:
            row[k]["ms"] = row[k]["ms_spread"]["median"]
        for k in ADAPTIVE:
            moved = p.numel() if k == "tiled_skip" else computed[k] * stripe_words
            b_ms, b_by = work_bound_ms(moved, computed[k] * stripe_words, gens[k], CONWAY, int_rate)
            row[k].update(computed_stripes_per_launch=computed[k], bound_ms=b_ms, bound_by=b_by)
        # K5's "computed stripes" are its routes' words in whole stripes.
        row["frontier"]["routes_per_launch"] = route_mix(routes)
        out[name] = row
        log(f"{name} board, {plan}: K2 {row['tiled_same_t_ms']:.4f} ms per {plan.t}-gen launch; "
            f"device ms a launch: K3 {row['tiled_skip']['device_ms']:.4f}, K4 "
            f"{row['probing']['device_ms']:.4f}; "
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
    fresh and the settled stack, and of the sparse stack, per launch (the
    median and spread of ``BATCHES`` batches of 3 chunks), with the bound
    of the work that chunk's data needs (the words of the routes its
    stripes took, ``route_words``, T + 6 generations each)."""
    nt, side, _, step = POD_K7
    v = packed.pack_vertical(soup_stack(nt, side, 61, torch.device("cuda", 0))).contiguous()
    k1_sequential = cuda_ms_spread(lambda: [cuda_packed.resident_superstep(b, CONWAY, step)
                                            for b in v], 5)
    def k7_launch(stack):
        return lambda: cuda_packed.resident_superstep_batched(stack, CONWAY, step)

    k7_ms = cuda_ms_spread(k7_launch(v), 20)
    plan = cuda_packed.card_batched_plan(v, CONWAY)
    active = cuda_packed.card_active_clusters(v.device, CONWAY)(plan)
    edge = packed.pack_vertical(torch.stack([board(1024, 1792, 41 + i, v.device)
                                             for i in range(3)])).contiguous()
    edge_plan = cuda_packed.card_batched_plan(edge, CONWAY)
    edge_ms = cuda_ms_spread(k7_launch(edge), 10)
    k7 = dict(
        ms=k7_ms["median"],
        plain_ms=cuda_ms(lambda: cuda_packed.resident_superstep_batched_plain(v, CONWAY, step), 2),
        bound=bound_ms(v.numel(), step, 1, CONWAY, int_rate),
        extra=dict(shape=[nt, side, side], gens=step, ms_spread=k7_ms,
                   device_ms=device_ms(k7_launch(v), 20, "resident_reg_kernel"),
                   plan=dataclasses.asdict(plan), active_clusters=active,
                   waves=-(-nt // active),
                   k1_sequential_ms=k1_sequential["median"], k1_sequential_spread=k1_sequential,
                   at_3x1024x1792=dict(ms_spread=edge_ms, plan=dataclasses.asdict(edge_plan),
                                       device_ms=device_ms(k7_launch(edge), 10,
                                                           "resident_reg_kernel"),
                                       bound_ms=bound_ms(edge.numel(), step, 1, CONWAY,
                                                         int_rate)[0])),
    )
    log(f"K7 {nt} x {side}^2 x {step} gens: {k7['ms']:.4f} ms in one launch "
        f"({k7_ms['min']:.4f}-{k7_ms['max']:.4f}; device {k7['extra']['device_ms']:.4f}; "
        f"clusters of {plan.cluster}, {active} at once), {nt} x K1 "
        f"{k1_sequential['median']:.4f} ms, plain {k7['plain_ms']:.3f} ms, bound "
        f"{k7['bound'][0]:.5f} ms by {k7['bound'][1]}; 3 x 1024x1792: "
        f"{edge_ms['median']:.4f} ms ({edge_plan})")
    nb, side = POD_K8[0], POD_K8[1]
    rows = {}
    for name, st in k8_stacks.items():
        plan = cuda_adaptive.adaptive_plan(tuple(st.shape[1:]), 10**6)
        routes = chunk_routes(lambda rec: cuda_adaptive.frontier_superstep_batched(
            st, CONWAY, plan, 8, lambda b, s, r: rec(r)))
        words = route_words(routes, plan, tuple(st.shape[1:]))
        b_ms, b_by = work_bound_ms(words, words, plan.t + 6, CONWAY, int_rate)
        spread_ms = per_launch(cuda_ms_spread(
            lambda: cuda_adaptive.frontier_superstep_batched(st, CONWAY, plan, 8), 3), 8)
        rows[name] = dict(
            ms=spread_ms["median"], ms_spread=spread_ms, shape=list(st.shape),
            plain_ms=cuda_ms(lambda: cuda_adaptive.frontier_superstep_batched_mirror(
                st, CONWAY, plan, 8), 1) / 8,
            routes_per_launch=route_mix(routes), bound_ms=b_ms, bound_by=b_by)
        log(f"K8 {tuple(st.shape)} words, {plan}, {name}: {rows[name]['ms']:.4f} ms per launch "
            f"(plain {rows[name]['plain_ms']:.3f}, bound {b_ms:.4f} by {b_by}, routes a launch "
            f"{route_mix(routes)})")
    plan = cuda_adaptive.adaptive_plan((side, side // 32), 10**6)
    fresh = rows["fresh"]
    k8 = dict(ms=fresh["ms"], plain_ms=fresh["plain_ms"],
              bound=(fresh["bound_ms"], fresh["bound_by"]),
              extra=dict(board="fresh", shape=[nb, side, side], plan=dataclasses.asdict(plan),
                         per_board=rows))
    return {"resident_batched": k7, "frontier_batched": k8}


def time_ext(cases: dict, int_rate: float) -> dict:
    """K9 per launch on one shard of the 16384² soup split (4, 1) and
    (2, 2), at the full launch depth (the median and spread of ``BATCHES``
    batches), with its blocks (``ext_reg_plan``: grid, threads, occupancy,
    fill, row-generations a block), beside one K2 launch of the whole board
    at the same T, its plain version and its bound over the centre's light
    cone (``ext_bound_ms``); the exchange alone (``halo.extend``) and a
    whole sharded launch (exchange plus one K9 per shard) per launch.  CUDA
    events."""
    rows = {}
    for mesh_shape, (sb, plan) in cases.items():
        e0 = halo.extend(sb, plan.pad, plan.xpad)[0][0]
        whole = sb.gather()
        step = cuda_halo.make_superstep(sb.mesh, CONWAY)
        b_ms, b_by = ext_bound_ms(sb.shard_shape, plan.t, plan.pad, plan.xpad, CONWAY, int_rate)
        blocks = cuda_halo.ext_reg_plan(sb.shard_shape, plan.t, cuda_halo.device_sms(e0.device))
        k9 = cuda_ms_spread(lambda: cuda_halo.ext_launch(e0, CONWAY, plan.t, plan.pad, plan.xpad),
                            20)
        row = dict(
            shard=list(sb.shard_shape), extended=list(e0.shape), t=plan.t, pad=plan.pad,
            xpad=plan.xpad, blocks=dataclasses.asdict(blocks), threads=blocks.threads,
            occupancy=blocks.occupancy, fill=blocks.fill(cuda_halo.device_sms(e0.device)),
            block_row_gens=blocks.work(), halo_bytes=plan.halo_bytes(sb.shard_shape),
            ms=k9["median"], ms_spread=k9,
            plain_ms=cuda_ms(lambda: cuda_halo.ext_launch_plain(
                e0, CONWAY, plan.t, plan.pad, plan.xpad), 2),
            bound_ms=b_ms, bound_by=b_by,
            exchange_ms=cuda_ms(lambda: halo.extend(sb, plan.pad, plan.xpad), 20),
            sharded_launch_ms=cuda_ms(lambda: step(sb, plan.t), 10),
            k2_whole_board_ms=cuda_ms(lambda: cuda_packed.tiled_superstep(whole, CONWAY, plan.t), 10),
        )
        rows[f"{mesh_shape[0]}x{mesh_shape[1]}"] = row
        log(f"K9 {mesh_shape} shard {sb.shard_shape} x {plan.t}: {row['ms']:.4f} ms per shard "
            f"launch (median of {BATCHES}, {k9['min']:.4f}-{k9['max']:.4f}; {blocks}, fill "
            f"{row['fill']:.3f}; plain {row['plain_ms']:.3f}, bound {b_ms:.4f} by {b_by}); "
            f"exchange "
            f"{row['exchange_ms']:.4f} ms ({row['halo_bytes']} halo bytes a shard); sharded "
            f"launch {row['sharded_launch_ms']:.4f} ms vs K2 on the whole board "
            f"{row['k2_whole_board_ms']:.4f} ms")
    lead = rows[f"{MESH_A[0]}x{MESH_A[1]}"]
    return dict(ms=lead["ms"], plain_ms=lead["plain_ms"], bound=(lead["bound_ms"], lead["bound_by"]),
                extra=dict(shape=lead["extended"], ms_spread=lead["ms_spread"], per_mesh=rows))


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
    16384² soup, fresh and settled, and of the sparse board, each call
    between CUDA events inside the strip tier's own launch sequence (so
    every launch sees the exchange's inputs; the median and spread of
    ``BATCHES`` sequences), beside the plain versions the same way, with
    each launch's bound from its own telemetry: K12 over the words of the
    routes its stripes took in 64 launches a strip (``route_words``) and
    K11 over 8 from a zero bitmap (it moves and computes only the stripes
    it computes), T + 6 and T generations, K11 at the probing
    plan and at the frontier plan (the in-kernel tier's loose tail on path
    (e), recorded as ``path_e_tail``); K10 one launch of
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name in ("fresh", "settled", "sparse"):
        sb = cases[name]
        strips = [row[0] for row in sb.shards]
        row = {}
        for key, kernel, plan, seq, n, gens in (
                ("strip_frontier", "strip_frontier", fplan, cuda_halo.frontier_launches, 64,
                 fplan.t + 6),
                ("strip_probing", "strip_probing", pplan, cuda_halo.probing_launches, 8, pplan.t),
                ("path_e_tail", "strip_probing", fplan, cuda_halo.probing_launches, 8, fplan.t)):
            seq(strips, CONWAY, plan, 2)  # warm-up
            per, plain = [], []
            for _ in range(BATCHES):
                spans = []
                _, sk, _ = seq(strips, CONWAY, plan, n, timed(WRAPPERS[kernel], spans))
                per.append(span_ms(spans))
            seq(strips, CONWAY, plan, 2, timed(getattr(cuda_halo, f"{kernel}_launch_plain"), plain))
            grid = plan.grid(strip[0])
            computed = (n * ny * grid - int(sk)) / (n * ny)
            words = computed * plan.stripe_h * strip[1]
            if kernel == "strip_frontier":
                def launch(*a, _rec=None):
                    out = cuda_halo.strip_frontier_launch(*a)
                    _rec(a[5].route)
                    return out

                routes = chunk_routes(lambda rec: seq(strips, CONWAY, plan, n,
                                                      functools.partial(launch, _rec=rec)))
                words = route_words(routes, plan, strip)
                computed = words / (plan.stripe_h * strip[1])
            b_ms, b_by = work_bound_ms(words, words, gens, CONWAY, int_rate)
            row[key] = dict(ms=statistics.median(per), ms_spread=spread(per),
                            plain_ms=span_ms(plain), plan=str(plan),
                            computed_stripes_per_launch=computed, stripes=grid,
                            bound_ms=b_ms, bound_by=b_by)
        t = 18
        e = halo.extend(sb, t, 0)[0][0]
        share, stable = k10_share(e, strip, t, 0)
        b_ms, b_by = ext_bound_ms(strip, t, t, 0, CONWAY, int_rate, share)
        k10 = cuda_ms_spread(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, 0), 20)
        flags = cuda_halo.ext_skip_launch.last_stable
        row["ext_skip"] = dict(
            ms=k10["median"], ms_spread=k10,
            plain_ms=cuda_ms(lambda: cuda_halo.ext_skip_launch_plain(e, CONWAY, t, t, 0), 2),
            t=t, computed_share=share, yardstick_tiles=stable, bound_ms=b_ms, bound_by=b_by,
            blocks=dataclasses.asdict(cuda_halo.ext_skip_plan(strip, t, sms)),
            blocks_computed=int((flags == 0).sum()),
            ext_same_t_ms=cuda_ms(lambda: cuda_halo.ext_launch(e, CONWAY, t, t, 0), 20))
        out[name] = row
        log(f"{name} strips of {MESH_E}: " + "; ".join(
            f"{k} {row[k]['ms']:.4f} ms (plain {row[k]['plain_ms']:.3f}, bound "
            f"{row[k]['bound_ms']:.4f} by {row[k]['bound_by']})" for k in (*STRIPS, "path_e_tail"))
            + f"; K9 at T = {t} {row['ext_skip']['ext_same_t_ms']:.4f} ms; K10 computed share "
            f"{share:.4f} (yardstick {stable}), blocks computed "
            f"{row['ext_skip']['blocks_computed']} of {flags.numel()}")
    h, w, turns = PLAN_LESS
    t = cuda_halo.skip_launch_depth((h // MESH_F[0], w // 32), turns)[0]
    e = halo.extend(cases["plan_less"], t, 0)[0][0]
    b_ms, b_by = ext_bound_ms((h // MESH_F[0], w // 32), t, t, 0, CONWAY, int_rate)
    k10 = cuda_ms_spread(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, 0), 50)
    path_f = dict(shape=list(e.shape), t=t, bound_ms=b_ms, bound_by=b_by, ms=k10["median"],
                  ms_spread=k10,
                  plain_ms=cuda_ms(lambda: cuda_halo.ext_skip_launch_plain(e, CONWAY, t, t, 0), 5))
    log(f"K10 at path (f)'s {tuple(e.shape)} block, T = {t}: {path_f['ms']:.4f} ms "
        f"(plain {path_f['plain_ms']:.3f}, bound {b_ms:.5f} by {b_by})")
    timings = {k: dict(ms=out["fresh"][k]["ms"], plain_ms=out["fresh"][k]["plain_ms"],
                       bound=(out["fresh"][k]["bound_ms"], out["fresh"][k]["bound_by"]),
                       extra=dict(board="fresh", shape=list(strip), per_board={
                           name: row[k] for name, row in out.items()}))
               for k in STRIPS}
    timings["ext_skip"]["extra"]["path_f"] = path_f
    timings["strip_probing"]["extra"]["path_e_tail"] = {
        name: row["path_e_tail"] for name, row in out.items()}
    timings["strip_probing"]["extra"]["settled_elision"] = cases["k11_settled"]
    return timings


def time_strip_mega(cases: dict, int_rate: float) -> dict:
    """K14 per launch on the (4, 1) strips of the 16384² soup, fresh and
    settled, and of the sparse board (the median and spread of
    ``BATCHES`` batches of 3 chunks):
    one 64-launch chunk on the card (its pointer tables, then one
    call a launch) between CUDA events, over 64, beside, in the same call
    and the same way, the ppermute tier's 64 launches (four K12 launches a
    mesh launch, with the row and interval exchange between launches:
    ``frontier_launches``), one K5 chunk of 64 on the whole board at the
    strip plan's stripes, and the plain chunk over 2 launches.  The bound
    is the work of the routes K14's stripes took (``route_words``): T + 6
    generations of their words, each read and written once."""
    strip = (BIG // MESH_E[0], BIG // 32)
    plan = cuda_halo.adaptive_strip_plan(strip, 10**6)
    ny, grid = MESH_E[0], plan.grid(strip[0])
    rows = {}
    for name in ("fresh", "settled", "sparse"):
        strips = cases[name]
        whole = torch.cat(strips)
        routes = chunk_routes(lambda rec: cuda_halo.strip_mega_launches(
            strips, CONWAY, plan, 64, each=lambda out, st: rec(st.route)))
        words = route_words(routes, plan, strip)
        computed = words / (plan.stripe_h * strip[1])
        b_ms, b_by = work_bound_ms(words, words, plan.t + 6, CONWAY, int_rate)
        spread_ms = per_launch(cuda_ms_spread(
            lambda: cuda_halo.strip_mega_launches(strips, CONWAY, plan, 64), 3), 64)
        rows[name] = dict(
            ms=spread_ms["median"], ms_spread=spread_ms,
            plain_ms=cuda_ms(lambda: cuda_halo.strip_mega_launches(
                strips, CONWAY, plan, 2, plain=True), 1) / 2,
            k12_mesh_launch_ms=cuda_ms(
                lambda: cuda_halo.frontier_launches(strips, CONWAY, plan, 64), 3) / 64,
            k5_whole_board_ms=cuda_ms(
                lambda: cuda_adaptive.frontier_superstep(whole, CONWAY, plan, 64), 3) / 64,
            plan=str(plan), computed_stripes_per_launch=computed, stripes=ny * grid,
            routes_per_launch=route_mix(routes), bound_ms=b_ms, bound_by=b_by)
        r = rows[name]
        log(f"K14 {name} strips of {MESH_E}, {plan}: {r['ms']:.4f} ms a launch over all "
            f"{ny} strips (plain {r['plain_ms']:.3f}, bound {b_ms:.5f} by {b_by}, {computed:.2f} "
            f"of {ny * grid} stripes computed); the ppermute tier (4 K12 and the exchange) "
            f"{r['k12_mesh_launch_ms']:.4f} ms; K5 on the whole board {r['k5_whole_board_ms']:.4f} ms")
    fresh = rows["fresh"]
    return dict(ms=fresh["ms"], plain_ms=fresh["plain_ms"],
                bound=(fresh["bound_ms"], fresh["bound_by"]),
                extra=dict(board="fresh", shape=[ny, *strip], per_board=rows))


def strip_mirror_chunk(strips, plan, n: int, rule: LifeRule = CONWAY):
    """An ``n``-launch K14 chunk on ``strips`` through K14's block mirror
    (``cuda_halo.strip_mega_launch_mirror`` at the card's blocks, here on
    the card) in place of the plain version: (strips, state)."""
    blocks = cuda_adaptive.frontier_blocks(tuple(strips[0].shape), plan, len(strips),
                                           cuda_adaptive.device_sms(strips[0].device))
    saved = cuda_halo.strip_mega_launch_plain
    cuda_halo.strip_mega_launch_plain = functools.partial(cuda_halo.strip_mega_launch_mirror,
                                                          blocks=blocks)
    try:
        return cuda_halo.strip_mega_launches(strips, rule, plan, n, plain=True)
    finally:
        cuda_halo.strip_mega_launch_plain = saved


def mirror_chunk(tiles, plan, n: int, rule: LifeRule = CONWAY):
    """An ``n``-launch K15 chunk on ``tiles`` through K15's mirror
    (``cuda_halo.tile_mega_launch_mirror``, which replays the kernel's
    blocks and decisions in PyTorch, here on the card) in place of the
    plain version: (tiles, state, the edge stripes it elided)."""
    saved = cuda_halo.tile_mega_launch_plain
    before = cuda_halo.tile_mega_launch_mirror.elided
    cuda_halo.tile_mega_launch_plain = cuda_halo.tile_mega_launch_mirror
    try:
        out, st = cuda_halo.tile_mega_launches(tiles, rule, plan, n, plain=True)
    finally:
        cuda_halo.tile_mega_launch_plain = saved
    return out, st, cuda_halo.tile_mega_launch_mirror.elided - before


def time_tile_mega(cases: dict, sharded: dict, int_rate: float) -> dict:
    """K15 per launch over the four (2, 2) tiles of the 16384² soup, fresh
    and settled, and of the sparse board with its tile gliders, at the
    shipped geometry: one 64-launch chunk on the card (its pointer tables,
    then one call a launch) between CUDA events, over 64, the median and
    spread of ``BATCHES`` batches of 3 chunks, beside, in the same
    call and the same way, on the soups the ppermute tier's 64 launches
    (four K13 launches a mesh launch from a zero bitmap, with the exchange
    and the 3x3 elision between launches: ``tile_probing_launches`` on the
    same tiles, ``sharded``) and one K5 chunk of 64 on the whole board at
    the tile plan's stripes, and the plain chunk over 2 launches.  The
    bound is the work of the routes K15's stripes took in the 64 launches
    (``route_words``: an elided edge stripe none): T + 6 generations of
    their words, each read and written once."""
    ny, nx = MESH_H
    tile = (BIG // ny, BIG // 32 // nx)
    plan, xpad = cuda_halo.adaptive_tile_plan(tile, 10**6)
    cells = ny * nx * plan.grid(tile[0])
    rows = {}
    for name in ("fresh", "settled", "sparse"):
        tiles = cases[name]
        routes = chunk_routes(lambda rec: cuda_halo.tile_mega_launches(
            tiles, CONWAY, plan, 64, each=lambda out, st: rec(st.route)))
        words = route_words(routes, plan, tile)
        computed = words / (plan.stripe_h * tile[1])
        b_ms, b_by = work_bound_ms(words, words, plan.t + 6, CONWAY, int_rate)
        spread_ms = per_launch(cuda_ms_spread(
            lambda: cuda_halo.tile_mega_launches(tiles, CONWAY, plan, 64), 3), 64)
        rows[name] = r = dict(
            ms=spread_ms["median"], ms_spread=spread_ms,
            elided_edge_stripes_per_launch=int((routes == cuda_adaptive.ROUTE_ELIDED).sum()) / 64,
            plain_ms=cuda_ms(lambda: cuda_halo.tile_mega_launches(
                tiles, CONWAY, plan, 2, plain=True), 1) / 2,
            plan=str(plan), tiers=cuda_adaptive.frontier_geometry(plan, tile),
            computed_stripes_per_launch=computed, stripes=cells,
            routes_per_launch=route_mix(routes), bound_ms=b_ms, bound_by=b_by)
        line = (f"K15 {name} tiles of {MESH_H}, {plan}: {r['ms']:.4f} ms a launch over all "
                f"{ny * nx} tiles ({spread_ms['min']:.4f}-{spread_ms['max']:.4f}; plain "
                f"{r['plain_ms']:.3f}, bound {b_ms:.5f} by {b_by}, {computed:.2f} of {cells} "
                f"stripes' words computed; routes a launch {r['routes_per_launch']})")
        if name in sharded:
            whole = torch.cat([torch.cat(t, dim=1) for t in tiles])
            r["k13_mesh_launch_ms"] = cuda_ms(
                lambda: cuda_halo.tile_probing_launches(sharded[name], CONWAY, plan, xpad, 64),
                3) / 64
            r["k5_whole_board_ms"] = cuda_ms(
                lambda: cuda_adaptive.frontier_superstep(whole, CONWAY, plan, 64), 3) / 64
            line += (f"; the ppermute tier (4 K13 and the exchange) {r['k13_mesh_launch_ms']:.4f} "
                     f"ms; K5 on the whole board {r['k5_whole_board_ms']:.4f} ms")
        log(line)
    fresh = rows["fresh"]
    return dict(ms=fresh["ms"], plain_ms=fresh["plain_ms"],
                bound=(fresh["bound_ms"], fresh["bound_by"]),
                extra=dict(board="fresh", shape=[ny, nx, *tile], per_board=rows))


def time_tiles(cases: dict, int_rate: float) -> dict:
    """Per-launch times of K13 and of K10 at xpad > 0 on the (2, 2) tiles
    of the 16384² soup, fresh and settled.  K13 at the port's plan (the
    plan of path (h)), each call between CUDA events inside the tile
    tier's own launch sequence (so every launch sees the exchange's
    inputs), 8 launches a tile from a zero bitmap, the median and spread
    of ``BATCHES`` such sequences, and back to back on tile (0, 0) from a
    zero bitmap (the device's time without the host's), beside its plain
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = cuda_halo.tile_reg_plan(plan, tile, xpad, sms)
    out = {}
    for name in ("fresh", "settled"):
        sb = cases[name]
        cuda_halo.tile_probing_launches(sb, CONWAY, plan, xpad, 2)  # warm-up
        per, plain = [], []
        n = 8
        for _ in range(BATCHES):
            spans = []
            _, sk, _ = cuda_halo.tile_probing_launches(
                sb, CONWAY, plan, xpad, n, timed(WRAPPERS["tile_probing"], spans))
            per.append(span_ms(spans))
        k13 = spread(per)
        cuda_halo.tile_probing_launches(sb, CONWAY, plan, xpad, 2,
                                        timed(cuda_halo.tile_probing_launch_plain, plain))
        e = halo.extend(sb, plan.pad, xpad)[0][0]
        elig = torch.zeros(plan.grid(tile[0]), dtype=torch.int32, device=e.device)
        st, dst = torch.ones_like(elig), torch.empty(tile, dtype=torch.int32, device=e.device)
        alone = cuda_ms_spread(lambda: cuda_halo.tile_probing_launch(e, elig, dst, st, CONWAY,
                                                                     plan, xpad), 20)
        computed = (n * cells - int(sk)) / (n * MESH_H[0] * MESH_H[1])
        words = computed * plan.stripe_h * tile[1]
        b_ms, b_by = work_bound_ms(words, words, plan.t, CONWAY, int_rate)
        row = {"tile_probing": dict(ms=k13["median"], ms_spread=k13, back_to_back=alone,
                                    plain_ms=span_ms(plain), plan=str(plan), xpad=xpad,
                                    blocks=dataclasses.asdict(blocks), fill=blocks.fill(sms),
                                    computed_stripes_per_launch=computed,
                                    stripes=plan.grid(tile[0]), bound_ms=b_ms, bound_by=b_by)}
        t, xw = 18, 1
        e = halo.extend(sb, t, xw)[0][0]
        share, stable = k10_share(e, tile, t, xw)
        b_ms, b_by = ext_bound_ms(tile, t, t, xw, CONWAY, int_rate, share)
        k10 = cuda_ms_spread(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, xw), 20)
        flags = cuda_halo.ext_skip_launch.last_stable
        row["ext_skip"] = dict(
            ms=k10["median"], ms_spread=k10,
            plain_ms=cuda_ms(lambda: cuda_halo.ext_skip_launch_plain(e, CONWAY, t, t, xw), 2),
            t=t, xpad=xw, shape=list(e.shape), computed_share=share, yardstick_tiles=stable,
            blocks=dataclasses.asdict(cuda_halo.ext_skip_plan(tile, t, sms)),
            blocks_computed=int((flags == 0).sum()), bound_ms=b_ms, bound_by=b_by,
            ext_same_t_ms=cuda_ms(lambda: cuda_halo.ext_launch(e, CONWAY, t, t, xw), 20))
        out[name] = row
        log(f"{name} tiles of {MESH_H}: " + "; ".join(
            f"{k} {row[k]['ms']:.4f} ms (plain {row[k]['plain_ms']:.3f}, bound "
            f"{row[k]['bound_ms']:.4f} by {row[k]['bound_by']})" for k in ("tile_probing", "ext_skip"))
            + f"; K13 median of {BATCHES} {k13['min']:.4f}-{k13['max']:.4f}, back to back "
            f"{alone['median']:.4f} ({blocks}, fill {blocks.fill(sms):.3f})"
            + f"; K9 at T = {t} {row['ext_skip']['ext_same_t_ms']:.4f} ms; K13 computed "
            f"{row['tile_probing']['computed_stripes_per_launch']:.2f} of {plan.grid(tile[0])} "
            f"stripes a tile launch; K10 computed share {share:.4f} (yardstick {stable}), "
            f"blocks computed {row['ext_skip']['blocks_computed']} of {flags.numel()}")
    h, w, turns = TILE_PLAN_LESS
    strip = (h // MESH_I[0], w // 32 // MESH_I[1])
    t = cuda_halo.skip_launch_depth(strip, turns)[0]
    xw = -(-t // 32)
    e = halo.extend(cases["plan_less"], t, xw)[0][0]
    b_ms, b_by = ext_bound_ms(strip, t, t, xw, CONWAY, int_rate)
    k10 = cuda_ms_spread(lambda: cuda_halo.ext_skip_launch(e, CONWAY, t, t, xw), 50)
    path_i = dict(shape=list(e.shape), t=t, xpad=xw, bound_ms=b_ms, bound_by=b_by,
                  ms=k10["median"], ms_spread=k10,
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
    each device part (CUDA events: the step alone, the step with K6's
    count, which a viewer turn runs, and the separate sum of the board it
    replaced), each host copy (host clock), and each Backend viewer method
    whole (host clock: step and count + view + bit-pack + copies + the
    host's unpacking), and the frame probe."""
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
        counted_step_ms=cuda_ms(lambda: be._counted_superstep(b, 1), 20),
        separate_sum_ms=cuda_ms(lambda: stencil.alive_count(nb), 20),
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
        probe_frame_fetch_ms=host_ms(lambda: be.probe_frame_fetch(b, fy, fx), 10),
        # Its parts are warm already, and one call unpacks the flips of a
        # whole fresh soup on the host.
        run_turn_with_flips_ms=host_ms(lambda: be.run_turn_with_flips(b), 1, warm=False),
    )
    log(f"a viewer turn at {BIG}^2: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items() if k.endswith("_ms")))
    return out


def k6_copy_witness(b: torch.Tensor) -> dict:
    """K6's yardstick on the 16384² board ``b``: a byte copy of the board
    (``out.copy_(b)``: the same 2·H·W bytes, no arithmetic), timed with
    CUDA events beside K6 itself, without and with its count."""
    h, w = b.shape
    out, k6_out = torch.empty_like(b), torch.empty_like(b)
    count = torch.zeros((), dtype=torch.int64, device=b.device)
    res = dict(
        shape=[h, w],
        k6_ms=cuda_ms(lambda: cuda_stencil.stencil_step(b, CONWAY, out=k6_out), 50),
        k6_counted_ms=cuda_ms(
            lambda: cuda_stencil.stencil_step(b, CONWAY, out=k6_out, count=count), 50),
        copy_ms=cuda_ms(lambda: out.copy_(b), 50),
    )
    res["copy_bytes_per_s"] = 2 * h * w / (res["copy_ms"] / 1e3)
    res["k6_bytes_per_s"] = 2 * h * w / (res["k6_ms"] / 1e3)
    log(f"K6 beside a byte copy at {h}x{w}: K6 {res['k6_ms']:.4f} ms, counted "
        f"{res['k6_counted_ms']:.4f} ms, byte copy {res['copy_ms']:.4f} ms "
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
    if "--peer" in sys.argv[1:]:
        return peer_main(started)
    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 1: build every kernel from source, in parallel.
    t0 = time.perf_counter()
    build_kernels()
    log(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for k in cuda_build.KERNELS:
        for line in cuda_build.build_log(k).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {k}: {line.strip()}")
    reg_build = {k: reg_build_report(cuda_build.build_log(k))
                 for k in ("ext", "probing", "frontier", "resident", "stencil", "tiled",
                           "tiled_skip")}
    log(f"all fifteen kernels build without spills: "
        f"{ {k: [r['registers'] for r in v.values()] for k, v in reg_build.items()} } registers")
    plan = cuda_packed.tiled_reg_plan((BIG, BIG // 32), 10**6, cuda_adaptive.device_sms(device))
    k1_plan = cuda_packed.resident_reg_plan(16, 512)
    log(f"dynamic shared memory: resident {k1_plan.smem_bytes} B per CTA at 512^2 "
        f"({k1_plan}), as each board's cluster of a K7 stack; tiled {plan.smem_bytes} B per "
        f"block at {BIG}^2 ({plan}, 32x{plan.warps} threads)")

    if "--flagship" in sys.argv[1:]:
        # Path (t) alone, with the kernels just built: no check, timing or
        # result line of the other phases.
        launches = {k: 0 for k in KERNELS}
        step("check_packing", check_packing, device)
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
            log(f"disk at the script's tmp: {shutil.disk_usage(tmp)}")
            flagship = step("flagship_path_t", flagship_path, Path(tmp), launches, device,
                            "--profile" in sys.argv[1:])
        measure.require_headline_stats(flagship)
        print(record({"flagship": flagship, "launches": launches, "card": card}))
        errs = {k: 0 for k in KERNELS}
        print(record({"flagship_kernels": step("flagship_kernels", flagship_kernels, errs,
                                               card_int_rate(), device),
                      "max_abs_err": errs, "card": card}))
        log(f"chip_smoke --flagship: {time.perf_counter() - started:.1f} s in all")
        print(card)
        return 0

    # Phase 2: each kernel against its plain version, bit for bit.
    errs = {k: 0 for k in KERNELS}
    step("check_packing", check_packing, device)
    step("check_resident", check_resident, device, errs)
    step("check_tiled", check_tiled, device, errs)
    boards = step("boards", lambda: {"fresh": packed.pack(board(BIG, BIG, 13, device)),
                                     "settled": settled_board(device)})
    sparse = sparse_packed(BIG, BIG, device)
    step("check_adaptive", check_adaptive, errs, boards, sparse)
    step("check_skip_blocks", check_skip_blocks, device, errs, boards)
    step("check_stencil", check_stencil, device, errs)
    step("check_resident_batched", check_resident_batched, device, errs)
    k8_stacks = step("check_frontier_batched", check_frontier_batched, device, errs)
    ext_cases = step("check_ext", check_ext, device, errs)
    strip_cases = step("check_strips", check_strips, device, errs, boards, sparse)
    strip_cases["plan_less"] = step("check_plan_less_f", check_plan_less, device, errs,
                                    PLAN_LESS, MESH_F, "f")
    mega_cases = step("check_strip_mega", check_strip_mega, device, errs, boards, sparse)
    tiled = tile_boards(boards)
    tile_cases = step("check_tiles", check_tiles, device, errs, tiled)
    tile_cases["plan_less"] = step("check_plan_less_i", check_plan_less, device, errs,
                                   TILE_PLAN_LESS, MESH_I, "i")
    tile_mega_cases = step("check_tile_mega", check_tile_mega, errs, tiled)
    peer_cases = step("check_peer_mega", check_peer_mega, errs, boards, sparse)
    log(f"phase 2 (kernels against their plain versions) done at "
        f"{time.perf_counter() - started:.1f} s")

    # Phase 3: the main paths, with every count set to 0 just before each run.
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        tmp = Path(tmp)
        images = tmp / "images"
        images.mkdir()
        pgm.write_pgm(images / "512x512.pgm", random_soup(512, 512, 0.3, 7))
        packed_ref = dict(engine="packed")
        default = gol.Params(images_dir=images, out_dir=tmp / "default", ticker_period=3600)
        t_paths = time.perf_counter()
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
        STEP_SECONDS["headless_paths"] = round(time.perf_counter() - t_paths, 1)
        e2e.update(step("viewer_paths", viewer_paths, images, tmp, launches, device))
        e2e.update(step("serving_paths", serving_paths, tmp, launches))
        e2e.update(step("sharded_paths", sharded_paths, tmp, straight, launches, device))
        e2e.update(step("mesh_viewer_paths_p", mesh_viewer_paths, tmp, straight, launches,
                        device))
        e2e.update(step("wire_pod_path_q", wire_pod_path, tmp, launches, device))
        e2e.update(step("federation_path_r", federation_path, tmp, launches, device, card))
        e2e.update(step("multihost_path_s", multihost_path, tmp, straight, launches, device,
                        card))
        a = next(v for k, v in e2e.items() if k.startswith("sharded_a_"))
        log(f"sharded (a) on {MESH_A}: {a['gens_per_s']:.1f} gens/s, K9 launches "
            f"{a['launches']['ext']}; single-device {BIG}^2 x 2000: "
            f"{e2e[f'soup_{BIG}x{BIG}x2000']['gens_per_s']:.1f} gens/s")
        long_pgm = (long.out_dir / f"{long.final_output_name}.pgm").read_bytes()
        e2e.update(step("strip_paths", strip_paths, tmp, long_pgm, straight, launches, device))
        e = next(v for k, v in e2e.items() if k.startswith("strips_e_"))
        k = next(v for k, v in e2e.items() if k.startswith("strips_k_"))
        print(f"strip path (e) on {MESH_E}, in-kernel tier: {e['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {e['dispatch_loop_s']:.3f} s, skip fraction "
              f"{e.get('skip_fraction')}; (k), ppermute tier: {k['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {k['dispatch_loop_s']:.3f} s, skip fraction "
              f"{k.get('skip_fraction')}; single-device {BIG}^2 x {LONG_TURNS}: "
              f"{run_long['gens_per_s']:.1f} gens/s, dispatch loop "
              f"{run_long['dispatch_loop_s']:.3f} s, skip fraction "
              f"{run_long.get('skip_fraction')}", flush=True)
        e2e.update(step("tile_paths", tile_paths, tmp, long_pgm, straight, launches, device))
        hh = next(v for k, v in e2e.items() if k.startswith("tiles_h_"))
        ll = next(v for k, v in e2e.items() if k.startswith("tiles_l_"))
        print(f"tile path (h) on {MESH_H}, in-kernel tier: {hh['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {hh['dispatch_loop_s']:.3f} s, skip fraction "
              f"{hh.get('skip_fraction')}; (l), ppermute tier: {ll['gens_per_s']:.1f} gens/s, "
              f"dispatch loop {ll['dispatch_loop_s']:.3f} s, skip fraction "
              f"{ll.get('skip_fraction')}; strip path (e) on {MESH_E}: {e['gens_per_s']:.1f} "
              f"gens/s; single-device {run_long['gens_per_s']:.1f} gens/s", flush=True)
        log(f"phase 3 up to the resilience paths done at {time.perf_counter() - started:.1f} s")
        e2e.update(step("resilience_paths", resilience_paths, tmp, long_pgm, straight,
                        launches, device))
        e2e.update(step("flagship_path_t", flagship_path, tmp, launches, device))
    log(f"phase 3 (main paths) done at {time.perf_counter() - started:.1f} s")

    # Phase 4: time each kernel at the main path's shapes.
    int_rate = card_int_rate()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    v = packed.pack_vertical(board(512, 512, 21, device))
    p = packed.pack(board(BIG, BIG, 22, device))
    k2_plan = cuda_packed.tiled_reg_plan(tuple(p.shape), 10**6, sms)
    t_big = k2_plan.t
    timings = {
        "resident": dict(
            ms=(k1 := cuda_ms_spread(lambda: cuda_packed.resident_superstep(v, CONWAY, 50),
                                     20))["median"],
            plain_ms=cuda_ms(lambda: cuda_packed.resident_superstep_plain(v, CONWAY, 50), 3),
            bound=bound_ms(v.numel(), 50, 1, CONWAY, int_rate),
            extra=dict(ms_spread=k1, plan=dataclasses.asdict(k1_plan), bound_one_sm_ms=bound_ms(
                v.numel(), 50, 1, CONWAY, int_rate / sms)[0], bound_one_cluster_ms=bound_ms(
                v.numel(), 50, 1, CONWAY, int_rate / sms * k1_plan.cluster)[0]),
        ),
        "tiled": dict(
            ms=(k2 := cuda_ms_spread(lambda: cuda_packed.tiled_superstep(p, CONWAY, t_big), 10))[
                "median"],
            extra=dict(ms_spread=k2, plan=dataclasses.asdict(k2_plan), device_ms=device_ms(
                lambda: cuda_packed.tiled_superstep(p, CONWAY, t_big), 10, "tiled_reg_kernel"),
                remainder=dict(gens=16, ms_spread=cuda_ms_spread(
                    lambda: cuda_packed.tiled_superstep(p, CONWAY, 16), 10), bound_ms=bound_ms(
                    p.numel(), 16, 1, CONWAY, int_rate)[0])),
            plain_ms=cuda_ms(lambda: cuda_packed.tiled_superstep_plain(p, CONWAY, t_big), 2),
            bound=bound_ms(p.numel(), t_big, 1, CONWAY, int_rate),
        ),
    }
    # K6 at the viewer paths' shapes, one generation a launch into a
    # preallocated buffer (as a superstep's ping-pong does), without and
    # with its count (a viewer turn's last launch); 16384² leads.
    k6, soups = {}, {n: board(n, n, 23, device) for n in (BIG, 512)}
    for n, b in soups.items():
        out = torch.empty((n, n), dtype=torch.uint8, device=device)
        count = torch.zeros((), dtype=torch.int64, device=device)
        spread_ms = cuda_ms_spread(lambda: cuda_stencil.stencil_step(b, CONWAY, out=out), 50)
        k6[n] = dict(ms=spread_ms["median"], ms_spread=spread_ms,
                     counted_ms=cuda_ms_spread(lambda: cuda_stencil.stencil_step(
                         b, CONWAY, out=out, count=count), 50),
                     plain_ms=cuda_ms(lambda: cuda_stencil.stencil_step_plain(b, CONWAY), 5),
                     run_rows=cuda_stencil.RUN_ROWS,
                     bound=stencil_bound_ms(n, n, int_rate))
    timings["stencil"] = dict(
        ms=k6[BIG]["ms"], plain_ms=k6[BIG]["plain_ms"], bound=k6[BIG]["bound"],
        extra=dict(shape=[BIG, BIG], ms_spread=k6[BIG]["ms_spread"],
                   counted_ms=k6[BIG]["counted_ms"], run_rows=k6[BIG]["run_rows"],
                   at_512=dict(ms=k6[512]["ms"], ms_spread=k6[512]["ms_spread"],
                               counted_ms=k6[512]["counted_ms"], plain_ms=k6[512]["plain_ms"],
                               run_rows=k6[512]["run_rows"], bound_ms=k6[512]["bound"][0],
                               bound_by=k6[512]["bound"][1])))
    k2x = timings["tiled"]["extra"]
    log(f"timed K1 at 512^2 x 50 gens (one launch), K2 at {BIG}^2 x {t_big} gens "
        f"(one launch: {k2['median']:.4f} ms, {k2['min']:.4f}-{k2['max']:.4f}, device "
        f"{k2x['device_ms']:.4f}; {k2_plan}; the 16-generation remainder "
        f"{k2x['remainder']['ms_spread']['median']:.4f}), K6 one generation at {BIG}^2 "
        f"({k6[BIG]['ms']:.4f} ms, "
        f"{k6[BIG]['ms_spread']['min']:.4f}-{k6[BIG]['ms_spread']['max']:.4f}; counted "
        f"{k6[BIG]['counted_ms']['median']:.4f}; bound {k6[BIG]['bound'][0]:.4f} by "
        f"{k6[BIG]['bound'][1]}) and 512^2 ({k6[512]['ms']:.4f} ms); "
        f"int32 rate {int_rate / 1e12:.2f} Tops/s ({sms} SMs, {clock_mhz} MHz); card {card}")
    timings.update(time_batched(k8_stacks, int_rate))
    timings["ext"] = time_ext(ext_cases, int_rate)
    timings.update(time_strips(strip_cases, int_rate))
    timings["strip_mega"] = time_strip_mega(mega_cases, int_rate)
    timings["tile_mega"] = time_tile_mega(tile_mega_cases, tile_cases, int_rate)
    for k, r in peer_entries(peer_cases, time_peer(boards)).items():
        timings[k]["extra"].update(r)
    tiles = time_tiles(tile_cases, int_rate)
    timings["tile_probing"] = tiles["tile_probing"]
    timings["ext"]["extra"]["build"] = {n: r for n, r in reg_build["ext"].items()
                                        if "ext_reg_kernel" in n}
    timings["ext_skip"]["extra"]["build"] = {n: r for n, r in reg_build["ext"].items()
                                             if "ext_skip_reg_kernel" in n}
    timings["resident"]["extra"]["build"] = reg_build["resident"]
    timings["resident_batched"]["extra"]["build"] = reg_build["resident"]
    timings["tiled"]["extra"]["build"] = reg_build["tiled"]
    timings["tile_probing"]["extra"]["build"] = {
        n: r for n, r in reg_build["probing"].items() if "tile_probing_reg_kernel" in n}
    timings["strip_probing"]["extra"]["build"] = {
        n: r for n, r in reg_build["probing"].items() if "strip_probing_reg_kernel" in n}
    timings["stencil"]["extra"]["build"] = reg_build["stencil"]
    timings["ext_skip"]["extra"]["tile_2d"] = tiles["ext_skip_2d"]
    witness = k6_copy_witness(soups[BIG])
    e2e[f"viewer_turn_{BIG}"] = time_viewer_turn(soups[BIG])
    boards["dead"] = torch.zeros_like(boards["fresh"])
    boards["sparse"] = sparse
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

    for k, r in flagship_kernels(errs, int_rate, device).items():
        timings[k]["extra"][f"at_{FLAG}"] = r
    timings["probing"]["extra"]["build"] = {
        n: r for n, r in reg_build["probing"].items() if "board_probing_reg_kernel" in n}
    timings["tiled_skip"]["extra"]["build"] = reg_build["tiled_skip"]
    for k, mangled in FRONTIER_REG.items():
        timings[k].setdefault("extra", {})["build"] = {
            n: r for n, r in reg_build["frontier"].items() if mangled in n}
    kernels = []
    for k, meta in KERNELS.items():
        tm = timings[k]
        b_ms, b_by = tm["bound"]
        kernels.append(dict(
            name=k, **meta, launches=launches[k], max_abs_err=errs[k], identical=True,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **tm.get("extra", {}),
        ))
    measure.require_headline_stats(e2e)  # every run row: {reps, median, spread}
    print(record({"end_to_end": e2e, "card": card}))
    print(record({"k6_copy_witness": witness, "card": card}))
    if "--sweep" in sys.argv[1:]:
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
            print(record({"sweep": sweep(boards, Path(tmp)), "card": card}))
    if "--profile" in sys.argv[1:]:
        runs = [(2000, BIG, {}), (LONG_TURNS, BIG, {}), (FLIP_TURNS, 512, dict(no_vis=False)),
                (FRAME_TURNS, BIG, dict(no_vis=False)),
                (VIEW_TURNS, BIG, dict(no_vis=False, viewport=VIEWPORT))]
        for turns, side, viewer in runs:
            print(record({"profile": profile_run(turns, side, **viewer), "card": card}))
        print(record({"profile": profile_run(2000, BIG, virtual(MESH_A, device),
                                                 mesh_shape=MESH_A), "card": card}))
        print(record({"profile": profile_run(LONG_TURNS, BIG, virtual(MESH_E, device),
                                                 mesh_shape=MESH_E), "card": card}))
        with dgol_ici("0"):  # path (k): K12 with the exchange between launches
            print(record({"profile": profile_run(LONG_TURNS, BIG, virtual(MESH_E, device),
                                                     mesh_shape=MESH_E), "card": card}))
        print(record({"profile": profile_run(LONG_TURNS, BIG, virtual(MESH_H, device),
                                                 mesh_shape=MESH_H), "card": card}))
    print(record({"step_seconds": STEP_SECONDS, "card": card}))
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, kernel builds included")
    print(record({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
