"""The device execution backend: a device-resident uint8 board plus the
engine that advances it.

PyTorch counterpart of ``distributed_gol_tpu/engine/backend.py`` for one
device, with the surface the controller calls: board placement
(``put``/``fetch``/``fetch_many``), the dispatch seam (``run_turns_async``:
an unsynced superstep plus an unsynced 0-d alive count that ``int()``
forces), the per-turn viewer dispatches (``run_turn_with_flips``,
``run_turn_with_frame``, ``run_turn_with_viewport``, ``fetch_viewport``,
``probe_frame_fetch``), the SDC probe, the whole-board cycle probes, and
the adaptive (``skip_stable``) tier's skip telemetry (``skip_fraction``,
``activity_bitmap``).  Engine selection mirrors the
JAX package's ``_resolve_single``, ``_resolve_sharded`` and
``_ENGINE_RANK``; every engine is bit-identical, so a fallback changes
speed, never results — and a slower tier than the one asked for is warned
about, never silent.

On a mesh (``Params.mesh_shape != (1, 1)``) the board is a
``parallel.halo.ShardedBoard``, one uint8 shard per mesh device, and the
same surface serves it: ``put`` scatters, ``fetch`` gathers, the alive
count is the sum of the shards' counts, and the engines are the sharded
roll (``parallel/halo.py``), packed (``parallel/packed_halo.py``) and
temporally blocked (``parallel/cuda_halo.py``: K9, and with
``skip_stable`` the adaptive kernels K10-K12 and K14 on a row mesh and K10,
K13 and K15 on a 2-D mesh, with the same skip telemetry over the whole
mesh) forms.  The controller
never touches the board itself, only these methods.  On a row mesh that
spans processes (``parallel/multihost.py``'s backend) the same methods
are collectives: ``put`` keeps this rank's band, ``fetch`` allgathers,
and the alive count, the fingerprint, the cycle probe's verdict, the
skip count and the activity cover every rank's strips.

:class:`BatchedBackend` is the board-stack form behind the same seam: B
same-shape boards per dispatch, the serving plane's cohort launch.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.ops import cuda_adaptive, cuda_packed, cuda_stencil, packed, stencil
from distributed_gol_torch.parallel import cuda_halo, halo, packed_halo
from distributed_gol_torch.parallel import mesh as mesh_lib
from distributed_gol_torch.utils.device import kernels_native, resolve_device


def _board_fingerprint(bo: torch.Tensor, y0: int = 0, x0: int = 0) -> torch.Tensor:
    """Position-weighted rolling hash of a board (mod 2^32) — the JAX
    package's SDC fingerprint, computed in int64 and reduced mod 2^32 so
    the two packages agree on every board.  ``bo`` may be the block at
    (y0, x0) of a larger board: the hash is a sum of per-cell terms, so
    the blocks' hashes add up to the board's, which is also how it is
    computed, a row block at a time (``stencil.row_blocks``: each cell's
    term is an int64)."""
    hh, ww = bo.shape
    dev = bo.device
    wx = ((torch.arange(ww, dtype=torch.int64, device=dev) + x0) * 2246822519) & 0xFFFFFFFF
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for r0, r1 in stencil.row_blocks(hh, ww):
        wy = ((torch.arange(r0, r1, dtype=torch.int64, device=dev) + y0) * 2654435761) & 0xFFFFFFFF
        terms = (wy[:, None] ^ wx).mul_(bo[r0:r1] != 0)
        total = (total + terms.sum()) & 0xFFFFFFFF
    return total


def _alive_count(board) -> torch.Tensor:
    """Unsynced alive count of a board or a sharded board (the sum of its
    shards' counts, on the first shard's device)."""
    return halo.as_board(board).reduce(lambda t, y0, x0: stencil.alive_count(t))


def _flip_bits(prev, new) -> torch.Tensor:
    """``stencil.packbits`` of the flip mask between two boards, whole or
    sharded on one mesh, on the (first shard's) device.  A mesh's shards
    pack their own masks when their width is a multiple of 8, so their
    bytes concatenate; otherwise each band of shards is put together
    before it is packed."""
    if not isinstance(prev, halo.ShardedBoard):
        return stencil.packbits(stencil.flip_mask(prev, new))
    dev = prev.shards[0][0].device
    own = prev.shard_shape[1] % 8 == 0
    bands = []
    for before, after in zip(prev.shards, new.shards):
        masks = [stencil.flip_mask(a, b) for a, b in zip(before, after)]
        if own:
            bands.append(torch.cat([stencil.packbits(m).to(dev) for m in masks], dim=1))
        else:
            bands.append(stencil.packbits(torch.cat([m.to(dev) for m in masks], dim=1)))
    return torch.cat(bands, dim=0)


class Backend:
    """Holds the step program of one (rule, engine, device) configuration.

    ``params.engine`` requests an engine; ``self.engine_used`` records what
    actually runs after capability fallbacks (the packed engines need
    W % 32 == 0, the byte kernel W % 4 == 0).  "auto" takes the
    hand-written kernels on a CUDA device of compute capability 9.0 — the
    packed tier for multi-generation dispatches, the byte kernel (K6) for
    per-turn ones — and the plain engines elsewhere.

    ``devices`` places the board: on one device its first entry, on a mesh
    the mesh's devices in row-major order (a device may repeat: a virtual
    mesh, all shards on one card).  None takes the device of
    ``params.device`` (the first healthy one of its kind once it is
    blacklisted), or on a mesh the healthy CUDA devices
    (``parallel.mesh.make_mesh``, which raises when there are too few) —
    or, with ``device="cpu"``, the CPU for every shard.

    ``in_kernel=False`` forces the ppermute exchange tier of a sharded
    ``skip_stable`` run (``DGOL_ICI=0`` is the CLI's spelling of it);
    ``True`` outranks the environment switch but no capability
    (``parallel.cuda_halo.tier_policy``)."""

    # The halo-exchange tier of the sharded pallas-packed engine and the
    # policy that picked it (None off that engine and mesh).
    sharded_tier = None
    sharded_tier_policy = None
    # The pallas engine's counted superstep (K6 counts the board its last
    # launch writes; cuda_stencil.make_counted_superstep); None elsewhere.
    _counted = None
    # Called with each adaptive dispatch's (skipped, stripe-launches,
    # activity) as the skip telemetry keeps it, device values unread (the
    # cycle probes are not dispatches); None: no one listens.
    skip_listener = None

    def __init__(self, params: Params, devices=None, in_kernel: bool | None = None):
        self.params = params
        self.device = resolve_device(params.device)
        if devices:
            devices = [torch.device(d) for d in devices]
            if any(d.type != self.device.type for d in devices):
                raise ValueError(
                    f"devices {[str(d) for d in devices]} are not all of the "
                    f"requested device type {params.device!r}"
                )
            self.device = devices[0]
        elif params.mesh_shape == (1, 1) and not mesh_lib.healthy_devices([self.device]):
            # A blacklisted default device is sidestepped for the first
            # healthy one of its kind, so a supervisor rebuild after
            # condemning it genuinely moves off it; an explicit device pins
            # regardless.
            kind = self.device.type
            healthy = mesh_lib.healthy_devices(mesh_lib.device_pool(kind))
            if not healthy:
                raise ValueError(
                    f"every {kind} device is blacklisted "
                    f"({sorted(mesh_lib.blacklisted(kind))}); no healthy device to build on"
                )
            self.device = healthy[0]
        shape = (params.image_height, params.image_width)
        ny, nx = params.mesh_shape
        if shape[0] % ny or shape[1] % nx:
            raise ValueError(
                f"mesh {params.mesh_shape} does not divide board {shape[0]}x{shape[1]}"
            )
        if params.engine == "pallas" and (ny, nx) != (1, 1):
            raise NotImplementedError(
                "engine='pallas' is single-device for now; sharded meshes use "
                "engine='pallas-packed', 'packed', or 'roll'"
            )
        self.mesh = None
        if (ny, nx) != (1, 1):
            self._init_sharded(params, shape, devices, in_kernel)
            return
        self.devices = [self.device]
        self.table = stencil.rule_table(params.rule, self.device)
        self.engine_used = self._resolve_single(params, shape, self.device)
        self._warn_if_downgraded(params, shape, (1, 1))
        if self.engine_used == "pallas-packed":
            if self._skip_engages(params, shape):
                # The adaptive tier with live skip telemetry; cap 0 = the
                # port's default stripe cap.
                self._skip_cap = params.skip_tile_cap or cuda_adaptive.SKIP_TILE_CAP
                self._skip_fn = cuda_packed.make_superstep_bytes(
                    params.rule, self.device, skip_stable=True,
                    skip_tile_cap=self._skip_cap, with_stats=True,
                )
                self._skip_stats = []
                self._superstep = self._skip_superstep
            else:
                self._superstep = cuda_packed.make_superstep_bytes(params.rule, self.device)
        elif self.engine_used == "packed":
            self._superstep = packed.make_superstep(params.rule)
        elif self.engine_used == "pallas":
            self._superstep = cuda_stencil.make_superstep(params.rule)
            self._counted = cuda_stencil.make_counted_superstep(params.rule)
        else:
            self._superstep = lambda b, k: stencil.superstep(b, self.table, k)
        self._init_metrics(params)

    def _init_sharded(self, params: Params, shape: tuple[int, int], devices,
                      in_kernel: bool | None) -> None:
        """The sharded branch: a mesh over ``devices`` (see the class
        docstring), the board split over it, and the sharded form of the
        engine that runs."""
        mesh_shape = params.mesh_shape
        if devices is None and self.device.type == "cpu":
            devices = [self.device] * (mesh_shape[0] * mesh_shape[1])
        self.mesh = self._make_mesh(mesh_shape, devices)
        self.devices = self.mesh.flat
        self.device = self.devices[0]
        self._sharding = halo.board_sharding(self.mesh)
        self.table = stencil.rule_table(params.rule, self.device)
        self.engine_used = self._resolve_sharded(params, shape, mesh_shape, self.device)
        self._warn_if_downgraded(params, shape, mesh_shape)
        if self.engine_used == "pallas-packed":
            # T-deep halos: one exchange a launch buys T generations, by
            # tensor copies.  skip_stable runs the adaptive strip tier on a
            # row mesh and the adaptive tile tier on a 2-D mesh, with live
            # skip telemetry; cap 0 = the port's default stripe cap.  On a
            # mesh whose strips or tiles share one card, or lie on cards
            # of this process that reach each other (the peer form), the
            # policy may pick the in-kernel exchange tier (K14 or K15
            # chunks); when
            # it does not, the ppermute form is a policy outcome, recorded
            # here and never warned about: both tiers give the same
            # boards.  The policy is asked once, here: its answer goes
            # down to the engine as in_kernel, so the tier that runs is
            # the tier recorded.
            self.sharded_tier = "ppermute"
            if params.skip_stable_requested():
                ny, nx = mesh_shape
                self._skip_cap = params.skip_tile_cap or cuda_adaptive.SKIP_TILE_CAP
                use_ici, self.sharded_tier_policy = cuda_halo.tier_policy(
                    self.mesh, strip=(shape[0] // ny, shape[1] // 32 // nx),
                    tile_cap=self._skip_cap, in_kernel=in_kernel,
                )
                if use_ici:
                    self.sharded_tier = "ici-megakernel"
                self._skip_fn = cuda_halo.make_superstep_bytes(
                    self.mesh, params.rule, skip_stable=True, skip_tile_cap=self._skip_cap,
                    with_stats=True, in_kernel=use_ici,
                )
                self._skip_stats = []
                self._superstep = self._skip_superstep
            else:
                self.sharded_tier_policy = (
                    "plain (non-adaptive) path: the in-kernel tier rides the "
                    "frontier kernel, which needs skip_stable"
                )
                self._superstep = cuda_halo.make_superstep_bytes(self.mesh, params.rule)
        elif self.engine_used == "packed":
            self._superstep = packed_halo.make_superstep_bytes(self.mesh, params.rule)
        else:
            roll = halo.sharded_superstep(self.mesh)
            self._superstep = lambda b, k: roll(b, self.table, k)
        self._init_metrics(params)

    def _make_mesh(self, mesh_shape: tuple[int, int], devices) -> mesh_lib.Mesh:
        """The mesh a sharded board lies on: a seam, which the multi-host
        backend (``parallel/multihost.py``) fills with its
        process-spanning row mesh."""
        return mesh_lib.make_mesh(mesh_shape, devices)

    def _init_metrics(self, params: Params):
        """A dispatch counter bumped on the seam, the engine label and, on a
        mesh's pallas-packed engine, the exchange tier and its policy."""
        from distributed_gol_torch.obs import metrics as obs_metrics

        # Run-scoped reset on the real registry, whatever this run's
        # metrics flag: an earlier run's labels must not leak into later
        # snapshots.
        obs_metrics.REGISTRY.clear_labels("backend.")
        reg = obs_metrics.registry_for(params.metrics)
        self._m_dispatches = reg.counter(f"backend.dispatches.{self.engine_used}")
        reg.info("backend.engine", self.engine_used)
        if self.sharded_tier is not None:
            reg.info("backend.sharded_tier", self.sharded_tier)
            reg.info("backend.sharded_tier_policy", self.sharded_tier_policy)
        # One bump per viewport device program dispatched
        # (fetch_viewport / run_turn_with_viewport).
        self._m_viewport_fetches = reg.counter("backend.viewport_fetches")
        if getattr(self, "_skip_fn", None) is not None:
            reg.gauge_fn("backend.skip_fraction", self.skip_fraction)
            reg.gauge_fn("backend.active_tiles", self._active_tiles)

    # -- the adaptive (skip_stable) tier ----------------------------------------
    @staticmethod
    def _skip_engages(params: Params, shape: tuple[int, int]) -> bool:
        """Whether the adaptive tier runs this board, as the JAX Backend
        decides it: ``skip_stable`` requested (auto: long headless runs) on
        a shape the tier takes — but "auto" never trades the resident
        kernel (K1) for it, an explicit request on a K1 board warns, and so
        does a rule whose ash period the stability window cannot cover."""
        h, w = shape
        engages = params.skip_stable_requested() and cuda_adaptive.supports((h, w // 32))
        if engages and cuda_packed.resident_shape(h, w) is not None:
            if params.skip_stable is None:
                return False
            warnings.warn(
                "skip_stable forces the tiled kernels on a board eligible for the "
                "resident fast path; unless the board is mostly ash this is slower",
                stacklevel=3,
            )
        if engages and not cuda_adaptive.skip_covers_rule(params.rule):
            warnings.warn(
                f"skip_stable engaged for rule {params.rule.notation} whose ash "
                f"period is {params.rule.ash_period} — the kernels' "
                f"period-{cuda_adaptive.SKIP_PERIOD} stability window cannot "
                "cover its settled debris, so stripes are unlikely to ever skip",
                stacklevel=3,
            )
        return engages

    def _skip_superstep(self, board: torch.Tensor, turns: int) -> torch.Tensor:
        """The adaptive tier with live skip telemetry: each dispatch's
        (skipped, stripe-launches, activity) is kept, device values unread,
        for :meth:`skip_fraction` and :meth:`activity_bitmap`.  On a mesh
        the stripe-launches and the activity span every shard: the strips
        top to bottom, on a 2-D mesh every (stripe, x-tile) cell."""
        new_board, skipped, act = self._skip_fn(board, turns)
        h, w = self.params.image_height, self.params.image_width
        if self.mesh is not None:
            total = cuda_halo.adaptive_strip_launches(
                (h, w // 32), self.params.mesh_shape, turns, self._skip_cap)
        else:
            total = cuda_adaptive.adaptive_tile_launches((h, w // 32), turns, self._skip_cap)
        if total:
            self._skip_stats.append((skipped, total, act))
            del self._skip_stats[:-3]
            if self.skip_listener is not None:
                self.skip_listener(skipped, total, act)
        return new_board

    def _device_superstep(self, board: torch.Tensor, turns: int) -> torch.Tensor:
        """The superstep without the skip-stats bookkeeping: the cycle
        probes run it, so they never shift which dispatch ``stats[-3]``
        is."""
        if getattr(self, "_skip_fn", None) is not None:
            return self._skip_fn(board, turns)[0]
        return self._superstep(board, turns)

    def skip_fraction(self) -> float | None:
        """The skip fraction of the newest dispatch at least two dispatches
        old, or None before there is one (or off the adaptive tier).  The
        numerator is the frontier kernel's skipped stripe-launches plus the
        probing kernel's stable flags after each launch (elided stripes
        included); the denominator is the dispatch's stripe-launches.  Only
        that entry is forced with ``int()``: the pipelined controller keeps
        at most one dispatch in flight, so reading this never stalls it."""
        stats = getattr(self, "_skip_stats", None)
        if not stats or len(stats) < 3:
            return None
        skipped, total, _act = stats[-3]
        return int(skipped) / total

    def activity_bitmap(self) -> np.ndarray | None:
        """Per-stripe activity of the same dispatch as :meth:`skip_fraction`:
        a bool vector, one entry per row stripe from the top, True where
        the stripe saw activity — measured by the frontier kernel (gen T + 6
        differs from gen T somewhere), conservatively (not proved stable)
        by the probing kernel.  Period-6 ash reads inactive.  A 2-D mesh
        records the (ny·grid, nx) grid of (stripe, x-tile) cells; its
        bitmap is the any-over-x, a stripe active where any of its tiles
        was.  None before there is one, or off the adaptive tier."""
        stats = getattr(self, "_skip_stats", None)
        if not stats or len(stats) < 3:
            return None
        act = np.asarray(torch.as_tensor(stats[-3][2]).cpu().numpy())
        if act.size == 0:
            return None
        if act.ndim == 2:
            return (act > 0).any(axis=1)
        return act > 0

    def _active_tiles(self) -> float | None:
        """The ``backend.active_tiles`` gauge: True entries of
        :meth:`activity_bitmap` (None while it is unavailable)."""
        bm = self.activity_bitmap()
        if bm is None:
            return None
        return float(int(bm.sum()))

    def activity_tile_rows(self) -> int | None:
        """Board rows per entry of :meth:`activity_bitmap` (None while it is
        unavailable): the stripes tile the whole board."""
        bm = self.activity_bitmap()
        if bm is None:
            return None
        return self.params.image_height // len(bm)

    # Speed tier of each engine; a capability fallback moves DOWN this
    # ranking, and must not be silent.
    _ENGINE_RANK = {"roll": 0, "pallas": 1, "packed": 2, "pallas-packed": 3}

    def _warn_if_downgraded(self, params: Params, shape, mesh_shape):
        """Warn whenever the engine that runs is a slower tier than the one
        requested (explicit engine) or the one "auto" aims for.  Choices
        "auto" makes by policy (roll for per-turn dispatches, for widths no
        packed engine takes and for shards narrower than one word; packed
        off the card) stay silent."""
        ny, nx = mesh_shape
        if params.engine == "auto":
            if params.runtime_superstep() == 1 or shape[1] % 32 or shape[1] // nx < 32:
                return
            preferred = "packed"
            if kernels_native(self.device) and (
                nx == 1 or cuda_halo.supports((shape[0], shape[1] // 32), mesh_shape)
            ):
                preferred = "pallas-packed"
            if self._ENGINE_RANK[self.engine_used] >= self._ENGINE_RANK[preferred]:
                return
            requested = f"auto (prefers '{preferred}' here)"
        else:
            if self.engine_used == params.engine:
                return
            requested = f"'{params.engine}'"
        if (ny, nx) == (1, 1):
            where, why = f"{self.device}", "(bit-identical but a slower tier)"
        else:
            where = f"mesh {ny}x{nx}"
            why = ("(bit-identical but a slower tier — see the README engine x "
                   "mesh capability matrix)")
        warnings.warn(
            f"engine {requested} cannot run {shape[1]}x{shape[0]} on {where}; "
            f"falling back to '{self.engine_used}' {why}",
            RuntimeWarning,
            stacklevel=3,
        )

    @staticmethod
    def _packed_kernel_upgrade(params: Params, device, supports_fn=lambda: True) -> bool:
        """Whether the packed engine upgrades to its hand-written kernel
        form: explicit "pallas-packed" on every device (the wrappers run
        their plain versions on a CPU tensor), "auto" only on a CUDA device
        of compute capability 9.0; and then only where ``supports_fn()``,
        the kernel's gate, takes the board."""
        want = params.engine == "pallas-packed" or (
            params.engine == "auto" and kernels_native(device)
        )
        return want and supports_fn()

    @staticmethod
    def _resolve_single(params: Params, shape: tuple[int, int], device) -> str:
        """Requested engine -> the engine that runs, capability-gated and
        always ending at the roll stencil.  Explicit "pallas-packed" and
        "pallas" are honoured on every device (the wrappers run their plain
        versions on a CPU tensor); "auto" upgrades to the kernels only on a
        CUDA device of compute capability 9.0."""
        if params.engine == "roll":
            return "roll"
        if params.engine in ("packed", "pallas-packed", "auto"):
            # The byte drivers pack and unpack around every dispatch, which
            # only pays over multi-generation supersteps: per-turn
            # dispatches (the viewers) skip the packed engines under "auto".
            per_turn = params.runtime_superstep() == 1
            if packed.supports(shape) and not (params.engine == "auto" and per_turn):
                if Backend._packed_kernel_upgrade(
                    params, device, lambda: cuda_packed.supports(shape)
                ):
                    return "pallas-packed"
                return "packed"
            if params.engine in ("packed", "pallas-packed"):
                return "roll"
        # engine == "pallas", or "auto" per-turn or on a width no packed
        # engine takes.
        if cuda_stencil.supports(shape) and (
            params.engine == "pallas" or kernels_native(device)
        ):
            return "pallas"
        return "roll"

    @staticmethod
    def _resolve_sharded(
        params: Params, shape: tuple[int, int], mesh_shape: tuple[int, int], device
    ) -> str:
        """Requested engine -> the engine that runs on a mesh: K9's
        temporally blocked form ("pallas-packed"; "auto" only on a CUDA
        device of compute capability 9.0), then the per-turn packed
        word-halo engine, then roll — all bit-identical."""
        if params.engine == "roll":
            return "roll"
        # Per-turn dispatches never amortise packing or temporal blocking.
        if params.engine == "auto" and params.runtime_superstep() == 1:
            return "roll"
        if not packed_halo.supports(shape, mesh_shape):
            return "roll"
        # K9's gate (cuda_halo.supports) takes every board the word-halo
        # engine takes.
        if Backend._packed_kernel_upgrade(params, device):
            return "pallas-packed"
        return "packed"

    # -- board placement -------------------------------------------------------
    def put(self, board: np.ndarray):
        """The host board onto the device, or split over the mesh."""
        t = torch.from_numpy(np.ascontiguousarray(board, dtype=np.uint8))
        if self.mesh is not None:
            return self._sharding.shard(t)
        return t.to(self.device)

    def fetch(self, board) -> np.ndarray:
        """The whole board on the host (a sharded board gathered)."""
        return halo.as_board(board).gather("cpu").numpy()

    def fetch_many(self, *arrays):
        """Several device values to numpy (scalars as 0-d arrays), one copy
        to the host each."""
        return [np.asarray(self.fetch(a)) for a in arrays]

    # -- per-turn viewer dispatches ----------------------------------------------
    # Each is one synchronous dispatch: the generations, then the view (flip
    # mask, pooled frame or viewport crop), the alive count and a bit-pack
    # on the device, so only the packed view and the count cross to the
    # host.  They go through ``_device_superstep``, never the skip-stats
    # bookkeeping.

    @staticmethod
    def normalize_rect(rect, h: int, w: int) -> tuple[int, int, int, int]:
        """Validate and canonicalise a viewport rect ``(y0, x0, vh, vw)``:
        anchors wrap onto the torus (any int is legal), sizes must fit the
        board."""
        y0, x0, vh, vw = (int(v) for v in rect)
        if not (1 <= vh <= h and 1 <= vw <= w):
            raise ValueError(
                f"viewport {vh}x{vw} does not fit board {w}x{h} "
                "(sizes must be within the board; the rect may wrap, "
                "its extent may not exceed the torus)"
            )
        return y0 % h, x0 % w, vh, vw

    @staticmethod
    def _unpack(bits: np.ndarray, cols: int) -> np.ndarray:
        """A fetched bit-packed view as uint8 {0, 255} cells."""
        return np.unpackbits(bits, axis=-1, count=cols) * np.uint8(255)

    def fetch_viewport(self, board, rect) -> np.ndarray:
        """Only the rect ``(y0, x0, vh, vw)`` of the board (toroidal wrap
        included) as a uint8 (vh, vw) array: the crop is bit-packed on the
        device, so ``ceil(vw/8)·vh`` bytes cross to the host.  On a mesh
        the crop is put together from the shards it covers
        (``ShardedBoard.window``), never from a gathered board."""
        h, w = self.params.image_height, self.params.image_width
        y0, x0, vh, vw = self.normalize_rect(rect, h, w)
        self._m_viewport_fetches.inc()
        bits = self.fetch(stencil.packbits(halo.as_board(board).window(y0, x0, vh, vw)))
        return self._unpack(bits, vw)

    def _counted_superstep(self, board, turns: int):
        """(board after ``turns`` generations, its unsynced alive count):
        on the pallas engine K6 counts the board its last launch writes,
        elsewhere the count is a separate sum of the board (on a mesh the
        sum of the shards' counts)."""
        if self._counted is not None:
            return self._counted(board, turns)
        new_board = self._device_superstep(board, turns)
        return new_board, _alive_count(new_board)

    def _fetch_count(self, board) -> torch.Tensor:
        """The device count a viewer turn fetches beside its view, without
        a turn: on the pallas engine an int64 scalar as K6's counter is
        (made and fetched, no sum of the board, which the turn no longer
        runs), elsewhere the board's alive count."""
        if self._counted is not None:
            return torch.zeros((), dtype=torch.int64, device=board.device)
        return _alive_count(board)

    def run_turn_with_flips(self, board) -> tuple[object, int, np.ndarray]:
        """One generation, returning (board, alive count, (n, 2) array of
        the flipped cells' (y, x)).  The diff is taken on the device
        (``stencil.flip_mask``) and bit-packed; the host unpacks it."""
        new_board, count = self._counted_superstep(board, 1)
        bits = _flip_bits(board, new_board)
        count, bits = self.fetch_many(count, bits)
        ys, xs = np.nonzero(np.unpackbits(bits, axis=-1, count=self.params.image_width))
        return new_board, int(count), np.stack([ys, xs], axis=1)

    def run_turn_with_frame(
        self, board, fy: int, fx: int, turns: int = 1
    ) -> tuple[object, int, np.ndarray]:
        """``turns`` generations (the frame stride), returning (board, alive
        count, the last generation max-pooled by (fy, fx) on the device;
        on a mesh shard by shard, ``ShardedBoard.pool``)."""
        new_board, count = self._counted_superstep(board, turns)
        bits = stencil.packbits(halo.as_board(new_board).pool(fy, fx))
        count, bits = self.fetch_many(count, bits)
        return new_board, int(count), self._unpack(bits, -(-self.params.image_width // fx))

    def run_turn_with_viewport(
        self, board, rect, fy: int, fx: int, turns: int = 1
    ) -> tuple[object, int, np.ndarray]:
        """The viewport form of :meth:`run_turn_with_frame`: the pooled
        frame covers only the rect ``(y0, x0, vh, vw)``, so a frame's cost
        scales with the viewport, not the board."""
        h, w = self.params.image_height, self.params.image_width
        y0, x0, vh, vw = self.normalize_rect(rect, h, w)
        self._m_viewport_fetches.inc()
        new_board, count = self._counted_superstep(board, turns)
        pooled = stencil.frame_pool(halo.as_board(new_board).window(y0, x0, vh, vw), fy, fx)
        count, bits = self.fetch_many(count, stencil.packbits(pooled))
        return new_board, int(count), self._unpack(bits, -(-vw // fx))

    def probe_frame_fetch(self, board, fy: int, fx: int, rect=None) -> None:
        """One frame fetch without advancing the simulation: the pool (of
        the viewport ``rect`` when given), count, bit-pack and host copy of
        :meth:`run_turn_with_frame` / :meth:`run_turn_with_viewport`, minus
        the generations (on the pallas engine, whose count comes from K6,
        minus the count's work too: ``_fetch_count``).  The controller
        times it to size the frame stride."""
        whole = halo.as_board(board)
        if rect is None:
            pooled = whole.pool(fy, fx)
        else:
            h, w = self.params.image_height, self.params.image_width
            y0, x0, vh, vw = self.normalize_rect(rect, h, w)
            pooled = stencil.frame_pool(whole.window(y0, x0, vh, vw), fy, fx)
        self.fetch_many(self._fetch_count(board), stencil.packbits(pooled))

    # -- compute ---------------------------------------------------------------
    def run_turns_async(
        self, board: torch.Tensor, turns: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Issue ``turns`` generations WITHOUT waiting for them: returns
        (board, count) where the count is an unsynced 0-d tensor.  CUDA work
        is asynchronous, so the controller may issue the next superstep
        before forcing this one's count with ``int()``."""
        self._m_dispatches.inc()
        if turns == 0:
            return board, _alive_count(board)
        new_board = self._superstep(board, turns)
        return new_board, _alive_count(new_board)

    def run_turns(self, board: torch.Tensor, turns: int) -> tuple[torch.Tensor, int]:
        """Advance ``turns`` generations; returns (board, alive count after
        the last turn), synchronised."""
        new_board, count = self.run_turns_async(board, turns)
        return new_board, int(count)

    def count(self, board) -> int:
        return int(_alive_count(board))

    # -- SDC sentinel probe (Params.sdc_check_every_turns) ---------------------
    # Sampled-stripe height of the redundant recompute on the roll stencil,
    # the independent formulation; the recompute needs a ``turns``-row halo
    # on each side (the light cone of one dispatch).
    _SDC_STRIPE_ROWS = 64
    # Deepest dispatch the stripe recompute replays; deeper ones run the
    # popcount/fingerprint leg only.
    _SDC_MAX_STRIPE_TURNS = 512

    def sdc_stripe_affordable(self, turns: int) -> bool:
        """Whether the stripe recompute stays a bounded, sampled check for a
        ``turns``-deep dispatch."""
        return turns <= self._SDC_MAX_STRIPE_TURNS

    def sdc_probe(
        self,
        board_in: torch.Tensor,
        board_out: torch.Tensor,
        turns: int,
        y0: int,
        *,
        stripe: bool = True,
    ) -> tuple[bool, int, int]:
        """One SDC check of a resolved dispatch (``board_in`` --turns-->
        ``board_out``): ``(stripe_ok, popcount, fingerprint)``.
        ``stripe_ok``: recomputing the dispatch on the row stripe starting
        at ``y0`` (toroidal window, exact by light-cone containment) through
        the roll stencil reproduces ``board_out`` there; vacuously True with
        ``stripe=False``.  ``popcount``: alive count of ``board_out``.
        ``fingerprint``: its rolling hash.  On a mesh the popcount and the
        fingerprint are sums of per-shard terms, and only the stripe's
        window rows are copied onto the first shard's device."""
        board_in, board_out = halo.as_board(board_in), halo.as_board(board_out)
        pop = _alive_count(board_out)
        fp = board_out.reduce(_board_fingerprint) & 0xFFFFFFFF
        if not stripe:
            return True, int(pop), int(fp)
        h = self.params.image_height
        rows = min(h, self._SDC_STRIPE_ROWS)
        pad = turns
        window_rows = min(h, rows + 2 * pad)
        # Window rows y0-pad .. y0-pad+window_rows-1 (toroidal).  After
        # ``turns`` toroidal steps rows pad..pad+rows-1 are exact: the
        # window's own wrap is outside their light cone, or the window IS
        # the whole rolled board, whose wrap is the true torus.
        stepped = stencil.superstep(board_in.rows(y0 - pad, window_rows), self.table, turns)
        if window_rows == h:
            ok = torch.equal(stepped, board_out.rows(y0 - pad, h))
        else:
            ok = torch.equal(stepped[pad : pad + rows], board_out.rows(y0, rows))
        return bool(ok), int(pop), int(fp)

    # -- whole-board cycle detection (Params.cycle_check) ----------------------
    # Probe depth for rules with no established ash census: lcm(1, 2, 3).
    _CYCLE_PERIOD = 6

    @property
    def cycle_period(self) -> int:
        """The probe depth: the rule's ash period when known, else 6.  The
        probe verifies ``step(board, p) == board``, so any depth is exact."""
        return self.params.rule.ash_period or self._CYCLE_PERIOD

    def cycle_probe_async(self, board: torch.Tensor) -> torch.Tensor:
        """Issue (without waiting) the periodicity check: an unsynced 0-d
        bool tensor, true iff advancing ``cycle_period`` generations
        reproduces ``board``; ``bool()`` forces it."""
        return halo.as_board(self._device_superstep(board, self.cycle_period)).equal(board)

    def cycle_counts(self, board: torch.Tensor) -> np.ndarray:
        """Alive counts of the cycle phases: entry i is the count after
        i+1 generations from ``board``."""
        counts = []
        for _ in range(self.cycle_period):
            board = self._device_superstep(board, 1)
            counts.append(_alive_count(board))
        return torch.stack(counts).cpu().numpy()


class _SharedCounts:
    """One host copy for a whole cohort round's count vector: the first
    member to force its count resolves all of them (idempotent, double-
    checked under a lock), so a 16-member round pays one device sync
    instead of sixteen.  Slots are ``__int__``-protocol objects, what the
    controller's count forcing already speaks at the dispatch seam."""

    __slots__ = ("_counts", "_values", "_lock")

    def __init__(self, counts: torch.Tensor):
        self._counts = counts
        self._values = None
        self._lock = threading.Lock()

    def resolve(self) -> list[int]:
        if self._values is None:
            with self._lock:
                if self._values is None:
                    self._values = [int(v) for v in self._counts.cpu().tolist()]
                    self._counts = None  # free the device vector
        return self._values


class _SlotCount:
    """One board's alive count inside a :class:`_SharedCounts` round."""

    __slots__ = ("_shared", "_i")

    def __init__(self, shared: _SharedCounts, i: int):
        self._shared = shared
        self._i = i

    def __int__(self) -> int:
        return self._shared.resolve()[self._i]


class BatchedBackend:
    """One engine for B same-shape boards: the board-stack analogue of
    :class:`Backend` behind the same dispatch seam.
    ``run_turns_async(stack, turns)`` advances a (B, H, W) uint8 stack and
    returns it with a per-board alive-count vector; :meth:`run_boards` is
    the list-in/list-out form the serving plane's coalescer launches
    through: one stack, one batched dispatch, per-slot views out, and one
    count vector that the first ``int()`` fetches for the whole round.

    Engine forms, ranked as :class:`Backend` ranks them per slot:
    ``pallas-packed`` = the batched kernels (K7 for boards of one block's
    shared memory, K8 for tiled boards with a frontier plan:
    ``cuda_adaptive.batched_supports``), ``packed`` = the plain batched SWAR
    engine, ``roll`` = the stencil per slot.  Every form is bit-identical
    per slot to B independent runs, so cohorts regroup freely.  Single
    device by design: batching amortises per-launch overhead of small
    boards."""

    def __init__(self, params: Params):
        if params.mesh_shape != (1, 1):
            raise NotImplementedError(
                "BatchedBackend is single-device: batch small boards, "
                "shard big ones (mesh_shape must be (1, 1))"
            )
        self.params = params
        self.device = resolve_device(params.device)
        self.table = stencil.rule_table(params.rule, self.device)
        shape = (params.image_height, params.image_width)
        self.engine_used = self._resolve(params, shape, self.device)
        if self.engine_used == "pallas-packed":
            self._stack_fn = cuda_packed.make_batched_superstep_bytes(
                params.rule, self.device, params.skip_tile_cap
            )
        elif self.engine_used == "packed":
            self._stack_fn = packed.make_batched_superstep(params.rule)
        else:
            self._stack_fn = self._roll_stack
        self._init_metrics(params)

    def _roll_stack(self, stack: torch.Tensor, turns: int):
        out = torch.stack([stencil.superstep(b, self.table, turns) for b in stack])
        return out, self._counts(out)

    @staticmethod
    def _counts(stack: torch.Tensor) -> torch.Tensor:
        """Per-board alive counts of a uint8 stack (unsynced int64)."""
        return torch.sum(stack & 1, dim=(1, 2), dtype=torch.int64)

    @staticmethod
    def _resolve(params: Params, shape: tuple[int, int], device) -> str:
        """Requested engine -> the batched form that runs: the solo ranking
        without the per-turn viewer carve-outs (a stack is headless by
        construction); "pallas" has no batched byte-kernel form and takes
        the packed tier."""
        if params.engine == "roll":
            return "roll"
        if packed.supports(shape):
            if Backend._packed_kernel_upgrade(
                params, device,
                lambda: cuda_adaptive.batched_supports((shape[0], shape[1] // 32)),
            ):
                return "pallas-packed"
            return "packed"
        return "roll"

    def _init_metrics(self, params: Params):
        from distributed_gol_torch.obs import metrics as obs_metrics

        reg = obs_metrics.registry_for(params.metrics)
        # One bump per batched dispatch however many boards rode it (the
        # coalescer's serve.batched_boards counter carries the cohort
        # sizes).
        self._m_dispatches = reg.counter(f"backend.batched_dispatches.{self.engine_used}")
        reg.info("backend.batched_engine", self.engine_used)

    # -- board placement ---------------------------------------------------------
    def put(self, stack: np.ndarray) -> torch.Tensor:
        """(B, H, W) uint8 stack onto the device."""
        return torch.from_numpy(np.ascontiguousarray(stack, dtype=np.uint8)).to(self.device)

    def fetch(self, stack: torch.Tensor) -> np.ndarray:
        return stack.cpu().numpy()

    # -- compute -----------------------------------------------------------------
    def run_turns_async(self, stack: torch.Tensor, turns: int):
        """Issue ``turns`` generations of every board of the stack as one
        dispatch, unsynced; returns (stack, per-board alive counts)."""
        self._m_dispatches.inc()
        return self._stack_fn(stack, turns)

    def run_turns(self, stack: torch.Tensor, turns: int) -> tuple[torch.Tensor, np.ndarray]:
        new_stack, counts = self.run_turns_async(stack, turns)
        return new_stack, counts.cpu().numpy()

    def run_boards(self, boards, turns: int):
        """Advance B same-shape boards ``turns`` generations in one dispatch;
        returns (list of boards, list of per-board count scalars) in input
        order.  The boards are views of one output stack, which nothing
        writes again (the next round stacks them into a fresh tensor); each
        tenant's controller forces its own count exactly as on a solo
        backend, and the first to do so fetches the whole vector."""
        self._m_dispatches.inc()
        out, counts = self._stack_fn(torch.stack(list(boards)), turns)
        shared = _SharedCounts(counts)
        return list(out.unbind(0)), [_SlotCount(shared, i) for i in range(len(boards))]

    def count(self, stack: torch.Tensor) -> np.ndarray:
        """Per-board alive counts of a stack, synchronised."""
        return self._counts(stack).cpu().numpy()

    def fetch_viewport(self, stack: torch.Tensor, rect) -> np.ndarray:
        """The batched form of :meth:`Backend.fetch_viewport`: the rect of
        every board of the (B, H, W) stack, cropped and bit-packed on the
        device in one pass, as a uint8 (B, vh, vw) array."""
        h, w = self.params.image_height, self.params.image_width
        y0, x0, vh, vw = Backend.normalize_rect(rect, h, w)
        dev = stack.device
        rows = torch.remainder(y0 + torch.arange(vh, device=dev), h)
        cols = torch.remainder(x0 + torch.arange(vw, device=dev), w)
        sub = stack.index_select(1, rows).index_select(2, cols)
        return Backend._unpack(self.fetch(stencil.packbits(sub)), vw)
