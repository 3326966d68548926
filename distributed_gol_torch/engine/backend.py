"""The device execution backend: a device-resident uint8 board plus the
engine that advances it.

PyTorch counterpart of ``distributed_gol_tpu/engine/backend.py`` for one
device, with the surface the controller calls on a headless run: board
placement (``put``/``fetch``/``fetch_many``), the dispatch seam
(``run_turns_async``: an unsynced superstep plus an unsynced 0-d alive
count that ``int()`` forces), the SDC probe, the whole-board cycle
probes, and the adaptive (``skip_stable``) tier's skip telemetry
(``skip_fraction``, ``activity_bitmap``).  Engine selection mirrors the
JAX package's ``_resolve_single`` and ``_ENGINE_RANK``; every engine is
bit-identical, so a fallback changes speed, never results — and a slower
tier than the one asked for is warned about, never silent.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.ops import cuda_adaptive, cuda_packed, packed, stencil
from distributed_gol_torch.utils.device import kernels_native, resolve_device


def _board_fingerprint(bo: torch.Tensor) -> torch.Tensor:
    """Position-weighted rolling hash of a board (mod 2^32) — the JAX
    package's SDC fingerprint, computed in int64 and reduced mod 2^32 so
    the two packages agree on every board."""
    hh, ww = bo.shape
    dev = bo.device
    wy = (torch.arange(hh, dtype=torch.int64, device=dev) * 2654435761) & 0xFFFFFFFF
    wx = (torch.arange(ww, dtype=torch.int64, device=dev) * 2246822519) & 0xFFFFFFFF
    bits = (bo != 0).to(torch.int64)
    return torch.sum(bits * (wy[:, None] ^ wx[None, :])) & 0xFFFFFFFF


class Backend:
    """Holds the step program of one (rule, engine, device) configuration.

    ``params.engine`` requests an engine; ``self.engine_used`` records what
    actually runs after capability fallbacks (the packed engines need
    W % 32 == 0).  "auto" takes the hand-written kernels on a CUDA device
    of compute capability 9.0 and the plain packed engine elsewhere."""

    sharded_tier = None  # single device: no halo-exchange tier

    def __init__(self, params: Params):
        self.params = params
        self.device = resolve_device(params.device)
        self.table = stencil.rule_table(params.rule, self.device)
        shape = (params.image_height, params.image_width)
        self.engine_used = self._resolve_single(params, shape, self.device)
        self._warn_if_downgraded(params, shape)
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
        else:
            self._superstep = lambda b, k: stencil.superstep(b, self.table, k)
        self._init_metrics(params)

    def _init_metrics(self, params: Params):
        """A dispatch counter bumped on the seam and the engine label."""
        from distributed_gol_torch.obs import metrics as obs_metrics

        # Run-scoped reset on the real registry, whatever this run's
        # metrics flag: an earlier run's labels must not leak into later
        # snapshots.
        obs_metrics.REGISTRY.clear_labels("backend.")
        reg = obs_metrics.registry_for(params.metrics)
        self._m_dispatches = reg.counter(f"backend.dispatches.{self.engine_used}")
        reg.info("backend.engine", self.engine_used)
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
        for :meth:`skip_fraction` and :meth:`activity_bitmap`."""
        new_board, skipped, act = self._skip_fn(board, turns)
        h, w = self.params.image_height, self.params.image_width
        total = cuda_adaptive.adaptive_tile_launches((h, w // 32), turns, self._skip_cap)
        if total:
            self._skip_stats.append((skipped, total, act))
            del self._skip_stats[:-3]
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
        by the probing kernel.  Period-6 ash reads inactive.  None before
        there is one, or off the adaptive tier."""
        stats = getattr(self, "_skip_stats", None)
        if not stats or len(stats) < 3:
            return None
        act = np.asarray(torch.as_tensor(stats[-3][2]).cpu().numpy())
        if act.size == 0:
            return None
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

    def _warn_if_downgraded(self, params: Params, shape):
        """Warn whenever the engine that runs is a slower tier than the one
        requested (explicit engine) or the one "auto" aims for.  Choices
        "auto" makes by policy (roll for per-turn dispatches and for widths
        no packed engine takes) stay silent."""
        if params.engine == "auto":
            if params.runtime_superstep() == 1 or shape[1] % 32:
                return
            preferred = "pallas-packed" if kernels_native(self.device) else "packed"
            if self._ENGINE_RANK[self.engine_used] >= self._ENGINE_RANK[preferred]:
                return
            requested = f"auto (prefers '{preferred}' here)"
        else:
            if self.engine_used == params.engine:
                return
            requested = f"'{params.engine}'"
        warnings.warn(
            f"engine {requested} cannot run {shape[1]}x{shape[0]} on "
            f"{self.device}; falling back to '{self.engine_used}' "
            "(bit-identical but a slower tier)",
            RuntimeWarning,
            stacklevel=3,
        )

    @staticmethod
    def _resolve_single(params: Params, shape: tuple[int, int], device) -> str:
        """Requested engine -> the engine that runs.  Explicit
        "pallas-packed" is honoured on every device (the wrappers run their
        plain versions on a CPU tensor); "auto" upgrades to the kernels only
        on a CUDA device of compute capability 9.0."""
        if params.engine == "roll":
            return "roll"
        # The byte drivers pack and unpack around every dispatch, which
        # only pays over multi-generation supersteps: per-turn dispatches
        # take the roll stencil under "auto".
        per_turn = params.runtime_superstep() == 1
        if packed.supports(shape) and not (params.engine == "auto" and per_turn):
            want = params.engine == "pallas-packed" or (
                params.engine == "auto" and kernels_native(device)
            )
            if want and cuda_packed.supports(shape):
                return "pallas-packed"
            return "packed"
        return "roll"

    # -- board placement -------------------------------------------------------
    def put(self, board: np.ndarray) -> torch.Tensor:
        board = np.ascontiguousarray(board, dtype=np.uint8)
        return torch.from_numpy(board).to(self.device)

    def fetch(self, board: torch.Tensor) -> np.ndarray:
        return board.cpu().numpy()

    def fetch_many(self, *arrays):
        """Several device values to numpy (scalars as 0-d arrays)."""
        return [np.asarray(a.cpu().numpy()) for a in arrays]

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
            return board, stencil.alive_count(board)
        new_board = self._superstep(board, turns)
        return new_board, stencil.alive_count(new_board)

    def run_turns(self, board: torch.Tensor, turns: int) -> tuple[torch.Tensor, int]:
        """Advance ``turns`` generations; returns (board, alive count after
        the last turn), synchronised."""
        new_board, count = self.run_turns_async(board, turns)
        return new_board, int(count)

    def count(self, board: torch.Tensor) -> int:
        return int(stencil.alive_count(board))

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
        ``fingerprint``: its rolling hash."""
        pop = stencil.alive_count(board_out)
        fp = _board_fingerprint(board_out)
        if not stripe:
            return True, int(pop), int(fp)
        h = self.params.image_height
        rows = min(h, self._SDC_STRIPE_ROWS)
        pad = turns
        window_rows = min(h, rows + 2 * pad)
        shift = pad - y0
        # Window rows y0-pad .. y0-pad+window_rows-1 (toroidal).  After
        # ``turns`` toroidal steps rows pad..pad+rows-1 are exact: the
        # window's own wrap is outside their light cone, or the window IS
        # the whole rolled board, whose wrap is the true torus.
        win = torch.roll(board_in, shift, 0)[:window_rows]
        stepped = stencil.superstep(win, self.table, turns)
        want = torch.roll(board_out, shift, 0)
        if window_rows == h:
            ok = torch.equal(stepped, want)
        else:
            ok = torch.equal(stepped[pad : pad + rows], want[pad : pad + rows])
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
        return torch.all(self._device_superstep(board, self.cycle_period) == board)

    def cycle_counts(self, board: torch.Tensor) -> np.ndarray:
        """Alive counts of the cycle phases: entry i is the count after
        i+1 generations from ``board``."""
        counts = []
        for _ in range(self.cycle_period):
            board = self._device_superstep(board, 1)
            counts.append(stencil.alive_count(board))
        return torch.stack(counts).cpu().numpy()
