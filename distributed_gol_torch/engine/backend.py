"""The device execution backend: a device-resident uint8 board plus the
engine that advances it.

PyTorch counterpart of ``distributed_gol_tpu/engine/backend.py`` for one
device, with the surface the controller calls on a headless run: board
placement (``put``/``fetch``/``fetch_many``), the dispatch seam
(``run_turns_async``: an unsynced superstep plus an unsynced 0-d alive
count that ``int()`` forces), the SDC probe, and the whole-board cycle
probes.  Engine selection mirrors the JAX package's ``_resolve_single``
and ``_ENGINE_RANK``; every engine is bit-identical, so a fallback changes
speed, never results — and a slower tier than the one asked for is
warned about, never silent.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.ops import cuda_packed, packed, stencil
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
            if params.skip_stable is None and params.skip_stable_requested():
                if cuda_packed.kernel_for(shape) == "tiled":
                    warnings.warn(
                        "skip_stable auto would engage the adaptive kernels for "
                        f"this {params.turns}-turn run; they are not ported yet "
                        "(ROADMAP B3/B4), so the plain tiled kernel runs",
                        RuntimeWarning,
                        stacklevel=2,
                    )
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

    def skip_fraction(self) -> float | None:
        """Share of tile launches the adaptive kernels skipped: None, since
        those kernels are not ported yet (ROADMAP B3/B4)."""
        return None

    def activity_bitmap(self) -> np.ndarray | None:
        """Per-stripe activity of the adaptive kernels: None, since those
        kernels are not ported yet (ROADMAP B3/B4)."""
        return None

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
        return torch.all(self._superstep(board, self.cycle_period) == board)

    def cycle_counts(self, board: torch.Tensor) -> np.ndarray:
        """Alive counts of the cycle phases: entry i is the count after
        i+1 generations from ``board``."""
        counts = []
        for _ in range(self.cycle_period):
            board = self._superstep(board, 1)
            counts.append(stencil.alive_count(board))
        return torch.stack(counts).cpu().numpy()
