"""Run configuration (reference: ``Params``, ``gol/gol.go:6-11``).

A copy of ``distributed_gol_tpu/engine/params.py`` — the same knobs, names
and defaults, so a command line for one package runs on the other — plus
``device``: the port runs on the CUDA card unless the caller asks for the
CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from distributed_gol_torch.models.life import CONWAY, LifeRule


@dataclass(frozen=True)
class Params:
    # --- the reference's four knobs (gol/gol.go:6-11) ---
    turns: int = 100
    threads: int = 8  # accepted for parity; the device owns its parallelism
    image_width: int = 512
    image_height: int = 512

    # --- reference CLI extra (main.go:40-46) ---
    no_vis: bool = True

    # --- framework knobs (no reference equivalent) ---
    rule: LifeRule = CONWAY
    # Generations per device dispatch when running headless.  1 => per-turn
    # host visibility (exact CellFlipped streams, as the SDL viewer needs);
    # larger values amortise dispatch overhead; 0 => auto (1 with a viewer;
    # headless an *adaptive* dispatch size that grows until one dispatch
    # takes ~max_dispatch_seconds — deep temporal blocking without
    # unbounded keypress latency).
    superstep: int = 0
    # Target wall-clock per device dispatch in adaptive (superstep=0)
    # headless mode.  Bounds interactivity: s/p/q/k keypresses are polled
    # between dispatches, so worst-case response is ~2x this value (one
    # overshooting dispatch) plus queue latency.  Explicit superstep > 0
    # opts out of the bound — the user chose their granularity.
    max_dispatch_seconds: float = 0.25
    # "roll" (torch.roll stencil, always correct) | "pallas" (the byte
    # kernel, one CUDA launch per generation, ops/cuda_stencil.py) |
    # "packed" (bit-packed SWAR, 32 cells/word) | "pallas-packed" (the
    # packed engine's hand-written CUDA kernel tier, ops/cuda_packed.py) |
    # "auto" (best available for the board and device: the kernels only on
    # a CUDA device of compute capability 9.0, the byte kernel for
    # per-turn viewer runs).  On a CPU device the kernel engines run their
    # plain PyTorch versions.  All engines are bit-identical; unsupported
    # shapes fall back (see Backend.engine_used).
    engine: str = "auto"
    # Activity-adaptive kernel tier (ops/cuda_adaptive.py): skip row
    # stripes whose neighbourhood is period-6 stable.  Bit-exact; pays off
    # once a long run has settled into ash.  None = auto: on for headless
    # runs of _SKIP_AUTO_TURNS or more (never instead of the resident
    # kernel); the engine must be "pallas-packed" (or "auto" resolving to
    # it).
    skip_stable: bool | None = None
    # Stripe-height cap of the adaptive tier (multiple of 8; 0 = the
    # port's default, cuda_adaptive.SKIP_TILE_CAP).
    skip_tile_cap: int = 0
    # TurnComplete telemetry policy: "per-turn" (the reference contract —
    # one TurnComplete per generation, ``gol/event.go:53-58``) | "batch"
    # (one TurnsCompleted(first, last) per device dispatch).  Per-turn
    # events cost one queue.put per generation on a plain queue.Queue,
    # bounding a headless ``gol.run()`` at Python queue throughput — pass
    # an ``EventQueue`` as the events queue (the CLI does) and the
    # controller enqueues each dispatch's TurnComplete range as ONE entry,
    # re-expanded per-turn on the consumer side.  Batch mode removes the
    # per-turn consumption cost too while keeping exact turn accounting.
    # Viewer-fed runs (flips/frames) are per-turn by construction and
    # ignore this knob.
    turn_events: str = "per-turn"
    # CellFlipped emission policy: "auto" (per-cell when a viewer is attached
    # i.e. not no_vis, off headless), "cell" (always, reference contract),
    # "batch" (one CellsFlipped per turn), "off".  Any flip mode forces
    # superstep 1 — exact per-turn diffs need per-turn host visibility.
    flip_events: str = "auto"
    # Viewer feed policy: "auto" (exact per-cell flips up to
    # _FLIP_VIEW_MAX_CELLS, device-pooled frames above), "flips" (always
    # the exact reference contract), "frame" (always pooled frames).
    # Frames cap the per-turn host transfer at ``frame_max`` uint8 cells
    # regardless of board size (SURVEY.md §7 hard part 4).
    view_mode: str = "auto"
    # Max (rows, cols) of a device-pooled viewer frame.
    frame_max: tuple[int, int] = (512, 512)
    # Generations per rendered frame in frame mode (exact simulation, the
    # viewer samples every Nth turn).  Each frame costs one synchronous
    # fetch round-trip (~100 ms through a tunnelled rig), so stride N
    # multiplies the per-wall-clock simulation rate by ~N while the
    # screen still updates at the same fps.  TurnComplete events stay
    # dense and exact at every stride.  0 (default) = LATENCY-ADAPTIVE:
    # the controller measures the frame-fetch round-trip at viewer start
    # and raises the effective stride on slow links (local links keep the
    # reference-faithful frame-per-turn cadence; see
    # Controller._auto_frame_stride for the policy).  An explicit N >= 1
    # always wins.  Ignored outside frame mode.
    frame_stride: int = 0
    # Region-of-interest spectator viewport: ``(y0, x0,
    # height, width)`` in board cells, or None for the whole board.
    # With a viewport, an attached viewer runs in FRAME mode regardless
    # of board size and every frame is a fused superstep + toroidal rect
    # extract + pool + bit-pack of ONLY the rect — per-frame cost scales
    # with the viewport, not the board (O(viewport ∪ activity); the
    # round-5 full-board path fetched O(H·W) per frame, which is why a
    # 65536² run simulating at 12.5k gens/s was unwatchable).  The
    # anchor may be any integers (it wraps the torus: rects straddling
    # the seam or a shard boundary are fine); the SIZE must fit the
    # board.  Viewer keys pan (a/d/w/x — left/right/up/down by half a
    # viewport) and zoom ('+'/'-' — halve/double the rect about its
    # centre) the rect mid-run; the pygame window maps the arrow keys
    # to the same actions.
    viewport: tuple[int, int, int, int] | None = None
    # Delta-encoded frames: after a keyframe (``FrameReady``),
    # ship only the changed 8-row bands of each rendered frame as
    # ``FrameDelta`` events, applied in place by the viewers — the wire
    # cost becomes O(activity within the viewport).  Keyframes re-arm on
    # every viewport change.  None (default) = AUTO: deltas on exactly
    # when a viewport is set (full-board frame runs keep the byte-for-
    # byte round-5 FrameReady stream); explicit True/False always wins.
    frame_deltas: bool | None = None
    # Whole-board cycle detection for headless runs: every N device
    # dispatches, probe (asynchronously, off the critical path) whether
    # advancing 6 generations reproduces the board exactly.  Once it does,
    # the dynamics are a fixed cycle — period a divisor of 6 = lcm(1..3),
    # which covers still lifes, blinkers and pulsars, i.e. every common
    # ash — so the controller stops dispatching and fast-forwards the
    # remaining turns exactly (events, counts, and the final board all
    # come from the 6 cycle phases; see ``CycleDetected``).  The reference
    # system's own 512² test board settles into a period-2 cycle near
    # turn 5k (``check/alive/512x512.csv`` tail), after which its per-turn
    # RPC loop keeps paying full price forever; this makes the default
    # 10^10-turn CLI config (``main.go:33``) finish in seconds with
    # ``turn_events="batch"`` (per-turn telemetry keeps the dense
    # TurnComplete stream, which then becomes the bound).  0 disables.
    # Boards with travelling patterns (gliders) simply never pass the
    # probe and pay only its ~6 generations per N dispatches.
    cycle_check: int = 8
    # Temporal-compression tier (engine/timecomp.py): once a board is
    # proved periodic, advance it in p·2^k-generation chunks with no
    # launches, bracketed by the SDC stripe guard; checkpoint sidecars
    # then split computed_turns from effective_turns.  Off by default
    # (dense runs are unchanged).  The cache size bounds the process-wide
    # LRU of settled boards' per-phase counts.
    time_compression: bool = False
    timecomp_cache_slots: int = 256
    # AliveCellsCount cadence in seconds (reference: 2000 ms ticker,
    # gol/distributor.go:228); configurable so tests can run fast.
    ticker_period: float = 2.0
    # Emit a TurnTiming event per device dispatch (wall-clock + gens/sec) —
    # the in-stream half of the tracing story (reference analog:
    # trace_test.go's runtime/trace harness); kernel traces via
    # utils.profiling.trace.
    emit_timing: bool = False
    # Device mesh shape (rows, cols) for sharded execution; (1, 1) = single
    # device.  Replaces the reference's hardcoded 4-worker fan-out
    # (broker/broker.go:192).
    mesh_shape: tuple[int, int] = (1, 1)
    # Where the board lives and the engines run: "cuda" (default; raises
    # when no CUDA GPU is available) or "cpu" (the plain PyTorch engines).
    device: str = "cuda"

    # --- fault tolerance (framework extension; the reference's only story
    # is the broker re-queueing a failed worker RPC once,
    # broker/broker.go:67-73; see docs/API.md "Fault tolerance") ---
    # Retries per failed dispatch, each re-run from the last good board.
    # The default mirrors the reference's single re-queue; 0 disables
    # retries (every failure is terminal: park a checkpoint and abort).
    retry_limit: int = 1
    # Deterministic exponential backoff between retries: the n-th retry of
    # a dispatch sleeps base·2^(n-1) seconds, capped at
    # retry_backoff_max_seconds.  0 (default) retries immediately — the
    # reference's re-queue semantics, and the right call for the transient
    # single-dispatch errors retries exist for; a base > 0 spaces retries
    # out for failures that need the device a moment to recover.
    retry_backoff_seconds: float = 0.0
    retry_backoff_max_seconds: float = 2.0
    # Per-run failure cap: once this many dispatch failures have occurred
    # in one run, the NEXT failure is terminal even if retry_limit allows
    # more — a flapping device should park a resumable checkpoint and
    # abort, not grind a long run forever.  0 = unlimited.
    failure_budget: int = 0
    # Dispatch watchdog: any blocking wait on a dispatch result (count
    # force, sync viewer dispatch, retry, terminal checkpoint fetch) that
    # exceeds this many seconds raises DispatchTimeout; the run aborts
    # with the stream sentinel — and a parked checkpoint when the last
    # good board is still fetchable — instead of wedging the controller.
    # Timeouts are terminal (never retried): a wedged device or collective
    # would wedge the retry too.  On multi-host runs every process's own
    # watchdog fires, so no process hangs alone in a collective.  0
    # (default) disables; the clean path then pays nothing.
    #
    # The deadline bounds WALL-CLOCK waits — the watchdog cannot tell a
    # wedge from a legitimately slow wait, so set it above the worst
    # legitimate one: first-dispatch jit compilation (tens of seconds at
    # 16384²-class boards; see bench.budget_for) and, with an explicit
    # large superstep, the dispatch's own device time.
    dispatch_deadline_seconds: float = 0.0
    # Durable periodic checkpoints: every N completed turns (and/or every
    # S seconds, both checked at dispatch boundaries against the settled
    # board) the controller parks a checkpoint on the session — atomic
    # tmp+rename writes, world-before-meta ordering, CRC32 sidecar,
    # keep-last-K rotation (Session.save_checkpoint) — so a crash at any
    # instant leaves a resumable state and a torn write is detected and
    # skipped at resume.  0 disables.  Multi-host runs refuse the
    # wall-clock cadence (it would diverge the SPMD dispatch schedule
    # between processes); the turn cadence is deterministic everywhere.
    checkpoint_every_turns: int = 0
    checkpoint_every_seconds: float = 0.0
    checkpoint_keep: int = 3

    # --- resilience: the self-healing runtime.  PR 2 made every failure terminal-but-clean; these
    # knobs make a production run SURVIVE them. ---
    # Rollback-recovery supervisor: a terminal dispatch failure with a
    # resumable checkpoint available no longer aborts the run — the
    # supervisor tears the backend down, rebuilds it (escalating to the
    # forced-ppermute exchange tier from the second restart), restores the
    # newest intact checkpoint via the existing Session.check_states scan,
    # and resumes.  This many restarts are allowed before the run degrades
    # to today's sentinel abort (with the full restart history in the
    # flight record).  0 (default) disables the supervisor entirely:
    # gol.run() is exactly the unsupervised, terminal-but-clean controller.
    restart_limit: int = 0
    # Restart-rate budget: with a window > 0, restart_limit bounds the
    # restarts within any trailing window of this many seconds (a steady
    # trickle of recoverable faults keeps being survived; a flap faster
    # than the budget aborts).  0 (default) makes restart_limit a per-run
    # total instead.
    restart_window_seconds: float = 0.0
    # SDC sentinel: every N completed turns (checked at dispatch
    # boundaries against the settled board, like the checkpoint cadence)
    # the controller cross-checks the dispatch it just resolved — a
    # redundant recompute of the dispatch on a sampled row stripe through
    # the independent roll-stencil formulation, plus an on-device
    # popcount/rolling-hash fingerprint whose popcount must equal the
    # count the dispatch already forced.  A mismatch raises
    # CorruptionDetected: terminal WITHOUT parking the (corrupt) board,
    # which the supervisor treats as a rollback trigger.  Keep the
    # cadence <= checkpoint_every_turns so a corruption is caught before
    # it can be checkpointed.  0 (default) disables.
    sdc_check_every_turns: int = 0
    # Multi-host peer heartbeat: every rank UDP-pings its peers
    # on this interval (seconds) from a daemon thread, OUTSIDE the
    # collective stream — so a rank that dies hard (SIGKILL, kernel
    # panic) is detected within ~3 intervals by every survivor, which
    # then aborts with the stream sentinel and the newest periodic
    # checkpoint as the resumable state, instead of relying solely on
    # the dispatch watchdog (which only fires once a survivor blocks in
    # a collective) or the coordination service's multi-minute
    # hard-kill.  Arm uniformly on every rank, like ``stop`` — the setup
    # address exchange is a collective.  0 (default) disables; ignored
    # on single-host runs.
    peer_heartbeat_seconds: float = 0.0

    # --- observability ---
    # Always-on metrics registry: process-wide named counters/gauges/
    # histograms bumped on the dispatch and failure paths (plain attribute
    # adds, no locks — the clean-path cost is noise, verified by the quiet
    # protocol), snapshotted into the terminal MetricsReport event, bench
    # records, checkpoint sidecars, and flight records.  False swaps in
    # no-op instruments and suppresses the MetricsReport.
    metrics: bool = True
    # Continuous telemetry sampling: a daemon thread snapshots
    # the registry every N seconds into a bounded ring of timestamped
    # samples (obs/timeseries.TelemetrySampler) — windowed rates and
    # latency percentiles derive from consecutive samples, and the
    # /metrics + /healthz endpoints serve the LATEST sample so a scrape
    # is bounded-time whatever the device is doing.  0 (default)
    # disables; ``gol.run(..., telemetry_port=...)`` arms it at a 1 s
    # default cadence when this is 0.  The sampler outlives supervisor
    # restarts (it is registry-scoped, armed outside the restart ladder).
    telemetry_sample_seconds: float = 0.0
    # Crash flight recorder: a bounded in-memory ring of the last N
    # structured records (dispatches with timings, retries, watchdog
    # transitions, checkpoint commits, tier decisions).  Every terminal
    # path dumps it as flight-<ts>.json next to the checkpoint dir (the
    # session's directory when durable, else out_dir) before the run
    # dies; a clean run writes nothing.  0 disables.
    flight_recorder_depth: int = 256

    # --- multi-tenant serving ---
    # Tenant identity for runs multiplexed through the serving plane
    # (``serve.ServePlane``): threads a ``tenant=`` label through the
    # per-dispatch metrics (``obs.metrics.DispatchRecorder``) — and, via
    # the run's metrics delta, through checkpoint-sidecar snapshots and
    # the terminal ``MetricsReport`` — so one process-wide registry
    # snapshot separates tenants.  Also the session's scoped checkpoint
    # subdirectory name under the plane's checkpoint root, so it must be
    # filesystem-safe (letters, digits, ``._-``; <= 64 chars).  None
    # (default) = untenanted: metric names are exactly the pre-serving
    # ones.
    tenant: str | None = None

    # Input-source override: a random soup of this density instead of the
    # ``images/WxH.pgm`` file (framework extension — the reference ships
    # pre-made soups as PGMs, which stops being practical at 16384²+ where
    # the input file alone is hundreds of MB).  None = read the PGM.
    soup_density: float | None = None
    soup_seed: int = 0

    # --- filesystem conventions (gol/io.go:46,96: images/ in, out/ out) ---
    images_dir: Path = field(default=Path("images"))
    out_dir: Path = field(default=Path("out"))

    def __post_init__(self):
        if self.turns < 0:
            raise ValueError("turns must be >= 0")
        if self.image_width <= 0 or self.image_height <= 0:
            raise ValueError("board dimensions must be positive")
        if self.engine not in ("roll", "pallas", "packed", "pallas-packed", "auto"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.flip_events not in ("auto", "cell", "batch", "off"):
            raise ValueError(f"unknown flip_events {self.flip_events!r}")
        if self.turn_events not in ("per-turn", "batch"):
            raise ValueError(f"unknown turn_events {self.turn_events!r}")
        if self.view_mode not in ("auto", "flips", "frame"):
            raise ValueError(f"unknown view_mode {self.view_mode!r}")
        fh, fw = self.frame_max
        if fh < 1 or fw < 1:
            raise ValueError(f"frame_max must be positive, got {self.frame_max}")
        if self.frame_stride < 0:
            raise ValueError(
                "frame_stride must be >= 1, or 0 for latency-adaptive"
            )
        if self.viewport is not None:
            vp = tuple(int(v) for v in self.viewport)
            if len(vp) != 4:
                raise ValueError(
                    f"viewport must be (y0, x0, height, width), got {self.viewport!r}"
                )
            if not (
                1 <= vp[2] <= self.image_height
                and 1 <= vp[3] <= self.image_width
            ):
                raise ValueError(
                    f"viewport size {vp[3]}x{vp[2]} does not fit board "
                    f"{self.image_width}x{self.image_height}"
                )
            object.__setattr__(self, "viewport", vp)
        ny, nx = self.mesh_shape
        if ny < 1 or nx < 1:
            raise ValueError(f"mesh_shape must be positive, got {self.mesh_shape}")
        if self.skip_tile_cap < 0 or self.skip_tile_cap % 8:
            raise ValueError(
                "skip_tile_cap must be 0 (auto) or a positive multiple of 8"
            )
        if self.cycle_check < 0:
            raise ValueError("cycle_check must be >= 0 (0 disables)")
        if self.timecomp_cache_slots < 1:
            raise ValueError("timecomp_cache_slots must be >= 1")
        if self.ticker_period <= 0:
            raise ValueError("ticker_period must be positive")
        if self.max_dispatch_seconds <= 0:
            raise ValueError("max_dispatch_seconds must be positive")
        if self.soup_density is not None and not 0.0 < self.soup_density < 1.0:
            raise ValueError("soup_density must be in (0, 1)")
        if self.retry_limit < 0:
            raise ValueError("retry_limit must be >= 0 (0 disables retries)")
        if self.retry_backoff_seconds < 0 or self.retry_backoff_max_seconds < 0:
            raise ValueError("retry backoff times must be >= 0")
        if self.failure_budget < 0:
            raise ValueError("failure_budget must be >= 0 (0 = unlimited)")
        if self.dispatch_deadline_seconds < 0:
            raise ValueError(
                "dispatch_deadline_seconds must be >= 0 (0 disables the watchdog)"
            )
        if self.checkpoint_every_turns < 0 or self.checkpoint_every_seconds < 0:
            raise ValueError("checkpoint cadences must be >= 0 (0 disables)")
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        if self.restart_limit < 0:
            raise ValueError(
                "restart_limit must be >= 0 (0 disables the supervisor)"
            )
        if self.restart_window_seconds < 0:
            raise ValueError(
                "restart_window_seconds must be >= 0 (0 = per-run total)"
            )
        if self.sdc_check_every_turns < 0:
            raise ValueError(
                "sdc_check_every_turns must be >= 0 (0 disables the sentinel)"
            )
        if self.peer_heartbeat_seconds < 0:
            raise ValueError(
                "peer_heartbeat_seconds must be >= 0 (0 disables the heartbeat)"
            )
        if (
            self.sdc_check_every_turns
            and self.checkpoint_every_turns
            and self.sdc_check_every_turns > self.checkpoint_every_turns
        ):
            # A checkpoint cadence finer than the sentinel's can persist
            # corruption BEFORE it is checked; the rollback would then
            # "recover" into corrupt state — silently defeating both
            # features the user armed.  (The wall-clock cadence
            # ``checkpoint_every_seconds`` cannot be ordered against a
            # turn cadence here; the controller instead FORCES an
            # out-of-cadence SDC check at any boundary about to park —
            # verify-before-park, ``Controller._guard_boundary`` — so no
            # unverified board is ever durably written while the
            # sentinel is armed.)
            raise ValueError(
                "sdc_check_every_turns must be <= checkpoint_every_turns "
                "when both are set: a corruption must be caught before it "
                "can be checkpointed"
            )
        if self.telemetry_sample_seconds < 0:
            raise ValueError(
                "telemetry_sample_seconds must be >= 0 (0 disables sampling)"
            )
        if self.flight_recorder_depth < 0:
            raise ValueError(
                "flight_recorder_depth must be >= 0 (0 disables the recorder)"
            )
        if self.tenant is not None:
            import re

            # No all-dot names: "." / ".." are path traversal, not tenants.
            if set(self.tenant) <= {"."} or not re.fullmatch(
                r"[A-Za-z0-9._-]{1,64}", self.tenant
            ):
                raise ValueError(
                    "tenant must be a filesystem-safe name (letters, "
                    f"digits, '._-', <= 64 chars), got {self.tenant!r}"
                )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}; expected 'cuda' or 'cpu'")
        # Paths may arrive as strings from CLI/config files.
        object.__setattr__(self, "images_dir", Path(self.images_dir))
        object.__setattr__(self, "out_dir", Path(self.out_dir))

    # Filename conventions are part of the reference contract:
    #   input  images/<W>x<H>.pgm            (gol/distributor.go:205)
    #   final  out/<W>x<H>x<Turns>.pgm       (gol/distributor.go:246)
    #   manual out/<W>x<H>x<turn>current.pgm (gol/distributor.go:92-94 uses
    #          p.Turns here; we deliberately use the *current* turn so
    #          successive 's' snapshots don't overwrite each other — quirk
    #          decision per SURVEY.md appendix)
    @property
    def input_path(self) -> Path:
        return self.images_dir / f"{self.image_width}x{self.image_height}.pgm"

    @property
    def final_output_name(self) -> str:
        return f"{self.image_width}x{self.image_height}x{self.turns}"

    def snapshot_name(self, turn: int) -> str:
        return f"{self.image_width}x{self.image_height}x{turn}current"

    def effective_superstep(self, viewer_attached: bool) -> int:
        if self.superstep > 0:
            return self.superstep
        if viewer_attached or not self.no_vis:
            return 1
        # Headless auto: large enough to amortise dispatch, small enough
        # that pause/quit keypresses are honoured promptly (SURVEY.md §7
        # hard part 3: interactivity is at superstep granularity).
        return min(self.turns, 50) if self.turns else 1

    # Boards above this cell count switch an "auto" viewer from exact
    # per-cell flips to device-pooled frames (a 2048² flip fetch is already
    # a 4 MB mask/turn; frames cap it at frame_max cells).
    _FLIP_VIEW_MAX_CELLS = 2**21

    def wants_flips(self) -> bool:
        """Whether this run emits per-turn CellFlipped/CellsFlipped events
        (which forces per-turn host visibility)."""
        if self.flip_events in ("cell", "batch"):
            return True
        return (
            self.flip_events == "auto"
            and not self.no_vis
            and not self.wants_frames()
        )

    def wants_frames(self) -> bool:
        """Whether an attached viewer is fed device-pooled frames instead of
        exact flips (large boards; SURVEY.md §7 hard part 4).  An explicit
        ``flip_events`` of "cell"/"batch" is the exact reference contract
        and always wins over frames; ``flip_events="off"`` asked for no
        per-turn viewer traffic at all, so it suppresses frames too."""
        if self.no_vis or self.flip_events in ("cell", "batch", "off"):
            return False
        if self.view_mode == "frame":
            return True
        # A viewport is a frame-mode request by construction:
        # rect extraction + pooling IS the frame path, whatever the board
        # size — unless the viewer explicitly demanded exact flips.
        if self.viewport is not None and self.view_mode != "flips":
            return True
        return (
            self.view_mode == "auto"
            and self.image_width * self.image_height > self._FLIP_VIEW_MAX_CELLS
        )

    def frame_deltas_enabled(self) -> bool:
        """The resolved frame-delta policy (None = auto: deltas exactly
        when a viewport is set, so full-board frame runs stay
        byte-for-byte the round-5 stream)."""
        if self.frame_deltas is not None:
            return self.frame_deltas
        return self.viewport is not None

    def factors_for(self, vh: int, vw: int) -> tuple[int, int]:
        """(fy, fx) pooling factors mapping a (vh, vw) region into
        ``frame_max`` — ONE home for the ceil-pooling math (the static
        :meth:`frame_factors`, the controller's live-zoom rects, and the
        bench's wire-byte accounting all call here)."""
        fh, fw = self.frame_max
        return (max(1, -(-vh // fh)), max(1, -(-vw // fw)))

    def frame_factors(self) -> tuple[int, int]:
        """(fy, fx) pooling factors mapping the rendered region — the
        viewport when one is set, else the whole board — into frame_max."""
        if self.viewport is not None:
            return self.factors_for(self.viewport[2], self.viewport[3])
        return self.factors_for(self.image_height, self.image_width)

    # Auto skip_stable engages at or beyond this run length: ~20× the
    # measured settling time of a 512²-class soup (≈5k turns) and long
    # enough that the active-phase ~3% cost is dwarfed by the settled-
    # phase win even if the board settles late.
    _SKIP_AUTO_TURNS = 100_000

    def skip_stable_requested(self) -> bool:
        """The resolved skip_stable policy (None = auto).  Auto says yes
        only for long headless multi-generation runs — per-turn-visible
        runs can't amortise the adaptive kernel, and short runs never
        reach the settled regime that pays for it.  The Backend still
        applies its capability gates (tiled shapes only, never off the
        resident fast path on auto)."""
        if self.skip_stable is not None:
            return self.skip_stable
        return (
            self.turns >= self._SKIP_AUTO_TURNS
            and self.no_vis
            and self.runtime_superstep() != 1
        )

    def runtime_superstep(self) -> int:
        """Generations per device dispatch the controller will actually use —
        the single source of truth shared by the controller's run loop and
        the backend's engine auto-selection."""
        if self.wants_flips():
            return 1
        if self.wants_frames():
            # Latency-adaptive stride (0) plans as 1: the controller may
            # raise the EFFECTIVE stride after measuring the link, but
            # engine selection and dispatch planning must not assume a
            # slow link that may not exist.
            return max(1, self.frame_stride)
        return self.effective_superstep(False)
