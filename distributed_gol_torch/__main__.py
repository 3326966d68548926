"""CLI entry — the reference's ``main.go`` equivalent, for the port.

The engine-run command line of ``python -m distributed_gol_tpu``, flag for
flag (``-t``, ``-w``, ``-h`` board height, ``-turns``, ``-noVis`` and the
framework flags), plus ``--device cuda|cpu``.  ``--mesh NYxNX`` shards the
board over a mesh of that many CUDA devices (``--device cpu``: shards on
the CPU), headless, ``--skip-stable`` included; with ``--skip-stable``
(or ``auto`` on runs of 100,000 turns or more) a mesh whose strips or
tiles share one card takes the in-kernel exchange tier (K14 on a row
mesh, K15 on a 2-D mesh), and the
environment variable ``DGOL_ICI=0`` forces the ppermute tier instead, as
in the JAX package.  ``--restart-limit N`` supervises the run (rollback
to the newest checkpoint on a terminal fault, ``engine/supervisor.py``),
``--time-compression`` fast-forwards settled ash, and
``--telemetry-sample-seconds S`` samples the metrics registry and
``--telemetry-port PORT`` serves ``/metrics`` and ``/healthz`` for the run.
A mesh runs with a viewer too (the viewer is on by default).  Multi-host
flags, which the port does not serve yet, are usage errors that name the
ROADMAP item.  The
engine runs in a worker thread while the main thread runs the viewer: the
terminal renderer by default, the pygame window with ``--window``, a
headless drain with ``-noVis``; the keyboard listener feeds s/p/q/k (and
the viewport's pan/zoom keys).

``python -m distributed_gol_torch serve ...`` runs one serving pod
(``serve/plane.py``): scripted ``--tenant NAME:WxHxTURNS`` sessions and
re-adopted parked ones, ``--batched`` to share launches across same-shape
tenants, with ``--device`` as above; ``--gateway-port PORT`` puts the pod
on the wire (``serve/gateway.py``: HTTP control plane, WebSocket event and
spectator legs; the pod then serves until drained) and
``--telemetry-port PORT`` serves its ``/metrics``, ``/healthz`` and
``/slo``.

``broker --pod URL ...`` fronts gateway pods with the health-probed
federation tier (placement, condemnation, failover from the shared
``--checkpoint-root``, migration; ``--collector`` rides the fleet
collector in it), ``relay --upstream URL`` re-fans one spectator stream to
many viewers, and ``collector --node URL ...`` serves the fleet's
aggregated metrics, stitched traces and merged flight records.  None of
the three touches a device.
"""

from __future__ import annotations

import argparse
import contextlib
import queue
import signal
import sys
import threading
import time
from pathlib import Path

from distributed_gol_torch.engine.events import EventQueue
from distributed_gol_torch.engine.gol import start
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.engine.session import Session, default_session
from distributed_gol_torch.engine.supervisor import GracefulStop
from distributed_gol_torch.models.life import parse_rule
from distributed_gol_torch.utils.device import resolve_device
from distributed_gol_torch.viewer.keyboard import keyboard_listener
from distributed_gol_torch.viewer.loop import run_headless, run_terminal


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_gol_torch",
        add_help=False,  # -h is board height, as in the reference CLI
        description="Game of Life engine on PyTorch and CUDA (port of distributed_gol_tpu)",
    )
    ap.add_argument("--help", action="help", help="show this help message")
    ap.add_argument("-t", type=int, default=8, metavar="THREADS",
                    help="threads knob (accepted for parity; the device owns its parallelism)")
    ap.add_argument("-w", type=int, default=512, metavar="WIDTH")
    ap.add_argument("-h", type=int, default=512, metavar="HEIGHT")
    ap.add_argument("-turns", type=int, default=10_000_000_000)
    ap.add_argument("-noVis", action="store_true", dest="no_vis")
    ap.add_argument("--rule", default="conway", help="conway | highlife | ... | B36/S23")
    ap.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "roll", "pallas", "packed", "pallas-packed"],
    )
    ap.add_argument("--superstep", type=int, default=0,
                    help="generations per device dispatch (0 = auto)")
    ap.add_argument("--mesh", default="1x1", metavar="NYxNX",
                    help="device mesh shape, e.g. 2x4")
    ap.add_argument("--images-dir", default="images")
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="durable 'q'-detach checkpoints live here")
    ap.add_argument("--ticker", type=float, default=2.0,
                    help="AliveCellsCount period in seconds")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the board lives and the engines run (cuda "
                         "fails when no CUDA GPU is available)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run to "
                         "DIR/trace.json")
    ap.add_argument("--timing", action="store_true",
                    help="emit TurnTiming events (per-dispatch gens/sec)")
    ap.add_argument("--turn-events", default="per-turn",
                    choices=["per-turn", "batch"],
                    help="TurnComplete telemetry: reference-exact per-turn "
                         "events, or one TurnsCompleted(first, last) per "
                         "dispatch (headless fast path)")
    ap.add_argument("--window", action="store_true",
                    help="render in a pixel window (pygame) instead of the "
                         "terminal — the reference's SDL window experience; "
                         "needs a display (or SDL_VIDEODRIVER=dummy)")
    ap.add_argument("--view-mode", default="auto",
                    choices=["auto", "flips", "frame"],
                    help="viewer feed: exact per-cell flips or device-pooled "
                         "frames (auto switches on board size)")
    ap.add_argument("--frame-max", default="512x512", metavar="HxW",
                    help="max size of a device-pooled viewer frame")
    ap.add_argument("--frame-stride", type=int, default=0, metavar="N",
                    help="frame mode: exact generations per rendered frame "
                         "(each frame costs one host round-trip; stride N "
                         "multiplies wall-clock sim speed ~N on high-"
                         "latency links).  Default 0 = latency-adaptive: "
                         "the frame-fetch round-trip is measured at "
                         "viewer start and the stride raised to match on "
                         "slow links (local links keep a frame per turn)")
    ap.add_argument("--viewport", default=None, metavar="Y0,X0,HxW",
                    help="region-of-interest spectator viewport: render "
                         "only this rect (toroidal anchor; a/d/w/x pan, "
                         "+/- zoom mid-run).  Frame cost becomes "
                         "O(viewport), not O(board) — what makes 16384^2+ "
                         "boards watchable (e.g. 0,0,1024x1024)")
    ap.add_argument("--frame-deltas", action="store_true", default=None,
                    dest="frame_deltas",
                    help="delta-encode frames (changed 8-row bands after "
                         "a keyframe).  Default: auto — on exactly when "
                         "--viewport is set")
    ap.add_argument("--no-frame-deltas", action="store_false",
                    dest="frame_deltas",
                    help="force whole-frame FrameReady events even with a "
                         "viewport")
    ap.add_argument("--max-dispatch-seconds", type=float, default=0.25,
                    help="adaptive-superstep target per dispatch; bounds "
                         "keypress latency at ~2x this value")
    ap.add_argument("--skip-stable", action="store_true", default=None,
                    help="activity-adaptive pallas-packed kernel: period-6-"
                         "stable tiles (ash) skip their generations, exactly "
                         "(default: auto — ON for headless multi-generation "
                         "runs of 100k+ turns on boards where it engages)")
    ap.add_argument("--no-skip-stable", action="store_false", dest="skip_stable",
                    help="force the adaptive kernel off (see --skip-stable)")
    ap.add_argument("--skip-tile-cap", type=int, default=0, metavar="ROWS",
                    help="stripe-height cap for --skip-stable (multiple "
                         "of 8). 0 = the port's default "
                         "(ops/cuda_adaptive.py SKIP_TILE_CAP)")
    ap.add_argument("--cycle-check", type=int, default=8, metavar="N",
                    help="probe for whole-board period-6 stability every N "
                         "headless dispatches; once proved, the remaining "
                         "turns fast-forward exactly (0 disables)")
    ap.add_argument("--time-compression", action="store_true",
                    help="temporal-compression tier (docs/API.md \"Time "
                         "compression\"): once the board is proved settled, "
                         "fast-forward through time in ash-period chunks "
                         "with zero device launches — exact, guarded by an "
                         "independent-stencil re-derivation; requires a "
                         "rule with a known ash period (B3/S23, B36/S23)")
    ap.add_argument("--timecomp-cache-slots", type=int, default=256,
                    metavar="N",
                    help="bounded LRU slots for the time-compression ash "
                         "cache (per-phase alive counts of settled boards)")
    ap.add_argument("--soup", type=float, default=None, metavar="DENSITY",
                    help="start from a seeded random soup of this density "
                         "instead of images/WxH.pgm (huge boards need no "
                         "input file)")
    ap.add_argument("--soup-seed", type=int, default=0,
                    help="RNG seed for --soup (multi-host runs must pass "
                         "the same seed on every process)")
    # Fault tolerance (docs/API.md "Fault tolerance").
    ap.add_argument("--retry-limit", type=int, default=1, metavar="N",
                    help="retries per failed dispatch from the last good "
                         "board (0 = every failure terminal; default 1, "
                         "the reference's single re-queue)")
    ap.add_argument("--retry-backoff", type=float, default=0.0,
                    metavar="SECONDS",
                    help="base of the deterministic exponential backoff "
                         "between retries (0 = retry immediately)")
    ap.add_argument("--failure-budget", type=int, default=0, metavar="N",
                    help="per-run failure cap: past it the next failure is "
                         "terminal regardless of --retry-limit (0 = unlimited)")
    ap.add_argument("--dispatch-deadline", type=float, default=0.0,
                    metavar="SECONDS",
                    help="dispatch watchdog: a blocking dispatch wait past "
                         "this deadline aborts the run (sentinel + parked "
                         "checkpoint) instead of wedging; 0 disables")
    ap.add_argument("--checkpoint-every-turns", type=int, default=0,
                    metavar="N",
                    help="durable periodic checkpoint every N turns "
                         "(atomic + CRC32 + keep-last-K; pair with "
                         "--checkpoint-dir to survive the process)")
    ap.add_argument("--checkpoint-every-seconds", type=float, default=0.0,
                    metavar="S",
                    help="wall-clock checkpoint cadence, checked at "
                         "dispatch boundaries (refused by multi-host runs)")
    ap.add_argument("--checkpoint-keep", type=int, default=3, metavar="K",
                    help="keep-last-K rotation for periodic checkpoints")
    # Resilience (docs/API.md "Resilience").
    ap.add_argument("--restart-limit", type=int, default=0, metavar="N",
                    help="rollback-recovery supervisor: survive up to N "
                         "terminal dispatch failures by restoring the "
                         "newest checkpoint and resuming (rebuilding the "
                         "backend, escalating to the ppermute exchange "
                         "tier from the second restart); 0 = off, every "
                         "terminal failure aborts as before")
    ap.add_argument("--restart-window", type=float, default=0.0,
                    metavar="SECONDS",
                    help="restart-rate budget: with a window, "
                         "--restart-limit bounds restarts per trailing "
                         "window instead of per run (0 = per-run total)")
    ap.add_argument("--sdc-check-every-turns", type=int, default=0,
                    metavar="N",
                    help="SDC sentinel: every N turns cross-check the "
                         "resolved dispatch against a redundant stripe "
                         "recompute + popcount fingerprint; a mismatch "
                         "is terminal (CorruptionDetected) and rolls "
                         "back under --restart-limit; keep N <= "
                         "--checkpoint-every-turns; 0 disables")
    ap.add_argument("--peer-heartbeat", type=float, default=0.0,
                    metavar="SECONDS",
                    help="multi-host peer liveness: every rank UDP-pings "
                         "its peers on this interval so a rank that dies "
                         "HARD (SIGKILL, machine loss) is detected within "
                         "~3 intervals and survivors abort resumable "
                         "(PeerLost) instead of waiting out the dispatch "
                         "deadline or the coordination service's "
                         "multi-minute hard-kill; arm uniformly on every "
                         "rank; 0 = off; ignored on single-host runs")
    # Observability (docs/API.md "Observability").
    ap.add_argument("--metrics", action="store_true", default=True,
                    help="always-on run metrics: counters/gauges/histograms "
                         "on the dispatch and failure paths, reported in the "
                         "terminal MetricsReport event (on by default; the "
                         "clean-path cost is noise)")
    ap.add_argument("--no-metrics", action="store_false", dest="metrics",
                    help="disable the metrics registry (see --metrics)")
    ap.add_argument("--flight-recorder-depth", type=int, default=256,
                    metavar="N",
                    help="crash flight recorder: keep the last N structured "
                         "records (dispatches, retries, watchdog fires, "
                         "checkpoints) and dump flight-<ts>.json next to the "
                         "checkpoint dir when a run dies; 0 disables")
    ap.add_argument("--telemetry-port", type=int, default=None, metavar="PORT",
                    help="continuous telemetry endpoints for this run "
                         "/metrics (OpenMetrics) and /healthz "
                         "(JSON) on PORT (0 = an ephemeral port, published "
                         "as the telemetry.endpoint info label), served "
                         "bounded-time from the sampler's latest in-memory "
                         "sample; needs --metrics (the default)")
    ap.add_argument("--telemetry-sample-seconds", type=float, default=0.0,
                    metavar="S",
                    help="registry sampling cadence for the telemetry "
                         "plane (0 = off unless --telemetry-port is set, "
                         "which defaults the cadence to 1s)")
    # Multi-host: launch the same command on every host (the reference's
    # hand-launched broker/worker fleet, broker/broker.go:191-205); process
    # 0 is the controller, the rest are followers.
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-host run: distributed coordinator address")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    return ap


def params_from_args(args) -> Params:
    ny, _, nx = args.mesh.partition("x")
    if not (ny.isdigit() and nx.isdigit()):
        raise ValueError(f"--mesh wants NYxNX (e.g. 2x4), got {args.mesh!r}")
    fh, _, fw = args.frame_max.partition("x")
    if not (fh.isdigit() and fw.isdigit()):
        raise ValueError(f"--frame-max wants HxW (e.g. 512x512), got {args.frame_max!r}")
    viewport = None
    if args.viewport is not None:
        try:
            y0, x0, size = args.viewport.split(",")
            vh, _, vw = size.partition("x")
            viewport = (int(y0), int(x0), int(vh), int(vw))
        except ValueError:
            raise ValueError(
                "--viewport wants Y0,X0,HxW (e.g. 0,0,1024x1024), "
                f"got {args.viewport!r}"
            ) from None
    return Params(
        turns=args.turns,
        threads=args.t,
        image_width=args.w,
        image_height=args.h,
        no_vis=args.no_vis,
        rule=parse_rule(args.rule),
        superstep=args.superstep,
        engine=args.engine,
        mesh_shape=(int(ny), int(nx)),
        images_dir=args.images_dir,
        out_dir=args.out_dir,
        ticker_period=args.ticker,
        emit_timing=args.timing,
        turn_events=args.turn_events,
        view_mode=args.view_mode,
        frame_max=(int(fh), int(fw)),
        frame_stride=args.frame_stride,
        viewport=viewport,
        frame_deltas=args.frame_deltas,
        max_dispatch_seconds=args.max_dispatch_seconds,
        skip_stable=args.skip_stable,
        skip_tile_cap=args.skip_tile_cap,
        cycle_check=args.cycle_check,
        time_compression=args.time_compression,
        timecomp_cache_slots=args.timecomp_cache_slots,
        soup_density=args.soup,
        soup_seed=args.soup_seed,
        retry_limit=args.retry_limit,
        retry_backoff_seconds=args.retry_backoff,
        failure_budget=args.failure_budget,
        dispatch_deadline_seconds=args.dispatch_deadline,
        checkpoint_every_turns=args.checkpoint_every_turns,
        checkpoint_every_seconds=args.checkpoint_every_seconds,
        checkpoint_keep=args.checkpoint_keep,
        restart_limit=args.restart_limit,
        restart_window_seconds=args.restart_window,
        sdc_check_every_turns=args.sdc_check_every_turns,
        peer_heartbeat_seconds=args.peer_heartbeat,
        metrics=args.metrics,
        flight_recorder_depth=args.flight_recorder_depth,
        telemetry_sample_seconds=args.telemetry_sample_seconds,
        device=args.device,
    )


@contextlib.contextmanager
def _trace(log_dir):
    """A ``torch.profiler`` capture of the run, written as
    ``log_dir/trace.json``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _refuse_cli_unported(args) -> None:
    if args.coordinator is not None or args.num_processes != 1:
        raise NotImplementedError(
            "multi-host runs (--coordinator, --num-processes: process-spanning "
            "meshes) are not ported yet (ROADMAP A8, parallel/multihost.py)"
        )


def build_serve_parser() -> argparse.ArgumentParser:
    """The ``serve`` subcommand: run one pod of the multi-tenant serving
    plane — scripted tenants and/or re-adopted parked ones — until every
    session reaches a terminal state or a SIGTERM drains the pod."""
    ap = argparse.ArgumentParser(
        prog="distributed_gol_torch serve",
        description="multi-tenant serving pod: admission control, "
        "per-session fault isolation, graceful SIGTERM drain",
    )
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME:WxHxTURNS",
                    help="submit one tenant session (repeatable), e.g. "
                    "alice:512x512x10000; each gets a seeded soup board "
                    "(seed derived from the name) and its own scoped "
                    "checkpoint dir under --checkpoint-root")
    ap.add_argument("--checkpoint-root", default=None, metavar="DIR",
                    help="per-tenant checkpoint directories live under "
                    "DIR/<tenant>; required for drain durability and "
                    "--readopt")
    ap.add_argument("--readopt", action="store_true",
                    help="re-adopt every parked (resumable) tenant found "
                    "under --checkpoint-root — the restarted-pod half of "
                    "the drain contract; each resumes toward --turns")
    ap.add_argument("--turns", type=int, default=10_000,
                    help="turn target for re-adopted tenants (a resumed "
                    "run continues from its checkpoint turn toward this)")
    ap.add_argument("--max-sessions", type=int, default=4,
                    help="resident session budget (concurrent runs)")
    ap.add_argument("--max-queued", type=int, default=8,
                    help="bounded admission wait queue; submissions past "
                    "it are shed with AdmissionRejected")
    ap.add_argument("--max-cells", type=int, default=2**24,
                    help="per-session board budget in cells")
    ap.add_argument("--max-total-cells", type=int, default=2**26,
                    help="pod-wide cell budget (0 = unbounded)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="dispatch watchdog deadline stamped on every "
                    "session (0 = off): a wedged tenant aborts itself "
                    "instead of pinning a pod worker")
    ap.add_argument("--soup", type=float, default=0.3,
                    help="soup density for scripted tenant boards")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "roll", "pallas", "packed", "pallas-packed"])
    ap.add_argument("--superstep", type=int, default=0,
                    help="generations per dispatch (0 = auto)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the boards live and the engines run (cuda "
                         "fails when no CUDA GPU is available)")
    ap.add_argument("--checkpoint-every-turns", type=int, default=0,
                    help="periodic durable checkpoint cadence per session")
    ap.add_argument("--restart-limit", type=int, default=0,
                    help="per-session rollback-recovery supervisor budget "
                    "(not ported yet: only 0 is accepted)")
    ap.add_argument("--sdc-check-every-turns", type=int, default=0,
                    help="per-session SDC sentinel cadence")
    ap.add_argument("--drain-timeout", type=float, default=60.0,
                    help="seconds a SIGTERM drain waits for resident "
                    "sessions to emergency-checkpoint")
    ap.add_argument("--batched", action="store_true",
                    help="coalesce resident same-shape/same-rule tenants "
                    "into shared launch cohorts: one batched device launch "
                    "per superstep advances every cohort member — pair "
                    "with an explicit --superstep so tenants share a "
                    "dispatch schedule")
    ap.add_argument("--gateway-port", type=int, default=None, metavar="PORT",
                    help="expose the HTTP/WebSocket gateway on PORT "
                    "(0 = ephemeral; the bound URL is printed to stderr "
                    "and published as the gateway.endpoint info label): "
                    "POST /v1/sessions submissions through the admission "
                    "ladder, pause/resume/quit control, controller event "
                    "streams and spectator frame streams over WebSocket, "
                    "drain-over-the-wire (drive with tools/gol_client.py). "
                    "The pod then serves until drained (SIGTERM, Ctrl-C, "
                    "or POST /v1/drain) instead of exiting when scripted "
                    "tenants finish; wire submissions run on --device")
    # The gateway's bind address and wire hardening (ServeConfig); they
    # act only with --gateway-port.
    ap.add_argument("--gateway-host", default="127.0.0.1",
                    help="gateway bind address (0.0.0.0 for off-host "
                    "controllers/spectators)")
    ap.add_argument("--wire-read-timeout", type=float, default=30.0,
                    metavar="SECONDS",
                    help="per-connection read deadline on the gateway: "
                    "a request trickling slower than this is answered "
                    "408 and reaped (0 = off)")
    ap.add_argument("--wire-body-cap", type=int, default=1 << 26,
                    metavar="BYTES",
                    help="request-body Content-Length bound; past it "
                    "the answer is 413, never a buffered read")
    ap.add_argument("--wire-max-connections", type=int, default=0,
                    metavar="N",
                    help="concurrent-connection bound on the gateway; "
                    "past it a new connection gets a raw 503 (0 = "
                    "unbounded)")
    ap.add_argument("--ws-keepalive", type=float, default=0.0,
                    metavar="SECONDS",
                    help="WebSocket ping/pong keepalive interval on the "
                    "gateway's legs: a peer silent for 3 consecutive "
                    "intervals is dropped (0 = off)")
    ap.add_argument("--ws-max-frame", type=int, default=1 << 20,
                    metavar="BYTES",
                    help="inbound WebSocket frame cap; an over-length "
                    "declaration is a protocol error, not an allocation")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="expose /metrics (OpenMetrics), /healthz, and "
                    "/slo on PORT (0 = ephemeral; the bound URL is "
                    "printed to stderr) — bounded-time scrapes served "
                    "from the pod sampler's latest sample")
    ap.add_argument("--telemetry-sample-seconds", type=float, default=1.0,
                    help="pod registry sampling cadence (the staleness "
                    "bound of health responses); 0 disables the "
                    "sampler and every health() takes a direct snapshot")
    ap.add_argument("--slo-latency", type=float, default=0.0,
                    metavar="SECONDS",
                    help="per-tenant latency SLO: the configured "
                    "percentile of dispatches must resolve within "
                    "SECONDS (0 = no latency objective)")
    ap.add_argument("--slo-latency-percentile", type=float, default=0.99)
    ap.add_argument("--slo-error-rate", type=float, default=0.0,
                    metavar="FRACTION",
                    help="per-tenant error-rate SLO: at most FRACTION of "
                    "dispatch attempts may fail (0 = no error objective)")
    ap.add_argument("--slo-fast-window", type=float, default=60.0,
                    metavar="SECONDS")
    ap.add_argument("--slo-slow-window", type=float, default=300.0,
                    metavar="SECONDS")
    ap.add_argument("--slo-burn-threshold", type=float, default=2.0,
                    help="burn-rate alert threshold: page when BOTH "
                    "windows burn the error budget faster than this "
                    "multiple of the sustainable pace")
    ap.add_argument("--slo-queue-wait", type=float, default=0.0,
                    metavar="SECONDS",
                    help="queue-wait SLO (0 = off): the latency percentile "
                    "of admissions must start within this many seconds "
                    "of submit")
    ap.add_argument("--trace-sample-rate", type=float, default=1.0,
                    metavar="RATE",
                    help="head-sampling rate in [0, 1]: fraction of "
                    "request traces retained (error traces are "
                    "tail-retained regardless)")
    ap.add_argument("--trace-ring-depth", type=int, default=256,
                    help="finished-trace ring depth")
    return ap


def _parse_tenant_spec(spec: str) -> tuple[str, int, int, int]:
    name, sep, geo = spec.partition(":")
    parts = geo.split("x")
    if not sep or not name or len(parts) != 3 or not all(p.isdigit() for p in parts):
        raise ValueError(
            f"--tenant wants NAME:WxHxTURNS (e.g. alice:512x512x10000), "
            f"got {spec!r}"
        )
    w, h, turns = (int(p) for p in parts)
    return name, w, h, turns


def serve_main(argv) -> int:
    import json
    import zlib

    from distributed_gol_torch.serve import AdmissionRejected, ServeConfig, ServePlane

    ap = build_serve_parser()
    args = ap.parse_args(argv)
    try:
        specs = [_parse_tenant_spec(s) for s in args.tenant]
    except ValueError as e:
        ap.error(str(e))
    if not specs and not args.readopt and args.gateway_port is None:
        ap.error(
            "nothing to serve: pass --tenant, --readopt, and/or "
            "--gateway-port"
        )
    if args.readopt and not args.checkpoint_root:
        ap.error("--readopt needs --checkpoint-root")
    try:
        config = ServeConfig(
            max_sessions=args.max_sessions,
            max_queued=args.max_queued,
            max_cells_per_session=args.max_cells,
            max_total_cells=args.max_total_cells,
            default_deadline_seconds=args.deadline,
            drain_timeout_seconds=args.drain_timeout,
            batched=args.batched,
            telemetry_sample_seconds=args.telemetry_sample_seconds,
            slo_latency_seconds=args.slo_latency,
            slo_latency_percentile=args.slo_latency_percentile,
            slo_error_rate=args.slo_error_rate,
            slo_fast_window_seconds=args.slo_fast_window,
            slo_slow_window_seconds=args.slo_slow_window,
            slo_burn_threshold=args.slo_burn_threshold,
            slo_queue_wait_seconds=args.slo_queue_wait,
            trace_sample_rate=args.trace_sample_rate,
            trace_ring_depth=args.trace_ring_depth,
            wire_read_timeout_seconds=args.wire_read_timeout,
            wire_body_cap_bytes=args.wire_body_cap,
            wire_max_connections=args.wire_max_connections,
            ws_keepalive_seconds=args.ws_keepalive,
            ws_max_frame_bytes=args.ws_max_frame,
        )
    except ValueError as e:
        ap.error(str(e))
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    def tenant_params(name: str, w: int, h: int, turns: int) -> Params:
        return Params(
            turns=turns,
            image_width=w,
            image_height=h,
            engine=args.engine,
            superstep=args.superstep,
            soup_density=args.soup,
            soup_seed=zlib.crc32(name.encode()) & 0x7FFFFFFF,
            out_dir=Path(args.checkpoint_root or "out") / name,
            checkpoint_every_turns=args.checkpoint_every_turns,
            restart_limit=args.restart_limit,
            sdc_check_every_turns=args.sdc_check_every_turns,
            turn_events="batch",
            device=args.device,
        )

    plane = ServePlane(config, checkpoint_root=args.checkpoint_root)
    try:
        restore = plane.install()  # SIGTERM -> drain
    except ValueError:
        # Embedded use (serve_main on a non-main thread — tests, a
        # supervising harness): no signal routing; drain arrives
        # programmatically instead.
        def restore() -> None:
            pass
    telemetry = gateway = None
    handles = []
    try:
        if args.telemetry_port is not None:
            from distributed_gol_torch.serve.telemetry import serve_plane_telemetry

            telemetry = serve_plane_telemetry(plane, port=args.telemetry_port)
            print(f"telemetry: {telemetry.url}/metrics /healthz /slo", file=sys.stderr)
        if args.gateway_port is not None:
            from distributed_gol_torch.serve.gateway import serve_plane_gateway

            gateway = serve_plane_gateway(
                plane, port=args.gateway_port, host=args.gateway_host, device=args.device
            )
            # The BOUND endpoint: an ephemeral port 0 is resolved here.
            print(
                f"gateway: {gateway.url}/v1/sessions "
                f"(ws: /v1/sessions/<tenant>/events|frames; "
                f"drive with tools/gol_client.py {gateway.url})",
                file=sys.stderr,
                flush=True,
            )
        if args.readopt:
            for name, info in plane.resumable_tenants().items():
                shape = info.get("shape")
                # Old sidecars may lack the shape field: without it the
                # Params cannot be rebuilt, so skip that one tenant rather
                # than crash the whole restarted pod.
                if not isinstance(shape, (list, tuple)) or len(shape) != 2:
                    print(f"cannot re-adopt {name}: checkpoint sidecar "
                          f"has no board shape", file=sys.stderr)
                    continue
                h, w = shape
                specs.append((name, w, h, max(args.turns, info["turn"])))
                print(f"re-adopting {name}: turn {info['turn']}, {w}x{h}",
                      file=sys.stderr)
        for name, w, h, turns in specs:
            try:
                params = tenant_params(name, w, h, turns)
                if gateway is not None:
                    # Through the gateway's books, so scripted and
                    # re-adopted tenants are wire-controllable too.
                    handles.append(gateway.local_submit(name, params))
                else:
                    handles.append(plane.submit(name, params))
            except AdmissionRejected as e:
                print(f"tenant {name} shed: {e}", file=sys.stderr)
        for handle in handles:
            handle.wait()
        if gateway is not None:
            # A gateway pod is a SERVER: scripted tenants finishing does
            # not end it — serve until a drain lands (SIGTERM, Ctrl-C,
            # or POST /v1/drain over the wire).
            try:
                while not plane.draining:
                    time.sleep(0.25)
            except KeyboardInterrupt:
                pass
        summary = plane.drain()  # no-op when every session already ended
        receipt = {"health": plane.health(), "sessions": summary}
        if gateway is not None:
            receipt["gateway"] = {"endpoint": gateway.url}
        print(json.dumps(receipt))
    finally:
        restore()
        if telemetry is not None:
            telemetry.close()
        if gateway is not None:
            gateway.close()
        plane.close()
    bad = [h for h in handles if h.status == "failed"]
    return 1 if bad else 0


def broker_main(argv) -> int:
    """The ``broker`` subcommand: front N gateway pods with
    the health-probed federation tier — tenant placement by live
    capacity, pod condemnation on probe misses, checkpoint-driven
    failover and live migration (docs/API.md "Federation").  The broker
    process never touches a device: importable and runnable on a
    machine with no accelerator at all."""
    from distributed_gol_torch.serve.broker import Broker, BrokerConfig

    ap = argparse.ArgumentParser(
        prog="distributed_gol_torch broker",
        description="pod-federation broker: health-probed placement, "
        "failover, live migration over N serving pods",
    )
    ap.add_argument("--pod", action="append", default=[], metavar="URL",
                    help="one pod gateway endpoint (repeatable), e.g. "
                    "http://127.0.0.1:9191 — the URL a pod's serve "
                    "--gateway-port printed")
    ap.add_argument("--port", type=int, default=0,
                    help="broker bind port (0 = ephemeral; the bound "
                    "URL is printed to stderr and published as the "
                    "broker.endpoint info label)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--checkpoint-root", default=None, metavar="DIR",
                    help="the SHARED checkpoint root every pod mounts — "
                    "what failover scans for adoptable durable state")
    ap.add_argument("--probe-interval", type=float, default=0.5,
                    help="health-probe cadence per pod (seconds)")
    ap.add_argument("--probe-timeout", type=float, default=2.0,
                    help="per-probe answer budget (seconds)")
    ap.add_argument("--probe-miss-threshold", type=int, default=3,
                    help="consecutive misses that condemn a pod")
    ap.add_argument("--rejoin-threshold", type=int, default=2,
                    help="consecutive healthy probes that readmit a "
                    "condemned pod to the placement ring")
    ap.add_argument("--no-failover", action="store_true",
                    help="condemn-and-route-around only: leave a dead "
                    "pod's tenants for an operator (POST /v1/recover)")
    ap.add_argument("--recover", action="store_true",
                    help="at startup, sweep the shared root for orphaned "
                    "resumable checkpoints no live pod claims and "
                    "readopt them onto the fleet")
    ap.add_argument("--collector", action="store_true",
                    help="ride the fleet observability collector "
                    "in this broker: scrape every pod's "
                    "/metrics + /healthz and serve /fleet/* (aggregated "
                    "metrics, stitched traces, merged postmortem) from "
                    "the broker's port")
    ap.add_argument("--collector-interval", type=float, default=0.5,
                    help="fleet scrape cadence, seconds")
    ap.add_argument("--collector-scrape-timeout", type=float, default=2.0,
                    help="per-node scrape answer budget, seconds (a "
                    "wedged node costs one timeout per round, never a "
                    "wedged collector)")
    args = ap.parse_args(argv)
    if not args.pod:
        ap.error("a broker needs at least one --pod URL")
    try:
        config = BrokerConfig(
            probe_interval_seconds=args.probe_interval,
            probe_timeout_seconds=args.probe_timeout,
            probe_miss_threshold=args.probe_miss_threshold,
            rejoin_threshold=args.rejoin_threshold,
            checkpoint_root=args.checkpoint_root,
            failover=not args.no_failover,
            collector=args.collector,
            collector_interval_seconds=args.collector_interval,
            collector_scrape_timeout_seconds=args.collector_scrape_timeout,
        )
    except ValueError as e:
        ap.error(str(e))
    broker = Broker(args.pod, config, port=args.port, host=args.host)
    print(
        f"broker: {broker.url}/v1/sessions fronting {len(args.pod)} "
        f"pod(s) (fleet: {broker.url}/v1/pods; drive with "
        f"tools/gol_client.py {broker.url})",
        file=sys.stderr,
    )
    if args.collector:
        print(
            f"collector: {broker.url}/fleet/metrics /fleet/healthz "
            f"/fleet/slo /fleet/traces/<id> /fleet/flight",
            file=sys.stderr,
        )
    try:
        if args.recover:
            broker.probe_once()  # placement needs at least one health
            import json as json_mod
            import urllib.request

            req = urllib.request.Request(
                broker.url + "/v1/recover", method="POST"
            )
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = json_mod.loads(resp.read())
            print(f"recover: {out}", file=sys.stderr)
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        broker.close()
    return 0


def relay_main(argv) -> int:
    """The ``relay`` subcommand: one node of the spectator
    broadcast tree — subscribe ONCE to an upstream frame stream (a
    gateway pod's spectator leg, or another relay) and re-fan it to M
    downstream WebSocket viewers off the local re-keyframe cache
    (docs/API.md "Relay tier").  Like the broker, a relay never touches
    a device: runnable on a machine with no accelerator at all."""
    from distributed_gol_torch.serve.relay import (
        BACKOFF_MAX,
        DEFAULT_CACHE_DELTAS,
        DEFAULT_KEEPALIVE,
        DEFAULT_QUEUE_DEPTH,
        RelayServer,
    )

    ap = argparse.ArgumentParser(
        prog="distributed_gol_torch relay",
        description="spectator relay: subscribe once upstream, fan the "
        "frame stream to M downstream viewers (chainable to any depth)",
    )
    ap.add_argument("--upstream", required=True, metavar="URL",
                    help="the spectator stream to relay: a gateway leg "
                    "(http://pod/v1/sessions/<t>/frames?rect=...) or "
                    "another relay (http://relay/v1/frames)")
    ap.add_argument("--port", type=int, default=0,
                    help="relay bind port (0 = ephemeral; the bound URL "
                    "is printed to stderr and published as the "
                    "relay.endpoint info label)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--cache-deltas", type=int,
                    default=DEFAULT_CACHE_DELTAS, metavar="N",
                    help="deltas retained past the cached keyframe "
                    "before compaction (the late-joiner window)")
    ap.add_argument("--queue-depth", type=int,
                    default=DEFAULT_QUEUE_DEPTH, metavar="N",
                    help="per-viewer bounded queue depth (drop-oldest "
                    "+ cache resync past it)")
    ap.add_argument("--backoff-max", type=float, default=BACKOFF_MAX,
                    help="resubscribe backoff cap, seconds")
    ap.add_argument("--keepalive", type=float, default=DEFAULT_KEEPALIVE,
                    metavar="SECONDS",
                    help="upstream ping/pong keepalive interval: an "
                    "upstream that answers neither frames nor "
                    "pongs for 3 consecutive intervals is a half-open "
                    "stall, dropped and resubscribed like a disconnect "
                    "(0 = unbounded blocking reads)")
    args = ap.parse_args(argv)
    relay = RelayServer(
        args.upstream,
        port=args.port,
        host=args.host,
        cache_deltas=args.cache_deltas,
        queue_depth=args.queue_depth,
        backoff_max=args.backoff_max,
        keepalive_seconds=args.keepalive,
    )
    print(
        f"relay: {relay.url}/v1/frames <- {args.upstream} "
        f"(watch with tools/gol_client.py --relay {relay.url}; "
        f"chain with --upstream {relay.url}/v1/frames)",
        file=sys.stderr,
    )
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        relay.close()
    return 0


def collector_main(argv) -> int:
    """The ``collector`` subcommand: the standalone fleet
    observability plane — scrape every node's ``/metrics`` +
    ``/healthz`` on a cadence and serve ONE aggregated surface:
    ``/fleet/metrics`` (node-labelled + fleet-aggregate OpenMetrics),
    ``/fleet/healthz``, ``/fleet/slo`` (fleet-level per-tenant burn
    over the aggregate — a tenant migrated mid-window keeps one
    continuous budget), ``/fleet/traces/<id>`` (cross-process stitch)
    and ``/fleet/flight`` (the merged postmortem).  Device-less, like
    the broker and relay; the same surface rides in-broker via
    ``broker --collector`` (docs/API.md "Fleet observability")."""
    from distributed_gol_torch.obs.fleet import (
        CollectorServer,
        FleetCollector,
        node_name,
    )
    from distributed_gol_torch.obs.slo import SLOObjectives

    ap = argparse.ArgumentParser(
        prog="distributed_gol_torch collector",
        description="fleet observability collector: federated scrape "
        "plane, cross-process trace stitching, one merged postmortem "
        "timeline over N nodes (pods, brokers, relays)",
    )
    ap.add_argument("--node", action="append", default=[],
                    metavar="[NAME=]URL",
                    help="one node to scrape (repeatable): a pod "
                    "gateway, broker, relay, or telemetry endpoint — "
                    "optionally named (name=http://...); unnamed nodes "
                    "are labelled by their host:port")
    ap.add_argument("--port", type=int, default=0,
                    help="collector bind port (0 = ephemeral; the "
                    "bound URL is printed to stderr and published as "
                    "the fleet.endpoint info label)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="scrape cadence, seconds")
    ap.add_argument("--scrape-timeout", type=float, default=2.0,
                    help="per-node scrape answer budget, seconds (a "
                    "wedged node costs one timeout per round and a "
                    "fleet.scrape_misses bump, never a wedged "
                    "collector)")
    ap.add_argument("--checkpoint-root", default=None, metavar="DIR",
                    help="the federation's shared checkpoint root: "
                    "on-disk flight-*.json abort dumps under it join "
                    "the /fleet/flight merged timeline")
    ap.add_argument("--slo-latency", type=float, default=0.0,
                    help="fleet per-tenant dispatch-latency objective, "
                    "seconds (0 = off)")
    ap.add_argument("--slo-latency-percentile", type=float, default=0.99)
    ap.add_argument("--slo-error-rate", type=float, default=0.0,
                    help="fleet per-tenant dispatch error-rate "
                    "objective (0 = off)")
    ap.add_argument("--slo-fast-window", type=float, default=60.0)
    ap.add_argument("--slo-slow-window", type=float, default=300.0)
    ap.add_argument("--slo-burn-threshold", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not args.node:
        ap.error("a collector needs at least one --node URL")
    nodes = {}
    for spec in args.node:
        name, eq, rest = spec.partition("=")
        if eq and "://" not in name:
            nodes[name] = rest
        else:
            nodes[node_name(spec)] = spec
    objectives = None
    if args.slo_latency > 0 or args.slo_error_rate > 0:
        try:
            objectives = SLOObjectives(
                latency_seconds=args.slo_latency,
                latency_percentile=args.slo_latency_percentile,
                error_rate=args.slo_error_rate,
                fast_window_seconds=args.slo_fast_window,
                slow_window_seconds=args.slo_slow_window,
                burn_threshold=args.slo_burn_threshold,
            )
        except ValueError as e:
            ap.error(str(e))
    try:
        collector = FleetCollector(
            nodes,
            interval=args.interval,
            scrape_timeout=args.scrape_timeout,
            checkpoint_root=args.checkpoint_root,
            objectives=objectives,
        )
    except ValueError as e:
        ap.error(str(e))
    server = CollectorServer(collector, port=args.port, host=args.host)
    print(
        f"collector: {server.url}/fleet/metrics /fleet/healthz "
        f"/fleet/slo /fleet/traces/<id> /fleet/flight scraping "
        f"{len(nodes)} node(s) every {args.interval}s "
        f"(fleet top: tools/pod_top.py {server.url})",
        file=sys.stderr,
    )
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "broker":
        return broker_main(argv[1:])
    if argv and argv[0] == "relay":
        return relay_main(argv[1:])
    if argv and argv[0] == "collector":
        return collector_main(argv[1:])
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        _refuse_cli_unported(args)
        params = params_from_args(args)
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))  # clean usage error, exit 2 — not a traceback
    try:
        resolve_device(params.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    session = Session(args.checkpoint_dir) if args.checkpoint_dir else default_session()
    if args.telemetry_port is not None:
        if not args.metrics:
            # gol.run gates the whole telemetry plane on the registry:
            # say so instead of printing an endpoint that never binds.
            print("telemetry disabled: --no-metrics", file=sys.stderr)
        elif args.telemetry_port:
            print(f"telemetry: /metrics + /healthz on http://127.0.0.1:{args.telemetry_port}",
                  file=sys.stderr)
        else:
            print("telemetry: /metrics + /healthz on an ephemeral port "
                  "(published as the telemetry.endpoint info label)", file=sys.stderr)

    events = EventQueue()
    key_presses: queue.Queue = queue.Queue()
    stop = threading.Event()
    restore_tty = keyboard_listener(key_presses, stop)
    # SIGTERM (a preemption notice) → graceful stop: the engine drains at
    # the next turn boundary, forces an emergency checkpoint and exits
    # paused-and-resumable.  Ctrl-C keeps its 'q' detach.
    graceful = GracefulStop()
    restore_signals = graceful.install((signal.SIGTERM,))
    tracer = _trace(args.trace) if args.trace else contextlib.nullcontext()
    with tracer:
        engine = start(params, events, key_presses, session, stop=graceful,
                       telemetry_port=args.telemetry_port)
        try:
            if params.no_vis:
                final = run_headless(params, events)
            elif args.window:
                from distributed_gol_torch.viewer.window import run_window

                final = run_window(params, events, key_presses)
            else:
                final = run_terminal(params, events)
        except KeyboardInterrupt:
            key_presses.put("q")  # graceful detach, checkpoint parked on session
            final = run_headless(params, events)
        finally:
            stop.set()
            restore_signals()
            if restore_tty is not None:
                restore_tty()
        engine.join(timeout=30)
    if final is None:
        # The stream ended without a FinalTurnComplete: the engine died
        # (its traceback went to stderr).  Scripts must see the failure.
        print("error: engine terminated without completing", file=sys.stderr)
        return 1
    print(f"Final turn {final.completed_turns}: {len(final.alive)} alive")
    return 0


if __name__ == "__main__":
    sys.exit(main())
