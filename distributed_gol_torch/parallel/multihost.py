"""Multi-host (multi-process) execution — the row mesh across processes.

Counterpart of ``distributed_gol_tpu/parallel/multihost.py``.  The JAX
package runs one board over a **process-spanning** ``jax.sharding.Mesh``,
whose ``ppermute`` edges XLA carries between processes.  The port's mesh
holds tensors of one process, so the span is explicit: every process
(a ``torch.distributed`` rank) owns a contiguous row band of the board,
its local devices subdivide the band (:func:`global_row_mesh`), and the
mesh carries a ``parallel.mesh.RankSpan`` through which the band's two
end edges, the sums and the gathers cross between ranks.  The engine
drivers (``parallel/halo.py``, ``parallel/packed_halo.py``,
``parallel/cuda_halo.py``) are the single-process ones: each rank
launches the row-mesh kernels (K9-K12) on its own strips, and only the
lookup of a neighbour's edge (``halo.neighbour_edges``) knows that the
neighbour may live in another process.  Only the two band-boundary edges
per neighbouring pair cross per exchange.

Transport: gloo (``torch.distributed``) on both the CPU and the card.
gloo's send and receive take CPU tensors, so on the card each rank
stages its edges through host memory; NCCL cannot give two ranks the
same card, which is how one H100 hosts a two-rank run.  Every collective
has an explicit bound (:data:`COLLECTIVE_TIMEOUT_SECONDS`, gloo's default
being 30 minutes), and the controller's watchdog bounds the control
plane's broadcasts on top.  A process-spanning mesh always takes the
ppermute exchange tier (``cuda_halo.tier_policy``): the in-kernel tier
(K14, K15) reads its neighbours in place, in memory another process
holds.

Control plane: process 0 is the controller (events, keypresses, PGM and
checkpoint files); the other processes run the same dispatch schedule
and block in the collectives.  What must stay the same on every process
goes out as broadcasts from process 0: key presses (:class:`_BroadcastKeys`),
the adaptive superstep, the resume negotiation and the emergency-save
decision; the stop poll is an allgather, and a UDP
:class:`PeerHeartbeat` turns a peer that died hard into a bounded
:class:`PeerLost` abort.

Local devices (:func:`local_devices`): on the card, the CUDA devices the
process sees (with none, it raises: no CPU fallback); on the CPU, the
count the ``DGOL_CPU_DEVICES`` environment variable pins (default 1), the
counterpart of the JAX worker's
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from distributed_gol_torch.engine.controller import DispatchTimeout
from distributed_gol_torch.obs import spans
from distributed_gol_torch.parallel import mesh as mesh_lib


class PeerLost(DispatchTimeout):
    """A peer rank went silent past the heartbeat bound.  The survivors
    abort with the stream sentinel; the newest periodic checkpoint is the
    resumable state (the multi-host park policy never fetches
    collectively after a failure — a dead peer cannot join).

    Raised from two seams, both bounded by the HEARTBEAT timeout rather
    than the (necessarily build-conservative) dispatch deadline: the
    turn-boundary poll (``_stop_now``), and the dispatch watchdog's
    mid-wait ``interrupt`` hook — a survivor already blocked in a
    collective its dead peer never joins must not sit out the full
    deadline.  At the controller seam it is re-classed as a
    :class:`~distributed_gol_torch.engine.controller.DispatchTimeout`
    subtype (terminal, never retried): a collective whose peer is dead
    can never complete, so retrying is the one guaranteed-futile
    response."""


#: A peer is declared dead after this many missed heartbeat intervals —
#: one lost UDP datagram must not condemn a rank, three in a row is a
#: dead process on any sane network.
HEARTBEAT_MISS_FACTOR = 3.0

#: The bound on every gloo operation (the process group's timeout): the
#: longest one rank may wait for a peer inside a collective — a kernel
#: build on one rank while the other already exchanges, at worst.
COLLECTIVE_TIMEOUT_SECONDS = 300.0

#: The environment variable that pins a CPU process's device count.
CPU_DEVICES_ENV = "DGOL_CPU_DEVICES"

# The coordinator's host, once :func:`initialize` has run with a TCP
# rendezvous: the heartbeat advertises the interface that reaches it.
_COORDINATOR_HOST: str | None = None


def _rank_world() -> tuple[int, int]:
    """(this process's rank, the world size); (0, 1) before
    :func:`initialize` (a single-process run)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class PeerHeartbeat:
    """Lightweight peer liveness beside the collective stream.

    Every rank UDP-pings every other rank on ``interval`` seconds from a
    daemon thread and tracks when it last heard each peer; a rank silent
    for ``HEARTBEAT_MISS_FACTOR x interval`` is reported by
    :meth:`dead_peers`.  Deliberately OUTSIDE the collective transport:
    the keys/superstep broadcasts only detect a dead rank once a survivor
    blocks in a collective the corpse never joins (bounded by the
    dispatch watchdog), and gloo's own timeout is minutes.  This detector
    works at turn boundaries even while no collective is in flight, names
    the dead rank, and costs one tiny datagram per peer per interval.

    ``start()`` exchanges addresses over ONE gloo allgather (call on every
    rank together — arm uniformly, like ``stop``); tests inject
    ``peer_addrs`` directly and need no process group.  The advertised
    address is the interface that reaches the coordinator (loopback rigs:
    127.0.0.1); single-process runs have no peers and never report one
    dead."""

    def __init__(
        self,
        interval: float,
        process_id: int | None = None,
        num_processes: int | None = None,
    ):
        if interval <= 0:
            raise ValueError("heartbeat interval must be positive")
        self.interval = interval
        self.timeout = HEARTBEAT_MISS_FACTOR * interval
        rank, world = _rank_world()
        self._pid = process_id if process_id is not None else rank
        self._n = num_processes if num_processes is not None else world
        self._sock = None
        self._addr: tuple[str, int] | None = None
        self._peers: dict[int, tuple[str, int]] = {}
        self._last: dict[int, float] = {}
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    def _bind(self) -> tuple[str, int]:
        import socket

        if self._sock is not None:  # idempotent: tests bind early for the port
            return self._addr
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("0.0.0.0", 0))
        # Short poll so one loop both sends on cadence and drains receipts.
        self._sock.settimeout(self.interval / 4)
        port = self._sock.getsockname()[1]
        self._addr = (self._advertised_host(), port)
        return self._addr

    @staticmethod
    def _advertised_host() -> str:
        """The IP peers should ping.  A UDP connect() toward the
        coordinator resolves the OUTBOUND interface that reaches the
        cluster without sending a packet — ``gethostbyname(gethostname())``
        is wrong on Debian-style hosts, where /etc/hosts maps the hostname
        to 127.0.1.1 and every rank would advertise an unreachable
        loopback.  The coordinator is the one address every rank already
        reaches; without a TCP rendezvous (a ``file://`` store: ranks of
        one machine) the answer is loopback."""
        import socket

        if _COORDINATOR_HOST is None:
            return "127.0.0.1"
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.settimeout(1.0)
            try:
                s.connect((_COORDINATOR_HOST, 9))  # routing lookup only, no I/O
                return s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            return "127.0.0.1"

    def _exchange(self, host: str, port: int) -> dict[int, tuple[str, int]]:
        """One collective ``host:port`` allgather (64-byte padded rows,
        the ``gather_metrics_snapshots`` transport pattern)."""
        payload = f"{host}:{port}".encode()
        if len(payload) > 64:
            raise ValueError(f"heartbeat address too long: {payload!r}")
        buf = np.zeros(64, dtype=np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
        rows = _allgather(buf)
        out = {}
        for r in range(rows.shape[0]):
            text = bytes(rows[r]).rstrip(b"\x00").decode()
            h, _, p = text.rpartition(":")
            out[r] = (h, int(p))
        return out

    def start(self, peer_addrs: dict[int, tuple[str, int]] | None = None):
        """Bind, exchange addresses (collectively, unless injected), and
        start the ping/listen daemon.  Returns self."""
        host, port = self._bind()
        if peer_addrs is None:
            peer_addrs = self._exchange(host, port)
        self._peers = {r: a for r, a in peer_addrs.items() if r != self._pid}
        now = time.monotonic()
        self._last = {r: now for r in self._peers}  # grace: start = heard
        self._thread = threading.Thread(
            target=self._loop, name="gol-peer-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self):
        import socket

        msg = str(self._pid).encode()
        next_send = 0.0
        while not self._stop_evt.is_set():
            now = time.monotonic()
            if now >= next_send:
                for addr in self._peers.values():
                    try:
                        self._sock.sendto(msg, addr)
                    except OSError:
                        pass  # unreachable peer: its silence is the signal
                next_send = now + self.interval
            try:
                data, _ = self._sock.recvfrom(64)
                rank = int(data)
                if rank in self._last:
                    self._last[rank] = time.monotonic()
            except (socket.timeout, ValueError, OSError):
                continue

    def dead_peers(self) -> list[int]:
        """Ranks silent past the bound (empty = everyone alive)."""
        now = time.monotonic()
        return sorted(
            r for r, t in self._last.items() if now - t > self.timeout
        )

    def stop(self) -> None:
        self._stop_evt.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)


def _loopback_interface() -> str | None:
    """The name of the loopback network interface, if there is one."""
    import socket

    return next((n for _, n in socket.if_nameindex() if n == "lo"), None)


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    timeout: float = COLLECTIVE_TIMEOUT_SECONDS,
) -> None:
    """Join the process group: gloo, rendezvous at ``coordinator``
    (``HOST:PORT``, process 0 listens there; or a ``file://`` URL that
    every process of one machine can reach), every operation bounded by
    ``timeout`` seconds.  A loopback coordinator (or a file store) keeps
    gloo on the loopback interface, so ranks of one machine never look
    their host name up."""
    global _COORDINATOR_HOST

    if "://" in coordinator:
        init_method, host = coordinator, None
    else:
        init_method, host = f"tcp://{coordinator}", coordinator.rpartition(":")[0]
    local = host is None or host == "localhost" or host.startswith("127.")
    if local and "GLOO_SOCKET_IFNAME" not in os.environ:
        lo = _loopback_interface()
        if lo is not None:
            os.environ["GLOO_SOCKET_IFNAME"] = lo
    dist.init_process_group(
        "gloo",
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=timeout),
    )
    _COORDINATOR_HOST = host


def local_devices(kind: str) -> list:
    """This process's devices of ``kind``: the CUDA devices it sees
    (raises when there are none — never the CPU instead), or
    ``DGOL_CPU_DEVICES`` virtual CPU devices (default 1)."""
    if kind == "cuda":
        devices = mesh_lib.device_pool("cuda")
        if not devices:
            raise RuntimeError(
                "multi-host device 'cuda' requested but this process sees no "
                "CUDA GPU; pass --device cpu to run the plain engines on the CPU"
            )
        return devices
    return mesh_lib.cpu_devices(int(os.environ.get(CPU_DEVICES_ENV, "1")))


def global_row_mesh(device: str | None = None) -> mesh_lib.Mesh:
    """A (n_global_devices, 1) mesh spanning every process: this
    process's :func:`local_devices` of kind ``device`` (default: the
    process's kind) as its strips, rank by rank from the top, so each
    process owns a contiguous row band — a process boundary is crossed
    exactly once per direction per exchange.  Every rank must hold the
    same number of devices."""
    devices = local_devices(device or mesh_lib.default_kind())
    rank, world = _rank_world()
    counts = _allgather(np.int32(len(devices)))
    if len(set(counts.tolist())) != 1:
        raise ValueError(
            f"every process must hold the same number of devices; got {counts.tolist()}"
        )
    span = mesh_lib.RankSpan(rank, world, len(devices))
    return mesh_lib.Mesh(tuple((d,) for d in devices), span)


def put_global(board: np.ndarray, sharding):
    """Place a host-replicated board onto a process-spanning sharding.

    Every process passes the same full board (read from the shared
    filesystem, or the seeded soup); each keeps and uploads only its own
    band of shards."""
    return sharding.shard(torch.from_numpy(np.ascontiguousarray(board, dtype=np.uint8)))


def fetch_global(board) -> np.ndarray:
    """Gather a process-spanning board to a full host copy on EVERY
    process (the final-board / snapshot path)."""
    return board.gather("cpu").numpy()


def _allgather(value: np.ndarray) -> np.ndarray:
    """Every process's ``value`` (same shape and dtype everywhere),
    stacked in rank order: shape (world, *value.shape)."""
    value = np.asarray(value)
    _, world = _rank_world()
    if world == 1:
        return value[None]
    t = torch.from_numpy(np.ascontiguousarray(value).reshape(-1))
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy().reshape((world, *value.shape))


def _broadcast(value: np.ndarray) -> np.ndarray:
    """Process 0's ``value`` on every process (every process passes an
    array of the same shape and dtype)."""
    value = np.asarray(value)
    _, world = _rank_world()
    if world == 1:
        return value
    t = torch.from_numpy(np.array(value).reshape(-1))
    dist.broadcast(t, src=0)
    return t.numpy().reshape(value.shape)


def gather_metrics_snapshots(snapshot: dict) -> list[dict]:
    """Allgather every process's metrics snapshot: each process passes
    its own ``gol-metrics-v1`` dict; every process gets the full
    per-process list back, in process order.  Rides the collective
    transport — JSON bytes padded to the max length (two small
    collectives per RUN, not per dispatch, so the cost is noise).  All
    processes must call together, like every other collective."""
    payload = np.frombuffer(json.dumps(snapshot).encode(), dtype=np.uint8)
    sizes = np.atleast_1d(_allgather(np.int32(payload.size)).reshape(-1))
    width = int(sizes.max())
    padded = np.zeros(width, dtype=np.uint8)
    padded[: payload.size] = payload
    rows = np.atleast_2d(_allgather(padded))
    return [
        json.loads(bytes(rows[i, : int(sizes[i])]).decode())
        for i in range(rows.shape[0])
    ]


# -- full controller runs across processes ------------------------------------
#
# The data plane above is enough for library users; ``run_distributed`` runs
# the ENTIRE reference controller contract (events, s/p/q/k keys, snapshots,
# checkpoints, final PGM) across processes.  The invariant that makes it
# work: every process executes the identical dispatch schedule, so every
# collective (edge exchange, count sum, snapshot allgather) lines up.  That
# requires identical control decisions, which ``_BroadcastKeys`` provides by
# broadcasting process 0's keypress stream to everyone at each poll (one tiny
# collective per poll; polls happen at superstep boundaries), and the
# adaptive superstep broadcast below.  Process 0 is the controller
# (reference analog: the one machine running ``main.go``); followers feed a
# throwaway event sink and skip file writes.


class _BroadcastKeys:
    """Queue facade making every process see process 0's keypresses.

    Each ``get``/``empty`` call is one scalar broadcast, so ALL processes
    must call them in the same order — guaranteed because the controller's
    control flow is a pure function of what these calls return.

    ``watchdog`` (a ``controller._Watchdog``) bounds each broadcast: after
    a one-sided failure the surviving processes' next keys poll is a
    collective the dead peer never joins, and without the bound they hang
    there — outside the dispatch paths' own watchdog — until gloo's
    timeout."""

    def __init__(self, inner, watchdog=None):
        import queue as _queue

        self._inner = inner  # the real queue on process 0, else None
        self._queue_mod = _queue
        self._watchdog = watchdog

    def _bcast(self, value: int) -> int:
        def do():
            return int(_broadcast(np.int32(value)))

        # Annotated like every other blocking collective: a trace shows
        # WHERE a survivor sat when the peer died.
        with spans.span("gol.broadcast.keys"):
            return self._watchdog.call(do) if self._watchdog is not None else do()

    def get(self, block=False, timeout=None):
        code = 0
        if self._inner is not None:
            try:
                code = ord(self._inner.get(block=block, timeout=timeout))
            except self._queue_mod.Empty:
                code = 0
        code = self._bcast(code)
        if code == 0:
            raise self._queue_mod.Empty
        return chr(code)

    def empty(self) -> bool:
        mine = 1 if self._inner is None or self._inner.empty() else 0
        return bool(self._bcast(mine))


def make_backend(params):
    """A Backend whose board spans every process's devices (row bands) and
    whose host transfers are collective allgathers."""
    from dataclasses import replace

    from distributed_gol_torch.engine.backend import Backend
    from distributed_gol_torch.utils.device import resolve_device

    mesh = global_row_mesh(resolve_device(params.device).type)
    ny = mesh.shape["y"]
    if params.mesh_shape not in ((1, 1), (ny, 1)):
        raise ValueError(
            f"multi-host runs shard rows over all {ny} global devices; "
            f"mesh_shape must be ({ny}, 1) (or left at (1, 1) to default). "
            "2-D (ny, nx) meshes are a SINGLE-host capability: the 2-D "
            "tier's halo exchange (in-kernel remote DMA or ppermute "
            "x-halos) rides ICI, while this tier's host boundary crosses "
            "DCN, where the row-banded layout keeps each host's halo one "
            "contiguous ppermute per direction — run 2-D meshes "
            "in-process (Params.mesh_shape) on one host's devices"
        )
    params = replace(params, mesh_shape=(ny, 1))

    class MultihostBackend(Backend):
        # Backend.put and Backend.fetch are put_global and fetch_global
        # on this mesh: the sharding keeps this rank's band, and the
        # gather is an allgather.
        def _make_mesh(self, mesh_shape, devices):
            return mesh

    return MultihostBackend(params, devices=mesh.flat)


def run_distributed(params, events=None, key_presses=None, session=None, stop=None):
    """The full controller contract over a process-spanning mesh.

    Call on EVERY process after :func:`initialize`.  Process 0 drives:
    its ``events`` queue receives the stream, its ``key_presses`` queue is
    broadcast to all processes, its filesystem gets the PGMs, and its
    ``session`` holds checkpoints.  Followers pass None everywhere: they
    get throwaway in-memory sessions (a 'q' detach must persist exactly
    one checkpoint, from process 0 — ``Session`` has no cross-process
    write locking), and the resume decision is negotiated by process 0
    and broadcast, because ``check_states`` is consume-once: letting every
    process ask would hand the checkpoint to whichever asked first and
    start the rest from turn 0, diverging the SPMD schedule.
    ``params.superstep`` may be 0 (adaptive): the sizing decision is
    wall-clock-driven, so process 0 decides and broadcasts the next size
    (one scalar broadcast per resolved dispatch — the same cadence as the
    keypress broadcast) and every process runs the identical dispatch
    schedule.  The auto ``skip_stable`` long-run policy rides on this: it
    resolves from Params alone, identically everywhere.

    ``stop`` (a ``supervisor.GracefulStop``): pass one on EVERY process
    (or none) to arm preemption handling — each process installs its own
    SIGTERM handler against its own latch, and the controller's
    turn-boundary stop poll becomes a tiny allgather
    (``MultihostController._stop_now``), so ONE signalled rank drains the
    whole collective together: every process forces the emergency
    checkpoint fetch in lockstep (process 0 persists it) and exits
    paused-and-resumable, instead of the signalled rank vanishing
    mid-allgather and wedging the survivors.  Arming must be uniform —
    the poll is a collective, so stop-armed and stop-less processes would
    diverge the schedule.

    ``params.peer_heartbeat_seconds > 0`` additionally arms the
    :class:`PeerHeartbeat` membership monitor on every rank (uniformly —
    the setup address exchange is a collective): a rank that dies HARD
    (SIGKILL, machine loss) is detected locally by every survivor within
    ``HEARTBEAT_MISS_FACTOR`` intervals, and the next turn-boundary poll
    raises :class:`PeerLost` — sentinel-terminated abort, flight record
    ``peer_lost``, `multihost.peers_lost` counter, resumable from the
    newest periodic checkpoint — complementing the dispatch watchdog
    (which bounds waits INSIDE a collective) and gloo's timeout.
    """
    try:
        return _validate_and_run(params, events, key_presses, session, stop)
    except BaseException:
        # The controller guarantees the stream sentinel for failures inside
        # its run; failures BEFORE it starts — params validation, backend
        # construction, resume negotiation — must not leave a listener
        # blocked forever either.
        if events is not None:
            events.put(None)
        raise


def _validate_and_run(params, events, key_presses, session, stop):
    if not params.no_vis or params.wants_flips() or params.wants_frames():
        raise ValueError("multi-host runs are headless (no_vis=True)")
    if params.checkpoint_every_seconds:
        raise ValueError(
            "multi-host runs schedule periodic checkpoints by turn cadence "
            "only (checkpoint_every_turns): the wall-clock cadence would "
            "diverge the SPMD dispatch schedule between processes (the "
            "checkpoint fetch is a collective)"
        )
    if params.restart_limit:
        raise ValueError(
            "multi-host runs do not support the rollback-recovery "
            "supervisor yet (restart_limit must be 0): a restart tears "
            "down and rebuilds the backend, which on a process-spanning "
            "mesh is a collective act every process would have to "
            "coordinate through a failure the runtime may only have "
            "surfaced on one rank.  Refusing loudly beats silently "
            "running without the recovery the flag promised; preemption "
            "handling (stop=) and periodic checkpoints cover the "
            "resumability story across hosts."
        )
    return _run_distributed(params, events, key_presses, session, stop)


def _run_distributed(params, events, key_presses, session, stop=None):
    from distributed_gol_torch.engine.controller import Controller, _Watchdog
    from distributed_gol_torch.engine.session import Session, default_session

    rank, world = _rank_world()
    main = rank == 0
    # Peer heartbeat: armed uniformly via Params, so the setup address
    # allgather lines up on every rank like any other collective.
    heartbeat = None
    if params.peer_heartbeat_seconds > 0 and world > 1:
        heartbeat = PeerHeartbeat(params.peer_heartbeat_seconds).start()
    try:
        backend = make_backend(params)
        session = (session if session is not None else default_session()) if main else Session()

        # Resume negotiation: process 0 consumes the checkpoint (if any)
        # and broadcasts the outcome, so every process starts from the
        # same world and turn.  (With turns == 0 the reference skips
        # negotiation.)
        negotiated = None
        if params.turns > 0:
            ckpt = (
                session.check_states(
                    params.image_width, params.image_height, params.rule.notation
                )
                if main
                else None
            )
            found = int(_broadcast(np.int32(0 if ckpt is None else 1)))
            if found:
                shape = (params.image_height, params.image_width)
                world_np = _broadcast(
                    np.asarray(ckpt.world, np.uint8) if main else np.zeros(shape, np.uint8)
                )
                turn = int(_broadcast(np.int32(ckpt.turn if main else 0)))
                negotiated = (world_np, turn)
    except BaseException:
        # A failed backend build or negotiation must not leak the
        # heartbeat daemon + socket (a retrying caller would accumulate
        # one per attempt, with peers still seeing this rank alive).
        if heartbeat is not None:
            heartbeat.stop()
        raise

    class _DevNull:
        """Follower event sink: the stream only exists on process 0, and a
        real queue would grow unboundedly over a long run."""

        def put(self, _):
            pass

    ev = events if (main and events is not None) else _DevNull()
    keys = _BroadcastKeys(
        key_presses if main else None,
        _Watchdog(params.dispatch_deadline_seconds),
    )

    class MultihostController(Controller):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._peer_loss_recorded = False
            if heartbeat is not None:
                # The watchdog's mid-wait hook: a survivor blocked in a
                # collective its dead peer never joins aborts within the
                # HEARTBEAT bound, naming the rank, instead of sitting out
                # the full dispatch deadline (which must stay conservative
                # enough for kernel builds).  And its failure hook: a
                # collective that fails because gloo saw the dead peer's
                # connection close is that loss, once the heartbeat says so.
                for watchdog in (self._watchdog, keys._watchdog):
                    watchdog.interrupt = self._peer_lost_error
                    watchdog.on_error = self._peer_loss_verdict

        def _write_pgm(self, path, board_np):
            if main:
                super()._write_pgm(path, board_np)

        def _park_checkpoint(self, board, turn, guard=None):
            # The base-class checkpoint fetch is a collective allgather; a
            # dispatch failure may be one-sided (one process's runtime
            # dies), and entering a collective alone hangs this process
            # instead of aborting with the sentinel.  Skip checkpointing:
            # the terminal DispatchError still reports checkpointed=False
            # and the stream still ends.  (PERIODIC checkpoints —
            # Controller._guard_boundary — do fetch collectively: their
            # turn cadence is deterministic in the dispatch schedule, so
            # every process enters that allgather together; they are the
            # resumable state a one-sided abort leaves behind.)
            #
            # The dispatch watchdog completes this divergence-safety
            # policy: a one-sided failure leaves the SURVIVING processes
            # blocked forcing a count whose collective the dead peer never
            # joined.  With Params.dispatch_deadline_seconds set, each
            # process's own watchdog raises DispatchTimeout (terminal:
            # never retried), the stream ends with the sentinel, and
            # run_distributed re-raises — every process aborts instead of
            # hanging alone in the collective.
            return False

        def _save_checkpoint(self, world, turn):
            # Followers' sessions are throwaway and never consulted for
            # resume; storing the allgathered board would pin a full-size
            # host copy per follower per cadence.  The collective fetch
            # itself already ran (SPMD lockstep) — only the session write
            # is main-only, like _write_pgm above.
            if main:
                super()._save_checkpoint(world, turn)

        def _initial_world(self):
            if negotiated is not None:
                # The negotiation CONSUMED process 0's pair — same
                # re-park-on-early-preempt semantics as the base class.
                self._resumed = True
                return negotiated
            return self._load_input(), 0

        def _issue(self, fn):
            # The port's issue is not only an enqueue: the edge exchanges
            # and the count's sum wait on the host for the peers.  Bounded
            # like every other collective wait — by the dispatch deadline,
            # and by the heartbeat's interrupt — so a survivor blocked in
            # an exchange its dead peer never joins aborts in bounded time.
            return self._watchdog.call(fn)

        def _force_probe(self, flag):
            # The base class swallows a probe-force failure (advisory
            # single-host semantics).  Here the cycle flag gates which
            # collectives every process issues next: its *value* is
            # all-reduced and identical everywhere, but a one-sided
            # failure while forcing it would make this process silently
            # read False while peers read True — divergent collective
            # schedules, a hang.  Abort with the stream sentinel instead
            # (same policy as _park_checkpoint above); the watchdog bounds
            # the force itself, like every other blocking collective wait.
            return self._watchdog.call(lambda: bool(flag))

        def _peer_lost_error(self):
            """The heartbeat verdict, as an exception or None: purely
            LOCAL — the dead rank cannot join a collective, so the
            detection must not be one.  Every survivor's own monitor
            trips within the same bound, so each aborts independently
            with the sentinel and the newest periodic checkpoint as the
            resumable state (the supervisor/resume path adopts it);
            detection is bounded by the heartbeat timeout instead of
            gloo's.  Records the loss (metrics + flight) exactly once."""
            if heartbeat is None:
                return None
            dead = heartbeat.dead_peers()
            if not dead:
                return None
            if not self._peer_loss_recorded:
                self._peer_loss_recorded = True
                self.metrics.counter("multihost.peers_lost").inc(len(dead))
                self.flight.record(
                    "peer_lost",
                    ranks=dead,
                    timeout_s=round(heartbeat.timeout, 3),
                )
            return PeerLost(
                f"peer rank(s) {dead} silent past the heartbeat "
                f"bound ({heartbeat.timeout:.1f}s); aborting — "
                "resume from the newest periodic checkpoint"
            )

        def _peer_loss_verdict(self, err):
            """A collective failed with ``err``.  gloo reports a peer that
            died (its connection closed) at once, before the heartbeat's
            bound has passed: wait out that bound for the heartbeat's
            verdict, and return the loss (PeerLost: terminal, never
            retried, with ``err`` as its cause) when it names a dead peer;
            None lets ``err`` stand."""
            deadline = time.monotonic() + heartbeat.timeout + heartbeat.interval
            while True:
                lost = self._peer_lost_error()
                if lost is not None:
                    lost.__cause__ = err
                    return lost
                if time.monotonic() >= deadline:
                    return None
                time.sleep(heartbeat.interval / 4)

        def _stop_now(self):
            # Peer-liveness check first; the same check also rides the
            # dispatch watchdog's mid-wait interrupt (wired in __init__),
            # because a survivor is usually BLOCKED in the dead peer's
            # collective when the loss bites — the boundary poll alone
            # would leave detection to the full dispatch deadline.
            err = self._peer_lost_error()
            if err is not None:
                raise err
            # The preemption poll is COLLECTIVE: each process contributes
            # its own latch and everyone acts on the max, so one signalled
            # rank stops the whole mesh together — the emergency-checkpoint
            # fetch that follows is a collective and must be entered by
            # every process.  Called at schedule-deterministic turn
            # boundaries only (same cadence as the keys broadcast),
            # watchdog-bounded like every collective.  stop=None on every
            # process keeps this a no-op (arming must be uniform across
            # processes — see run_distributed).
            if self._stop is None:
                return False
            if self._stop_seen:
                # Already observed collectively: every rank latched at the
                # same allgather, so the short-circuit is identical
                # everywhere and issues no further collective.
                return True
            mine = np.int32(1 if self._stop.requested else 0)
            with spans.span("gol.broadcast.stop"):
                flags = self._watchdog.call(lambda: _allgather(mine))
            if flags.max():
                self._stop_seen = True
            return self._stop_seen

        def _emergency_save_due(self, turn):
            # Process 0 owns the durable session, so ITS last-successful-
            # save state decides — broadcast, watchdog-bounded, reached by
            # every rank together (the stop decision above was collective).
            # Deciding locally would let a one-sided save failure (ENOSPC
            # on process 0, while followers' no-op saves "succeed") split
            # the ranks around _checkpoint_now's collective fetch.
            mine = super()._emergency_save_due(turn)
            with spans.span("gol.broadcast.emergency_due", turn=turn):
                return bool(
                    self._watchdog.call(
                        lambda: int(_broadcast(np.int32(1 if mine else 0)))
                    )
                )

        def _gather_snapshots(self, snap):
            # The multihost half of the MetricsReport: every process
            # contributes its own snapshot through the collective
            # transport; the controller aggregates (counters sum, gauges
            # max).  Reached at the same schedule point everywhere
            # (_finalize emits the report before the final fetch), and
            # watchdog-bounded like every other collective.
            return self._watchdog.call(
                lambda: gather_metrics_snapshots(snap)
            )

        def _next_superstep(self, k, dt, superstep, warm_sizes, cap):
            # Deterministic adaptive sizing: dt is local wall-clock — the
            # one input that differs between processes — so process 0
            # makes the decision and broadcasts it.  Every process reaches
            # this call at the same point of the dispatch schedule (the
            # call sites are schedule-deterministic), so the broadcast
            # lines up like every other collective.  Process 0's
            # warm_sizes gating rides inside its base-class call;
            # followers' warm_sizes stay empty, which is fine — they
            # never decide.
            if main:
                superstep = super()._next_superstep(
                    k, dt, superstep, warm_sizes, cap
                )
            # Watchdog-bounded like the keys broadcast: this collective
            # runs once per resolved dispatch and must not become the
            # place a survivor hangs after a one-sided failure.
            with spans.span("gol.broadcast.superstep", k=k):
                return self._watchdog.call(
                    lambda: int(_broadcast(np.int32(superstep)))
                )

    try:
        MultihostController(params, ev, keys, session, backend, stop=stop).run()
    finally:
        if heartbeat is not None:
            heartbeat.stop()
