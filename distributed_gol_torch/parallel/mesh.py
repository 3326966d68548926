"""Device meshes and device health.

Counterpart of ``distributed_gol_tpu/parallel/mesh.py``.  A mesh is a
``(ny, nx)`` grid of ``torch.device``s with axes ``("y", "x")`` — rows and
columns of the board's 2-D domain decomposition, the counterpart of a
``jax.sharding.Mesh``; ``(ny, 1)`` is the reference's contiguous row
strips.  :func:`make_mesh` draws from the healthy CUDA devices and raises
when there are too few: it never shrinks the mesh and never moves to the
CPU.  An explicit ``devices`` list may name one device several times: the
virtual mesh, whose shards all live on one card (or on the CPU), the
counterpart of the JAX package's ``--xla_force_host_platform_device_count``.
A :class:`RankSpan` makes a row mesh span processes: each holds its own
band of strips, and the span carries the edges and sums between them.

The health half: a device a supervisor condemns (:func:`condemn`) stays out
of every later default-built mesh (:func:`healthy_devices`); the serving
plane reads :func:`capacity_fraction` at every admission to scale its cell
budget, and :func:`lost_device_count` for its health.  Device ids are
device indices; the blacklist keys a device by its type and index
(:func:`device_key`), so a virtual CPU device and a card of the same
index stay apart, and a raw int id names a device of the process's kind
(:func:`default_kind`: CUDA where there is a CUDA GPU, else the CPU).
Blacklist lifetime is the process (clear with :func:`clear_blacklist`);
the observability contract is the ``mesh.devices_lost`` counter and the
``mesh.device_blacklist`` info label.  :func:`probe_devices` classifies
devices with one bounded put/compute/fetch round trip each.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import torch
import torch.distributed as dist

AXES = ("y", "x")

# Process-wide blacklist of condemned devices, keyed (type, index), guarded
# for the rare concurrent condemn (serving-plane tenants share it).
_BLACKLIST: set[tuple[str, int]] = set()
_BLACKLIST_LOCK = threading.Lock()


def default_kind() -> str:
    """This process's device kind: "cuda" where there is a CUDA GPU, else
    "cpu" — the kind a raw int device id names."""
    cuda = torch.cuda.is_available() and torch.cuda.device_count() > 0
    return "cuda" if cuda else "cpu"


def device_ids() -> list[int]:
    """This process's device ids: the CUDA device indices, or ``[0]`` (the
    CPU) where there is no CUDA GPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return list(range(n)) if n else [0]


def device_id(d) -> int:
    """A device's id: the raw int, or a ``torch.device``'s index (0 for
    the CPU and an index-less "cuda")."""
    return d if isinstance(d, int) else (d.index or 0)


def device_key(d) -> tuple[str, int]:
    """A device's blacklist key, (type, id): a ``torch.device``'s own type,
    or :func:`default_kind` for a raw int id."""
    if isinstance(d, int):
        return default_kind(), d
    d = torch.device(d)
    return d.type, d.index or 0


def blacklisted(kind: str | None = None) -> frozenset[int]:
    """The condemned ids of ``kind`` devices (default :func:`default_kind`;
    a snapshot copy)."""
    kind = kind or default_kind()
    with _BLACKLIST_LOCK:
        return frozenset(i for t, i in _BLACKLIST if t == kind)


def _label() -> str:
    """The ``mesh.device_blacklist`` label: the condemned ids, those of
    another kind than :func:`default_kind` as "type:id"."""
    kind = default_kind()
    return ",".join(str(i) if t == kind else f"{t}:{i}" for t, i in sorted(_BLACKLIST))


def condemn(devices) -> list[int]:
    """Add ``devices`` (``torch.device`` objects or raw ids) to the
    process-wide blacklist; returns the ids that are NEWLY condemned.
    Bumps the ``mesh.devices_lost`` counter by that count and republishes
    the ``mesh.device_blacklist`` info label (comma-joined ids) on the
    process-wide registry."""
    keys = [device_key(d) for d in devices]
    with _BLACKLIST_LOCK:
        new = [k for k in dict.fromkeys(keys) if k not in _BLACKLIST]
        _BLACKLIST.update(new)
        label = _label()
    if new:
        from distributed_gol_torch.obs import metrics as metrics_lib

        metrics_lib.REGISTRY.counter("mesh.devices_lost").inc(len(new))
        metrics_lib.REGISTRY.info("mesh.device_blacklist", label)
    return [i for _, i in new]


def clear_blacklist() -> None:
    """Forget every condemned device (tests; bench reps; an operator who
    physically replaced the card).  The metrics label is reset too."""
    with _BLACKLIST_LOCK:
        had = bool(_BLACKLIST)
        _BLACKLIST.clear()
    if had:
        from distributed_gol_torch.obs import metrics as metrics_lib

        metrics_lib.REGISTRY.info("mesh.device_blacklist", "")


def lost_device_count() -> int:
    """How many of this process's devices are condemned (the serving
    plane's ``degraded`` health field)."""
    bad = blacklisted()
    return sum(1 for d in device_ids() if d in bad)


def capacity_fraction() -> float:
    """Healthy share of this process's devices, in [0, 1] — the factor a
    degraded serving pod scales its cell budget by (1.0 = full health)."""
    total = len(device_ids())
    return (total - lost_device_count()) / total if total else 0.0


#: How many virtual CPU devices :func:`cpu_devices` names by default: the
#: pool a CPU run's device-health machinery (the supervisor's elastic
#: rung, a one-device Backend sidestepping a condemned default) draws
#: from — the
#: counterpart of the JAX package's eight virtual host devices
#: (``--xla_force_host_platform_device_count=8``).
CPU_DEVICE_COUNT = 8


def cpu_devices(n: int = CPU_DEVICE_COUNT) -> list:
    """``n`` virtual CPU devices, ids 0..n-1 (``torch.device("cpu", i)``:
    their tensors all live in host memory; the index only names the
    device to the blacklist and to fault injection)."""
    return [torch.device("cpu", i) for i in range(n)]


def device_pool(kind: str) -> list:
    """Every device of ``kind`` ("cuda" or "cpu") this process has, sick
    or not: the CUDA devices, or :func:`cpu_devices`."""
    if kind == "cpu":
        return cpu_devices()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


#: Default per-device probe deadline: generous for a healthy device (the
#: round trip is microseconds of compute), far below a wedged wait.
PROBE_DEADLINE_SECONDS = 5.0


def healthy_devices(devices=None) -> list:
    """``devices`` (default: every CUDA device of this process, none where
    there is no CUDA GPU) minus the blacklist — what every default-built
    mesh draws from."""
    if devices is None:
        devices = device_pool("cuda")
    with _BLACKLIST_LOCK:
        bad = set(_BLACKLIST)
    return [d for d in devices if device_key(d) not in bad]


def probe_device(device, deadline_seconds: float = PROBE_DEADLINE_SECONDS) -> bool:
    """One cheap health check of ``device``: put a tiny tensor, add one to
    it there, fetch, verify the round trip; bounded by the controller's
    dispatch watchdog, so a wedged device fails the probe in bounded time.
    Any exception or timeout classifies the device unhealthy."""
    # Lazy import: the watchdog lives with the controller, and this module
    # stays importable below the engine layer.
    from distributed_gol_torch.engine.controller import _Watchdog

    def attempt() -> bool:
        want = torch.arange(8, dtype=torch.uint8)
        got = (want.to(device) + 1).cpu()
        return bool(torch.equal(got, want + 1))

    try:
        return bool(_Watchdog(deadline_seconds).call(attempt))
    except Exception:  # noqa: BLE001 — timeout, runtime error: unhealthy
        return False


def probe_devices(
    devices=None, deadline_seconds: float = PROBE_DEADLINE_SECONDS
) -> tuple[list, list]:
    """Classify ``devices`` (default: the healthy devices) into
    ``(healthy, condemned)`` lists via :func:`probe_device`."""
    if devices is None:
        devices = healthy_devices()
    healthy, condemned = [], []
    for d in devices:
        (healthy if probe_device(d, deadline_seconds) else condemned).append(d)
    return healthy, condemned


#: ``torch.distributed`` tags of the two directions of a rank-crossing
#: edge exchange: with two ranks the north and the south neighbour are
#: the same rank, and the tag keeps its two messages apart.
_SOUTHWARD, _NORTHWARD = 0, 1


@dataclasses.dataclass(frozen=True)
class RankSpan:
    """Where a process-spanning row mesh lies: ``world`` processes
    (``torch.distributed`` ranks) hold ``local`` consecutive strips each,
    rank ``rank`` the strips ``y0 .. y0 + local - 1`` of ``ny``.  Its
    methods are the transport (gloo, on CPU tensors: a CUDA value is
    staged through host memory) and are collectives: every rank calls
    them in the same order.  With ``world == 1`` they move nothing."""

    rank: int
    world: int
    local: int

    @property
    def y0(self) -> int:
        return self.rank * self.local

    @property
    def ny(self) -> int:
        return self.world * self.local

    def exchange(self, southward: torch.Tensor, northward: torch.Tensor):
        """Send ``southward`` to the next rank and ``northward`` to the
        previous one (the torus wraps); returns ``(from_north,
        from_south)``, what the previous rank sent south and the next one
        sent north, on ``southward``'s device.  Every rank sends the same
        shapes."""
        if self.world == 1:
            return southward, northward
        south, north = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        send_s, send_n = southward.cpu().contiguous(), northward.cpu().contiguous()
        from_n, from_s = torch.empty_like(send_s), torch.empty_like(send_n)
        works = [dist.irecv(from_n, north, tag=_SOUTHWARD),
                 dist.irecv(from_s, south, tag=_NORTHWARD),
                 dist.isend(send_s, south, tag=_SOUTHWARD),
                 dist.isend(send_n, north, tag=_NORTHWARD)]
        for w in works:
            w.wait()
        dev = southward.device
        return from_n.to(dev), from_s.to(dev)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (same shape everywhere), on
        ``t``'s device."""
        if self.world == 1:
            return t
        buf = t.to("cpu", copy=True)
        dist.all_reduce(buf)
        return buf.to(t.device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape everywhere) concatenated along
        dim 0 in rank order, on ``t``'s device."""
        if self.world == 1:
            return t
        buf = t.cpu().contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf)
        return torch.cat(parts).to(t.device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(ny, nx)`` grid of devices with axes ``("y", "x")``: shard
    ``(iy, ix)`` of a board lives on ``devices[iy][ix]``.  A device may
    appear more than once (a virtual mesh).

    ``span`` marks a process-spanning row mesh
    (``parallel/multihost.py``): ``devices`` then holds this process's
    strips alone, rows ``span.y0 ..`` of the ``span.ny`` that ``shape``
    counts."""

    devices: tuple[tuple[torch.device, ...], ...]
    span: RankSpan | None = None

    @property
    def shape(self) -> dict[str, int]:
        """``{"y": ny, "x": nx}``, as ``jax.sharding.Mesh.shape``."""
        ny = self.span.ny if self.span is not None else len(self.devices)
        return {"y": ny, "x": len(self.devices[0])}

    @property
    def y0(self) -> int:
        """The mesh row of ``devices[0]``: 0 unless the mesh spans ranks."""
        return 0 if self.span is None else self.span.y0

    @property
    def spans_ranks(self) -> bool:
        """Whether the strips lie in more than one process."""
        return self.span is not None and self.span.world > 1

    @property
    def flat(self) -> list[torch.device]:
        """The devices in row-major shard order."""
        return [d for row in self.devices for d in row]


def make_mesh(shape: tuple[int, int], devices=None) -> Mesh:
    """A (ny, nx) mesh with axes ("y", "x") over the first ny*nx devices.

    ``devices=None`` draws from :func:`healthy_devices`: blacklisted
    devices never enter a default-built mesh, and with too few CUDA devices
    this raises — it never shrinks the mesh and never falls back to the
    CPU.  An explicit list may repeat a device (a virtual mesh)."""
    ny, nx = shape
    if devices is None:
        devices = healthy_devices()
    devices = [torch.device(d) for d in devices]
    n = ny * nx
    if len(devices) < n:
        lost = lost_device_count()
        hint = f" ({lost} blacklisted)" if lost else ""
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have {len(devices)}{hint}")
    return Mesh(tuple(tuple(devices[iy * nx : (iy + 1) * nx]) for iy in range(ny)))


def _squarest_factorisation(
    n_devices: int, height: int, width: int, predicate=None
) -> tuple[int, int] | None:
    """The (ny, nx) factorisation of ``n_devices`` that divides the board
    and is as square as possible (least halo perimeter per device),
    restricted to shapes ``predicate`` accepts; None if none qualifies."""
    best = None
    for ny in range(1, n_devices + 1):
        if n_devices % ny:
            continue
        nx = n_devices // ny
        if height % ny or width % nx:
            continue
        if predicate is not None and not predicate(ny, nx):
            continue
        score = abs(math.log(ny) - math.log(nx))
        if best is None or score < best[0]:
            best = (score, (ny, nx))
    return best[1] if best else None


def mesh_shape_for(n_devices: int, height: int, width: int) -> tuple[int, int]:
    """Pick a (ny, nx) factorisation of n_devices that divides the board and
    is as square as possible."""
    shape = _squarest_factorisation(n_devices, height, width)
    if shape is None:
        raise ValueError(
            f"no factorisation of {n_devices} devices divides a {height}x{width} board"
        )
    return shape


def largest_mesh_shape(
    n_devices: int, height: int, width: int, word_aligned: bool = True
) -> tuple[int, int]:
    """The largest mesh (most devices <= ``n_devices``) that still divides
    a ``height`` x ``width`` board — a reshard target after device loss.
    ``word_aligned`` first prefers shapes the packed engines can run
    ((width // nx) % 32 == 0), then any dividing factorisation (the roll
    engine runs every shape).  Always succeeds for ``n_devices >= 1``."""
    if n_devices < 1:
        raise ValueError("largest_mesh_shape needs >= 1 device")
    word_gate = lambda ny, nx: (width // nx) % 32 == 0  # noqa: E731
    passes = (word_gate, None) if word_aligned else (None,)
    for predicate in passes:
        for n in range(n_devices, 0, -1):
            shape = _squarest_factorisation(n, height, width, predicate)
            if shape is not None:
                return shape
    raise ValueError(  # unreachable: n == 1 always divides
        f"no mesh of <= {n_devices} devices divides {height}x{width}"
    )
