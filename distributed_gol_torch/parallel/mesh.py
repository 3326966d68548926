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

The health half: a device a supervisor condemns (:func:`condemn`) stays out
of every later default-built mesh (:func:`healthy_devices`); the serving
plane reads :func:`capacity_fraction` at every admission to scale its cell
budget, and :func:`lost_device_count` for its health.  Device ids are CUDA
device indices (one device, the CPU, where there is no CUDA GPU).
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

AXES = ("y", "x")

# Process-wide blacklist of condemned device ids, guarded for the rare
# concurrent condemn (serving-plane tenants share it).
_BLACKLIST: set[int] = set()
_BLACKLIST_LOCK = threading.Lock()


def device_ids() -> list[int]:
    """This process's device ids: the CUDA device indices, or ``[0]`` (the
    CPU) where there is no CUDA GPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return list(range(n)) if n else [0]


def _device_id(d) -> int:
    """A device's id: the raw int, or a ``torch.device``'s index (0 for
    the CPU and an index-less "cuda")."""
    return d if isinstance(d, int) else (d.index or 0)


def blacklisted() -> frozenset[int]:
    """The condemned device ids (a snapshot copy)."""
    with _BLACKLIST_LOCK:
        return frozenset(_BLACKLIST)


def condemn(devices) -> list[int]:
    """Add ``devices`` (``torch.device`` objects or raw ids) to the
    process-wide blacklist; returns the ids that are NEWLY condemned.
    Bumps the ``mesh.devices_lost`` counter by that count and republishes
    the ``mesh.device_blacklist`` info label (comma-joined ids) on the
    process-wide registry."""
    ids = [_device_id(d) for d in devices]
    with _BLACKLIST_LOCK:
        new = [i for i in ids if i not in _BLACKLIST]
        _BLACKLIST.update(new)
        label = ",".join(str(i) for i in sorted(_BLACKLIST))
    if new:
        from distributed_gol_torch.obs import metrics as metrics_lib

        metrics_lib.REGISTRY.counter("mesh.devices_lost").inc(len(new))
        metrics_lib.REGISTRY.info("mesh.device_blacklist", label)
    return new


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


#: Default per-device probe deadline: generous for a healthy device (the
#: round trip is microseconds of compute), far below a wedged wait.
PROBE_DEADLINE_SECONDS = 5.0


def healthy_devices(devices=None) -> list:
    """``devices`` (default: every CUDA device of this process, none where
    there is no CUDA GPU) minus the blacklist — what every default-built
    mesh draws from."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    bad = blacklisted()
    return [d for d in devices if _device_id(d) not in bad]


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(ny, nx)`` grid of devices with axes ``("y", "x")``: shard
    ``(iy, ix)`` of a board lives on ``devices[iy][ix]``.  A device may
    appear more than once (a virtual mesh)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        """``{"y": ny, "x": nx}``, as ``jax.sharding.Mesh.shape``."""
        return {"y": len(self.devices), "x": len(self.devices[0])}

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
