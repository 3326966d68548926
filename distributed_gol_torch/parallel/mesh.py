"""Device health: the process-wide device blacklist.

Counterpart of the blacklist half of ``distributed_gol_tpu/parallel/mesh.py``.
A device a supervisor condemns (:func:`condemn`) stays out of every later
build; the serving plane reads :func:`capacity_fraction` at every admission
to scale its cell budget, and :func:`lost_device_count` for its health.
Devices are CUDA device indices, counted with ``torch.cuda.device_count()``
(one device, the CPU, where there is no CUDA GPU).  Blacklist lifetime is
the process (clear with :func:`clear_blacklist`); the observability
contract is the ``mesh.devices_lost`` counter and the
``mesh.device_blacklist`` info label.  Meshes and device probes are
ROADMAP A8.
"""

from __future__ import annotations

import threading

import torch

# Process-wide blacklist of condemned device ids, guarded for the rare
# concurrent condemn (serving-plane tenants share it).
_BLACKLIST: set[int] = set()
_BLACKLIST_LOCK = threading.Lock()


def device_ids() -> list[int]:
    """This process's device ids: the CUDA device indices, or ``[0]`` (the
    CPU) where there is no CUDA GPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return list(range(n)) if n else [0]


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
    ids = [d if isinstance(d, int) else (d.index or 0) for d in devices]
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
