"""Deterministic, seedable fault injection at the dispatch seam.

A copy of ``distributed_gol_tpu/testing/faults.py`` for the port: the
same plans (same JSON, same seeded schedules, the same corrupted cells)
against the port's Backend, whose boards are ``torch`` tensors (or
``parallel.halo.ShardedBoard``s) and whose devices are ``torch.device``s.

The reference system's failure story is one mechanism — the broker
re-queues a failed worker RPC (``broker/broker.go:67-73``) — and its tests
never exercise it.  The rebuild's controller has a real fault surface
(retry policy, dispatch watchdog, periodic checkpoints; ``Params`` fault-
tolerance knobs), and this module is the single way failures are produced
to test it: a :class:`FaultPlan` is an explicit, dispatch-indexed schedule
of faults, and :class:`FaultInjectionBackend` wraps ANY backend (single
device, sharded mesh, multi-host) and injects the plan at the headless
dispatch seam the controller's retry contract is built on
(``Backend.run_turns_async`` / ``run_turns``).

Fault kinds:

- ``issue`` — the dispatch raises at issue time (a Python-level device
  error; the sync retry path sees these too).
- ``resolve`` — the dispatch issues fine but its on-device count raises
  when forced (the async failure mode: the error surfaces dispatches
  later, when the pipelined controller resolves it).
- ``latency`` — the dispatch is delayed ``seconds`` before issuing (a
  network/device latency spike; no error is raised).
- ``hang`` — the dispatch issues fine but its count never resolves:
  forcing it blocks (the wedged-device / wedged-collective mode the
  dispatch watchdog exists for).  A safety timeout (``seconds``, default
  30) bounds the injected hang itself so an abandoned watchdog thread
  cannot outlive its test run.
- ``corrupt`` — the dispatch succeeds but its RESULT is silently wrong:
  ``cells`` seeded bit-flips are applied to the returned board at the
  resolve seam (no error is raised — the silent-data-corruption mode the
  SDC sentinel, ``Params.sdc_check_every_turns``, exists to catch).  The
  flip locations are drawn from the plan RNG (``random.Random`` seeded
  from the fault's own index), so the same plan corrupts the same cells
  everywhere.  Use an odd ``cells`` count when the test relies on the
  sentinel's popcount cross-check alone (an even mix of births/deaths
  could cancel in the count; the stripe recompute has no such parity
  blind spot).
- ``device_down`` — a PERSISTENTLY dead device, not a transient fault:
  from dispatch ``at`` onward, device id ``device`` is down for the rest
  of the plan's life, and EVERY dispatch whose backend still computes on
  that device fails at issue time — retries included, and (through
  :meth:`FaultInjectionBackend.rebind`, the supervisor-chaos seam)
  every rebuilt attempt too.  Contrast with a ``burst`` of consecutive
  ``issue`` faults: a burst is transient — it defeats the retry budget
  but the NEXT attempt's dispatches succeed, so a same-tier supervisor
  rebuild recovers; ``device_down`` defeats every rung that rebuilds on
  the same device set, and only a topology-elastic rebuild that excludes
  the dead device recovers.  Dispatches on a backend that does
  NOT touch the dead device (a shrunken mesh) succeed, which is exactly
  the recovery the elastic ladder is asserted against.
  JSON-schedulable like ``corrupt``:
  ``{"at": 2, "kind": "device_down", "device": 3}``.
- ``pod_down`` — a dead (or partitioned) POD, not a device: the
  federation chaos kind.  ``at`` is a TURN threshold, not a dispatch
  index (pod chaos is scripted against observed session progress — the
  broker tier has no dispatch counter to index by); ``device`` names the
  pod (an index into the chaos driver's pod list); ``seconds == 0`` is a
  SIGKILL (permanent death — the failover leg's trigger), ``seconds > 0``
  a SIGSTOP/SIGCONT partition that heals after that long (the
  condemned-then-recovered rejoin leg).  Driven by :class:`PodChaos`
  against real child pod processes; handing a pod_down-bearing plan to
  :class:`FaultInjectionBackend` (the dispatch seam) is a test-harness
  bug and is rejected at construction, exactly like ``flood``.
  JSON-schedulable: ``{"at": 12, "kind": "pod_down", "device": 0}``.
- ``flood`` — a misbehaving TENANT, not a misbehaving device: at step
  ``at`` of a scripted submission schedule, ``cells`` back-to-back
  session submissions are fired at the serving plane's admission seam
  with no pacing (the max-rate client the admission budget exists to
  shed).  Flood faults target ``serve.ServePlane.submit`` and are driven
  by :class:`FloodTenant`; handing a flood-bearing plan to
  :class:`FaultInjectionBackend` (the dispatch seam) is a test-harness
  bug and is rejected at construction.  Deterministic like every other
  kind: the outcome sequence (admitted / queued / shed) is a pure
  function of the plan and the plane's capacity budget.

Determinism: a plan is a pure value.  Scripted plans are literal fault
lists; :meth:`FaultPlan.random` derives the schedule from a seed via
``random.Random`` (no global RNG, no wall-clock), so the same seed gives
the bitwise-identical schedule on every host — one process of a
multi-host run can be faulted while its peers run clean, repeatably.

Dispatch indexing counts EVERY ``run_turns_async``/``run_turns`` call the
controller makes, retries included — so consecutive indices model a burst
that defeats the retry budget, and an index equal to a retry's position
faults the retry itself.
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import torch

from distributed_gol_torch.parallel.mesh import device_key

FAULT_KINDS = (
    "issue", "resolve", "latency", "hang", "corrupt", "flood", "device_down",
    "pod_down",
)

# Injected hangs self-release after this long if nothing (watchdog, test
# teardown) got there first: a leaked daemon thread must not outlive the
# test session.
DEFAULT_HANG_SECONDS = 30.0


@dataclass(frozen=True)
class Fault:
    """One scripted failure, striking the ``at``-th dispatch (0-based)."""

    at: int
    kind: str
    seconds: float = 0.0  # latency duration / hang self-release timeout
    cells: int = 1  # corrupt: seeded bit-flips; flood: burst submissions
    device: int = 0  # device_down: the condemned device's id (its index)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.at < 0:
            raise ValueError(f"fault index must be >= 0, got {self.at}")
        if self.seconds < 0:
            raise ValueError(f"fault seconds must be >= 0, got {self.seconds}")
        if self.cells < 1:
            raise ValueError(f"fault cells must be >= 1, got {self.cells}")
        if self.device < 0:
            raise ValueError(f"fault device id must be >= 0, got {self.device}")


class FaultPlan:
    """An immutable dispatch-indexed fault schedule (at most one fault per
    dispatch index — a "burst" is faults at consecutive indices)."""

    def __init__(self, faults: Iterable[Fault] = ()):
        by_index: dict[int, Fault] = {}
        for f in faults:
            if f.at in by_index:
                raise ValueError(f"two faults scripted at dispatch {f.at}")
            by_index[f.at] = f
        self._by_index = by_index

    def fault_at(self, dispatch: int) -> Fault | None:
        return self._by_index.get(dispatch)

    @property
    def faults(self) -> tuple[Fault, ...]:
        return tuple(sorted(self._by_index.values(), key=lambda f: f.at))

    def __len__(self) -> int:
        return len(self._by_index)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultPlan) and self.faults == other.faults

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.faults)!r})"

    @classmethod
    def random(
        cls,
        seed: int,
        n_dispatches: int,
        p_fault: float = 0.1,
        kinds: Sequence[str] = ("issue", "resolve"),
        burst: int = 1,
        seconds: float = 0.0,
    ) -> "FaultPlan":
        """A seeded schedule over dispatches ``0..n_dispatches-1``: each
        index independently starts a fault with probability ``p_fault``; a
        started fault emits ``burst`` consecutive faults of one (seeded)
        kind.  Same arguments, same plan — everywhere."""
        if not 0.0 <= p_fault <= 1.0:
            raise ValueError("p_fault must be in [0, 1]")
        if burst < 1:
            raise ValueError("burst must be >= 1")
        rng = random.Random(seed)
        faults: list[Fault] = []
        i = 0
        while i < n_dispatches:
            if rng.random() < p_fault:
                kind = kinds[rng.randrange(len(kinds))]
                for j in range(i, i + burst):
                    faults.append(Fault(j, kind, seconds=seconds))
                i += burst
            else:
                i += 1
        return cls(faults)

    # -- the PLAN schema (the same JSON as the JAX package's) ------------------
    @classmethod
    def from_json(cls, spec: str) -> "FaultPlan":
        """Build a plan from a JSON spec — the text itself or a path to a
        file holding it.  Two forms:

        scripted: ``{"faults": [{"at": 3, "kind": "issue"},
                                {"at": 7, "kind": "latency", "seconds": 0.05}]}``
        seeded:   ``{"seed": 0, "n_dispatches": 64, "p_fault": 0.1,
                     "kinds": ["issue", "resolve"], "burst": 2}``

        ``{}`` (or ``{"faults": []}``) is the empty plan — the clean-path
        overhead measurement."""
        text = str(spec)
        try:
            if Path(text).is_file():
                text = Path(text).read_text()
        except OSError:
            pass  # inline JSON longer than a legal path name
        obj = json.loads(text)
        if not isinstance(obj, dict):
            raise ValueError("fault plan must be a JSON object")
        if "seed" in obj:
            return cls.random(
                int(obj["seed"]),
                int(obj["n_dispatches"]),
                p_fault=float(obj.get("p_fault", 0.1)),
                kinds=tuple(obj.get("kinds", ("issue", "resolve"))),
                burst=int(obj.get("burst", 1)),
                seconds=float(obj.get("seconds", 0.0)),
            )
        return cls(
            Fault(
                int(f["at"]),
                str(f["kind"]),
                seconds=float(f.get("seconds", 0.0)),
                cells=int(f.get("cells", 1)),
                device=int(f.get("device", 0)),
            )
            for f in obj.get("faults", ())
        )


class _PoisonedScalar:
    """Stands in for an on-device count whose computation died after issue:
    resolution (``int()``) raises — the async failure mode."""

    def __init__(self, error: str):
        self._error = error

    def __int__(self) -> int:
        raise RuntimeError(self._error)


class _HangingScalar:
    """A count that never resolves: ``int()`` blocks until released (or the
    safety timeout), then raises so nothing downstream mistakes the stale
    value for a result."""

    def __init__(self, release: threading.Event, seconds: float):
        self._release = release
        self._seconds = seconds or DEFAULT_HANG_SECONDS

    def __int__(self) -> int:
        self._release.wait(self._seconds)
        raise RuntimeError("injected hang released")


class FaultInjectionBackend:
    """A :class:`FaultPlan`-driven wrapper around any backend.

    Everything except the dispatch seam delegates to the wrapped backend,
    so viewer paths, board placement, cycle probes, and engine/tier
    resolution behave exactly as the real backend's — the harness changes
    WHEN dispatches fail, never what they compute.

    Observability for assertions and bench records: ``dispatches`` counts
    every seam call, ``injected`` lists the faults that actually struck
    (a plan can script faults past the end of a short run)."""

    def __init__(self, inner, plan: FaultPlan):
        if any(f.kind == "flood" for f in plan.faults):
            raise ValueError(
                "flood faults target the serving plane's admission seam "
                "(testing.faults.FloodTenant), not the dispatch seam"
            )
        if any(f.kind == "pod_down" for f in plan.faults):
            raise ValueError(
                "pod_down faults target child pod processes "
                "(testing.faults.PodChaos), not the dispatch seam"
            )
        self._inner = inner
        self.plan = plan
        self.dispatches = 0
        self.injected: list[Fault] = []
        #: Devices struck by a ``device_down`` fault, keyed (type, id) as
        #: the blacklist keys them (the fault's id names a device of the
        #: wrapped Backend's kind) — persistent plan state: once dead, dead
        #: for the harness's whole life (across :meth:`rebind`), exactly
        #: like real dead silicon.
        self.down_devices: set[tuple[str, int]] = set()
        self._release = threading.Event()

    def __getattr__(self, name):
        # Only consulted for names not defined on the wrapper: params,
        # put/fetch, viewer dispatches, skip telemetry, _CYCLE_PERIOD...
        return getattr(self._inner, name)

    def rebind(self, inner) -> "FaultInjectionBackend":
        """Swap the wrapped backend while KEEPING the dispatch index and
        the dead-device set — the supervisor-chaos seam: a rebuild ladder
        hands each attempt's fresh backend to ONE persistent harness, so
        ``device_down`` stays down across attempts (a fresh harness per
        attempt would resurrect the device, modelling a transient fault
        the ``issue`` kind already covers).  Returns self so a
        ``backend_factory`` can be one expression."""
        self._inner = inner
        return self

    def _inner_devices(self):
        devices = getattr(self._inner, "devices", None)
        if devices is not None:
            return devices
        return [torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")]

    def device_probe(self, devices) -> tuple[list, list]:
        """The plan-consistent health probe for the supervisor's elastic
        rung (``Supervisor(device_probe=...)``): classifies ``devices``
        into (healthy, condemned) by the harness's OWN dead set — the
        hermetic stand-in for ``parallel.mesh.probe_devices``, whose real
        put/fetch probes would find a CPU rig's devices healthy and never
        see an injected fault."""
        healthy = [d for d in devices if device_key(d) not in self.down_devices]
        condemned = [d for d in devices if device_key(d) in self.down_devices]
        return healthy, condemned

    def release_hangs(self) -> None:
        """Unblock every injected hang (test teardown: frees any watchdog
        thread still parked in a hung force)."""
        self._release.set()

    def run_turns_async(self, board, turns: int):
        i = self.dispatches
        self.dispatches += 1
        # device_down strikes are persistent: latch every fault whose
        # index has arrived, then fail ANY dispatch (this one and all
        # later ones, retries and rebound attempts included) whose
        # backend still computes on a dead device — at issue time, like
        # ``issue``.  A backend that no longer touches the device (the
        # elastic supervisor's shrunken mesh) sails through.
        devices = self._inner_devices()
        kind = torch.device(devices[0]).type
        for f in self.plan.faults:
            if (
                f.kind == "device_down"
                and f.at <= i
                and (kind, f.device) not in self.down_devices
            ):
                self.down_devices.add((kind, f.device))
                self.injected.append(f)
        if self.down_devices:
            dead = self.down_devices & {device_key(d) for d in devices}
            if dead:
                raise RuntimeError(
                    f"injected device_down (devices {sorted(i for _, i in dead)}, "
                    f"dispatch {i})"
                )
        fault = self.plan.fault_at(i)
        if fault is None or fault.kind == "device_down":
            return self._inner.run_turns_async(board, turns)
        self.injected.append(fault)
        if fault.kind == "issue":
            raise RuntimeError(f"injected issue-time failure (dispatch {i})")
        if fault.kind == "latency":
            time.sleep(fault.seconds)
            return self._inner.run_turns_async(board, turns)
        new_board, count = self._inner.run_turns_async(board, turns)
        if fault.kind == "resolve":
            return new_board, _PoisonedScalar(
                f"injected resolve-time failure (dispatch {i})"
            )
        if fault.kind == "corrupt":
            return self._corrupt(new_board, fault), count
        return new_board, _HangingScalar(self._release, fault.seconds)

    def _corrupt(self, new_board, fault: Fault):
        """Silently flip ``fault.cells`` seeded cells of the settled
        result (the SDC injection): a copy of the board, toggled on its own
        device (shard by shard on a ``ShardedBoard``), so placement stays
        exactly what the real backend produced.  The count scalar is left as
        computed from the UNCORRUPTED board — modelling corruption after
        the count reduction, which the sentinel's popcount cross-check
        exists to catch.  Deterministic: locations come from
        ``random.Random`` seeded by the fault's own dispatch index."""
        from distributed_gol_torch.parallel.halo import ShardedBoard

        rng = random.Random(0xC0FFEE ^ (fault.at * 1000003))
        h, w = new_board.shape
        cells = [(rng.randrange(h), rng.randrange(w)) for _ in range(fault.cells)]
        if not isinstance(new_board, ShardedBoard):
            world = new_board.clone()
            for y, x in cells:
                world[y, x] ^= 255
            return world
        shards = [[t.clone() for t in row] for row in new_board.shards]
        sh, sw = new_board.shard_shape
        for y, x in cells:
            shards[y // sh][x // sw][y % sh, x % sw] ^= 255
        return ShardedBoard(new_board.mesh, shards)

    def run_turns(self, board, turns: int):
        # Through the seam above so retries are counted (and faultable).
        new_board, count = self.run_turns_async(board, turns)
        return new_board, int(count)


class FloodTenant:
    """The ``flood`` fault kind's driver: a scripted tenant submitting
    at max rate against a serving plane's admission seam.

    Walks the plan's ``flood`` faults in schedule order; each fires
    ``cells`` back-to-back submissions (tenants ``<prefix>0``,
    ``<prefix>1``, ... — distinct names, so the budget ladder is
    exercised: resident slots fill, then the bounded queue, then
    shedding) with NO pacing and NO randomness, so the exact outcome
    sequence is assertable.  Submissions that the plane admits run for
    real — ``make_params(tenant)`` supplies each one's :class:`Params` —
    which is what makes a flood a genuine noisy-neighbour workload
    beside the healthy tenants of an isolation test rather than a mocked
    counter bump.

    ``outcomes`` after :meth:`run`: one ``(tenant, verdict)`` per
    submission, verdict ∈ ``{"admitted", "queued", "rejected"}``
    (admitted = a slot was free at submit time; queued = parked in the
    bounded wait queue)."""

    def __init__(self, plane, make_params, plan: FaultPlan, prefix: str = "flood-"):
        self.plane = plane
        self.make_params = make_params
        self.plan = plan
        self.prefix = prefix
        self.outcomes: list[tuple[str, str]] = []
        self.handles: list = []
        self.rejections: list = []

    def run(self) -> dict:
        """Fire the whole scripted flood; returns the tally
        ``{submitted, admitted, queued, rejected}``."""
        from distributed_gol_torch.serve.admission import AdmissionRejected

        k = 0
        for fault in self.plan.faults:
            if fault.kind != "flood":
                continue
            for _ in range(fault.cells):
                tenant = f"{self.prefix}{k}"
                k += 1
                try:
                    handle = self.plane.submit(tenant, self.make_params(tenant))
                except AdmissionRejected as e:
                    self.rejections.append(e)
                    self.outcomes.append((tenant, "rejected"))
                else:
                    self.handles.append(handle)
                    self.outcomes.append(
                        (
                            tenant,
                            "queued"
                            if handle.admitted_as == "queue"
                            else "admitted",
                        )
                    )
        tally = {"submitted": k, "admitted": 0, "queued": 0, "rejected": 0}
        for _, verdict in self.outcomes:
            tally[verdict] += 1
        return tally


class PodChaos:
    """The ``pod_down`` fault kind's driver: kill or
    partition real child pod processes at scripted TURN thresholds.

    ``pods`` is an ordered list of process handles (anything with
    ``pid`` and ``poll()`` — ``subprocess.Popen`` is the intended
    shape); a fault's ``device`` field indexes into it.  ``turn_fn``
    reports the watched session's observed progress (typically a
    closure over a broker/gateway state poll); :meth:`maybe_fire` is
    the deterministic seam — tests call it with each observed turn, or
    :meth:`watch` polls ``turn_fn`` from a daemon thread at a bounded
    cadence for end-to-end runs.

    Firing semantics per fault, once each, in ``at`` order:

    - ``seconds == 0``: ``SIGKILL`` — permanent pod death, no shutdown
      hooks, no drain: the ONLY durable state left is what the pod's
      sessions had already checkpointed (sidecars persist paused=True,
      so a kill mid-run leaves adoptable state — exactly what the
      broker's failover leg is asserted against).
    - ``seconds > 0``: ``SIGSTOP`` now, ``SIGCONT`` after ``seconds``
      (a timer thread) — a network-partition stand-in: the pod stops
      answering probes, gets condemned, then heals and rejoins.

    ``fired`` lists the faults that struck, ``(fault, turn)`` pairs —
    the chaos-matrix assertion surface, like ``injected`` on the
    dispatch harness."""

    def __init__(self, pods: Sequence, plan: FaultPlan, turn_fn=None):
        for f in plan.faults:
            if f.kind != "pod_down":
                continue
            if f.device >= len(pods):
                raise ValueError(
                    f"pod_down fault names pod {f.device} but only "
                    f"{len(pods)} pod(s) were handed to PodChaos"
                )
        self.pods = list(pods)
        self.plan = plan
        self.turn_fn = turn_fn
        self.fired: list[tuple[Fault, int]] = []
        self._pending = sorted(
            (f for f in plan.faults if f.kind == "pod_down"),
            key=lambda f: f.at,
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._timers: list[threading.Timer] = []

    @property
    def done(self) -> bool:
        with self._lock:
            return not self._pending

    def maybe_fire(self, turn: int) -> list[Fault]:
        """Fire every still-pending fault whose threshold has arrived
        (``turn >= at``); returns the faults that struck this call."""
        struck: list[Fault] = []
        with self._lock:
            while self._pending and turn >= self._pending[0].at:
                struck.append(self._pending.pop(0))
        for fault in struck:
            self._strike(fault, turn)
        return struck

    def _strike(self, fault: Fault, turn: int) -> None:
        import os
        import signal

        pod = self.pods[fault.device]
        if pod.poll() is not None:
            return  # already dead: a double-kill is a no-op, not a crash
        if fault.seconds == 0:
            os.kill(pod.pid, signal.SIGKILL)
        else:
            os.kill(pod.pid, signal.SIGSTOP)
            timer = threading.Timer(
                fault.seconds, self._heal, args=(pod,)
            )
            timer.daemon = True
            timer.start()
            self._timers.append(timer)
        self.fired.append((fault, turn))

    def _heal(self, pod) -> None:
        import os
        import signal

        if pod.poll() is None:
            try:
                os.kill(pod.pid, signal.SIGCONT)
            except ProcessLookupError:
                pass

    def watch(self, interval: float = 0.1) -> threading.Thread:
        """Poll ``turn_fn`` from a daemon thread until every scripted
        fault fired (or :meth:`stop`).  A ``turn_fn`` error is treated
        as turn-unknown (no fire), never a crash — mid-failover the
        watched tenant is legitimately unreachable for a beat."""
        if self.turn_fn is None:
            raise ValueError("watch() needs a turn_fn")

        def loop():
            while not self._stop.is_set() and not self.done:
                try:
                    turn = self.turn_fn()
                except Exception:  # noqa: BLE001 — unreachable mid-failover
                    turn = None
                if turn is not None:
                    self.maybe_fire(int(turn))
                self._stop.wait(interval)

        thread = threading.Thread(
            target=loop, name="gol-pod-chaos", daemon=True
        )
        thread.start()
        return thread

    def stop(self) -> None:
        """Halt the watcher and heal any still-partitioned pod (test
        teardown must not leak a SIGSTOPped child)."""
        self._stop.set()
        for timer in self._timers:
            timer.cancel()
        for fault, _ in self.fired:
            if fault.seconds > 0:
                self._heal(self.pods[fault.device])
