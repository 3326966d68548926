"""Deterministic network fault injection — the wire-tier sibling of
``testing/faults.py``.

A copy of ``distributed_gol_tpu/testing/netchaos.py`` (stdlib only; the
port keeps its own copy and imports nothing of the JAX package).

Every dispatch-seam and process-level failure already has a scripted,
seeded harness (:class:`testing.faults.FaultPlan`, ``PodChaos``), but
the HTTP/WebSocket plane the serving tier grew (gateway, broker, relay,
collector) talks over REAL sockets, and real networks fail in ways no
dispatch-seam fault can model: a peer that trickles one byte a second,
a connection that dies mid-response, a router that eats packets without
closing anything.  This module is the single way those failures are
produced: a :class:`ChaosProxy` is a TCP forwarder inserted between any
client/server pair in the stack (client→gateway, broker→pod,
relay→upstream, collector→node), driven by a :class:`WirePlan` — an
explicit, connection-indexed schedule in exactly the ``FaultPlan``
idiom (scripted literal lists, or seeded via ``random.Random``; same
arguments, same plan, everywhere; JSON-schedulable inline or from a
file).

Wire fault kinds (``at`` indexes the proxy's accepted connections in
accept order, 0-based):

- ``latency`` — every upstream→client chunk is delayed ``seconds``
  before forwarding (an added-RTT path; no bytes are lost).
- ``trickle`` — the upstream→client stream is written ONE BYTE at a
  time, ``seconds`` between bytes (the slow-peer / slow-loris shape:
  readers see maximally fragmented, maximally slow input).
- ``disconnect`` — both sides are hard-closed once ``after_bytes``
  upstream→client bytes have been forwarded (0 = at accept: the
  connection dies before the server answers a byte — the
  response-died-mid-body retry case).
- ``corrupt`` — the upstream→client byte at absolute stream offset
  ``after_bytes`` is XOR-flipped (0xFF); everything else rides
  verbatim — the silent-data-corruption mode for wire codecs.
- ``stall`` — forwarding STOPS (both directions) once ``after_bytes``
  upstream→client bytes have passed, but neither socket is closed:
  the half-open connection, the SIGSTOP of sockets (0 = accept, then
  never forward anything — a connect that succeeds and then goes
  silent forever).
- ``blackhole`` — the client's connect is accepted and nothing else
  ever happens: no upstream connection, no bytes, no close.

``stall``/``blackhole`` connections self-release after
``hang_seconds`` (default :data:`DEFAULT_HANG_SECONDS`) so an
abandoned socket cannot outlive its test run — the same safety
contract as the injected dispatch hangs.

Assertion surface: ``proxy.fired`` (the faults that actually struck,
in strike order), ``proxy.connections`` (total accepted), and
``proxy.open_connections()`` (live pairs — the leak pin).  All proxy
threads are daemons named ``gol-netchaos-*`` so a suite can count
leaked threads by prefix.

Zero dependencies beyond the stdlib; never imports torch — the proxy
runs in broker-grade processes.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence
from urllib.parse import urlsplit

WIRE_FAULT_KINDS = (
    "latency", "trickle", "disconnect", "corrupt", "stall", "blackhole",
)

#: Stalled/blackholed connections self-release after this long if the
#: test (or proxy.close()) got there first — a leaked half-open socket
#: must not outlive the test session.
DEFAULT_HANG_SECONDS = 30.0

#: Forwarding chunk size (pre-fault).  Small enough that byte-offset
#: faults land inside real responses, large enough to be invisible on
#: the clean path.
_CHUNK = 65536


@dataclass(frozen=True)
class WireFault:
    """One scripted wire failure, striking the ``at``-th accepted
    connection (0-based, accept order)."""

    at: int
    kind: str
    seconds: float = 0.0  # latency per chunk / trickle per byte
    after_bytes: int = 0  # upstream→client offset that triggers/strikes

    def __post_init__(self):
        if self.kind not in WIRE_FAULT_KINDS:
            raise ValueError(
                f"unknown wire fault kind {self.kind!r}; "
                f"one of {WIRE_FAULT_KINDS}"
            )
        if self.at < 0:
            raise ValueError(f"connection index must be >= 0, got {self.at}")
        if self.seconds < 0:
            raise ValueError(f"fault seconds must be >= 0, got {self.seconds}")
        if self.after_bytes < 0:
            raise ValueError(
                f"after_bytes must be >= 0, got {self.after_bytes}"
            )


class WirePlan:
    """An immutable connection-indexed wire-fault schedule (at most one
    fault per connection — a "burst" is faults on consecutive
    connections), in the ``FaultPlan`` idiom."""

    def __init__(self, faults: Iterable[WireFault] = ()):
        by_index: dict[int, WireFault] = {}
        for f in faults:
            if f.at in by_index:
                raise ValueError(f"two wire faults scripted at connection {f.at}")
            by_index[f.at] = f
        self._by_index = by_index

    def fault_at(self, connection: int) -> WireFault | None:
        return self._by_index.get(connection)

    @property
    def faults(self) -> tuple[WireFault, ...]:
        return tuple(sorted(self._by_index.values(), key=lambda f: f.at))

    def __len__(self) -> int:
        return len(self._by_index)

    def __eq__(self, other) -> bool:
        return isinstance(other, WirePlan) and self.faults == other.faults

    def __repr__(self) -> str:
        return f"WirePlan({list(self.faults)!r})"

    @classmethod
    def random(
        cls,
        seed: int,
        n_connections: int,
        p_fault: float = 0.25,
        kinds: Sequence[str] = ("latency", "trickle"),
        burst: int = 1,
        seconds: float = 0.0,
        after_bytes: int = 0,
    ) -> "WirePlan":
        """A seeded schedule over connections ``0..n_connections-1``:
        each index independently starts a fault with probability
        ``p_fault``; a started fault emits ``burst`` consecutive faults
        of one (seeded) kind.  Same arguments, same plan — everywhere."""
        if not 0.0 <= p_fault <= 1.0:
            raise ValueError("p_fault must be in [0, 1]")
        if burst < 1:
            raise ValueError("burst must be >= 1")
        rng = random.Random(seed)
        faults: list[WireFault] = []
        i = 0
        while i < n_connections:
            if rng.random() < p_fault:
                kind = kinds[rng.randrange(len(kinds))]
                for j in range(i, i + burst):
                    faults.append(
                        WireFault(
                            j, kind, seconds=seconds, after_bytes=after_bytes
                        )
                    )
                i += burst
            else:
                i += 1
        return cls(faults)

    # -- the PLAN schema (docs/API.md "Wire hardening") ------------------------
    @classmethod
    def from_json(cls, spec: str) -> "WirePlan":
        """Build a plan from a JSON spec — the text itself or a path to
        a file holding it.  Two forms:

        scripted: ``{"faults": [{"at": 0, "kind": "latency",
                                 "seconds": 0.01},
                                {"at": 2, "kind": "disconnect",
                                 "after_bytes": 512}]}``
        seeded:   ``{"seed": 7, "n_connections": 16, "p_fault": 0.25,
                     "kinds": ["latency", "trickle"], "seconds": 0.005}``

        ``{}`` (or ``{"faults": []}``) is the empty plan — the
        clean-path overhead measurement."""
        text = str(spec)
        try:
            if Path(text).is_file():
                text = Path(text).read_text()
        except OSError:
            pass  # inline JSON longer than a legal path name
        obj = json.loads(text)
        if not isinstance(obj, dict):
            raise ValueError("wire plan must be a JSON object")
        if "seed" in obj:
            return cls.random(
                int(obj["seed"]),
                int(obj["n_connections"]),
                p_fault=float(obj.get("p_fault", 0.25)),
                kinds=tuple(obj.get("kinds", ("latency", "trickle"))),
                burst=int(obj.get("burst", 1)),
                seconds=float(obj.get("seconds", 0.0)),
                after_bytes=int(obj.get("after_bytes", 0)),
            )
        return cls(
            WireFault(
                int(f["at"]),
                str(f["kind"]),
                seconds=float(f.get("seconds", 0.0)),
                after_bytes=int(f.get("after_bytes", 0)),
            )
            for f in obj.get("faults", ())
        )


class _Pair:
    """One proxied connection: the client socket, the upstream socket
    (None for blackhole), and the strike state its pumps share."""

    def __init__(self, cid: int, client, upstream, fault: WireFault | None):
        self.id = cid
        self.client = client
        self.upstream = upstream
        self.fault = fault
        self.lock = threading.Lock()
        self.down_bytes = 0  # upstream→client bytes forwarded so far
        self.stalled = False  # stall struck: pumps park, sockets stay up
        self.closed = False

    def close(self) -> None:
        self.closed = True
        for sock in (self.client, self.upstream):
            if sock is None:
                continue
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class ChaosProxy:
    """A deterministic TCP chaos forwarder: listens on
    ``host:port`` (0 = ephemeral), forwards every accepted connection
    to ``upstream`` (a ``host:port`` / ``http://host:port`` string or a
    ``(host, port)`` tuple), and strikes each connection with its
    plan-scheduled fault.  Point any client in the stack at
    ``proxy.url`` instead of the real endpoint."""

    def __init__(
        self,
        upstream,
        plan: WirePlan | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        hang_seconds: float = DEFAULT_HANG_SECONDS,
        connect_timeout: float = 10.0,
    ):
        if isinstance(upstream, (tuple, list)):
            self._up_host, self._up_port = upstream[0], int(upstream[1])
        else:
            split = urlsplit(
                upstream if "//" in str(upstream) else f"//{upstream}"
            )
            self._up_host = split.hostname or "127.0.0.1"
            self._up_port = int(split.port or 80)
        self.plan = plan if plan is not None else WirePlan()
        self._hang_seconds = hang_seconds
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._pairs: dict[int, _Pair] = {}
        self._timers: list[threading.Timer] = []
        self._closing = False
        #: Assertion surface: faults that actually struck, strike order.
        self.fired: list[WireFault] = []
        #: Total connections accepted (the plan index high-water mark).
        self.connections = 0

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._listener.settimeout(0.2)  # bounded accept: close() is prompt
        self.host, self.port = self._listener.getsockname()[:2]
        self._thread = threading.Thread(
            target=self._accept_loop, name="gol-netchaos-accept", daemon=True
        )
        self._thread.start()

    # -- surface ---------------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def open_connections(self) -> int:
        """Live proxied pairs — the thread/socket leak pin."""
        with self._lock:
            return sum(1 for p in self._pairs.values() if not p.closed)

    def stalled_connections(self) -> int:
        """Pairs currently half-open (a stall struck and neither
        close() nor the self-release timer has ended them) — the pin a
        stall-detection test anchors its clock on."""
        with self._lock:
            return sum(
                1 for p in self._pairs.values()
                if p.stalled and not p.closed
            )

    def set_plan(self, plan: WirePlan, relative: bool = True) -> None:
        """Swap the schedule at runtime.  With ``relative=True`` (the
        default) the plan's connection indices are rebased so index 0
        means "the NEXT connection this proxy accepts" — how a test
        injects faults after a warm-up phase (discovery, probe
        settling) of unknown connection count."""
        with self._lock:
            base = self.connections if relative else 0
        if base:
            plan = WirePlan(
                WireFault(
                    f.at + base, f.kind,
                    seconds=f.seconds, after_bytes=f.after_bytes,
                )
                for f in plan.faults
            )
        self.plan = plan

    def close(self) -> None:
        """Tear everything down: listener, every pair (stalled and
        blackholed ones included), self-release timers.  Idempotent."""
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            pairs = list(self._pairs.values())
            timers = list(self._timers)
            self._timers.clear()
        for t in timers:
            t.cancel()
        for p in pairs:
            p.close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the accept loop -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                client, _addr = self._listener.accept()
            except TimeoutError:
                continue
            except OSError:
                break
            with self._lock:
                cid = self.connections
                self.connections += 1
            fault = self.plan.fault_at(cid)
            if fault is not None:
                self.fired.append(fault)
            if fault is not None and fault.kind == "blackhole":
                # Accepted, and that is all that will ever happen.
                pair = _Pair(cid, client, None, fault)
                self._register(pair, self_release=True)
                continue
            if fault is not None and fault.kind == "disconnect" \
                    and fault.after_bytes == 0:
                # Dead before the server answers a byte.
                client.close()
                continue
            try:
                up = socket.create_connection(
                    (self._up_host, self._up_port),
                    timeout=self._connect_timeout,
                )
            except OSError:
                client.close()
                continue
            pair = _Pair(cid, client, up, fault)
            stall_now = (
                fault is not None
                and fault.kind == "stall"
                and fault.after_bytes == 0
            )
            if stall_now:
                pair.stalled = True
            self._register(
                pair,
                self_release=(fault is not None
                              and fault.kind in ("stall", "blackhole")),
            )
            # Pumps always start: a stall struck at offset 0 parks them
            # immediately, but they must exist to notice close() and
            # the self-release timer.
            for src, dst, downstream in (
                (up, client, True),
                (client, up, False),
            ):
                threading.Thread(
                    target=self._pump,
                    args=(pair, src, dst, downstream),
                    name=f"gol-netchaos-pump-{cid}",
                    daemon=True,
                ).start()

    def _register(self, pair: _Pair, self_release: bool) -> None:
        with self._lock:
            self._pairs[pair.id] = pair
            if self_release and self._hang_seconds:
                timer = threading.Timer(self._hang_seconds, pair.close)
                timer.daemon = True
                self._timers.append(timer)
                timer.start()

    # -- the pumps -------------------------------------------------------------
    def _pump(self, pair: _Pair, src, dst, downstream: bool) -> None:
        """Forward ``src``→``dst`` until EOF/close.  ``downstream`` is
        the upstream→client direction — the one byte-offset faults
        meter (it carries the stack's responses and frame streams)."""
        fault = pair.fault
        src.settimeout(0.5)  # bounded reads: close()/stall stay prompt
        try:
            while not pair.closed and not self._closing:
                if pair.stalled:
                    time.sleep(0.05)
                    continue
                try:
                    data = src.recv(_CHUNK)
                except TimeoutError:
                    continue
                except OSError:
                    break
                if not data:
                    break
                if not downstream or fault is None:
                    self._write(pair, dst, data)
                    continue
                data = bytearray(data)
                offset = pair.down_bytes
                if fault.kind == "latency":
                    time.sleep(fault.seconds)
                elif fault.kind == "corrupt":
                    hit = fault.after_bytes - offset
                    if 0 <= hit < len(data):
                        data[hit] ^= 0xFF
                elif fault.kind == "disconnect":
                    keep = fault.after_bytes - offset
                    if keep < len(data):
                        if keep > 0:
                            self._write(pair, dst, data[:keep])
                            pair.down_bytes += keep
                        pair.close()
                        break
                elif fault.kind == "stall":
                    keep = fault.after_bytes - offset
                    if keep < len(data):
                        if keep > 0:
                            self._write(pair, dst, data[:keep])
                            pair.down_bytes += keep
                        pair.stalled = True
                        continue
                if fault.kind == "trickle":
                    for i in range(len(data)):
                        if pair.closed or pair.stalled or self._closing:
                            break
                        if fault.seconds:
                            time.sleep(fault.seconds)
                        if not self._write(pair, dst, data[i : i + 1]):
                            break
                        pair.down_bytes += 1
                    continue
                if self._write(pair, dst, data):
                    pair.down_bytes += len(data)
        finally:
            # EOF/error on either leg ends the pair (unless it is
            # deliberately stalled half-open — then only close()/the
            # self-release timer may end it).
            if not pair.stalled:
                pair.close()

    @staticmethod
    def _write(pair: _Pair, dst, data) -> bool:
        try:
            dst.sendall(data)
            return True
        except OSError:
            pair.close()
            return False


__all__ = [
    "DEFAULT_HANG_SECONDS",
    "WIRE_FAULT_KINDS",
    "ChaosProxy",
    "WireFault",
    "WirePlan",
]
