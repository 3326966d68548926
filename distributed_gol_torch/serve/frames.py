"""FramePlane — the spectator fan-out hub.

A copy of ``distributed_gol_tpu/serve/frames.py`` on the port's engine.

One session renders; N spectators watch.  Without a hub every spectator
costs one device fetch per frame — O(N · viewport) device round-trips per
turn, which is exactly the per-viewer cost the serving plane exists to
amortise away.  The FramePlane inverts it: per (session, turn) the
producer makes ONE device fetch of the COALESCED bounding rect of every
subscriber's viewport (``publish``), and each subscriber's frame is
sliced host-side from that superset and delta-encoded against the last
frame that subscriber was shipped (``engine/frames.py`` — the same wire
format the controller's own viewer speaks).  Fetches/frame == 1 for any
N (test-pinned); per-subscriber work is O(their viewport), and wire
bytes O(activity ∩ viewport).

The hub rides the serving machinery rather than reimplementing it: a
``Controller`` with ``frame_plane=`` publishes every rendered turn
(``gol.run(..., frame_plane=)``, surviving supervisor restarts), and
cohort-batched tenants publish through their solo fetch surface —
``_CohortMember`` only overrides the superstep seam, so ROI fetches are
inherited unchanged.  Standalone callers (benches, tests, a future
WebSocket front-end) call ``publish`` directly with any
``fetch(rect) -> np.uint8`` callable.

Coalescing on a torus: the bounding rect per axis is the shortest cyclic
interval covering every subscriber interval (anchor-candidate scan); when
subscribers are spread past the point where one window helps, the axis
degrades to full size — still one fetch, never two.  Subscribers joining
or re-viewporting mid-stream get a keyframe on their next published
turn; slow consumers lose OLDEST frames first (bounded queues,
drop-oldest) so one stalled spectator can never wedge the producer.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np

from distributed_gol_torch.engine import frames as frames_lib
from distributed_gol_torch.engine.events import FrameDelta, FrameReady
from distributed_gol_torch.obs import metrics as obs_metrics
from distributed_gol_torch.obs import tracing


class FrameSubscriber:
    """One spectator: a viewport rect and a bounded event queue of
    FrameReady/FrameDelta events (drop-OLDEST on overflow — a spectator
    that falls behind skips frames and re-anchors on the keyframe the
    plane sends after any drop, rather than stalling the producer).

    The stream speaks exactly the viewer wire format: consume with the
    same ``set_frame`` / ``apply_bands`` logic as ``viewer/window.py``
    (``reconstruct`` is the reference consumer, used by the tests)."""

    def __init__(self, sub_id: int, rect, maxsize: int = 8):
        self.id = sub_id
        self.rect = rect
        self.events: queue.Queue = queue.Queue(maxsize=max(1, maxsize))
        self._last = None  # last shipped frame (the delta base)
        self._dropped = False  # a frame was dropped: next ship keyframes

    def _needs_keyframe(self, frame: np.ndarray) -> bool:
        """Whether the next ship must keyframe (un-anchored: first
        frame, rect change, post-drop) — read by the publisher BEFORE
        encoding so anchored same-rect subscribers can share one delta
        encode (the per-distinct-rect dedup)."""
        last = self._last
        return last is None or self._dropped or last.shape != frame.shape

    def _ship(
        self, turn: int, frame: np.ndarray, rect, bands=None, ts=None
    ) -> int:
        """Enqueue this turn's frame for the spectator — keyframe when
        un-anchored (first frame, rect change, post-drop), else delta
        bands.  ``rect`` is the publisher's SNAPSHOT of this
        subscriber's viewport (taken under the plane lock), so the
        event's rect always labels the content actually shipped even if
        ``set_viewport`` raced the publish.  ``bands`` is the
        publisher's shared per-rect delta encoding (computed once per
        distinct rect); None computes it here — only legal against
        this subscriber's own ``_last``.  Returns payload bytes
        shipped."""
        last = self._last
        self._last = frame
        if last is None or self._dropped or last.shape != frame.shape:
            self._dropped = False
            ev = FrameReady(turn, frame, rect=rect, ts=ts)
            nbytes = frame.nbytes
        else:
            if bands is None:
                bands = frames_lib.delta_bands(last, frame)
            ev = FrameDelta(turn, bands=bands, rect=rect, ts=ts)
            nbytes = frames_lib.bands_nbytes(bands)
        while True:
            try:
                self.events.put_nowait(ev)
                return nbytes
            except queue.Full:
                # Drop-oldest; whatever state the consumer reconstructs
                # from the survivors, the next _ship keyframes over it.
                self._dropped = True
                try:
                    self.events.get_nowait()
                except queue.Empty:
                    pass

    def reconstruct(self, buf=None):
        """Drain pending events into a frame buffer (None until the
        first keyframe arrives) — the reference consumer of the wire
        format, shared by tests and simple pollers.  Deltas with no
        anchoring keyframe are skipped, not applied: drop-oldest can
        evict the keyframe while its deltas survive, and the plane's
        post-drop re-keyframe converges the stream on the next ship."""
        while True:
            try:
                ev = self.events.get_nowait()
            except queue.Empty:
                return buf
            if isinstance(ev, FrameReady):
                buf = np.array(ev.frame, dtype=np.uint8, copy=True)
            elif buf is not None:
                frames_lib.apply_bands(buf, ev.bands)


def _cyclic_bound(intervals, n: int) -> tuple[int, int]:
    """Shortest cyclic interval (start, length) on a ring of size ``n``
    covering every (start, length) interval.  Degrades to the full axis
    (0, n) when no single window shorter than the ring covers them.
    Candidate-anchor scan: the optimal window starts at some interval's
    start, so trying each is exact — O(k²) with k = subscriber count,
    host-side, negligible against the fetch it shapes."""
    ivs = [(s % n, min(ln, n)) for s, ln in intervals]
    best = None
    for anchor, _ in ivs:
        ext = max((s - anchor) % n + ln for s, ln in ivs)
        if ext >= n:
            continue
        if best is None or ext < best[1]:
            best = (anchor, ext)
    return best if best is not None else (0, n)


class FramePlane:
    """The subscriber hub.  Thread-safe: subscribe/set_viewport may race
    ``publish`` (the producer thread) — the subscriber set is snapshotted
    per publish under the lock, and a rect change simply keyframes on
    the next turn it is seen."""

    def __init__(self, board_shape=None, metrics: bool = True):
        self._lock = threading.Lock()
        self._subs: dict[int, FrameSubscriber] = {}
        self._ids = itertools.count()
        # (h, w) of the torus — the bounding-rect wrap arithmetic needs
        # it.  Pass it here, call bind(), or attach the plane to a run
        # (the controller binds automatically); publish refuses unbound.
        self._board_shape = (
            None if board_shape is None else tuple(int(v) for v in board_shape)
        )
        reg = obs_metrics.registry_for(metrics)
        # The fan-out economics, straight off the hub: fetches per
        # published turn is ALWAYS 1 (the acceptance proof reads these
        # two counters), bytes split device-fetched vs wire-shipped.
        self._m_publishes = reg.counter("frames.publishes")
        self._m_fetches = reg.counter("frames.fetches")
        self._m_frames = reg.counter("frames.frames_served")
        self._m_bytes_fetched = reg.counter("frames.bytes_fetched")
        self._m_bytes_shipped = reg.counter("frames.bytes_shipped")
        reg.gauge_fn("frames.subscribers", lambda: float(len(self._subs)))

    # -- subscriber management -------------------------------------------------
    def subscribe(self, rect, maxsize: int = 8) -> FrameSubscriber:
        """Register a spectator for viewport ``rect`` (y0, x0, vh, vw).
        Its first frame (next published turn) is a keyframe."""
        rect = tuple(int(v) for v in rect)
        if len(rect) != 4 or rect[2] < 1 or rect[3] < 1:
            raise ValueError(f"rect must be (y0, x0, vh, vw), got {rect!r}")
        with self._lock:
            sub = FrameSubscriber(next(self._ids), rect, maxsize)
            self._subs[sub.id] = sub
        return sub

    def unsubscribe(self, sub: FrameSubscriber) -> None:
        with self._lock:
            self._subs.pop(sub.id, None)

    def set_viewport(self, sub: FrameSubscriber, rect) -> None:
        """Pan/zoom a spectator mid-stream; the next published frame is
        a keyframe for the new rect."""
        rect = tuple(int(v) for v in rect)
        if len(rect) != 4 or rect[2] < 1 or rect[3] < 1:
            raise ValueError(f"rect must be (y0, x0, vh, vw), got {rect!r}")
        with self._lock:
            sub.rect = rect
            sub._last = None  # re-anchor: next ship is a keyframe

    def subscribers(self) -> int:
        return len(self._subs)

    # -- the fan-out -----------------------------------------------------------
    @staticmethod
    def _bound_rects(rects, h: int, w: int):
        """The coalesced fetch rect covering ``rects`` on an (h, w)
        torus, or None with no rects."""
        if not rects:
            return None
        y0, vh = _cyclic_bound([(r[0], r[2]) for r in rects], h)
        x0, vw = _cyclic_bound([(r[1], r[3]) for r in rects], w)
        return (y0, x0, vh, vw)

    def bounding_rect(self, h: int, w: int):
        """The coalesced fetch rect for the current subscriber set on an
        (h, w) torus, or None with no subscribers."""
        with self._lock:
            rects = [tuple(s.rect) for s in self._subs.values()]
        return self._bound_rects(rects, h, w)

    def publish(self, turn: int, fetch) -> dict:
        """Serve every subscriber one frame for ``turn`` off ONE device
        fetch.  ``fetch(rect) -> np.uint8 (vh, vw)`` is the producer's
        viewport fetch — ``Backend.fetch_viewport`` bound to the live
        board (the controller wraps it in the dispatch watchdog, like
        every other fetch).  Returns {subscribers, fetched_bytes,
        shipped_bytes, rect} for the caller's telemetry."""
        # Snapshot (subscriber, rect) pairs ONCE under the lock: the
        # bounding rect, the superset slicing, and the shipped event's
        # rect label must all describe the same viewport even when
        # ``set_viewport`` races this publish (the racer's new rect
        # simply takes effect next turn, as a keyframe).
        with self._lock:
            subs = [(s, tuple(s.rect)) for s in self._subs.values()]
        self._m_publishes.inc()
        if not subs:
            return {
                "subscribers": 0,
                "fetched_bytes": 0,
                "shipped_bytes": 0,
                "rect": None,
            }
        if self._board_shape is None:
            raise ValueError(
                "FramePlane is unbound: pass board_shape= or call "
                "bind(h, w) before publish (an attached controller "
                "binds automatically)"
            )
        # One fetch: the torus-shortest bounding rect of every viewport.
        h, w = self._board_shape
        rect = self._bound_rects([r for _, r in subs], h, w)
        # The publish span: rides the producer's request
        # trace when one is active on this context (the controller
        # publishes from the run's worker) — nullcontext otherwise.
        # Covers the WHOLE publish (coalesced fetch AND the
        # per-subscriber slice/ship fan-out), so a many-spectator
        # tenant's frame latency is attributable to this span, not
        # unaccounted host time after it.
        # One wall-clock stamp per publish, shared by every subscriber's
        # event: same publish → identical wire bytes downstream (the
        # relay tree's bit-identity), and the stamp measures frame AGE
        # (publish → ingest), not encode skew.
        ts = round(time.time(), 6)
        with tracing.span(
            "gol.frame.publish", turn=turn, subscribers=len(subs)
        ):
            superset = fetch(rect)
            self._m_fetches.inc()
            self._m_bytes_fetched.inc(superset.nbytes)
            by0, bx0, bvh, bvw = rect
            shipped = 0
            # Group same-rect subscribers: the slice, the contiguous
            # copy, AND the delta encoding are computed once per
            # DISTINCT rect, not once per subscriber (the relay-tree
            # workload is many watchers of one rect).  Sharing one
            # frame array as every member's ``_last`` is what keeps the
            # dedup exact next turn: anchored members' delta bases are
            # the identical object.
            groups: dict[tuple, list] = {}
            for sub, srect in subs:
                groups.setdefault(srect, []).append(sub)
            for (sy, sx, svh, svw), members in groups.items():
                # Subscriber offset inside the fetched superset.
                # Coverage guarantees oy + svh <= bvh whenever bvh < h;
                # a full-axis superset (bvh == h) is the whole ring
                # anchored at by0, so the index arithmetic wraps mod
                # bvh.
                oy = (sy - by0) % h
                ox = (sx - bx0) % w
                rows = (
                    slice(oy, oy + svh)
                    if oy + svh <= bvh
                    else (np.arange(svh) + oy) % bvh
                )
                cols = (
                    slice(ox, ox + svw)
                    if ox + svw <= bvw
                    else (np.arange(svw) + ox) % bvw
                )
                view = np.ascontiguousarray(superset[rows][:, cols])
                # One encode per distinct delta base — in steady state
                # exactly one per rect (every anchored member's _last
                # is last turn's shared array).  The base is kept in
                # the cache entry so its id cannot be recycled mid-loop.
                enc: dict[int, tuple] = {}
                for sub in members:
                    bands = None
                    last = sub._last
                    if not sub._needs_keyframe(view):
                        hit = enc.get(id(last))
                        if hit is None:
                            bands = frames_lib.delta_bands(last, view)
                            enc[id(last)] = (last, bands)
                        else:
                            bands = hit[1]
                    shipped += sub._ship(
                        turn, view, (sy, sx, svh, svw), bands=bands, ts=ts
                    )
                    self._m_frames.inc()
            self._m_bytes_shipped.inc(shipped)
        return {
            "subscribers": len(subs),
            "fetched_bytes": int(superset.nbytes),
            "shipped_bytes": int(shipped),
            "rect": rect,
        }

    def bind(self, h: int, w: int) -> "FramePlane":
        """Tell the hub the board's torus shape (bounding-rect wrap
        arithmetic needs it).  Returns self for chaining; the controller
        binds automatically when a plane is attached to a run."""
        self._board_shape = (int(h), int(w))
        return self


__all__ = ["FramePlane", "FrameSubscriber"]
