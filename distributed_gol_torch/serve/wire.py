"""The gateway wire protocol — message schemas and codecs.

A copy of ``distributed_gol_tpu/serve/wire.py`` on the port's engine:
every message it encodes is byte for byte the JAX package's.

The protocol is the reference broker contract put on the wire
(PAPER.md §1): ``Broker.Publish`` is ``POST /v1/sessions`` (a board or
soup spec + Params JSON through the admission ladder),
``Broker.Pause`` is ``POST .../pause|resume``, ``Broker.CheckStates``
is ``GET .../state`` (alive-count/turn per run), ``Broker.Quit`` is
``POST .../quit`` — and the controller's event channel plus the
spectator frame stream ride WebSocket legs (``serve/ws.py``).

This module is the ONE home of what crosses the socket, used by both
``serve/gateway.py`` (server) and ``tools/gol_client.py`` (client):

- **Control/event messages** (ws text frames): JSON dicts with a
  ``type`` field.  :func:`event_to_wire` maps the engine's typed event
  stream (``engine/events.py``) onto them; chatty per-cell forms
  (``CellFlipped``) and the frame events (they have their own binary
  leg) are elided — the controller leg is control + telemetry, exactly
  the reference's events channel minus pixels.
- **Frame messages** (ws binary frames): a 4-byte big-endian header
  length, a JSON header, and the raw payload.  A keyframe ships the
  whole rendered viewport (``FrameReady``); a delta ships
  ``engine/frames.pack_bands`` output (``FrameDelta``) — byte-exact
  the in-process spectator wire format, so a wire spectator
  reconstructs with the same ``apply_bands`` contract.
- **Session specs** (HTTP POST bodies): :func:`params_from_spec`
  builds a :class:`Params` from whitelisted JSON fields plus either a
  ``soup`` spec or an uploaded base64 PGM board — malformed input is a
  :class:`SpecError` (the gateway's 400), never a traceback.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

from distributed_gol_torch.engine import frames as frames_lib
from distributed_gol_torch.engine import pgm
from distributed_gol_torch.engine.events import (
    AliveCellsCount,
    CheckpointSaved,
    CycleDetected,
    DispatchError,
    FinalTurnComplete,
    FrameDelta,
    FrameReady,
    ImageOutputComplete,
    MetricsReport,
    StateChange,
    TurnComplete,
    TurnsCompleted,
)
from distributed_gol_torch.engine.params import Params


class SpecError(ValueError):
    """A malformed session spec / wire message — the gateway's 400."""


# -- event stream (controller leg, ws text frames) -----------------------------

def event_to_wire(event) -> dict | None:
    """One engine event as a wire message dict, or None for event types
    the controller leg elides (per-cell flips, frame payloads)."""
    t = event.completed_turns
    if isinstance(event, TurnsCompleted):
        return {"type": "turns", "first": event.first_turn, "turn": t}
    if isinstance(event, TurnComplete):
        return {"type": "turns", "first": t, "turn": t}
    if isinstance(event, AliveCellsCount):
        return {"type": "alive", "turn": t, "count": event.cells_count}
    if isinstance(event, StateChange):
        return {"type": "state", "turn": t, "state": str(event.new_state)}
    if isinstance(event, FinalTurnComplete):
        xy = getattr(event.alive, "_xy", None)
        alive = (
            xy.tolist()
            if xy is not None
            else [[int(c.x), int(c.y)] for c in event.alive]
        )
        return {"type": "final", "turn": t, "alive": alive}
    if isinstance(event, DispatchError):
        return {
            "type": "dispatch_error",
            "turn": t,
            "error": event.error,
            "will_retry": event.will_retry,
            "checkpointed": event.checkpointed,
            "attempt": event.attempt,
        }
    if isinstance(event, CheckpointSaved):
        return {"type": "checkpoint", "turn": t}
    if isinstance(event, CycleDetected):
        return {"type": "cycle", "turn": t, "period": event.period}
    if isinstance(event, ImageOutputComplete):
        return {"type": "image", "turn": t, "filename": event.filename}
    if isinstance(event, MetricsReport):
        return {"type": "metrics_report", "turn": t, "run_id": event.run_id}
    return None  # flips / frames / unknown extensions: elided


# -- frame stream (spectator leg, ws binary frames) ----------------------------

def encode_frame_event(event) -> bytes:
    """A FrameReady/FrameDelta as one binary wire frame:
    ``>I header-length | header JSON | payload``.  When the event
    carries the FramePlane's wall-clock publish stamp (``event.ts``),
    the header carries it verbatim: the stamp is set ONCE
    per publish, so every subscriber's copy of one frame encodes to
    identical wire bytes (the relay tree's bit-identity), and relays —
    which forward blobs verbatim — measure true publish-to-here
    staleness (``relay.frame_staleness_seconds``) at any chain depth.
    Decoders ignore unknown header keys — old clients are
    unaffected."""
    if isinstance(event, FrameReady):
        frame = np.ascontiguousarray(event.frame, dtype=np.uint8)
        header = {
            "type": "keyframe",
            "turn": event.completed_turns,
            "rect": list(event.rect) if event.rect is not None else None,
            "shape": list(frame.shape),
        }
        payload = frame.tobytes()
    elif isinstance(event, FrameDelta):
        meta, payload = frames_lib.pack_bands(event.bands)
        header = {
            "type": "delta",
            "turn": event.completed_turns,
            "rect": list(event.rect) if event.rect is not None else None,
            "bands": meta,
        }
    else:
        raise TypeError(f"not a frame event: {type(event).__name__}")
    if event.ts is not None:
        header["ts"] = event.ts
    head = json.dumps(header).encode()
    return struct.pack(">I", len(head)) + head + payload


def decode_frame_event(blob: bytes):
    """Inverse of :func:`encode_frame_event` (raises ValueError on a
    malformed frame — a truncated wire message must not apply)."""
    if len(blob) < 4:
        raise ValueError("frame message shorter than its length prefix")
    (hlen,) = struct.unpack(">I", blob[:4])
    if 4 + hlen > len(blob):
        raise ValueError("frame header truncated")
    header = json.loads(blob[4 : 4 + hlen])
    payload = blob[4 + hlen :]
    rect = tuple(header["rect"]) if header.get("rect") is not None else None
    turn = int(header["turn"])
    ts = header.get("ts")
    if not isinstance(ts, (int, float)):
        ts = None
    if header.get("type") == "keyframe":
        h, w = (int(v) for v in header["shape"])
        if len(payload) != h * w:
            raise ValueError(
                f"keyframe payload {len(payload)} != shape {h}x{w}"
            )
        frame = np.frombuffer(payload, np.uint8).reshape(h, w)
        return FrameReady(turn, frame, rect=rect, ts=ts)
    if header.get("type") == "delta":
        bands = frames_lib.unpack_bands(header["bands"], payload)
        return FrameDelta(turn, bands=bands, rect=rect, ts=ts)
    raise ValueError(f"unknown frame message type {header.get('type')!r}")


# -- session specs (POST /v1/sessions bodies) ----------------------------------

#: Params fields a wire submission may set, with coercers.  Everything
#: else is pod policy (deadlines ride the admission config; mesh/engine
#: internals are the operator's) — an unknown key is a SpecError so a
#: client typo cannot silently run a different simulation.
_PARAM_FIELDS = {
    "turns": int,
    "width": int,
    "height": int,
    "engine": str,
    "superstep": int,
    "rule": str,
    "soup_density": float,
    "soup_seed": int,
    "turn_events": str,
    "checkpoint_every_turns": int,
    "checkpoint_keep": int,
    "restart_limit": int,
    "retry_limit": int,
    "sdc_check_every_turns": int,
    "ticker_period": float,
    "cycle_check": int,
    "time_compression": lambda v: _coerce_bool(v, "time_compression"),
    "timecomp_cache_slots": int,
}


def _coerce_bool(v, field: str) -> bool:
    """JSON booleans only — ``bool("false")`` is True, so a string here
    is a client bug the wire must reject, not silently enable."""
    if isinstance(v, bool):
        return v
    raise TypeError(f"{field} must be a JSON boolean, got {type(v).__name__}")

#: Spec keys outside the Params whitelist.
_SPEC_KEYS = {"params", "board_b64", "soup", "spectate", "viewport",
              "frame_stride", "deadline_seconds"}


def params_from_spec(
    tenant: str, spec: dict, root: Path | None = None, device: str = "cuda"
) -> tuple[Params, dict]:
    """Build the ``Params`` for one wire submission.

    ``spec`` is the decoded POST body: ``{"params": {...}, "soup":
    {"density", "seed"} | "board_b64": <base64 PGM>, "spectate": bool,
    "viewport": [y0,x0,vh,vw], "frame_stride": int, "deadline_seconds":
    float}``.  Returns ``(params, options)`` where ``options`` carries
    the non-Params knobs the gateway applies at submit time
    (``spectate``, ``deadline_seconds``).

    An uploaded board is decoded from base64 PGM bytes and parked under
    ``root/<tenant>/upload/`` as the run's input image (the reference's
    ``Publish`` ships the world in the RPC; here it ships in the POST).
    A ``spectate`` session runs the frame-mode viewer path with a
    viewport, so its FramePlane publishes every rendered turn.

    ``device`` is pod policy, never the client's: the Params run there
    (``"cuda"``, the card, unless the pod was asked for the CPU)."""
    if not isinstance(spec, dict):
        raise SpecError("session spec must be a JSON object")
    unknown = set(spec) - _SPEC_KEYS
    if unknown:
        raise SpecError(f"unknown spec keys: {sorted(unknown)}")
    raw = spec.get("params") or {}
    if not isinstance(raw, dict):
        raise SpecError("'params' must be an object")
    unknown = set(raw) - set(_PARAM_FIELDS)
    if unknown:
        raise SpecError(f"unknown params fields: {sorted(unknown)}")
    kw: dict = {}
    for key, coerce in _PARAM_FIELDS.items():
        if key in raw:
            try:
                kw[key] = coerce(raw[key])
            except (TypeError, ValueError) as e:
                raise SpecError(f"params.{key}: {e}") from None
    if "rule" in kw:
        from distributed_gol_torch.models.life import parse_rule

        try:
            kw["rule"] = parse_rule(kw["rule"])
        except ValueError as e:
            raise SpecError(str(e)) from None
    width = kw.pop("width", None)
    height = kw.pop("height", None)

    board = spec.get("board_b64")
    soup = spec.get("soup")
    if board is not None and soup is not None:
        raise SpecError("pass either 'board_b64' or 'soup', not both")
    if board is not None:
        try:
            world = pgm.decode_pgm(base64.b64decode(board))
        except (ValueError, pgm.PgmError) as e:
            raise SpecError(f"board_b64: {e}") from None
        h, w = world.shape
        if (width is not None and width != w) or (
            height is not None and height != h
        ):
            raise SpecError(
                f"uploaded board is {w}x{h}, contradicting params "
                f"width/height"
            )
        width, height = w, h
        # Park the upload as the run's input image — Publish-over-POST.
        updir = (root or Path("out")) / tenant / "upload"
        updir.mkdir(parents=True, exist_ok=True)
        pgm.write_pgm(updir / f"{w}x{h}.pgm", world)
        kw["images_dir"] = updir
    elif soup is not None:
        if not isinstance(soup, dict):
            raise SpecError("'soup' must be {'density': float, 'seed': int}")
        try:
            kw["soup_density"] = float(soup.get("density", 0.3))
            kw["soup_seed"] = int(soup.get("seed", 0))
        except (TypeError, ValueError) as e:
            raise SpecError(f"soup: {e}") from None
    elif "soup_density" not in kw:
        raise SpecError(
            "a session needs a board: pass 'board_b64', 'soup', or "
            "params.soup_density"
        )
    if width is not None:
        kw["image_width"] = width
    if height is not None:
        kw["image_height"] = height
    kw.setdefault("turn_events", "batch")

    spectate = bool(spec.get("spectate", False))
    if spectate:
        w = kw.get("image_width", 512)
        h = kw.get("image_height", 512)
        viewport = spec.get("viewport")
        if viewport is None:
            viewport = (0, 0, min(256, h), min(256, w))
        try:
            viewport = tuple(int(v) for v in viewport)
        except (TypeError, ValueError):
            raise SpecError("viewport must be [y0, x0, vh, vw]") from None
        if len(viewport) != 4 or viewport[2] < 1 or viewport[3] < 1:
            raise SpecError("viewport must be [y0, x0, vh, vw]")
        try:
            stride = int(spec.get("frame_stride", 1) or 1)
        except (TypeError, ValueError) as e:
            raise SpecError(f"frame_stride: {e}") from None
        # The frame-mode viewer path is what publishes to the session's
        # FramePlane each rendered turn (engine/controller.py); the
        # session's own viewport rides the same ROI machinery.
        kw.update(
            no_vis=False,
            view_mode="frame",
            viewport=viewport,
            frame_stride=stride,
        )
    elif "viewport" in spec or "frame_stride" in spec:
        raise SpecError("'viewport'/'frame_stride' need 'spectate': true")

    out_root = (root or Path("out")) / tenant
    kw.setdefault("out_dir", out_root)
    kw["device"] = device
    options = {"spectate": spectate}
    if spec.get("deadline_seconds") is not None:
        try:
            options["deadline_seconds"] = float(spec["deadline_seconds"])
        except (TypeError, ValueError) as e:
            raise SpecError(f"deadline_seconds: {e}") from None
    try:
        return Params(**kw), options
    except (TypeError, ValueError) as e:
        raise SpecError(f"invalid params: {e}") from None


# -- control frames (controller leg, client -> server) -------------------------

#: Raw keyboard-equivalent keys a controller may inject (the
#: reference's sdl/loop.go s/p/q/k plus the viewport's pan/zoom set).
CONTROL_KEYS = frozenset("spqk" "adwx+=-")


def parse_control(text: str) -> dict:
    """Decode one inbound controller/spectator ws text frame; raises
    :class:`SpecError` on garbage (the server answers with an error
    message rather than dying)."""
    try:
        msg = json.loads(text)
    except ValueError as e:
        raise SpecError(f"not JSON: {e}") from None
    if not isinstance(msg, dict) or "type" not in msg:
        raise SpecError("control frame must be {'type': ...}")
    kind = msg["type"]
    if kind in ("pause", "resume", "quit"):
        return {"type": kind}
    if kind == "key":
        key = msg.get("key")
        if key not in CONTROL_KEYS:
            raise SpecError(f"unknown key {key!r}")
        return {"type": "key", "key": key}
    if kind == "set_viewport":
        rect = msg.get("rect")
        try:
            rect = tuple(int(v) for v in rect)
        except (TypeError, ValueError):
            raise SpecError("set_viewport wants rect=[y0,x0,vh,vw]") from None
        if len(rect) != 4 or rect[2] < 1 or rect[3] < 1:
            raise SpecError("set_viewport wants rect=[y0,x0,vh,vw]")
        return {"type": "set_viewport", "rect": rect}
    raise SpecError(f"unknown control type {kind!r}")


__all__ = [
    "CONTROL_KEYS",
    "SpecError",
    "decode_frame_event",
    "encode_frame_event",
    "event_to_wire",
    "params_from_spec",
    "parse_control",
]
