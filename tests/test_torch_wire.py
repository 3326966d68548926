"""The port's wire codecs (``serve/wire.py``, ``serve/ws.py``) against the
JAX package's, byte for byte, on the CPU.

Every message the port encodes must be the JAX package's bytes: the
controller leg's JSON events, the spectator leg's binary frame messages
(keyframes and delta bands, with and without a publish stamp), the
RFC 6455 frames, and the session specs' Params.  Ported rows of the JAX
``tests/test_gateway.py`` (the codec units) follow."""

import base64
import dataclasses
import json
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_gol_torch.engine import events as tev
from distributed_gol_torch.engine import frames as tframes
from distributed_gol_torch.engine import pgm as tpgm
from distributed_gol_torch.serve import wire
from distributed_gol_torch.serve import ws as ws_lib
from distributed_gol_torch.utils.cell import Cell
from distributed_gol_tpu.engine import events as jev
from distributed_gol_tpu.serve import wire as jwire
from distributed_gol_tpu.serve import ws as jws
from distributed_gol_tpu.utils.cell import Cell as JCell

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


def both(name: str, *args, **kw):
    """The same event built from each package's class: (port's, JAX's)."""
    return getattr(tev, name)(*args, **kw), getattr(jev, name)(*args, **kw)


def frame(h, w, seed):
    return (np.random.default_rng(seed).random((h, w)) < 0.3).astype(np.uint8) * 255


# -- the controller leg: JSON events ------------------------------------------------


EVENTS = [
    ("TurnComplete", (3,), {}),
    ("TurnsCompleted", (), dict(completed_turns=8, first_turn=5)),
    ("AliveCellsCount", (12,), dict(cells_count=345)),
    ("StateChange", (4,), dict(new_state="PAUSED")),
    ("DispatchError", (7,), dict(error="boom", will_retry=True, checkpointed=False,
                                 attempt=2)),
    ("CheckpointSaved", (16,), {}),
    ("CycleDetected", (600,), dict(period=2)),
    ("ImageOutputComplete", (9,), dict(filename="64x64x9")),
    ("MetricsReport", (100,), dict(run_id="r-1")),
    ("CellFlipped", (1,), {}),
    ("FrameReady", (1, np.zeros((2, 2), np.uint8)), {}),
]


@pytest.mark.parametrize("name,args,kw", EVENTS, ids=[e[0] for e in EVENTS])
def test_event_to_wire_matches_jax(name, args, kw):
    if "new_state" in kw:
        t, j = tev.StateChange(*args, new_state=tev.State.PAUSED), jev.StateChange(
            *args, new_state=jev.State.PAUSED)
    else:
        t, j = both(name, *args, **kw)
    got, want = wire.event_to_wire(t), jwire.event_to_wire(j)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


def test_final_event_to_wire_matches_jax():
    cells = [(3, 4), (0, 7), (9, 1)]
    t = tev.FinalTurnComplete(10, alive=[Cell(x, y) for x, y in cells])
    j = jev.FinalTurnComplete(10, alive=[JCell(x, y) for x, y in cells])
    assert json.dumps(wire.event_to_wire(t)) == json.dumps(jwire.event_to_wire(j))


# -- the spectator leg: binary frame messages ------------------------------------------


@pytest.mark.parametrize("ts", [None, 1234.5678])
@pytest.mark.parametrize("rect", [None, (5, 7, 12, 9)])
@pytest.mark.parametrize("shape", [(12, 9), (1, 1), (33, 64)])
def test_keyframe_bytes_match_jax(shape, rect, ts):
    f = frame(*shape, seed=shape[0])
    t = tev.FrameReady(3, f, rect=rect, ts=ts)
    j = jev.FrameReady(3, f, rect=rect, ts=ts)
    blob = wire.encode_frame_event(t)
    assert blob == jwire.encode_frame_event(j)
    back = wire.decode_frame_event(blob)
    assert isinstance(back, tev.FrameReady) and back.rect == rect and back.ts == ts
    np.testing.assert_array_equal(np.asarray(back.frame), f)


@pytest.mark.parametrize("ts", [None, 99.000001])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_delta_bytes_match_jax(seed, ts):
    prev, new = frame(40, 24, seed), frame(40, 24, seed + 10)
    new[:16] = prev[:16]  # some bands unchanged
    bands = tframes.delta_bands(prev, new)
    blob = wire.encode_frame_event(tev.FrameDelta(9, bands=bands, rect=(0, 1, 40, 24), ts=ts))
    assert blob == jwire.encode_frame_event(jev.FrameDelta(9, bands=bands, rect=(0, 1, 40, 24),
                                                           ts=ts))
    out = wire.decode_frame_event(blob)
    buf = prev.copy()
    tframes.apply_bands(buf, out.bands)
    np.testing.assert_array_equal(buf, new)


def test_non_frame_events_refused():
    with pytest.raises(TypeError):
        wire.encode_frame_event(tev.TurnComplete(1))


def test_truncated_frames_refused_as_jax_refuses():
    blob = wire.encode_frame_event(tev.FrameReady(1, np.ones((8, 8), np.uint8)))
    for bad in (blob[:-3], b"\x00\x01", b"\x00\x00\x00\x05{}"):
        with pytest.raises(ValueError):
            wire.decode_frame_event(bad)
        with pytest.raises(ValueError):
            jwire.decode_frame_event(bad)


def test_pack_bands_mismatch_refused():
    meta, payload = tframes.pack_bands(((0, np.ones((2, 4), np.uint8)),))
    with pytest.raises(ValueError, match="truncated"):
        tframes.unpack_bands(meta, payload[:-1])
    with pytest.raises(ValueError, match="trailing"):
        tframes.unpack_bands(meta, payload + b"x")


# -- control frames -------------------------------------------------------------------


CONTROL = ['{"type": "pause"}', '{"type": "resume"}', '{"type": "quit"}',
           '{"type": "set_viewport", "rect": [1, 2, 3, 4]}', '{"type": "key", "key": "s"}',
           '{"type": "key", "key": "+"}']
BAD_CONTROL = ["not json", "[1]", '{"type": "reboot"}', '{"type": "key", "key": "Z"}',
               '{"type": "set_viewport", "rect": [1, 2]}',
               '{"type": "set_viewport", "rect": [1, 2, 0, 4]}', '{"kind": "pause"}']


@pytest.mark.parametrize("text", CONTROL)
def test_parse_control_matches_jax(text):
    assert wire.parse_control(text) == jwire.parse_control(text)


@pytest.mark.parametrize("text", BAD_CONTROL)
def test_bad_control_refused_as_jax_refuses(text):
    with pytest.raises(wire.SpecError) as got:
        wire.parse_control(text)
    with pytest.raises(jwire.SpecError) as want:
        jwire.parse_control(text)
    assert str(got.value) == str(want.value)


# -- session specs ---------------------------------------------------------------------


def base_spec(**kw):
    spec = {"params": {"width": 16, "height": 16, "turns": 24, "engine": "roll",
                       "superstep": 4, "cycle_check": 0, "ticker_period": 60.0},
            "soup": {"density": 0.25, "seed": 7}}
    spec["params"].update(kw.pop("params", {}))
    spec.update(kw)
    return spec


def params_dict(p) -> dict:
    d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p) if f.name != "device"}
    d["rule"] = p.rule.notation
    return {k: str(v) if isinstance(v, Path) else v for k, v in d.items()}


SPECS = {
    "soup": base_spec(),
    "spectate": base_spec(spectate=True),
    "spectate-viewport": base_spec(spectate=True, viewport=[3, 4, 8, 8], frame_stride=3),
    "rule": base_spec(params={"rule": "B36/S23", "restart_limit": 2,
                              "checkpoint_every_turns": 8, "time_compression": True}),
    "deadline": base_spec(deadline_seconds=12.5),
    "density-param": {"params": {"turns": 5, "soup_density": 0.4, "soup_seed": 3}},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_params_from_spec_matches_jax(tmp_path, name):
    spec = SPECS[name]
    tp, topt = wire.params_from_spec("alice", json.loads(json.dumps(spec)), root=tmp_path / "t",
                                     device="cpu")
    jp, jopt = jwire.params_from_spec("alice", json.loads(json.dumps(spec)), root=tmp_path / "j")
    assert tp.device == "cpu"
    assert topt == jopt
    want = params_dict(jp)
    want["out_dir"] = str(tmp_path / "t" / "alice")
    assert params_dict(tp) == want


def test_wire_sessions_run_on_the_card_unless_the_pod_says_cpu(tmp_path):
    p, _ = wire.params_from_spec("bob", base_spec(), root=tmp_path)
    assert p.device == "cuda"


def test_board_upload_roundtrip_matches_jax(tmp_path):
    board = frame(24, 16, seed=3)
    spec = {"params": {"turns": 10},
            "board_b64": base64.b64encode(tpgm.encode_pgm(board)).decode()}
    tp, _ = wire.params_from_spec("bob", spec, root=tmp_path / "t", device="cpu")
    jp, _ = jwire.params_from_spec("bob", spec, root=tmp_path / "j")
    assert (tp.image_width, tp.image_height) == (jp.image_width, jp.image_height) == (16, 24)
    stored = Path(tp.images_dir) / "16x24.pgm"
    assert stored.read_bytes() == (Path(jp.images_dir) / "16x24.pgm").read_bytes()
    np.testing.assert_array_equal(tpgm.read_pgm(stored), board)


@pytest.mark.parametrize("mutate", [
    {"params": {"width": "x"}},
    {"params": {"mesh_shape": [2, 1]}},
    {"params": {"device": "cpu"}},
    {"nonsense": True},
    {"soup": {"density": "thick"}},
    {"viewport": [0, 0, 8, 8]},
    {"spectate": True, "frame_stride": "fast"},
    {"spectate": True, "viewport": [0, 0, 0, 8]},
    {"params": {"time_compression": "false"}},
    {"board_b64": "aGk="},
    {"params": {"width": 16, "height": 16, "turns": -1}},
], ids=lambda m: json.dumps(m, sort_keys=True))
def test_bad_specs_refused_as_jax_refuses(tmp_path, mutate):
    spec = base_spec()
    for key, val in mutate.items():
        if key == "params":
            spec["params"].update(val)
        else:
            spec[key] = val
    with pytest.raises(wire.SpecError) as got:
        wire.params_from_spec("eve", spec, root=tmp_path, device="cpu")
    with pytest.raises(jwire.SpecError) as want:
        jwire.params_from_spec("eve", spec, root=tmp_path)
    assert str(got.value) == str(want.value)


def test_missing_board_refused():
    with pytest.raises(wire.SpecError, match="needs a board"):
        wire.params_from_spec("eve", {"params": {"turns": 5}})


# -- RFC 6455 frames -------------------------------------------------------------------


def test_accept_key_rfc_vector():
    assert ws_lib.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("n", [0, 1, 125, 126, 65535, 65536, 70000])
@pytest.mark.parametrize("opcode", [ws_lib.OP_TEXT, ws_lib.OP_BINARY])
def test_server_frames_match_jax(opcode, n):
    payload = bytes(range(256)) * (n // 256 + 1)
    payload = payload[:n]
    assert ws_lib.encode_server_frame(opcode, payload) == jws.encode_server_frame(opcode,
                                                                                  payload)


def test_mask_is_involutive_and_matches_jax():
    data, key = bytes(range(251)), b"\x12\x34\x56\x78"
    masked = ws_lib._mask(data, key)
    assert masked == jws._mask(data, key) != data
    assert ws_lib._mask(masked, key) == data
    assert ws_lib._mask(b"", key) == b""


def test_frame_roundtrip_over_a_socket_pair():
    a, b = socket.socketpair()
    try:
        end_a = ws_lib.WebSocket(a.makefile("rb"), a.makefile("wb"), mask=True, sock=a)
        end_b = ws_lib.WebSocket(b.makefile("rb"), b.makefile("wb"), mask=False, sock=b)
        end_a.send_text("hello")
        assert end_b.recv() == (ws_lib.OP_TEXT, b"hello")
        blob = bytes(range(256)) * 300  # > 64 KiB: the 8-byte length form
        end_b.send_binary(blob)
        assert end_a.recv() == (ws_lib.OP_BINARY, blob)
        end_a.ping(b"x")  # answered under the next recv
        end_a.send_text("after")
        assert end_b.recv() == (ws_lib.OP_TEXT, b"after")
        end_a.close()
        with pytest.raises(ws_lib.WsClosed):
            end_b.recv()
    finally:
        a.close()
        b.close()


def test_port_and_jax_endpoints_talk():
    """A port endpoint and a JAX endpoint on one socket pair exchange the
    same messages in both directions: the framing is one protocol."""
    a, b = socket.socketpair()
    try:
        ours = ws_lib.WebSocket(a.makefile("rb"), a.makefile("wb"), mask=True, sock=a)
        theirs = jws.WebSocket(b.makefile("rb"), b.makefile("wb"), mask=False, sock=b)
        blob = wire.encode_frame_event(tev.FrameReady(2, frame(30, 20, 4), rect=(1, 2, 30, 20)))
        ours.send_binary(blob)
        op, got = theirs.recv()
        assert op == jws.OP_BINARY and got == blob
        assert jwire.decode_frame_event(got).completed_turns == 2
        theirs.send_text(json.dumps({"type": "end"}))
        assert ours.recv() == (ws_lib.OP_TEXT, b'{"type": "end"}')
    finally:
        a.close()
        b.close()
