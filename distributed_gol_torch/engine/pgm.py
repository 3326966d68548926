"""PGM (P5) codec — byte-compatible with the reference's reader/writer.

The PGM file is the framework's at-rest board format: input soups
(``images/WxH.pgm``), final outputs and manual snapshots (``out/*.pgm``),
and the de-facto checkpoint format (SURVEY.md §5).  Byte-level contract
from ``gol/io.go:42-87``:

    P5\\n
    {width} {height}\\n
    255\\n
    <height * width raw bytes, row-major>

The reference reader (``gol/io.go:90-128``) is lenient — it splits on
whitespace and validates magic/width/height/maxval — and streams bytes one
at a time over a channel; here a board is one ``np.fromfile`` into a uint8
array (the whole point of the rebuild: no per-byte hops).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

MAXVAL = 255


class PgmError(ValueError):
    pass


#: Bytes of a file that ``read_pgm`` parses the header from; a header
#: longer than this (comments) is read with the whole file.
_HEADER_BYTES = 1 << 16


def read_pgm(path: str | os.PathLike) -> np.ndarray:
    """Read a P5 PGM into a uint8 array of shape (height, width): the header
    from the file's first bytes, then the raster straight into the array
    (a 65536² board is 4 GiB: no second copy of it)."""
    with open(path, "rb") as f:
        head = f.read(_HEADER_BYTES)
        try:
            width, height, pos = _header(head)
        except ValueError:
            pos = None
        if pos is None or pos > len(head):
            # A header this prefix does not hold, or a bad one: decode the
            # whole file, which raises what it must.
            return decode_pgm(head + f.read())
        f.seek(pos)
        board = np.fromfile(f, dtype=np.uint8, count=width * height)
    if board.size != width * height:
        raise PgmError("truncated PGM raster")
    return board.reshape(height, width)


def _header(data: bytes) -> tuple[int, int, int]:
    """(width, height, offset of the raster) of P5 bytes.  Accepts
    arbitrary whitespace between header tokens and ``#`` comments (the
    standard allows them; the reference's ``strings.Fields`` split accepts
    the former)."""
    tokens: list[bytes] = []
    pos = 0
    # Scan header tokens; after the maxval token exactly one whitespace byte
    # separates header from raster (per the PGM spec).
    while len(tokens) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if pos < len(data) and data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        if start == pos:
            raise PgmError("truncated PGM header")
        tokens.append(data[start:pos])
    if tokens[0] != b"P5":
        raise PgmError("not a P5 pgm file")  # gol/io.go:103
    width, height, maxval = (int(t) for t in tokens[1:4])
    if maxval != MAXVAL:
        raise PgmError(f"unsupported maxval {maxval}")  # gol/io.go:118
    return width, height, pos + 1  # the single whitespace byte after maxval


def decode_pgm(data: bytes) -> np.ndarray:
    """Decode P5 bytes (the header as :func:`_header` reads it)."""
    width, height, pos = _header(data)
    raster = memoryview(data)[pos : pos + width * height]
    if len(raster) != width * height:
        raise PgmError("truncated PGM raster")
    return np.frombuffer(raster, dtype=np.uint8).reshape(height, width).copy()


def _encode_parts(board: np.ndarray) -> tuple[bytes, memoryview]:
    """(header, raster) of a uint8 board's P5 file, the raster a view of
    the board's own bytes."""
    board = np.ascontiguousarray(board, dtype=np.uint8)
    if board.ndim != 2:
        raise PgmError(f"board must be 2-D, got shape {board.shape}")
    h, w = board.shape
    return f"P5\n{w} {h}\n{MAXVAL}\n".encode("ascii"), memoryview(board).cast("B")


def encode_pgm(board: np.ndarray) -> bytes:
    """Encode a uint8 board as P5 bytes, header byte-identical to the
    reference writer (``gol/io.go:53-60``: ``P5\\n``, ``{w} {h}\\n``,
    ``255\\n``)."""
    header, raster = _encode_parts(board)
    return header + raster.tobytes()


def write_pgm(
    path: str | os.PathLike, board: np.ndarray, durable: bool = False
) -> None:
    """Write a board to ``path``, creating parent directories (the reference
    mkdirs ``out/``, ``gol/io.go:44``).  Write is atomic (tmp + rename) so a
    crash mid-snapshot never leaves a torn checkpoint.

    ``durable=True`` additionally fsyncs the file before the rename and
    the directory after it — without the directory fsync a machine-kill
    right after ``os.replace`` can lose the RENAME itself (the data made
    it, the directory entry didn't), which would defeat the emergency-
    checkpoint guarantee the Session paths rely on.
    Plain snapshots keep the cheap non-durable form."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    parts = _encode_parts(board)  # the board's bytes written from the board itself
    if durable:
        write_bytes_durable(path, *parts)
        return
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
    os.replace(tmp, path)


def write_bytes_durable(path: str | os.PathLike, *parts) -> None:
    """Machine-kill-durable atomic write: tmp + fsync(file) before the
    rename, fsync(directory) after it.  ONE home for that ordering — the
    checkpoint commit protocol (world, then sidecar as the commit record)
    relies on it from two writers (``write_pgm(durable=True)`` and the
    Session's JSON sidecars), and a fix to the sequence must reach both."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)


def fsync_dir(directory: str | os.PathLike) -> None:
    """fsync a directory so a completed ``os.replace`` into it survives a
    machine kill.  Best-effort: platforms that cannot open or fsync a
    directory (e.g. Windows) degrade silently — the write is still atomic,
    just not machine-kill-durable there."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
