"""Frame delta codec — the one home of the viewer frame-stream format.

A copy of ``distributed_gol_tpu/engine/frames.py`` (it has no JAX in it;
the port keeps its own copy so it never imports the JAX package).

A frame stream is a KEYFRAME (``FrameReady``: the whole rendered frame)
followed by DELTAS (``FrameDelta``: the changed 8-row bands against the
previously delivered frame).  Encoding happens host-side by diffing the
fetched bytes, so it is exact by construction.  The controller's viewport
viewer and the viewers' in-place appliers both speak exactly this format.

Cost shape: ``delta_bands`` is O(viewport) host work per frame (one
elementwise compare) and O(activity ∩ viewport) payload bytes;
``apply_bands`` touches ONLY the changed rows.
"""

from __future__ import annotations

import numpy as np

#: Rows per delta band.  8 matches the packed engines' alignment quantum
#: and keeps band bookkeeping negligible against the row payload.
BAND_ROWS = 8


def delta_bands(
    prev: np.ndarray, new: np.ndarray, band_rows: int = BAND_ROWS
) -> tuple:
    """The changed ``band_rows``-row bands of ``new`` against ``prev``
    (same shape), as a tuple of ``(y0, rows)`` pairs — ``rows`` copies,
    so the caller may keep mutating ``new``.  Empty tuple = identical
    frames (a legal, cheap delta)."""
    if prev.shape != new.shape:
        raise ValueError(
            f"delta frames must match: {prev.shape} vs {new.shape}"
        )
    h = new.shape[0]
    hot_rows = (prev != new).any(axis=1)
    bands = []
    for y in range(0, h, band_rows):
        end = min(y + band_rows, h)
        if hot_rows[y:end].any():
            bands.append((y, new[y:end].copy()))
    return tuple(bands)


def apply_bands(buf: np.ndarray, bands) -> np.ndarray:
    """Apply delta ``bands`` to ``buf`` IN PLACE (and return it).  Rows
    outside every band are not touched — the viewer-side half of the
    in-place contract."""
    for y0, rows in bands:
        buf[y0 : y0 + rows.shape[0], : rows.shape[1]] = rows
    return buf


def bands_nbytes(bands) -> int:
    """Payload bytes of a delta (the rows only — the per-band scalar is
    noise), for the bytes/frame telemetry."""
    return int(sum(rows.nbytes for _, rows in bands))


def pack_bands(bands) -> tuple[list, bytes]:
    """Serialize delta ``bands`` for a byte stream: a JSON-able
    ``[[y0, rows, cols], ...]`` geometry list plus the concatenated raw
    row payload."""
    meta, parts = [], []
    for y0, rows in bands:
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        meta.append([int(y0), int(rows.shape[0]), int(rows.shape[1])])
        parts.append(rows.tobytes())
    return meta, b"".join(parts)


def unpack_bands(meta, payload: bytes) -> tuple:
    """Inverse of :func:`pack_bands`: ``(y0, rows)`` pairs ready for
    :func:`apply_bands`.  Raises ``ValueError`` on a geometry/payload
    size mismatch (a truncated frame must not apply silently)."""
    bands, off = [], 0
    for y0, nrows, ncols in meta:
        n = int(nrows) * int(ncols)
        chunk = payload[off : off + n]
        if len(chunk) != n:
            raise ValueError(
                f"band payload truncated: wanted {n} bytes at offset "
                f"{off}, got {len(chunk)}"
            )
        rows = np.frombuffer(chunk, np.uint8).reshape(int(nrows), int(ncols))
        bands.append((int(y0), rows))
        off += n
    if off != len(payload):
        raise ValueError(
            f"band payload has {len(payload) - off} trailing bytes"
        )
    return tuple(bands)
