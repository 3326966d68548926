"""Seeded random-soup boards, generated in bounded memory.

One generator shared by the engine (``Params.soup_density``) and the
benchmark runner, so every consumer of a (density, seed) pair gets the
bit-identical board.  Generation is chunked in row blocks of float32
randoms: a naive ``np.where(rng.random((H, W)) < d, 255, 0)`` materialises
~17× the board size in float64/int64 temporaries — ~68 GB of host RAM for
the 65536² flagship board this feature exists to make practical.
"""

from __future__ import annotations

import numpy as np

_CHUNK_ROWS = 4096


def random_soup(
    height: int, width: int, density: float, seed: int = 0
) -> np.ndarray:
    """uint8 {0, 255} board with P(alive) = density, deterministic in
    (height, width, density, seed) — including across processes, which
    multi-host input loading relies on."""
    rng = np.random.default_rng(seed)
    out = np.empty((height, width), np.uint8)
    for y0 in range(0, height, _CHUNK_ROWS):
        y1 = min(height, y0 + _CHUNK_ROWS)
        block = rng.random((y1 - y0, width), dtype=np.float32) < density
        out[y0:y1] = block.astype(np.uint8) * np.uint8(255)
    return out
