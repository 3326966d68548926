"""Seeded boards that send the frontier kernels down each of their routes.

:func:`sparse_board` is a dead board with gliders, a short-lived spark and
ash placed where the compute tiers of K5, K8, K12 and K14 part ways (the
cases of the JAX package's column-window and frontier-window tests): the
tests, ``chip_smoke.py`` and ``tools/regwin_ab.py`` all use it.  Given the
tiles of a 2-D mesh, it adds gliders across the tiles' seams and a corner,
where K15's routes part ways.
"""

from __future__ import annotations

import numpy as np

GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=bool)  # heads down-right
GLIDER_LEFT = GLIDER[:, ::-1]  # heads down-left
BLOCK = np.ones((2, 2), dtype=bool)
#: The spark's seed: a 6 x 6 random patch (density 0.5) of this seed dies
#: out within 45 generations under B3/S23, staying within 13 cells.
SPARK_SEED = 50
#: The slots of :func:`sparse_board`, one a stripe, top to bottom.
SLOTS = ("board_top", "mid", "stripe_top", "stripe_bottom", "quantum", "seam_left",
         "seam_right", "two_columns", "spark", "two_rows")


def _put(b: np.ndarray, cells: np.ndarray, y: int, x: int) -> None:
    """OR a pattern into the torus at (y, x)."""
    h, w = b.shape
    ys, xs = np.nonzero(cells)
    b[(ys + y) % h, (xs + x) % w] = 255


def spark() -> np.ndarray:
    """The short-lived patch: it computes for a few launches, then its
    stripe is stable and skips."""
    return np.random.default_rng(SPARK_SEED).random((6, 6)) < 0.5


def sparse_board(h: int, w: int, stripe_h: int, slots=SLOTS,
                 tiles: tuple[int, int] | None = None) -> np.ndarray:
    """A dead h x w board (uint8 cells, 0 or 255) of stripes of
    ``stripe_h`` rows (at least 200), w at least 8192 cells (256 words),
    with ``slots`` (``SLOTS``) spread evenly down it, slot k in stripe
    k · s + s // 2 for s = stripes // len(slots) (at least 2 when there
    are several, so no slot's stripe neighbours another's), its activity
    mid-stripe unless named: a glider on the board's first rows (a
    rectangle there would cross the board's edge); one mid-stripe; one at
    a stripe's top and one at its bottom heading down across the stripe
    seam; one straddling the 4096-cell (128-word) quantum; one within 2
    cells of the torus' x seam and one heading left across it; two
    clusters about 0.6 of the width apart in one stripe (300 words on a
    512-word board); the spark; two gliders 180 rows apart in one
    stripe.  Every stripe holds a block of ash, which never changes.

    ``tiles`` = (ny, nx), the board cut into ny x nx tiles of whole
    stripes (nx >= 2), adds three gliders and leaves the slots as they
    are: one heading right across the seam of tiles (0, 0) and (0, 1) in
    the first interior stripe of a tile (neither a tile's first nor its
    last) that holds no slot, and in the last stripe of tile row 0 (an edge
    stripe, which must hold no slot) one heading down across the seam of
    tile rows 0 and 1 (on one tile row, the torus' y seam) and one heading
    across the corner of tiles (0, 0), (0, 1), (1, 0) and (1, 1)."""
    stripes = h // stripe_h
    spacing = stripes // len(slots)
    if (h % stripe_h or spacing < (2 if len(slots) > 1 else 1) or w < 8192 or stripe_h < 200
            or not set(slots) <= set(SLOTS)):
        raise ValueError(f"no sparse board of {slots} on {h} x {w} cells in stripes of "
                         f"{stripe_h} rows")
    taken = {k * spacing + spacing // 2 for k in range(len(slots))}
    if tiles is not None:
        ny, nx = tiles
        per = stripes // ny
        free = [s for s in range(stripes) if 0 < s % per < per - 1 and s not in taken]
        if nx < 2 or w % nx or stripes % ny or not free or per - 1 in taken:
            raise ValueError(f"no tile gliders on {h} x {w} cells in {tiles} tiles of "
                             f"{stripe_h}-row stripes beside the slots' stripes {sorted(taken)}")
    b = np.zeros((h, w), dtype=np.uint8)
    for s in range(stripes):
        _put(b, BLOCK, s * stripe_h + stripe_h // 3, 7 * w // 8 + 40 * (s % 5))
    mid = stripe_h // 2 - 10
    for k, slot in enumerate(slots):
        y = (k * spacing + spacing // 2) * stripe_h
        if slot == "board_top":
            _put(b, GLIDER, 2, w // 5)
        elif slot == "mid":
            _put(b, GLIDER, y + mid, w // 3)
        elif slot == "stripe_top":
            _put(b, GLIDER, y + 2, w // 2 + 600)
        elif slot == "stripe_bottom":
            _put(b, GLIDER, y + stripe_h - 10, 2 * w // 3)
        elif slot == "quantum":
            _put(b, GLIDER, y + mid, 4096 - 6)
        elif slot == "seam_left":
            _put(b, GLIDER, y + mid, 2)
        elif slot == "seam_right":
            _put(b, GLIDER_LEFT, y + mid, 3)
        elif slot == "two_columns":
            gap = (w // 32) * 300 // 512 * 32
            _put(b, GLIDER, y + mid, w // 8)
            _put(b, GLIDER, y + mid + 6, w // 8 + gap)
        elif slot == "spark":
            _put(b, spark(), y + mid, w // 4)
        elif slot == "two_rows":
            _put(b, GLIDER, y + 20, 3 * w // 5)
            _put(b, GLIDER, y + 200, 3 * w // 5)
    if tiles is not None:
        th, tw = h // tiles[0], w // tiles[1]
        _put(b, GLIDER, free[0] * stripe_h + mid, tw - 6)
        _put(b, GLIDER, th - 10, tw // 3)
        _put(b, GLIDER, th - 8, tw - 8)
    return b
