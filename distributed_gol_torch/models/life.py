"""Life-like cellular-automaton rules as data.

The reference implements exactly one rule, Conway's B3/S23, as branchy Go
(``server/server.go:33-53``: a cell is born with 3 neighbours, survives with
2 or 3, dies otherwise, on a toroidal board of {0, 255} bytes).  Here, as
in ``distributed_gol_tpu/models/life.py``, the rule is *data*: an
outer-totalistic rule is fully described by an 18-entry uint8 table indexed
by ``9 * alive + neighbour_count`` (the roll stencil's gather), and by its
birth/survive sets (the packed engine's bit-plane terms and the CUDA
kernels' runtime rule masks).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

ALIVE = 255  # cell byte values, as in the reference PGM boards
DEAD = 0


@dataclass(frozen=True)
class LifeRule:
    """An outer-totalistic rule B{birth}/S{survive} on the Moore neighbourhood.

    ``birth``: neighbour counts that turn a dead cell alive.
    ``survive``: neighbour counts that keep a live cell alive.
    """

    name: str
    birth: frozenset[int]
    survive: frozenset[int]

    def __post_init__(self):
        for n in self.birth | self.survive:
            if not 0 <= n <= 8:
                raise ValueError(f"neighbour count {n} out of range [0, 8]")

    @cached_property
    def table(self) -> np.ndarray:
        """18-entry lookup: ``table[9 * alive + n]`` → next cell byte (0/255).

        Rows: [dead-cell outcomes for n=0..8, live-cell outcomes for n=0..8].
        """
        t = np.zeros(18, dtype=np.uint8)
        for n in self.birth:
            t[n] = ALIVE
        for n in self.survive:
            t[9 + n] = ALIVE
        return t

    @property
    def notation(self) -> str:
        b = "".join(str(n) for n in sorted(self.birth))
        s = "".join(str(n) for n in sorted(self.survive))
        return f"B{b}/S{s}"

    @property
    def ash_period(self) -> int | None:
        """The rule's *ash period*: a period every common settled-debris
        oscillation divides, or ``None`` when no such period is known
        for this rule.

        This is the one number the engine's whole temporal story hangs
        off — the frontier kernels' stability-proof window
        (the JAX package's adaptive kernels prove a tile's window
        reproduces itself after this many generations before eliding it), the whole-board
        cycle probe (``Backend.cycle_probe_async``), and the JAX
        package's time-compression tier all use it.  Every
        consumer VERIFIES periodicity on device before acting (the
        period is a probe depth, never an assumption), so a wrong entry
        here cannot corrupt results — but an unknown period means the
        probes have no principled depth to use, and features that lean
        on ash periodicity (``Params.time_compression``) refuse to
        engage rather than probe blind.
        """
        return _ASH_PERIODS.get((self.birth, self.survive))

    def __str__(self) -> str:
        return f"{self.name} ({self.notation})"


def _rule(name: str, birth: tuple[int, ...], survive: tuple[int, ...]) -> LifeRule:
    return LifeRule(name, frozenset(birth), frozenset(survive))


#: Known ash periods, keyed by (birth, survive) so notation aliases of
#: the same rule resolve identically.  B3/S23 and B36/S23: settled
#: debris is still lifes (period 1), blinkers/beacons/toads (period 2)
#: and pulsars (period 3) — lcm(1, 2, 3) = 6, the constant the frontier
#: kernels have proved stability against (now derived from
#: here; see ``LifeRule.ash_period``).  Rules absent from this table
#: have ash_period None: their settled-debris census is not established,
#: so period-reliant features refuse rather than guess.
_ASH_PERIODS: dict[tuple[frozenset[int], frozenset[int]], int] = {
    (frozenset({3}), frozenset({2, 3})): 6,  # conway  B3/S23
    (frozenset({3, 6}), frozenset({2, 3})): 6,  # highlife B36/S23
}


# The reference's rule (server/server.go:33-53) and a zoo of well-known
# life-like rules the generalised kernel supports for free.
CONWAY = _rule("conway", (3,), (2, 3))
HIGHLIFE = _rule("highlife", (3, 6), (2, 3))
SEEDS = _rule("seeds", (2,), ())
DAY_AND_NIGHT = _rule("day-and-night", (3, 6, 7, 8), (3, 4, 6, 7, 8))
LIFE_WITHOUT_DEATH = _rule("life-without-death", (3,), (0, 1, 2, 3, 4, 5, 6, 7, 8))

RULES: dict[str, LifeRule] = {
    r.name: r for r in (CONWAY, HIGHLIFE, SEEDS, DAY_AND_NIGHT, LIFE_WITHOUT_DEATH)
}


def parse_rule(spec: str) -> LifeRule:
    """Parse ``"conway"`` (a zoo name) or ``"B36/S23"`` notation."""
    key = spec.strip().lower()
    if key in RULES:
        return RULES[key]
    if key.startswith("b") and "/s" in key:
        b_part, s_part = key[1:].split("/s", 1)
        birth = tuple(int(c) for c in b_part)
        survive = tuple(int(c) for c in s_part)
        return _rule(spec, birth, survive)
    raise ValueError(f"unknown rule {spec!r}; known: {sorted(RULES)} or B…/S… notation")
