"""Cellular-automaton model families: life-like B/S rules as data (the
18-entry table the roll stencil gathers from, and the birth/survive sets
the packed engine and the kernels evaluate on bit planes)."""

from distributed_gol_torch.models.life import (
    CONWAY,
    DAY_AND_NIGHT,
    HIGHLIFE,
    LIFE_WITHOUT_DEATH,
    RULES,
    SEEDS,
    LifeRule,
    parse_rule,
)

__all__ = [
    "CONWAY",
    "DAY_AND_NIGHT",
    "HIGHLIFE",
    "LIFE_WITHOUT_DEATH",
    "RULES",
    "SEEDS",
    "LifeRule",
    "parse_rule",
]
