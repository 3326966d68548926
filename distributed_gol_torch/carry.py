"""Carry state across from the JAX package, and back.

Boards are uint8 {0, 255} arrays in both packages; packed boards are
uint32 words in the JAX package and int32 tensors holding the same bit
pattern here; rules travel as their notation.  Checkpoints need nothing
from this module: ``engine/session.py`` reads and writes the JAX
package's on-disk format (PGM plus a CRC'd JSON sidecar) byte for byte,
so a run parked by either package resumes in the other.  The adaptive
(``skip_stable``) tier adds nothing to carry: it keeps no weights, and its
state (stripe flags, tracked intervals, skip counts) lives only within
one dispatch, so checkpoints stay byte-compatible.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_gol_torch.models.life import LifeRule, parse_rule


def board_to_device(board: np.ndarray, device) -> torch.Tensor:
    """A uint8 {0, 255} board (e.g. ``np.asarray`` of a JAX board) as a
    new tensor on ``device``."""
    return torch.tensor(np.asarray(board, dtype=np.uint8), device=device)


def packed_from_reference(words: np.ndarray) -> torch.Tensor:
    """JAX packed words (uint32, either packing) → int32 tensor with the
    same bit pattern, a new tensor on the CPU."""
    return torch.tensor(np.asarray(words, dtype=np.uint32).view(np.int32))


def packed_to_reference(words: torch.Tensor) -> np.ndarray:
    """int32 packed words → uint32 numpy array with the same bit pattern."""
    return words.detach().cpu().numpy().view(np.uint32)


def rule_from_reference(notation: str) -> LifeRule:
    """The port's rule for a JAX ``LifeRule.notation`` (or zoo name)."""
    return parse_rule(notation)
