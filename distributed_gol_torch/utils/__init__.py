"""Shared utilities: cells, seeded soups and device selection."""

from distributed_gol_torch.utils.cell import AliveCells, Cell

__all__ = ["AliveCells", "Cell"]
