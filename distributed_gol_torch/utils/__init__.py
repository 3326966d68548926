"""Shared utilities: cells, seeded soups, device selection and the text
rendering of a board (``visualise``)."""

from distributed_gol_torch.utils.cell import AliveCells, Cell
from distributed_gol_torch.utils.visualise import alive_cells_to_string

__all__ = ["AliveCells", "Cell", "alive_cells_to_string"]
