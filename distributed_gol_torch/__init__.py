"""distributed_gol_torch — the PyTorch/CUDA port of ``distributed_gol_tpu``.

The same Game of Life engine, event stream, files and checkpoints as the
JAX package, with the board on an NVIDIA GPU as a ``torch`` tensor and the
packed engine's kernels written by hand in CUDA for Hopper
(``ops/cuda_packed.py``, ``csrc/``).  Every engine is bit-identical to the
JAX package's.  This package imports neither ``jax`` nor
``distributed_gol_tpu``.

Public API (the JAX package's, for the single-device paths, headless and
viewer): :class:`Params` (with ``device``, default "cuda"), :func:`run`,
:func:`start`, :func:`supervise`, the event types, :class:`Cell` and
:class:`GracefulStop`.
"""

from distributed_gol_torch.utils.cell import Cell
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.engine.events import (
    AliveCellsCount,
    CellFlipped,
    CellsFlipped,
    CheckpointSaved,
    CycleDetected,
    DispatchError,
    Event,
    EventQueue,
    FinalTurnComplete,
    FrameDelta,
    FrameReady,
    ImageOutputComplete,
    MetricsReport,
    State,
    StateChange,
    TurnComplete,
    TurnsCompleted,
    TurnTiming,
)
from distributed_gol_torch.engine.controller import (
    CorruptionDetected,
    DispatchTimeout,
)
from distributed_gol_torch.engine.gol import run, start
from distributed_gol_torch.engine.supervisor import GracefulStop, supervise

__all__ = [
    "AliveCellsCount",
    "Cell",
    "CellFlipped",
    "CellsFlipped",
    "CheckpointSaved",
    "CorruptionDetected",
    "CycleDetected",
    "DispatchError",
    "DispatchTimeout",
    "Event",
    "EventQueue",
    "FinalTurnComplete",
    "FrameDelta",
    "FrameReady",
    "GracefulStop",
    "ImageOutputComplete",
    "MetricsReport",
    "Params",
    "State",
    "StateChange",
    "TurnComplete",
    "TurnsCompleted",
    "TurnTiming",
    "run",
    "start",
    "supervise",
]

__version__ = "0.1.0"
