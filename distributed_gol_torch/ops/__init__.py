"""Device compute: the roll stencil (``stencil``), the packed SWAR engine
(``packed``) and its hand-written CUDA kernel tier (``cuda_packed``, built
by ``cuda_build`` from ``csrc/``).  The stencil's functions are re-exported
here, as the JAX package's ``ops`` does."""

from distributed_gol_torch.ops.stencil import (
    alive_count,
    make_step_fn,
    neighbour_counts,
    step,
    steps_with_counts,
    superstep,
)

__all__ = [
    "alive_count",
    "make_step_fn",
    "neighbour_counts",
    "step",
    "steps_with_counts",
    "superstep",
]
