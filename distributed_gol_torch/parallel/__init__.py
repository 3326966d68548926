"""Sharded execution over a device mesh, in one process.

Counterpart of ``distributed_gol_tpu/parallel``: the board is split 2-D
over a ``(ny, nx)`` mesh of devices (``mesh.py``), each shard exchanges
halos with its torus neighbours by tensor copies (``halo.py``; the packed
word-halo engine ``packed_halo.py``; T-deep halos and the K9 kernel
``cuda_halo.py``), and alive counts are sums over the shards.  A mesh may
repeat one device (a virtual mesh); process-spanning meshes
(``parallel/multihost.py``) are ROADMAP A8.  ``mesh.py`` also keeps the
process-wide device blacklist.
"""

from distributed_gol_torch.parallel.mesh import make_mesh, mesh_shape_for
from distributed_gol_torch.parallel.halo import (
    sharded_step,
    sharded_steps_with_counts,
    sharded_superstep,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "sharded_step",
    "sharded_steps_with_counts",
    "sharded_superstep",
]
