"""Multi-tenant serving plane: admission control, per-session fault
isolation, graceful pod drain, health surface, and the batched dispatch
cohorts that amortise one launch across N resident tenants.  See
``serve/plane.py`` for the architecture.  The wire tier of the JAX
package (gateway, relay, broker, telemetry endpoints, the spectator frame
fan-out) is not ported yet (ROADMAP A9)."""

from distributed_gol_torch.serve.admission import (
    AdmissionController,
    AdmissionRejected,
    ServeConfig,
)
from distributed_gol_torch.serve.batcher import CohortBatcher, cohort_key
from distributed_gol_torch.serve.plane import ServePlane, SessionHandle

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "CohortBatcher",
    "ServeConfig",
    "ServePlane",
    "SessionHandle",
    "cohort_key",
]
