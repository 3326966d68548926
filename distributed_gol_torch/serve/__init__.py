"""Multi-tenant serving plane: admission control, per-session fault
isolation, graceful pod drain, health surface, the batched dispatch
cohorts that amortise one launch across N resident tenants, the
spectator frame fan-out hub that serves N viewers' viewports off one
device fetch per turn, the telemetry endpoints, and the network gateway
that puts the whole contract on the wire (HTTP control plane + WebSocket
controller/spectator streaming).  See ``serve/plane.py`` for the
architecture.  Above the pods: the federation broker (``serve/broker.py``,
over ``serve/podclient.py``) and the spectator relay tier
(``serve/relay.py``), neither of which touches a device."""

from distributed_gol_torch.serve.admission import (
    AdmissionController,
    AdmissionRejected,
    ServeConfig,
)
from distributed_gol_torch.serve.batcher import CohortBatcher, cohort_key
from distributed_gol_torch.serve.broker import Broker, BrokerConfig
from distributed_gol_torch.serve.frames import FramePlane, FrameSubscriber
from distributed_gol_torch.serve.gateway import GatewayServer, serve_plane_gateway
from distributed_gol_torch.serve.plane import ServePlane, SessionHandle
from distributed_gol_torch.serve.podclient import PodClient, PodHTTPError, PodUnreachable
from distributed_gol_torch.serve.relay import RelayServer
from distributed_gol_torch.serve.telemetry import TelemetryServer, serve_plane_telemetry

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "Broker",
    "BrokerConfig",
    "CohortBatcher",
    "FramePlane",
    "FrameSubscriber",
    "GatewayServer",
    "PodClient",
    "PodHTTPError",
    "PodUnreachable",
    "RelayServer",
    "ServeConfig",
    "ServePlane",
    "SessionHandle",
    "TelemetryServer",
    "cohort_key",
    "serve_plane_gateway",
    "serve_plane_telemetry",
]
