"""Serving runtime: the runner, the engine and ``build_engine``, with the
degrade ladder, the circuit breaker, health and the watchdog, continuous
batching and tenancy; ``FleetRouter`` and ``build_fleet`` run N replica
engines as independent failure domains (least-loaded routing, hedged
retries, quarantine and rebuild, the rolling weight swap, draining
shutdown, the result cache).  Of ``mx_rcnn_tpu/serve`` only the
cross-host fabric (``rpc``, ``gossip``, ``gateway``) is not ported yet."""

from mx_rcnn_tpu_torch.serve.batcher import PackBuffer
from mx_rcnn_tpu_torch.serve.degrade import (
    LEVELS,
    CircuitBreaker,
    HysteresisPlanner,
    LatencyEstimator,
    plan_level,
)
from mx_rcnn_tpu_torch.serve.engine import (
    DeadlineExceeded,
    DetectorRunner,
    EngineUnavailable,
    InferenceEngine,
    InferenceRequest,
    Overloaded,
    Plan,
    QuotaExceeded,
    ServeError,
    build_engine,
)
from mx_rcnn_tpu_torch.serve.fleet import FleetRequest, FleetRouter, build_fleet
from mx_rcnn_tpu_torch.serve.health import EngineHealth
from mx_rcnn_tpu_torch.serve.result_cache import ResultCache, content_key
from mx_rcnn_tpu_torch.serve.router import (
    DEAD,
    DEGRADED,
    QUARANTINED,
    READY,
    RETIRING,
    ReplicaView,
    mean_load,
    routable_views,
    select_replica,
)
from mx_rcnn_tpu_torch.serve.tenancy import (
    QuotaGovernor,
    TenancyPolicy,
    TenantSpec,
)

__all__ = [
    "PackBuffer",
    "LEVELS",
    "CircuitBreaker",
    "HysteresisPlanner",
    "LatencyEstimator",
    "plan_level",
    "DeadlineExceeded",
    "DetectorRunner",
    "EngineUnavailable",
    "InferenceEngine",
    "InferenceRequest",
    "Overloaded",
    "Plan",
    "QuotaExceeded",
    "ServeError",
    "build_engine",
    "FleetRequest",
    "FleetRouter",
    "build_fleet",
    "QuotaGovernor",
    "TenancyPolicy",
    "TenantSpec",
    "EngineHealth",
    "ResultCache",
    "content_key",
    "DEAD",
    "DEGRADED",
    "QUARANTINED",
    "READY",
    "RETIRING",
    "ReplicaView",
    "mean_load",
    "routable_views",
    "select_replica",
]
