"""Serving runtime: the runner, the engine and ``build_engine``, with the
degrade ladder, the circuit breaker, health and the watchdog, continuous
batching and tenancy (the single-engine surface of
``mx_rcnn_tpu/serve``; the fleet and the cross-host fabric are not ported
yet)."""

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
from mx_rcnn_tpu_torch.serve.health import EngineHealth
from mx_rcnn_tpu_torch.serve.tenancy import (
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
    "TenancyPolicy",
    "TenantSpec",
    "EngineHealth",
]
