"""Closed-loop control plane: SLOs, burn-rate alerts, autoscaling,
continuous deployment.

The port's own copy of ``mx_rcnn_tpu/ctrl/``.  The observability plane
(``mx_rcnn_tpu_torch.obs``) *watches* the serving stack; this package
*acts* on what it sees:

* ``ctrl/slo.py`` — declarative :class:`SLO` objects evaluated over
  metrics ``Registry`` snapshots, with SRE-style multi-window burn-rate
  alerting journaled as typed events and the remaining error budget
  exported on ``/metrics``.
* ``ctrl/autoscale.py`` — an :class:`Autoscaler` policy loop that turns
  queue-depth / shed-rate / windowed-p99 pressure into
  ``FleetRouter.add_replica()`` / ``retire_replica()`` calls, with
  scale-down hysteresis mirroring ``serve/degrade.HysteresisPlanner``.
* ``ctrl/deploy.py`` — a :class:`Deployer` that watches the checkpoint
  directory, stages candidates as shadow canaries behind a
  parity + shadow-SLO gate, promotes through the one-at-a-time weight
  roll, and rolls back automatically on a post-promote burn alert;
  :func:`build_deployer` wires it from ``cfg.ctrl.deploy``.

Everything here is host-side control logic; knobs live under
``cfg.ctrl`` (:class:`mx_rcnn_tpu_torch.config.CtrlConfig`).
"""

from mx_rcnn_tpu_torch.ctrl.autoscale import (
    Autoscaler,
    ScalePolicy,
    ScaleSignals,
    desired_action,
)
from mx_rcnn_tpu_torch.ctrl.deploy import (
    Deployer,
    ShadowVerdict,
    build_deployer,
)
from mx_rcnn_tpu_torch.ctrl.slo import (
    SLO,
    SLOEngine,
    default_slos,
    good_total,
    merged_percentile,
    tenant_slos,
)


def build_controller(cfg, fleet):
    """(SLOEngine, Autoscaler) pair wired from ``cfg.ctrl`` — neither
    loop started; callers pick the period (``cfg.ctrl.period_s``)."""
    ctrl = cfg.ctrl
    engine = SLOEngine(
        default_slos(ctrl),
        fast_s=ctrl.burn_fast_s,
        slow_s=ctrl.burn_slow_s,
        burn_factor=ctrl.burn_factor,
    )
    scaler = Autoscaler(fleet, ScalePolicy.from_config(ctrl))
    return engine, scaler


__all__ = [
    "SLO",
    "SLOEngine",
    "default_slos",
    "good_total",
    "merged_percentile",
    "tenant_slos",
    "Autoscaler",
    "ScalePolicy",
    "ScaleSignals",
    "desired_action",
    "build_controller",
    "Deployer",
    "ShadowVerdict",
    "build_deployer",
]
