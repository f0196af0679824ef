"""The port's control plane (``ctrl/``), its ``QuotaGovernor`` and its
config fields against the JAX package's.

* ``SLOEngine`` (fleet-wide and tenant-scoped SLOs, availability and
  latency) on one injected clock over one seeded snapshot sequence with
  incidents and recoveries: every ``observe`` state, the alerts, the
  verdicts, the ``slo_burn_start``/``slo_burn_stop`` journal events (the
  ``emit`` calls) and the error-budget gauge are equal; ``replay`` of the
  same records equals the live run; a ``QuotaGovernor`` on each engine's
  alerts tightens and restores the same tenants.
* ``desired_action`` over seeded random signals, and the ``Autoscaler``
  over a scripted fleet (the JAX tests' ``_ScriptedFleet``) with one
  clock, one load script and latency histograms in its own registry:
  every step's record, the resize decisions, the journal events and the
  fleet-size gauge are equal.
* ``CtrlConfig``, ``DeployConfig``, ``ServeConfig.result_cache_capacity``
  and ``TenancyConfig.tighten_factor`` have JAX's names, types and
  defaults, and one ``--set`` list parses to equal values in both.
All exact: host Python on floats.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from mx_rcnn_tpu import config as JCfg
from mx_rcnn_tpu import ctrl as JCtrl
from mx_rcnn_tpu import obs as JO
from mx_rcnn_tpu.obs.metrics import Registry as JRegistry
from mx_rcnn_tpu.serve import tenancy as JT
from mx_rcnn_tpu_torch import config as TCfg
from mx_rcnn_tpu_torch import ctrl as TCtrl
from mx_rcnn_tpu_torch import obs as TO
from mx_rcnn_tpu_torch.obs.metrics import Registry as TRegistry
from mx_rcnn_tpu_torch.serve import tenancy as TT

PORT = (TCtrl, TO, TRegistry, TT, TCfg)
JAX = (JCtrl, JO, JRegistry, JT, JCfg)


@pytest.fixture(autouse=True)
def _fresh_planes():
    JO.reset()
    TO.reset()
    yield
    JO.reset()
    TO.reset()


@pytest.fixture
def emitted(monkeypatch):
    """The (subsystem, kind, payload) of every ``obs.emit`` call, per package."""
    calls = {"port": [], "jax": []}
    for name, mod in (("port", TO), ("jax", JO)):
        real = mod.emit

        def record(subsystem, kind, payload=None, *a, _real=real, _into=calls[name], **kw):
            _into.append((subsystem, kind, dict(payload or {})))
            return _real(subsystem, kind, payload, *a, **kw)

        monkeypatch.setattr(mod, "emit", record)
    return calls


def _snapshot(rng: random.Random, totals: dict, bad_frac: float) -> dict:
    """Advance cumulative counters by one flush of traffic and return a
    snapshot of both families, tenant-labelled."""
    fleet, lat = {}, {}
    le = [0.05, 0.1, 0.5, 1.0, float("inf")]
    for tenant in ("a", "b"):
        n = rng.randrange(20, 60)
        frac = bad_frac if tenant == "a" else 0.0   # only tenant a misbehaves
        bad = int(n * frac)
        for outcome, k in (("completed", n - bad), ("failed", bad // 2),
                           ("shed", bad - bad // 2), ("quota", rng.randrange(3))):
            key = f'{{outcome="{outcome}",tenant="{tenant}"}}'
            totals[key] = totals.get(key, 0.0) + k
        lkey = f'{{level="full",replica="0",tenant="{tenant}"}}'
        counts = totals.setdefault(lkey, [0.0] * len(le))
        slow = frac > 0.05
        for _ in range(n - bad):
            x = rng.random()
            i = 3 if slow and x < 0.5 else (0 if x < 0.6 else 1 if x < 0.85 else 2)
            counts[i] += 1
    for key, v in totals.items():
        if isinstance(v, list):
            lat[key] = {"count": float(sum(v)), "sum": 1.0, "le": le,
                        "buckets": [float(c) for c in v]}
        else:
            fleet[key] = float(v)
    return {"fleet_requests_total": fleet, "serve_request_latency_seconds": lat}


def _series(seed: int) -> list:
    rng = random.Random(seed)
    totals, out, t = {}, [], 0.0
    phases = [(0.0, 10), (0.3, 4), (0.0, 8), (0.15, 3), (0.0, 6)]
    for bad_frac, flushes in phases:
        for _ in range(flushes):
            out.append((t, _snapshot(rng, totals, bad_frac)))
            t += rng.choice((20.0, 30.0, 45.0))
    return out


def _slos(mod, cfg_mod):
    ctrl = cfg_mod.CtrlConfig(latency_threshold_s=0.5, availability_target=0.95,
                              latency_target=0.9)
    return (*mod.default_slos(ctrl), *mod.tenant_slos(ctrl, ("a", "b")),
            mod.SLO("latency_full", target=0.9, kind="latency", threshold_s=0.1, level="full"))


@pytest.mark.parametrize("seed", range(3))
def test_slo_engine_equals_jax_on_one_clock(seed, emitted):
    series = _series(seed)
    runs = {}
    for name, (ctrl, obs, registry, tenancy, cfg_mod) in (("port", PORT), ("jax", JAX)):
        clock = [0.0]
        reg = registry()
        policy = tenancy.TenancyPolicy(tenancy.parse_table("a:rate=10,burst=5;b:rate=20"),
                                       tighten_factor=0.5)
        gov = tenancy.QuotaGovernor(policy)
        eng = ctrl.SLOEngine(_slos(ctrl, cfg_mod), registry=reg, fast_s=60.0, slow_s=240.0,
                             burn_factor=2.0, clock=lambda c=clock: c[0], on_alert=gov.on_alert)
        states, factors = [], []
        for t, snap in series:
            clock[0] = t
            states.append(eng.observe(snapshot=snap))
            factors.append({k: v["factor"] for k, v in policy.snapshot().items()})
        runs[name] = dict(states=states, alerts=list(eng.alerts), verdicts=eng.verdicts(),
                          gauge=reg.snapshot()["slo_error_budget_remaining"],
                          actions=list(gov.actions), factors=factors)
    assert runs["port"] == runs["jax"]
    assert emitted["port"] == emitted["jax"]
    kinds = [k for _, k, _ in emitted["port"]]
    assert "slo_burn_start" in kinds and "slo_burn_stop" in kinds
    assert "tenant_quota_tightened" in kinds and "tenant_quota_restored" in kinds
    assert ("tighten", "a") in runs["port"]["actions"]
    assert all(t == "a" for _, t in runs["port"]["actions"])


def test_replay_equals_the_live_run():
    series = _series(7)
    records = [{"kind": "metrics_flush", "ts": t, "payload": {"snapshot": s}} for t, s in series]
    out = []
    for ctrl, _, registry, _, cfg_mod in (PORT, JAX):
        live = ctrl.SLOEngine(_slos(ctrl, cfg_mod), registry=registry(), fast_s=60.0,
                              slow_s=240.0)
        for t, snap in series:
            live.observe(t, snap)
        replayed = ctrl.SLOEngine(_slos(ctrl, cfg_mod), registry=registry(), fast_s=60.0,
                                  slow_s=240.0)
        replayed.replay(records)
        assert replayed.verdicts() == live.verdicts() and replayed.alerts == live.alerts
        out.append(live.verdicts())
    assert out[0] == out[1]


def test_slo_validation_good_total_and_percentile_equal_jax():
    for bad in (dict(target=1.5), dict(target=0.9, kind="nope"),
                dict(target=0.9, kind="latency")):
        for ctrl in (TCtrl, JCtrl):
            with pytest.raises(ValueError):
                ctrl.SLO("x", **bad)
    snap = _series(1)[-1][1]
    for args in (dict(), dict(tenant="a"), dict(kind="latency", threshold_s=0.1),
                 dict(kind="latency", threshold_s=1.0, level="reduced")):
        ours = TCtrl.good_total(TCtrl.SLO("s", target=0.9, **args), snap)
        assert ours == JCtrl.good_total(JCtrl.SLO("s", target=0.9, **args), snap)
    for q in (0.5, 0.9, 0.99):
        for level in (None, "full", "small"):
            assert TCtrl.merged_percentile(snap, q, level=level) == \
                JCtrl.merged_percentile(snap, q, level=level)
    assert TCtrl.merged_percentile({}, 0.99) is None


@pytest.mark.parametrize("seed", range(3))
def test_desired_action_equals_jax(seed):
    rng = random.Random(seed)
    for _ in range(300):
        kw = dict(routable=rng.randrange(0, 5), building=rng.randrange(0, 2),
                  mean_load=rng.choice((0.0, 0.2, 0.5, 1.0, 4.0, 6.5)),
                  queue_depth=rng.randrange(8), shed_rate=rng.choice((0.0, 0.0, 0.5, 2.0)),
                  p99_s=rng.choice((None, 0.05, 0.4, 0.9)),
                  pod_mean_load=rng.choice((None, None, 0.1, 5.0)))
        pol = dict(min_replicas=rng.randrange(1, 3), max_replicas=rng.randrange(2, 5),
                   load_high=4.0, load_low=0.5, shed_high=rng.choice((0.0, 1.0)),
                   p99_high_s=rng.choice((0.0, 0.5)))
        ours = TCtrl.desired_action(TCtrl.ScaleSignals(**kw), TCtrl.ScalePolicy(**pol))
        assert ours == JCtrl.desired_action(JCtrl.ScaleSignals(**kw), JCtrl.ScalePolicy(**pol))


class _ScriptedFleet:
    """The JAX tests' ``stats()``-shaped fake whose load the script sets."""

    def __init__(self, inflight, shed=0):
        self.reps = dict(inflight)
        self.next_rid = max(self.reps) + 1
        self.shed = shed
        self.adds, self.retires = [], []

    def stats(self):
        return {"shed": self.shed, "replica": [
            {"rid": rid, "state": "ready", "inflight": n, "engine": {"queue_depth": n // 2}}
            for rid, n in self.reps.items()]}

    def add_replica(self, wait=False, timeout=300.0):
        rid = self.next_rid
        self.next_rid += 1
        self.reps[rid] = 0
        self.adds.append(rid)
        return rid

    def retire_replica(self, rid, timeout=60.0, reason=""):
        del self.reps[rid]
        self.retires.append(rid)
        return True


@pytest.mark.parametrize("seed", range(3))
def test_autoscaler_equals_jax_on_one_clock(seed, emitted):
    runs = {}
    for name, (ctrl, _, registry, _, _) in (("port", PORT), ("jax", JAX)):
        rng = random.Random(seed)
        clock = [100.0]
        reg = registry()
        hist = reg.histogram("serve_request_latency_seconds", "served request latency",
                             buckets=(0.05, 0.1, 0.5, 1.0))
        fleet = _ScriptedFleet({0: 0, 1: 0})
        sc = ctrl.Autoscaler(
            fleet, ctrl.ScalePolicy(min_replicas=1, max_replicas=4, load_high=3.0,
                                    load_low=0.5, p99_high_s=0.4, down_dwell=2,
                                    up_cooldown_s=5.0, down_cooldown_s=8.0),
            registry=reg, p99_window_s=10.0, clock=lambda c=clock: c[0])
        recs = []
        for step in range(60):
            hot = (step // 12) % 2 == 1
            for rid in fleet.reps:
                fleet.reps[rid] = rng.randrange(4, 9) if hot else int(rng.random() < 0.2)
            fleet.shed += rng.randrange(3) if hot and rng.random() < 0.3 else 0
            for _ in range(rng.randrange(5)):
                hist.observe(rng.uniform(0.3, 0.9) if hot else rng.uniform(0.0, 0.1),
                             level="full")
            clock[0] += rng.choice((1.0, 2.0, 3.0))
            recs.append(sc.step())
        runs[name] = dict(recs=recs, decisions=sc.resize_timeline(), adds=fleet.adds,
                          retires=fleet.retires, size=reg.snapshot()["ctrl_fleet_size"])
    assert runs["port"] == runs["jax"]
    assert emitted["port"] == emitted["jax"]
    actions = [r["action"] for r in runs["port"]["recs"]]
    assert "up" in actions and "down" in actions
    assert any("cooldown" in r["reason"] for r in runs["port"]["recs"])


def test_build_controller_wires_config():
    cfg = TCfg.apply_overrides(TCfg.get_config("tiny_synthetic"),
                               ["ctrl.burn_fast_s=2", "ctrl.max_replicas=3"])
    eng, sc = TCtrl.build_controller(cfg, _ScriptedFleet({0: 0}))
    assert eng.fast_s == 2.0 and eng.slow_s == cfg.ctrl.burn_slow_s
    assert [s.name for s in eng.slos] == ["availability", "latency"]
    assert sc.policy == TCtrl.ScalePolicy.from_config(cfg.ctrl)
    assert sc.policy.max_replicas == 3


def _fields(cls) -> list:
    out = []
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        out.append((f.name, str(f.type), default if not dataclasses.is_dataclass(default)
                    else dataclasses.asdict(default)))
    return out


def test_config_fields_are_jax():
    assert _fields(TCfg.CtrlConfig) == _fields(JCfg.CtrlConfig)
    assert _fields(TCfg.DeployConfig) == _fields(JCfg.DeployConfig)
    for cls, name in (("ServeConfig", "result_cache_capacity"),
                      ("TenancyConfig", "tighten_factor")):
        ours = {f[0]: f for f in _fields(getattr(TCfg, cls))}
        theirs = {f[0]: f for f in _fields(getattr(JCfg, cls))}
        assert ours[name] == theirs[name]
    assert dataclasses.asdict(TCfg.get_config("r50_fpn_coco").ctrl) == \
        dataclasses.asdict(JCfg.get_config("r50_fpn_coco").ctrl)


def test_overrides_parse_the_same():
    sets = ["ctrl.enabled=true", "ctrl.max_replicas=3", "ctrl.load_high=1.5",
            "ctrl.period_s=0.2", "ctrl.burn_fast_s=2", "ctrl.deploy.mirror_rate=0.5",
            "ctrl.deploy.min_mirrored=4", "ctrl.deploy.enabled=yes",
            "serve.result_cache_capacity=16", "serve.tenancy.tighten_factor=0.1",
            "serve.tenancy.enabled=true", "serve.tenancy.table=a:rate=2,burst=1"]
    ours = TCfg.apply_overrides(TCfg.get_config("tiny_synthetic"), sets)
    theirs = JCfg.apply_overrides(JCfg.get_config("tiny_synthetic"), sets)
    assert dataclasses.asdict(ours.ctrl) == dataclasses.asdict(theirs.ctrl)
    assert dataclasses.asdict(ours.serve.tenancy) == dataclasses.asdict(theirs.serve.tenancy)
    assert ours.serve.result_cache_capacity == theirs.serve.result_cache_capacity == 16
    policy = TT.TenancyPolicy.from_config(ours.serve.tenancy)
    assert policy.tighten_factor == 0.1
    assert policy.tighten("a") and policy.snapshot()["a"]["factor"] == 0.1
