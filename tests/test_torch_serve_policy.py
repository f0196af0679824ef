"""The serving engine's policy modules in the port against the JAX package's,
decision for decision, under the same scripted inputs and fake clocks:

  * ``plan_level`` over a grid of (remaining, estimates, full_allowed,
    available, headroom);
  * ``CircuitBreaker`` and ``HysteresisPlanner`` over seeded random scripts
    of calls and clock steps: every return value and state;
  * ``EngineHealth``: transitions (illegal jumps refused in both),
    counters and snapshots;
  * ``PackBuffer`` over seeded random streams of arrivals, deadlines,
    programs and tenants, anti-starvation promotion included: every pack
    and every expiry;
  * ``TenancyPolicy``: ``admit``, ``retry_after_s``, ``label``,
    ``tighten`` and ``restore`` under a fake clock, and ``parse_table``,
    errors included.
All exact: the policies are host Python on floats.
"""

from __future__ import annotations

import itertools
import random

import pytest

from mx_rcnn_tpu.serve import batcher as JB
from mx_rcnn_tpu.serve import degrade as JD
from mx_rcnn_tpu.serve import health as JH
from mx_rcnn_tpu.serve import tenancy as JT
from mx_rcnn_tpu.serve.engine import Plan as JPlan
from mx_rcnn_tpu_torch.config import TenancyConfig
from mx_rcnn_tpu_torch.serve import batcher as TB
from mx_rcnn_tpu_torch.serve import degrade as TD
from mx_rcnn_tpu_torch.serve import health as TH
from mx_rcnn_tpu_torch.serve import tenancy as TT
from mx_rcnn_tpu_torch.serve.engine import Plan as TPlan


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _outcome(fn, *args, **kw):
    """A call's value, or its exception's type name and message."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# degrade.py


def test_levels_are_jax_levels():
    assert TD.LEVELS == JD.LEVELS
    assert TD.FULL_QUALITY_LEVELS == JD.FULL_QUALITY_LEVELS


AVAILABLE = [
    (), ("full",), ("full", "reduced"), ("full", "small", "reduced", "proposals"),
    ("full", "full_q8", "full_q8n", "reduced"), TD.LEVELS, ("reduced", "proposals"),
    ("proposals", "full", "full_q8"),
]
ESTIMATES = [
    {}, {"full": 0.1}, {"full": 1.0, "small": 0.5, "full_q8": 0.4, "full_q8n": 0.45,
                        "reduced": 0.2, "proposals": 0.05},
    {"full": 0.02, "small": 0.5, "reduced": 3.0}, {"reduced": 0.3, "proposals": 0.3},
]


@pytest.mark.parametrize("available", AVAILABLE, ids=lambda a: "+".join(a) or "none")
def test_plan_level_grid(available):
    n = 0
    for remaining, est, full_ok, headroom in itertools.product(
            (None, -1.0, 0.0, 0.03, 0.1, 0.25, 0.5, 0.6, 1.25, 10.0), ESTIMATES, (True, False),
            (1.0, 1.25, 2.0)):
        args = (remaining, est, full_ok, available)
        assert _outcome(TD.plan_level, *args, headroom=headroom) == \
            _outcome(JD.plan_level, *args, headroom=headroom), (args, headroom)
        n += 1
    assert n == 10 * len(ESTIMATES) * 2 * 3


@pytest.mark.parametrize("seed", range(6))
def test_circuit_breaker_transitions_equal(seed):
    rng = random.Random(seed)
    clocks = FakeClock(), FakeClock()
    threshold, cooldown = rng.choice((1, 2, 3)), rng.choice((0.5, 2.0, 5.0))
    ours = TD.CircuitBreaker(threshold, cooldown, clock=clocks[0])
    theirs = JD.CircuitBreaker(threshold, cooldown, clock=clocks[1])
    for step in range(300):
        op = rng.choice(("allow_full", "record_success", "record_failure", "record_failure",
                         "cancel_probe", "advance"))
        if op == "advance":
            dt = rng.choice((0.1, 0.5, 1.0, 3.0))
            for c in clocks:
                c.advance(dt)
            got = want = None
        else:
            got, want = getattr(ours, op)(), getattr(theirs, op)()
        assert (got, ours.state, ours.trips) == (want, theirs.state, theirs.trips), (step, op)
    assert _outcome(TD.CircuitBreaker, 0) == _outcome(JD.CircuitBreaker, 0)


@pytest.mark.parametrize("seed", range(6))
def test_hysteresis_planner_equal(seed):
    rng = random.Random(seed)
    kw = dict(headroom=rng.choice((1.0, 1.25)), up_margin=rng.choice((1.0, 1.5, 2.0)),
              up_dwell=rng.choice((1, 2, 3)))
    ours, theirs = TD.HysteresisPlanner(**kw), JD.HysteresisPlanner(**kw)
    est_t, est_j = TD.LatencyEstimator(), JD.LatencyEstimator()
    for step in range(300):
        if rng.random() < 0.5:
            lvl, sec = rng.choice(TD.LEVELS), rng.choice((0.01, 0.05, 0.1, 0.3, 1.0))
            est_t.observe(lvl, sec)
            est_j.observe(lvl, sec)
        assert est_t.snapshot() == est_j.snapshot()
        available = rng.choice(AVAILABLE[1:])
        remaining = rng.choice((None, 0.02, 0.06, 0.1, 0.2, 0.5, 2.0))
        full_ok = rng.random() < 0.8
        args = (remaining, est_t.snapshot(), full_ok, available)
        assert ours.plan(*args) == theirs.plan(*args), (step, args)
        assert ours.level == theirs.level
    assert _outcome(TD.HysteresisPlanner, up_dwell=0) == _outcome(JD.HysteresisPlanner,
                                                                   up_dwell=0)


# ---------------------------------------------------------------------------
# health.py


def test_health_states_and_transitions_are_jax():
    assert (TH.STARTING, TH.READY, TH.DEGRADED, TH.DEAD) == \
        (JH.STARTING, JH.READY, JH.DEGRADED, JH.DEAD)
    assert TH._TRANSITIONS == JH._TRANSITIONS


@pytest.mark.parametrize("seed", range(4))
def test_health_snapshots_equal(seed):
    rng = random.Random(seed)
    clocks = FakeClock(), FakeClock()
    ours = TH.EngineHealth(clock=clocks[0], latency_window=8, replica_id=seed or None)
    theirs = JH.EngineHealth(clock=clocks[1], latency_window=8, replica_id=seed or None)
    refused = 0
    for step in range(200):
        op = rng.choice(("transition", "shed", "miss", "fail", "served", "swap", "advance"))
        if op == "transition":
            new = rng.choice((TH.STARTING, TH.READY, TH.DEGRADED, TH.DEAD))
            got, want = ours.transition(new, f"r{step}"), theirs.transition(new, f"r{step}")
            refused += not got and new != ours.state
        elif op == "shed":
            got, want = ours.record_shed(), theirs.record_shed()
        elif op == "miss":
            got, want = ours.record_deadline_miss(), theirs.record_deadline_miss()
        elif op == "fail":
            got, want = ours.record_failure(), theirs.record_failure()
        elif op == "served":
            lvl, lat = rng.choice(TD.LEVELS), rng.random()
            got, want = ours.record_served(lvl, lat), theirs.record_served(lvl, lat)
        elif op == "swap":
            gen = ours.generation + rng.choice((-1, 0, 1, 2))
            got, want = _outcome(ours.record_swap, gen), _outcome(theirs.record_swap, gen)
        else:
            for c in clocks:
                c.advance(0.25)
            got = want = None
        assert got == want, (step, op)
        assert (ours.ready(), ours.alive(), ours.state, ours.reason) == \
            (theirs.ready(), theirs.alive(), theirs.state, theirs.reason)
        assert ours.snapshot(extra=step) == theirs.snapshot(extra=step), step
    assert refused > 0


def test_illegal_jumps_refused_in_both():
    for mod in (TH, JH):
        h = mod.EngineHealth(clock=FakeClock())
        assert not h.transition(mod.DEGRADED)          # STARTING -> DEGRADED
        assert h.transition(mod.READY) and h.transition(mod.DEAD)
        assert not h.transition(mod.READY) and h.state == mod.DEAD   # DEAD absorbs


# ---------------------------------------------------------------------------
# batcher.py


class _Req:
    def __init__(self, i, deadline, enqueued_at, plan, tenant):
        self.i, self.deadline, self.enqueued_at = i, deadline, enqueued_at
        self.plan, self.tenant = plan, tenant


TABLE = "a:weight=3,priority=0;b:weight=1;c:weight=2,priority=2"


@pytest.mark.parametrize("tenancy", [False, True], ids=["plain", "tenancy"])
@pytest.mark.parametrize("seed", range(4))
def test_pack_buffer_compositions_equal(seed, tenancy):
    rng = random.Random(seed)
    ours = TB.PackBuffer(TT.TenancyPolicy(TT.parse_table(TABLE)) if tenancy else None,
                         max_passovers=rng.choice((2, 3, 4)))
    theirs = JB.PackBuffer(JT.TenancyPolicy(JT.parse_table(TABLE)) if tenancy else None,
                           max_passovers=ours._max_passovers)
    programs = [("full", (64, 64)), ("full", (128, 128)), ("reduced", (64, 64)),
                ("full_q8", (128, 128))]
    now, i, packs, promoted = 0.0, 0, 0, 0
    for step in range(150):
        for _ in range(rng.choice((0, 1, 1, 2, 3))):
            mode, bucket = rng.choice(programs)
            deadline = None if rng.random() < 0.4 else now + rng.choice((0.05, 0.2, 1.0, 5.0))
            tenant = rng.choice((None, "a", "b", "c", "zzz"))
            level = rng.choice(("full", "small")) if mode == "full" else mode
            ours.add(_Req(i, deadline, now, TPlan(level, mode, bucket), tenant))
            theirs.add(_Req(i, deadline, now, JPlan(level, mode, bucket), tenant))
            i += 1
        now += rng.choice((0.0, 0.01, 0.1))
        if rng.random() < 0.3:
            assert [r.i for r in ours.expire(now)] == [r.i for r in theirs.expire(now)]
        bs = rng.choice((1, 2, 4))
        aged = [r.i for r in ours._items if ours._passovers.get(id(r), 0) >= ours._max_passovers]
        got, want = ours.take(bs), theirs.take(bs)
        assert (None if got is None else [r.i for r in got]) == \
            (None if want is None else [r.i for r in want]), step
        packs += got is not None
        promoted += bool(aged) and got is not None and got[0].i in aged
        assert len(ours) == len(theirs)
    assert sorted(r.i for r in ours.drain()) == sorted(r.i for r in theirs.drain())
    assert packs > 50 and promoted > 0, (packs, promoted)


def test_urgency_equal():
    for deadline, at in ((None, 1.0), (2.0, 1.0), (0.5, 3.0)):
        r = _Req(0, deadline, at, None, None)
        assert TB.urgency(r) == JB.urgency(r)


def test_anti_starvation_promotion_equal():
    """A deadline-less request on program B, passed over while deadlined
    program-A leads keep arriving, leads within ``max_passovers + 1`` packs
    in both (the JAX package's tests/test_tenancy.py scenario)."""
    leads = {}
    for name, mod, plan in (("port", TB, TPlan), ("jax", JB, JPlan)):
        buf = mod.PackBuffer(max_passovers=3)
        buf.add(_Req("starved", None, 0.0, plan("full", "full", (128, 128)), None))
        order = []
        for k in range(8):
            buf.add(_Req(k, 1.0 + k, 0.1 * k, plan("full", "full", (64, 64)), None))
            order.append(buf.take(1)[0].i)
        leads[name] = order
    assert leads["port"] == leads["jax"]
    assert leads["port"].index("starved") <= 3 + 1


# ---------------------------------------------------------------------------
# tenancy.py


@pytest.mark.parametrize("spec", [
    "a:weight=4,rate=50,burst=20,priority=0;b:", "a;b;;c:rate=2", " x : weight = 2 ",
    "a:wieght=2", ":rate=1", "a:rate", "a:priority=1.5", "a:rate=x", "",
])
def test_parse_table_equal(spec):
    assert _specs(_outcome(TT.parse_table, spec)) == _specs(_outcome(JT.parse_table, spec))


def _specs(table):
    """A tenant table (or an outcome) with each TenantSpec as its fields:
    the two packages' dataclasses never compare equal as objects."""
    if isinstance(table, dict):
        return {k: (type(v).__name__, vars(v)) for k, v in table.items()}
    return table


def test_tenancy_config_is_jax():
    from mx_rcnn_tpu.config import TenancyConfig as JaxTenancyConfig

    # Every field, tighten_factor (the QuotaGovernor's) included.
    jax_fields = vars(JaxTenancyConfig())
    assert set(jax_fields) == set(vars(TenancyConfig()))
    assert TenancyConfig() == TenancyConfig(**jax_fields)
    assert TT.TenancyPolicy.from_config(TenancyConfig()) is None
    cfg = TenancyConfig(enabled=True, table="a:rate=1,burst=2", default_tenant="d",
                        tighten_factor=0.5)
    ours = TT.TenancyPolicy.from_config(cfg)
    theirs = JT.TenancyPolicy.from_config(JaxTenancyConfig(**vars(cfg)))
    assert (_specs(ours.table), ours.default_tenant, ours.tighten_factor,
            ours.label_values()) == (_specs(theirs.table), theirs.default_tenant,
                                     theirs.tighten_factor, theirs.label_values())


@pytest.mark.parametrize("seed", range(4))
def test_tenancy_policy_equal(seed):
    rng = random.Random(seed)
    table = "a:weight=3,rate=1,burst=2;b:weight=1;c:rate=5,burst=1,priority=0"
    clocks = FakeClock(), FakeClock()
    ours = TT.TenancyPolicy(TT.parse_table(table), tighten_factor=0.5, clock=clocks[0])
    theirs = JT.TenancyPolicy(JT.parse_table(table), tighten_factor=0.5, clock=clocks[1])
    tokens = (None, "a", "b", "c", "default", "zzz", 7)
    for step in range(300):
        op = rng.choice(("admit", "admit", "admit", "retry", "label", "tighten", "restore",
                         "advance", "weight"))
        tok = rng.choice(tokens)
        if op == "admit":
            t = ours.resolve(tok)
            assert t == theirs.resolve(tok)
            got, want = ours.admit(t), theirs.admit(t)
        elif op == "retry":
            got, want = ours.retry_after_s(tok), theirs.retry_after_s(tok)
        elif op == "label":
            got, want = ours.label(tok), theirs.label(tok)
        elif op == "tighten":
            f = rng.choice((None, 0.25, 0.001, 3.0))
            got, want = ours.tighten(tok, f), theirs.tighten(tok, f)
        elif op == "restore":
            got, want = ours.restore(tok), theirs.restore(tok)
        elif op == "weight":
            got = (ours.weight(tok), ours.priority(tok))
            want = (theirs.weight(tok), theirs.priority(tok))
        else:
            dt = rng.choice((0.1, 0.5, 2.0))
            for c in clocks:
                c.advance(dt)
            got = want = None
        assert got == want, (step, op, tok)
        assert ours.snapshot() == theirs.snapshot(), step

