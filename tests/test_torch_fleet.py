"""The port's ``FleetRouter`` against the JAX package's, over fake runners.

The cases of the JAX package's ``tests/test_serve.py::TestFleet`` and
``tests/test_ctrl.py::TestDynamicFleet`` (routing, a kill with rebuild and
reinstatement, the hedge, retries into quarantine, the rolling swap, the
drain, add and retire on sparse ids, the autoscaler on a real fleet), and
the fleet's result cache, tenancy and mirror, run as one script each on
both packages, with the same fake runner (``test_torch_serve_engine``'s
copy of JAX's) and the same calls.  What the script decides (the
``stats()`` counters that do not depend on thread timing, the replica
states and ids, the served generations, the cache's counters, the
outcome metrics) must be equal, and equal to what the JAX tests expect.

Every fleet is stopped in a ``finally``; every wait is bounded (10 s).
"""

from __future__ import annotations

import threading
import time
import types

import pytest

from mx_rcnn_tpu import ctrl as JCtrl
from mx_rcnn_tpu import obs as JO
from mx_rcnn_tpu.serve import engine as JEng
from mx_rcnn_tpu.serve import fleet as JF
from mx_rcnn_tpu.serve import result_cache as JC
from mx_rcnn_tpu.serve import router as JR
from mx_rcnn_tpu.serve import tenancy as JT
from mx_rcnn_tpu_torch import ctrl as TCtrl
from mx_rcnn_tpu_torch import obs as TO
from mx_rcnn_tpu_torch.serve import engine as TEng
from mx_rcnn_tpu_torch.serve.degrade import LEVELS
from mx_rcnn_tpu_torch.serve import fleet as TF
from mx_rcnn_tpu_torch.serve import result_cache as TC
from mx_rcnn_tpu_torch.serve import router as TR
from mx_rcnn_tpu_torch.serve import tenancy as TT
from test_torch_serve_engine import FakeRunner, _img

PORT = types.SimpleNamespace(name="port", eng=TEng, fleet=TF, router=TR, obs=TO, ctrl=TCtrl,
                             cache=TC, tenancy=TT)
JAX = types.SimpleNamespace(name="jax", eng=JEng, fleet=JF, router=JR, obs=JO, ctrl=JCtrl,
                            cache=JC, tenancy=JT)
WAIT = 10.0

# Counters every script decides; "retries" and "hedges" also do where no
# replica fails by timing (they are compared per scenario below).
COUNTERS = ("replicas", "generation", "pending", "submitted", "completed", "failed", "shed",
            "quota", "quarantines", "reinstatements", "added", "retired")


@pytest.fixture(autouse=True)
def _fresh_planes():
    JO.reset()
    TO.reset()
    yield
    JO.reset()
    TO.reset()


def _wait(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for condition")
        time.sleep(0.005)


def _fleet(api, n=3, runner_fn=None, hang_timeout=5.0, **kw):
    runners, engines = {}, []

    def factory(rid):
        r = runner_fn(rid) if runner_fn else FakeRunner(delay=0.005)
        runners[rid] = r
        engines.append(api.eng.InferenceEngine(r, replica_id=rid, hang_timeout=hang_timeout))
        return engines[-1]

    kw.setdefault("supervisor_poll", 0.02)
    fleet = api.fleet.FleetRouter(factory, n, **kw)
    fleet.built_engines = engines
    return fleet, runners


def _stop(fleet):
    """Stop the fleet, then every engine its factory built: the JAX
    fleet leaves an engine that a rebuild replaced running."""
    fleet.stop(timeout=WAIT)
    for eng in fleet.built_engines:
        eng.stop(timeout=WAIT, drain=False)


def _summary(fleet, *extra):
    # A request's watcher thread leaves ``pending`` just after the latch.
    _wait(lambda: fleet.pending == 0)
    s = fleet.stats()
    out = {k: s[k] for k in (*COUNTERS, *extra)}
    out["states"] = {rep["rid"]: rep["state"] for rep in s["replica"]}
    return out


def routes_least_loaded(api):
    fleet, _ = _fleet(api, 3, runner_fn=lambda rid: FakeRunner(delay=0.05))
    try:
        fleet.start()
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(9)]
        used = sorted({r.result(WAIT)["replica_id"] for r in reqs})
    finally:
        _stop(fleet)
    return dict(used=used, stats=_summary(fleet, "retries", "hedges"))


def kill_loses_no_accepted_request(api):
    fleet, _ = _fleet(api, 3, runner_fn=lambda rid: FakeRunner(delay=0.02))
    try:
        fleet.start()
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(12)]
        fleet.kill_replica(1, "test kill")
        served = len([r.result(WAIT) for r in reqs])
        _wait(lambda: fleet.stats()["reinstatements"] >= 1)
        _wait(lambda: fleet.stats()["replica"][1]["state"] == api.router.READY)
        stats = _summary(fleet)
    finally:
        _stop(fleet)
    return dict(served=served, stats=stats)


def hedge_first_result_wins(api):
    gate = threading.Event()
    fleet, _ = _fleet(api, 2, runner_fn=lambda rid: FakeRunner(block=gate if rid == 0 else None),
                      hedge_after=0.05, quarantine_failures=100)
    try:
        fleet.start()
        res = fleet.submit(_img(8, 8), timeout=WAIT).result(WAIT)
        stats = _summary(fleet, "hedges", "hedge_wins", "retries")
        gate.set()   # the straggler's result is dropped
        _wait(lambda: fleet.pending == 0)
        after = fleet.stats()["completed"]
    finally:
        gate.set()
        _stop(fleet)
    return dict(replica=res["replica_id"], stats=stats, completed_after=after)


def failures_retry_then_quarantine_then_reinstate(api):
    built = []

    def runner_fn(rid):
        bad = rid == 0 and 0 not in built
        built.append(rid)
        return FakeRunner(fail_modes=set(LEVELS) if bad else set(),
                          delay=0.0 if bad else 0.05)

    fleet, _ = _fleet(api, 2, runner_fn=runner_fn, quarantine_failures=2, max_attempts=2)
    try:
        fleet.start()
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(6)]
        rids = sorted({r.result(WAIT)["replica_id"] for r in reqs})
        _wait(lambda: fleet.stats()["reinstatements"] >= 1)
        _wait(lambda: fleet.stats()["replica"][0]["state"] == api.router.READY)
        retried = fleet.stats()["retries"] >= 1
        stats = _summary(fleet)
    finally:
        _stop(fleet)
    return dict(rids=rids, retried=retried, stats=stats, built=sorted(built))


def rolling_swap_is_atomic_per_request(api):
    fleet, runners = _fleet(api, 2)
    try:
        fleet.start()
        gens = [fleet.infer(_img(8, 8), timeout=WAIT)["generation"]]
        swaps = [fleet.swap_weights({"w": 1})]
        gens.append(fleet.infer(_img(8, 8), timeout=WAIT)["generation"])
        swaps.append(fleet.swap_weights({"w": 2}))
        gens.append(fleet.infer(_img(8, 8), timeout=WAIT)["generation"])
        try:
            fleet.swap_weights({"w": 3}, generation=2)
            stale = None
        except ValueError as e:
            stale = type(e).__name__
        history = (fleet.current_weights(), fleet.previous_weights())
        runner_gens = sorted(r.generation for r in runners.values())
    finally:
        _stop(fleet)
    return dict(gens=gens, swaps=swaps, stale=stale, history=history, runner_gens=runner_gens,
                stats=_summary(fleet))


def drain_completes_accepted_then_refuses(api):
    fleet, _ = _fleet(api, 2, runner_fn=lambda rid: FakeRunner(delay=0.03))
    try:
        fleet.start()
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(8)]
        clean = fleet.drain(timeout=WAIT)
        levels = [r.result(1)["level"] for r in reqs]
        try:
            fleet.submit(_img(8, 8))
            refused = None
        except api.eng.EngineUnavailable as e:
            refused = str(e)
    finally:
        _stop(fleet)
    return dict(clean=clean, levels=levels, refused=refused, stats=_summary(fleet))


def submit_before_start_refused(api):
    fleet, _ = _fleet(api, 1)
    try:
        try:
            fleet.submit(_img(8, 8))
            refused = None
        except api.eng.EngineUnavailable as e:
            refused = str(e)
    finally:
        _stop(fleet)
    return dict(refused=refused)


def add_replica_joins_rotation(api):
    fleet, _ = _fleet(api, 2, runner_fn=lambda rid: FakeRunner(delay=0.01))
    try:
        fleet.start()
        rid = fleet.add_replica(wait=True, timeout=WAIT)
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(9)]
        used = sorted({r.result(WAIT)["replica_id"] for r in reqs})
        stats = _summary(fleet)
    finally:
        _stop(fleet)
    return dict(rid=rid, used=used, stats=stats)


def retire_drains_accepted_work(api):
    fleet, _ = _fleet(api, 3, runner_fn=lambda rid: FakeRunner(delay=0.05))
    try:
        fleet.start()
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(12)]
        clean = fleet.retire_replica(2, timeout=WAIT)
        served = len([r.result(WAIT) for r in reqs])
        stats = _summary(fleet)
    finally:
        _stop(fleet)
    return dict(clean=clean, served=served, stats=stats)


def rids_sparse_and_never_reused(api):
    fleet, _ = _fleet(api, 3, runner_fn=lambda rid: FakeRunner(delay=0.005))
    try:
        fleet.start()
        fleet.retire_replica(1, timeout=WAIT)
        rid = fleet.add_replica(wait=True, timeout=WAIT)
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(9)]
        used = sorted({r.result(WAIT)["replica_id"] for r in reqs})
        stats = _summary(fleet)
    finally:
        _stop(fleet)
    return dict(rid=rid, used=used, stats=stats)


def retire_guards(api):
    out = {}
    fleet, _ = _fleet(api, 1, runner_fn=lambda rid: FakeRunner())
    try:
        fleet.start()
        for rid in (0, 7):
            try:
                fleet.retire_replica(rid)
                out[rid] = None
            except (ValueError, KeyError) as e:
                out[rid] = type(e).__name__
        try:
            fleet.kill_replica(9)
            out["kill"] = None
        except KeyError as e:
            out["kill"] = type(e).__name__
        spare = fleet.build_spare_engine()   # the Deployer's shadow slot: out of rotation
        out["spare"] = (spare.replica_id, sorted(r["rid"] for r in fleet.stats()["replica"]))
    finally:
        _stop(fleet)
    return out


def add_then_kill_interleave_loses_nothing(api):
    fleet, _ = _fleet(api, 2, runner_fn=lambda rid: FakeRunner(delay=0.02))
    try:
        fleet.start()
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(8)]
        added = fleet.add_replica()
        fleet.kill_replica(0, "test interleave")
        reqs += [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(8)]
        served = len([r.result(WAIT) for r in reqs])
        _wait(lambda: fleet.stats()["replicas"] == 3)
        _wait(lambda: fleet.stats()["reinstatements"] >= 1)
        _wait(lambda: fleet.stats()["added"] >= 1)
        stats = _summary(fleet)
    finally:
        _stop(fleet)
    return dict(added=added, served=served, stats=stats)


def outcome_counters(api):
    fleet, _ = _fleet(api, 2, runner_fn=lambda rid: FakeRunner(delay=0.005))
    try:
        fleet.start()
        [r.result(WAIT) for r in [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(6)]]
    finally:
        _stop(fleet)
    return dict(series=api.obs.registry().snapshot()["fleet_requests_total"])


def autoscaler_drives_real_fleet(api):
    gate = threading.Event()
    fleet, _ = _fleet(api, 2, runner_fn=lambda rid: FakeRunner(block=gate), hang_timeout=60.0,
                      quarantine_failures=100)
    clk = [0.0]
    sc = api.ctrl.Autoscaler(
        fleet, api.ctrl.ScalePolicy(min_replicas=2, max_replicas=3, load_high=1.0,
                                    load_low=0.5, down_dwell=2, up_cooldown_s=0.0,
                                    down_cooldown_s=0.0),
        clock=lambda: clk[0])
    actions = []
    try:
        fleet.start()
        reqs = [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(8)]
        rec = sc.step()
        actions.append((rec["action"], rec.get("replica")))
        gate.set()
        served = len([r.result(WAIT) for r in reqs])
        _wait(lambda: any(rep["rid"] == rec["replica"] and rep["state"] == api.router.READY
                          for rep in fleet.stats()["replica"]))
        for _ in range(10):
            clk[0] += 1.0
            down = sc.step()
            actions.append((down["action"], down.get("replica")))
            if down["action"] == "down":
                break
        stats = _summary(fleet)
    finally:
        gate.set()
        _stop(fleet)
    return dict(actions=actions, served=served, stats=stats)


def result_cache_hits_and_coalesces(api):
    gate = threading.Event()
    cache = api.cache.ResultCache(capacity=4)
    fleet, runners = _fleet(api, 2, runner_fn=lambda rid: FakeRunner(block=gate),
                            result_cache=cache, quarantine_failures=100)
    img, other = _img(8, 8), _img(9, 9)
    try:
        fleet.start()
        leader = fleet.submit(img, timeout=WAIT)
        followers = [fleet.submit(img.copy(), timeout=WAIT) for _ in range(2)]
        gate.set()
        first = leader.result(WAIT)
        got = [f.result(WAIT) for f in followers]
        hit = fleet.submit(img, timeout=WAIT).result(WAIT)
        miss = fleet.submit(other, timeout=WAIT).result(WAIT)
        fleet.swap_weights({"w": 1})
        after_swap = fleet.submit(img, timeout=WAIT).result(WAIT)
        calls = sum(len(r.run_calls) for r in runners.values())
        stats = _summary(fleet)
        cstats = fleet.stats()["cache"]
    finally:
        gate.set()
        _stop(fleet)
    return dict(coalesced=[g.get("coalesced") for g in got],
                same_arrays=all(g["boxes"] is first["boxes"] for g in got),
                hit=(hit.get("cached"), hit["boxes"] is first["boxes"], "latency_s" in hit),
                miss=miss.get("cached"), after_swap=(after_swap.get("cached"),
                                                     after_swap["generation"]),
                calls=calls, stats=stats, cache=cstats)


def tenancy_charges_once(api):
    policy = api.tenancy.TenancyPolicy(api.tenancy.parse_table("a:rate=1,burst=2;b:weight=1"),
                                       clock=lambda: 0.0)
    fleet, _ = _fleet(api, 2, tenancy=policy)
    try:
        fleet.start()
        served = [fleet.submit(_img(8, 8), timeout=WAIT, tenant="a").result(WAIT)["level"]
                  for _ in range(2)]
        try:
            fleet.submit(_img(8, 8), tenant="a")
            quota = None
        except api.eng.QuotaExceeded as e:
            quota = (type(e).__name__, e.retry_after_s)
        served.append(fleet.submit(_img(8, 8), timeout=WAIT, tenant="b").result(WAIT)["level"])
        stats = _summary(fleet)
    finally:
        _stop(fleet)
    return dict(served=served, quota=quota, stats=stats,
                series=api.obs.registry().snapshot()["fleet_requests_total"])


def mirror_samples_every_nth(api):
    seen = []
    fleet, _ = _fleet(api, 2)
    try:
        fleet.start()
        fleet.set_mirror(lambda image, freq: seen.append(image.shape), rate=0.5)
        [r.result(WAIT) for r in [fleet.submit(_img(8, 8), timeout=WAIT) for _ in range(6)]]
        fired = fleet._mirror.fired
        fleet.clear_mirror()
        fleet.submit(_img(8, 8), timeout=WAIT).result(WAIT)
    finally:
        _stop(fleet)
    return dict(seen=seen, fired=fired, stats=_summary(fleet))


READY = TR.READY
SCENARIOS = {
    routes_least_loaded: dict(used=[0, 1, 2]),
    kill_loses_no_accepted_request: dict(served=12),
    hedge_first_result_wins: dict(replica=1, completed_after=1),
    failures_retry_then_quarantine_then_reinstate: dict(rids=[1], retried=True),
    rolling_swap_is_atomic_per_request: dict(gens=[0, 1, 2], swaps=[1, 2], stale="ValueError",
                                             runner_gens=[2, 2]),
    drain_completes_accepted_then_refuses: dict(clean=True, levels=["full"] * 8,
                                                refused="fleet stopping"),
    submit_before_start_refused: dict(refused="fleet not started"),
    add_replica_joins_rotation: dict(rid=2, used=[0, 1, 2]),
    retire_drains_accepted_work: dict(clean=True, served=12),
    rids_sparse_and_never_reused: dict(rid=3, used=[0, 2, 3]),
    retire_guards: {0: "ValueError", 7: "KeyError", "kill": "KeyError", "spare": (1, [0])},
    add_then_kill_interleave_loses_nothing: dict(added=2, served=16),
    outcome_counters: dict(series={'{outcome="completed"}': 6.0}),
    autoscaler_drives_real_fleet: dict(served=8),
    result_cache_hits_and_coalesces: dict(coalesced=[True, True], same_arrays=True,
                                          hit=(True, True, False), miss=None,
                                          after_swap=(None, 1), calls=3),
    tenancy_charges_once: dict(served=["full"] * 3),
    mirror_samples_every_nth: dict(seen=[(8, 8, 3)] * 3, fired=3),
}
STATS = {
    routes_least_loaded: dict(submitted=9, completed=9, failed=0, retries=0, hedges=0,
                              states={0: READY, 1: READY, 2: READY}),
    kill_loses_no_accepted_request: dict(completed=12, failed=0, quarantines=1,
                                         reinstatements=1),
    hedge_first_result_wins: dict(hedges=1, hedge_wins=1, completed=1, retries=0),
    failures_retry_then_quarantine_then_reinstate: dict(failed=0, completed=6, quarantines=1,
                                                        reinstatements=1),
    drain_completes_accepted_then_refuses: dict(failed=0, completed=8, pending=0),
    retire_drains_accepted_work: dict(failed=0, replicas=2, retired=1,
                                      states={0: READY, 1: READY}),
    rids_sparse_and_never_reused: dict(states={0: READY, 2: READY, 3: READY}, added=1,
                                       retired=1),
    add_then_kill_interleave_loses_nothing: dict(failed=0, replicas=3, added=1,
                                                 reinstatements=1),
    autoscaler_drives_real_fleet: dict(failed=0, added=1, retired=1, replicas=2),
    result_cache_hits_and_coalesces: dict(submitted=6, completed=6, failed=0, generation=1),
    tenancy_charges_once: dict(submitted=4, completed=3, quota=1, shed=0),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=lambda f: f.__name__)
def test_fleet_scenario_as_jax(scenario):
    ours, theirs = scenario(PORT), scenario(JAX)
    assert ours == theirs
    for key, want in SCENARIOS[scenario].items():
        assert ours[key] == want, key
    for key, want in STATS.get(scenario, {}).items():
        assert ours["stats"][key] == want, key


def test_autoscaler_retires_the_replica_it_added():
    got = autoscaler_drives_real_fleet(PORT)
    assert got["actions"][0] == ("up", 2) and got["actions"][-1] == ("down", 2)


def test_cache_counts_hits_and_followers():
    cache = result_cache_hits_and_coalesces(PORT)["cache"]
    assert (cache["hits"], cache["coalesced"], cache["inserts"]) == (1, 2, 3)


def test_rebuild_stops_the_engine_it_replaces():
    """Port-only: the killed engine's worker exits once its replacement is
    in rotation, so its runner (its weights on the card) can be freed."""
    fleet, _ = _fleet(PORT, 2)
    try:
        fleet.start()
        old = fleet._replicas[1].engine
        fleet.kill_replica(1, "test")
        _wait(lambda: fleet.stats()["reinstatements"] >= 1)
        _wait(lambda: not old._worker.is_alive())
        assert fleet._replicas[1].engine is not old and old._stopping
        assert fleet.infer(_img(8, 8), timeout=WAIT)["level"] == "full"
    finally:
        _stop(fleet)


def test_the_fleet_has_the_jax_signatures():
    import inspect

    for name in ("__init__", "submit", "swap_weights", "add_replica", "retire_replica",
                 "kill_replica", "drain", "stop", "set_mirror", "build_spare_engine"):
        ours = inspect.signature(getattr(TF.FleetRouter, name))
        theirs = inspect.signature(getattr(JF.FleetRouter, name))
        assert str(ours) == str(theirs), name
    ours = inspect.signature(TF.build_fleet).parameters
    theirs = inspect.signature(JF.build_fleet).parameters
    assert [p for p in ours if p != "device"] == list(theirs)
