"""The port's continuous deployment (``ctrl/deploy.py``, ``restore_raw``)
against the JAX package's, on the CPU.

* ``comparable_payload``, ``payloads_equal`` and ``golden_map`` on seeded
  payloads and golden sets, hits and misses included: exactly equal.
* ``restore_raw`` and ``verify_manifest`` on a newest step that is
  truncated, has a flipped byte or lost its manifest: the same reasons and
  the same walk-back step (neither package's raw restore reads the
  manifest, so a flipped byte loads in both).
* The cases of the JAX package's ``tests/test_deploy.py`` ``TestShadowGate``,
  ``TestRollback``, ``TestRecover`` and ``TestBuildDeployer``, run as one
  script each on both packages over the same weight-sensitive fake runner
  (the JAX tests' ``WeightRunner``), each package writing its own
  checkpoints: the outcomes, reasons, generations, verdicts, the
  ``history`` (less ``t``), the ``ctrl_deploy_*`` counters and
  ``recover``'s summaries are equal, and equal to what the JAX tests
  expect.  One more script, with live deadlines a slow shadow would miss,
  shows both shadows infer within ``mirror_timeout_s`` and promote.
* A promote and a rollback journaled by each package replay through the
  port's ``obs/report.py`` and the JAX package's ``tools/obs_report.py`` to
  the same deploy timeline.
* ``build_deployer`` takes every ``cfg.ctrl.deploy`` field, keyword
  overrides win, and one ``--set ctrl.deploy.*`` list gives equal settings.

Deterministic by construction: each Deployer reads an injected clock that
only the test moves, mirrored traffic is a fixed count submitted once the
mirror is installed (the shadow window is a ceiling no passing run
reaches), and a watch window is crossed by advancing that clock.  Every
fleet is stopped in a ``finally``; every wait is bounded (10 s).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import importlib.util
import os
import threading
import types

import numpy as np
import pytest

from mx_rcnn_tpu import config as JCfg
from mx_rcnn_tpu import ctrl as JCtrl
from mx_rcnn_tpu import obs as JO
from mx_rcnn_tpu.ctrl import deploy as JDep
from mx_rcnn_tpu.serve import engine as JEng
from mx_rcnn_tpu.serve import fleet as JF
from mx_rcnn_tpu.train import checkpoint as JCk
from mx_rcnn_tpu_torch import config as TCfg
from mx_rcnn_tpu_torch import ctrl as TCtrl
from mx_rcnn_tpu_torch import obs as TO
from mx_rcnn_tpu_torch.ctrl import deploy as TDep
from mx_rcnn_tpu_torch.obs import report as TReport
from mx_rcnn_tpu_torch.serve import engine as TEng
from mx_rcnn_tpu_torch.serve import fleet as TF
from mx_rcnn_tpu_torch.train import checkpoint as TCk
from test_torch_fleet import _fleet, _stop, _wait
from test_torch_serve_engine import FakeRunner, _img

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 10.0


def _jax_save(d, step, tree):
    JCk.save_checkpoint(d, {"step": step, "variables": tree}, manifest=True)


def _port_save(d, step, tree):
    TCk.save_checkpoint(d, TCk.weights_payload(step, tree))


PORT = types.SimpleNamespace(name="port", dep=TDep, ctrl=TCtrl, eng=TEng, fleet=TF, obs=TO,
                             ckpt=TCk, cfg=TCfg, save=_port_save)
JAX = types.SimpleNamespace(name="jax", dep=JDep, ctrl=JCtrl, eng=JEng, fleet=JF, obs=JO,
                            ckpt=JCk, cfg=JCfg, save=_jax_save)


@pytest.fixture(autouse=True)
def _fresh_planes():
    JO.reset()
    TO.reset()
    yield
    JO.reset()
    TO.reset()


# Two weight trees whose first element drives the fake runner's output:
# candidates equal to TREE_A are bitwise-parity-clean against a TREE_A
# fleet; TREE_B candidates diverge and miss TREE_A's golden ground truth.
TREE_A = {"w": np.full((4,), 3.0, np.float32)}
TREE_B = {"w": np.full((4,), 40.0, np.float32)}


def _sig(tree):
    if tree is None:
        return 0.0
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        else:
            leaves.append(np.asarray(x))

    walk(tree)
    return float(np.ravel(leaves[0])[0]) if leaves else 0.0


def _sig_box(sig):
    return np.array([[0.0, 0.0, 1.0 + sig, 1.0 + sig]], np.float32)


class WeightRunner(FakeRunner):
    """The JAX tests' runner: detections depend bitwise on the swapped
    tree, so two engines agree bitwise iff they hold equal weights."""

    def __init__(self, *args, variables=None, **kw):
        super().__init__(*args, **kw)
        self.sig = _sig(variables)
        self.swapped = []  # (generation, tree) in arrival order

    def swap_weights(self, variables, generation=None):
        gen = super().swap_weights(variables, generation=generation)
        self.sig = _sig(variables)
        self.swapped.append((gen, variables))
        return gen

    def run(self, mode, bucket, images):
        out = super().run(mode, bucket, images)
        for r in out:
            r["boxes"] = _sig_box(self.sig)
            r["scores"] = np.array([0.9], np.float32)
            r["classes"] = np.zeros(1, np.int32)
        return out


class ManualClock:
    """The Deployer's clock: moves only when the test advances it."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _weight_fleet(api, n=2, tree=TREE_A, delay=0.002, shadow_delay=None):
    """``n`` replicas running ``delay`` s a call; a spare engine (rid >= n,
    the shadow) runs ``shadow_delay`` s when it is given."""
    def runner(rid):
        slow = shadow_delay is not None and rid >= n
        return WeightRunner(delay=shadow_delay if slow else delay, variables=tree)

    fleet, runners = _fleet(api, n, runner_fn=runner, initial_weights=tree)
    fleet.start()
    return fleet, runners


def _deployer(api, fleet, d, clock, **kw):
    kw.setdefault("mirror_rate", 1.0)
    kw.setdefault("min_mirrored", 3)
    kw.setdefault("shadow_window_s", 10.0)
    kw.setdefault("mirror_timeout_s", 5.0)
    kw.setdefault("slo_fast_s", 2.0)
    kw.setdefault("slo_slow_s", 6.0)
    kw.setdefault("watch_window_s", 60.0)
    return api.dep.Deployer(fleet, d, clock=clock, **kw)


def mirrored_image(i: int) -> np.ndarray:
    return np.full((32, 32, 3), (i % 31) * 0.5, np.float32)


class Mirrored:
    """Live traffic for one shadow: once ``deploy_shadow_start`` is in the
    history and the fleet's mirror hook is installed, ``count`` varied
    images (nothing coalesces), one submit each, every one mirrored at
    ``mirror_rate=1.0``.  With ``count=0`` it instead advances the clock
    until the offer returns (a window that must run out).  A run that
    never rules within 10 s gets its window closed so the test fails
    instead of hanging."""

    def __init__(self, fleet, dep, clock, count: int, deadline: float = WAIT) -> None:
        self.fleet, self.dep, self.clock, self.count = fleet, dep, clock, count
        self.deadline = deadline
        self.reqs = []
        self.done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="test-mirrored", daemon=True)

    def _run(self) -> None:
        _wait(lambda: any(h["kind"] == "deploy_shadow_start" for h in list(self.dep.history))
              and self.fleet._mirror is not None)
        for i in range(self.count):
            self.reqs.append(self.fleet.submit(mirrored_image(i), timeout=self.deadline))
        if self.count == 0:
            while not self.done.wait(0.01):
                self.clock.advance(0.1)
        elif not self.done.wait(WAIT):
            self.clock.advance(1e6)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, exc_type, *exc):
        self.done.set()
        self._thread.join(WAIT)
        if exc_type is None:
            assert not self._thread.is_alive(), "the traffic thread did not end"

    def results(self):
        return [r.result(WAIT) for r in self.reqs]


def _offer(fleet, dep, clock, step=1, count=3, deadline=WAIT):
    with Mirrored(fleet, dep, clock, count, deadline) as traffic:
        out = dep.offer(step)
    return out, traffic


def _verdict(v):
    return None if v is None else dataclasses.asdict(v)


def _out(out: dict) -> dict:
    return {k: (_verdict(v) if k == "verdict" else v) for k, v in out.items()}


def _history(dep) -> list:
    return [{k: v for k, v in h.items() if k != "t"} for h in dep.history]


def _counters(api) -> dict:
    snap = api.obs.registry().snapshot()
    return {k: v for k, v in snap.items() if k.startswith("ctrl_deploy_")}


def _swaps(runners, n=2) -> list:
    """(generation, the tree's values) of every swap of the live replicas
    (the shared factory also records the shadow's runner under a later rid)."""
    return [[(g, np.asarray(t["w"]).tolist()) for g, t in runners[rid].swapped]
            for rid in range(n)]


def _corrupt_first_byte(api, d, step):
    m = api.ckpt.read_manifest(d, step)
    rel = max(m["files"], key=lambda r: m["files"][r]["bytes"])
    sdir = api.ckpt._step_dir(d, step) if api is JAX else api.ckpt.step_dir(d, step)
    full = os.path.join(sdir, rel)
    with open(full, "r+b") as f:
        b = bytearray(f.read())
        b[0] ^= 0xFF
        f.seek(0)
        f.write(bytes(b))


# -- the scripts, one per JAX test ---------------------------------------------------------


def parity_pass_slo_fail(api, d):
    api.save(d, 1, TREE_A)
    clock = ManualClock()
    fleet, runners = _weight_fleet(api, delay=0.003)
    try:
        dep = _deployer(api, fleet, d, clock, latency_threshold_s=1e-4)
        out, _ = _offer(fleet, dep, clock)
    finally:
        _stop(fleet)
    return dict(out=_out(out), history=_history(dep), counters=_counters(api),
                generation=fleet.generation, swaps=_swaps(runners))


def parity_fail_slo_pass(api, d):
    api.save(d, 1, TREE_B)
    clock = ManualClock()
    fleet, runners = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock)
        out, traffic = _offer(fleet, dep, clock)
        served = [r["generation"] for r in traffic.results()]
        reserved = dep._reserve_generation()
    finally:
        _stop(fleet)
    return dict(out=_out(out), history=_history(dep), counters=_counters(api), served=served,
                reserved=reserved, generation=fleet.generation, swaps=_swaps(runners))


def parity_fail_map_regression(api, d):
    api.save(d, 1, TREE_B)
    golden = {"images": [np.zeros((32, 32, 3), np.float32)],
              "gt": {0: {"0": {"boxes": _sig_box(_sig(TREE_A)),
                               "difficult": np.zeros(1, bool)}}}}
    clock = ManualClock()
    fleet, _ = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock, golden=golden)
        out, _ = _offer(fleet, dep, clock)
    finally:
        _stop(fleet)
    return dict(out=_out(out), history=_history(dep), counters=_counters(api))


def insufficient_mirrored(api, d):
    api.save(d, 1, TREE_A)
    clock = ManualClock()
    fleet, _ = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock, min_mirrored=2, shadow_window_s=0.3,
                        mirror_timeout_s=0.2)
        out, _ = _offer(fleet, dep, clock, count=0)   # no traffic at all
    finally:
        _stop(fleet)
    return dict(out=_out(out), history=_history(dep), counters=_counters(api),
                generation=fleet.generation)


def clean_candidate_promotes(api, d):
    api.save(d, 1, TREE_A)
    clock = ManualClock()
    fleet, runners = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock, watch_window_s=0.0)
        out, _ = _offer(fleet, dep, clock)
        after = fleet.infer(_img(16, 16), timeout=WAIT)["generation"]
        pending = dep.pending_candidates()
    finally:
        _stop(fleet)
    return dict(out=_out(out), history=_history(dep), counters=_counters(api),
                generation=fleet.generation, swaps=_swaps(runners), after=after, pending=pending)


def corrupt_candidate_never_staged(api, d):
    api.save(d, 1, TREE_B)
    _corrupt_first_byte(api, d, 1)
    clock = ManualClock()
    fleet, runners = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock)
        out = dep.offer(1)
        built = sorted(runners)
    finally:
        _stop(fleet)
    out["reason"] = out["reason"].split(":")[0]   # the file's name is each package's own
    return dict(out=out, kinds=[h["kind"] for h in dep.history], counters=_counters(api),
                generation=fleet.generation, swaps=_swaps(runners), built=built)


def burn_inside_window_rolls_back(api, d):
    api.save(d, 1, TREE_A)
    live_slo = types.SimpleNamespace(alerts=[])
    clock = ManualClock()
    fleet, runners = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock, live_slo=live_slo)
        out, _ = _offer(fleet, dep, clock)
        quiet = dep.check_watch()
        live_slo.alerts.append({"event": "start", "slo": "availability", "t": 0.0,
                                "burn_fast": 37.5})
        rb = dep.check_watch()
        after = fleet.infer(_img(16, 16), timeout=WAIT)["generation"]
        again = dep.check_watch()
    finally:
        _stop(fleet)
    return dict(out=_out(out), quiet=quiet, rb=rb, after=after, again=again,
                history=_history(dep), counters=_counters(api), generation=fleet.generation,
                swaps=_swaps(runners))


def quiet_window_disarms(api, d):
    api.save(d, 1, TREE_A)
    live_slo = types.SimpleNamespace(alerts=[])
    clock = ManualClock()
    fleet, _ = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock, live_slo=live_slo, watch_window_s=0.05)
        out, _ = _offer(fleet, dep, clock)
        clock.advance(0.1)   # past the watch window, with no burn
        rb = dep.check_watch()
        watch = dep._watch
    finally:
        _stop(fleet)
    return dict(out=_out(out), rb=rb, watch=watch, generation=fleet.generation,
                history=_history(dep))


def pre_promote_burn_alerts_do_not_count(api, d):
    api.save(d, 1, TREE_A)
    live_slo = types.SimpleNamespace(alerts=[
        {"event": "start", "slo": "availability", "burn_fast": 9.0}])
    clock = ManualClock()
    fleet, _ = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock, live_slo=live_slo)
        out, _ = _offer(fleet, dep, clock)
        rb = dep.check_watch()
    finally:
        _stop(fleet)
    return dict(out=_out(out), rb=rb, generation=fleet.generation, history=_history(dep))


def tight_live_deadline_slow_shadow(api, d):
    """Not a JAX test: live deadlines of 0.25 s that the replicas (2 ms a
    call) meet, and a shadow at 0.4 s a call that would miss them.  The
    shadow infers with ``mirror_timeout_s`` as its budget, never the live
    request's, so every pair lands and compares at ``full`` and the
    bitwise-identical candidate promotes."""
    api.save(d, 1, TREE_A)
    clock = ManualClock()
    fleet, runners = _weight_fleet(api, shadow_delay=0.4)
    try:
        dep = _deployer(api, fleet, d, clock, watch_window_s=0.0)
        out, traffic = _offer(fleet, dep, clock, deadline=0.25)
        live = [(r["level"], r["generation"]) for r in traffic.results()]
    finally:
        _stop(fleet)
    return dict(out=_out(out), history=_history(dep), counters=_counters(api),
                generation=fleet.generation, swaps=_swaps(runners), live=live)


def _rec(kind, **payload):
    return {"kind": kind, "payload": payload}


def resume_promote_after_verdict(api, d):
    fleet, runners = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, ManualClock(), loader=lambda step: {"variables": TREE_A})
        summary = dep.recover(records=[
            _rec("deploy_candidate", step=7, valid=True, reason="ok"),
            _rec("deploy_shadow_start", step=7, generation=3, mirror_rate=1.0),
            _rec("deploy_shadow_verdict", step=7, generation=3, verdict="promote",
                 reason="ok"),
        ])
    finally:
        _stop(fleet)
    return dict(summary=summary, generation=fleet.generation, swaps=_swaps(runners),
                history=_history(dep), counters=_counters(api))


def abandon_mid_shadow(api, d):
    fleet, runners = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, ManualClock())
        summary = dep.recover(records=[
            _rec("deploy_shadow_start", step=7, generation=3, mirror_rate=1.0)])
        reserved = dep._reserve_generation()
    finally:
        _stop(fleet)
    return dict(summary=summary, generation=fleet.generation, swaps=_swaps(runners),
                history=_history(dep), counters=_counters(api), reserved=reserved)


def rearm_watch_after_promote(api, d):
    live_slo = types.SimpleNamespace(alerts=[])
    fleet, runners = _weight_fleet(api)
    try:
        fleet.swap_weights(TREE_A, generation=3)   # the landed roll
        dep = _deployer(api, fleet, d, ManualClock(), live_slo=live_slo)
        summary = dep.recover(records=[
            _rec("deploy_shadow_start", step=7, generation=3, mirror_rate=1.0),
            _rec("deploy_shadow_verdict", step=7, generation=3, verdict="promote",
                 reason="ok"),
            _rec("deploy_promote", step=7, generation=3, from_generation=0,
                 watch_window_s=60.0),
        ])
        live_slo.alerts.append({"event": "start", "slo": "availability", "burn_fast": 5.0})
        rb = dep.check_watch()
    finally:
        _stop(fleet)
    return dict(summary=summary, rb=rb, generation=fleet.generation, swaps=_swaps(runners),
                history=_history(dep))


def settled_decisions_replay_as_decided(api, d):
    fleet, _ = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, ManualClock())
        summary = dep.recover(records=[
            _rec("deploy_candidate", step=5, valid=True, reason="ok"),
            _rec("deploy_shadow_start", step=5, generation=2, mirror_rate=1.0),
            _rec("deploy_shadow_verdict", step=5, generation=2, verdict="reject",
                 reason="parity"),
            _rec("deploy_reject", step=5, reason="parity"),
            _rec("deploy_rollback", step=4, from_generation=2, to_generation=9,
                 restored_generation=1),
        ])
        reserved = dep._reserve_generation()
    finally:
        _stop(fleet)
    return dict(summary=summary, history=_history(dep), reserved=reserved)


SCRIPTS = {f.__name__: f for f in (
    parity_pass_slo_fail, parity_fail_slo_pass, parity_fail_map_regression,
    insufficient_mirrored, clean_candidate_promotes, corrupt_candidate_never_staged,
    burn_inside_window_rolls_back, quiet_window_disarms, pre_promote_burn_alerts_do_not_count,
    resume_promote_after_verdict, abandon_mid_shadow, rearm_watch_after_promote,
    settled_decisions_replay_as_decided, tight_live_deadline_slow_shadow)}


def _both(name, tmp_path):
    """The script on both packages at once (each its own fleet, clock,
    checkpoints and observability plane; nothing is shared)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {}
        for api in (JAX, PORT):
            d = str(tmp_path / api.name)
            os.makedirs(d)
            futures[api.name] = pool.submit(SCRIPTS[name], api, d)
        got = {k: f.result(WAIT) for k, f in futures.items()}
    assert got["port"] == got["jax"], (got["port"], got["jax"])
    return got["port"]


# -- the JAX tests' expectations ------------------------------------------------------------


def _expect_parity_pass_slo_fail(r):
    assert r["out"]["outcome"] == "rejected" and r["out"]["reason"] == "shadow_slo"
    v = r["out"]["verdict"]
    assert v["mismatched"] == 0 and v["shadow_failures"] == 0 and v["mirrored"] == 3
    assert not v["slo_ok"]
    latency = [x for x in v["slo_verdicts"] if x["kind"] == "latency"]
    assert latency and not latency[0]["held"]
    assert r["generation"] == 0 and r["swaps"] == [[], []]


def _expect_parity_fail_slo_pass(r):
    assert r["out"]["outcome"] == "rejected" and r["out"]["reason"] == "parity"
    v = r["out"]["verdict"]
    assert v["mismatched"] == 3 and v["slo_ok"]
    # The rejected candidate's generation never appears in any served
    # response's tag, and its number is burned forever.
    assert r["served"] == [0, 0, 0]
    assert r["generation"] == 0 and r["reserved"] > v["generation"]
    assert r["counters"]["ctrl_deploy_candidates_total"] == {'{outcome="rejected"}': 1.0}
    assert r["counters"]["ctrl_deploy_mirrored_total"] == {"": 3.0}


def _expect_parity_fail_map_regression(r):
    v = r["out"]["verdict"]
    assert r["out"]["outcome"] == "rejected"
    assert v["map_live"] == pytest.approx(1.0) and v["map_shadow"] == pytest.approx(0.0)
    assert v["map_ok"] is False


def _expect_insufficient_mirrored(r):
    assert r["out"]["outcome"] == "rejected" and r["out"]["reason"] == "insufficient_mirrored"
    assert r["out"]["verdict"]["mirrored"] < 2 and r["generation"] == 0


def _expect_clean_candidate_promotes(r):
    assert r["out"]["outcome"] == "promoted" and r["out"]["verdict"]["reason"] == "ok"
    gen = r["out"]["generation"]
    assert r["generation"] == gen and r["after"] == gen
    assert r["swaps"] == [[(gen, TREE_A["w"].tolist())]] * 2
    assert [h["kind"] for h in r["history"]] == [
        "deploy_candidate", "deploy_shadow_start", "deploy_shadow_verdict", "deploy_promote"]
    assert r["pending"] == []


def _expect_corrupt_candidate_never_staged(r):
    assert r["out"] == {"step": 1, "outcome": "invalid", "reason": "file_checksum_mismatch"}
    assert r["kinds"] == ["deploy_candidate", "deploy_reject"]
    # Rejected before deserialization: no shadow, no swap, no roll.
    assert r["generation"] == 0 and r["swaps"] == [[], []] and r["built"] == [0, 1]


def _expect_burn_inside_window_rolls_back(r):
    promoted = r["out"]["generation"]
    rb = r["rb"]
    assert r["out"]["outcome"] == "promoted" and r["quiet"] is None
    assert rb["from_generation"] == promoted and rb["to_generation"] > promoted
    assert rb["restored_generation"] == 0 and rb["slo"] == "availability"
    assert r["generation"] == rb["to_generation"] == r["after"]
    # The restored tree is bitwise the pre-promote tree, under the NEW generation.
    assert all(s[-1] == (rb["to_generation"], TREE_A["w"].tolist()) for s in r["swaps"])
    assert r["history"][-1]["kind"] == "deploy_rollback" and r["again"] is None
    assert r["counters"]["ctrl_deploy_rollbacks_total"] == {"": 1.0}


def _expect_quiet_window_disarms(r):
    assert r["out"]["outcome"] == "promoted" and r["rb"] is None and r["watch"] is None
    assert r["generation"] == r["out"]["generation"]


def _expect_pre_promote_burn_alerts_do_not_count(r):
    assert r["out"]["outcome"] == "promoted" and r["rb"] is None
    assert r["generation"] == r["out"]["generation"]


def _expect_resume_promote_after_verdict(r):
    assert r["summary"]["resumed"] == [7] and r["generation"] == 3
    assert all(s[-1][0] == 3 for s in r["swaps"])
    assert [h["kind"] for h in r["history"]] == ["deploy_resume", "deploy_promote"]
    assert r["history"][0]["action"] == "resume_promote"


def _expect_abandon_mid_shadow(r):
    assert r["summary"]["abandoned"] == [7]
    assert [h["kind"] for h in r["history"]] == ["deploy_resume", "deploy_reject"]
    assert r["history"][0]["action"] == "abandon"
    assert r["generation"] == 0 and r["swaps"] == [[], []] and r["reserved"] > 3


def _expect_rearm_watch_after_promote(r):
    assert r["summary"]["rearmed"] == [7] and r["summary"]["decided"] == [7]
    assert r["rb"]["to_generation"] > 3 and r["generation"] == r["rb"]["to_generation"]
    assert r["swaps"][0][-1] == (r["rb"]["to_generation"], TREE_A["w"].tolist())


def _expect_settled_decisions_replay_as_decided(r):
    assert sorted(r["summary"]["decided"]) == [4, 5]
    assert r["summary"]["resumed"] == [] and r["summary"]["abandoned"] == []
    assert r["history"] == [] and r["reserved"] > 9


def _expect_tight_live_deadline_slow_shadow(r):
    v = r["out"]["verdict"]
    assert r["out"]["outcome"] == "promoted" and v["reason"] == "ok"
    assert v["mirrored"] == v["compared"] == 3 and v["mismatched"] == 0
    assert v["level_mismatch"] == 0 and v["shadow_failures"] == 0 and v["slo_ok"]
    assert r["live"] == [("full", 0)] * 3
    gen = r["out"]["generation"]
    assert r["generation"] == gen and r["swaps"] == [[(gen, TREE_A["w"].tolist())]] * 2


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_deployer_script_matches_jax(name, tmp_path):
    globals()[f"_expect_{name}"](_both(name, tmp_path))


# -- the parity helpers ------------------------------------------------------------------


def _payloads(rng):
    """Seeded response pairs: equal, a one-ulp box, other levels, extra or
    missing keys, volatile stamps and provenance tags that differ."""
    out = []
    for i in range(40):
        n = int(rng.integers(0, 4))
        a = {"boxes": rng.uniform(0, 64, (n, 4)).astype(np.float32),
             "scores": rng.uniform(0, 1, n).astype(np.float32),
             "classes": rng.integers(1, 5, n).astype(np.int32), "level": "full",
             "generation": int(rng.integers(0, 9)), "latency_s": float(rng.uniform()),
             "replica_id": int(rng.integers(0, 3))}
        b = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in a.items()}
        b.update(generation=int(rng.integers(0, 9)), latency_s=float(rng.uniform()),
                 replica_id=5, host_id="b", cached=True, coalesced=bool(i % 2))
        kind = i % 6
        if kind == 1 and n:
            b["boxes"][0, 0] = np.nextafter(b["boxes"][0, 0], np.float32(1e9))
        elif kind == 2:
            b["level"] = "reduced"
        elif kind == 3:
            b["extra"] = 1
        elif kind == 4:
            del b["scores"]
        out.append((a, b))
    return out


def test_parity_helpers_match_jax():
    rng = np.random.default_rng(0)
    assert TDep.PARITY_EXCLUDED_FIELDS == JDep.PARITY_EXCLUDED_FIELDS
    seen = set()
    for a, b in _payloads(rng):
        got = TDep.payloads_equal(a, b)
        assert got == JDep.payloads_equal(a, b)
        assert sorted(TDep.comparable_payload(a)) == sorted(JDep.comparable_payload(a))
        seen.add(got)
    assert seen == {True, False}


def _golden(rng, n_images=3, classes=(1, 2)):
    gt = {}
    for c in classes:
        gt[c] = {}
        for i in range(n_images):
            m = int(rng.integers(0, 3))
            xy = rng.uniform(0, 40, (m, 2))
            gt[c][str(i)] = {"boxes": np.concatenate([xy, xy + rng.uniform(4, 20, (m, 2))], 1)
                             .astype(np.float32),
                             "difficult": rng.uniform(size=m) < 0.2}
    return {"images": [np.full((8, 8, 3), i, np.float32) for i in range(n_images)], "gt": gt}


def _infer_from(golden, rng, jitter: float, fail_on=()):
    """Detections near the golden boxes (hits, with ``jitter``), a few
    spurious boxes (misses), and an exception on ``fail_on`` images."""
    table = {}
    for i in range(len(golden["images"])):
        boxes, scores, classes = [], [], []
        for c, per_image in golden["gt"].items():
            g = per_image[str(i)]["boxes"]
            boxes.append(g + rng.normal(0, jitter, g.shape).astype(np.float32))
            scores.append(rng.uniform(0.3, 1, len(g)))
            classes.append(np.full(len(g), c))
            boxes.append(rng.uniform(0, 60, (1, 4)).astype(np.float32))
            scores.append(rng.uniform(0, 0.3, 1))
            classes.append(np.full(1, c))
        table[i] = {"boxes": np.concatenate(boxes), "scores": np.concatenate(scores),
                    "classes": np.concatenate(classes)}

    def infer(img):
        i = int(img[0, 0, 0])
        if i in fail_on:
            raise RuntimeError("dead side")
        return table[i]

    return infer


def test_golden_map_matches_jax():
    rng = np.random.default_rng(1)
    maps = []
    for case in range(6):
        golden = _golden(rng)
        infer = _infer_from(golden, rng, jitter=(0.0, 1.0, 8.0)[case % 3],
                            fail_on=(1,) if case >= 3 else ())
        got = TDep.golden_map(infer, golden)
        assert got == JDep.golden_map(infer, golden)
        assert TDep.golden_map(infer, golden, 0.7) == JDep.golden_map(infer, golden, 0.7)
        maps.append(got)
    assert max(maps) == pytest.approx(1.0) and min(maps) < 0.9
    dead = _infer_from(_golden(rng, 1), rng, 0.0, fail_on=(0,))
    assert TDep.golden_map(dead, _golden(rng, 1)) is JDep.golden_map(dead, _golden(rng, 1)) is None
    assert TDep.golden_map(dead, {"images": [], "gt": {}}) is None


# -- restore_raw and the manifest on a damaged newest step ----------------------------------


def _damaged(api, d, how):
    rng = np.random.default_rng(2)
    trees = [{"w": np.full((64,), float(s), np.float32),
              "b": rng.standard_normal(1000).astype(np.float32)} for s in (1, 2)]
    for s, tree in zip((1, 2), trees):
        api.save(d, s, tree)
    if api is JAX:
        JCk.flush_checkpoints(d)
    m = api.ckpt.read_manifest(d, 2)
    rel = max(m["files"], key=lambda r: m["files"][r]["bytes"])
    full = os.path.join(JCk._step_dir(d, 2) if api is JAX else TCk.step_dir(d, 2), rel)
    if how == "flipped":
        with open(full, "r+b") as f:
            b = bytearray(f.read())
            b[len(b) // 2] ^= 0xFF
            f.seek(0)
            f.write(bytes(b))
    elif how == "truncated":
        with open(full, "rb") as f:
            b = f.read()
        with open(full, "wb") as f:
            f.write(b[: len(b) // 2])
    else:
        os.remove(api.ckpt.manifest_path(d, 2))
    ok, reason = api.ckpt.verify_manifest(d, 2)
    tree = api.ckpt.restore_raw(d)
    weights = tree["variables"] if api is JAX else tree["model"]
    try:
        api.ckpt.restore_raw(d, step=2)
        explicit = "restored"
    except Exception:  # noqa: BLE001 - an explicit step raises, by name per package
        explicit = "raised"
    return dict(ok=ok, reason=reason.split(":")[0], step=int(tree["step"]),
                w0=float(np.asarray(weights["w"])[0]), explicit=explicit)


@pytest.mark.parametrize("how", ["flipped", "truncated", "no_manifest"])
def test_restore_raw_walks_back_as_jax(how, tmp_path):
    got = {api.name: _damaged(api, str(tmp_path / api.name), how) for api in (JAX, PORT)}
    assert got["port"] == got["jax"]
    want = {"flipped": (False, "file_checksum_mismatch", 2, "restored"),
            "truncated": (False, "file_checksum_mismatch", 1, "raised"),
            "no_manifest": (False, "manifest_missing", 2, "restored")}[how]
    r = got["port"]
    assert (r["ok"], r["reason"], r["step"], r["explicit"]) == want
    assert r["w0"] == float(r["step"])


def test_restore_raw_of_an_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TCk.restore_raw(str(tmp_path))


def test_weights_payload_is_the_deployer_variables(tmp_path):
    """A weights-only checkpoint round-trips to the ``state_dict`` the
    Deployer hands ``swap_weights``, its manifest and tree CRC intact."""
    sd = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3), "a.bias": np.ones(2)}
    d = str(tmp_path)
    TCk.save_checkpoint(d, TCk.weights_payload(4, sd))
    assert TCk.verify_manifest(d, 4) == (True, "ok")
    tree = TCk.restore_raw(d, step=4)
    assert TCk.tree_crc(tree) == TCk.read_manifest(d, 4)["tree_crc"]
    dep = TDep.Deployer(types.SimpleNamespace(generation=0), d)
    got = dep._variables_of(tree)
    assert sorted(got) == sorted(sd)
    assert all(np.array_equal(got[k].numpy(), sd[k]) for k in sd)
    assert dep._variables_of({"params": 1}) == JDep.Deployer(
        types.SimpleNamespace(generation=0), d)._variables_of({"params": 1})


# -- the journal through the report ----------------------------------------------------------


def _jax_report_module():
    spec = importlib.util.spec_from_file_location(
        "obs_report_jax", os.path.join(REPO_ROOT, "tools", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _journaled(api, root):
    """A promote, a burn-triggered rollback and an invalid candidate,
    journaled under ``root/obs``."""
    obs_dir, d = str(root / "obs"), str(root / "ckpt")
    api.save(d, 1, TREE_A)
    api.obs.configure(obs_dir, spans=False)
    live_slo = types.SimpleNamespace(alerts=[])
    clock = ManualClock()
    fleet, _ = _weight_fleet(api)
    try:
        dep = _deployer(api, fleet, d, clock, live_slo=live_slo)
        _offer(fleet, dep, clock)
        live_slo.alerts.append({"event": "start", "slo": "availability", "burn_fast": 20.0})
        dep.check_watch()
        dep.offer(2)   # no checkpoint: manifest_missing
    finally:
        _stop(fleet)
        api.obs.close()
    return obs_dir


def test_journal_replays_to_the_same_deploy_timeline(tmp_path):
    timelines = {}
    for api, build in ((JAX, _jax_report_module().build_report), (PORT, TReport.build_report)):
        report, _ = build(_journaled(api, tmp_path / api.name))
        timelines[api.name] = [(e["kind"], e["payload"]) for e in report["incident_timeline"]
                               if e["kind"].startswith("deploy_")]
    assert timelines["port"] == timelines["jax"]
    assert [k for k, _ in timelines["port"]] == [
        "deploy_candidate", "deploy_shadow_start", "deploy_shadow_verdict", "deploy_promote",
        "deploy_rollback", "deploy_candidate", "deploy_reject"]
    assert timelines["port"][-1][1]["reason"] == "manifest_missing"


# -- the config's reader ------------------------------------------------------------------


DEPLOY_SETS = ["ctrl.deploy.poll_s=0.7", "ctrl.deploy.mirror_rate=0.5",
               "ctrl.deploy.min_mirrored=5", "ctrl.deploy.shadow_window_s=12",
               "ctrl.deploy.map_drop=0.02", "ctrl.deploy.watch_window_s=30",
               "ctrl.deploy.burn_fast_s=3", "ctrl.deploy.burn_slow_s=9",
               "ctrl.deploy.burn_factor=4", "ctrl.deploy.availability_target=0.9",
               "ctrl.deploy.latency_target=0.8", "ctrl.deploy.latency_threshold_s=2.5"]
KNOBS = {"poll_s": "poll_s", "mirror_rate": "mirror_rate", "min_mirrored": "min_mirrored",
         "shadow_window_s": "shadow_window_s", "map_drop": "map_drop",
         "watch_window_s": "watch_window_s", "slo_fast_s": "burn_fast_s",
         "slo_slow_s": "burn_slow_s", "slo_burn_factor": "burn_factor",
         "availability_target": "availability_target", "latency_target": "latency_target",
         "latency_threshold_s": "latency_threshold_s"}


def _settings(dep) -> dict:
    return {k: getattr(dep, k) for k in (*KNOBS, "mirror_timeout_s", "golden", "ckpt_dir")}


@pytest.mark.parametrize("sets", [[], DEPLOY_SETS], ids=["defaults", "set_list"])
def test_build_deployer_reads_every_deploy_field(sets, tmp_path):
    got = {}
    for api in (JAX, PORT):
        cfg = api.cfg.apply_overrides(api.cfg.get_config("tiny_synthetic"), sets)
        dep = api.ctrl.build_deployer(cfg, types.SimpleNamespace(), ckpt_dir=str(tmp_path))
        for knob, field in KNOBS.items():
            assert getattr(dep, knob) == getattr(cfg.ctrl.deploy, field), knob
        over = api.ctrl.build_deployer(cfg, types.SimpleNamespace(), ckpt_dir=str(tmp_path),
                                       mirror_rate=1.0, min_mirrored=2)
        assert (over.mirror_rate, over.min_mirrored) == (1.0, 2)
        got[api.name] = (_settings(dep), _settings(over))
    assert got["port"] == got["jax"]
    fields = {f.name for f in dataclasses.fields(TCfg.DeployConfig)}
    assert fields - {"enabled"} == set(KNOBS.values())
