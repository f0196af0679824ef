"""The port's serving engine against the JAX package's.

The scenarios of the JAX package's ``tests/test_serve.py::TestEngine`` and
``TestEngineStopDrain`` (and its packing and quota cases) run on both
engines, driven by the same fake runner (copied below) and the same
calls; the levels served, the error types and the ``stats()`` counters
must be equal, and equal to what the JAX tests expect.  Then the real
``DetectorRunner`` on ``tiny_synthetic`` with two buckets and both int8
programs: its levels and program keys are JAX's, an unwarmed program is
refused, ``swap_weights`` refuses a key or shape drift and a generation
that does not increase, and results carry the generation that served them
(and, bitwise, the weights of that generation).

Synchronization is by events and polling with short sleeps; no test waits
on a race it could lose.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
import types
from typing import Optional

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.serve import degrade as JD
from mx_rcnn_tpu.serve import engine as JEng
from mx_rcnn_tpu.serve import health as JH
from mx_rcnn_tpu.serve import tenancy as JT
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.serve import degrade as TD
from mx_rcnn_tpu_torch.serve import engine as TEng
from mx_rcnn_tpu_torch.serve import health as TH
from mx_rcnn_tpu_torch.serve import tenancy as TT
from mx_rcnn_tpu_torch.weights import init_variables

torch.set_num_threads(2)

PORT = types.SimpleNamespace(name="port", eng=TEng, CircuitBreaker=TD.CircuitBreaker,
                             health=TH, tenancy=TT)
JAX = types.SimpleNamespace(name="jax", eng=JEng, CircuitBreaker=JD.CircuitBreaker,
                            health=JH, tenancy=JT)


def _det(n=0):
    return {
        "boxes": np.zeros((n, 4), np.float32),
        "scores": np.zeros(n, np.float32),
        "classes": np.zeros(n, np.int32),
    }


class FakeRunner:
    """The JAX package's test runner (tests/test_serve.py): warm-up registers
    the program set; ``run`` on anything outside it is the bug the engine
    must never trigger."""

    def __init__(self, buckets=((64, 64), (128, 128)), batch_size=1,
                 block: Optional[threading.Event] = None, fail_modes=(),
                 delay: float = 0.0):
        self.buckets = sorted((tuple(b) for b in buckets), key=lambda b: b[0] * b[1])
        self.batch_size = batch_size
        self.block = block
        self.fail_modes = set(fail_modes)
        self.delay = delay
        self.compile_count = 0
        self.run_calls = []
        self.generation = 0
        self._warmed = set()

    def levels(self):
        out = ["full"]
        if len(self.buckets) > 1:
            out.append("small")
        out += ["reduced", "proposals"]
        return tuple(out)

    def pick_bucket(self, h, w):
        for b in self.buckets:
            if b[0] >= h and b[1] >= w:
                return b
        return self.buckets[-1]

    def smaller_bucket(self, bucket):
        i = self.buckets.index(bucket)
        return self.buckets[i - 1] if i > 0 else None

    def warmup(self):
        keys = [("full", b) for b in self.buckets]
        keys += [("reduced", self.buckets[0]), ("proposals", self.buckets[0])]
        for k in keys:
            if k not in self._warmed:
                self.compile_count += 1
                self._warmed.add(k)
        return len(self._warmed)

    def swap_weights(self, variables, generation=None):
        gen = self.generation + 1 if generation is None else int(generation)
        if gen <= self.generation:
            raise ValueError("generation must be monotonic")
        self.generation = gen
        return gen

    def run(self, mode, bucket, images):
        key = (mode, bucket)
        assert key in self._warmed, f"unwarmed program on the serving path: {key}"
        self.run_calls.append((mode, bucket, len(images)))
        if self.delay:
            time.sleep(self.delay)
        if self.block is not None:
            self.block.wait()
        if mode in self.fail_modes:
            raise RuntimeError("injected device failure")
        return [dict(_det(), generation=self.generation) for _ in images]


def _img(h, w):
    return np.zeros((h, w, 3), np.float32)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for condition")
        time.sleep(0.005)


def _err(req, timeout=10.0):
    """The request's error type name, or its level when served."""
    try:
        return req.result(timeout=timeout)["level"]
    except Exception as e:  # noqa: BLE001 - compared by type
        return type(e).__name__


COUNTERS = ("state", "served", "served_total", "shed", "deadline_missed", "failed", "hung",
            "generation", "breaker", "breaker_trips", "queue_depth", "draining")


def _counters(stats):
    return {k: stats[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# The JAX scenarios, each a function of one package's API.


def no_recompile_for_arbitrary_request_sizes(api):
    runner = FakeRunner()
    with api.eng.InferenceEngine(runner) as e:
        warm = runner.compile_count
        levels = [e.infer(_img(h, w))["level"] for h, w in
                  [(10, 10), (64, 64), (65, 64), (128, 128), (500, 300), (1, 777), (127, 3)]]
        assert runner.compile_count == warm
        return dict(levels=levels, calls=runner.run_calls, stats=_counters(e.stats()))


def small_images_use_small_bucket_program(api):
    runner = FakeRunner()
    with api.eng.InferenceEngine(runner) as e:
        e.infer(_img(32, 32))
    return dict(call=runner.run_calls[-1])


def overload_sheds_deterministically(api):
    gate = threading.Event()
    runner = FakeRunner(block=gate)
    e = api.eng.InferenceEngine(runner, max_queue=2).start()
    try:
        first = e.submit(_img(8, 8))
        _wait(lambda: e._queue.qsize() == 0 and runner.run_calls)
        queued = [e.submit(_img(8, 8)) for _ in range(2)]
        try:
            e.submit(_img(8, 8))
            shed = None
        except api.eng.Overloaded as err:
            shed = type(err).__name__
        stats = _counters(e.stats())
        gate.set()
        levels = [_err(r) for r in [first, *queued]]
    finally:
        gate.set()
        e.stop()
    return dict(shed=shed, stats=stats, levels=levels)


def expired_queue_deadline_is_typed(api):
    with api.eng.InferenceEngine(FakeRunner()) as e:
        req = e.submit(_img(8, 8), timeout=-1.0)
        out = _err(req)
        return dict(err=out, stats=_counters(e.stats()))


def open_breaker_serves_degraded(api):
    breaker = api.CircuitBreaker(failure_threshold=1, cooldown=3600)
    breaker.record_failure()
    runner = FakeRunner()
    with api.eng.InferenceEngine(runner, breaker=breaker) as e:
        level = e.infer(_img(8, 8))["level"]
        stats = _counters(e.stats())
    return dict(level=level, call=runner.run_calls[-1], stats=stats)


def latency_pressure_walks_the_ladder(api):
    with api.eng.InferenceEngine(FakeRunner()) as e:
        e.estimates.observe("full", 10.0)
        e.estimates.observe("small", 10.0)
        e.estimates.observe("reduced", 1e-4)
        return dict(level=e.infer(_img(8, 8), timeout=0.5)["level"])


def device_failure_is_typed_and_trips_breaker(api):
    breaker = api.CircuitBreaker(failure_threshold=1, cooldown=3600)
    with api.eng.InferenceEngine(FakeRunner(fail_modes={"full"}), breaker=breaker) as e:
        first = _err(e.submit(_img(8, 8)))
        state = breaker.state
        second = e.infer(_img(8, 8))["level"]
        return dict(first=first, state=state, second=second, stats=_counters(e.stats()))


def watchdog_declares_hang_and_fails_waiters(api):
    gate = threading.Event()  # never set while "hung"
    e = api.eng.InferenceEngine(FakeRunner(block=gate), hang_timeout=0.2,
                                watchdog_poll=0.02).start()
    try:
        req = e.submit(_img(8, 8))
        out = _err(req)
        stats = _counters(e.stats())
        try:
            e.submit(_img(8, 8))
            refused = None
        except api.eng.EngineUnavailable as err:
            refused = type(err).__name__
    finally:
        gate.set()  # let the stuck worker thread exit
        e.stop(timeout=2)
    return dict(err=out, stats=stats, refused=refused)


def stop_fails_pending_and_is_idempotent(api):
    e = api.eng.InferenceEngine(FakeRunner()).start()
    e.stop()
    e.stop()
    try:
        e.submit(_img(8, 8))
        refused = None
    except api.eng.EngineUnavailable as err:
        refused = str(err)
    return dict(refused=refused, stats=_counters(e.stats()))


def death_mid_batch_fails_the_batch(api):
    gate = threading.Event()
    e = api.eng.InferenceEngine(FakeRunner(block=gate), hang_timeout=300.0,
                                watchdog_poll=0.02).start()
    try:
        req = e.submit(_img(8, 8))
        _wait(lambda: e.stats()["inflight_age_s"] is not None)
        e.health.transition(api.health.DEAD, "simulated missed sweep")
        gate.set()
        assert req.wait(timeout=5.0), "request stranded after death"
        return dict(err=_err(req))
    finally:
        gate.set()
        e.stop(timeout=2)


def results_carry_weight_generation(api):
    with api.eng.InferenceEngine(FakeRunner()) as e:
        first = e.infer(_img(8, 8))["generation"]
        gen = e.swap_weights(None)
        second = e.infer(_img(8, 8))["generation"]
        return dict(gens=(first, gen, second), stats=_counters(e.stats()))


def kill_fails_inflight_and_queued(api):
    gate = threading.Event()
    runner = FakeRunner(block=gate)
    e = api.eng.InferenceEngine(runner, max_queue=4).start()
    try:
        first = e.submit(_img(8, 8))
        _wait(lambda: runner.run_calls)
        queued = e.submit(_img(8, 8))
        e.kill("drill")
        errs = [_err(first), _err(queued)]
        return dict(errs=errs, stats=_counters(e.stats()))
    finally:
        gate.set()
        e.stop(timeout=2)


def drain_flushes_accepted_then_refuses_new(api):
    gate = threading.Event()
    runner = FakeRunner(block=gate)
    e = api.eng.InferenceEngine(runner, max_queue=8).start()
    first = e.submit(_img(8, 8))
    _wait(lambda: e._queue.qsize() == 0 and runner.run_calls)
    queued = [e.submit(_img(8, 8)) for _ in range(3)]
    stopper = threading.Thread(target=e.stop, kwargs={"timeout": 10})
    stopper.start()
    _wait(lambda: e._draining)
    try:
        e.submit(_img(8, 8))
        refused = None
    except api.eng.EngineUnavailable as err:
        refused = str(err)
    gate.set()
    stopper.join(10)
    assert not stopper.is_alive()
    return dict(refused=refused, levels=[_err(r) for r in [first, *queued]])


def fast_stop_fails_queued_as_stopping(api):
    gate = threading.Event()
    runner = FakeRunner(block=gate)
    e = api.eng.InferenceEngine(runner, max_queue=8).start()
    first = e.submit(_img(8, 8))
    _wait(lambda: runner.run_calls)
    queued = e.submit(_img(8, 8))
    stopper = threading.Thread(target=e.stop, kwargs={"timeout": 5, "drain": False})
    stopper.start()
    gate.set()
    stopper.join(10)
    assert not stopper.is_alive()
    try:
        queued.result(timeout=5)
        err = None
    except api.eng.EngineUnavailable as ex:
        err = str(ex)
    return dict(err=err, first_done=first.done())


def strangers_share_one_device_call(api):
    """Packing at batch 4: requests queued behind a held call go out as one
    call, the occupancy counted (the JAX package's tests/test_batcher.py)."""
    gate = threading.Event()
    runner = FakeRunner(batch_size=4, block=gate)
    e = api.eng.InferenceEngine(runner, max_queue=16).start()
    try:
        first = e.submit(_img(8, 8))
        _wait(lambda: runner.run_calls)
        rest = [e.submit(_img(8, 8)) for _ in range(4)]
        gate.set()
        levels = [_err(r) for r in [first, *rest]]
        return dict(levels=levels, calls=runner.run_calls,
                    occupancy=e.stats()["occupancy"])
    finally:
        gate.set()
        e.stop()


def quota_exceeded_for_a_tenant(api):
    clock = [0.0]
    policy = api.tenancy.TenancyPolicy(
        api.tenancy.parse_table("a:weight=3,rate=1,burst=2;b:weight=1"),
        clock=lambda: clock[0])
    with api.eng.InferenceEngine(FakeRunner(), tenancy=policy) as e:
        served = [e.submit(_img(8, 8), tenant="a").result(5)["level"] for _ in range(2)]
        try:
            e.submit(_img(8, 8), tenant="a")
            quota = None
        except api.eng.QuotaExceeded as err:
            quota = (type(err).__name__, err.retry_after_s)
        b = [e.submit(_img(8, 8), tenant="b").result(5)["level"] for _ in range(3)]
        clock[0] += 1.0
        refill = e.submit(_img(8, 8), tenant="a").result(5)["level"]
        return dict(served=served, quota=quota, b=b, refill=refill,
                    stats=_counters(e.stats()))


SCENARIOS = {
    no_recompile_for_arbitrary_request_sizes: dict(levels=["full"] * 7),
    small_images_use_small_bucket_program: dict(call=("full", (64, 64), 1)),
    overload_sheds_deterministically: dict(shed="Overloaded", levels=["full"] * 3),
    expired_queue_deadline_is_typed: dict(err="DeadlineExceeded"),
    open_breaker_serves_degraded: dict(level="reduced", call=("reduced", (64, 64), 1)),
    latency_pressure_walks_the_ladder: dict(level="reduced"),
    device_failure_is_typed_and_trips_breaker: dict(first="ServeError", state="open",
                                                    second="reduced"),
    watchdog_declares_hang_and_fails_waiters: dict(err="EngineUnavailable",
                                                   refused="EngineUnavailable"),
    stop_fails_pending_and_is_idempotent: dict(refused="engine stopping"),
    death_mid_batch_fails_the_batch: dict(err="EngineUnavailable"),
    results_carry_weight_generation: dict(gens=(0, 1, 1)),
    kill_fails_inflight_and_queued: dict(errs=["EngineUnavailable", "EngineUnavailable"]),
    drain_flushes_accepted_then_refuses_new: dict(refused="engine stopping",
                                                  levels=["full"] * 4),
    fast_stop_fails_queued_as_stopping: dict(err="engine stopping", first_done=True),
    strangers_share_one_device_call: dict(levels=["full"] * 5),
    quota_exceeded_for_a_tenant: dict(served=["full", "full"], b=["full"] * 3, refill="full"),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=lambda f: f.__name__)
def test_engine_scenario_as_jax(scenario):
    ours, theirs = scenario(PORT), scenario(JAX)
    assert ours == theirs
    for key, want in SCENARIOS[scenario].items():
        assert ours[key] == want, key


def test_stats_details():
    """The counters the scenarios compare, at their JAX test values."""
    assert overload_sheds_deterministically(PORT)["stats"]["shed"] == 1
    assert overload_sheds_deterministically(PORT)["stats"]["state"] == TH.DEGRADED
    dog = watchdog_declares_hang_and_fails_waiters(PORT)["stats"]
    assert (dog["hung"], dog["state"]) == (1, TH.DEAD)
    packed = strangers_share_one_device_call(PORT)
    assert packed["calls"] == [("full", (64, 64), 1), ("full", (64, 64), 4)]
    assert packed["occupancy"] == {"pack": True, "batch_size": 4, "device_calls": 2,
                                   "slots_filled": 5, "mean": 0.625}
    quota = quota_exceeded_for_a_tenant(PORT)["quota"]
    assert quota[0] == "QuotaExceeded" and quota[1] > 0


def test_concurrent_submitters_lose_no_request():
    """Eight threads submit at once, with a short switch interval, into a
    packing engine: every accepted request is served exactly once, every
    refused one is counted as shed, and the slots filled add up."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runner = FakeRunner(batch_size=4)
        accepted, shed, lock = [], [0], threading.Lock()
        with TEng.InferenceEngine(runner, max_queue=32) as e:
            def client():
                for _ in range(40):
                    try:
                        req = e.submit(_img(8, 8))
                    except TEng.Overloaded:
                        with lock:
                            shed[0] += 1
                        continue
                    with lock:
                        accepted.append(req)

            threads = [threading.Thread(target=client) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads)
            levels = [r.result(30)["level"] for r in accepted]
            stats = e.stats()
    finally:
        sys.setswitchinterval(old)
    assert levels == ["full"] * len(accepted) and len(accepted) + shed[0] == 320
    assert stats["served_total"] == len(accepted) and stats["shed"] == shed[0]
    assert stats["occupancy"]["slots_filled"] == len(accepted) == sum(n for *_, n in
                                                                       runner.run_calls)


def test_the_engine_has_the_jax_signatures():
    import inspect

    for ours, theirs in ((TEng.InferenceEngine.__init__, JEng.InferenceEngine.__init__),
                         (TEng.build_engine, JEng.build_engine),
                         (TEng.InferenceEngine.stop, JEng.InferenceEngine.stop),
                         (TEng.InferenceEngine.swap_weights, JEng.InferenceEngine.swap_weights),
                         (TEng.InferenceEngine.submit, JEng.InferenceEngine.submit)):
        assert list(inspect.signature(ours).parameters) == \
            list(inspect.signature(theirs).parameters), ours.__qualname__
    sub = list(inspect.signature(TEng.InferenceEngine.submit).parameters)
    assert sub == ["self", "image", "timeout", "trace_id", "parent_span_id", "tenant"]
    assert "mode" not in inspect.signature(TEng.build_engine).parameters


class _OneLevel(FakeRunner):
    """Offers one level, so that the planner takes it whatever the estimates."""

    level = "full"

    def levels(self):
        return (self.level,)


@pytest.mark.parametrize("level", TD.LEVELS)
def test_level_program_is_the_jax_plans(level):
    """The program that serves ``level`` by ``level_program`` (which
    ``InferenceEngine._plan`` and ``serve/profile.py --level`` read) is the
    JAX engine's ``_plan``'s, for requests of every bucket and beyond the
    largest (``small`` only where a smaller bucket exists)."""
    runner = _OneLevel(buckets=((64, 64), (128, 128), (256, 256)))
    runner.level = level
    engines = [mod.InferenceEngine(runner) for mod in (TEng, JEng)]
    planned = 0
    for hw in ((50, 60), (100, 120), (200, 250), (400, 500)):
        base = runner.pick_bucket(*hw)
        if level == "small" and runner.smaller_bucket(base) is None:
            with pytest.raises(ValueError):
                TEng.level_program(runner, level, base)
            continue
        ours, theirs = (e._plan(mod.InferenceRequest(_img(*hw), 0.0, None))
                        for e, mod in zip(engines, (TEng, JEng)))
        assert tuple(ours) == tuple(theirs) == (level, *TEng.level_program(runner, level, base))
        planned += 1
    assert planned == (3 if level == "small" else 4)


# ---------------------------------------------------------------------------
# The real runner on tiny_synthetic.

BUCKETS = [(128, 128), (64, 64)]


@functools.lru_cache(maxsize=None)
def _weights(seed):
    """The config and a state_dict from ``seed`` (shared: never mutated)."""
    cfg = apply_overrides(get_config("tiny_synthetic"), ["serve.fused_middle=on"])
    sd = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    sd["box_head.cls_score.bias"][1:3] = 3.0   # detections above the threshold
    return cfg, sd


def _runner(seed=0, warm=True):
    cfg, sd = _weights(seed)
    r = TEng.DetectorRunner(cfg, sd, buckets=BUCKETS, batch_size=2, int8_head=True,
                            int8_network=True, device="cpu")
    if warm:
        r.warmup()
    return r


@pytest.fixture(scope="module")
def warmed():
    return _runner()


def _image(seed, hw=(100, 120)):
    return np.random.RandomState(seed).uniform(0, 255, (*hw, 3)).astype(np.float32)


def test_runner_levels_and_programs_are_jax(monkeypatch):
    from mx_rcnn_tpu.config import apply_overrides as jax_overrides
    from mx_rcnn_tpu.config import get_config as jax_get_config
    from mx_rcnn_tpu.serve import quantize as JQ
    from mx_rcnn_tpu_torch.weights import to_jax_variables

    ours = _runner(warm=False)
    _, sd = _weights(0)
    jcfg = jax_overrides(jax_get_config("tiny_synthetic"), ["serve.fused_middle=on"])
    # The program set does not depend on the quantized values: skip JAX's
    # eager quantization (tens of seconds of op-by-op dispatch on the CPU).
    monkeypatch.setattr(JQ, "quantize_box_head", lambda variables: {})
    monkeypatch.setattr(JQ, "quantize_network", lambda variables: {})
    theirs = JEng.DetectorRunner(jcfg, to_jax_variables(sd), buckets=BUCKETS, batch_size=2,
                                 int8_head=True, int8_network=True)
    assert ours.levels() == theirs.levels() == TD.LEVELS
    assert ours._program_keys == theirs._program_keys
    assert len(ours._program_keys) == 8
    assert ours.buckets == theirs.buckets and ours.smaller_bucket((128, 128)) == (64, 64)
    assert ours.reduced_max_detections == theirs.reduced_max_detections


def test_runner_refuses_an_unwarmed_program(warmed):
    cold = _runner(warm=False)
    with pytest.raises(TEng.EngineUnavailable, match="never warmed"):
        cold.run("full", (64, 64), [_image(0)])
    assert warmed.warmup() == 8
    for mode, bucket in (("reduced", (128, 128)), ("proposals", (128, 128)), ("masks", (64, 64)),
                         ("full", (96, 96))):
        with pytest.raises(TEng.EngineUnavailable):
            warmed.run(mode, bucket, [_image(0)])
    with pytest.raises(ValueError, match="exceeds batch_size"):
        warmed.run("full", (64, 64), [_image(0)] * 3)


def test_every_program_serves(warmed):
    img = _image(1)
    out = {(m, b): warmed.run(m, b, [img, _image(2)]) for m, b in warmed._program_keys}
    for (mode, bucket), res in out.items():
        for r in res:
            assert r["generation"] == 0
            assert r["boxes"].shape == (len(r["scores"]), 4) and np.isfinite(r["boxes"]).all()
        if mode == "reduced":
            assert max(len(r["scores"]) for r in res) <= 25
        elif mode == "proposals":
            assert all((r["classes"] == 0).all() for r in res)
        else:
            assert all(len(r["scores"]) > 0 for r in res), (mode, bucket)
    # The int8 head moves the scores a little; the int8 network a little more.
    full, q8, q8n = (out[(m, (128, 128))][0]["scores"] for m in ("full", "full_q8", "full_q8n"))
    assert abs(float(q8[0]) - float(full[0])) <= 0.05 and not np.array_equal(full, q8n)


def test_swap_weights_refuses_drift_and_stale_generation():
    r = _runner(warm=False)
    _, sd = _weights(1)
    bad_shape = dict(sd, **{"box_head.fc6.bias": torch.zeros(3)})
    bad_dtype = dict(sd, **{"box_head.fc6.bias": sd["box_head.fc6.bias"].double()})
    missing = {k: v for k, v in sd.items() if k != "rpn_head.conv.bias"}
    for variables, gen, match in ((bad_shape, None, "drift"), (bad_dtype, None, "drift"),
                                  (missing, None, "keys"), (sd, 0, "monotonic")):
        with pytest.raises(ValueError, match=match):
            r.swap_weights(variables, generation=gen)
        assert r.generation == 0
    assert r.swap_weights(sd, generation=5) == 5 and r.generation == 5
    with pytest.raises(ValueError, match="monotonic"):
        r.swap_weights(sd, generation=5)


def test_results_carry_the_generation_that_served_them():
    """Through the engine: generation 0 before the swap, 1 after it with
    other results, and 2 after swapping the first weights back, bitwise
    generation 0's results again, in every program the swap reloads or
    re-quantizes."""
    _, sd0 = _weights(0)
    _, sd1 = _weights(1)
    engine = TEng.InferenceEngine(_runner(0, warm=False))
    img = _image(3)
    programs = [("full_q8", (128, 128)), ("full_q8n", (128, 128)), ("reduced", (64, 64))]

    def serve():
        res = [engine.infer(img)] + [engine.runner.run(m, b, [img])[0] for m, b in programs]
        return [r["generation"] for r in res], [r["scores"] for r in res], res[0]

    with engine:
        gens0, first, res0 = serve()
        assert engine.swap_weights(sd1) == 1
        gens1, second, _ = serve()
        assert engine.swap_weights(sd0) == 2
        gens2, third, res2 = serve()
        assert engine.stats()["generation"] == 2
    assert (gens0, gens1, gens2) == ([0] * 4, [1] * 4, [2] * 4)
    for a, b, c in zip(first, second, third):
        np.testing.assert_array_equal(a, c)
        assert not np.array_equal(a, b)
    for k in ("boxes", "classes"):
        np.testing.assert_array_equal(res0[k], res2[k])
