"""The deployment slice whole on ``tiny_synthetic``: the port's ``Deployer``
over the port's ``build_fleet`` against the JAX package's over JAX's, on
the CPU.

The weights are ``test_torch_fleet_slice``'s two flax trees (a seeded
tree, and the same with every float leaf scaled by a seeded 1 + 0.05
N(0, 1)); the port's ``state_dict`` comes from each through
``weights.py::from_jax_variables``.  Each package writes its own
checkpoints of them: step 1 the served tree (a clean candidate), step 2 the
scaled one (a divergent candidate).  JAX's fleet (one replica, its runners
warming ``full`` only) and the port's (two replicas, ``device="cpu"``)
each run ``offer(1)`` then ``offer(2)`` under three mirrored requests a
shadow (``mirror_rate=1.0``, submitted once the mirror is installed), and
serve four requests after each:

* both promote step 1 under generation 1 and reject step 2 for parity
  under generation 2, which no response ever carries;
* every served response holds JAX's detections within 1e-5 in score and
  1e-3 px, and every port response is bitwise the port runner's on the
  served weights (the candidate's, after the promote).

JAX's shadow runner shares the live runner's jitted programs (the weights
are their argument), so ``full`` compiles once; the two packages' stories
run at once, the port's on a thread of its own.  Everything started is
stopped in a ``finally``; every wait is bounded (10 s).
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import pytest

from mx_rcnn_tpu import obs as JO
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.ctrl import deploy as JDep
from mx_rcnn_tpu.serve import engine as JEng
from mx_rcnn_tpu.serve import fleet as JF
from mx_rcnn_tpu.train import checkpoint as JCk
from mx_rcnn_tpu_torch import obs as TO
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.ctrl import deploy as TDep
from mx_rcnn_tpu_torch.serve import engine as TEng
from mx_rcnn_tpu_torch.serve import fleet as TF
from mx_rcnn_tpu_torch.train import checkpoint as TCk
from mx_rcnn_tpu_torch.weights import from_jax_variables
from test_torch_deploy import ManualClock, Mirrored, mirrored_image
from test_torch_fleet_slice import BUCKET, _FullOnlyRunner, _images, _matches_jax, _same, _trees

WAIT = 10.0


def _deployer(dep_mod, fleet, ckpt_dir, clock, **kw):
    return dep_mod.Deployer(fleet, ckpt_dir, clock=clock, mirror_rate=1.0, min_mirrored=3,
                            shadow_window_s=10.0, mirror_timeout_s=8.0, slo_fast_s=2.0,
                            slo_slow_s=6.0, watch_window_s=60.0, **kw)


def _story(fleet, dep, clock, images) -> dict:
    """offer(1) then offer(2), each under three mirrored requests, and four
    requests served after each: the decisions, and (image, response) of
    every served request."""
    served, outs = [], []
    for step in (1, 2):
        with Mirrored(fleet, dep, clock, 3) as traffic:
            out = dep.offer(step)
        served += [(mirrored_image(i), r) for i, r in enumerate(traffic.results())]
        served += [(img, fleet.submit(img, timeout=WAIT).result(WAIT)) for img in images]
        v = out.get("verdict")
        outs.append({"step": step, "outcome": out["outcome"], "reason": out["reason"]
                     if "reason" in out else v.reason, "generation": v.generation,
                     "mirrored": v.mirrored, "compared": v.compared,
                     "mismatched": v.mismatched > 0, "fleet_generation": fleet.generation})
    return {"outs": outs, "served": served,
            "kinds": [h["kind"] for h in dep.history]}


class _SharedProgramsRunner(_FullOnlyRunner):
    """JAX's runner warming ``full`` only, whose jitted programs (the
    weights are their argument, not a constant) are the first instance's,
    on the first device: the shadow's ``full`` compiles once, with the live
    replica's (``build_fleet`` would put replica ``rid`` on the test mesh's
    device ``rid % 8``, and a program compiles again for every device)."""

    programs = None

    def __init__(self, *args, **kw):
        import jax

        kw["device"] = jax.devices()[0]
        super().__init__(*args, **kw)
        if _SharedProgramsRunner.programs is None:
            _SharedProgramsRunner.programs = self._steps
        self._steps = _SharedProgramsRunner.programs


def _jax_story(jdir, trees, images) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEng, "DetectorRunner", _SharedProgramsRunner)
        mp.setattr(_SharedProgramsRunner, "programs", None)
        fleet = JF.build_fleet(jax_get_config("tiny_synthetic"), trees[0], n_replicas=1,
                               buckets=[BUCKET], batch_size=1, supervisor_poll=0.05)
        try:
            fleet.start()
            clock = ManualClock()
            return _story(fleet, _deployer(JDep, fleet, jdir, clock), clock, images)
        finally:
            fleet.stop(timeout=WAIT)


def _port_story(cfg, tdir, trees, images) -> dict:
    sds = [from_jax_variables(t) for t in trees]
    for step, sd in ((1, sds[0]), (2, sds[1])):
        TCk.save_checkpoint(tdir, TCk.weights_payload(step, sd))
    fleet = TF.build_fleet(cfg, sds[0], n_replicas=2, buckets=[BUCKET], batch_size=1,
                           device="cpu", supervisor_poll=0.05)
    try:
        fleet.start()
        clock = ManualClock()
        story = _story(fleet, _deployer(TDep, fleet, tdir, clock), clock, images)
    finally:
        fleet.stop(timeout=WAIT)
    runner = TEng.DetectorRunner(cfg, sds[0], buckets=[BUCKET], batch_size=1, device="cpu")
    runner.warmup()
    story["oracle"] = [runner.run("full", BUCKET, [img])[0] for img, _ in story["served"]]
    return story


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """Both stories at once, each package writing its own checkpoints, the
    port's on a thread of its own (nothing is shared): the JAX side's
    compiles overlap the port's CPU work."""
    trees = _trees()
    images = _images()
    root = tmp_path_factory.mktemp("deploy_slice")
    jdir, tdir = str(root / "jax"), str(root / "port")
    cfg = get_config("tiny_synthetic")
    JO.reset()
    TO.reset()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port_f = pool.submit(_port_story, cfg, tdir, trees, images)
            for step, tree in ((1, trees[0]), (2, trees[1])):
                JCk.save_checkpoint(jdir, {"step": step, "variables": tree}, manifest=True)
            JCk.flush_checkpoints(jdir)
            jax_story = _jax_story(jdir, trees, images)   # the longer of the two
            port_story = port_f.result(WAIT)
    finally:
        JO.reset()
        TO.reset()
    replicas = sorted({r["replica_id"] for _, r in port_story["served"]})
    return dict(jax=jax_story, port=port_story, oracle=port_story["oracle"], replicas=replicas)


def test_same_decisions_as_jax(slice_setup):
    port, jax = slice_setup["port"]["outs"], slice_setup["jax"]["outs"]
    assert port == jax
    assert [(o["outcome"], o["reason"], o["generation"], o["fleet_generation"]) for o in port] \
        == [("promoted", "ok", 1, 1), ("rejected", "parity", 2, 1)]
    assert port[0]["mismatched"] is False and port[1]["mismatched"] is True
    assert slice_setup["port"]["kinds"] == slice_setup["jax"]["kinds"]


def _close(ours: dict, theirs: dict) -> None:
    """As many detections, each JAX detection paired with a port detection
    of its class within 1e-5 in score and 1e-3 px."""
    assert len(ours["scores"]) == len(theirs["scores"])
    free = np.ones(len(ours["scores"]), bool)
    for box, score, cls in zip(theirs["boxes"], theirs["scores"], theirs["classes"]):
        ok = free & (ours["classes"] == cls) & (np.abs(ours["scores"] - score) <= 1e-5) \
            & (np.abs(ours["boxes"] - box).max(axis=1) <= 1e-3)
        assert ok.any(), (box, score, cls)
        free[np.flatnonzero(ok)[0]] = False


def test_served_detections_match_jax(slice_setup):
    port, jax = slice_setup["port"]["served"], slice_setup["jax"]["served"]
    assert len(port) == len(jax) == 14 and slice_setup["replicas"] == [0, 1]
    for (img, ours), (jimg, theirs) in zip(port, jax):
        assert np.array_equal(img, jimg)
        assert ours["level"] == theirs["level"] == "full"
        assert ours["generation"] == theirs["generation"]
        _close(ours, theirs)
    # The fleet slice's noise images give detections aplenty.
    for (_, ours), (_, theirs) in zip(port[3:7] + port[10:], jax[3:7] + jax[10:]):
        _matches_jax(ours, theirs)


def test_every_response_is_the_served_weights_runner(slice_setup):
    served = slice_setup["port"]["served"]
    # Before the promote generation 0, after it the candidate's 1; the
    # rejected candidate's generation 2 never reaches a caller.
    assert [r["generation"] for _, r in served] == [0] * 3 + [1] * 11
    assert all(_same(r, want) for (_, r), want in zip(served, slice_setup["oracle"]))
