"""The fleet slice whole on ``tiny_synthetic``: the port's ``build_fleet``
against the JAX package's, on the CPU.

One flax tree of weights per generation (generation 0 from a seed,
generation 1 the same tree with every float leaf scaled by a seeded 1 +
0.05 N(0, 1)); the port's ``state_dict`` comes from it through
``weights.py::from_jax_variables``.
JAX's ``build_fleet`` (one replica) and the port's (two replicas,
``device="cpu"``) serve the same requests at the 64x64 bucket:

* every port response holds JAX's detections one for one: as many, each
  JAX detection paired with a port detection of its class whose score is
  within 1e-5 and whose box is within 1e-3 px (the convolutions sum in
  another order; at this size the two agree to a few ulp).  Box for box,
  not by IoU: random heads give boxes of zero height at the image border,
  whose IoU with themselves is 0;
* every port response is bitwise the response of one port runner on the
  same weights (the per-generation oracle), whichever replica served it;
* under a client that keeps submitting, ``swap_weights`` rolls the port
  fleet to generation 1: no request fails, every response's generation
  is 0 or 1, both occur, and each equals its generation's oracle bitwise
  (and JAX's generation-1 fleet, as above).

JAX's runners warm only their ``full`` program here (a monkeypatched
``_program_keys``): requests without a deadline are served at ``full``,
and the other programs would only add compile time.  Everything started
is stopped in a ``finally``; every wait is bounded.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.parallel.plan import ExecutionPlan  # noqa: F401 - the JAX runner's, imported once
from mx_rcnn_tpu.serve import engine as JEng
from mx_rcnn_tpu.serve import fleet as JF
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.serve import engine as TEng
from mx_rcnn_tpu_torch.serve import fleet as TF
from mx_rcnn_tpu_torch.weights import from_jax_variables, init_variables, to_jax_variables

torch.set_num_threads(2)

BUCKET = (64, 64)
SIZES = ((64, 64), (50, 60), (60, 44), (40, 64))
WAIT = 10.0


def _trees() -> list:
    """Two flax trees of numpy weights for ``tiny_synthetic``: one from a
    seed, with a few classes favoured so random heads give detections, and
    the same with every float leaf scaled by a seeded 1 + 0.05 N(0, 1)."""
    sd = init_variables(get_config("tiny_synthetic").model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:3] = 3.0
    tree = to_jax_variables(sd)
    rng = np.random.RandomState(1)

    def scaled(node):
        if isinstance(node, dict):
            return {k: scaled(v) for k, v in node.items()}
        noise = rng.standard_normal(node.shape).astype(node.dtype)
        return node * (1 + 0.05 * noise)

    return [tree, scaled(tree)]


def _images() -> list:
    rng = np.random.RandomState(5)
    return [rng.uniform(0, 255, (*hw, 3)).astype(np.float32) for hw in SIZES]


class _FullOnlyRunner(JEng.DetectorRunner):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._program_keys = [k for k in self._program_keys if k[0] == "full"]


@pytest.fixture(scope="module")
def slice_setup():
    trees = _trees()
    images = _images()
    jax_results = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEng, "DetectorRunner", _FullOnlyRunner)
        fleet = JF.build_fleet(jax_get_config("tiny_synthetic"), trees[0], n_replicas=1,
                               buckets=[BUCKET], batch_size=1, supervisor_poll=0.05)
        try:
            fleet.start()
            for gen, tree in enumerate(trees):
                if gen:
                    assert fleet.swap_weights(tree) == gen
                jax_results.append([fleet.submit(img, timeout=60).result(60) for img in images])
        finally:
            fleet.stop(timeout=WAIT)
    cfg = get_config("tiny_synthetic")
    sds = [from_jax_variables(t) for t in trees]
    oracles = []
    for sd in sds:
        runner = TEng.DetectorRunner(cfg, sd, buckets=[BUCKET], batch_size=1, device="cpu")
        runner.warmup()
        oracles.append([runner.run("full", BUCKET, [img])[0] for img in images])
    return dict(cfg=cfg, sds=sds, images=images, jax=jax_results, oracles=oracles)


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores", "classes"))


def _matches_jax(ours: dict, theirs: dict) -> None:
    assert len(theirs["scores"]) > 5 and len(ours["scores"]) == len(theirs["scores"])
    free = np.ones(len(ours["scores"]), bool)
    for box, score, cls in zip(theirs["boxes"], theirs["scores"], theirs["classes"]):
        ok = free & (ours["classes"] == cls) & (np.abs(ours["scores"] - score) <= 1e-5) \
            & (np.abs(ours["boxes"] - box).max(axis=1) <= 1e-3)
        assert ok.any(), (box, score, cls)
        free[np.flatnonzero(ok)[0]] = False


def test_fleet_serves_jax_detections_through_every_replica(slice_setup):
    s = slice_setup
    fleet = TF.build_fleet(s["cfg"], s["sds"][0], n_replicas=2, buckets=[BUCKET],
                           batch_size=1, device="cpu", supervisor_poll=0.05)
    try:
        fleet.start()
        reqs = [fleet.submit(img, timeout=WAIT) for img in s["images"] * 2]
        results = [r.result(WAIT) for r in reqs]
        stats = fleet.stats()
        runners = [rep.engine.runner for rep in fleet._replicas.values()]
    finally:
        fleet.stop(timeout=WAIT)
    assert [r.device.type for r in runners] == ["cpu", "cpu"]
    assert {r["replica_id"] for r in results} == {0, 1}
    assert stats["completed"] == 8 and stats["failed"] == 0
    n = len(s["images"])
    for i, res in enumerate(results):
        assert res["level"] == "full" and res["generation"] == 0
        assert _same(res, s["oracles"][0][i % n])
        _matches_jax(res, s["jax"][0][i % n])
    for ours, theirs in zip(s["oracles"][1], s["jax"][1]):
        _matches_jax(ours, theirs)


def test_rolling_swap_under_load_matches_each_generation(slice_setup):
    s = slice_setup
    n = len(s["images"])
    fleet = TF.build_fleet(s["cfg"], s["sds"][0], n_replicas=2, buckets=[BUCKET],
                           batch_size=1, device="cpu", supervisor_poll=0.05)
    accepted, stop = [], threading.Event()

    def client():
        i = 0
        while not stop.is_set() and i < 200:
            req = fleet.submit(s["images"][i % n], timeout=WAIT)
            accepted.append((i % n, req))
            req.wait(WAIT)
            i += 1

    thread = threading.Thread(target=client, daemon=True)
    try:
        fleet.start()
        thread.start()
        while len(accepted) < 2 and thread.is_alive():
            threading.Event().wait(0.01)
        gen = fleet.swap_weights(s["sds"][1])
        tail = len(accepted) + 3
        while len(accepted) < tail and thread.is_alive():
            threading.Event().wait(0.01)
        stop.set()
        thread.join(WAIT)
        results = [(i, req.result(WAIT)) for i, req in accepted]
        stats = fleet.stats()
        after = [fleet.submit(img, timeout=WAIT).result(WAIT) for img in s["images"]]
    finally:
        stop.set()
        fleet.stop(timeout=WAIT)
    assert gen == 1 and not thread.is_alive()
    assert stats["failed"] == 0 and stats["completed"] == len(accepted)
    gens = [res["generation"] for _, res in results]
    assert set(gens) == {0, 1}
    for i, res in results:
        assert _same(res, s["oracles"][res["generation"]][i])
    for i, res in enumerate(after):
        assert res["generation"] == 1 and _same(res, s["oracles"][1][i])
        _matches_jax(res, s["jax"][1][i])


def test_no_card_and_no_cpu_request_raises(slice_setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.build_fleet(slice_setup["cfg"], slice_setup["sds"][0], n_replicas=1)
