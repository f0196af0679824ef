"""The port's fleet routing policy (``serve/router.py``) against the JAX
package's, decision for decision.

Seeded random sets of ``ReplicaView`` (every state, sparse replica ids,
buckets a replica did and did not warm, ties in load) go through
``select_replica``, ``select_hedge``, ``routable_views``, ``mean_load``
and ``auto_hedge_delay`` in both packages: exactly equal.  The cases of
the JAX package's ``tests/test_serve.py::TestRouterPolicy`` then run on
the port with JAX's expectations.  Pure functions: no threads, no clock.
"""

from __future__ import annotations

import random

import pytest

from mx_rcnn_tpu.serve import router as JR
from mx_rcnn_tpu_torch.serve import router as TR

STATES = (TR.READY, TR.DEGRADED, TR.QUARANTINED, TR.DEAD, TR.RETIRING)
BUCKETS = ((64, 64), (128, 128), (96, 160))


def _views(mod, rng: random.Random, n: int) -> list:
    """``n`` views on sparse, shuffled rids; loads drawn small so ties
    happen and the READY-before-DEGRADED and rid tie-breaks decide."""
    rids = rng.sample(range(40), n)
    out = []
    for rid in rids:
        warmed = tuple(b for b in BUCKETS if rng.random() < 0.6)
        out.append(mod.ReplicaView(
            rid=rid, state=rng.choice(STATES), inflight=rng.randrange(4),
            queue_depth=rng.randrange(3), buckets=warmed,
            generation=rng.randrange(3)))
    return out


def _as_tuple(view):
    return None if view is None else tuple(view)


def test_states_and_routable_set_are_jax():
    assert (TR.READY, TR.DEGRADED, TR.QUARANTINED, TR.DEAD, TR.RETIRING) == \
        (JR.READY, JR.DEGRADED, JR.QUARANTINED, JR.DEAD, JR.RETIRING)
    assert TR.ROUTABLE == JR.ROUTABLE == frozenset({TR.READY, TR.DEGRADED})
    assert TR.ReplicaView._fields == JR.ReplicaView._fields


@pytest.mark.parametrize("seed", range(6))
def test_policy_functions_equal_jax_on_random_views(seed):
    rng = random.Random(seed)
    for _ in range(150):
        n = rng.randrange(0, 7)
        state = rng.getstate()
        ours = _views(TR, rng, n)
        rng.setstate(state)
        theirs = _views(JR, rng, n)
        assert [tuple(v) for v in ours] == [tuple(v) for v in theirs]
        rids = [v.rid for v in ours]
        bucket = rng.choice((None, *BUCKETS, (32, 32)))
        exclude = frozenset(r for r in rids if rng.random() < 0.3)
        assert _as_tuple(TR.select_replica(ours, bucket=bucket, exclude=exclude)) == \
            _as_tuple(JR.select_replica(theirs, bucket=bucket, exclude=exclude))
        assert _as_tuple(TR.select_hedge(ours, tried=exclude, bucket=bucket)) == \
            _as_tuple(JR.select_hedge(theirs, tried=exclude, bucket=bucket))
        assert [tuple(v) for v in TR.routable_views(ours)] == \
            [tuple(v) for v in JR.routable_views(theirs)]
        assert TR.mean_load(ours) == JR.mean_load(theirs)


@pytest.mark.parametrize("seed", range(3))
def test_auto_hedge_delay_equals_jax(seed):
    rng = random.Random(100 + seed)
    levels = ("full", "small", "full_q8", "full_q8n", "reduced", "proposals", "other")
    for _ in range(200):
        est = {lvl: rng.choice((0.0, 0.001, 0.01, rng.uniform(0, 0.5)))
               for lvl in levels if rng.random() < 0.4}
        mult = rng.choice((1.0, 2.5, 3.0))
        floor = rng.choice((0.0, 0.05, 0.2))
        assert TR.auto_hedge_delay(est, multiplier=mult, floor=floor) == \
            JR.auto_hedge_delay(est, multiplier=mult, floor=floor)


# The JAX package's TestRouterPolicy cases, on the port.


def _view(rid, state=TR.READY, inflight=0, qd=0, buckets=((64, 64),), gen=0):
    return TR.ReplicaView(rid, state, inflight, qd, tuple(tuple(b) for b in buckets), gen)


def test_least_loaded_and_ready_before_degraded():
    views = [_view(0, inflight=2), _view(1, inflight=0, qd=1), _view(2, inflight=3)]
    assert TR.select_replica(views).rid == 1
    assert TR.select_replica([_view(0, state=TR.DEGRADED), _view(1)]).rid == 1
    assert TR.select_replica([_view(0, state=TR.QUARANTINED), _view(1, state=TR.DEAD)]) is None


def test_exclude_bucket_preference_and_fallback():
    views = [_view(0), _view(1, inflight=5)]
    assert TR.select_replica(views, exclude=frozenset({0})).rid == 1
    assert TR.select_replica(views, exclude=frozenset({0, 1})) is None
    views = [_view(0, buckets=((64, 64),), inflight=0),
             _view(1, buckets=((128, 128),), inflight=5)]
    assert TR.select_replica(views, bucket=(128, 128)).rid == 1
    assert TR.select_replica(views, bucket=(256, 256)).rid == 0


def test_sparse_rids_retiring_and_hedges():
    views = [_view(0, inflight=3), _view(5, inflight=1), _view(12, inflight=2)]
    assert TR.select_replica(views).rid == 5
    assert TR.select_replica(views, exclude=frozenset({5})).rid == 12
    assert TR.select_replica([_view(0, state=TR.RETIRING), _view(3, inflight=9)]).rid == 3
    views = [_view(2), _view(7, inflight=1), _view(9, state=TR.RETIRING)]
    assert TR.select_hedge(views, tried=frozenset({2})).rid == 7
    assert TR.select_hedge(views, tried=frozenset({2, 7})) is None


def test_routable_views_mean_load_and_hedge_delay():
    views = [_view(1, inflight=2, qd=2), _view(4, state=TR.RETIRING, inflight=9),
             _view(6, state=TR.DEGRADED, inflight=1, qd=1), _view(8, state=TR.QUARANTINED)]
    assert [v.rid for v in TR.routable_views(views)] == [1, 6]
    assert TR.mean_load(views) == pytest.approx(3.0)
    assert TR.mean_load([]) == 0.0
    assert TR.auto_hedge_delay({}) is None
    assert TR.auto_hedge_delay({"full": 0.1}, multiplier=3.0) == pytest.approx(0.3)
    assert TR.auto_hedge_delay({"reduced": 0.001}, floor=0.05) == pytest.approx(0.05)
