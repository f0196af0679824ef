"""The port's result cache (``serve/result_cache.py``) against the JAX
package's.

* ``content_key``: the same hex digest string as JAX's for the same numpy
  image, over dtypes and shapes; a non-contiguous view keys as its
  contiguous copy in both; a CPU ``torch.Tensor`` keys as its numpy array
  (JAX returns None for anything that is not an ndarray, so there the
  port's key is held against JAX's key of the array); what cannot key
  gives None in both.
* ``ResultCache``: one seeded script of lookups, coalescing, settlements
  (results and errors), invalidations and follower views drives both
  caches; every return value, ``stats()`` after every step and the
  ``serve_cache_*`` metrics at the end are equal.  Exact: host Python.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from mx_rcnn_tpu import obs as JO
from mx_rcnn_tpu.serve import result_cache as JC
from mx_rcnn_tpu_torch import obs as TO
from mx_rcnn_tpu_torch.serve import result_cache as TC


@pytest.fixture(autouse=True)
def _fresh_planes():
    JO.reset()
    TO.reset()
    yield
    JO.reset()
    TO.reset()


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float64, np.int32])
def test_content_key_is_jax_digest(dtype):
    rng = np.random.RandomState(3)
    for shape in ((8, 8), (17, 5, 3), (64, 48, 3), (1, 1, 1)):
        img = (rng.uniform(0, 255, shape)).astype(dtype)
        key = TC.content_key(img)
        assert key == JC.content_key(img)
        assert key.startswith(f"{np.dtype(dtype)}:{shape}:")
        flipped = img.copy()
        flipped.flat[0] += 1
        assert TC.content_key(flipped) != key


def test_non_contiguous_and_tensor_images_key_as_contiguous_numpy():
    rng = np.random.RandomState(4)
    base = rng.uniform(0, 255, (40, 60, 3)).astype(np.float32)
    views = [base[::2], base[:, ::-1], base.transpose(1, 0, 2), np.asfortranarray(base)]
    for v in views:
        want = JC.content_key(np.ascontiguousarray(v))
        assert TC.content_key(v) == JC.content_key(v) == want
        assert TC.content_key(torch.from_numpy(np.ascontiguousarray(v))) == want
    # A tensor view that is not contiguous keys as its contiguous copy.
    t = torch.from_numpy(base).permute(1, 0, 2)
    assert not t.is_contiguous()
    assert TC.content_key(t) == JC.content_key(np.ascontiguousarray(base.transpose(1, 0, 2)))
    assert TC.content_key(torch.from_numpy(base.astype(np.uint8))) == \
        JC.content_key(base.astype(np.uint8))


def test_unkeyable_requests_give_none():
    for bad in (np.zeros(5, np.float32), np.float32(1.0), [[1, 2], [3, 4]], "image", None):
        assert TC.content_key(bad) is None and JC.content_key(bad) is None
    assert TC.content_key(torch.zeros(4, 4, dtype=torch.bfloat16)) is None
    assert TC.content_key(torch.zeros(4)) is None


def test_capacity_must_be_positive():
    for mod in (TC, JC):
        with pytest.raises(ValueError, match="capacity"):
            mod.ResultCache(capacity=0)


def _result(rng, level):
    n = rng.randrange(4)
    return {"boxes": np.arange(4 * n, dtype=np.float32).reshape(n, 4) + rng.randrange(9),
            "scores": np.linspace(0, 1, n, dtype=np.float32), "level": level,
            "generation": 0, "latency_s": rng.random(), "replica_id": rng.randrange(3),
            "cached": False}


def _plain(x):
    """A comparable form of a return value (arrays as lists)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    return x


@pytest.mark.parametrize("seed", range(4))
def test_cache_script_equals_jax(seed):
    rng = random.Random(seed)
    keys = [f"float32:(8, 8, 3):{k}" for k in range(5)]
    levels = ("full", "small", "reduced", "proposals")
    caches = (TC.ResultCache(capacity=3), JC.ResultCache(capacity=3))
    next_req = 0
    for step in range(400):
        op = rng.choice(("lookup", "lookup", "coalesce", "settle", "settle_err", "invalidate",
                         "follower"))
        ckey, gen = rng.choice(keys), rng.randrange(3)
        if op == "lookup":
            got = [c.lookup(ckey, gen) for c in caches]
        elif op == "coalesce":
            next_req += 1
            got = [c.coalesce(ckey, gen, next_req) for c in caches]
        elif op in ("settle", "settle_err"):
            res = _result(rng, rng.choice(levels)) if op == "settle" else None
            got = [c.settle(ckey, gen, res) for c in caches]
        elif op == "invalidate":
            got = [c.invalidate_below(gen) for c in caches]
        else:
            res = _result(rng, rng.choice(levels))
            got = [c.follower_view(res) for c in caches]
        assert _plain(got[0]) == _plain(got[1]), (step, op)
        assert caches[0].stats() == caches[1].stats(), (step, op)
    names = ("serve_cache_hits_total", "serve_cache_coalesced_total",
             "serve_cache_evictions_total", "serve_cache_size")
    ours, theirs = TO.registry().snapshot(), JO.registry().snapshot()
    assert {n: ours.get(n) for n in names} == {n: theirs.get(n) for n in names}
    assert ours["serve_cache_hits_total"][""] > 0 and caches[0].stats()["evictions"] > 0


def test_hit_returns_the_leaders_arrays_stamped_cached():
    cache = TC.ResultCache(capacity=2)
    res = {"boxes": np.ones((2, 4), np.float32), "level": "full", "latency_s": 0.1,
           "replica_id": 1, "generation": 0}
    assert not cache.coalesce("k", 0, "leader")
    assert cache.coalesce("k", 0, "follower")
    assert cache.settle("k", 0, res) == ["follower"]
    hit = cache.lookup("k", 0)
    assert hit["boxes"] is res["boxes"] and hit["cached"] is True
    assert "latency_s" not in hit and "replica_id" not in hit
    assert cache.lookup("k", 1) is None
    view = cache.follower_view(res)
    assert view["coalesced"] is True and view["boxes"] is res["boxes"]
