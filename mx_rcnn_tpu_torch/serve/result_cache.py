"""Content-addressed detection result cache + in-flight coalescing.

The port's own copy of ``mx_rcnn_tpu/serve/result_cache.py``: the key,
the LRU and the coalescing registry are the JAX package's; a request
image that arrives as a CPU ``torch.Tensor`` keys as its numpy array.

The serving router (serve/fleet.py) consults this
BEFORE any replica/host is chosen, so a duplicate image never touches a
device at all — the output-side application of the ``data/cache.py`` /
compile-cache keying discipline: content-address the inputs, version the
producer, and a stale entry can then never alias a fresh one.

**Key schema.**  A cached response is identified by three coordinates:

* ``content key`` — ``"{dtype}:{shape}:{crc32(image bytes)}"`` over the
  request's raw pixel buffer (same ``mem:`` fingerprint idiom as the
  data cache).  Dtype/shape ride the key so a reinterpreted buffer with
  an equal CRC cannot alias.
* ``generation`` — the router's weight generation at admission.  A
  weight roll bumps the generation, so every cached response is
  entirely-one-generation by construction; ``invalidate_below`` is
  memory hygiene, not a correctness mechanism.
* ``degrade level`` — the level that produced the response (a
  ``reduced`` answer must never masquerade as ``full``).  Lookups scan
  levels best-quality-first and return the best cached answer for the
  image at the current generation.

**Hit contract.**  A hit returns the stored response dict with the SAME
array objects a cold call latched (responses are treated immutable
everywhere in serve/), so a cache hit is bitwise-identical to the cold
call that populated it; only per-call metadata (``replica_id``/
``host_id``, ``latency_s``) is stripped at insert, and hits are stamped
``cached=True`` so callers can tell the difference.

**Coalescing.**  Identical in-flight requests dedup the same way hedges
already do — first completion wins, one device call serves everyone.
The first admission of a (content, generation) pair becomes the
*leader* and is placed normally; later identical admissions register as
*followers* and latch whatever the leader latches (result OR error —
a failed leader fails its followers, and failures are never cached).

Counters: ``serve_cache_hits_total`` / ``serve_cache_coalesced_total``
/ ``serve_cache_evictions_total`` + the ``serve_cache_size`` gauge
(obs/report.py folds them into the report).
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.serve.degrade import LEVELS

# Per-call metadata that must not ride a cached response: it describes
# the cold call's placement, not the image's answer.
_VOLATILE_FIELDS = ("latency_s", "replica_id", "host_id", "cached")


def content_key(image) -> Optional[str]:
    """CRC32 content fingerprint of one request image (None when the
    request is neither an ndarray nor a tensor numpy can hold — those
    never cache).  A tensor keys as its numpy array on the host, so the
    same pixels key the same whichever form they arrive in."""
    if isinstance(image, torch.Tensor):
        try:
            image = image.detach().cpu().numpy()
        except TypeError:  # a dtype numpy lacks (bfloat16)
            return None
    if not isinstance(image, np.ndarray) or image.ndim < 2:
        return None
    buf = image if image.flags.c_contiguous else np.ascontiguousarray(image)
    return f"{image.dtype}:{image.shape}:{zlib.crc32(buf.tobytes())}"


class _Inflight:
    __slots__ = ("leader", "followers")

    def __init__(self, leader) -> None:
        self.leader = leader
        self.followers: list = []


class ResultCache:
    """LRU response cache + in-flight coalescing registry.

    Thread-safe; pure host-side bookkeeping (no device state), so
    one instance is shared by a router and every watcher/callback thread
    that settles requests through it.
    """

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError("result cache capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # (content_key, generation, level) -> response dict, LRU order.
        self._entries: OrderedDict[tuple, dict] = OrderedDict()
        # (content_key, generation) -> _Inflight (leader + followers).
        self._inflight: dict[tuple, _Inflight] = {}
        self._hits = 0
        self._misses = 0
        self._coalesced = 0
        self._evictions = 0
        self._inserts = 0

    # -- lookup / admission -------------------------------------------------

    def lookup(self, ckey: str, generation: int) -> Optional[dict]:
        """Best-quality cached response for (image, generation), or None.
        A hit refreshes LRU recency and returns a shallow copy stamped
        ``cached=True`` — the arrays are the cold call's own objects."""
        with self._lock:
            for level in LEVELS:
                entry = self._entries.get((ckey, generation, level))
                if entry is not None:
                    self._entries.move_to_end((ckey, generation, level))
                    self._hits += 1
                    out = dict(entry)
                    break
            else:
                self._misses += 1
                return None
        obs.counter(
            "serve_cache_hits_total",
            "result-cache hits served without a device call",
        ).inc()
        out["cached"] = True
        return out

    def coalesce(self, ckey: str, generation: int, request) -> bool:
        """Join an identical in-flight request, or become its leader.

        Returns True when ``request`` was registered as a FOLLOWER of an
        in-flight leader (the caller must NOT place it — it latches when
        the leader settles); False when ``request`` is now the leader
        for this (content, generation) and must be placed normally."""
        with self._lock:
            inflight = self._inflight.get((ckey, generation))
            if inflight is None:
                self._inflight[(ckey, generation)] = _Inflight(request)
                return False
            inflight.followers.append(request)
            self._coalesced += 1
        obs.counter(
            "serve_cache_coalesced_total",
            "identical in-flight requests coalesced onto one device call",
        ).inc()
        return True

    # -- settlement ---------------------------------------------------------

    def settle(self, ckey: str, generation: int,
               result: Optional[dict]) -> list:
        """Leader finished: insert its response (success only — errors
        are never cached) and release the followers for the caller to
        latch.  Idempotent per (content, generation): a second settle
        returns no followers."""
        with self._lock:
            inflight = self._inflight.pop((ckey, generation), None)
            followers = inflight.followers if inflight is not None else []
            if result is not None:
                entry = {
                    k: v for k, v in result.items()
                    if k not in _VOLATILE_FIELDS
                }
                level = entry.get("level", "full")
                self._entries[(ckey, generation, level)] = entry
                self._entries.move_to_end((ckey, generation, level))
                self._inserts += 1
                evicted = 0
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    evicted = evicted + 1
                    self._evictions += 1
            else:
                evicted = 0
            size = len(self._entries)
        if evicted:
            obs.counter(
                "serve_cache_evictions_total", "LRU result-cache evictions"
            ).inc(evicted)
        obs.gauge(
            "serve_cache_size", "resident result-cache entries"
        ).set(size)
        return followers

    def follower_view(self, result: dict) -> dict:
        """A follower's copy of the leader's latched response: same
        arrays (bitwise-identical by construction), per-call metadata
        kept — the follower DID ride that device call."""
        out = dict(result)
        out["coalesced"] = True
        return out

    # -- invalidation / introspection --------------------------------------

    def invalidate_below(self, generation: int) -> int:
        """Drop entries older than ``generation`` (weight roll hygiene;
        generation-keyed lookups already can't see them)."""
        with self._lock:
            stale = [
                k for k in self._entries if k[1] < generation
            ]
            for k in stale:
                del self._entries[k]
            size = len(self._entries)
        obs.gauge(
            "serve_cache_size", "resident result-cache entries"
        ).set(size)
        return len(stale)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "size": len(self._entries),
                "hits": self._hits,
                "misses": self._misses,
                "coalesced": self._coalesced,
                "inserts": self._inserts,
                "evictions": self._evictions,
            }
