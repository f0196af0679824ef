"""Pure routing policy over replica views: no threads, no engines.

The port's own copy of ``mx_rcnn_tpu/serve/router.py``: the states and
every decision are the JAX package's.

The fleet (serve/fleet.py) owns replica lifecycles and locks; every
*decision* — which replica takes a request, which replica hedges it,
when a hedge should launch — lives here as pure functions over immutable
:class:`ReplicaView` snapshots, so the policy is unit-testable without a
single thread.

Replica lifecycle states (the fleet's superset of the engine's
health states — QUARANTINED is a *fleet* decision, the engine only
knows it was killed):

    READY -----> DEGRADED          (engine under pressure; still routable)
      \\            |
       \\           v
        +----> QUARANTINED ----> READY     (background rebuild succeeded)
                    |
                    v
                  DEAD                     (rebuild budget exhausted)

    READY/DEGRADED ----> RETIRING ----> (removed)   (scale-down drain:
                                        stop admitting, drain accepted
                                        work, release the device slot)

The replica-id space is SPARSE under autoscaling: retire_replica leaves
a hole and add_replica appends a fresh never-reused rid, so every policy
function here treats rids as opaque labels, never as list indices.

Routing policy: least-loaded first.  Load is ``inflight +
queue_depth`` — work accepted but not finished — with READY preferred
over DEGRADED at equal load, and the replica id as the deterministic
tiebreak.  A request with a known resolution bucket prefers replicas
that warmed that bucket (all of them, in a homogeneous fleet, but the
filter keeps heterogeneous fleets honest) and falls back to any
routable replica rather than failing.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence

READY = "ready"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
DEAD = "dead"
RETIRING = "retiring"

# States a request may be routed to.  QUARANTINED replicas are fenced
# (their engine was killed; a rebuild is in flight), RETIRING ones are
# draining toward removal (accepted work finishes, nothing new lands),
# and DEAD ones are gone for good.
ROUTABLE = frozenset({READY, DEGRADED})


class ReplicaView(NamedTuple):
    """Immutable routing snapshot of one replica."""

    rid: int
    state: str
    inflight: int
    queue_depth: int
    buckets: tuple[tuple[int, int], ...]
    generation: int


def select_replica(
    views: Sequence[ReplicaView],
    bucket: Optional[tuple[int, int]] = None,
    exclude: frozenset[int] = frozenset(),
) -> Optional[ReplicaView]:
    """Least-loaded routable replica, or None when nothing can serve.

    ``exclude`` carries the replicas a request already tried (failed
    attempts, the hedge's primary) so retries and hedges land on fresh
    hardware.
    """
    routable = [
        v for v in views if v.state in ROUTABLE and v.rid not in exclude
    ]
    if not routable:
        return None
    if bucket is not None:
        matching = [v for v in routable if tuple(bucket) in v.buckets]
        if matching:
            routable = matching
    return min(
        routable,
        key=lambda v: (
            v.inflight + v.queue_depth,
            0 if v.state == READY else 1,
            v.rid,
        ),
    )


def select_hedge(
    views: Sequence[ReplicaView],
    tried: frozenset[int],
    bucket: Optional[tuple[int, int]] = None,
) -> Optional[ReplicaView]:
    """Replica for a hedged duplicate: same policy, never a replica the
    request already runs on — a hedge onto the wedged replica is not a
    hedge."""
    return select_replica(views, bucket=bucket, exclude=tried)


def routable_views(
    views: Sequence[ReplicaView],
) -> list[ReplicaView]:
    """The subset a request could land on right now (rid-sparse safe)."""
    return [v for v in views if v.state in ROUTABLE]


def mean_load(views: Sequence[ReplicaView]) -> float:
    """Mean accepted-but-unfinished work per routable replica — the
    autoscaler's primary pressure signal (ctrl/autoscale.py).  0.0 with
    no routable replica (the supervisor's problem, not a load signal)."""
    r = routable_views(views)
    if not r:
        return 0.0
    return sum(v.inflight + v.queue_depth for v in r) / len(r)


def auto_hedge_delay(
    estimates: Mapping[str, float],
    multiplier: float = 3.0,
    floor: float = 0.05,
) -> Optional[float]:
    """Hedge-launch delay from observed latency: a multiple of the best
    (full-quality) estimate, so hedges fire for *stragglers*, not for
    the ordinary tail.  None until an estimate exists — hedging on zero
    information would double every request during warmup."""
    for lvl in ("full", "small", "full_q8", "full_q8n", "reduced",
                "proposals"):
        est = estimates.get(lvl)
        if est is not None:
            return max(floor, est * multiplier)
    return None
