"""Continuous-batching pack policy for the serving engine.

The port's own copy of ``mx_rcnn_tpu/serve/batcher.py``.

The runner's micro-batch is a STATIC shape: every device call runs
``batch_size`` slots whether they hold one request or eight (the pad
rows are zeros the postprocess never reads).  Filling those slots with
requests from *different* callers is therefore free throughput — the
device call costs the same, the per-request latency only improves.
:class:`PackBuffer` is the policy half of that packer, deliberately
separated from the engine's queue/thread mechanics so it can be tested
standalone.

Packing rules:

* **One program per call.**  A pack shares one compiled program, i.e.
  one ``(mode, bucket)`` — the ``Plan`` minus its level name.  Mixing
  degrade levels that map to the same program (``full`` and ``small``
  never do; ``reduced`` requests always share the smallest bucket) is
  allowed and exercised by tests.
* **Deadline-aware ordering.**  The most urgent buffered request —
  earliest deadline, then earliest arrival; deadline-less requests sort
  last — picks the program, and its program-mates join it most-urgent
  first.  With no deadlines anywhere this degenerates to exact FIFO, so
  the packer composes with hedged retries (a hedge is just a second
  request, possibly landing in the same pack) and with the
  ``HysteresisPlanner`` ladder (whose per-request level choice already
  happened at plan time).
* **Anti-starvation aging.**  Deadline-first alone can starve: a
  deadline-less request on program B waits forever while deadlined
  program-A leads keep arriving.  Every request passed over by
  ``max_passovers`` consecutive packs is promoted to lead the next one,
  so FIFO degeneration is bounded — any buffered request reaches the
  device within ``max_passovers + 1`` packs of arriving
  (tests/test_torch_serve_policy.py holds it against the JAX package).
* **Weighted-fair tenant shares.**  With a :class:`TenancyPolicy`
  (serve/tenancy.py), the lead is chosen priority-class first (lower
  class drains earlier), and a tenant's slots in each pack are capped
  at its weight's share of ``batch_size`` — a flooding tenant cannot
  crowd program-mates out of the call.  Ordering *within* a tenant
  stays deadline-first, caps are work-conserving (unused share is
  refilled by urgency), and requests without a tenant fold to the
  default tenant so the single-tenant path is unchanged.
* **Bitwise identity.**  Rows in a padded micro-batch are independent
  through letterbox, the forward, and per-row postprocess, so a
  request's de-interleaved response is bitwise identical whether it
  shared its device call with seven strangers or rode alone
  (``chip_smoke.py`` phase 7f holds this on the card; cuDNN must pick
  the same algorithm for the same shape, so ``cudnn.benchmark`` stays off).

The buffer never blocks and never touches the clock on its own: the
engine feeds it admitted (planned) requests, expires it with the
engine's clock, and asks for one pack per device call.
"""

from __future__ import annotations

import math
from typing import Optional


def urgency(req) -> tuple[float, float]:
    """Sort key: earliest deadline first, arrival order among equals;
    deadline-less requests pack after every deadlined one."""
    return (
        math.inf if req.deadline is None else req.deadline,
        req.enqueued_at,
    )


class PackBuffer:
    """Planned requests awaiting a device call, packed by program.

    The engine bounds how many requests it holds out of its admission
    queue (``2 * batch_size``), so shed semantics stay predictable; the
    buffer itself is just the ordered pool those requests wait in.
    """

    def __init__(self, tenancy=None, max_passovers: int = 4) -> None:
        self._items: list = []
        self._tenancy = tenancy
        # A request passed over by this many consecutive packs leads the
        # next one.  > 1 so one urgent newcomer can still jump the line
        # (deadline-first stays the common case).
        self._max_passovers = max(2, int(max_passovers))
        self._passovers: dict[int, int] = {}  # id(req) -> packs missed

    def __len__(self) -> int:
        return len(self._items)

    def add(self, req) -> None:
        """Admit one planned request (``req.plan`` must be set)."""
        assert req.plan is not None, "PackBuffer takes PLANNED requests"
        self._items.append(req)

    def expire(self, now: float) -> list:
        """Remove and return every request whose deadline has passed —
        the engine fails them exactly as the unpacked path does."""
        expired = [
            r for r in self._items
            if r.deadline is not None and now > r.deadline
        ]
        if expired:
            self._remove(expired)
        return expired

    def _remove(self, taken: list) -> None:
        dead = set(id(r) for r in taken)
        self._items = [r for r in self._items if id(r) not in dead]
        for rid in dead:
            self._passovers.pop(rid, None)

    def _tenant_of(self, req) -> str:
        t = getattr(req, "tenant", None)
        return self._tenancy.resolve(t) if self._tenancy is not None else ""

    def _pick_lead(self):
        """Aged request first (most-starved wins); else priority class +
        urgency when tenancy is on; else pure urgency."""
        aged = [
            r for r in self._items
            if self._passovers.get(id(r), 0) >= self._max_passovers
        ]
        if aged:
            return max(
                aged,
                key=lambda r: (self._passovers[id(r)],
                               tuple(-u for u in urgency(r))),
            )
        if self._tenancy is not None:
            return min(
                self._items,
                key=lambda r: (self._tenancy.priority(self._tenant_of(r)),
                               *urgency(r)),
            )
        return min(self._items, key=urgency)

    def _fill_fair(self, lead, mates: list, batch_size: int) -> list:
        """Weighted-fair pack composition: per-tenant slot caps from the
        tenant table, priority-class order across tenants, deadline-first
        within a tenant, work-conserving second pass."""
        by_tenant: dict[str, list] = {}
        for r in [lead] + mates:
            by_tenant.setdefault(self._tenant_of(r), []).append(r)
        weights = {
            t: self._tenancy.weight(t) for t in by_tenant
        }
        total_w = sum(weights.values())
        caps = {
            t: max(1, int(math.floor(batch_size * w / total_w)))
            for t, w in weights.items()
        }
        order = sorted(
            mates,
            key=lambda r: (self._tenancy.priority(self._tenant_of(r)),
                           *urgency(r)),
        )
        group = [lead]
        used = {self._tenant_of(lead): 1}
        leftovers = []
        for r in order:
            if len(group) >= batch_size:
                break
            t = self._tenant_of(r)
            if used.get(t, 0) >= caps[t]:
                leftovers.append(r)
                continue
            group.append(r)
            used[t] = used.get(t, 0) + 1
        # Work-conserving: unfilled slots go to whoever is most urgent,
        # caps ignored — fairness never costs occupancy.
        for r in leftovers:
            if len(group) >= batch_size:
                break
            group.append(r)
        return group

    def take(self, batch_size: int) -> Optional[list]:
        """One pack: the lead request plus up to ``batch_size - 1``
        program-mates.  None when empty."""
        if not self._items:
            return None
        lead = self._pick_lead()
        key = lead.plan[1:]  # (mode, bucket) — the compiled program
        mates = sorted(
            (r for r in self._items
             if r is not lead and r.plan[1:] == key),
            key=urgency,
        )
        if self._tenancy is not None and batch_size > 1:
            group = self._fill_fair(lead, mates, batch_size)
        else:
            group = [lead] + mates[:batch_size - 1]
        self._remove(group)
        for r in self._items:  # everyone left behind aged one pack
            rid = id(r)
            self._passovers[rid] = self._passovers.get(rid, 0) + 1
        return group

    def drain(self) -> list:
        """Remove and return everything (engine shutdown/failure path)."""
        items, self._items = self._items, []
        self._passovers.clear()
        return items
