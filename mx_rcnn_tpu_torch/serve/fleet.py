"""Fleet serving: N replica engines behind one fault-isolating router.

The port's own copy of ``mx_rcnn_tpu/serve/fleet.py``: the router, its
counters, states, journal events, metrics and spans are the JAX
package's.  Two things differ: :func:`build_fleet` places replica
``rid`` on card ``rid % torch.cuda.device_count()`` (so an N-replica
fleet on one card is N engines on that card, as JAX's replicas share a
device when there are fewer chips than replicas), and a rebuild stops
the engine it replaces, so a killed engine's worker exits and its
weights leave the card.

One :class:`~mx_rcnn_tpu_torch.serve.engine.InferenceEngine` is one
failure domain: a wedged device call or a bad weight push takes down
everything behind it.  :class:`FleetRouter` runs N of them and treats
each as disposable:

* **Routing** — bucket-aware least-loaded dispatch (serve/router.py);
  every replica keeps its own circuit breaker and degrade ladder, so one
  replica under pressure degrades alone instead of dragging the fleet.
* **Hedged retry** — a request that lingers past ``hedge_after`` gets a
  duplicate on a second replica; the first result wins (idempotent
  latch), the loser is dropped.  Failed attempts retry on fresh
  replicas up to ``max_attempts``.
* **Quarantine → rebuild → reinstate** — a replica whose engine dies
  (watchdog, crash injection) or fails repeatedly is fenced
  (``engine.kill`` fails its queue fast so waiters retry elsewhere),
  rebuilt in the background from the engine factory, re-warmed, swapped
  to the fleet's current weight generation, and put back in rotation.
  ``max_rebuilds`` failures retire it to DEAD.
* **Zero-downtime weight swap** — ``swap_weights`` rolls the fleet one
  replica at a time; each replica warms the new tree on a standby
  buffer while its live buffer serves, then flips atomically
  (serve/engine.py::DetectorRunner.swap_weights).  No request ever
  executes against a half-swapped tree, and every response carries the
  ``generation`` that served it.
* **Draining shutdown** — ``drain()`` stops admitting, flushes every
  accepted request, then stops the replicas; ``serve_forever``-style
  callers pair it with SIGTERM → exit
  ``train/preemption.py::RESUMABLE_EXIT_CODE`` (75), the same
  convention the trainer uses for preemption.
* **Dynamic fleet** — ``add_replica()`` grows the set (background build
  + warmup on the rebuild machinery, aligned to the current weight
  generation) and ``retire_replica(rid)`` shrinks it (stop admitting →
  drain accepted work → release the slot), so the autoscaler
  (ctrl/autoscale.py) can resize under load.  Replica ids
  are never reused: the live set is a SPARSE dict keyed by rid, and
  every policy decision goes through rid-agnostic views
  (serve/router.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Sequence, Union

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.analysis import lockcheck
from mx_rcnn_tpu_torch.serve import result_cache as result_cache_mod
from mx_rcnn_tpu_torch.serve import tenancy as tenancy_mod
from mx_rcnn_tpu_torch.serve.engine import (
    DeadlineExceeded,
    EngineUnavailable,
    InferenceEngine,
    Overloaded,
    QuotaExceeded,
    ServeError,
)
from mx_rcnn_tpu_torch.serve.router import (
    DEAD,
    DEGRADED,
    QUARANTINED,
    READY,
    RETIRING,
    ROUTABLE,
    ReplicaView,
    auto_hedge_delay,
    select_replica,
)

log = logging.getLogger("mx_rcnn_tpu_torch.serve")


class FleetRequest:
    """A fleet-level request: one logical answer over possibly several
    replica attempts (retries, hedges).  First completion wins; the
    latch is idempotent, so a late duplicate result is dropped, never
    double-delivered."""

    def __init__(self, image, enqueued_at: float,
                 deadline: Optional[float]) -> None:
        self.image = image
        self.enqueued_at = enqueued_at
        self.deadline = deadline
        self.bucket: Optional[tuple[int, int]] = None
        # Resolved tenant name (serve/tenancy.py); None single-tenant.
        self.tenant: Optional[str] = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[dict] = None
        self._error: Optional[BaseException] = None
        self._wake = threading.Event()  # watcher wakes on sub completion
        self._attempts: list[_Attempt] = []
        # Watcher-thread-private bookkeeping (single writer):
        self._retries = 0
        self._hedged = False
        # Tracing (obs/tracing.py): the root request span; every attempt
        # span (and the engine spans under it) shares trace_id.
        self.trace_id: Optional[str] = None
        self.span = None
        # Result-cache coordinates ((content_key, generation)) when this
        # request is a cache LEADER; its done-hooks settle the cache and
        # release coalesced followers on either latch path.
        self._cache_key: Optional[tuple[str, int]] = None
        self._done_hooks: list = []

    def _run_done_hooks(self) -> None:
        for hook in list(self._done_hooks):
            try:
                hook(self)
            except Exception:  # noqa: BLE001 - hooks must not break the latch
                log.exception("fleet request done-hook failed")

    def _latch_result(self, result: dict) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self._event.set()
        if self.span is not None:
            self.span.end(outcome="ok")
        self._run_done_hooks()
        return True

    def _latch_error(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
            self._event.set()
        if self.span is not None:
            self.span.end(error=type(error).__name__)
        self._run_done_hooks()
        return True

    def tried_rids(self) -> frozenset[int]:
        with self._lock:
            return frozenset(a.rid for a in self._attempts)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._event.wait(timeout):
            raise TimeoutError("fleet request not complete")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class _Attempt:
    """One replica submission of a fleet request."""

    __slots__ = ("rid", "sub", "is_hedge", "handled", "span")

    def __init__(self, rid: int, sub, is_hedge: bool) -> None:
        self.rid = rid
        self.sub = sub
        self.is_hedge = is_hedge
        self.handled = False  # watcher-private: failure already processed
        self.span = None      # attempt span (child of the request span)


class _Replica:
    """Mutable fleet-side record for one replica slot."""

    __slots__ = ("rid", "engine", "state", "inflight", "fail_streak",
                 "rebuilds", "rebuilding", "rebuild_thread")

    def __init__(self, rid: int) -> None:
        self.rid = rid
        self.engine: Optional[InferenceEngine] = None
        self.state = QUARANTINED  # not routable until start() warms it
        self.inflight = 0
        self.fail_streak = 0
        self.rebuilds = 0
        self.rebuilding = False
        self.rebuild_thread: Optional[threading.Thread] = None


class _Mirror:
    """Shadow-canary mirroring hook (the Deployer's, ctrl/deploy.py):
    every Nth accepted
    submission's image is handed to ``fn`` out of band.  The hook only
    ever sees a copy of the input, never the caller's request result
    path, so shadow responses cannot reach callers by construction."""

    __slots__ = ("fn", "every", "fired", "_n", "_lock")

    def __init__(self, fn: Callable, rate: float) -> None:
        self.fn = fn
        self.every = max(1, int(round(1.0 / max(float(rate), 1e-6))))
        self.fired = 0
        self._n = 0
        self._lock = threading.Lock()

    def sample(self) -> bool:
        with self._lock:
            self._n += 1
            if self._n % self.every:
                return False
            self.fired += 1
            return True


class FleetRouter:
    """Router + supervisor over N replica engines.

    ``engine_factory(rid)`` builds a started-able engine for replica
    slot ``rid`` (see :func:`build_fleet` for the real wiring); the
    supervisor reuses it for background rebuilds, so a factory must be
    safe to call at any time.

    ``hedge_after`` — seconds before a still-pending request gets a
    duplicate on a second replica: a float, ``"auto"`` (3x the observed
    full-path latency, serve/router.py::auto_hedge_delay), or None to
    disable hedging.
    """

    def __init__(
        self,
        engine_factory: Callable[[int], InferenceEngine],
        n_replicas: int,
        *,
        hedge_after: Union[float, str, None] = None,
        max_attempts: int = 2,
        quarantine_failures: int = 3,
        max_rebuilds: int = 3,
        supervisor_poll: float = 0.25,
        default_timeout: Optional[float] = None,
        result_cache=None,
        initial_weights=None,
        tenancy=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self._engine_factory = engine_factory
        # Content-addressed response cache + coalescing registry
        # (serve/result_cache.py); None disables both.
        self._cache = result_cache
        # Multi-tenancy (serve/tenancy.py): the router is THE quota
        # layer — it charges each logical request's token exactly once,
        # before cache consult or placement, so retries/hedges/cache
        # hits never double-charge.  None keeps the single-tenant path
        # (and its metric series) bit-identical.
        self._tenancy = tenancy
        self.n_replicas = n_replicas
        self.hedge_after = hedge_after
        self.max_attempts = max_attempts
        self.quarantine_failures = quarantine_failures
        self.max_rebuilds = max_rebuilds
        self.supervisor_poll = supervisor_poll
        self.default_timeout = default_timeout
        self._clock = clock
        self._lock = threading.Lock()
        # Serializes weight rolls and rebuild publishes.  Held across
        # device work BY DESIGN (one roll at a time is the zero-downtime
        # invariant) — exempted from the lockcheck blocked-call rule,
        # never from its order rule.
        self._swap_lock = lockcheck.allow_blocking(threading.Lock())
        # SPARSE rid -> replica map: retire_replica leaves holes,
        # add_replica appends fresh never-reused rids.
        self._replicas: dict[int, _Replica] = {
            rid: _Replica(rid) for rid in range(n_replicas)
        }
        self._next_rid = n_replicas
        # Current tree (rebuild alignment; seeded by build_fleet so the
        # generation-0 tree is known) + the PREVIOUS generation's tree —
        # depth-2 history so deploy rollback (ctrl/deploy.py) is a local
        # re-push, never a checkpoint reload.
        self._weights = initial_weights
        self._weights_prev: Optional[tuple[int, object]] = None
        # Shadow mirror hook (ctrl/deploy.py installs one per canary).
        self._mirror: Optional[_Mirror] = None
        self._generation = 0
        self._pending = 0
        self._started = False
        self._draining = False
        self._stopped = False
        self._stop_event = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        # Fleet counters (under _lock).
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._shed = 0
        # Quota rejections are NOT sheds: the autoscaler's shed-rate
        # signal reads _shed, and a quota-capped flooder must not be
        # able to trigger a scale-up.
        self._quota = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._retries_total = 0
        self._quarantines = 0
        self._reinstatements = 0
        self._added = 0
        self._retired = 0

    # -- lifecycle ---------------------------------------------------------

    def _reps(self) -> list[_Replica]:
        """Lock-consistent snapshot of the live replica records — the
        map mutates under add/retire, so no iteration may walk it raw."""
        with self._lock:
            return list(self._replicas.values())

    def _count_outcome(self, outcome: str,
                       tenant: Optional[str] = None) -> None:
        labels = {"outcome": outcome}
        if self._tenancy is not None:
            # Folded to the bounded vocabulary; per-tenant SLOs
            # (ctrl/slo.py) filter on this label.
            labels["tenant"] = self._tenancy.label(tenant)
        obs.counter(
            "fleet_requests_total",
            "fleet requests by final outcome",
        ).inc(**labels)

    def start(self) -> "FleetRouter":
        if self._started:
            return self
        for r in self._reps():
            r.engine = self._engine_factory(r.rid)
            r.engine.start()
            r.state = READY
        self._started = True
        self._supervisor = threading.Thread(
            target=self._supervise, name="fleet-supervisor", daemon=True
        )
        self._supervisor.start()
        log.info("fleet ready: %d replicas", self.n_replicas)
        return self

    def stop(self, timeout: float = 10.0, drain: bool = True) -> None:
        if self._stopped:
            return
        self._draining = True
        self._stopped = True
        self._stop_event.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout)
        for r in self._reps():
            if r.engine is None:
                continue
            try:
                r.engine.stop(timeout=timeout, drain=drain)
            except Exception:
                log.exception("stopping replica %d failed", r.rid)
        # A rebuild caught mid-build (a runner loading its weights and
        # warming its programs on the card) cannot be interrupted; wait
        # it out rather than leave a thread launching onto a card the
        # caller is about to release.
        for r in self._reps():
            t = r.rebuild_thread
            if t is not None and t.is_alive():
                t.join(timeout)

    def drain(self, timeout: float = 30.0) -> bool:
        """Draining shutdown: stop admitting, wait for every accepted
        fleet request to complete, then stop the replicas (which flush
        their own queues).  Returns True when nothing was abandoned —
        the SIGTERM handler pairs this with exit code 75
        (train/preemption.py) so a supervisor restarts the process."""
        self._draining = True
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            with self._lock:
                if self._pending == 0:
                    break
            time.sleep(0.02)
        with self._lock:
            clean = self._pending == 0
        self.stop(timeout=max(1.0, deadline - self._clock()), drain=True)
        return clean

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API --------------------------------------------------------

    def submit(self, image, timeout: Optional[float] = None,
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None) -> FleetRequest:
        """Route one image; returns immediately.  Raises
        :class:`Overloaded` when every routable replica shed it,
        :class:`QuotaExceeded` when the caller's tenant is over its
        token-bucket quota, or :class:`EngineUnavailable` when no
        replica can serve.  ``trace_id`` stamps the request's span tree
        (loadgen passes one per synthetic request); one is minted when
        spans are recording and none was given.  ``tenant`` is the
        caller's tenancy token — unknown/absent folds to the default
        tenant (serve/tenancy.py)."""
        if not self._started:
            raise EngineUnavailable("fleet not started")
        if self._draining or self._stopped:
            raise EngineUnavailable("fleet stopping")
        if self._tenancy is not None:
            # Quota gate: ONE token per logical request, charged before
            # the cache consult and before any placement — a request
            # that will be answered from cache still spent its tenant's
            # budget, and retries/hedges below never charge again.
            tenant = self._tenancy.resolve(tenant)
            if not self._tenancy.admit(tenant):
                tlabel = self._tenancy.label(tenant)
                with self._lock:
                    self._submitted += 1
                    self._quota += 1
                self._count_outcome("quota", tenant)
                obs.counter(
                    "serve_quota_exceeded_total",
                    "requests rejected by per-tenant quota",
                ).inc(tenant=tlabel, replica="-")
                obs.emit("serve", "tenant_quota_exceeded", {
                    "tenant": tlabel, "layer": "fleet",
                }, logger=log)
                err = QuotaExceeded(f"tenant {tenant!r} over quota")
                err.retry_after_s = self._tenancy.retry_after_s(tenant)
                raise err
        now = self._clock()
        timeout = self.default_timeout if timeout is None else timeout
        freq = FleetRequest(
            image, now, None if timeout is None else now + timeout
        )
        freq.tenant = tenant
        freq.trace_id = trace_id
        if obs.spans_enabled():
            freq.span = obs.span(
                "request", subsystem="fleet", trace_id=trace_id
            )
            freq.trace_id = freq.span.trace_id
        freq.bucket = self._bucket_for(image)
        # Result cache: consulted before ANY replica is chosen.  A hit
        # completes the request without a device call; a miss with an
        # identical request already in flight coalesces onto it (one
        # device call serves everyone, like hedge first-wins dedup);
        # otherwise this request leads and settles the cache on latch.
        if self._cache is not None:
            ckey = result_cache_mod.content_key(image)
            if ckey is not None:
                with self._lock:
                    gen = self._generation
                hit = self._cache.lookup(ckey, gen)
                if hit is not None:
                    with self._lock:
                        self._submitted += 1
                        self._completed += 1
                    self._count_outcome("completed", freq.tenant)
                    freq._latch_result(hit)
                    return freq
                if self._cache.coalesce(ckey, gen, freq):
                    # Follower: no placement, no watcher — it latches
                    # when the leader settles (result or error).
                    with self._lock:
                        self._submitted += 1
                        self._pending += 1
                    return freq
                # Leader only: the settle hook pops the in-flight entry
                # and releases followers; a follower must never carry it
                # (its latch would re-settle and re-insert its stamped
                # copy of the response).
                freq._cache_key = (ckey, gen)
                freq._done_hooks.append(self._settle_cached)
        try:
            self._place(freq, is_hedge=False)
        except Overloaded:
            with self._lock:
                self._submitted += 1
                self._shed += 1
            self._count_outcome("shed", freq.tenant)
            if freq.span is not None:
                freq.span.end(error="Overloaded")
            self._abort_cached(freq, Overloaded("leader shed"))
            raise
        except ServeError as e:
            with self._lock:
                self._submitted += 1
                self._failed += 1
            self._count_outcome("failed", freq.tenant)
            if freq.span is not None:
                freq.span.end(error=type(e).__name__)
            self._abort_cached(freq, e)
            raise
        with self._lock:
            self._submitted += 1
            self._pending += 1
        mir = self._mirror
        if mir is not None and mir.sample():
            try:
                mir.fn(image, freq)
            except Exception:  # noqa: BLE001 - mirror must not hurt callers
                log.exception("fleet: shadow mirror hook failed")
        threading.Thread(
            target=self._watch, args=(freq,),
            name="fleet-watch", daemon=True,
        ).start()
        return freq

    def infer(self, image, timeout: Optional[float] = None) -> dict:
        return self.submit(image, timeout).result()

    # -- result cache -------------------------------------------------------

    def _settle_cached(self, freq: FleetRequest) -> None:
        """Leader latched (result OR error): publish to the cache and
        latch every coalesced follower with the same outcome.  Runs as a
        request done-hook, so both latch paths (the sub done-callback
        and the watcher's deadline/no-replica errors) settle exactly
        once — ``ResultCache.settle`` pops the in-flight entry."""
        if self._cache is None or freq._cache_key is None:
            return
        ckey, gen = freq._cache_key
        err = freq._error
        res = freq._result if err is None else None
        followers = self._cache.settle(ckey, gen, res)
        for f in followers:
            if err is None:
                assert res is not None
                if f._latch_result(self._cache.follower_view(res)):
                    with self._lock:
                        self._completed += 1
                        self._pending -= 1
                    self._count_outcome("completed", f.tenant)
            else:
                if f._latch_error(err):
                    with self._lock:
                        self._failed += 1
                        self._pending -= 1
                    self._count_outcome("failed", f.tenant)

    def _abort_cached(self, freq: FleetRequest,
                      err: BaseException) -> None:
        """A cache leader that failed AT PLACEMENT (shed / unroutable)
        never latches, so its done-hook never fires — release any
        follower that joined in the placement window here."""
        if self._cache is None or freq._cache_key is None:
            return
        ckey, gen = freq._cache_key
        for f in self._cache.settle(ckey, gen, None):
            if f._latch_error(err):
                with self._lock:
                    self._failed += 1
                    self._pending -= 1
                self._count_outcome("failed", f.tenant)

    def swap_weights(self, variables,
                     generation: Optional[int] = None) -> int:
        """Zero-downtime fleet weight swap: bump the fleet generation,
        then roll the live replicas ONE AT A TIME — each warms the new
        tree on its standby buffer while serving, then flips atomically.
        A replica that fails its swap is quarantined (the supervisor
        rebuilds it straight onto the new generation) and the roll
        continues.  Returns the new generation.

        ``generation`` pins the target explicitly (it must advance past
        the current one) — a caller that rolls several fleets (JAX's
        cross-host gateway, not ported) assigns one generation and pushes
        it to every fleet so no two tag the same weights differently."""
        with self._swap_lock:
            with self._lock:
                target = (
                    self._generation + 1 if generation is None
                    else int(generation)
                )
                if target <= self._generation:
                    raise ValueError(
                        f"generation must advance: {target} <= "
                        f"{self._generation}"
                    )
                if self._weights is not None:
                    # Depth-2 history: the outgoing generation's tree is
                    # retained so rollback is a local re-push.
                    self._weights_prev = (self._generation, self._weights)
                self._weights = variables
                self._generation = target
                live = [
                    r for r in self._replicas.values()
                    if r.state in ROUTABLE
                ]
            if self._cache is not None:
                # New generation: older cached responses can no longer
                # be looked up (the key carries the generation); drop
                # them now rather than waiting for LRU pressure.
                self._cache.invalidate_below(target)
            for r in live:
                try:
                    r.engine.swap_weights(variables, generation=target)
                except Exception as e:  # noqa: BLE001 - fault-isolate
                    log.exception(
                        "fleet: weight swap failed on replica %d", r.rid
                    )
                    self._quarantine(r, f"swap failed: {e}")
            obs.emit("serve", "weight_swap", {
                "generation": target, "replicas": len(live),
            }, logger=log)
            return target

    def kill_replica(self, rid: int, reason: str = "operator kill") -> None:
        """Chaos/ops hook: hard-kill one replica.  Its accepted work
        fails over through retry; the supervisor rebuilds it."""
        with self._lock:
            r = self._replicas.get(rid)
        if r is None:
            raise KeyError(f"no replica {rid} in the fleet")
        self._quarantine(r, reason)

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def current_weights(self) -> tuple[int, object]:
        """(generation, variables) currently published (variables is
        None when the fleet was built without ``initial_weights`` and
        never swapped)."""
        with self._lock:
            return self._generation, self._weights

    def previous_weights(self) -> Optional[tuple[int, object]]:
        """(generation, variables) of the generation BEFORE the current
        one, or None when no history exists yet — the rollback source
        for the Deployer (re-published under a new, higher number)."""
        with self._lock:
            return self._weights_prev

    def set_mirror(self, fn: Callable, rate: float) -> None:
        """Install the shadow mirror: ``fn(image, freq)`` runs for
        roughly ``rate`` of accepted submissions right after placement,
        off the caller's result path.  One mirror at a time — installing
        replaces the previous hook."""
        self._mirror = _Mirror(fn, rate)

    def clear_mirror(self) -> None:
        self._mirror = None

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def stats(self) -> dict:
        with self._lock:
            out = {
                "replicas": len(self._replicas),
                "generation": self._generation,
                "pending": self._pending,
                "draining": self._draining,
                "submitted": self._submitted,
                "completed": self._completed,
                "failed": self._failed,
                "shed": self._shed,
                "quota": self._quota,
                "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "retries": self._retries_total,
                "quarantines": self._quarantines,
                "reinstatements": self._reinstatements,
                "added": self._added,
                "retired": self._retired,
            }
            reps = [
                (r.rid, r.state, r.inflight, r.fail_streak, r.rebuilds,
                 r.engine)
                for r in self._replicas.values()
            ]
        out["replica"] = [
            {
                "rid": rid,
                "state": state,
                "inflight": inflight,
                "fail_streak": streak,
                "rebuilds": rebuilds,
                "engine": None if eng is None else eng.stats(),
            }
            for rid, state, inflight, streak, rebuilds, eng in reps
        ]
        if self._cache is not None:
            out["cache"] = self._cache.stats()
        if self._tenancy is not None:
            out["tenancy"] = self._tenancy.snapshot()
        return out

    # -- placement ---------------------------------------------------------

    def _bucket_for(self, image) -> Optional[tuple[int, int]]:
        shape = getattr(image, "shape", None)
        if not shape or len(shape) < 2:
            return None
        for r in self._reps():
            if r.state in ROUTABLE and r.engine is not None:
                try:
                    return tuple(
                        r.engine.runner.pick_bucket(shape[0], shape[1])
                    )
                except Exception:  # noqa: BLE001 - routing hint only
                    return None
        return None

    def _views(self) -> list[ReplicaView]:
        with self._lock:
            reps = [
                (r.rid, r.state, r.inflight, r.engine)
                for r in self._replicas.values()
            ]
        views = []
        for rid, state, inflight, eng in reps:
            if eng is None:
                continue
            if state in ROUTABLE and eng.health.state == "degraded":
                state = DEGRADED
            views.append(ReplicaView(
                rid=rid,
                state=state,
                inflight=inflight,
                queue_depth=eng.queue_depth,
                buckets=tuple(
                    tuple(b) for b in getattr(eng.runner, "buckets", ())
                ),
                generation=getattr(eng.health, "generation", 0),
            ))
        return views

    def _place(self, freq: FleetRequest, is_hedge: bool) -> _Attempt:
        """Submit ``freq`` to the best fresh replica.  Raises
        :class:`Overloaded` when every candidate shed it,
        :class:`EngineUnavailable` when none is routable, or
        :class:`DeadlineExceeded` when the budget is already gone."""
        exclude = set(freq.tried_rids())
        overloaded = False
        while True:
            view = select_replica(
                self._views(), bucket=freq.bucket,
                exclude=frozenset(exclude),
            )
            if view is None:
                if overloaded:
                    raise Overloaded(
                        "every routable replica shed the request"
                    )
                raise EngineUnavailable("no routable replica")
            with self._lock:
                r = self._replicas.get(view.rid)
            if r is None:  # retired between the view and the placement
                exclude.add(view.rid)
                continue
            remaining = (
                None if freq.deadline is None
                else freq.deadline - self._clock()
            )
            if remaining is not None and remaining <= 0:
                raise DeadlineExceeded("deadline passed before placement")
            eng = r.engine
            if eng is None:
                exclude.add(view.rid)
                continue
            aspan = None
            if freq.span is not None:
                aspan = freq.span.child("attempt", attrs={
                    "replica": view.rid, "hedge": is_hedge,
                    "retry": freq._retries,
                })
            try:
                # The fleet already charged the quota; the engine's
                # tenancy (tenancy_admit=False via build_fleet) only
                # labels metrics and packs weighted-fair.
                if aspan is None:
                    sub = eng.submit(
                        freq.image, timeout=remaining, tenant=freq.tenant
                    )
                else:
                    sub = eng.submit(
                        freq.image, timeout=remaining,
                        trace_id=freq.trace_id,
                        parent_span_id=aspan.span_id,
                        tenant=freq.tenant,
                    )
            except Overloaded:
                if aspan is not None:
                    aspan.end(error="Overloaded")
                overloaded = True
                exclude.add(view.rid)
                continue
            except EngineUnavailable:
                # Raced the replica dying; the supervisor will fence it.
                if aspan is not None:
                    aspan.end(error="EngineUnavailable")
                exclude.add(view.rid)
                continue
            att = _Attempt(view.rid, sub, is_hedge)
            att.span = aspan
            with self._lock:
                r.inflight += 1
                if is_hedge:
                    self._hedges += 1
            if is_hedge:
                obs.counter(
                    "fleet_hedges_total", "duplicate hedge attempts"
                ).inc()
            with freq._lock:
                freq._attempts.append(att)
            sub.add_done_callback(
                lambda _s, r=r, freq=freq, att=att:
                self._on_sub_done(r, freq, att)
            )
            return att

    def _on_sub_done(self, r: _Replica, freq: FleetRequest,
                     att: _Attempt) -> None:
        with self._lock:
            r.inflight = max(0, r.inflight - 1)
        err = att.sub.error()
        self._observe(r, err)
        if err is None:
            try:
                res = att.sub.result(timeout=0)
            except Exception:  # noqa: BLE001 - raced a failure
                res = None
            if res is not None:
                res = dict(res)
                res["replica_id"] = r.rid
                if freq._latch_result(res):
                    with self._lock:
                        self._completed += 1
                        if att.is_hedge:
                            self._hedge_wins += 1
                    self._count_outcome("completed", freq.tenant)
        # Span I/O after the latch: a file write between sub completion
        # and latching would widen the window in which the watcher sees
        # a done-but-unlatched attempt.
        if att.span is not None:
            if err is not None:
                att.span.set(error=type(err).__name__)
            att.span.end()
        freq._wake.set()

    # -- per-request watcher ----------------------------------------------

    def _hedge_delay(self) -> Optional[float]:
        if self.hedge_after is None:
            return None
        if self.hedge_after == "auto":
            for r in self._reps():
                if r.state in ROUTABLE and r.engine is not None:
                    return auto_hedge_delay(r.engine.estimates.snapshot())
            return None
        return float(self.hedge_after)

    def _watch(self, freq: FleetRequest) -> None:
        """One thread per fleet request: latches the deadline, retries
        failed attempts on fresh replicas, and launches the hedge.
        Woken by sub done-callbacks instead of polling."""
        try:
            while True:
                if freq.done():
                    return
                now = self._clock()
                if freq.deadline is not None and now >= freq.deadline:
                    if freq._latch_error(
                        DeadlineExceeded("fleet deadline exceeded")
                    ):
                        with self._lock:
                            self._failed += 1
                        self._count_outcome("failed", freq.tenant)
                    return
                waits = [self.supervisor_poll]
                if freq.deadline is not None:
                    waits.append(freq.deadline - now)
                hedge_at = None
                if not freq._hedged:
                    delay = self._hedge_delay()
                    if delay is not None:
                        hedge_at = freq.enqueued_at + delay
                        waits.append(hedge_at - now)
                freq._wake.wait(max(0.005, min(waits)))
                freq._wake.clear()
                if freq.done():
                    return
                now = self._clock()
                with freq._lock:
                    attempts = list(freq._attempts)
                # An attempt that completed successfully but whose done
                # callback has not latched the result yet still counts
                # as live — latching is imminent, and declaring "no
                # replica could serve" here would race it.
                live = sum(
                    1 for a in attempts
                    if not a.sub.done() or a.sub.error() is None
                )
                last_err: Optional[BaseException] = None
                for a in attempts:
                    if a.handled or not a.sub.done():
                        continue
                    err = a.sub.error()
                    if err is None:
                        continue  # success; the callback latched it
                    a.handled = True
                    last_err = err
                    if isinstance(err, DeadlineExceeded):
                        continue  # retrying cannot beat a global deadline
                    if freq._retries < self.max_attempts - 1:
                        freq._retries += 1
                        with self._lock:
                            self._retries_total += 1
                        obs.counter(
                            "fleet_retries_total", "failed-attempt retries"
                        ).inc()
                        try:
                            self._place(freq, is_hedge=False)
                            live += 1
                        except ServeError as e:
                            last_err = e
                if live == 0:
                    if freq._latch_error(
                        last_err
                        or EngineUnavailable("no replica could serve")
                    ):
                        with self._lock:
                            self._failed += 1
                        self._count_outcome("failed", freq.tenant)
                    return
                if (
                    hedge_at is not None
                    and now >= hedge_at
                    and not freq._hedged
                ):
                    try:
                        self._place(freq, is_hedge=True)
                        freq._hedged = True
                    except ServeError:
                        pass  # no fresh replica yet; try on the next wake
        finally:
            with self._lock:
                self._pending -= 1

    # -- supervision -------------------------------------------------------

    def _observe(self, r: _Replica, err: Optional[BaseException]) -> None:
        """Per-attempt health accounting.  Deadline misses and sheds are
        load signals, not replica faults; a typed engine death fences
        immediately; repeated serving failures fence after a streak."""
        if self._draining or self._stopped:
            return
        if err is None:
            with self._lock:
                r.fail_streak = 0
            return
        if isinstance(err, (DeadlineExceeded, Overloaded, QuotaExceeded)):
            # Load/budget signals, not replica faults.
            return
        if isinstance(err, EngineUnavailable):
            self._quarantine(r, f"engine unavailable: {err}")
            return
        with self._lock:
            r.fail_streak += 1
            streak = r.fail_streak
        if streak >= self.quarantine_failures:
            self._quarantine(r, f"{streak} consecutive failures")

    def _quarantine(self, r: _Replica, reason: str) -> None:
        with self._lock:
            if r.state not in ROUTABLE:
                return
            r.state = QUARANTINED
            self._quarantines += 1
        obs.emit("serve", "fleet_quarantine", {
            "replica": r.rid, "reason": reason,
        }, logger=log)
        obs.counter(
            "fleet_quarantines_total", "replica quarantines"
        ).inc()
        if r.engine is not None:
            try:
                # Fence: queued work fails fast with a typed error and
                # retries on healthy replicas instead of waiting here.
                r.engine.kill(f"quarantined: {reason}")
            except Exception:
                log.exception("killing replica %d failed", r.rid)

    def _supervise(self) -> None:
        while not self._stop_event.wait(self.supervisor_poll):
            for r in self._reps():
                with self._lock:
                    state = r.state
                    rebuilding = r.rebuilding
                    rebuilds = r.rebuilds
                if (
                    state in ROUTABLE
                    and r.engine is not None
                    and not r.engine.health.alive()
                ):
                    self._quarantine(
                        r, f"engine dead: {r.engine.health.reason}"
                    )
                    state = QUARANTINED
                if state == QUARANTINED and not rebuilding:
                    if rebuilds >= self.max_rebuilds:
                        with self._lock:
                            if r.state == QUARANTINED:
                                r.state = DEAD
                        obs.emit("serve", "fleet_retire", {
                            "replica": r.rid, "rebuilds": rebuilds,
                        }, logger=log)
                        obs.flight_dump(
                            "fleet_retire", {"replica": r.rid}
                        )
                        continue
                    with self._lock:
                        r.rebuilding = True
                        r.rebuilds += 1
                    t = threading.Thread(
                        target=self._rebuild, args=(r,),
                        name=f"fleet-rebuild-{r.rid}", daemon=True,
                    )
                    r.rebuild_thread = t
                    t.start()

    def _rebuild(self, r: _Replica, reinstate: bool = True) -> None:
        """Background (re-)warmup of a replica slot: fresh engine from
        the factory, warmed, aligned to the fleet's current weight
        generation, then put in rotation READY.  ``reinstate=False`` is
        the add_replica path — same machinery, counted and journaled as
        growth instead of recovery."""
        replaced = None
        try:
            if self._stopped:
                return  # fleet went away before the build even began
            eng = self._engine_factory(r.rid)
            eng.start()
            # Alignment + publish serialize against swap_weights under
            # _swap_lock (same _swap_lock -> _lock order): without it a
            # concurrent roll can advance the generation between our
            # weights read and the READY publish, putting a stale
            # replica into rotation that no later roll revisits — it
            # wasn't live when the roll snapshotted the fleet.
            with self._swap_lock:
                with self._lock:
                    weights, gen = self._weights, self._generation
                if weights is not None and gen > 0:
                    eng.swap_weights(weights, generation=gen)
                with self._lock:
                    if self._stopped or self._replicas.get(r.rid) is not r \
                            or r.state == RETIRING:
                        pass  # fleet/slot went away mid-build; discarded
                    else:
                        replaced = r.engine
                        r.engine = eng
                        r.state = READY
                        r.fail_streak = 0
                        if reinstate:
                            self._reinstatements += 1
                        else:
                            self._added += 1
                        eng = None
            if eng is not None:
                eng.stop(drain=False)
            elif reinstate:
                obs.emit(
                    "serve", "fleet_reinstate", {"replica": r.rid},
                    logger=log,
                )
                obs.counter(
                    "fleet_reinstatements_total", "replica reinstatements"
                ).inc()
            else:
                obs.emit("serve", "fleet_replica_added", {
                    "replica": r.rid, "generation": gen,
                }, logger=log)
                obs.counter(
                    "fleet_replicas_added_total",
                    "replicas added by scale-up",
                ).inc()
            if replaced is not None:
                # The killed engine's worker may still be inside a device
                # call; stopping it makes the worker exit when the call
                # returns, which releases its runner's weights.  The
                # bounded join keeps a wedged call from holding the
                # rebuild (the worker exits on its own afterwards).
                replaced.stop(timeout=1.0, drain=False)
        except Exception:
            log.exception("fleet: build of replica %d failed", r.rid)
        finally:
            with self._lock:
                r.rebuilding = False

    # -- dynamic fleet (autoscaler API) ------------------------------------

    def add_replica(self, wait: bool = False,
                    timeout: float = 300.0) -> int:
        """Grow the fleet by one replica on a fresh, never-reused rid.

        The build runs in the BACKGROUND on the rebuild machinery
        (factory → start/warmup → align to the current weight
        generation → READY), so the call returns immediately with the
        new rid; ``wait=True`` blocks until the replica is in rotation
        (raises TimeoutError if the build does not land in time).
        """
        with self._lock:
            if self._stopped or self._draining:
                raise EngineUnavailable("fleet stopping")
            rid = self._next_rid
            self._next_rid += 1
            r = _Replica(rid)
            r.rebuilding = True  # keeps the supervisor's hands off
            self._replicas[rid] = r
        t = threading.Thread(
            target=self._rebuild, args=(r, False),
            name=f"fleet-add-{rid}", daemon=True,
        )
        r.rebuild_thread = t
        t.start()
        if wait:
            deadline = self._clock() + timeout
            while self._clock() < deadline:
                with self._lock:
                    if r.state in ROUTABLE:
                        return rid
                    gone = self._replicas.get(rid) is not r
                if gone or (not t.is_alive() and r.state not in ROUTABLE):
                    raise EngineUnavailable(
                        f"replica {rid} build failed"
                    )
                time.sleep(0.02)
            raise TimeoutError(f"replica {rid} not ready in {timeout}s")
        return rid

    def build_spare_engine(self):
        """An out-of-rotation engine from the fleet's own factory on a
        fresh, never-reused rid — the deploy shadow slot
        (the Deployer's).  The engine never enters the replica map, so
        routing, supervision and weight rolls cannot see it; the caller
        owns its lifecycle (start/swap/stop)."""
        with self._lock:
            if self._stopped or self._draining:
                raise EngineUnavailable("fleet stopping")
            rid = self._next_rid
            self._next_rid += 1
        return self._engine_factory(rid)

    def retire_replica(self, rid: int, timeout: float = 60.0,
                       reason: str = "scale-down") -> bool:
        """Shrink the fleet by draining one replica out of rotation:
        stop admitting (state RETIRING excludes it from every routing
        view), let its accepted work finish (the engine drains its own
        queue; fleet-side attempts complete through their callbacks),
        then release the slot.  Returns True when the drain was clean —
        zero accepted requests lost, the same bar as ``replica_kill``.

        Refuses (ValueError) to retire the last routable replica: an
        autoscaler bug must not be able to scale the fleet to zero.
        """
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                raise KeyError(f"no replica {rid} in the fleet")
            if r.state == RETIRING:
                return False
            routable_n = sum(
                1 for x in self._replicas.values()
                if x.state in ROUTABLE
            )
            if r.state in ROUTABLE and routable_n <= 1 \
                    and not self._stopped:
                raise ValueError(
                    "refusing to retire the last routable replica"
                )
            r.state = RETIRING
        eng = r.engine
        clean = True
        if eng is not None:
            try:
                # Drain: the engine finishes every accepted request
                # before its worker exits; nothing new lands because
                # RETIRING is not ROUTABLE.
                eng.stop(timeout=timeout, drain=True)
            except Exception:
                log.exception("draining replica %d failed", rid)
                clean = False
        # Wait out fleet-side completion callbacks for this replica.
        deadline = self._clock() + max(1.0, timeout)
        while self._clock() < deadline:
            with self._lock:
                if r.inflight == 0:
                    break
            time.sleep(0.01)
        with self._lock:
            clean = clean and r.inflight == 0
            self._replicas.pop(rid, None)
            self._retired += 1
        obs.emit("serve", "fleet_replica_retired", {
            "replica": rid, "reason": reason,
        }, logger=log)
        obs.counter(
            "fleet_replicas_retired_total",
            "replicas retired by scale-down",
        ).inc()
        return clean


def build_fleet(
    cfg,
    variables,
    n_replicas: int,
    buckets: Optional[Sequence[tuple[int, int]]] = None,
    batch_size: Optional[int] = None,
    int8_head: bool = False,
    int8_network: bool = False,
    engine_kwargs: Optional[dict] = None,
    device=None,
    **fleet_kwargs,
) -> FleetRouter:
    """The real wiring: replica ``rid`` runs a :class:`DetectorRunner` over
    the ``state_dict`` ``variables`` on card ``rid % device_count``, so an
    N-replica fleet on an N-card host serves one replica a card and on one
    card N engines share it.  ``device="cpu"`` puts every replica on the
    CPU; with no card and no such request this raises, as every entry
    point of the port does.  ``cfg.serve`` supplies the micro-batch,
    packing, tenancy and result-cache defaults; explicit arguments and
    ``engine_kwargs`` win."""
    import torch

    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    base = resolve_device(device)
    if base.type == "cuda" and base.index is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [base]
    ekw = dict(engine_kwargs or {})
    serve_cfg = getattr(cfg, "serve", None)
    if batch_size is None:
        batch_size = serve_cfg.batch_size if serve_cfg is not None else 1
    if serve_cfg is not None:
        ekw.setdefault("pack", serve_cfg.pack)
        ekw.setdefault("pack_window_s", serve_cfg.pack_window_s)
    if "tenancy" not in fleet_kwargs and serve_cfg is not None \
            and getattr(serve_cfg, "tenancy", None) is not None:
        fleet_kwargs["tenancy"] = \
            tenancy_mod.TenancyPolicy.from_config(serve_cfg.tenancy)
    # One shared policy: the ROUTER charges the quota; engines get the
    # same policy for tenant labels + weighted-fair packing only
    # (tenancy_admit=False), so a request is never double-charged.
    if fleet_kwargs.get("tenancy") is not None:
        ekw.setdefault("tenancy", fleet_kwargs["tenancy"])
        ekw.setdefault("tenancy_admit", False)
    if "result_cache" not in fleet_kwargs:
        cap = getattr(serve_cfg, "result_cache_capacity", 0) \
            if serve_cfg is not None else 0
        if cap > 0:
            fleet_kwargs["result_cache"] = \
                result_cache_mod.ResultCache(capacity=cap)

    def factory(rid: int) -> InferenceEngine:
        runner = DetectorRunner(
            cfg, variables,
            buckets=buckets, batch_size=batch_size, int8_head=int8_head,
            int8_network=int8_network,
            device=devices[rid % len(devices)],
        )
        return InferenceEngine(runner, replica_id=rid, **ekw)

    fleet_kwargs.setdefault("initial_weights", variables)
    return FleetRouter(factory, n_replicas, **fleet_kwargs)
