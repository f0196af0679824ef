"""lockcheck: opt-in runtime lock-order sanitizer for the host-side plane.

The port's own copy of ``mx_rcnn_tpu/analysis/lockcheck.py``.  It proves
lock-acquisition order at runtime, the way TSan's deadlock detector does:
every ``threading.Lock``/``threading.RLock`` created by the port's code
(``mx_rcnn_tpu_torch/``) or its tests (``tests/``) is replaced by an
instrumented wrapper that

* tracks the per-thread *held set* (which locks this thread currently
  holds, in acquisition order),
* maintains a global acquisition-order graph keyed by the lock's
  *creation site* (``file:line``), so the discipline is enforced across
  instances — two engines' locks created on the same line are one
  node, exactly like a striped lock class in a real detector,
* raises :class:`LockOrderViolation` the moment an acquisition would
  close a cycle in that graph (deterministically, from a single thread's
  nesting — no real contention or timing needed), and
* raises :class:`HeldLockBlockedCall` when a registered blocking call
  (``urllib.request.urlopen``, or any :func:`blocking_region`) runs
  while a non-exempt instrumented lock is held.

Activation is the env knob ``MX_RCNN_LOCKCHECK=1``, checked when the
package is imported (``mx_rcnn_tpu_torch/__init__.py``), so the variable
alone activates it in any child process — ``eval_cli`` processes, the
input service's spawned decode workers.  When the variable is unset
nothing is patched: ``threading.Lock`` is the original C implementation
bit-for-bit (``tests/test_torch_lockcheck.py`` asserts the identity).

Deliberate coarse sections, a lock held *by design* across device or
network work, are marked with :func:`allow_blocking`, which exempts that
one lock from the blocked-call check (never from the order check).  The
port marks none: the JAX package marks only its fleet's and gateway's
swap locks, which are not ported.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Optional

__all__ = [
    "LockOrderViolation",
    "HeldLockBlockedCall",
    "install",
    "uninstall",
    "maybe_install",
    "enabled",
    "allow_blocking",
    "blocking_region",
    "reset",
    "order_graph",
]

ENV_KNOB = "MX_RCNN_LOCKCHECK"

# Originals, captured at import time — the instrumented wrappers and the
# sanitizer's own internal bookkeeping always use these, never the
# patched names (the sanitizer must not sanitize itself).
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Only locks created from these trees are instrumented; everything else
# (threading.py internals, queue.Queue mutexes, torch/numpy machinery)
# gets the real lock.  Allowlist, not denylist: a lock we fail to
# instrument costs coverage, a lock we wrongly instrument can break the
# stdlib.
_INSTRUMENT_DIRS = (
    os.path.join(_REPO_ROOT, "mx_rcnn_tpu_torch") + os.sep,
    os.path.join(_REPO_ROOT, "tests") + os.sep,
)


class LockOrderViolation(RuntimeError):
    """Acquiring this lock would close a cycle in the global
    acquisition-order graph — two code paths take the same pair of locks
    in opposite orders, which is a deadlock waiting for the right
    interleaving."""


class HeldLockBlockedCall(RuntimeError):
    """A registered blocking call (network I/O, unbounded wait) ran while
    an instrumented lock was held — every other thread that wants that
    lock now waits on the network."""


class _State:
    """All sanitizer state, guarded by a REAL (uninstrumented) lock."""

    def __init__(self) -> None:
        self.mu = _REAL_LOCK()
        # site -> set of successor sites: edge A->B means "B was acquired
        # while A was held" somewhere, ever, in this process.
        self.edges: dict[str, set[str]] = {}
        # Sites marked blocking-exempt (via allow_blocking).
        self.exempt_sites: set[str] = set()
        self.violations = 0

    def reachable(self, src: str, dst: str) -> bool:
        """DFS: is dst reachable from src over recorded edges?"""
        stack, seen = [src], set()
        while stack:
            node = stack.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self.edges.get(node, ()))
        return False


_state = _State()
_tls = threading.local()
_installed = False
_real_urlopen: Optional[Any] = None


def _held() -> list:
    """This thread's held instrumented locks, acquisition order."""
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _creation_site() -> Optional[str]:
    """repo-relative file:line of the frame that called Lock()/RLock(),
    or None when the caller is outside the instrumented trees."""
    frame = sys._getframe(2)  # caller of the patched factory
    fname = frame.f_code.co_filename
    try:
        fname = os.path.abspath(fname)
    except (OSError, ValueError):
        return None
    for root in _INSTRUMENT_DIRS:
        if fname.startswith(root):
            rel = os.path.relpath(fname, _REPO_ROOT)
            return f"{rel}:{frame.f_lineno}"
    return None


def _emit(kind: str, payload: dict) -> None:
    """Journal the violation so a run's journal shows it — best-effort,
    the raise is the real signal."""
    try:
        from mx_rcnn_tpu_torch import obs

        obs.emit("lockcheck", kind, payload)
    except Exception:
        pass


def _record_acquire(lock: "_CheckedLock") -> None:
    """Called AFTER the underlying acquire succeeded, while the caller is
    about to enter the critical section."""
    if not _installed:
        return  # leftover wrapper after uninstall(): pure pass-through
    held = _held()
    site = lock._lc_site
    if held:
        prev_site = held[-1]._lc_site
        if prev_site != site:
            cycle = False
            # The emit below can itself acquire instrumented locks
            # (obs counters), re-entering this function — so never
            # report or raise while holding the state mutex.
            with _state.mu:
                succ = _state.edges.setdefault(prev_site, set())
                if site not in succ:
                    # New edge prev->site: a cycle exists iff prev is
                    # already reachable FROM site.
                    if _state.reachable(site, prev_site):
                        _state.violations += 1
                        cycle = True
                    else:
                        succ.add(site)
            if cycle:
                held_sites = [h._lc_site for h in held]
                _emit("lock_order_violation", {
                    "edge": [prev_site, site],
                    "held": held_sites,
                    "thread": threading.current_thread().name,
                })
                raise LockOrderViolation(
                    f"lock-order cycle: acquiring {site} while "
                    f"holding {held_sites} inverts an existing "
                    f"{site} -> {prev_site} ordering"
                )
    held.append(lock)


def _record_release(lock: "_CheckedLock") -> None:
    held = _held()
    # Releases can be out of acquisition order (rare but legal); remove
    # the most recent entry for this lock.
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            return


def check_blocking(what: str) -> None:
    """Raise :class:`HeldLockBlockedCall` if this thread holds any
    non-exempt instrumented lock.  No-op when the sanitizer is off."""
    if not _installed:
        return
    held = [
        h for h in getattr(_tls, "held", ()) or ()
        if not h._lc_allow_blocking
    ]
    if held:
        sites = [h._lc_site for h in held]
        with _state.mu:
            _state.violations += 1
        _emit("held_lock_blocked_call", {
            "call": what,
            "held": sites,
            "thread": threading.current_thread().name,
        })
        raise HeldLockBlockedCall(
            f"blocking call {what!r} while holding lock(s) {sites}"
        )


class blocking_region:
    """Context manager marking a region as a blocking call for the
    sanitizer (e.g. a device sync, a subprocess wait).  Zero-cost when
    lockcheck is not installed."""

    def __init__(self, what: str) -> None:
        self.what = what

    def __enter__(self) -> "blocking_region":
        check_blocking(self.what)
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


class _CheckedLock:
    """Instrumented threading.Lock: same surface, plus order tracking."""

    _lc_reentrant = False

    def __init__(self, site: str) -> None:
        self._lc_inner = _REAL_LOCK()
        self._lc_site = site
        self._lc_allow_blocking = False

    # threading.Condition duck-types on these three when handed a lock.
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lc_inner.acquire(blocking, timeout)
        if ok:
            try:
                _record_acquire(self)
            except LockOrderViolation:
                self._lc_inner.release()
                raise
        return ok

    def release(self) -> None:
        _record_release(self)
        self._lc_inner.release()

    def locked(self) -> bool:
        return self._lc_inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockcheck.Lock site={self._lc_site}>"


class _CheckedRLock:
    """Instrumented threading.RLock: reentrant re-acquisition by the
    owning thread adds no graph edge (not an ordering event)."""

    _lc_reentrant = True

    def __init__(self, site: str) -> None:
        self._lc_inner = _REAL_RLOCK()
        self._lc_site = site
        self._lc_allow_blocking = False
        self._lc_owner: Optional[int] = None
        self._lc_depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._lc_owner == me:
            # Pure reentrancy: no new hold, no edge, never a violation.
            ok = self._lc_inner.acquire(blocking, timeout)
            if ok:
                self._lc_depth += 1
            return ok
        ok = self._lc_inner.acquire(blocking, timeout)
        if ok:
            try:
                _record_acquire(self)
            except LockOrderViolation:
                self._lc_inner.release()
                raise
            self._lc_owner = me
            self._lc_depth = 1
        return ok

    def release(self) -> None:
        if self._lc_owner == threading.get_ident() and self._lc_depth > 1:
            self._lc_depth -= 1
            self._lc_inner.release()
            return
        self._lc_owner = None
        self._lc_depth = 0
        _record_release(self)
        self._lc_inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # threading.Condition uses these when present (RLock protocol).
    def _is_owned(self) -> bool:
        return self._lc_owner == threading.get_ident()

    def _release_save(self):
        state = (self._lc_depth, self._lc_owner)
        while self._lc_depth:
            self.release()
        return state

    def _acquire_restore(self, state) -> None:
        depth, _ = state
        for _ in range(depth):
            self.acquire()

    def __repr__(self) -> str:
        return f"<lockcheck.RLock site={self._lc_site}>"


def _lock_factory():
    site = _creation_site()
    if site is None:
        return _REAL_LOCK()
    return _CheckedLock(site)


def _rlock_factory():
    site = _creation_site()
    if site is None:
        return _REAL_RLOCK()
    return _CheckedRLock(site)


def _checked_urlopen(*args: Any, **kwargs: Any):
    url = args[0] if args else kwargs.get("url", "?")
    check_blocking(f"urlopen({getattr(url, 'full_url', url)!r})")
    return _real_urlopen(*args, **kwargs)  # type: ignore[misc]


def enabled() -> bool:
    """True iff the sanitizer is currently installed."""
    return _installed


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` and ``urllib.request.urlopen``.
    Idempotent.  Locks created BEFORE install stay uninstrumented."""
    global _installed, _real_urlopen
    if _installed:
        return
    import urllib.request

    _real_urlopen = urllib.request.urlopen
    threading.Lock = _lock_factory  # type: ignore[assignment]
    threading.RLock = _rlock_factory  # type: ignore[assignment]
    urllib.request.urlopen = _checked_urlopen
    _installed = True


def uninstall() -> None:
    """Restore the real primitives and drop all recorded state."""
    global _installed, _real_urlopen
    if not _installed:
        return
    import urllib.request

    threading.Lock = _REAL_LOCK  # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK  # type: ignore[assignment]
    if _real_urlopen is not None:
        urllib.request.urlopen = _real_urlopen
    _real_urlopen = None
    _installed = False
    reset()


def reset() -> None:
    """Forget the recorded order graph (between test cases)."""
    with _state.mu:
        _state.edges.clear()
        _state.exempt_sites.clear()
        _state.violations = 0


def maybe_install() -> bool:
    """Install iff ``MX_RCNN_LOCKCHECK=1`` in the environment.  The
    no-op path is one getenv — safe to call from package import."""
    if os.environ.get(ENV_KNOB) == "1":
        install()
        return True
    return False


def allow_blocking(lock: Any) -> Any:
    """Mark one lock as deliberately held across blocking work (a coarse
    serialization lock, by design).  Exempts it from the blocked-call
    check only — order checking still applies.  No-op on real
    (uninstrumented) locks, so call sites never need to gate on the env
    knob."""
    try:
        lock._lc_allow_blocking = True
        with _state.mu:
            _state.exempt_sites.add(lock._lc_site)
    except AttributeError:
        pass  # real _thread.lock: attributes are read-only, nothing to mark
    return lock


def order_graph() -> dict[str, list[str]]:
    """Snapshot of the recorded acquisition-order edges (for tests and
    reports)."""
    with _state.mu:
        return {k: sorted(v) for k, v in _state.edges.items()}


def violation_count() -> int:
    with _state.mu:
        return _state.violations
