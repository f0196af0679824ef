"""The port's runtime lock-order sanitizer (``analysis/lockcheck.py``), as
the JAX package's ``tests/test_fleetlint.py::TestLockcheck`` holds its
own:

  * unset, ``MX_RCNN_LOCKCHECK`` patches nothing (``threading.Lock`` is
    the C original); set, importing the package installs it before any of
    the port's locks exist, and only locks made by the port's code or its
    tests are instrumented;
  * an inverted nesting raises ``LockOrderViolation`` without
    deadlocking, across threads deterministically; RLock reentrancy adds
    no edge; a blocking region or ``urlopen`` under a held lock raises
    ``HeldLockBlockedCall``; ``allow_blocking`` exempts one lock from that
    check, never from the order check;
  * the port's engine (ladder, breaker, packing, weight swap, kill, spans
    and flight dumps on), its prefetch and its input service (spawned
    workers, which install the sanitizer from the variable too) run under
    it with no violation.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.analysis import lockcheck
from mx_rcnn_tpu_torch.serve import engine as TEng

from test_torch_serve_engine import FakeRunner

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sanitizer():
    was_enabled = lockcheck.enabled()
    lockcheck.install()
    lockcheck.reset()
    yield lockcheck
    lockcheck.reset()
    if not was_enabled:
        lockcheck.uninstall()


def _python(code: str, lockcheck_on: bool, timeout: float = 300.0):
    env = {k: v for k, v in os.environ.items() if k != "MX_RCNN_LOCKCHECK"}
    if lockcheck_on:
        env["MX_RCNN_LOCKCHECK"] = "1"
    proc = subprocess.run([sys.executable, "-c", f"import sys\nsys.path.insert(0, {REPO_ROOT!r})\n"
                           + code], capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_unset_variable_patches_nothing():
    got = _python(
        "import threading\n"
        "import mx_rcnn_tpu_torch.obs, mx_rcnn_tpu_torch.serve.engine\n"
        "from mx_rcnn_tpu_torch.analysis import lockcheck\n"
        "import json\n"
        "print(json.dumps([lockcheck.enabled(), threading.Lock is lockcheck._REAL_LOCK,\n"
        "                  threading.RLock is lockcheck._REAL_RLOCK]))\n", lockcheck_on=False)
    assert got == [False, True, True]


def test_variable_installs_before_the_ports_locks():
    got = _python(
        "import threading, json\n"
        "from mx_rcnn_tpu_torch import obs\n"
        "from mx_rcnn_tpu_torch.analysis import lockcheck\n"
        "from mx_rcnn_tpu_torch.obs.journal import Journal\n"
        "import queue\n"
        "q = queue.Queue()\n"
        "print(json.dumps([lockcheck.enabled(), repr(obs._lock), repr(obs._flight._lock),\n"
        "                  type(q.mutex).__name__]))\n", lockcheck_on=True)
    assert got[0] is True
    assert got[1].startswith("<lockcheck.RLock site=mx_rcnn_tpu_torch/obs/__init__.py:")
    assert got[2].startswith("<lockcheck.Lock site=mx_rcnn_tpu_torch/obs/flight.py:")
    assert got[3] == "lock"          # the stdlib's own locks stay real


class TestLockcheck:
    def test_inversion_raises_without_deadlocking(self, sanitizer):
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with pytest.raises(lockcheck.LockOrderViolation):
            with b:
                with a:
                    pass
        assert sanitizer.violation_count() == 1
        assert not a.locked() and not b.locked()

    def test_cross_thread_inversion_is_deterministic(self, sanitizer):
        a = threading.Lock()
        b = threading.Lock()

        def establish():
            with a:
                with b:
                    pass

        t = threading.Thread(target=establish, daemon=True)
        t.start()
        t.join(10)
        assert not t.is_alive()
        with pytest.raises(lockcheck.LockOrderViolation):
            with b:
                with a:
                    pass

    def test_rlock_reentrancy_is_not_an_ordering_event(self, sanitizer):
        r = threading.RLock()
        with r:
            with r:
                with r:
                    pass
        assert sanitizer.order_graph() == {}
        assert sanitizer.violation_count() == 0

    def test_condition_over_a_checked_rlock(self, sanitizer):
        cond = threading.Condition(threading.RLock())
        hits = []

        def waiter():
            with cond:
                cond.wait_for(lambda: hits, timeout=10)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            hits.append(1)
            cond.notify_all()
        t.join(10)
        assert not t.is_alive() and sanitizer.violation_count() == 0

    def test_blocking_region_under_held_lock(self, sanitizer):
        lk = threading.Lock()
        with lk:
            with pytest.raises(lockcheck.HeldLockBlockedCall):
                with lockcheck.blocking_region("device_sync"):
                    pass
        assert sanitizer.violation_count() == 1

    def test_urlopen_under_held_lock(self, sanitizer):
        lk = threading.Lock()
        with lk:
            # Refused before any connection is attempted.
            with pytest.raises(lockcheck.HeldLockBlockedCall, match="urlopen"):
                urllib.request.urlopen("http://127.0.0.1:9/metrics", timeout=1)

    def test_allow_blocking_exempts_one_lock(self, sanitizer):
        lk = lockcheck.allow_blocking(threading.Lock())
        with lk:
            with lockcheck.blocking_region("device_sync"):
                pass
        assert sanitizer.violation_count() == 0
        other = threading.Lock()
        with lk:
            with other:
                pass
        with pytest.raises(lockcheck.LockOrderViolation):
            with other:
                with lk:
                    pass

    def test_allow_blocking_is_noop_on_real_locks(self):
        raw = lockcheck._REAL_LOCK()
        assert lockcheck.allow_blocking(raw) is raw

    def test_violation_is_journaled(self, sanitizer, tmp_path):
        obs.reset()
        obs.configure(str(tmp_path))
        try:
            a = threading.Lock()   # one line each: a creation site is one node
            b = threading.Lock()
            with a, b:
                pass
            with pytest.raises(lockcheck.LockOrderViolation):
                with b, a:
                    pass
        finally:
            obs.reset()
        recs = obs.read_journal(str(tmp_path / "journal.jsonl"))
        (v,) = [r for r in recs if r["kind"] == "lock_order_violation"]
        assert v["subsystem"] == "lockcheck" and len(v["payload"]["edge"]) == 2

    def test_uninstall_restores_the_originals(self, sanitizer):
        lockcheck.uninstall()
        assert threading.Lock is lockcheck._REAL_LOCK and not lockcheck.enabled()
        lockcheck.install()


def test_engine_runs_sanitized(sanitizer, tmp_path):
    """Locks made after the install: the engine's, its requests', the
    plane's journal and ring (configured here), on every engine path."""
    obs.reset()
    obs.configure(str(tmp_path), metrics_port=0)
    img = np.zeros((8, 8, 3), np.float32)
    try:
        with TEng.InferenceEngine(FakeRunner(batch_size=2), replica_id=0) as e:
            obs.register_status("engine", e.stats)
            reqs = [e.submit(img, timeout=10) for _ in range(6)]
            assert len([r.result(10) for r in reqs]) == 6
            assert e.swap_weights({"w": 1}) == 1
            assert [e.submit(img).result(10)["generation"] for _ in range(2)] == [1, 1]
            urlopen_ok = urllib.request.urlopen(
                f"http://127.0.0.1:{obs.metrics_port()}/statusz", timeout=5).status
            e.kill("sanitized kill")
        with TEng.InferenceEngine(FakeRunner(fail_modes=("full",)), pack=False) as e:
            for _ in range(3):
                with pytest.raises(TEng.ServeError):
                    e.infer(img)
            assert e.infer(img)["level"] != "full"
    finally:
        obs.reset()
    assert urlopen_ok == 200
    assert repr(e._lock).startswith("<lockcheck.Lock site=mx_rcnn_tpu_torch/serve/engine.py:")
    assert sanitizer.violation_count() == 0


def test_train_runtime_runs_sanitized_with_workers():
    """``train()`` with the prefetch (in process) and the input service
    (two spawned workers, sanitized by the inherited variable), then a
    report of the order graph: no violation anywhere."""
    got = _python(
        "import json, multiprocessing as mp\n"
        "from mx_rcnn_tpu_torch.analysis import lockcheck\n"
        "from mx_rcnn_tpu_torch.config import apply_overrides, get_config\n"
        "from mx_rcnn_tpu_torch.train.loop import train\n"
        "if __name__ == '__main__':\n"
        "    for extra in ([], ['data.num_workers=2']):\n"
        "        cfg = apply_overrides(get_config('tiny_synthetic'),\n"
        "                              ['train.log_every=1', *extra])\n"
        "        train(cfg, steps=2, device='cpu', log=lambda line: None)\n"
        "    print(json.dumps({'violations': lockcheck.violation_count(),\n"
        "                      'graph': lockcheck.order_graph(),\n"
        "                      'children': len(mp.active_children())}))\n",
        lockcheck_on=True, timeout=600)
    assert got["violations"] == 0 and got["children"] == 0
    sites = set(got["graph"]) | {s for v in got["graph"].values() for s in v}
    assert all(s.startswith("mx_rcnn_tpu_torch/") for s in sites), sites
