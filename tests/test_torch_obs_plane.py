"""The port's configured observability plane (``mx_rcnn_tpu_torch/obs``)
against the JAX package's, on the same inputs:

  * the journal as ``tests/test_obs.py::TestJournal`` (round trip, torn
    tail, foreign garbage, concurrent writers, write after close), and a
    record through both packages' ``Journal`` equal but for its times;
  * the ``/metrics``, ``/healthz``, ``/readyz`` and ``/statusz`` endpoint
    on an ephemeral port of 127.0.0.1, as ``TestEndpoint``;
  * spans: the Chrome-trace file, ``Span.to_chrome`` equal to JAX's but
    for ids and times, and the engine's per-request span tree (one
    ``engine_request`` with ``queue`` and ``device`` children, under a
    caller's trace, its error on a shed) equal to the JAX engine's on the
    same fake runner;
  * the flight recorder: bounded, no dump unconfigured, the engine's kill
    and watchdog death dump, a real interpreter's crash dumps through the
    chained crash handler, as ``TestFlightRecorder``;
  * ``tiny_synthetic`` trained 4 steps with ``obs.enabled`` in both
    packages: the same journal ``(subsystem, kind)`` sequence and the same
    span tree of names and attrs; a preempted and resumed port run
    journals the drain, the dump and the restore;
  * ``obs/report.py::build_report`` equal to the JAX package's
    ``tools/obs_report.py::build_report`` over the same directories, and
    its incident timeline holding a preemption and an engine kill.
All exact: the modules are host Python.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mx_rcnn_tpu import obs as jobs
from mx_rcnn_tpu.obs import Journal as JaxJournal
from mx_rcnn_tpu.serve import engine as JEng
from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.obs import Journal, read_journal
from mx_rcnn_tpu_torch.obs.report import build_report
from mx_rcnn_tpu_torch.obs.report import main as report_main
from mx_rcnn_tpu_torch.serve import engine as TEng
from mx_rcnn_tpu_torch.train import loop as L
from mx_rcnn_tpu_torch.train.preemption import Preempted

from test_torch_serve_engine import FakeRunner

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("ts", "ts_mono_ns")


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Every test starts and leaves both planes unconfigured and empty."""
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _img(h=8, w=8):
    return np.zeros((h, w, 3), np.float32)


def _wait(pred, timeout=10.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _read_spans(obs_dir):
    with open(os.path.join(obs_dir, "spans.jsonl")) as f:
        return [json.loads(line) for line in f]


# -- journal ----------------------------------------------------------------------------


class TestJournal:
    def test_roundtrip_stamps_records(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with Journal(path, "run-1") as j:
            j.write({"subsystem": "t", "kind": "a", "payload": {"x": 1}})
            j.write({"subsystem": "t", "kind": "b"})
        recs = read_journal(path)
        assert [r["kind"] for r in recs] == ["a", "b"]
        assert all(r["run_id"] == "run-1" and r["pid"] == os.getpid() for r in recs)
        assert [r["seq"] for r in recs] == [0, 1]
        assert recs[0]["ts_mono_ns"] <= recs[1]["ts_mono_ns"]

    def test_torn_tail_loses_only_last_line(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with Journal(path, "r") as j:
            for i in range(5):
                j.write({"kind": "k", "payload": {"i": i}})
        with open(path, "ab") as f:   # a SIGKILL mid-write: the last line torn
            f.write(b'{"kind": "torn", "payl')
        assert [r["payload"]["i"] for r in read_journal(path)] == [0, 1, 2, 3, 4]

    def test_foreign_garbage_line_is_skipped(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with Journal(path, "r") as j:
            j.write({"kind": "a"})
        with open(path, "ab") as f:
            f.write(b"\x00\xffnot json at all\n")
            f.write(b"[1, 2, 3]\n")  # parseable but not a record
        with Journal(path, "r2") as j:
            j.write({"kind": "b"})
        assert [r["kind"] for r in read_journal(path)] == ["a", "b"]

    def test_concurrent_writers_lose_nothing(self, tmp_path):
        # Two journals on one file (the multi-process O_APPEND story),
        # hammered by four threads each.
        path = str(tmp_path / "j.jsonl")
        writers = [Journal(path, f"w{i}") for i in range(2)]
        n_threads, n_recs = 4, 200

        def hammer(j, tid):
            for i in range(n_recs):
                j.write({"kind": "k", "payload": {"t": tid, "i": i}})

        threads = [threading.Thread(target=hammer, args=(w, f"{wi}-{ti}"))
                   for wi, w in enumerate(writers) for ti in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for w in writers:
            w.close()
        recs = read_journal(path)
        assert len(recs) == len({(r["payload"]["t"], r["payload"]["i"]) for r in recs}) \
            == 2 * n_threads * n_recs

    def test_write_after_close_is_noop(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = Journal(path, "r")
        j.write({"kind": "a"})
        j.close()
        j.write({"kind": "b"})
        assert [r["kind"] for r in read_journal(path)] == ["a"]

    @pytest.mark.parametrize("record", [
        {"subsystem": "train", "kind": "checkpoint_saved", "payload": {"step": 4}},
        {"subsystem": "serve", "kind": "engine_killed", "payload": {"reason": "x", "n": [1, 2]}},
        {"kind": "k", "seq": 7, "run_id": "kept", "payload": {"nested": {"a": 1.5}}},
    ])
    def test_record_is_jax_but_for_times(self, tmp_path, record):
        lines = []
        for cls, name in ((Journal, "port"), (JaxJournal, "jax")):
            path = str(tmp_path / f"{name}.jsonl")
            with cls(path, "run-7") as j:
                j.write(dict(record))
            with open(path) as f:
                lines.append(json.loads(f.read()))
        ours, theirs = ({k: v for k, v in r.items() if k not in STAMPS} for r in lines)
        assert ours == theirs and set(lines[0]) == set(lines[1])


def test_configured_plane_journals_and_flushes(tmp_path):
    run_id = obs.configure(str(tmp_path), run_id="r-1", flush_s=0.05)
    assert run_id == "r-1" and obs.is_configured() and obs.out_dir() == str(tmp_path)
    obs.emit("train", "checkpoint_saved", {"step": 3})
    assert _wait(lambda: any(r["kind"] == "metrics_flush"
                             for r in read_journal(str(tmp_path / "journal.jsonl"))))
    obs.close()
    assert not obs.is_configured() and obs.out_dir() is None
    recs = read_journal(str(tmp_path / "journal.jsonl"))
    assert [r["kind"] for r in recs[:2]] == ["configured", "checkpoint_saved"]
    assert recs[-1]["kind"] == "metrics_flush" and "obs_events_total" in \
        recs[-1]["payload"]["snapshot"]
    assert {r["run_id"] for r in recs} == {"r-1"}
    obs.emit("train", "checkpoint_saved", {"step": 4})  # after close: the ring only
    assert len(read_journal(str(tmp_path / "journal.jsonl"))) == len(recs)
    assert obs.flight().entries()[-1]["payload"] == {"step": 4}


def test_obs_config_is_jax_and_drift_checked(tmp_path, caplog):
    from mx_rcnn_tpu.config import ObsConfig as JaxObs

    from mx_rcnn_tpu_torch.config import ObsConfig

    assert dataclasses.asdict(ObsConfig()) == dataclasses.asdict(JaxObs())
    cfg = apply_overrides(get_config("tiny_synthetic"), ["obs.enabled=true",
                                                          "obs.metrics_port=0"])
    assert (cfg.obs.enabled, cfg.obs.metrics_port) == (True, 0)
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    with caplog.at_level(logging.WARNING, logger="mx_rcnn_tpu_torch"):
        L._warn_config_drift(apply_overrides(cfg, ["obs.flush_s=2.5"]), path)
    assert any("obs.flush_s" in r.getMessage() for r in caplog.records)


# -- endpoint ---------------------------------------------------------------------------


class TestEndpoint:
    def _get(self, port, path):
        return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5).read().decode()

    def test_scrape_metrics_healthz_statusz(self, tmp_path):
        obs.configure(str(tmp_path), metrics_port=0)
        port = obs.metrics_port()
        assert port and port > 0
        assert obs._server._server.server_address[0] == "127.0.0.1"
        obs.counter("t_scrape_total").inc(3)
        obs.register_status("engine", lambda: {"alive": True, "n": 2})
        body = self._get(port, "/metrics")
        assert "t_scrape_total 3" in body and "obs_events_total" in body
        assert json.loads(self._get(port, "/healthz"))["ok"] is True
        assert json.loads(self._get(port, "/readyz"))["ok"] is True
        assert json.loads(self._get(port, "/statusz"))["engine"] == {"alive": True, "n": 2}
        with pytest.raises(urllib.error.HTTPError) as ei:
            self._get(port, "/nothing")
        assert ei.value.code == 404
        obs.close()
        assert obs.metrics_port() is None

    def test_unhealthy_provider_fails_healthz(self, tmp_path):
        obs.configure(str(tmp_path), metrics_port=0)
        port = obs.metrics_port()
        obs.register_status("engine", lambda: {"alive": False})
        with pytest.raises(urllib.error.HTTPError) as ei:
            self._get(port, "/healthz")
        assert ei.value.code == 503
        obs.close()

    def test_draining_provider_fails_readyz_not_healthz(self, tmp_path):
        obs.register_status("engine", lambda: {"alive": True, "draining": True})
        obs.configure(str(tmp_path), metrics_port=0)   # providers survive a configure
        port = obs.metrics_port()
        assert json.loads(self._get(port, "/healthz"))["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            self._get(port, "/readyz")
        assert ei.value.code == 503
        obs.unregister_status("engine")
        assert json.loads(self._get(port, "/readyz"))["ok"] is True
        obs.close()

    def test_engine_stats_serve_as_status(self, tmp_path):
        obs.configure(str(tmp_path), metrics_port=0)
        with TEng.InferenceEngine(FakeRunner()) as e:
            obs.register_status("engine", e.stats)
            e.infer(_img())
            status = json.loads(self._get(obs.metrics_port(), "/statusz"))["engine"]
            assert status["alive"] and status["served"] == {"full": 1}
            assert "serve_requests_total" in self._get(obs.metrics_port(), "/metrics")
        obs.close()


# -- spans ------------------------------------------------------------------------------


def _tree(spans):
    """The span forest as nested (name, attrs, children) tuples, ids and
    times dropped; children in name order."""
    ids = {s["args"]["span_id"] for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s["args"]["parent_id"], []).append(s)

    def node(s):
        attrs = {k: v for k, v in s["args"].items()
                 if k not in ("trace_id", "span_id", "parent_id", "ts_wall")}
        return (s["name"], attrs, sorted((node(c) for c in kids.get(s["args"]["span_id"], [])),
                                         key=repr))

    roots = [s for s in spans if s["args"]["parent_id"] not in ids]
    return [node(s) for s in roots]


class TestSpans:
    def test_span_file_is_chrome_trace_events(self, tmp_path):
        obs.configure(str(tmp_path))
        assert obs.spans_enabled()
        with obs.span("outer", subsystem="test") as s:
            with s.child("inner"):
                pass
        obs.close()
        by_name = {s["name"]: s for s in _read_spans(str(tmp_path))}
        assert set(by_name) == {"outer", "inner"}
        inner, outer = by_name["inner"], by_name["outer"]
        assert all(s["ph"] == "X" for s in by_name.values())
        assert inner["args"]["trace_id"] == outer["args"]["trace_id"]
        assert inner["args"]["parent_id"] == outer["args"]["span_id"]
        assert outer["dur"] >= inner["dur"] >= 0

    def test_span_ends_once_and_records_errors(self, tmp_path):
        obs.configure(str(tmp_path))
        s = obs.span("once", attrs={"a": 1})
        s.set(b=2)
        s.end(c=3)
        s.end(d=4)
        with pytest.raises(ValueError):
            with obs.span("fails"):
                raise ValueError("x")
        obs.close()
        spans = {s["name"]: s for s in _read_spans(str(tmp_path))}
        assert len(_read_spans(str(tmp_path))) == 2
        assert {k: spans["once"]["args"][k] for k in "abc"} == {"a": 1, "b": 2, "c": 3}
        assert "d" not in spans["once"]["args"] and spans["fails"]["args"]["error"] == "ValueError"

    def test_to_chrome_is_jax_but_for_ids_and_times(self):
        spans = []
        for mod in (obs, jobs):
            with mod.span("engine_request", subsystem="serve", trace_id="t" * 16,
                          attrs={"replica": "-"}) as root:
                child = root.child("device", attrs={"level": "full", "bucket": [8, 8]})
                child.set(batch=2)
                child.end()
            spans.append((root.to_chrome(), child.to_chrome()))
        for ours, theirs in zip(*spans):
            assert set(ours) == set(theirs) and set(ours["args"]) == set(theirs["args"])
            for k in ("ts", "dur"):
                ours.pop(k), theirs.pop(k)
            for k in ("span_id", "parent_id", "ts_wall"):
                ours["args"].pop(k), theirs["args"].pop(k)
            assert ours == theirs

    def test_new_trace_ids_are_distinct_hex(self):
        ids = {obs.new_trace_id() for _ in range(100)}
        assert len(ids) == 100 and all(len(i) == 16 and int(i, 16) >= 0 for i in ids)

    def test_engine_request_span_tree_is_jax(self, tmp_path):
        """The same calls on both engines over the same fake runner: a
        request under a caller's trace, two packed into one call, and one
        shed by a full queue give the same span forest."""
        forests = []
        for name, mod, eng in (("port", obs, TEng), ("jax", jobs, JEng)):
            out = tmp_path / name
            mod.configure(str(out))
            gate = threading.Event()
            e = eng.InferenceEngine(FakeRunner(batch_size=2, block=gate), max_queue=2,
                                    pack=False)
            with e:
                parent = mod.span("caller", subsystem="test")
                first = e.submit(_img(), trace_id=parent.trace_id,
                                 parent_span_id=parent.span_id)
                assert _wait(lambda: e.runner.run_calls)   # held in the device call
                queued = [e.submit(_img()), e.submit(_img())]
                with pytest.raises(eng.Overloaded):
                    e.submit(_img())
                gate.set()
                for r in (first, *queued):
                    r.result(10)
                parent.end()
                assert first.trace_id == parent.trace_id
            mod.close()
            forests.append(sorted(_tree(_read_spans(str(out))), key=repr))
        assert forests[0] == forests[1]
        names = sorted(root[0] for root in forests[0])
        assert names == ["caller", "engine_request", "engine_request", "engine_request"]
        caller = next(r for r in forests[0] if r[0] == "caller")
        (req,) = caller[2]
        assert [c[0] for c in req[2]] == ["device", "queue"]
        assert req[2][0][1] == {"level": "full", "bucket": [64, 64], "batch": 1}
        assert req[2][1][1] == {"level": "full"}
        shed = [r for r in forests[0] if r[0] == "engine_request" and "error" in r[1]]
        assert len(shed) == 1 and shed[0][1]["error"] == "Overloaded"
        assert [c[0] for c in shed[0][2]] == ["queue"]

    def test_failed_and_killed_requests_end_their_spans(self, tmp_path):
        obs.configure(str(tmp_path))
        with TEng.InferenceEngine(FakeRunner(fail_modes=("full", "reduced", "proposals")),
                                  pack=False) as e:
            with pytest.raises(TEng.ServeError):
                e.infer(_img())
        gate = threading.Event()
        e = TEng.InferenceEngine(FakeRunner(block=gate), pack=False).start()
        stuck = e.submit(_img())
        assert _wait(lambda: e.runner.run_calls)
        queued = e.submit(_img())
        e.kill("test kill")
        gate.set()
        for r in (stuck, queued):
            with pytest.raises(TEng.EngineUnavailable):
                r.result(10)
        e.stop()
        obs.close()
        reqs = [s for s in _read_spans(str(tmp_path)) if s["name"] == "engine_request"]
        assert sorted(s["args"]["error"] for s in reqs) == \
            ["EngineUnavailable", "EngineUnavailable", "ServeError"]
        device = [s for s in _read_spans(str(tmp_path)) if s["name"] == "device"]
        assert [s["args"].get("error") for s in device if "error" in s["args"]] == \
            ["RuntimeError"]

    def test_spans_disabled_writes_nothing(self, tmp_path):
        obs.configure(str(tmp_path), spans=False)
        assert not obs.spans_enabled()
        with TEng.InferenceEngine(FakeRunner()) as e:
            e.infer(_img())
        obs.close()
        assert os.path.getsize(str(tmp_path / "spans.jsonl")) == 0


# -- flight recorder --------------------------------------------------------------------


class TestFlightRecorder:
    def test_ring_is_bounded_and_survives_configure(self, tmp_path):
        from mx_rcnn_tpu_torch.obs import FlightRecorder

        ring = FlightRecorder(size=4)
        for i in range(10):
            ring.record({"i": i})
        assert [e["i"] for e in ring.entries()] == [6, 7, 8, 9]
        obs.emit("test", "before", {})
        obs.configure(str(tmp_path), flight_size=8)
        kinds = [e.get("kind") for e in obs.flight().entries()]
        assert kinds[-2:] == ["before", "configured"]

    def test_dump_unconfigured_returns_none(self):
        assert obs.flight_dump("test") is None

    def test_dump_names_and_journals(self, tmp_path):
        obs.configure(str(tmp_path), run_id="r")
        obs.emit("test", "x", {"i": 1})
        paths = [obs.flight_dump("a b/c", {"why": 1}), obs.flight_dump("a b/c")]
        assert [os.path.basename(p) for p in paths] == [
            f"flight_a_b_c_{os.getpid()}_0.json", f"flight_a_b_c_{os.getpid()}_1.json"]
        dump = json.loads(open(paths[0]).read())
        assert (dump["trigger"], dump["run_id"], dump["extra"]) == ("a b/c", "r", {"why": 1})
        assert "x" in {e.get("kind") for e in dump["entries"]}
        assert not list(tmp_path.glob("*.tmp"))
        recs = read_journal(str(tmp_path / "journal.jsonl"))
        assert [r["payload"]["path"] for r in recs if r["kind"] == "flight_dump"] == paths
        assert obs.registry().counter("obs_flight_dumps_total").value(trigger="a b/c") == 2

    def test_dump_into_a_vanished_dir_returns_none(self, tmp_path):
        obs.configure(str(tmp_path / "gone"))
        os.rename(tmp_path / "gone", tmp_path / "moved")
        assert obs.flight_dump("test") is None

    def test_engine_kill_dumps_flight(self, tmp_path):
        obs.configure(str(tmp_path))
        e = TEng.InferenceEngine(FakeRunner(), replica_id=7).start()
        e.kill("test kill")
        obs.close()
        (path,) = sorted(tmp_path.glob("flight_engine_killed_*.json"))
        dump = json.loads(path.read_text())
        assert dump["trigger"] == "engine_killed" and dump["extra"] == {
            "replica": 7, "reason": "test kill"}
        assert "engine_killed" in {e.get("kind") for e in dump["entries"]}
        recs = read_journal(str(tmp_path / "journal.jsonl"))
        assert any(r.get("kind") == "flight_dump" for r in recs)

    def test_watchdog_death_dumps_flight(self, tmp_path):
        obs.configure(str(tmp_path))
        gate = threading.Event()
        e = TEng.InferenceEngine(FakeRunner(block=gate), hang_timeout=0.2,
                                 watchdog_poll=0.02, replica_id=3).start()
        req = e.submit(_img())
        try:
            assert _wait(lambda: not e.health.alive())
            with pytest.raises(TEng.EngineUnavailable):
                req.result(10)
        finally:
            gate.set()
            e.stop()
        obs.close()
        (path,) = sorted(tmp_path.glob("flight_engine_dead_*.json"))
        dump = json.loads(path.read_text())
        assert dump["extra"]["replica"] == 3 and "hung" in dump["extra"]["reason"]
        assert "engine_dead" in {e.get("kind") for e in dump["entries"]}

    def test_guardian_divergence_dumps_flight(self, tmp_path):
        from mx_rcnn_tpu_torch.train.guardian import Guardian, TrainingDiverged

        obs.configure(str(tmp_path))
        with pytest.raises(TrainingDiverged):
            Guardian(max_rollbacks=0).observe(6, {"loss": float("nan")}, [])
        obs.close()
        (path,) = sorted(tmp_path.glob("flight_training_diverged_*.json"))
        (ev,) = [e for e in json.loads(path.read_text())["entries"]
                 if e.get("kind") == "training_diverged"]
        assert ev["payload"] == {"step": 6, "reason": "interval mean of 'loss' is nan",
                                 "rollbacks": 0}

    def test_subprocess_crash_dumps_flight_through_chained_hooks(self, tmp_path):
        # A real interpreter dying on an unhandled exception leaves the
        # postmortem behind; two installs chain (each dumps), and the
        # default hook still prints the traceback.
        script = (
            "import sys\n"
            f"sys.path.insert(0, {REPO_ROOT!r})\n"
            "from mx_rcnn_tpu_torch import obs\n"
            f"obs.configure({str(tmp_path)!r})\n"
            "obs.install_crash_handler()\n"
            "obs.install_crash_handler()\n"
            "obs.emit('test', 'checkpoint_saved', {'step': 1})\n"
            "raise RuntimeError('injected crash')\n"
        )
        proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                              timeout=120, env={k: v for k, v in os.environ.items()
                                                if k != "MX_RCNN_LOCKCHECK"})
        assert proc.returncode != 0 and "injected crash" in proc.stderr
        dumps = sorted(tmp_path.glob("flight_crash_*.json"))
        assert len(dumps) == 2
        dump = json.loads(dumps[0].read_text())
        by_kind = {e.get("kind"): e for e in dump["entries"]}
        assert "checkpoint_saved" in by_kind
        crash = by_kind["unhandled_exception"]
        assert crash["payload"]["exc_type"] == "RuntimeError"
        assert crash["payload"]["where"] == "main"
        assert "injected crash" in crash["payload"]["message"]

    def test_thread_crash_dumps_flight(self, tmp_path):
        obs.configure(str(tmp_path))
        before = threading.excepthook, sys.excepthook
        try:
            obs.install_crash_handler()
            t = threading.Thread(target=lambda: 1 / 0, name="doomed")
            t.start()
            t.join(10)
        finally:
            threading.excepthook, sys.excepthook = before
        (path,) = sorted(tmp_path.glob("flight_crash_*.json"))
        crash = [e for e in json.loads(path.read_text())["entries"]
                 if e.get("kind") == "unhandled_exception"]
        assert crash[-1]["payload"]["where"] == "doomed"
        assert crash[-1]["payload"]["exc_type"] == "ZeroDivisionError"


# -- train(): both packages, and the preemption ------------------------------------------

TRAIN_SETS = ["obs.enabled=true", "train.log_every=2", "train.checkpoint_every=2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``tiny_synthetic`` trained 4 steps with the plane on, in each
    package; each plane closed after its run (the closing flush)."""
    from mx_rcnn_tpu.config import apply_overrides as jax_overrides
    from mx_rcnn_tpu.config import get_config as jax_get_config
    from mx_rcnn_tpu.train.loop import train as jax_train

    obs.reset()
    jobs.reset()
    work = tmp_path_factory.mktemp("trained")
    try:
        jax_train(jax_overrides(jax_get_config("tiny_synthetic"), TRAIN_SETS), total_steps=4,
                  workdir=str(work / "jax"))
        L.train(apply_overrides(get_config("tiny_synthetic"), TRAIN_SETS), steps=4,
                device="cpu", log=lambda line: None, workdir=str(work / "port"))
    finally:
        jobs.close()
        obs.close()
        sys.excepthook, threading.excepthook = sys.__excepthook__, threading.__excepthook__
    return {k: str(work / k / "tiny_synthetic" / "obs") for k in ("jax", "port")}


def test_train_journal_kinds_are_jax(trained):
    kinds = {k: [(r["subsystem"], r["kind"]) for r in read_journal(f"{d}/journal.jsonl")]
             for k, d in trained.items()}
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"] == [("obs", "configured")] + [("train", "checkpoint_saved")] * 4 + [
        ("obs", "metrics_flush")]
    steps = [r["payload"]["step"] for r in read_journal(f"{trained['port']}/journal.jsonl")
             if r["kind"] == "checkpoint_saved"]
    assert steps == [0, 2, 4, 4]


def test_train_span_tree_is_jax(trained):
    forests = {k: _tree(_read_spans(d)) for k, d in trained.items()}
    assert forests["port"] == forests["jax"]
    assert forests["port"] == [("train_step", {"step": i}, [("data", {}, []), ("step", {}, [])])
                               for i in range(4)]


def test_preempted_run_journals_drain_dump_and_restore(tmp_path):
    assert threading.current_thread() is threading.main_thread()
    cfg = apply_overrides(get_config("tiny_synthetic"), [*TRAIN_SETS, "train.log_every=1"])

    def log(line):
        if json.loads(line)["step"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = sys.excepthook, threading.excepthook
    try:
        with pytest.raises(Preempted):
            L.train(cfg, steps=4, device="cpu", log=log, workdir=str(tmp_path))
        L.train(cfg, steps=4, device="cpu", log=lambda line: None, workdir=str(tmp_path),
                resume=True)
    finally:
        sys.excepthook, threading.excepthook = before
    obs.close()
    d = tmp_path / "tiny_synthetic" / "obs"
    recs = read_journal(str(d / "journal.jsonl"))
    kinds = [(r["kind"], r.get("payload", {}).get("step")) for r in recs
             if r["kind"] not in ("metrics_flush",)]
    assert kinds == [("configured", None), ("checkpoint_saved", 0), ("checkpoint_saved", 2),
                     ("preempt_drain", 2), ("checkpoint_saved", 2), ("flight_dump", None),
                     ("configured", None), ("checkpoint_restored", 2), ("checkpoint_saved", 4),
                     ("checkpoint_saved", 4)]
    (dump,) = sorted(d.glob("flight_preempt_drain_*.json"))
    entries = json.loads(dump.read_text())["entries"]
    assert [e["args"]["step"] for e in entries if e.get("name") == "train_step"] == [0, 1]
    assert [s["args"]["step"] for s in _read_spans(str(d)) if s["name"] == "train_step"] == \
        [0, 1, 2, 3]


# -- the report ------------------------------------------------------------------------


def _jax_report_module():
    spec = importlib.util.spec_from_file_location(
        "obs_report_jax", os.path.join(REPO_ROOT, "tools", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def incident_dir(tmp_path_factory):
    """One obs directory holding a preempted train, a killed engine with
    traced requests, a quarantined data record and a flush snapshot."""
    d = tmp_path_factory.mktemp("incident")
    obs.reset()
    obs.configure(str(d), run_id="incident")
    obs.emit("train", "checkpoint_saved", {"step": 0})
    obs.emit("data", "worker_death", {"service": "s", "worker": 0, "why": "x", "lost": 1,
                                     "indices": [3], "respawns_left": 1})
    obs.emit("train", "preempt_drain", {"step": 2})
    obs.flight_dump("preempt_drain")
    with TEng.InferenceEngine(FakeRunner(batch_size=2), replica_id=0) as e:
        for _ in range(3):
            e.infer(_img())
        obs.histogram("serve_batch_occupancy", "", buckets=(0.5, 1.0)).observe(0.5)
        e.kill("chaos: test kill")
    obs.close()
    obs.reset()
    return str(d)


@pytest.mark.parametrize("which", ["incident", "port_train", "jax_train"])
def test_build_report_is_jax(which, incident_dir, trained):
    d = {"incident": incident_dir, "port_train": trained["port"],
         "jax_train": trained["jax"]}[which]
    assert build_report(d) == _jax_report_module().build_report(d)


def test_report_timeline_holds_preemption_and_kill(incident_dir, tmp_path, capsys):
    out = tmp_path / "r.json"
    assert report_main([incident_dir, "--out", str(out),
                        "--trace-out", str(tmp_path / "t.json")]) == 0
    report = json.loads(out.read_text())
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["metric"] == "obs_report" and summary["value"]["spans"] == 9
    kinds = [e["kind"] for e in report["incident_timeline"]]
    assert kinds == ["checkpoint_saved", "worker_death", "preempt_drain", "engine_killed"]
    assert {f["trigger"] for f in report["flight_dumps"]} == {"preempt_drain", "engine_killed"}
    assert report["spans"] == {"count": 9, "traces": 3, "max_spans_per_trace": 3}
    assert report["data_plane"]["batch_occupancy"] == {"device_calls": 4, "mean": 0.5}
    trace = json.loads((tmp_path / "t.json").read_text())
    assert len(trace["traceEvents"]) == 9


def test_report_refuses_a_missing_dir(tmp_path):
    with pytest.raises(SystemExit):
        report_main([str(tmp_path / "absent")])


def test_report_module_runs_without_jax(incident_dir, tmp_path):
    """``python -m mx_rcnn_tpu_torch.obs.report`` in an interpreter where
    importing jax or the JAX package fails."""
    script = (
        "import sys, runpy\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'mx_rcnn_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        f"sys.argv = ['report', {incident_dir!r}, '--out', {str(tmp_path / 'r.json')!r}]\n"
        "runpy.run_module('mx_rcnn_tpu_torch.obs.report', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["value"]["flight_dumps"] == 2
