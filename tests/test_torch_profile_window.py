"""The port's profile window (``utils/profiling.py::ProfileWindow`` and
``trace`` on ``torch.profiler``) against the JAX package's
(``jax.profiler``):

  * driven by the same step sequences (a fresh run, a resume inside the
    window, a run that ends inside it, one that never reaches it, a
    resume past it), both windows start and stop their traces at the same
    steps, and each active trace is stopped exactly once;
  * on the CPU a real ``torch.profiler`` trace lands in the directory as a
    Chrome trace holding the traced ops, and every trace of a process is a
    file of its own (``trace_<tag>_<pid>_<n>.json``): a window reopened
    after a guardian rollback, or a second block, overwrites nothing;
  * through ``train()`` on ``tiny_synthetic``: the window traces its steps,
    rounds up to ``train.steps_per_call``'s stride as JAX's loop does, and
    a run preempted inside it and resumed writes one trace each;
  * ``train_cli --profile DIR`` hands DIR to ``train()``;
  * marked ``gpu`` (skipped without a card): a ``trace`` block around
    work queued on the card holds its kernels.  On the card: ``python -m
    pytest --noconftest -q -p no:cacheprovider
    tests/test_torch_profile_window.py -m gpu``.
"""

from __future__ import annotations

import json
import os
import re
import signal
import threading

import pytest
import torch

try:
    import jax

    from mx_rcnn_tpu.utils import profiling as JP
except ImportError:  # the card's machine has no jax: only the gpu test runs there
    jax = JP = None
from mx_rcnn_tpu_torch.cli import train_cli
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.train import loop as L
from mx_rcnn_tpu_torch.train.preemption import Preempted
from mx_rcnn_tpu_torch.utils import profiling as TP


class _FakeProfile:
    """Stands in for ``torch.profiler.profile``: records start and stop."""

    def __init__(self, events, activities=None):
        self.events = events

    def start(self):
        self.events.append("start")

    def stop(self):
        self.events.append("stop")

    def export_chrome_trace(self, path):
        self.events.append("export")


def _drive(window, events, steps, end):
    for i in steps:
        events.append(i)
        window.step(i, sync=None)
    if end:
        window.close(sync=None)


def _sequences(monkeypatch, start, stop, steps, end):
    jax_events, port_events = [], []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: jax_events.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: jax_events.append("stop"))
    monkeypatch.setattr(TP.torch.profiler, "profile",
                        lambda activities=None: _FakeProfile(port_events, activities))
    _drive(JP.ProfileWindow("dir", start, stop), jax_events, steps, end)
    _drive(TP.ProfileWindow("dir", start, stop), port_events, steps, end)
    return jax_events, [e for e in port_events if e != "export"], port_events.count("export")


@pytest.mark.parametrize("case, steps, end", [
    ("fresh", range(0, 20), True),
    ("resume_inside", range(12, 20), True),
    ("end_inside", range(0, 13), True),
    ("never_reached", range(0, 8), True),
    ("resume_past", range(16, 20), True),
    ("stride_3", range(0, 20, 3), True),
    ("end_inside_no_close", range(0, 13), False),
])
def test_window_starts_and_stops_as_jax(monkeypatch, case, steps, end):
    want, got, exports = _sequences(monkeypatch, 10, 15, steps, end)
    assert got == want
    assert got.count("start") <= 1 and exports == got.count("stop")
    if end:
        assert got.count("stop") == got.count("start")


def test_close_twice_stops_once(monkeypatch):
    events = []
    monkeypatch.setattr(TP.torch.profiler, "profile",
                        lambda activities=None: _FakeProfile(events, activities))
    w = TP.ProfileWindow("dir", 0, 5)
    w.step(0)
    w.close()
    w.close()
    w.step(6)
    assert events == ["start", "stop", "export"]


def test_no_logdir_is_inert(monkeypatch):
    monkeypatch.setattr(TP.torch.profiler, "profile", None)   # would raise if called
    w = TP.ProfileWindow(None, 0, 5)
    for i in range(6):
        w.step(i)
    w.close()
    with TP.trace(None):
        pass


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _trace_names(path):
    return {e.get("name", "") for e in _trace_events(path)}


def _traces(d):
    """The trace files in ``d`` as (tag, path), in the order written: each
    is ``trace_<tag>_<pid>_<n>.json``, n counting this process's traces."""
    found = []
    for name in os.listdir(d):
        m = re.fullmatch(rf"trace_(\w+?)_{os.getpid()}_(\d+)\.json", name)
        assert m, name
        found.append((int(m[2]), m[1], os.path.join(d, name)))
    return [(tag, path) for _, tag, path in sorted(found)]


def _tags(d):
    return [tag for tag, _ in _traces(d)]


def test_window_writes_a_chrome_trace_on_the_cpu(tmp_path):
    w = TP.ProfileWindow(str(tmp_path), 2, 4)
    a = torch.ones(16, 16)
    for i in range(3, 6):                     # resumes inside the window
        w.step(i, sync=torch.device("cpu"))
        a = torch.mm(a, a) / 16
    w.close()
    ((tag, path),) = _traces(tmp_path)
    assert tag == "step3"
    assert "aten::mm" in _trace_names(path)


def test_trace_block_writes_a_chrome_trace(tmp_path):
    for _ in range(2):
        with TP.trace(str(tmp_path / "t")):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    # The second block is a file of its own.
    assert _tags(tmp_path / "t") == ["block", "block"]
    assert all("aten::mm" in _trace_names(path) for _, path in _traces(tmp_path / "t"))


@pytest.mark.gpu
def test_trace_block_holds_the_cards_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace's CUDA activity has no CPU mode")
    a = torch.ones(512, 512, device="cuda")
    with TP.trace(str(tmp_path)):
        for _ in range(8):
            a = torch.mm(a, a) / 512    # queued; the block's end waits for it
    ((tag, path),) = _traces(tmp_path)
    assert tag == "block"
    assert any(e.get("cat") == "kernel" for e in _trace_events(path))


def _cfg(*extra):
    return apply_overrides(get_config("tiny_synthetic"),
                           ["train.log_every=1", "train.checkpoint_every=100", *extra])


@pytest.mark.parametrize("k, window, first", [(1, (1, 3), 1), (2, (1, 3), 2), (2, (0, 1), 0)])
def test_train_traces_its_window_rounded_to_the_stride(tmp_path, k, window, first):
    calls = []
    real = L.make_train_step

    def counting(**kw):
        step = real(**kw)

        def wrapped(state, batch):
            calls.append(state.step)
            return step(state, batch)
        return wrapped

    L.make_train_step, saved = counting, L.make_train_step
    try:
        L.train(_cfg(f"train.steps_per_call={k}"), steps=4, device="cpu",
                log=lambda line: None, profile_dir=str(tmp_path), profile_steps=window)
    finally:
        L.make_train_step = saved
    assert _tags(tmp_path) == [f"step{first}"]
    assert calls == list(range(0, 4, k))


def test_train_preempted_inside_the_window_then_resumed(tmp_path):
    assert threading.current_thread() is threading.main_thread()

    def log(line):
        if json.loads(line)["step"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    prof = tmp_path / "prof"
    with pytest.raises(Preempted):
        L.train(_cfg(), steps=4, device="cpu", log=log, workdir=str(tmp_path / "w"),
                profile_dir=str(prof), profile_steps=(1, 4))
    # Stopped at the preemption: steps 1 and 2 of the window are in it.
    assert _tags(prof) == ["step1"]
    L.train(_cfg(), steps=4, device="cpu", log=lambda line: None, workdir=str(tmp_path / "w"),
            resume=True, profile_dir=str(prof), profile_steps=(1, 4))
    # The resume at step 2 starts inside the window; the run's end stops it.
    assert _tags(prof) == ["step1", "step2"]
    assert {"aten::mm", "aten::addmm"} & _trace_names(_traces(prof)[1][1])


def test_window_reopened_by_a_rollback_keeps_both_traces(tmp_path, monkeypatch):
    """A step poisoned inside a closed window's retry range: the guardian
    rolls back to the checkpoint at step 2, inside the window (2, 3), and
    the window traces step 2 again into a second file."""
    real, hit = L.make_train_step, []

    def make(**kw):
        step = real(**kw)

        def poisoned(state, batch):
            i = state.step
            state, metrics = step(state, batch)
            if i == 3 and not hit:
                hit.append(i)
                metrics["loss"] = metrics["loss"] * float("nan")
                metrics["nonfinite"] = torch.ones_like(metrics["nonfinite"])
            return state, metrics
        return poisoned

    monkeypatch.setattr(L, "make_train_step", make)
    lines = []
    state = L.train(_cfg("train.checkpoint_every=2"), steps=5, device="cpu",
                    log=lambda line: lines.append(json.loads(line)["step"]),
                    workdir=str(tmp_path / "w"), profile_dir=str(tmp_path / "p"),
                    profile_steps=(2, 3))
    assert hit == [3] and state.step == 5
    assert lines == [1, 2, 3, 3, 4, 5]      # step 4 rolled back to 2; 3 retried
    assert _tags(tmp_path / "p") == ["step2", "step2"]


def test_cli_profile_reaches_train(monkeypatch):
    seen = {}

    class _State:
        step = 0

    def fake_train(cfg, **kw):
        seen.update(kw)
        return _State()

    monkeypatch.setattr(L, "train", fake_train)
    train_cli.main(["--config", "tiny_synthetic", "--device", "cpu", "--steps", "1",
                    "--no-eval", "--profile", "/some/dir"])
    assert seen["profile_dir"] == "/some/dir"
    assert train_cli.parse_args(["--config", "tiny_synthetic"]).profile is None
