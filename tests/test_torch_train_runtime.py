"""The port's training runtime: guardian, metrics writer, preemption,
resume and real-data training, against the JAX package where it has a
counterpart and against the port's own uninterrupted run otherwise.

  * the guardian reaches the JAX guardian's decisions (rollback with its
    step, reason and attempt; the divergence error; the loss-spike
    warning) on the same metric streams, for rollback budgets 0-2;
  * ``ScalarWriter`` and ``host_interval_metrics`` give the JAX ones'
    files and values (the cases of ``tests/test_robustness.py``);
  * ``PreemptionGuard`` as ``TestPreemptionGuard``, and ``cli()`` maps
    ``Preempted`` to exit code 75;
  * a config drift on resume warns, and ``--strict-resume`` raises;
  * on ``tiny_synthetic`` (CPU, 6 steps, at most 8 a run): a resumed run
    and a run preempted by a real SIGTERM and resumed end bitwise equal
    to the uninterrupted run (parameters, FrozenBN buffers, momentum,
    step counts, the manifest's tree CRC); a poisoned step rolls back to
    the last finite checkpoint, skips its data window and finishes
    finite; poison at every step raises ``TrainingDiverged``;
  * ``train_cli`` trains 2 steps on a VOC directory written here (JPEGs
    from PIL) and runs the final eval;
  * the input runtime: ``train()`` through the input service
    (``data.num_workers=2``) and the tensor cache ends bitwise where the
    synchronous run (``host_depth=0``) ends; no ``host-prefetch`` or
    ``loader-prefetch`` thread and no decode worker outlives ``train()``
    after a rollback, a preemption or a normal end; the NaN chaos hook
    refuses the port's uint8 batches with JAX's error.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import multiprocessing as mp
import os
import shutil
import signal
import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.train.guardian import Guardian as JaxGuardian
from mx_rcnn_tpu.train.guardian import TrainingDiverged as JaxDiverged
from mx_rcnn_tpu.train.metrics import ScalarWriter as JaxWriter
from mx_rcnn_tpu.train.metrics import host_interval_metrics as jax_interval
from mx_rcnn_tpu_torch.cli import train_cli
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.train import checkpoint as C
from mx_rcnn_tpu_torch.train import loop as L
from mx_rcnn_tpu_torch.train.guardian import Guardian, TrainingDiverged
from mx_rcnn_tpu_torch.train.metrics import (
    ScalarWriter,
    Speedometer,
    host_interval_metrics,
    host_mean_metrics,
)
from mx_rcnn_tpu_torch.train.preemption import RESUMABLE_EXIT_CODE, Preempted, PreemptionGuard

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _remove_written_files(tmp_path):
    """Checkpoints and .pth files here are 100-200 MB each: delete them
    when the test ends rather than leave them to pytest's retention."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)

# -- guardian -------------------------------------------------------------------


def _stream(seed: int):
    """(step, means, per_step) drains: clean noise, a spike, a per-step
    trip under a finite mean, a non-finite mean, then clean again."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(1, 25):
        loss = 1.0 + 0.01 * rng.randn()
        per = [{"loss": loss, "nonfinite": 0.0}, {"loss": loss, "nonfinite": 0.0}]
        if s == 12:
            loss = 50.0
        if s in (15, 20):
            per[0]["nonfinite"] = 1.0
        if s == 17:
            loss = float("nan")
        if s == 22:
            loss = float("inf")
        out.append((2 * s, {"loss": loss, "nonfinite": 0.0, "lr": 0.01}, per))
    return out


def _decisions(guardian, diverged, stream, caplog):
    caplog.clear()
    got = []
    for step, means, per in stream:
        try:
            r = guardian.observe(step, dict(means), per)
        except diverged:
            got.append(("diverged", step))
            break
        got.append(None if r is None else (r.detect_step, r.reason, r.attempt))
    spikes = [r.getMessage().split(" — ")[0].split(": ")[1] for r in caplog.records
              if "loss spike" in r.getMessage()]
    return got, spikes


@pytest.mark.parametrize("budget", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_guardian_decides_as_jax(caplog, budget, seed):
    stream = _stream(seed)
    with caplog.at_level(logging.WARNING):
        want = _decisions(JaxGuardian(max_rollbacks=budget, spike_zscore=4.0, spike_window=16),
                          JaxDiverged, stream, caplog)
        got = _decisions(Guardian(max_rollbacks=budget, spike_zscore=4.0, spike_window=16),
                         TrainingDiverged, stream, caplog)
    assert got == want
    assert want[1] == ["loss spike at step 24"]
    assert any(d is not None for d in want[0])


# -- metrics ---------------------------------------------------------------------


def test_interval_metrics_match_jax():
    rng = np.random.RandomState(0)
    rows = [{"loss": np.float32(rng.rand()), "RPNAcc": np.float32(rng.rand()),
             "nonfinite": np.float32(i == 1), "lr": np.float32(0.01 * (i + 1))}
            for i in range(3)]
    got = host_interval_metrics([{k: torch.tensor(v) for k, v in r.items()} for r in rows])
    want = jax_interval(rows)
    assert got == want and host_mean_metrics(
        [{k: torch.tensor(v) for k, v in r.items()} for r in rows]) == want[0]
    assert got[0]["lr"] == rows[-1]["lr"] and got[1][1]["nonfinite"] == 1.0


def test_speedometer_rates_after_the_first_call():
    s = Speedometer(batch_size=2)
    assert s(1, {"loss": 1.0}) is None
    speed = s(3, {"loss": 1.0})
    assert speed is not None and speed > 0


def _rows(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


WRITERS = pytest.mark.parametrize("writer", [ScalarWriter, JaxWriter], ids=["port", "jax"])


@WRITERS
def test_writer_resume_truncates_future_rows(tmp_path, writer):
    path = str(tmp_path / "metrics.jsonl")
    w = writer(path)
    for s in (2, 4, 6):
        w.write(s, {"loss": float(s)})
    w.close()
    w = writer(path, resume=True, resume_step=4)
    w.write(6, {"loss": 60.0})
    w.close()
    rows = _rows(path)
    assert [r["step"] for r in rows] == [2, 4, 6] and rows[-1]["loss"] == 60.0


@WRITERS
def test_writer_resume_drops_torn_last_line(tmp_path, writer):
    path = str(tmp_path / "metrics.jsonl")
    w = writer(path)
    w.write(2, {"loss": 1.0})
    w.close()
    with open(path, "a") as f:
        f.write('{"step": 4, "los')
    writer(path, resume=True, resume_step=4).close()
    assert [r["step"] for r in _rows(path)] == [2]


@WRITERS
def test_writer_rollback_truncate_while_open(tmp_path, writer):
    path = str(tmp_path / "metrics.jsonl")
    w = writer(path)
    for s in (2, 4, 6):
        w.write(s, {"loss": float(s)})
    w.truncate(4)
    w.write(6, {"loss": 61.0})
    w.close()
    rows = _rows(path)
    assert [r["step"] for r in rows] == [2, 4, 6] and rows[-1]["loss"] == 61.0


@WRITERS
def test_writer_fresh_run_overwrites(tmp_path, writer):
    path = str(tmp_path / "metrics.jsonl")
    w = writer(path)
    w.write(2, {"loss": 1.0})
    w.close()
    writer(path).close()
    assert _rows(path) == []


# -- preemption guard --------------------------------------------------------------


def _on_main_thread():
    # A SIGTERM with no guard installed would kill the test process.
    assert threading.current_thread() is threading.main_thread()


def test_sigterm_sets_flag_and_restores_handler():
    _on_main_thread()
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.triggered and g.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_second_sigint_raises():
    _on_main_thread()
    with PreemptionGuard() as g:
        os.kill(os.getpid(), signal.SIGINT)
        assert g.triggered
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)


def test_guard_off_the_main_thread_is_an_inert_flag():
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def enter():
        with PreemptionGuard() as g:
            seen.append((g.triggered, signal.getsignal(signal.SIGTERM) is before))

    t = threading.Thread(target=enter)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [(False, True)]


def test_preempted_carries_step_and_dir():
    p = Preempted(7, "/runs/x/ckpt")
    assert p.step == 7 and p.ckpt_dir == "/runs/x/ckpt" and "--resume" in str(p)


def test_cli_maps_preempted_to_resumable_exit(monkeypatch):
    def boom(argv=None):
        raise Preempted(3, "ckpt")

    monkeypatch.setattr(train_cli, "main", boom)
    assert train_cli.cli([]) == RESUMABLE_EXIT_CODE == 75
    args = train_cli.parse_args(["--resume", "--strict-resume", "--no-eval", "--pretrained",
                                 "r50.pth"])
    assert args.resume and args.strict_resume and args.no_eval and args.pretrained == "r50.pth"


# -- checkpoints ---------------------------------------------------------------------


def test_delete_steps_after_and_restore_max_step(tmp_path):
    cfg = get_config("tiny_synthetic")
    _, _, state, _, _ = L.build_all(cfg, "cpu")
    for s in (0, 2, 4):
        state.step = s
        C.save_checkpoint(str(tmp_path), C.state_payload(state))
    assert C.delete_steps_after(str(tmp_path), 2) == [4]
    assert C.all_steps(str(tmp_path)) == [0, 2]
    assert sorted(os.listdir(tmp_path)) == ["0", "2", "manifest-0.json", "manifest-2.json"]
    assert C.restore_checkpoint(str(tmp_path), state, max_step=1).step == 0
    assert C.restore_checkpoint(str(tmp_path), state, max_step=3).step == 2
    with pytest.raises(FileNotFoundError):
        C.restore_checkpoint(str(tmp_path / "none"), state, max_step=3)


# -- config ----------------------------------------------------------------------------


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("name", ["r50_fpn_coco", "tiny_synthetic"])
def test_shared_config_fields_equal_jax(name):
    """Every field the port's preset carries has the JAX preset's value,
    the runtime's new ones (``data.flip``, ``train.log_every``, the
    guardian's) included."""
    from mx_rcnn_tpu.config import get_config as jax_get_config

    ours = _flat(dataclasses.asdict(get_config(name)))
    theirs = _flat(dataclasses.asdict(jax_get_config(name)))
    assert {"data.flip", "train.log_every", "train.guardian_rollbacks",
            "train.guardian_spike_z"} <= ours.keys()
    assert {k: ours[k] for k in ours} == {k: theirs[k] for k in ours}


# -- config drift -----------------------------------------------------------------------


def test_drift_warns_and_strict_raises(tmp_path, caplog):
    cfg = get_config("tiny_synthetic")
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    changed = apply_overrides(cfg, ["train.log_every=123456"])
    with caplog.at_level(logging.WARNING, logger="mx_rcnn_tpu_torch"):
        L._warn_config_drift(changed, path)
    assert any("train.log_every" in r.getMessage() for r in caplog.records)
    with pytest.raises(L.ConfigDriftError, match="log_every"):
        L._warn_config_drift(changed, path, strict=True)
    L._warn_config_drift(cfg, path, strict=True)                  # no drift: silent
    L._warn_config_drift(changed, str(tmp_path / "none.json"), strict=True)


# -- runs on tiny_synthetic ----------------------------------------------------------------

BASE = ["train.log_every=2", "train.checkpoint_every=4"]


def _cfg(*extra):
    return apply_overrides(get_config("tiny_synthetic"), [*BASE, *extra])


def _snapshot(state):
    opt = state.optimizer
    return {"step": state.step, "opt_step": opt.step,
            "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "momentum": [t.clone() for t in opt.trace]}


def _assert_bitwise(a, b):
    assert (a["step"], a["opt_step"]) == (b["step"], b["opt_step"])
    assert a["model"].keys() == b["model"].keys()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"], strict=True))


def _metric_steps(workdir):
    return [r["step"] for r in _rows(f"{workdir}/tiny_synthetic/metrics.jsonl")]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("a"))
    state = L.train(_cfg(), steps=6, device="cpu", log=lambda line: None, workdir=work)
    yield work, _snapshot(state)
    shutil.rmtree(work, ignore_errors=True)


def test_resume_is_bitwise(tmp_path, uninterrupted):
    work_a, want = uninterrupted
    work = str(tmp_path)
    L.train(_cfg(), steps=4, device="cpu", log=lambda line: None, workdir=work)
    state = L.train(_cfg(), steps=6, device="cpu", log=lambda line: None, workdir=work,
                    resume=True)
    _assert_bitwise(_snapshot(state), want)
    ckpt, ckpt_a = L.checkpoint_dir(_cfg(), work), L.checkpoint_dir(_cfg(), work_a)
    assert C.all_steps(ckpt) == C.all_steps(ckpt_a) == [0, 4, 6]
    assert C.read_manifest(ckpt, 6)["tree_crc"] == C.read_manifest(ckpt_a, 6)["tree_crc"]
    assert _metric_steps(work) == [1, 2, 4, 5, 6] and _metric_steps(work_a) == [1, 2, 4, 6]


def test_sigterm_preempts_then_resumes_bitwise(tmp_path, uninterrupted):
    _on_main_thread()
    _, want = uninterrupted
    work = str(tmp_path)
    seen = []

    def log(line):
        seen.append(json.loads(line)["step"])
        if seen[-1] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Preempted) as exc:
        L.train(_cfg(), steps=6, device="cpu", log=log, workdir=work)
    assert signal.getsignal(signal.SIGTERM) is before
    ckpt = L.checkpoint_dir(_cfg(), work)
    assert (exc.value.step, exc.value.ckpt_dir) == (2, ckpt) and seen == [1, 2]
    assert C.all_steps(ckpt) == [0, 2]                   # before the first cadence save
    assert C.verify_manifest(ckpt, 2) == (True, "ok")
    state = L.train(_cfg(), steps=6, device="cpu", log=lambda line: None, workdir=work,
                    resume=True)
    _assert_bitwise(_snapshot(state), want)
    assert _metric_steps(work) == [1, 2, 3, 4, 6]


def test_strict_resume_refuses_a_drifted_config(tmp_path):
    work = str(tmp_path)
    L.train(_cfg(), steps=1, device="cpu", log=lambda line: None, workdir=work)
    with pytest.raises(L.ConfigDriftError, match="guardian_spike_z"):
        L.train(_cfg("train.guardian_spike_z=3.0"), steps=2, device="cpu",
                log=lambda line: None, workdir=work, resume=True, strict_resume=True)


def _poisoning(monkeypatch, at_steps):
    """Wrap the train step: a step that starts at a step in ``at_steps``
    (once each, or always for ``at_steps=None``) leaves NaN in a weight
    and in its loss."""
    real = L.make_train_step
    hit = set()

    def make(**kw):
        step = real(**kw)

        def poisoned(state, batch):
            i = state.step
            state, metrics = step(state, batch)
            if at_steps is None or (i in at_steps and i not in hit):
                hit.add(i)
                with torch.no_grad():
                    state.model.box_head.fc6.weight[0, 0] = float("nan")
                metrics["loss"] = metrics["loss"] * float("nan")
                metrics["nonfinite"] = torch.ones_like(metrics["nonfinite"])
            return state, metrics

        return poisoned

    monkeypatch.setattr(L, "make_train_step", make)


def test_guardian_rolls_back_and_skips_the_window(tmp_path, monkeypatch, caplog):
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader
    from mx_rcnn_tpu_torch.data.roidb import filter_roidb

    cfg = _cfg("train.checkpoint_every=2")
    loader = DetectionLoader(filter_roidb(build_dataset(cfg.data).roidb()), cfg.data, 1, "cpu")
    skips = []
    real_iter = loader.iter_from
    monkeypatch.setattr(loader, "iter_from", lambda k=0: skips.append(k) or real_iter(k))
    _poisoning(monkeypatch, {2})
    work = str(tmp_path)
    with caplog.at_level(logging.WARNING, logger="mx_rcnn_tpu_torch"):
        state = L.train(cfg, steps=6, device="cpu", log=lambda line: None, workdir=work,
                        loader=loader)
    assert any("at step 4 — rolling back" in r.getMessage() for r in caplog.records)
    # Poisoned in step 3, caught at the step-4 drain, rolled back to step 2;
    # the retried steps 3-6 take batches 4-7: batches 2-3 are skipped.
    assert skips == [0, 4]
    assert state.step == 6 and C.finite_state(C.state_payload(state))
    ckpt = L.checkpoint_dir(cfg, work)
    assert C.all_steps(ckpt) == [0, 2, 4, 6]
    assert all(C.verify_manifest(ckpt, s) == (True, "ok") for s in (0, 2, 4, 6))
    steps = _metric_steps(work)
    assert steps == [1, 2, 4, 6]
    assert all(math.isfinite(v) for r in _rows(f"{work}/tiny_synthetic/metrics.jsonl")
               for v in r.values())


def test_poison_at_every_step_raises(tmp_path, monkeypatch):
    _poisoning(monkeypatch, None)
    with pytest.raises(TrainingDiverged):
        L.train(_cfg("train.guardian_rollbacks=1"), steps=6, device="cpu",
                log=lambda line: None, workdir=str(tmp_path))
    with pytest.raises(TrainingDiverged):          # no workdir: detect and raise at once
        L.train(_cfg(), steps=2, device="cpu", log=lambda line: None)


# -- real data --------------------------------------------------------------------------


def _write_voc_jpegs(root, sets):
    """A VOC2007 devkit under ``root``: ``sets`` maps an image set to its
    (id, (h, w)) images, each a JPEG of noise with one dog and, on the
    first, a difficult person."""
    from PIL import Image

    dev = root / "VOC2007"
    for d in ("ImageSets/Main", "Annotations", "JPEGImages"):
        (dev / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    obj = ("<object><name>{}</name><difficult>{}</difficult><bndbox><xmin>{}</xmin>"
           "<ymin>{}</ymin><xmax>{}</xmax><ymax>{}</ymax></bndbox></object>")
    for name, images in sets.items():
        (dev / "ImageSets" / "Main" / f"{name}.txt").write_text(
            "".join(f"{i}\n" for i, _ in images))
        for n, (idx, (h, w)) in enumerate(images):
            pixels = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            pixels[h // 4:h // 2, w // 4:w // 2] = (200, 40, 40)
            Image.fromarray(pixels).save(dev / "JPEGImages" / f"{idx}.jpg", quality=95)
            objs = obj.format("dog", 0, w // 4 + 1, h // 4 + 1, w // 2, h // 2)
            if n == 0:
                objs += obj.format("person", 1, 2, 2, 20, 30)
            (dev / "Annotations" / f"{idx}.xml").write_text(
                f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth>"
                f"</size>{objs}</annotation>")


def test_train_cli_on_a_voc_directory(tmp_path, capsys):
    _write_voc_jpegs(tmp_path / "voc", {
        "trainval": [("000001", (96, 128)), ("000002", (128, 96)), ("000003", (100, 120))],
        "test": [("000004", (96, 128)), ("000005", (120, 90))]})
    result = train_cli.main([
        "--config", "tiny_synthetic", "--steps", "2", "--device", "cpu",
        "--workdir", str(tmp_path / "runs"), "--set", "data.dataset=voc",
        "--set", f"data.root={tmp_path / 'voc'}", "--set", "data.train_split=2007_trainval",
        "--set", "data.val_split=2007_test", "--set", "model.num_classes=21",
        "--set", "train.log_every=1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["step"] for x in out[:2]] == [1, 2]
    assert result["final_step"] == 2 and "mAP" in result
    assert all(math.isfinite(v) for v in result.values())
    assert out[2:] == [f"{k} = {v:.4f}" for k, v in sorted(result.items()) if k != "final_step"]
    run = tmp_path / "runs" / "tiny_synthetic"
    assert C.all_steps(str(run / "ckpt")) == [0, 2]
    assert not (run / "quarantine.jsonl").exists()


# -- the input runtime ------------------------------------------------------------------


def _runtime_alive():
    return ({t.name for t in threading.enumerate()
             if t.name in ("host-prefetch", "loader-prefetch") and t.is_alive()},
            {p.pid for p in mp.active_children()})


def test_service_and_cache_train_bitwise_the_sync_run(tmp_path):
    want = L.train(_cfg(), steps=3, device="cpu", log=lambda line: None, host_depth=0)
    got = L.train(_cfg("data.num_workers=2", f"data.cache_dir={tmp_path / 'tc'}"), steps=3,
                  device="cpu", log=lambda line: None)
    _assert_bitwise(_snapshot(got), _snapshot(want))
    assert os.listdir(tmp_path / "tc" / "tensors")


@pytest.mark.parametrize("end", ["rollback", "preemption", "normal"])
def test_nothing_outlives_train(tmp_path, monkeypatch, end):
    """With the input service on (one worker) and the default prefetch."""
    threads, children = _runtime_alive()
    cfg = _cfg("data.num_workers=1", "train.checkpoint_every=2")
    kw = dict(device="cpu", workdir=str(tmp_path), log=lambda line: None)
    if end == "rollback":
        _poisoning(monkeypatch, {2})
        state = L.train(cfg, steps=4, **kw)
        assert state.step == 4
    elif end == "preemption":
        _on_main_thread()

        def log(line):
            if json.loads(line)["step"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        with pytest.raises(Preempted):
            L.train(cfg, steps=4, **{**kw, "log": log})
    else:
        L.train(cfg, steps=2, **kw)
    assert _runtime_alive() == (threads, children)


def test_nan_hook_refuses_uint8_batches_as_jax(monkeypatch):
    from mx_rcnn_tpu.config import get_config as jax_get_config
    from mx_rcnn_tpu.data.datasets import SyntheticDataset as JaxSynthetic
    from mx_rcnn_tpu.data.loader import CHAOS_NAN_ENV as JAX_NAN_ENV
    from mx_rcnn_tpu.data.loader import DetectionLoader as JaxLoader
    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
    from mx_rcnn_tpu_torch.data.loader import CHAOS_NAN_ENV, DetectionLoader

    assert CHAOS_NAN_ENV == JAX_NAN_ENV
    monkeypatch.setenv(CHAOS_NAN_ENV, "1")
    jds = JaxSynthetic(num_images=8, image_hw=(64, 64), seed=0, dtype="uint8")
    theirs = JaxLoader(jds.roidb(), jax_get_config("tiny_synthetic").data,
                       batch_size=2, seed=0, prefetch=False, num_workers=0)
    ds = SyntheticDataset(num_images=8, image_hw=(64, 64), seed=0)
    ours = DetectionLoader(ds.roidb(), get_config("tiny_synthetic").data,
                           2, "cpu")
    errors = []
    for stream in (theirs._train_batches(0), ours.iter_from(0)):
        next(stream)  # batch 0 is not armed
        with pytest.raises(ValueError) as exc:
            next(stream)
        errors.append(str(exc.value))
        stream.close()
    assert errors[0] == errors[1] == (f"{CHAOS_NAN_ENV} needs float images (synthetic/"
                                      "normalized paths); batch 1 is uint8")
