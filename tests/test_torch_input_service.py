"""The port's input service, thread pool and journal
(``mx_rcnn_tpu_torch/data/service.py``, ``data/loader.py``) against the
JAX package's and against the port's own synchronous loader, mirroring
``tests/test_data_service.py``'s ``TestInputService``, ``TestPoolDrain``,
``TestEvalAssemblyBackends`` and ``TestQuarantineJournal``.

Against JAX (bitwise unless stated):
  * the spec stream (roidb indices and flips, resume fast-forward) is
    JAX's ``_global_spec_stream`` for the same roidb and seed;
  * the host half's gt, ignore, mask and ``ext_rois`` arrays are JAX's
    ``_assemble_rows`` fields, its ``image_hw`` JAX's; the letterboxed
    pixels within 1 of 255 (the port's stated resize tolerance,
    ``tests/test_torch_datasets.py``);
  * a quarantine journal written through the port's service (a missing
    file, a bad annotation, a chaos-bad record) holds JAX's records,
    ``ts`` and ``ts_mono_ns`` left out, each once.
Against the port's synchronous stream, bitwise:
  * the service at 1 and 3 workers, after a mid-stream SIGKILL, after a
    wedge (2 s watchdog) and after an shm slot corruption (journaled
    ``shm_checksum``);
  * with the respawn budget spent, ``InputServiceDead`` without the
    fallback, the same bits with it (journaled ``service_fallback``);
  * the thread pool drains a bounded spec stream to the full count;
  * eval through the pool and the service.
Workers are spawned (a torch import each), so each service here is small.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import DataConfig as JaxDataConfig
from mx_rcnn_tpu.data.loader import CHAOS_BAD_IMAGES_ENV as JAX_BAD_ENV
from mx_rcnn_tpu.data.loader import DetectionLoader as JaxLoader
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data.cache import quarantine_read
from mx_rcnn_tpu_torch.data.loader import (
    CHAOS_BAD_IMAGES_ENV,
    DetectionLoader,
    HostBatch,
    _service_assembler,
    device_half,
)
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.data.service import (
    CHAOS_SHM_CORRUPT_ENV,
    CHAOS_SUICIDE_ENV,
    CHAOS_WEDGE_ENV,
    WATCHDOG_ENV,
    InputService,
    InputServiceDead,
)

KW = dict(dataset="synthetic", image_size=(96, 128), short_side=96, max_side=128,
          max_gt_boxes=8)


def octagon(box):
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    return [[x1 + w * .3, y1, x2 - w * .3, y1, x2, y1 + h * .3, x2, y2 - h * .3,
             x2 - w * .3, y2, x1 + w * .3, y2, x1, y2 - h * .3, x1, y1 + h * .3]]


def make_records(rng, n=12, paths=None, bad_class=()):
    """Port and JAX records of uint8 noise: landscape 96x128 and, every
    third, portrait 120x90; two boxes (the second a crowd region on every
    fourth), polygon masks; ``paths`` maps an index to an image file."""
    ours, theirs = [], []
    for i in range(n):
        h, w = (120, 90) if i % 3 == 2 else (96, 128)
        boxes = np.array([[4.0, 5.0, w // 2, h // 2], [w // 4, h // 3, w - 2, h - 3]], np.float32)
        classes = np.array([1, 9 if i in bad_class else 2], np.int32)
        ignore = np.array([False, i % 4 == 0])
        path = (paths or {}).get(i, "")
        img = None if path else rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        masks = [octagon(b) for b in boxes.tolist()]
        kw = dict(image_array=img, ignore=ignore, masks=masks)
        ours.append(RoiRecord(f"im{i}", path, h, w, boxes, classes, **kw))
        theirs.append(JaxRecord(f"im{i}", path, h, w, boxes, classes, **kw))
    return ours, theirs


def loader(roidb, cfg=None, **kw):
    kw.setdefault("prefetch", False)
    kw.setdefault("num_workers", 0)
    return DetectionLoader(roidb, cfg or DataConfig(**KW), 2, "cpu", seed=3, **kw)


def copied(batches):
    """Owning copies (a retained zero-copy view would pin its slot)."""
    for b in batches:
        yield HostBatch(*[None if f is None else np.array(f) for f in b])


def assert_same(a, b):
    for x, y in zip(a, b, strict=True):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)


def assert_streams(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b)


@pytest.fixture(scope="module")
def roidb():
    return make_records(np.random.RandomState(0))[0]


@pytest.fixture(scope="module")
def sync_stream(roidb):
    return list(loader(roidb)._raw_train_batches(0, epochs=2))


# -- against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("skip", [0, 5])
def test_spec_stream_is_jaxs_global_stream(rng, skip):
    ours, theirs = make_records(rng)
    ref = JaxLoader(theirs, JaxDataConfig(**KW), batch_size=2, seed=3, prefetch=False,
                    num_workers=0, service_workers=0)
    got = list(loader(ours)._local_spec_stream(skip, epochs=2))
    want = list(ref._global_spec_stream(skip, epochs=2))
    assert got == want and len(got) == 12 - skip
    assert all(type(j) is int for s in got for j in s[0])
    assert all(type(f) is bool for s in got for f in s[1])


def test_host_half_arrays_are_jaxs(rng):
    ours, theirs = make_records(rng)
    props = {r.image_id: {"boxes": rng.rand(7, 4).astype(np.float32) * 60 + [0, 0, 30, 30],
                          "scores": rng.rand(7).astype(np.float32)} for r in ours}
    port = loader(ours, proposals=props, num_proposals=5, with_masks=True)
    ref = JaxLoader(theirs, JaxDataConfig(**KW), batch_size=2, seed=3, prefetch=False,
                    num_workers=0, service_workers=0, proposals=props, num_proposals=5,
                    with_masks=True)
    for spec in itertools.islice(port._local_spec_stream(0), 8):
        hb, want = port._assemble_rows(spec), ref._assemble_rows(spec)
        for f in ("image_hw", "gt_boxes", "gt_classes", "gt_valid", "gt_ignore", "gt_masks",
                  "ext_rois", "ext_valid"):
            np.testing.assert_array_equal(getattr(hb, f), getattr(want, f), err_msg=f)
        images = device_half(hb, "cpu").images.numpy().astype(int)
        assert np.abs(images - want.images.astype(int)).max() <= 1


def test_journal_through_the_service_is_jaxs(rng, tmp_path, monkeypatch):
    ours, theirs = make_records(rng, paths={4: str(tmp_path / "missing.jpg")}, bad_class=(7,))
    monkeypatch.setenv(CHAOS_BAD_IMAGES_ENV, "im1")
    assert JAX_BAD_ENV == CHAOS_BAD_IMAGES_ENV
    port = loader(ours, quarantine_path=str(tmp_path / "port.jsonl"), num_classes=5,
                  io_retries=0, service_workers=2)
    ref = JaxLoader(theirs, JaxDataConfig(**KW), batch_size=2, seed=3, prefetch=False,
                    num_workers=0, service_workers=0, num_classes=5, io_retries=0,
                    quarantine_path=str(tmp_path / "jax.jsonl"))
    n = len(list(copied(port._raw_train_batches(0, epochs=2))))
    assert n == len(list(ref._raw_train_batches(0, epochs=2))) == 12

    def rows(path):
        return sorted(({k: v for k, v in r.items() if k not in ("ts", "ts_mono_ns")}
                       for r in quarantine_read(path)), key=lambda r: r["image_id"])

    got, want = rows(str(tmp_path / "port.jsonl")), rows(str(tmp_path / "jax.jsonl"))
    assert got == want
    assert [(r["image_id"], r["reason"]) for r in got] == [
        ("im1", "io"), ("im4", "io"), ("im7", "annotation")]


# -- against the port's synchronous stream ------------------------------------------


@pytest.mark.parametrize("workers", [1, 3])
def test_service_is_the_sync_stream(roidb, sync_stream, workers):
    port = loader(roidb, service_workers=workers)
    assert_streams(list(copied(port._raw_train_batches(0, epochs=2))), sync_stream)
    (run,) = port.service_runs
    assert len(run["hellos"]) == workers and not any(h["cuda"] for h in run["hellos"])
    assert run["deaths"] == 0 and not mp.active_children()


def test_resume_skip_is_the_sync_tail(roidb, sync_stream):
    port = loader(roidb, service_workers=2)
    assert_streams(list(copied(port._raw_train_batches(5, epochs=2))), sync_stream[5:])


def test_worker_sigkill_is_invisible(roidb, sync_stream):
    before = {p.pid for p in mp.active_children()}
    t0 = time.monotonic_ns()  # the flight ring is bounded: select by time, not position
    port = loader(roidb, service_workers=2, worker_respawns=2)
    got, killed = [], False
    for batch in copied(port._raw_train_batches(0, epochs=2)):
        got.append(batch)
        if not killed and len(got) == 2:
            workers = [p for p in mp.active_children() if p.pid not in before]
            os.kill(workers[0].pid, signal.SIGKILL)
            killed = True
    assert killed
    assert_streams(got, sync_stream)
    (run,) = port.service_runs
    # The respawn is issued at the death; whether its hello lands before the
    # survivor finishes the stream is boot timing, which the service does
    # not promise.  A worker's hello precedes its first batch, so at least
    # one arrived.
    deaths = [e for e in obs.flight().entries()
              if e.get("subsystem") == "data" and e.get("kind") == "worker_death"
              and e["ts_mono_ns"] > t0]
    assert run["deaths"] == 1
    assert len(deaths) == 1 and deaths[0]["payload"]["respawns_left"] == 1
    assert 1 <= len(run["hellos"]) <= 3 and not any(h["cuda"] for h in run["hellos"])


def test_wedged_worker_is_reaped_and_invisible(roidb, sync_stream, tmp_path, monkeypatch):
    monkeypatch.setenv(WATCHDOG_ENV, "2")
    monkeypatch.setenv(CHAOS_WEDGE_ENV, f"1:{tmp_path / 'wedge.sentinel'}")
    t0 = time.monotonic_ns()  # the flight ring is bounded: select by time, not position
    port = loader(roidb, service_workers=2)
    assert_streams(list(copied(port._raw_train_batches(0, epochs=2))), sync_stream)
    wedged = [e for e in obs.flight().entries()
              if e["kind"] == "worker_wedged" and e["ts_mono_ns"] > t0]
    # Reaped once its heartbeat aged past the watchdog, by a poll after it
    # (late by however long a loaded host takes to schedule the poll).
    assert len(wedged) == 1 and 2.0 <= wedged[0]["payload"]["heartbeat_age_s"] < 10.0
    assert port.service_runs[0]["deaths"] == 1


def test_corrupt_slot_is_quarantined_and_invisible(roidb, sync_stream, tmp_path, monkeypatch):
    monkeypatch.setenv(CHAOS_SHM_CORRUPT_ENV, "3")
    counter = obs.counter("data_shm_quarantines_total")
    shipped = obs.counter("data_shm_bytes_total")
    c0, s0 = counter.value(service="input-service", reason="shm_checksum"), \
        shipped.value(service="input-service")
    qpath = str(tmp_path / "q.jsonl")
    port = loader(roidb, service_workers=2, quarantine_path=qpath)
    assert_streams(list(copied(port._raw_train_batches(0, epochs=2))), sync_stream)
    assert counter.value(service="input-service", reason="shm_checksum") == c0 + 1
    assert shipped.value(service="input-service") > s0
    (rec,) = quarantine_read(qpath)
    assert (rec["kind"], rec["batch_index"], rec["reason"]) == ("shm_slot", 3, "shm_checksum")


def _service(port, fallback, qpath=None):
    return InputService(specs=port._local_spec_stream(0, epochs=1),
                        assemble=port._assemble_rows, builder=_service_assembler,
                        payload=port._worker_payload(), num_workers=1, respawns=0,
                        fallback=fallback, quarantine_path=qpath)


def test_spent_budget_raises_typed_or_falls_back(roidb, sync_stream, tmp_path, monkeypatch):
    monkeypatch.setenv(CHAOS_SUICIDE_ENV, "always")
    port = loader(roidb[:4])
    svc = _service(port, fallback=False)
    try:
        with pytest.raises(InputServiceDead):
            list(svc)
    finally:
        svc.close()
    qpath = str(tmp_path / "q.jsonl")
    svc = _service(port, fallback=True, qpath=qpath)
    try:
        got = list(svc)
    finally:
        svc.close()
    assert svc.deaths == 1 and svc.fell_back
    assert_streams(got, list(loader(roidb[:4])._raw_train_batches(0, epochs=1)))
    assert [r["reason"] for r in quarantine_read(qpath)] == ["service_fallback"]


def test_pool_drains_bounded_epochs(roidb, sync_stream):
    assert len(sync_stream) == 12
    for workers in (2, 4):
        assert_streams(list(loader(roidb, num_workers=workers)._raw_train_batches(0, epochs=2)),
                       sync_stream)


def test_eval_backends_give_the_sync_bytes(roidb):
    def run(**kw):
        port = DetectionLoader(roidb, DataConfig(**KW), 2, "cpu", train=False, **kw)
        return [(b, [r.image_id for r in recs]) for b, recs in port.eval_batch_range(0, 4)]

    want = run()
    for kw in (dict(num_workers=4), dict(service_workers=2)):
        got = run(**kw)
        assert len(got) == len(want) == 4
        for (a, ra), (b, rb) in zip(got, want):
            assert ra == rb
            assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))
