"""The port's train loader against ``mx_rcnn_tpu.data.DetectionLoader`` on
roidbs the tests write themselves (no dataset on disk).

  * the schedule, ``(roidb indices, flips)`` a batch, bitwise over 3
    epochs: square and non-square canvases, flips on and off, aspect
    grouping on and off (square only: a non-square canvas requires it),
    batch sizes that leave odd group tails, two seeds; ``iter_from(k)``
    is the stream's tail;
  * assembled train batches with flips: boxes, classes, ``gt_valid`` and
    ``gt_ignore`` bitwise, ``image_hw`` equal, pixels within 1 of 255
    where the record is resized (torch bilinear against cv2's fixed-point
    ``INTER_LINEAR``) and bitwise where it is not;
  * quarantine: the same ids and journal fields (a missing file, an
    inverted box), each journaled once, blank stand-ins with no valid gt;
  * ``gt_ignore`` is decided over the whole roidb, for train and eval
    batches alike (the port decided it a batch at a time before);
  * ``load_image``: a missing file raises ``FileNotFoundError`` with or
    without PIL, an existing file without PIL a ``RuntimeError`` that the
    loader does not quarantine;
  * the roidb cache: a hit skips the parse, an edited annotation file or
    a relocated root misses, as ``tests/test_data.py::TestRoidbCache``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
import time

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data import datasets as JD
from mx_rcnn_tpu.data.cache import quarantine_read as jax_quarantine_read
from mx_rcnn_tpu.data.loader import DetectionLoader as JaxLoader
from mx_rcnn_tpu.data.loader import annotation_error as jax_annotation_error
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu.data.transforms import hflip as jax_hflip
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.data import datasets as TD
from mx_rcnn_tpu_torch.data import loader as TL
from mx_rcnn_tpu_torch.data.cache import quarantine_append, quarantine_read
from mx_rcnn_tpu_torch.data.loader import DetectionLoader, annotation_error, eval_batches, load_image
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.data.transforms import hflip
from test_torch_datasets import assert_same_roidb, write_coco, write_voc


torch.set_num_threads(2)
SQUARE, WIDE = (96, 96), (64, 96)
JOURNAL_FIELDS = ("image_id", "path", "reason", "error", "retries")


def _cfgs(**over):
    base = dict(short_side=64, max_side=96, max_gt_boxes=6)
    base.update(over)
    return (dataclasses.replace(get_config("tiny_synthetic").data, **base),
            dataclasses.replace(jax_get_config("tiny_synthetic").data, **base))


def _records(sizes, seed=0, crowd=(1,), paths=None):
    """Port and JAX records of (h, w) sizes: uint8 noise pixels (or the
    file ``paths[i]``), two boxes, the second a crowd region in the
    records ``crowd`` names."""
    rng = np.random.RandomState(seed)
    ours, theirs = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        path = (paths or {}).get(i, "")
        boxes = np.array([[1.5, 2, w // 2, h // 2], [w // 4, h // 3, w - 1, h - 1.25]],
                         np.float32)
        classes = np.array([1, 2], np.int32)
        ignore = np.array([False, i in crowd])
        kw = dict(image_array=None if path else img, ignore=ignore)
        ours.append(RoiRecord(str(i), path, h, w, boxes, classes, **kw))
        theirs.append(JaxRecord(str(i), path, h, w, boxes, classes, **kw))
    return ours, theirs


def _loaders(ours, theirs, canvas, batch_size, seed=0, tmp_path=None, **over):
    data, jdata = _cfgs(image_size=canvas, **over)
    q = {}
    if tmp_path is not None:
        q = dict(port=str(tmp_path / "port.jsonl"), jax=str(tmp_path / "jax.jsonl"))
    # Both synchronous (no pool, no read-ahead), so that what a test counts
    # (decodes, quarantines) is what the consumed batches needed.
    port = DetectionLoader(ours, data, batch_size, "cpu", seed=seed,
                           quarantine_path=q.get("port"), io_retries=0, prefetch=False,
                           num_workers=0)
    ref = JaxLoader(theirs, jdata, batch_size=batch_size, train=True, seed=seed, prefetch=False,
                    num_workers=0, service_workers=0, quarantine_path=q.get("jax"),
                    io_retries=0)
    return port, ref


# Odd group sizes: 7 landscape (aspect >= 1, square included) and 4 portrait.
SIZES = [(48, 64), (64, 48), (40, 80), (72, 40), (64, 64), (50, 60), (60, 50), (30, 90),
         (90, 30), (44, 44), (33, 70)]


def _spec_list(specs, n):
    return [([int(j) for j in idx], [bool(f) for f in fl])
            for idx, fl in itertools.islice(specs, n)]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("batch_size", [2, 3])
@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("canvas,grouping", [(SQUARE, True), (SQUARE, False), (WIDE, True)],
                         ids=["square-grouped", "square-shuffled", "wide-grouped"])
def test_schedule_matches_jax(seed, batch_size, flip, canvas, grouping):
    ours, theirs = _records(SIZES)
    port, ref = _loaders(ours, theirs, canvas, batch_size, seed, flip=flip,
                         aspect_grouping=grouping)
    want = list(ref._batch_index_specs(epochs=3))
    got = list(port._batch_index_specs(epochs=3))
    assert _spec_list(iter(got), len(got)) == _spec_list(iter(want), len(want))
    assert len(got) == 3 * len(port._epoch_batches(0))
    if not flip:
        assert not any(f for _, fl in got for f in fl)
    if grouping and canvas == WIDE:
        # One orientation a batch, both orientations in the schedule.
        kinds = {tuple(ours[j].aspect >= 1 for j in idx) for idx, _ in got}
        assert kinds == {(True,) * batch_size, (False,) * batch_size}
    # Resume fast-forward: the stream from batch k is the tail of the stream.
    full = _spec_list(port._local_spec_stream(0), len(got))
    for k in (0, 1, 4):
        assert _spec_list(port._local_spec_stream(k), len(full) - k) == full[k:]


def test_non_square_canvas_requires_grouping():
    ours, theirs = _records(SIZES[:4])
    data, jdata = _cfgs(image_size=WIDE, aspect_grouping=False)
    with pytest.raises(ValueError, match="aspect_grouping"):
        DetectionLoader(ours, data, 2, "cpu")
    with pytest.raises(ValueError, match="aspect_grouping"):
        JaxLoader(theirs, jdata, batch_size=2, train=True, prefetch=False, num_workers=0,
                  service_workers=0)


def test_iter_from_skips_without_decoding(monkeypatch):
    ours, theirs = _records(SIZES)
    port, _ = _loaders(ours, theirs, WIDE, 2)
    full = [b.gt_boxes for b in itertools.islice(port.iter_from(0), 5)]
    calls = []
    real = TL.load_image
    monkeypatch.setattr(TL, "load_image", lambda rec: calls.append(rec.image_id) or real(rec))
    tail = [b.gt_boxes for b in itertools.islice(port.iter_from(3), 2)]
    assert len(calls) == 4          # two batches of two, none for the skipped three
    assert all(torch.equal(a, b) for a, b in zip(tail, full[3:]))


def _same_batch(got, want, resized: bool):
    np.testing.assert_array_equal(got.image_hw.numpy(), want.image_hw)
    for f in ("gt_boxes", "gt_classes", "gt_valid", "gt_ignore"):
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    assert got.images.dtype == torch.uint8 and got.images.shape == want.images.shape
    diff = np.abs(got.images.numpy().astype(int) - want.images.astype(int))
    assert diff.max() <= (1 if resized else 0)


@pytest.mark.parametrize("canvas", [WIDE, SQUARE], ids=["wide", "square"])
def test_train_batches_with_flips_match_jax(canvas):
    ours, theirs = _records(SIZES, seed=3)
    port, ref = _loaders(ours, theirs, canvas, 3, seed=2)
    specs = _spec_list(port._local_spec_stream(0), 8)
    assert any(any(fl) for _, fl in specs) and any(not all(fl) for _, fl in specs)
    for idxs, flips in specs:
        got = port._assemble(idxs, flips)
        want = ref._assemble_rows((idxs, flips))
        resized = any(TL.record_scale(port.cfg, ours[j]) != 1.0 for j in idxs)
        _same_batch(got, want, resized)
    # A flipped record's boxes, by hand: x1, x2 = w-1-x2, w-1-x1, then the scale.
    j = next(j for idxs, fl in specs for j, f in zip(idxs, fl) if f)
    rec = ours[j]
    got = port._assemble([j], [True]).gt_boxes[0, :2].numpy()
    b = rec.boxes
    flipped = np.stack([rec.width - 1 - b[:, 2], b[:, 1], rec.width - 1 - b[:, 0], b[:, 3]], 1)
    np.testing.assert_array_equal(got, flipped * np.float32(TL.record_scale(port.cfg, rec)))


def test_hflip_matches_jax():
    img = np.arange(2 * 5 * 3, dtype=np.uint8).reshape(2, 5, 3)
    boxes = np.array([[0.5, 1, 3, 1.5], [0, 0, 4, 1]], np.float32)
    for a, b in zip(hflip(img, boxes, 5), jax_hflip(img, boxes, 5)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_quarantine_matches_jax(tmp_path):
    sizes = [(48, 64), (64, 48), (40, 80), (72, 40), (64, 64)]
    ours, theirs = _records(sizes, paths={1: str(tmp_path / "missing.jpg")})
    for recs in (ours, theirs):          # record 3: an inverted box
        recs[3].boxes = recs[3].boxes[:, [2, 1, 0, 3]].copy()
    assert annotation_error(ours[3]) == jax_annotation_error(theirs[3]) is not None
    assert all(annotation_error(r) is None for i, r in enumerate(ours) if i != 3)
    port, ref = _loaders(ours, theirs, WIDE, 2, tmp_path=tmp_path)
    specs = _spec_list(port._local_spec_stream(0), 12)  # 4 epochs: each record met again
    for idxs, flips in specs:
        got = port._assemble(idxs, flips)
        want = ref._assemble_rows((idxs, flips))
        _same_batch(got, want, resized=True)
        for row, j in enumerate(idxs):
            if j in (1, 3):
                assert not got.gt_valid[row].any() and not got.images[row].any()
    rows = quarantine_read(str(tmp_path / "port.jsonl"))
    jrows = jax_quarantine_read(str(tmp_path / "jax.jsonl"))
    assert [r["image_id"] for r in rows] == ["3", "1"]
    assert [{k: r[k] for k in JOURNAL_FIELDS} for r in rows] == \
        [{k: r[k] for k in JOURNAL_FIELDS} for r in jrows]
    assert rows[1]["error"] == f"FileNotFoundError: {tmp_path / 'missing.jpg'}"


def test_journal_skips_a_torn_line(tmp_path):
    path = str(tmp_path / "q" / "quarantine.jsonl")
    quarantine_append(path, {"image_id": "a"})
    with open(path, "a") as f:
        f.write('{"image_id": "b", "rea\n')       # a corrupt interior line
    quarantine_append(path, {"image_id": "c"})
    with open(path, "a") as f:
        f.write('{"image_id": "d", "rea')         # a torn last line
    rows = quarantine_read(path)
    assert [r["image_id"] for r in rows] == ["a", "c"]
    assert rows[0]["ts_mono_ns"] <= rows[1]["ts_mono_ns"] and "ts" in rows[0]
    assert rows == jax_quarantine_read(path)
    assert quarantine_read(str(tmp_path / "none.jsonl")) == []


def test_gt_ignore_is_decided_over_the_roidb():
    """Only record 0 has a crowd region: a batch without it still carries
    an all-False ``gt_ignore``, in train and eval batches of both
    packages.  (The port decided it from the batch's own records.)"""
    sizes = [(48, 64), (50, 64), (40, 64), (44, 64)]
    ours, theirs = _records(sizes, crowd=(0,))
    port, ref = _loaders(ours, theirs, WIDE, 2)
    assert port.with_ignore and ref.with_ignore
    got = port._assemble([1, 2], [False, True])
    want = ref._assemble_rows(([1, 2], [False, True]))
    assert want.gt_ignore is not None and not want.gt_ignore.any()
    _same_batch(got, want, resized=True)
    data, jdata = _cfgs(image_size=WIDE)
    jeval = JaxLoader(theirs, jdata, batch_size=2, train=False, prefetch=False, num_workers=0,
                      service_workers=0)
    for (got, recs), (want, jrecs) in zip(eval_batches(ours, data, 2, "cpu"), jeval):
        assert [r.image_id for r in recs] == [r.image_id for r in jrecs]
        _same_batch(got, want, resized=True)
    last, _ = list(eval_batches(ours, data, 2, "cpu"))[-1]
    assert last.gt_ignore is not None and not last.gt_ignore.any()
    # A roidb with no ignore region anywhere: no gt_ignore at all.
    clean, _ = _records(sizes, crowd=())
    assert next(eval_batches(clean, data, 2, "cpu"))[0].gt_ignore is None


def _hide_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


@pytest.mark.parametrize("pil", [True, False], ids=["with-pil", "without-pil"])
def test_missing_file_raises_file_not_found(tmp_path, monkeypatch, pil):
    if not pil:
        _hide_pil(monkeypatch)
    rec = RoiRecord("m", str(tmp_path / "gone.jpg"), 20, 30, np.zeros((0, 4), np.float32),
                    np.zeros(0, np.int32))
    with pytest.raises(FileNotFoundError, match="gone.jpg"):
        load_image(rec)


def test_existing_file_without_pil_is_a_hard_error(tmp_path, monkeypatch):
    from PIL import Image

    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(tmp_path / "x.png")
    ours, _ = _records([(20, 30), (20, 30)], paths={0: str(tmp_path / "x.png")})
    _hide_pil(monkeypatch)
    with pytest.raises(RuntimeError, match="needs PIL"):
        load_image(ours[0])
    journal = tmp_path / "q.jsonl"
    loader = DetectionLoader(ours, _cfgs(image_size=(32, 32))[0], 2, "cpu",
                             quarantine_path=str(journal))
    with pytest.raises(RuntimeError, match="needs PIL"):
        next(iter(loader))
    assert not journal.exists() and not loader._quarantined


def test_retry_then_success(monkeypatch):
    calls = {"n": 0}
    real = TL.load_image

    def flaky(rec):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient")
        return real(rec)

    monkeypatch.setattr(TL, "load_image", flaky)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    ours, _ = _records([(32, 32), (32, 32)])
    loader = DetectionLoader(ours, _cfgs(image_size=(32, 32))[0], 2, "cpu", io_retries=2)
    batch = next(iter(loader))
    assert batch.gt_valid.any(dim=1).all() and not loader._quarantined


# -- the roidb cache -----------------------------------------------------------


def _coco_cfg(tmp_path, root):
    return dataclasses.replace(get_config("r50_fpn_coco").data, dataset="coco", root=str(root),
                               cache_dir=str(tmp_path / "cache"))


def test_roidb_cache_hit_skips_parse_and_matches(tmp_path, monkeypatch):
    (tmp_path / "d").mkdir()
    write_coco(tmp_path / "d")
    cfg = _coco_cfg(tmp_path, tmp_path / "d")
    first = TD.build_dataset(cfg, train=False).roidb()
    assert len(list((tmp_path / "cache").glob("*_gt_roidb.pkl"))) == 1
    calls = []
    real = TD.CocoDataset.__init__
    monkeypatch.setattr(TD.CocoDataset, "__init__",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    second = TD.build_dataset(cfg, train=False).roidb()
    assert not calls
    assert_same_roidb(second, first)
    assert_same_roidb(second, JD.build_dataset(
        dataclasses.replace(jax_get_config("r50_fpn_coco").data, dataset="coco",
                            root=str(tmp_path / "d")), train=False).roidb())
    # The dataset's attributes come through the cache object.
    assert TD.build_dataset(cfg, train=False).classes[1] == "person"


def test_roidb_cache_mtime_invalidation(tmp_path):
    (tmp_path / "d").mkdir()
    write_coco(tmp_path / "d")
    cfg = _coco_cfg(tmp_path, tmp_path / "d")
    TD.build_dataset(cfg, train=False).roidb()
    src = tmp_path / "d" / "annotations" / "instances_val2017.json"
    os.utime(src, (time.time() + 10, time.time() + 10))
    TD.build_dataset(cfg, train=False).roidb()
    assert len(list((tmp_path / "cache").glob("*_gt_roidb.pkl"))) == 2


def test_roidb_cache_voc_annotation_edit_invalidates(tmp_path):
    (tmp_path / "d").mkdir()
    write_voc(tmp_path / "d")
    cfg = dataclasses.replace(get_config("r50_fpn_coco").data, dataset="voc",
                              root=str(tmp_path / "d"), val_split="2007_test",
                              cache_dir=str(tmp_path / "cache"))
    first = TD.build_dataset(cfg, train=False).roidb()
    xml = tmp_path / "d" / "VOC2007" / "Annotations" / "000001.xml"
    os.utime(xml, (time.time() + 10, time.time() + 10))
    assert_same_roidb(TD.build_dataset(cfg, train=False).roidb(), first)
    assert len(list((tmp_path / "cache").glob("voc_*_gt_roidb.pkl"))) == 2
    # use_diff changes the parse, so it keys the cache too.
    TD.build_dataset(dataclasses.replace(cfg, use_diff=True), train=False).roidb()
    assert len(list((tmp_path / "cache").glob("voc_*_gt_roidb.pkl"))) == 3


def test_roidb_cache_relocated_root_misses(tmp_path):
    import shutil

    (tmp_path / "a").mkdir()
    write_coco(tmp_path / "a")
    TD.build_dataset(_coco_cfg(tmp_path, tmp_path / "a"), train=False).roidb()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    moved = TD.build_dataset(_coco_cfg(tmp_path, tmp_path / "b"), train=False).roidb()
    assert all(r.image_path.startswith(str(tmp_path / "b")) for r in moved)
    assert len(list((tmp_path / "cache").glob("*_gt_roidb.pkl"))) == 2


def test_roidb_cache_never_reads_the_jax_packages_pickle(tmp_path):
    """Both packages may share a cache_dir: each keys its own file, so the
    port never unpickles the JAX package's records."""
    (tmp_path / "d").mkdir()
    write_coco(tmp_path / "d")
    cfg = _coco_cfg(tmp_path, tmp_path / "d")
    jcfg = dataclasses.replace(jax_get_config("r50_fpn_coco").data, dataset="coco",
                               root=str(tmp_path / "d"), cache_dir=str(tmp_path / "cache"))
    JD.build_dataset(jcfg, train=False).roidb()
    ours = TD.build_dataset(cfg, train=False).roidb()
    assert all(type(r) is RoiRecord for r in ours)
    assert len(list((tmp_path / "cache").glob("*_gt_roidb.pkl"))) == 2


def test_roidb_cache_heals_a_torn_entry(tmp_path):
    (tmp_path / "d").mkdir()
    write_coco(tmp_path / "d")
    cfg = _coco_cfg(tmp_path, tmp_path / "d")
    first = TD.build_dataset(cfg, train=False).roidb()
    (entry,) = (tmp_path / "cache").glob("*_gt_roidb.pkl")
    entry.write_bytes(entry.read_bytes()[:20])
    assert_same_roidb(TD.build_dataset(cfg, train=False).roidb(), first)
    assert_same_roidb(TD.build_dataset(cfg, train=False).roidb(), first)
