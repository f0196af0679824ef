"""The port's roidb readers and eval batching against the JAX package, on
annotation files the tests write themselves (no dataset on disk).

  * the COCO json and VOC xml readers give the JAX readers' roidbs, field
    by field, bitwise (crowd and difficult regions, sparse category ids,
    degenerate boxes, ``use_diff``);
  * the synthetic set's roidb and class names equal JAX's ``uint8`` set;
  * the eval schedule (landscape first, then portrait, a short batch
    padded with its last record) equals ``DetectionLoader.eval_specs``;
  * a portrait record letterboxes into the transposed canvas as the JAX
    loader does: the same scale, ``image_hw``, scaled gt, and pixels
    bitwise where no resize is needed (within 1 of 255 where cv2's
    fixed-point uint8 resize meets torch's float bilinear).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data import datasets as JD
from mx_rcnn_tpu.data.loader import DetectionLoader
from mx_rcnn_tpu.data.loader import load_image as jax_load_image
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu.data.roidb import filter_roidb as jax_filter_roidb
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.data import datasets as TD
from mx_rcnn_tpu_torch.data.loader import (
    assemble,
    eval_index_specs,
    load_image,
    record_canvas,
    record_scale,
)
from mx_rcnn_tpu_torch.data.roidb import RoiRecord, filter_roidb

FIELDS = ("image_id", "image_path", "height", "width", "flipped")


def assert_same_roidb(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        for f in ("boxes", "gt_classes", "ignore_flags"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.aspect == b.aspect
        if b.image_array is None:
            assert a.image_array is None
        else:
            np.testing.assert_array_equal(a.image_array, b.image_array)


def write_coco(root, split="val2017"):
    (root / "annotations").mkdir(parents=True)
    cats = [{"id": 1, "name": "person"}, {"id": 18, "name": "dog"}, {"id": 90, "name": "toothbrush"}]
    images = [{"id": 42, "file_name": "a.jpg", "height": 480, "width": 640},
              {"id": 7, "file_name": "b.jpg", "height": 640, "width": 427},
              {"id": 9, "file_name": "c.jpg", "height": 300, "width": 300}]
    anns = [
        {"image_id": 42, "bbox": [10.5, 20.25, 100.0, 50.0], "category_id": 18, "iscrowd": 1},
        {"image_id": 42, "bbox": [0, 0, 640, 480], "category_id": 1, "iscrowd": 0},
        {"image_id": 42, "bbox": [5, 5, 0.5, 10], "category_id": 90},        # degenerate
        {"image_id": 42, "bbox": [300.7, 200.1, 33.3, 1.0], "category_id": 90},
        {"image_id": 7, "bbox": [1, 2, 3, 4], "category_id": 1, "iscrowd": 1},
    ]
    (root / "annotations" / f"instances_{split}.json").write_text(
        json.dumps({"categories": cats[::-1], "images": images, "annotations": anns}))


VOC_OBJ = ("<object><name>{}</name><difficult>{}</difficult><bndbox><xmin>{}</xmin>"
           "<ymin>{}</ymin><xmax>{}</xmax><ymax>{}</ymax></bndbox></object>")


def write_voc(root):
    dev = root / "VOC2007"
    (dev / "ImageSets" / "Main").mkdir(parents=True)
    (dev / "Annotations").mkdir()
    (dev / "ImageSets" / "Main" / "test.txt").write_text("000001\n\n000002\n")
    objs = {"000001": [("dog", 1, 10, 20, 110, 220), ("Person ", 0, 1, 1, 500, 375),
                       ("unicorn", 0, 1, 1, 5, 5), ("tvmonitor", 0, 48, 240, 195, 371)],
            "000002": [("cat", 1, 3, 4, 50, 60)]}
    sizes = {"000001": (375, 500), "000002": (500, 333)}
    for idx, obs in objs.items():
        h, w = sizes[idx]
        (dev / "Annotations" / f"{idx}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
            + "".join(VOC_OBJ.format(*o) for o in obs) + "</annotation>")


def test_coco_reader_matches_jax(tmp_path):
    write_coco(tmp_path)
    ours, theirs = TD.CocoDataset(str(tmp_path), "val2017"), JD.CocoDataset(str(tmp_path), "val2017")
    assert ours.classes == theirs.classes and ours.label_to_cat == theirs.label_to_cat
    assert_same_roidb(ours.roidb(), theirs.roidb())
    assert_same_roidb(filter_roidb(ours.roidb()), jax_filter_roidb(theirs.roidb()))
    assert ours.roidb()[0].ignore_flags.tolist() == [False, False, True]


@pytest.mark.parametrize("use_diff", [False, True])
def test_voc_reader_matches_jax(tmp_path, use_diff):
    write_voc(tmp_path)
    ours = TD.VocDataset(str(tmp_path), "2007_test", use_diff=use_diff)
    theirs = JD.VocDataset(str(tmp_path), "2007_test", use_diff=use_diff)
    assert ours.classes == theirs.classes and TD.VOC_CLASSES == JD.VOC_CLASSES
    assert_same_roidb(ours.roidb(), theirs.roidb())
    assert ours.roidb()[1].ignore_flags.tolist() == [not use_diff]


def test_build_dataset_matches_jax(tmp_path):
    write_coco(tmp_path)
    write_voc(tmp_path)
    for over in (dict(dataset="coco", root=str(tmp_path)),
                 dict(dataset="voc", root=str(tmp_path), val_split="2007_test")):
        ours = TD.build_dataset(dataclasses.replace(get_config("r50_fpn_coco").data, **over),
                                train=False)
        theirs = JD.build_dataset(
            dataclasses.replace(jax_get_config("r50_fpn_coco").data, **over), train=False)
        assert_same_roidb(ours.roidb(), theirs.roidb())
    # data.cache_dir: the roidb comes through the cache, still equal to JAX's.
    over = dict(dataset="coco", root=str(tmp_path), cache_dir=str(tmp_path / "c"))
    cached = TD.build_dataset(dataclasses.replace(get_config("r50_fpn_coco").data, **over),
                              train=False)
    theirs = JD.build_dataset(dataclasses.replace(jax_get_config("r50_fpn_coco").data, **over),
                              train=False)
    assert_same_roidb(cached.roidb(), theirs.roidb())
    assert_same_roidb(cached.roidb(), theirs.roidb())   # the second read hits the cache
    with pytest.raises(ValueError, match="unknown dataset"):
        TD.build_dataset(dataclasses.replace(get_config("tiny_synthetic").data, dataset="x"))


def test_synthetic_roidb_matches_jax():
    ours = TD.SyntheticDataset(num_images=5, image_hw=(96, 128), num_classes=7, seed=3)
    theirs = JD.SyntheticDataset(num_images=5, image_hw=(96, 128), num_classes=7, seed=3,
                                 dtype="uint8")
    assert ours.classes == theirs.classes
    assert_same_roidb(ours.roidb(), theirs.roidb())
    built = TD.build_dataset(get_config("tiny_synthetic").data, train=False)
    assert (built.num_images, built.image_hw, built.num_classes) == (64, (128, 128), 5)


def test_load_image_decodes_files_as_jax_does(tmp_path):
    from PIL import Image

    pixels = np.random.RandomState(0).randint(0, 256, (20, 30, 3)).astype(np.uint8)
    Image.fromarray(pixels).save(tmp_path / "x.png")
    rec = RoiRecord("x", str(tmp_path / "x.png"), 20, 30, np.zeros((0, 4), np.float32),
                    np.zeros(0, np.int32))
    jrec = JaxRecord("x", str(tmp_path / "x.png"), 20, 30, rec.boxes, rec.gt_classes)
    np.testing.assert_array_equal(load_image(rec), pixels)
    np.testing.assert_array_equal(load_image(rec), jax_load_image(jrec))


def _records(sizes, seed=0):
    """Port and JAX records of (h, w) sizes with uint8 noise pixels and a
    few boxes, a crowd region in the second."""
    rng = np.random.RandomState(seed)
    ours, theirs = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        boxes = np.array([[1, 2, w // 2, h // 2], [w // 4, h // 3, w - 1, h - 1]], np.float32)
        classes = np.array([1, 2], np.int32)
        ignore = np.array([False, i == 1])
        ours.append(RoiRecord(str(i), "", h, w, boxes, classes, image_array=img, ignore=ignore))
        theirs.append(JaxRecord(str(i), "", h, w, boxes, classes, image_array=img, ignore=ignore))
    return ours, theirs


def _jax_loader(recs, data, batch_size):
    return DetectionLoader(recs, data, batch_size=batch_size, train=False, prefetch=False,
                           num_workers=0, service_workers=0)


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_eval_schedule_matches_jax(batch_size):
    sizes = [(48, 64), (64, 48), (40, 80), (72, 40), (64, 64), (50, 60), (60, 50)]
    ours, theirs = _records(sizes)
    jdata = dataclasses.replace(jax_get_config("tiny_synthetic").data, image_size=(64, 96))
    data = dataclasses.replace(get_config("tiny_synthetic").data, image_size=(64, 96))
    want = [([r.image_id for r in rows], [r.image_id for r in recs])
            for rows, recs in _jax_loader(theirs, jdata, batch_size).eval_specs()]
    got = [([ours[j].image_id for j in rows], [ours[j].image_id for j in idxs])
           for rows, idxs in eval_index_specs(ours, data, batch_size)]
    assert got == want
    assert any(len(rows) > len(idxs) for rows, idxs in got) == (batch_size > 1)
    square = dataclasses.replace(data, image_size=(96, 96))
    assert [i for _, idxs in eval_index_specs(ours, square, batch_size) for i in idxs] == \
        list(range(len(sizes)))


@pytest.mark.parametrize("sizes", [[(96, 64), (90, 60)], [(130, 70), (100, 61)], [(48, 64)]],
                         ids=["portrait-unscaled", "portrait-resized", "landscape"])
def test_record_letterboxes_like_jax(sizes):
    """A portrait record takes the transposed canvas, its scale, true size
    and gt from it, as in the JAX loader (this failed before the repair:
    the port letterboxed every record into the landscape canvas)."""
    data = dataclasses.replace(get_config("tiny_synthetic").data, image_size=(64, 96),
                               short_side=64, max_side=96)
    jdata = dataclasses.replace(jax_get_config("tiny_synthetic").data, image_size=(64, 96),
                                short_side=64, max_side=96)
    ours, theirs = _records(sizes, seed=1)
    loader = _jax_loader(theirs, jdata, len(sizes))
    want = loader._assemble(theirs, [False] * len(theirs))
    got = assemble(ours, data, "cpu")
    for o, t in zip(ours, theirs):
        assert record_canvas(data, o) == loader.record_canvas(t)
        assert record_scale(data, o) == loader.record_scale(t)
    assert got.images.shape == want.images.shape and got.images.dtype == torch.uint8
    np.testing.assert_array_equal(got.image_hw.numpy(), want.image_hw)
    for f in ("gt_boxes", "gt_classes", "gt_valid", "gt_ignore"):
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    diff = np.abs(got.images.numpy().astype(int) - want.images.astype(int))
    exact = all(record_scale(data, o) == 1.0 for o in ours)
    assert diff.max() <= (0 if exact else 1)


def test_assemble_refuses_mixed_orientations():
    data = dataclasses.replace(get_config("tiny_synthetic").data, image_size=(64, 96))
    ours, _ = _records([(48, 64), (64, 48)])
    with pytest.raises(ValueError, match="two orientations"):
        assemble(ours, data, "cpu")
    square = dataclasses.replace(data, image_size=(96, 96))
    assert assemble(ours, square, "cpu").images.shape == (2, 96, 96, 3)
