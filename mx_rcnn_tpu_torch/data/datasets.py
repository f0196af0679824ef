"""Dataset readers producing roidb records (port of
``mx_rcnn_tpu/data/datasets.py``).

* :class:`SyntheticDataset`: deterministic images with filled,
  class-textured rectangles on a noise background, rendered in numpy
  exactly as the JAX package renders them with ``dtype="uint8"`` (its
  "classic" palette), so both packages see the same pixels and boxes for
  the same (seed, index).  The "wheel" palette and float32 pixels are not
  ported: the port's loader takes uint8 only.
* :class:`CocoDataset`: COCO detection annotations read with ``json``
  (no pycocotools), the 91 sparse category ids mapped to 1..80; crowd
  annotations kept as ignore regions.  Segmentations are not read (Mask
  R-CNN is not ported).
* :class:`VocDataset`: PASCAL VOC annotations read with ``xml.etree``;
  difficult objects kept as ignore regions unless ``use_diff``.

The parsed-roidb cache (``data.cache_dir``) is not ported.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data.roidb import RoiRecord

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class SyntheticDataset:
    name = "synthetic"

    def __init__(self, num_images: int = 64, image_hw: tuple[int, int] = (128, 128),
                 num_classes: int = 5, max_objects: int = 4, seed: int = 0) -> None:
        self.num_images = num_images
        self.image_hw = image_hw
        self.num_classes = num_classes  # incl. background 0
        self.max_objects = max_objects
        self.seed = seed
        self.classes = ("__background__",) + tuple(f"shape{c}" for c in range(1, num_classes))

    def __len__(self) -> int:
        return self.num_images

    def record(self, idx: int) -> RoiRecord:
        """Record ``idx``, rendered on access."""
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.image_hw
        img = rng.uniform(0, 40, size=(h, w, 3)).astype(np.float32)
        n = rng.randint(1, self.max_objects + 1)
        boxes, classes = [], []
        for _ in range(n):
            cls = rng.randint(1, self.num_classes)
            bw = rng.randint(h // 8, h // 2)
            bh = rng.randint(h // 8, h // 2)
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            # Class-specific color and stripes whose period encodes the class.
            yy, xx = np.mgrid[y1 : y1 + bh, x1 : x1 + bw]
            stripe = ((xx // (cls + 1) + yy // (cls + 1)) % 2).astype(np.float32)
            color = np.array([80 + 40 * cls, 255 - 35 * cls, 120 + 25 * (cls % 3)], np.float32)
            img[y1 : y1 + bh, x1 : x1 + bw] = color * (0.6 + 0.4 * stripe[..., None])
            boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
            classes.append(cls)
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
        return RoiRecord(image_id=str(idx), image_path="", height=h, width=w,
                         boxes=np.asarray(boxes, np.float32),
                         gt_classes=np.asarray(classes, np.int32), image_array=img)

    def roidb(self) -> list[RoiRecord]:
        return [self.record(i) for i in range(self.num_images)]


class CocoDataset:
    """COCO detection annotations, ``<root>/annotations/instances_<split>.json``,
    images under ``<root>/<split>/``."""

    name = "coco"

    def __init__(self, root: str, split: str = "train2017") -> None:
        self.root = root
        self.split = split
        with open(os.path.join(root, "annotations", f"instances_{split}.json")) as f:
            d = json.load(f)
        cats = sorted(d["categories"], key=lambda c: c["id"])
        self.classes = ("__background__",) + tuple(c["name"] for c in cats)
        self.cat_to_label = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self.label_to_cat = {v: k for k, v in self.cat_to_label.items()}
        self._images = {im["id"]: im for im in d["images"]}
        self._anns: dict[int, list] = {}
        for a in d["annotations"]:
            self._anns.setdefault(a["image_id"], []).append(a)

    def roidb(self) -> list[RoiRecord]:
        out = []
        for img_id, im in self._images.items():
            # Crowd annotations are kept as ignore regions, after the others.
            anns = sorted(self._anns.get(img_id, []), key=lambda a: bool(a.get("iscrowd", 0)))
            boxes, classes, crowd = [], [], []
            for a in anns:
                x, y, bw, bh = a["bbox"]
                if bw < 1 or bh < 1:
                    continue
                boxes.append([x, y, x + max(bw - 1, 0), y + max(bh - 1, 0)])
                classes.append(self.cat_to_label[a["category_id"]])
                crowd.append(bool(a.get("iscrowd", 0)))
            out.append(RoiRecord(
                image_id=str(img_id),
                image_path=os.path.join(self.root, self.split, im["file_name"]),
                height=im["height"], width=im["width"],
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                gt_classes=np.asarray(classes, np.int32),
                ignore=np.asarray(crowd, bool),
            ))
        return out


class VocDataset:
    """PASCAL VOC; ``split`` is "<year>_<imageset>" (e.g. "2007_trainval")
    under the VOCdevkit layout at ``root``."""

    name = "voc"

    def __init__(self, root: str, split: str = "2007_trainval", use_diff: bool = False) -> None:
        self.root = root
        year, imageset = split.split("_")
        self.year, self.imageset = year, imageset
        self.devkit = os.path.join(root, f"VOC{year}")
        self.use_diff = use_diff
        self.classes = ("__background__",) + VOC_CLASSES
        self._cls_index = {c: i for i, c in enumerate(self.classes)}
        with open(os.path.join(self.devkit, "ImageSets", "Main", f"{imageset}.txt")) as f:
            self.image_index = [line.strip() for line in f if line.strip()]

    def _parse(self, idx: str) -> RoiRecord:
        tree = ET.parse(os.path.join(self.devkit, "Annotations", f"{idx}.xml"))
        size = tree.find("size")
        h = int(size.find("height").text)
        w = int(size.find("width").text)
        # Difficult objects are kept as ignore regions (unless use_diff),
        # after the others.
        objs = []
        for obj in tree.findall("object"):
            name = obj.find("name").text.lower().strip()
            if name not in self._cls_index:
                continue
            difficult = bool(int(obj.find("difficult").text or 0))
            objs.append((difficult and not self.use_diff, name, obj))
        objs.sort(key=lambda t: t[0])
        boxes, classes, ignore = [], [], []
        for ign, name, obj in objs:
            bb = obj.find("bndbox")
            # VOC is 1-based pixel coords.
            boxes.append([float(bb.find(k).text) - 1 for k in ("xmin", "ymin", "xmax", "ymax")])
            classes.append(self._cls_index[name])
            ignore.append(ign)
        return RoiRecord(
            image_id=idx,
            image_path=os.path.join(self.devkit, "JPEGImages", f"{idx}.jpg"),
            height=h, width=w,
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            gt_classes=np.asarray(classes, np.int32),
            ignore=np.asarray(ignore, bool),
        )

    def roidb(self) -> list[RoiRecord]:
        return [self._parse(i) for i in self.image_index]


def build_dataset(cfg: DataConfig, split: Optional[str] = None, train: bool = True):
    """The dataset of ``cfg.data.dataset`` for ``split`` (default: the
    config's train or val split)."""
    if cfg.cache_dir:
        raise NotImplementedError("data.cache_dir: the roidb cache is not ported")
    split = split or (cfg.train_split if train else cfg.val_split)
    if cfg.dataset == "synthetic":
        return SyntheticDataset(image_hw=cfg.image_size)
    if cfg.dataset == "coco":
        return CocoDataset(cfg.root, split)
    if cfg.dataset == "voc":
        return VocDataset(cfg.root, split, use_diff=cfg.use_diff)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
