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

With ``data.cache_dir`` set, COCO and VOC roidbs are pickled there on
first parse and read back while their annotation files are unchanged
(:class:`_CachedRoidb`).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import uuid
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


# Bump when roidb PARSING changes (crowd ordering, box conventions, new
# RoiRecord fields): the fingerprint only sees the annotation files, so a
# parser fix must invalidate existing caches itself.
_CACHE_VERSION = 2


class _CachedRoidb:
    """Lazy parsed-roidb pickle cache (the reference's
    ``data/cache/<name>_gt_roidb.pkl``).  On a hit the dataset is never
    constructed, which skips the COCO annotation json parse.  Entries are
    keyed by the dataset root and the annotation source's fingerprint, so
    edited annotations re-parse and a relocated copy misses.  The key also
    names this package: a pickle of the JAX package's records, in a
    ``cache_dir`` both packages share, is never read here (unpickling it
    would import that package).  Attribute access (``classes`` etc.)
    constructs the dataset on demand."""

    def __init__(self, factory, name: str, cache_dir: str, split: str,
                 root: str, fingerprint) -> None:
        self._factory = factory
        self._name = name
        self._cache_dir = cache_dir
        self._split = split
        self._root = root
        self._fingerprint = fingerprint  # () -> Optional[str]
        self._ds = None

    def _dataset(self):
        if self._ds is None:
            self._ds = self._factory()
        return self._ds

    def __getattr__(self, name):
        return getattr(self._dataset(), name)

    def roidb(self) -> list[RoiRecord]:
        fp = self._fingerprint()
        if fp is None:
            return self._dataset().roidb()
        key = hashlib.sha1(
            f"mx_rcnn_tpu_torch|v{_CACHE_VERSION}|{os.path.abspath(self._root)}|{fp}".encode()
        ).hexdigest()[:16]
        path = os.path.join(self._cache_dir, f"{self._name}_{self._split}_{key}_gt_roidb.pkl")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    return pickle.load(f)
            except (OSError, EOFError, ImportError, AttributeError, TypeError, ValueError,
                    pickle.UnpicklingError):
                pass  # a torn or stale entry: re-parse and replace it below
        roidb = self._dataset().roidb()
        os.makedirs(self._cache_dir, exist_ok=True)
        # A unique tmp per writer: concurrent starts over one cache_dir
        # must not interleave into one file.
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(roidb, f)
        os.replace(tmp, path)
        return roidb


def _mtime_fingerprint(path: str) -> Optional[str]:
    """mtime_ns and size of one file, or None if unreadable (no cache)."""
    try:
        st = os.stat(path)
        return f"{st.st_mtime_ns}:{st.st_size}"
    except OSError:
        return None


def _voc_fingerprint(devkit: str, index_file: str) -> Optional[str]:
    """The ImageSets file's fingerprint, the newest Annotations xml mtime,
    the xml count and their total size: editing any annotation, or
    replacing one with an older copy, invalidates."""
    base = _mtime_fingerprint(index_file)
    if base is None:
        return None
    newest = count = total = 0
    try:
        with os.scandir(os.path.join(devkit, "Annotations")) as it:
            for e in it:
                if e.name.endswith(".xml"):
                    st = e.stat()
                    newest = max(newest, st.st_mtime_ns)
                    count += 1
                    total += st.st_size
    except OSError:
        return None
    return f"{base}|{newest}:{count}:{total}"


def build_dataset(cfg: DataConfig, split: Optional[str] = None, train: bool = True):
    """The dataset of ``cfg.dataset`` for ``split`` (default: the config's
    train or val split), behind the roidb cache when ``cfg.cache_dir``."""
    split = split or (cfg.train_split if train else cfg.val_split)
    if cfg.dataset == "synthetic":
        return SyntheticDataset(image_hw=cfg.image_size)
    if cfg.dataset == "coco":
        factory = lambda: CocoDataset(cfg.root, split)  # noqa: E731
        ann = os.path.join(cfg.root, "annotations", f"instances_{split}.json")
        fingerprint = lambda: _mtime_fingerprint(ann)  # noqa: E731
    elif cfg.dataset == "voc":
        factory = lambda: VocDataset(cfg.root, split, use_diff=cfg.use_diff)  # noqa: E731
        year, imageset = split.split("_")
        devkit = os.path.join(cfg.root, f"VOC{year}")
        index = os.path.join(devkit, "ImageSets", "Main", f"{imageset}.txt")
        # use_diff changes the parse (difficult promoted to real gt).
        fingerprint = lambda: (  # noqa: E731
            None if (fp := _voc_fingerprint(devkit, index)) is None
            else f"{fp}|diff{int(cfg.use_diff)}"
        )
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    if cfg.cache_dir:
        return _CachedRoidb(factory, cfg.dataset, cfg.cache_dir, split, cfg.root, fingerprint)
    return factory()
