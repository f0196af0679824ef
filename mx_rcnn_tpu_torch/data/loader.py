"""Batch assembly and the train schedule (port of
``mx_rcnn_tpu/data/loader.py``).

Each record is letterboxed as uint8 into its oriented canvas (the
landscape ``data.image_size``, transposed for portrait records) by the
loader's scale rule (short side to ``short_side`` unless the long side
passes ``max_side``, clamped to the canvas), its boxes scaled by the same
factor, and its gt padded to ``data.max_gt_boxes`` with ``gt_valid`` (and
``gt_ignore`` where the roidb has crowd or difficult regions anywhere).
Pixels stay uint8; the graph normalizes them
(``detection/graph.py::prep_images``).

**The resize stays on the card; everything before it leaves the
consumer's thread.**  Assembly is two halves, ``assemble(...) ==
device_half(host_half(...))`` bit for bit:

* :func:`host_half`, numpy only and picklable: decode, flip, the gt,
  mask and ``ext_rois`` arrays, and the batch's source pixels packed
  into one flat uint8 array beside their ``(B, 2)`` heights and widths
  (:class:`HostBatch`, ndarray-or-None fields, so the shm ring takes it).
  The thread pool, the input service's workers and the tensor cache stop
  here.
* :func:`device_half`: upload, then each image resized with
  ``data/transforms.py``'s torch bilinear on the device, rounded back to
  uint8 and pasted into the canvas (an image already at its letterbox
  size is not resampled), giving the :class:`~.batch.Batch`.  Resizing
  on the host in torch instead would change the bits: CPU and CUDA
  bilinear are not bitwise equal, and the port's parity with the JAX
  package rests on the stated resize tolerance.

A flipped record's pixels flip on the host and its boxes in original
coordinates before the scale, as the JAX loader flips before its resize.

Training draws batches from :class:`DetectionLoader`, whose schedule
(epoch shuffle, aspect grouping, flips) is the JAX loader's, bit for bit;
its eval form (``train=False``) runs one pass in the JAX loader's eval
order (:func:`eval_index_specs`), with the same quarantine.
Both take external proposals (:func:`load_proposals`'s pkl) for Fast
R-CNN mode: each record's boxes ride the gt boxes' geometry (flip in
original coordinates, the letterbox scale), best ``num_proposals`` by
score, clipped to the resized image and zero-padded with ``ext_valid``.
With ``with_masks`` each gt slot also carries its instance mask,
rasterized on the host over the box at ``GT_MASK_SIZE`` square
(:func:`rasterize_mask`, numpy: the card's machine has no cv2), mirrored
with a flipped record.

The host half runs, as in JAX, in one of three places: in the consumer's
thread; in a thread pool of ``num_workers`` (PIL's decode releases the
GIL), read ahead by a ``loader-prefetch`` thread (:class:`_Prefetched`);
or in the process input service (``data.num_workers`` > 0,
``data/service.py``), whose spawned workers rebuild the loader on the
CPU and never touch the card.  Chaos hooks: ``MX_RCNN_CHAOS_BAD_IMAGES``
makes the named records' loads raise (quarantine and blank), and
``MX_RCNN_CHAOS_NAN_STEPS`` refuses the port's batches as JAX refuses a
uint8 batch: the port's pixels are uint8 only.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import pickle
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.cache import TensorCache, quarantine_append
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.data.transforms import (
    flip_boxes,
    oriented_canvas,
    resize_linear,
    resize_scale,
)
from mx_rcnn_tpu_torch.evalutil.masks import fill_polygons, resize_bilinear, rle_decode

log = logging.getLogger("mx_rcnn_tpu_torch")

# Chaos hook: comma-separated global batch indices whose batches would be
# poisoned with NaN (training only).  The port's pixels are uint8, so the
# loader refuses at that index, as the JAX loader refuses a uint8 batch.
CHAOS_NAN_ENV = "MX_RCNN_CHAOS_NAN_STEPS"
# Chaos hook: comma-separated image ids whose pixel load raises (as a
# corrupt file would): retries, quarantine and a blank, training and eval.
CHAOS_BAD_IMAGES_ENV = "MX_RCNN_CHAOS_BAD_IMAGES"

# Box-relative resolution of the gt instance masks; the graph crops them
# to the mask head's grid a sampled roi (detection/graph.py::crop_gt_masks).
GT_MASK_SIZE = 112


def load_proposals(path: str) -> dict:
    """A proposal pkl (the ``eval_cli --proposals`` format: image_id ->
    {"boxes": (n, 4) in original image coordinates, "scores": (n,)}),
    its schema spot-checked on one entry; the rest are read per image."""
    with open(path, "rb") as f:
        props = pickle.load(f)
    if not isinstance(props, dict) or not props:
        raise ValueError(f"{path}: expected a non-empty image_id->dict map")
    for key, p in props.items():
        boxes = np.asarray(p.get("boxes", None))
        scores = np.asarray(p.get("scores", None))
        if boxes.ndim != 2 or boxes.shape[1] != 4 or scores.shape != boxes.shape[:1]:
            raise ValueError(f"{path}: image {key!r} needs boxes (n, 4) + scores (n,), "
                             f"got {boxes.shape} / {scores.shape}")
        break
    return props


def require_proposals(roidb: Sequence[RoiRecord], proposals: dict) -> None:
    """Raise when a record of ``roidb`` has no entry in ``proposals``."""
    missing = [r.image_id for r in roidb if r.image_id not in proposals]
    if missing:
        raise ValueError(f"{len(missing)} roidb image(s) have no proposals "
                         f"(first: {missing[0]!r})")


def external_rois(rec: RoiRecord, proposals: dict, num_proposals: int, flip: bool,
                  scale: float, th: int, tw: int) -> tuple[np.ndarray, np.ndarray]:
    """The record's proposals as ``(ext_rois (R, 4) float32, ext_valid
    (R,) bool)``, R = ``num_proposals``: flipped in original coordinates,
    the best R by score (a stable sort, ties in file order), scaled,
    clipped to the resized ``th`` x ``tw`` image, zero-padded."""
    p = proposals[rec.image_id]
    pb = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
    ps = np.asarray(p["scores"], np.float32).reshape(len(pb))
    if flip:
        pb = flip_boxes(pb, rec.width)
    order = np.argsort(-ps, kind="mergesort")[:num_proposals]
    pb = pb[order] * scale
    np.clip(pb[:, 0::2], 0.0, tw - 1.0, out=pb[:, 0::2])
    np.clip(pb[:, 1::2], 0.0, th - 1.0, out=pb[:, 1::2])
    rois = np.zeros((num_proposals, 4), np.float32)
    valid = np.zeros((num_proposals,), bool)
    rois[:len(pb)] = pb
    valid[:len(pb)] = True
    return rois, valid


def annotation_error(rec: RoiRecord, num_classes: Optional[int] = None) -> Optional[str]:
    """Why this record's annotations are unusable (malformed box arrays,
    non-finite or inverted coordinates, class ids below 1 or, given
    ``num_classes``, at or above it, ignore flags of another length), or
    None if they are fine."""
    boxes = np.asarray(rec.boxes)
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        return f"boxes shape {boxes.shape} is not (n, 4)"
    if boxes.dtype.kind not in "fiu" or not np.isfinite(boxes.astype(np.float64, copy=False)).all():
        return "non-finite or non-numeric box coordinates"
    if (boxes[:, 2] < boxes[:, 0]).any() or (boxes[:, 3] < boxes[:, 1]).any():
        return "inverted box (x2 < x1 or y2 < y1)"
    cls = np.asarray(rec.gt_classes)
    if cls.shape != (len(boxes),):
        return f"gt_classes shape {cls.shape} does not match {len(boxes)} boxes"
    if len(cls) and cls.min() < 1:
        return "class id < 1 (foreground labels are 1-based)"
    if num_classes is not None and len(cls) and cls.max() >= num_classes:
        return f"class id {int(cls.max())} >= num_classes {num_classes}"
    if rec.ignore is not None and np.asarray(rec.ignore).shape != (len(boxes),):
        return "ignore flags do not match the box count"
    return None


def rasterize_mask(seg, box: np.ndarray) -> np.ndarray:
    """A segmentation -> its (GT_MASK_SIZE,) * 2 float32 mask over ``box``
    (original coordinates, inclusive extent): polygons scaled into the
    grid, rounded and filled; an uncompressed RLE decoded, cropped to the
    box and resized bilinearly.  None (no segmentation) and a compressed
    RLE give zeros, as in JAX."""
    out = np.zeros((GT_MASK_SIZE, GT_MASK_SIZE), np.float32)
    if seg is None:
        return out
    x1, y1, x2, y2 = box
    bw, bh = max(x2 - x1 + 1, 1.0), max(y2 - y1 + 1, 1.0)
    if isinstance(seg, list):  # polygons in image coordinates
        polys = []
        for p in seg:
            pts = np.asarray(p, np.float32).reshape(-1, 2)
            pts[:, 0] = (pts[:, 0] - x1) / bw * GT_MASK_SIZE
            pts[:, 1] = (pts[:, 1] - y1) / bh * GT_MASK_SIZE
            polys.append(pts.round().astype(np.int32))
        out[fill_polygons(polys, GT_MASK_SIZE, GT_MASK_SIZE)] = 1.0
    elif isinstance(seg, dict) and isinstance(seg["counts"], list):
        full = rle_decode(seg).astype(np.float32)
        crop = full[int(max(y1, 0)):int(y2) + 1, int(max(x1, 0)):int(x2) + 1]
        if crop.size:
            out = resize_bilinear(crop, GT_MASK_SIZE, GT_MASK_SIZE)
    return out


def roidb_with_ignore(roidb: Sequence[RoiRecord], bad: Sequence[str] = ()) -> bool:
    """Whether batches of ``roidb`` carry ``gt_ignore``: decided once over
    the whole roidb (records whose ids are in ``bad``, blanked at
    assembly, left out), so every batch of a run has one structure."""
    bad = set(bad)
    return any(r.ignore_flags.any() for r in roidb if r.image_id not in bad)


def load_image(rec: RoiRecord) -> np.ndarray:
    """The record's (H, W, 3) uint8 RGB pixels: its in-memory array, or its
    file decoded with PIL.  A missing file raises ``FileNotFoundError``
    (which the train loader quarantines); an existing file on a host
    without PIL raises ``RuntimeError``, which nothing quarantines."""
    if rec.image_array is not None:
        return rec.image_array
    if not os.path.exists(rec.image_path):
        raise FileNotFoundError(rec.image_path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"record {rec.image_id!r}: decoding {rec.image_path} needs PIL, "
                           "which is not installed") from e
    with Image.open(rec.image_path) as im:
        return np.array(im.convert("RGB"), np.uint8)


def record_canvas(cfg: DataConfig, rec: RoiRecord) -> tuple[int, int]:
    """The static canvas the record letterboxes into."""
    return oriented_canvas(cfg.image_size, rec.height, rec.width)


def record_scale(cfg: DataConfig, rec: RoiRecord) -> float:
    """The letterbox scale of the record in its canvas (the reference's
    ``im_scale``, undone on the detections at eval)."""
    ch, cw = record_canvas(cfg, rec)
    return min(resize_scale(rec.height, rec.width, cfg.short_side, cfg.max_side),
               ch / rec.height, cw / rec.width)


class HostBatch(NamedTuple):
    """The host half of a batch: numpy arrays only (picklable, and what
    ``data/shm_ring.py`` encodes).  ``pixels`` holds each image's decoded
    (and flipped) uint8 RGB at source size, flattened and concatenated in
    batch order; ``src_hw`` their (h, w); ``image_hw`` the letterboxed
    (nh, nw) each is resized to; ``canvas_hw`` the batch's canvas.  The
    rest are :class:`~.batch.Batch`'s fields."""

    pixels: np.ndarray                    # (sum h*w*3,) uint8
    src_hw: np.ndarray                    # (B, 2) int32
    image_hw: np.ndarray                  # (B, 2) float32
    canvas_hw: np.ndarray                 # (2,) int32
    gt_boxes: np.ndarray                  # (B, G, 4) float32
    gt_classes: np.ndarray                # (B, G) int32
    gt_valid: np.ndarray                  # (B, G) bool
    gt_ignore: Optional[np.ndarray] = None
    ext_rois: Optional[np.ndarray] = None
    ext_valid: Optional[np.ndarray] = None
    gt_masks: Optional[np.ndarray] = None


def plain_pixels(rec: RoiRecord, flip: bool) -> tuple[np.ndarray, bool]:
    """``(pixels, ok)``: the record's pixels (:func:`load_image`), flipped
    when ``flip``; no retry, no quarantine."""
    pixels = load_image(rec)
    return (pixels[:, ::-1].copy() if flip else pixels), True


def host_half(records: Sequence[RoiRecord], cfg: DataConfig,
              flips: Optional[Sequence[bool]] = None, with_ignore: Optional[bool] = None,
              pixels: Callable[[RoiRecord, bool], tuple[np.ndarray, bool]] = plain_pixels,
              proposals: Optional[dict] = None, num_proposals: int = 0,
              with_masks: bool = False) -> HostBatch:
    """The :class:`HostBatch` of uint8 records of one orientation.

    ``with_ignore``: whether the batch carries ``gt_ignore``, which the
    train loader and :func:`eval_batches` decide over the whole roidb
    (:func:`roidb_with_ignore`); None decides it over ``records``, for a
    caller whose records are the whole roidb.
    ``flips``: a horizontal flip for each record (default: none).
    ``pixels(rec, flip) -> (pixels, ok)``: the record's pixels, flipped
    (default :func:`plain_pixels`); a record loaded with ``ok=False`` is a
    stand-in whose boxes and classes are kept but whose gt slots are all
    invalid.  ``proposals``: a :func:`load_proposals` map; the batch then
    carries ``ext_rois``/``ext_valid`` of ``num_proposals`` rows an image
    (:func:`external_rois`), looked up by ``image_id``, a stand-in's too.
    ``with_masks``: the batch carries ``gt_masks``, each real gt slot's
    segmentation rasterized over its unflipped box (:func:`rasterize_mask`)
    and mirrored when the record is flipped; ignore and padding slots,
    and a record without masks, stay zero."""
    canvases = {record_canvas(cfg, rec) for rec in records}
    if len(canvases) > 1:
        raise ValueError(f"records of two orientations in one batch (canvases "
                         f"{sorted(canvases)}); batch portrait and landscape records apart")
    if with_ignore is None:
        with_ignore = roidb_with_ignore(records)
    g = cfg.max_gt_boxes
    images, src, hws, boxes, classes, valid, ignore, ext, masks = [], [], [], [], [], [], [], [], []
    for rec, flip in zip(records, flips or [False] * len(records), strict=True):
        img, ok = pixels(rec, flip)
        if img.dtype != np.uint8:
            raise ValueError(f"record {rec.image_id!r}: the loader takes uint8 images, "
                             f"got {img.dtype}")
        rec_boxes = flip_boxes(rec.boxes, rec.width) if flip else rec.boxes
        scale = record_scale(cfg, rec)
        nh, nw = int(round(rec.height * scale)), int(round(rec.width * scale))
        images.append(img.reshape(-1))
        src.append(img.shape[:2])
        hws.append([nh, nw])
        n = min(len(rec_boxes), g)
        ign = rec.ignore_flags
        gb = np.zeros((g, 4), np.float32)
        gc = np.zeros((g,), np.int32)
        gv = np.zeros((g,), bool)
        gi = np.zeros((g,), bool)
        gb[:n] = (rec_boxes.astype(np.float32) * scale)[:n]
        gc[:n] = rec.gt_classes[:n]
        if ok:
            gv[:n] = ~ign[:n]
            gi[:n] = ign[:n]
        boxes.append(gb)
        classes.append(gc)
        valid.append(gv)
        ignore.append(gi)
        if with_masks:
            gm = np.zeros((g, GT_MASK_SIZE, GT_MASK_SIZE), np.float32)
            if rec.masks is not None:
                for i in range(n):
                    if not ign[i]:  # an ignore slot is never a mask target
                        m = rasterize_mask(rec.masks[i], rec.boxes[i])
                        gm[i] = m[:, ::-1] if flip else m
            masks.append(gm)
        if proposals is not None:
            ext.append(external_rois(rec, proposals, num_proposals, flip, scale, nh, nw))
    return HostBatch(
        pixels=np.concatenate(images),
        src_hw=np.asarray(src, np.int32).reshape(-1, 2),
        image_hw=np.asarray(hws, np.float32),
        canvas_hw=np.asarray(canvases.pop(), np.int32),
        gt_boxes=np.stack(boxes),
        gt_classes=np.stack(classes),
        gt_valid=np.stack(valid),
        gt_ignore=np.stack(ignore) if with_ignore else None,
        ext_rois=np.stack([r for r, _ in ext]) if ext else None,
        ext_valid=np.stack([v for _, v in ext]) if ext else None,
        gt_masks=np.stack(masks) if with_masks else None,
    )


def letterbox_images(pixels: torch.Tensor, src_hw: np.ndarray, image_hw: np.ndarray,
                     canvas_hw: np.ndarray) -> torch.Tensor:
    """(B, ch, cw, 3) uint8 canvases on ``pixels``' device from a
    :class:`HostBatch`'s flat ``pixels`` (already there) and its geometry
    (host arrays): each image resized to its (nh, nw), rounded back to
    uint8 and pasted top-left into zeros."""
    ch, cw = (int(v) for v in canvas_hw)
    images = torch.zeros((len(src_hw), ch, cw, 3), dtype=torch.uint8, device=pixels.device)
    off = 0
    for i, ((h, w), (nh, nw)) in enumerate(zip(src_hw.tolist(), image_hw.astype(int).tolist())):
        image = pixels[off:off + h * w * 3].view(h, w, 3)
        off += h * w * 3
        if (h, w) == (nh, nw):
            images[i, :nh, :nw] = image
        else:
            resized = resize_linear(image, nh, nw)
            images[i, :nh, :nw] = torch.clamp(torch.round(resized), 0, 255).to(torch.uint8)
    return images


def device_batch(fields: dict, hb_geometry: tuple) -> Batch:
    """The :class:`~.batch.Batch` from a host batch's non-None fields
    already on the device (``fields``: name -> tensor) and its geometry
    ``(src_hw, image_hw, canvas_hw)`` as host arrays."""
    return Batch(
        images=letterbox_images(fields["pixels"], *hb_geometry),
        image_hw=fields["image_hw"],
        gt_boxes=fields["gt_boxes"],
        gt_classes=fields["gt_classes"],
        gt_valid=fields["gt_valid"],
        gt_ignore=fields.get("gt_ignore"),
        ext_rois=fields.get("ext_rois"),
        ext_valid=fields.get("ext_valid"),
        gt_masks=fields.get("gt_masks"),
    )


def device_half(hb: HostBatch, device) -> Batch:
    """:func:`host_half`'s batch on ``device``, in the caller's thread and
    stream: every array is copied (never aliased: a host batch's arrays
    may be views of an shm ring slot or a cache entry), then letterboxed.
    ``parallel/prefetch.py::device_prefetch`` does the same from pinned
    staging on a copy stream."""
    device = torch.device(device)
    fields = {name: torch.tensor(arr, device=device)
              for name, arr in zip(HostBatch._fields, hb) if arr is not None}
    return device_batch(fields, (hb.src_hw, hb.image_hw, hb.canvas_hw))


def assemble(records: Sequence[RoiRecord], cfg: DataConfig, device,
             flips: Optional[Sequence[bool]] = None, with_ignore: Optional[bool] = None,
             proposals: Optional[dict] = None, num_proposals: int = 0,
             with_masks: bool = False) -> Batch:
    """One batch on ``device`` from uint8 records of one orientation:
    ``device_half(host_half(...))`` (:func:`host_half` for the
    arguments)."""
    return device_half(host_half(records, cfg, flips, with_ignore, proposals=proposals,
                                 num_proposals=num_proposals, with_masks=with_masks), device)


class DetectionLoader:
    """Batches on ``device`` in the JAX loader's schedule (port of
    ``mx_rcnn_tpu/data/loader.py::DetectionLoader``): infinite train
    batches, or with ``train=False`` one eval pass of ``(batch, records)``
    pairs (:meth:`eval_specs`, :meth:`eval_batch_range`).

    Each epoch is shuffled by ``RandomState(seed + epoch)``; under
    ``data.aspect_grouping`` landscape (aspect >= 1) and portrait records
    are batched apart, a group's short tail batch filled by wrapping
    around the group, and the batches shuffled together; each image draws
    its flip from one ``RandomState(seed + 17)`` stream (no draw with
    ``data.flip`` off).  The schedule depends on the roidb alone, so
    :meth:`iter_from` skips a resumed run's batches without decoding them.

    A record whose annotations are malformed (:func:`annotation_error`,
    class ids checked against ``num_classes`` when given, as the eval
    CLI gives it) is quarantined at construction; one whose pixels
    fail to load (an ``OSError`` or ``ValueError``, after ``io_retries``
    retries) is quarantined when first met.  Both stay in the schedule as a blank
    image with no valid gt, and each is journaled once to
    ``quarantine_path`` (``data/cache.py``), whichever process meets it.  Any other error, such as
    PIL missing on the host, propagates.

    ``run_length``: batches come in runs of that many consecutive
    same-canvas batches (``train.steps_per_call`` steps or
    ``train.accum_steps`` microbatches take one run a call), as in the JAX
    loader: a group's batches are cut into runs, its last run filled by
    wrapping whole batches around the group, and the runs shuffled
    together.  On a square canvas every batch has one shape, so the
    schedule is that of ``run_length`` 1 whatever it is.

    Eval (``train=False``): the records in :func:`eval_index_specs` order,
    never flipped, a short group's last batch padded with its last record;
    each pair's records are the real ones, which alone are scored.  A
    quarantined record still counts in the metric, its gt as misses.

    Where the host half runs (JAX's knobs and defaults): ``num_workers``
    threads of a pool when above 1 (default: ``min(8, cores)`` for
    training on a host with more than one core, 0 for eval), the train
    stream read ahead by a ``loader-prefetch`` thread with ``prefetch``;
    or, with ``service_workers`` > 0 (default ``data.num_workers``), the
    process input service with ``worker_respawns`` respawns a worker
    (default ``data.worker_respawns``) and, with ``data.shm_transport``,
    its shm ring.  ``data.cache_dir`` turns on the tensor cache.  Every
    backend gives the synchronous stream's bits.  Single host only: the
    JAX loader's ``rank``/``world`` slicing is not ported.

    ``proposals`` (Fast R-CNN mode): a :func:`load_proposals` map holding
    every record of the roidb (checked here), ``num_proposals`` rows an
    image in each batch's ``ext_rois``.  ``with_masks``: batches carry
    ``gt_masks`` (:func:`host_half`); a quarantined record's are zero.
    ``quarantine_announced``: ids already journaled (a service worker's
    loader gets its parent's), never journaled again here."""

    def __init__(self, roidb: Sequence[RoiRecord], cfg: DataConfig, batch_size: int, device,
                 seed: int = 0, quarantine_path: Optional[str] = None,
                 io_retries: int = 2, proposals: Optional[dict] = None,
                 num_proposals: int = 0, with_masks: bool = False,
                 run_length: int = 1, train: bool = True,
                 num_classes: Optional[int] = None, prefetch: bool = True,
                 num_workers: Optional[int] = None, service_workers: Optional[int] = None,
                 worker_respawns: Optional[int] = None,
                 quarantine_announced: Optional[Iterable[str]] = None) -> None:
        self.cfg = cfg
        self.train = train
        self.run_length = max(run_length, 1)
        self.with_masks = with_masks
        self.batch_size = batch_size
        self.device = device
        self.seed = seed
        self.quarantine_path = quarantine_path
        self.io_retries = max(int(io_retries), 0)
        self._num_classes = num_classes
        # Pool threads quarantine concurrently.
        self._quarantine_lock = threading.Lock()
        self._quarantined: set[str] = set(quarantine_announced or ())
        self._bad_annotations: dict[str, str] = {}
        for r in roidb:
            why = annotation_error(r, num_classes)
            if why is not None and r.image_id not in self._bad_annotations:
                self._bad_annotations[r.image_id] = why
                self._quarantine(r, ValueError(why), reason="annotation")
        self.with_ignore = roidb_with_ignore(roidb, self._bad_annotations)
        self.roidb = list(roidb)
        self.proposals = proposals
        self.num_proposals = num_proposals
        if proposals is not None:
            require_proposals(self.roidb, proposals)
        ch, cw = cfg.image_size
        if train and ch != cw and not cfg.aspect_grouping:
            raise ValueError("non-square image_size (orientation-bucketed canvases) "
                             "requires data.aspect_grouping=true")
        if not self.roidb:
            raise ValueError("empty roidb")
        if train and not cfg.aspect_grouping and len(self.roidb) < batch_size:
            raise ValueError(f"{len(self.roidb)} records make no full batch of {batch_size} "
                             "without data.aspect_grouping")
        self.prefetch = prefetch and train
        if num_workers is None:
            # JAX's heuristic: the pool only for training, on a host with
            # cores to spare.
            cores = os.cpu_count() or 1
            num_workers = (min(8, cores) if cores > 1 else 0) if train else 0
        self.num_workers = num_workers
        self.service_workers = max(int(cfg.num_workers if service_workers is None
                                       else service_workers), 0)
        self.worker_respawns = max(int(cfg.worker_respawns if worker_respawns is None
                                       else worker_respawns), 0)
        # One summary an input service this loader ran (hellos, deaths,
        # reassignments, fallback), appended when the service closes.
        self.service_runs: list[dict] = []
        self._tensor_cache: Optional[TensorCache] = None
        if cfg.cache_dir:
            self._tensor_cache = TensorCache(cfg.cache_dir, quarantine_path=quarantine_path)
        bad_env = os.environ.get(CHAOS_BAD_IMAGES_ENV, "")
        self._chaos_bad_images = frozenset(t.strip() for t in bad_env.split(",") if t.strip())
        if self._chaos_bad_images:
            log.warning("chaos: simulated-corrupt image ids armed: %s",
                        sorted(self._chaos_bad_images))
        nan_env = os.environ.get(CHAOS_NAN_ENV, "") if train else ""
        self._nan_steps = frozenset(int(t) for t in nan_env.split(",") if t.strip())
        if self._nan_steps:
            log.warning("chaos: NaN injection armed for global batch indices %s",
                        sorted(self._nan_steps))

    # -- ordering ----------------------------------------------------------

    def _epoch_batches(self, epoch: int) -> list[np.ndarray]:
        """Epoch ``epoch``'s shuffled full batches of roidb indices, each of
        one orientation under aspect grouping, in runs of ``run_length``
        same-orientation batches on a non-square canvas."""
        n, bs = len(self.roidb), self.batch_size
        rng = np.random.RandomState(self.seed + epoch)
        if not self.cfg.aspect_grouping:
            order = rng.permutation(n)
            return [order[i:i + bs] for i in range(0, n - bs + 1, bs)]
        aspects = np.array([r.aspect for r in self.roidb])
        ch, cw = self.cfg.image_size
        run = 1 if ch == cw else self.run_length
        runs: list[list[np.ndarray]] = []
        for group in (np.flatnonzero(aspects >= 1), np.flatnonzero(aspects < 1)):
            if len(group) == 0:
                continue
            rng.shuffle(group)
            batches = [group[i:i + bs] for i in range(0, len(group) - bs + 1, bs)]
            if len(group) % bs:
                # Wrap-around fill of the group's tail batch.
                batches.append(np.resize(group, (len(batches) + 1) * bs)[-bs:])
            if len(batches) % run:
                # Wrap whole batches to complete the group's last run.
                need = run - len(batches) % run
                batches.extend(batches[i % len(batches)] for i in range(need))
            runs.extend(batches[i:i + run] for i in range(0, len(batches), run))
        rng.shuffle(runs)
        return [b for r in runs for b in r]

    def _batch_index_specs(self, epochs: Optional[int] = None):
        """``(roidb indices, flips)`` a batch, in epoch order; infinite
        unless ``epochs`` bounds it."""
        epoch = 0
        rng = np.random.RandomState(self.seed + 17)
        while epochs is None or epoch < epochs:
            for batch_idx in self._epoch_batches(epoch):
                flips = [self.cfg.flip and bool(rng.randint(2)) for _ in range(len(batch_idx))]
                yield batch_idx, flips
            epoch += 1

    def _local_spec_stream(self, skip_batches: int = 0, epochs: Optional[int] = None):
        """The specs as plain ints and bools (a few a batch: what ships to
        service workers), the first ``skip_batches`` drawn and dropped
        (resume fast-forward: no pixel is decoded).  At the port's one
        host this is JAX's ``_global_spec_stream`` too."""
        specs = self._batch_index_specs(epochs)
        for _ in range(skip_batches):
            if next(specs, None) is None:
                return
        for batch_idx, flips in specs:
            yield [int(j) for j in batch_idx], [bool(f) for f in flips]

    # -- train stream ------------------------------------------------------

    def iter_from(self, skip_batches: int = 0) -> "LoaderStream":
        """Batches from the ``skip_batches``-th of the schedule on: step k
        of a resumed run gets the batch step k of an uninterrupted run
        would have.  A :class:`LoaderStream`: device batches, its ``host``
        the host batches (read ahead by the ``loader-prefetch`` thread
        with ``prefetch``, unless the input service already runs ahead);
        close it to reclaim threads and workers."""
        it = self._train_batches(skip_batches)
        if self.prefetch and self.service_workers == 0:
            it = _Prefetched(it, depth=2)
        return LoaderStream(it, self.device)

    def __iter__(self):
        return self.iter_from() if self.train else self.eval_batch_range()

    def _train_batches(self, skip_batches: int = 0) -> Iterator[HostBatch]:
        it = self._raw_train_batches(skip_batches)
        if not self._nan_steps:
            yield from it
            return
        # Every backend yields in schedule order, so the position is the
        # global batch index.
        try:
            for idx, batch in enumerate(it, start=skip_batches):
                yield self._poison(batch, idx) if idx in self._nan_steps else batch
        finally:
            it.close()

    def _poison(self, batch: HostBatch, idx: int) -> HostBatch:
        """Chaos hook (``CHAOS_NAN_ENV``): NaN pixels need float images,
        and the port's are uint8 only, so this refuses as JAX's ``_poison``
        refuses a uint8 batch (the same error)."""
        raise ValueError(f"{CHAOS_NAN_ENV} needs float images (synthetic/normalized "
                         f"paths); batch {idx} is {batch.pixels.dtype}")

    def _raw_train_batches(self, skip_batches: int = 0,
                           epochs: Optional[int] = None) -> Iterator[HostBatch]:
        specs = self._local_spec_stream(skip_batches, epochs)
        if self.service_workers > 0:
            # The service's cursor starts at the global batch index, so
            # resume and chaos speak the schedule's coordinates.
            yield from self._service_batches(specs, start_index=skip_batches, global_specs=True)
        elif self.num_workers <= 1:
            for spec in specs:
                yield self._assemble_rows(spec)
        else:
            yield from self._pooled_batches(specs)

    def _pooled_batches(self, spec_iter) -> Iterator[HostBatch]:
        """A thread pool assembling ``num_workers`` host batches ahead,
        yielded in order.  When the spec stream runs dry (bounded epochs,
        an eval range) the pending deque is drained, not dropped, and the
        generator returns instead of letting ``next(specs)``'s
        StopIteration escape as a PEP-479 RuntimeError."""
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: collections.deque = collections.deque()

            def pump() -> bool:
                try:
                    spec = next(spec_iter)
                except StopIteration:
                    return False
                pending.append(pool.submit(self._assemble_rows, spec))
                return True

            for _ in range(self.num_workers):
                if not pump():
                    break
            while pending:
                batch = pending.popleft().result()
                pump()
                yield batch

    # -- the input service -------------------------------------------------

    def _worker_payload(self) -> dict:
        """What a service worker rebuilds this loader from (spawn: nothing
        is inherited).  No device: a worker's loader is on the CPU and runs
        the host half only.  ``quarantine_announced`` keeps workers from
        journaling again what this process already did."""
        with self._quarantine_lock:
            announced = sorted(self._quarantined)
        return {
            "roidb": self.roidb, "cfg": self.cfg, "batch_size": self.batch_size,
            "train": self.train, "seed": self.seed, "with_masks": self.with_masks,
            "proposals": self.proposals, "num_proposals": self.num_proposals,
            "run_length": self.run_length, "quarantine_path": self.quarantine_path,
            "io_retries": self.io_retries, "num_classes": self._num_classes,
            "quarantine_announced": announced,
        }

    def _shm_slot_bytes(self) -> int:
        """One shm slot: ``data.shm_slot_mb`` MiB, or the host batch of a
        full batch of source images at the canvas area (uint8) with its gt,
        masks and proposals, 25% headroom over it as in JAX, and the header
        region.  A batch of larger source images overflows its slot and
        rides the pickle path for that batch (``data_shm_overflows_total``),
        so this is a throughput knob, not a correctness one."""
        from mx_rcnn_tpu_torch.data.shm_ring import HEADER_RESERVE

        if self.cfg.shm_slot_mb > 0:
            return self.cfg.shm_slot_mb * (1 << 20)
        b = max(self.batch_size, 1)
        h, w = self.cfg.image_size
        g = self.cfg.max_gt_boxes
        payload = b * h * w * 3                 # source pixels, uint8
        payload += b * (2 * 4 + 2 * 4) + 2 * 4  # src_hw, image_hw, canvas_hw
        payload += b * g * (4 * 4 + 4 + 1 + 1)  # boxes, classes, valid, ignore
        if self.with_masks:
            payload += b * g * GT_MASK_SIZE * GT_MASK_SIZE * 4
        if self.proposals is not None:
            payload += b * self.num_proposals * (4 * 4 + 1)
        return int(payload * 1.25) + HEADER_RESERVE + 4096

    def _service_batches(self, spec_iter, start_index: int = 0,
                         global_specs: bool = False) -> Iterator[HostBatch]:
        """A spec stream through the process input service, yielded in
        spec order; closing or exhausting this generator tears the service
        down.  ``global_specs``: the training path's global schedule, the
        workers slicing their host's rows (:func:`_service_assembler_global`)."""
        from mx_rcnn_tpu_torch.data.service import InputService

        shm_slots = max(int(self.cfg.shm_slots), 0) if self.cfg.shm_transport else 0
        svc = InputService(
            specs=spec_iter,
            assemble=self._assemble_global_rows if global_specs else self._assemble_rows,
            builder=_service_assembler_global if global_specs else _service_assembler,
            payload=self._worker_payload(),
            num_workers=self.service_workers,
            start_index=start_index,
            respawns=self.worker_respawns,
            shm_slots=shm_slots,
            shm_slot_bytes=self._shm_slot_bytes() if shm_slots else 0,
            quarantine_path=self.quarantine_path,
        )
        try:
            yield from svc
        finally:
            svc.close()
            self.service_runs.append({"hellos": list(svc.hellos), "deaths": svc.deaths,
                                      "reassigned": svc.reassigned,
                                      "fell_back": svc.fell_back})

    # -- eval ----------------------------------------------------------------

    def eval_specs(self) -> list[tuple[list[RoiRecord], list[RoiRecord]]]:
        """The eval schedule without a pixel decoded: one ``(rows,
        records)`` pair a batch, the padded batch's records and the real
        ones (:func:`eval_index_specs`).  Sharded evaluation fingerprints
        and cuts it (``evalutil/pred_eval.py``)."""
        return [([self.roidb[j] for j in rows], [self.roidb[j] for j in idxs])
                for rows, idxs in eval_index_specs(self.roidb, self.cfg, self.batch_size)]

    def eval_batch_range(self, start: int = 0, stop: Optional[int] = None
                         ) -> Iterator[tuple[Batch, list[RoiRecord]]]:
        """``(batch, records)`` for eval batches ``start:stop`` of
        :meth:`eval_specs`; no pixel outside the range is decoded.  The
        host halves come from the service (``service_workers``), the pool
        (``num_workers`` > 1) or this thread, the device half runs here:
        every backend gives the same bytes."""
        specs = eval_index_specs(self.roidb, self.cfg, self.batch_size)[start:stop]
        rec_lists = [[self.roidb[j] for j in idxs] for _, idxs in specs]
        row_specs = iter([(rows, [False] * len(rows)) for rows, _ in specs])
        if self.service_workers > 0:
            host: Iterator[HostBatch] = self._service_batches(row_specs, start_index=start)
        elif self.num_workers > 1:
            host = self._pooled_batches(row_specs)
        else:
            host = (self._assemble_rows(s) for s in row_specs)
        try:
            for hb, recs in zip(host, rec_lists):
                yield device_half(hb, self.device), recs
        finally:
            host.close()

    # -- records -------------------------------------------------------------

    def _assemble_rows(self, spec) -> HostBatch:
        """The host half of one ``(roidb indices, flips)`` spec: the unit
        of work of the pool and the service alike."""
        idxs, flips = spec
        recs = [self._usable(self.roidb[j]) for j in idxs]
        return host_half(recs, self.cfg, flips, self.with_ignore, pixels=self._pixels,
                         proposals=self.proposals, num_proposals=self.num_proposals,
                         with_masks=self.with_masks)

    def _assemble_global_rows(self, spec) -> HostBatch:
        """One global spec's rows of this host: at the port's one host
        (world 1) all of them, so :meth:`_assemble_rows`.  Multi-host
        slicing comes with ``rank``/``world``."""
        return self._assemble_rows(spec)

    def _assemble(self, idxs: Sequence[int], flips: Sequence[bool]) -> Batch:
        """One batch on the loader's device, both halves in this thread."""
        return device_half(self._assemble_rows((idxs, flips)), self.device)

    def _usable(self, rec: RoiRecord) -> RoiRecord:
        """The record, or for quarantined annotations a blank stand-in with
        no gt that never touches the malformed arrays."""
        if rec.image_id not in self._bad_annotations:
            return rec
        return dataclasses.replace(rec, boxes=np.zeros((0, 4), np.float32),
                                   gt_classes=np.zeros((0,), np.int32), ignore=None,
                                   masks=None, image_array=self._blank_pixels(rec),
                                   image_path="")

    @staticmethod
    def _blank_pixels(rec: RoiRecord) -> np.ndarray:
        if rec.image_array is not None:
            return np.zeros_like(rec.image_array)
        return np.zeros((rec.height, rec.width, 3), np.uint8)

    def _pixels(self, rec: RoiRecord, flip: bool) -> tuple[np.ndarray, bool]:
        """``(pixels, ok)``: the record's decoded pixels, flipped when
        ``flip``, through the tensor cache when it is on.  A hit returns
        the bytes a rebuild would, so hits and misses are bitwise the same
        downstream.  A record that is chaos-bad or already quarantined
        never reads the cache: a blob from a healthier life of the file
        must not mask the failure."""
        cache = self._tensor_cache
        if cache is not None and (rec.image_id in self._chaos_bad_images
                                  or rec.image_id in self._quarantined):
            cache = None
        key = cache.key(rec, flip) if cache is not None else None
        if cache is not None:
            hit = cache.get(key, rec.image_id)
            if hit is not None:
                return hit[0], True
        img, ok = self._load_image(rec)
        if flip:
            img = img[:, ::-1].copy()
        if ok and cache is not None and img.dtype == np.uint8:
            cache.put(key, img, img.shape[0], img.shape[1])
        return img, ok

    def _load_image(self, rec: RoiRecord) -> tuple[np.ndarray, bool]:
        """``(pixels, ok)``: bounded retries on I/O errors, then quarantine
        and a blank image with ``ok=False``."""
        err: Optional[BaseException] = None
        for attempt in range(self.io_retries + 1):
            try:
                if rec.image_id in self._chaos_bad_images:
                    raise ValueError("chaos: simulated corrupt image")
                return load_image(rec), True
            except (OSError, ValueError) as e:
                err = e
                if attempt < self.io_retries:
                    time.sleep(0.1 * (2 ** attempt))
        self._quarantine(rec, err)
        return self._blank_pixels(rec), False

    def _quarantine(self, rec: RoiRecord, error: BaseException, reason: str = "io") -> None:
        retries = self.io_retries if reason == "io" else 0
        with self._quarantine_lock:
            if rec.image_id in self._quarantined:
                return  # recorded once, not every epoch
            self._quarantined.add(rec.image_id)
            log.error("quarantining image %r (%s; %s: %s) after %d retries; substituting a "
                      "blank example", rec.image_id, reason, type(error).__name__, error, retries)
            if self.quarantine_path is not None:
                # Once a journal: a service worker that meets a record another
                # worker (or this process) journaled does not journal it again.
                quarantine_append(self.quarantine_path, {
                    "image_id": rec.image_id, "path": rec.image_path, "reason": reason,
                    "error": f"{type(error).__name__}: {error}", "retries": retries,
                }, once_per=("image_id", "reason"))


def eval_index_specs(roidb: Sequence[RoiRecord], cfg: DataConfig,
                     batch_size: int) -> list[tuple[list[int], list[int]]]:
    """The eval schedule: one ``(rows, records)`` pair of roidb indices a
    batch.  On a non-square canvas landscape records come first, then
    portrait, each in roidb order, so every batch has one canvas.  A short
    last batch of a group is padded with its last record: ``rows`` is the
    padded batch, ``records`` the real ones, which alone are scored."""
    idx_all = list(range(len(roidb)))
    ch, cw = cfg.image_size
    if ch == cw:
        groups = [idx_all]
    else:
        groups = [[j for j in idx_all if roidb[j].aspect >= 1],
                  [j for j in idx_all if roidb[j].aspect < 1]]
    specs = []
    for group in groups:
        for i in range(0, len(group), batch_size):
            idxs = group[i:i + batch_size]
            specs.append((idxs + [idxs[-1]] * (batch_size - len(idxs)), idxs))
    return specs


def eval_batches(roidb: Sequence[RoiRecord], cfg: DataConfig, batch_size: int,
                 device, proposals: Optional[dict] = None,
                 num_proposals: int = 0) -> Iterator[tuple[Batch, list[RoiRecord]]]:
    """One pass over ``roidb`` in :func:`eval_index_specs` order:
    ``(batch, records)``, the batch padded to ``batch_size``, through
    :class:`DetectionLoader`'s eval form (its quarantine included).
    ``proposals``: as :class:`DetectionLoader`'s (checked before the first
    batch), never flipped.  Eval batches carry no ``gt_masks``: segm
    scoring reads the gt masks from the roidb."""
    yield from DetectionLoader(roidb, cfg, batch_size, device, train=False, proposals=proposals,
                               num_proposals=num_proposals)


def _service_assembler(payload: dict):
    """Rebuild the parent's loader inside a spawned service worker and
    return its ``_assemble_rows`` (module level, so it pickles by
    reference).  The worker's loader is on the CPU and never touches the
    card; ``service_workers=0`` keeps it from starting a service of its
    own, and ``prefetch=False``, ``num_workers=0`` keep it single-threaded
    (its parallelism is the process pool)."""
    loader = DetectionLoader(
        payload["roidb"], payload["cfg"], payload["batch_size"], "cpu",
        seed=payload["seed"], quarantine_path=payload["quarantine_path"],
        io_retries=payload["io_retries"], proposals=payload["proposals"],
        num_proposals=payload["num_proposals"], with_masks=payload["with_masks"],
        run_length=payload["run_length"], train=payload["train"],
        num_classes=payload["num_classes"], prefetch=False, num_workers=0,
        service_workers=0, worker_respawns=0,
        quarantine_announced=payload["quarantine_announced"])
    return loader._assemble_rows


def _service_assembler_global(payload: dict):
    """Like :func:`_service_assembler`, for global specs: the rebuilt
    loader's ``_assemble_global_rows``."""
    return _service_assembler(payload).__self__._assemble_global_rows


class _Prefetched:
    """Background read-ahead over a batch iterator (the
    ``loader-prefetch`` thread), with a ``close()`` that reclaims the
    thread: it drains the queue until the thread can finish, joins it,
    closes the source, and with ``raise_pending`` re-raises an exception
    the thread hit that the consumer never saw."""

    def __init__(self, it: Iterator, depth: int = 2) -> None:
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = object()
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, name="loader-prefetch",
                                        daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
                if self._closed:
                    break
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._exc = e
        finally:
            self._q.put(self._stop)

    def __iter__(self) -> "_Prefetched":
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is self._stop:
            self._closed = True
            self._thread.join(timeout=5.0)
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        return item

    def close(self, raise_pending: bool = True) -> None:
        """Join the thread and close the source iterator; with
        ``raise_pending`` a source exception the consumer never consumed
        is raised here instead of being swallowed."""
        if self._closed:
            self._close_source()
            return
        self._closed = True
        # Unblock a thread stuck on a full queue, then wait for its final
        # stop marker (bounded: it checks _closed after each put).
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        self._close_source()
        if raise_pending and self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _close_source(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            try:
                close()
            except RuntimeError:
                pass  # generator already executing or closed


class LoaderStream:
    """Device batches from a host-batch stream: each :class:`HostBatch`
    through :func:`device_half` in the consumer's thread.  ``host`` is the
    host stream itself, which ``parallel/prefetch.py::device_prefetch``
    uploads from pinned staging on a copy stream instead.  ``close()``
    closes the host stream (threads, pool and service workers with it)."""

    def __init__(self, host: Iterator[HostBatch], device) -> None:
        self.host = host
        self.device = device

    def __iter__(self) -> "LoaderStream":
        return self

    def __next__(self) -> Batch:
        return device_half(next(self.host), self.device)

    def close(self) -> None:
        close = getattr(self.host, "close", None)
        if close is not None:
            close()
