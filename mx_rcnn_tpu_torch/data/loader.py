"""Batch assembly and the train schedule (port of
``mx_rcnn_tpu/data/loader.py``).

Each record is letterboxed as uint8 into its oriented canvas (the
landscape ``data.image_size``, transposed for portrait records) by the
loader's scale rule (short side to ``short_side`` unless the long side
passes ``max_side``, clamped to the canvas), its boxes scaled by the same
factor, and its gt padded to ``data.max_gt_boxes`` with ``gt_valid`` (and
``gt_ignore`` where the roidb has crowd or difficult regions anywhere).
Pixels stay uint8; the graph normalizes them
(``detection/graph.py::prep_images``).  The resize is
``data/transforms.py``'s torch bilinear on the batch's device, rounded
back to uint8; an image already at its letterbox size is not resampled.
A flipped record's pixels flip on the host before the upload and its
boxes in original coordinates before the scale, as the JAX loader flips
before its resize.

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
with a flipped record.  Not ported: the prefetch thread, the thread pool,
the input service, the tensor cache and the chaos hooks.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.cache import quarantine_append
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.data.transforms import (
    flip_boxes,
    hflip,
    oriented_canvas,
    resize_linear,
    resize_scale,
)
from mx_rcnn_tpu_torch.evalutil.masks import fill_polygons, resize_bilinear, rle_decode

log = logging.getLogger("mx_rcnn_tpu_torch")

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


def letterbox_uint8(image: torch.Tensor, canvas_hw: tuple[int, int], nh: int,
                    nw: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> resized to (nh, nw), pasted top-left into a
    zero uint8 canvas."""
    canvas = torch.zeros((*canvas_hw, 3), dtype=torch.uint8, device=image.device)
    if image.shape[:2] == (nh, nw):
        canvas[:nh, :nw] = image
    else:
        resized = resize_linear(image, nh, nw)
        canvas[:nh, :nw] = torch.clamp(torch.round(resized), 0, 255).to(torch.uint8)
    return canvas


def _pixels_ok(rec: RoiRecord) -> tuple[np.ndarray, bool]:
    return load_image(rec), True


def assemble(records: Sequence[RoiRecord], cfg: DataConfig, device,
             flips: Optional[Sequence[bool]] = None, with_ignore: Optional[bool] = None,
             load: Callable[[RoiRecord], tuple[np.ndarray, bool]] = _pixels_ok,
             proposals: Optional[dict] = None, num_proposals: int = 0,
             with_masks: bool = False) -> Batch:
    """One batch on ``device`` from uint8 records of one orientation.

    ``with_ignore``: whether the batch carries ``gt_ignore``, which the
    train loader and :func:`eval_batches` decide over the whole roidb
    (:func:`roidb_with_ignore`); None decides it over ``records``, for a
    caller whose records are the whole roidb.
    ``flips``: a horizontal flip for each record (default: none).
    ``load(rec) -> (pixels, ok)``: the record's pixels (default
    :func:`load_image`); a record loaded with ``ok=False`` is a stand-in
    whose boxes and classes are kept but whose gt slots are all invalid.
    ``proposals``: a :func:`load_proposals` map; the batch then carries
    ``ext_rois``/``ext_valid`` of ``num_proposals`` rows an image
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
    images, hws, boxes, classes, valid, ignore, ext, masks = [], [], [], [], [], [], [], []
    for rec, flip in zip(records, flips or [False] * len(records), strict=True):
        pixels, ok = load(rec)
        if pixels.dtype != np.uint8:
            raise ValueError(f"record {rec.image_id!r}: the loader takes uint8 images, "
                             f"got {pixels.dtype}")
        rec_boxes = rec.boxes
        if flip:
            pixels, rec_boxes = hflip(pixels, rec_boxes, rec.width)
        scale = record_scale(cfg, rec)
        nh, nw = int(round(rec.height * scale)), int(round(rec.width * scale))
        images.append(letterbox_uint8(torch.from_numpy(pixels).to(device),
                                      record_canvas(cfg, rec), nh, nw))
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
    return Batch(
        images=torch.stack(images),
        image_hw=torch.tensor(np.asarray(hws, np.float32), device=device),
        gt_boxes=torch.tensor(np.stack(boxes), device=device),
        gt_classes=torch.tensor(np.stack(classes), device=device),
        gt_valid=torch.tensor(np.stack(valid), device=device),
        gt_ignore=torch.tensor(np.stack(ignore), device=device) if with_ignore else None,
        ext_rois=torch.tensor(np.stack([r for r, _ in ext]), device=device) if ext else None,
        ext_valid=torch.tensor(np.stack([v for _, v in ext]), device=device) if ext else None,
        gt_masks=torch.tensor(np.stack(masks), device=device) if with_masks else None,
    )


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
    ``quarantine_path`` (``data/cache.py``).  Any other error, such as
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

    Single host only: the JAX loader's ``rank``/``world`` slicing,
    prefetch, the thread pool and the input service are not ported.

    ``proposals`` (Fast R-CNN mode): a :func:`load_proposals` map holding
    every record of the roidb (checked here), ``num_proposals`` rows an
    image in each batch's ``ext_rois``.  ``with_masks``: batches carry
    ``gt_masks`` (:func:`assemble`); a quarantined record's are zero."""

    def __init__(self, roidb: Sequence[RoiRecord], cfg: DataConfig, batch_size: int, device,
                 seed: int = 0, quarantine_path: Optional[str] = None,
                 io_retries: int = 2, proposals: Optional[dict] = None,
                 num_proposals: int = 0, with_masks: bool = False,
                 run_length: int = 1, train: bool = True,
                 num_classes: Optional[int] = None) -> None:
        self.cfg = cfg
        self.train = train
        self.run_length = max(run_length, 1)
        self.with_masks = with_masks
        self.batch_size = batch_size
        self.device = device
        self.seed = seed
        self.quarantine_path = quarantine_path
        self.io_retries = max(int(io_retries), 0)
        self._quarantined: set[str] = set()
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

    def _local_spec_stream(self, skip_batches: int = 0):
        """The specs as plain ints and bools, the first ``skip_batches``
        drawn and dropped (resume fast-forward: no pixel is decoded)."""
        specs = self._batch_index_specs()
        for _ in range(skip_batches):
            if next(specs, None) is None:
                return
        for batch_idx, flips in specs:
            yield [int(j) for j in batch_idx], [bool(f) for f in flips]

    def iter_from(self, skip_batches: int = 0) -> Iterator[Batch]:
        """Batches from the ``skip_batches``-th of the schedule on: step k
        of a resumed run gets the batch step k of an uninterrupted run
        would have."""
        for idxs, flips in self._local_spec_stream(skip_batches):
            yield self._assemble(idxs, flips)

    def __iter__(self):
        return self.iter_from() if self.train else self.eval_batch_range()

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
        :meth:`eval_specs`; no pixel outside the range is decoded."""
        for rows, idxs in eval_index_specs(self.roidb, self.cfg, self.batch_size)[start:stop]:
            yield self._assemble(rows, [False] * len(rows)), [self.roidb[j] for j in idxs]

    # -- records -------------------------------------------------------------

    def _assemble(self, idxs: Sequence[int], flips: Sequence[bool]) -> Batch:
        recs = [self._usable(self.roidb[j]) for j in idxs]
        return assemble(recs, self.cfg, self.device, flips, self.with_ignore,
                        load=self._load_image, proposals=self.proposals,
                        num_proposals=self.num_proposals, with_masks=self.with_masks)

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

    def _load_image(self, rec: RoiRecord) -> tuple[np.ndarray, bool]:
        """``(pixels, ok)``: bounded retries on I/O errors, then quarantine
        and a blank image with ``ok=False``."""
        err: Optional[BaseException] = None
        for attempt in range(self.io_retries + 1):
            try:
                return load_image(rec), True
            except (OSError, ValueError) as e:
                err = e
                if attempt < self.io_retries:
                    time.sleep(0.1 * (2 ** attempt))
        self._quarantine(rec, err)
        return self._blank_pixels(rec), False

    def _quarantine(self, rec: RoiRecord, error: BaseException, reason: str = "io") -> None:
        if rec.image_id in self._quarantined:
            return  # recorded once, not every epoch
        self._quarantined.add(rec.image_id)
        retries = self.io_retries if reason == "io" else 0
        log.error("quarantining image %r (%s; %s: %s) after %d retries; substituting a blank "
                  "example", rec.image_id, reason, type(error).__name__, error, retries)
        if self.quarantine_path is not None:
            quarantine_append(self.quarantine_path, {
                "image_id": rec.image_id, "path": rec.image_path, "reason": reason,
                "error": f"{type(error).__name__}: {error}", "retries": retries,
            })


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
