"""Serving runtime (port of the core of ``mx_rcnn_tpu/serve/engine.py``).

:class:`DetectorRunner` owns the detector on one device and a fixed set of
(mode, bucket) programs, every one run once at :meth:`~DetectorRunner.warmup`
(which also builds the CUDA kernels) and refused afterwards if it was not:
``("full", b)`` for every bucket, ``("reduced", smallest)`` and
``("proposals", smallest)``.  ``cfg.serve.fused_middle`` overrides the
proposal middle of every program: ``"on"`` forces the fused CUDA middle
(``rpn.fused_middle=True, nms_impl="pallas"``), ``"off"`` the plain chain,
``"inherit"`` keeps ``cfg.model.rpn``.

:class:`InferenceEngine` is the minimal serving loop: a bounded queue that
sheds with :class:`Overloaded` when full, one worker thread that packs up
to ``batch_size`` requests of one bucket into each device call, and
``start``/``submit``/``infer``/``stop``.  Tenancy, the degrade ladder, the
breaker, the watchdog, the int8 programs and the fleet are not ported yet.

Entry points run on the card: ``device=None`` means ``"cuda"``, and with
no card they raise rather than fall back to the CPU.  Tests pass
``device="cpu"``.
"""

from __future__ import annotations

import copy
import dataclasses
import queue as queue_mod
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.transforms import letterbox, normalize_image
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.detection.graph import forward_inference, forward_proposals
from mx_rcnn_tpu_torch.evalutil.postprocess import unletterbox_detections
from mx_rcnn_tpu_torch.utils.device import resolve_device

MODES = ("full", "reduced", "proposals")


class ServeError(RuntimeError):
    """Base class for typed serving failures."""


class Overloaded(ServeError):
    """Admission control shed this request: the queue is full."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before it was served."""


class EngineUnavailable(ServeError):
    """The engine cannot serve (not started, stopping, or an unwarmed
    program was asked for)."""


def serving_model_cfg(cfg):
    """``cfg.model`` with ``cfg.serve.fused_middle`` applied."""
    fused = cfg.serve.fused_middle
    if fused not in ("inherit", "on", "off"):
        raise ValueError(f"serve.fused_middle must be inherit/on/off, got {fused!r}")
    if fused == "inherit":
        return cfg.model
    return dataclasses.replace(
        cfg.model,
        rpn=dataclasses.replace(
            cfg.model.rpn,
            fused_middle=(fused == "on"),
            nms_impl="pallas" if fused == "on" else "xla",
        ),
    )


class DetectorRunner:
    """The detector on one device over fixed shape buckets."""

    def __init__(
        self,
        cfg,
        variables: dict[str, torch.Tensor],
        buckets: Optional[Sequence[tuple[int, int]]] = None,
        batch_size: int = 1,
        reduced_max_detections: Optional[int] = None,
        with_proposals: bool = True,
        device=None,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        bks = list(buckets) if buckets else [tuple(cfg.data.image_size)]
        # Ascending by area; pick_bucket takes the first that fits.
        self.buckets = sorted(
            (tuple(int(x) for x in b) for b in bks), key=lambda b: (b[0] * b[1], b)
        )
        if reduced_max_detections is None:
            reduced_max_detections = max(1, cfg.model.test.max_detections // 4)
        self.reduced_max_detections = int(reduced_max_detections)
        self.pixel_stats = (cfg.data.pixel_mean, cfg.data.pixel_std)

        self.model_cfg = serving_model_cfg(cfg)
        model = TwoStageDetector(self.model_cfg, device=self.device)
        model.load_state_dict(variables)
        model.eval()
        # The reduced program shares the weights and differs only in its
        # postprocess caps.
        reduced = copy.copy(model)
        reduced.cfg = dataclasses.replace(
            self.model_cfg,
            test=dataclasses.replace(
                self.model_cfg.test,
                max_detections=self.reduced_max_detections,
                fused_top_k=min(self.model_cfg.test.fused_top_k,
                                4 * self.reduced_max_detections),
            ),
        )
        self._models = {"full": model, "reduced": reduced, "proposals": model}
        self._program_keys = [("full", b) for b in self.buckets]
        self._program_keys.append(("reduced", self.buckets[0]))
        if with_proposals:
            self._program_keys.append(("proposals", self.buckets[0]))
        self._warmed: set[tuple[str, tuple[int, int]]] = set()

    def levels(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(m for m, _ in self._program_keys))

    def pick_bucket(self, height: int, width: int) -> tuple[int, int]:
        """Smallest bucket that holds the image without downscaling; the
        largest bucket otherwise (letterbox downscales into it)."""
        for b in self.buckets:
            if b[0] >= height and b[1] >= width:
                return b
        return self.buckets[-1]

    def bucket_for(self, mode: str, height: int, width: int) -> tuple[int, int]:
        return self.pick_bucket(height, width) if mode == "full" else self.buckets[0]

    def warmup(self) -> int:
        """Run every program once on a zero batch; returns the count."""
        for mode, bucket in self._program_keys:
            images = torch.zeros((self.batch_size, *bucket, 3), device=self.device)
            hw = torch.tensor([bucket] * self.batch_size, dtype=torch.float32,
                              device=self.device)
            self._execute(mode, Batch(images=images, image_hw=hw))
            self._sync()
            self._warmed.add((mode, bucket))
        return len(self._warmed)

    def run(self, mode: str, bucket: tuple[int, int],
            images: Sequence[np.ndarray]) -> list[dict]:
        """Serve a micro-batch of (H, W, 3) images through a warmed program;
        one dict per image in original image coordinates ("boxes",
        "scores", "classes"; a Mask R-CNN's detection programs add "masks",
        one pasted (h, w) bool mask a detection)."""
        if (mode, bucket) not in self._warmed:
            raise EngineUnavailable(
                f"program ({mode}, {bucket}) was never warmed — refusing to "
                "serve it"
            )
        if len(images) > self.batch_size:
            raise ValueError(
                f"micro-batch of {len(images)} exceeds batch_size {self.batch_size}"
            )
        rows, hw, scales, orig = [], [], [], []
        for img in images:
            h, w = img.shape[:2]
            x = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
            canvas, scale, (nh, nw) = letterbox(x, bucket, min(bucket), max(bucket))
            rows.append(normalize_image(canvas, *self.pixel_stats))
            hw.append([nh, nw])
            scales.append(scale)
            orig.append((h, w))
        pad = self.batch_size - len(rows)
        rows += [torch.zeros_like(rows[0])] * pad
        hw += [list(bucket)] * pad
        batch = Batch(
            images=torch.stack(rows),
            image_hw=torch.tensor(hw, dtype=torch.float32, device=self.device),
        )
        out = self._execute(mode, batch)
        out = type(out)(*(None if t is None else t.cpu().numpy() for t in out))
        return [self._postprocess(mode, out, i, scales[i], *orig[i])
                for i in range(len(images))]

    def _execute(self, mode: str, batch: Batch):
        model = self._models[mode]
        with torch.inference_mode():
            if mode == "proposals":
                return forward_proposals(model, batch, self.pixel_stats)
            return forward_inference(model, batch, self.pixel_stats)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _postprocess(mode, out, i, scale, height, width) -> dict:
        if mode == "proposals":
            valid = out.valid[i]
            boxes = out.rois[i][valid] / max(scale, 1e-12)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, width - 1)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, height - 1)
            return {
                "boxes": boxes.astype(np.float32),
                "scores": out.scores[i][valid],
                "classes": np.zeros(int(valid.sum()), np.int32),
            }
        masks = getattr(out, "masks", None)
        return unletterbox_detections(out.boxes[i], out.scores[i], out.classes[i],
                                      out.valid[i], scale, height, width,
                                      masks=masks[i] if masks is not None else None)


class InferenceRequest:
    """A submitted request; :meth:`result` blocks until served or failed."""

    def __init__(self, image: np.ndarray, deadline: Optional[float]) -> None:
        self.image = image
        self.deadline = deadline
        self.submitted_at = time.monotonic()
        self.served_at: Optional[float] = None
        self._event = threading.Event()
        self._result: Optional[dict] = None
        self._error: Optional[BaseException] = None

    def _set_result(self, result: dict) -> None:
        self._result = result
        self.served_at = time.monotonic()
        self._event.set()

    def _set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._event.wait(timeout):
            raise TimeoutError("request not complete")
        if self._error is not None:
            raise self._error
        return self._result


class InferenceEngine:
    """Bounded-queue serving loop over one mode of a runner's programs.

    Lifecycle: construct -> :meth:`start` (warms every program, starts the
    worker) -> :meth:`submit` / :meth:`infer` -> :meth:`stop`.  Usable as a
    context manager."""

    _STOP = object()

    def __init__(self, runner: DetectorRunner, max_queue: int = 16,
                 mode: str = "full") -> None:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.runner = runner
        self.mode = mode
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        self._accepting = False
        self._worker: Optional[threading.Thread] = None
        self._carry: list[InferenceRequest] = []
        self.served = 0
        self.shed = 0

    def start(self) -> "InferenceEngine":
        with self._lock:
            if self._worker is not None:
                return self
            self.runner.warmup()
            self._worker = threading.Thread(target=self._worker_loop, name="mx-rcnn-serve",
                                            daemon=True)
            self._accepting = True
            self._worker.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop admission, serve what was accepted, and join the worker."""
        with self._lock:
            if self._worker is None:
                return
            self._accepting = False
            worker, self._worker = self._worker, None
        self._queue.put(self._STOP)
        worker.join(timeout)
        if worker.is_alive():
            raise RuntimeError(f"serving worker did not stop within {timeout}s")

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def submit(self, image: np.ndarray, timeout: Optional[float] = None) -> InferenceRequest:
        """Enqueue one (H, W, 3) image; raises :class:`Overloaded` when the
        queue is full and :class:`EngineUnavailable` when not serving."""
        deadline = None if timeout is None else time.monotonic() + timeout
        req = InferenceRequest(image, deadline)
        with self._lock:
            if not self._accepting:
                raise EngineUnavailable("engine is not serving")
            try:
                self._queue.put_nowait(req)
            except queue_mod.Full:
                self.shed += 1
                raise Overloaded(f"queue full ({self._queue.maxsize})") from None
        return req

    def infer(self, image: np.ndarray, timeout: Optional[float] = None) -> dict:
        return self.submit(image, timeout).result()

    def _bucket(self, req: InferenceRequest) -> tuple[int, int]:
        h, w = req.image.shape[:2]
        return self.runner.bucket_for(self.mode, h, w)

    def _take_batch(self) -> Optional[list[InferenceRequest]]:
        """Up to ``batch_size`` requests of one bucket; None on stop."""
        if self._carry:
            first = self._carry.pop(0)
        else:
            first = self._queue.get()
            if first is self._STOP:
                return None
        batch, bucket, rest = [first], self._bucket(first), []
        pending = self._carry
        self._carry = []
        while len(batch) < self.runner.batch_size:
            if pending:
                req = pending.pop(0)
            else:
                try:
                    req = self._queue.get_nowait()
                except queue_mod.Empty:
                    break
                if req is self._STOP:
                    self._queue.put(self._STOP)
                    break
            (batch if self._bucket(req) == bucket else rest).append(req)
        self._carry = rest + pending
        return batch

    def _worker_loop(self) -> None:
        # STOP is taken only once the carry is empty: every accepted
        # request is served before the worker ends.
        while (batch := self._take_batch()) is not None:
            self._serve(batch)

    def _serve(self, batch: list[InferenceRequest]) -> None:
        now = time.monotonic()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                req._set_error(DeadlineExceeded("deadline passed in the queue"))
            else:
                live.append(req)
        if not live:
            return
        try:
            results = self.runner.run(self.mode, self._bucket(live[0]),
                                      [r.image for r in live])
        except Exception as e:  # noqa: BLE001 - the worker must keep serving
            for req in live:
                req._set_error(e)
            return
        for req, res in zip(live, results):
            req._set_result(res)
        self.served += len(live)


def build_engine(cfg, variables, buckets=None, batch_size: Optional[int] = None,
                 device=None, mode: str = "full", max_queue: int = 16) -> InferenceEngine:
    """A runner and an engine from a config and a ``state_dict``;
    ``batch_size`` defaults to ``cfg.serve.batch_size``."""
    if batch_size is None:
        batch_size = cfg.serve.batch_size
    runner = DetectorRunner(cfg, variables, buckets=buckets, batch_size=batch_size,
                            device=device, with_proposals=(mode == "proposals"))
    return InferenceEngine(runner, max_queue=max_queue, mode=mode)
