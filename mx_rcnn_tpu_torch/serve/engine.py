"""Serving runtime (port of ``mx_rcnn_tpu/serve/engine.py``).

:class:`InferenceEngine` wraps the detector's programs with the serving
behaviours of the JAX engine, on one device:

* **Startup warm-up**: every (mode, bucket) program runs once before the
  engine reports ready (which also builds the CUDA kernels), and
  :class:`DetectorRunner` refuses any program it did not warm.
* **Bucketed pad-batching**: requests letterbox into a fixed set of
  resolution buckets and pad into the static batch.
* **Admission control**: a bounded queue sheds with :class:`Overloaded`;
  per-tenant token buckets (serve/tenancy.py) refuse with
  :class:`QuotaExceeded`.
* **Per-request deadlines and the degrade ladder** (serve/degrade.py):
  the remaining budget, the latency estimates and the circuit breaker
  pick a level per request: ``full`` > ``small`` > ``full_q8`` >
  ``full_q8n`` > ``reduced`` > ``proposals``.
* **Watchdog**: a monitor thread declares the engine DEAD when a device
  call stops returning, and fails its waiters.
* **Continuous batching** (``batch_size > 1`` and ``pack``): requests of
  different callers pack into the slots of each call (serve/batcher.py).
* **Zero-downtime weight swap**: the runner loads the new weights beside
  the live ones and flips one reference.

The engine is generic over a ``runner`` (``buckets``, ``batch_size``,
``levels()``, ``pick_bucket``, ``smaller_bucket``, ``warmup``, ``run``);
:class:`DetectorRunner` is the real one, and tests drive the same engine
with fakes.  With the observability plane configured (``obs.configure``)
each request records an ``engine_request`` span with its ``queue`` and
``device`` children, and ``kill`` and the watchdog's death dump the flight
ring; unconfigured, events and metrics are counted in-process and events
land in the flight ring.

Entry points run on the card: ``device=None`` means ``"cuda"``, and with
no card they raise rather than fall back to the CPU.  Tests pass
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import logging
import queue as queue_mod
import threading
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.transforms import letterbox, normalize_image
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.detection.graph import forward_inference, forward_proposals
from mx_rcnn_tpu_torch.evalutil.postprocess import unletterbox_detections
from mx_rcnn_tpu_torch.serve import health as health_mod
from mx_rcnn_tpu_torch.serve import tenancy as tenancy_mod
from mx_rcnn_tpu_torch.serve.batcher import PackBuffer
from mx_rcnn_tpu_torch.serve.degrade import (
    FULL_QUALITY_LEVELS,
    CircuitBreaker,
    HysteresisPlanner,
    LatencyEstimator,
)
from mx_rcnn_tpu_torch.serve.quantize import (
    apply_box_head_q8,
    dequantize_network,
    is_quantized_leaf,
    quantize_box_head,
    quantize_network,
)
from mx_rcnn_tpu_torch.utils.device import resolve_device

log = logging.getLogger("mx_rcnn_tpu_torch.serve")


class ServeError(RuntimeError):
    """Base class for typed serving failures."""


class Overloaded(ServeError):
    """Admission control shed this request: the queue is full."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before a result was produced."""


class EngineUnavailable(ServeError):
    """The engine cannot serve (not started, stopped, or declared dead), or
    an unwarmed program was asked for."""


class QuotaExceeded(ServeError):
    """The caller's tenant is over its token-bucket quota
    (serve/tenancy.py); its own budget, not the engine's pressure."""

    retry_after_s: float = 1.0  # admission sets the real value


class Plan(NamedTuple):
    level: str              # degrade.LEVELS entry
    mode: str               # program family: full | full_q8 | full_q8n | reduced | proposals
    bucket: tuple[int, int]  # canvas (H, W)


class InferenceRequest:
    """A submitted request; ``result()`` blocks until served or failed."""

    __slots__ = ("image", "enqueued_at", "deadline", "_event", "_result",
                 "_error", "plan", "_callbacks", "_cb_lock",
                 "trace_id", "span", "queue_span", "tenant")

    def __init__(self, image: np.ndarray, enqueued_at: float,
                 deadline: Optional[float]) -> None:
        self.image = image
        self.enqueued_at = enqueued_at
        self.deadline = deadline
        # Resolved tenant name (serve/tenancy.py); None on the
        # single-tenant path, which the batcher folds to the default.
        self.tenant: Optional[str] = None
        self._event = threading.Event()
        self._result: Optional[dict] = None
        self._error: Optional[BaseException] = None
        self.plan: Optional[Plan] = None
        self._callbacks: list[Callable[["InferenceRequest"], None]] = []
        self._cb_lock = threading.Lock()
        # Tracing state (obs/tracing.py): set by submit() when span
        # recording is on; _finish() closes whatever is still open, so
        # every completion path (served, shed, deadline, engine death)
        # ends the request's span tree exactly once.
        self.trace_id: Optional[str] = None
        self.span = None
        self.queue_span = None

    def _set_result(self, result: dict) -> None:
        self._result = result
        self._finish()

    def _set_error(self, error: BaseException) -> None:
        self._error = error
        self._finish()

    def _finish(self) -> None:
        if self.queue_span is not None:
            self.queue_span.end()
        if self.span is not None:
            if self._error is not None:
                self.span.set(error=type(self._error).__name__)
            self.span.end()
        self._event.set()
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 - a callback must not kill
                log.exception("request done-callback raised")  # the worker

    def add_done_callback(self, fn: Callable[["InferenceRequest"], None]) -> None:
        """Call ``fn(request)`` exactly once when the request completes
        (success or failure); at once if it already did."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def error(self) -> Optional[BaseException]:
        """The failure, if the request is done and failed (non-blocking)."""
        return self._error if self._event.is_set() else None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until done (or ``timeout``); True when complete."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        """The served detections (boxes, scores, classes, level,
        latency_s, generation); raises the typed serving error on
        failure."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not complete")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


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


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module call, so that
    ``torch.func.functional_call`` can put other tensors in the model's
    place for one call (the ``full_q8n`` program)."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


class _Live(NamedTuple):
    """One generation of weights: everything a call reads, flipped as one
    reference by :meth:`DetectorRunner.swap_weights`."""

    model: TwoStageDetector     # full / small / proposals
    reduced: TwoStageDetector   # the same tensors, the reduced caps
    q8: Optional[dict]          # quantized box head (full_q8)
    q8n: Optional[dict]         # quantized network, "model."-prefixed keys (full_q8n)
    generation: int


class DetectorRunner:
    """The detector on one device over fixed shape buckets.

    Programs, every one run at :meth:`warmup` and none added after:
      * ``("full", bucket)`` for EVERY bucket: the production detector;
      * ``("full_q8", bucket)`` for every bucket with ``int8_head``: the
        int8/bf16 box head (serve/quantize.py);
      * ``("full_q8n", bucket)`` for every bucket with ``int8_network``:
        the forward on dequantized int8 weights, run through
        ``torch.func.functional_call`` so that only int8 and scales stay
        on the device;
      * ``("reduced", smallest bucket)``: ``reduced_max_detections``
        output slots (``fused_top_k`` capped at four times that);
      * ``("proposals", smallest bucket)`` with ``with_proposals``: RPN
        boxes only, class-agnostic.

    ``cfg.serve.fused_middle`` overrides the proposal middle of every
    program: ``"on"`` forces the fused CUDA middle (``rpn.fused_middle=True,
    nms_impl="pallas"``), ``"off"`` the plain chain, ``"inherit"`` keeps
    ``cfg.model.rpn``.

    **Double-buffered weights**: the live generation is one :class:`_Live`
    tuple.  :meth:`swap_weights` loads the new one beside it (on a side
    stream on the card, synchronized before the flip) while the live one
    keeps serving, then flips the reference, so a concurrent :meth:`run`
    sees all-old or all-new weights.  Every result carries the
    ``generation`` that served it.
    """

    def __init__(
        self,
        cfg,
        variables: dict[str, torch.Tensor],
        buckets: Optional[Sequence[tuple[int, int]]] = None,
        batch_size: int = 1,
        reduced_max_detections: Optional[int] = None,
        with_proposals: bool = True,
        int8_head: bool = False,
        int8_network: bool = False,
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
        self.reduced_cfg = dataclasses.replace(
            self.model_cfg,
            test=dataclasses.replace(
                self.model_cfg.test,
                max_detections=self.reduced_max_detections,
                fused_top_k=min(self.model_cfg.test.fused_top_k,
                                4 * self.reduced_max_detections),
            ),
        )
        self._int8_head = bool(int8_head)
        self._int8_network = bool(int8_network)
        self._program_keys = [("full", b) for b in self.buckets]
        if self._int8_head:
            self._program_keys += [("full_q8", b) for b in self.buckets]
        if self._int8_network:
            self._program_keys += [("full_q8n", b) for b in self.buckets]
        self._program_keys.append(("reduced", self.buckets[0]))
        if with_proposals:
            self._program_keys.append(("proposals", self.buckets[0]))
        self._signature = self._sig(variables)
        self._side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # functional_call puts the q8n tensors into the live model for the
        # length of a call: calls run one at a time.
        self._exec_lock = threading.Lock()
        self._active = self._load(variables, 0)
        self._warmed: set[tuple[str, tuple[int, int]]] = set()

    # -- weights ----------------------------------------------------------

    @staticmethod
    def _sig(variables) -> dict:
        return {k: (tuple(v.shape), v.dtype) for k, v in variables.items()}

    def _load(self, variables, generation: int) -> _Live:
        """Build one generation on the device from a host ``state_dict``:
        the model, and the int8 trees quantized on the host from the f32
        masters.  On the card the copies run on a side stream, which is
        synchronized before this returns."""
        q8 = quantize_box_head(variables) if self._int8_head else None
        q8n = quantize_network(variables) if self._int8_network else None
        ctx = torch.cuda.stream(self._side) if self._side is not None else contextlib.nullcontext()
        with ctx:
            model = TwoStageDetector(self.model_cfg, device=self.device)
            model.load_state_dict(variables)
            model.eval()
            params = dict(model.state_dict())
            if q8 is not None:
                q8 = {name: {k: t.to(self.device) for k, t in layer.items()}
                      for name, layer in q8.items()}
            if q8n is not None:
                # int8 in the layout of the model's own tensor (channels_last
                # convolution weights), so a rebuilt weight keeps it.
                q8n = {f"model.{k}": (
                    {"q": torch.empty_like(params[k], dtype=torch.int8).copy_(v["q"]),
                     "scale": v["scale"].to(self.device)}
                    if is_quantized_leaf(v) else params[k])
                    for k, v in q8n.items()}
        if self._side is not None:
            self._side.synchronize()
            # The serving stream reads these from now on.
            main = torch.cuda.current_stream(self.device)
            for t in _tensors(params, q8, q8n):
                t.record_stream(main)
        reduced = copy.copy(model)      # shares the tensors, not the cfg
        reduced.cfg = self.reduced_cfg
        return _Live(model, reduced, q8, q8n, generation)

    @property
    def generation(self) -> int:
        """Weight-swap counter; 0 = the construction weights."""
        return self._active.generation

    def swap_weights(self, variables, generation: Optional[int] = None) -> int:
        """Zero-downtime weight swap: load the standby generation, then flip.

        ``variables`` must have the live ``state_dict``'s keys, shapes and
        dtypes (a swap never changes a program), and ``generation`` (default
        live + 1) must increase.  The new weights (and both int8 trees,
        re-quantized) are resident on the device before the flip, a single
        reference assignment.  Returns the new generation."""
        live_gen = self._active.generation
        sig = self._sig(variables)
        if sig.keys() != self._signature.keys():
            raise ValueError(
                "swap_weights: the new state_dict's keys differ from the live "
                f"ones ({sorted(sig.keys() ^ self._signature.keys())[:4]}) — a swap "
                "must not change the programs"
            )
        for k, s in sig.items():
            if s != self._signature[k]:
                raise ValueError(
                    f"swap_weights: {k} shape/dtype drift {self._signature[k]} -> {s} — "
                    "a swap must not change the programs"
                )
        gen = live_gen + 1 if generation is None else int(generation)
        if gen <= live_gen:
            raise ValueError(
                f"swap_weights: generation must be monotonic ({live_gen} -> {gen})"
            )
        self._active = self._load(variables, gen)
        return gen

    # -- engine-facing surface --------------------------------------------

    def levels(self) -> tuple[str, ...]:
        modes = {m for m, _ in self._program_keys}
        out = ["full"]
        if len(self.buckets) > 1:
            out.append("small")
        out += [m for m in ("full_q8", "full_q8n") if m in modes]
        out.append("reduced")
        if "proposals" in modes:
            out.append("proposals")
        return tuple(out)

    def pick_bucket(self, height: int, width: int) -> tuple[int, int]:
        """Smallest bucket that holds the image without downscaling; the
        largest bucket otherwise (letterbox downscales into it)."""
        for b in self.buckets:
            if b[0] >= height and b[1] >= width:
                return b
        return self.buckets[-1]

    def smaller_bucket(self, bucket: tuple[int, int]) -> Optional[tuple[int, int]]:
        i = self.buckets.index(bucket)
        return self.buckets[i - 1] if i > 0 else None

    def warmup(self) -> int:
        """Run every program once on a zero batch; returns the count."""
        live = self._active
        for mode, bucket in self._program_keys:
            images = torch.zeros((self.batch_size, *bucket, 3), device=self.device)
            hw = torch.tensor([bucket] * self.batch_size, dtype=torch.float32,
                              device=self.device)
            self._execute(mode, Batch(images=images, image_hw=hw), live)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._warmed.add((mode, bucket))
        return len(self._warmed)

    def run(self, mode: str, bucket: tuple[int, int],
            images: Sequence[np.ndarray]) -> list[dict]:
        """Serve a micro-batch of (H, W, 3) images through a warmed program;
        one dict per image in original image coordinates ("boxes",
        "scores", "classes", "generation"; a Mask R-CNN's detection
        programs add "masks", one pasted (h, w) bool mask a detection)."""
        if (mode, bucket) not in self._warmed:
            raise EngineUnavailable(
                f"program ({mode}, {bucket}) was never warmed — refusing to "
                "serve it"
            )
        if len(images) > self.batch_size:
            raise ValueError(
                f"micro-batch of {len(images)} exceeds batch_size {self.batch_size}"
            )
        # One read of the live generation: the whole micro-batch runs on it
        # even if swap_weights flips mid-call.
        live = self._active
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
        out = self._execute(mode, batch, live)
        # The copy to the host waits for the device, as JAX's device_get.
        out = type(out)(*(None if t is None else t.cpu().numpy() for t in out))
        results = [self._postprocess(mode, out, i, scales[i], *orig[i])
                   for i in range(len(images))]
        for res in results:
            res["generation"] = live.generation
        return results

    # -- internals ---------------------------------------------------------

    def _execute(self, mode: str, batch: Batch, live: _Live):
        stats = self.pixel_stats
        # The kernels launch on the calling thread's current card: a fleet's
        # worker threads serve runners on any card of the host.
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with self._exec_lock, on_card, torch.inference_mode():
            if mode == "proposals":
                return forward_proposals(live.model, batch, stats)
            if mode == "reduced":
                return forward_inference(live.reduced, batch, stats)
            if mode == "full_q8":
                return forward_inference(live.model, batch, stats,
                                         functools.partial(apply_box_head_q8, live.q8))
            if mode == "full_q8n":
                return torch.func.functional_call(
                    _Bound(live.model), dequantize_network(live.q8n),
                    (forward_inference, batch, stats))
            return forward_inference(live.model, batch, stats)

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


def level_program(runner, level: str, base: tuple[int, int]) -> tuple[str, tuple[int, int]]:
    """The (mode, bucket) program of ``runner`` that serves ``level`` for a
    request whose own bucket is ``base``: ``small`` is ``full`` at the next
    smaller bucket; ``full_q8`` and ``full_q8n`` stay at ``base`` like
    ``full`` (quantization degrades precision, not resolution); ``reduced``
    and ``proposals`` exist at the smallest bucket only."""
    if level == "small":
        smaller = runner.smaller_bucket(base)
        if smaller is None:
            raise ValueError(f"no bucket smaller than {base} for the small level")
        return "full", smaller
    if level in ("full", "full_q8", "full_q8n"):
        return level, base
    return level, runner.buckets[0]


def _tensors(*trees):
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            yield tree
        elif isinstance(tree, dict):
            yield from _tensors(*tree.values())


class InferenceEngine:
    """Bounded-queue serving loop over a runner's programs.

    Lifecycle: construct -> ``start()`` (warms every program, then starts
    the worker and watchdog threads and reports READY) -> ``submit`` /
    ``infer`` -> ``stop()``.  Usable as a context manager.
    """

    _STOP = object()

    def __init__(
        self,
        runner,
        max_queue: int = 16,
        default_timeout: Optional[float] = None,
        hang_timeout: float = 60.0,
        watchdog_poll: float = 0.25,
        headroom: float = 1.25,
        up_margin: float = 1.5,
        up_dwell: int = 3,
        breaker: Optional[CircuitBreaker] = None,
        replica_id: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        pack: bool = True,
        pack_window_s: float = 0.0,
        tenancy=None,
        tenancy_admit: bool = True,
    ) -> None:
        self.runner = runner
        self._clock = clock
        # Multi-tenancy (serve/tenancy.py): the shared TenancyPolicy, or
        # None for the single-tenant path.  ``tenancy_admit`` False leaves
        # the quota to an outer admission layer; the policy then only
        # labels and weighs packs.
        self._tenancy = tenancy
        self._tenancy_admit = bool(tenancy_admit) and tenancy is not None
        # Packing needs slots to fill; at batch_size 1 the plain take path
        # behaves the same with less machinery.
        self._pack = bool(pack) and runner.batch_size > 1
        self.pack_window_s = float(pack_window_s)
        self.default_timeout = default_timeout
        self.hang_timeout = hang_timeout
        self.watchdog_poll = watchdog_poll
        self.headroom = headroom
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.estimates = LatencyEstimator()
        self.planner = HysteresisPlanner(
            headroom=headroom, up_margin=up_margin, up_dwell=up_dwell
        )
        self.replica_id = replica_id
        self._mlabels = {
            "replica": "-" if replica_id is None else str(replica_id)
        }
        self.health = health_mod.EngineHealth(clock=clock, replica_id=replica_id)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue)
        self._carry = None  # InferenceRequest | _STOP carried across takes
        # Planned requests awaiting a pack; tenancy makes the pack
        # composition weighted-fair (serve/batcher.py).
        self._buf = PackBuffer(tenancy=self._tenancy)
        self._stop_parked = False  # STOP seen; the buffer flushes first
        self._occ_calls = 0        # device calls (occupancy denominator)
        self._occ_filled = 0       # request slots filled across them
        self._inflight_since: Optional[float] = None
        self._inflight_plan: Optional[Plan] = None
        self._inflight_reqs: list[InferenceRequest] = []
        self._lock = threading.Lock()
        self._started = False
        self._draining = False  # no new admissions; accepted work flushes
        self._stopping = False  # the worker must exit
        self._worker: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "InferenceEngine":
        if self._started:
            return self
        try:
            n = self.runner.warmup()
        except Exception as e:
            self.health.transition(
                health_mod.DEAD, f"warmup failed: {type(e).__name__}: {e}"
            )
            raise
        log.info(
            "engine ready: %d programs, buckets=%s, levels=%s",
            n, list(self.runner.buckets), list(self.runner.levels()),
        )
        self._started = True
        self.health.transition(health_mod.READY, "warmup complete")
        self._worker = threading.Thread(
            target=self._worker_loop, name="serve-worker", daemon=True
        )
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="serve-watchdog", daemon=True
        )
        self._worker.start()
        self._watchdog.start()
        return self

    def stop(self, timeout: float = 10.0, drain: bool = True) -> None:
        """Shut down.  With ``drain`` (the default) admission stops first,
        the worker flushes every accepted request, and only then is any
        residue failed.  ``drain=False`` fails queued requests at once with
        ``EngineUnavailable("engine stopping")``."""
        if not self._started or self._stopping:
            return
        self._draining = True  # submit() refuses from here on
        if not drain:
            self._stopping = True
        try:
            # Blocking put: FIFO places the sentinel behind every accepted
            # request, so a draining worker flushes them all first.
            self._queue.put(self._STOP, timeout=timeout)
        except queue_mod.Full:
            pass
        if self._worker is not None:
            self._worker.join(timeout)
        self._stopping = True
        self._fail_pending(EngineUnavailable("engine stopping"))
        self.health.transition(health_mod.DEAD, "stopped")
        if self._watchdog is not None:
            self._watchdog.join(timeout)

    def kill(self, reason: str = "killed") -> None:
        """Hard-fail the engine: DEAD now, every in-flight and queued
        request fails with a typed error; the flight ring is dumped."""
        self.health.transition(health_mod.DEAD, reason)
        obs.emit("serve", "engine_killed", {"reason": reason}, logger=log)
        obs.flight_dump("engine_killed", {"replica": self.replica_id, "reason": reason})
        error = EngineUnavailable(f"engine died: {reason}")
        with self._lock:
            stuck = list(self._inflight_reqs)
        for r in stuck:
            r._set_error(error)
        self._fail_pending(error)

    def swap_weights(self, variables, generation: Optional[int] = None) -> int:
        """Zero-downtime weight swap, delegated to the runner (standby load
        and one flip) and recorded in the health snapshot.  Safe under live
        traffic."""
        gen = self.runner.swap_weights(variables, generation=generation)
        self.health.record_swap(gen)
        return gen

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API --------------------------------------------------------

    def submit(
        self, image: np.ndarray, timeout: Optional[float] = None,
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> InferenceRequest:
        """Enqueue one (H, W, 3) image; returns at once.  Raises
        :class:`Overloaded` when the queue is full, :class:`QuotaExceeded`
        when the tenancy policy refuses the tenant, and
        :class:`EngineUnavailable` when the engine cannot serve.
        ``trace_id``/``parent_span_id`` link the request's spans under a
        caller's trace."""
        if not self._started:
            raise EngineUnavailable("engine not started")
        if self._draining or self._stopping:
            raise EngineUnavailable("engine stopping")
        if not self.health.alive():
            raise EngineUnavailable(f"engine is dead: {self.health.reason}")
        if self._tenancy is not None:
            tenant = self._tenancy.resolve(tenant)
            if self._tenancy_admit and not self._tenancy.admit(tenant):
                tlabel = self._tenancy.label(tenant)
                obs.counter(
                    "serve_quota_exceeded_total",
                    "requests rejected by per-tenant quota",
                ).inc(tenant=tlabel, **self._mlabels)
                obs.emit("serve", "tenant_quota_exceeded", {
                    "tenant": tlabel, "layer": "engine",
                }, logger=log)
                err = QuotaExceeded(f"tenant {tenant!r} over quota")
                err.retry_after_s = self._tenancy.retry_after_s(tenant)
                raise err
        now = self._clock()
        timeout = self.default_timeout if timeout is None else timeout
        req = InferenceRequest(image, now, None if timeout is None else now + timeout)
        req.tenant = tenant
        req.trace_id = trace_id
        if obs.spans_enabled():
            req.span = obs.span(
                "engine_request", subsystem="serve", trace_id=trace_id,
                parent_id=parent_span_id, attrs=dict(self._mlabels),
            )
            req.trace_id = req.span.trace_id
            req.queue_span = req.span.child("queue")
        try:
            self._queue.put_nowait(req)
        except queue_mod.Full:
            self.health.record_shed()
            self._note_pressure()
            obs.counter(
                "serve_shed_total", "requests shed by admission control"
            ).inc(**self._req_labels(tenant))
            obs.emit("serve", "shed", {
                "queue_depth": self._queue.qsize(),
                "max_queue": self._queue.maxsize,
            }, logger=log)
            if req.queue_span is not None:
                req.queue_span.end()
            if req.span is not None:
                req.span.end(error="Overloaded")
            raise Overloaded(
                f"queue full ({self._queue.maxsize} waiting); request shed"
            ) from None
        obs.counter(
            "serve_requests_total", "requests admitted"
        ).inc(**self._req_labels(tenant))
        obs.gauge(
            "serve_queue_depth", "accepted-but-unserved requests"
        ).set(self._queue.qsize(), **self._mlabels)
        return req

    def _req_labels(self, tenant: Optional[str]) -> dict:
        """Per-request metric labels: the replica always, the tenant only
        with tenancy configured (folded to the policy's vocabulary)."""
        if self._tenancy is None:
            return self._mlabels
        return dict(self._mlabels, tenant=self._tenancy.label(tenant))

    def infer(self, image: np.ndarray, timeout: Optional[float] = None) -> dict:
        return self.submit(image, timeout).result()

    @property
    def queue_depth(self) -> int:
        """Accepted-but-unserved requests, those in the pack buffer
        included."""
        return self._queue.qsize() + len(self._buf)

    def stats(self) -> dict:
        with self._lock:
            inflight_age = (
                None
                if self._inflight_since is None
                else round(self._clock() - self._inflight_since, 3)
            )
            calls, filled = self._occ_calls, self._occ_filled
        return self.health.snapshot(
            queue_depth=self.queue_depth,
            inflight_age_s=inflight_age,
            draining=self._draining,
            breaker=self.breaker.state,
            breaker_trips=self.breaker.trips,
            latency_estimates_s=self.estimates.snapshot(),
            buckets=[list(b) for b in self.runner.buckets],
            occupancy={
                "pack": self._pack,
                "batch_size": self.runner.batch_size,
                "device_calls": calls,
                "slots_filled": filled,
                "mean": (
                    round(filled / (calls * self.runner.batch_size), 4)
                    if calls else None
                ),
            },
        )

    # -- planning ----------------------------------------------------------

    def _plan(self, req: InferenceRequest) -> Plan:
        h, w = req.image.shape[:2]
        base = self.runner.pick_bucket(h, w)
        smaller = self.runner.smaller_bucket(base)
        available = [
            lvl for lvl in self.runner.levels()
            if lvl != "small" or smaller is not None
        ]
        remaining = (
            None if req.deadline is None else req.deadline - self._clock()
        )
        full_ok = self.breaker.allow_full()
        level = self.planner.plan(
            remaining, self.estimates.snapshot(), full_ok, available
        )
        if full_ok and level not in FULL_QUALITY_LEVELS:
            # A half-open probe was taken but the deadline forced a
            # degrade anyway: return it, this is no probe outcome.
            self.breaker.cancel_probe()
        return Plan(level, *level_program(self.runner, level, base))

    def _note_pressure(self) -> None:
        if self.health.state == health_mod.READY:
            self.health.transition(health_mod.DEGRADED, "load shedding")

    # -- worker ------------------------------------------------------------

    def _take_batch(self) -> Optional[list[InferenceRequest]]:
        """Next micro-batch: the first live request plus any immediately
        available requests with the SAME program, up to the static batch.
        None = nothing yet, [] = stop."""
        while True:
            if self._carry is not None:
                if self._carry is self._STOP:
                    return []
                first, self._carry = self._carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue_mod.Empty:
                    return None
            if first is self._STOP:
                return []
            if first.deadline is not None and self._clock() > first.deadline:
                self._expire(first)
                continue
            first.plan = self._plan(first)
            if first.queue_span is not None:
                first.queue_span.end(level=first.plan.level)
            batch = [first]
            while len(batch) < self.runner.batch_size:
                try:
                    nxt = self._queue.get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is self._STOP:
                    # The carry slot is free here: park the sentinel, this
                    # batch still runs and the NEXT take returns the stop.
                    self._carry = self._STOP
                    break
                if nxt.deadline is not None and self._clock() > nxt.deadline:
                    self.health.record_deadline_miss()
                    nxt._set_error(DeadlineExceeded("deadline passed while queued"))
                    continue
                nxt.plan = self._plan(nxt)
                if nxt.queue_span is not None:
                    nxt.queue_span.end(level=nxt.plan.level)
                if nxt.plan[1:] != first.plan[1:]:
                    self._carry = nxt  # another program; runs next
                    break
                batch.append(nxt)
            return batch

    def _expire(self, req: InferenceRequest) -> None:
        """Fail one request whose deadline passed before its device call."""
        self.health.record_deadline_miss()
        self._note_pressure()
        req._set_error(DeadlineExceeded("deadline passed while queued"))

    def _admit_buffered(self, item) -> bool:
        """Plan and buffer one queue item; False when it was the STOP
        sentinel (which parks: the buffer flushes before the stop)."""
        if item is self._STOP:
            self._stop_parked = True
            return False
        if item.deadline is not None and self._clock() > item.deadline:
            self._expire(item)
            return True
        item.plan = self._plan(item)
        if item.queue_span is not None:
            item.queue_span.end(level=item.plan.level)
        self._buf.add(item)
        return True

    def _take_batch_packed(self) -> Optional[list[InferenceRequest]]:
        """Continuous-batching take: pool up to ``2 * batch_size`` planned
        requests, then pack the most urgent request's program full
        (serve/batcher.py).  Same contract as :meth:`_take_batch`."""
        bs = self.runner.batch_size
        cap = 2 * bs
        for r in self._buf.expire(self._clock()):
            self._expire(r)
        while not self._stop_parked and len(self._buf) < cap:
            try:
                # Block (the worker's idle wait) only when the buffer is
                # empty; otherwise sweep what is already queued.
                if len(self._buf):
                    item = self._queue.get_nowait()
                else:
                    item = self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                if not len(self._buf):
                    return None
                break
            if not self._admit_buffered(item):
                break
        if not len(self._buf):
            return [] if self._stop_parked else None
        if self.pack_window_s > 0 and not self._stop_parked and len(self._buf) < bs:
            # Linger for stragglers to top off a partial batch.  Wall
            # clock, not self._clock: tests drive deadlines with fake
            # clocks that never advance on their own.
            t_end = time.monotonic() + self.pack_window_s
            while len(self._buf) < cap:
                left = t_end - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._queue.get(timeout=min(left, 0.01))
                except queue_mod.Empty:
                    continue
                if not self._admit_buffered(item):
                    break
        return self._buf.take(bs)

    def _worker_loop(self) -> None:
        while not self._stopping:
            batch = self._take_batch_packed() if self._pack else self._take_batch()
            if batch is None:
                continue
            if not batch:  # STOP
                break
            plan = batch[0].plan
            assert plan is not None
            obs.histogram(
                "serve_batch_occupancy",
                "request slots filled / slots total per device call",
                buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
            ).observe(len(batch) / self.runner.batch_size, level=plan.level, **self._mlabels)
            start = self._clock()
            with self._lock:
                self._occ_calls += 1
                self._occ_filled += len(batch)
                self._inflight_since = start
                self._inflight_plan = plan
                self._inflight_reqs = list(batch)
            dspan = None
            if batch[0].span is not None:
                dspan = batch[0].span.child("device", attrs={
                    "level": plan.level, "bucket": list(plan.bucket), "batch": len(batch),
                })
            try:
                results = self.runner.run(plan.mode, plan.bucket, [r.image for r in batch])
                err: Optional[BaseException] = None
            except BaseException as e:  # noqa: BLE001 - typed below
                results, err = None, e
            finally:
                if dspan is not None:
                    if err is not None:
                        dspan.set(error=type(err).__name__)
                    dspan.end()
                with self._lock:
                    self._inflight_since = None
                    self._inflight_plan = None
                    self._inflight_reqs = []
            if not self.health.alive():
                # The watchdog declared us dead while this call was stuck
                # (its requests already failed), or a kill() raced this
                # batch between the queue pop and the in-flight
                # registration: fail whatever is unresolved and drop the
                # zombie result.
                dead = EngineUnavailable("engine died mid-batch")
                for r in batch:
                    if not r.done():
                        r._set_error(dead)
                self._fail_pending(dead)
                break
            latency = self._clock() - start
            if err is not None:
                self.health.record_failure()
                if plan.level in FULL_QUALITY_LEVELS:
                    self.breaker.record_failure()
                self._note_pressure()
                for r in batch:
                    r._set_error(ServeError(
                        f"inference failed at level {plan.level}: "
                        f"{type(err).__name__}: {err}"
                    ))
                continue
            self.estimates.observe(plan.level, latency)
            late = [r for r in batch if r.deadline is not None and self._clock() > r.deadline]
            if plan.level in FULL_QUALITY_LEVELS:
                # A full-path overrun that blew the deadline counts against
                # the breaker; an on-time full result heals it.
                if late:
                    self.breaker.record_failure()
                else:
                    self.breaker.record_success()
            for r, res in zip(batch, results):
                # A pack shares one program, not necessarily one level:
                # each request reports its own plan's level.
                level = r.plan.level
                if r in late:
                    self.health.record_deadline_miss()
                    self._note_pressure()
                    r._set_error(DeadlineExceeded(
                        f"served at level {level} in {latency:.3f}s, past the deadline"
                    ))
                else:
                    self.health.record_served(level, latency)
                    obs.histogram(
                        "serve_request_latency_seconds",
                        "served request latency (device call to result)",
                    ).observe(latency, level=level, **self._req_labels(r.tenant))
                    res = dict(res)
                    res["level"] = level
                    res["latency_s"] = latency
                    # Fake runners in tests may not tag provenance.
                    res.setdefault("generation", getattr(self.runner, "generation", 0))
                    r._set_result(res)
            if (
                self.health.state == health_mod.DEGRADED
                and self.breaker.state == "closed"
                and not late
                and self._queue.qsize() < max(1, self._queue.maxsize // 2)
            ):
                self.health.transition(health_mod.READY, "pressure cleared")

    # -- watchdog ----------------------------------------------------------

    def _fail_pending(self, error: BaseException) -> None:
        for r in self._buf.drain():
            r._set_error(error)
        if self._carry is not None:
            if self._carry is not self._STOP:
                self._carry._set_error(error)
            self._carry = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue_mod.Empty:
                return
            if item is not self._STOP:
                item._set_error(error)

    def _watchdog_loop(self) -> None:
        while not self._stopping and self.health.alive():
            time.sleep(self.watchdog_poll)
            with self._lock:
                since = self._inflight_since
                plan = self._inflight_plan
            if since is None:
                continue
            age = self._clock() - since
            if age <= self.hang_timeout:
                continue
            self.health.hung += 1
            self.health.transition(
                health_mod.DEAD,
                f"device call hung for {age:.1f}s "
                f"(plan={plan}, hang_timeout={self.hang_timeout}s)",
            )
            obs.emit("serve", "engine_dead", {
                "reason": self.health.reason,
                "queued": self._queue.qsize(),
            }, logger=log)
            obs.flight_dump(
                "engine_dead", {"replica": self.replica_id, "reason": self.health.reason})
            error = EngineUnavailable(f"engine died: {self.health.reason}")
            with self._lock:
                stuck = list(self._inflight_reqs)
            for r in stuck:
                # The device call may never return; unblock its waiters.
                r._set_error(error)
            self._fail_pending(error)
            return


def build_engine(
    cfg,
    variables,
    buckets: Optional[Sequence[tuple[int, int]]] = None,
    batch_size: Optional[int] = None,
    int8_head: bool = False,
    int8_network: bool = False,
    device=None,
    **engine_kwargs,
) -> InferenceEngine:
    """A runner and an engine from a config and a ``state_dict``.
    ``cfg.serve`` supplies the micro-batch, packing and tenancy defaults;
    explicit arguments win."""
    serve_cfg = cfg.serve
    if batch_size is None:
        batch_size = serve_cfg.batch_size
    engine_kwargs.setdefault("pack", serve_cfg.pack)
    engine_kwargs.setdefault("pack_window_s", serve_cfg.pack_window_s)
    if "tenancy" not in engine_kwargs:
        engine_kwargs["tenancy"] = tenancy_mod.TenancyPolicy.from_config(serve_cfg.tenancy)
    runner = DetectorRunner(
        cfg, variables, buckets=buckets, batch_size=batch_size,
        int8_head=int8_head, int8_network=int8_network, device=device,
    )
    return InferenceEngine(runner, **engine_kwargs)
