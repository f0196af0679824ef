"""Host prefetch and the pinned, asynchronous upload (port of
``mx_rcnn_tpu/parallel/prefetch.py``).

Two overlaps, as in JAX:

- **Host-work overlap** — :class:`_HostPrefetcher` (the ``host-prefetch``
  thread, JAX's, with its close and exception-relay semantics) pulls host
  batches (``data/loader.py::HostBatch``) ahead of the consumer, so
  decode, flip and the gt arrays overlap the step instead of serializing
  with it.  On the card it also copies each host batch into a pinned
  staging buffer (:class:`PinnedStaging`), so the host batch, which may
  be a view of an shm ring slot or a cache entry, is dropped there.
- **Transfer overlap** — the consumer issues each batch's H2D copy
  (``non_blocking``, from the pinned buffer) and its letterbox
  (``data/loader.py::device_batch``) on a dedicated copy stream, ``depth``
  batches ahead of the one it yields, and records an event.  The step's
  stream waits on that event before it uses the batch, and
  ``record_stream`` marks the batch's tensors for the caching allocator,
  so their memory is not handed to the next copy while the step reads
  them.  A staging buffer is reused only after its copy's event has
  completed.

With a CPU device the device half (``data/loader.py::device_half``) runs
synchronously in the consumer, as before.  Batch order is unchanged
(single producer, single consumer, FIFO), so the data schedule, and with
it quarantine substitution and bitwise resume, is the synchronous
pipeline's.

:class:`PrefetchStats` meters only what the overlap does not hide: the
time the consumer blocks waiting for a host batch that is not ready (the
``data_stall_ms`` of the train loop's log).  A buffered batch costs about
0 however long it took to build; the upload and letterbox hidden behind
the step are not stall.  With ``host_depth=0`` (:func:`_timed_pulls`)
every pull is synchronous, so its whole time is, both halves: the
``data_stall_ms`` of the port before the prefetch.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch.data.loader import HostBatch, device_batch, device_half

log = logging.getLogger("mx_rcnn_tpu_torch")


class PrefetchStats:
    """Time the consumer spent blocked waiting for batches; ``take()``
    returns it and resets, so callers meter an interval at a time."""

    def __init__(self) -> None:
        self.stall_s = 0.0
        self.batches = 0

    def add(self, stall_s: float) -> None:
        self.stall_s += stall_s
        self.batches += 1

    def take(self) -> tuple[float, int]:
        """(accumulated stall seconds, batches) since the last take."""
        out = (self.stall_s, self.batches)
        self.stall_s = 0.0
        self.batches = 0
        return out


class _HostPrefetcher:
    """Background-thread stage: pulls from ``it`` ahead of the consumer.

    Exceptions raised by the source iterator are re-raised in the
    consumer at the position they occurred (the failure is part of the
    stream, not swallowed in the thread).  ``close()`` stops the thread
    promptly even if it is blocked on a full queue; iterating a closed
    prefetcher raises StopIteration.
    """

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 1,
                 stats: Optional[PrefetchStats] = None) -> None:
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._stats = stats
        self._thread = threading.Thread(target=self._run, args=(it,), name="host-prefetch",
                                        daemon=True)
        self._thread.start()

    def _run(self, it: Iterator) -> None:
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put((item, None), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            payload = (self._DONE, None)
        except BaseException as exc:  # noqa: BLE001 — relayed to the consumer
            payload = (self._DONE, exc)
        while not self._stop.is_set():
            try:
                self._q.put(payload, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> "_HostPrefetcher":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        if self._stats is None:
            item, exc = self._q.get()
        else:
            # Time only the blocking wait: a buffered item costs no clock
            # read beyond the happy path's.
            try:
                item, exc = self._q.get_nowait()
                self._stats.add(0.0)
            except queue.Empty:
                t0 = time.perf_counter()
                item, exc = self._q.get()
                self._stats.add(time.perf_counter() - t0)
        if item is self._DONE:
            self._stop.set()
            if exc is not None:
                raise exc
            raise StopIteration
        return item

    def close(self, raise_pending: bool = False) -> Optional[BaseException]:
        """Stop and join the thread, close the source iterator, and return
        any exception the producer hit that the consumer never pulled (or
        raise it with ``raise_pending``): the train loop logs it at
        teardown, which must not die on a stream the run abandoned."""
        self._stop.set()
        pending: Optional[BaseException] = None

        def drain() -> None:
            nonlocal pending
            try:
                while True:
                    _, exc = self._q.get_nowait()
                    if exc is not None and pending is None:
                        pending = exc
            except queue.Empty:
                pass

        # Drain so a producer blocked on put() sees the stop event, join,
        # then drain again for anything it published while exiting.
        drain()
        self._thread.join(timeout=5.0)
        drain()
        # Close the source chain so loader threads and service workers are
        # reclaimed; an exception the source raises at close (the loader's
        # own prefetch wrapper does) folds into ours.
        close = getattr(self._it, "close", None)
        if close is not None:
            try:
                close()
            except RuntimeError:
                pass  # generator already executing or closed
            except BaseException as exc:  # noqa: BLE001 — folded, not fatal
                if pending is None:
                    pending = exc
        if pending is not None and raise_pending:
            raise pending
        return pending


def _timed_pulls(it: Iterator, stats: PrefetchStats) -> Iterator:
    """``host_depth=0``: every pull is synchronous (here the host half,
    the upload and the letterbox), so the whole ``next(it)`` is
    consumer-blocking stall."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        stats.add(time.perf_counter() - t0)
        yield item


class _Field(NamedTuple):
    name: str
    offset: int
    dtype: np.dtype
    shape: tuple


class Staged(NamedTuple):
    """A host batch packed into a pinned buffer: every non-None field of
    the :class:`HostBatch` at a 64-byte-aligned offset (``layout``), and
    its letterbox geometry kept on the host."""

    buffer: torch.Tensor     # pinned uint8, at least ``nbytes`` long
    nbytes: int
    layout: tuple            # of _Field
    geometry: tuple          # (src_hw, image_hw, canvas_hw), numpy copies


class PinnedStaging:
    """The pinned staging buffers of one :func:`device_prefetch`: the
    ``host-prefetch`` thread packs each host batch into a free buffer
    (:meth:`stage`), the consumer issues its H2D copy and hands it back
    with the copy's event (:meth:`release`).  A buffer is reused only
    after that event has completed; one too small for a batch is replaced
    by a larger one (a quarter over, so sizes that wander settle)."""

    def __init__(self) -> None:
        self._free: queue.SimpleQueue = queue.SimpleQueue()

    def _buffer(self, nbytes: int) -> torch.Tensor:
        try:
            buf, event = self._free.get_nowait()
        except queue.Empty:
            buf, event = None, None
        if event is not None:
            event.synchronize()  # its last copy has read it
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes + nbytes // 4, dtype=torch.uint8, pin_memory=True)
        return buf

    def stage(self, hb: HostBatch) -> Staged:
        layout, off = [], 0
        for name, arr in zip(HostBatch._fields, hb):
            if arr is None:
                continue
            off = -(-off // 64) * 64
            layout.append(_Field(name, off, arr.dtype, arr.shape))
            off += arr.nbytes
        buf = self._buffer(off)
        host = buf.numpy()
        for f in layout:
            arr = getattr(hb, f.name)
            host[f.offset:f.offset + arr.nbytes] = np.ascontiguousarray(arr).reshape(-1).view(
                np.uint8)
        geometry = (hb.src_hw.copy(), hb.image_hw.copy(), hb.canvas_hw.copy())
        return Staged(buf, off, tuple(layout), geometry)

    def release(self, buf: torch.Tensor, event) -> None:
        self._free.put((buf, event))


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool}


def _upload(staged: Staged, device: torch.device):
    """On the current (copy) stream: one H2D copy of the staged buffer,
    the fields as views of it, the letterbox.  -> (batch, [tensors the
    step's stream must be recorded on])."""
    dev = torch.empty(staged.nbytes, dtype=torch.uint8, device=device)
    dev.copy_(staged.buffer[:staged.nbytes], non_blocking=True)
    fields = {}
    for f in staged.layout:
        n = int(np.prod(f.shape, dtype=np.int64)) * f.dtype.itemsize
        fields[f.name] = dev[f.offset:f.offset + n].view(_TORCH_DTYPES[f.dtype]).view(f.shape)
    batch = device_batch(fields, staged.geometry)
    return batch, [dev, batch.images]


class _Staging:
    """``it``'s host batches packed into pinned buffers, one a ``next``
    (run by the ``host-prefetch`` thread): the host batch, which may hold
    an shm slot's lease, is dropped as soon as it is packed.  ``close()``
    closes ``it``, started or not."""

    def __init__(self, it: Iterator[HostBatch], staging: PinnedStaging) -> None:
        self._it = it
        self._staging = staging

    def __iter__(self) -> "_Staging":
        return self

    def __next__(self) -> Staged:
        return self._staging.stage(next(self._it))

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


def device_prefetch(it: Iterator[HostBatch], device, depth: int = 2, host_depth: int = 1,
                    stats: Optional[PrefetchStats] = None) -> Iterator:
    """Device batches (``data/batch.py::Batch``) from a stream of host
    batches.  ``host_depth``: host batches the ``host-prefetch`` thread
    reads ahead (0: synchronous pulls in the consumer's thread, each
    uploaded and letterboxed there, in its stream).  On a CUDA ``device``
    with ``host_depth`` > 0, batches upload from pinned staging and
    letterbox on a copy stream, ``depth`` ahead of the one yielded; on the
    CPU the device half runs in the consumer.  ``stats`` meters the
    consumer's stall.  Closing the returned generator stops the thread and
    closes ``it``."""
    device = torch.device(device)
    if host_depth <= 0:
        # Both halves in the consumer, so both are stall.
        batches: Iterator = (device_half(hb, device) for hb in it)
        try:
            yield from (batches if stats is None else _timed_pulls(batches, stats))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        return
    cuda = device.type == "cuda"
    staging = PinnedStaging() if cuda else None
    src = _HostPrefetcher(_Staging(it, staging) if cuda else it, host_depth, stats=stats)
    try:
        if not cuda:
            for hb in src:
                yield device_half(hb, device)
            return
        copy_stream = torch.cuda.Stream(device)
        inflight: collections.deque = collections.deque()

        def ready(item):
            batch, event, tensors = item
            step_stream = torch.cuda.current_stream(device)
            step_stream.wait_event(event)
            for t in tensors:
                t.record_stream(step_stream)
            return batch

        for staged in src:
            with torch.cuda.stream(copy_stream):
                batch, tensors = _upload(staged, device)
                event = torch.cuda.Event()
                event.record(copy_stream)
            staging.release(staged.buffer, event)
            inflight.append((batch, event, tensors))
            if len(inflight) > depth:
                yield ready(inflight.popleft())
        while inflight:
            yield ready(inflight.popleft())
    finally:
        pending = src.close()
        if pending is not None:
            # The consumer stopped before it would have seen this (a loader
            # failure during early close): log, do not raise from teardown.
            log.warning("host prefetch: source raised after consumer stopped: %s: %s",
                        type(pending).__name__, pending)
