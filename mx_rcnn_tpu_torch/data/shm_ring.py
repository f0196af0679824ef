"""CRC-stamped shared-memory ring buffers for the input service (the
port's copy of ``mx_rcnn_tpu/data/shm_ring.py``, byte for byte the same
slot format: a slot either package writes decodes in the other).

The zero-copy hand-off between decode workers and the consumer
(data/service.py).  The pickle transport sends whole host batches
(``data/loader.py::HostBatch``) through ``multiprocessing.Queue`` pipes —
every batch is serialized in the worker, copied through the OS pipe, and
deserialized in the parent: three full copies of the pixel payload per
batch.  Here each worker owns
one ``multiprocessing.shared_memory`` segment divided into fixed-size
**slots**; the worker writes tensors straight into a slot and ships only
a tiny ``("shm", idx, (slot, nbytes, stalls))`` control message, and the
consumer maps the slot as numpy views without copying a byte.

Blob discipline mirrors the tensor cache (data/cache.py, ``MXTC1``):
``MXRB1`` magic, u32 header length, JSON header (per-field dtype / shape
/ offset, payload CRC32, total bytes), payload.  Two deliberate
differences, both because a slot is rewritten in place rather than
published atomically via ``os.replace``:

* the header lives in a fixed reserve at the slot start and the payload
  at a fixed offset after it, so the payload can be written (and CRC'd)
  **before** the header that describes it;
* the magic is zeroed before any write and restored last, so a torn
  writer (worker SIGKILLed mid-write) leaves a slot that fails the magic
  check, not one that parses.

Validation order on read — magic, header bounds, JSON, payload CRC —
raises ``ValueError`` with the same category-prefix convention as the
cache (``shm_truncated: ...`` / ``shm_checksum: ...``), so the service
can quarantine with one ``reason = str(e).split(":")[0]``.

**Slot lifecycle / backpressure.**  Free slot ids travel a bounded
``free_q`` (consumer -> worker): the worker blocks (still heartbeating)
when every slot is full — the bounded-slot equivalent of the legacy
bounded result queue, and the wait is counted as a **stall** the service
exports as ``data_shm_ring_stalls_total``.  A zero-copy read pins the
slot: the returned arrays are ``_ShmArray`` views whose finalizers
return the slot to ``free_q`` only when the LAST array dies, so a slot
can never be rewritten under a batch the training loop still holds.
Finalizers see only the numpy views.  In torch the hazard has two forms:
``torch.from_numpy`` of a view aliases the slot (the tensor keeps its
view, and so its lease, alive — sound, but the slot stays pinned as long
as the tensor lives), and an asynchronous host-to-device copy straight
from a slot would read it after the view, and so the lease, is gone.  So
the device half (``data/loader.py::device_half``, and
``parallel/prefetch.py``'s pinned staging) copies out of the slot, into
a fresh tensor or pinned memory, before the host batch is dropped.  Every
field still sits at 8 (mod 64) (``MISALIGN``), the JAX layout: the JAX
package needs it (its CPU backend zero-copies 64-byte-aligned arrays),
and one layout keeps the two packages' slots interchangeable.
``close()`` unlinks the segment immediately (the name is gone) but
defers the unmap until every lease drains — live views stay valid on a
ring whose worker already died.

Failure isolation matches the per-worker result queues it replaces: one
ring per worker, torn down whole on death and recreated fresh for the
respawn, so a crashed writer can corrupt at most its own slots — and a
corrupt slot is detected by CRC, quarantined, and the batch index
reassigned (content is deterministic, so the stream stays bit-identical;
see data/service.py).
"""

from __future__ import annotations

import importlib
import json
import queue
import struct
import threading
import weakref
import zlib
from multiprocessing import shared_memory
from typing import Any, Optional

import numpy as np

MAGIC = b"MXRB1\n"
# Fixed header region per slot: magic + u32 length + JSON header.  The
# payload starts here so it can be written and CRC'd before the header.
HEADER_RESERVE = 4096
# Field payloads start at this residue (mod 64) within the payload area:
# 8-byte aligned (every dtype we ship), but never 16-byte aligned: the
# JAX package's layout (XLA zero-copies only aligned buffers), kept so a
# slot reads the same in both packages.  torch aliases any alignment, so
# here the device half's copy out of the slot is what keeps the lease
# protocol sound (see the module docstring).
MISALIGN = 8


class SlotOverflow(RuntimeError):
    """The value does not fit one slot — caller falls back to pickle."""


class _Segment(shared_memory.SharedMemory):
    """SharedMemory whose ``__del__`` tolerates live exported views.
    When the consumer holds zero-copy arrays at interpreter shutdown the
    base class raises ``BufferError`` from ``mmap.close()``; the OS
    reclaims the mapping at process exit anyway, so swallow it instead
    of spraying "Exception ignored" tracebacks."""

    def __del__(self) -> None:
        try:
            super().__del__()
        except BufferError:
            pass


class _ShmArray(np.ndarray):
    """ndarray view into a ring slot.  A Python-level subclass so
    instances accept weakrefs (base ndarrays do not); the finalizer on
    each field view is what returns the slot to the free queue."""


def shm_eligible(value: Any) -> bool:
    """True when ``value`` is a NamedTuple of ndarray-or-None fields —
    the only shape the ring encodes; anything else rides the pickle
    fallback."""
    if not (isinstance(value, tuple) and hasattr(value, "_fields")):
        return False
    return all(
        f is None or (isinstance(f, np.ndarray) and f.dtype != object)
        for f in value
    )


def encode_into(buf, base: int, slot_bytes: int, value) -> int:
    """Write ``value`` (an :func:`shm_eligible` NamedTuple) into the slot
    at ``buf[base:base+slot_bytes]``; returns payload bytes written.
    Raises :class:`SlotOverflow` when it does not fit (the slot is left
    invalid — magic zeroed — and can be reused)."""
    # Invalidate first: a reader (or a crash before the final magic
    # write) must see a torn slot, never a stale-but-valid one.
    buf[base:base + len(MAGIC)] = b"\x00" * len(MAGIC)
    fields = []
    off = 0
    for name, arr in zip(type(value)._fields, value):
        if arr is None:
            fields.append({"name": name, "null": True})
            continue
        a = np.ascontiguousarray(arr)
        nb = a.nbytes
        # Place every field at 8 (mod 64) (MISALIGN, the JAX layout).  A
        # torch.from_numpy tensor of a view would alias the slot at any
        # alignment, so the device half copies out before the view dies.
        # The gap bytes are zeroed so the contiguous payload CRC stays
        # deterministic.
        pad = (MISALIGN - off) % 64
        if pad:
            gap = base + HEADER_RESERVE + off
            buf[gap:gap + pad] = b"\x00" * pad
            off += pad
        if HEADER_RESERVE + off + nb > slot_bytes:
            raise SlotOverflow(
                f"field {name} ({nb} bytes at offset {off}) exceeds slot "
                f"of {slot_bytes} bytes"
            )
        dst = np.ndarray(
            a.shape, dtype=a.dtype, buffer=buf,
            offset=base + HEADER_RESERVE + off,
        )
        np.copyto(dst, a)
        fields.append({
            "name": name, "dtype": str(a.dtype), "shape": list(a.shape),
            "off": off, "nbytes": nb,
        })
        off += nb
    crc = zlib.crc32(buf[base + HEADER_RESERVE:base + HEADER_RESERVE + off])
    header = json.dumps({
        "v": 1,
        "cls": [type(value).__module__, type(value).__qualname__],
        "nbytes": off,
        "crc32": crc,
        "fields": fields,
    }).encode()
    if len(MAGIC) + 4 + len(header) > HEADER_RESERVE:
        raise SlotOverflow(
            f"header of {len(header)} bytes exceeds the "
            f"{HEADER_RESERVE}-byte reserve"
        )
    struct.pack_into("<I", buf, base + len(MAGIC), len(header))
    hoff = base + len(MAGIC) + 4
    buf[hoff:hoff + len(header)] = header
    buf[base:base + len(MAGIC)] = MAGIC  # valid LAST
    return off


def decode_from(buf, base: int, slot_bytes: int, copy: bool,
                on_array_freed=None) -> tuple[Any, int]:
    """Rebuild the NamedTuple from the slot; ``(value, payload_bytes)``.

    ``copy=False`` returns read-only :class:`_ShmArray` views into the
    slot, each registered with ``on_array_freed`` (called once per field
    array as it is garbage collected).  ``copy=True`` returns owning
    arrays — safe after the ring is gone (death salvage).

    Raises ``ValueError("shm_truncated: ...")`` /
    ``ValueError("shm_checksum: ...")`` — same category-prefix discipline
    as the tensor cache.
    """
    if bytes(buf[base:base + len(MAGIC)]) != MAGIC:
        raise ValueError("shm_truncated: bad slot magic (torn writer)")
    (hlen,) = struct.unpack_from("<I", buf, base + len(MAGIC))
    if not 0 < hlen <= HEADER_RESERVE - len(MAGIC) - 4:
        raise ValueError(f"shm_truncated: header length {hlen} out of range")
    hoff = base + len(MAGIC) + 4
    try:
        header = json.loads(bytes(buf[hoff:hoff + hlen]))
    except ValueError as e:
        raise ValueError(f"shm_truncated: header unparseable ({e})")
    total = int(header["nbytes"])
    if HEADER_RESERVE + total > slot_bytes:
        raise ValueError(
            f"shm_truncated: payload {total} exceeds slot {slot_bytes}"
        )
    pbase = base + HEADER_RESERVE
    if zlib.crc32(buf[pbase:pbase + total]) != header["crc32"]:
        raise ValueError("shm_checksum: payload crc mismatch")
    mod, qual = header["cls"]
    cls = getattr(importlib.import_module(mod), qual)
    values = []
    for f in header["fields"]:
        if f.get("null"):
            values.append(None)
            continue
        arr = np.frombuffer(
            buf, dtype=np.dtype(f["dtype"]),
            count=int(np.prod(f["shape"], dtype=np.int64)) if f["shape"]
            else 1,
            offset=pbase + f["off"],
        ).reshape(f["shape"])
        if copy:
            values.append(arr.copy())
        else:
            view = arr.view(_ShmArray)
            view.flags.writeable = False
            if on_array_freed is not None:
                weakref.finalize(view, on_array_freed)
            values.append(view)
    return cls(*values), total


class ShmRing:
    """Parent-side ring: one shared segment, ``slots`` fixed slots, and
    the free-slot queue that doubles as backpressure."""

    def __init__(self, ctx, slots: int, slot_bytes: int,
                 name: Optional[str] = None) -> None:
        if slots < 1 or slot_bytes <= HEADER_RESERVE:
            raise ValueError(
                f"need slots >= 1 and slot_bytes > {HEADER_RESERVE}, got "
                f"{slots} x {slot_bytes}"
            )
        self.slots = int(slots)
        # Round slot size up to a 64-byte multiple: the segment is page-
        # aligned, so this keeps every slot base at 0 (mod 64) and the
        # encode-side MISALIGN residue therefore holds for absolute
        # addresses too.
        self.slot_bytes = -(-int(slot_bytes) // 64) * 64
        self._shm = _Segment(
            create=True, size=self.slots * self.slot_bytes, name=name,
        )
        self.name = self._shm.name
        self._free_q = ctx.Queue(maxsize=self.slots)
        for s in range(self.slots):
            self._free_q.put(s)
        self._lock = threading.Lock()
        self._leases = 0      # outstanding zero-copy field arrays
        self._closed = False
        self._unmapped = False

    def handle(self) -> dict:
        """Picklable worker-side handle (spawn Process args)."""
        return {
            "name": self.name, "slots": self.slots,
            "slot_bytes": self.slot_bytes, "free_q": self._free_q,
        }

    # -- consumer side -----------------------------------------------------

    def read(self, slot: int, copy: bool = False) -> tuple[Any, int]:
        """Decode slot -> ``(value, payload_bytes)``.  ``copy=False``
        pins the slot until every returned field array is collected;
        ``copy=True`` releases it immediately.  ``ValueError`` on a
        torn/corrupt slot (the caller quarantines and must
        :meth:`release` the slot itself)."""
        base = slot * self.slot_bytes
        if copy:
            value, nbytes = decode_from(
                self._shm.buf, base, self.slot_bytes, copy=True
            )
            self.release(slot)
            return value, nbytes
        n_arrays = 0
        state = {"left": 0}

        def freed() -> None:
            with self._lock:
                state["left"] -= 1
                last = state["left"] == 0
                if last:
                    self._leases -= 1
            if last:
                self.release(slot)
                self._maybe_unmap()

        value, nbytes = decode_from(
            self._shm.buf, base, self.slot_bytes, copy=False,
            on_array_freed=freed,
        )
        n_arrays = sum(1 for v in value if v is not None)
        if n_arrays == 0:
            return value, nbytes  # all-None tuple: nothing pins the slot
        with self._lock:
            state["left"] = n_arrays
            self._leases += 1
        return value, nbytes

    def release(self, slot: int) -> None:
        """Return a slot to the writer (duplicate / corrupt / drained)."""
        with self._lock:
            if self._closed:
                return
        try:
            self._free_q.put_nowait(slot)
        except Exception:  # noqa: BLE001 — queue torn down under us
            pass

    def corrupt_slot(self, slot: int) -> None:
        """Chaos hook: flip one payload byte so the CRC check fires."""
        off = slot * self.slot_bytes + HEADER_RESERVE
        self._shm.buf[off] ^= 0xFF

    @property
    def leases(self) -> int:
        with self._lock:
            return self._leases

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Unlink the segment now (the name is gone from /dev/shm); the
        unmap waits for outstanding zero-copy leases, so batches already
        handed to the consumer stay valid."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for q_op in ("cancel_join_thread", "close"):
            try:
                getattr(self._free_q, q_op)()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
        self._maybe_unmap()

    def _maybe_unmap(self) -> None:
        with self._lock:
            if not self._closed or self._unmapped or self._leases > 0:
                return
            self._unmapped = True
        try:
            self._shm.close()
        except BufferError:
            # A lease raced us; its finalizer calls back in here.
            with self._lock:
                self._unmapped = False


class ShmRingWriter:
    """Worker-side writer built from :meth:`ShmRing.handle`.  Attaches
    lazily (first write) so constructing it in the spawn args costs
    nothing if the worker dies in boot."""

    def __init__(self, handle: dict) -> None:
        self._name = handle["name"]
        self.slots = handle["slots"]
        self.slot_bytes = handle["slot_bytes"]
        self._free_q = handle["free_q"]
        self._shm: Optional[shared_memory.SharedMemory] = None

    def _buf(self):
        if self._shm is None:
            self._shm = _Segment(name=self._name)
        return self._shm.buf

    def acquire(self, timeout: float) -> Optional[int]:
        """Next free slot id, or None after ``timeout`` (the caller
        loops, heartbeating — a full ring is backpressure, not death)."""
        try:
            return self._free_q.get(timeout=timeout)
        except queue.Empty:
            return None
        except (OSError, EOFError, ValueError):
            return None  # parent tore the queue down; caller falls back

    def unget(self, slot: int) -> None:
        try:
            self._free_q.put_nowait(slot)
        except Exception:  # noqa: BLE001
            pass

    def write(self, slot: int, value) -> int:
        """Encode ``value`` into ``slot``; returns payload bytes.
        :class:`SlotOverflow` when it does not fit."""
        return encode_into(
            self._buf(), slot * self.slot_bytes, self.slot_bytes, value
        )

    def close(self) -> None:
        if self._shm is not None:
            try:
                self._shm.close()
            except BufferError:
                pass
            self._shm = None
