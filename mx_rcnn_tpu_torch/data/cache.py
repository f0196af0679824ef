"""The quarantine journal and the tensor cache (port of
``mx_rcnn_tpu/data/cache.py``).

**Quarantine journal.** ``quarantine_append`` writes one ``O_APPEND``
``os.write`` a record, so a record is either fully present or absent:
writers (loader threads, service workers, the cache, the service's shm
check) interleave at line granularity and a crash mid-append tears at
most the final line, which ``quarantine_read`` skips.  Records carry a
wall-clock and a monotonic timestamp and a ``reason`` (``io`` |
``annotation`` | ``cache_checksum`` | ``cache_truncated`` |
``shm_checksum`` | ``shm_truncated``).

**TensorCache.** The port letterboxes on the card
(``data/loader.py::device_half``), so what it caches is the host half's
pixels: each record's decoded uint8 RGB at source size, flipped as the
key says (JAX's cache holds the letterboxed tensor).  The contract is
JAX's: the key hashes the record's source identity
(:func:`record_source_signature`, JAX's exactly), the flip and the
namespace (:func:`transform_fingerprint`); a blob is ``MXTC1`` magic, a
JSON header with the payload's CRC32, and the payload, published with
``os.replace``, staged through a RAM LRU.  A corrupt or truncated blob is
quarantined (``cache_checksum`` / ``cache_truncated``), unlinked and
rebuilt from source, never served, so a hit is bitwise invisible
downstream.  The namespace is the port's own: a ``data.cache_dir`` shared
with the JAX package never serves one package's blobs to the other.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import logging
import os
import struct
import tempfile
import threading
import time
import zlib
from collections import OrderedDict
from typing import Optional

import numpy as np

from mx_rcnn_tpu_torch import obs

log = logging.getLogger("mx_rcnn_tpu_torch")


def quarantine_append(path: str, record: dict, once_per: tuple[str, ...] = ()) -> bool:
    """Append one JSON record crash-safely, with ``ts`` (epoch seconds) and
    ``ts_mono_ns`` (monotonic, for in-run ordering) unless given.

    ``once_per``: field names; the record is skipped when the journal
    already holds one with the same values of those fields.  The check and
    the append run under an exclusive ``flock``, so the processes that
    share a journal (a loader and its input service's workers, each of
    which meets a bad record on its own) journal it once.  Returns whether
    the record was written."""
    rec = dict(record)
    rec.setdefault("ts", round(time.time(), 3))
    rec.setdefault("ts_mono_ns", time.monotonic_ns())
    line = (json.dumps(rec) + "\n").encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        if once_per:
            fcntl.flock(fd, fcntl.LOCK_EX)
            key = tuple(rec.get(k) for k in once_per)
            if any(tuple(r.get(k) for k in once_per) == key for r in quarantine_read(path)):
                return False
        os.write(fd, line)
        return True
    finally:
        os.close(fd)  # releases the lock


def quarantine_read(path: str) -> list[dict]:
    """All parseable records; a torn trailing line or a corrupt interior
    line is skipped, not fatal."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path, "rb") as f:
        for line in f:
            try:
                out.append(json.loads(line.decode("utf-8", "replace")))
            except ValueError:
                continue
    return out


# -- tensor cache -------------------------------------------------------------

# Blob layout: MAGIC, u32 header length, JSON header, raw payload bytes.
_MAGIC = b"MXTC1\n"
_VERSION = 1


def transform_fingerprint() -> str:
    """The cache's namespace: the port's tag and blob version, what the
    blob holds, and the decoder's version.  No ``DataConfig`` field changes
    the host half's bytes (the letterbox geometry is the device half's),
    so a geometry change keeps the cache; a new PIL may decode a JPEG to
    other bits, so it opens a new namespace."""
    try:
        import PIL

        decoder = f"PIL {PIL.__version__}"
    except ImportError:
        decoder = "none"
    sig = {
        "package": "mx_rcnn_tpu_torch",
        "v": _VERSION,
        "pixels": "decoded uint8 RGB at source size, flipped per key",
        "decoder": decoder,
    }
    return hashlib.sha1(json.dumps(sig, sort_keys=True).encode()).hexdigest()[:16]


def record_source_signature(rec) -> str:
    """Identity of a record's source pixels (JAX's exactly): path, size and
    mtime_ns for a file, so that a replaced file misses; the CRC of the
    bytes for an in-memory array."""
    if rec.image_array is not None:
        arr = np.ascontiguousarray(rec.image_array)
        return f"mem:{arr.dtype}:{arr.shape}:{zlib.crc32(arr.view(np.uint8).ravel())}"
    try:
        st = os.stat(rec.image_path)
        return f"file:{rec.image_path}:{st.st_size}:{st.st_mtime_ns}"
    except OSError:
        # Unreadable now: key on the path alone; the load fails and
        # quarantines, and nothing is cached for this record.
        return f"file:{rec.image_path}:?"


class TensorCache:
    """RAM + disk cache of host-half pixels under
    ``<root>/tensors/<transform_fingerprint()>``.

    ``get`` returns ``(pixels, h, w)`` or None (a miss, or a corrupt blob,
    quarantined); ``put`` stores them.  Returned arrays are read-only:
    entries are shared, and the host half copies them into each batch."""

    def __init__(self, root: str, ram_bytes: int = 256 << 20,
                 quarantine_path: Optional[str] = None) -> None:
        self.dir = os.path.join(root, "tensors", transform_fingerprint())
        os.makedirs(self.dir, exist_ok=True)
        self.quarantine_path = quarantine_path
        self._ram_budget = max(int(ram_bytes), 0)
        self._ram: OrderedDict[str, tuple] = OrderedDict()
        self._ram_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.corrupt = 0

    def key(self, rec, flip: bool) -> str:
        raw = f"{rec.image_id}|{record_source_signature(rec)}|flip={int(flip)}"
        return hashlib.sha1(raw.encode()).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.blob")

    @staticmethod
    def _encode(pixels: np.ndarray, th: int, tw: int) -> bytes:
        arr = np.ascontiguousarray(pixels)
        payload = arr.tobytes()
        header = json.dumps({
            "dtype": str(arr.dtype), "shape": list(arr.shape), "th": int(th), "tw": int(tw),
            "crc32": zlib.crc32(payload), "nbytes": len(payload),
        }).encode()
        return _MAGIC + struct.pack("<I", len(header)) + header + payload

    @staticmethod
    def _decode(blob: bytes) -> tuple:
        """(pixels, th, tw), or ValueError with a category prefix."""
        if len(blob) < len(_MAGIC) + 4 or not blob.startswith(_MAGIC):
            raise ValueError("cache_truncated: bad magic/short blob")
        off = len(_MAGIC)
        (hlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        if len(blob) < off + hlen:
            raise ValueError("cache_truncated: header clipped")
        try:
            header = json.loads(blob[off:off + hlen])
        except ValueError as e:
            raise ValueError(f"cache_truncated: header unparseable ({e})") from e
        payload = blob[off + hlen:]
        if len(payload) != header["nbytes"]:
            raise ValueError(f"cache_truncated: payload {len(payload)} != "
                             f"{header['nbytes']} bytes")
        if zlib.crc32(payload) != header["crc32"]:
            raise ValueError("cache_checksum: payload crc mismatch")
        arr = np.frombuffer(payload, dtype=np.dtype(header["dtype"]))
        return arr.reshape(header["shape"]), header["th"], header["tw"]

    def get(self, key: str, image_id: str = "?"):
        with self._lock:
            hit = self._ram.get(key)
            if hit is not None:
                self._ram.move_to_end(key)
                self.hits += 1
                return hit
        try:
            with open(self._path(key), "rb") as f:
                blob = f.read()
        except OSError:
            self.misses += 1
            return None
        try:
            value = self._decode(blob)
        except ValueError as e:
            self._quarantine_blob(key, image_id, e)
            return None
        self.hits += 1
        self._ram_put(key, value)
        return value

    def put(self, key: str, pixels: np.ndarray, th: int, tw: int) -> None:
        arr = np.ascontiguousarray(pixels)
        if arr is pixels:
            arr = arr.copy()  # the entry must not alias the caller's array
        arr.flags.writeable = False
        value = (arr, int(th), int(tw))
        self._ram_put(key, value)
        blob = self._encode(arr, th, tw)
        # Atomic publish: a reader sees the old blob, the new one, or none.
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _ram_put(self, key: str, value: tuple) -> None:
        if not self._ram_budget:
            return
        with self._lock:
            if key in self._ram:
                self._ram.move_to_end(key)
                return
            self._ram[key] = value
            self._ram_bytes += value[0].nbytes
            while self._ram_bytes > self._ram_budget and len(self._ram) > 1:
                _, (old, _, _) = self._ram.popitem(last=False)
                self._ram_bytes -= old.nbytes

    def _quarantine_blob(self, key: str, image_id: str, error: ValueError) -> None:
        """Journal the corrupt blob, unlink it; the caller rebuilds."""
        with self._lock:
            self.corrupt += 1
        reason = str(error).split(":", 1)[0]
        if reason not in ("cache_checksum", "cache_truncated"):
            reason = "cache_checksum"
        path = self._path(key)
        obs.emit("data", "cache_quarantine", {
            "image_id": image_id, "error": str(error), "path": path, "reason": reason,
        }, logger=log)
        obs.counter("cache_quarantines_total", "corrupt tensor blobs quarantined").inc(
            reason=reason)
        if self.quarantine_path:
            quarantine_append(self.quarantine_path, {
                "image_id": image_id, "path": path, "reason": reason,
                "error": f"{type(error).__name__}: {error}", "retries": 0,
            })
        try:
            os.unlink(path)
        except OSError:
            pass
