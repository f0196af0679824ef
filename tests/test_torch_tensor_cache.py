"""The port's tensor cache (``mx_rcnn_tpu_torch/data/cache.py``) against
the JAX package's, and against the port's own uncached loader.

  * ``record_source_signature`` is JAX's, for a file record and an
    in-memory one (equal strings);
  * the namespace is the port's own: ``transform_fingerprint`` differs
    from JAX's for the same ``DataConfig``, and a root the JAX package
    populated serves the port nothing;
  * a blob round-trips bitwise through disk, read-only;
  * a corrupt and a truncated blob are quarantined with JAX's reasons
    (``cache_checksum``, ``cache_truncated``; the journals equal but for
    the path and timestamps), unlinked, and rebuilt with the same bits;
  * through the loader, a cold cache, a warm one (every read a hit) and
    no cache give the same batches, bitwise, host and device halves;
  * records that are chaos-bad or already quarantined never read the
    cache: a planted blob for them is never served.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import DataConfig as JaxDataConfig
from mx_rcnn_tpu.data import cache as JC
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data import cache as PC
from mx_rcnn_tpu_torch.data.loader import CHAOS_BAD_IMAGES_ENV, DetectionLoader, device_half
from mx_rcnn_tpu_torch.data.roidb import RoiRecord

KW = dict(dataset="synthetic", image_size=(96, 128), short_side=96, max_side=128,
          max_gt_boxes=8)


def records(rng, n=6, path_of=None):
    out = []
    for i in range(n):
        h, w = (96, 128) if i % 3 else (120, 90)
        path = (path_of or {}).get(i, "")
        out.append(RoiRecord(
            f"im{i}", path, h, w, np.array([[4.0, 5.0, 60.0, 70.0]], np.float32),
            np.array([1], np.int32),
            image_array=None if path else rng.randint(0, 256, (h, w, 3)).astype(np.uint8)))
    return out


def sync_loader(roidb, cfg, **kw):
    return DetectionLoader(roidb, cfg, 2, "cpu", seed=3, prefetch=False, num_workers=0,
                           service_workers=0, **kw)


def host_batches(loader, epochs=1):
    return list(loader._raw_train_batches(0, epochs=epochs))


def assert_host_equal(a, b):
    for x, y in zip(a, b, strict=True):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)


def test_source_signature_is_jaxs(rng, tmp_path):
    from PIL import Image

    path = tmp_path / "a.jpg"
    Image.fromarray(rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)).save(path)
    mem = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    for port, jax in (
            (RoiRecord("a", str(path), 20, 30, np.zeros((0, 4)), np.zeros(0)),
             JaxRecord("a", str(path), 20, 30, np.zeros((0, 4)), np.zeros(0))),
            (RoiRecord("b", "", 20, 30, np.zeros((0, 4)), np.zeros(0), image_array=mem),
             JaxRecord("b", "", 20, 30, np.zeros((0, 4)), np.zeros(0), image_array=mem)),
            (RoiRecord("c", str(tmp_path / "gone.jpg"), 20, 30, np.zeros((0, 4)), np.zeros(0)),
             JaxRecord("c", str(tmp_path / "gone.jpg"), 20, 30, np.zeros((0, 4)), np.zeros(0)))):
        assert PC.record_source_signature(port) == JC.record_source_signature(jax)


def test_namespace_is_the_ports_own(rng, tmp_path):
    cfg = JaxDataConfig(**KW)
    assert PC.transform_fingerprint() != JC.transform_fingerprint(cfg)
    rec = records(rng, 1)[0]
    theirs = JC.TensorCache(str(tmp_path), cfg)
    theirs.put(theirs.key(rec, False), rec.image_array, 96, 128)
    ours = PC.TensorCache(str(tmp_path))
    assert ours.dir != theirs.dir
    assert ours.get(ours.key(rec, False), rec.image_id) is None
    assert ours.key(rec, False) == theirs.key(rec, False)  # the namespace alone keeps them apart


def test_round_trip(rng, tmp_path):
    cache = PC.TensorCache(str(tmp_path))
    rec = records(rng, 1)[0]
    key = cache.key(rec, True)
    assert key != cache.key(rec, False)
    assert cache.get(key, rec.image_id) is None
    img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    cache.put(key, img, 96, 128)
    assert img.flags.writeable  # the caller's array is not taken over
    got, h, w = PC.TensorCache(str(tmp_path)).get(key, rec.image_id)  # from disk
    assert (h, w) == (96, 128) and not got.flags.writeable
    np.testing.assert_array_equal(got, img)


def _blob(cache):
    (name,) = [n for n in os.listdir(cache.dir) if n.endswith(".blob")]
    return os.path.join(cache.dir, name)


@pytest.mark.parametrize("fault,reason", [("flip", "cache_checksum"), ("cut", "cache_truncated")])
def test_bad_blob_is_quarantined_as_jax_and_rebuilt(rng, tmp_path, fault, reason):
    rec = records(rng, 1)[0]
    img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    journals = {}
    for name, cache in (("port", PC.TensorCache(str(tmp_path / "p"), ram_bytes=0,
                                                quarantine_path=str(tmp_path / "p.jsonl"))),
                        ("jax", JC.TensorCache(str(tmp_path / "j"), JaxDataConfig(**KW),
                                               ram_bytes=0,
                                               quarantine_path=str(tmp_path / "j.jsonl")))):
        key = cache.key(rec, False)
        cache.put(key, img, 96, 128)
        blob = _blob(cache)
        with open(blob, "r+b") as f:
            if fault == "flip":
                f.seek(-4, os.SEEK_END)
                tail = f.read(4)
                f.seek(-4, os.SEEK_END)
                f.write(bytes(b ^ 0xFF for b in tail))
            else:
                f.truncate(os.path.getsize(blob) // 2)
        assert cache.get(key, rec.image_id) is None and cache.corrupt == 1
        assert not os.path.exists(blob)
        cache.put(key, img, 96, 128)
        got, _, _ = cache.get(key, rec.image_id)
        np.testing.assert_array_equal(got, img)
        journals[name] = [{k: v for k, v in r.items() if k not in ("ts", "ts_mono_ns", "path")}
                          for r in (PC if name == "port" else JC).quarantine_read(
                              str(tmp_path / f"{name[0]}.jsonl"))]
    assert journals["port"] == journals["jax"]
    assert [r["reason"] for r in journals["port"]] == [reason]


def test_hits_are_bitwise_misses_through_the_loader(rng, tmp_path):
    roidb = records(rng)
    cfg = DataConfig(**KW, cache_dir=str(tmp_path / "tc"))
    cold = sync_loader(roidb, cfg)
    want = host_batches(cold)
    assert cold._tensor_cache.misses > 0 and cold._tensor_cache.hits == 0
    warm = sync_loader(roidb, cfg)
    got = host_batches(warm)
    assert warm._tensor_cache.hits == cold._tensor_cache.misses and warm._tensor_cache.misses == 0
    plain = host_batches(sync_loader(roidb, DataConfig(**KW)))
    for a, b, c in zip(want, got, plain, strict=True):
        assert_host_equal(a, b)
        assert_host_equal(a, c)
        for x, y in zip(device_half(a, "cpu"), device_half(b, "cpu")):
            assert (x is None and y is None) or torch.equal(x, y)


def test_bad_and_quarantined_records_never_read_the_cache(rng, tmp_path, monkeypatch):
    roidb = records(rng, 4, path_of={1: str(tmp_path / "missing.jpg")})
    cfg = DataConfig(**KW, cache_dir=str(tmp_path / "tc"))
    cache = PC.TensorCache(cfg.cache_dir)
    planted = np.full((96, 128, 3), 7, np.uint8)

    def plant(rec):  # the blobs a healthier life of the record would have left
        for flip in (False, True):
            cache.put(cache.key(rec, flip), planted, 96, 128)

    monkeypatch.setenv(CHAOS_BAD_IMAGES_ENV, "im0")
    loader = DetectionLoader(roidb, cfg, 1, "cpu", seed=0, prefetch=False, num_workers=0,
                             service_workers=0, io_retries=0)
    plant(roidb[0])
    pixels, ok = loader._pixels(roidb[1], False)  # the missing file: quarantined
    assert not ok and not pixels.any()
    plant(roidb[1])
    for rec in (roidb[0], roidb[1]):
        for flip in (False, True):
            pixels, ok = loader._pixels(rec, flip)
            assert not ok and not pixels.any()
    assert loader._quarantined == {"im0", "im1"}
    pixels, ok = loader._pixels(roidb[2], False)
    assert ok and np.array_equal(pixels, roidb[2].image_array)
