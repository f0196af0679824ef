"""The port's shm ring (``mx_rcnn_tpu_torch/data/shm_ring.py``) against
the JAX package's (``mx_rcnn_tpu/data/shm_ring.py``).  Bitwise everywhere:

  * the slot format is one: a slot the port writes decodes with JAX's
    ``decode_from`` to equal arrays (the port's ``HostBatch``), and a slot
    JAX writes decodes with the port's (JAX's ``Batch``), None fields too;
  * ten values through a two-slot ring come back bitwise (wraparound);
    an oversized value raises ``SlotOverflow`` and leaves the slot usable;
  * a torn magic and a flipped payload byte raise the same
    ``shm_truncated:`` / ``shm_checksum:`` prefixes in both packages;
  * a zero-copy read leases the slot while a ``torch.from_numpy`` tensor
    of one of its views lives, and frees it once the tensor is gone;
  * every exported field sits at 8 (mod 64) (``MISALIGN``), as in JAX.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import warnings

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.data import shm_ring as JR
from mx_rcnn_tpu.data.batch import Batch as JaxBatch
from mx_rcnn_tpu_torch.data import shm_ring as PR
from mx_rcnn_tpu_torch.data.loader import HostBatch

SLOT = 1 << 16


def host_batch(rng, b=2, g=4, masks=True, ext=False) -> HostBatch:
    hw = [(12, 16), (16, 10)][:b]
    return HostBatch(
        pixels=rng.randint(0, 256, sum(h * w * 3 for h, w in hw)).astype(np.uint8),
        src_hw=np.asarray(hw, np.int32),
        image_hw=np.asarray([[24, 32], [32, 20]][:b], np.float32),
        canvas_hw=np.asarray([32, 32], np.int32),
        gt_boxes=rng.rand(b, g, 4).astype(np.float32),
        gt_classes=rng.randint(0, 5, (b, g)).astype(np.int32),
        gt_valid=rng.rand(b, g) > 0.5,
        gt_ignore=None,
        ext_rois=rng.rand(b, 6, 4).astype(np.float32) if ext else None,
        ext_valid=(rng.rand(b, 6) > 0.5) if ext else None,
        gt_masks=rng.rand(b, g, 8, 8).astype(np.float32) if masks else None,
    )


def jax_batch(rng, b=2, g=4) -> JaxBatch:
    return JaxBatch(
        images=rng.randint(0, 256, (b, 16, 24, 3)).astype(np.uint8),
        image_hw=np.array([[16, 24]] * b, np.float32),
        gt_boxes=rng.rand(b, g, 4).astype(np.float32),
        gt_classes=rng.randint(0, 5, (b, g)).astype(np.int32),
        gt_valid=rng.rand(b, g) > 0.5,
    )


def assert_same(a, b):
    assert type(a) is type(b)
    for fa, fb in zip(a, b, strict=True):
        if fa is None or fb is None:
            assert fa is None and fb is None
        else:
            assert fa.dtype == fb.dtype
            np.testing.assert_array_equal(fa, fb)


def ring_pair(slots=2, slot_bytes=SLOT):
    ring = PR.ShmRing(mp.get_context("spawn"), slots, slot_bytes)
    return ring, PR.ShmRingWriter(ring.handle())


@pytest.mark.parametrize("writer,reader", [(PR, JR), (JR, PR)], ids=["port->jax", "jax->port"])
def test_codec_round_trips_across_packages(rng, writer, reader):
    for value in (host_batch(rng), host_batch(rng, masks=False, ext=True), jax_batch(rng)):
        buf = bytearray(SLOT)
        n = writer.encode_into(buf, 0, SLOT, value)
        got, total = reader.decode_from(buf, 0, SLOT, copy=True)
        assert total == n
        assert_same(value, got)


def test_eligibility_matches_jax(rng):
    for v in (host_batch(rng), jax_batch(rng), (1, 2), "x",
              host_batch(rng)._replace(pixels=np.array([object()], dtype=object))):
        assert PR.shm_eligible(v) == JR.shm_eligible(v)
    assert PR.shm_eligible(host_batch(rng))


def test_wraparound_reuses_slots_bitwise(rng):
    ring, writer = ring_pair(slots=2)
    try:
        for i in range(10):
            value = host_batch(rng, b=1 + i % 2, masks=bool(i % 3))
            slot = writer.acquire(timeout=1.0)
            assert slot is not None
            writer.write(slot, value)
            got, _ = ring.read(slot, copy=True)
            assert_same(value, got)
    finally:
        writer.close()
        ring.close()


def test_overflow_leaves_slot_reusable(rng):
    ring, writer = ring_pair(slot_bytes=PR.HEADER_RESERVE + 1024)
    try:
        slot = writer.acquire(timeout=1.0)
        with pytest.raises(PR.SlotOverflow):
            writer.write(slot, host_batch(rng))
        small = host_batch(rng, b=1, g=1, masks=False)
        writer.write(slot, small)
        got, _ = ring.read(slot, copy=True)
        assert_same(small, got)
    finally:
        writer.close()
        ring.close()


@pytest.mark.parametrize("pkg", [PR, JR], ids=["port", "jax"])
@pytest.mark.parametrize("fault,prefix", [("magic", "shm_truncated"), ("payload", "shm_checksum")])
def test_torn_and_corrupt_slots_raise_the_same_prefix(rng, pkg, fault, prefix):
    buf = bytearray(SLOT)
    pkg.encode_into(buf, 0, SLOT, host_batch(rng))
    if fault == "magic":
        buf[:len(pkg.MAGIC)] = b"\x00" * len(pkg.MAGIC)
    else:
        buf[pkg.HEADER_RESERVE + pkg.MISALIGN] ^= 0xFF
    with pytest.raises(ValueError, match=f"^{prefix}:"):
        pkg.decode_from(buf, 0, SLOT, copy=True)


def test_torch_tensor_of_a_view_holds_the_lease(rng):
    ring, writer = ring_pair(slots=1)
    try:
        slot = writer.acquire(timeout=1.0)
        writer.write(slot, host_batch(rng))
        got, _ = ring.read(slot, copy=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the view is read-only
            t = torch.from_numpy(got.gt_boxes)
        want = t.clone()
        del got
        gc.collect()
        assert ring.leases == 1 and writer.acquire(timeout=0.1) is None
        assert torch.equal(t, want)
        del t
        gc.collect()
        assert ring.leases == 0 and writer.acquire(timeout=1.0) == slot
    finally:
        writer.close()
        ring.close()


def test_every_field_sits_at_8_mod_64(rng):
    assert PR.MISALIGN == JR.MISALIGN == 8
    ring, writer = ring_pair()
    try:
        slot = writer.acquire(timeout=1.0)
        writer.write(slot, host_batch(rng, ext=True))
        got, _ = ring.read(slot, copy=False)
        ptrs = [f.__array_interface__["data"][0] for f in got if f is not None]
        assert len(ptrs) == 10 and all(p % 64 == 8 for p in ptrs)
        del got
        gc.collect()
    finally:
        writer.close()
        ring.close()
