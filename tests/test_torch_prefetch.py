"""The port's host prefetch (``mx_rcnn_tpu_torch/parallel/prefetch.py``)
and loader read-ahead (``data/loader.py::_Prefetched``) against the JAX
package's, and the prefetched stream against the synchronous one.

  * ``TestHostPrefetcher``'s cases with the same inputs through both
    packages: FIFO order, a source exception relayed at its position
    (then the stream stays ended), ``close()`` while the producer blocks
    on a full queue, the thread joined by closing ``device_prefetch``,
    ``host_depth=0`` starting no thread; ``close()`` returns an exception
    the consumer never pulled;
  * ``_Prefetched.close`` reclaims its thread and re-raises a pending
    exception, in both packages;
  * on the CPU, ``device_prefetch`` over the loader's host batches gives
    the synchronous batches, bitwise, at ``host_depth`` 0 and 1;
  * marked ``gpu`` (skipped without a card): the pinned copy-stream
    batches equal the synchronous ones bitwise at 800x1344, batch 2.
    On the card: ``python -m pytest --noconftest -q -p no:cacheprovider
    tests/test_torch_prefetch.py -m gpu``.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np
import pytest
import torch

try:
    from mx_rcnn_tpu.data import loader as JL
    from mx_rcnn_tpu.parallel import prefetch as JP
except ImportError:  # the card's machine has no jax: only the gpu test runs there
    JL = JP = None
from mx_rcnn_tpu_torch.config import DataConfig, apply_overrides, get_config
from mx_rcnn_tpu_torch.data import loader as PL
from mx_rcnn_tpu_torch.data.datasets import build_dataset
from mx_rcnn_tpu_torch.parallel import prefetch as PP

PACKAGES = pytest.mark.parametrize("pkg", ["port", "jax"])


def prefetcher(pkg):
    return (PP if pkg == "port" else JP)._HostPrefetcher


def prefetched(pkg):
    return (PL if pkg == "port" else JL)._Prefetched


def alive(name):
    return [t for t in threading.enumerate() if t.name == name and t.is_alive()]


def failing(n=3):
    yield from range(n)
    raise ValueError("decode exploded")


@PACKAGES
def test_order_preserved(pkg):
    assert list(prefetcher(pkg)(iter(range(200)), depth=4)) == list(range(200))


@PACKAGES
def test_exception_relayed_after_preceding_items(pkg):
    p = prefetcher(pkg)(failing(2), depth=2)
    assert [next(p), next(p)] == [0, 1]
    with pytest.raises(ValueError, match="decode exploded"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)


@PACKAGES
def test_close_stops_the_thread_while_the_producer_blocks(pkg):
    p = prefetcher(pkg)(itertools.count(), depth=1)
    assert next(p) == 0
    p.close()
    assert not p._thread.is_alive()


@PACKAGES
def test_close_returns_an_exception_never_pulled(pkg):
    p = prefetcher(pkg)(failing(), depth=8)
    assert next(p) == 0
    deadline = time.time() + 5.0
    while p._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert isinstance(p.close(), ValueError) and not p._thread.is_alive()


def _host_batches(n=8):
    cfg = DataConfig(dataset="synthetic", image_size=(64, 64), short_side=64, max_side=64,
                     max_gt_boxes=4)
    roidb = build_dataset(cfg, train=True).roidb()[:16]
    port = PL.DetectionLoader(roidb, cfg, 2, "cpu", prefetch=False, num_workers=0)
    return list(port._raw_train_batches(0, epochs=1))[:n]


@PACKAGES
def test_closing_device_prefetch_joins_the_thread(pkg):
    before = len(alive("host-prefetch"))
    if pkg == "port":
        gen = PP.device_prefetch(iter(_host_batches()), "cpu", depth=2)
    else:
        gen = JP.device_prefetch(iter(np.arange(64).reshape(8, 8)), mesh=None, depth=2)
    assert next(gen) is not None
    assert len(alive("host-prefetch")) == before + 1
    gen.close()
    assert len(alive("host-prefetch")) == before


@PACKAGES
def test_host_depth_zero_starts_no_thread(pkg):
    before = len(alive("host-prefetch"))
    if pkg == "port":
        out = list(PP.device_prefetch(iter(_host_batches(3)), "cpu", depth=2, host_depth=0))
        assert len(out) == 3
    else:
        out = list(JP.device_prefetch(iter(range(10)), mesh=None, depth=2, host_depth=0))
        assert [int(np.asarray(x)) for x in out] == list(range(10))
    assert len(alive("host-prefetch")) == before


@PACKAGES
def test_prefetched_close_joins_and_raises_pending(pkg):
    pf = prefetched(pkg)(iter(range(100)), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    pf = prefetched(pkg)(failing(), depth=8)
    assert next(pf) == 0
    pf._thread.join(timeout=5.0)
    with pytest.raises(ValueError, match="decode exploded"):
        pf.close(raise_pending=True)
    assert not pf._thread.is_alive()


def _same(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("host_depth", [0, 1])
def test_cpu_prefetch_is_the_sync_stream(host_depth):
    host = _host_batches()
    want = [PL.device_half(hb, "cpu") for hb in host]
    stats = PP.PrefetchStats()
    got = list(PP.device_prefetch(iter(host), "cpu", depth=2, host_depth=host_depth,
                                  stats=stats))
    assert len(got) == len(want) and all(_same(a, b) for a, b in zip(got, want))
    # The threaded form also meters its last pull, the end of the stream (as JAX's).
    assert stats.take()[1] == len(host) + (host_depth > 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned copy-stream upload has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pinned_copy_stream_batches_are_the_sync_ones(cuda):
    cfg = apply_overrides(get_config("r50_fpn_coco"), ["data.dataset=synthetic"])
    roidb = build_dataset(cfg.data, train=True).roidb()[:16]
    port = PL.DetectionLoader(roidb, cfg.data, 2, cuda, prefetch=False, num_workers=0)
    host = list(port._raw_train_batches(0, epochs=1))
    want = [PL.device_half(hb, cuda) for hb in host]
    got = []
    for batch in PP.device_prefetch(iter(host), cuda, depth=2, host_depth=1):
        torch.cuda._sleep(10_000_000)  # a step's worth of work on the step's stream
        got.append(batch)
    torch.cuda.synchronize()
    assert got[0].images.shape == (2, 800, 1344, 3)
    assert len(got) == len(want) and all(_same(a, b) for a, b in zip(got, want))
