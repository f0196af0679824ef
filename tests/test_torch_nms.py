"""NMS: the port's plain versions against ``mx_rcnn_tpu.ops.nms`` and the
Pallas NMS kernel in interpret mode.  Keep masks, ranked indices and
class-offset NMS are all bitwise: the inputs include ``-inf`` and invalid
lanes, snapped-score ties, and dense overlapping clusters."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops import nms as J
from mx_rcnn_tpu.ops.pallas.nms import nms_mask_pallas
from mx_rcnn_tpu_torch.ops import nms as T
from mx_rcnn_tpu_torch.ops.cuda.nms import nms_keep_sorted_plain, nms_mask_cuda

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)


def _case(seed, n, canvas=300.0):
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(0, canvas, (n, 2))
    # Clusters: every box near one of a few centres, so suppression chains.
    ctr = ctr[rng.randint(0, max(1, n // 8), n)] + rng.randn(n, 2) * 6
    wh = rng.uniform(10, 60, (n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    scores = (np.round(rng.rand(n) * 8) / 8).astype(np.float32)  # ties
    scores[::6] = -np.inf
    valid = rng.rand(n) > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("n,thresh", [(1, 0.5), (37, 0.5), (200, 0.7), (300, 0.3)])
def test_nms_mask_matches_jax_and_pallas(n, thresh):
    boxes, scores, valid = _case(n, n)
    want = np.asarray(J.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                 jnp.asarray(valid)))
    pallas = np.asarray(nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                        jnp.asarray(valid), interpret=True))
    tb, ts, tv = map(torch.from_numpy, (boxes, scores, valid))
    np.testing.assert_array_equal(T.nms_mask(tb, ts, thresh, tv).numpy(), want)
    np.testing.assert_array_equal(nms_mask_cuda(tb, ts, thresh, tv).numpy(), pallas)
    np.testing.assert_array_equal(pallas, want)


def test_batched_nms_mask_equals_per_row():
    rows = [_case(s, 120) for s in range(3)]
    tb = torch.from_numpy(np.stack([r[0] for r in rows]))
    ts = torch.from_numpy(np.stack([r[1] for r in rows]))
    batched = T.nms_mask(tb, ts, 0.6)
    kernel_plain = nms_mask_cuda(tb, ts, 0.6)
    for i, (b, s, _) in enumerate(rows):
        want = np.asarray(J.nms_mask(jnp.asarray(b), jnp.asarray(s), 0.6))
        np.testing.assert_array_equal(batched[i].numpy(), want)
        np.testing.assert_array_equal(kernel_plain[i].numpy(), want)


def test_keep_sorted_plain_is_the_greedy_definition():
    boxes, _, valid = _case(5, 90)
    keep = nms_keep_sorted_plain(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5).numpy()
    # The sequential definition the kernel implements, in numpy.
    alive = valid.copy()
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        for j in range(i + 1, len(boxes)):
            iw = max(min(boxes[i, 2], boxes[j, 2]) - max(boxes[i, 0], boxes[j, 0]), 0)
            ih = max(min(boxes[i, 3], boxes[j, 3]) - max(boxes[i, 1], boxes[j, 1]), 0)
            inter = np.float32(iw) * np.float32(ih)
            union = np.float32(area[i] + area[j]) - inter
            iou = np.float32(inter / union) if union > 0 else np.float32(0)
            if valid[j] and np.round(iou * 65536) / 65536 > np.float32(0.5):
                alive[j] = False
    np.testing.assert_array_equal(keep, alive)


@pytest.mark.parametrize("max_outputs", [10, 64, 150])
def test_rank_keep_and_nms_indices(max_outputs):
    boxes, scores, valid = _case(7, 100)
    ji, jv = J.nms_indices(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_outputs,
                           jnp.asarray(valid))
    for impl in ("xla", "pallas"):
        ti, tv = T.nms_indices(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                               max_outputs, torch.from_numpy(valid), nms_impl=impl)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sweep_cap_matches_jax():
    boxes, scores, _ = _case(8, 150)
    for cap in (1, 2, 500):
        want = J.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.4, sweep_cap=cap)
        got = T.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.4, sweep_cap=cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_class_offset_nms_matches_jax():
    boxes, scores, valid = _case(9, 200)
    classes = np.random.RandomState(9).randint(1, 6, 200).astype(np.int32)
    want = J.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.5,
                         valid=jnp.asarray(valid))
    got = T.batched_nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                        torch.from_numpy(classes)[None], 0.5, valid=torch.from_numpy(valid)[None])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        T.nms_indices(torch.zeros(3, 4), torch.zeros(3), 0.5, 2, nms_impl="cuda")
