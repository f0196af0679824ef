"""ROIAlign: the port's level assignment bitwise against the JAX package's,
boundary boxes included, and its plain multi-level ROIAlign against
``mx_rcnn_tpu.ops.roi_align.multilevel_roi_align`` (XLA) and the Pallas
kernel in interpret mode: C = 128, B = 2, levels P2-P5, float32, atol 1e-5.
The CUDA wrapper on CPU tensors is the plain version itself."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.pallas.roi_align import multilevel_roi_align_pallas
from mx_rcnn_tpu.ops.roi_align import fpn_level_assignment as jax_assign
from mx_rcnn_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align
from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_cuda
from mx_rcnn_tpu_torch.ops.roi_align import fpn_level_assignment, multilevel_roi_align

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)

ATOL = 1e-5  # float32 sums of 4 bilinear taps x 4 samples, same order in both


def _rois(rng, n, canvas=256):
    ctr = rng.rand(n, 2) * canvas
    size = 2.0 ** rng.uniform(1, np.log2(canvas * 0.9), size=(n, 2))
    x1 = ctr[:, 0] - size[:, 0] / 2
    y1 = ctr[:, 1] - size[:, 1] / 2
    return np.stack([x1, y1, x1 + size[:, 0], y1 + size[:, 1]], 1).astype(np.float32)


def test_level_assignment_bitwise_on_boundaries():
    # sqrt(area) exactly 224 * 2**j: the floor sits on an integer; extents
    # exactly 38 * 2**j: the ceil of the extent bound sits on an integer.
    sides = [224.0 * 2.0 ** j for j in range(-3, 3)]
    boxes = [[10, 10, 10 + s, 10 + s] for s in sides]
    boxes += [[0, 0, s * 2, s / 2] for s in sides]
    boxes += [[5, 5, 5 + 38.0 * 2 ** j, 6] for j in range(0, 6)]
    boxes += [[0, 0, 0, 0], [3, 3, 2, 2]]          # degenerate
    rois = np.asarray(boxes, np.float32)
    rng = np.random.RandomState(0)
    rois = np.concatenate([rois, _rois(rng, 2000, canvas=1300)])
    for extent in (38, None):
        want = np.asarray(jax_assign(jnp.asarray(rois), 2, 5, max_extent_cells=extent))
        got = fpn_level_assignment(torch.from_numpy(rois), 2, 5, max_extent_cells=extent)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # The boundary boxes themselves land where eq. 1 says.
    got = fpn_level_assignment(torch.from_numpy(rois[:6]), 0, 9, max_extent_cells=None)
    np.testing.assert_array_equal(got.numpy(), [1, 2, 3, 4, 5, 6])


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(1)
    pyr = {l: rng.rand(2, 256 >> l, 192 >> l, 128).astype(np.float32) for l in (2, 3, 4, 5)}
    rois = np.stack([_rois(rng, 24), _rois(rng, 24)])
    rois[:, :4] = [[-5, -5, 20, 30], [250, 180, 270, 200], [0, 0, 255, 191], [7, 7, 7, 7]]
    return pyr, rois


def test_plain_roi_align_matches_xla_oracle(case):
    pyr, rois = case
    got = multilevel_roi_align({l: torch.from_numpy(f) for l, f in pyr.items()},
                               torch.from_numpy(rois), 7, 2)
    want = jax.vmap(lambda p, r: jax_roi_align(p, r, output_size=7, sampling_ratio=2))(
        {l: jnp.asarray(f) for l, f in pyr.items()}, jnp.asarray(rois))
    assert got.shape == (2, 24, 7, 7, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_wrapper_on_cpu_matches_pallas_interpret(case):
    pyr, rois = case
    got = multilevel_roi_align_cuda({l: torch.from_numpy(f) for l, f in pyr.items()},
                                    torch.from_numpy(rois), 7, 2)
    want = multilevel_roi_align_pallas({l: jnp.asarray(f) for l, f in pyr.items()},
                                       jnp.asarray(rois), output_size=7, sampling_ratio=2,
                                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_bf16_features_cast_once():
    rng = np.random.RandomState(2)
    pyr = {l: rng.rand(1, 128 >> l, 128 >> l, 16).astype(np.float32) for l in (2, 3, 4, 5)}
    rois = _rois(rng, 20, canvas=128)[None]
    tp = {l: torch.from_numpy(f).to(torch.bfloat16) for l, f in pyr.items()}
    got = multilevel_roi_align(tp, torch.from_numpy(rois))
    ref = multilevel_roi_align({l: f.float() for l, f in tp.items()}, torch.from_numpy(rois))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())
