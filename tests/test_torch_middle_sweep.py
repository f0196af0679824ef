"""B3's two stages on the CPU: the suppression words
(``suppression_words_plain``) and the chunked greedy sweep over them
(``chunked_sweep_plain``), the plain versions of the fused middle's two
launches.

Over decoded candidates in positional order, words + sweep give exactly
the keep mask of ``ops/nms.py::nms_mask`` (a fixed point over the full
suppression matrix) at candidate counts on both sides of every chunk
edge, with ties, ``-inf`` pad lanes, duplicate boxes and a chain that
crosses chunks.  Decode, words and sweep together equal the plain middle and the JAX package's Pallas
``fused_middle_levels`` in interpret mode, on inputs whose decode is exact
in both (see ``test_torch_middle.py``).  The wrapper's candidate cap is
the one the sweep's shared memory allows (``csrc/nms_sweep.cuh``).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.pallas.middle import fused_middle_levels as jax_middle
from mx_rcnn_tpu_torch.ops.cuda.middle import (
    MAX_CANDIDATES,
    TILE,
    chunked_sweep_plain,
    fused_middle_levels_plain,
    suppression_words_plain,
)
from mx_rcnn_tpu_torch.ops.nms import nms_mask
from mx_rcnn_tpu_torch.ops.proposals import decode_candidates

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parents[1] / "mx_rcnn_tpu_torch" / "csrc"


def _candidates(seed, shape, k, exact_decode=False):
    """anchors, deltas (*shape, k, 4), top-k ordered scores (*shape, k)
    with ties and a -inf tail, on a 300x380 image."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 380, (*shape, k, 2))
    an = np.concatenate([xy, xy + rng.uniform(4, 120, (*shape, k, 2))], -1)
    dl = rng.randn(*shape, k, 4) * 0.3
    if exact_decode:  # every product and exp exact: no FMA or exp ulp can show
        an, dl = np.round(an * 4) / 4, np.round(dl * 16) / 16
        dl[..., 2:] = 0.0
    sc = -np.sort(-(np.round(rng.rand(*shape, k) * 12) / 12), axis=-1, kind="stable")
    sc[..., k - k // 5:] = -np.inf
    return (torch.tensor(an, dtype=torch.float32), torch.tensor(dl, dtype=torch.float32),
            torch.tensor(sc, dtype=torch.float32))


@pytest.mark.parametrize("thresh", [0.5, 0.7])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 127, 300])
def test_words_and_chunked_sweep_equal_nms_mask(k, thresh):
    an, dl, sc = _candidates(k, (2, 3), k)
    hw = torch.tensor([[300.0, 380.0], [200.0, 260.0]])
    boxes, masked = decode_candidates(sc, dl, an, hw, 4.0)
    valid = torch.isfinite(masked)
    words = suppression_words_plain(boxes, valid, thresh)
    assert words.shape == (2, 3, k, -(-k // TILE))
    keep = chunked_sweep_plain(words, valid)
    assert torch.equal(keep, nms_mask(boxes, masked, thresh))
    assert not (keep & ~valid).any()


def test_chunked_sweep_chain_across_chunks_and_duplicates():
    """Box j of a chain suppresses j + 1 (IoU 0.6) but not j + 2 (1/3), so
    greedy keeps every other one, across three chunk edges; a run of
    identical boxes keeps only its first."""
    n = 260
    j = torch.arange(200, dtype=torch.float32)
    chain = torch.stack([5 * j, 0 * j, 5 * j + 20, 0 * j + 20], -1)
    dup = torch.tensor([[600.0, 600.0, 640.0, 650.0]]).expand(n - 200, 4)
    boxes = torch.cat([chain, dup])[None]
    valid = torch.ones((1, n), dtype=torch.bool)
    keep = chunked_sweep_plain(suppression_words_plain(boxes, valid, 0.5), valid)[0]
    assert bool(keep[:200:2].all()) and not keep[1:200:2].any()
    assert bool(keep[200]) and not keep[201:].any()
    scores = torch.linspace(1.0, 0.0, n)[None]
    assert torch.equal(keep[None], nms_mask(boxes, scores, 0.5))


def test_words_bits_and_lower_tiles():
    """Bit c of word w in row i is the pair (i, 64 w + c); the words of
    tiles below the diagonal, and of invalid rows and columns, are 0."""
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]]).repeat(1, 140, 1)
    valid = torch.ones((1, 140), dtype=torch.bool)
    valid[0, 5] = False
    words = suppression_words_plain(boxes, valid, 0.7)[0]
    bit = lambda i, j: bool((words[i, j // 64] >> (j % 64)) & 1)  # noqa: E731
    assert bit(0, 70) and bit(3, 139) and bit(64, 127)
    assert not bit(70, 3) and not bit(4, 4) and not bit(5, 9) and not bit(2, 5)
    assert not words[64:, 0].any() and not words[128:, :2].any()


def _two_stage_middle(anchors, deltas, scores, image_hw, min_size, iou_threshold):
    """The fused middle as the kernel stages it, in plain torch: decode,
    then launch (a)'s words, then launch (b)'s chunked sweep."""
    boxes, masked = decode_candidates(scores, deltas, anchors, image_hw, min_size)
    valid = torch.isfinite(masked)
    words = suppression_words_plain(boxes, valid, iou_threshold)
    return boxes, masked, chunked_sweep_plain(words, valid)


@pytest.mark.parametrize("k", [64, 100])
def test_fused_middle_words_cpu_matches_plain_and_pallas_interpret(k):
    an, dl, sc = _candidates(k + 1, (1, 2), k, exact_decode=True)
    hw = torch.tensor([[300.0, 380.0]])
    got = _two_stage_middle(an, dl, sc, hw, 0.0, 0.7)
    want = fused_middle_levels_plain(an, dl, sc, hw, 0.0, 0.7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref = jax_middle(jnp.asarray(an[0].numpy()), jnp.asarray(dl[0].numpy()),
                     jnp.asarray(sc[0].numpy()), 300.0, 380.0, min_size=0.0,
                     iou_threshold=0.7, interpret=True)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all()


def test_max_candidates_is_the_sweeps_cap():
    src = (CSRC / "nms_sweep.cuh").read_text()
    tile = int(re.search(r"constexpr int kTile = (\d+);", src).group(1))
    smem = eval(re.search(r"constexpr int kMaxSmem = ([\d *]+);", src).group(1))
    assert tile == TILE
    assert MAX_CANDIDATES == tile * (smem // (8 * (1 + 2 * tile))) == 14400
