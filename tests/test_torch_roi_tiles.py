"""B2's binning pass on the CPU: ``roi_tile_lists_plain`` against the
plain ROIAlign backward, by brute force.

For every roi alone (a cotangent of ones on that roi, zeros elsewhere)
the plain backward puts a nonzero gradient into some cells; the tile of
each such cell must list the roi.  The rois are random, degenerate
(zero-size, inverted), partly or wholly outside the map, and on tile and
level edges, at the levels the FPN assignment gives and at levels drawn
at random.  Every list is a bitset read in roi-index order, and a roi is
listed only at its own level.  On CPU tensors ``roi_tile_lists_cuda`` is
the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
    TILE,
    multilevel_roi_align_bwd_plain,
    roi_level_index,
    roi_tile_lists_cuda,
    roi_tile_lists_plain,
)

torch.set_num_threads(2)

LEVELS = (2, 3, 4, 5)
SHAPES = {l: (136 >> l, 168 >> l) for l in LEVELS}  # a 136x168 canvas


def _level_tiles():
    """(level index, tile row, tile column) of every global tile index."""
    out = []
    for i, l in enumerate(LEVELS):
        h, w = SHAPES[l]
        out += [(i, ty, tx) for ty in range(-(-h // TILE)) for tx in range(-(-w // TILE))]
    return out


def _rois(kind: str, rng) -> np.ndarray:
    n = 40
    xy = rng.uniform(-20, 180, (2, n, 2))
    wh = 2.0 ** rng.uniform(0, 7.5, (2, n, 2))
    rois = np.concatenate([xy, xy + wh], -1)
    if kind == "degenerate":
        rois[:, ::3, 2:] = rois[:, ::3, :2]                   # zero size
        rois[:, 1::3, 2:] = rois[:, 1::3, :2] - wh[:, 1::3]   # inverted
    elif kind == "outside":
        rois[:, ::2] += rng.choice([-400.0, 400.0], (2, n // 2, 1))
        rois[:, 1::4, :2] = -30.0                             # straddles the origin
        rois[:, 3::4, 2:] = [200.0, 160.0]                    # past the far edges
    elif kind == "edges":
        # Corners on multiples of a tile at every level's stride, and on
        # the map's last cells.
        step = rng.choice([4, 8, 16, 32], (2, n, 1)) * TILE
        rois = np.round(rois / step) * step + rng.choice([-0.5, 0.0, 0.25], (2, n, 4))
        rois[:, ::5, 2:] = [168.0, 136.0]
    return rois.astype(np.float32)


def _case(kind: str, assign: str, seed: int):
    rng = np.random.RandomState(seed)
    rois = torch.from_numpy(_rois(kind, rng))
    if assign == "fpn":
        level_idx = roi_level_index(rois, LEVELS)
    else:
        level_idx = torch.from_numpy(rng.randint(0, len(LEVELS), rois.shape[:2]).astype(np.int32))
    return rois, level_idx


def _member(lists: torch.Tensor, r: int) -> np.ndarray:
    """(B, T) bool: which tiles list roi r."""
    return ((lists[..., r // 32] >> (r % 32)) & 1).bool().numpy()


@pytest.mark.parametrize("assign", ["fpn", "random"])
@pytest.mark.parametrize("kind", ["random", "degenerate", "outside", "edges"])
def test_lists_cover_every_nonzero_gradient(kind, assign):
    rois, level_idx = _case(kind, assign, seed=len(kind) + len(assign))
    lists = roi_tile_lists_plain(SHAPES, rois, level_idx, 7, 2)
    tiles = _level_tiles()
    assert lists.shape == (2, len(tiles), 2) and lists.dtype == torch.int32
    # A global tile index for every cell of every level.
    cell_tile = {}
    start = 0
    for l in LEVELS:
        h, w = SHAPES[l]
        tx = -(-w // TILE)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        cell_tile[l] = start + (ys // TILE) * tx + xs // TILE
        start += -(-h // TILE) * tx
    covered = 0
    for r in range(rois.shape[1]):
        g = torch.zeros((2, rois.shape[1], 7, 7, 1))
        g[:, r] = 1.0
        grads = multilevel_roi_align_bwd_plain(SHAPES, torch.float32, rois, level_idx, g, 2)
        member = _member(lists, r)
        for l in LEVELS:
            for b in range(2):
                hot = grads[l][b, ..., 0].numpy() != 0.0
                need = np.unique(cell_tile[l][hot])
                assert member[b, need].all(), (kind, assign, r, b, l)
                covered += len(need)
    assert covered > 0


@pytest.mark.parametrize("kind", ["random", "outside", "edges"])
def test_lists_are_in_roi_order_at_the_rois_own_level(kind):
    rois, level_idx = _case(kind, "fpn", seed=7)
    lists = roi_tile_lists_plain(SHAPES, rois, level_idx, 7, 2)
    tile_level = np.array([i for i, _, _ in _level_tiles()])
    words = lists.numpy().view(np.uint32)
    for b in range(2):
        for t in range(words.shape[1]):
            order = [w * 32 + j for w in range(words.shape[2]) for j in range(32)
                     if (int(words[b, t, w]) >> j) & 1]
            assert order == sorted(order) and all(o < rois.shape[1] for o in order)
            assert all(int(level_idx[b, o]) == tile_level[t] for o in order)
    # Each roi is listed in a rectangle of tiles, at least one tile.
    for r in range(rois.shape[1]):
        member = _member(lists, r)
        assert member.any(axis=1).all()


def test_cuda_wrapper_on_cpu_is_the_plain_version():
    rois, level_idx = _case("random", "fpn", seed=3)
    assert torch.equal(roi_tile_lists_cuda(SHAPES, rois, level_idx),
                       roi_tile_lists_plain(SHAPES, rois, level_idx))
