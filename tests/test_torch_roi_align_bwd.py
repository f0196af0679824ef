"""ROIAlign backward: the plain version of kernel B2 and the autograd
``Function`` around B1/B2, on the CPU.

* The plain backward against the Pallas backward kernel in interpret mode
  (``multilevel_roi_align_bwd_pallas``), P2-P5 of a 256x192 canvas, C = 128:
  float32 within atol 1e-5 (f32 sums in another order); bfloat16 within
  atol 3e-2 + rtol 2.5e-2, the JAX package's own bound for that kernel,
  whose bf16 path truncates the interpolation weights to bf16.
* The plain backward against autograd of the plain forward: float32 within
  atol 1e-5; in bfloat16 it is its own float32 result cast once, bitwise.
* The ``Function`` (forward B1, backward B2; on CPU tensors both are their
  plain versions) against autograd of the plain forward within atol 1e-5,
  with a zero roi gradient; ``roi_align_bwd_impl="xla"`` equals that
  autograd bitwise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.pallas.roi_align import multilevel_roi_align_bwd_pallas
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.detection.graph import _pool_rois_impl
from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
    multilevel_roi_align_bwd_cuda,
    multilevel_roi_align_bwd_plain,
    multilevel_roi_align_fast,
    multilevel_roi_align_plain,
    roi_level_index,
)

torch.set_num_threads(2)

LEVELS = (2, 3, 4, 5)


def _rois(rng, n, canvas=256):
    ctr = rng.rand(n, 2) * canvas
    size = 2.0 ** rng.uniform(1, np.log2(canvas * 0.9), size=(n, 2))
    x1 = ctr[:, 0] - size[:, 0] / 2
    y1 = ctr[:, 1] - size[:, 1] / 2
    return np.stack([x1, y1, x1 + size[:, 0], y1 + size[:, 1]], 1).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    c = 128
    pyr = {l: rng.rand(2, 256 >> l, 192 >> l, c).astype(np.float32) for l in LEVELS}
    rois = np.stack([_rois(rng, 40), _rois(rng, 40)])
    rois[:, :3] = [[-5, -5, 20, 30], [250, 180, 270, 200], [0, 0, 255, 191]]
    g = rng.rand(2, 40, 7, 7, c).astype(np.float32)
    return pyr, rois, g


def _shapes(pyr):
    return {l: tuple(f.shape[1:3]) for l, f in pyr.items()}


def _autograd_plain(pyr, rois, g):
    p = {l: torch.tensor(f).requires_grad_() for l, f in pyr.items()}
    multilevel_roi_align_plain(p, torch.tensor(rois)).backward(torch.tensor(g))
    return {l: f.grad for l, f in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_interpret(case, dtype):
    pyr, rois, g = case
    tdt = getattr(torch, dtype)
    jp = {l: jnp.asarray(f).astype(dtype) for l, f in pyr.items()}
    want = multilevel_roi_align_bwd_pallas(jp, jnp.asarray(rois), jnp.asarray(g).astype(dtype),
                                           interpret=True)
    tr = torch.tensor(rois)
    got = multilevel_roi_align_bwd_plain(_shapes(pyr), tdt, tr, roi_level_index(tr, LEVELS),
                                         torch.tensor(g).to(tdt))
    for l in LEVELS:
        assert got[l].dtype == tdt and got[l].shape == pyr[l].shape
        w = np.asarray(want[l].astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got[l].numpy(), w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got[l].float().numpy(), w, rtol=2.5e-2, atol=3e-2)
    assert float(got[2].float().abs().max()) > 1.0


def test_plain_bwd_is_the_transpose_of_the_plain_forward(case):
    pyr, rois, g = case
    want = _autograd_plain(pyr, rois, g)
    tr = torch.tensor(rois)
    li = roi_level_index(tr, LEVELS)
    got = multilevel_roi_align_bwd_plain(_shapes(pyr), torch.float32, tr, li, torch.tensor(g))
    for l in LEVELS:
        np.testing.assert_allclose(got[l].numpy(), want[l].numpy(), rtol=0, atol=1e-5)
    # bf16: the f32 accumulation cast once.
    gb = torch.tensor(g).bfloat16()
    f32 = multilevel_roi_align_bwd_plain(_shapes(pyr), torch.float32, tr, li, gb.float())
    bf = multilevel_roi_align_bwd_plain(_shapes(pyr), torch.bfloat16, tr, li, gb)
    for l in LEVELS:
        assert torch.equal(bf[l], f32[l].bfloat16())
    # The CUDA wrapper on CPU tensors is the plain version.
    via = multilevel_roi_align_bwd_cuda(_shapes(pyr), torch.float32, tr, li, torch.tensor(g))
    for l in LEVELS:
        assert torch.equal(via[l], got[l])


@pytest.mark.parametrize("bwd_impl", ["pallas", "xla"])
def test_function_against_autograd_of_plain_forward(case, bwd_impl):
    pyr, rois, g = case
    want = _autograd_plain(pyr, rois, g)
    p = {l: torch.tensor(f).requires_grad_() for l, f in pyr.items()}
    tr = torch.tensor(rois).requires_grad_()
    out = multilevel_roi_align_fast(p, tr, 7, 2, bwd_impl)
    assert torch.equal(out.detach(), multilevel_roi_align_plain(
        {l: torch.tensor(f) for l, f in pyr.items()}, torch.tensor(rois)))
    out.backward(torch.tensor(g))
    assert torch.equal(tr.grad, torch.zeros_like(tr))
    for l in LEVELS:
        if bwd_impl == "xla":
            assert torch.equal(p[l].grad, want[l])
        else:
            np.testing.assert_allclose(p[l].grad.numpy(), want[l].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("over", [[], ["model.rcnn.roi_align_bwd_impl=xla"],
                                  ["model.rcnn.roi_align_impl=xla"]])
def test_pool_rois_routes_the_backward(case, over):
    """_pool_rois_impl: every route gives the plain forward's values and
    gradients; a bad backward name is refused."""
    pyr, rois, g = case
    cfg = apply_overrides(get_config("tiny_synthetic"), over).model
    p = {l: torch.tensor(f).requires_grad_() for l, f in pyr.items()}
    out = _pool_rois_impl(cfg, p, torch.tensor(rois), 7, LEVELS)
    out.backward(torch.tensor(g))
    want = _autograd_plain(pyr, rois, g)
    for l in LEVELS:
        np.testing.assert_allclose(p[l].grad.numpy(), want[l].numpy(), rtol=0, atol=1e-5)
    bad = apply_overrides(get_config("tiny_synthetic"), ["model.rcnn.roi_align_bwd_impl=tpu"])
    with pytest.raises(ValueError):
        _pool_rois_impl(bad.model, p, torch.tensor(rois), 7, LEVELS)


def test_fast_under_inference_mode_is_the_forward_alone(case):
    """With grad mode off (serving) the pooled rois are B1's (here its
    plain version) and carry no autograd node."""
    pyr, rois, _ = case
    p = {l: torch.tensor(f) for l, f in pyr.items()}
    with torch.inference_mode():
        out = multilevel_roi_align_fast(p, torch.tensor(rois), 7, 2, "pallas")
    assert out.grad_fn is None
    assert torch.equal(out, multilevel_roi_align_plain(p, torch.tensor(rois)))
