"""The port's native host library (``mx_rcnn_tpu_torch/native``) against
the JAX package's library and against the port's numpy versions
(``tests/test_native.py`` for the JAX package).

Tolerance: none.  Both libraries are the same source built with the same
flags (no ``-march=native``, no fast-math), and the numpy versions do
the same float32 operations in the same order, so every entry point
bound in ``native/lib.py`` is held bitwise: keep lists, RLE counts (and
their uint32 dtype), IoU matrices (compared as int64 bit patterns) and
letterboxed canvases.
"""

from __future__ import annotations

import numpy as np
import pytest

from mx_rcnn_tpu.native import lib as JL
from mx_rcnn_tpu_torch.evalutil import masks
from mx_rcnn_tpu_torch.native import build
from mx_rcnn_tpu_torch.native import lib as TL


@pytest.fixture
def numpy_only(monkeypatch):
    """The library made unloadable, as on a host without g++: the build
    raises, the failure is cached, every entry point takes numpy."""
    def no_compiler(verbose=True):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(TL, "_LIB", None)
    monkeypatch.setattr(build, "build", no_compiler)
    assert not TL.available()


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint8)


def test_builds_into_the_build_dir():
    assert TL.available() and JL.available()
    path = build.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "mx_rcnn_tpu_torch"
    assert build.SRC.parts[-3:] == ("native", "src", "native.cc")
    assert build.FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")


def _boxes(rng, n):
    ctr = rng.rand(n, 2) * 100
    wh = rng.rand(n, 2) * 30 + 1
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpu_nms_bitwise(seed):
    rng = np.random.RandomState(seed)
    boxes, scores = _boxes(rng, 300), rng.rand(300).astype(np.float32)
    scores[::7] = scores[0]                       # ties, broken by the stable sort
    calls = TL.cpu_nms.calls
    got = TL.cpu_nms(boxes, scores, 0.5)
    assert TL.cpu_nms.calls == calls + 1
    order = np.argsort(-scores, kind="mergesort").astype(np.int32)
    np.testing.assert_array_equal(got, JL.cpu_nms(boxes, scores, 0.5))
    np.testing.assert_array_equal(got, TL._py_nms(boxes, order, 0.5))
    assert 0 < len(got) < 300 and got.dtype == np.int32


def _mask_cases(rng):
    first = np.zeros((9, 7), bool)
    first[0, 0] = True
    return {"empty": np.zeros((6, 5), bool), "all_ones": np.ones((6, 5), bool),
            "first_pixel": first, "zero_size": np.zeros((0, 4), bool),
            "random": rng.rand(43, 31) > 0.5, "sparse": rng.rand(80, 60) > 0.97}


def test_rle_encode_bitwise(monkeypatch):
    cases = _mask_cases(np.random.RandomState(0))
    native = {k: TL.rle_encode_native(m) for k, m in cases.items()}
    jax = {k: JL.rle_encode_native(m) for k, m in cases.items()}
    monkeypatch.setattr(TL, "_LIB", False)         # masks.rle_encode's numpy code
    plain = {k: masks.rle_encode(m) for k, m in cases.items()}
    for k in cases:
        for other in (jax[k], plain[k]):
            assert native[k]["size"] == other["size"], k
            assert native[k]["counts"].dtype == other["counts"].dtype == np.uint32, k
            np.testing.assert_array_equal(native[k]["counts"], other["counts"], err_msg=k)
        np.testing.assert_array_equal(masks.rle_decode(plain[k]), cases[k])
    assert native["all_ones"]["counts"].tolist() == [0, 30]
    assert native["first_pixel"]["counts"].tolist() == [0, 1, 62]
    assert native["empty"]["counts"].tolist() == [30]


def test_rle_iou_bitwise(monkeypatch):
    rng = np.random.RandomState(1)
    ms = [rng.rand(40, 28) > t for t in (0.3, 0.55, 0.8, 0.95)]
    ms += [np.zeros((40, 28), bool), np.ones((40, 28), bool)]
    rles = [TL.rle_encode_native(m) for m in ms]
    native = TL.rle_iou_native(rles[:3], rles)
    jax = JL.rle_iou_native(rles[:3], rles)
    assert TL.rle_iou_native([], rles).shape == (0, len(rles))
    monkeypatch.setattr(TL, "_LIB", False)
    plain = masks.rle_iou(rles[:3], rles)
    assert native.dtype == plain.dtype == np.float64
    np.testing.assert_array_equal(_bits(native), _bits(jax))
    np.testing.assert_array_equal(_bits(native), _bits(plain))
    for i in range(3):
        for j in range(len(ms)):
            union = float((ms[i] | ms[j]).sum())
            assert native[i, j] == (float((ms[i] & ms[j]).sum()) / union if union else 0.0)


@pytest.mark.parametrize("src_hw, canvas, nh, nw", [
    ((97, 143), (128, 128), 87, 128),     # downscale into a padded canvas
    ((40, 60), (96, 128), 85, 128),       # upscale
    ((64, 64), (64, 64), 64, 64),         # identity
    ((30, 50), (32, 64), 30, 50),         # no resize, padded
], ids=["down", "up", "identity", "pad"])
def test_letterbox_normalize_bitwise(src_hw, canvas, nh, nw):
    rng = np.random.RandomState(2)
    img = (rng.rand(*src_hw, 3) * 255).astype(np.uint8)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    scale = nh / src_hw[0]
    calls = TL.letterbox_normalize.calls
    got = TL.letterbox_normalize(img, canvas, nh, nw, scale, mean, std)
    assert TL.letterbox_normalize.calls == calls + 1 and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(JL.letterbox_normalize(
        img, canvas, nh, nw, scale, mean, std)))
    np.testing.assert_array_equal(_bits(got), _bits(TL._py_letterbox_normalize(
        img, canvas, nh, nw, mean, std)))
    pad = (-np.asarray(mean, np.float32)) * (np.float32(1) / np.asarray(std, np.float32))
    assert (got[nh:] == pad).all() and (got[:, nw:] == pad).all()
    assert TL.letterbox_normalize(img.astype(np.float32), canvas, nh, nw, scale, mean,
                                  std) is None


def test_masks_take_the_library_when_built():
    rng = np.random.RandomState(3)
    m = rng.rand(20, 30) > 0.5
    enc, iou = TL.rle_encode_native.calls, TL.rle_iou_native.calls
    rle = masks.rle_encode(m)
    masks.rle_iou([rle], [rle])
    assert TL.rle_encode_native.calls == enc + 1 and TL.rle_iou_native.calls == iou + 1


def test_numpy_path_when_the_library_cannot_load(numpy_only):
    rng = np.random.RandomState(4)
    m = rng.rand(20, 30) > 0.5
    counts = (TL.rle_encode_native.calls, TL.rle_iou_native.calls, TL.cpu_nms.calls,
              TL.letterbox_normalize.calls)
    rle = masks.rle_encode(m)
    iou = masks.rle_iou([rle], [rle])
    boxes, scores = _boxes(rng, 50), rng.rand(50).astype(np.float32)
    keep = TL.cpu_nms(boxes, scores, 0.5)
    img = (rng.rand(20, 30, 3) * 255).astype(np.uint8)
    canvas = TL.letterbox_normalize(img, (32, 32), 21, 32, 32 / 30, (1.0, 2.0, 3.0),
                                    (4.0, 5.0, 6.0))
    assert (TL.rle_encode_native.calls, TL.rle_iou_native.calls, TL.cpu_nms.calls,
            TL.letterbox_normalize.calls) == counts
    assert TL.rle_encode_native(m) is None and TL.rle_iou_native([rle], [rle]) is None
    assert rle["counts"].dtype == np.uint32 and iou[0, 0] == 1.0
    np.testing.assert_array_equal(keep, JL.cpu_nms(boxes, scores, 0.5))
    np.testing.assert_array_equal(_bits(canvas), _bits(JL.letterbox_normalize(
        img, (32, 32), 21, 32, 32 / 30, (1.0, 2.0, 3.0), (4.0, 5.0, 6.0))))
