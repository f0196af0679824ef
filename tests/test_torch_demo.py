"""The port's demo (``cli/demo_cli.py``) and drawing (``evalutil/vis.py``)
against the JAX package's, and their refusals where PIL or matplotlib is
missing (as on the card's machine).

Tolerances: ``draw_detections`` returns the same count and writes PNGs
whose decoded pixels are equal (the same matplotlib calls);
``detect_image`` on ``tiny_synthetic`` with the weights carried by the
bridge, on an image the letterbox does not resample, within the
inference tolerance of ``tests/test_torch_inference.py``: per image
``match_fraction`` (same class, IoU >= 0.9, score within 1e-3) >= 0.9;
the demo's served detections equal to ``detect_image``'s (one program,
batch 1, on the CPU).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mx_rcnn_tpu.cli.demo_cli import detect_image as jax_detect_image
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.evalutil.vis import draw_detections as jax_draw
from mx_rcnn_tpu_torch.cli import demo_cli, eval_cli
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction
from mx_rcnn_tpu_torch.evalutil.vis import draw_detections, require_matplotlib
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables

torch.set_num_threads(2)

CONFIG = "tiny_synthetic"


@pytest.fixture(scope="module")
def weights():
    sd = init_variables(get_config(CONFIG).model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:3] = 3.0   # detections above the threshold
    return sd


def _image(h=96, w=128, seed=0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[20:60, 30:90] = (200, 40, 40)
    return img


def _pixels(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_draw_detections_matches_jax(tmp_path):
    img = _image()
    boxes = np.array([[10, 12, 60, 50], [30, 20, 120, 90], [0, 0, 5, 5]], np.float32)
    scores = np.array([0.9, 0.6, 0.2], np.float32)
    classes = np.array([1, 3, 2], np.int32)
    mask = np.zeros((96, 128), bool)
    mask[20:40, 15:50] = True
    masks = [mask, None, mask]
    names = ("__background__", "a", "b", "c")
    for kw in ({}, {"masks": masks}):
        got = draw_detections(img, boxes, scores, classes, names, str(tmp_path / "t.png"), **kw)
        want = jax_draw(img, boxes, scores, classes, names, str(tmp_path / "j.png"), **kw)
        assert got == want == 2
        np.testing.assert_array_equal(_pixels(tmp_path / "t.png"), _pixels(tmp_path / "j.png"))


def test_detect_image_matches_jax(weights):
    # 96x128 in the 128x128 canvas: scale 1, so neither package resamples.
    img = _image()
    boxes, scores, classes, masks = demo_cli.detect_image(get_config(CONFIG), weights, img,
                                                          device="cpu")
    jb, js, jc, jm = jax_detect_image(jax_get_config(CONFIG), to_jax_variables(weights), img)
    assert masks is None and jm is None and len(js) > 10
    ref = {"boxes": np.asarray(jb), "scores": np.asarray(js), "classes": np.asarray(jc)}
    out = {"boxes": boxes, "scores": scores, "classes": classes}
    assert match_fraction(ref, out, min_iou=0.9, score_tol=1e-3) >= 0.9


def test_demo_serves_the_detect_image_detections(tmp_path, weights, monkeypatch):
    img = _image(80, 100, seed=1)
    path = tmp_path / "in.png"
    Image.fromarray(img).save(path)
    served = demo_cli.serve_image(get_config(CONFIG), weights, img, device="cpu")
    direct = demo_cli.detect_image(get_config(CONFIG), weights, img, device="cpu")
    for key, want in zip(("boxes", "scores", "classes"), direct[:3]):
        np.testing.assert_array_equal(served[key], want, err_msg=key)
    monkeypatch.setattr(demo_cli, "serve_image", lambda cfg, v, image, device=None: served)
    out = tmp_path / "out.png"
    boxes, scores, _, _ = demo_cli.main([str(path), "--config", CONFIG, "--random-params",
                                         "--device", "cpu", "--out", str(out),
                                         "--threshold", "0.0"])
    assert out.exists() and len(scores) == len(direct[1]) > 0
    np.testing.assert_array_equal(boxes, direct[0])


def test_load_demo_image_errors(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="not found"):
        demo_cli.load_demo_image(str(tmp_path / "none.png"))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"definitely not a png")
    with pytest.raises(SystemExit, match="not a decodable image"):
        demo_cli.load_demo_image(str(bad))
    with pytest.raises(SystemExit, match="could not read image"):
        demo_cli.load_demo_image(str(tmp_path))
    good = tmp_path / "good.png"
    Image.fromarray(_image()).save(good)
    np.testing.assert_array_equal(demo_cli.load_demo_image(str(good)), _image())
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="needs PIL"):
        demo_cli.load_demo_image(str(good))
    # The demo refuses before any model is built.
    monkeypatch.setattr(demo_cli, "serve_image", None)
    with pytest.raises(SystemExit, match="needs PIL"):
        demo_cli.main([str(good), "--config", CONFIG, "--random-params", "--device", "cpu"])


def test_refusals_without_matplotlib(tmp_path, monkeypatch):
    good = tmp_path / "good.png"
    Image.fromarray(_image()).save(good)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        require_matplotlib()
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        draw_detections(_image(), np.zeros((0, 4)), np.zeros(0), np.zeros(0), None,
                        str(tmp_path / "x.png"))
    monkeypatch.setattr(demo_cli, "serve_image", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        demo_cli.main([str(good), "--config", CONFIG, "--random-params", "--device", "cpu"])

    def no_batch(*a, **k):
        raise AssertionError("the eval loader was built despite --vis without matplotlib")

    monkeypatch.setattr(eval_cli, "_eval_loader", no_batch)
    monkeypatch.setattr(eval_cli, "_restored_state", no_batch)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        eval_cli.main(["--config", CONFIG, "--device", "cpu", "--vis", "2"])


def test_eval_vis_writes_the_first_images(tmp_path, weights):
    from mx_rcnn_tpu_torch.train.loop import build_all

    cfg = dataclasses.replace(get_config(CONFIG), workdir=str(tmp_path))
    _, _, state, _, _ = build_all(cfg, "cpu", weights)
    eval_cli.run_eval(cfg, state=state, limit=3, device="cpu", vis_count=2)
    written = sorted((tmp_path / CONFIG / "vis").iterdir())
    assert [p.name for p in written] == ["0.png", "1.png"]
    assert all(_pixels(p).shape[2] == 4 for p in written)
