"""Detect one image and draw it (port of ``mx_rcnn_tpu/cli/demo_cli.py``,
the reference's ``demo.py``).

    python -m mx_rcnn_tpu_torch.cli.demo_cli photo.jpg --config r50_fpn_coco \\
        --ckpt runs/r50_fpn_coco/ckpt --out photo_det.png

Reads the image with PIL, serves it through the serving engine
(``serve.build_engine``: warmed programs, the watchdog, typed errors), logs
the detections above ``--threshold`` and draws them with matplotlib.
``--random-params`` skips the checkpoint: weights from ``train.seed``.
Without PIL, or without matplotlib, it exits with a message naming the
package before any model is built (the card's machine lacks matplotlib).
``--device`` defaults to the card (``--device cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from mx_rcnn_tpu_torch.cli.common import add_config_args, config_from_args, setup_logging
from mx_rcnn_tpu_torch.config import Config

log = logging.getLogger("mx_rcnn_tpu_torch")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(p)
    p.add_argument("image", help="input image path")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (default: <workdir>/<config name>/ckpt)")
    p.add_argument("--step", type=int, default=None, help="checkpoint step")
    p.add_argument("--out", default=None, help="output drawing (png; default <image>_det.png)")
    p.add_argument("--threshold", type=float, default=0.5, help="score cut-off for the drawing")
    p.add_argument("--random-params", action="store_true",
                   help="skip the checkpoint: random weights from train.seed")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def detect_image(cfg: Config, variables, image: np.ndarray, mask_threshold: float = 0.0,
                 device=None):
    """One RGB image through ``forward_inference`` at batch 1 -> (boxes,
    scores, classes, masks) in original image coordinates (the
    reference's ``im_detect`` and unscale).  The image is letterboxed and
    normalized as the serving runner does it, in float32 on the device.
    Masks are pasted only for detections scoring at least
    ``mask_threshold`` (the others get None)."""
    import torch

    from mx_rcnn_tpu_torch.data.batch import Batch
    from mx_rcnn_tpu_torch.data.transforms import letterbox, normalize_image
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.detection.graph import forward_inference
    from mx_rcnn_tpu_torch.evalutil.postprocess import unletterbox_detections
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = TwoStageDetector(cfg.model, device=dev)
    model.load_state_dict(variables)
    model.eval()
    h, w = image.shape[:2]
    x = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
    canvas, scale, (nh, nw) = letterbox(x, cfg.data.image_size, cfg.data.short_side,
                                        cfg.data.max_side)
    stats = (cfg.data.pixel_mean, cfg.data.pixel_std)
    batch = Batch(images=normalize_image(canvas, *stats)[None],
                  image_hw=torch.tensor([[nh, nw]], dtype=torch.float32, device=dev))
    with torch.inference_mode():
        dets = forward_inference(model, batch, stats)
    boxes, scores, classes, valid = (t[0].cpu().numpy() for t in dets[:4])
    masks = dets.masks[0].cpu().numpy() if dets.masks is not None else None
    d = unletterbox_detections(boxes, scores, classes, valid, scale, h, w, masks=masks,
                               mask_threshold=mask_threshold)
    return d["boxes"], d["scores"], d["classes"], d.get("masks")


def load_demo_image(path: str) -> np.ndarray:
    """One RGB uint8 image, or ``SystemExit`` with a one-line diagnosis: a
    missing path, PIL not installed, bytes PIL cannot decode."""
    if not os.path.exists(path):
        raise SystemExit(f"error: input image not found: {path}")
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        raise SystemExit(f"error: reading {path} needs PIL (Pillow), which is not "
                         "installed") from None
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except UnidentifiedImageError:
        raise SystemExit(f"error: {path} is not a decodable image (corrupt or unsupported "
                         "format)") from None
    except OSError as e:
        raise SystemExit(f"error: could not read image {path}: {e}") from None


def serve_image(cfg: Config, variables, image: np.ndarray, device=None) -> dict:
    """One (H, W, 3) image served through ``build_engine(cfg, variables)``
    (started, warmed, stopped after): the engine's result dict ("boxes",
    "scores", "classes", with a Mask R-CNN "masks", and "level",
    "latency_s")."""
    from mx_rcnn_tpu_torch.serve import ServeError, build_engine

    try:
        with build_engine(cfg, variables, device=device) as engine:
            return engine.infer(image)
    except ServeError as e:
        raise SystemExit(f"error: inference failed: {e}") from None


def main(argv=None):
    """Detect, log and draw; returns (boxes, scores, classes, masks)."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    cfg = config_from_args(args)
    image = load_demo_image(args.image)

    from mx_rcnn_tpu_torch.evalutil.vis import draw_detections, require_matplotlib

    try:
        require_matplotlib()
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None

    import torch

    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.random_params:
        from mx_rcnn_tpu_torch.weights import init_variables

        variables = init_variables(cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    else:
        from mx_rcnn_tpu_torch.cli.eval_cli import _restored_state
        from mx_rcnn_tpu_torch.parallel.step import eval_variables

        variables = eval_variables(_restored_state(cfg, args.ckpt, args.step, dev))
    result = serve_image(cfg, variables, image, device=dev)
    log.info("served at level %r in %.3fs", result["level"], result["latency_s"])
    boxes, scores, classes = result["boxes"], result["scores"], result["classes"]
    masks = result.get("masks")
    class_names = None
    if cfg.data.dataset == "voc":
        from mx_rcnn_tpu_torch.data.datasets import VOC_CLASSES

        class_names = ("__background__",) + VOC_CLASSES
    for box, score, cls in zip(boxes, scores, classes):
        if score >= args.threshold:
            name = class_names[int(cls)] if class_names else str(int(cls))
            log.info("%s %.3f [%.1f %.1f %.1f %.1f]", name, score, *box)
    out = args.out or (args.image.rsplit(".", 1)[0] + "_det.png")
    n = draw_detections(image, boxes, scores, classes, class_names, out, args.threshold,
                        masks=masks)
    log.info("drew %d detections -> %s", n, out)
    return boxes, scores, classes, masks


def cli(argv=None) -> int:
    """The process entry point: 0 when done."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
