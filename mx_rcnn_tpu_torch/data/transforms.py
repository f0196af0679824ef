"""Image transforms for serving (port of ``mx_rcnn_tpu/data/transforms.py``).

The JAX package resizes on the host with cv2 ``INTER_LINEAR`` (PIL
``BILINEAR`` as a fallback).  A GPU host need have neither, so the port
resizes with ``torch.nn.functional.interpolate(mode="bilinear",
align_corners=False, antialias=False)`` on the tensor's own device: the
same half-pixel-centre bilinear rule as cv2 on float images.  Against cv2
on float32 0-255 images it agrees within 5e-3 (cv2 rounds its weights
its own way; ``tests/test_torch_inference.py``).  PIL filters downscales
with a wider support, so PIL differs there by design.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def oriented_canvas(canvas_hw: tuple[int, int], h: int, w: int) -> tuple[int, int]:
    """The static canvas for an image of true size (h, w): ``canvas_hw``
    is the landscape canvas (h <= w), and portrait images use its
    transpose.  Square canvases are orientation-free."""
    ch, cw = canvas_hw
    if h > w and ch != cw:
        return cw, ch
    return ch, cw


def resize_scale(h: int, w: int, short_side: int, max_side: int) -> float:
    """Short side -> ``short_side`` unless the long side passes ``max_side``."""
    scale = short_side / min(h, w)
    if round(scale * max(h, w)) > max_side:
        scale = max_side / max(h, w)
    return scale


def resize_linear(image: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bilinear resize of an (H, W, C) float image to (nh, nw, C)."""
    x = image.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                      antialias=False)
    return y[0].permute(1, 2, 0)


def letterbox(image: torch.Tensor, canvas_hw: tuple[int, int], short_side: int,
              max_side: int) -> tuple[torch.Tensor, float, tuple[int, int]]:
    """Resize by the scale rule and paste top-left into a zero canvas.
    image (H, W, 3) -> (canvas (ch, cw, 3) float32, scale, (nh, nw))."""
    h, w = image.shape[:2]
    ch, cw = canvas_hw
    scale = min(resize_scale(h, w, short_side, max_side), ch / h, cw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    canvas = torch.zeros((ch, cw, 3), dtype=torch.float32, device=image.device)
    canvas[:nh, :nw] = resize_linear(image, nh, nw)
    return canvas, scale, (nh, nw)


def normalize_image(image: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std channelwise, float32."""
    m = torch.tensor(mean, dtype=torch.float32, device=image.device)
    s = torch.tensor(std, dtype=torch.float32, device=image.device)
    return (image - m) / s
