"""Detection drawing, headless (port of ``mx_rcnn_tpu/evalutil/vis.py``,
the reference's ``vis_all_detection`` saved rather than shown).

It needs matplotlib, which a GPU host may lack: there
:func:`require_matplotlib` raises a ``RuntimeError`` that names it, and
the CLIs call it before any work that the drawing would follow.
"""

from __future__ import annotations

import numpy as np


def require_matplotlib():
    """``matplotlib.pyplot`` on the headless Agg backend; a
    ``RuntimeError`` naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("drawing detections needs matplotlib, which is not installed "
                           "on this host") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_detections(image: np.ndarray, boxes: np.ndarray, scores: np.ndarray,
                    classes: np.ndarray, class_names, out_path: str, threshold: float = 0.5,
                    masks=None) -> int:
    """Boxes (and instance masks) scoring at least ``threshold`` drawn over
    ``image`` into the PNG ``out_path``; returns how many were drawn."""
    plt = require_matplotlib()
    fig, ax = plt.subplots(1, figsize=(12, 12 * image.shape[0] / max(image.shape[1], 1)))
    ax.imshow(image.astype(np.uint8))
    ax.axis("off")
    cmap = plt.get_cmap("hsv")
    shown = 0
    for i, (box, score, cls) in enumerate(zip(boxes, scores, classes)):
        if score < threshold:
            continue
        color = cmap((int(cls) * 37 % 256) / 256.0)
        if masks is not None and i < len(masks) and masks[i] is not None:
            overlay = np.zeros((*masks[i].shape, 4), np.float32)
            overlay[masks[i]] = (*color[:3], 0.4)
            ax.imshow(overlay)
        x1, y1, x2, y2 = box
        ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False, edgecolor=color,
                                   linewidth=2))
        name = class_names[int(cls)] if class_names else str(int(cls))
        ax.text(x1, max(y1 - 3, 0), f"{name} {score:.2f}", fontsize=9, color="white",
                bbox=dict(facecolor=color, alpha=0.7, pad=1))
        shown += 1
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return shown
