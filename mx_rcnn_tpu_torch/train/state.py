"""Training state (port of ``mx_rcnn_tpu/train/state.py``).

One object holds what a step reads and writes: the step count, the model
(float32 master parameters and the norm buffers: FrozenBN's four,
``bn``'s running mean and var), the optimizer (its
momentum buffers and update count) and the generator the step's random
draws come from.  The step updates it in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.train.optim import SGDMomentum


@dataclass
class TrainState:
    step: int
    model: TwoStageDetector
    optimizer: SGDMomentum
    generator: torch.Generator


def step_seed(seed: int, step: int) -> int:
    """The generator seed of ``step`` under ``train.seed``: a given step
    always draws the same."""
    return (seed << 32) + step
