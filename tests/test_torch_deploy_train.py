"""Trained candidates on the port's deployment path, on the CPU: a
checkpoint that ``train()`` writes fits the serving runner's signature
(keys, shapes, dtypes; ``r50_fpn_coco``'s trainer model against its
serving weights: FrozenBN constants, float32 masters, no buffer the
trainer adds), and one ``train()`` step's checkpoint of ``tiny_synthetic``
reaches the shadow engine and is ruled on for parity, never refused by the
shadow's swap.  The fleet is stopped in a ``finally``; every wait is
bounded (10 s).
"""

from __future__ import annotations

import torch

from mx_rcnn_tpu_torch import obs as TO
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.ctrl import deploy as TDep
from mx_rcnn_tpu_torch.serve import engine as TEng
from mx_rcnn_tpu_torch.serve import fleet as TF
from mx_rcnn_tpu_torch.train import checkpoint as TCk
from mx_rcnn_tpu_torch.weights import from_jax_variables, init_variables
from test_torch_deploy import ManualClock, Mirrored
from test_torch_fleet_slice import BUCKET, _trees

WAIT = 10.0


def test_train_checkpoint_fits_the_serving_signature():
    """What ``train()`` saves (``state_payload``: the trainer model's
    ``state_dict``) has the serving weights' keys, shapes and dtypes, so a
    trained candidate swaps where the served one does (``r50_fpn_coco``)."""
    from mx_rcnn_tpu_torch.train.loop import build_all

    cfg = get_config("r50_fpn_coco")
    served = init_variables(cfg.model, torch.Generator().manual_seed(0))
    _, _, state, _, _ = build_all(cfg, device="cpu", variables=served)
    payload = TCk.state_payload(state)
    assert TEng.DetectorRunner._sig(payload["model"]) == TEng.DetectorRunner._sig(served)


def test_a_trained_checkpoint_reaches_the_shadow(tmp_path):
    """One ``train()`` step from the served weights, checkpointed by the
    trainer: the shadow loads it (no ``shadow_swap_failed``) and the gate
    rules it out for parity, the live fleet untouched."""
    from mx_rcnn_tpu_torch.train.loop import checkpoint_dir, train

    cfg = apply_overrides(get_config("tiny_synthetic"), ["train.log_every=1"])
    served = from_jax_variables(_trees()[0])
    train(cfg, steps=1, device="cpu", variables=served, workdir=str(tmp_path),
          log=lambda line: None)
    ckpt = checkpoint_dir(cfg, str(tmp_path))
    assert TCk.all_steps(ckpt) == [0, 1]   # the start and the step
    fleet = TF.build_fleet(cfg, served, n_replicas=1, buckets=[BUCKET],
                           batch_size=1, device="cpu", supervisor_poll=0.05)
    try:
        fleet.start()
        clock = ManualClock()
        dep = TDep.Deployer(fleet, ckpt, clock=clock, mirror_rate=1.0, min_mirrored=3,
                            shadow_window_s=10.0, mirror_timeout_s=8.0)
        with Mirrored(fleet, dep, clock, 3):
            out = dep.offer(1)
    finally:
        fleet.stop(timeout=WAIT)
        TO.reset()
    assert out["outcome"] != "invalid", out
    assert (out["outcome"], out["reason"]) == ("rejected", "parity")
    assert out["verdict"].mismatched > 0 and fleet.generation == 0
