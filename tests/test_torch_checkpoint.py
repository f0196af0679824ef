"""The port's checkpoints: a bitwise round trip, the walk back past a
broken latest step, the JAX package's manifest check (``verify_manifest``,
which the deployer runs) on the port's files, and ``tree_crc`` equal to
the JAX package's on the same variables.

Most cases checkpoint a small model (one linear layer and a FrozenBN-like
buffer) so the files stay small; the trainer's own saves are checked on
``tiny_synthetic``.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.train.checkpoint import tree_crc as jax_tree_crc
from mx_rcnn_tpu.train.checkpoint import verify_manifest as jax_verify_manifest
from mx_rcnn_tpu_torch.config import ScheduleConfig, TrainConfig, apply_overrides, get_config
from mx_rcnn_tpu_torch.train import checkpoint as C
from mx_rcnn_tpu_torch.train.loop import build_all, checkpoint_dir, train
from mx_rcnn_tpu_torch.train.optim import SGDMomentum, make_schedule
from mx_rcnn_tpu_torch.train.state import TrainState
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables

torch.set_num_threads(2)


class Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 4)
        self.register_buffer("var", torch.ones(4))


def small_state(seed: int) -> TrainState:
    torch.manual_seed(seed)
    model = Small()
    sched = ScheduleConfig(base_lr=0.1, warmup_steps=0, decay_steps=(100,), total_steps=100,
                           reference_batch=0)
    opt = SGDMomentum(dict(model.named_parameters()), TrainConfig(schedule=sched),
                      make_schedule(sched))
    return TrainState(step=0, model=model, optimizer=opt, generator=torch.Generator())


def advance(state: TrainState, n: int) -> TrainState:
    for _ in range(n):
        grads = [torch.randn_like(p) for p in state.optimizer.params]
        state.optimizer.apply(grads)
        state.model.var.mul_(1.5)
        state.step += 1
    return state


def same_state(a: TrainState, b: TrainState) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.step == b.step and a.optimizer.step == b.optimizer.step
            and sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(a.optimizer.trace, b.optimizer.trace)))


def test_round_trip_is_bitwise(tmp_path):
    state = advance(small_state(0), 3)
    path = C.save_checkpoint(str(tmp_path), C.state_payload(state))
    assert path == str(tmp_path / "3") and sorted(os.listdir(tmp_path)) == ["3", "manifest-3.json"]
    assert C.all_steps(str(tmp_path)) == [3] and C.latest_step(str(tmp_path)) == 3
    restored = C.restore_checkpoint(str(tmp_path), small_state(1))
    assert same_state(restored, state)
    assert C.tree_crc(C.state_payload(restored)) == C.read_manifest(str(tmp_path), 3)["tree_crc"]
    # A step already on disk is left alone.
    before = (tmp_path / "3" / C.STATE_FILE).read_bytes()
    C.save_checkpoint(str(tmp_path), C.state_payload(advance(small_state(2), 3)))
    assert (tmp_path / "3" / C.STATE_FILE).read_bytes() == before


@pytest.mark.parametrize("damage", ["truncate", "flip_byte", "delete_file",
                                    "truncate_without_manifest"])
def test_restore_walks_back_past_a_broken_latest_step(tmp_path, damage):
    state = small_state(0)
    saved = {}
    for _ in range(2):
        advance(state, 2)
        C.save_checkpoint(str(tmp_path), C.state_payload(state))
        saved[state.step] = C.state_payload(state)
    latest = tmp_path / "4" / C.STATE_FILE
    data = latest.read_bytes()
    if damage == "truncate_without_manifest":
        # No manifest to catch it: the truncated file fails to load.
        (tmp_path / "manifest-4.json").unlink()
        latest.write_bytes(data[: len(data) // 2])
        assert C.verify_manifest(str(tmp_path), 4) == (False, "manifest_missing")
        assert C.restore_checkpoint(str(tmp_path), small_state(1)).step == 2
        return
    if damage == "truncate":
        latest.write_bytes(data[: len(data) // 2])
    elif damage == "flip_byte":
        latest.write_bytes(data[:100] + bytes([data[100] ^ 1]) + data[101:])
    else:
        latest.unlink()
    ok, why = C.verify_manifest(str(tmp_path), 4)
    assert not ok and why.startswith(("file_checksum_mismatch", "file_missing"))
    assert jax_verify_manifest(str(tmp_path), 4) == (ok, why)
    restored = C.restore_checkpoint(str(tmp_path), small_state(1))
    assert restored.step == 2
    assert C.tree_crc(C.state_payload(restored)) == C.tree_crc(saved[2])
    if damage != "delete_file":
        with pytest.raises(Exception):
            C.restore_checkpoint(str(tmp_path), small_state(1), step=4)


def test_restore_walks_back_past_a_step_that_fails_validate(tmp_path):
    state = small_state(0)
    advance(state, 1)
    C.save_checkpoint(str(tmp_path), C.state_payload(state))
    with torch.no_grad():
        state.model.fc.weight[0, 0] = float("nan")
    advance(state, 1)
    C.save_checkpoint(str(tmp_path), C.state_payload(state))
    assert C.read_manifest(str(tmp_path), 2)["valid"] is False
    assert jax_verify_manifest(str(tmp_path), 2) == (False, "invalid_at_save")
    restored = C.restore_checkpoint(str(tmp_path), small_state(1), validate=C.finite_state)
    assert restored.step == 1 and C.finite_state(C.state_payload(restored))
    with pytest.raises(RuntimeError, match="every checkpoint"):
        C.restore_checkpoint(str(tmp_path), small_state(1), validate=lambda p: False)
    with pytest.raises(FileNotFoundError):
        C.restore_checkpoint(str(tmp_path / "none"), small_state(1))


def test_jax_verify_manifest_accepts_the_port_manifest(tmp_path):
    state = advance(small_state(0), 5)
    C.save_checkpoint(str(tmp_path), C.state_payload(state))
    assert jax_verify_manifest(str(tmp_path), 5) == (True, "ok")
    assert C.verify_manifest(str(tmp_path), 5) == (True, "ok")
    manifest = json.loads((tmp_path / "manifest-5.json").read_text())
    assert set(manifest) == {"step", "tree_crc", "valid", "files"}
    assert manifest["files"][C.STATE_FILE]["bytes"] == (tmp_path / "5" / C.STATE_FILE).stat().st_size
    assert jax_verify_manifest(str(tmp_path), 6) == (False, "manifest_missing")


def test_tree_crc_matches_jax():
    cfg = get_config("tiny_synthetic").model
    sd = init_variables(cfg, torch.Generator().manual_seed(0))
    tree = to_jax_variables(sd)
    want = jax_tree_crc(jax.tree_util.tree_map(np.asarray, tree["params"]))
    assert C.tree_crc(tree["params"]) == want
    assert C.tree_crc(tree) == jax_tree_crc(tree)
    mixed = {"step": 3, "x": [np.arange(4, dtype=np.int32), torch.ones(2, 3)]}
    assert C.tree_crc(mixed) == jax_tree_crc({"step": 3, "x": [np.arange(4, dtype=np.int32),
                                                                np.ones((2, 3), np.float32)]})
    assert C.finite_state(mixed) and not C.finite_state({"a": torch.tensor([np.inf])})


def test_trainer_saves_every_k_steps_and_at_the_end(tmp_path):
    cfg = apply_overrides(get_config("tiny_synthetic"), ["train.checkpoint_every=2"])
    state = train(cfg, steps=3, device="cpu", log=lambda line: None, workdir=str(tmp_path))
    ckpt = checkpoint_dir(cfg, str(tmp_path))
    assert ckpt == f"{tmp_path}/tiny_synthetic/ckpt" and C.all_steps(ckpt) == [0, 2, 3]
    assert all(jax_verify_manifest(ckpt, s) == (True, "ok") for s in (0, 2, 3))
    _, _, fresh, _, _ = build_all(cfg, "cpu")
    restored = C.restore_checkpoint(ckpt, fresh)
    assert same_state(restored, state)
    # COCO is no longer refused: the trainer goes to read its annotations.
    with pytest.raises(FileNotFoundError, match="instances_train2017.json"):
        train(apply_overrides(cfg, ["data.dataset=coco", f"data.root={tmp_path}/coco"]),
              steps=1, device="cpu")
