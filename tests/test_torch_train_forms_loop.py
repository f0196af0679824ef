"""The single-card training forms through the port's loop against the
JAX package: the loader's same-canvas runs (``run_length``) against the
JAX loader's schedule, and ``train/loop.py::train`` and
``cli/train_cli.py`` under ``accum_steps``, ``steps_per_call``, remat
and the ``bn``/``gn``/``none`` norms, on the CPU at ``tiny_synthetic``'s
size.  The module-level forms (norms, remat, the weight bridge, the
accumulated step itself) are in ``test_torch_train_forms.py``.

Every check here is exact: the loader's run schedule equals JAX's index
for index and flip for flip; ``steps_per_call=2`` ends bitwise where
``steps_per_call=1`` ends on the same batches; a run resumed from its
step-2 checkpoint ends bitwise where the uninterrupted run ends, having
skipped ``2 x accum_steps`` loader batches; a ``bn`` checkpoint's tree
CRC covers its running statistics; the CLI's metrics are finite.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.cli import train_cli
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.data.loader import DetectionLoader
from mx_rcnn_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    state_payload,
    tree_crc,
)
from mx_rcnn_tpu_torch.train.loop import build_all, train
from mx_rcnn_tpu_torch.weights import init_variables

from test_torch_loader_train import SIZES, WIDE, _loaders, _records, _spec_list

torch.set_num_threads(2)


@pytest.fixture
def work(tmp_path):
    """``tmp_path``, emptied after the test: a checkpoint of these
    full-width ResNet-50 models holds over 200 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tiny(*overrides):
    return apply_overrides(get_config("tiny_synthetic"), list(overrides))


@pytest.mark.parametrize("run_length", [2, 3])
@pytest.mark.parametrize("canvas", [(96, 96), WIDE], ids=["square", "wide"])
def test_loader_run_schedule_matches_jax(run_length, canvas):
    ours, theirs = _records(SIZES)
    port, ref = _loaders(ours, theirs, canvas, 2, seed=3)
    port.run_length = ref.run_length = run_length
    want = list(ref._batch_index_specs(epochs=3))
    got = list(port._batch_index_specs(epochs=3))
    assert _spec_list(iter(got), len(got)) == _spec_list(iter(want), len(want))
    if canvas == WIDE:
        for r in range(0, len(got) // run_length * run_length, run_length):
            kinds = {ours[j].aspect >= 1 for idx, _ in got[r:r + run_length] for j in idx}
            assert len(kinds) == 1, r
    else:
        port.run_length = 1
        assert _spec_list(port._batch_index_specs(epochs=3), len(got)) == \
            _spec_list(iter(got), len(got))


def _assembled(monkeypatch):
    """The ``(indices, flips)`` of each batch the loader assembles (its
    host half, ``_assemble_rows``)."""
    seen = []
    original = DetectionLoader._assemble_rows

    def spy(self, spec):
        seen.append((list(spec[0]), list(spec[1])))
        return original(self, spec)

    monkeypatch.setattr(DetectionLoader, "_assemble_rows", spy)
    return seen


def test_steps_per_call_2_is_bitwise_steps_per_call_1(monkeypatch):
    seen = _assembled(monkeypatch)
    ends, schedules = [], []
    for k in (1, 2):
        lines = []
        # host_depth=0: the synchronous path, where the assembled batches
        # are the consumed ones (a read-ahead assembles more).
        state = train(_tiny(f"train.steps_per_call={k}", "train.log_every=2"), steps=4,
                      device="cpu", log=lines.append, host_depth=0)
        assert state.step == 4 and state.optimizer.step == 4
        # A call's first drain is at its end: step k.
        assert [json.loads(x)["step"] for x in lines] == ([1, 2, 4] if k == 1 else [2, 4])
        ends.append(state.model.state_dict())
        schedules.append(list(seen))
        seen.clear()
    assert schedules[0] == schedules[1] and len(schedules[0]) == 4
    assert all(torch.equal(ends[0][n], ends[1][n]) for n in ends[0])
    with pytest.raises(ValueError, match="not divisible"):
        train(_tiny("train.steps_per_call=2"), steps=3, device="cpu", log=lambda s: None)


@pytest.mark.parametrize("overrides", [["train.accum_steps=2"], ["model.backbone.norm=bn"]],
                         ids=["accum", "bn"])
def test_resume_ends_bitwise_an_uninterrupted_run(overrides, monkeypatch, work):
    """Resumed from its step-2 checkpoint, a run skips ``2 x accum_steps``
    loader batches and ends bitwise where the uninterrupted run ends; the
    checkpoint's tree CRC covers ``bn``'s buffers."""
    cfg = _tiny(*overrides, "train.checkpoint_every=2", "train.log_every=2")
    accum = cfg.train.accum_steps
    skips = []
    original = DetectionLoader.iter_from

    def spy(self, skip_batches=0):
        skips.append(skip_batches)
        return original(self, skip_batches)

    monkeypatch.setattr(DetectionLoader, "iter_from", spy)
    quiet = dict(device="cpu", log=lambda s: None)
    whole = train(cfg, steps=4, **quiet)
    train(cfg, steps=2, workdir=str(work / "b"), **quiet)
    resumed = train(cfg, steps=4, workdir=str(work / "b"), resume=True, **quiet)
    assert skips == [0, 0, 2 * accum]
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tree_crc(state_payload(whole)) == tree_crc(state_payload(resumed))
    if "model.backbone.norm=bn" in overrides:
        # bn's statistics are saved, restored and never trained.
        payload = state_payload(resumed)
        assert "backbone.bn1.mean" in payload["model"]
        _, _, fresh, _, _ = build_all(cfg, device="cpu")
        for n, buf in fresh.model.named_buffers():
            buf.fill_(7.0)
        restore_checkpoint(str(work / "b" / cfg.name / "ckpt"), fresh)
        assert all(torch.equal(buf, b[n]) for n, buf in fresh.model.named_buffers())
        assert torch.equal(b["backbone.bn1.var"], torch.ones(64))


def test_checkpoint_crc_covers_bn_buffers(work):
    cfg = _tiny("model.backbone.norm=bn")
    _, _, state, _, _ = build_all(cfg, device="cpu")
    before = tree_crc(state_payload(state))
    save_checkpoint(str(work), state_payload(state))
    with torch.no_grad():
        state.model.backbone.bn1.mean.add_(1.0)
    assert tree_crc(state_payload(state)) != before
    restore_checkpoint(str(work), state)
    assert tree_crc(state_payload(state)) == before


@pytest.mark.parametrize("overrides", [
    ["model.backbone.norm=gn"], ["model.backbone.norm=bn"], ["model.backbone.norm=none"],
    ["model.backbone.remat=true"], ["train.accum_steps=2"], ["train.steps_per_call=2"],
], ids=["gn", "bn", "none", "remat", "accum", "steps_per_call"])
def test_train_cli_takes_each_form(overrides, work, capsys):
    args = ["--config", "tiny_synthetic", "--steps", "2", "--device", "cpu", "--no-eval",
            "--workdir", str(work), "--set", "train.log_every=1",
            "--set", "model.backbone.freeze_stages=2"]
    for o in overrides:
        args += ["--set", o]
    assert train_cli.main(args) == {"final_step": 2}
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines and all(np.isfinite(m["loss"]) and m["nonfinite"] == 0.0 for m in lines)
    assert lines[-1]["step"] == 2


def test_train_moves_norm_parameters_outside_frozen_stages():
    """Three steps under ``gn``: the norm scales and biases outside the
    frozen stages move, those inside stay bitwise."""
    cfg = _tiny("model.backbone.norm=gn", "model.backbone.freeze_stages=2",
                "train.log_every=3")
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    state = train(cfg, steps=3, device="cpu", variables=sd, log=lambda s: None)
    after = dict(state.model.named_parameters())
    frozen = [n for n in after if n.startswith(("backbone.bn1", "backbone.layer1_"))
              and n.endswith((".scale", ".bias"))]
    live = [n for n in after if n.startswith("backbone.layer3_") and n.endswith(".scale")]
    assert frozen and live
    assert all(torch.equal(after[n].detach(), sd[n]) for n in frozen)
    assert all(not torch.equal(after[n].detach(), sd[n]) for n in live)
