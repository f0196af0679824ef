"""The alternate schedule (``cli/alternate_cli.py``) and the proposal
flags of the port's CLIs, on the CPU at ``tiny_synthetic``'s size with a
four-image roidb (the synthetic set's first images; ``build_dataset`` is
patched so that every split reads them).

  * ``alternate_train`` with ``num_phases=2`` (rpn1, a dump, rcnn1), in
    the default schedule and in ``external_proposals``: each phase's
    frozen groups are bitwise unchanged and every other weight moved; the
    step and the optimizer restart at 0; the pkl holds every train image;
    the final checkpoint passes its manifest check; every logged number is
    finite, and rcnn1's RPN metrics are exact zeros under external
    proposals; rcnn1 starts from rpn1's result, or from the initial
    weights under external proposals;
  * the ``vgg_fast_rcnn.sh`` pipe through ``eval_cli.main``: a val-split
    dump, then ``--from-proposals`` scores it; the flags' exclusions;
  * ``train_cli --proposals`` trains in Fast R-CNN mode;
  * every CLI's ``cli()`` returns 0 when ``main`` returns a dict (the JAX
    package's console-script contract, ``tests/test_cli.py``).
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.cli import alternate_cli, eval_cli, train_cli
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.data import datasets as TD
from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
from mx_rcnn_tpu_torch.train import checkpoint as C
from mx_rcnn_tpu_torch.train import loop
from mx_rcnn_tpu_torch.weights import init_variables

torch.set_num_threads(2)

OVERRIDES = ["train.log_every=1", "model.test.per_device_batch=4"]
N_IMAGES = 4


class _Roidb:
    def __init__(self, records):
        self.records = records

    def roidb(self):
        return list(self.records)


@pytest.fixture
def small_roidb(monkeypatch):
    """Every split of the synthetic set reads its first four images."""
    ds = SyntheticDataset(image_hw=(128, 128), num_classes=5)
    records = [ds.record(i) for i in range(N_IMAGES)]
    build = lambda *a, **k: _Roidb(records)  # noqa: E731
    monkeypatch.setattr(TD, "build_dataset", build)
    monkeypatch.setattr(loop, "build_dataset", build)
    return records


@pytest.fixture
def phases(monkeypatch):
    """Each ``build_all`` call's config name, start parameters and state."""
    seen = []
    real = loop.build_all

    def spy(cfg, *args, **kw):
        out = real(cfg, *args, **kw)
        seen.append((cfg.name, {n: p.detach().clone() for n, p in out[0].named_parameters()},
                     out[2]))
        return out

    monkeypatch.setattr(loop, "build_all", spy)
    return seen


def _log_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith('{"step"')]


@pytest.mark.parametrize("external", [False, True], ids=["in_graph", "external"])
def test_alternate_two_phases(external, small_roidb, phases, tmp_path, capsys):
    cfg = apply_overrides(get_config("tiny_synthetic"), OVERRIDES)
    state = alternate_cli.alternate_train(cfg, phase_steps=2, workdir=str(tmp_path),
                                          num_phases=2, external_proposals=external,
                                          device="cpu")
    lines = _log_lines(capsys.readouterr().out)
    assert [m["step"] for m in lines] == [1, 2, 1, 2]      # each phase restarts at 0
    assert all(np.isfinite(v) for m in lines for k, v in m.items() if v is not None)
    assert all(m["nonfinite"] == 0.0 for m in lines)
    assert lines[0]["lr"] == lines[2]["lr"]                  # the schedule restarted
    rcnn1 = lines[2:]
    if external:
        assert all(m[k] == 0.0 for m in rcnn1 for k in ("RPNAcc", "RPNLogLoss", "RPNL1Loss"))
    else:
        assert all(m["RPNLogLoss"] > 0 for m in rcnn1)

    # Two phases, then the combined state's build.
    assert [name for name, _, _ in phases] == ["tiny_synthetic_rpn1", "tiny_synthetic_rcnn1",
                                               "tiny_synthetic"]
    frozen_by_phase = {"tiny_synthetic_rpn1": "box_head.", "tiny_synthetic_rcnn1": "rpn_head."}
    for name, start, st in phases[:2]:
        assert st.step == 2 and st.optimizer.step == 2
        for n, p in st.model.named_parameters():
            frozen = n.startswith(frozen_by_phase[name])
            assert p.requires_grad != frozen, n
            if frozen:
                assert torch.equal(p.detach(), start[n]), n
            elif not n.endswith("bias"):
                assert not torch.equal(p.detach(), start[n]), n
    rpn1_end = {n: p.detach() for n, p in phases[0][2].model.named_parameters()}
    rcnn1_start = phases[1][1]
    if external:
        init = init_variables(cfg.model, torch.Generator().manual_seed(cfg.train.seed))
        assert all(torch.equal(rcnn1_start[n], init[n]) for n in rcnn1_start)
    else:
        assert all(torch.equal(rcnn1_start[n], rpn1_end[n]) for n in rcnn1_start)
    # The combined state: rcnn1's parameters under the base optimizer.
    assert state is phases[2][2] and state.step == 2 and state.optimizer.step == 0
    assert set(state.optimizer.names) == {n for n, _ in state.model.named_parameters()}
    assert all(torch.equal(p, dict(phases[1][2].model.named_parameters())[n])
               for n, p in state.model.named_parameters())

    with open(tmp_path / cfg.name / "proposals_rpn1.pkl", "rb") as f:
        props = pickle.load(f)
    assert sorted(props) == sorted(r.image_id for r in small_roidb)
    assert all(len(p["scores"]) == cfg.model.rpn.train_post_nms_top_n for p in props.values())
    ckpt = str(tmp_path / cfg.name / "ckpt")
    assert C.latest_step(ckpt) == 2 and C.verify_manifest(ckpt, 2)[0]
    restored = eval_cli._restored_state(cfg, ckpt, None, "cpu")      # what eval_cli reads
    assert all(torch.equal(p, dict(state.model.named_parameters())[n])
               for n, p in restored.model.named_parameters())


def test_fast_rcnn_pipe_through_the_clis(small_roidb, tmp_path, capsys):
    """``vgg_fast_rcnn.sh`` from a checkpoint: dump the val split's
    proposals, score them (the RPN out of the graph), and train Fast
    R-CNN on the pkl."""
    common = ["--config", "tiny_synthetic", "--device", "cpu",
              *sum((["--set", o] for o in OVERRIDES), [])]
    _, _, state, _, _ = loop.build_all(apply_overrides(get_config("tiny_synthetic"), OVERRIDES),
                                       "cpu")
    ckpt = ["--ckpt", str(tmp_path / "ckpt")]
    C.save_checkpoint(ckpt[1], C.state_payload(state))
    pkl = str(tmp_path / "val.pkl")
    props = eval_cli.main([*common, *ckpt, "--proposals", pkl, "--proposals-split", "val"])
    assert sorted(props) == sorted(r.image_id for r in small_roidb)
    test_n = get_config("tiny_synthetic").model.rpn.test_post_nms_top_n
    assert max(len(p["scores"]) for p in props.values()) <= test_n
    metrics = eval_cli.main([*common, *ckpt, "--from-proposals", pkl])
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    capsys.readouterr()
    out = train_cli.main([*common, "--steps", "1", "--workdir", str(tmp_path / "fast"),
                          "--no-eval", "--proposals", pkl, "--set", "model.rpn.loss_weight=0.0"])
    (line,) = _log_lines(capsys.readouterr().out)
    assert out["final_step"] == 1 and line["RPNLogLoss"] == 0.0 and line["RCNNLogLoss"] > 0
    for bad, msg in ((["--proposals", pkl, "--from-proposals", pkl], "exclusive"),
                     (["--proposals-split", "train"], "only applies")):
        with pytest.raises(SystemExit, match=msg):
            eval_cli.main([*common, *ckpt, *bad])
    with pytest.raises(ValueError, match="requires the proposal dumps"):
        alternate_cli.alternate_train(get_config("tiny_synthetic"), dump_proposals_pkl=False,
                                      external_proposals=True, device="cpu")


@pytest.mark.parametrize("module", [train_cli, eval_cli, alternate_cli],
                         ids=["train_cli", "eval_cli", "alternate_cli"])
def test_cli_wrapper_returns_zero(module, monkeypatch):
    seen = {}

    def fake_main(argv=None):
        seen["argv"] = argv
        return {"loss": 0.5, "mAP": 0.3}    # truthy, like the real mains

    monkeypatch.setattr(module, "main", fake_main)
    assert module.cli(["--whatever"]) == 0
    assert seen["argv"] == ["--whatever"]
