#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mx_rcnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # on a machine with the card
    python3 chip_smoke.py --cpu-rehearsal # anywhere: tiny shapes, plain ops
    python3 chip_smoke.py --parent DIR    # also hold B1-B4 against DIR's

Phases (any failure exits non-zero, and the ``ok`` line is printed only
when every phase passed):

1. No card -> exit 2.  Print the card's name and power limit.
2. Build the kernels from ``mx_rcnn_tpu_torch/csrc`` (one nvcc per source,
   all started together) and print the seconds and the ptxas summary.
3. Hold each kernel against its plain torch version on the card at the
   serving shapes of ``r50_fpn_coco`` (800x1344 canvas, batch 2): B1
   ROIAlign in bf16 (within 1 bf16 ulp) and f32 (atol 1e-5), two launches
   bitwise equal; B3 fused middle
   bitwise at the serving top-k and at k = 2000 (the train pre-NMS
   top-n); B4 NMS bitwise at the stacked shape the ``proposals``
   path launches (batch 1, 5 levels, n = 1000), at PR 2's one-level shape
   (P2, batch 2) and at n = 2000 (the train pre-NMS top-n); and at its
   train shapes (512 rois per image sampled as the train step samples
   them): B2 ROIAlign backward in bf16 (within 1 bf16 ulp of the plain
   float32 sum, plus the f32 tolerance) and f32 (within 1e-5 of the
   largest gradient of |g|), two launches bitwise equal.  Time all with
   CUDA events after a warm-up (``ms``, the wrapper's host work
   included), and the kernels alone (``kernel_ms``): the C entry points
   a wrapper call reaches, called again with the wrapper's own arguments
   between CUDA events.  B3 and B4 are also timed alone at 2000
   candidates, and the time a sweep chunk adds is read from the two
   sizes; the larger must take longer.
4. Serve ``r50_fpn_coco`` at full width with random weights from a seed:
   an engine with ``serve.fused_middle=on`` and batch 2 (the ``full``
   program: B1 + B3), and one with ``rpn.nms_impl=pallas`` (the
   ``proposals`` program: B4, one launch a request).  Each path runs with
   the launch counts set to 0 just before it and read just after; every
   kernel of a path must have launched.  Every response must be finite
   with boxes inside its image, and the full path must return detections.
5. Train ``r50_fpn_coco`` at full width (``model.rpn.loss_impl=compact``,
   the mixed bf16 policy, batch 2, the synthetic set's uint8 images on
   the 800x1344 canvas in the loader's schedule, random weights from the
   seed) for 5 steps through ``train/loop.py::train`` with
   ``train.log_every=1``: every loss finite and ``nonfinite`` 0, every
   trainable parameter moved, frozen parameters and FrozenBN buffers
   bitwise unchanged, B1 and B2 launched in every step.  Seconds a step
   after the first (batch assembly included, and its ``data_stall_ms``)
   and peak memory are printed.  The last step's B2 inputs are kept for
   phase 7b.
6. Save the trained state with ``train/checkpoint.py``, verify its
   manifest, restore it into a fresh state (tree CRC equal), and evaluate
   ``r50_fpn_coco`` at full width on the synthetic set (64 images, batch
   8) through ``cli/eval_cli.py::run_eval`` with ``test.nms_mode=fused``
   and with ``per_class``, launch counts set to 0 before each run and read
   after (B1 must launch).  Metrics finite; each run's dump, loaded and
   rescored, gives its dict; the first batch in float32 through the
   kernels and through the plain path gives identical detections.  Eval
   img/s (end to end, and over the batches after the first), the metrics,
   a traced batch and each postprocess's time a call at three candidate
   densities are printed.
7. Train on a roidb, preempt, resume, evaluate (:func:`roidb_phase`):
   ``r50_fpn_coco`` at full width from a torchvision-layout ResNet-50
   file written from the seed, on 16 landscape (480x640) and 8 portrait
   (640x480) uint8 records, one with an inverted box and one whose file
   does not exist, flips on.  Run A takes 8 steps; run B is preempted by
   a real SIGTERM at its step-2 drain (emergency checkpoint at 2) and
   resumed to 8; both under deterministic algorithms, B's final state
   equal to A's.  The import, the schedule (indices, flips, both
   orientations), the quarantine journal, B1 and B2 in every step,
   ``metrics.jsonl``, checkpoint steps and tree CRC are checked; then
   ``run_eval`` on 16 synthetic images.  Img/s, ``data_stall_ms``, the
   emergency save's and the restore's seconds, eval img/s and peak memory
   are printed.
7b. B2 held against its plain version and timed on the inputs of phase
   5's last step, of a portrait step of phase 7 and on crowded rois
   (every roi of an image inside one 8x8-cell tile of P2), as in phase 3;
   B1 likewise on those two steps' rois (the train shape; the portrait
   one over a random pyramid of the portrait canvas) and on edge rois
   (outside, degenerate, at the level borders, on the last cells).  B1's
   launches count ``full``, ``train``, ``eval`` and ``roidb``, B2's
   ``train`` and ``roidb``.
7c. The single-level C4 family (:func:`c4_phase`), ``vgg16_voc07`` and
   ``r101_coco`` at full width, random weights from the seed:
   (a) serve: an engine with ``serve.fused_middle=on`` at batch 2 (the
   ``full`` program: B1 on one level, B3 at L = 1, k = 6000) and one with
   ``rpn.nms_impl=pallas`` (the ``proposals`` program: B4 on one level,
   n = 6000), counts set to 0 before each path and read after, every
   kernel launched, responses finite and inside their images, the full
   path returning detections (classes 1-4 favoured), latency printed;
   one ``r101_fpn_coco`` request rides with the full path.  (b) 3 train
   steps through ``train/loop.py::train`` on the synthetic set at the
   preset's canvas and batch (608x1024 batch 1; 800x1344 batch 2),
   compact RPN loss, mixed policy, as phase 5 checks them (``layer4`` of
   r101_coco is trained by weight decay alone and must move too).  (c)
   ``run_eval`` on 16 synthetic images, ``nms_mode=fused``: metrics
   finite, B1 launched, the first batch identical through the kernels and
   the plain path in float32; img/s printed.  (d) B1 on one level at
   C = 1024 and 512 (bf16 within one ulp, f32 bitwise) on (a)'s rois, B2
   on (b)'s last step, B3 and B4 at 6000 candidates (bitwise), each timed
   as in phase 3: the ``kernels`` line's ``@c4`` entries.  Phase c4's
   launches count in B1-B4's entries as well.  The rehearsal cuts the
   canvas to 192x256 and the proposals to hundreds.
8. A small input (``tiny_synthetic``, float32, TF32 off): the kernel
   path and the plain torch path on the card must return identical
   detections, the CPU's shown beside them; and one train step through
   the kernels (B1 forward, B2 backward) and through the plain path
   (``roi_align_impl=xla``) gives the same loss and metrics within 1e-6
   relative (B1 is bitwise in f32) and gradients within the CPU parity
   tests' tolerances (backbone 5e-3 by norm, the rest 1e-5 of the largest
   value): B2 and autograd's scatter sum in different orders.
9. With ``--parent DIR``: import DIR's kernel wrappers (``ops/cuda``, its
   own package beside this one) and build its four kernel sources, then
   require this tree's kernels to give the same bits as DIR's wrappers on
   phase 3's and phase 7b's inputs (B1 bf16 and f32 on serving, train-step,
   portrait-step and edge rois; B3 at the serving shape and k = 2000; B2
   on its five cases; B4 on its three shapes), and time each in turns
   (parent, this, this, parent).
10. Print the card's line, the ``kernels`` line and, last,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12          # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12        # H100 SXM HBM3, bytes/s
IOU_FLOPS = 16            # min/max/sub/mul/add/div/snap/compare of one IoU test


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Clock:
    """Times a callable: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def ms(self, fn, iters: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def kernel_ms(self, fn, build=None) -> float:
        """Device time of one call of the kernel wrapper ``fn`` in its
        kernels alone, without the wrapper's host work: every C entry point
        the call reaches is called again with the wrapper's own arguments
        between CUDA events (``utils/profiling.py::entry_ms``).  ``build``
        is the ``ops/cuda/_build`` module of the tree whose wrapper ``fn``
        calls, this tree's when None; its cache of loaded entry points is
        the set the call may reach.  NaN on the CPU."""
        if not self.cuda:
            return float("nan")
        from mx_rcnn_tpu_torch.ops.cuda import _build
        from mx_rcnn_tpu_torch.utils.profiling import entry_ms

        fn()
        return entry_ms(fn, (build or _build)._ENTRIES.values())


def chunk_step_us(name: str, small: dict, large: dict) -> float:
    """The time a sweep chunk adds, in us, read from the kernel-alone times
    of a problem of ``small["k"]`` and of ``large["k"]`` candidates: the
    larger adds ceil(k/64) chunk steps, but also 4x the word tiles, so it
    is an upper estimate.  Raises when the larger problem is not slower,
    since then there is no step to read."""
    more = -(-large["k"] // 64) - -(-small["k"] // 64)
    if not large["kernel_ms"] > small["kernel_ms"]:
        if np.isnan(small["kernel_ms"]):  # the CPU rehearsal times no kernel
            return float("nan")
        raise AssertionError(
            f"{name} alone: k = {large['k']} took {large['kernel_ms']:.4f} ms, not more than "
            f"k = {small['k']}'s {small['kernel_ms']:.4f} ms")
    return 1e3 * (large["kernel_ms"] - small["kernel_ms"]) / more


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_RATE * 1e3, flops / F32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def greedy_pairs(keep: torch.Tensor, valid: torch.Tensor) -> int:
    """IoU tests the greedy chain needs on this data: each kept box
    against every later valid box (keep, valid (..., N) in NMS order)."""
    later_valid = valid.flip(-1).long().cumsum(-1).flip(-1) - valid.long()
    return int((later_valid * keep.long()).sum())


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def kernel_phase(dev: torch.device, rehearsal: bool, seed: int) -> dict:
    """Phase 3: each kernel against its plain version at serving shapes."""
    from mx_rcnn_tpu_torch.config import get_config
    from mx_rcnn_tpu_torch.detection.graph import level_anchors
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels, fused_middle_levels_plain
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_keep_sorted_cuda, nms_keep_sorted_plain
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_cuda,
        multilevel_roi_align_plain,
    )
    from mx_rcnn_tpu_torch.ops.proposals import (
        _pre_nms_candidates,
        _stack_padded,
        _topk_candidates,
        generate_fpn_proposals,
    )

    cfg = get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco")
    rpn = cfg.model.rpn
    b, (h, w) = 2, cfg.data.image_size
    c = 32 if rehearsal else cfg.model.fpn.channels
    g = torch.Generator().manual_seed(seed)
    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    out = {}

    # Real anchor grids and RPN-like outputs: near-zero logits squashed to
    # bf16 (the "mixed" policy's scores, full of ties) and small deltas.
    feats = {l: torch.empty((b, h >> l, w >> l, 1), device=dev) for l in range(2, 7)}
    anchors = level_anchors(cfg.model, feats)
    scores = {l: torch.sigmoid(0.5 * torch.randn((b, a.shape[0]), generator=g))
              .to(torch.bfloat16).to(dev) for l, a in anchors.items()}
    deltas = {l: (0.2 * torch.randn((b, a.shape[0], 4), generator=g))
              .to(torch.bfloat16).to(dev) for l, a in anchors.items()}
    image_hw = torch.tensor([[h, w], [h - 176, w - 320]], dtype=torch.float32, device=dev)

    # B3: the fused middle over stacked per-level top-k candidates, at the
    # serving top-k and at the train pre-NMS top-k (k = 2000).
    def middle_args(top_n):
        cand = [_topk_candidates(scores[l], deltas[l], anchors[l], top_n)
                for l in sorted(anchors)]
        return (_stack_padded([a for _, _, a in cand], 0.0).float(),
                _stack_padded([d for _, d, _ in cand], 0.0).float(),
                _stack_padded([s for s, _, _ in cand], -torch.inf).float(),
                image_hw, rpn.min_size, rpn.nms_threshold)

    middle = {"serving": middle_args(rpn.test_pre_nms_top_n),
              "k2000": middle_args(rpn.train_pre_nms_top_n)}
    res = {}
    for key, args in middle.items():
        got, want = fused_middle_levels(*args), fused_middle_levels_plain(*args)
        valid = torch.isfinite(got[1])
        res[key] = dict(
            same=all(torch.equal(x, y) for x, y in zip(got, want)),
            err=float((got[0] - want[0]).abs().max()),
            ms=clock.ms(lambda: fused_middle_levels(*args), iters),
            kernel_ms=clock.kernel_ms(lambda: fused_middle_levels(*args)),
            flops=40 * args[2].numel() + IOU_FLOPS * greedy_pairs(got[2], valid),
            bytes=nbytes(*args[:4], *got), k=args[2].shape[-1])
    sv, k2 = res["serving"], res["k2000"]
    # The sweep's sequential floor is ceil(k/64) chunk steps.
    chunk_us = chunk_step_us("fused middle", sv, k2)
    an_k = middle["serving"][0]
    out["fused_middle"] = dict(
        match=sv["same"] and k2["same"], max_abs_err=max(sv["err"], k2["err"]),
        ms=sv["ms"], kernel_ms=sv["kernel_ms"],
        plain_ms=clock.ms(lambda: fused_middle_levels_plain(*middle["serving"]), plain_iters),
        bound=bound(sv["bytes"], sv["flops"]),
        extra=dict(ms_k2000=k2["ms"], kernel_ms_k2000=k2["kernel_ms"],
                   bound_ms_k2000=bound(k2["bytes"], k2["flops"])[0], chunk_step_us=chunk_us,
                   sequential_floor_ms=1e-3 * chunk_us * -(-sv["k"] // 64)),
        inputs=middle,
        shape=f"B={b} L={an_k.shape[1]} k={an_k.shape[2]} (two launches a call)",
    )
    log(f"[kernel:fused_middle] k={k2['k']}: match={k2['same']} ms={k2['ms']:.4f} "
        f"kernel_ms={k2['kernel_ms']:.4f}; a chunk step <= {chunk_us:.3f} us")
    # The rois B1 pools: these inputs' proposals, as the full path makes them.
    rois = generate_fpn_proposals(
        scores, deltas, anchors, image_hw, rpn.test_pre_nms_top_n,
        rpn.test_post_nms_top_n, rpn.nms_threshold, rpn.min_size, fused_middle=True,
    ).rois.contiguous()

    # B4: the NMS kernel over the score-sorted dense candidates of every
    # (image, level): the proposals path stacks them into one launch (its
    # batch is 1); PR 2's one-level shape (P2, batch 2) is kept beside it.
    def sorted_candidates(pre_nms_top_n):
        dense = [_pre_nms_candidates(scores[l], deltas[l], anchors[l], image_hw,
                                     pre_nms_top_n, rpn.min_size)
                 for l in sorted(anchors)]
        boxes = _stack_padded([x for x, _ in dense], 0.0)
        msc = _stack_padded([s for _, s in dense], -torch.inf)
        order = torch.argsort(-msc, dim=-1, stable=True)
        return (torch.gather(boxes, 2, order[..., None].expand(*order.shape, 4)).contiguous(),
                torch.gather(torch.isfinite(msc), 2, order).contiguous())

    thresh = rpn.nms_threshold
    sboxes, svalid = sorted_candidates(rpn.test_pre_nms_top_n)
    tboxes, tvalid = sorted_candidates(rpn.train_pre_nms_top_n)
    nms_shapes = {
        "stacked": (sboxes[:1].contiguous(), svalid[:1].contiguous(), thresh),
        "one_level": (sboxes[:, 0].contiguous(), svalid[:, 0].contiguous(), thresh),
        "n2000": (tboxes[:1].contiguous(), tvalid[:1].contiguous(), thresh),
    }
    nms = {}
    for key, a in nms_shapes.items():
        k1, k2 = nms_keep_sorted_cuda(*a), nms_keep_sorted_plain(*a)
        nms[key] = dict(
            mismatched=int((k1 != k2).sum()), keep=k1, k=a[0].shape[-2],
            ms=clock.ms(lambda: nms_keep_sorted_cuda(*a), iters),
            bound=bound(nbytes(a[0], a[1], k1), IOU_FLOPS * greedy_pairs(k1, a[1])),
        )
    mismatched = sum(v["mismatched"] for v in nms.values())
    stacked = nms_shapes["stacked"]
    # The sweep's sequential floor is ceil(n/64) chunk steps.
    for key, a in nms_shapes.items():
        nms[key]["kernel_ms"] = clock.kernel_ms(lambda: nms_keep_sorted_cuda(*a))
    chunk_us = chunk_step_us("nms", nms["stacked"], nms["n2000"])
    out["nms"] = dict(
        match=mismatched == 0, max_abs_err=float(mismatched > 0),
        ms=nms["stacked"]["ms"], kernel_ms=nms["stacked"]["kernel_ms"],
        plain_ms=clock.ms(lambda: nms_keep_sorted_plain(*stacked), plain_iters),
        bound=nms["stacked"]["bound"],
        extra=dict(ms_one_level=nms["one_level"]["ms"],
                   kernel_ms_one_level=nms["one_level"]["kernel_ms"],
                   bound_ms_one_level=nms["one_level"]["bound"][0],
                   ms_n2000=nms["n2000"]["ms"], kernel_ms_n2000=nms["n2000"]["kernel_ms"],
                   chunk_step_us=chunk_us,
                   sequential_floor_ms=1e-3 * chunk_us * -(-nms["stacked"]["k"] // 64)),
        inputs=nms_shapes,
        shape=f"B=1 L={sboxes.shape[1]} n={sboxes.shape[2]} (stacked, one launch)",
    )
    log(f"[kernel:nms] one level B={b} n={sboxes.shape[2]}: {nms['one_level']['ms']:.4f} ms; "
        f"stacked n={tboxes.shape[2]}: {nms['n2000']['ms']:.4f} ms; mismatched "
        f"{ {k: v['mismatched'] for k, v in nms.items()} }; a chunk step <= {chunk_us:.3f} us")

    # B1: ROIAlign over a P2-P5 pyramid, bf16 (the serving dtype) and f32.
    s, sr = cfg.model.rcnn.pooled_size, cfg.model.rcnn.sampling_ratio
    for dt, name in ((torch.bfloat16, "roi_align"), (torch.float32, "roi_align_f32")):
        pyr = {l: torch.randn((b, h >> l, w >> l, c), generator=g).to(dt).to(dev)
               for l in range(2, 6)}
        res = hold_fwd(pyr, rois, s, sr, clock, iters, plain_iters)
        out[name] = dict(**res, inputs={"serving": (pyr, rois, s, sr)})
    return out


def fwd_within_tolerance(got: torch.Tensor, want: torch.Tensor) -> bool:
    """B1's tolerance against its plain version: one bf16 ulp in bf16,
    1e-5 in f32."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return bool((diff <= bf16_ulp(want.float())).all())
    return bool((diff <= 1e-5).all())


def hold_fwd(pyr, rois, s: int, sr: int, clock, iters: int, plain_iters: int) -> dict:
    """B1 on these inputs against its plain version (within tolerance) and
    two launches bitwise equal; timed, the kernel alone too."""
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_cuda,
        multilevel_roi_align_plain,
    )

    got = multilevel_roi_align_cuda(pyr, rois, s, sr)
    again = multilevel_roi_align_cuda(pyr, rois, s, sr)
    want = multilevel_roi_align_plain(pyr, rois, s, sr)
    deterministic = torch.equal(got, again)
    flops = got.numel() * (sr * sr * 14 + 1)
    return dict(
        match=fwd_within_tolerance(got, want) and deterministic, deterministic=deterministic,
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=clock.ms(lambda: multilevel_roi_align_cuda(pyr, rois, s, sr), iters),
        kernel_ms=clock.kernel_ms(lambda: multilevel_roi_align_cuda(pyr, rois, s, sr)),
        plain_ms=clock.ms(lambda: multilevel_roi_align_plain(pyr, rois, s, sr), plain_iters),
        bound=bound(nbytes(*pyr.values(), rois, got), flops),
        shape=f"B={rois.shape[0]} R={rois.shape[1]} C={got.shape[-1]} "
              f"{str(got.dtype).split('.')[-1]}",
    )


def edge_rois(b: int, r: int, h: int, w: int, seed: int) -> torch.Tensor:
    """(b, r, 4) rois on an h x w canvas at B1's edges, a quarter of each
    kind: wholly or partly outside the image; degenerate (zero, inverted,
    under one cell); sized at the FPN level thresholds (112, 224, 448 px
    and the 38-cell extent bound) so that they straddle level borders;
    and on the map's last cells."""
    rng = np.random.RandomState(seed)
    q = r // 4
    xy = rng.uniform(0, [w, h], (b, r, 2))
    wh = rng.uniform(1, 300, (b, r, 2))
    out = np.concatenate([xy, xy + wh], -1)
    shift = rng.choice([-1.0, 1.0], (b, q, 1)) * rng.uniform(50, 2 * max(h, w), (b, q, 1))
    out[:, :q] += shift                                              # outside
    d = out[:, q:2 * q]
    d[:, 0::3, 2:] = d[:, 0::3, :2]                                  # zero size
    d[:, 1::3, 2:] = d[:, 1::3, :2] - rng.uniform(1, 20, (b, d[:, 1::3].shape[1], 2))
    d[:, 2::3, 2:] = d[:, 2::3, :2] + rng.uniform(0, 3, (b, d[:, 2::3].shape[1], 2))
    side = rng.choice([112.0, 224.0, 448.0, 38.0 * 16, 38.0 * 32], (b, q, 1))
    side = side * rng.uniform(0.98, 1.02, (b, q, 2))
    ctr = rng.uniform(0, [w, h], (b, q, 2))
    out[:, 2 * q:3 * q] = np.concatenate([ctr - side / 2, ctr + side / 2], -1)  # straddle
    far = np.array([w, h], np.float64)
    out[:, 3 * q:, 2:] = far + rng.uniform(-2, 2, (b, r - 3 * q, 2))  # last cells
    return torch.tensor(out, dtype=torch.float32)


def synthetic_batch(cfg, dev, seed: int):
    """A batch-2 uint8 train batch of the synthetic set on ``cfg``'s canvas."""
    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
    from mx_rcnn_tpu_torch.data.loader import assemble

    ds = SyntheticDataset(image_hw=tuple(cfg.data.image_size),
                          num_classes=cfg.model.num_classes, seed=seed)
    return assemble([ds.record(0), ds.record(1)], cfg.data, dev)


def backward_phase(dev, rehearsal: bool, seed: int) -> dict:
    """Phase 3, B2: the ROIAlign backward against its plain version at the
    train shapes, on rois sampled as the train step samples them."""
    from mx_rcnn_tpu_torch.config import get_config
    from mx_rcnn_tpu_torch.detection.graph import _slice_levels, level_anchors
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import roi_level_index
    from mx_rcnn_tpu_torch.ops.proposals import generate_fpn_proposals
    from mx_rcnn_tpu_torch.ops.sampling import sample_rois

    cfg = get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco")
    rpn, rc = cfg.model.rpn, cfg.model.rcnn
    (h, w), c = cfg.data.image_size, (32 if rehearsal else cfg.model.fpn.channels)
    g = torch.Generator().manual_seed(seed + 2)
    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    batch = synthetic_batch(cfg, dev, seed)
    b = batch.images.shape[0]
    feats = {l: torch.empty((b, h >> l, w >> l, 1), device=dev) for l in range(2, 7)}
    anchors = level_anchors(cfg.model, feats)
    levels = sorted(anchors)
    n_anchors = sum(a.shape[0] for a in anchors.values())
    scores = torch.sigmoid(0.5 * torch.randn((b, n_anchors), generator=g)).to(dev)
    deltas = (0.2 * torch.randn((b, n_anchors, 4), generator=g)).to(dev)
    props = generate_fpn_proposals(
        *_slice_levels(levels, anchors, scores, deltas), batch.image_hw,
        rpn.train_pre_nms_top_n, rpn.train_post_nms_top_n, rpn.nms_threshold, rpn.min_size)
    n = props.rois.shape[1] + batch.gt_boxes.shape[1]
    fg_draw, bg_draw = torch.rand((2, b, n), generator=g).to(dev)
    rois = sample_rois(props.rois, props.valid, batch.gt_boxes, batch.gt_classes, batch.gt_valid,
                       fg_draw, bg_draw, batch_size=rc.roi_batch_size,
                       fg_fraction=rc.fg_fraction).rois.contiguous()
    level_idx = roi_level_index(rois, (2, 3, 4, 5))
    shapes = {l: (h >> l, w >> l) for l in (2, 3, 4, 5)}
    s, sr = rc.pooled_size, rc.sampling_ratio
    cot = torch.randn((b, rois.shape[1], s, s, c), generator=g).to(dev)
    out = {}
    for dt, name in ((torch.bfloat16, "roi_align_bwd"), (torch.float32, "roi_align_bwd_f32")):
        args = (shapes, dt, rois, level_idx, cot.to(dt), sr)
        out[name] = hold_bwd(args, clock, iters, plain_iters)
        out[name]["inputs"] = args
    return out


def hold_bwd(args, clock, iters: int, plain_iters: int) -> dict:
    """B2 on ``args`` against its plain version: within 1e-5 of the largest
    gradient of |g| (plus one bf16 ulp of the plain float32 sum in bf16),
    two launches bitwise equal; timed."""
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_bwd_plain,
    )

    shapes, dt, rois, level_idx, gd, sr = args
    got = multilevel_roi_align_bwd_cuda(*args)
    again = multilevel_roi_align_bwd_cuda(*args)
    ref = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, level_idx, gd.float(), sr)
    scale = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, level_idx,
                                           gd.float().abs(), sr)
    same, deterministic, err = True, True, 0.0
    for l in shapes:
        diff = (got[l].float() - ref[l]).abs()
        tol = 1e-5 * float(scale[l].max().clamp(min=1.0))
        if dt == torch.bfloat16:
            tol = bf16_ulp(ref[l]) + tol
        same &= bool((diff <= tol).all())
        deterministic &= torch.equal(got[l], again[l])
        err = max(err, float(diff.max()))
    b, r, s, _, c = gd.shape
    taps = b * r * s * s * sr * sr * 4
    return dict(
        match=same and deterministic, deterministic=deterministic, max_abs_err=err,
        ms=clock.ms(lambda: multilevel_roi_align_bwd_cuda(*args), iters),
        kernel_ms=clock.kernel_ms(lambda: multilevel_roi_align_bwd_cuda(*args)),
        plain_ms=clock.ms(lambda: multilevel_roi_align_bwd_plain(*args), plain_iters),
        bound=bound(nbytes(gd, rois, level_idx, *got.values()), 3 * taps * c),
        shape=f"B={b} R={r} C={c} {str(dt).split('.')[-1]}",
    )


def crowded_rois(b: int, r: int, seed: int) -> torch.Tensor:
    """(b, r, 4) rois all inside the 8x8-cell tile (1, 1) of P2 (image
    pixels 32..64): every roi of an image lands on one tile."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(34.0, 44.0, (b, r, 2))
    wh = rng.uniform(2.0, 14.0, (b, r, 2))
    return torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32)


def backward_cases_phase(dev, rehearsal: bool, seed: int, steps: dict, kernels: dict) -> None:
    """Phase 7b: B2 on the rois and cotangent of real train steps (their
    backward's inputs, captured in the train phases: ``steps`` maps a
    case name to them, the landscape step of phase 5 and a portrait step
    of phase 7) and on crowded rois, each held against its plain version
    and timed."""
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import roi_level_index

    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    shapes, dt, rois, _, gd, sr = steps["step"]
    crowd = crowded_rois(rois.shape[0], rois.shape[1], seed).to(dev)
    g = torch.Generator().manual_seed(seed + 5)
    cases = {
        **steps,
        "crowded": (shapes, dt, crowd, roi_level_index(crowd, sorted(shapes)),
                    torch.randn(gd.shape, generator=g).to(dt).to(dev), sr),
    }
    k = kernels["roi_align_bwd"]
    for name, args in cases.items():
        res = hold_bwd(args, clock, iters, plain_iters)
        h2, w2 = args[0][2]
        log(f"[kernel:roi_align_bwd:{name}] {res['shape']} P2 {h2}x{w2}: match={res['match']} "
            f"max_abs_err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
            f"kernel_ms={res['kernel_ms']:.4f} "
            f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound'][0]:.4f}")
        k["match"] = k["match"] and res["match"]
        k.setdefault("extra", {}).update({f"ms_{name}": res["ms"],
                                          f"kernel_ms_{name}": res["kernel_ms"],
                                          f"plain_ms_{name}": res["plain_ms"],
                                          f"bound_ms_{name}": res["bound"][0],
                                          f"max_abs_err_{name}": res["max_abs_err"]})
        k.setdefault("cases", {})[name] = args


def forward_cases_phase(dev, rehearsal: bool, seed: int, steps: dict, kernels: dict) -> None:
    """Phase 7b: B1 on the rois of real train steps (captured in the train
    phases, 512 rois an image: ``steps`` as in
    :func:`backward_cases_phase`) and on edge rois, in bf16 and f32, each
    held against its plain version, two launches bitwise equal, and
    timed.  The landscape cases pool phase 3's pyramids; a portrait step
    pools a random pyramid of its own (transposed) level shapes."""
    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    g = torch.Generator().manual_seed(seed + 9)
    for name in ("roi_align", "roi_align_f32"):
        k = kernels[name]
        pyr, _, s, sr = k["inputs"]["serving"]
        for case, args in steps.items():
            shapes, rois = args[0], args[2]
            case_pyr = pyr
            if any(pyr[l].shape[1:3] != shapes[l] for l in pyr):
                case_pyr = {l: torch.randn((rois.shape[0], *shapes[l], pyr[l].shape[-1]),
                                           generator=g).to(pyr[l].dtype).to(dev) for l in pyr}
            k["inputs"][case] = (case_pyr, rois, s, sr)
        b, r = steps["step"][2].shape[:2]
        h, w = (x << 2 for x in pyr[2].shape[1:3])
        k["inputs"]["edge"] = (pyr, edge_rois(b, r, h, w, seed + 7).to(dev), s, sr)
        for case in (*steps, "edge"):
            res = hold_fwd(*k["inputs"][case], clock, iters, plain_iters)
            h2, w2 = k["inputs"][case][0][2].shape[1:3]
            log(f"[kernel:{name}:{case}] {res['shape']} P2 {h2}x{w2}: match={res['match']} "
                f"max_abs_err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
                f"kernel_ms={res['kernel_ms']:.4f} plain_ms={res['plain_ms']:.4f} "
                f"bound_ms={res['bound'][0]:.4f}")
            k["match"] = k["match"] and res["match"]
            k.setdefault("extra", {}).update({
                f"ms_{case}": res["ms"], f"kernel_ms_{case}": res["kernel_ms"],
                f"plain_ms_{case}": res["plain_ms"], f"bound_ms_{case}": res["bound"][0],
                f"max_abs_err_{case}": res["max_abs_err"]})


def check_response(res: dict, height: int, width: int) -> None:
    boxes, scores = res["boxes"], res["scores"]
    if boxes.ndim != 2 or boxes.shape[1] != 4 or len(scores) != len(boxes):
        raise AssertionError(f"malformed response: boxes {boxes.shape}, scores {scores.shape}")
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
        raise AssertionError("non-finite boxes or scores")
    if len(boxes) and (
        boxes.min() < 0 or boxes[:, 0::2].max() > width - 1 or boxes[:, 1::2].max() > height - 1
        or (boxes[:, 2] < boxes[:, 0]).any() or (boxes[:, 3] < boxes[:, 1]).any()
    ):
        raise AssertionError(f"boxes outside the {height}x{width} image")


def serve_path(name, engine, images, counters, timeout) -> dict:
    """Drive one engine over ``images`` with every launch count set to 0
    just before and read just after; returns the path's numbers."""
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(img) for img in images]
    results = [r.result(timeout) for r in reqs]
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for img, res in zip(images, results):
        check_response(res, *img.shape[:2])
    lat = [1e3 * (r.served_at - r.submitted_at) for r in reqs]
    counts = [len(r["scores"]) for r in results]
    log(f"[serve:{name}] {len(images)} requests in {wall:.3f} s = {len(images) / wall:.2f} img/s; "
        f"latency ms per request {[round(x, 1) for x in lat]}; outputs per request {counts}; "
        f"launches {launches}")
    return {"launches": launches, "counts": counts, "latency_ms": [round(x, 1) for x in lat]}


def serving_phase(dev, rehearsal: bool, seed: int) -> dict:
    """Phase 4: r50_fpn_coco at full width through the port's engine."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_cuda
    from mx_rcnn_tpu_torch.serve.engine import build_engine
    from mx_rcnn_tpu_torch.weights import init_variables

    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda}
    base = get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco")
    variables = init_variables(base.model, torch.Generator().manual_seed(seed))
    # Random heads put every class near 1/81, under test.score_threshold;
    # a few favoured classes make the full path return detections.
    variables["box_head.cls_score.bias"][1:5] = 4.0
    rng = np.random.RandomState(seed)
    sizes = ([(96, 128), (128, 100), (80, 120)] if rehearsal
             else [(480, 640), (800, 1333), (600, 1000), (427, 640), (640, 480)])
    images = [rng.uniform(0, 255, (hh, ww, 3)).astype(np.float32) for hh, ww in sizes]
    timeout = 600.0

    out = {}
    full_cfg = apply_overrides(base, ["serve.fused_middle=on", "serve.batch_size=2"])
    t0 = time.perf_counter()
    with build_engine(full_cfg, variables, device=dev) as engine:
        log(f"[serve:full] warm-up {time.perf_counter() - t0:.1f} s "
            f"(programs {engine.runner.levels()}, bucket {engine.runner.buckets})")
        out["full"] = serve_path("full", engine, images, counters, timeout)
    if sum(out["full"]["counts"]) == 0:
        raise AssertionError("the full path returned no detections")

    prop_cfg = apply_overrides(base, ["model.rpn.nms_impl=pallas"])
    with build_engine(prop_cfg, variables, batch_size=1, device=dev, mode="proposals") as engine:
        out["proposals"] = serve_path("proposals", engine, images[:3], counters, timeout)
    return out


def reference_phase(dev, seed: int) -> None:
    """Phase 5, a small input (tiny_synthetic, float32): the kernel path
    and the plain torch path on the card must return identical detections
    (every kernel is bitwise equal to its plain version in float32); the
    CPU's plain path is shown beside them."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner
    from mx_rcnn_tpu_torch.weights import init_variables

    base = get_config("tiny_synthetic")
    variables = init_variables(base.model, torch.Generator().manual_seed(seed + 1))
    variables["box_head.cls_score.bias"][1:3] = 3.0
    rng = np.random.RandomState(seed + 1)
    images = [rng.uniform(0, 255, (hh, ww, 3)).astype(np.float32)
              for hh, ww in ((128, 128), (100, 128))]
    runs = {
        "kernels": (["serve.fused_middle=on"], dev),
        "plain": (["serve.fused_middle=off", "model.rcnn.roi_align_impl=xla"], dev),
        "cpu": (["serve.fused_middle=on"], torch.device("cpu")),
    }
    results = {}
    for name, (overrides, d) in runs.items():
        runner = DetectorRunner(apply_overrides(base, overrides), variables, batch_size=2,
                                device=d, with_proposals=False)
        runner.warmup()
        results[name] = runner.run("full", runner.buckets[0], images)
    for i, (kern, plain, cpu) in enumerate(zip(results["kernels"], results["plain"],
                                               results["cpu"])):
        same = all(np.array_equal(kern[k], plain[k]) for k in ("boxes", "scores", "classes"))
        log(f"[reference] image {i}: {len(kern['scores'])} detections through the kernels, "
            f"{len(plain['scores'])} through the plain path, identical={same}; CPU "
            f"{len(cpu['scores'])}, matched {match_fraction(cpu, kern):.3f} (shown, not held: "
            "near-tied random-weight scores reorder under the CPU's conv sums)")
        if not same:
            raise AssertionError("the kernel path and the plain path disagree")


def finite_line(m: dict) -> bool:
    """Every number of a train log line is finite (``img_s`` is null at
    the first drain)."""
    return all(np.isfinite(v) for k, v in m.items() if not (k == "img_s" and v is None))


@contextlib.contextmanager
def captured_backward(store: list, keep):
    """Wrap B2's autograd Function: each backward call whose level shapes
    ``keep`` accepts puts its inputs, as :func:`hold_bwd` takes them, in
    ``store[0]`` (the last such call wins)."""
    from mx_rcnn_tpu_torch.ops.cuda import roi_align as roi_align_mod

    backward = roi_align_mod.MultilevelRoiAlign.backward

    def capture(ctx, g):
        if keep(ctx.shapes):
            rois, level_idx = ctx.saved_tensors[:2]
            store[:] = [(dict(ctx.shapes), ctx.dtype, rois.clone(), level_idx.clone(),
                         g.to(ctx.dtype).contiguous().clone(), ctx.sampling_ratio)]
        return backward(ctx, g)

    roi_align_mod.MultilevelRoiAlign.backward = staticmethod(capture)
    try:
        yield store
    finally:
        roi_align_mod.MultilevelRoiAlign.backward = staticmethod(backward)


def train_phase(dev, rehearsal: bool, seed: int, steps: int = 5) -> dict:
    """Phase 5: r50_fpn_coco trained at full width for ``steps`` steps
    through ``train/loop.py::train``."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config

    # r50_fpn_coco freezes the stem and stage 1; the tiny rehearsal is
    # given the same freeze so that it has frozen parameters to check.
    overrides = ["model.rpn.loss_impl=compact", f"train.seed={seed}", "data.dataset=synthetic",
                 "train.log_every=1"]
    if rehearsal:
        overrides.append("model.backbone.freeze_stages=2")
    cfg = apply_overrides(get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco"),
                          overrides)
    # At the rehearsal's 128x128 no sampled anchor or roi reaches P4 or P5,
    # so the biases of those two FPN outputs get no gradient.
    return train_run(dev, rehearsal, cfg, "train", steps, unmoved=2 if rehearsal else 0)


def train_run(dev, rehearsal: bool, cfg, label: str, steps: int, unmoved: int = 0) -> dict:
    """``cfg`` trained for ``steps`` steps through ``train/loop.py::train``
    with random weights from ``train.seed``; the launch counts are set to
    0 just before and read after every step.  Every loss finite, B1 and B2
    launched in every step (on the card), every trainable parameter but
    ``unmoved`` moved, frozen parameters and FrozenBN buffers bitwise
    unchanged.  Returns the launches, the last step's B2 inputs, the state
    and ``cfg``."""
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )
    from mx_rcnn_tpu_torch.train.loop import train
    from mx_rcnn_tpu_torch.weights import init_variables

    counters = {"roi_align": multilevel_roi_align_cuda,
                "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    variables = init_variables(cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    steps_seen, launches = [], {k: 0 for k in counters}

    def on_step(line: str) -> None:
        m = json.loads(line)
        per_step = {k: fn.launches for k, fn in counters.items()}
        for k, fn in counters.items():
            launches[k] += fn.launches
            fn.launches = 0
        steps_seen.append((time.perf_counter(), m, per_step))
        log(f"[{label}] {line} launches {per_step}")

    # The backward's inputs of the last step, for timing B2 on a real
    # step's rois.
    step_args = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with captured_backward(step_args, lambda shapes: True):
        state = train(cfg, steps=steps, device=dev, variables=variables, log=on_step)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")

    bad = [i for i, (_, m, _) in enumerate(steps_seen)
           if m["nonfinite"] != 0.0 or not finite_line(m)]
    if len(steps_seen) != steps or bad:
        raise AssertionError(f"{label}: {len(steps_seen)} of {steps} steps, non-finite at {bad}")
    if not rehearsal:
        missing = [(i, k) for i, (_, _, per) in enumerate(steps_seen) for k, v in per.items()
                   if v < 1]
        if missing:
            raise AssertionError(f"{label}: kernels not launched at (step, kernel) {missing}")
    moved, frozen_same, n_frozen = 0, True, 0
    for name, p in state.model.named_parameters():
        start = variables[name].to(p.device)
        if p.requires_grad:
            moved += int(not torch.equal(p.detach(), start))
        else:
            n_frozen += 1
            frozen_same &= torch.equal(p.detach(), start)
    buffers_same = all(torch.equal(v, variables[k].to(v.device))
                       for k, v in state.model.named_buffers())
    n_train = sum(p.requires_grad for p in state.model.parameters())
    if not (frozen_same and buffers_same and n_frozen > 0 and moved == n_train - unmoved):
        raise AssertionError(
            f"{label}: frozen unchanged={frozen_same} ({n_frozen}), buffers unchanged="
            f"{buffers_same}, trainable moved {moved} of {n_train}")
    times = [t for t, _, _ in steps_seen]
    wall = (times[-1] - times[0]) / (len(times) - 1)
    stall = float(np.mean([m["data_stall_ms"] for _, m, _ in steps_seen[1:]]))
    (h, w) = cfg.data.image_size
    log(f"[{label}] {cfg.name}{' (rehearsal: cut)' if rehearsal else ''} batch "
        f"{cfg.train.per_device_batch}, {h}x{w}, {steps} steps in {time.perf_counter() - t0:.2f} "
        f"s (build and the synthetic set's rendering included); after the first: {wall:.4f} s "
        f"a step with the batch assembly, of which data_stall_ms {stall:.2f} (time in "
        f"next(loader)); peak memory {peak:.2f} GiB; "
        f"loss {steps_seen[0][1]['loss']:.4f} -> {steps_seen[-1][1]['loss']:.4f}; "
        f"frozen {n_frozen} parameters and all buffers unchanged, {moved} of {n_train} "
        f"trainable moved; launches {launches}")
    if not step_args:
        raise AssertionError(f"{label}: the ROIAlign backward was never called")
    return {"launches": launches, "step_args": step_args[0], "state": state, "cfg": cfg,
            "s_per_step": wall, "data_stall_ms": stall, "peak_gib": peak}


def torchvision_resnet50(seed: int) -> dict:
    """A ResNet-50 state_dict in torchvision's layout and key names
    (``fc.*`` and ``num_batches_tracked`` included), from ``seed``:
    lecun-normal convolutions and near-identity BN statistics."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[f"{key}.weight"] = torch.randn((cout, cin, k, k), generator=g) / (cin * k * k) ** 0.5

    def bn(key, c):
        sd[f"{key}.weight"] = 1.0 + 0.01 * torch.randn(c, generator=g)
        sd[f"{key}.bias"] = 0.01 * torch.randn(c, generator=g)
        sd[f"{key}.running_mean"] = 0.01 * torch.randn(c, generator=g)
        sd[f"{key}.running_var"] = 1.0 + 0.01 * torch.rand(c, generator=g)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), start=1):
        for b in range(n):
            t = f"layer{li}.{b}"
            for ci, (cout, k) in enumerate(((width, 1), (width, 3), (4 * width, 1)), start=1):
                conv(f"{t}.conv{ci}", cout, cin if ci == 1 else width, k)
                bn(f"{t}.bn{ci}", cout)
            if b == 0:
                conv(f"{t}.downsample.0", 4 * width, cin, 1)
                bn(f"{t}.downsample.1", 4 * width)
            cin = 4 * width
    sd["fc.weight"] = 0.01 * torch.randn((1000, 2048), generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def phase_roidb(cfg, rehearsal: bool, seed: int, missing_path: str, batch: int, steps: int):
    """Sixteen landscape and eight portrait uint8 records (480x640 and
    640x480; a quarter of that in the rehearsal) rendered like the
    synthetic set's classes 1-4, one landscape record with an inverted
    box and one whose image file does not exist.  The missing record sits
    where the schedule's first landscape batch draws a row, so that the
    run meets it (every landscape record has the same aspect, so where it
    sits does not change the schedule).  Raises unless the first
    ``steps`` batches hold both orientations."""
    import dataclasses
    import itertools

    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader

    hw = {"land": (120, 160), "port": (160, 120)} if rehearsal else \
        {"land": (480, 640), "port": (640, 480)}
    roidb = []
    for tag, n in (("land", 18), ("port", 8)):
        ds = SyntheticDataset(num_images=n, image_hw=hw[tag], num_classes=5,
                              seed=seed + (tag == "port"))
        roidb += [dataclasses.replace(ds.record(i), image_id=f"{tag}{i}") for i in range(n)]
    inv, miss = roidb[16], roidb[17]
    roidb[16] = dataclasses.replace(inv, image_id="inverted",
                                    boxes=inv.boxes[:, [2, 1, 0, 3]].copy())
    roidb[17] = dataclasses.replace(miss, image_id="missing", image_array=None,
                                    image_path=missing_path)
    probe = DetectionLoader(roidb, cfg.data, batch, "cpu", seed=cfg.train.seed)
    specs = list(itertools.islice(probe._batch_index_specs(), steps))
    kinds = [roidb[int(idx[0])].aspect >= 1 for idx, _ in specs]
    if all(kinds) or not any(kinds):
        raise AssertionError(f"roidb: the first {steps} batches hold one orientation only")
    first = next(int(j) for idx, _ in specs for j in idx
                 if roidb[int(j)].aspect >= 1 and roidb[int(j)].image_id != "inverted")
    roidb[first], roidb[17] = roidb[17], roidb[first]
    return roidb


@contextlib.contextmanager
def deterministic_algorithms(nondeterministic: list):
    """Every op on its deterministic algorithm (``cudnn.benchmark`` off;
    an op that has none warns instead of raising, and its name goes to
    ``nondeterministic``); the previous settings come back after."""
    import warnings

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(), torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            yield nondeterministic
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
            torch.backends.cudnn.benchmark = prev[2]
            nondeterministic.extend(sorted({
                str(w.message).split(" does not have a deterministic")[0] for w in seen
                if "does not have a deterministic" in str(w.message)}))


def roidb_phase(dev, rehearsal: bool, seed: int, steps: int = 8) -> dict:
    """Phase 7: ``r50_fpn_coco`` at full width trained on a roidb from a
    torchvision-layout ResNet-50 file (``pretrained=``), preempted by a
    real SIGTERM, resumed, then evaluated.  Run A takes 8 steps
    uninterrupted; run B, the same config in another workdir, gets a
    SIGTERM from its log callback at the step-2 line, must raise
    ``Preempted`` there after an emergency checkpoint at step 2 (before
    the first cadence checkpoint, step 4), and resumes to step 8.  Both
    run under deterministic algorithms; B's final state must equal A's
    bitwise (or within 1e-3 of each tensor's largest value, if an op
    without a deterministic CUDA algorithm ran: it is named).  Checked
    too: the import (the backbone equals the file's tensors; frozen stem,
    stage 1 and FrozenBN buffers unchanged by training), both runs' batches
    against ``_batch_index_specs`` (indices and flips, both orientations),
    each quarantine once in ``quarantine.jsonl``, B1 and B2 in every step,
    ``metrics.jsonl`` steps increasing, the checkpoint steps and tree CRC.
    Then ``run_eval`` on 16 synthetic val images (B1 must launch)."""
    import itertools
    import shutil
    import signal

    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.data.cache import quarantine_read
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )
    from mx_rcnn_tpu_torch.train import checkpoint as ckpt
    from mx_rcnn_tpu_torch.train import loop
    from mx_rcnn_tpu_torch.train.import_torch import map_torch_resnet
    from mx_rcnn_tpu_torch.train.preemption import Preempted

    counters = {"roi_align": multilevel_roi_align_cuda,
                "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    overrides = ["model.rpn.loss_impl=compact", f"train.seed={seed}", "data.dataset=synthetic",
                 "data.flip=true", "train.checkpoint_every=4", "train.log_every=2"]
    if rehearsal:
        # A non-square canvas, so that the rehearsal batches portrait apart.
        overrides += ["model.backbone.freeze_stages=2", "data.image_size=96,128"]
    cfg = apply_overrides(get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco"),
                          overrides)
    batch = 2
    cfg = apply_overrides(cfg, [f"train.per_device_batch={batch}"])
    work = os.path.join(ROOT, "runs", f"chip_smoke_roidb_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    saved = {"save": loop.save_checkpoint, "restore": loop.restore_checkpoint}
    times = {"save": [], "restore": []}

    def timed(key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = saved[key](*args, **kw)
            times[key].append((args[1].step, time.perf_counter() - t0))
            return out
        return call

    try:
        pth = os.path.join(work, "resnet50.pth")
        file_sd = torchvision_resnet50(seed)
        torch.save(file_sd, pth)
        roidb = phase_roidb(cfg, rehearsal, seed, os.path.join(work, "missing.jpg"), batch, steps)
        # The import: every backbone tensor is the file's.
        model = loop.build_all(cfg, dev, pretrained=pth)[0]
        mapped = map_torch_resnet(file_sd)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
        frozen += [n for n, _ in model.named_buffers()]
        imported = (sorted(mapped) == sorted(k for k in start if k.startswith("backbone."))
                    and all(torch.equal(start[k], v) for k, v in mapped.items()))
        del model
        if not imported:
            raise AssertionError("roidb: the backbone is not the pretrained file's")

        def drive(name, log_line, loader, **kw):
            """One train() call: its lines, batches and per-step launches."""
            out = {"lines": [], "specs": [], "launches": []}
            assemble = loader._assemble

            def watched(idxs, flips):
                out["launches"].append({k: fn.launches for k, fn in counters.items()})
                for fn in counters.values():
                    fn.launches = 0
                out["specs"].append(([int(j) for j in idxs], [bool(f) for f in flips]))
                return assemble(idxs, flips)

            def on_line(line):
                out["lines"].append((time.perf_counter(), json.loads(line)))
                log(f"[roidb:{name}] {line}")
                log_line(out["lines"][-1][1])

            for fn in counters.values():
                fn.launches = 0
            loader._assemble = watched
            try:
                out["state"] = loop.train(cfg, steps=steps, device=dev, log=on_line,
                                          workdir=os.path.join(work, name), pretrained=pth,
                                          loader=loader, **kw)
            except Preempted as e:
                out["preempted"] = (e, time.perf_counter())
            finally:
                loader._assemble = assemble
                out["launches"] = out["launches"][1:] + [
                    {k: fn.launches for k, fn in counters.items()}]
            return out

        def loader_for(name):
            return DetectionLoader(roidb, cfg.data, batch, dev, seed=cfg.train.seed,
                                   quarantine_path=os.path.join(work, name, cfg.name,
                                                                "quarantine.jsonl"))

        def preempt_at_2(m):
            if m["step"] == 2:
                sent.append(time.perf_counter())
                os.kill(os.getpid(), signal.SIGTERM)

        sent, nondeterministic, portrait = [], [], []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        loader_a, loader_b = loader_for("A"), loader_for("B")
        expected = [([int(j) for j in idx], [bool(f) for f in fl]) for idx, fl in
                    itertools.islice(loader_a._batch_index_specs(), steps)]
        loop.save_checkpoint, loop.restore_checkpoint = timed("save"), timed("restore")
        t0 = time.perf_counter()
        with deterministic_algorithms(nondeterministic), \
                captured_backward(portrait, lambda shapes: shapes[2][0] > shapes[2][1]):
            run_a = drive("A", lambda m: None, loader_a)
            run_b = drive("B", preempt_at_2, loader_b)
            run_b2 = drive("B", lambda m: None, loader_b, resume=True)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else \
            float("nan")
        loop.save_checkpoint, loop.restore_checkpoint = saved["save"], saved["restore"]

        # Preemption: Preempted at the step-2 drain, saved at 2, not yet at 4.
        ckpt_b = loop.checkpoint_dir(cfg, os.path.join(work, "B"))
        pre = run_b.get("preempted")
        if pre is None or pre[0].step != 2 or pre[0].ckpt_dir != ckpt_b:
            raise AssertionError(f"roidb: run B was not preempted at step 2 ({pre})")
        emergency = [t for s, t in times["save"] if s == 2]
        restores = [t for s, t in times["restore"]]
        ckpt_a = loop.checkpoint_dir(cfg, os.path.join(work, "A"))
        state_a, state_b = run_a["state"], run_b2["state"]
        problems = []
        if ckpt.all_steps(ckpt_a) != [0, 4, 8] or ckpt.all_steps(ckpt_b) != [0, 2, 4, 8]:
            problems.append(f"checkpoint steps {ckpt.all_steps(ckpt_a)}, {ckpt.all_steps(ckpt_b)}")
        crcs = [ckpt.read_manifest(d, 8)["tree_crc"] for d in (ckpt_a, ckpt_b)]
        steps_ab = [(s.step, s.optimizer.step) for s in (state_a, state_b)]
        if steps_ab != [(steps, steps)] * 2:
            problems.append(f"step counts {steps_ab}")
        # The schedule: the batches each run drew.
        if run_a["specs"] != expected or run_b["specs"] + run_b2["specs"] != expected:
            problems.append("a run left the loader's schedule")
        kinds = {roidb[idx[0]].aspect >= 1 for idx, _ in expected}
        flips = sum(f for _, fl in expected for f in fl)
        # Quarantine: each bad record journaled once in each run.
        for name in ("A", "B"):
            rows = quarantine_read(os.path.join(work, name, cfg.name, "quarantine.jsonl"))
            if sorted(r["image_id"] for r in rows) != ["inverted", "missing"]:
                problems.append(f"run {name} quarantined {[r['image_id'] for r in rows]}")
        # Launches in every step; metrics.jsonl steps increasing.
        per_step = run_a["launches"] + run_b["launches"] + run_b2["launches"]
        if len(per_step) != 2 * steps:
            problems.append(f"{len(per_step)} steps counted")
        if not rehearsal and any(v < 1 for c in per_step for v in c.values()):
            problems.append(f"B1 or B2 not launched in some step: {per_step}")
        for name in ("A", "B"):
            with open(os.path.join(work, name, cfg.name, "metrics.jsonl")) as f:
                rows = [json.loads(x)["step"] for x in f]
            if rows != sorted(set(rows)) or rows[-1] != steps:
                problems.append(f"run {name} metrics.jsonl steps {rows}")
        lines = [m for run in (run_a, run_b, run_b2) for _, m in run["lines"]]
        if not all(finite_line(m) and m["nonfinite"] == 0.0 for m in lines):
            problems.append("non-finite metrics")
        # The import survives training where nothing trains it.
        final_a = {k: v.detach().cpu() for k, v in state_a.model.state_dict().items()}
        if not all(torch.equal(final_a[k], start[k]) for k in frozen):
            problems.append("a frozen parameter or FrozenBN buffer moved")
        # B's final state against A's.
        final_b = {k: v.detach().cpu() for k, v in state_b.model.state_dict().items()}
        tensors = [(final_a[k], final_b[k]) for k in final_a] + [
            (x.cpu(), y.cpu()) for x, y in zip(state_a.optimizer.trace, state_b.optimizer.trace)]
        bitwise = all(torch.equal(x, y) for x, y in tensors)
        worst = max(float((x - y).abs().max() / x.abs().max().clamp(min=1e-12))
                    for x, y in tensors)
        if nondeterministic:
            same = worst <= 1e-3
        else:
            same = bitwise and crcs[0] == crcs[1]
        if not same:
            problems.append(f"run B ends apart from run A (worst {worst:.3g} of the largest "
                            f"value; ops without a deterministic algorithm: {nondeterministic})")
        if len(kinds) != 2 or not portrait:
            problems.append("no landscape or no portrait batch")
        launches = {k: sum(c[k] for c in per_step) for k in counters}

        img_s = [m["img_s"] for _, m in run_a["lines"][1:]]
        stall = [m["data_stall_ms"] for _, m in run_a["lines"][1:]]
        log(f"[roidb] {cfg.name}{' (rehearsal: tiny)' if rehearsal else ''} batch {batch}, "
            f"{len(roidb)} records, runs A, B (preempted at 2) and B resumed: {wall:.2f} s in "
            f"all; A after its first drain {np.mean(img_s):.2f} img/s (drains {img_s}), "
            f"data_stall_ms {np.mean(stall):.2f} ({stall}); emergency save "
            f"{emergency} s, SIGTERM to Preempted {pre[1] - sent[0]:.3f} s, restore "
            f"{restores} s; peak memory {peak:.2f} GiB; {flips} of {batch * steps} images "
            f"flipped; checkpoints A {ckpt.all_steps(ckpt_a)} B {ckpt.all_steps(ckpt_b)}; "
            f"tree CRC A/B {crcs}; B equals A bitwise={bitwise} (worst {worst:.3g}); ops "
            f"without a deterministic algorithm: {nondeterministic}; launches {launches}")

        # The final eval pass, as train_cli runs it.
        n = 4 if rehearsal else 16
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = run_eval(cfg, state=state_b, limit=n, device=dev)
        eval_wall = time.perf_counter() - t0
        eval_b1 = multilevel_roi_align_cuda.launches
        launches["roi_align"] += eval_b1
        log(f"[roidb:eval] {n} synthetic val images: {n / eval_wall:.2f} img/s end to end "
            f"({eval_wall:.2f} s, model build and rendering included); B1 launches {eval_b1}; "
            f"metrics {json.dumps(metrics, sort_keys=True)}")
        if not all(np.isfinite(v) for v in metrics.values()):
            problems.append("non-finite eval metrics")
        if not rehearsal and eval_b1 < 1:
            problems.append("B1 never launched in the eval")
        if problems:
            raise AssertionError(f"roidb: {problems}")
    finally:
        loop.save_checkpoint, loop.restore_checkpoint = saved["save"], saved["restore"]
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "step_args": portrait[0]}


@contextlib.contextmanager
def captured_postprocess(seen: list):
    """Append to ``seen`` the arguments of every call of either
    postprocess of ``detection/graph.py`` (``forward_inference`` looks
    them up at each call)."""
    from mx_rcnn_tpu_torch.detection import graph

    names = ("_postprocess_one_fused", "_postprocess_one")
    saved = {name: getattr(graph, name) for name in names}

    def wrap(name):
        def call(*args):
            seen.append(args)
            return saved[name](*args)
        return call

    for name in names:
        setattr(graph, name, wrap(name))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(graph, name, fn)


def postprocess_times(dev, rehearsal: bool, args: tuple, label: str) -> dict:
    """Both postprocesses on the same captured inputs ``args``: CUDA
    events around back-to-back calls (``ms``, the NMS fixed point's host
    syncs included) and, from a ``torch.profiler`` trace, the device time
    and kernel launches a call."""
    from mx_rcnn_tpu_torch.detection import graph
    from mx_rcnn_tpu_torch.utils.profiling import traced_breakdown

    clock = Clock(dev)
    cfg, _, roi_valid, probs = args[:4]
    candidates = int((roi_valid[..., None] & (probs[..., 1:] >= cfg.test.score_threshold)).sum())
    out = {"candidates": candidates}
    for mode, fn in (("fused", graph._postprocess_one_fused), ("per_class", graph._postprocess_one)):
        ms = clock.ms(lambda: fn(*args), 2 if rehearsal else 20)
        device_ms = launches = float("nan")
        if dev.type == "cuda":
            trace = traced_breakdown(lambda: (fn(*args), torch.cuda.synchronize()))
            device_ms, launches = trace["device_ms_per_call"], trace["kernel_launches_per_call"]
        out[mode] = {"ms": ms, "device_ms": device_ms, "launches": launches}
        log(f"[eval:postprocess:{mode}] {label}: batch {probs.shape[0]}, {probs.shape[1]} rois, "
            f"{candidates} (roi, class) candidates above the threshold: {ms:.4f} ms a call "
            f"(events), device {device_ms:.4f} ms, {launches} launches a call")
    return out


def eval_breakdown(dev, rehearsal: bool, cfg, model, first) -> dict:
    """Where an eval batch's time goes: ``first`` through the eval step
    with ``model`` (fused postprocess), CUDA events around back-to-back
    calls (the forward alone, the batch already on the card) and a
    ``torch.profiler`` trace of two calls (device time by stage, busy
    share, launches)."""
    from mx_rcnn_tpu_torch.parallel.step import make_eval_step
    from mx_rcnn_tpu_torch.utils.profiling import traced_breakdown

    step = make_eval_step((cfg.data.pixel_mean, cfg.data.pixel_std))
    ms = Clock(dev).ms(lambda: step(model, first), 2 if rehearsal else 10)
    if dev.type != "cuda":
        return {"ms": ms}
    trace = traced_breakdown(lambda: (step(model, first), torch.cuda.synchronize()))
    stages = {k: round(v, 3) for k, v in list(trace["device_ms_by_stage"].items())[:8]}
    log(f"[eval:trace] a batch of {first.images.shape[0]}, fused: {ms:.2f} ms (events, the "
        f"forward alone), device {trace['device_ms_per_call']:.2f} ms, busy "
        f"{trace['device_busy_share_of_traced_window']:.2f}, "
        f"{trace['kernel_launches_per_call']:.0f} launches; device ms by stage {stages}")
    return {"ms": ms, **trace}


def first_batch_reference(dev, cfg, state_dict, roidb, batch: int, label: str):
    """The first eval batch of ``roidb`` through the kernels and through the
    plain versions (``roi_align_impl=xla``), both in float32 from
    ``state_dict``: the detections must be identical (B1 is the one kernel
    of this path whatever the mode, bitwise in float32), and there must be
    some.  Returns the batch."""
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.data.loader import eval_batches
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.parallel.step import make_eval_step

    first, _ = next(eval_batches(roidb, cfg.data, batch, dev))
    dets = {}
    for name, over in (("kernels", []), ("plain", ["model.rcnn.roi_align_impl=xla"])):
        fcfg = apply_overrides(cfg, ["model.precision.policy=float32", *over])
        model = TwoStageDetector(fcfg.model, device=dev)
        model.load_state_dict(state_dict)
        step = make_eval_step((fcfg.data.pixel_mean, fcfg.data.pixel_std))
        dets[name] = [x.cpu() for x in step(model, first)]
        del model
    same = all(torch.equal(a, b) for a, b in zip(dets["kernels"], dets["plain"]))
    log(f"[{label}:reference] first batch, float32: {int(dets['kernels'][3].sum())} detections "
        f"through the kernels, {int(dets['plain'][3].sum())} through the plain path, "
        f"identical={same}")
    if not same or not dets["kernels"][3].any():
        raise AssertionError(f"{label}: the kernel path and the plain path disagree, or return "
                             "no detections")
    return first


def eval_phase(dev, rehearsal: bool, trained: dict) -> dict:
    """Phase 6: the trained r50_fpn_coco state saved with
    ``train/checkpoint.py``, its manifest verified, restored into a fresh
    state (the tree CRC and every tensor equal), then evaluated at full
    width on the synthetic set through ``cli/eval_cli.py::run_eval`` in
    both ``test.nms_mode``s, the launch counts set to 0 just before each
    run and read just after.  Each run's dump, loaded and scored again,
    gives its metrics dict; the metrics are finite.  Img/s is read end to
    end and over the batches after the first.  Then, once: the first
    eval batch through the kernels and through the plain versions
    (float32 policy, ``roi_align_impl=xla``) gives identical detections
    (B1 is the one kernel of this path, whatever the mode); the forward
    is traced (:func:`eval_breakdown`); both postprocesses are timed on
    the first batch's captured inputs at three candidate densities
    (:func:`postprocess_times`).  Five train steps leave every
    foreground score under ``test.score_threshold``, so the restored head
    favours classes 1-4 (+4 on their bias: about 2,500 candidates an
    image) to give the evaluator detections; the densities set that
    favour to 0, 2 and 4.  The candidate mix is synthetic: no trained
    detector's eval traffic is on the card's machine."""
    import shutil

    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.evalutil.detections import load_detections
    from mx_rcnn_tpu_torch.evalutil.pred_eval import evaluate_detections
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_cuda
    from mx_rcnn_tpu_torch.parallel.step import make_eval_step
    from mx_rcnn_tpu_torch.train import checkpoint as ckpt
    from mx_rcnn_tpu_torch.train.loop import build_all

    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda}
    cfg, state = trained["cfg"], trained["state"]
    n = 4 if rehearsal else 64
    batch = max(cfg.model.test.per_device_batch, 1)
    work = os.path.join(ROOT, "runs", f"chip_smoke_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    try:
        ckpt_dir = os.path.join(work, "ckpt")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(ckpt_dir, state)
        t_save = time.perf_counter() - t0
        verified = ckpt.verify_manifest(ckpt_dir, state.step)
        _, _, fresh, _, _ = build_all(cfg, dev)
        t0 = time.perf_counter()
        restored = ckpt.restore_checkpoint(ckpt_dir, fresh)
        t_restore = time.perf_counter() - t0
        saved_crc = ckpt.read_manifest(ckpt_dir, state.step)["tree_crc"]
        crcs = (ckpt.tree_crc(ckpt.state_payload(state)), saved_crc,
                ckpt.tree_crc(ckpt.state_payload(restored)))
        size = os.path.getsize(os.path.join(ckpt.step_dir(ckpt_dir, state.step), ckpt.STATE_FILE))
        log(f"[eval:checkpoint] step {state.step}: {size / 2**20:.1f} MiB saved in {t_save:.2f} s, "
            f"manifest {verified}, restored in {t_restore:.2f} s; tree CRC trained/manifest/"
            f"restored {crcs}")
        if verified != (True, "ok") or len(set(crcs)) != 1 or restored.step != state.step:
            raise AssertionError("eval: the checkpoint does not verify or restore")

        bias = restored.model.box_head.cls_score.bias
        base = bias[1:5].detach().clone()

        def favour(extra: float) -> None:
            with torch.no_grad():
                bias[1:5] = base + extra

        favour(4.0)
        roidb = build_dataset(cfg.data, train=False).roidb()[:n]
        out, launches = {}, {k: 0 for k in counters}
        for mode in ("fused", "per_class"):
            ecfg = apply_overrides(cfg, [f"model.test.nms_mode={mode}"])
            ticks = []
            dump = os.path.join(work, f"dets_{mode}.json")
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            metrics = run_eval(ecfg, state=restored, dump_path=dump, limit=n, device=dev,
                               progress=lambda k: ticks.append((time.perf_counter(), k)))
            wall = time.perf_counter() - t0
            run = {k: fn.launches for k, fn in counters.items()}
            for k in counters:
                launches[k] += run[k]
            # The batches after the first: one tick at each batch's end.
            ends = ticks[batch - 1::batch]
            gaps = np.diff([t for t, _ in ends])
            steady = (ends[-1][1] - ends[0][1]) / (ends[-1][0] - ends[0][0]) if gaps.size else \
                float("nan")
            per_batch = [batch / g for g in gaps]
            dumped = load_detections(dump)
            n_dets = sum(len(d["scores"]) for d in dumped.values())
            rescored = evaluate_detections(dumped, roidb, ecfg.model.num_classes)
            log(f"[eval:{mode}] r50_fpn_coco{' (rehearsal: tiny)' if rehearsal else ''} "
                f"{n} images, batch {batch}: {n / wall:.2f} img/s end to end ({wall:.2f} s, "
                f"model build and the synthetic set's rendering included), {steady:.2f} img/s "
                f"over the {gaps.size} batches after the first (per batch: min "
                f"{min(per_batch, default=float('nan')):.2f}, median "
                f"{float(np.median(per_batch)) if per_batch else float('nan'):.2f}, max "
                f"{max(per_batch, default=float('nan')):.2f}); {n_dets} detections; launches "
                f"{run}; dump rescored equal={rescored == metrics}")
            log(f"[eval:{mode}] metrics {json.dumps(metrics, sort_keys=True)}")
            if (rescored != metrics or not n_dets
                    or not all(np.isfinite(v) for v in metrics.values())):
                raise AssertionError(f"eval {mode}: no detections, non-finite metrics or the "
                                     "dump rescores apart")
            if not rehearsal and run["roi_align"] < 1:
                raise AssertionError(f"eval {mode}: B1 never launched")
            out[mode] = {"img_s": n / wall, "img_s_steady": steady, "img_s_per_batch": per_batch,
                         "metrics": metrics}

        first = first_batch_reference(dev, cfg, restored.model.state_dict(), roidb, batch,
                                      "eval")

        restored.model.eval()
        out["trace"] = eval_breakdown(dev, rehearsal, cfg, restored.model, first)
        step = make_eval_step((cfg.data.pixel_mean, cfg.data.pixel_std))
        out["postprocess"] = {}
        for extra in (0.0, 2.0, 4.0):
            favour(extra)
            seen = []
            with captured_postprocess(seen):
                step(restored.model, first)
            out["postprocess"][extra] = postprocess_times(dev, rehearsal, seen[0],
                                                          f"classes 1-4 favoured +{extra:g}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, **out}


def train_reference_phase(dev, seed: int) -> None:
    """Phase 6, training: one tiny_synthetic float32 step through the
    kernels and through the plain path, same weights, batch and draws."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.detection.graph import Draws, forward_train
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_bwd_cuda
    from mx_rcnn_tpu_torch.weights import init_variables

    base = get_config("tiny_synthetic")
    variables = init_variables(base.model, torch.Generator().manual_seed(seed + 3))
    batch = synthetic_batch(base, dev, seed + 3)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    n_anchors = sum(3 * (128 >> l) ** 2 for l in range(2, 7))
    n_rows = base.model.rpn.train_post_nms_top_n + base.data.max_gt_boxes
    draws = Draws(*(torch.rand((2, n), generator=g, device=dev)
                    for n in (n_anchors, n_anchors, n_rows, n_rows)))
    stats = (base.data.pixel_mean, base.data.pixel_std)
    runs = {}
    for name, over in (("kernels", []), ("plain", ["model.rcnn.roi_align_impl=xla"])):
        model = TwoStageDetector(apply_overrides(base, over).model, device=dev)
        model.load_state_dict(variables)
        before = multilevel_roi_align_bwd_cuda.launches
        total, metrics = forward_train(model, batch, draws, stats)
        total.backward()
        runs[name] = ({k: float(v.detach()) for k, v in metrics.items()},
                      {n: p.grad for n, p in model.named_parameters()},
                      multilevel_roi_align_bwd_cuda.launches - before)
    (km, kg, kl), (pm, pg, pl) = runs["kernels"], runs["plain"]
    metric_err = max(abs(km[k] - pm[k]) / max(abs(pm[k]), 1.0) for k in km)
    worst, ok = 0.0, True
    for n, a in pg.items():
        d = kg[n] - a
        if n.startswith("backbone."):
            rel = float(d.norm() / a.norm().clamp(min=1e-12))
            ok &= rel <= 5e-3
        else:
            rel = float(d.abs().max() / a.abs().max().clamp(min=1e-12))
            ok &= rel <= 1e-5
        worst = max(worst, rel)
    log(f"[reference:train] tiny_synthetic f32: loss {km['loss']:.6f} (kernels) vs "
        f"{pm['loss']:.6f} (plain), largest metric difference {metric_err:.3g} (<= 1e-6 "
        f"relative); worst gradient "
        f"difference {worst:.3g} (backbone by norm <= 5e-3, others by max <= 1e-5); "
        f"B2 launches {kl} vs {pl}")
    if metric_err > 1e-6 or not ok or kl != 1 or pl != 0:
        raise AssertionError("the kernel train step and the plain train step disagree")


# Phase c4: the single-level C4 family at full width; the first is the
# headline of the kernels line's ``@c4`` entries.
C4_CONFIGS = ("r101_coco", "vgg16_voc07")


def c4_overrides(rehearsal: bool) -> list[str]:
    """The rehearsal's cuts of the C4 presets (a 192x256 canvas, proposals
    in the hundreds, a narrow box head, eval batch 2); none on the card."""
    if not rehearsal:
        return []
    return ["data.image_size=192,256", "data.short_side=192", "data.max_side=256",
            "model.rpn.train_pre_nms_top_n=300", "model.rpn.train_post_nms_top_n=100",
            "model.rpn.test_pre_nms_top_n=300", "model.rpn.test_post_nms_top_n=50",
            "model.rcnn.roi_batch_size=32", "model.rcnn.hidden_dim=64",
            "model.test.per_device_batch=2"]


@contextlib.contextmanager
def captured_pool(store: list):
    """Put the one-level pyramid and rois of the last single-level ROIAlign
    call of ``detection/graph.py`` in ``store[0]``, and whether B1 read
    that map eight channels a thread (contiguous, C a multiple of 8,
    16-byte aligned) in ``store[1]`` (``forward_inference`` looks
    ``_pool_rois_impl`` up at each call)."""
    from mx_rcnn_tpu_torch.detection import graph

    pool = graph._pool_rois_impl

    def capture(cfg, feats, rois, pooled_size, roi_level_set):
        levels = {l: f for l, f in feats.items() if l in roi_level_set}
        if len(levels) == 1:
            (f,) = levels.values()
            vec = f.is_contiguous() and f.shape[-1] % 8 == 0 and f.data_ptr() % 16 == 0
            store[:] = [({l: f.detach().clone() for l, f in levels.items()},
                         rois.detach().clone()), vec]
        return pool(cfg, feats, rois, pooled_size, roi_level_set)

    graph._pool_rois_impl = capture
    try:
        yield store
    finally:
        graph._pool_rois_impl = pool


def c4_serve(dev, rehearsal: bool, seed: int, name: str, counters: dict) -> dict:
    """Phase c4 (a): ``name`` at full width through the engine, random
    weights from the seed, classes 1-4 favoured: the ``full`` program with
    ``serve.fused_middle=on`` at batch 2 (B1 on one level, B3 at L = 1),
    then the ``proposals`` program with ``rpn.nms_impl=pallas`` at batch 1
    (B4 on one level); each path with the counts set to 0 just before and
    read just after, and every kernel of it launched (on the card)."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.serve.engine import build_engine
    from mx_rcnn_tpu_torch.weights import init_variables

    base = apply_overrides(get_config(name), c4_overrides(rehearsal))
    variables = init_variables(base.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    rng = np.random.RandomState(seed)
    if rehearsal:
        sizes = [(96, 128), (128, 100), (80, 120)]
    elif name == "vgg16_voc07":      # VOC's own sizes
        sizes = [(375, 500), (500, 375), (333, 500), (500, 333), (281, 500)]
    else:
        sizes = [(480, 640), (800, 1333), (600, 1000), (427, 640), (640, 480)]
    images = [rng.uniform(0, 255, (hh, ww, 3)).astype(np.float32) for hh, ww in sizes]
    out, pooled = {}, []
    full_cfg = apply_overrides(base, ["serve.fused_middle=on", "serve.batch_size=2"])
    t0 = time.perf_counter()
    with build_engine(full_cfg, variables, device=dev) as engine, captured_pool(pooled):
        log(f"[c4:{name}:full] warm-up {time.perf_counter() - t0:.1f} s "
            f"(programs {engine.runner.levels()}, bucket {engine.runner.buckets})")
        out["full"] = serve_path(f"c4:{name}:full", engine, images, counters, 600.0)
    prop_cfg = apply_overrides(base, ["model.rpn.nms_impl=pallas"])
    with build_engine(prop_cfg, variables, batch_size=1, device=dev, mode="proposals") as engine:
        out["proposals"] = serve_path(f"c4:{name}:proposals", engine, images[:3], counters,
                                      600.0)
    if sum(out["full"]["counts"]) == 0:
        raise AssertionError(f"c4 {name}: the full path returned no detections")
    log(f"[c4:{name}:full] B1 reads the {tuple(pooled[0][0][4].shape)} map eight channels "
        f"a thread: {pooled[1]}")
    need = {"full": ("roi_align", "fused_middle"), "proposals": ("nms",)}
    missing = [(path, k) for path, ks in need.items() for k in ks
               if out[path]["launches"][k] < 1]
    if missing and not rehearsal:
        raise AssertionError(f"c4 {name}: kernels not launched on (path, kernel) {missing}")
    if not pooled[1]:
        raise AssertionError(f"c4 {name}: B1 read the C4 map one channel a thread")
    out["pool"] = pooled[0]
    return out


def c4_fpn_request(dev, rehearsal: bool, seed: int, counters: dict) -> dict:
    """Phase c4 (a): one request to ``r101_fpn_coco`` at full width
    (``serve.fused_middle=on``: B1 and B3), counted with the full path."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.serve.engine import build_engine
    from mx_rcnn_tpu_torch.weights import init_variables

    cfg = apply_overrides(get_config("r101_fpn_coco"),
                          [*c4_overrides(rehearsal), "serve.fused_middle=on"])
    variables = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    hw = (96, 128) if rehearsal else (800, 1333)
    image = np.random.RandomState(seed).uniform(0, 255, (*hw, 3)).astype(np.float32)
    with build_engine(cfg, variables, device=dev) as engine:
        out = serve_path("c4:r101_fpn_coco:full", engine, [image], counters, 600.0)
    if not rehearsal and min(out["launches"][k] for k in ("roi_align", "fused_middle")) < 1:
        raise AssertionError(f"c4 r101_fpn_coco: B1 or B3 not launched ({out['launches']})")
    return out


def c4_eval(dev, rehearsal: bool, trained: dict, counters: dict) -> dict:
    """Phase c4 (c): ``run_eval`` on 16 synthetic images at
    ``test.per_device_batch``, ``nms_mode=fused``, with the trained state
    (classes 1-4 favoured, so that there are detections), the counts set
    to 0 just before and read just after (B1 must launch); metrics
    finite; the first batch in float32 through the kernels and the plain
    path identical."""
    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.data.datasets import build_dataset

    cfg = apply_overrides(trained["cfg"], ["model.test.nms_mode=fused"])
    state = trained["state"]
    # Three steps leave the trained head sure of the background, so classes
    # 1-4 take the background's row of the classifier and one more on its
    # bias: each scores about e / (1 + 4e) = 0.23 on every roi.
    with torch.no_grad():
        head = state.model.box_head.cls_score
        head.weight[1:5] = head.weight[0]
        head.bias[1:5] = head.bias[0] + 1.0
    n, batch = (4 if rehearsal else 16), cfg.model.test.per_device_batch
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = run_eval(cfg, state=state, limit=n, device=dev)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[c4:{cfg.name}:eval] {n} synthetic images, batch {batch}, fused: {n / wall:.2f} img/s "
        f"end to end ({wall:.2f} s, model build and rendering included); launches {launches}; "
        f"metrics {json.dumps(metrics, sort_keys=True)}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"c4 {cfg.name}: non-finite eval metrics")
    if not rehearsal and launches["roi_align"] < 1:
        raise AssertionError(f"c4 {cfg.name}: B1 never launched in the eval")
    roidb = build_dataset(cfg.data, train=False).roidb()[:n]
    first_batch_reference(dev, cfg, state.model.state_dict(), roidb, batch, f"c4:{cfg.name}:eval")
    return {"launches": launches, "img_s": n / wall, "metrics": metrics}


def c4_kernels(dev, rehearsal: bool, seed: int, runs: dict, chunk_us: dict) -> dict:
    """Phase c4 (d): each kernel at the C4 shapes against its plain
    version, timed as in phase 3: B1 on one level on the rois phase (a)
    pooled, bf16 (the path's dtype, within one bf16 ulp) and f32
    (bitwise), for r101_coco (C = 1024) and vgg16_voc07 (C = 512); B2 on
    phase (b)'s last-step inputs; B3 at L = 1 and B4 on one level at the
    serving pre-NMS top-n (6000), both bitwise.  ``chunk_us``: phase 3's
    sweep chunk step of B3 and B4, for their sequential floor."""
    from mx_rcnn_tpu_torch.detection.graph import level_anchors
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels, fused_middle_levels_plain
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_keep_sorted_cuda, nms_keep_sorted_plain
    from mx_rcnn_tpu_torch.ops.proposals import _pre_nms_candidates, _topk_candidates

    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)

    def entry(cases: dict) -> dict:
        """One kernels-line entry from ``cases`` {case: result}: the first
        case is the headline, the others' numbers are suffixed extras, and
        it matches when every case does."""
        first, *rest = cases
        out = dict(cases[first], match=all(r["match"] for r in cases.values()), extra={})
        for case in rest:
            r = cases[case]
            out["extra"].update({f"{k}_{case}": r[k] for k in
                                 ("ms", "kernel_ms", "plain_ms", "max_abs_err")})
            out["extra"][f"bound_ms_{case}"] = r["bound"][0]
        return out

    fwd, bwd = {}, {}
    for name in runs:
        pyr, rois = runs[name]["serve"]["pool"]
        for dt, case in ((torch.bfloat16, name), (torch.float32, f"f32_{name}")):
            res = hold_fwd({l: f.to(dt) for l, f in pyr.items()}, rois, 7, 2, clock, iters,
                           plain_iters)
            if dt == torch.float32:    # bitwise in float32
                res["match"] = res["match"] and res["max_abs_err"] == 0.0
            fwd[case] = res
            log(f"[kernel:roi_align@c4:{case}] {res['shape']} map {tuple(pyr[4].shape[1:3])}: "
                f"match={res['match']} max_abs_err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
                f"kernel_ms={res['kernel_ms']:.4f} plain_ms={res['plain_ms']:.4f} "
                f"bound_ms={res['bound'][0]:.4f}")
        args = runs[name]["train"]["step_args"]
        bwd[name] = res = hold_bwd(args, clock, iters, plain_iters)
        log(f"[kernel:roi_align_bwd@c4:{name}] {res['shape']} map {args[0][4]}: "
            f"match={res['match']} max_abs_err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
            f"kernel_ms={res['kernel_ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={res['bound'][0]:.4f}")
    out = {"roi_align@c4": entry(fwd), "roi_align_bwd@c4": entry(bwd)}

    # B3 and B4 at the serving pre-NMS top-n of r101_coco's canvas: its C4
    # anchor grid, RPN-like bf16 scores (full of ties) and small deltas.
    cfg = runs["r101_coco"]["train"]["cfg"]
    rpn = cfg.model.rpn
    (h, w), b = cfg.data.image_size, 2
    anchors = level_anchors(cfg.model, {4: torch.empty((1, h >> 4, w >> 4, 1), device=dev)})[4]
    g = torch.Generator().manual_seed(seed + 11)
    scores = torch.sigmoid(0.5 * torch.randn((b, len(anchors)), generator=g)) \
        .to(torch.bfloat16).to(dev)
    deltas = (0.2 * torch.randn((b, len(anchors), 4), generator=g)).to(torch.bfloat16).to(dev)
    image_hw = torch.tensor([[h, w], [h - 176, w - 320]], dtype=torch.float32, device=dev)
    pre, thresh = rpn.test_pre_nms_top_n, rpn.nms_threshold
    ts, td, ta = _topk_candidates(scores, deltas, anchors, pre)
    margs = (ta[:, None].float(), td[:, None].float(), ts[:, None].float(), image_hw,
             rpn.min_size, thresh)
    got, want = fused_middle_levels(*margs), fused_middle_levels_plain(*margs)
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    k = margs[2].shape[-1]
    flops = 40 * margs[2].numel() + IOU_FLOPS * greedy_pairs(got[2], torch.isfinite(got[1]))
    out["fused_middle@c4"] = dict(
        match=same, max_abs_err=float((got[0] - want[0]).abs().max()),
        ms=clock.ms(lambda: fused_middle_levels(*margs), iters),
        kernel_ms=clock.kernel_ms(lambda: fused_middle_levels(*margs)),
        plain_ms=clock.ms(lambda: fused_middle_levels_plain(*margs), plain_iters),
        bound=bound(nbytes(*margs[:4], *got), flops),
        extra=dict(chunk_steps=-(-k // 64),
                   sequential_floor_ms=1e-3 * chunk_us["fused_middle"] * -(-k // 64)),
        shape=f"B={b} L=1 k={k} (two launches a call)")
    dense = _pre_nms_candidates(scores[:1], deltas[:1], anchors, image_hw[:1], pre, rpn.min_size)
    order = torch.argsort(-dense[1], dim=-1, stable=True)
    nargs = (torch.gather(dense[0], 1, order[..., None].expand(*order.shape, 4)).contiguous(),
             torch.gather(torch.isfinite(dense[1]), 1, order).contiguous(), thresh)
    k1, k2 = nms_keep_sorted_cuda(*nargs), nms_keep_sorted_plain(*nargs)
    out["nms@c4"] = dict(
        match=torch.equal(k1, k2), max_abs_err=float(not torch.equal(k1, k2)),
        ms=clock.ms(lambda: nms_keep_sorted_cuda(*nargs), iters),
        kernel_ms=clock.kernel_ms(lambda: nms_keep_sorted_cuda(*nargs)),
        plain_ms=clock.ms(lambda: nms_keep_sorted_plain(*nargs), plain_iters),
        bound=bound(nbytes(nargs[0], nargs[1], k1), IOU_FLOPS * greedy_pairs(k1, nargs[1])),
        extra=dict(chunk_steps=-(-nargs[0].shape[-2] // 64),
                   sequential_floor_ms=1e-3 * chunk_us["nms"] * -(-nargs[0].shape[-2] // 64)),
        shape=f"B=1 L=1 n={nargs[0].shape[-2]} (one launch)")
    for key in ("fused_middle@c4", "nms@c4"):
        r = out[key]
        log(f"[kernel:{key}] {r['shape']}: match={r['match']} ms={r['ms']:.4f} "
            f"kernel_ms={r['kernel_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}); {r['extra']['chunk_steps']} "
            f"chunk steps, sequential floor {r['extra']['sequential_floor_ms']:.4f} ms")
    return out


def c4_phase(dev, rehearsal: bool, seed: int, chunk_us: dict) -> dict:
    """Phase c4: vgg16_voc07 and r101_coco at full width, random weights
    from the seed: (a) serve (:func:`c4_serve`, and one r101_fpn_coco
    request), (b) 3 train steps through ``train/loop.py::train`` on the
    synthetic set at the preset's canvas and batch (compact RPN loss, the
    mixed policy), (c) evaluate (:func:`c4_eval`), then (d) each kernel at
    these shapes (:func:`c4_kernels`).  Returns the paths' launches and the
    kernels' entries."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )

    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda, "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    paths = {p: {"launches": {k: 0 for k in counters}}
             for p in ("c4_full", "c4_proposals", "c4_train", "c4_eval")}

    def count(path, launches):
        for k, v in launches.items():
            paths[path]["launches"][k] = paths[path]["launches"].get(k, 0) + v

    runs = {}
    for name in C4_CONFIGS:
        serve = c4_serve(dev, rehearsal, seed, name, counters)
        count("c4_full", serve["full"]["launches"])
        count("c4_proposals", serve["proposals"]["launches"])
        cfg = apply_overrides(get_config(name), [
            "model.rpn.loss_impl=compact", f"train.seed={seed}", "data.dataset=synthetic",
            "train.log_every=1", *c4_overrides(rehearsal)])
        trained = train_run(dev, rehearsal, cfg, f"c4:{name}:train", 3)
        count("c4_train", trained["launches"])
        evaluated = c4_eval(dev, rehearsal, trained, counters)
        count("c4_eval", evaluated["launches"])
        log(f"[c4:{name}] serving latency ms per request "
            f"{serve['full']['latency_ms']} (full), {serve['proposals']['latency_ms']} "
            f"(proposals); launches full {serve['full']['launches']}, proposals "
            f"{serve['proposals']['launches']}; train {trained['s_per_step']:.4f} s a step after "
            f"the first, data_stall_ms {trained['data_stall_ms']:.2f}, peak memory "
            f"{trained['peak_gib']:.2f} GiB; eval {evaluated['img_s']:.2f} img/s")
        trained["state"] = None
        runs[name] = {"serve": serve, "train": trained}
    count("c4_full", c4_fpn_request(dev, rehearsal, seed, counters)["launches"])
    kernels = c4_kernels(dev, rehearsal, seed, runs, chunk_us)
    return {"paths": paths, "kernels": kernels}


# The kernels of the main paths: source, the TPU kernel it replaces, and
# the paths that launch it.  (``roi_align_f32`` and ``roi_align_bwd_f32``
# are checked as well, but the paths run bf16, so they are no entries of
# their own.)
KERNELS = {
    "roi_align": ("mx_rcnn_tpu_torch/csrc/roi_align.cu", "mx_rcnn_tpu/ops/pallas/roi_align.py:393",
                  ("full", "train", "eval", "roidb", "c4_full", "c4_train", "c4_eval")),
    "roi_align_bwd": ("mx_rcnn_tpu_torch/csrc/roi_align_bwd.cu",
                      "mx_rcnn_tpu/ops/pallas/roi_align.py:623", ("train", "roidb", "c4_train")),
    "fused_middle": ("mx_rcnn_tpu_torch/csrc/middle.cu",
                     "mx_rcnn_tpu/ops/pallas/middle.py:145", ("full", "c4_full")),
    "nms": ("mx_rcnn_tpu_torch/csrc/nms.cu", "mx_rcnn_tpu/ops/pallas/nms.py:75",
            ("proposals", "c4_proposals")),
}
# Phase c4's entries: the same kernels at the single-level C4 shapes,
# counted over phase c4's paths alone.
KERNELS.update({
    "roi_align@c4": (*KERNELS["roi_align"][:2], ("c4_full", "c4_train", "c4_eval")),
    "roi_align_bwd@c4": (*KERNELS["roi_align_bwd"][:2], ("c4_train",)),
    "fused_middle@c4": (*KERNELS["fused_middle"][:2], ("c4_full",)),
    "nms@c4": (*KERNELS["nms"][:2], ("c4_proposals",)),
})


PKG = "mx_rcnn_tpu_torch"


def import_tree(root: str, modules) -> dict:
    """Import ``modules`` (names under the package) from the package in the
    tree ``root``, beside this tree's: this tree's modules leave
    ``sys.modules`` while ``root``'s load, and come back after.  Raises
    when a module does not come from ``root``."""
    import importlib

    root = os.path.abspath(root)
    ours = lambda k: k == PKG or k.startswith(PKG + ".")  # noqa: E731
    mine = {k: sys.modules.pop(k) for k in [k for k in sys.modules if ours(k)]}
    sys.path.insert(0, root)
    try:
        loaded = {m: importlib.import_module(f"{PKG}.{m}") for m in modules}
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(mine)
    for m, mod in loaded.items():
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise AssertionError(f"{PKG}.{m} came from {mod.__file__}, not from {root}")
    return loaded


def parent_phase(dev, parent: str, kernels: dict) -> dict:
    """Hold this tree's kernels bitwise against another tree's (``parent``,
    e.g. the parent commit unpacked by ``git archive``) on this run's
    inputs, timed in turns (parent, this, this, parent), as a call and as
    the kernels alone: B1 in bf16 and f32 on serving, train-step,
    portrait-step and edge rois, B3 at the serving shape and at k = 2000,
    B2 on its five cases, B4 on its three shapes.  The parent's kernels are reached through its
    own wrappers (``ops/cuda``), which set up its own C entry points; its
    sources are built first, and a failed build raises."""
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_keep_sorted_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )

    mods = import_tree(parent, ("ops.cuda._build", "ops.cuda.roi_align", "ops.cuda.middle",
                                "ops.cuda.nms"))
    build = mods["ops.cuda._build"]
    t0 = time.perf_counter()
    build.build_all()
    log(f"[parent] {parent}: built {build.KERNELS} in {time.perf_counter() - t0:.1f} s")
    wrappers = {
        "roi_align": (mods["ops.cuda.roi_align"].multilevel_roi_align_cuda,
                      multilevel_roi_align_cuda),
        "roi_align_bwd": (mods["ops.cuda.roi_align"].multilevel_roi_align_bwd_cuda,
                          multilevel_roi_align_bwd_cuda),
        "fused_middle": (mods["ops.cuda.middle"].fused_middle_levels, fused_middle_levels),
        "nms": (mods["ops.cuda.nms"].nms_keep_sorted_cuda, nms_keep_sorted_cuda),
    }
    clock = Clock(dev)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
        return torch.equal(a, b)

    def turns(old, new, args, iters=20):
        """Parent, this, this, parent: a call's event time (the wrapper's
        host work included) and, in the same order, the kernels alone."""
        t = [clock.ms(lambda: f(*args), iters) for f in (old, new, new, old)]
        k = [clock.kernel_ms(lambda: f(*args), build if f is old else None)
             for f in (old, new, new, old)]
        return {"parent_ms": [t[0], t[3]], "ms": [t[1], t[2]],
                "parent_kernel_ms": [k[0], k[3]], "kernel_ms": [k[1], k[2]]}

    cases = []
    for name in ("roi_align", "roi_align_f32"):
        for key, args in kernels[name]["inputs"].items():
            cases.append((f"{name}:{key}", "roi_align", args))
    for key, args in kernels["fused_middle"]["inputs"].items():
        cases.append((f"fused_middle:{key}", "fused_middle", args))
    bwd_cases = {"spread": kernels["roi_align_bwd"]["inputs"],
                 "spread_f32": kernels["roi_align_bwd_f32"]["inputs"],
                 **kernels["roi_align_bwd"].get("cases", {})}
    for key, args in bwd_cases.items():
        cases.append((f"roi_align_bwd:{key}", "roi_align_bwd", args))
    for key, args in kernels["nms"]["inputs"].items():
        cases.append((f"nms:{key}", "nms", args))
    res = {}
    for key, kernel, args in cases:
        old, new = wrappers[kernel]
        res[key] = {"bitwise": same(old(*args), new(*args)), **turns(old, new, args)}
        r = {k: [round(x, 4) for x in v] for k, v in res[key].items() if k != "bitwise"}
        log(f"[parent:{key}] bitwise={res[key]['bitwise']} parent ms {r['parent_ms']} this "
            f"tree ms {r['ms']}; kernels alone: parent {r['parent_kernel_ms']} this tree "
            f"{r['kernel_ms']}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny shapes on the CPU through the plain versions; never prints ok")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="another tree (e.g. the parent commit from git archive): hold B1, "
                         "B2, B3 and B4 bitwise against its kernels and time each in turns")
    args = ap.parse_args()

    if not args.cpu_rehearsal and not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    # cuBLAS reads it at its first call; phase 7 runs under deterministic
    # algorithms, which require it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.cpu_rehearsal and args.parent:
        log("chip_smoke: --parent needs the card")
        return 2
    sys.path.insert(0, ROOT)
    try:
        import mx_rcnn_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port is not here ({e}); run from the repository root")
        return 3
    from mx_rcnn_tpu_torch.ops.cuda import _build

    dev = torch.device("cpu" if args.cpu_rehearsal else "cuda")
    card = "cpu rehearsal" if args.cpu_rehearsal else card_line()
    log(f"[card] {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if not args.cpu_rehearsal:
        t0 = time.perf_counter()
        built = _build.build_all()
        log(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built)} "
            f"(per source: { {k: round(v['seconds'], 2) for k, v in built.items()} })")
        for name, info in built.items():
            for line in info["log"].splitlines():
                if "Used" in line or "spill" in line:
                    log(f"[ptxas:{name}] {line.strip()}")

    kernels = kernel_phase(dev, args.cpu_rehearsal, args.seed)
    kernels.update(backward_phase(dev, args.cpu_rehearsal, args.seed))
    for name, k in kernels.items():
        log(f"[kernel:{name}] {k['shape']}: match={k['match']} max_abs_err={k['max_abs_err']:.3g} "
            f"ms={k['ms']:.4f} kernel_ms={k['kernel_ms']:.4f} plain_ms={k['plain_ms']:.4f} "
            f"bound_ms={k['bound'][0]:.4f} "
            f"({k['bound'][1]})")
    paths = serving_phase(dev, args.cpu_rehearsal, args.seed)
    paths["train"] = train_phase(dev, args.cpu_rehearsal, args.seed)
    paths["eval"] = eval_phase(dev, args.cpu_rehearsal, paths["train"])
    paths["roidb"] = roidb_phase(dev, args.cpu_rehearsal, args.seed)
    steps = {"step": paths["train"]["step_args"], "step_portrait": paths["roidb"]["step_args"]}
    backward_cases_phase(dev, args.cpu_rehearsal, args.seed, steps, kernels)
    forward_cases_phase(dev, args.cpu_rehearsal, args.seed, steps, kernels)
    c4 = c4_phase(dev, args.cpu_rehearsal, args.seed,
                  {k: kernels[k]["extra"]["chunk_step_us"] for k in ("fused_middle", "nms")})
    paths.update(c4["paths"])
    if not args.cpu_rehearsal:
        reference_phase(dev, args.seed)
        train_reference_phase(dev, args.seed)
    parent = parent_phase(dev, args.parent, kernels) if args.parent else {}
    kernels.update(c4["kernels"])

    line = []
    for name, (source, replaces, on) in KERNELS.items():
        k = kernels[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths[p]["launches"][name.split("@")[0]] for p in on),
            "match": k["match"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1],
            "library_ms": None, "shape": k["shape"], **k.get("extra", {}),
        })
    failed = [name for name, k in kernels.items() if not k["match"]]
    failed += [f"{k} differs from the parent's" for k, r in parent.items() if not r["bitwise"]]
    if not args.cpu_rehearsal:
        failed += [f"{k['name']} never launched" for k in line if k["launches"] <= 0]
    log(f"[card] {card}")
    log(json.dumps({"kernels": line}))
    if failed:
        log(f"chip_smoke: FAILED: {failed}")
        return 1
    if args.cpu_rehearsal:
        log("chip_smoke: cpu rehearsal passed (no device result)")
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
