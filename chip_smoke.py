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
   program: B1 + B3), and a runner with ``rpn.nms_impl=pallas`` whose
   ``proposals`` program is reached as the JAX engine reaches it below
   its ladder, through ``runner.run("proposals", ...)`` (B4, one launch a
   request; :func:`proposals_path`).  Each path runs with
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
   ``full`` program: B1 on one level, B3 at L = 1, k = 6000) and a runner
   with ``rpn.nms_impl=pallas`` (its ``proposals`` program through
   ``runner.run``, as in phase 4: B4 on one level, n = 6000), counts set to
   0 before each path and read after, every
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
7d. Fast R-CNN mode and the 4-step alternate schedule
   (:func:`fast_rcnn_phase`), ``vgg16_voc07`` at full width (608x1024,
   batch 1, 6000/2000 proposals in training, 6000/300 in test, 128 rois
   an image), random weights from the seed, on eight VOC-like train and
   eight val records (VOC's image sizes, three portrait, flips on),
   through the port's entry points: (a) ``alternate_cli.main
   --external-proposals``, 3 steps a phase, ``rpn.fused_middle=true``
   (rpn1, a B3 dump, rcnn1 on the pkl with the RPN out of the graph,
   rpn2, a dump, rcnn2, the combined checkpoint, the eval): each phase's
   losses finite, its frozen groups bitwise unchanged and every other
   parameter moved, its step restarted, the Fast R-CNN phases' RPN
   metrics exactly 0; each dump one entry a train record inside its
   image; rcnn1's first ``ext_rois`` bitwise a numpy recompute from the
   pkl; the final checkpoint verified.  (b) The default in-graph
   schedule, 2 phases of 2 steps, the same frozen and finite checks.
   (c) ``vgg_fast_rcnn.sh``: ``eval_cli.main --proposals
   --proposals-split val`` under ``rpn.nms_impl=pallas`` (B4), then
   ``--from-proposals`` (B1), metrics finite, the first batch identical
   in float32 through the kernels and the plain path.  Counts set to 0
   before each path and read after: B1, B2, B3 must launch in (a) and
   (b), B4 and B1 in (c).  (d) B1 (bf16 within one ulp, f32 bitwise) and
   B2 on rcnn1's last step, B3 and B4 on the final RPN's outputs at the
   dump's 6000 candidates, each against its plain version and timed: the
   ``kernels`` line's ``@fast`` entries.  Seconds a step per phase with
   ``data_stall_ms``, the dumps' images a second, peak memory and the
   phase's seconds are printed.  The rehearsal cuts it as 7c.
7e. Mask R-CNN (:func:`mask_phase`), ``mask_r50_fpn_coco`` at full width
   (ResNet-50 + FPN, 800x1344, batch 2, 81 classes, the mask branch
   pooling at 14x14), random weights from the seed: (a) serve: an engine
   with ``serve.fused_middle=on`` at batch 2 (the ``full`` program: B1 at
   7x7 and 14x14, B3), every response with one (h, w) bool mask a
   detection (classes 1-4 favoured), and a runner with
   ``rpn.nms_impl=pallas`` (its ``proposals`` program through
   ``runner.run``, as in phase 4: B4), counts set to 0 before each path
   and read after.  (b) 3 train steps through ``train/loop.py::train`` on the
   synthetic set and its octagon masks, compact RPN loss, mixed policy:
   ``MaskLogLoss`` finite and above 0 in every step, every trainable
   parameter (the mask head's all) moved, the frozen groups bitwise, B1
   and B2 twice a step; seconds a step with ``data_stall_ms`` and peak
   memory printed.  (c) ``run_eval`` on 16 synthetic images: bbox and
   ``segm/*`` metrics finite, the dump rescored equal, the first batch in
   float32 identical in boxes and masks through the kernels and the plain
   path, B1 twice a forward; img/s and the host's paste and RLE time a
   batch printed.  (d)
   B1 at 14x14 on (a)'s detection boxes and on (b)'s last fg prefix
   (bf16 within one ulp, f32 bitwise) and B2 at 14x14 on (b)'s last mask
   cotangent, each against its plain version and timed as in phase 3:
   the ``kernels`` line's ``@mask`` entries.  Phase 7e's launches count
   in B1-B4's entries as well.  The rehearsal cuts it as 7c.
7f. The serving engine's single-card surface (:func:`ladder_phase`),
   ``r50_fpn_coco`` at full width, random weights from the seed (classes
   1-4 favoured), ``build_engine`` with ``serve.fused_middle=on``, batch
   2, buckets 800x1344 and 512x864, ``int8_head`` and ``int8_network``:
   (1) the six levels and 8 programs, warmed, the seconds printed; (2)
   every program through ``runner.run`` on four portrait COCO-sized
   images: responses finite and inside their images, detections from all
   but ``proposals``, at most 25 an image from ``reduced``, class 0 only
   from ``proposals``, B3 and (but for ``proposals``) B1 launched by each
   program's calls; each program's time a call and device time; the q8
   gates: the int8 head's logits and deltas within 0.05 x max|ref| of the
   model's head on the ``full`` call's pooled features (the JAX
   package's test); the served ``full_q8n`` bitwise the ``full`` program
   of a runner on the dequantized int8 weights, and unlike the served
   ``full``; and the JAX test's gate, ``full_q8n``'s mean AP against
   ``full`` at least 0.85, on the float32 network (the bf16 readings and
   their noise floor printed beside it); (3) the ladder: each level's
   estimate warmed by
   requests without a deadline, then a deadline under ``full``'s
   estimate x headroom served at the first level that fits, and one that
   nothing fits at ``proposals``; a runner wrapper failing the
   full-quality program opens the breaker, and the next request is
   ``full_q8``; (4) packing: five requests behind a held call, two to a
   call, bitwise those of one request a call; occupancy printed; (5) the
   weight swap under load to the weights of seed + 1: no failed request,
   generations 0 then 1 in completion order, each result bitwise its
   generation's; the swap's seconds and peak memory; (6) the watchdog: a
   first call behind ``torch.cuda._sleep`` of about 5 s, ``hang_timeout``
   2 s: DEAD within 2 + 0.25 (+ 1) s, the stuck and the queued requests
   ``EngineUnavailable``, ``submit`` refused; (7) tenancy
   (``serve.tenancy.table=a:weight=3,rate=1,burst=2;b:weight=1``): tenant
   a's third request ``QuotaExceeded`` with ``retry_after_s`` > 0, tenant
   b served; (8) B1 (bf16 within one ulp, f32 bitwise) and B3 (bitwise) on
   the 512x864 call's inputs, and B4 (bitwise) on the ``proposals``
   program of a second runner with ``rpn.nms_impl=pallas`` at that
   bucket, each timed as in phase 3: the ``kernels`` line's ``@small``
   entries.  Phase 7f's launches count in B1's, B3's and B4's entries:
   (2)-(7) from after the warm-up, less the reference runs (the
   references of (2), the one-a-call runs that (4) and (5) are held
   against), and B4's on (8)'s ``proposals`` call.  The rehearsal cuts it
   as phase 7c, with buckets 192x256 and 128x160.
7g. The single-card training forms (:func:`forms_phase`), ``r50_fpn_coco``
   at full width (800x1344, batch 2 a microbatch, compact RPN loss, the
   mixed policy, the synthetic set's uint8 images in the loader's
   schedule, random weights from the seed), through
   ``train/loop.py::train``: (1) ``train.accum_steps=2`` for 3 optimizer
   steps, the counts set to 0 before and read after each step: B1 and B2
   twice a step (once a microbatch), finite, every trainable parameter
   moved, frozen ones and buffers bitwise; seconds a step, img/s,
   ``data_stall_ms`` and peak memory printed.  From one state, under
   deterministic algorithms and the float32 policy, one accumulated step
   against one step over the same 4 images on the same draws: parameters
   within 2e-6 + 1e-5 |p| (the JAX package's contract); and
   ``accum_steps=1`` bitwise the plain step after 2 steps.  (2)
   ``backbone.remat`` on against off, one step from one state under
   deterministic algorithms: gradients bitwise equal, the remat step's
   peak memory lower, both printed.  (3) ``backbone.norm`` ``gn`` and
   ``bn``, 3 steps each, checked as (1) (so ``bn``'s running statistics
   and the frozen stages' norm parameters stay bitwise, the others move),
   a save and restore with equal tree CRC; seconds a step and peak memory
   printed.  (4) ``train.steps_per_call=2`` against 1, 4 steps each on
   one loader in runs of 2, deterministic: the loader's schedule and
   bitwise equal parameters.  (5) B1 (bf16 within one ulp, f32 bitwise)
   and B2 on the second microbatch of (1)'s last step, each against its
   plain version and timed as in phase 3: the ``kernels`` line's
   ``@accum`` entries, counted over (1) alone; phase 7g's launches count
   in B1's and B2's entries as well.  The rehearsal cuts it as phase 7c.
7h. Evaluation breadth (:func:`evalx_phase`), ``r50_fpn_coco`` at full
   width (800x1344, batch 8, 1000 proposals, bf16) on phase 5's state,
   saved as a checkpoint with classes 1-4 favoured: (a) three ``eval_cli``
   processes on the card, 64 images in 4 shards of 2 batches: one
   uninterrupted (exit 0); one sent a real SIGTERM once its first shard
   file exists (exit 75, 1-3 shards on disk); that one resumed with
   ``--resume`` (exit 0, the shards on disk untouched): the two dumps
   byte-identical, the printed metrics equal.  (b) ``run_eval`` with
   ``shard_dir`` in this process, counts set to 0 before and read after:
   B1 launched as often as in phase 6's unsharded run; img/s after the
   first shard printed beside phase 6's.  (c) The first run's dump as a
   COCO results file (COCO's sparse category ids) and comp4 files, read
   back and scored, and ``reeval_cli.main``: the reeval equals the first
   run's metrics exactly, each file equals run 1's detections rounded
   its way, within 1e-3 (COCO) and 2e-2 (comp4) of run 1.  (d)
   ``mask_r50_fpn_coco`` (random weights from the seed) evaluated on 16
   images with the native library (it must build; its ``calls`` above
   0) and on the numpy path: dumps byte-identical, metrics equal; paste,
   RLE encode and ``rle_iou`` ms a detection printed for each.  (e)
   ``demo_cli.main`` on an image path (without PIL or matplotlib: a
   refusal naming it before any model is built); the demo's
   ``serve_image`` on a 480x640 image through ``build_engine``, equal to
   ``detect_image``, B1 launched on the request; ``eval_cli --vis 2``
   (without matplotlib: refused before the first batch, naming it; with
   it: 2 PNGs).  B1's launches in (b), (d) and (e) count in its entry.
   The rehearsal runs it on phase 5's tiny state at batch 8 on the CPU.
7i. The training input runtime (:func:`runtime_phase`), ``r50_fpn_coco``
   at full width (800x1344, batch 2, compact RPN loss, the mixed policy,
   random weights from the seed), 6 steps through ``train()`` under
   deterministic algorithms on a COCO directory of real JPEGs written with
   PIL (16 landscape 480x640, 8 portrait 640x480, one file missing, one
   truncated; a quarter of that in the rehearsal), five ways: (a)
   synchronous (``host_depth=0``, no pool, no read-ahead); (b) the default
   in-process path (the pool, ``_Prefetched``, ``device_prefetch``'s
   pinned staging and copy stream); (c) ``data.num_workers=3`` with the
   shm ring and a fresh ``data.cache_dir``; (d) (c) with the cache warm and
   ``MX_RCNN_CHAOS_DATA_SUICIDE`` on batch 2; (e)
   ``MX_RCNN_CHAOS_DATA_WEDGE`` on batch 1 under
   ``MX_RCNN_DATA_WATCHDOG_S=4``, one cache blob's bytes flipped, and
   ``MX_RCNN_CHAOS_SHM_CORRUPT`` on batch 3.  Every run's final parameters
   and momentum bitwise (a)'s; each journal holds the missing and the
   truncated record once each, (e)'s one ``cache_checksum`` and one
   ``shm_checksum`` record besides; B1 and B2 in every step; after each
   ``train()`` no ``host-prefetch``/``loader-prefetch`` thread and no
   child process alive; every worker's hello without CUDA; the shm ring
   carried bytes in (c)-(e).  Seconds a step, ``data_stall_ms`` (phase 5's
   beside (a)'s and (b)'s), peak memory and (e)'s reap seconds printed with
   the card's line.  Then ``run_eval`` on the set at batch 8 with
   ``data.num_workers=2`` and 0: the dumps byte-identical.  B1's and B2's
   launches count as the ``runtime`` paths.
7j. The configured observability plane (:func:`obs_phase`),
   ``r50_fpn_coco`` at full width (800x1344, batch 2, compact RPN loss,
   the mixed policy, random weights from the seed): (a) 10 steps through
   ``train()`` with ``obs.enabled``, ``obs.metrics_port=0``,
   ``obs.flush_s=0.5`` and ``profile_dir`` over steps 2-4, a real SIGTERM
   at the step-4 drain, then the resume to 10 into the same obs directory:
   the journal exactly ``configured``, the step-0 checkpoint, the drain,
   its checkpoint and flight dump, ``configured``, the restore and the
   final checkpoint (plus at least one ``metrics_flush``); one
   ``train_step`` span a step with its ``data`` and ``step`` children;
   one ``flight_preempt_drain_*.json``; two profile traces (steps 2-3,
   stopped by the preemption; step 4, started inside the window on
   resume), each holding B1's and B2's kernels; ``/metrics`` and
   ``/healthz`` scraped over HTTP at step 1 answer 200; B1 and B2 in every
   step.  The five untraced steps that are not first in their run (2 and
   7-10) are printed beside phase 5's steps at the same index in its run.
   (b) The ``full`` engine (B1 + B3, batch 2), warmed by one request of
   each size, serves 4 rounds of 16 requests with spans on and 16 off,
   one at a time, the set that goes first alternating by round (each
   round's p50 difference printed), and a ``proposals``-only engine with
   ``rpn.nms_impl=pallas`` one request with spans on (B4 once): one
   ``engine_request`` span a traced request with its ``queue`` and
   ``device`` children; then ``kill()`` writes one
   ``flight_engine_killed_*.json`` holding every traced request's span.
   (c) ``python -m mx_rcnn_tpu_torch.obs.report`` over (a)'s and (b)'s
   directories exits 0, its timelines holding the preemption and the
   kill.  (d) ``chip_smoke.py --lockcheck-child`` under
   ``MX_RCNN_LOCKCHECK=1`` runs the engine's ladder (each level, a
   deadline nothing fits, a swap under load, the kill, the breaker) with
   the plane and its endpoint on, and 2 train steps through 2 decode
   workers: zero violations, the order graph printed.  Seconds a step
   (beside phase 5's), ms a request p50/p99 with spans on and off, the
   traces' size and the phase's seconds printed with the card's line.
   Launches count as the ``obs_train`` (B1, B2), ``obs_serve`` (B1, B3)
   and ``obs_proposals`` (B4) paths.
7k. The serving fleet and its control loop (:func:`fleet_phase`),
   ``r50_fpn_coco`` at full width (800x1344, 1000 proposals, random weights
   from the seed, classes 1-4 favoured), ``build_fleet`` of 2 replicas on
   the one card with ``serve.fused_middle=on``, one request a call, the
   result cache on, two tenants, on COCO-sized landscape and portrait noise
   requests that never share a cache key: (a) 16 requests routed at once,
   each bitwise a single runner's on the same weights, both replicas
   serving; a second fleet with ``rpn.nms_impl=pallas`` (B4) walks one
   replica's ladder with deadlines under ``full``'s and ``reduced``'s
   estimates down to ``proposals``, bitwise a runner of its config; (b)
   ``kill_replica(1)`` under load: quarantined, rebuilt, READY again, the
   seconds printed, no accepted request failed, the killed engine's worker
   gone and the allocated memory back to its level before the kill; (c)
   replica 0's runner wedged, ``hedge_after="auto"``: the hedge on replica 1
   answers, the delay and the seconds printed; (d) ``swap_weights`` to the
   weights of seed + 1 under load: no failed request, each response bitwise
   its generation's single runner, the roll's seconds printed; (e) one
   image ten times: coalesced followers and cache hits, every answer the
   leader's; (f) ``build_controller`` and a tenant-scoped SLO engine with
   a ``QuotaGovernor``, every 0.2 s: a burst drives ``add_replica`` (a
   third engine on the card) and the quiet after it ``retire_replica`` of
   that one; tenant a's requests with deadlines nothing meets raise the
   availability burn alert and tighten tenant a alone, healthy traffic
   clears it and restores a; (g) ``drain()``, no fleet thread left.  B1 and
   B3 on (a)'s last call and B4 on the second fleet's last ``proposals``
   call held against their plain versions and timed as in phase 3: the
   ``kernels`` line's ``@fleet`` entries.  Then (b)-(f) once more in
   ``chip_smoke.py --fleet-lockcheck-child`` under ``MX_RCNN_LOCKCHECK=1``:
   zero violations.  Launches count as the ``fleet`` (B1, B3: (a) and
   (b)-(f)) and ``fleet_proposals`` (B1, B4) paths.
8. A small input (``tiny_synthetic``, float32, TF32 off): the kernel
   path and the plain torch path on the card must return identical
   detections, the CPU's shown beside them; and one train step through
   the kernels (B1 forward, B2 backward) and through the plain path
   (``roi_align_impl=xla``) gives the same loss and metrics within 1e-6
   relative (B1 is bitwise in f32) and gradients within the CPU parity
   tests' tolerances (backbone 5e-3 by norm, the rest 1e-5 of the largest
   value): B2 and autograd's scatter sum in different orders.  The same
   step again with the mask branch on at 14x14 (B1 and B2 twice), with
   ``MaskLogLoss`` among the metrics.
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
import importlib
import itertools
import json
import os
import subprocess
import sys
import threading
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


def tapped_cells(pyr, rois, s: int, sr: int) -> tuple[int, int]:
    """(cells read, cells in all): the distinct (image, level, y, x) cells
    of ``pyr`` under B1's bilinear taps with a nonzero weight on ``rois``
    at S = ``s``, each roi on its own level, against the pyramid's count.
    Read off the plain backward of a one-channel cotangent of ones: its
    weights are nonnegative, so a cell's sum is nonzero exactly when a
    tap reads it."""
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_plain,
        roi_level_index,
    )

    levels = sorted(pyr)
    shapes = {l: tuple(pyr[l].shape[1:3]) for l in levels}
    ones = torch.ones((*rois.shape[:2], s, s, 1), device=rois.device)
    hits = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois,
                                          roi_level_index(rois, levels), ones, sr)
    return (sum(int(torch.count_nonzero(h)) for h in hits.values()),
            sum(h.numel() for h in hits.values()))


def hold_fwd(pyr, rois, s: int, sr: int, clock, iters: int, plain_iters: int) -> dict:
    """B1 on these inputs against its plain version (within tolerance) and
    two launches bitwise equal; timed, the kernel alone too.  Its bound's
    bytes: the rois, the output and the pyramid cells the taps read
    (:func:`tapped_cells`), each once."""
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_cuda,
        multilevel_roi_align_plain,
    )

    got = multilevel_roi_align_cuda(pyr, rois, s, sr)
    again = multilevel_roi_align_cuda(pyr, rois, s, sr)
    want = multilevel_roi_align_plain(pyr, rois, s, sr)
    deterministic = torch.equal(got, again)
    flops = got.numel() * (sr * sr * 14 + 1)
    read, cells = tapped_cells(pyr, rois, s, sr)
    return dict(
        match=fwd_within_tolerance(got, want) and deterministic, deterministic=deterministic,
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=clock.ms(lambda: multilevel_roi_align_cuda(pyr, rois, s, sr), iters),
        kernel_ms=clock.kernel_ms(lambda: multilevel_roi_align_cuda(pyr, rois, s, sr)),
        plain_ms=clock.ms(lambda: multilevel_roi_align_plain(pyr, rois, s, sr), plain_iters),
        bound=bound(nbytes(rois, got) + read * got.shape[-1] * got.element_size(), flops),
        shape=f"B={rois.shape[0]} R={rois.shape[1]} C={got.shape[-1]} "
              f"{str(got.dtype).split('.')[-1]}, taps read {read / cells:.1%} of the pyramid",
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
    """A batch-2 uint8 train batch of the synthetic set on ``cfg``'s canvas
    (with its gt masks for a mask model)."""
    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
    from mx_rcnn_tpu_torch.data.loader import assemble

    ds = SyntheticDataset(image_hw=tuple(cfg.data.image_size),
                          num_classes=cfg.model.num_classes, seed=seed)
    return assemble([ds.record(0), ds.record(1)], cfg.data, dev,
                    with_masks=cfg.model.mask.enabled)


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
    masks = res.get("masks")
    if masks is not None and (len(masks) != len(boxes) or any(
            m.shape != (height, width) or m.dtype != np.bool_ for m in masks)):
        raise AssertionError(f"masks are not one ({height}, {width}) bool mask a detection")


def serve_path(name, engine, images, counters, timeout) -> dict:
    """Drive one engine over ``images`` with every launch count set to 0
    just before and read just after; returns the path's numbers."""
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = {}
    reqs = [engine.submit(img) for img in images]
    for r in reqs:
        r.add_done_callback(lambda q: done.setdefault(id(q), time.monotonic()))
    results = [r.result(timeout) for r in reqs]
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for img, res in zip(images, results):
        check_response(res, *img.shape[:2])
    lat = [1e3 * (done[id(r)] - r.enqueued_at) for r in reqs]
    counts = [len(r["scores"]) for r in results]
    with_masks = all("masks" in r for r in results)
    log(f"[serve:{name}] {len(images)} requests in {wall:.3f} s = {len(images) / wall:.2f} img/s; "
        f"latency ms per request {[round(x, 1) for x in lat]}; outputs per request {counts}"
        f"{', each with its masks' if with_masks else ''}; launches {launches}")
    return {"launches": launches, "counts": counts, "latency_ms": [round(x, 1) for x in lat],
            "with_masks": with_masks}


def proposals_path(name, dev, base, variables, images, counters) -> dict:
    """The ``proposals`` program with ``rpn.nms_impl=pallas`` (B4, one launch
    a request) at batch 1, reached as the JAX engine reaches it below its
    ladder, through ``runner.run("proposals", ...)`` of a warmed runner, one
    request a call, with every launch count set to 0 just before and read
    just after.  Each response finite, inside its image, class 0."""
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner

    runner = DetectorRunner(apply_overrides(base, ["model.rpn.nms_impl=pallas"]), variables,
                            batch_size=1, device=dev)
    runner.warmup()
    for fn in counters.values():
        fn.launches = 0
    results, lat = [], []
    t0 = time.perf_counter()
    for img in images:
        t = time.perf_counter()
        results += runner.run("proposals", runner.buckets[0], [img])
        lat.append(1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for img, res in zip(images, results):
        check_response(res, *img.shape[:2])
        if (res["classes"] != 0).any():
            raise AssertionError(f"{name}: a proposal of a class other than 0")
    counts = [len(r["scores"]) for r in results]
    log(f"[serve:{name}] {len(images)} requests in {wall:.3f} s = {len(images) / wall:.2f} "
        f"img/s; latency ms per request {[round(x, 1) for x in lat]}; outputs per request "
        f"{counts}; launches {launches}")
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
    images = serve_images(rehearsal, seed)
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

    out["proposals"] = proposals_path("proposals", dev, base, variables, images[:3], counters)
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
def captured_backward(store: list, keep, size=None):
    """Wrap B2's autograd Function: each backward call whose level shapes
    ``keep`` accepts (and whose output size is ``size``, when given) puts
    its inputs, as :func:`hold_bwd` takes them, in ``store[0]`` (the last
    such call wins)."""
    from mx_rcnn_tpu_torch.ops.cuda import roi_align as roi_align_mod

    backward = roi_align_mod.MultilevelRoiAlign.backward

    def capture(ctx, g):
        if keep(ctx.shapes) and size in (None, ctx.output_size):
            rois, level_idx = ctx.saved_tensors[:2]
            store[:] = [(dict(ctx.shapes), ctx.dtype, rois.clone(), level_idx.clone(),
                         g.to(ctx.dtype).contiguous().clone(), ctx.sampling_ratio)]
        return backward(ctx, g)

    roi_align_mod.MultilevelRoiAlign.backward = staticmethod(capture)
    try:
        yield store
    finally:
        roi_align_mod.MultilevelRoiAlign.backward = staticmethod(backward)


def train_overrides(rehearsal: bool, seed: int) -> list[str]:
    """Phase 5's overrides of its preset (``r50_fpn_coco``; the rehearsal's
    ``tiny_synthetic``)."""
    # r50_fpn_coco freezes the stem and stage 1; the tiny rehearsal is
    # given the same freeze so that it has frozen parameters to check.
    overrides = ["model.rpn.loss_impl=compact", f"train.seed={seed}", "data.dataset=synthetic",
                 "train.log_every=1"]
    if rehearsal:
        overrides.append("model.backbone.freeze_stages=2")
    return overrides


def train_phase(dev, rehearsal: bool, seed: int, steps: int = 5) -> dict:
    """Phase 5: r50_fpn_coco trained at full width for ``steps`` steps
    through ``train/loop.py::train``."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config

    cfg = apply_overrides(get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco"),
                          train_overrides(rehearsal, seed))
    # At the rehearsal's 128x128 no sampled anchor or roi reaches P4 or P5,
    # so the biases of those two FPN outputs get no gradient.
    return train_run(dev, rehearsal, cfg, "train", steps, unmoved=2 if rehearsal else 0)


def train_run(dev, rehearsal: bool, cfg, label: str, steps: int, unmoved: int = 0,
              per_step: int = 1, bwd_size=None) -> dict:
    """``cfg`` trained for ``steps`` steps through ``train/loop.py::train``
    with random weights from ``train.seed``; the launch counts are set to
    0 just before and read after every step.  Every loss finite, B1 and B2
    launched ``per_step`` times in every step (on the card), every
    trainable parameter but ``unmoved`` moved, frozen parameters and
    FrozenBN buffers bitwise unchanged.  Returns the launches, the last
    step's B2 inputs (of its call at output size ``bwd_size``, when
    given), the state and ``cfg``."""
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
    live = 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev) / 2**30
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with captured_backward(step_args, lambda shapes: True, bwd_size):
        state = train(cfg, steps=steps, device=dev, variables=variables, log=on_step)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")

    bad = [i for i, (_, m, _) in enumerate(steps_seen)
           if m["nonfinite"] != 0.0 or not finite_line(m)]
    if len(steps_seen) != steps or bad:
        raise AssertionError(f"{label}: {len(steps_seen)} of {steps} steps, non-finite at {bad}")
    if not rehearsal:
        missing = [(i, k) for i, (_, _, per) in enumerate(steps_seen) for k, v in per.items()
                   if v != per_step]
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
        f"a step with the batch assembly, of which data_stall_ms {stall:.2f} (the wait "
        f"past the prefetch buffer); peak memory {peak:.2f} GiB ({peak - live:.2f} above the {live:.2f} "
        f"GiB live before the run); "
        f"loss {steps_seen[0][1]['loss']:.4f} -> {steps_seen[-1][1]['loss']:.4f}; "
        f"frozen {n_frozen} parameters and all buffers unchanged, {moved} of {n_train} "
        f"trainable moved; launches {launches}")
    if not step_args:
        raise AssertionError(f"{label}: the ROIAlign backward was never called")
    return {"launches": launches, "step_args": step_args[0], "state": state, "cfg": cfg,
            "s_per_step": wall, "data_stall_ms": stall, "peak_gib": peak,
            "step_s": [b - a for a, b in zip(times, times[1:])],
            "peak_own_gib": peak - live,
            "lines": [m for _, m, _ in steps_seen]}


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
            assemble = loader._assemble_rows

            def watched(spec):
                out["launches"].append({k: fn.launches for k, fn in counters.items()})
                for fn in counters.values():
                    fn.launches = 0
                out["specs"].append(([int(j) for j in spec[0]], [bool(f) for f in spec[1]]))
                return assemble(spec)

            def on_line(line):
                out["lines"].append((time.perf_counter(), json.loads(line)))
                log(f"[roidb:{name}] {line}")
                log_line(out["lines"][-1][1])

            for fn in counters.values():
                fn.launches = 0
            loader._assemble_rows = watched
            try:
                # The synchronous path (host_depth=0, a loader without pool
                # or read-ahead): each batch is assembled just before its
                # step, so the launches between two assemblies are a step's.
                out["state"] = loop.train(cfg, steps=steps, device=dev, log=on_line,
                                          workdir=os.path.join(work, name), pretrained=pth,
                                          loader=loader, host_depth=0, **kw)
            except Preempted as e:
                out["preempted"] = (e, time.perf_counter())
            finally:
                loader._assemble_rows = assemble
                out["launches"] = out["launches"][1:] + [
                    {k: fn.launches for k, fn in counters.items()}]
            return out

        def loader_for(name):
            return DetectionLoader(roidb, cfg.data, batch, dev, seed=cfg.train.seed,
                                   quarantine_path=os.path.join(work, name, cfg.name,
                                                                "quarantine.jsonl"),
                                   prefetch=False, num_workers=0)

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
def captured(module, names, on_call):
    """Wrap each ``module.<name>`` for the length of the context (its callers
    look it up at each call): after every call, ``on_call(name, arguments,
    result)``, the arguments bound to the signature with defaults applied.
    The wrapper calls the original, so launch counts count as before."""
    import inspect

    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            out = fn(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            on_call(name, bound.arguments, out)
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def detached(x):
    """A detached copy of the tensors in ``x`` (tuples, named tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: detached(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = (detached(v) for v in x)
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def keep_last(store: dict):
    """An ``on_call`` for :func:`captured` that keeps the last call's
    arguments and result of each name, detached copies, in ``store[name]``."""
    def on_call(name, arguments, out):
        store[name] = (detached(tuple(arguments.values())), detached(out))
    return on_call


def captured_postprocess(seen: list):
    """Append to ``seen`` the arguments of every call of either
    postprocess of ``detection/graph.py``."""
    from mx_rcnn_tpu_torch.detection import graph

    return captured(graph, ("_postprocess_one_fused", "_postprocess_one"),
                    lambda name, arguments, out: seen.append(tuple(arguments.values())))


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


def first_batch_reference(dev, cfg, state_dict, roidb, batch: int, label: str,
                          proposals=None):
    """The first eval batch of ``roidb`` through the kernels and through the
    plain versions (``roi_align_impl=xla``), both in float32 from
    ``state_dict``: the detections, and a mask model's masks, must be
    identical (B1 is the one kernel of this path whatever the mode,
    bitwise in float32), and there must be some.  ``proposals``: a
    proposal map whose boxes the batch carries (``--from-proposals``).
    Returns the batch."""
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.data.loader import eval_batches
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.parallel.step import make_eval_step

    first, _ = next(eval_batches(roidb, cfg.data, batch, dev, proposals,
                                 cfg.model.rpn.test_post_nms_top_n))
    dets = {}
    for name, over in (("kernels", []), ("plain", ["model.rcnn.roi_align_impl=xla"])):
        fcfg = apply_overrides(cfg, ["model.precision.policy=float32", *over])
        model = TwoStageDetector(fcfg.model, device=dev)
        model.load_state_dict(state_dict)
        step = make_eval_step((fcfg.data.pixel_mean, fcfg.data.pixel_std))
        dets[name] = [None if x is None else x.cpu() for x in step(model, first)]
        del model
    same = all(a is b if a is None or b is None else torch.equal(a, b)
               for a, b in zip(dets["kernels"], dets["plain"], strict=True))
    masks = dets["kernels"][4] is not None
    log(f"[{label}:reference] first batch, float32: {int(dets['kernels'][3].sum())} detections "
        f"through the kernels, {int(dets['plain'][3].sum())} through the plain path, "
        f"identical={same}{' (boxes and masks)' if masks else ''}")
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
                         "metrics": metrics, "launches": run}

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
    """Phase 8, training: one tiny_synthetic float32 step through the
    kernels and through the plain path, same weights, batch and draws;
    then the same with the mask branch on at the preset's 14x14 pooling
    (B1 and B2 twice a step)."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.detection.graph import Draws, forward_train
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_bwd_cuda
    from mx_rcnn_tpu_torch.weights import init_variables

    for label, extra in (("", []), (":mask", ["model.mask.enabled=true"])):
        base = apply_overrides(get_config("tiny_synthetic"), extra)
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
        want_launches = 2 if base.model.mask.enabled else 1
        log(f"[reference:train{label}] tiny_synthetic f32: loss {km['loss']:.6f} (kernels) vs "
            f"{pm['loss']:.6f} (plain), largest metric difference {metric_err:.3g} (<= 1e-6 "
            f"relative) over {sorted(km)}; worst gradient "
            f"difference {worst:.3g} (backbone by norm <= 5e-3, others by max <= 1e-5); "
            f"B2 launches {kl} vs {pl}")
        if metric_err > 1e-6 or not ok or kl != want_launches or pl != 0 or \
                ("MaskLogLoss" in km) != base.model.mask.enabled:
            raise AssertionError(f"the kernel train step{label} and the plain train step "
                                 "disagree")


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


def captured_pool(store: list, wanted=lambda size, levels: len(levels) == 1):
    """Put the pyramid and rois of the last ROIAlign call of
    ``detection/graph.py`` that ``wanted(pooled_size, levels)`` picks (by
    default the single-level ones) in ``store[0]``, whether B1 read that
    map eight channels a thread (contiguous, C a multiple of 8, 16-byte
    aligned) in ``store[1]``, and the pooled features in ``store[2]``,
    detached copies."""
    from mx_rcnn_tpu_torch.detection import graph

    def on_call(name, a, out):
        levels = {l: f for l, f in a["feats"].items() if l in a["roi_level_set"]}
        if wanted(a["pooled_size"], levels):
            vec = all(f.is_contiguous() and f.shape[-1] % 8 == 0 and f.data_ptr() % 16 == 0
                      for f in levels.values())
            store[:] = [(detached(levels), detached(a["rois"])), vec, detached(out)]

    return captured(graph, ("_pool_rois_impl",), on_call)


def serve_programs(dev, label: str, base, variables, images, counters, capture) -> dict:
    """The ``full`` program with ``serve.fused_middle=on`` at batch 2 over
    ``images`` through the engine (inside the context ``capture``), then the
    ``proposals`` program with ``rpn.nms_impl=pallas`` at batch 1 over the
    first three (:func:`proposals_path`); each path with the counts set to 0
    just before and read just after."""
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.serve.engine import build_engine

    out = {}
    full_cfg = apply_overrides(base, ["serve.fused_middle=on", "serve.batch_size=2"])
    t0 = time.perf_counter()
    with build_engine(full_cfg, variables, device=dev) as engine, capture:
        log(f"[{label}:full] warm-up {time.perf_counter() - t0:.1f} s "
            f"(programs {engine.runner.levels()}, bucket {engine.runner.buckets})")
        out["full"] = serve_path(f"{label}:full", engine, images, counters, 600.0)
    out["proposals"] = proposals_path(f"{label}:proposals", dev, base, variables, images[:3],
                                      counters)
    return out


def serve_images(rehearsal: bool, seed: int, voc: bool = False) -> list:
    """Float32 noise requests at COCO's image sizes (VOC's with ``voc``),
    small on the rehearsal."""
    if rehearsal:
        sizes = [(96, 128), (128, 100), (80, 120)]
    elif voc:
        sizes = [(375, 500), (500, 375), (333, 500), (500, 333), (281, 500)]
    else:
        sizes = [(480, 640), (800, 1333), (600, 1000), (427, 640), (640, 480)]
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 255, (hh, ww, 3)).astype(np.float32) for hh, ww in sizes]


def c4_serve(dev, rehearsal: bool, seed: int, name: str, counters: dict) -> dict:
    """Phase c4 (a): ``name`` at full width through the engine, random
    weights from the seed, classes 1-4 favoured: the ``full`` program with
    ``serve.fused_middle=on`` at batch 2 (B1 on one level, B3 at L = 1),
    then the ``proposals`` program with ``rpn.nms_impl=pallas`` at batch 1
    (B4 on one level) (:func:`serve_programs`); every kernel of a path
    launched (on the card)."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.weights import init_variables

    base = apply_overrides(get_config(name), c4_overrides(rehearsal))
    variables = init_variables(base.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    images = serve_images(rehearsal, seed, voc=name == "vgg16_voc07")
    pooled = []
    out = serve_programs(dev, f"c4:{name}", base, variables, images, counters,
                         captured_pool(pooled))
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


def kernel_entry(cases: dict) -> dict:
    """One kernels-line entry from ``cases`` {case: result}: the first case
    is the headline, the others' numbers are suffixed extras, and it
    matches when every case does."""
    first, *rest = cases
    out = dict(cases[first], match=all(r["match"] for r in cases.values()), extra={})
    for case in rest:
        r = cases[case]
        out["extra"].update({f"{k}_{case}": r[k] for k in
                             ("ms", "kernel_ms", "plain_ms", "max_abs_err")})
        out["extra"][f"bound_ms_{case}"] = r["bound"][0]
    return out


def c4_kernels(dev, rehearsal: bool, seed: int, runs: dict, chunk_us: dict) -> dict:
    """Phase c4 (d): each kernel at the C4 shapes against its plain
    version, timed as in phase 3: B1 on one level on the rois phase (a)
    pooled, bf16 (the path's dtype, within one bf16 ulp) and f32
    (bitwise), for r101_coco (C = 1024) and vgg16_voc07 (C = 512); B2 on
    phase (b)'s last-step inputs; B3 at L = 1 and B4 on one level at the
    serving pre-NMS top-n (6000), both bitwise (:func:`proposal_kernels`).
    ``chunk_us``: phase 3's sweep chunk step of B3 and B4, for their
    sequential floor."""
    from mx_rcnn_tpu_torch.detection.graph import level_anchors

    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
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
    out = {"roi_align@c4": kernel_entry(fwd), "roi_align_bwd@c4": kernel_entry(bwd)}

    # B3 and B4 at the serving pre-NMS top-n of r101_coco's canvas: its C4
    # anchor grid, RPN-like bf16 scores (full of ties) and small deltas.
    cfg = runs["r101_coco"]["train"]["cfg"]
    (h, w), b = cfg.data.image_size, 2
    anchors = level_anchors(cfg.model, {4: torch.empty((1, h >> 4, w >> 4, 1), device=dev)})[4]
    g = torch.Generator().manual_seed(seed + 11)
    scores = torch.sigmoid(0.5 * torch.randn((b, len(anchors)), generator=g)) \
        .to(torch.bfloat16).to(dev)
    deltas = (0.2 * torch.randn((b, len(anchors), 4), generator=g)).to(torch.bfloat16).to(dev)
    image_hw = torch.tensor([[h, w], [h - 176, w - 320]], dtype=torch.float32, device=dev)
    found = proposal_kernels(dev, rehearsal, scores, deltas, anchors, image_hw, cfg.model.rpn,
                             cfg.model.rpn.test_pre_nms_top_n, 1, chunk_us, "c4")
    out.update({f"{k}@c4": v for k, v in found.items()})
    return out


def hold_middle(margs, chunk_us: float, clock, iters: int, plain_iters: int) -> dict:
    """B3 on ``margs`` (stacked anchors, deltas, scores (B, L, k), image_hw,
    min_size, threshold) bitwise against its plain version, timed as in
    phase 3, the kernel alone too; ``chunk_us``: phase 3's sweep chunk step,
    for the sequential floor."""
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels, fused_middle_levels_plain

    got, want = fused_middle_levels(*margs), fused_middle_levels_plain(*margs)
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    b, levels, k = margs[2].shape
    flops = 40 * margs[2].numel() + IOU_FLOPS * greedy_pairs(got[2], torch.isfinite(got[1]))
    return dict(
        match=same, max_abs_err=float((got[0] - want[0]).abs().max()),
        ms=clock.ms(lambda: fused_middle_levels(*margs), iters),
        kernel_ms=clock.kernel_ms(lambda: fused_middle_levels(*margs)),
        plain_ms=clock.ms(lambda: fused_middle_levels_plain(*margs), plain_iters),
        bound=bound(nbytes(*margs[:4], *got), flops),
        extra=dict(chunk_steps=-(-k // 64), sequential_floor_ms=1e-3 * chunk_us * -(-k // 64)),
        shape=f"B={b} L={levels} k={k} (two launches a call)")


def hold_nms(nargs, chunk_us: float, clock, iters: int, plain_iters: int) -> dict:
    """B4 on ``nargs`` (score-sorted boxes (..., n, 4), valid (..., n),
    threshold) bitwise against its plain version, timed as in phase 3."""
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_keep_sorted_cuda, nms_keep_sorted_plain

    k1, k2 = nms_keep_sorted_cuda(*nargs), nms_keep_sorted_plain(*nargs)
    n = nargs[0].shape[-2]
    return dict(
        match=torch.equal(k1, k2), max_abs_err=float(not torch.equal(k1, k2)),
        ms=clock.ms(lambda: nms_keep_sorted_cuda(*nargs), iters),
        kernel_ms=clock.kernel_ms(lambda: nms_keep_sorted_cuda(*nargs)),
        plain_ms=clock.ms(lambda: nms_keep_sorted_plain(*nargs), plain_iters),
        bound=bound(nbytes(nargs[0], nargs[1], k1), IOU_FLOPS * greedy_pairs(k1, nargs[1])),
        extra=dict(chunk_steps=-(-n // 64), sequential_floor_ms=1e-3 * chunk_us * -(-n // 64)),
        shape=f"B={nargs[0].shape[0]} L={nargs[0].shape[1] if nargs[0].dim() == 4 else 1} "
              f"n={n} (one launch)")


def log_proposal_kernels(found: dict, tag: str) -> None:
    for key, r in found.items():
        log(f"[kernel:{key}@{tag}] {r['shape']}: match={r['match']} ms={r['ms']:.4f} "
            f"kernel_ms={r['kernel_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}); {r['extra']['chunk_steps']} "
            f"chunk steps, sequential floor {r['extra']['sequential_floor_ms']:.4f} ms")


def proposal_kernels(dev, rehearsal: bool, scores, deltas, anchors, image_hw, rpn, pre: int,
                     nms_rows: int, chunk_us: dict, tag: str) -> dict:
    """B3 at L = 1 on the batch and B4 on one level for its first
    ``nms_rows`` images, at pre-NMS top-n ``pre`` of one level's RPN
    outputs (scores (B, A), deltas (B, A, 4), anchors (A, 4)), each
    bitwise against its plain version and timed as in phase 3
    (:func:`hold_middle`, :func:`hold_nms`).  ``chunk_us``: phase 3's sweep
    chunk step of B3 and B4, for their sequential floor; ``tag`` names the
    entries in the log."""
    from mx_rcnn_tpu_torch.ops.proposals import _pre_nms_candidates, _topk_candidates

    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    thresh = rpn.nms_threshold
    ts, td, ta = _topk_candidates(scores, deltas, anchors, pre)
    margs = (ta[:, None].float(), td[:, None].float(), ts[:, None].float(), image_hw,
             rpn.min_size, thresh)
    rows = slice(0, nms_rows)
    dense = _pre_nms_candidates(scores[rows], deltas[rows], anchors, image_hw[rows], pre,
                                rpn.min_size)
    order = torch.argsort(-dense[1], dim=-1, stable=True)
    nargs = (torch.gather(dense[0], 1, order[..., None].expand(*order.shape, 4)).contiguous(),
             torch.gather(torch.isfinite(dense[1]), 1, order).contiguous(), thresh)
    out = {"fused_middle": hold_middle(margs, chunk_us["fused_middle"], clock, iters, plain_iters),
           "nms": hold_nms(nargs, chunk_us["nms"], clock, iters, plain_iters)}
    log_proposal_kernels(out, tag)
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


# Phase 7d: Fast R-CNN mode and the 4-step alternate schedule of
# vgg16_voc07 at full width.
FAST_CONFIG = "vgg16_voc07"
# What each phase of the alternate schedule freezes besides VGG's groups
# 1-2, as port parameter-name prefixes.
VGG_FROZEN = ("backbone.group1.", "backbone.group2.")
PHASE_FROZEN = {"rpn1": ("box_head.",), "rcnn1": ("rpn_head.",),
                "rpn2": ("backbone.", "box_head."), "rcnn2": ("backbone.", "rpn_head.")}
RPN_METRICS = ("RPNAcc", "RPNLogLoss", "RPNL1Loss")


def fast_overrides(rehearsal: bool, seed: int) -> list[str]:
    """Phase 7d's settings of ``vgg16_voc07``: the compact RPN loss, a log
    line a step, flips, the seed; the rehearsal's C4 cuts."""
    return ["model.rpn.loss_impl=compact", f"train.seed={seed}", "train.log_every=1",
            "data.flip=true", *c4_overrides(rehearsal)]


def voc_like_records(rehearsal: bool, seed: int, split: str) -> list:
    """Eight uint8 records at VOC's own image sizes, three of them
    portrait (a quarter of each side in the rehearsal), rendered like the
    synthetic set over VOC's 20 classes, ids ``<split><i>``."""
    import dataclasses

    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset

    sizes = [(375, 500), (500, 375), (333, 500), (281, 500), (500, 333), (375, 500),
             (334, 500), (500, 375)]
    out = []
    for i, (h, w) in enumerate(sizes):
        hw = (h // 4, w // 4) if rehearsal else (h, w)
        ds = SyntheticDataset(image_hw=hw, num_classes=21, seed=seed + 7 * (split == "val"))
        out.append(dataclasses.replace(ds.record(i), image_id=f"{split}{i}"))
    return out


@contextlib.contextmanager
def voc_like_roidb(rehearsal: bool, seed: int):
    """Every dataset build (``data/datasets.py::build_dataset``, as
    ``train/loop.py`` and ``cli/eval_cli.py`` look it up) returns the
    VOC-like train or val records by split: no VOC tree is on the card's
    machine, and decoding its JPEGs would need PIL.  Yields the records."""
    import types

    from mx_rcnn_tpu_torch.data import datasets
    from mx_rcnn_tpu_torch.train import loop

    roidbs = {split: voc_like_records(rehearsal, seed, split) for split in ("train", "val")}

    def build(cfg, split=None, train=True):
        split = split or (cfg.train_split if train else cfg.val_split)
        records = roidbs["train" if split == cfg.train_split else "val"]
        return types.SimpleNamespace(roidb=lambda: list(records))

    saved = datasets.build_dataset, loop.build_dataset
    datasets.build_dataset = loop.build_dataset = build
    try:
        yield roidbs
    finally:
        datasets.build_dataset, loop.build_dataset = saved


def check_phase(label: str, phase: str, state, start: dict, lines: list, steps: int,
                external: bool, require_moved: bool) -> tuple[int, int]:
    """One phase of the alternate schedule: ``steps`` log lines counting
    from 1, every number finite and ``nonfinite`` 0, the state's and the
    optimizer's step at ``steps``, the RPN metrics of a Fast R-CNN phase
    exact zeros, the phase's frozen groups (and VGG's groups 1-2) out of
    the optimizer and bitwise equal to ``start``; with ``require_moved``
    every other parameter moved.  Returns (frozen, moved) counts."""
    metrics = [m for _, m in lines]
    bad = [i for i, m in enumerate(metrics) if m["nonfinite"] != 0.0 or not finite_line(m)]
    if [m["step"] for m in metrics] != list(range(1, steps + 1)) or bad or \
            state.step != steps or state.optimizer.step != steps:
        raise AssertionError(f"{label}:{phase}: steps {[m['step'] for m in metrics]}, state "
                             f"{state.step}, optimizer {state.optimizer.step}, non-finite {bad}")
    if external and phase.startswith("rcnn") and any(m[k] != 0.0 for m in metrics
                                                     for k in RPN_METRICS):
        raise AssertionError(f"{label}:{phase}: RPN metrics not zero in Fast R-CNN mode")
    frozen_prefixes = VGG_FROZEN + PHASE_FROZEN[phase]
    wrong, n_frozen, n_moved = [], 0, 0
    for name, p in state.model.named_parameters():
        frozen = name.startswith(frozen_prefixes)
        same = torch.equal(p.detach(), start[name])
        n_frozen += frozen
        n_moved += not same
        if frozen == p.requires_grad or (frozen and not same) or \
                (require_moved and not frozen and same):
            wrong.append(name)
    if wrong:
        raise AssertionError(f"{label}:{phase}: {len(wrong)} parameters frozen or moved against "
                             f"the schedule, e.g. {wrong[:4]}")
    return n_frozen, n_moved


@contextlib.contextmanager
def alternate_spy(dev, label: str, counters: dict, store: dict, require_moved: bool):
    """Watch the alternate schedule through the functions ``alternate_cli``
    looks up at each call: ``train/loop.py``'s ``build_all`` (each phase's
    start parameters and first batch) and ``train`` (its log lines, held
    by :func:`check_phase` with ``require_moved``; rcnn1's last step's B1 and B2 inputs into
    ``store["pool"]`` and ``store["bwd"]``), and ``cli/eval_cli.py``'s
    ``dump_proposals`` (seconds and images into ``store["dumps"]``).
    Prints each phase's seconds a step after the first, ``data_stall_ms``,
    peak memory, total seconds and launches, then deletes its
    checkpoints (a VGG-16 state with momentum is 1.1 GB)."""
    import shutil

    from mx_rcnn_tpu_torch.cli import eval_cli
    from mx_rcnn_tpu_torch.train import loop

    real = {"build_all": loop.build_all, "train": loop.train, "dump": eval_cli.dump_proposals}
    built = []

    def build_all(cfg, *args, **kw):
        model, opt, state, step_fn, global_batch = real["build_all"](cfg, *args, **kw)
        if cfg.name.rsplit("_", 1)[-1] not in PHASE_FROZEN:   # the combined state's build
            return model, opt, state, step_fn, global_batch
        first = []

        def step(state, batch):
            if not first:
                first.append(batch)
            return step_fn(state, batch)

        built.append({"start": {n: p.detach().clone() for n, p in model.named_parameters()},
                      "first": first})
        return model, opt, state, step, global_batch

    def train(cfg, *args, **kw):
        phase = cfg.name.rsplit("_", 1)[1]
        lines = []
        kw["log"] = lambda line: lines.append((time.perf_counter(), json.loads(line)))
        before = {k: fn.launches for k, fn in counters.items()}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if phase == "rcnn1":
                stack.enter_context(captured_pool(store["pool"]))
                stack.enter_context(captured_backward(store["bwd"], lambda shapes: True))
            state = real["train"](cfg, *args, **kw)
        total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else \
            float("nan")
        launches = {k: fn.launches - before[k] for k, fn in counters.items()}
        rec = built[-1]
        external = kw.get("proposals_path") is not None
        n_frozen, n_moved = check_phase(label, phase, state, rec["start"], lines, kw["steps"],
                                        external, require_moved)
        if phase == "rpn1":
            store["rpn1"] = {"start": rec["start"], "state": state}
        elif phase == "rcnn1":
            # The reference's schedule restarts rcnn1 from the initial
            # weights, as rpn1 started; the in-graph one continues rpn1.
            rpn1 = store.pop("rpn1")
            want = rpn1["start"] if external else dict(rpn1["state"].model.named_parameters())
            if not all(torch.equal(rec["start"][n], want[n]) for n in want):
                raise AssertionError(f"{label}:rcnn1 did not start from "
                                     f"{'the initial weights' if external else 'rpn1'}")
        times = [t for t, _ in lines]
        s_step = (times[-1] - times[0]) / max(len(times) - 1, 1)
        stall = float(np.mean([m["data_stall_ms"] for _, m in lines[1:]] or [float("nan")]))
        log(f"[fast:{label}:{phase}] {len(lines)} steps in {total:.2f} s (model build, "
            f"checkpoints and the rendering included); after the first: {s_step:.4f} s a step "
            f"with the batch assembly, data_stall_ms {stall:.2f}; peak memory {peak:.2f} GiB; "
            f"loss {lines[0][1]['loss']:.4f} -> {lines[-1][1]['loss']:.4f}; frozen {n_frozen} "
            f"unchanged, {n_moved} of {len(state.optimizer.names)} trainable moved; external "
            f"proposals {external}; launches "
            f"{launches}")
        store["phases"].append({"phase": phase, "first": rec["first"][0], "lr": lines[0][1]["lr"],
                                "s_per_step": s_step, "data_stall_ms": stall, "peak_gib": peak,
                                "seconds": total})
        rec["start"] = None
        shutil.rmtree(f"{kw['workdir']}/{cfg.name}/ckpt", ignore_errors=True)
        return state

    def dump(cfg, out_path, *args, **kw):
        t0 = time.perf_counter()
        out = real["dump"](cfg, out_path, *args, **kw)
        store["dumps"].append({"path": out_path, "images": len(out),
                               "seconds": time.perf_counter() - t0})
        return out

    loop.build_all, loop.train, eval_cli.dump_proposals = build_all, train, dump
    try:
        yield store
    finally:
        loop.build_all, loop.train, eval_cli.dump_proposals = (
            real["build_all"], real["train"], real["dump"])


def ext_rois_numpy(cfg, rec, proposals: dict, flip: bool, num: int):
    """A record's external rois recomputed in numpy from a proposal map:
    the flip in original coordinates, a stable sort by score, the best
    ``num``, the letterbox scale, clipped to the resized image,
    zero-padded -> (rois (num, 4) float32, valid (num,) bool)."""
    from mx_rcnn_tpu_torch.data.loader import record_scale

    boxes = np.asarray(proposals[rec.image_id]["boxes"], np.float32)
    scores = np.asarray(proposals[rec.image_id]["scores"], np.float32)
    if flip:
        boxes = np.stack([rec.width - 1 - boxes[:, 2], boxes[:, 1], rec.width - 1 - boxes[:, 0],
                          boxes[:, 3]], axis=1)
    scale = record_scale(cfg.data, rec)
    top = boxes[np.argsort(-scores, kind="mergesort")[:num]] * scale
    nh, nw = int(round(rec.height * scale)), int(round(rec.width * scale))
    top[:, 0::2] = np.clip(top[:, 0::2], 0.0, nw - 1.0)
    top[:, 1::2] = np.clip(top[:, 1::2], 0.0, nh - 1.0)
    rois, valid = np.zeros((num, 4), np.float32), np.zeros((num,), bool)
    rois[:len(top)], valid[:len(top)] = top, True
    return rois, valid


def check_dumps(label: str, cfg, dumps: list, records: list) -> None:
    """Each dump holds one entry a record, every box inside its original
    image (the resized image's extent over the scale: a row rounded up in
    the resize reaches a fraction of a pixel past the last one); prints
    each dump's images a second."""
    from mx_rcnn_tpu_torch.data.loader import load_proposals, record_scale

    for d in dumps:
        props = load_proposals(d["path"])
        if sorted(props) != sorted(r.image_id for r in records):
            raise AssertionError(f"{label}: {d['path']} holds {sorted(props)}")
        for rec in records:
            b = props[rec.image_id]["boxes"]
            scale = record_scale(cfg.data, rec)
            w, h = (np.float32(round(n * scale)) / np.float32(scale)
                    for n in (rec.width, rec.height))
            inside = (len(b) > 0 and (b >= 0).all() and (b[:, 2] >= b[:, 0]).all()
                      and (b[:, 3] >= b[:, 1]).all() and (b[:, [0, 2]] <= w).all()
                      and (b[:, [1, 3]] <= h).all())
            if not inside:
                raise AssertionError(f"{label}: {rec.image_id}'s proposals leave its image or "
                                     "are missing")
        n = min(len(p["scores"]) for p in props.values())
        log(f"[fast:{label}:dump] {os.path.basename(d['path'])}: {d['images']} images in "
            f"{d['seconds']:.2f} s, {d['images'] / d['seconds']:.2f} img/s (model build "
            f"included); at least {n} proposals an image, every box inside its image")


def fast_rcnn_phase(dev, rehearsal: bool, seed: int, chunk_us: dict) -> dict:
    """Phase 7d: Fast R-CNN mode and the alternate schedule of
    ``vgg16_voc07`` at full width (608x1024, batch 1, fc6/fc7 4096 wide,
    21 classes, 6000/2000 proposals in training, 6000/300 in test, 128
    rois an image), random weights from the seed, on eight VOC-like train
    and eight val records (:func:`voc_like_roidb`, flips on), through the
    port's entry points:

    (a) ``alternate_cli.main --external-proposals``, 3 steps a phase, B3
    (``rpn.fused_middle``): rpn1, a dump, rcnn1 on its pkl (the RPN out of
    the graph), rpn2, a dump, rcnn2, the final checkpoint and the eval.
    Each phase held by :func:`check_phase`; rcnn1 restarts from the
    initial weights; each dump one entry a train record, inside its
    image; rcnn1's first batch carries exactly :func:`ext_rois_numpy`'s
    rois; the final checkpoint passes its manifest check; metrics finite.
    (b) ``alternate_train``, the default in-graph schedule, 2 phases of 2
    steps, held the same way (rcnn1 continues rpn1; a parameter that no
    update moves in float32 is not required to move).  (c) The
    ``vgg_fast_rcnn.sh`` pipe on (a)'s final checkpoint, restored (classes
    1-4 favoured as in phase 7c, so that there are detections) and saved:
    ``eval_cli.main --proposals --proposals-split val`` under
    ``rpn.nms_impl=pallas`` (B4), then ``--from-proposals`` (B1, metrics
    finite), then its first batch in float32 through the kernels and the
    plain path, identical.  Launch counts set to 0 before each path and
    read after; B1, B2 and B3 must launch in (a) and (b), B4 and B1 in
    (c).  (d) :func:`fast_kernels`: the ``@fast`` entries."""
    import shutil

    from mx_rcnn_tpu_torch.cli import alternate_cli, eval_cli
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader, load_proposals
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )
    from mx_rcnn_tpu_torch.train import checkpoint as ckpt
    from mx_rcnn_tpu_torch.train.loop import build_all

    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda, "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    sets = fast_overrides(rehearsal, seed)
    cfg = apply_overrides(get_config(FAST_CONFIG), sets)
    common = ["--config", FAST_CONFIG, "--device", dev.type, *sum((["--set", o] for o in sets), [])]
    work = os.path.join(ROOT, "runs", f"chip_smoke_fast_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    paths, t_phase = {}, time.perf_counter()

    def run(path: str, need: tuple, fn):
        """``fn()`` with the counts set to 0 just before and read just
        after, added to ``path``'s; each kernel of ``need`` must launch."""
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        total = paths.setdefault(path, {"launches": dict.fromkeys(counters, 0)})["launches"]
        for k, v in got.items():
            total[k] += v
        log(f"[fast:{path}] {wall:.2f} s; launches {got}")
        missing = [k for k in need if got[k] < 1]
        if missing and not rehearsal:
            raise AssertionError(f"fast {path}: kernels not launched: {missing}")
        return out

    try:
        with voc_like_roidb(rehearsal, seed) as roidbs:
            # (a) The reference's schedule.
            alt = {"phases": [], "dumps": [], "pool": [], "bwd": []}
            with alternate_spy(dev, "external", counters, alt, require_moved=True):
                metrics = run("fast_alt", ("roi_align", "roi_align_bwd", "fused_middle"),
                              lambda: alternate_cli.main([
                                  *common, "--workdir", os.path.join(work, "a"),
                                  "--phase-steps", "3", "--external-proposals",
                                  "--set", "model.rpn.fused_middle=true"]))
            log(f"[fast:external] metrics {json.dumps(metrics, sort_keys=True)}")
            if [p["phase"] for p in alt["phases"]] != list(PHASE_FROZEN) or len(alt["dumps"]) != 2:
                raise AssertionError(f"fast external: phases {alt['phases']}, dumps {alt['dumps']}")
            if len({p["lr"] for p in alt["phases"]}) != 1 or not metrics or \
                    not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError("fast external: a phase's schedule did not restart, or "
                                     "the metrics are not finite")
            check_dumps("external", cfg, alt["dumps"], roidbs["train"])
            # rcnn1's first batch against the pkl, recomputed in numpy.
            probe = DetectionLoader(roidbs["train"], cfg.data, cfg.train.per_device_batch, "cpu",
                                    seed=cfg.train.seed)
            idxs, flips = next(probe._local_spec_stream(0))
            props = load_proposals(alt["dumps"][0]["path"])
            num = cfg.model.rpn.train_post_nms_top_n
            want = [ext_rois_numpy(cfg, roidbs["train"][j], props, f, num)
                    for j, f in zip(idxs, flips)]
            first = alt["phases"][1]["first"]
            same = (np.array_equal(first.ext_rois.cpu().numpy(), np.stack([r for r, _ in want]))
                    and np.array_equal(first.ext_valid.cpu().numpy(),
                                       np.stack([v for _, v in want])))
            log(f"[fast:external:rcnn1] first batch (records {idxs}, flips {flips}): ext_rois "
                f"{tuple(first.ext_rois.shape)}, {int(first.ext_valid.sum())} valid, equal to "
                f"the numpy recompute from proposals_rpn1.pkl: {same}")
            if not same:
                raise AssertionError("fast external: rcnn1's ext_rois differ from the pkl's")
            final_dir = os.path.join(work, "a", FAST_CONFIG, "ckpt")
            step = ckpt.latest_step(final_dir)
            verified = ckpt.verify_manifest(final_dir, step)
            log(f"[fast:external] final checkpoint step {step}: manifest {verified}")
            if verified != (True, "ok") or step != 3:
                raise AssertionError("fast external: the final checkpoint does not verify")
            # (c)'s checkpoint: the final one, restored as eval_cli restores
            # it, with classes 1-4 favoured as in phase 7c (three steps leave
            # the head sure of the background) so that there are detections.
            _, _, state, _, _ = build_all(cfg, dev)
            ckpt.restore_checkpoint(final_dir, state)
            with torch.no_grad():
                head = state.model.box_head.cls_score
                head.weight[1:5] = head.weight[0]
                head.bias[1:5] = head.bias[0] + 1.0
            ckpt_c = os.path.join(work, "c", "ckpt")
            ckpt.save_checkpoint(ckpt_c, state)
            shutil.rmtree(os.path.join(work, "a"), ignore_errors=True)

            # (b) The default in-graph schedule, two phases.
            ingraph = {"phases": [], "dumps": [], "pool": [], "bwd": []}
            with alternate_spy(dev, "in_graph", counters, ingraph, require_moved=False):
                run("fast_ingraph", ("roi_align", "roi_align_bwd", "fused_middle"),
                    lambda: alternate_cli.alternate_train(
                        apply_overrides(cfg, ["model.rpn.fused_middle=true"]), phase_steps=2,
                        workdir=os.path.join(work, "b"), num_phases=2, device=dev))
            if [p["phase"] for p in ingraph["phases"]] != ["rpn1", "rcnn1"]:
                raise AssertionError(f"fast in_graph: phases {ingraph['phases']}")
            check_dumps("in_graph", cfg, ingraph["dumps"], roidbs["train"])
            shutil.rmtree(os.path.join(work, "b"), ignore_errors=True)

            # (c) vgg_fast_rcnn.sh on (a)'s final checkpoint.
            pkl = os.path.join(work, "c", "val_proposals.pkl")
            t0 = time.perf_counter()
            run("fast_pipe", ("nms",), lambda: eval_cli.main([
                *common, "--ckpt", ckpt_c, "--proposals", pkl, "--proposals-split", "val",
                "--set", "model.rpn.nms_impl=pallas"]))
            check_dumps("pipe", cfg, [{"path": pkl, "images": len(roidbs["val"]),
                                  "seconds": time.perf_counter() - t0}], roidbs["val"])
            t0 = time.perf_counter()
            scored = run("fast_pipe", ("roi_align",), lambda: eval_cli.main([
                *common, "--ckpt", ckpt_c, "--from-proposals", pkl]))
            n = len(roidbs["val"])
            log(f"[fast:pipe] --from-proposals: {n} images, {n / (time.perf_counter() - t0):.2f} "
                f"img/s end to end (restore included); metrics {json.dumps(scored, sort_keys=True)}")
            if not scored or not all(np.isfinite(v) for v in scored.values()):
                raise AssertionError("fast pipe: non-finite --from-proposals metrics")
            first_batch_reference(dev, cfg, state.model.state_dict(), roidbs["val"],
                                  max(cfg.model.test.per_device_batch, 1), "fast:pipe",
                                  proposals=load_proposals(pkl))
            kernels = fast_kernels(dev, rehearsal, cfg, state.model, alt, roidbs["train"],
                                   chunk_us)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    per_phase = {p["phase"]: round(p["s_per_step"], 4) for p in alt["phases"]}
    log(f"[fast] phase 7d in {time.perf_counter() - t_phase:.2f} s; external schedule seconds "
        f"a step after the first {per_phase}, peak memory "
        f"{max(p['peak_gib'] for p in alt['phases']):.2f} GiB")
    return {"paths": paths, "kernels": kernels}


def fast_kernels(dev, rehearsal: bool, cfg, model, alt: dict, records: list,
                 chunk_us: dict) -> dict:
    """Phase 7d (d): B1 on rcnn1's last step (rois sampled from external
    proposals; bf16 within one ulp, f32 bitwise) and B2 on its backward,
    each against its plain version and timed as in phase 3; B3 and B4 on
    the final state's RPN outputs over the first dump batch of train
    records, at the train pre-NMS top-n (:func:`proposal_kernels`): the
    kernels line's ``@fast`` entries."""
    from mx_rcnn_tpu_torch.data.loader import eval_batches
    from mx_rcnn_tpu_torch.detection.graph import level_anchors, prep_images

    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    (pyr, rois), *_ = alt["pool"]
    fwd = {}
    for dt, case in ((torch.bfloat16, "rcnn1_step"), (torch.float32, "f32_rcnn1_step")):
        res = hold_fwd({l: f.to(dt) for l, f in pyr.items()}, rois, 7, 2, clock, iters,
                       plain_iters)
        if dt == torch.float32:
            res["match"] = res["match"] and res["max_abs_err"] == 0.0
        fwd[case] = res
        log(f"[kernel:roi_align@fast:{case}] {res['shape']} map {tuple(pyr[4].shape[1:3])}: "
            f"match={res['match']} max_abs_err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
            f"kernel_ms={res['kernel_ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={res['bound'][0]:.4f}")
    args = alt["bwd"][0]
    bwd = hold_bwd(args, clock, iters, plain_iters)
    log(f"[kernel:roi_align_bwd@fast:rcnn1_step] {bwd['shape']} map {args[0][4]}: "
        f"match={bwd['match']} max_abs_err={bwd['max_abs_err']:.3g} ms={bwd['ms']:.4f} "
        f"kernel_ms={bwd['kernel_ms']:.4f} plain_ms={bwd['plain_ms']:.4f} "
        f"bound_ms={bwd['bound'][0]:.4f}")
    out = {"roi_align@fast": kernel_entry(fwd),
           "roi_align_bwd@fast": kernel_entry({"rcnn1_step": bwd})}
    batch, _ = next(eval_batches(records, cfg.data, max(cfg.model.test.per_device_batch, 1), dev))
    with torch.inference_mode():
        feats = model.features(prep_images(batch.images, (cfg.data.pixel_mean,
                                                          cfg.data.pixel_std)))
        logits, deltas = model.rpn(feats)[4]
        anchors = level_anchors(cfg.model, feats)[4]
    rpn = cfg.model.rpn
    found = proposal_kernels(dev, rehearsal, torch.sigmoid(logits), deltas, anchors,
                             batch.image_hw, rpn, rpn.train_pre_nms_top_n, logits.shape[0],
                             chunk_us, "fast")
    out.update({f"{k}@fast": v for k, v in found.items()})
    return out


# Phase 7e: Mask R-CNN (mask_r50_fpn_coco) at full width; the mask
# branch pools at 14x14, which only it gives B1 and B2.
MASK_CONFIG = "mask_r50_fpn_coco"


def mask_pool(size: int):
    """The :func:`captured_pool` predicate of the mask branch's calls."""
    return lambda pooled_size, levels: pooled_size == size


def mask_serve(dev, rehearsal: bool, seed: int, counters: dict) -> dict:
    """Phase 7e (a): mask_r50_fpn_coco at full width through the engine at
    batch 2, random weights from the seed, classes 1-4 favoured: the
    ``full`` program with ``serve.fused_middle=on`` (B1 at 7x7 and 14x14,
    B3), then the ``proposals`` program with ``rpn.nms_impl=pallas`` (B4)
    (:func:`serve_programs`); every kernel of a path launched (on the
    card, B1 twice a call), every ``full`` response with one (h, w) bool
    mask a detection."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.weights import init_variables

    base = apply_overrides(get_config(MASK_CONFIG), c4_overrides(rehearsal))
    variables = init_variables(base.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    images = serve_images(rehearsal, seed)
    pooled = []
    out = serve_programs(dev, "mask", base, variables, images, counters,
                         captured_pool(pooled, mask_pool(base.model.mask.pooled_size)))
    if sum(out["full"]["counts"]) == 0 or not out["full"]["with_masks"]:
        raise AssertionError("mask: the full path returned no detections, or no masks")
    calls = -(-len(images) // 2)
    need = {"full": {"roi_align": 2 * calls, "fused_middle": 1}, "proposals": {"nms": 1}}
    missing = [(path, k) for path, ks in need.items() for k, n in ks.items()
               if out[path]["launches"][k] < n]
    if missing and not rehearsal:
        raise AssertionError(f"mask: kernels not launched on (path, kernel) {missing}")
    out["pool"] = pooled[0]
    return out


def mask_eval(dev, rehearsal: bool, trained: dict, counters: dict) -> dict:
    """Phase 7e (c): ``run_eval`` on 16 synthetic images at
    ``test.per_device_batch`` with the trained state (classes 1-4 given
    the background's classifier row plus one, as phase 7c does), the
    counts set to 0 just before and read just after (B1 twice a forward:
    the box and the mask branch);
    bbox and ``segm/*`` metrics finite; the dump, loaded and rescored,
    gives the same dict; the first batch in float32 gives identical boxes
    and masks through the kernels and the plain path.  The host's paste
    and RLE time a batch is read around ``unletterbox_detections``."""
    import shutil

    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import eval_index_specs
    from mx_rcnn_tpu_torch.evalutil.detections import load_detections

    # The module (the package exports the function of the same name).
    pred_eval = importlib.import_module("mx_rcnn_tpu_torch.evalutil.pred_eval")

    cfg, state = trained["cfg"], trained["state"]
    with torch.no_grad():
        head = state.model.box_head.cls_score
        head.weight[1:5] = head.weight[0]
        head.bias[1:5] = head.bias[0] + 1.0
    n, batch = (4 if rehearsal else 16), cfg.model.test.per_device_batch
    work = os.path.join(ROOT, "runs", f"chip_smoke_mask_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    unletterbox, host = pred_eval.unletterbox_detections, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = unletterbox(*args, **kw)
        host.append(time.perf_counter() - t0)
        return out

    try:
        for fn in counters.values():
            fn.launches = 0
        dump = os.path.join(work, "dets.json")
        pred_eval.unletterbox_detections = timed
        t0 = time.perf_counter()
        try:
            metrics = run_eval(cfg, state=state, limit=n, device=dev, dump_path=dump)
        finally:
            pred_eval.unletterbox_detections = unletterbox
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        roidb = build_dataset(cfg.data, train=False).roidb()[:n]
        dumped = load_detections(dump)
        rescored = pred_eval.evaluate_detections(dumped, roidb, cfg.model.num_classes)
        n_dets = sum(len(d["scores"]) for d in dumped.values())
        n_masks = sum(len(d.get("masks", ())) for d in dumped.values())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    segm = {k: v for k, v in metrics.items() if k.startswith("segm/")}
    host_ms = 1e3 * sum(host) * batch / max(len(host), 1)
    log(f"[mask:eval] {n} synthetic images, batch {batch}: {n / wall:.2f} img/s end to end "
        f"({wall:.2f} s, model build and rendering included); host paste and RLE "
        f"{host_ms:.2f} ms a batch; {n_dets} detections, {n_masks} masks; launches {launches}; "
        f"dump rescored equal={rescored == metrics}; metrics {json.dumps(metrics, sort_keys=True)}")
    if not segm or not all(np.isfinite(v) for v in metrics.values()) or rescored != metrics \
            or not n_dets or n_masks != n_dets:
        raise AssertionError("mask eval: no segm metrics, non-finite metrics, no detections, a "
                             "detection without its mask, or the dump rescores apart")
    forwards = len(eval_index_specs(roidb, cfg.data, batch))
    if not rehearsal and launches["roi_align"] != 2 * forwards:
        raise AssertionError(f"mask eval: B1 launched {launches['roi_align']} times, not twice "
                             f"in each of {forwards} forwards (the box and the mask branch)")
    first_batch_reference(dev, cfg, state.model.state_dict(), roidb, batch, "mask:eval")
    return {"launches": launches, "img_s": n / wall, "metrics": metrics, "host_ms": host_ms}


def mask_kernels(dev, rehearsal: bool, serve: dict, trained: dict) -> dict:
    """Phase 7e (d): B1 at 14x14 on (a)'s detection boxes and on (b)'s last
    fg prefix, bf16 (the paths' dtype, within one bf16 ulp) and f32
    (bitwise), and B2 at 14x14 on (b)'s last mask cotangent, each against
    its plain version and timed as in phase 3: the kernels line's
    ``@mask`` entries."""
    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    s = trained["cfg"].model.mask.pooled_size
    fwd = {}
    for case, (pyr, rois) in (("detections", serve["pool"]), ("fg_prefix", trained["pool"])):
        for dt, name in ((torch.bfloat16, case), (torch.float32, f"f32_{case}")):
            res = hold_fwd({l: f.to(dt) for l, f in pyr.items()}, rois, s, 2, clock, iters,
                           plain_iters)
            if dt == torch.float32:    # bitwise in float32
                res["match"] = res["match"] and res["max_abs_err"] == 0.0
            fwd[name] = res
            log(f"[kernel:roi_align@mask:{name}] {res['shape']} S={s}: match={res['match']} "
                f"max_abs_err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
                f"kernel_ms={res['kernel_ms']:.4f} plain_ms={res['plain_ms']:.4f} "
                f"bound_ms={res['bound'][0]:.4f}")
    args = trained["step_args"]
    bwd = hold_bwd(args, clock, iters, plain_iters)
    log(f"[kernel:roi_align_bwd@mask:fg_prefix] {bwd['shape']} S={args[4].shape[2]}: "
        f"match={bwd['match']} max_abs_err={bwd['max_abs_err']:.3g} ms={bwd['ms']:.4f} "
        f"kernel_ms={bwd['kernel_ms']:.4f} plain_ms={bwd['plain_ms']:.4f} "
        f"bound_ms={bwd['bound'][0]:.4f}")
    return {"roi_align@mask": kernel_entry(fwd),
            "roi_align_bwd@mask": kernel_entry({"fg_prefix": bwd})}


def mask_phase(dev, rehearsal: bool, seed: int) -> dict:
    """Phase 7e: mask_r50_fpn_coco at full width, random weights from the
    seed: (a) serve (:func:`mask_serve`), (b) 3 train steps through
    ``train/loop.py::train`` on the synthetic set with its octagon masks
    (800x1344, batch 2, compact RPN loss, mixed policy): ``MaskLogLoss``
    finite and above 0 in every step, every trainable parameter (the mask
    head's all) moved and the frozen groups bitwise, B1 and B2 twice a
    step; (c) evaluate (:func:`mask_eval`); (d) B1 and B2 at 14x14
    (:func:`mask_kernels`).  The rehearsal cuts it as phase 7c.  Returns
    the paths' launches and the kernels' entries."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )

    t_phase = time.perf_counter()
    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda, "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    serve = mask_serve(dev, rehearsal, seed, counters)
    cfg = apply_overrides(get_config(MASK_CONFIG), [
        "model.rpn.loss_impl=compact", f"train.seed={seed}", "data.dataset=synthetic",
        "train.log_every=1", *c4_overrides(rehearsal)])
    pooled = []
    with captured_pool(pooled, mask_pool(cfg.model.mask.pooled_size)):
        # At the rehearsal's 192x256 no sampled roi reaches P5, so the bias
        # of that FPN output gets no gradient.
        trained = train_run(dev, rehearsal, cfg, "mask:train", 3, unmoved=1 if rehearsal else 0,
                            per_step=2, bwd_size=cfg.model.mask.pooled_size)
    trained["pool"] = pooled[0]
    losses = [m["MaskLogLoss"] for m in trained["lines"]]
    log(f"[mask:train] MaskLogLoss a step {[round(x, 4) for x in losses]}")
    if not all(np.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"mask train: MaskLogLoss {losses}")
    evaluated = mask_eval(dev, rehearsal, trained, counters)
    trained["state"] = None
    kernels = mask_kernels(dev, rehearsal, serve, trained)
    paths = {"mask_full": {"launches": serve["full"]["launches"]},
             "mask_proposals": {"launches": serve["proposals"]["launches"]},
             "mask_train": {"launches": trained["launches"]},
             "mask_eval": {"launches": evaluated["launches"]}}
    for p in paths.values():
        p["launches"] = {k: p["launches"].get(k, 0) for k in counters}
    log(f"[mask] phase 7e in {time.perf_counter() - t_phase:.2f} s; serving latency ms per "
        f"request {serve['full']['latency_ms']} (full), {serve['proposals']['latency_ms']} "
        f"(proposals); train {trained['s_per_step']:.4f} s a step after the first, "
        f"data_stall_ms {trained['data_stall_ms']:.2f}, peak memory "
        f"{trained['peak_gib']:.2f} GiB; eval {evaluated['img_s']:.2f} img/s, host paste and "
        f"RLE {evaluated['host_ms']:.2f} ms a batch")
    return {"paths": paths, "kernels": kernels}


# Phase 7g: the single-card training forms on r50_fpn_coco.
FORMS_CONFIG = "r50_fpn_coco"


def forms_cfg(rehearsal: bool, seed: int, *extra: str):
    """``r50_fpn_coco`` as phase 5 trains it (compact RPN loss, the mixed
    policy, batch 2 a microbatch, the synthetic set), cut as phase 7c in
    the rehearsal, with ``extra`` overrides."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config(FORMS_CONFIG), [
        "model.rpn.loss_impl=compact", f"train.seed={seed}", "data.dataset=synthetic",
        "train.log_every=1", *c4_overrides(rehearsal), *extra])


@contextlib.contextmanager
def counted(counters: dict, into: dict):
    """Launch counts set to 0 before the context and added to ``into``
    after."""
    for fn in counters.values():
        fn.launches = 0
    try:
        yield
    finally:
        for k, fn in counters.items():
            into[k] = into.get(k, 0) + fn.launches
            fn.launches = 0


@contextlib.contextmanager
def assembled_specs(seen: list):
    """Append each train batch's ``(indices, flips)`` to ``seen`` as the
    loader assembles it."""
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader

    original = DetectionLoader._assemble_rows

    def spy(self, spec):
        seen.append(([int(j) for j in spec[0]], [bool(f) for f in spec[1]]))
        return original(self, spec)

    DetectionLoader._assemble_rows = spy
    try:
        yield seen
    finally:
        DetectionLoader._assemble_rows = original


def peak_step(dev, cfg, variables, batch):
    """One step of ``cfg`` from ``variables`` through ``build_all``'s step:
    (the state, the gradients it applied, the peak memory above what was
    allocated before the step, in GiB; NaN on the CPU)."""
    from mx_rcnn_tpu_torch.train.loop import build_all

    _, opt, state, step_fn, _ = build_all(cfg, device=dev, variables=variables)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    state, metrics = step_fn(state, batch)
    grads = [None if p.grad is None else p.grad.detach().clone() for p in opt.params]
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30 if cuda else float("nan")
    return state, grads, peak, metrics


def release(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def forms_accum_parity(dev, rehearsal: bool, seed: int, counters: dict, launches: dict) -> dict:
    """(1) From one state, under deterministic algorithms and the float32
    policy: one accumulated step (2 microbatches of 2) against one step
    over the same 4 images, which draws the same anchors and rois image
    for image.  The JAX package's contract: parameters within 2e-6 + 1e-5
    |p| (the same loss when every image meets its sampling quota; the
    gradients sum in another order).  And ``accum_steps=1`` against the
    plain step, 2 steps each: bitwise."""
    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
    from mx_rcnn_tpu_torch.data.loader import assemble
    from mx_rcnn_tpu_torch.parallel.step import make_train_step
    from mx_rcnn_tpu_torch.train.loop import build_all
    from mx_rcnn_tpu_torch.weights import init_variables

    f32 = "model.precision.policy=float32"
    acc_cfg = forms_cfg(rehearsal, seed, f32, "train.accum_steps=2")
    flat_cfg = forms_cfg(rehearsal, seed, f32, "train.per_device_batch=4")
    variables = init_variables(acc_cfg.model, torch.Generator().manual_seed(seed))
    ds = SyntheticDataset(image_hw=tuple(acc_cfg.data.image_size),
                          num_classes=acc_cfg.model.num_classes, seed=seed)
    recs = [ds.record(i) for i in range(4)]
    micro = [assemble(recs[:2], acc_cfg.data, dev), assemble(recs[2:], acc_cfg.data, dev)]
    flat = assemble(recs, acc_cfg.data, dev)
    nondet: list = []
    with deterministic_algorithms(nondet), counted(counters, launches):
        s_acc, _, _, m_acc = peak_step(dev, acc_cfg, variables, micro)
        acc = {n: p.detach().clone() for n, p in s_acc.model.named_parameters()}
        del s_acc
        release(dev)
        s_flat, _, _, m_flat = peak_step(dev, flat_cfg, variables, flat)
        worst, bad = 0.0, []
        for n, p in s_flat.model.named_parameters():
            diff = (acc[n] - p.detach()).abs()
            worst = max(worst, float(diff.max()))
            if not bool((diff <= 2e-6 + 1e-5 * p.detach().abs()).all()):
                bad.append(n)
        del s_flat, acc
        release(dev)
        # accum_steps=1 is the plain step.
        cfg1 = forms_cfg(rehearsal, seed, "train.accum_steps=1")
        mixed = init_variables(cfg1.model, torch.Generator().manual_seed(seed))
        ends = []
        for step_of in (lambda fn: fn,
                        lambda fn: make_train_step((cfg1.data.pixel_mean, cfg1.data.pixel_std),
                                                   cfg1.train.seed)):
            _, _, state, step_fn, _ = build_all(cfg1, device=dev, variables=mixed)
            step_fn = step_of(step_fn)
            for b in micro:
                state, _ = step_fn(state, b)
            ends.append({k: v.clone() for k, v in state.model.state_dict().items()})
            del state
            release(dev)
    plain_same = all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])
    loss_gap = abs(float(m_acc["loss"]) - float(m_flat["loss"]))
    log(f"[forms:accum] one accumulated step (2 x 2) against one step over the 4 images, "
        f"float32, deterministic: parameters max |diff| {worst:.3g}, "
        f"{len(bad)} tensors outside 2e-6 + 1e-5 |p|; loss {float(m_acc['loss']):.6f} vs "
        f"{float(m_flat['loss']):.6f}; accum_steps=1 bitwise the plain step after 2 steps: "
        f"{plain_same}; ops without a deterministic algorithm: {nondet}")
    if bad or not plain_same or not loss_gap <= 1e-4 * abs(float(m_flat["loss"])) + 1e-5:
        raise AssertionError(f"forms accum parity: outside tolerance {bad[:5]}, plain bitwise "
                             f"{plain_same}, loss gap {loss_gap}")
    return {"max_param_diff": worst}


def forms_remat(dev, rehearsal: bool, seed: int, counters: dict, launches: dict) -> dict:
    """(2) ``backbone.remat`` true against false, one step from one state
    and batch under deterministic algorithms: gradients bitwise equal, the
    remat step's peak memory lower; both peaks printed."""
    from mx_rcnn_tpu_torch.weights import init_variables

    cfgs = {False: forms_cfg(rehearsal, seed), True: forms_cfg(rehearsal, seed,
                                                                "model.backbone.remat=true")}
    variables = init_variables(cfgs[False].model, torch.Generator().manual_seed(seed))
    batch = synthetic_batch(cfgs[False], dev, seed)
    out = {}
    nondet: list = []
    with deterministic_algorithms(nondet), counted(counters, launches):
        for remat, cfg in cfgs.items():
            state, grads, peak, _ = peak_step(dev, cfg, variables, batch)
            out[remat] = (grads, peak)
            del state
            release(dev)
    same = all((a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
               for a, b in zip(out[False][0], out[True][0]))
    stored, remat = out[False][1], out[True][1]
    log(f"[forms:remat] one step, deterministic: gradients bitwise equal {same} "
        f"({len(out[False][0])} tensors); peak memory above the state {stored:.3f} GiB stored, "
        f"{remat:.3f} GiB remat, {stored - remat:.3f} GiB less; nondeterministic ops {nondet}")
    if not same or (dev.type == "cuda" and not remat < stored):
        raise AssertionError(f"forms remat: bitwise {same}, peak {remat} vs {stored}")
    return {"peak_gib_stored": stored, "peak_gib_remat": remat}


def forms_norm(dev, rehearsal: bool, seed: int, norm: str, launches: dict) -> dict:
    """(3) ``backbone.norm`` ``norm``, 3 steps through ``train()``
    (:func:`train_run`: finite, every trainable parameter moved, frozen
    ones and every buffer, ``bn``'s running statistics too, bitwise), the
    norm parameters counted; then a save and restore into a fresh state,
    tree CRC equal."""
    import shutil

    from mx_rcnn_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
        state_payload,
        tree_crc,
    )
    from mx_rcnn_tpu_torch.train.loop import build_all
    from mx_rcnn_tpu_torch.weights import init_variables

    cfg = forms_cfg(rehearsal, seed, f"model.backbone.norm={norm}")
    run = train_run(dev, rehearsal, cfg, f"forms:{norm}", 3, unmoved=1 if rehearsal else 0)
    for k, v in run["launches"].items():
        launches[k] = launches.get(k, 0) + v
    state = run["state"]
    start = init_variables(cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    moved = frozen = 0
    for name, p in state.model.named_parameters():
        if name.endswith((".scale", ".bias")) and "bn" in name.rsplit(".", 2)[-2]:
            same = torch.equal(p.detach(), start[name].to(p.device))
            moved += p.requires_grad and not same
            frozen += (not p.requires_grad) and same
    buffers = sorted({n.rsplit(".", 1)[-1] for n, _ in state.model.named_buffers()})
    work = os.path.join(ROOT, "runs", f"chip_smoke_forms_{norm}_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(work, state)
    saved_s = time.perf_counter() - t0
    _, _, fresh, _, _ = build_all(cfg, device=dev)
    restore_checkpoint(work, fresh)
    crc = (tree_crc(state_payload(state)), tree_crc(state_payload(fresh)))
    shutil.rmtree(work, ignore_errors=True)
    log(f"[forms:{norm}] norm scale/bias moved outside the frozen stages {moved}, bitwise "
        f"inside them {frozen}; buffers {buffers} unchanged; checkpoint saved in {saved_s:.2f} "
        f"s, restored tree CRC {crc[1]} == {crc[0]}: {crc[0] == crc[1]}")
    if crc[0] != crc[1] or moved == 0 or frozen == 0:
        raise AssertionError(f"forms {norm}: crc {crc}, moved {moved}, frozen {frozen}")
    return {"s_per_step": run["s_per_step"], "peak_gib": run["peak_own_gib"]}


def forms_steps_per_call(dev, rehearsal: bool, seed: int, counters: dict,
                         launches: dict) -> dict:
    """(4) ``train.steps_per_call`` 2 against 1, 4 steps each through
    ``train()`` under deterministic algorithms, both on one loader in runs
    of 2 (on a non-square canvas the run length orders the batches, as in
    the JAX loader): the loader's schedule (indices and flips) and bitwise
    equal parameters."""
    import itertools

    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader
    from mx_rcnn_tpu_torch.data.roidb import filter_roidb
    from mx_rcnn_tpu_torch.train.loop import train
    from mx_rcnn_tpu_torch.weights import init_variables

    ends, specs, walls = {}, {}, {}
    nondet: list = []
    base = forms_cfg(rehearsal, seed)
    roidb = filter_roidb(build_dataset(base.data, train=True).roidb())
    loader = DetectionLoader(roidb, base.data, base.train.per_device_batch, dev,
                             seed=base.train.seed, run_length=2, prefetch=False, num_workers=0)
    want = [([int(j) for j in idx], [bool(f) for f in fl])
            for idx, fl in itertools.islice(loader._batch_index_specs(), 4)]
    for k in (1, 2):
        cfg = forms_cfg(rehearsal, seed, f"train.steps_per_call={k}", "train.log_every=2")
        variables = init_variables(cfg.model, torch.Generator().manual_seed(seed))
        seen: list = []
        with deterministic_algorithms(nondet), counted(counters, launches), \
                assembled_specs(seen):
            t0 = time.perf_counter()
            state = train(cfg, steps=4, device=dev, variables=variables, log=lambda line: None,
                          loader=loader, host_depth=0)
            walls[k] = time.perf_counter() - t0
        ends[k] = {n: v.clone() for n, v in state.model.state_dict().items()}
        specs[k] = seen
        del state
        release(dev)
    same = all(torch.equal(ends[1][n], ends[2][n]) for n in ends[1])
    log(f"[forms:steps_per_call] 4 steps, K = 2 against K = 1: schedule equal "
        f"{specs[1] == specs[2]} ({len(specs[2])} batches), parameters bitwise {same}; "
        f"{walls[1]:.2f} s and {walls[2]:.2f} s (build and rendering included)")
    if not same or not specs[1] == specs[2] == want:
        raise AssertionError(f"forms steps_per_call: bitwise {same}, schedules {specs}")
    return {}


def forms_kernels(dev, rehearsal: bool, run: dict) -> dict:
    """(5) B1 and B2 on the inputs of the second microbatch of the last
    accumulated step: B2 on its backward's inputs, B1 on its rois over its
    pyramid in bf16 (within one ulp) and f32 (bitwise), each against its
    plain version and timed as in phase 3: the ``@accum`` entries."""
    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    pyr, rois = run["pool"]
    s, sr = run["cfg"].model.rcnn.pooled_size, run["cfg"].model.rcnn.sampling_ratio
    fwd = {}
    for dt, name in ((torch.bfloat16, "microbatch"), (torch.float32, "f32_microbatch")):
        res = hold_fwd({l: f.to(dt) for l, f in pyr.items()}, rois, s, sr, clock, iters,
                       plain_iters)
        if dt == torch.float32:
            res["match"] = res["match"] and res["max_abs_err"] == 0.0
        fwd[name] = res
        log(f"[kernel:roi_align@accum:{name}] {res['shape']}: match={res['match']} "
            f"max_abs_err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
            f"kernel_ms={res['kernel_ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={res['bound'][0]:.4f}")
    bwd = hold_bwd(run["step_args"], clock, iters, plain_iters)
    log(f"[kernel:roi_align_bwd@accum:microbatch] {bwd['shape']}: match={bwd['match']} "
        f"max_abs_err={bwd['max_abs_err']:.3g} ms={bwd['ms']:.4f} "
        f"kernel_ms={bwd['kernel_ms']:.4f} plain_ms={bwd['plain_ms']:.4f} "
        f"bound_ms={bwd['bound'][0]:.4f}")
    return {"roi_align@accum": kernel_entry(fwd),
            "roi_align_bwd@accum": kernel_entry({"microbatch": bwd})}


def forms_phase(dev, rehearsal: bool, seed: int) -> dict:
    """Phase 7g: the single-card training forms of ``r50_fpn_coco`` at full
    width (800x1344, batch 2 a microbatch, compact RPN loss, the mixed
    policy, the synthetic set's uint8 images in the loader's schedule,
    random weights from the seed) through ``train/loop.py``: (1) 3
    accumulated steps of 2 microbatches (:func:`train_run`: B1 and B2
    twice a step, finite, trainable moved, frozen and buffers bitwise;
    seconds a step, img/s, ``data_stall_ms``, peak memory printed) and the
    parity checks of :func:`forms_accum_parity`; (2) remat
    (:func:`forms_remat`); (3) ``gn`` and ``bn`` (:func:`forms_norm`); (4)
    ``steps_per_call`` (:func:`forms_steps_per_call`); (5) the ``@accum``
    kernel entries (:func:`forms_kernels`).  The rehearsal cuts it as
    phase 7c.  Returns the paths' launches and the kernels' entries."""
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )

    t_phase = time.perf_counter()
    counters = {"roi_align": multilevel_roi_align_cuda,
                "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    cfg = forms_cfg(rehearsal, seed, "train.accum_steps=2")
    pooled: list = []
    with captured_pool(pooled, lambda size, levels: len(levels) > 1):
        # At the rehearsal's 192x256 no sampled roi reaches P5, so the bias
        # of that FPN output gets no gradient.
        run = train_run(dev, rehearsal, cfg, "forms:accum", 3, unmoved=1 if rehearsal else 0,
                        per_step=2)
    run["pool"] = pooled[0]
    img_s = [m["img_s"] for m in run["lines"] if m["img_s"] is not None]
    log(f"[forms:accum] accum_steps 2 x batch 2 (global batch 4): {run['s_per_step']:.4f} s "
        f"an optimizer step, {float(np.mean(img_s)):.2f} img/s between drains, data_stall_ms "
        f"{run['data_stall_ms']:.2f}, peak memory {run['peak_own_gib']:.2f} GiB above what was "
        f"live before")
    accum_launches = run["launches"]
    run["state"] = None
    release(dev)
    other: dict = {}
    parity = forms_accum_parity(dev, rehearsal, seed, counters, other)
    remat = forms_remat(dev, rehearsal, seed, counters, other)
    norms = {n: forms_norm(dev, rehearsal, seed, n, other) for n in ("gn", "bn")}
    release(dev)
    forms_steps_per_call(dev, rehearsal, seed, counters, other)
    kernels = forms_kernels(dev, rehearsal, run)
    log(f"[forms] phase 7g in {time.perf_counter() - t_phase:.2f} s; accumulated step "
        f"{run['s_per_step']:.4f} s; peaks above what was live before each run: gn "
        f"{norms['gn']['s_per_step']:.4f} s a step, peak "
        f"{norms['gn']['peak_gib']:.2f} GiB; bn {norms['bn']['s_per_step']:.4f} s, peak "
        f"{norms['bn']['peak_gib']:.2f} GiB; remat peak {remat['peak_gib_remat']:.3f} against "
        f"{remat['peak_gib_stored']:.3f} GiB; accumulation parity max |diff| "
        f"{parity['max_param_diff']:.3g}; launches accum {accum_launches}, other {other}")
    return {"paths": {"forms_accum": {"launches": accum_launches},
                      "forms": {"launches": other}},
            "kernels": kernels}


# Phase 7f: the serving engine's single-card surface on r50_fpn_coco.
LADDER_CONFIG = "r50_fpn_coco"
LADDER_TABLE = "a:weight=3,rate=1,burst=2;b:weight=1"


def ladder_buckets(rehearsal: bool) -> list:
    return [(192, 256), (128, 160)] if rehearsal else [(800, 1344), (512, 864)]


def ladder_images(rehearsal: bool, seed: int) -> list:
    """Four float32 noise requests at portrait COCO sizes, each taller than
    the small bucket, so that its ``full`` plan is the large bucket and its
    ``small`` plan the small one (small on the rehearsal)."""
    sizes = ([(150, 110), (160, 120), (140, 140), (170, 130)] if rehearsal
             else [(640, 480), (640, 427), (612, 612), (640, 512)])
    rng = np.random.RandomState(seed + 7)
    return [rng.uniform(0, 255, (hh, ww, 3)).astype(np.float32) for hh, ww in sizes]


def q8n_map(full: list, q8n: list) -> list:
    """Per-class AP of ``q8n``'s detections scored against ``full``'s as
    ground truth (score > 0.05), over the same images, with the port's
    VOC evaluator: the JAX package's PTQ gate (tests/test_precision.py)."""
    from mx_rcnn_tpu_torch.evalutil.voc_eval import voc_eval

    classes = sorted({int(c) for r in full for c in r["classes"][r["scores"] > 0.05]})
    aps = []
    for c in classes:
        det, gt = {}, {}
        for i, (f, q) in enumerate(zip(full, q8n)):
            mf = (f["scores"] > 0.05) & (f["classes"] == c)
            mq = (q["scores"] > 0.05) & (q["classes"] == c)
            gt[str(i)] = {"boxes": f["boxes"][mf]}
            det[str(i)] = np.concatenate([q["boxes"][mq], q["scores"][mq, None]], axis=1)
        aps.append(float(voc_eval(det, gt)[0]))
    return aps


class _Delegate:
    """A runner that hands every attribute to ``runner``; subclasses
    override ``run`` (the engine's fault and hang injections)."""

    def __init__(self, runner) -> None:
        self.runner = runner

    def __getattr__(self, name):
        return getattr(self.runner, name)


class _FailsFullQuality(_Delegate):
    """Raises on every call of the full-quality program (levels ``full`` and
    ``small``), as a failing device path would."""

    def run(self, mode, bucket, images):
        if mode == "full":
            raise RuntimeError("injected failure of the full-quality program")
        return self.runner.run(mode, bucket, images)


class _FirstCallSleeps(_Delegate):
    """Launches ``torch.cuda._sleep(cycles)`` on the card before its first
    call: a device call that does not return for that long."""

    def __init__(self, runner, cycles: int) -> None:
        super().__init__(runner)
        self.cycles, self.slept = cycles, False

    def run(self, mode, bucket, images):
        if not self.slept:
            self.slept = True
            if self.runner.device.type == "cuda":
                torch.cuda._sleep(self.cycles)
            else:
                time.sleep(self.cycles / 1e9)   # the rehearsal's stand-in
        return self.runner.run(mode, bucket, images)


def sleep_cycles(dev, seconds: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that take about ``seconds`` on this
    card, read from a timed short sleep (1e9 a second on the rehearsal)."""
    if dev.type != "cuda":
        return int(seconds * 1e9)
    probe = 50_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    torch.cuda.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(end))


def same_result(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores", "classes"))


@contextlib.contextmanager
def uncounted(counters: dict):
    """Launches inside the context do not count: the counts are read before
    and set back after (a reference run inside a counted path)."""
    saved = {k: fn.launches for k, fn in counters.items()}
    try:
        yield
    finally:
        for k, fn in counters.items():
            fn.launches = saved[k]


def ladder_phase(dev, rehearsal: bool, seed: int, chunk_us: dict) -> dict:
    """Phase 7f: the serving engine's single-card surface (:func:`ladder_programs`,
    :func:`ladder_engine`), then B1, B3 and B4 at the small bucket
    (:func:`ladder_kernels`).  The ``ladder`` path's launches are counted
    from after the engine's warm-up to the end of :func:`ladder_engine`,
    less the reference runs (:func:`uncounted`).  Returns the paths'
    launches and the kernels' entries."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_cuda
    from mx_rcnn_tpu_torch.serve.engine import build_engine
    from mx_rcnn_tpu_torch.weights import init_variables

    t_phase = time.perf_counter()
    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda}
    cfg = apply_overrides(get_config(LADDER_CONFIG), [
        *c4_overrides(rehearsal), "serve.fused_middle=on", "serve.batch_size=2",
        "serve.tenancy.enabled=true", f"serve.tenancy.table={LADDER_TABLE}"])
    variables = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    t0 = time.perf_counter()
    engine = build_engine(cfg, variables, buckets=ladder_buckets(rehearsal), int8_head=True,
                          int8_network=True, device=dev)
    runner = engine.runner
    engine.start()
    engine.stop()
    warm_s = time.perf_counter() - t0
    levels = runner.levels()
    card = card_line() if dev.type == "cuda" else "cpu rehearsal"
    log(f"[ladder] {card}; {LADDER_CONFIG}, buckets {runner.buckets}, batch "
        f"{runner.batch_size}: levels {levels}; {len(runner._warmed)} programs "
        f"{sorted(runner._warmed)} warmed in {warm_s:.1f} s (build and quantization included)")
    if levels != ("full", "small", "full_q8", "full_q8n", "reduced", "proposals") \
            or len(runner._warmed) != 8:
        raise AssertionError(f"ladder: levels {levels}, {len(runner._warmed)} programs")
    store = {}
    for fn in counters.values():
        fn.launches = 0
    programs = ladder_programs(dev, rehearsal, seed, cfg, variables, runner, store, counters)
    calls = {k: fn.launches for k, fn in counters.items()}
    served = ladder_engine(dev, rehearsal, seed, cfg, runner, counters)
    launches = {k: fn.launches for k, fn in counters.items()}
    requests = {k: launches[k] - calls[k] for k in launches}
    log(f"[ladder] launches: {calls} over the programs' calls, {requests} over the engines' "
        f"requests (warm-ups and reference runs not counted)")
    if not rehearsal and min(requests[k] for k in ("roi_align", "fused_middle")) < 1:
        raise AssertionError(f"ladder: B1 or B3 never launched by the engines ({requests})")
    kernels, prop_launches = ladder_kernels(dev, rehearsal, seed, cfg, variables, store,
                                            counters, chunk_us)
    log(f"[ladder] phase 7f in {time.perf_counter() - t_phase:.2f} s")
    return {"paths": {"ladder": {"launches": launches},
                      "ladder_proposals": {"launches": prop_launches}},
            "kernels": kernels, "programs": programs, "served": served}


class _Levels(_Delegate):
    """Offers only ``only`` of the runner's levels while set: the engine then
    plans every request at one of them (how phase 7f warms each level's
    estimate with requests that have no deadline)."""

    only = None

    def levels(self):
        return self.only or self.runner.levels()


class _Gated(_Delegate):
    """Holds its first call until ``gate`` is set (``entered`` says it is
    held), and records every call's (mode, bucket, image count): requests
    queue behind the held call and pack."""

    def __init__(self, runner) -> None:
        super().__init__(runner)
        self.entered, self.gate, self.calls = threading.Event(), threading.Event(), []

    def run(self, mode, bucket, images):
        if not self.entered.is_set():
            self.entered.set()
            self.gate.wait(600)
        self.calls.append((mode, bucket, len(images)))
        return self.runner.run(mode, bucket, images)


def ladder_programs(dev, rehearsal: bool, seed: int, cfg, variables, runner, store: dict,
                    counters: dict) -> dict:
    """Phase 7f (2): every program through ``runner.run`` on the same four
    images, two to a call: responses finite and inside their images,
    detections from ``full``, ``small``, ``full_q8`` and ``full_q8n``, at
    most ``reduced_max_detections`` an image from ``reduced``, class 0 only
    from ``proposals``; on the card, each program's calls launch B3 and,
    but for ``proposals``, B1.  Each program's time a call (host clock, 2
    images) and device time (traced).  The ``small`` call's ROIAlign and
    fused-middle inputs go to ``store`` for the kernels.  The q8 gates: on
    the pooled features of the ``full`` call, the int8 head's logits and
    deltas within 0.05 x max|ref| of the model's head (the JAX package's
    tests/test_precision.py); ``full_q8n`` by :func:`q8n_references`, whose
    runs are not counted."""
    from mx_rcnn_tpu_torch.ops.cuda import middle as middle_mod
    from mx_rcnn_tpu_torch.serve.quantize import apply_box_head_q8
    from mx_rcnn_tpu_torch.utils.profiling import traced_breakdown

    images = ladder_images(rehearsal, seed)
    small, big = runner.buckets[0], runner.buckets[-1]
    if any(runner.pick_bucket(*img.shape[:2]) != big for img in images):
        raise AssertionError("ladder: a request image fits the small bucket")
    level_of = {("full", big): "full", ("full", small): "small"}
    every = lambda size, levels: True   # noqa: E731
    calls = 2 if rehearsal else 10
    out, times, full_pool = {}, {}, []
    store["pool"] = []
    for mode, bucket in runner._program_keys:
        level = level_of.get((mode, bucket), mode)
        name = f"{level}@{bucket[0]}x{bucket[1]}"
        before = {k: fn.launches for k, fn in counters.items()}
        with contextlib.ExitStack() as stack:
            if (mode, bucket) == ("full", small):
                stack.enter_context(captured_pool(store["pool"], every))
                stack.enter_context(captured(middle_mod, ("_launch", "fused_middle_levels_plain"),
                                             keep_last(store)))
            elif (mode, bucket) == ("full", big):
                stack.enter_context(captured_pool(full_pool, every))
            res = runner.run(mode, bucket, images[:2]) + runner.run(mode, bucket, images[2:])
        ran = {k: fn.launches - before[k] for k, fn in counters.items()}
        for img, r in zip(images, res):
            check_response(r, *img.shape[:2])
        counts = [len(r["scores"]) for r in res]
        if mode == "reduced" and max(counts) > runner.reduced_max_detections:
            raise AssertionError(f"ladder {name}: {counts} detections, over "
                                 f"{runner.reduced_max_detections} an image")
        if mode == "proposals" and any((r["classes"] != 0).any() for r in res):
            raise AssertionError(f"ladder {name}: a proposal of a class other than 0")
        if mode != "proposals" and sum(counts) == 0:
            raise AssertionError(f"ladder {name}: no detections")
        need = ("fused_middle",) if mode == "proposals" else ("roi_align", "fused_middle")
        if not rehearsal and min(ran[k] for k in need) < 1:
            raise AssertionError(f"ladder {name}: {need} not all launched ({ran})")
        t0 = time.perf_counter()
        for _ in range(calls):
            runner.run(mode, bucket, images[:2])
        ms = 1e3 * (time.perf_counter() - t0) / calls
        device_ms = (traced_breakdown(lambda: runner.run(mode, bucket, images[:2]))
                     ["device_ms_per_call"] if dev.type == "cuda" else float("nan"))
        out[name], times[name] = res, {"ms": ms, "device_ms": device_ms}
        log(f"[ladder:{name}] checks passed; outputs per image {counts}; launches over its "
            f"two check calls {ran}; {ms:.2f} ms a call of 2 images (host clock), device "
            f"{device_ms:.2f} ms")

    # The int8 head against the model's own, on the full call's pooled features.
    pooled = full_pool[2]
    s = pooled.shape[-2]
    pooled = pooled.reshape(-1, s, s, pooled.shape[-1])
    live = runner._active
    with torch.inference_mode():
        ref = live.model.box(pooled)
        got = apply_box_head_q8(live.q8, pooled)
    head = [float((g.float() - r.float()).abs().max() / r.float().abs().max())
            for g, r in zip(got, ref)]
    log(f"[ladder:q8] full_q8 head on {pooled.shape[0]} pooled rois: max |err| / max |ref| "
        f"logits {head[0]:.4g}, deltas {head[1]:.4g} (gate 0.05)")
    if not max(head) <= 0.05:
        raise AssertionError(f"ladder q8 head gate: {head}")
    with uncounted(counters):
        maps = q8n_references(dev, cfg, variables, images, out[f"full@{big[0]}x{big[1]}"],
                              out[f"full_q8n@{big[0]}x{big[1]}"], big)
    return {"times": times, "q8_head_err": head, "q8n": maps}


def q8n_references(dev, cfg, variables, images, full: list, q8n: list, bucket) -> dict:
    """The served ``full_q8n`` (bf16) against two references, each a
    runner of its own:

    * the ``full`` program of a runner whose weights are the dequantized
      int8 network (``dequantize_network(quantize_network(...))`` on the
      host): ``full_q8n`` is the production forward on those weights, so
      its detections must be bitwise these, and differ from the served
      ``full``'s;
    * the JAX package's gate (mean AP against ``full`` at least 0.85) as its
      test runs it: on a float32 network (``model.precision.policy=float32``,
      TF32 off), so that the only difference between the two programs is
      the int8 rounding of the weights.  The served bf16 programs' AP and
      the noise floor of that reading (the bf16 ``full`` against the float32
      one) are printed: a random network's detections are near ties, which
      any rounding reorders (the RPN's objectness above all)."""
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner
    from mx_rcnn_tpu_torch.serve.quantize import dequantize_network, quantize_network

    def served(runner, mode):
        runner.warmup()
        return [r for half in (images[:2], images[2:]) for r in runner.run(mode, bucket, half)]

    rounded = DetectorRunner(cfg, dequantize_network(quantize_network(variables)),
                             buckets=[bucket], batch_size=2, with_proposals=False, device=dev)
    ref = served(rounded, "full")
    bitwise = [same_result(a, b) for a, b in zip(q8n, ref)]
    same_as_full = [same_result(a, b) for a, b in zip(q8n, full)]
    del rounded
    f32 = DetectorRunner(apply_overrides(cfg, ["model.precision.policy=float32"]), variables,
                         buckets=[bucket], batch_size=2, int8_network=True,
                         with_proposals=False, device=dev)
    full32, q8n32 = served(f32, "full"), served(f32, "full_q8n")
    maps = {"f32": float(np.mean(q8n_map(full32, q8n32))),
            "bf16": float(np.mean(q8n_map(full, q8n))),
            "bf16_vs_f32": float(np.mean(q8n_map(full32, full))),
            "classes": len(q8n_map(full32, q8n32)),
            "bitwise_rounded_full": bitwise, "same_as_full": same_as_full}
    log(f"[ladder:q8n] served full_q8n bitwise the full program on the dequantized int8 "
        f"weights, per image: {bitwise}; equal to the served full: {same_as_full}; mean AP "
        f"against full, float32 policy {maps['f32']:.4f} (gate 0.85); as served in bf16 "
        f"{maps['bf16']:.4f}, where full in bf16 against full in float32 reads "
        f"{maps['bf16_vs_f32']:.4f}; {maps['classes']} classes over 0.05")
    if not all(bitwise) or all(same_as_full) or not maps["f32"] >= 0.85:
        raise AssertionError(f"ladder q8n gates: {maps}")
    return maps


def ladder_engine(dev, rehearsal: bool, seed: int, cfg, runner, counters: dict) -> dict:
    """Phase 7f (3-7) through engines over the warmed runner: the ladder and
    the breaker, packing, the weight swap under load, the watchdog on a
    stuck device call, tenancy.  The runs of the runner that packing and
    the swap are held against are not counted."""
    import threading

    from mx_rcnn_tpu_torch.serve.degrade import plan_level
    from mx_rcnn_tpu_torch.serve.engine import (
        EngineUnavailable,
        InferenceEngine,
        QuotaExceeded,
        ServeError,
    )
    from mx_rcnn_tpu_torch.serve.tenancy import TenancyPolicy
    from mx_rcnn_tpu_torch.weights import init_variables

    images = ladder_images(rehearsal, seed)
    out = {}

    # (3) The ladder: each level's estimate warmed by requests without a
    # deadline (offered that level alone), best level last, so the planner
    # sits at full; headroom 4, so that a level that fits by its estimate
    # also meets its deadline on a host whose calls vary by a quarter.
    headroom = 4.0
    levels = _Levels(runner)
    eng = InferenceEngine(levels, headroom=headroom, pack=False)
    with eng:
        warm = {}
        for level in reversed(runner.levels()):
            levels.only = (level,)
            got = [eng.infer(img) for img in (*images, *images)]
            if [r["level"] for r in got] != [level] * len(got):
                raise AssertionError(f"ladder: warming {level} served {got}")
            warm[level] = [round(1e3 * r["latency_s"], 2) for r in got]
        levels.only = None
        est = eng.estimates.snapshot()
        log(f"[ladder:plan] warm-up latencies ms, eight requests a level without a deadline: "
            f"{warm}")
        available = list(runner.levels())
        t_full = est["full"] * headroom
        for f in (0.9, 0.8, 0.7, 0.6, 0.5):
            deadline = f * t_full
            want = plan_level(deadline, est, True, available, headroom)
            if want != "full" and want == plan_level(0.95 * deadline, est, True, available,
                                                     headroom):
                break
        fit = eng.submit(images[0], timeout=deadline).result(600)
        nothing = 0.5 * headroom * min(est.values())
        cheapest = eng.submit(images[1], timeout=nothing).result(600)
        stats = eng.stats()
    log(f"[ladder:plan] estimates ms {({k: round(1e3 * v, 2) for k, v in est.items()})}, "
        f"headroom {headroom}: a deadline of {1e3 * deadline:.2f} ms (under full's "
        f"{1e3 * t_full:.2f}) served at {fit['level']} (expected {want}) in "
        f"{1e3 * fit['latency_s']:.2f} ms; {1e3 * nothing:.2f} ms (nothing fits) served at "
        f"{cheapest['level']} in {1e3 * cheapest['latency_s']:.2f} ms; served {stats['served']}")
    if fit["level"] != want or want == "full" or cheapest["level"] != "proposals":
        raise AssertionError(f"ladder: served at {fit['level']} (expected {want}) and "
                             f"{cheapest['level']} (expected proposals)")
    out["plan"] = {"estimates_ms": {k: 1e3 * v for k, v in est.items()},
                   "fit": fit["level"], "nothing_fits": cheapest["level"]}

    # The breaker: the full-quality program fails three times, the breaker
    # opens, and the next request is served at full_q8.
    eng = InferenceEngine(_FailsFullQuality(runner), pack=False)
    with eng:
        errors = []
        for img in images[:3]:
            try:
                eng.infer(img)
                errors.append(None)
            except ServeError as e:
                errors.append(type(e).__name__)
        degraded = eng.infer(images[3])
        stats = eng.stats()
    log(f"[ladder:breaker] full-quality failures {errors}, then served at {degraded['level']}; "
        f"breaker {stats['breaker']}, trips {stats['breaker_trips']}, served {stats['served']}, "
        f"failed {stats['failed']}, state {stats['state']}")
    if errors != ["ServeError"] * 3 or degraded["level"] != "full_q8" \
            or stats["breaker"] != "open" or stats["breaker_trips"] != 1:
        raise AssertionError(f"ladder breaker: {errors}, {degraded['level']}, {stats}")
    out["breaker"] = {k: stats[k] for k in ("breaker", "breaker_trips", "served", "failed")}

    # (4) Packing: five requests queue behind a held call; the packed
    # results, two to a call, bitwise those of one request a call.
    gated = _Gated(runner)
    eng = InferenceEngine(gated)     # pack=True, batch 2
    sent = [images[0], *images]
    with eng:
        reqs = [eng.submit(sent[0])]
        if not gated.entered.wait(600):
            raise AssertionError("ladder pack: the first call never started")
        reqs += [eng.submit(img) for img in sent[1:]]
        gated.gate.set()
        results = [r.result(600) for r in reqs]
        occupancy = eng.stats()["occupancy"]
    sizes = [n for _, _, n in gated.calls]
    with uncounted(counters):
        solo = [runner.run("full", runner.buckets[-1], [img])[0] for img in sent]
    bitwise = all(same_result(r, s) for r, s in zip(results, solo))
    log(f"[ladder:pack] images a call {sizes}; occupancy {occupancy}; packed results bitwise "
        f"equal to one a call: {bitwise}")
    if sizes.count(2) < 2 or not bitwise or not all(r["level"] == "full" for r in results):
        raise AssertionError(f"ladder pack: images a call {sizes}, bitwise {bitwise}")
    out["pack"] = {"occupancy": occupancy, "bitwise": bitwise}

    # (5) The weight swap under load: a client submits without pause while
    # swap_weights flips to the weights of seed + 1.
    new = init_variables(cfg.model, torch.Generator().manual_seed(seed + 1))
    new["box_head.cls_score.bias"][1:5] = 4.0
    old = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    old["box_head.cls_score.bias"][1:5] = 4.0
    after = 16             # requests the client submits once the swap returned
    done, lock, accepted, swapped = [], threading.Lock(), [], threading.Event()
    eng = InferenceEngine(runner, max_queue=16)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def finished(i, req):
        with lock:
            done.append((i, req))

    def client():
        i, last = 0, None
        while i < 4000 and (last is None or i < last):
            while len(accepted) - len(done) >= 8:     # at most 8 waiting
                time.sleep(0.001)
            req = eng.submit(images[i % 4])
            req.add_done_callback(lambda q, i=i: finished(i, q))
            accepted.append((i, req))
            i += 1
            if last is None and swapped.is_set():
                last = i + after

    with eng:
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        limit = time.monotonic() + 600
        while len(done) < 16 and thread.is_alive() and time.monotonic() < limit:
            time.sleep(0.001)
        before = len(done)
        t0 = time.perf_counter()
        gen = eng.swap_weights(new)
        swap_s = time.perf_counter() - t0
        swapped.set()
        thread.join(600)
        for _, req in accepted:
            req.wait(600)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    failed = [i for i, q in done if q.error() is not None]
    gens = [q.result()["generation"] for i, q in done if q.error() is None]
    with uncounted(counters):
        refs = {1: [runner.run("full", runner.buckets[-1], [img])[0] for img in images]}
        runner.swap_weights(old)
        refs[0] = [runner.run("full", runner.buckets[-1], [img])[0] for img in images]
    matches = all(same_result(q.result(), refs[q.result()["generation"]][i % 4])
                  for i, q in done if q.error() is None)
    log(f"[ladder:swap] {len(accepted)} requests under load, swap to generation {gen} in "
        f"{swap_s:.3f} s, begun after {before} were done: failed {failed}; generations in "
        f"completion order {''.join(str(g) for g in gens)}; each bitwise its generation's "
        f"result: {matches}; peak memory {peak:.3f} GiB")
    if failed or len(done) != len(accepted) or gens != sorted(gens) or set(gens) != {0, 1} \
            or not matches:
        raise AssertionError(f"ladder swap: failed {failed}, gens {gens}, matches {matches}")
    out["swap"] = {"seconds": swap_s, "peak_gib": peak, "requests": len(accepted)}

    # (6) The watchdog: the first device call sleeps about 5 s on the card.
    stuck_runner = _FirstCallSleeps(runner, sleep_cycles(dev, 5.0))
    eng = InferenceEngine(stuck_runner, hang_timeout=2.0, watchdog_poll=0.25, pack=False)
    eng.start()
    t0 = time.monotonic()
    stuck = eng.submit(images[0])
    queued = [eng.submit(img) for img in images[1:3]]
    errors = []
    for req in (stuck, *queued):
        try:
            req.result(30)
            errors.append(None)
        except EngineUnavailable:
            errors.append("EngineUnavailable")
    dead_s = time.monotonic() - t0
    stats = eng.stats()
    try:
        eng.submit(images[0])
        refused = False
    except EngineUnavailable:
        refused = True
    if dev.type == "cuda":
        torch.cuda.synchronize()
    eng.stop(timeout=30)
    log(f"[ladder:watchdog] hang_timeout 2 s, poll 0.25 s: {stats['state']} ({stats['reason']}) "
        f"{dead_s:.2f} s after the stuck submit; stuck and queued requests {errors}; submit "
        f"refused: {refused}; hung {stats['hung']}")
    if stats["state"] != "dead" or errors != ["EngineUnavailable"] * 3 or not refused \
            or not 2.0 <= dead_s <= 2.0 + 0.25 + 1.0:
        raise AssertionError(f"ladder watchdog: {stats['state']}, {errors}, {dead_s:.2f} s")
    out["watchdog"] = {"dead_s": dead_s}

    # (7) Tenancy: tenant a's third request within its burst is refused.
    eng = InferenceEngine(runner, tenancy=TenancyPolicy.from_config(cfg.serve.tenancy))
    with eng:
        a = [eng.submit(images[0], tenant="a"), eng.submit(images[1], tenant="a")]
        try:
            eng.submit(images[2], tenant="a")
            quota = None
        except QuotaExceeded as e:
            quota = e.retry_after_s
        b = eng.submit(images[3], tenant="b")
        served = [r.result(600)["level"] for r in (*a, b)]
    log(f"[ladder:tenancy] table {cfg.serve.tenancy.table!r}: tenant a's third request "
        f"QuotaExceeded with retry_after_s {quota}; a, a, b served at {served}")
    if quota is None or not quota > 0 or served != ["full"] * 3:
        raise AssertionError(f"ladder tenancy: retry_after_s {quota}, served {served}")
    return out


def ladder_kernels(dev, rehearsal: bool, seed: int, cfg, variables, store: dict,
                   counters: dict, chunk_us: dict) -> tuple[dict, dict]:
    """Phase 7f (8): B1 (bf16 within one ulp, f32 bitwise) and B3 (bitwise)
    on the inputs of the ``small`` call of (2), at the 512x864 bucket; B4
    (bitwise) on the ``proposals`` program of a second runner with
    ``rpn.nms_impl=pallas`` at that bucket, its launches counted as the
    ``ladder_proposals`` path.  Each timed as in phase 3: the kernels line's
    ``@small`` entries.  Returns them and that path's launches."""
    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.ops.cuda import nms as nms_mod
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner

    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    small = ladder_buckets(rehearsal)[1]
    images = ladder_images(rehearsal, seed)[:2]
    runner = DetectorRunner(apply_overrides(cfg, ["serve.fused_middle=inherit",
                                                  "model.rpn.nms_impl=pallas"]),
                            variables, buckets=[small], batch_size=2, device=dev)
    runner.warmup()
    nms_store = {}
    for fn in counters.values():
        fn.launches = 0
    with captured(nms_mod, ("nms_keep_sorted_cuda",), keep_last(nms_store)):
        res = runner.run("proposals", small, images)
    launches = {k: fn.launches for k, fn in counters.items()}
    for img, r in zip(images, res):
        check_response(r, *img.shape[:2])
    log(f"[ladder:proposals] rpn.nms_impl=pallas at {small}: {[len(r['scores']) for r in res]} "
        f"proposals an image; launches {launches}")
    if not rehearsal and launches["nms"] < 1:
        raise AssertionError(f"ladder: B4 never launched on the proposals program ({launches})")

    (pyr, rois), *_ = store["pool"]
    size = cfg.model.rcnn.pooled_size
    fwd = {}
    for dt, case in ((torch.bfloat16, "small"), (torch.float32, "f32_small")):
        r = hold_fwd({l: f.to(dt) for l, f in pyr.items()}, rois, size,
                     cfg.model.rcnn.sampling_ratio, clock, iters, plain_iters)
        if dt == torch.float32:    # bitwise in float32
            r["match"] = r["match"] and r["max_abs_err"] == 0.0
        fwd[case] = r
        log(f"[kernel:roi_align@small:{case}] {r['shape']} canvas {small}: match={r['match']} "
            f"max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} kernel_ms={r['kernel_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f}")
    middle = store.get("_launch") or store["fused_middle_levels_plain"]
    nargs = nms_store["nms_keep_sorted_cuda"][0]
    found = {"fused_middle": hold_middle(middle[0], chunk_us["fused_middle"], clock, iters,
                                         plain_iters),
             "nms": hold_nms(nargs, chunk_us["nms"], clock, iters, plain_iters)}
    log_proposal_kernels(found, "small")
    return ({"roi_align@small": kernel_entry(fwd), "fused_middle@small": found["fused_middle"],
             "nms@small": found["nms"]}, launches)


# Phase 7h: evaluation breadth on r50_fpn_coco, and Mask R-CNN's host mask
# work on each RLE path.
EVALX_SHARD_SIZE = 2
# COCO 2017's 80 category ids, the sparse ids a COCO results file carries
# (``CocoDataset.label_to_cat`` on COCO's annotation files): the synthetic
# set's ids are dense, and the card's machine cannot decode a COCO image.
COCO_CATEGORY_IDS = (*range(1, 12), *range(13, 26), 27, 28, *range(31, 45), *range(46, 66), 67,
                     70, *range(72, 83), *range(84, 91))


def printed_metrics(stdout: str) -> dict:
    """The ``name = value`` lines a CLI printed."""
    out = {}
    for line in stdout.splitlines():
        name, sep, value = line.partition(" = ")
        if sep and name and " " not in name:
            out[name] = value
    return out


def shard_files(shard_dir: str) -> dict:
    """The shard files under ``shard_dir``: name -> (mtime_ns, bytes)."""
    out = {}
    for name in sorted(os.listdir(shard_dir)) if os.path.isdir(shard_dir) else ():
        if name.startswith("shard-") and name.endswith(".json"):
            path = os.path.join(shard_dir, name)
            with open(path, "rb") as f:
                out[name] = (os.stat(path).st_mtime_ns, f.read())
    return out


def evalx_preempt(work: str, eval_args: list, n: int) -> dict:
    """Phase 7h (a): three ``eval_cli`` processes over the checkpoint,
    ``n`` images in shards of 2 batches: run 1 uninterrupted; run 2, beside
    it, sent a real SIGTERM once its first shard file exists (exit 75, some
    but not all shards on disk); run 3, run 2 again with ``--resume`` (exit
    0, the shards on disk untouched).  The dumps of runs 1 and 3
    byte-identical and their printed metrics equal.  Returns run 1's dump
    path, printed metrics and shard count."""
    import signal

    cmd = [sys.executable, "-m", "mx_rcnn_tpu_torch.cli.eval_cli", *eval_args, "--limit",
           str(n), "--shard-size", str(EVALX_SHARD_SIZE)]
    shards = {k: os.path.join(work, f"S{k}") for k in (1, 2)}
    dumps = {k: os.path.join(work, f"D{k}.json") for k in (1, 2)}
    procs = []

    def start(k, tag, *extra):
        files = [open(os.path.join(work, f"{tag}.{s}"), "w+") for s in ("out", "err")]
        procs.append((subprocess.Popen(
            [*cmd, "--shard-dir", shards[k], "--dump", dumps[k], *extra], cwd=ROOT,
            stdout=files[0], stderr=files[1], text=True), files))
        return len(procs) - 1

    def finish(i, timeout=600):
        p, files = procs[i]
        rc = p.wait(timeout=timeout)
        text = []
        for f in files:
            f.seek(0)
            text.append(f.read())
        return rc, *text

    try:
        t0 = time.perf_counter()
        run1, run2 = start(1, "run1"), start(2, "run2")
        first = os.path.join(shards[2], "shard-00000.json")
        while not os.path.exists(first) and procs[run2][0].poll() is None:
            time.sleep(0.002)
        t_sig = time.perf_counter()
        procs[run2][0].send_signal(signal.SIGTERM)
        rc2, _, err2 = finish(run2)
        t_exit2 = time.perf_counter()
        on_disk = shard_files(shards[2])
        rc1, out1, err1 = finish(run1)
        t1 = time.perf_counter()
        rc3, out3, err3 = finish(start(2, "run3", "--resume"))
        t3 = time.perf_counter()
    finally:
        for p, files in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in files:
                f.close()
    after = shard_files(shards[2])
    with open(os.path.join(shards[1], "manifest.json")) as f:
        num_shards = json.load(f)["num_shards"]
    with open(dumps[1], "rb") as f1, open(dumps[2], "rb") as f2:
        d1, d2 = f1.read(), f2.read()
    m1, m3 = printed_metrics(out1), printed_metrics(out3)
    untouched = {k: after.get(k) for k in on_disk} == on_disk
    log(f"[evalx:preempt] {n} images, {num_shards} shards of {EVALX_SHARD_SIZE} batches: run 1 "
        f"rc={rc1} in {t1 - t0:.2f} s (process start, build and restore included); run 2 "
        f"SIGTERM {t_sig - t0:.2f} s after its start, rc={rc2} {t_exit2 - t_sig:.2f} s later "
        f"with {len(on_disk)} shards on disk {sorted(on_disk)}; run 3 (--resume) rc={rc3} in "
        f"{t3 - t1:.2f} s, {len(after) - len(on_disk)} shards computed, the shards on disk "
        f"untouched={untouched}; dumps byte-identical={d1 == d2} ({len(d1)} bytes); printed "
        f"metrics equal={m1 == m3} {m1}")
    problems = []
    if (rc1, rc2, rc3) != (0, 75, 0):
        problems.append(f"exit codes {rc1}, {rc2}, {rc3} (want 0, 75, 0)")
    if not 1 <= len(on_disk) < num_shards or len(after) != num_shards:
        problems.append(f"{len(on_disk)} shards on disk after the SIGTERM, {len(after)} after "
                        f"the resume, of {num_shards}")
    if not untouched:
        problems.append("the resume rewrote a shard that was on disk")
    if d1 != d2 or not m1 or m1 != m3:
        problems.append(f"dumps byte-identical={d1 == d2}, printed metrics {m1} vs {m3}")
    if problems:
        for name, text in (("run 1", err1), ("run 2", err2), ("run 3", err3)):
            log(f"[evalx:preempt] {name} stderr, last lines:\n{text[-3000:]}")
        raise AssertionError(f"evalx preempt: {problems}")
    return {"dump": dumps[1], "metrics": m1, "num_shards": num_shards}


def evalx_inprocess(dev, cfg, ckpt_dir: str, work: str, n: int, phase6: dict,
                    counters: dict) -> dict:
    """Phase 7h (b): ``run_eval(shard_dir=...)`` in this process on the same
    checkpoint and images, the counts set to 0 just before and read just
    after: B1 launched as often as phase 6's unsharded run of the same
    images in the same ``test.nms_mode``; img/s after the first shard
    printed beside phase 6's after the first batch."""
    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval

    ticks = []
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = run_eval(cfg, ckpt_dir=ckpt_dir, limit=n, device=dev,
                       shard_dir=os.path.join(work, "S_inproc"), shard_size=EVALX_SHARD_SIZE,
                       dump_path=os.path.join(work, "D_inproc.json"),
                       progress=lambda k: ticks.append((time.perf_counter(), k)))
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    (ta, ka), (tb, kb) = ticks[0], ticks[-1]
    img_s = (kb - ka) / (tb - ta) if tb > ta else float("nan")
    mode = cfg.model.test.nms_mode
    ref = phase6[mode]
    log(f"[evalx:sharded] run_eval in this process, {n} images in {len(ticks)} shards: "
        f"{n / wall:.2f} img/s end to end ({wall:.2f} s, restore included), {img_s:.2f} img/s "
        f"after the first shard (shard writes included) against phase 6's "
        f"{ref['img_s_steady']:.2f} img/s after the first batch, unsharded ({mode}); B1 "
        f"launches {launches['roi_align']} (phase 6: {ref['launches']['roi_align']}); metrics "
        f"{json.dumps(metrics, sort_keys=True)}")
    if launches["roi_align"] != ref["launches"]["roi_align"]:
        raise AssertionError(f"evalx sharded: B1 launched {launches['roi_align']} times, phase 6 "
                             f"{ref['launches']['roi_align']}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError("evalx sharded: non-finite metrics")
    return {"launches": launches, "img_s_after_first_shard": img_s, "metrics": metrics}


def evalx_submission(cfg, config_args: list, work: str, run1: dict, n: int) -> None:
    """Phase 7h (c): run 1's dump written as a COCO results file in
    :data:`COCO_CATEGORY_IDS` and as VOC comp4 files, each read back and
    scored, and rescored by ``reeval_cli.main``.  The reeval equals run
    1's metrics exactly.  The files round the detections (COCO: boxes to 2
    decimals, scores to 5; comp4: 1 and 3), so each must score exactly as
    run 1's detections rounded the same way do, and within the JAX
    package's round-trip bounds of run 1's (1e-3, 2e-2)."""
    from mx_rcnn_tpu_torch.cli import reeval_cli
    from mx_rcnn_tpu_torch.cli.common import submission_imageset
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.evalutil import (
        evaluate_detections,
        load_detections,
        read_coco_results,
        read_voc_dets,
        write_coco_results,
        write_voc_dets,
    )

    dataset = build_dataset(cfg.data, train=False)
    roidb = dataset.roidb()
    if len(roidb) != n:   # reeval scores the whole split
        raise AssertionError(f"evalx: {n} images evaluated of a {len(roidb)}-image split")
    per_image = load_detections(run1["dump"])
    k = cfg.model.num_classes
    score = lambda dets: evaluate_detections(dets, roidb, k)  # noqa: E731
    base = score(per_image)
    label_to_cat = dict(enumerate(COCO_CATEGORY_IDS[:k - 1], 1))
    t0 = time.perf_counter()
    n_coco = write_coco_results(os.path.join(work, "results.json"), per_image, label_to_cat)
    coco = score(read_coco_results(os.path.join(work, "results.json"),
                                   {v: c for c, v in label_to_cat.items()}))
    imageset = submission_imageset(cfg)
    paths = write_voc_dets(os.path.join(work, "voc"), per_image, dataset.classes, imageset)
    voc = score(read_voc_dets(os.path.join(work, "voc"), dataset.classes, imageset))
    t_files = time.perf_counter() - t0

    def rounded(d: dict, coco_style: bool) -> dict:
        """The detections as the file carries them, read back."""
        boxes, scores = [], []
        for (x1, y1, x2, y2), s in zip(np.asarray(d["boxes"], np.float64).tolist(),
                                       np.asarray(d["scores"], np.float64).tolist()):
            if coco_style:
                x, y, w, h = (round(v, 2) for v in (x1, y1, x2 - x1 + 1, y2 - y1 + 1))
                boxes.append([x, y, x + w - 1, y + h - 1])
                scores.append(round(s, 5))
            else:
                boxes.append([float(f"{v + 1:.1f}") - 1 for v in (x1, y1, x2, y2)])
                scores.append(float(f"{s:.3f}"))
        return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                "scores": np.asarray(scores, np.float32), "classes": d["classes"]}

    named = len(dataset.classes)   # comp4 files exist for the named classes only
    want_coco = score({i: rounded(d, True) for i, d in per_image.items()})
    want_voc = score({i: rounded({f: v[d["classes"] < named] for f, v in d.items()}, False)
                      for i, d in per_image.items()})
    t0 = time.perf_counter()
    reeval = reeval_cli.main([run1["dump"], *config_args])
    t_reeval = time.perf_counter() - t0
    shown = {name: f"{v:.4f}" for name, v in base.items()}
    worst = {name: max(abs(coco[m] - base[m]) for m in base) if name == "coco" else
             max(abs(voc[m] - base[m]) for m in base) for name in ("coco", "voc")}
    log(f"[evalx:submission] COCO results {n_coco} entries in COCO's category ids, "
        f"{len(paths)} comp4 files, written and read back in {t_files:.2f} s; reeval "
        f"{t_reeval:.2f} s; run 1's dump rescored = run 1's printed metrics: "
        f"{shown == run1['metrics']}; reeval = run 1: {reeval == base}; COCO file = its "
        f"rounding: {coco == want_coco}, off run 1 by at most {worst['coco']:.3g}; comp4 = its "
        f"rounding: {voc == want_voc}, off run 1 by at most {worst['voc']:.3g}")
    if shown != run1["metrics"] or reeval != base or coco != want_coco or voc != want_voc \
            or worst["coco"] > 1e-3 or worst["voc"] > 2e-2:
        raise AssertionError("evalx submission: a file or the reeval does not rescore as it "
                             "must")


def evalx_mask(dev, rehearsal: bool, seed: int, work: str, counters: dict) -> dict:
    """Phase 7h (d): ``mask_r50_fpn_coco`` at full width, random weights
    from the seed with classes 1-4 favoured, evaluated on 16 synthetic
    images twice through ``run_eval``: with the native library (required
    to build; its ``calls`` above 0), then on the numpy path (the
    library's loader patched to fail, as ``mask_eval`` patches).  The dumps
    byte-identical and the metrics equal; paste, RLE encode and
    ``rle_iou`` timed apart, in ms a detection, on each path.  B1's
    launches of the native run are counted."""
    from mx_rcnn_tpu_torch import native
    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.evalutil import coco_eval, postprocess
    from mx_rcnn_tpu_torch.native import lib
    from mx_rcnn_tpu_torch.train.loop import build_all
    from mx_rcnn_tpu_torch.weights import init_variables

    t0 = time.perf_counter()
    built = native.available()
    t_build = time.perf_counter() - t0
    if not built:
        raise AssertionError("evalx mask: the native library did not build or load")
    cfg = apply_overrides(get_config(MASK_CONFIG), ["data.dataset=synthetic",
                                                    *c4_overrides(rehearsal)])
    variables = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    state = build_all(cfg, dev, variables)[2]
    n = 4 if rehearsal else 16
    spans = {"paste": (postprocess, "paste_mask"), "rle_encode": (postprocess, "rle_encode"),
             "rle_iou": (coco_eval, "rle_iou")}
    runs = {}
    for path in ("native", "numpy"):
        took = {k: 0.0 for k in spans}
        originals = {k: getattr(mod, name) for k, (mod, name) in spans.items()}

        def timed(key, fn):
            def call(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    took[key] += time.perf_counter() - t
            return call

        calls = (lib.rle_encode_native.calls, lib.rle_iou_native.calls)
        load = lib._load
        for fn in counters.values():
            fn.launches = 0
        dump = os.path.join(work, f"mask_{path}.json")
        try:
            for k, (mod, name) in spans.items():
                setattr(mod, name, timed(k, originals[k]))
            if path == "numpy":
                lib._load = lambda: None
            t = time.perf_counter()
            metrics = run_eval(cfg, state=state, limit=n, device=dev, dump_path=dump)
            wall = time.perf_counter() - t
        finally:
            lib._load = load
            for k, (mod, name) in spans.items():
                setattr(mod, name, originals[k])
        with open(dump, "rb") as f:
            raw = f.read()
        n_dets = sum(len(d["scores"]) for d in json.loads(raw).values())
        runs[path] = {"metrics": metrics, "raw": raw, "wall": wall, "n_dets": n_dets,
                      "ms_a_det": {k: 1e3 * v / max(n_dets, 1) for k, v in took.items()},
                      "calls": (lib.rle_encode_native.calls - calls[0],
                                lib.rle_iou_native.calls - calls[1]),
                      "launches": {k: fn.launches for k, fn in counters.items()}}
    a, b = runs["native"], runs["numpy"]
    same = a["raw"] == b["raw"]
    segm = {k: v for k, v in a["metrics"].items() if k.startswith("segm/")}
    for path, r in runs.items():
        ms = {k: round(v, 4) for k, v in r["ms_a_det"].items()}
        log(f"[evalx:mask:{path}] {n} synthetic images, {r['n_dets']} detections: "
            f"{n / r['wall']:.2f} img/s end to end ({r['wall']:.2f} s); ms a detection {ms}; "
            f"native calls (rle_encode, rle_iou) {r['calls']}; launches {r['launches']}")
    log(f"[evalx:mask] native library built and loaded in {t_build:.2f} s; dumps "
        f"byte-identical={same}; metrics equal={a['metrics'] == b['metrics']}; segm "
        f"{json.dumps(segm, sort_keys=True)}")
    if not same or a["metrics"] != b["metrics"] or not segm or not a["n_dets"] \
            or min(a["calls"]) < 1 or max(b["calls"]) > 0:
        raise AssertionError("evalx mask: the native and numpy paths disagree, or the native "
                             "library was not called")
    if not rehearsal and a["launches"]["roi_align"] < 1:
        raise AssertionError("evalx mask: B1 never launched")
    return {"launches": a["launches"], "ms_a_det": {p: r["ms_a_det"] for p, r in runs.items()}}


def evalx_demo(dev, rehearsal: bool, seed: int, cfg, config_args: list, eval_args: list,
               work: str, counters: dict) -> dict:
    """Phase 7h (e): ``demo_cli.main`` on an image path (without PIL: a
    ``SystemExit`` naming PIL before any model is built; without
    matplotlib: one naming matplotlib; with both, it runs); the demo's
    array function ``serve_image`` on a synthetic 480x640 uint8 image
    through ``build_engine`` at full width (random weights from the seed,
    classes 1-4 favoured), the counts set to 0 before and read after, less
    the engine's warm-up: B1 launched, the detections equal to
    ``detect_image``'s; ``eval_cli --vis 2`` (without matplotlib: refused
    before the first batch, naming it; with it: 2 PNGs)."""
    from mx_rcnn_tpu_torch.cli import demo_cli, eval_cli
    from mx_rcnn_tpu_torch.serve import engine as engine_mod
    from mx_rcnn_tpu_torch.weights import init_variables

    have = {}
    for pkg in ("PIL", "matplotlib"):
        try:
            importlib.import_module(pkg)
            have[pkg] = True
        except ImportError:
            have[pkg] = False
    missing = next((p for p in ("PIL", "matplotlib") if not have[p]), None)
    h, w = (48, 64) if rehearsal else (480, 640)
    image = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    path = os.path.join(work, "demo.png")
    if have["PIL"]:
        from PIL import Image

        Image.fromarray(image).save(path)
    else:
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n not decodable without PIL")
    served_calls = []
    serve = demo_cli.serve_image

    def watched(*args, **kw):
        served_calls.append(1)
        return serve(*args, **kw)

    drawn = os.path.join(work, "demo_det.png")
    argv = [path, *config_args, "--random-params", "--out", drawn]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    refusal = None
    demo_cli.serve_image = watched
    try:
        try:
            demo_cli.main(argv)
        except SystemExit as e:
            refusal = str(e)
    finally:
        demo_cli.serve_image = serve
    log(f"[evalx:demo] PIL {have['PIL']}, matplotlib {have['matplotlib']}: demo_cli.main "
        f"{'refused: ' + refusal if refusal else 'ran'}; models built {len(served_calls)}")
    if missing is not None and (refusal is None or missing not in refusal or served_calls):
        raise AssertionError(f"evalx demo: without {missing} the demo did not refuse before "
                             f"building a model ({refusal!r}, {len(served_calls)})")
    if missing is None and (refusal is not None or not os.path.exists(drawn)):
        raise AssertionError(f"evalx demo: the demo failed ({refusal!r})")

    variables = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    warm = {"launches": 0}
    warmup = engine_mod.DetectorRunner.warmup

    def counted_warmup(runner):
        before = counters["roi_align"].launches
        try:
            return warmup(runner)
        finally:
            warm["launches"] += counters["roi_align"].launches - before

    for fn in counters.values():
        fn.launches = 0
    engine_mod.DetectorRunner.warmup = counted_warmup
    try:
        t0 = time.perf_counter()
        served = demo_cli.serve_image(cfg, variables, image, device=dev)
        wall = time.perf_counter() - t0
    finally:
        engine_mod.DetectorRunner.warmup = warmup
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["roi_align"] -= warm["launches"]
    direct = demo_cli.detect_image(cfg, variables, image, device=dev)
    same = all(np.array_equal(served[k], v) for k, v in zip(("boxes", "scores", "classes"),
                                                          direct[:3]))
    log(f"[evalx:demo] serve_image {h}x{w} through build_engine in {wall:.2f} s (engine start and "
        f"warm-up included), level {served['level']}, {len(served['scores'])} detections; "
        f"equal to detect_image's={same}; B1 launches on the request {launches['roi_align']} "
        f"(warm-up's {warm['launches']} not counted)")
    if not same or not len(served["scores"]):
        raise AssertionError("evalx demo: the served detections differ from detect_image's, or "
                             "there are none")
    if not rehearsal and launches["roi_align"] < 1:
        raise AssertionError("evalx demo: B1 never launched on the request")

    vis_refusal, pngs = None, []
    load = eval_cli._eval_loader

    def no_batch(*args, **kw):
        raise AssertionError("the eval loader was built despite --vis without matplotlib")

    if not have["matplotlib"]:
        eval_cli._eval_loader = no_batch
    try:
        eval_cli.main([*eval_args, "--limit", "4", "--vis", "2"])
    except RuntimeError as e:
        vis_refusal = str(e)
    finally:
        eval_cli._eval_loader = load
    vis_dir = os.path.join(work, "evalx", cfg.name, "vis")
    if os.path.isdir(vis_dir):
        pngs = sorted(os.listdir(vis_dir))
    log(f"[evalx:vis] eval_cli --vis 2: {'refused: ' + vis_refusal if vis_refusal else 'ran'}; "
        f"PNGs {pngs}")
    if have["matplotlib"] != (vis_refusal is None) or \
            (vis_refusal is not None and "matplotlib" not in vis_refusal) or \
            len(pngs) != (2 if have["matplotlib"] else 0):
        raise AssertionError(f"evalx vis: {vis_refusal!r}, {pngs}")
    return {"launches": launches}


def evalx_phase(dev, rehearsal: bool, seed: int, trained: dict, phase6: dict) -> dict:
    """Phase 7h: evaluation breadth on ``r50_fpn_coco`` at full width
    (800x1344, ``test.per_device_batch`` 8, 1000 proposals, bf16): phase
    5's trained state saved as a checkpoint with classes 1-4 favoured (+4
    on their bias, as phase 6 favours them), then (a) preemption and
    resume through real ``eval_cli`` processes (:func:`evalx_preempt`),
    (b) the sharded eval in this process (:func:`evalx_inprocess`), (c) the
    submission files and reeval (:func:`evalx_submission`), (d) Mask
    R-CNN's host mask work on the native and the numpy path
    (:func:`evalx_mask`), (e) the demo and ``--vis`` (:func:`evalx_demo`).
    The rehearsal runs it on phase 5's tiny state, at batch 8 on the CPU.
    Returns the paths' launches."""
    import shutil

    from mx_rcnn_tpu_torch.config import apply_overrides
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )
    from mx_rcnn_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda, "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    extra = ["model.test.per_device_batch=8"] if rehearsal else []
    config_args = ["--config", trained["cfg"].name]
    for o in [*train_overrides(rehearsal, seed), *extra]:
        config_args += ["--set", o]
    cfg = apply_overrides(trained["cfg"], extra)
    n = 64
    work = os.path.join(ROOT, "runs", f"chip_smoke_evalx_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ckpt_dir = os.path.join(work, "ckpt")
        bias = trained["state"].model.box_head.cls_score.bias
        base = bias.detach().clone()
        with torch.no_grad():
            bias[1:5] += 4.0
        try:
            ckpt.save_checkpoint(ckpt_dir, trained["state"])
        finally:
            with torch.no_grad():
                bias.copy_(base)
        eval_args = [*config_args, "--ckpt", ckpt_dir, "--workdir", os.path.join(work, "evalx")]
        if dev.type == "cpu":
            eval_args += ["--device", "cpu"]
        run1 = evalx_preempt(work, eval_args, n)
        sharded = evalx_inprocess(dev, cfg, ckpt_dir, work, n, phase6, counters)
        evalx_submission(cfg, config_args, work, run1, n)
        mask = evalx_mask(dev, rehearsal, seed, work, counters)
        demo = evalx_demo(dev, rehearsal, seed, cfg, config_args, eval_args, work, counters)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[evalx] phase 7h in {time.perf_counter() - t_phase:.2f} s")
    paths = {"evalx_sharded": sharded, "evalx_mask": mask, "evalx_demo": demo}
    return {"paths": {k: {"launches": {c: v["launches"].get(c, 0) for c in counters}}
                      for k, v in paths.items()},
            "img_s_after_first_shard": sharded["img_s_after_first_shard"],
            "mask_ms_a_det": mask["ms_a_det"]}


# The kernels of the main paths: source, the TPU kernel it replaces, and
# the paths that launch it.  (``roi_align_f32`` and ``roi_align_bwd_f32``
# are checked as well, but the paths run bf16, so they are no entries of
# their own.)
RUNTIME_CONFIG = "r50_fpn_coco"
RUNTIME_STEPS = 6
# The batches phase 7i's faults land on: run (e) wedges a worker on batch 1
# and corrupts batch 3's shm slot (reassigned: assembled twice), run (d)
# kills a worker on batch 2 (before it assembles it).  The bad records sit
# in batches a fault never reassigns, so each is journaled once.
RUNTIME_CLEAN_BATCHES = (0, 4, 5)


def runtime_records(rehearsal: bool, seed: int):
    """Sixteen landscape and eight portrait records rendered like the
    synthetic set's classes 1-4 (480x640 and 640x480; a quarter of that in
    the rehearsal), and two more landscape ones, ``missing`` and
    ``truncated``: ``[(record, tag)]`` in roidb order, pixels in
    ``image_array``."""
    import dataclasses

    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset

    hw = {"land": (120, 160), "port": (160, 120)} if rehearsal else \
        {"land": (480, 640), "port": (640, 480)}
    out = []
    for tag, n in (("land", 18), ("port", 8)):
        ds = SyntheticDataset(num_images=n, image_hw=hw[tag], num_classes=5,
                              seed=seed + 7 + (tag == "port"))
        out += [(dataclasses.replace(ds.record(i), image_id=f"{tag}{i}"), "ok")
                for i in range(n)]
    out[16] = (out[16][0], "missing")
    out[17] = (out[17][0], "truncated")
    return out


def write_runtime_set(root: str, cfg, rehearsal: bool, seed: int, batch: int) -> str:
    """The records of :func:`runtime_records` as a COCO directory under
    ``root`` (JPEGs written with PIL at quality 90, split ``runtime``), the
    missing record's file absent and the truncated one's cut to half its
    bytes; the bad records moved to rows that the schedule's batches in
    ``RUNTIME_CLEAN_BATCHES`` draw (every landscape record has one aspect,
    so the move leaves the schedule as it was).  Returns the split and the
    bad records' file names."""
    import itertools

    from PIL import Image

    from mx_rcnn_tpu_torch.data.loader import DetectionLoader

    recs = runtime_records(rehearsal, seed)
    probe = DetectionLoader([r for r, _ in recs], cfg.data, batch, "cpu", seed=cfg.train.seed,
                            prefetch=False, num_workers=0, service_workers=0)
    specs = list(itertools.islice(probe._batch_index_specs(), RUNTIME_STEPS))
    rows = [int(j) for b in RUNTIME_CLEAN_BATCHES for j in specs[b][0]
            if recs[int(j)][0].aspect >= 1]
    rows = list(dict.fromkeys(rows))
    if len(rows) < 2:
        raise AssertionError(f"runtime: batches {RUNTIME_CLEAN_BATCHES} draw too few landscape "
                             f"rows ({rows})")
    for bad, row in zip((16, 17), rows):
        recs[bad], recs[row] = recs[row], recs[bad]
    split = "runtime"
    os.makedirs(os.path.join(root, split), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, anns = [], []
    for n, (rec, tag) in enumerate(recs):
        name = f"{rec.image_id}.jpg"
        path = os.path.join(root, split, name)
        if tag != "missing":
            Image.fromarray(rec.image_array).save(path, quality=90)
        if tag == "truncated":
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
        images.append({"id": n + 1, "file_name": name, "height": rec.height,
                       "width": rec.width})
        for box, cls in zip(rec.boxes.tolist(), rec.gt_classes.tolist()):
            x1, y1, x2, y2 = box
            anns.append({"id": len(anns) + 1, "image_id": n + 1, "category_id": int(cls),
                         "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1], "iscrowd": 0,
                         "area": (x2 - x1 + 1) * (y2 - y1 + 1)})
    cats = [{"id": c, "name": f"shape{c}"} for c in range(1, 5)]
    with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return split, {f"{rec.image_id}.jpg" for rec, tag in recs if tag != "ok"}


def live_runtime() -> dict:
    """The input pipeline's threads and this process's children alive."""
    import multiprocessing as mp

    return {"threads": sorted(t.name for t in threading.enumerate()
                              if t.name in ("host-prefetch", "loader-prefetch")),
            "children": sorted(p.pid for p in mp.active_children())}


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` with ``values`` set, restored after."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def runtime_phase(dev, rehearsal: bool, seed: int, phase5: dict) -> dict:
    """Phase 7i: the training input runtime.  ``r50_fpn_coco`` at full
    width (800x1344, batch 2, compact RPN loss, the mixed policy, random
    weights from the seed) trains 6 steps through ``train()`` under
    deterministic algorithms on a COCO directory of real JPEGs (one file
    missing, one truncated), five ways: (a) synchronous (``host_depth=0``,
    a loader without pool or read-ahead); (b) the default in-process path
    (the pool, ``_Prefetched``, ``device_prefetch``'s pinned staging and
    copy stream); (c) ``data.num_workers=3`` with the shm ring and a fresh
    ``data.cache_dir`` (every read a miss); (d) (c) with the cache warm and
    a worker SIGKILLing itself on batch 2; (e) a worker wedged on batch 1
    under a 4 s watchdog, one cache blob's bytes flipped before the run,
    and batch 3's shm slot corrupted.  Every run's final parameters and
    momentum bitwise (a)'s; each run's journal holds the missing and the
    truncated record once each, (e)'s one ``cache_checksum`` and one
    ``shm_checksum`` record besides; B1 and B2 in every step; no
    ``host-prefetch``/``loader-prefetch`` thread and no child process
    alive after each ``train()``; every worker's hello without CUDA.
    Then ``run_eval`` on the set at batch 8 with ``data.num_workers=2``:
    its dump byte-identical to the ``num_workers=0`` dump."""
    import shutil

    from mx_rcnn_tpu_torch import obs
    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.data.cache import TensorCache, quarantine_read
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )
    from mx_rcnn_tpu_torch.train.loop import build_all, train
    from mx_rcnn_tpu_torch.weights import init_variables

    t_phase = time.perf_counter()
    counters = {"roi_align": multilevel_roi_align_cuda,
                "roi_align_bwd": multilevel_roi_align_bwd_cuda}
    batch = 2
    work = os.path.join(ROOT, "runs", f"chip_smoke_runtime_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    overrides = ["model.rpn.loss_impl=compact", f"train.seed={seed}", "data.flip=true",
                 "train.log_every=1", f"train.per_device_batch={batch}",
                 "model.test.per_device_batch=8", "data.dataset=coco", f"data.root={work}",
                 "data.train_split=runtime", "data.val_split=runtime"]
    if rehearsal:
        # The rehearsal's sources (120x160) outsize its canvas, which sizes
        # the shm slots: give the slots room.
        overrides += ["model.backbone.freeze_stages=2", "data.image_size=96,128",
                      "data.shm_slot_mb=1"]
    base = apply_overrides(get_config("tiny_synthetic" if rehearsal else RUNTIME_CONFIG),
                           overrides)
    try:
        _, bad_files = write_runtime_set(work, base, rehearsal, seed, batch)
        roidb = build_dataset(base.data, train=True).roidb()
        bad_ids = sorted(r.image_id for r in roidb
                         if os.path.basename(r.image_path) in bad_files)
        variables = init_variables(base.model, torch.Generator().manual_seed(seed))
        specs = list(itertools.islice(
            DetectionLoader(roidb, base.data, batch, "cpu", seed=seed, prefetch=False,
                            num_workers=0, service_workers=0)._batch_index_specs(),
            RUNTIME_STEPS))
        cache_dir = os.path.join(work, "tensor_cache")
        service = [f"data.num_workers=3", f"data.cache_dir={cache_dir}"]
        runs = {"a": ([], dict(host_depth=0), dict(prefetch=False, num_workers=0), {}),
                "b": ([], {}, {}, {}),
                "c": (service, {}, {}, {}),
                "d": (service, {}, {}, {"MX_RCNN_CHAOS_DATA_SUICIDE":
                                        f"2:{os.path.join(work, 'suicide.sentinel')}"}),
                "e": (service, {}, {}, {"MX_RCNN_CHAOS_DATA_WEDGE":
                                        f"1:{os.path.join(work, 'wedge.sentinel')}",
                                        "MX_RCNN_DATA_WATCHDOG_S": "4",
                                        "MX_RCNN_CHAOS_SHM_CORRUPT": "3"})}
        results, problems, nondet = {}, [], []
        launches = {k: 0 for k in counters}
        for name, (extra, train_kw, loader_kw, env) in runs.items():
            cfg = apply_overrides(base, extra)
            if name == "e":
                # Flip the bytes of one blob run (c) wrote: the first good
                # record of the clean batches, as the schedule draws it.
                j, flip = next((int(j), f) for b in (*RUNTIME_CLEAN_BATCHES, 1, 2, 3)
                               for j, f in zip(*specs[b])
                               if roidb[int(j)].image_id not in bad_ids)
                cache = TensorCache(cache_dir)
                blob = cache._path(cache.key(roidb[j], flip))
                with open(blob, "r+b") as f:
                    f.seek(-64, os.SEEK_END)
                    tail = f.read(64)
                    f.seek(-64, os.SEEK_END)
                    f.write(bytes(b ^ 0xFF for b in tail))
            qpath = os.path.join(work, name, "quarantine.jsonl")
            loader = DetectionLoader(roidb, cfg.data, batch, dev, seed=seed,
                                     quarantine_path=qpath, **loader_kw)
            lines, per_step = [], []

            def on_line(line, lines=lines, per_step=per_step, name=name):
                lines.append((time.perf_counter(), json.loads(line)))
                per_step.append({k: fn.launches for k, fn in counters.items()})
                for fn in counters.values():
                    fn.launches = 0

            before = live_runtime()
            t_events = time.monotonic_ns()  # the flight ring is bounded: select by time
            shm = {k: obs.counter(k).value(service="input-service")
                   for k in ("data_shm_bytes_total", "data_shm_overflows_total")}
            for fn in counters.values():
                fn.launches = 0
            live = 0.0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
                live = torch.cuda.memory_allocated(dev) / 2**30
            t0 = time.perf_counter()
            with environ(**env), deterministic_algorithms(nondet):
                state = train(cfg, steps=RUNTIME_STEPS, device=dev, variables=variables,
                              log=on_line, loader=loader, **train_kw)
            wall = time.perf_counter() - t0
            after = live_runtime()
            peak = torch.cuda.max_memory_allocated(dev) / 2**30 - live if dev.type == "cuda" \
                else float("nan")
            events = [e for e in obs.flight().entries() if e["ts_mono_ns"] > t_events]
            reap = [e["payload"]["heartbeat_age_s"] for e in events
                    if e["kind"] == "worker_wedged"]
            shm = {k: obs.counter(k).value(service="input-service") - v for k, v in shm.items()}
            rows = quarantine_read(qpath)
            io = sorted(r["image_id"] for r in rows if r.get("reason") == "io")
            kinds = sorted(r["reason"] for r in rows if r.get("reason") != "io")
            hellos = [h for run in loader.service_runs for h in run["hellos"]]
            deaths = sum(run["deaths"] for run in loader.service_runs)
            times = [t for t, _ in lines]
            step_s = (times[-1] - times[0]) / (len(times) - 1)
            stall = [m["data_stall_ms"] for _, m in lines[1:]]
            results[name] = {
                "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                "momentum": [t.cpu() for t in state.optimizer.trace],
                "s_per_step": step_s, "data_stall_ms": float(np.mean(stall)), "peak_gib": peak,
                "reap_s": reap, "wall": wall}
            for k in counters:
                launches[k] += sum(c[k] for c in per_step)
            want_kinds = ["cache_checksum", "shm_checksum"] if name == "e" else []
            if len(lines) != RUNTIME_STEPS or not all(
                    finite_line(m) and m["nonfinite"] == 0.0 for _, m in lines):
                problems.append(f"({name}): {len(lines)} steps, or a non-finite metric")
            if io != bad_ids or kinds != want_kinds:
                problems.append(f"({name}): journal io {io} (want {bad_ids}), others {kinds} "
                                f"(want {want_kinds})")
            if not rehearsal and any(v < 1 for c in per_step for v in c.values()):
                problems.append(f"({name}): B1 or B2 not launched in a step: {per_step}")
            if after["threads"] or set(after["children"]) - set(before["children"]):
                problems.append(f"({name}): alive after train(): {after}")
            if name in "cde" and (len(hellos) < 3 or any(h["cuda"] for h in hellos)):
                problems.append(f"({name}): worker hellos {hellos}")
            if name == "d" and deaths < 1:
                problems.append("(d): no worker died")
            if name == "e" and not reap:
                problems.append("(e): the wedged worker was not reaped")
            if name in "cde" and not shm["data_shm_bytes_total"]:
                problems.append(f"({name}): nothing went through the shm ring ({shm})")
            log(f"[runtime:{name}] {cfg.name}{' (rehearsal: cut)' if rehearsal else ''} batch "
                f"{batch}, {RUNTIME_STEPS} steps in {wall:.2f} s (build included): "
                f"{step_s:.4f} s a step after the first, data_stall_ms {np.mean(stall):.2f} "
                f"({[round(s, 2) for s in stall]}), peak memory {peak:.2f} GiB above the "
                f"{live:.2f} GiB live before the run; journal io {io} "
                f"others {kinds}; workers {len(hellos)} (cuda in a hello: "
                f"{any(h['cuda'] for h in hellos)}), deaths {deaths}, shm {shm}, wedge reaped after "
                f"{reap} s; launches a step {per_step}; {card_line() if dev.type == 'cuda' else 'cpu'}")
            del state
            release(dev)
        ref = results["a"]
        for name, r in results.items():
            same = all(torch.equal(r["state"][k], ref["state"][k]) for k in ref["state"]) and \
                all(torch.equal(x, y) for x, y in zip(r["momentum"], ref["momentum"],
                                                      strict=True))
            if not same:
                problems.append(f"({name}): final parameters differ from (a)'s "
                                f"(ops without a deterministic algorithm: {nondet})")
        log(f"[runtime] data_stall_ms: phase 5 {phase5['data_stall_ms']:.2f}, (a) "
            f"{results['a']['data_stall_ms']:.2f}, (b) {results['b']['data_stall_ms']:.2f}; "
            f"s a step: phase 5 {phase5['s_per_step']:.4f}, " + ", ".join(
                f"({k}) {r['s_per_step']:.4f}" for k, r in results.items()) +
            f"; all five bitwise (a): {not any('differ' in p for p in problems)}")

        # The eval: the set at batch 8, through the input service and without,
        # classes 1-4 favoured so that the dumps hold detections.
        favoured = dict(variables)
        favoured["box_head.cls_score.bias"] = variables["box_head.cls_score.bias"].clone()
        favoured["box_head.cls_score.bias"][1:5] = 4.0
        state = build_all(base, dev, favoured)[2]
        dumps, eval_b1 = {}, 0
        for workers in (0, 2):
            cfg = apply_overrides(base, [f"data.num_workers={workers}"])
            path = os.path.join(work, f"dump_w{workers}.json")
            before = live_runtime()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            metrics = run_eval(cfg, state=state, dump_path=path, device=dev)
            eval_s = time.perf_counter() - t0
            eval_b1 += multilevel_roi_align_cuda.launches
            with open(path, "rb") as f:
                dumps[workers] = f.read()
            if not all(np.isfinite(v) for v in metrics.values()):
                problems.append(f"eval num_workers={workers}: non-finite metrics")
            if set(live_runtime()["children"]) - set(before["children"]):
                problems.append(f"eval num_workers={workers}: a worker outlived run_eval")
            n_dets = sum(len(d.get("boxes", [])) for d in json.loads(dumps[workers]).values())
            log(f"[runtime:eval] num_workers={workers}: {len(roidb)} images in {eval_s:.2f} s "
                f"(model build included), B1 launches {multilevel_roi_align_cuda.launches}, "
                f"dump {len(dumps[workers])} bytes, {n_dets} detections")
            if not n_dets:
                problems.append(f"eval num_workers={workers}: the dump holds no detection")
        if dumps[0] != dumps[2]:
            problems.append("eval: the num_workers=2 dump differs from the num_workers=0 dump")
        if not rehearsal and eval_b1 < 1:
            problems.append("eval: B1 never launched")
        log(f"[runtime] phase 7i {time.perf_counter() - t_phase:.2f} s; dumps byte-identical "
            f"{dumps[0] == dumps[2]}; ops without a deterministic algorithm: {nondet}")
        if problems:
            raise AssertionError(f"runtime: {problems}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"paths": {"runtime": {"launches": launches},
                      "runtime_eval": {"launches": {"roi_align": eval_b1}}}}


OBS_STEPS, OBS_PREEMPT_AT, OBS_PROFILE = 10, 4, (2, 5)
OBS_ROUNDS, OBS_REQUESTS = 4, 16


def http_get(port: int, path: str) -> tuple[int, str]:
    """GET ``path`` from the plane's endpoint on 127.0.0.1."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read().decode()


def read_spans(obs_dir: str) -> list:
    with open(os.path.join(obs_dir, "spans.jsonl")) as f:
        return [json.loads(line) for line in f]


def children_of(spans: list) -> dict:
    """span_id -> sorted names of its children."""
    out = {}
    for s in spans:
        out.setdefault(s["args"]["parent_id"], []).append(s["name"])
    return {k: sorted(v) for k, v in out.items()}


@contextlib.contextmanager
def kept_excepthooks():
    """``train()`` with the plane on chains a crash handler onto the hooks;
    put the originals back after."""
    saved = sys.excepthook, threading.excepthook
    try:
        yield
    finally:
        sys.excepthook, threading.excepthook = saved


def obs_train(dev, rehearsal: bool, seed: int, work: str, counters: dict, phase5: dict,
              problems: list) -> dict:
    """Phase 7j (a): ten steps through ``train()`` with the plane on, the
    endpoint on an ephemeral port, a flush every 0.5 s and the profile
    window over steps 2-4; a real SIGTERM at the step-4 drain, then the
    resume to 10 into the same obs directory."""
    import signal

    from mx_rcnn_tpu_torch import obs
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.obs import read_journal
    from mx_rcnn_tpu_torch.train.loop import train
    from mx_rcnn_tpu_torch.train.preemption import Preempted
    from mx_rcnn_tpu_torch.utils.profiling import stage_of
    from mx_rcnn_tpu_torch.weights import init_variables

    cfg = apply_overrides(get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco"),
                          train_overrides(rehearsal, seed) + [
                              "train.checkpoint_every=1000", "obs.enabled=true",
                              "obs.metrics_port=0", "obs.flush_s=0.5"])
    variables = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    obs_dir = os.path.join(work, cfg.name, "obs")
    prof_dir = os.path.join(work, "profile")
    lines, left, per_step, scraped, sent = [], [], [], {}, []

    def on_line(line):
        m = json.loads(line)
        lines.append((time.perf_counter(), m))
        per_step.append({k: fn.launches for k, fn in counters.items()})
        for fn in counters.values():
            fn.launches = 0
        if m["step"] == 1:
            port = obs.metrics_port()
            t = time.perf_counter()
            scraped.update({p: http_get(port, p) for p in ("/metrics", "/healthz")})
            scraped["ms"] = 1e3 * (time.perf_counter() - t)
        if m["step"] == OBS_PREEMPT_AT and not sent:
            sent.append(time.perf_counter())
            os.kill(os.getpid(), signal.SIGTERM)
        left.append(time.perf_counter())

    kw = dict(steps=OBS_STEPS, device=dev, variables=variables, log=on_line, workdir=work,
              profile_dir=prof_dir, profile_steps=OBS_PROFILE)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with kept_excepthooks():
        try:
            train(cfg, **kw)
            problems.append("(a): the SIGTERM did not preempt the run")
        except Preempted as e:
            if e.step != OBS_PREEMPT_AT:
                problems.append(f"(a): preempted at {e.step}")
        split = len(lines)
        train(cfg, resume=True, **kw)
    wall = time.perf_counter() - t0
    obs.close()

    recs = read_journal(os.path.join(obs_dir, "journal.jsonl"))
    kinds = [(r["kind"], (r.get("payload") or {}).get("step")) for r in recs
             if r["kind"] != "metrics_flush"]
    want = [("configured", None), ("checkpoint_saved", 0), ("preempt_drain", 4),
            ("checkpoint_saved", 4), ("flight_dump", None), ("configured", None),
            ("checkpoint_restored", 4), ("checkpoint_saved", OBS_STEPS)]
    flushes = sum(r["kind"] == "metrics_flush" for r in recs)
    if kinds != want or flushes < 1:
        problems.append(f"(a): journal {kinds}, {flushes} metrics_flush (want {want}, >= 1)")
    spans = read_spans(obs_dir)
    kids = children_of(spans)
    steps = [s for s in spans if s["name"] == "train_step"]
    if sorted(s["args"]["step"] for s in steps) != list(range(OBS_STEPS)) or any(
            kids.get(s["args"]["span_id"]) != ["data", "step"] for s in steps):
        problems.append(f"(a): train_step spans {[s['args'] for s in steps]}")
    dumps = [f for f in os.listdir(obs_dir) if f.startswith("flight_preempt_drain_")]
    if len(dumps) != 1:
        problems.append(f"(a): preempt_drain dumps {dumps}")
    answers = {k: scraped.get(k, (0, ""))[0] for k in ("/metrics", "/healthz")}
    if answers != {"/metrics": 200, "/healthz": 200} or \
            "obs_events_total" not in scraped["/metrics"][1]:
        problems.append(f"(a): endpoint answers {answers}")
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    want_traces = [f"trace_step{OBS_PROFILE[0]}_{os.getpid()}_",
                   f"trace_step{OBS_PREEMPT_AT}_{os.getpid()}_"]
    stages, sizes = {}, {}
    for name in traces:
        path = os.path.join(prof_dir, name)
        sizes[name] = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        stages[name] = sorted({stage_of(e["name"]) for e in events
                               if e.get("cat") == "kernel" and e.get("name")
                               and stage_of(e["name"]).startswith("B")})
    if len(traces) != len(want_traces) or not all(
            t.startswith(w) for t, w in zip(traces, want_traces)):
        problems.append(f"(a): profile traces {traces} (want {want_traces})")
    if not rehearsal and any(v != ["B1 roi_align kernel", "B2 roi_align backward kernel"]
                             for v in stages.values()):
        problems.append(f"(a): the traces' B kernels {stages}")
    if len(lines) != OBS_STEPS or not all(finite_line(m) and m["nonfinite"] == 0.0
                                          for _, m in lines):
        problems.append(f"(a): {len(lines)} steps, or a non-finite metric")
    if not rehearsal and any(v < 1 for c in per_step for v in c.values()):
        problems.append(f"(a): B1 or B2 not launched in a step: {per_step}")
    # A step's seconds: from the end of the previous line's callback (the
    # scrape is in the callback) to its line, in its run (drain included,
    # as phase 5 reads it); traced steps are i = 2..4 (lines 3-5), and the
    # window's export runs at the top of i=5.  Each untraced step is held
    # against phase 5's step at the same index in its run (the first of
    # each run is left out, as phase 5 leaves out its own).
    dts = {m["step"]: t - left[k - 1] for k, (t, m) in enumerate(lines)
           if k not in (0, split)}
    index = {m["step"]: k if k < split else k - split for k, (_, m) in enumerate(lines)}
    plain = {d: v for d, v in dts.items() if not OBS_PROFILE[0] < d <= OBS_PROFILE[1] + 1}
    p5 = phase5.get("step_s", [])
    pairs = {d: (v, p5[index[d] - 1]) for d, v in plain.items() if index[d] - 1 < len(p5)}
    diff = [v - off for v, off in pairs.values()] or [float("nan")]   # nan: no phase 5 steps
    span_ms = {s["args"]["step"]: s["dur"] / 1e3 for s in steps}
    log(f"[obs:train] {cfg.name}{' (rehearsal: cut)' if rehearsal else ''} batch "
        f"{cfg.train.per_device_batch}, {OBS_STEPS} steps (preempted at {OBS_PREEMPT_AT}, "
        f"resumed) in {wall:.2f} s (builds, checkpoints and the trace export included); "
        f"seconds a step by its line {({d: round(v, 4) for d, v in dts.items()})}, "
        f"untraced {np.mean(list(plain.values())):.4f} over {len(plain)} steps (phase 5, "
        f"plane off: {phase5['s_per_step']:.4f}); untraced step by line (plane on, phase 5 "
        f"at the same index in its run) "
        f"{({d: (round(a, 4), round(b, 4)) for d, (a, b) in pairs.items()})}: paired "
        f"difference mean {np.mean(diff):+.4f} s, range {min(diff):+.4f} to {max(diff):+.4f}; "
        f"train_step span ms {({i: round(v, 2) for i, v in sorted(span_ms.items())})}; "
        f"journal {kinds} + {flushes} metrics_flush; /metrics and /healthz {answers} "
        f"(both scraped in {scraped.get('ms', float('nan')):.2f} ms); preempt dumps {len(dumps)}; "
        f"traces {({k: round(v / 2**20, 2) for k, v in sizes.items()})} MiB holding {stages}; "
        f"launches a step {per_step}; {card_line() if dev.type == 'cuda' else 'cpu'}")
    launches = {k: sum(c[k] for c in per_step) for k in counters}
    return {"obs_dir": obs_dir, "launches": launches,
            "s_per_step": float(np.mean(list(plain.values()))),
            "paired_diff_s": (float(np.mean(diff)), len(pairs)),
            "trace_mib": sum(sizes.values()) / 2**20}


def obs_serve(dev, rehearsal: bool, seed: int, work: str, counters: dict,
              problems: list) -> dict:
    """Phase 7j (b): the ``full`` engine (B1 + B3), warmed by one request
    of each size, serves 16 requests with spans on and 16 with spans
    off in each of 4 rounds, one request at a time, the set that goes
    first alternating by round;
    a ``proposals``-only engine on ``rpn.nms_impl=pallas`` (B4) serves one
    with spans on; then ``kill()`` dumps the ring."""
    from mx_rcnn_tpu_torch import obs
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner, InferenceEngine, build_engine
    from mx_rcnn_tpu_torch.weights import init_variables

    base = get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco")
    variables = init_variables(base.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    images = serve_images(rehearsal, seed)
    obs_dir = os.path.join(work, "serve_obs")
    run_id = obs.configure(obs_dir, spans=True)
    engine = build_engine(apply_overrides(base, ["serve.fused_middle=on", "serve.batch_size=2"]),
                          variables, device=dev).start()
    lat, traced, outs = {True: [], False: []}, [], 0
    for fn in counters.values():
        fn.launches = 0
    # Warm the path at each request size (spans off, not timed), so that
    # neither set pays a first call.
    obs.configure(obs_dir, run_id=run_id, spans=False)
    for img in images:
        engine.submit(img).result(600)
    rounds = []
    for r in range(OBS_ROUNDS):
        first = len(lat[True]), len(lat[False])
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            obs.configure(obs_dir, run_id=run_id, spans=on)
            for j in range(OBS_REQUESTS):
                img = images[j % len(images)]
                t = time.perf_counter()
                req = engine.submit(img)
                res = req.result(600)
                lat[on].append(1e3 * (time.perf_counter() - t))
                check_response(res, *img.shape[:2])
                outs += len(res["scores"])
                if on == (req.span is None):
                    problems.append(f"(b): spans {'on' if on else 'off'}, span {req.span}")
                if on:
                    traced.append(req.span.span_id)
        rounds.append(float(np.median(lat[True][first[0]:]) - np.median(lat[False][first[1]:])))
    full_launches = {k: fn.launches for k, fn in counters.items()}

    obs.configure(obs_dir, run_id=run_id, spans=True)
    runner = DetectorRunner(apply_overrides(base, ["model.rpn.nms_impl=pallas"]), variables,
                            batch_size=1, device=dev)
    levels = _Levels(runner)
    levels.only = ("proposals",)
    with InferenceEngine(levels, pack=False) as prop:
        for fn in counters.values():
            fn.launches = 0
        req = prop.submit(images[0])
        res = req.result(600)
        prop_launches = {k: fn.launches for k, fn in counters.items()}
    check_response(res, *images[0].shape[:2])
    traced.append(req.span.span_id)
    if res["level"] != "proposals" or (res["classes"] != 0).any():
        problems.append(f"(b): proposals served at {res['level']}")

    engine.kill("chip_smoke: phase 7j kill")
    engine.stop()
    obs.close()
    dumps = sorted(f for f in os.listdir(obs_dir) if f.startswith("flight_engine_killed_"))
    in_dump = set()
    for name in dumps:
        with open(os.path.join(obs_dir, name)) as f:
            in_dump |= {e["args"]["span_id"] for e in json.load(f)["entries"]
                        if e.get("type") == "span" and e.get("name") == "engine_request"}
    spans = read_spans(obs_dir)
    kids = children_of(spans)
    reqs = [s for s in spans if s["name"] == "engine_request"]
    devices = [s["args"] for s in spans if s["name"] == "device"]
    if sorted(s["args"]["span_id"] for s in reqs) != sorted(traced) or any(
            kids.get(s["args"]["span_id"]) != ["device", "queue"] for s in reqs):
        problems.append(f"(b): {len(reqs)} engine_request spans for {len(traced)} traced "
                        f"requests, or one without its queue and device children")
    if sorted({d["level"] for d in devices}) != ["full", "proposals"]:
        problems.append(f"(b): device span levels {sorted({d['level'] for d in devices})}")
    if len(dumps) != 1 or not set(traced) <= in_dump:
        problems.append(f"(b): kill dumps {dumps}, holding {len(set(traced) & in_dump)} of the "
                        f"{len(traced)} traced requests")
    if not rehearsal and (min(full_launches["roi_align"], full_launches["fused_middle"]) < 1
                          or prop_launches["nms"] != 1):
        problems.append(f"(b): launches full {full_launches}, proposals {prop_launches}")
    pct = {on: (float(np.percentile(v, 50)), float(np.percentile(v, 99)))
           for on, v in lat.items()}
    log(f"[obs:serve] {base.name} full (B1 + B3), batch 2: {len(images)} warm-up requests, "
        f"then {OBS_ROUNDS} rounds of {OBS_REQUESTS} requests with spans on and "
        f"{OBS_REQUESTS} off, one at a time; ms a "
        f"request p50/p99 spans on {pct[True][0]:.2f}/{pct[True][1]:.2f}, off "
        f"{pct[False][0]:.2f}/{pct[False][1]:.2f}; p50 on less off by round (on first in "
        f"rounds 1 and 3) {[round(d, 2) for d in rounds]}; {outs} detections; {len(reqs)} traced "
        f"requests (one at proposals: B4 launches {prop_launches['nms']}), all in the kill's "
        f"dump: {set(traced) <= in_dump}; launches full {full_launches}; "
        f"{card_line() if dev.type == 'cuda' else 'cpu'}")
    return {"obs_dir": obs_dir, "full": full_launches, "proposals": prop_launches,
            "p50_p99_ms": pct, "round_p50_diff_ms": rounds}


def obs_report(obs_dir: str, want: str, problems: list) -> list:
    """Phase 7j (c): ``python -m mx_rcnn_tpu_torch.obs.report`` over one
    directory; its timeline must hold ``want``."""
    proc = subprocess.run([sys.executable, "-m", "mx_rcnn_tpu_torch.obs.report", obs_dir],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        problems.append(f"(c): the report exited {proc.returncode}: {proc.stderr[-2000:]}")
        return []
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(summary["path"]) as f:
        report = json.load(f)
    kinds = [e["kind"] for e in report["incident_timeline"]]
    if want not in kinds:
        problems.append(f"(c): {want} not in the timeline {kinds}")
    log(f"[obs:report] {os.path.basename(obs_dir)}: {summary['value']}; timeline {kinds}")
    return kinds


def obs_lockcheck(rehearsal: bool, seed: int, problems: list) -> dict:
    """Phase 7j (d): ``chip_smoke.py --lockcheck-child`` under
    ``MX_RCNN_LOCKCHECK=1``: zero violations, the order graph printed."""
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--lockcheck-child",
           "--seed", str(seed)] + (["--cpu-rehearsal"] if rehearsal else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, MX_RCNN_LOCKCHECK="1"),
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.strip().splitlines()[:-1]:
        log(f"  {line}")
    if proc.returncode != 0:
        problems.append(f"(d): the child exited {proc.returncode}: {proc.stderr[-3000:]}")
        return {}
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if not got["installed"] or got["violations"] != 0 or not got["graph"] \
            or got["statusz"] != 200 or got["steps"] != 2 or got["workers"] < 2 \
            or got["children"] or "proposals" not in got["levels"] \
            or got["levels"][-4:] != ["failed"] * 3 + ["full_q8"]:
        problems.append(f"(d): {got}")
    log(f"[obs:lockcheck] child {time.perf_counter() - t0:.2f} s: sanitizer installed "
        f"{got['installed']}, violations {got['violations']}; levels served {got['levels']}; "
        f"/statusz {got['statusz']}; {got['steps']} train steps through {got['workers']} decode "
        f"workers (each imports the package under the variable); order graph (held -> "
        f"acquired), {sum(len(v) for v in got['graph'].values())} edges:")
    for held, acquired in sorted(got["graph"].items()):
        log(f"  {held} -> {', '.join(acquired)}")
    return got


def lockcheck_child(dev, rehearsal: bool, seed: int) -> int:
    """The process phase 7j (d) starts under ``MX_RCNN_LOCKCHECK=1``: the
    engine's ladder (each level, a deadline nothing fits, a swap under load,
    the kill, the breaker) with the plane configured and its endpoint
    scraped, then 2 train steps through the input service
    (``data.num_workers=2``).  Prints one JSON line last."""
    import multiprocessing as mp
    import shutil

    from mx_rcnn_tpu_torch import obs
    from mx_rcnn_tpu_torch.analysis import lockcheck
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader
    from mx_rcnn_tpu_torch.data.roidb import filter_roidb
    from mx_rcnn_tpu_torch.serve.engine import (
        DeadlineExceeded,
        DetectorRunner,
        InferenceEngine,
        ServeError,
    )
    from mx_rcnn_tpu_torch.train.loop import train
    from mx_rcnn_tpu_torch.weights import init_variables

    base = get_config("tiny_synthetic" if rehearsal else "r50_fpn_coco")
    work = os.path.join(ROOT, "runs", f"chip_smoke_lockcheck_{os.getpid()}")
    variables = init_variables(base.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    images = serve_images(rehearsal, seed)
    images = [images[i % len(images)] for i in range(4)]
    served = []

    def level_of(req):
        try:
            return req.result(600)["level"]
        except DeadlineExceeded:
            return "late"

    try:
        obs.configure(os.path.join(work, "obs"), metrics_port=0)
        runner = DetectorRunner(apply_overrides(base, ["serve.fused_middle=on"]), variables,
                                batch_size=2, int8_head=True, device=dev)
        levels = _Levels(runner)
        with InferenceEngine(levels, headroom=4.0) as eng:
            obs.register_status("engine", eng.stats)
            for level in reversed(runner.levels()):
                levels.only = (level,)
                served += [eng.infer(img)["level"] for img in images[:2]]
            levels.only = None
            est = eng.estimates.snapshot()
            served.append(level_of(eng.submit(images[0], timeout=2.0 * min(est.values()))))
            reqs = [eng.submit(img) for img in images]
            swap = threading.Thread(target=eng.swap_weights, args=(variables,))
            swap.start()
            reqs += [eng.submit(img) for img in images]
            swap.join(600)
            served += [level_of(r) for r in reqs]
            status = http_get(obs.metrics_port(), "/statusz")[0]
            eng.kill("chip_smoke: lockcheck kill")
        with InferenceEngine(_FailsFullQuality(runner), pack=False) as eng:
            for img in images[:3]:
                try:
                    eng.infer(img)
                except ServeError:
                    served.append("failed")
            served.append(eng.infer(images[3])["level"])
        cfg = apply_overrides(base, train_overrides(rehearsal, seed) + ["data.num_workers=2"])
        loader = DetectionLoader(filter_roidb(build_dataset(cfg.data, train=True).roidb()),
                                 cfg.data, cfg.train.per_device_batch, dev, seed=seed)
        lines = []
        train(cfg, steps=2, device=dev, log=lines.append, loader=loader)
        hellos = [h for run in loader.service_runs for h in run["hellos"]]
    finally:
        obs.reset()
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"installed": lockcheck.enabled(), "violations": lockcheck.violation_count(),
                      "graph": lockcheck.order_graph(), "levels": served, "statusz": status,
                      "steps": len(lines), "workers": len(hellos),
                      "children": len(mp.active_children())}), flush=True)
    return 0


def obs_phase(dev, rehearsal: bool, seed: int, phase5: dict) -> dict:
    """Phase 7j: the configured observability plane on ``r50_fpn_coco`` at
    full width (800x1344, batch 2, compact RPN loss, the mixed policy,
    random weights from the seed): (a) :func:`obs_train`, (b)
    :func:`obs_serve`, (c) :func:`obs_report` over (a)'s and (b)'s
    directories, (d) :func:`obs_lockcheck`."""
    import shutil

    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
        multilevel_roi_align_bwd_cuda,
        multilevel_roi_align_cuda,
    )

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "runs", f"chip_smoke_obs_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    problems = []
    try:
        a = obs_train(dev, rehearsal, seed, work,
                      {"roi_align": multilevel_roi_align_cuda,
                       "roi_align_bwd": multilevel_roi_align_bwd_cuda}, phase5, problems)
        b = obs_serve(dev, rehearsal, seed, work,
                      {"roi_align": multilevel_roi_align_cuda,
                       "fused_middle": fused_middle_levels, "nms": nms_mask_cuda}, problems)
        obs_report(a["obs_dir"], "preempt_drain", problems)
        obs_report(b["obs_dir"], "engine_killed", problems)
        obs_lockcheck(rehearsal, seed, problems)
        log(f"[obs] phase 7j {time.perf_counter() - t_phase:.2f} s; train {a['s_per_step']:.4f} "
            f"s a step untraced with the plane on (phase 5: {phase5['s_per_step']:.4f}; paired "
            f"by index, mean difference {a['paired_diff_s'][0]:+.4f} s over "
            f"{a['paired_diff_s'][1]} steps); serve ms p50/p99 spans on "
            f"{b['p50_p99_ms'][True]}, off {b['p50_p99_ms'][False]}, p50 on less off by round "
            f"{[round(d, 2) for d in b['round_p50_diff_ms']]}; "
            f"profile traces {a['trace_mib']:.2f} MiB; "
            f"{card_line() if dev.type == 'cuda' else 'cpu'}")
        if problems:
            raise AssertionError(f"obs: {problems}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"paths": {"obs_train": {"launches": a["launches"]},
                      "obs_serve": {"launches": b["full"]},
                      "obs_proposals": {"launches": b["proposals"]}}}


# Phase 7k: the serving fleet and its control loop on r50_fpn_coco.
FLEET_CONFIG = "r50_fpn_coco"
FLEET_TABLE = "a:weight=1,rate=400,burst=400;b:weight=1,rate=400,burst=400"
FLEET_WAIT = 120.0


def fleet_cfg(rehearsal: bool, *extra: str):
    """``r50_fpn_coco`` served one request a call with ``serve.fused_middle=on``,
    a result cache, two tenants and the controller's knobs of phase 7k
    (a 0.2 s period, 2-3 replicas, burn windows of 1 and 2 s)."""
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config(FLEET_CONFIG), [
        *c4_overrides(rehearsal), "serve.fused_middle=on", "serve.batch_size=1",
        "serve.result_cache_capacity=64", "serve.tenancy.enabled=true",
        f"serve.tenancy.table={FLEET_TABLE}", "ctrl.period_s=0.2", "ctrl.min_replicas=2",
        "ctrl.max_replicas=3", "ctrl.load_high=4", "ctrl.load_low=0.5", "ctrl.down_dwell=2",
        "ctrl.up_cooldown_s=1", "ctrl.down_cooldown_s=1", "ctrl.burn_fast_s=1",
        "ctrl.burn_slow_s=2", *extra])


class FleetImages:
    """Request ``i``: float32 noise at a COCO size, landscape and portrait
    in turn, whose first pixel carries ``i``, so that no two requests share
    a result-cache key; rebuilt from ``i`` when an oracle needs it."""

    def __init__(self, rehearsal: bool, seed: int) -> None:
        sizes = ([(120, 160), (160, 120), (107, 160), (160, 107)] if rehearsal
                 else [(480, 640), (640, 480), (427, 640), (640, 427)])
        rng = np.random.RandomState(seed + 11)
        self.bases = [rng.uniform(0, 255, (h, w, 3)).astype(np.float32) for h, w in sizes]
        self.count = itertools.count()

    def __call__(self, i: int) -> np.ndarray:
        img = self.bases[i % len(self.bases)].copy()
        img[0, 0] = (i % 251, i // 251 % 251, 7)
        return img


class FleetLoad:
    """A client thread that keeps ``depth`` requests in flight on ``fleet``,
    each a fresh image of ``images``, until :meth:`stop`.  ``accepted``
    holds (i, request) of every submit that returned, ``refused`` the error
    names of those that raised (then it waits 10 ms)."""

    def __init__(self, fleet, images: FleetImages, depth: int, tenant=None,
                 timeout: float = FLEET_WAIT) -> None:
        self.fleet, self.images, self.depth = fleet, images, depth
        self.tenant, self.timeout = tenant, timeout
        self.accepted, self.refused = [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="fleet-load", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from collections import deque

        from mx_rcnn_tpu_torch.serve.engine import ServeError

        pending = deque()
        while not self._stop.is_set():
            while pending and pending[0].done():
                pending.popleft()
            if len(pending) >= self.depth:
                pending[0].wait(0.05)
                continue
            i = next(self.images.count)
            try:
                req = self.fleet.submit(self.images(i), timeout=self.timeout, tenant=self.tenant)
            except ServeError as e:
                self.refused.append(type(e).__name__)
                time.sleep(0.01)
                continue
            self.accepted.append((i, req))
            pending.append(req)

    def halt(self) -> None:
        """Stop submitting, waiting for nothing (a failed step's cleanup)."""
        self._stop.set()

    def done(self) -> int:
        return sum(1 for _, r in list(self.accepted) if r.done())

    def wait_done(self, n: int, timeout: float = FLEET_WAIT) -> None:
        wait_for(lambda: self.done() >= n, timeout, f"fleet load: {n} requests not done")

    def stop(self, timeout: float = FLEET_WAIT) -> list:
        """Stop submitting and wait for every accepted request: (i, result),
        or (i, error name) for a failed one."""
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise AssertionError("fleet load: the client did not stop")
        out = []
        for i, req in self.accepted:
            if not req.wait(timeout):
                raise AssertionError(f"fleet load: request {i} never completed")
            try:
                out.append((i, req.result(0)))
            except Exception as e:  # noqa: BLE001 - reported by name
                out.append((i, type(e).__name__))
        return out


def wait_for(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(what)
        time.sleep(0.01)


class _Wedged(_Delegate):
    """Holds every call until ``gate`` is set (``entered`` says one is held):
    a replica whose device call does not come back."""

    def __init__(self, runner) -> None:
        super().__init__(runner)
        self.entered, self.gate = threading.Event(), threading.Event()

    def run(self, mode, bucket, images):
        self.entered.set()
        self.gate.wait(FLEET_WAIT)
        return self.runner.run(mode, bucket, images)


def fleet_failed(results: list) -> list:
    return [(i, r) for i, r in results if isinstance(r, str)]


def fleet_oracle(counters: dict, oracle, images: FleetImages, results: list) -> list:
    """The (i, response) pairs of ``results`` that are not bitwise
    ``oracle``'s (a runner of the fleet's config on the weights of the
    response's generation) on image ``i``, at the response's level; not
    counted.  None as ``oracle`` checks nothing."""
    from mx_rcnn_tpu_torch.serve.engine import level_program

    if oracle is None:
        return []
    bad = []
    with uncounted(counters):
        for i, res in results:
            img = images(i)
            mode, bucket = level_program(oracle, res["level"],
                                         oracle.pick_bucket(*img.shape[:2]))
            if not same_result(res, oracle.run(mode, bucket, [img])[0]):
                bad.append((i, res["level"], res["generation"]))
    return bad


def fleet_route(fleet, images: FleetImages, counters: dict, oracle, store: dict) -> dict:
    """Phase 7k (a): 16 requests routed at once, the ROIAlign and
    fused-middle inputs of the last call kept in ``store``: every response
    at ``full``, finite and inside its image, with detections, and bitwise
    the single runner's on the same weights; both replicas served."""
    from mx_rcnn_tpu_torch.ops.cuda import middle as middle_mod

    every = lambda size, levels: True   # noqa: E731
    store["pool"] = []
    idx = [next(images.count) for _ in range(16)]
    t0 = time.perf_counter()
    with captured_pool(store["pool"], every), \
            captured(middle_mod, ("_launch", "fused_middle_levels_plain"), keep_last(store)):
        reqs = [fleet.submit(images(i), timeout=FLEET_WAIT) for i in idx]
        results = [(i, r.result(FLEET_WAIT)) for i, r in zip(idx, reqs)]
    wall = time.perf_counter() - t0
    for i, res in results:
        check_response(res, *images(i).shape[:2])
    rids = sorted({res["replica_id"] for _, res in results})
    levels = {res["level"] for _, res in results}
    bad = fleet_oracle(counters, oracle, images, results)
    counts = [len(res["scores"]) for _, res in results]
    log(f"[fleet:route] 16 requests in {wall:.3f} s over replicas {rids}, levels {sorted(levels)}; "
        f"detections {counts}; bitwise the single runner's: {not bad}")
    if rids != [0, 1] or levels != {"full"} or bad or min(counts) == 0:
        raise AssertionError(f"fleet route: replicas {rids}, levels {levels}, differ {bad}")
    return {"wall_s": wall, "bitwise": not bad}


def fleet_proposals(dev, rehearsal: bool, seed: int, variables, images: FleetImages,
                    counters: dict, nms_store: dict) -> dict:
    """Phase 7k (a), the ladder's bottom: a second fleet of two replicas
    whose programs run ``rpn.nms_impl=pallas`` with the fused middle off
    (B4, as phase 7f's second runner), headroom 4.  Four requests without a
    deadline warm both replicas' ``full`` estimates; then, one at a time
    (each lands on replica 0), a deadline of 3x ``full``'s estimate (served
    at ``reduced``), 3x the least of ``full``'s and ``reduced``'s
    (``proposals``) and 3x the least estimate (nothing fits: ``proposals``),
    the B4 inputs of the last kept in ``nms_store``.  Every response
    bitwise a runner of that config; the launches counted from 0."""
    from mx_rcnn_tpu_torch.ops.cuda import nms as nms_mod
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet

    cfg = fleet_cfg(rehearsal, "serve.fused_middle=inherit", "model.rpn.nms_impl=pallas",
                    "serve.result_cache_capacity=0")
    t0 = time.perf_counter()
    fleet = build_fleet(cfg, variables, n_replicas=2, device=dev, supervisor_poll=0.05,
                        engine_kwargs={"headroom": 4.0})
    oracle = DetectorRunner(cfg, variables, batch_size=1, device=dev)
    oracle.warmup()
    try:
        fleet.start()
        warm_s = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        idx = [next(images.count) for _ in range(4)]
        reqs = [fleet.submit(images(i), timeout=FLEET_WAIT) for i in idx]
        results = [(i, r.result(FLEET_WAIT)) for i, r in zip(idx, reqs)]
        est = lambda: fleet.stats()["replica"][0]["engine"]["latency_estimates_s"]  # noqa: E731
        ladder = []
        for pick in (lambda e: e["full"], lambda e: min(e["full"], e["reduced"]),
                     lambda e: min(e.values())):
            deadline = 3.0 * pick(est())
            i = next(images.count)
            with captured(nms_mod, ("nms_keep_sorted_cuda",), keep_last(nms_store)):
                res = fleet.submit(images(i), timeout=deadline).result(FLEET_WAIT)
            results.append((i, res))
            ladder.append((round(1e3 * deadline, 2), res["level"], res["replica_id"]))
        launches = {k: fn.launches for k, fn in counters.items()}
        clean = fleet.drain(timeout=FLEET_WAIT)
    finally:
        fleet.stop()
    for i, res in results:
        check_response(res, *images(i).shape[:2])
    bad = fleet_oracle(counters, oracle, images, results)
    log(f"[fleet:proposals] rpn.nms_impl=pallas fleet warmed in {warm_s:.1f} s; deadlines ms, "
        f"level, replica {ladder}; bitwise a single runner's: {not bad}; drained {clean}; "
        f"launches {launches}")
    if [lv for _, lv, _ in ladder] != ["reduced", "proposals", "proposals"] or bad or not clean:
        raise AssertionError(f"fleet proposals: {ladder}, differ {bad}, drained {clean}")
    if (results[-1][1]["classes"] != 0).any():
        raise AssertionError("fleet proposals: a proposal of a class other than 0")
    if dev.type == "cuda" and min(launches["nms"], launches["roi_align"]) < 1:
        raise AssertionError(f"fleet proposals: B4 or B1 never launched ({launches})")
    return {"launches": launches, "ladder": ladder}


def fleet_kill(dev, fleet, images: FleetImages, weight_bytes: int, rehearsal: bool) -> dict:
    """Phase 7k (b): ``kill_replica(1)`` under a load of 4 in flight:
    quarantine, rebuild, reinstate; no accepted request fails; the killed
    engine's worker exits and, on the card, the allocated memory comes back
    to its level before the kill (a leaked runner would hold its weights)."""
    import gc

    gc.collect()   # what earlier steps left for the cycle collector goes first
    if dev.type == "cuda":
        torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    before = fleet.stats()
    old = fleet._replicas[1].engine
    load = FleetLoad(fleet, images, depth=4)
    try:
        load.wait_done(4 if rehearsal else 8)
        t0 = time.monotonic()
        fleet.kill_replica(1, "chip_smoke: kill under load")
        wait_for(lambda: fleet.stats()["reinstatements"] > before["reinstatements"]
                 and fleet.stats()["replica"][1]["state"] == "ready", FLEET_WAIT,
                 "fleet kill: replica 1 not reinstated")
        ready_s = time.monotonic() - t0
        load.wait_done(load.done() + (2 if rehearsal else 8))
        results = load.stop()
    finally:
        load.halt()
    old._worker.join(FLEET_WAIT)
    exited = not old._worker.is_alive()
    del old
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    after = fleet.stats()
    failed = fleet_failed(results)
    quarantines = after["quarantines"] - before["quarantines"]
    log(f"[fleet:kill] {len(results)} requests under load, replica 1 killed: quarantined "
        f"{quarantines}, rebuilt and READY {ready_s:.3f} s after the kill; failed {failed}; "
        f"retries {after['retries'] - before['retries']}; the killed engine's worker exited: "
        f"{exited}; allocated {m0 / 2**20:.1f} MiB before the kill, {m1 / 2**20:.1f} after "
        f"(weights {weight_bytes / 2**20:.1f} MiB)")
    if failed or quarantines != 1 or not exited or m1 - m0 > weight_bytes / 2:
        raise AssertionError(f"fleet kill: failed {failed}, quarantines {quarantines}, "
                             f"worker exited {exited}, memory {m0} -> {m1}")
    return {"kill_to_ready_s": ready_s, "requests": len(results), "mem_mib": (m0 / 2**20,
                                                                             m1 / 2**20)}


def fleet_hedge(fleet, images: FleetImages) -> dict:
    """Phase 7k (c): replica 0's runner wedged (its call held), hedging on
    ``"auto"``: one request lands on replica 0, its hedge on replica 1
    answers, the straggler's late result is dropped."""
    from mx_rcnn_tpu_torch.serve.router import auto_hedge_delay

    eng = fleet._replicas[0].engine
    wedge = _Wedged(eng.runner)
    before = fleet.stats()
    delay = auto_hedge_delay(before["replica"][0]["engine"]["latency_estimates_s"])
    fleet.hedge_after = "auto"
    eng.runner = wedge
    try:
        t0 = time.monotonic()
        res = fleet.submit(images(next(images.count)), timeout=FLEET_WAIT).result(FLEET_WAIT)
        answer_s = time.monotonic() - t0
    finally:
        wedge.gate.set()
        eng.runner = wedge.runner
        fleet.hedge_after = None
    wait_for(lambda: fleet.pending == 0, FLEET_WAIT, "fleet hedge: the straggler never settled")
    after = fleet.stats()
    got = {k: after[k] - before[k] for k in ("hedges", "hedge_wins", "completed", "failed")}
    log(f"[fleet:hedge] hedge_after auto = {delay:.4f} s (3x replica 0's full estimate); the "
        f"wedged replica held the request, the hedge on replica {res['replica_id']} answered "
        f"in {answer_s:.3f} s; {got}")
    if not wedge.entered.is_set() or res["replica_id"] != 1 or \
            got != {"hedges": 1, "hedge_wins": 1, "completed": 1, "failed": 0}:
        raise AssertionError(f"fleet hedge: replica {res['replica_id']}, {got}")
    return {"hedge_after_s": delay, "answer_s": answer_s}


def fleet_swap(fleet, images: FleetImages, new_variables, counters: dict, oracle,
               rehearsal: bool) -> dict:
    """Phase 7k (d): ``swap_weights`` to the second tree under a load of 4
    in flight: no failed request; every response's generation the old or
    the new one, both served, and each bitwise the single runner's on that
    generation's weights."""
    gen0 = fleet.generation
    load = FleetLoad(fleet, images, depth=4)
    try:
        load.wait_done(4 if rehearsal else 8)
        t0 = time.perf_counter()
        gen = fleet.swap_weights(new_variables)
        roll_s = time.perf_counter() - t0
        load.wait_done(load.done() + (2 if rehearsal else 8))
        results = load.stop()
    finally:
        load.halt()
    failed = fleet_failed(results)
    served = [(i, r) for i, r in results if not isinstance(r, str)]
    gens = [r["generation"] for _, r in served]
    bad = fleet_oracle(counters, oracle, images, [(i, r) for i, r in served
                                                  if r["generation"] == gen0])
    if oracle is not None:
        with uncounted(counters):
            oracle.swap_weights(new_variables, generation=gen)
    bad += fleet_oracle(counters, oracle, images, [(i, r) for i, r in served
                                                   if r["generation"] == gen])
    log(f"[fleet:swap] {len(results)} requests under load, rolled to generation {gen} in "
        f"{roll_s:.3f} s over {len(fleet.stats()['replica'])} replicas; failed {failed}; "
        f"generations {gens.count(gen0)} x {gen0}, {gens.count(gen)} x {gen}; each bitwise its "
        f"generation's single runner: {not bad if oracle is not None else 'not checked'}")
    if failed or bad or set(gens) != {gen0, gen} or gen != gen0 + 1:
        raise AssertionError(f"fleet swap: failed {failed}, gens {set(gens)}, differ {bad}")
    return {"roll_s": roll_s, "requests": len(results)}


def fleet_cache(fleet, images: FleetImages, counters: dict, oracle) -> dict:
    """Phase 7k (e): one image six times at once (a leader and followers
    that coalesce onto its call), then four times more (cache hits): every
    answer the leader's, bitwise, and the leader the single runner's."""
    i = next(images.count)
    img = images(i)
    before = fleet.stats()["cache"]
    leader = fleet.submit(img, timeout=FLEET_WAIT)
    rest = [fleet.submit(img, timeout=FLEET_WAIT) for _ in range(5)]
    first = leader.result(FLEET_WAIT)
    got = [r.result(FLEET_WAIT) for r in rest]
    got += [fleet.submit(img, timeout=FLEET_WAIT).result(FLEET_WAIT) for _ in range(4)]
    after = fleet.stats()["cache"]
    hits, coalesced = after["hits"] - before["hits"], after["coalesced"] - before["coalesced"]
    same = all(same_result(r, first) for r in got)
    bad = fleet_oracle(counters, oracle, images, [(i, first)])
    log(f"[fleet:cache] one image ten times: {coalesced} followers coalesced onto the leader's "
        f"call, {hits} cache hits; every answer the leader's: {same}; the leader the single "
        f"runner's: {not bad if oracle is not None else 'not checked'}; cache {after}")
    if not same or bad or coalesced < 1 or hits + coalesced != 9:
        raise AssertionError(f"fleet cache: hits {hits}, coalesced {coalesced}, same {same}")
    return {"hits": hits, "coalesced": coalesced}


def fleet_control(fleet, cfg, policy, images: FleetImages, rehearsal: bool) -> dict:
    """Phase 7k (f): ``build_controller`` and a tenant-scoped SLO engine
    whose alerts drive a ``QuotaGovernor``, all evaluated every
    ``ctrl.period_s`` (0.2 s).  A burst of 24 in flight (tenant b; 12 on
    the rehearsal) must
    drive an ``add_replica`` (a third engine on the card) and the quiet
    after it a ``retire_replica`` of that replica; then tenant a's requests
    with deadlines nothing meets (the injected failure window) beside
    tenant b's healthy ones must raise the availability burn alert and
    tighten tenant a alone, and healthy traffic must clear it and restore
    tenant a.  No accepted request of a healthy load fails."""
    from mx_rcnn_tpu_torch.ctrl import SLOEngine, build_controller, tenant_slos
    from mx_rcnn_tpu_torch.serve.tenancy import QuotaGovernor

    ctrl = cfg.ctrl
    slo, scaler = build_controller(cfg, fleet)
    governor = QuotaGovernor(policy)
    tslo = SLOEngine(tenant_slos(ctrl, ("a", "b")), fast_s=ctrl.burn_fast_s,
                     slow_s=ctrl.burn_slow_s, burn_factor=ctrl.burn_factor,
                     on_alert=governor.on_alert)
    t0 = time.monotonic()
    stamp = {}
    healthy, loads = [], []
    before = fleet.stats()

    def load(**kw) -> FleetLoad:
        loads.append(FleetLoad(fleet, images, **kw))
        return loads[-1]

    def routable():
        return sorted(r["rid"] for r in fleet.stats()["replica"]
                      if r["state"] in ("ready", "degraded"))

    def alerted(engine, name, event):
        return any(a["slo"] == name and a["event"] == event for a in list(engine.alerts))

    try:
        for loop in (slo, tslo, scaler):
            loop.start(ctrl.period_s)
        burst = load(depth=12 if rehearsal else 24, tenant="b")
        wait_for(lambda: any(d["action"] == "up" for d in scaler.resize_timeline()), 60,
                 "fleet control: no scale-up under the burst")
        stamp["up"] = time.monotonic() - t0
        healthy += burst.stop()
        wait_for(lambda: len(routable()) == 3, FLEET_WAIT, "fleet control: the added replica "
                 "never reached rotation")
        stamp["added_ready"] = time.monotonic() - t0
        wait_for(lambda: any(d["action"] == "down" for d in scaler.resize_timeline())
                 and len(fleet.stats()["replica"]) == 2, 60,
                 "fleet control: no scale-down in the quiet spell")
        stamp["down"] = time.monotonic() - t0
        good = load(depth=2, tenant="b")
        bad = load(depth=1, tenant="a", timeout=1e-4)
        wait_for(lambda: alerted(slo, "availability", "start")
                 and ("tighten", "a") in governor.actions, 60,
                 "fleet control: no availability burn alert in the failure window")
        stamp["burn_start"] = time.monotonic() - t0
        injected = bad.stop()
        recovered = load(depth=1, tenant="a")
        wait_for(lambda: alerted(slo, "availability", "stop")
                 and ("restore", "a") in governor.actions, 60,
                 "fleet control: the availability burn alert never cleared")
        stamp["burn_stop"] = time.monotonic() - t0
        healthy += good.stop() + recovered.stop()
    finally:
        for running in loads:
            running.halt()
        scaler.stop()
        slo.stop()
        tslo.stop()
    decisions = [(d["action"], d.get("replica")) for d in scaler.resize_timeline()]
    alerts = [(a["slo"], a["event"]) for a in slo.alerts]
    talerts = [(a["slo"], a["event"]) for a in tslo.alerts]
    after = fleet.stats()
    failed = fleet_failed(healthy)
    log(f"[fleet:control] period {ctrl.period_s} s; seconds from the start: "
        f"{ {k: round(v, 2) for k, v in stamp.items()} }; resizes {decisions} (added "
        f"{after['added'] - before['added']}, retired {after['retired'] - before['retired']}); "
        f"burn alerts {alerts}; tenant alerts {talerts}; governor {governor.actions}; "
        f"injected failures {len(bad.refused)} refused + "
        f"{len(fleet_failed(injected))} failed; healthy requests {len(healthy)}, failed {failed}")
    added = [r for a, r in decisions if a == "up"]
    if failed or decisions[:1] != [("up", added[0])] or ("down", added[0]) not in decisions \
            or governor.actions != [("tighten", "a"), ("restore", "a")] \
            or ("availability[b]", "start") in talerts:
        raise AssertionError(f"fleet control: {decisions}, {governor.actions}, {talerts}, "
                             f"failed {failed}")
    return {"seconds": stamp, "decisions": decisions, "alerts": alerts,
            "governor": governor.actions}


def fleet_drills(dev, rehearsal: bool, seed: int, fleet, cfg, policy, images: FleetImages,
                 counters: dict, oracle) -> dict:
    """Phase 7k (b)-(f) on a started fleet (the phase's, or the lockcheck
    child's with no ``oracle``)."""
    from mx_rcnn_tpu_torch.weights import init_variables

    new = init_variables(cfg.model, torch.Generator().manual_seed(seed + 1))
    new["box_head.cls_score.bias"][1:5] = 4.0
    weight_bytes = sum(t.numel() * t.element_size() for t in new.values())
    return {"kill": fleet_kill(dev, fleet, images, weight_bytes, rehearsal),
            "hedge": fleet_hedge(fleet, images),
            "swap": fleet_swap(fleet, images, new, counters, oracle, rehearsal),
            "cache": fleet_cache(fleet, images, counters, oracle),
            "control": fleet_control(fleet, cfg, policy, images, rehearsal)}


FLEET_THREADS = ("fleet-", "serve-worker", "serve-watchdog")


def fleet_threads() -> list:
    return [t.name for t in threading.enumerate() if t.name.startswith(FLEET_THREADS)]


def fleet_start(dev, rehearsal: bool, seed: int):
    """The phase's fleet: ``build_fleet`` of 2 replicas on ``dev``, started,
    with its config, weights and shared tenancy policy."""
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet
    from mx_rcnn_tpu_torch.serve.tenancy import TenancyPolicy
    from mx_rcnn_tpu_torch.weights import init_variables

    cfg = fleet_cfg(rehearsal)
    variables = init_variables(cfg.model, torch.Generator().manual_seed(seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    policy = TenancyPolicy.from_config(cfg.serve.tenancy)
    t0 = time.perf_counter()
    fleet = build_fleet(cfg, variables, n_replicas=2, device=dev, tenancy=policy,
                        supervisor_poll=0.05)
    fleet.start()
    return fleet, cfg, variables, policy, time.perf_counter() - t0


def fleet_lockcheck(rehearsal: bool, seed: int) -> dict:
    """Phase 7k's sanitized run: ``chip_smoke.py --fleet-lockcheck-child``
    under ``MX_RCNN_LOCKCHECK=1`` runs (b)-(f) on a fleet of its own: zero
    violations."""
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--fleet-lockcheck-child",
           "--seed", str(seed)] + (["--cpu-rehearsal"] if rehearsal else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, MX_RCNN_LOCKCHECK="1"),
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.strip().splitlines()[:-1]:
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"fleet lockcheck: the child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[fleet:lockcheck] child {time.perf_counter() - t0:.2f} s: sanitizer installed "
        f"{got['installed']}, violations {got['violations']}, threads left {got['threads']}; "
        f"order graph (held -> acquired), {sum(len(v) for v in got['graph'].values())} edges:")
    for held, acquired in sorted(got["graph"].items()):
        log(f"  {held} -> {', '.join(acquired)}")
    if not got["installed"] or got["violations"] != 0 or got["threads"] or not got["drained"]:
        raise AssertionError(f"fleet lockcheck: {got}")
    return got


def fleet_lockcheck_child(dev, rehearsal: bool, seed: int) -> int:
    """The process phase 7k starts under ``MX_RCNN_LOCKCHECK=1``: a fleet of
    its own through (b)-(f), then ``drain()``.  Prints one JSON line last."""
    from mx_rcnn_tpu_torch.analysis import lockcheck

    if rehearsal:
        torch.set_num_threads(2)   # as the phase's own fleet
    fleet, cfg, _, policy, _ = fleet_start(dev, rehearsal, seed)
    try:
        fleet_drills(dev, rehearsal, seed, fleet, cfg, policy, FleetImages(rehearsal, seed),
                     {}, None)
        drained = fleet.drain(timeout=FLEET_WAIT)
    finally:
        fleet.stop()
    if fleet_threads():
        time.sleep(0.2)   # a request's watcher leaves just after its latch
    print(json.dumps({"installed": lockcheck.enabled(), "violations": lockcheck.violation_count(),
                      "graph": lockcheck.order_graph(), "drained": drained,
                      "threads": fleet_threads()}), flush=True)
    return 0


def fleet_kernels(dev, rehearsal: bool, cfg, store: dict, nms_store: dict,
                  chunk_us: dict) -> dict:
    """Phase 7k's kernels at the fleet's shapes: B1 (bf16 within one ulp,
    f32 bitwise) and B3 (bitwise) on (a)'s last call, B4 (bitwise) on the
    last ``proposals`` call of the ``rpn.nms_impl=pallas`` fleet, each timed
    as in phase 3: the ``kernels`` line's ``@fleet`` entries."""
    clock = Clock(dev)
    iters, plain_iters = (2, 1) if rehearsal else (20, 3)
    (pyr, rois), *_ = store["pool"]
    fwd = {}
    for dt, case in ((torch.bfloat16, "fleet"), (torch.float32, "f32_fleet")):
        r = hold_fwd({l: f.to(dt) for l, f in pyr.items()}, rois, cfg.model.rcnn.pooled_size,
                     cfg.model.rcnn.sampling_ratio, clock, iters, plain_iters)
        if dt == torch.float32:
            r["match"] = r["match"] and r["max_abs_err"] == 0.0
        fwd[case] = r
        log(f"[kernel:roi_align@fleet:{case}] {r['shape']}: match={r['match']} "
            f"max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} kernel_ms={r['kernel_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f}")
    middle = store.get("_launch") or store["fused_middle_levels_plain"]
    found = {"fused_middle": hold_middle(middle[0], chunk_us["fused_middle"], clock, iters,
                                         plain_iters),
             "nms": hold_nms(nms_store["nms_keep_sorted_cuda"][0], chunk_us["nms"], clock, iters,
                             plain_iters)}
    log_proposal_kernels(found, "fleet")
    return {"roi_align@fleet": kernel_entry(fwd), "fused_middle@fleet": found["fused_middle"],
            "nms@fleet": found["nms"]}


def fleet_phase(dev, rehearsal: bool, seed: int, chunk_us: dict) -> dict:
    """Phase 7k: the serving fleet and its control loop on ``r50_fpn_coco``
    at full width (800x1344, 1000 proposals, random weights from the seed):
    ``build_fleet`` of 2 replicas on the one card, then (a)
    :func:`fleet_route` and :func:`fleet_proposals`, (b)-(f)
    :func:`fleet_drills`, (g) ``drain()``, the kernels at the fleet's shapes
    (:func:`fleet_kernels`) and (b)-(f) again under the sanitizer
    (:func:`fleet_lockcheck`).  The ``fleet`` path's launches are (a)'s and
    (b)-(f)'s, from 0 before each to after it, the added replica's warm-up
    included and the single runner's references not;
    ``fleet_proposals``'s are the second fleet's requests."""
    from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels
    from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_cuda
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner

    t_phase = time.perf_counter()
    counters = {"roi_align": multilevel_roi_align_cuda, "fused_middle": fused_middle_levels,
                "nms": nms_mask_cuda}
    card = card_line() if dev.type == "cuda" else "cpu rehearsal"
    threads = torch.get_num_threads()
    if rehearsal:
        torch.set_num_threads(2)   # a few engines share the host: no oversubscription
    images = FleetImages(rehearsal, seed)
    fleet, cfg, variables, policy, warm_s = fleet_start(dev, rehearsal, seed)
    store, nms_store = {}, {}
    try:
        oracle = DetectorRunner(cfg, variables, batch_size=1, device=dev)
        oracle.warmup()
        log(f"[fleet] {card}; {FLEET_CONFIG} at {cfg.data.image_size}, "
            f"{cfg.model.rpn.test_post_nms_top_n} proposals, one request a call: 2 replicas "
            f"warmed in {warm_s:.1f} s on {sorted({str(r.engine.runner.device) for r in fleet._replicas.values()})}")
        for fn in counters.values():
            fn.launches = 0
        route = fleet_route(fleet, images, counters, oracle, store)
        launches = {k: fn.launches for k, fn in counters.items()}
        prop = fleet_proposals(dev, rehearsal, seed, variables, images, counters, nms_store)
        for fn in counters.values():
            fn.launches = 0
        drills = fleet_drills(dev, rehearsal, seed, fleet, cfg, policy, images, counters, oracle)
        launches = {k: launches[k] + fn.launches for k, fn in counters.items()}
        clean = fleet.drain(timeout=FLEET_WAIT)
    finally:
        fleet.stop()
    if fleet_threads():
        time.sleep(0.2)   # a request's watcher leaves just after its latch
    left = fleet_threads()
    log(f"[fleet:drain] drained clean {clean}; threads left {left}; fleet launches {launches}")
    if not clean or left:
        raise AssertionError(f"fleet drain: clean {clean}, threads left {left}")
    if dev.type == "cuda" and min(launches["roi_align"], launches["fused_middle"]) < 1:
        raise AssertionError(f"fleet: B1 or B3 never launched ({launches})")
    torch.set_num_threads(threads)
    kernels = fleet_kernels(dev, rehearsal, cfg, store, nms_store, chunk_us)
    sanitized = fleet_lockcheck(rehearsal, seed)
    d = drills
    log(f"[fleet] phase 7k {time.perf_counter() - t_phase:.2f} s: warm {warm_s:.2f} s, kill to "
        f"ready {d['kill']['kill_to_ready_s']:.3f} s, hedge after {d['hedge']['hedge_after_s']:.4f} "
        f"s answered in {d['hedge']['answer_s']:.3f} s, roll {d['swap']['roll_s']:.3f} s, cache "
        f"hits {d['cache']['hits']} coalesced {d['cache']['coalesced']}, control "
        f"{ {k: round(v, 2) for k, v in d['control']['seconds'].items()} }, sanitized child "
        f"violations {sanitized['violations']}; {card}")
    return {"paths": {"fleet": {"launches": launches},
                      "fleet_proposals": {"launches": prop["launches"]}},
            "kernels": kernels, "route": route, "drills": drills}


FAST_PATHS = {"roi_align": ("fast_alt", "fast_ingraph", "fast_pipe"),
              "roi_align_bwd": ("fast_alt", "fast_ingraph"),
              "fused_middle": ("fast_alt", "fast_ingraph"), "nms": ("fast_pipe",)}
MASK_PATHS = {"roi_align": ("mask_full", "mask_train", "mask_eval"),
              "roi_align_bwd": ("mask_train",), "fused_middle": ("mask_full",),
              "nms": ("mask_proposals",)}
LADDER_PATHS = {"roi_align": ("ladder",), "fused_middle": ("ladder",),
                "nms": ("ladder_proposals",)}
FORMS_PATHS = ("forms_accum", "forms")
EVALX_PATHS = ("evalx_sharded", "evalx_mask", "evalx_demo")
RUNTIME_PATHS = {"roi_align": ("runtime", "runtime_eval"), "roi_align_bwd": ("runtime",)}
OBS_PATHS = {"roi_align": ("obs_train", "obs_serve"), "roi_align_bwd": ("obs_train",),
             "fused_middle": ("obs_serve",), "nms": ("obs_proposals",)}
FLEET_PATHS = {"roi_align": ("fleet", "fleet_proposals"), "fused_middle": ("fleet",),
               "nms": ("fleet_proposals",)}
KERNELS = {
    "roi_align": ("mx_rcnn_tpu_torch/csrc/roi_align.cu", "mx_rcnn_tpu/ops/pallas/roi_align.py:393",
                  ("full", "train", "eval", "roidb", "c4_full", "c4_train", "c4_eval",
                   *FAST_PATHS["roi_align"], *MASK_PATHS["roi_align"],
                   *LADDER_PATHS["roi_align"], *FORMS_PATHS, *EVALX_PATHS,
                   *RUNTIME_PATHS["roi_align"], *OBS_PATHS["roi_align"],
                   *FLEET_PATHS["roi_align"])),
    "roi_align_bwd": ("mx_rcnn_tpu_torch/csrc/roi_align_bwd.cu",
                      "mx_rcnn_tpu/ops/pallas/roi_align.py:623",
                      ("train", "roidb", "c4_train", *FAST_PATHS["roi_align_bwd"],
                       *MASK_PATHS["roi_align_bwd"], *FORMS_PATHS,
                       *RUNTIME_PATHS["roi_align_bwd"], *OBS_PATHS["roi_align_bwd"])),
    "fused_middle": ("mx_rcnn_tpu_torch/csrc/middle.cu",
                     "mx_rcnn_tpu/ops/pallas/middle.py:145",
                     ("full", "c4_full", *FAST_PATHS["fused_middle"],
                      *MASK_PATHS["fused_middle"], *LADDER_PATHS["fused_middle"],
                      *OBS_PATHS["fused_middle"], *FLEET_PATHS["fused_middle"])),
    "nms": ("mx_rcnn_tpu_torch/csrc/nms.cu", "mx_rcnn_tpu/ops/pallas/nms.py:75",
            ("proposals", "c4_proposals", *FAST_PATHS["nms"], *MASK_PATHS["nms"],
             *LADDER_PATHS["nms"], *OBS_PATHS["nms"], *FLEET_PATHS["nms"])),
}
# Phase c4's entries: the same kernels at the single-level C4 shapes,
# counted over phase c4's paths alone.
KERNELS.update({
    "roi_align@c4": (*KERNELS["roi_align"][:2], ("c4_full", "c4_train", "c4_eval")),
    "roi_align_bwd@c4": (*KERNELS["roi_align_bwd"][:2], ("c4_train",)),
    "fused_middle@c4": (*KERNELS["fused_middle"][:2], ("c4_full",)),
    "nms@c4": (*KERNELS["nms"][:2], ("c4_proposals",)),
})
# Phase 7d's entries: the kernels on the Fast R-CNN and alternate paths'
# inputs, counted over phase 7d's paths alone.
KERNELS.update({f"{k}@fast": (*KERNELS[k][:2], on) for k, on in FAST_PATHS.items()})
# Phase 7e's entries: B1 and B2 at the mask branch's 14x14, counted over
# phase 7e's paths alone (both output sizes: a path launches B1 at 7 and
# at 14 in one forward).
KERNELS.update({f"{k}@mask": (*KERNELS[k][:2], MASK_PATHS[k])
                for k in ("roi_align", "roi_align_bwd")})
# Phase 7f's entries: B1, B3 and B4 at the 512x864 bucket of the ladder,
# counted over phase 7f's paths alone.
KERNELS.update({f"{k}@small": (*KERNELS[k][:2], on) for k, on in LADDER_PATHS.items()})
# Phase 7g's entries: B1 and B2 on the second microbatch of the last
# accumulated step, counted over the accumulation run alone.
KERNELS.update({f"{k}@accum": (*KERNELS[k][:2], ("forms_accum",))
                for k in ("roi_align", "roi_align_bwd")})
# Phase 7k's entries: B1, B3 and B4 at the fleet's shapes (800x1344, one
# request a call), counted over phase 7k's paths alone.
KERNELS.update({f"{k}@fleet": (*KERNELS[k][:2], on) for k, on in FLEET_PATHS.items()})


PKG = "mx_rcnn_tpu_torch"


def import_tree(root: str, modules) -> dict:
    """Import ``modules`` (names under the package) from the package in the
    tree ``root``, beside this tree's: this tree's modules leave
    ``sys.modules`` while ``root``'s load, and come back after.  Raises
    when a module does not come from ``root``."""
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
    ap.add_argument("--lockcheck-child", action="store_true",
                    help="phase 7j (d)'s child: run under MX_RCNN_LOCKCHECK=1 by the smoke")
    ap.add_argument("--fleet-lockcheck-child", action="store_true",
                    help="phase 7k's sanitized child: run under MX_RCNN_LOCKCHECK=1 by the smoke")
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
    if args.lockcheck_child:
        return lockcheck_child(dev, args.cpu_rehearsal, args.seed)
    if args.fleet_lockcheck_child:
        return fleet_lockcheck_child(dev, args.cpu_rehearsal, args.seed)

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
    fast = fast_rcnn_phase(dev, args.cpu_rehearsal, args.seed,
                           {k: kernels[k]["extra"]["chunk_step_us"] for k in ("fused_middle", "nms")})
    paths.update(fast["paths"])
    mask = mask_phase(dev, args.cpu_rehearsal, args.seed)
    paths.update(mask["paths"])
    chunk_us = {k: kernels[k]["extra"]["chunk_step_us"] for k in ("fused_middle", "nms")}
    ladder = ladder_phase(dev, args.cpu_rehearsal, args.seed, chunk_us)
    paths.update(ladder["paths"])
    forms = forms_phase(dev, args.cpu_rehearsal, args.seed)
    paths.update(forms["paths"])
    evalx = evalx_phase(dev, args.cpu_rehearsal, args.seed, paths["train"], paths["eval"])
    paths.update(evalx["paths"])
    paths.update(runtime_phase(dev, args.cpu_rehearsal, args.seed, paths["train"])["paths"])
    paths.update(obs_phase(dev, args.cpu_rehearsal, args.seed, paths["train"])["paths"])
    fleet = fleet_phase(dev, args.cpu_rehearsal, args.seed, chunk_us)
    paths.update(fleet["paths"])
    if not args.cpu_rehearsal:
        reference_phase(dev, args.seed)
        train_reference_phase(dev, args.seed)
    parent = parent_phase(dev, args.parent, kernels) if args.parent else {}
    kernels.update(c4["kernels"])
    kernels.update(fast["kernels"])
    kernels.update(mask["kernels"])
    kernels.update(ladder["kernels"])
    kernels.update(forms["kernels"])
    kernels.update(fleet["kernels"])

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
