"""Time variants of kernel B1 (``csrc/roi_align.cu``), each built from an
edited copy of the source, against the source as it stands, on the card.

    python -m mx_rcnn_tpu_torch.utils.kernel_variants [--seed 0] [--rounds 3]

The input is the serving shape of ``r50_fpn_coco``: batch 2, a bf16 P2-P5
pyramid of 256 channels on the 800x1344 canvas, and the 1000 rois an image
that the proposal stage makes from random RPN outputs (as ``chip_smoke.py``
makes them).  A variant is a list of text substitutions, each of which
must occur exactly once in the source: the block size (``kThreads``) and
the run-time form of the sample loops, which ``sr = 2`` otherwise skips
for a form with the loop bounds fixed at compile time.  Every variant is
reached through the wrapper, ``ops/cuda/roi_align.py``, with its C entry
point swapped, and timed on its kernel alone
(``utils/profiling.py::entry_ms``), the committed source first in each
round.  Prints the card and one JSON line: per variant its ms in each
round and whether its output is bitwise the committed source's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from mx_rcnn_tpu_torch.ops.cuda import _build
from mx_rcnn_tpu_torch.utils.profiling import card_line, entry_ms

VARIANTS = {
    **{f"threads_{t}": [("kThreads = 256;", f"kThreads = {t};")]
       for t in (64, 128, 224, 448, 512, 1024)},
    "sr_at_run_time": [("if (sr == 2) {", "if (false) {")],
}


def build_variants(variants=VARIANTS) -> dict:
    """Build each variant's library (one nvcc each, all started together)
    under ``_build/variants/``; returns {name: ctypes.CDLL}."""
    src = (_build.CSRC / "roi_align.cu").read_text()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times in the source")
            text = text.replace(old, new)
        out = _build.BUILD_DIR / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "roi_align.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / "libroi_align.so"), str(out / "roi_align.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelError(f"variant {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(_build.BUILD_DIR / "variants" / name / "libroi_align.so"))
    return libs


def serving_inputs(seed: int, dev: torch.device):
    """The bf16 pyramid and the proposal rois of the serving shape."""
    from mx_rcnn_tpu_torch.config import get_config
    from mx_rcnn_tpu_torch.detection.graph import level_anchors
    from mx_rcnn_tpu_torch.ops.proposals import generate_fpn_proposals

    cfg = get_config("r50_fpn_coco")
    rpn, c = cfg.model.rpn, cfg.model.fpn.channels
    b, (h, w) = 2, cfg.data.image_size
    g = torch.Generator().manual_seed(seed)
    feats = {l: torch.empty((b, h >> l, w >> l, 1), device=dev) for l in range(2, 7)}
    anchors = level_anchors(cfg.model, feats)
    scores = {l: torch.sigmoid(0.5 * torch.randn((b, a.shape[0]), generator=g))
              .to(torch.bfloat16).to(dev) for l, a in anchors.items()}
    deltas = {l: (0.2 * torch.randn((b, a.shape[0], 4), generator=g))
              .to(torch.bfloat16).to(dev) for l, a in anchors.items()}
    image_hw = torch.tensor([[h, w], [h - 176, w - 320]], dtype=torch.float32, device=dev)
    rois = generate_fpn_proposals(
        scores, deltas, anchors, image_hw, rpn.test_pre_nms_top_n, rpn.test_post_nms_top_n,
        rpn.nms_threshold, rpn.min_size, fused_middle=True).rois.contiguous()
    pyr = {l: torch.randn((b, h >> l, w >> l, c), generator=g).to(torch.bfloat16).to(dev)
           for l in range(2, 6)}
    return pyr, rois, cfg.model.rcnn.pooled_size, cfg.model.rcnn.sampling_ratio


def main() -> None:
    from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_cuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    dev = torch.device("cuda")
    libs = build_variants()
    pyr, rois, s, sr = serving_inputs(args.seed, dev)

    def call():
        return multilevel_roi_align_cuda(pyr, rois, s, sr)

    def run(lib):
        """The output and the kernel-alone ms with ``lib``'s entry point
        (the committed build when None)."""
        saved = _build.entry
        if lib is not None:
            def entry(name, symbol, argtypes):
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                return fn

            _build.entry = entry
        try:
            out = call()
            fns = [lib.roi_align_forward] if lib is not None else _build._ENTRIES.values()
            return out, entry_ms(call, fns)
        finally:
            _build.entry = saved

    base = call()
    ms = {name: [] for name in ("committed", *libs)}
    bitwise = {}
    for _ in range(args.rounds):
        for name in ms:
            out, t = run(libs.get(name))
            ms[name].append(t)
            bitwise[name] = bitwise.get(name, True) and torch.equal(out, base)
    print(f"[card] {card_line()}", flush=True)
    print(json.dumps({"shape": f"B={rois.shape[0]} R={rois.shape[1]} C={base.shape[-1]} bf16",
                      "kernel_ms": ms, "bitwise": bitwise}), flush=True)
    if not all(bitwise.values()):
        raise SystemExit("a variant's output differs from the committed source's")


if __name__ == "__main__":
    main()
