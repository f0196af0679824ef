"""Continuous-deployment watcher: stage, gate, and roll new checkpoints
(port of the JAX package's ``tools/deploy_watch.py``).

Runs a serving fleet, arms a live SLO engine, and starts a
:class:`mx_rcnn_tpu_torch.ctrl.Deployer` over ``--ckpt-dir``: every
validated checkpoint step that lands while the watcher runs is
shadow-staged on a spare out-of-rotation replica, gated on bitwise parity
/ golden-set mAP / a shadow-scoped SLO against mirrored live traffic,
promoted through the zero-downtime roll, and watched for a post-promote
burn (automatic rollback under a new, higher generation).  Knobs come
from ``cfg.ctrl.deploy``; CLI flags override.  Real engines serve
``--config`` with random weights from a seed on the card (``--device
cpu`` on the CPU); a candidate is a port checkpoint
(``train/checkpoint.py``) whose weights fit that model.

Synthetic open-loop traffic (``--qps``) keeps the mirror fed when no
external callers exist.  One JSON line on stdout summarizes every
decision; the full timeline replays from ``--obs-dir`` via
``python -m mx_rcnn_tpu_torch.obs.report``.

Usage:
    python -m mx_rcnn_tpu_torch.tools.deploy_watch --ckpt-dir CKPTS \\
        --duration 60 --fake-engines --obs-dir OBS
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def _build_fleet(args):
    if args.fake_engines:
        from mx_rcnn_tpu_torch.serve import FleetRouter, InferenceEngine
        from mx_rcnn_tpu_torch.tools.soak import _SoakRunner

        def factory(rid: int) -> InferenceEngine:
            return InferenceEngine(
                _SoakRunner(args.service_time),
                replica_id=rid,
                hang_timeout=60.0,
                max_queue=args.max_queue,
            )

        return FleetRouter(factory, args.replicas, supervisor_poll=0.1)

    import torch

    from mx_rcnn_tpu_torch.config import get_config
    from mx_rcnn_tpu_torch.serve import build_fleet
    from mx_rcnn_tpu_torch.weights import init_variables

    cfg = get_config(args.config)
    variables = init_variables(cfg.model, torch.Generator().manual_seed(0))
    return build_fleet(
        cfg, variables, args.replicas,
        engine_kwargs={"hang_timeout": 300.0, "max_queue": args.max_queue},
        device=args.device,
        supervisor_poll=0.1,
    )


def run_watch(args: argparse.Namespace) -> dict:
    import numpy as np

    from mx_rcnn_tpu_torch import obs
    from mx_rcnn_tpu_torch.config import get_config
    from mx_rcnn_tpu_torch.ctrl import SLOEngine, build_deployer, default_slos
    from mx_rcnn_tpu_torch.serve import ServeError

    obs.configure(args.obs_dir)
    print(f"[deploy_watch] obs: run_id={obs.run_id()} dir={obs.out_dir()}",
          file=sys.stderr)

    cfg = get_config(args.config)
    fleet = _build_fleet(args)
    fleet.start()
    print(f"[deploy_watch] fleet of {args.replicas} ready; watching "
          f"{args.ckpt_dir}", file=sys.stderr)

    dc = cfg.ctrl.deploy
    live_slo = SLOEngine(
        default_slos(cfg.ctrl),
        fast_s=dc.burn_fast_s, slow_s=dc.burn_slow_s,
        burn_factor=dc.burn_factor,
    ).start(args.ctrl_period)

    overrides = {
        k: v for k, v in (
            ("mirror_rate", args.mirror_rate),
            ("min_mirrored", args.min_mirrored),
            ("shadow_window_s", args.shadow_window),
            ("watch_window_s", args.watch_window),
            ("poll_s", args.poll),
        ) if v is not None
    }
    dep = build_deployer(
        cfg, fleet, ckpt_dir=args.ckpt_dir, live_slo=live_slo, **overrides
    ).start(recover=True)

    img = np.zeros((48, 48, 3), np.float32)
    completed = failed = 0
    lock = threading.Lock()
    deadline = time.monotonic() + args.duration
    stop = threading.Event()

    def pump() -> None:
        nonlocal completed, failed
        while not stop.is_set() and time.monotonic() < deadline:
            try:
                fleet.infer(img, timeout=60.0)
                with lock:
                    completed += 1
            except ServeError:
                with lock:
                    failed += 1
            time.sleep(1.0 / max(args.qps, 0.1))

    pumps = [
        threading.Thread(target=pump, name=f"deploy-watch-pump-{i}",
                         daemon=True)
        for i in range(args.pump_threads)
    ]
    for t in pumps:
        t.start()
    try:
        while time.monotonic() < deadline:
            time.sleep(0.25)
    finally:
        stop.set()
        for t in pumps:
            t.join(60)
        dep.stop()
        live_slo.stop()
        fleet.stop()
        obs.close()

    decisions = [
        {k: v for k, v in h.items() if k != "slo_verdicts"}
        for h in dep.history
    ]
    return {
        "ckpt_dir": os.path.abspath(args.ckpt_dir),
        "obs_dir": os.path.abspath(args.obs_dir),
        "decisions": decisions,
        "promotions": sum(
            1 for h in dep.history if h["kind"] == "deploy_promote"
        ),
        "rollbacks": sum(
            1 for h in dep.history if h["kind"] == "deploy_rollback"
        ),
        "rejections": sum(
            1 for h in dep.history if h["kind"] == "deploy_reject"
        ),
        "generation": fleet.generation,
        "completed": completed,
        "failed": failed,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint dir to watch for validated steps")
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--qps", type=float, default=40.0,
                   help="synthetic open-loop traffic per pump thread")
    p.add_argument("--pump-threads", type=int, default=2)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--ctrl-period", type=float, default=0.5)
    p.add_argument("--config", default="tiny_synthetic")
    p.add_argument("--device", default=None,
                   help="real engines: the card by default; 'cpu' puts "
                        "every replica on the CPU")
    p.add_argument("--fake-engines", action="store_true",
                   help="runner-protocol fakes instead of real models")
    p.add_argument("--service-time", type=float, default=0.005,
                   help="--fake-engines: per-request service time")
    p.add_argument("--mirror-rate", type=float, default=None,
                   help="override cfg.ctrl.deploy.mirror_rate")
    p.add_argument("--min-mirrored", type=int, default=None)
    p.add_argument("--shadow-window", type=float, default=None)
    p.add_argument("--watch-window", type=float, default=None)
    p.add_argument("--poll", type=float, default=None,
                   help="override cfg.ctrl.deploy.poll_s")
    p.add_argument("--obs-dir", default=None,
                   help="obs journal dir (default: a temp dir)")
    args = p.parse_args(argv)
    if args.obs_dir is None:
        import tempfile

        args.obs_dir = tempfile.mkdtemp(prefix="deploy_watch_obs_")

    rec = run_watch(args)
    print(json.dumps(rec))
    print(f"[deploy_watch] {rec['promotions']} promoted, "
          f"{rec['rejections']} rejected, {rec['rollbacks']} rolled "
          f"back; fleet at generation {rec['generation']}",
          file=sys.stderr)
    return 0 if rec["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
