"""Serving soak: diurnal + spike traffic, live chaos, SLO verdicts (port of
the JAX package's ``tools/soak.py``).

The production rehearsal for the closed control loop.  One process runs,
concurrently:

* **traffic** — an open-loop arrival schedule composed from the shared
  profiles (``tools/loadgen.py::make_profile``): a compressed diurnal
  sine modulating the base rate, with periodic spike bursts multiplied
  on top, so the fleet sees troughs, peaks and steps in a single run;
* **the control plane** — an :class:`~mx_rcnn_tpu_torch.ctrl.SLOEngine`
  evaluating availability + latency SLOs on soak-scaled burn windows,
  and an :class:`~mx_rcnn_tpu_torch.ctrl.Autoscaler` resizing the fleet
  between ``--min-replicas`` and ``--max-replicas`` off queue/shed/p99
  pressure;
* **chaos** — a replica kill at mid-run (quarantine -> rebuild under
  load);
* **adversarial tenancy** (``--tenants``) — the mix becomes one
  open-loop schedule per tenant (flooder/bursty/latency-sensitive), the
  fleet enforces per-tenant token-bucket quotas (serve/tenancy.py), the
  SLO engine gains per-tenant SLO instances whose burn alerts tighten
  only the burning tenant's quota (QuotaGovernor), and the record gains
  a per-tenant verdict table: every well-behaved tenant must end HELD
  and the flooder QUOTA-CAPPED for the run to pass;
* **deployment** (``--deploy``) — a fresh validated checkpoint of the
  served weights lands mid-soak and a
  :class:`~mx_rcnn_tpu_torch.ctrl.Deployer` stages, gates and rolls it
  live: the record carries the whole shadow -> promote/reject story and
  the per-SLO verdicts must hold THROUGH the roll for the run to pass.

Verdict: the run PASSES only if every SLO held (whole-run error budget
not exhausted) and no accepted request was lost.  Prints
``[soak] SLO VERDICT: HELD`` (or ``VIOLATED``) on stderr and exactly
one ``soak`` JSON record as the LAST stdout line, carrying the per-SLO
verdicts, the autoscaler's resize-decision timeline (with the input
signals for every decision) and a per-degrade-level latency summary.

Two engine modes:

* default — real :func:`~mx_rcnn_tpu_torch.serve.fleet.build_fleet`
  engines of ``--config`` with random weights from a seed, on the card
  (``--device cpu`` puts them on the CPU);
* ``--fake-engines`` — a runner-protocol fake with a configurable
  service time, no model build: the shape of the rehearsal in seconds.

The JAX tool's ``--data-chaos`` (input-service chaos scenarios as
subprocesses) needs the chaos harness, which the port does not have.

Usage:
    python -m mx_rcnn_tpu_torch.tools.soak --config r50_fpn_coco --deploy \\
        --duration 20 --qps 6
    python -m mx_rcnn_tpu_torch.tools.soak --fake-engines --duration 12 --qps 40
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from mx_rcnn_tpu_torch.tools.loadgen import (
    _occupancy_summary,
    _percentile,
    make_profile,
    parse_tenant_load_spec,
    tenant_table_string,
)


class _SoakRunner:
    """Runner-protocol fake with a fixed service time (no model): the
    serving engine's runner surface, kept here so the tool never imports
    the test suite."""

    def __init__(self, delay: float, buckets=((64, 64),)):
        self.buckets = sorted(
            (tuple(b) for b in buckets), key=lambda b: b[0] * b[1]
        )
        self.batch_size = 1
        self.delay = delay
        self.generation = 0
        self._warmed = set()

    def levels(self):
        return ("full", "reduced", "proposals")

    def pick_bucket(self, h, w):
        for b in self.buckets:
            if b[0] >= h and b[1] >= w:
                return b
        return self.buckets[-1]

    def smaller_bucket(self, bucket):
        i = self.buckets.index(tuple(bucket))
        return self.buckets[i - 1] if i > 0 else None

    def warmup(self):
        for b in self.buckets:
            for mode in ("full", "reduced", "proposals"):
                self._warmed.add((mode, b))
        return len(self._warmed)

    def swap_weights(self, variables, generation=None):
        gen = self.generation + 1 if generation is None else int(generation)
        self.generation = gen
        return gen

    def run(self, mode, bucket, images):
        import numpy as np

        assert (mode, tuple(bucket)) in self._warmed
        time.sleep(self.delay)
        return [
            {
                "boxes": np.zeros((0, 4), np.float32),
                "scores": np.zeros(0, np.float32),
                "classes": np.zeros(0, np.int32),
                "generation": self.generation,
            }
            for _ in images
        ]


def _build_fake_fleet(args, tenancy=None):
    import numpy as np

    from mx_rcnn_tpu_torch.serve import FleetRouter, InferenceEngine

    def factory(rid: int) -> InferenceEngine:
        return InferenceEngine(
            _SoakRunner(args.service_time),
            replica_id=rid,
            hang_timeout=60.0,
            max_queue=args.max_queue,
            tenancy=tenancy,
            tenancy_admit=False,  # the router charges the quota
        )

    return FleetRouter(
        factory, args.replicas,
        supervisor_poll=0.05, hedge_after=None,
        tenancy=tenancy,
        # The tree a --deploy candidate carries; the fake runners ignore it.
        initial_weights={"w": np.zeros((4,), np.float32)},
    )


def _build_real_fleet(args, tenancy=None):
    import torch

    from mx_rcnn_tpu_torch.config import get_config
    from mx_rcnn_tpu_torch.serve import build_fleet
    from mx_rcnn_tpu_torch.weights import init_variables

    cfg = get_config(args.config)
    variables = init_variables(cfg.model, torch.Generator().manual_seed(0))
    kwargs = {} if tenancy is None else {"tenancy": tenancy}
    return build_fleet(
        cfg, variables, args.replicas,
        engine_kwargs={"hang_timeout": 300.0, "max_queue": args.max_queue},
        device=args.device,
        supervisor_poll=0.1,
        hedge_after="auto",
        **kwargs,
    )


def _drop_deploy_candidate(fleet, ckpt_dir: str) -> int:
    """Land a validated checkpoint of the weights the fleet serves under a
    fresh step (bitwise parity -> the roll itself is the event under
    test).  Runs off the arrival loop's thread, so that the write does not
    distort the latency SLO the run is judged on.  Returns the step."""
    from mx_rcnn_tpu_torch.train import checkpoint

    _, variables = fleet.current_weights()
    step = (checkpoint.latest_step(ckpt_dir) or 0) + 1
    checkpoint.save_checkpoint(ckpt_dir, checkpoint.weights_payload(step, variables))
    return step


def _deploy_story(deployer, t0: float) -> dict:
    """The shadow -> gate -> promote/reject (-> rollback) story from
    the Deployer's own journal mirror, soak-clock timestamps."""
    keep = ("step", "generation", "reason", "verdict", "mirrored",
            "compared", "mismatched", "from_generation", "to_generation",
            "restored_generation", "slo")
    kinds = [h["kind"] for h in deployer.history]
    return {
        "ckpt_dir": deployer.ckpt_dir,
        "timeline": [
            dict({k: h[k] for k in keep if k in h},
                 kind=h["kind"], t_s=round(h["t"] - t0, 2))
            for h in deployer.history
        ],
        "promoted": "deploy_promote" in kinds,
        "rejected": "deploy_reject" in kinds,
        "rolled_back": "deploy_rollback" in kinds,
        "decided": any(
            k in kinds for k in ("deploy_promote", "deploy_reject")
        ),
    }


def run_soak(args: argparse.Namespace) -> dict:
    import numpy as np

    from mx_rcnn_tpu_torch import obs
    from mx_rcnn_tpu_torch.config import CtrlConfig
    from mx_rcnn_tpu_torch.ctrl import (
        Autoscaler,
        ScalePolicy,
        SLOEngine,
        default_slos,
        tenant_slos,
    )
    from mx_rcnn_tpu_torch.serve import (
        Overloaded,
        QuotaExceeded,
        QuotaGovernor,
        ServeError,
        TenancyPolicy,
    )
    from mx_rcnn_tpu_torch.serve.tenancy import parse_table

    obs.configure(args.obs_dir, flush_s=max(args.ctrl_period, 0.5))
    print(f"[soak] obs: run_id={obs.run_id()} dir={obs.out_dir()}",
          file=sys.stderr)

    tenant_specs = getattr(args, "_tenant_specs", None)
    policy = None
    if tenant_specs:
        policy = TenancyPolicy(
            parse_table(tenant_table_string(tenant_specs))
        )
    fleet = (_build_fake_fleet if args.fake_engines
             else _build_real_fleet)(args, tenancy=policy)
    mode = "fake" if args.fake_engines else "real"
    print(f"[soak] starting {args.replicas} {mode} replica(s)...",
          file=sys.stderr)
    fleet.start()
    obs.register_status("fleet", fleet.stats)
    print("[soak] fleet ready", file=sys.stderr)

    # Burn windows scaled to the run so a soak-length incident can trip
    # both windows: minutes-long fast/slow windows would never fire in
    # a CI-sized rehearsal.
    fast_s = max(2.0, args.duration * 0.1)
    slow_s = max(fast_s, args.duration * 0.4)
    ctrl = CtrlConfig(
        availability_target=args.availability_target,
        latency_target=args.latency_target,
        latency_threshold_s=args.latency_threshold,
    )
    slos = default_slos(ctrl)
    governor = None
    if tenant_specs:
        # Per-tenant SLO instances for the WELL-BEHAVED tenants only:
        # the flooder is judged by its quota cap, not an SLO it is
        # expected to blow; its burn must never reach the governor.
        well_behaved = [
            e["name"] for e in tenant_specs if e["role"] != "flooder"
        ]
        slos = slos + tenant_slos(ctrl, well_behaved)
        governor = QuotaGovernor(policy)
    slo_engine = SLOEngine(
        slos, fast_s=fast_s, slow_s=slow_s,
        burn_factor=args.burn_factor,
        on_alert=None if governor is None else governor.on_alert,
    ).start(args.ctrl_period)
    scaler = Autoscaler(
        fleet,
        ScalePolicy(
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            load_high=args.load_high,
            load_low=args.load_low,
            down_dwell=args.down_dwell,
            up_cooldown_s=args.up_cooldown,
            down_cooldown_s=args.down_cooldown,
        ),
        p99_window_s=max(fast_s, 5.0),
    ).start(args.ctrl_period)

    deployer = None
    deploy_drop_t: list[float] = []
    drop_threads: list[threading.Thread] = []
    if args.deploy:
        import tempfile

        from mx_rcnn_tpu_torch.config import get_config
        from mx_rcnn_tpu_torch.ctrl import build_deployer

        deploy_ckpt = args.deploy_ckpt_dir or tempfile.mkdtemp(
            prefix="soak_deploy_ckpt_"
        )
        # Soak-scaled deploy knobs over cfg.ctrl.deploy: the gate must
        # settle inside one run, and the watch window spans the rest of
        # it so a post-roll burn still triggers rollback before the
        # verdict is read.
        deployer = build_deployer(
            get_config(args.config), fleet,
            ckpt_dir=deploy_ckpt, live_slo=slo_engine,
            poll_s=max(0.3, args.ctrl_period),
            mirror_rate=1.0, min_mirrored=4,
            shadow_window_s=min(8.0, args.duration * 0.25),
            watch_window_s=args.duration,
        ).start(recover=False)
        print(f"[soak] deploy: watching {deploy_ckpt}", file=sys.stderr)

    # Diurnal sine modulated by spike bursts: base * burst-multiplier.
    base = make_profile(
        "sine", args.qps, amplitude=args.amplitude,
        period_s=args.duration / args.cycles,
    )
    burst = make_profile(
        "spike", 1.0, spike_factor=args.spike_factor,
        period_s=args.duration / args.cycles, duty=args.duty,
    )

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (48, 48, 3), dtype=np.uint8) \
        if not args.fake_engines else np.zeros((48, 48, 3), np.float32)

    lock = threading.Lock()
    by_level: dict[str, list[float]] = {}
    submitted = shed = quota = failed = 0
    pending: list[threading.Thread] = []
    tstats: dict[str, dict] = {
        e["name"]: {"submitted": 0, "shed": 0, "quota": 0, "failed": 0,
                    "lat": []}
        for e in (tenant_specs or [])
    }

    def collect(freq, t_submit: float, tenant: str | None = None) -> None:
        nonlocal quota, failed
        ts = tstats.get(tenant)
        try:
            res = freq.result(timeout=args.deadline + 60.0)
        except QuotaExceeded:
            with lock:
                quota += 1
                if ts is not None:
                    ts["quota"] += 1
            return
        except ServeError:
            with lock:
                failed += 1
                if ts is not None:
                    ts["failed"] += 1
            return
        lat = time.monotonic() - t_submit
        level = res.get("level", "full")
        with lock:
            by_level.setdefault(level, []).append(lat)
            if ts is not None:
                ts["lat"].append(lat)

    killed_rid = None
    t0 = time.monotonic()
    next_at = t0
    deadline_wall = t0 + args.duration

    def chaos_tick(t: float) -> None:
        """The soak's mid-run events, shared by both arrival shapes."""
        nonlocal killed_rid
        if deployer is not None and not deploy_drop_t \
                and t >= args.duration * 0.3:
            deploy_drop_t.append(t)
            th = threading.Thread(
                target=_drop_deploy_candidate,
                args=(fleet, deployer.ckpt_dir),
                name="soak-deploy-drop", daemon=True,
            )
            th.start()
            drop_threads.append(th)
            print(f"[soak] deploy: candidate landing at t={t:.1f}s",
                  file=sys.stderr)
        if args.kill_replica and killed_rid is None \
                and t >= args.duration * 0.4:
            # Kill a currently-routable replica (rids are sparse under
            # autoscaling, so pick from live stats, not range()).  Only
            # with a failover target standing: killing the LAST routable
            # replica can't prove resilience, only loss — if the
            # autoscaler has drained to one, wait for the next tick.
            live = [rep["rid"] for rep in fleet.stats()["replica"]
                    if rep["state"] in ("ready", "degraded")]
            if len(live) >= 2:
                killed_rid = min(live)
                fleet.kill_replica(killed_rid, "soak chaos")
                print(f"[soak] killed replica {killed_rid} at "
                      f"t={t:.1f}s", file=sys.stderr)

    if tenant_specs:
        # One open-loop schedule per tenant: the flooder bouncing off its
        # quota never slows the victims' offered load, and a bursty
        # tenant rides its own spike profile.
        period = args.duration / args.cycles

        def tenant_loop(ent: dict) -> None:
            nonlocal submitted, shed, quota, failed
            name = ent["name"]
            ts = tstats[name]
            rate = make_profile(
                ent["profile"],
                ent["qps"] if ent["qps"]
                else max(args.qps / len(tenant_specs), 0.1),
                amplitude=args.amplitude, period_s=period,
                spike_factor=args.spike_factor, duty=args.duty,
            )
            nxt = t0
            while True:
                now = time.monotonic()
                if now >= deadline_wall:
                    return
                if now < nxt:
                    time.sleep(min(nxt - now, 0.02))
                    continue
                nxt += 1.0 / rate(now - t0)
                try:
                    freq = fleet.submit(
                        img, timeout=args.deadline, tenant=name
                    )
                except QuotaExceeded:
                    with lock:
                        submitted += 1
                        quota += 1
                        ts["submitted"] += 1
                        ts["quota"] += 1
                    continue
                except Overloaded:
                    with lock:
                        submitted += 1
                        shed += 1
                        ts["submitted"] += 1
                        ts["shed"] += 1
                    continue
                except ServeError:
                    with lock:
                        submitted += 1
                        failed += 1
                        ts["submitted"] += 1
                        ts["failed"] += 1
                    continue
                with lock:
                    submitted += 1
                    ts["submitted"] += 1
                th = threading.Thread(
                    target=collect, args=(freq, now, name), daemon=True
                )
                th.start()
                pending.append(th)

        loops = [
            threading.Thread(target=tenant_loop, args=(e,), daemon=True)
            for e in tenant_specs
        ]
        for th in loops:
            th.start()
        while True:
            now = time.monotonic()
            if now >= deadline_wall:
                break
            chaos_tick(now - t0)
            time.sleep(0.05)
        for th in loops:
            th.join(timeout=args.duration + 120.0)
    else:
        while True:
            now = time.monotonic()
            if now >= deadline_wall:
                break
            if now < next_at:
                time.sleep(min(next_at - now, 0.02))
                continue
            t = now - t0
            next_at += 1.0 / (base(t) * burst(t))
            chaos_tick(t)
            try:
                freq = fleet.submit(img, timeout=args.deadline)
            except Overloaded:
                with lock:
                    submitted += 1
                    shed += 1
                continue
            except ServeError:
                with lock:
                    submitted += 1
                    failed += 1
                continue
            with lock:
                submitted += 1
            th = threading.Thread(
                target=collect, args=(freq, now), daemon=True
            )
            th.start()
            pending.append(th)

    print(f"[soak] load window done ({submitted} arrivals); draining...",
          file=sys.stderr)
    for th in pending + drop_threads:
        th.join(timeout=args.deadline + 120.0)
    if deployer is not None:
        deployer.stop()
    scaler.stop()
    slo_engine.stop()   # runs a final observe() so verdicts cover the tail
    stats = fleet.stats()
    fleet.stop(timeout=240.0)

    verdicts = slo_engine.verdicts()
    tenants_rec = None
    if tenant_specs:
        # Per-tenant verdict table: well-behaved tenants must have every
        # tenant-scoped SLO held; the flooder is judged by its cap — a
        # flooder that was never quota-limited means the bucket leaked.
        vds_by_tenant: dict[str, list] = {}
        for v in verdicts:
            if v.get("tenant"):
                vds_by_tenant.setdefault(v["tenant"], []).append(v)
        tenants_rec = {}
        for e in tenant_specs:
            name = e["name"]
            ts = tstats[name]
            lat = sorted(ts["lat"])
            vds = vds_by_tenant.get(name, [])
            slo_held = all(v["held"] for v in vds) if vds else None
            if e["role"] == "flooder":
                verdict = "QUOTA-CAPPED" if ts["quota"] > 0 else "UNCAPPED"
            elif slo_held is not False and ts["failed"] == 0 and lat:
                verdict = "HELD"
            else:
                verdict = "VIOLATED"
            tenants_rec[name] = {
                "role": e["role"],
                "submitted": ts["submitted"],
                "completed": len(lat),
                "shed": ts["shed"],
                "quota": ts["quota"],
                "failed": ts["failed"],
                "p50_s": round(_percentile(lat, 0.50), 4),
                "p99_s": round(_percentile(lat, 0.99), 4),
                "slo_held": slo_held,
                "verdict": verdict,
            }
    completed = sum(len(v) for v in by_level.values())
    latency_by_level = {}
    for level, vals in sorted(by_level.items()):
        vals.sort()
        latency_by_level[level] = {
            "n": len(vals),
            "p50_s": round(_percentile(vals, 0.50), 4),
            "p99_s": round(_percentile(vals, 0.99), 4),
            "max_s": round(vals[-1], 4),
        }
    rec = {
        "bench": "soak",
        "engine_mode": mode,
        "duration_s": args.duration,
        "profile": {
            "base": "sine", "burst": "spike", "qps": args.qps,
            "amplitude": args.amplitude, "cycles": args.cycles,
            "spike_factor": args.spike_factor, "duty": args.duty,
        },
        "replicas_initial": args.replicas,
        "replicas_final": stats["replicas"],
        "added": stats["added"],
        "retired": stats["retired"],
        "submitted": submitted,
        "completed": completed,
        "shed": shed,
        "quota": quota,
        "failed": failed,
        "killed_rid": killed_rid,
        "quarantines": stats["quarantines"],
        "reinstatements": stats["reinstatements"],
        "latency_by_level": latency_by_level,
        # Batch occupancy across every replica's device calls.
        "occupancy": _occupancy_summary(),
        "shm": {
            name: round(sum(series.values()), 2)
            for name, series in obs.registry().snapshot().items()
            if name.startswith("data_shm_") and series
        },
        # Result-cache counters (serve/result_cache.py); empty when the
        # soak fleet runs cache-off (the default — coalescing would mask
        # the queue pressure the autoscaler story asserts on).
        "cache": {
            name: round(sum(series.values()), 2)
            for name, series in obs.registry().snapshot().items()
            if name.startswith("serve_cache_") and series
        },
        "slo": {
            "fast_s": round(fast_s, 2),
            "slow_s": round(slow_s, 2),
            "burn_factor": args.burn_factor,
            "verdicts": verdicts,
            "burn_alerts": [
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in a.items()}
                for a in slo_engine.alerts
            ],
        },
        "resize_timeline": [
            {**d, "t": round(d["t"] - t0, 2)}
            for d in scaler.resize_timeline()
        ],
        "tenants": tenants_rec,
        "quota_governor": None if governor is None else [
            {"action": a, "tenant": t} for a, t in governor.actions
        ],
        "data_chaos": None,
        "deploy": None if deployer is None else dict(
            _deploy_story(deployer, t0),
            dropped_at_s=(
                round(deploy_drop_t[0], 2) if deploy_drop_t else None
            ),
            generation_final=fleet.generation,
        ),
        "obs": {"run_id": obs.run_id(), "dir": obs.out_dir()},
    }
    obs.close()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--duration", type=float, default=45.0)
    p.add_argument("--qps", type=float, default=8.0,
                   help="diurnal baseline arrival rate")
    p.add_argument("--amplitude", type=float, default=0.5,
                   help="diurnal swing as a fraction of --qps")
    p.add_argument("--cycles", type=float, default=2.0,
                   help="diurnal cycles across the run")
    p.add_argument("--spike-factor", type=float, default=3.0,
                   help="burst multiplier on the diurnal rate")
    p.add_argument("--duty", type=float, default=0.15,
                   help="fraction of each cycle spent bursting")
    p.add_argument("--replicas", type=int, default=2,
                   help="fleet size at t=0")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--load-high", type=float, default=3.0)
    p.add_argument("--load-low", type=float, default=0.5)
    p.add_argument("--down-dwell", type=int, default=3)
    p.add_argument("--up-cooldown", type=float, default=3.0)
    p.add_argument("--down-cooldown", type=float, default=8.0)
    p.add_argument("--ctrl-period", type=float, default=0.5,
                   help="control-loop evaluation period (seconds)")
    p.add_argument("--availability-target", type=float, default=0.95)
    p.add_argument("--latency-target", type=float, default=0.95)
    p.add_argument("--latency-threshold", type=float, default=30.0,
                   help="latency SLO: good means under this (seconds)")
    p.add_argument("--burn-factor", type=float, default=3.0)
    p.add_argument("--deadline", type=float, default=120.0)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--config", default="tiny_synthetic")
    p.add_argument("--device", default=None,
                   help="real engines: the card by default; 'cpu' puts "
                        "every replica on the CPU")
    p.add_argument("--fake-engines", action="store_true",
                   help="runner-protocol fakes instead of real models "
                        "(seconds-scale; used by the tests)")
    p.add_argument("--service-time", type=float, default=0.01,
                   help="--fake-engines: per-request service time")
    p.add_argument("--kill-replica", action="store_true", default=True)
    p.add_argument("--no-kill-replica", dest="kill_replica",
                   action="store_false",
                   help="skip the mid-run replica kill")
    p.add_argument("--deploy", action="store_true",
                   help="land a fresh checkpoint mid-soak and run the "
                        "continuous-deployment pipeline (ctrl/deploy.py) "
                        "against the live fleet; the record gains the "
                        "shadow->promote/reject story")
    p.add_argument("--deploy-ckpt-dir", default=None,
                   help="--deploy: checkpoint dir to land the candidate "
                        "in (default: a temp dir)")
    p.add_argument("--tenants", default="",
                   help="adversarial multi-tenant mix "
                        "('name:k=v,...;name2:...'): per-tenant "
                        "schedules + serve.tenancy quotas + per-tenant "
                        "SLO verdicts in the record; the role=flooder "
                        "tenant must end QUOTA-CAPPED and every other "
                        "tenant HELD for the run to pass")
    p.add_argument("--obs-dir", default=None,
                   help="obs journal/spans dir (default: a temp dir)")
    args = p.parse_args(argv)
    if args.tenants:
        try:
            args._tenant_specs = parse_tenant_load_spec(args.tenants)
        except ValueError as e:
            p.error(str(e))
    if args.obs_dir is None:
        import tempfile

        args.obs_dir = tempfile.mkdtemp(prefix="soak_obs_")

    rec = run_soak(args)

    held = all(v["held"] for v in rec["slo"]["verdicts"])
    ok = held and rec["failed"] == 0 and rec["completed"] > 0
    if args.deploy:
        # The deployment must have reached a decision, and the per-SLO
        # verdicts above must hold THROUGH the roll — a promote that
        # burns the budget fails the soak even after rollback.
        ok = ok and rec["deploy"] is not None and rec["deploy"]["decided"]
    if args.tenants and rec["tenants"] is not None:
        # Isolation proof: every well-behaved tenant HELD, and the
        # flooder actually hit its cap (an uncapped flooder means the
        # bucket never bit — the rehearsal proved nothing).
        tnts = rec["tenants"].values()
        ok = ok and all(
            t["verdict"] == "HELD" for t in tnts if t["role"] != "flooder"
        )
        flooders = [t for t in tnts if t["role"] == "flooder"]
        if flooders:
            ok = ok and any(
                t["verdict"] == "QUOTA-CAPPED" for t in flooders
            )
    rec["held"] = held
    rec["pass"] = ok
    print(json.dumps(rec))
    for v in rec["slo"]["verdicts"]:
        print(f"[soak] slo {v['slo']}: budget_remaining="
              f"{v['budget_remaining']:+.4f} worst_burn_fast="
              f"{v['worst_burn_fast']} alerts={v['burn_alerts']} "
              f"held={v['held']}", file=sys.stderr)
    print(f"[soak] fleet resizes: +{rec['added']} -{rec['retired']} "
          f"(final {rec['replicas_final']})", file=sys.stderr)
    if rec.get("tenants"):
        for name, t in rec["tenants"].items():
            print(f"[soak] tenant {name} ({t['role']}): "
                  f"submitted={t['submitted']} completed={t['completed']} "
                  f"shed={t['shed']} quota={t['quota']} "
                  f"failed={t['failed']} p99={t['p99_s']}s "
                  f"verdict={t['verdict']}", file=sys.stderr)
    if rec.get("deploy"):
        d = rec["deploy"]
        story = "promoted" if d["promoted"] else (
            "rejected" if d["rejected"] else "undecided"
        )
        if d["rolled_back"]:
            story += " then rolled back"
        print(f"[soak] deploy: candidate {story}; fleet at generation "
              f"{d['generation_final']}", file=sys.stderr)
    print(f"[soak] SLO VERDICT: {'HELD' if held else 'VIOLATED'}",
          file=sys.stderr)
    if not ok:
        print(f"[soak] FAIL: held={held} failed={rec['failed']} "
              f"completed={rec['completed']}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
