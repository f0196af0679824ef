"""Continuous deployment: shadow canaries, parity-gated promotion, and
burn-triggered automatic rollback (port of ``mx_rcnn_tpu/ctrl/deploy.py``).

The :class:`Deployer` closes the loop between the training and serving
halves:

* **Watch** — polls a checkpoint directory for new steps.  A candidate
  must pass ``train/checkpoint.py``'s manifest verification (file-level
  size+CRC digests — truncated/tampered checkpoints are rejected before
  a single byte is deserialized), load through
  :func:`~mx_rcnn_tpu_torch.train.checkpoint.restore_raw`, and match the
  manifest's tree CRC.
* **Shadow** — the candidate is staged on a spare out-of-rotation
  replica (``FleetRouter.build_spare_engine`` — fresh never-reused rid,
  invisible to routing and supervision) while live traffic is mirrored
  to it at ``cfg.ctrl.deploy.mirror_rate`` through the router's mirror
  hook.  Shadow responses never reach callers by construction: the hook
  only ever sees a copy of the input.
* **Gate** — live/shadow pairs whose degrade levels match must agree
  BITWISE over the comparable payload (the result-cache sanitization
  discipline: everything except the volatile per-serving stamps and the
  producer's generation tag); pairs whose levels differ — and any
  bitwise divergence — are arbitrated by mAP-on-a-golden-set
  (evalutil's voc_eval).  A dedicated
  :class:`~mx_rcnn_tpu_torch.ctrl.slo.SLOEngine` over the shadow's
  PRIVATE metrics registry must hold, and a minimum mirrored-request
  count must be reached, before promotion.
* **Promote** — the existing one-at-a-time ``swap_weights`` roll, with
  the generation pinned to the shadow's number (unique, never reused —
  a rejected candidate's generation can never reappear in a served
  response's tag).
* **Watch window / rollback** — after promotion, a burn alert from the
  LIVE SLO engine inside ``watch_window_s`` triggers automatic
  rollback: the fleet's retained previous tree is re-published under a
  NEW, HIGHER generation number.  Monotonic ``health.record_swap`` and
  generation-keyed ``result_cache.invalidate_below`` both require that
  the number never moves backwards; only the weights roll back, never
  the counter.

Every decision is a typed journal event (deploy_candidate,
deploy_shadow_start, deploy_shadow_verdict, deploy_promote,
deploy_reject, deploy_rollback, deploy_resume), so ``obs/report.py``
replays the whole deployment history from artifacts alone, and a
restarted Deployer reconstructs its state from the journal
(:meth:`Deployer.recover`): killed after a promote verdict but before
the roll completed it resumes the roll; killed mid-shadow it safely
abandons the candidate.

The decisions, reasons, events and counters are the JAX package's.
What differs:

* the router is a :class:`~mx_rcnn_tpu_torch.serve.fleet.FleetRouter`;
  the JAX package's ``GatewayRouter`` branch (wire leaves, a cross-host
  roll) comes with the port's fabric;
* a port checkpoint's payload keeps the weights under ``"model"`` (the
  ``state_dict`` that ``swap_weights`` takes): :meth:`Deployer._variables_of`
  reads it beside the JAX package's ``"variables"`` and ``"params"``;
* a pair still in flight when the evidence closes counts nowhere: not in
  the pair counts, the shadow's registry or its SLO, which the JAX
  package still feeds (after its verdict, so that a pair failing against
  the stopped shadow journals a spurious shadow burn alert); the SLO
  verdicts are read with the pair counts, before the shadow stops; every
  mirror thread is then joined (bounded by ``mirror_timeout_s``) before
  the verdict returns and in :meth:`Deployer.stop`, and the shadow's
  engine is released.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.ctrl.slo import SLOEngine, default_slos
from mx_rcnn_tpu_torch.obs.metrics import Registry
from mx_rcnn_tpu_torch.serve.result_cache import _VOLATILE_FIELDS

log = logging.getLogger("mx_rcnn_tpu_torch.ctrl")

__all__ = [
    "PARITY_EXCLUDED_FIELDS", "ShadowVerdict", "Deployer",
    "build_deployer", "comparable_payload", "payloads_equal", "golden_map",
]

# Fields excluded from the bitwise live/shadow comparison: the volatile
# per-serving stamps the result cache strips before insert
# (serve/result_cache.py), plus the tags that differ between live and
# shadow BY CONSTRUCTION — the producer's generation and the cache's
# coalesced marker.  Everything else must match bit for bit.
PARITY_EXCLUDED_FIELDS = tuple(_VOLATILE_FIELDS) + ("generation", "coalesced")


def comparable_payload(res: dict) -> dict:
    """The parity-comparable subset of one response payload."""
    return {
        k: v for k, v in res.items() if k not in PARITY_EXCLUDED_FIELDS
    }


def payloads_equal(a: dict, b: dict) -> bool:
    """Bitwise equality over the comparable payload."""
    ca, cb = comparable_payload(a), comparable_payload(b)
    if set(ca) != set(cb):
        return False
    for k, va in ca.items():
        vb = cb[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not np.array_equal(np.asarray(va), np.asarray(vb)):
                return False
        elif va != vb:
            return False
    return True


def golden_map(infer: Callable[[object], dict], golden: dict,
               iou_threshold: float = 0.5) -> Optional[float]:
    """mAP of ``infer`` over a golden set.

    ``golden`` is ``{"images": [arrays], "gt": {class_idx: {image_id:
    {"boxes": (m,4), "difficult": (m,)}}}}`` — image ids are the string
    indices into ``images``.  Returns None when the set is unusable
    (empty, or every inference failed)."""
    from mx_rcnn_tpu_torch.evalutil.voc_eval import voc_eval

    images = golden.get("images") or []
    gt = golden.get("gt") or {}
    if not images or not gt:
        return None
    per_class: dict[int, dict[str, np.ndarray]] = {
        int(c): {} for c in gt
    }
    ran = 0
    for i, image in enumerate(images):
        try:
            res = infer(image)
        except Exception:  # noqa: BLE001 - a dead side scores 0, not a crash
            continue
        ran += 1
        boxes = np.asarray(res.get("boxes", ())).reshape(-1, 4)
        scores = np.asarray(res.get("scores", ())).reshape(-1)
        classes = np.asarray(res.get("classes", ())).reshape(-1)
        n = min(len(boxes), len(scores), len(classes))
        for c in per_class:
            keep = classes[:n] == c
            rows = np.concatenate(
                [boxes[:n][keep], scores[:n][keep][:, None]], axis=1
            ) if keep.any() else np.zeros((0, 5))
            per_class[c][str(i)] = rows
    if ran == 0:
        return None
    aps = []
    for c, dets in per_class.items():
        class_gt = {str(k): v for k, v in gt[c].items()}
        ap, _, _ = voc_eval(dets, class_gt, iou_threshold)
        aps.append(ap)
    return float(np.mean(aps)) if aps else None


@dataclasses.dataclass
class ShadowVerdict:
    """The shadow gate's ruling plus the evidence it ruled on."""

    step: int
    generation: int
    promote: bool
    reason: str
    mirrored: int = 0
    compared: int = 0
    mismatched: int = 0
    level_mismatch: int = 0
    shadow_failures: int = 0
    map_live: Optional[float] = None
    map_shadow: Optional[float] = None
    map_ok: Optional[bool] = None
    slo_ok: bool = True
    slo_verdicts: list = dataclasses.field(default_factory=list)

    def payload(self) -> dict:
        out = dataclasses.asdict(self)
        out["verdict"] = "promote" if self.promote else "reject"
        return out


class _ShadowState:
    """One candidate's in-flight shadow bookkeeping (own lock — never
    nested with the Deployer's or any router lock).  ``threads`` are its
    mirror threads, started under the lock while it is open."""

    def __init__(self, step: int, generation: int, engine,
                 slo: SLOEngine, registry: Registry) -> None:
        self.step = step
        self.generation = generation
        self.engine = engine
        self.slo = slo
        self.registry = registry
        self.lock = threading.Lock()
        self.mirrored = 0
        self.compared = 0
        self.mismatched = 0
        self.level_mismatch = 0
        self.shadow_failures = 0
        self.closed = False
        self.threads: list[threading.Thread] = []


class Deployer:
    """Watch → shadow → gate → promote → watch-window → rollback.

    ``router`` is a :class:`~mx_rcnn_tpu_torch.serve.fleet.FleetRouter`.
    ``loader(step)`` returns the raw checkpoint payload (default:
    ``checkpoint.restore_raw``); ``to_variables(tree)`` maps it to the
    serving ``state_dict`` (default: the payload's ``"model"``, or a JAX
    tree's ``"variables"``/``"params"`` entry, else the tree itself).
    ``shadow_engine_factory()`` builds the out-of-rotation canary engine
    (default: ``router.build_spare_engine``).  ``live_slo`` is the LIVE
    SLOEngine whose burn alerts drive the post-promote watch.  The shadow
    window, the settle wait, the watch window and the journal's ``t`` read
    ``clock``."""

    def __init__(
        self,
        router,
        ckpt_dir: str,
        *,
        poll_s: float = 2.0,
        mirror_rate: float = 0.25,
        min_mirrored: int = 8,
        shadow_window_s: float = 30.0,
        map_drop: float = 0.005,
        watch_window_s: float = 60.0,
        mirror_timeout_s: float = 30.0,
        slos: Optional[Sequence] = None,
        slo_fast_s: float = 5.0,
        slo_slow_s: float = 15.0,
        slo_burn_factor: float = 2.0,
        availability_target: float = 0.95,
        latency_target: float = 0.95,
        latency_threshold_s: float = 30.0,
        golden: Optional[dict] = None,
        live_slo: Optional[SLOEngine] = None,
        loader: Optional[Callable[[int], object]] = None,
        to_variables: Optional[Callable[[object], object]] = None,
        shadow_engine_factory: Optional[Callable[[], object]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._router = router
        self.ckpt_dir = ckpt_dir
        self.poll_s = float(poll_s)
        self.mirror_rate = float(mirror_rate)
        self.min_mirrored = int(min_mirrored)
        self.shadow_window_s = float(shadow_window_s)
        self.map_drop = float(map_drop)
        self.watch_window_s = float(watch_window_s)
        self.mirror_timeout_s = float(mirror_timeout_s)
        self.availability_target = float(availability_target)
        self.latency_target = float(latency_target)
        self.latency_threshold_s = float(latency_threshold_s)
        self._slos = tuple(slos) if slos is not None else None
        self.slo_fast_s = float(slo_fast_s)
        self.slo_slow_s = float(slo_slow_s)
        self.slo_burn_factor = float(slo_burn_factor)
        self.golden = golden
        self.live_slo = live_slo
        self._loader = loader
        self._to_variables = to_variables
        self._shadow_factory = shadow_engine_factory
        self._clock = clock
        self._lock = threading.Lock()
        self._shadow: Optional[_ShadowState] = None
        self._watch: Optional[dict] = None
        self._decided: dict[int, str] = {}   # step -> outcome
        self._deployed_step: Optional[int] = None
        self._next_gen = 1                   # never reused, never rewound
        self.history: list[dict] = []
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_candidates = obs.counter(
            "ctrl_deploy_candidates_total",
            "deploy candidates by final outcome",
        )
        self._m_mirrored = obs.counter(
            "ctrl_deploy_mirrored_total",
            "live submissions mirrored to the shadow replica",
        )
        self._m_rollbacks = obs.counter(
            "ctrl_deploy_rollbacks_total",
            "burn-triggered automatic rollbacks",
        )

    # -- candidate plumbing ------------------------------------------------

    def _load(self, step: int):
        if self._loader is not None:
            return self._loader(step)
        from mx_rcnn_tpu_torch.train import checkpoint
        return checkpoint.restore_raw(self.ckpt_dir, step=step)

    def _variables_of(self, tree):
        if self._to_variables is not None:
            return self._to_variables(tree)
        if isinstance(tree, dict):
            for key in ("variables", "params", "model"):
                if key in tree:
                    return {"params": tree["params"]} if key == "params" else tree[key]
        return tree

    def _spare_engine(self):
        if self._shadow_factory is not None:
            return self._shadow_factory()
        factory = getattr(self._router, "build_spare_engine", None)
        if factory is None:
            raise RuntimeError(
                "router has no build_spare_engine; pass "
                "shadow_engine_factory explicitly"
            )
        return factory()

    def _reserve_generation(self) -> int:
        """A unique, strictly-increasing generation for the next shadow.
        Rejected candidates burn their number — it can never reappear in
        a served response's generation tag."""
        with self._lock:
            gen = max(self._next_gen, self._router.generation + 1)
            self._next_gen = gen + 1
            return gen

    # -- journal -----------------------------------------------------------

    def _record(self, kind: str, payload: dict) -> None:
        obs.emit("ctrl", kind, payload, logger=log)
        self.history.append(dict(payload, kind=kind, t=self._clock()))

    # -- mirror ------------------------------------------------------------

    def _on_mirror(self, image, live_req) -> None:
        """Router mirror hook: pair one live request with a shadow
        inference, off the caller's path (fresh daemon thread, started
        while the shadow is open and joined before it is ruled on)."""
        sh = self._shadow
        if sh is None:
            return
        t = threading.Thread(
            target=self._mirror_pair, args=(sh, image, live_req),
            name="deploy-mirror", daemon=True,
        )
        with sh.lock:
            if sh.closed:
                return
            sh.threads.append(t)
            t.start()
        self._m_mirrored.inc()

    def _mirror_pair(self, sh: _ShadowState, image, live_req) -> None:
        t0 = self._clock()
        shadow_res = None
        try:
            shadow_res = sh.engine.infer(image, timeout=self.mirror_timeout_s)
        except Exception:  # noqa: BLE001 - a failing canary is evidence
            pass
        latency = self._clock() - t0
        live_res = None
        try:
            live_res = live_req.result(timeout=self.mirror_timeout_s)
        except Exception:  # noqa: BLE001 - live failure isn't the canary's
            pass
        with sh.lock:
            if sh.closed:
                return   # the evidence closed while this pair was in flight
            requests = sh.registry.counter(
                "fleet_requests_total", "shadow requests by outcome"
            )
            if shadow_res is None:
                requests.inc(outcome="failed")
            else:
                requests.inc(outcome="completed")
                sh.registry.histogram(
                    "serve_request_latency_seconds", "shadow request latency"
                ).observe(latency, level=str(shadow_res.get("level", "full")))
            sh.mirrored += 1
            if shadow_res is None:
                sh.shadow_failures += 1
            elif live_res is not None:
                if live_res.get("level") == shadow_res.get("level"):
                    sh.compared += 1
                    if not payloads_equal(live_res, shadow_res):
                        sh.mismatched += 1
                else:
                    sh.level_mismatch += 1
        sh.slo.observe()

    def _join_mirrors(self, sh: _ShadowState) -> None:
        """Wait for the shadow's mirror threads: each waits at most
        ``mirror_timeout_s`` for the shadow and as long for the live side."""
        with sh.lock:
            sh.closed = True
            threads = list(sh.threads)
        deadline = time.monotonic() + 2 * self.mirror_timeout_s + 1.0
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        left = [t for t in threads if t.is_alive()]
        if left:
            log.warning("deploy: %d mirror thread(s) still running", len(left))

    # -- shadow phase ------------------------------------------------------

    def _shadow_phase(self, step: int, variables) -> ShadowVerdict:
        generation = self._reserve_generation()
        engine = self._spare_engine()
        engine.start()
        try:
            engine.swap_weights(variables, generation=generation)
        except Exception as e:  # noqa: BLE001 - unload-able candidate
            try:
                engine.stop(drain=False)
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
            return ShadowVerdict(
                step=step, generation=generation, promote=False,
                reason=f"shadow_swap_failed: {e}",
            )
        registry = Registry()
        slo = SLOEngine(
            self._slos if self._slos is not None else default_slos(self),
            registry=registry,
            fast_s=self.slo_fast_s, slow_s=self.slo_slow_s,
            burn_factor=self.slo_burn_factor, clock=self._clock,
        )
        slo.observe()
        sh = _ShadowState(step, generation, engine, slo, registry)
        with self._lock:
            self._shadow = sh
        self._record("deploy_shadow_start", {
            "step": step, "generation": generation,
            "mirror_rate": self.mirror_rate,
        })
        self._router.set_mirror(self._on_mirror, self.mirror_rate)
        deadline = self._clock() + self.shadow_window_s
        try:
            while self._clock() < deadline:
                with sh.lock:
                    enough = (
                        sh.mirrored >= self.min_mirrored
                        and sh.compared + sh.level_mismatch > 0
                    )
                if enough or self._stop_event.wait(0.05):
                    break
        finally:
            self._router.clear_mirror()
        # Let in-flight mirror pairs land before ruling.
        settle = self._clock() + min(2.0, self.mirror_timeout_s)
        while self._clock() < settle:
            with sh.lock:
                if sh.mirrored >= self.min_mirrored or sh.closed:
                    break
            if self._stop_event.wait(0.02):
                break
        slo.observe()
        map_live = map_shadow = None
        if self.golden:
            map_shadow = golden_map(
                lambda img: engine.infer(img, timeout=self.mirror_timeout_s),
                self.golden,
            )
            map_live = golden_map(
                lambda img: self._router.infer(
                    img, timeout=self.mirror_timeout_s
                ),
                self.golden,
            )
        with sh.lock:
            sh.closed = True
            mirrored, compared = sh.mirrored, sh.compared
            mismatched, level_mm = sh.mismatched, sh.level_mismatch
            failures = sh.shadow_failures
        with self._lock:
            self._shadow = None
        # The SLO evidence is read with the counts: a pair still in flight
        # fails once the engine stops, and that is no evidence.
        slo_verdicts = slo.verdicts()
        burn_started = any(a.get("event") == "start" for a in slo.alerts)
        try:
            engine.stop(drain=False)
        except Exception:  # noqa: BLE001 - best-effort teardown
            log.exception("deploy: stopping shadow engine failed")
        self._join_mirrors(sh)
        sh.engine = engine = None   # the shadow's weights leave the card
        slo_ok = (
            not burn_started
            and all(v.get("held", False) for v in slo_verdicts)
        )
        map_ok = None
        if map_live is not None and map_shadow is not None:
            map_ok = map_shadow >= map_live - self.map_drop
        # The gate: bitwise parity wherever degrade levels matched; any
        # divergence (bitwise or level) must be redeemed by an explicit
        # golden-set mAP pass; the shadow-scoped SLO must hold; and the
        # evidence must be big enough to mean something.
        enough = (
            mirrored >= self.min_mirrored and compared + level_mm > 0
        )
        parity_ok = (
            failures == 0
            and (mismatched == 0 or map_ok is True)
            and (level_mm == 0 or map_ok is True)
            and (map_ok is not False)
        )
        if not enough:
            promote, reason = False, "insufficient_mirrored"
        elif not parity_ok:
            promote, reason = False, "parity"
        elif not slo_ok:
            promote, reason = False, "shadow_slo"
        else:
            promote, reason = True, "ok"
        return ShadowVerdict(
            step=step, generation=generation, promote=promote,
            reason=reason, mirrored=mirrored, compared=compared,
            mismatched=mismatched, level_mismatch=level_mm,
            shadow_failures=failures, map_live=map_live,
            map_shadow=map_shadow, map_ok=map_ok, slo_ok=slo_ok,
            slo_verdicts=slo_verdicts,
        )

    # -- promote / rollback ------------------------------------------------

    def _promote(self, step: int, variables, generation: int) -> int:
        from_gen = self._router.generation
        target = max(generation, from_gen + 1)
        rolled = self._router.swap_weights(variables, generation=target)
        with self._lock:
            self._deployed_step = step
            self._decided[step] = "promoted"
            self._next_gen = max(self._next_gen, rolled + 1)
            self._watch = {
                "step": step,
                "generation": rolled,
                "deadline": self._clock() + self.watch_window_s,
                "alerts_seen": (
                    len(self.live_slo.alerts)
                    if self.live_slo is not None else 0
                ),
            }
        self._m_candidates.inc(outcome="promoted")
        self._record("deploy_promote", {
            "step": step, "generation": rolled,
            "from_generation": from_gen,
            "watch_window_s": self.watch_window_s,
        })
        return rolled

    def _reject(self, step: int, reason: str,
                outcome: str = "rejected") -> None:
        with self._lock:
            self._decided[step] = outcome
        self._m_candidates.inc(outcome=outcome)
        self._record("deploy_reject", {"step": step, "reason": reason})

    def check_watch(self) -> Optional[dict]:
        """One post-promote watch evaluation: a NEW live burn alert
        inside the window triggers rollback.  Returns the rollback
        record when one happened."""
        with self._lock:
            w = self._watch
        if w is None:
            return None
        burn = None
        if self.live_slo is not None:
            alerts = list(self.live_slo.alerts)[w["alerts_seen"]:]
            burn = next(
                (a for a in alerts if a.get("event") == "start"), None
            )
        if burn is not None:
            return self.rollback(burn, watch=w)
        if self._clock() >= w["deadline"]:
            with self._lock:
                if self._watch is w:
                    self._watch = None
        return None

    def rollback(self, burn: Optional[dict] = None,
                 watch: Optional[dict] = None) -> Optional[dict]:
        """Re-publish the previous generation's retained tree under a
        NEW, HIGHER generation number.  ``health.record_swap`` refuses a
        backwards generation and the result cache invalidates strictly
        below — the number must keep climbing even though the weights go
        back."""
        if watch is None:
            with self._lock:
                watch = self._watch
        prev = self._router.previous_weights()
        if prev is None:
            log.error("deploy: rollback requested but no retained history")
            with self._lock:
                self._watch = None
            return None
        prev_gen, tree = prev
        from_gen = self._router.generation
        with self._lock:
            target = max(self._next_gen, from_gen + 1)
            self._next_gen = target + 1
        rolled = self._router.swap_weights(tree, generation=target)
        step = watch.get("step") if watch else None
        with self._lock:
            self._watch = None
            if step is not None:
                self._decided[step] = "rolled_back"
            if self._deployed_step == step:
                self._deployed_step = None
        self._m_rollbacks.inc()
        record = {
            "step": step,
            "from_generation": from_gen,
            "to_generation": rolled,
            "restored_generation": prev_gen,
            "slo": None if burn is None else burn.get("slo"),
            "burn_fast": None if burn is None else burn.get("burn_fast"),
        }
        self._record("deploy_rollback", record)
        return record

    # -- the loop ----------------------------------------------------------

    def offer(self, step: int) -> dict:
        """Run one candidate through the full pipeline synchronously.
        Returns the decision record."""
        from mx_rcnn_tpu_torch.train import checkpoint
        ok, reason = checkpoint.verify_manifest(self.ckpt_dir, step)
        self._record("deploy_candidate", {
            "step": step, "valid": ok, "reason": reason,
        })
        if not ok:
            self._reject(step, reason, outcome="invalid")
            return {"step": step, "outcome": "invalid", "reason": reason}
        try:
            tree = self._load(step)
        except Exception as e:  # noqa: BLE001 - unrestorable candidate
            self._reject(step, f"restore_failed: {e}", outcome="invalid")
            return {"step": step, "outcome": "invalid",
                    "reason": "restore_failed"}
        manifest = checkpoint.read_manifest(self.ckpt_dir, step)
        if manifest is not None and "tree_crc" in manifest and \
                checkpoint.tree_crc(tree) != manifest["tree_crc"]:
            self._reject(step, "tree_crc_mismatch", outcome="invalid")
            return {"step": step, "outcome": "invalid",
                    "reason": "tree_crc_mismatch"}
        variables = self._variables_of(tree)
        verdict = self._shadow_phase(step, variables)
        self._record("deploy_shadow_verdict", verdict.payload())
        if not verdict.promote:
            self._reject(step, verdict.reason)
            return {"step": step, "outcome": "rejected",
                    "reason": verdict.reason, "verdict": verdict}
        generation = self._promote(step, variables, verdict.generation)
        return {"step": step, "outcome": "promoted",
                "generation": generation, "verdict": verdict}

    def pending_candidates(self) -> list[int]:
        """Undecided steps on disk, oldest first."""
        from mx_rcnn_tpu_torch.train import checkpoint
        steps = checkpoint.all_steps(self.ckpt_dir)
        with self._lock:
            decided = set(self._decided)
            deployed = self._deployed_step
        return [
            s for s in steps
            if s not in decided and (deployed is None or s > deployed)
        ]

    def step_once(self) -> list[dict]:
        """One control tick: watch-window check, then every pending
        candidate in order (the soak and the tests call this directly
        for determinism; the background loop calls it on ``poll_s``)."""
        out = []
        rb = self.check_watch()
        if rb is not None:
            out.append({"outcome": "rolled_back", **rb})
        with self._lock:
            busy = self._watch is not None
        if not busy:
            for step in self.pending_candidates():
                out.append(self.offer(step))
                with self._lock:
                    if self._watch is not None:
                        break  # promote armed a watch; candidates wait
        return out

    def start(self, recover: bool = True) -> "Deployer":
        if recover:
            try:
                self.recover()
            except Exception:  # noqa: BLE001 - recovery is best-effort
                log.exception("deploy: journal recovery failed")
        self._thread = threading.Thread(
            target=self._loop, name="ctrl-deploy", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_event.wait(self.poll_s):
            try:
                self.step_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("deploy: control tick failed")

    def stop(self) -> None:
        """Stop the loop; a shadow in flight is ruled on and stopped, and
        its mirror threads are joined, before this returns."""
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.mirror_timeout_s + 5.0)
            self._thread = None
        self._router.clear_mirror()
        with self._lock:
            sh = self._shadow
        if sh is not None:
            self._join_mirrors(sh)

    # -- crash recovery ----------------------------------------------------

    def recover(self, records: Optional[Sequence[dict]] = None) -> dict:
        """Reconstruct decisions from the journal and resolve any
        candidate caught mid-flight.

        * verdict said PROMOTE but no ``deploy_promote`` landed → the
          roll may have died half-way: RESUME it (reload the candidate,
          re-roll under a fresh generation ≥ the recorded one).
        * shadow started but no verdict → the evidence died with the
          process: ABANDON the candidate (journaled as a reject).
        * promote landed, watch window unresolved → re-arm a full watch
          window (conservative: a burn that fired while we were dead
          still triggers rollback via the live engine's next alerts).
        """
        if records is None:
            d = obs.out_dir()
            path = os.path.join(d, "journal.jsonl") if d else None
            records = (
                obs.read_journal(path)
                if path and os.path.exists(path) else []
            )
        per_step: dict[int, dict] = {}
        max_gen = 0
        for rec in records:
            kind = rec.get("kind", "")
            if not kind.startswith("deploy_"):
                continue
            payload = rec.get("payload") or {}
            step = payload.get("step")
            gen = payload.get("generation") or 0
            max_gen = max(max_gen, int(gen), int(
                payload.get("to_generation") or 0
            ))
            if step is None:
                continue
            st = per_step.setdefault(int(step), {})
            st[kind] = payload
            st["last"] = kind
        summary = {"resumed": [], "abandoned": [], "rearmed": [],
                   "decided": []}
        with self._lock:
            self._next_gen = max(self._next_gen, max_gen + 1)
        for step in sorted(per_step):
            st = per_step[step]
            if "deploy_rollback" in st:
                with self._lock:
                    self._decided[step] = "rolled_back"
                summary["decided"].append(step)
                continue
            if "deploy_reject" in st:
                with self._lock:
                    self._decided[step] = "rejected"
                summary["decided"].append(step)
                continue
            if "deploy_promote" in st:
                with self._lock:
                    self._decided[step] = "promoted"
                    self._deployed_step = step
                summary["decided"].append(step)
                # The watch window's elapsed time died with the old
                # process — re-arm a full one.
                promoted_gen = int(st["deploy_promote"].get(
                    "generation", 0
                ))
                if self._router.generation >= promoted_gen and \
                        self.watch_window_s > 0:
                    with self._lock:
                        self._watch = {
                            "step": step, "generation": promoted_gen,
                            "deadline": (
                                self._clock() + self.watch_window_s
                            ),
                            "alerts_seen": (
                                len(self.live_slo.alerts)
                                if self.live_slo is not None else 0
                            ),
                        }
                    summary["rearmed"].append(step)
                continue
            verdict = st.get("deploy_shadow_verdict")
            if verdict is not None and verdict.get("verdict") == "promote":
                # Killed between verdict and a completed roll: resume.
                self._record("deploy_resume", {
                    "step": step, "action": "resume_promote",
                    "generation": verdict.get("generation"),
                })
                try:
                    tree = self._load(step)
                    variables = self._variables_of(tree)
                    self._promote(
                        step, variables,
                        int(verdict.get("generation") or 0),
                    )
                    summary["resumed"].append(step)
                except Exception as e:  # noqa: BLE001 - then reject it
                    log.exception("deploy: resume of step %d failed", step)
                    self._reject(step, f"resume_failed: {e}")
                    summary["abandoned"].append(step)
                continue
            if verdict is not None:
                with self._lock:
                    self._decided[step] = "rejected"
                summary["decided"].append(step)
                continue
            if "deploy_shadow_start" in st:
                # Killed mid-shadow: the mirrored evidence is gone;
                # abandon deterministically (the step stays decided —
                # a re-offer would need a new checkpoint step).
                self._record("deploy_resume", {
                    "step": step, "action": "abandon",
                    "generation": st["deploy_shadow_start"].get(
                        "generation"
                    ),
                })
                self._reject(step, "crash_mid_shadow")
                summary["abandoned"].append(step)
        return summary


def build_deployer(cfg, router, **overrides) -> Deployer:
    """Wire a Deployer from ``cfg.ctrl.deploy`` (``tools/soak.py --deploy``,
    ``tools/deploy_watch.py``).  Keyword overrides win over config."""
    dc = cfg.ctrl.deploy
    kw = dict(
        poll_s=dc.poll_s,
        mirror_rate=dc.mirror_rate,
        min_mirrored=dc.min_mirrored,
        shadow_window_s=dc.shadow_window_s,
        map_drop=dc.map_drop,
        watch_window_s=dc.watch_window_s,
        slo_fast_s=dc.burn_fast_s,
        slo_slow_s=dc.burn_slow_s,
        slo_burn_factor=dc.burn_factor,
        availability_target=dc.availability_target,
        latency_target=dc.latency_target,
        latency_threshold_s=dc.latency_threshold_s,
    )
    ckpt_dir = overrides.pop("ckpt_dir")
    kw.update(overrides)
    return Deployer(router, ckpt_dir, **kw)
