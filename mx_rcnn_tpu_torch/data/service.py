"""Crash-tolerant multi-process input service (the port's copy of
``mx_rcnn_tpu/data/service.py``).

The decode half of the input pipeline as a pool of **independent failure
domains**: spawned worker processes that can die (an OOM-killed decode,
a crashing image codec, chaos SIGKILL) or wedge (a stuck read) without
taking the run down or changing the data schedule.  A worker assembles
host batches only (``data/loader.py::HostBatch``: decode, flip, gt
arrays); the letterbox stays on the card in the parent.

Determinism: batch content is a pure function of the global batch index.
The parent derives the schedule (shuffle order, flip draws) exactly as
the in-process loader does and ships each batch as an ``(index, spec)``
task, a spec being roidb row indices and flip flags.  Workers never draw
randomness.  Results are reordered by index on the consumer side, so the
yielded stream is bit-identical for any worker count, after any worker
death or reassignment, and on resume.

- **Workers never touch the card.**  A worker is spawned (never forked:
  the parent holds a CUDA context and threads).  Its entry sets
  ``CUDA_VISIBLE_DEVICES=""`` before anything in it can initialize CUDA
  (spawn has imported torch by then, to unpickle the entry's arguments,
  but importing torch initializes nothing; the parent's environment is
  left alone, since changing it under the parent's threads is unsafe).
  Its loader is built on the CPU and runs the host half only.  Each
  worker's first message is a hello carrying its pid and
  ``torch.cuda.is_available()`` (``InputService.hellos``).
- **Heartbeats + watchdog** — each worker stamps a shared heartbeat slot
  from its main loop only (a wedged decode therefore stales it).  The
  consumer doubles as watchdog (``MX_RCNN_DATA_WATCHDOG_S``, default
  30 s): a dead process or a stale heartbeat gets the worker killed.
- **Deterministic reassignment** — the dead worker's queues are
  discarded, its delivered-but-unconsumed results salvaged, and its
  in-flight batch indices go back on the pending heap for live workers;
  the respawned worker starts clean.
- **Bounded respawns** — each worker slot carries a respawn budget;
  exhausting every slot raises the typed :class:`InputServiceDead` or,
  with ``fallback=True`` (the loader's), degrades to in-process
  assembly with a logged and journaled ``service_fallback`` (the run
  completes, slower; the assembly stays on the host, the letterbox on
  the card).
- **Backpressure** — per-worker result queues are bounded; a worker
  SIGKILLed mid-write can tear only its own pipe.
- **Orphan protection** — workers poll ``getppid`` and exit when the
  parent vanishes.
- **Shared-memory transport** (``shm_slots > 0``) — each worker owns a
  CRC-stamped ring (data/shm_ring.py) and ships host batches as slot
  references; a corrupt or torn slot is quarantined and its index
  reassigned.  A batch the ring cannot take (a full ring past the stall
  budget, or a batch over the slot size, counted) rides the pickle path.

Chaos hooks: workers self-SIGKILL (``MX_RCNN_CHAOS_DATA_SUICIDE``) or
wedge (``MX_RCNN_CHAOS_DATA_WEDGE``) on a claimed batch index; an
``O_EXCL`` sentinel file makes the claim exclusive, so the reassigned
batch does not re-trigger the fault.  ``MX_RCNN_CHAOS_SHM_CORRUPT`` flips
a payload byte in one delivered slot before the consumer reads it.
"""

from __future__ import annotations

import heapq
import logging
import multiprocessing as mp
import os
import queue
import signal
import sys
import time
from typing import Callable, Iterator, Optional

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.data.cache import quarantine_append
from mx_rcnn_tpu_torch.data.shm_ring import (
    ShmRing,
    ShmRingWriter,
    SlotOverflow,
    shm_eligible,
)

log = logging.getLogger("mx_rcnn_tpu_torch")

# Watchdog staleness threshold override (seconds, float) — chaos scenarios
# tighten it so a wedged worker is reaped inside the test budget.
WATCHDOG_ENV = "MX_RCNN_DATA_WATCHDOG_S"
# Chaos: "always" or "<global_batch_idx>:<sentinel_path>" — the (first)
# worker to claim that batch SIGKILLs itself before assembling.
CHAOS_SUICIDE_ENV = "MX_RCNN_CHAOS_DATA_SUICIDE"
# Chaos: "<global_batch_idx>:<sentinel_path>" — the claiming worker wedges
# (sleeps without heartbeating) so the watchdog must reap + reassign.
CHAOS_WEDGE_ENV = "MX_RCNN_CHAOS_DATA_WEDGE"
# Chaos: "<global_batch_idx>" — the consumer flips one payload byte in
# that batch's delivered shm slot before decoding it (one-shot): CRC
# detect -> quarantine -> deterministic reassignment, no worker involved.
CHAOS_SHM_CORRUPT_ENV = "MX_RCNN_CHAOS_SHM_CORRUPT"

_WORKER_DEPTH = 2      # in-flight tasks per worker (decode pipelining)
_RESULT_DEPTH = 2      # bounded per-worker result queue (backpressure)
_POLL_S = 0.02         # consumer poll cadence when nothing is ready
_BOOT_GRACE_S = 120.0  # heartbeat grace for a worker still importing
# How long a worker waits on a full shm ring before shipping THAT batch
# via pickle instead.  Zero-copy slots are pinned until the consumer
# DROPS the batch, so a consumer that retains every batch (list(...) in
# tests, an unbounded prefetch buffer) would pin every slot forever —
# the bounded wait turns that would-be deadlock into a counted, per-batch
# degrade to the legacy transport.
_SHM_STALL_BUDGET_S = 0.5


class InputServiceDead(RuntimeError):
    """Every worker slot is dead and the respawn budget is exhausted."""


class InputServiceError(RuntimeError):
    """A worker's assembly raised — deterministic, so not retried."""


def _parse_chaos(env: str, allow_always: bool = False):
    """``"always"`` or ``"<idx>:<sentinel>"`` → ('always'|int, path|None)."""
    raw = os.environ.get(env, "").strip()
    if not raw:
        return None
    if raw == "always" and allow_always:
        return ("always", None)
    idx, _, sentinel = raw.partition(":")
    return (int(idx), sentinel or None)


def _chaos_claims(spec, idx: int) -> bool:
    """Does this worker claim the fault for batch ``idx``?  The O_EXCL
    sentinel makes the claim exclusive across workers AND respawns — the
    reassigned batch must not re-trigger the same fault forever."""
    if spec is None:
        return False
    target, sentinel = spec
    if target != "always" and idx != target:
        return False
    if sentinel is None:
        return True
    try:
        os.close(os.open(sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False
    except OSError:
        return True


def _ship_via_ring(writer, idx: int, val, heartbeat, wid: int,
                   parent_pid: int):
    """Try the shm path for one assembled value: claim a slot (blocking
    on backpressure, heartbeating, counting stalls), write, and return
    the control message — or None to fall back to the pickle path
    (ineligible value or a torn-down ring; a slot overflow ships the value
    itself as an ``shm_overflow`` message, which the parent counts).

    The wait for a free slot is BOUNDED (``_SHM_STALL_BUDGET_S``): slots
    stay pinned until the consumer drops the delivered batch, so a
    consumer that retains every batch would otherwise pin every slot and
    wedge the stream.  When the budget runs out, THIS batch ships as a
    stall-fallback pickle message (stall count attached) and the ring is
    retried on the next batch."""
    if writer is None or not shm_eligible(val):
        return None
    stalls = 0
    slot = writer.acquire(timeout=0.02)
    while slot is None:
        # Every slot is in flight: bounded-slot backpressure.  Keep
        # heartbeating (this is a slow consumer, not a wedge) and count
        # the wait so the consumer can export it as a ring stall.
        stalls += 1
        heartbeat[wid] = time.time()
        if os.getppid() != parent_pid:
            os._exit(2)
        if stalls * 0.2 >= _SHM_STALL_BUDGET_S:
            return ("shm_stall", idx, (val, stalls))
        slot = writer.acquire(timeout=0.2)
    try:
        nbytes = writer.write(slot, val)
    except SlotOverflow:
        writer.unget(slot)
        # One oversized batch rides the pickle path, counted by the parent;
        # the stream survives.
        return ("shm_overflow", idx, val)
    except Exception:  # noqa: BLE001 — ring gone (teardown race)
        writer.unget(slot)
        return None
    return ("shm", idx, (slot, nbytes, stalls))


def _service_worker(
    wid: int,
    builder: Callable,
    payload: dict,
    task_q,
    result_q,
    heartbeat,
    parent_pid: int,
    ring_handle: Optional[dict] = None,
) -> None:
    """Worker main: say hello, then pull (idx, spec) tasks, assemble, ship
    (kind, idx, …).

    The heartbeat is stamped ONLY here, between units of real work — a
    wedged assemble or a wedged queue therefore reads as stale, which is
    the watchdog's entire signal.  The worker never touches the card:
    ``CUDA_VISIBLE_DEVICES=""`` is set first, before anything below can
    initialize CUDA, and its hello reports ``torch.cuda.is_available()``,
    which the parent records.

    With ``ring_handle`` (shm transport) the assembled arrays go into a
    ring slot and ``result_q`` carries only the slot reference; the
    pickle message remains the per-batch fallback.
    """
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent owns Ctrl-C
    suicide = _parse_chaos(CHAOS_SUICIDE_ENV, allow_always=True)
    wedge = _parse_chaos(CHAOS_WEDGE_ENV)
    assemble = builder(payload)
    writer = ShmRingWriter(ring_handle) if ring_handle else None
    import torch

    hello = ("hello", -1, {"worker": wid, "pid": os.getpid(),
                           "cuda": bool(torch.cuda.is_available())})
    heartbeat[wid] = time.time()
    result_q.put(hello)
    while True:
        if os.getppid() != parent_pid:
            os._exit(2)  # orphaned (parent SIGKILLed) — no cleanup to run
        heartbeat[wid] = time.time()
        try:
            task = task_q.get(timeout=0.2)
        except (queue.Empty, OSError, EOFError):
            continue
        if task is None:
            if writer is not None:
                writer.close()
            return
        idx, spec = task
        if _chaos_claims(suicide, idx):
            print(
                f"[input-service worker {wid}] chaos: self-SIGKILL on "
                f"batch {idx}", file=sys.stderr, flush=True,
            )
            os.kill(os.getpid(), signal.SIGKILL)
        if _chaos_claims(wedge, idx):
            print(
                f"[input-service worker {wid}] chaos: wedging on batch "
                f"{idx}", file=sys.stderr, flush=True,
            )
            time.sleep(3600.0)  # no heartbeat: the watchdog reaps us
        try:
            val = assemble(spec)
            msg = _ship_via_ring(
                writer, idx, val, heartbeat, wid, parent_pid
            ) or ("ok", idx, val)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            msg = ("err", idx, f"{type(e).__name__}: {e}")
        while True:
            heartbeat[wid] = time.time()
            if os.getppid() != parent_pid:
                os._exit(2)
            try:
                result_q.put(msg, timeout=0.2)
                break
            except queue.Full:
                continue  # backpressure: bounded queue, consumer is slow


class _Slot:
    """One worker's parent-side state: process, private queues, shm ring
    (when the transport is on), in-flight indices, and the remaining
    respawn budget."""

    def __init__(self, proc, task_q, result_q, respawns_left: int,
                 ring: Optional[ShmRing] = None) -> None:
        self.proc = proc
        self.task_q = task_q
        self.result_q = result_q
        self.respawns_left = respawns_left
        self.ring = ring
        self.outstanding: set[int] = set()
        self.spawned_at = time.time()


class InputService:
    """Deterministic process-pool batch assembly (iterator protocol).

    ``specs`` yields picklable local batch specs in global-schedule
    order; ``assemble(spec)`` is the parent-side (fallback) assembler;
    ``builder(payload)`` — both picklable — reconstructs the same
    assembler inside a spawned worker.  Yields batches in exactly
    ``specs`` order, whatever happens to the workers.
    """

    def __init__(
        self,
        specs: Iterator,
        assemble: Callable,
        builder: Callable,
        payload: dict,
        num_workers: int,
        start_index: int = 0,
        respawns: int = 2,
        watchdog_s: Optional[float] = None,
        fallback: bool = True,
        name: str = "input-service",
        shm_slots: int = 0,
        shm_slot_bytes: int = 0,
        quarantine_path: Optional[str] = None,
    ) -> None:
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._specs = specs
        self._assemble = assemble
        self._builder = builder
        self._payload = payload
        self._fallback = fallback
        self._name = name
        if watchdog_s is None:
            watchdog_s = float(os.environ.get(WATCHDOG_ENV, "30"))
        self._watchdog_s = watchdog_s
        self._boot_grace_s = max(_BOOT_GRACE_S, watchdog_s)
        # Zero-copy shm transport: one ring per worker when both knobs
        # are set (data/shm_ring.py); 0 keeps the pickle-through-queue
        # hand-off.  The quarantine journal is shared with the tensor
        # cache so corrupt slots and corrupt blobs land in one place.
        self._shm_slots = max(int(shm_slots), 0)
        self._shm_slot_bytes = max(int(shm_slot_bytes), 0)
        self._quarantine_path = quarantine_path
        self._ring_seq = 0
        raw = os.environ.get(CHAOS_SHM_CORRUPT_ENV, "").strip()
        self._chaos_shm_corrupt: Optional[int] = int(raw) if raw else None
        # spawn, not fork: the parent holds a CUDA context and threads,
        # which a forked child would inherit half-initialized.
        self._ctx = mp.get_context("spawn")
        self._heartbeat = self._ctx.Array("d", num_workers, lock=False)
        self._slots: list[Optional[_Slot]] = [None] * num_workers
        for wid in range(num_workers):
            self._slots[wid] = self._spawn(wid, respawns)
        # Consumer-side reorder buffer + dispatch window: specs are pulled
        # at most `window` ahead of the yield cursor, so memory stays
        # bounded however unevenly workers finish.
        self._window = max(4, 2 * num_workers * _WORKER_DEPTH)
        self._pending: list[int] = []   # indices needing (re)assignment
        self._spec_buf: dict[int, object] = {}  # idx -> spec until yielded
        self._done: dict[int, object] = {}      # idx -> assembled batch
        self._next_yield = start_index
        self._next_spec = start_index
        self._exhausted = False
        self._mode = "service"  # -> "sync" after fallback degradation
        self._closed = False
        self._last_watchdog = 0.0
        self.deaths = 0
        self.reassigned = 0
        self.fell_back = False
        # One hello a started worker: {"worker", "pid", "cuda"}.
        self.hellos: list[dict] = []
        log.info(
            "%s: %d decode worker(s) (spawn), respawn budget %d/worker, "
            "watchdog %.1fs, transport %s", name, num_workers, respawns,
            watchdog_s,
            f"shm ring ({self._shm_slots} x {self._shm_slot_bytes}B/worker)"
            if self._shm_on else "pickle queue",
        )

    @property
    def _shm_on(self) -> bool:
        return self._shm_slots > 0 and self._shm_slot_bytes > 0

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, wid: int, respawns_left: int) -> _Slot:
        task_q = self._ctx.Queue()
        result_q = self._ctx.Queue(maxsize=_RESULT_DEPTH)
        ring = None
        if self._shm_on:
            # A FRESH ring per (worker, respawn): failure isolation
            # matches the per-worker queues — a crashing writer can tear
            # only its own segment, and the respawn starts clean.
            self._ring_seq += 1
            ring = ShmRing(
                self._ctx, self._shm_slots, self._shm_slot_bytes,
                name=f"mxr{os.getpid()}_{self._ring_seq}",
            )
        self._heartbeat[wid] = 0.0  # 0 = not yet booted (grace applies)
        proc = self._ctx.Process(
            target=_service_worker,
            args=(wid, self._builder, self._payload, task_q, result_q,
                  self._heartbeat, os.getpid(),
                  ring.handle() if ring else None),
            name=f"{self._name}-worker-{wid}",
            daemon=True,
        )
        proc.start()
        return _Slot(proc, task_q, result_q, respawns_left, ring=ring)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for slot in self._slots:
            if slot is None:
                continue
            try:
                slot.task_q.put_nowait(None)
            except Exception:  # noqa: BLE001 — queue may be broken/full
                pass
        for slot in self._slots:
            if slot is None:
                continue
            slot.proc.join(timeout=2.0)
            if slot.proc.is_alive():
                slot.proc.kill()
                slot.proc.join(timeout=2.0)
            self._discard_queues(slot)
            if slot.ring is not None:
                # Unlinks now; the segment unmaps once any still-live
                # zero-copy batch views (already yielded) are collected.
                slot.ring.close()
        self._slots = [None] * len(self._slots)

    @staticmethod
    def _discard_queues(slot: _Slot) -> None:
        for q in (slot.task_q, slot.result_q):
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    # -- iterator protocol -------------------------------------------------

    def __iter__(self) -> "InputService":
        return self

    def __next__(self):
        if self._mode == "sync":
            return self._sync_next()
        while True:
            if self._next_yield in self._done:
                batch = self._done.pop(self._next_yield)
                self._spec_buf.pop(self._next_yield, None)
                self._next_yield += 1
                return batch
            if self._finished():
                self.close()
                raise StopIteration
            self._dispatch()
            if not self._poll_results():
                now = time.time()
                if now - self._last_watchdog >= min(0.2, self._watchdog_s / 4):
                    self._watchdog(now)
                    if self._mode == "sync":
                        return self._sync_next()
                time.sleep(_POLL_S)

    def _finished(self) -> bool:
        return (
            self._exhausted
            and not self._pending
            and not self._done
            and not any(s and s.outstanding for s in self._slots)
        )

    # -- dispatch / results ------------------------------------------------

    def _dispatch(self) -> None:
        while True:
            slot = self._idle_slot()
            if slot is None:
                return
            if self._pending:
                idx = heapq.heappop(self._pending)
                spec = self._spec_buf[idx]
            else:
                if self._exhausted or self._next_spec >= self._next_yield + self._window:
                    return
                try:
                    spec = next(self._specs)
                except StopIteration:
                    self._exhausted = True
                    return
                idx = self._next_spec
                self._next_spec += 1
                self._spec_buf[idx] = spec
            slot.outstanding.add(idx)
            try:
                slot.task_q.put_nowait((idx, spec))
            except Exception:  # noqa: BLE001 — broken pipe: watchdog reaps
                return

    def _idle_slot(self) -> Optional[_Slot]:
        """A live slot with room for a task: a booted worker (its heartbeat
        started) before one still booting, then the fewest in flight.  So
        a batch reassigned after a death goes to a worker that can take it
        now, not to the respawn still importing (JAX's service ranks by
        load alone; the schedule is the same either way)."""
        best, best_key = None, None
        for wid, slot in enumerate(self._slots):
            if slot is None or len(slot.outstanding) >= _WORKER_DEPTH:
                continue
            key = (self._heartbeat[wid] == 0.0, len(slot.outstanding))
            if best is None or key < best_key:
                best, best_key = slot, key
        return best

    def _poll_results(self) -> bool:
        got = False
        for wid, slot in enumerate(self._slots):
            if slot is None:
                continue
            while True:
                try:
                    msg = slot.result_q.get_nowait()
                except queue.Empty:
                    break
                except Exception as e:  # noqa: BLE001 — torn result pipe
                    self._fail_slot(wid, f"result stream corrupt ({e})")
                    break
                self._accept(slot, msg)
                got = True
        return got

    def _accept(self, slot: Optional[_Slot], msg,
                salvage: bool = False) -> None:
        kind, idx, val = msg
        if kind == "hello":
            self.hellos.append(val)
            log.info("%s: worker %d (pid %d) up; cuda available: %s", self._name,
                     val["worker"], val["pid"], val["cuda"])
            return
        if slot is not None:
            slot.outstanding.discard(idx)
        if idx < self._next_yield or idx in self._done:
            if kind == "shm" and slot is not None and slot.ring is not None:
                slot.ring.release(val[0])  # duplicate: recycle the slot
            return  # duplicate after reassignment — content is identical
        if kind == "err":
            # Assembly is deterministic (the loader already absorbs I/O
            # flakiness via retry+quarantine inside _assemble), so a raise
            # here reproduces on any worker: surface it, typed.
            self.close()
            raise InputServiceError(
                f"{self._name}: batch {idx} assembly failed in a worker: "
                f"{val}"
            )
        if kind == "shm":
            self._accept_shm(slot, idx, val, salvage)
            return
        if kind == "shm_overflow":
            obs.counter(
                "data_shm_overflows_total",
                "host batches over the shm slot size, shipped by pickle",
            ).inc(service=self._name)
        if kind == "shm_stall":
            # Worker gave up waiting on a full ring (consumer is holding
            # yielded batches alive, pinning the slots) and shipped this
            # batch via pickle.  Count the wait; content is identical.
            val, stalls = val
            obs.counter(
                "data_shm_ring_stalls_total",
                "worker waits on a full shm ring (backpressure)",
            ).inc(stalls, service=self._name)
        self._done[idx] = val

    def _accept_shm(self, slot: _Slot, idx: int, ref, salvage: bool) -> None:
        """Map one delivered ring slot.  ``salvage=True`` (dead worker)
        copies out of the segment so the ring can be unlinked; the normal
        path hands the consumer zero-copy views that release the slot when
        garbage-collected.  A CRC/torn-write failure is quarantined like a
        corrupt cache blob and the index reassigned — the yielded stream
        stays bit-identical."""
        slot_id, nbytes, stalls = ref
        if self._chaos_shm_corrupt == idx:
            self._chaos_shm_corrupt = None  # one-shot
            log.warning(
                "%s: chaos: corrupting shm slot %d (batch %d)",
                self._name, slot_id, idx,
            )
            slot.ring.corrupt_slot(slot_id)
        try:
            val, _ = slot.ring.read(slot_id, copy=salvage)
        except ValueError as e:
            reason = str(e).split(":", 1)[0]
            if reason not in ("shm_checksum", "shm_truncated"):
                reason = "shm_decode"
            obs.emit("data", "shm_quarantine", {
                "service": self._name, "batch_index": idx,
                "slot": slot_id, "reason": reason, "error": str(e),
            }, logger=log)
            obs.counter(
                "data_shm_quarantines_total",
                "corrupt/torn shm ring slots quarantined",
            ).inc(service=self._name, reason=reason)
            if self._quarantine_path:
                quarantine_append(self._quarantine_path, {
                    "kind": "shm_slot", "service": self._name,
                    "batch_index": idx, "slot": slot_id,
                    "reason": reason, "error": str(e),
                    "time": time.time(),
                })
            slot.ring.release(slot_id)
            heapq.heappush(self._pending, idx)
            self.reassigned += 1
            obs.counter(
                "data_batches_reassigned_total",
                "in-flight batches returned to the pending heap",
            ).inc(service=self._name)
            return
        obs.counter(
            "data_shm_bytes_total",
            "tensor bytes shipped zero-copy through shm rings",
        ).inc(nbytes, service=self._name)
        if stalls:
            obs.counter(
                "data_shm_ring_stalls_total",
                "worker waits on a full shm ring (backpressure)",
            ).inc(stalls, service=self._name)
        self._done[idx] = val

    # -- watchdog / failure handling ---------------------------------------

    def _watchdog(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self._last_watchdog = now
        for wid, slot in enumerate(self._slots):
            if slot is None:
                continue
            alive = slot.proc.is_alive()
            hb = self._heartbeat[wid]
            if hb > 0:
                stale = now - hb > self._watchdog_s
            else:  # still booting (spawn + package import)
                stale = now - slot.spawned_at > self._boot_grace_s
            if alive and not stale:
                continue
            if alive:
                obs.emit("data", "worker_wedged", {
                    "service": self._name, "worker": wid,
                    "heartbeat_age_s": now - (hb or slot.spawned_at),
                }, logger=log)
                slot.proc.kill()
                slot.proc.join(timeout=5.0)
                why = "wedged"
            else:
                why = f"died (exit {slot.proc.exitcode})"
            self._fail_slot(wid, why)
        if all(s is None for s in self._slots):
            self._go_dead()

    def _fail_slot(self, wid: int, why: str) -> None:
        slot = self._slots[wid]
        if slot is None:
            return
        self.deaths += 1
        if slot.proc.is_alive():
            slot.proc.kill()
            slot.proc.join(timeout=5.0)
        # Salvage results the worker delivered before dying — re-assembling
        # them would be wasted work (content is deterministic either way).
        # salvage=True: shm results are copied out so the dead worker's
        # ring can be torn down instead of pinning live batch views to an
        # unlinked segment.
        while True:
            try:
                self._accept(slot, slot.result_q.get_nowait(), salvage=True)
            except queue.Empty:
                break
            except Exception:  # noqa: BLE001 — torn pipe dies with worker
                break
        # Deterministic reassignment: every in-flight index goes back on
        # the pending heap; live workers pick them up in index order.
        lost = sorted(slot.outstanding)
        for idx in lost:
            heapq.heappush(self._pending, idx)
        self.reassigned += len(lost)
        self._discard_queues(slot)
        if slot.ring is not None:
            slot.ring.close()  # respawn gets a FRESH ring
        obs.counter(
            "data_worker_deaths_total", "decode worker deaths/wedges"
        ).inc(service=self._name)
        obs.counter(
            "data_batches_reassigned_total",
            "in-flight batches returned to the pending heap",
        ).inc(len(lost), service=self._name)
        if slot.respawns_left > 0:
            obs.emit("data", "worker_death", {
                "service": self._name, "worker": wid, "why": why,
                "lost": len(lost), "indices": lost,
                "respawns_left": slot.respawns_left - 1,
            }, logger=log)
            self._slots[wid] = self._spawn(wid, slot.respawns_left - 1)
        else:
            obs.emit("data", "worker_retired", {
                "service": self._name, "worker": wid, "why": why,
                "lost": len(lost), "indices": lost,
            }, logger=log)
            self._slots[wid] = None

    def _go_dead(self) -> None:
        """No live workers, no respawn budget: degrade or die — typed."""
        self.close()
        if not self._fallback:
            raise InputServiceDead(
                f"{self._name}: all workers dead and respawn budget "
                f"exhausted after {self.deaths} death(s)"
            )
        obs.emit("data", "service_fallback", {
            "service": self._name, "deaths": self.deaths,
        }, logger=log)
        if self._quarantine_path:
            quarantine_append(self._quarantine_path, {
                "kind": "service_fallback", "service": self._name,
                "reason": "service_fallback", "deaths": self.deaths,
                "batch_index": self._next_yield,
            })
        self.fell_back = True
        self._mode = "sync"

    # -- degraded mode -----------------------------------------------------

    def _sync_next(self):
        """In-process assembly from the yield cursor onward.  Uses salvaged
        ``_done`` results first; specs already pulled from the stream sit
        in ``_spec_buf``, the rest come straight off the iterator — the
        yielded schedule is unchanged."""
        idx = self._next_yield
        if idx in self._done:
            batch = self._done.pop(idx)
            self._spec_buf.pop(idx, None)
            self._next_yield += 1
            return batch
        spec = self._spec_buf.pop(idx, None)
        if spec is None:
            if self._exhausted:
                raise StopIteration
            try:
                spec = next(self._specs)
            except StopIteration:
                self._exhausted = True
                raise StopIteration from None
            assert self._next_spec == idx, (
                f"spec cursor desync: {self._next_spec} != {idx}"
            )
            self._next_spec += 1
        self._next_yield += 1
        return self._assemble(spec)
