"""Checkpoint save and restore (port of ``mx_rcnn_tpu/train/checkpoint.py``
without orbax: the port cannot read orbax files, and weights cross
packages through ``weights.py``).

Layout, one directory a step:

    <ckpt>/<step>/state.pt      torch.save of CPU tensors: {"step",
                                "model" (parameters and FrozenBN buffers),
                                "optimizer": {"step", "momentum"}}
    <ckpt>/manifest-<step>.json {"step", "tree_crc", "valid", "files":
                                {"state.pt": {"bytes", "crc"}}}

The manifest has the JAX package's schema, so its ``verify_manifest``
(and the deployer in ``ctrl/deploy.py``) accepts a port checkpoint.  A
step is written into ``<ckpt>/.saving`` and renamed into place, so a
step directory is complete or absent; the manifest follows the rename.
``restore_checkpoint`` walks back past a step that is truncated or
corrupt on disk, fails its manifest, or fails the caller's ``validate``.
One process writes a checkpoint directory at a time.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch.train.state import TrainState

log = logging.getLogger("mx_rcnn_tpu_torch")

STATE_FILE = "state.pt"
_SAVING = ".saving"


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def tree_crc(tree) -> int:
    """Order-independent CRC32 of every leaf of nested dicts, lists and
    tuples (shape, numpy dtype string and bytes a leaf; the leaf digests
    sorted before they are combined), as the JAX package defines it."""
    crcs = []
    for leaf in _leaves(tree):
        arr = _numpy(leaf)
        h = zlib.crc32(str((arr.shape, str(arr.dtype))).encode())
        h = zlib.crc32(np.ascontiguousarray(arr).tobytes(), h)
        crcs.append(h)
    out = 0
    for h in sorted(crcs):
        out = zlib.crc32(h.to_bytes(4, "big"), out)
    return out


def finite_state(tree) -> bool:
    """True when every floating-point leaf is finite."""
    for leaf in _leaves(tree):
        arr = _numpy(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
            return False
    return True


def state_payload(state: TrainState) -> dict:
    """What a checkpoint holds of ``state``, as CPU tensors.  The step's
    generator is not saved: each step reseeds it from (train.seed, step)."""
    opt = state.optimizer
    return {
        "step": int(state.step),
        "model": {k: v.detach().to("cpu", copy=True)
                  for k, v in state.model.state_dict().items()},
        "optimizer": {"step": int(opt.step),
                      "momentum": {n: t.detach().to("cpu", copy=True)
                                   for n, t in zip(opt.names, opt.trace)}},
    }


def load_payload(state: TrainState, payload: dict) -> TrainState:
    """Copy a checkpoint's payload into ``state`` in place."""
    opt = state.optimizer
    momentum = payload["optimizer"]["momentum"]
    if sorted(momentum) != sorted(opt.names):
        raise ValueError("the checkpoint's momentum buffers are not the optimizer's: "
                         f"{sorted(set(momentum) ^ set(opt.names))[:4]}")
    state.model.load_state_dict(payload["model"])
    with torch.no_grad():
        for n, t in zip(opt.names, opt.trace):
            t.copy_(momentum[n])
    opt.step = int(payload["optimizer"]["step"])
    state.step = int(payload["step"])
    return state


def manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"manifest-{int(step)}.json")


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), str(int(step)))


def write_manifest(ckpt_dir: str, step: int, payload: dict) -> str:
    """``manifest-<step>.json`` beside the step directory: the step, the
    payload's tree CRC, whether it is finite, and each file's size and
    CRC.  Atomic via tmp + rename."""
    sdir = step_dir(ckpt_dir, step)
    files = {}
    for name in sorted(os.listdir(sdir)):
        with open(os.path.join(sdir, name), "rb") as f:
            data = f.read()
        files[name] = {"bytes": len(data), "crc": zlib.crc32(data)}
    manifest = {"step": int(step), "tree_crc": tree_crc(payload),
                "valid": finite_state(payload), "files": files}
    path = manifest_path(ckpt_dir, step)
    with open(path + ".tmp", "w") as f:
        json.dump(manifest, f, sort_keys=True)
    os.replace(path + ".tmp", path)
    return path


def read_manifest(ckpt_dir: str, step: int) -> Optional[dict]:
    """The parsed manifest of ``step``, or None when missing or unreadable."""
    try:
        with open(manifest_path(ckpt_dir, step)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_manifest(ckpt_dir: str, step: int) -> tuple[bool, str]:
    """File-level check of a step without deserializing it: the manifest
    parses, names the step, declared itself valid, and every file it lists
    still has its size and CRC."""
    if not os.path.exists(manifest_path(ckpt_dir, step)):
        return False, "manifest_missing"
    manifest = read_manifest(ckpt_dir, step)
    if manifest is None:
        return False, "manifest_unreadable"
    if manifest.get("step") != int(step):
        return False, "manifest_step_mismatch"
    if manifest.get("valid") is not True:
        return False, "invalid_at_save"
    for rel, rec in sorted((manifest.get("files") or {}).items()):
        try:
            with open(os.path.join(step_dir(ckpt_dir, step), rel), "rb") as f:
                data = f.read()
        except OSError:
            return False, f"file_missing:{rel}"
        if len(data) != rec.get("bytes") or zlib.crc32(data) != rec.get("crc"):
            return False, f"file_checksum_mismatch:{rel}"
    return True, "ok"


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Save ``state`` at its step and write its manifest; a step already
    on disk is left alone.  Returns the step directory."""
    root = os.path.abspath(ckpt_dir)
    step = int(state.step)
    final = step_dir(root, step)
    if os.path.exists(os.path.join(final, STATE_FILE)):
        return final
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, _SAVING)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    payload = state_payload(state)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    write_manifest(root, step, payload)
    return final


def all_steps(ckpt_dir: str) -> list[int]:
    """Ascending steps with a state file under ``ckpt_dir`` ([] if none)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isfile(os.path.join(ckpt_dir, n, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_payload(ckpt_dir: str, step: int) -> dict:
    """One step's payload, after its manifest (when there is one) passes."""
    ok, why = verify_manifest(ckpt_dir, step)
    if not ok and why != "manifest_missing":
        raise ValueError(f"checkpoint step {step} fails its manifest: {why}")
    return torch.load(os.path.join(step_dir(ckpt_dir, step), STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, target: TrainState, step: Optional[int] = None, *,
                       validate: Optional[Callable[[dict], bool]] = None) -> TrainState:
    """Restore into ``target`` (in place; returned).  ``step=None`` takes
    the newest step and walks back to older steps past one that is
    truncated or corrupt, fails its manifest, or fails ``validate``
    (called on the payload); an explicit ``step`` does not walk back."""
    candidates = [step] if step is not None else list(reversed(all_steps(ckpt_dir)))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    last_err: Optional[BaseException] = None
    for s in candidates:
        try:
            payload = read_payload(ckpt_dir, s)
            if validate is not None and not validate(payload):
                raise ValueError(f"checkpoint step {s} failed restore validation")
            if s != candidates[0]:
                log.warning("checkpoint step %d unusable (%s); fell back to step %d",
                            candidates[0], last_err, s)
            return load_payload(target, payload)
        except Exception as e:
            if step is not None:
                raise
            last_err = e
            log.warning("restoring checkpoint step %d from %s failed (%s: %s); trying an "
                        "earlier step", s, ckpt_dir, type(e).__name__, e)
    raise RuntimeError(f"every checkpoint under {ckpt_dir} failed to restore (steps tried: "
                       f"{candidates}); last error: {last_err!r}")
