"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel lives in ``mx_rcnn_tpu_torch/csrc/<name>.cu`` behind a plain C
entry point: pointers and the stream as ``void*``, sizes as ``int``, and a
return value of ``cudaGetLastError()`` right after the launch.  ``nvcc``
compiles it into ``mx_rcnn_tpu_torch/_build/lib<name>-<hash>.so`` (the
directory is git-ignored), where the hash covers the sources and the flags,
so an edited source is rebuilt and never served stale.  Nothing includes
PyTorch's headers, so a build takes seconds.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so that ``a*b+c`` rounds
twice, exactly as the plain torch versions of the kernels do, and never
``--use_fast_math`` (``expf`` and IEEE division must match torch's).
``-Xptxas -v`` prints registers, shared memory and spills, which the
build log keeps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)

# The kernels the port builds, one source file each.
KERNELS = ("roi_align", "roi_align_bwd", "middle", "nms")


class KernelError(RuntimeError):
    """A kernel failed to build, to load, or to launch."""


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns the
    (process, output path, temp path, start time) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp, time.perf_counter()


def _finish(name: str, started) -> dict:
    proc, out, tmp, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": log}


def build_all(names=KERNELS) -> dict[str, dict]:
    """Build every named kernel with one ``nvcc`` per source, all started
    together; returns ``{name: {"seconds", "log"}}`` for those built now."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items() if s is not None}


_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib


_ENTRIES: dict = {}


def entry(name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of kernel ``name`` with its argument types
    set once; it returns a CUDA error code (``int``)."""
    key = (name, symbol)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise when a C entry point of kernel ``name`` returned a CUDA error
    code."""
    if rc != 0:
        fn = load(name).kernel_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise KernelError(f"{what}: CUDA error {rc} ({fn(rc).decode()})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
