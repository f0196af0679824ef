"""Build the native host library with g++ (port of
``mx_rcnn_tpu/native/build.py``; no setuptools, no pybind11).

    python -m mx_rcnn_tpu_torch.native.build

The flags are the JAX package's: ``-O3 -shared -fPIC -std=c++17``, no
``-march=native`` and no fast-math, so the library computes the same bits
as the JAX package's and as the numpy versions in ``native/lib.py``.  The
library lands in ``mx_rcnn_tpu_torch/_build/`` (git-ignored) under a name
that hashes the source and the flags, so an edited source is rebuilt and
never served stale; it is compiled to a temporary file and renamed into
place, so parallel builds never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "native" / "src" / "native.cc"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libnative-{h.hexdigest()[:16]}.so"


def build(verbose: bool = True) -> Path:
    """The built library's path, compiled now unless it is there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    build()
