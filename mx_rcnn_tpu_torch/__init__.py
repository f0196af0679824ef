"""PyTorch/CUDA port of ``mx_rcnn_tpu``.

The JAX package stays beside this one as the reference.  This package
imports torch and never imports jax, flax or ``mx_rcnn_tpu``: the host
modules it needs (config, transforms, postprocess) are its own copies.

Importing it builds nothing and touches no device: the CUDA kernels under
``csrc/`` are compiled on first use (``ops/cuda/_build.py``), and every
entry point runs on the card unless the caller asks for the CPU.
"""

import os as _os

# The runtime lock-order sanitizer (analysis/lockcheck.py), env-gated so
# that the one variable activates it in every process of a run (the input
# service's decode workers import this package too).  It must install
# before any module of the package creates its locks; the package's import
# is the earliest common point.  Unset (the default) this is one getenv.
if _os.environ.get("MX_RCNN_LOCKCHECK") == "1":
    from mx_rcnn_tpu_torch.analysis import lockcheck as _lockcheck

    _lockcheck.install()
    del _lockcheck
del _os
