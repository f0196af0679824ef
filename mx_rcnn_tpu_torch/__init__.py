"""PyTorch/CUDA port of ``mx_rcnn_tpu``.

The JAX package stays beside this one as the reference.  This package
imports torch and never imports jax, flax or ``mx_rcnn_tpu``: the host
modules it needs (config, transforms, postprocess) are its own copies.

Importing it builds nothing and touches no device: the CUDA kernels under
``csrc/`` are compiled on first use (``ops/cuda/_build.py``), and every
entry point runs on the card unless the caller asks for the CPU.
"""
