"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain torch version beside it.  The directory mirrors the JAX
package's ``ops/pallas/``: ``roi_align.py`` (B1 and its backward B2),
``middle.py`` (B3) and ``nms.py`` (B4).  Importing a module here builds nothing."""
