"""Detection ops: top-k, NMS, proposals, ROIAlign (plain torch), and the
CUDA kernels under ``ops/cuda``."""
