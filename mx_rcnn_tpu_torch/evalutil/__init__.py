"""Detection-output postprocessing on the host."""
