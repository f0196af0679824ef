"""Utilities: the mixed-precision policy and device resolution."""
