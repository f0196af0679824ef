"""Utilities: the mixed-precision policy."""
