"""Serving runtime: the runner, the engine and ``build_engine``."""
