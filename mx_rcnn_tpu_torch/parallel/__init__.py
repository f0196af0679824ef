"""Step bodies: the single-device train step."""
