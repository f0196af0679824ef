"""Training: optimizer and schedule, state, and the loop."""
