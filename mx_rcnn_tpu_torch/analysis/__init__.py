"""Runtime analysis of the port's host code (``lockcheck``: the lock-order
sanitizer, installed by ``MX_RCNN_LOCKCHECK=1``)."""
