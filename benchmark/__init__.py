"""The benchmark of the port's sidecar daemon (see run.py)."""
