"""Lanes a joint dispatch carried in the window (Stats)."""
from benchmark.readers import lanes_per_dispatch as read  # noqa: F401
