"""Hits of the signature cache over its lookups in the window (Stats), in %."""
from benchmark.readers import cache_hit_share as read  # noqa: F401
