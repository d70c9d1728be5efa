"""The signature cache's resolve: ms per 1,000 lanes of its spans."""
from benchmark.span_readers import resolve_ms_per_klane as read  # noqa: F401
