"""The daemon's columnar decode of a verify frame: ms per 1,000 lanes of its spans."""
from benchmark.span_readers import decode_ms_per_klane as read  # noqa: F401
