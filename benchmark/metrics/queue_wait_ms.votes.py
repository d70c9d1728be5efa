"""Mean time a window request waited in the coalescer's queue, in ms."""
from benchmark.span_readers import queue_wait_ms as read  # noqa: F401
