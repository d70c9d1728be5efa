"""Mean part of a window request's queue wait the gather window lingered, in ms."""
from benchmark.span_readers import linger_ms as read  # noqa: F401
