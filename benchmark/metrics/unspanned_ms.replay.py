"""Mean round trip less the part the daemon's spans cover, in ms."""
from benchmark.span_readers import unspanned_ms as read  # noqa: F401
