"""Mean round trip less the mean flush span, in ms."""
from benchmark.readers import daemon_overhead_ms as read  # noqa: F401
