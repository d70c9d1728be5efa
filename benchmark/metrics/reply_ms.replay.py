"""Mean handoff to the reply thread plus the reply, a window request, in ms."""
from benchmark.span_readers import reply_ms as read  # noqa: F401
