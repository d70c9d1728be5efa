"""Host prep of ed25519 lanes: ms per 1,000 lanes of its spans."""
from benchmark.readers import prep_ms_per_klane as read  # noqa: F401
