"""The ed25519 kernel's share of its roofline, in %."""
from benchmark.readers import ed25519_roofline as read  # noqa: F401
