"""The secp256k1 kernel's share of its roofline, in %."""
from benchmark.k1_readers import secp256k1_roofline as read  # noqa: F401
