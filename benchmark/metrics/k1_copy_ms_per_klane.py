"""The secp256k1 plane's copy to the card and the mask's copy back: ms per
1,000 lanes of their spans."""
from benchmark.k1_readers import k1_copy_ms_per_klane as read  # noqa: F401
