"""Host prep of secp256k1 lanes: ms per 1,000 lanes of its spans."""
from benchmark.k1_readers import k1_prep_ms_per_klane as read  # noqa: F401
