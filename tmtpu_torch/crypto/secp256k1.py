"""secp256k1 key objects on the pure-Python curve (``secp256k1_ref``): the
port's own copy of the reference package's ``crypto/secp256k1.py`` without
its OpenSSL engine, addresses or the key registry.

Signatures are 64-byte R || S over SHA-256(msg) with the low-S rule: signing
normalizes s to n - s when s > n/2, and verification rejects s > n/2, r or s
outside [1, n - 1] and wrong lengths (crypto/secp256k1/secp256k1.go:195-197).
Public keys are 33-byte compressed SEC 1 points. Nonces follow RFC 6979, so
signing is deterministic.
"""

from __future__ import annotations

import hashlib

from tmtpu_torch.crypto import secp256k1_ref as _ref

KEY_TYPE = "secp256k1"
PUB_KEY_SIZE = 33  # compressed
PRIV_KEY_SIZE = 32
SIG_SIZE = 64

N = _ref.N  # group order
HALF_N = N // 2


class PubKeySecp256k1:
    __slots__ = ("_bytes",)

    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PUB_KEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(key_bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def type_value(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIG_SIZE:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if s > HALF_N:  # malleable (not low-S) signatures are rejected
            return False
        if r == 0 or s == 0 or r >= N or s >= N:
            return False
        pt = _ref.decompress(self._bytes)
        if pt is None:
            return False
        return _ref.verify_digest(pt, hashlib.sha256(msg).digest(), r, s)


class PrivKeySecp256k1:
    __slots__ = ("_bytes",)

    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PRIV_KEY_SIZE:
            raise ValueError(f"secp256k1 privkey must be {PRIV_KEY_SIZE} bytes")
        if not 0 < int.from_bytes(key_bytes, "big") < N:
            raise ValueError("secp256k1 privkey scalar out of range")
        self._bytes = bytes(key_bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def type_value(self) -> str:
        return KEY_TYPE

    def sign(self, msg: bytes) -> bytes:
        r, s = _ref.sign_digest(int.from_bytes(self._bytes, "big"),
                                hashlib.sha256(msg).digest())
        if s > HALF_N:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> PubKeySecp256k1:
        return PubKeySecp256k1(_ref.compress(
            _ref.scalar_mult(int.from_bytes(self._bytes, "big"))))
