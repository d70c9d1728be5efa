"""sr25519 key objects (schnorrkel: Schnorr signatures over ristretto255
with merlin transcripts), in pure Python: the port's own copy of the
reference package's ``crypto/sr25519.py`` without addresses or the key
registry.

The protocol, as in schnorrkel's sign.rs:

  t = merlin("SigningContext"); t.append("", ""); t.append("sign-bytes", m)
  t.append("proto-name", "Schnorr-sig"); t.append("sign:pk", A)
  r = witness scalar from (transcript, nonce); R = r B
  t.append("sign:R", R); k = challenge_scalar("sign:c")
  s = k key + r; sig = R || s with bit 7 of byte 63 set (schnorrkel marker)

Verification recomputes k and checks encode(s B - k A) == R. The private
key bytes are the 32-byte mini secret key, expanded ed25519-style (SHA-512,
clamp, divide by the cofactor) on use.
"""

from __future__ import annotations

import hashlib

from tmtpu_torch.crypto import ristretto
from tmtpu_torch.crypto.merlin import Transcript

KEY_TYPE = "sr25519"
PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 32
SIGNATURE_SIZE = 64

# group order l (the same as ed25519's L)
L = 2**252 + 27742317777372353535851937790883648493


def signing_context(msg: bytes) -> Transcript:
    """go-schnorrkel NewSigningContext([]byte{}, msg) with the protocol
    name and nothing else appended yet."""
    t = Transcript(b"SigningContext")
    t.append_message(b"", b"")
    t.append_message(b"sign-bytes", msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    return t


def challenge_k(pk: bytes, msg: bytes, r_bytes: bytes) -> int:
    """The challenge scalar k of a signature with R = ``r_bytes`` by
    ``pk`` over ``msg``, reduced mod L."""
    t = signing_context(msg)
    t.append_message(b"sign:pk", pk)
    t.append_message(b"sign:R", r_bytes)
    return int.from_bytes(t.challenge_bytes(b"sign:c", 64), "little") % L


def _expand_ed25519(mini: bytes):
    """schnorrkel MiniSecretKey::expand_ed25519 -> (key scalar, nonce)."""
    h = hashlib.sha512(mini).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    # divide by the cofactor: the low three bits are clamped to 0
    return int.from_bytes(key, "little") >> 3, h[32:64]


class PubKeySr25519:
    __slots__ = ("_bytes",)

    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PUB_KEY_SIZE:
            raise ValueError(f"sr25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(key_bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def type_value(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        if not sig[63] & 0x80:
            return False  # not marked as a schnorrkel signature
        A = ristretto.decode(self._bytes)
        if A is None:
            return False
        r_bytes = bytes(sig[:32])
        s = int.from_bytes(sig[32:63] + bytes([sig[63] & 0x7F]), "little")
        if s >= L:
            return False  # non-canonical scalar
        k = challenge_k(self._bytes, msg, r_bytes)
        R = ristretto.point_add(
            ristretto.scalar_mult(s, ristretto.BASEPOINT),
            ristretto.scalar_mult(k, ristretto.point_neg(A)))
        return ristretto.encode(R) == r_bytes


class PrivKeySr25519:
    __slots__ = ("_bytes",)

    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PRIV_KEY_SIZE:
            raise ValueError(f"sr25519 privkey must be {PRIV_KEY_SIZE} bytes")
        self._bytes = bytes(key_bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def type_value(self) -> str:
        return KEY_TYPE

    def sign(self, msg: bytes) -> bytes:
        key, nonce = _expand_ed25519(self._bytes)
        pub = self.pub_key().bytes()
        t = signing_context(msg)
        t.append_message(b"sign:pk", pub)
        # the witness rng's outside randomness is derived from nonce and
        # msg, so signing is deterministic; any choice verifies
        rng = hashlib.sha512(nonce + msg).digest()[:32]
        r = int.from_bytes(t.witness_bytes(b"signing", nonce, 64, rng_bytes=rng),
                           "little") % L
        R = ristretto.encode(ristretto.scalar_mult(r, ristretto.BASEPOINT))
        t.append_message(b"sign:R", R)
        k = int.from_bytes(t.challenge_bytes(b"sign:c", 64), "little") % L
        sig = bytearray(R + ((k * key + r) % L).to_bytes(32, "little"))
        sig[63] |= 0x80
        return bytes(sig)

    def pub_key(self) -> PubKeySr25519:
        key, _ = _expand_ed25519(self._bytes)
        return PubKeySr25519(ristretto.encode(
            ristretto.scalar_mult(key, ristretto.BASEPOINT)))


def gen_priv_key_from_secret(secret: bytes) -> PrivKeySr25519:
    return PrivKeySr25519(hashlib.sha256(secret).digest())
