"""Plain secp256k1 ECDSA verification (SEC 1 §4.1.4, Tendermint's rules).

The benchmark's reference: Python integers only, written from SEC 1 and
SEC 2 and independent of the program under test. A signature ``R || S``
(64 bytes, big-endian r and s) on ``msg`` under the key ``Q`` is valid
when
- ``Q`` is a 33-byte SEC 1 compressed point: prefix 2 or 3, x < p, and
  x^3 + 7 a square mod p (the key is on the curve);
- r and s lie in [1, n - 1] and s <= n/2, the low-S rule of Tendermint
  v0.34 (crypto/secp256k1/secp256k1.go:195-197);
- with e = SHA-256(msg) read big-endian (SEC 1 §4.1.4 step 5: the digest
  is 256 bits, as wide as n, so nothing is truncated), u1 = e s^-1 and
  u2 = r s^-1 mod n, the point [u1]G + [u2]Q is not the identity and its
  x mod n equals r.

Departures from SEC 1 §4.1.4: the low-S rule is Tendermint's and not
SEC 1's (a high-S signature that SEC 1 and OpenSSL accept is refused);
the key arrives compressed, so the check that Q is on the curve is its
decompression (a compressed point with a square root is on the curve, and
the curve's order is prime, so no cofactor check is needed). A few
milliseconds a lane.
"""

from __future__ import annotations

import hashlib

P = 2 ** 256 - 2 ** 32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)

# Jacobian (X, Y, Z) with x = X/Z^2, y = Y/Z^3; Z = 0 is the identity
_IDENTITY = (0, 1, 0)


def _double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return _IDENTITY
    s = 4 * x * y * y % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    return x3, (m * (s - x3) - 8 * pow(y, 4, P)) % P, 2 * y * z % P


def _add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    if u1 == u2:
        return _double(p) if s1 == s2 else _IDENTITY
    h, r = (u2 - u1) % P, (s2 - s1) % P
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return x3, (r * (v - x3) - s1 * hhh) % P, h * z1 * z2 % P


def _mul(k: int, p):
    q = _IDENTITY
    while k:
        if k & 1:
            q = _add(q, p)
        p = _double(p)
        k >>= 1
    return q


def decompress(pk: bytes):
    """The Jacobian point of a 33-byte compressed key, or None."""
    if len(pk) != 33 or pk[0] not in (2, 3):
        return None
    x = int.from_bytes(pk[1:], "big")
    if x >= P:
        return None
    y2 = (x * x * x + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if y & 1 != pk[0] & 1:
        y = P - y
    return x, y, 1


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Whether ``sig`` is a valid low-S signature of ``msg`` under ``pk``."""
    if len(sig) != 64:
        return False
    q = decompress(pk)
    if q is None:
        return False
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    if not (0 < r < N and 0 < s < N) or s > N // 2:
        return False
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, -1, N)
    x, _, z = _add(_mul(e * w % N, (*G, 1)), _mul(r * w % N, q))
    if z == 0:
        return False
    return x * pow(z * z, -1, P) % P % N == r
