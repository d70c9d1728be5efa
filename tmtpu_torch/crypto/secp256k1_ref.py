"""Pure-Python secp256k1 ECDSA: the port's own copy of the reference
package's ``crypto/secp256k1_ref.py``.

Exactly what the key type needs: Jacobian point arithmetic, SEC 1
compressed-point coding, RFC 6979 deterministic nonces and ECDSA sign and
verify over SHA-256 digests. The low-S rule lives in the caller
(``secp256k1.py``), as the reference splits curve math from consensus rules
(crypto/secp256k1/secp256k1.go:195-197). The port signs its smoke and test
votes with it, builds the kernel's fixed-base table from it, and uses it as
the per-lane oracle.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional, Tuple

# curve parameters (SEC 2): y^2 = x^3 + 7 over F_P
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Point = Optional[Tuple[int, int]]  # None is the point at infinity


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


# --- Jacobian arithmetic (one inversion per scalar mult, not per add) --------


def _to_jac(pt: Point):
    if pt is None:
        return (0, 1, 0)
    return (pt[0], pt[1], 1)


def _from_jac(j) -> Point:
    x, y, z = j
    if z == 0:
        return None
    zi = _inv(z, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _jac_double(j):
    x, y, z = j
    if z == 0 or y == 0:
        return (0, 1, 0)
    s = 4 * x * y * y % P
    m = 3 * x * x % P  # a == 0 for secp256k1
    x2 = (m * m - 2 * s) % P
    y2 = (m * (s - x2) - 8 * pow(y, 4, P)) % P
    z2 = 2 * y * z % P
    return (x2, y2, z2)


def _jac_add(j1, j2):
    if j1[2] == 0:
        return j2
    if j2[2] == 0:
        return j1
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return _jac_double(j1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    h2 = h * h % P
    h3 = h2 * h % P
    x3 = (r * r - h3 - 2 * u1 * h2) % P
    y3 = (r * (u1 * h2 - x3) - s1 * h3) % P
    z3 = h * z1 * z2 % P
    return (x3, y3, z3)


def point_add(p1: Point, p2: Point) -> Point:
    return _from_jac(_jac_add(_to_jac(p1), _to_jac(p2)))


def scalar_mult(k: int, pt: Point = (GX, GY)) -> Point:
    k %= N
    if k == 0 or pt is None:
        return None
    acc = (0, 1, 0)
    add = _to_jac(pt)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return _from_jac(acc)


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return False
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x + 7)) % P == 0


# --- compressed-point codec (SEC 1 §2.3.3/2.3.4) ----------------------------


def compress(pt: Tuple[int, int]) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def decompress(data: bytes) -> Point:
    """33-byte compressed point → (x, y); None when not a curve point."""
    if len(data) != 33 or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)  # P ≡ 3 (mod 4)
    if y * y % P != y2:
        return None  # x has no square root: not on the curve
    if (y & 1) != (data[0] & 1):
        y = P - y
    return (x, y)


# --- RFC 6979 deterministic nonce -------------------------------------------


def _rfc6979_k(priv: int, h1: bytes) -> int:
    """Deterministic ECDSA nonce (RFC 6979 §3.2, HMAC-SHA256)."""
    holen = 32
    x = priv.to_bytes(32, "big")
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# --- ECDSA over a SHA-256 digest --------------------------------------------


def sign_digest(priv: int, digest: bytes) -> Tuple[int, int]:
    """(r, s) over ``digest``; nonce per RFC 6979. The caller applies
    the low-S consensus rule."""
    z = int.from_bytes(digest[:32], "big")
    while True:
        k = _rfc6979_k(priv, digest)
        pt = scalar_mult(k)
        r = pt[0] % N
        if r == 0:
            digest = hashlib.sha256(digest).digest()  # re-derive; ~never
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        return r, s


def verify_digest(pub: Tuple[int, int], digest: bytes, r: int,
                  s: int) -> bool:
    if not (0 < r < N and 0 < s < N):
        return False
    if not is_on_curve(pub):
        return False
    z = int.from_bytes(digest[:32], "big")
    w = _inv(s, N)
    u1 = z * w % N
    u2 = r * w % N
    pt = _from_jac(_jac_add(
        _to_jac(scalar_mult(u1)),
        _to_jac(scalar_mult(u2, pub))))
    if pt is None:
        return False
    return pt[0] % N == r
