"""Plain ed25519 verification (RFC 8032 §5.1.7, Go's crypto/ed25519 rules).

The benchmark's reference: Python integers only, written from the RFC and
independent of the program under test. A signature ``R || s`` on ``msg``
under the key ``A`` is valid when ``s < L``, ``A`` decodes to a point on
the curve, and the encoding of ``[s]B - [h]A`` equals ``R``, where ``h =
SHA-512(R || A || msg) mod L`` (the cofactorless check, as Go's
``ed25519.Verify`` makes it). A few milliseconds a lane.
"""

from __future__ import annotations

import hashlib

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_BY = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
B = (_BX, _BY, 1, _BX * _BY % P)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def _mul(k: int, p):
    q = (0, 1, 1, 0)
    while k:
        if k & 1:
            q = _add(q, p)
        p = _add(p, p)
        k >>= 1
    return q


def _encode(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decode(s: bytes):
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return x, y, 1, x * y % P


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Whether ``sig`` is a valid signature of ``msg`` under ``pk``."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    a = _decode(pk)
    if a is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
    neg_a = (P - a[0], a[1], a[2], P - a[3])
    return _encode(_add(_mul(s, B), _mul(h, neg_a))) == sig[:32]


def verify_many(lanes):
    """``verify`` of each (pk, msg, sig); a process pool's unit of work."""
    return [verify(pk, m, s) for pk, m, s in lanes]


def challenge(pk: bytes, msg: bytes, sig: bytes) -> int:
    """h = SHA-512(R || A || msg) mod L."""
    return int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
