"""The ristretto255 group in pure Python, on the port's edwards25519 oracle
(``ed25519_ref``): its own copy of the reference package's
``crypto/ristretto.py``.

Decode and encode follow draft-irtf-cfrg-ristretto255. sr25519 signs over
ristretto-compressed points; a ristretto element is an Edwards point, and
only the coding and the equality differ. The port's sr25519 keys sign and
verify with it, and the tests use it as the oracle of the batched decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tmtpu_torch.crypto.ed25519_ref import (
    BASE, D, IDENTITY, P, SQRT_M1, Point, point_add, point_neg, scalar_mult,
)

# 1/sqrt(a - d) with a = -1 (the Edwards form of curve25519)
_A_MINUS_D = (-1 - D) % P


def _is_negative(x: int) -> bool:
    return bool(x & 1)


def _abs(x: int) -> int:
    return P - x if _is_negative(x) else x


def _sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """(was_square, sqrt(u/v)): ristretto's SQRT_RATIO_M1."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u % P
    flipped = check == (-u) % P
    flipped_i = check == ((-u) % P) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return correct or flipped, _abs(r)


_, INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, _A_MINUS_D)

BASEPOINT: Point = BASE  # the Edwards basepoint is ristretto's too


def decode(s: bytes) -> Optional[Point]:
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    if val >= P or _is_negative(val):
        return None
    ss = val * val % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    ok, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * val % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not ok or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(p: Point) -> bytes:
    X, Y, Z, T = p
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T % P
    ix0 = X * SQRT_M1 % P
    iy0 = Y * SQRT_M1 % P
    enchanted = den1 * INVSQRT_A_MINUS_D % P
    if _is_negative(T * z_inv % P):
        x, y, den_inv = iy0, ix0, enchanted
    else:
        x, y, den_inv = X, Y, den2
    if _is_negative(x * z_inv % P):
        y = (-y) % P
    s = _abs(den_inv * ((Z - y) % P) % P)
    return s.to_bytes(32, "little")


def equals(p: Point, q: Point) -> bool:
    """Coset equality: x1 y2 == y1 x2 or x1 x2 == y1 y2 (the Z factors
    cancel, so projective coordinates compare directly)."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    return (X1 * Y2 - Y1 * X2) % P == 0 or (X1 * X2 - Y1 * Y2) % P == 0


__all__ = ["BASEPOINT", "IDENTITY", "Point", "decode", "encode", "equals",
           "point_add", "point_neg", "scalar_mult"]
