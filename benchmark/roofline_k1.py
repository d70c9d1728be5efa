"""The least time an H100 needs for the secp256k1 lanes it verified.

The count is the algorithm's and not the kernel's, so it holds whatever
implements the verify: the reference's 64-window 4-bit Straus/Shamir
ladder R = [u1]G + [u2]Q with the complete Renes-Costello-Batina formulas
(a = 0), as field multiplies (M) and squarings (S). Each of the 63 windows
after the first doubles four times (algorithm 9: 6M + 2S), each non-zero
4-bit digit of u1 = e s^-1 or u2 = r s^-1 mod n adds a point (algorithm
7: 12M), the table of d*Q, d = 2..15, takes 14 additions (12M each),
decompressing Q takes the (p+1)/4 power (13M + 253S), x^3 (1M + 1S) and
the check of y^2 (1S), and the final compare 2M: per lane 1,696M + 759S
plus 12M a non-zero digit. A 256-bit operand is eight 32-bit words, so a
multiply needs at least 64 32x32->64 products and a squaring 36.

A lane the host refuses before the card (a wrong length or prefix, x >= p,
r or s outside [1, n - 1], s > n/2) is sent with u1 = u2 = 1, and is
counted so. Peaks as in ``roofline.py``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from benchmark import roofline

P = 2 ** 256 - 2 ** 32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
FIXED_M, FIXED_S = 63 * 4 * 6 + 14 * 12 + 14 + 2, 63 * 4 * 2 + 255
ADD_M = 12
PRODUCTS_PER_M, PRODUCTS_PER_S = 64, 36
# a lane's plane in (pkx, u1, u2, r, r + n: 32 bytes each; the parity and
# seven zero rows) and its verdict out (4)
LANE_BYTES = 168 + 4
# the fixed-base table, (X, Y, Z) of d*G for d = 0..15 in eight words each
TABLE_BYTES = 16 * 3 * 8 * 4
_DUMMY = (1, 1)


def scalars(pk: bytes, msg: bytes, sig: bytes):
    """(u1, u2) of a lane as the host sends them to the card."""
    if len(pk) != 33 or len(sig) != 64 or pk[0] not in (2, 3):
        return _DUMMY
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    if int.from_bytes(pk[1:], "big") >= P or not 0 < r < N or not 0 < s <= N // 2:
        return _DUMMY
    w = pow(s, -1, N)
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    return e * w % N, r * w % N


def lane_products(lanes) -> np.ndarray:
    """32x32->64 products each (pk, msg, sig) lane needs."""
    rows = b"".join(u1.to_bytes(32, "big") + u2.to_bytes(32, "big")
                    for u1, u2 in (scalars(pk, m, sig) for pk, m, sig in lanes))
    digits = roofline.nonzero_digits(np.frombuffer(rows, dtype=np.uint8).reshape(-1, 64))
    m = FIXED_M + ADD_M * digits.astype(np.int64)
    return m * PRODUCTS_PER_M + FIXED_S * PRODUCTS_PER_S


def bound_s(products: int, lanes: int) -> float:
    """Seconds one launch needs at the peaks: the larger of its products
    over the multiply rate and its bytes over HBM's."""
    return max(products / roofline.INT_MULS_PER_S,
               (lanes * LANE_BYTES + TABLE_BYTES) / roofline.HBM_BYTES_PER_S)
