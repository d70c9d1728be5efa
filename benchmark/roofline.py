"""The least time an H100 needs for the ed25519 lanes it verified.

The count is the algorithm's and not the kernel's, so it holds whatever
implements the verify: the reference's 64-window 4-bit Straus ladder in
ref10's formulas, as field multiplies (M) and squarings (S). Decompressing
A takes pow22523 (11M + 251S) and 8M + 4S around it; the table of d*(-A),
d = 1..15, seven doublings to cached form (5M + 4S each), seven cached
additions (9M each) and 1M; each of the 63 windows after the first
doubles four times (three to P2 at 3M + 4S, one to P3 at 4M + 4S); each
non-zero 4-bit digit of h adds a cached point (8M), each non-zero digit of
s a niels point (6M); the inversion of Z takes 11M + 254S and x, y 2M. A
product of ten radix-2^25.5 limbs needs 100 32x32->64 multiplies, a
squaring 55: per lane 950M + 1,545S plus the digits' additions.

Peaks of one H100 SXM (CUDA C++ Programming Guide, compute capability 9.0,
arithmetic instruction throughput: 64 32-bit integer multiply-adds a clock
an SM; 132 SMs at 1.98 GHz; HBM3 at 3.35 TB/s). One 32x32->64 product
(IMAD.WIDE) counts as one such instruction. If it issues at 32 a clock,
every bound doubles: a share from this peak reads low, never high.
"""

from __future__ import annotations

import hashlib

import numpy as np

INT_MULS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
FIXED_M, FIXED_S = 19 + 99 + 63 * 13 + 13, 255 + 28 + 63 * 16 + 254
ADD_H_M, ADD_S_M = 8, 6
PRODUCTS_PER_M, PRODUCTS_PER_S = 100, 55
# a lane's plane in (A, R, s, h: 32 bytes each) and its power (8)
LANE_BYTES = 4 * 32 + 8
L = 2 ** 252 + 27742317777372353535851937790883648493


def nonzero_digits(rows: np.ndarray) -> np.ndarray:
    """Non-zero 4-bit digits of each row of little-endian scalar bytes."""
    return ((rows & 0x0F) != 0).sum(axis=1) + ((rows >> 4) != 0).sum(axis=1)


def challenge_bytes(pk: bytes, msg: bytes, sig: bytes) -> bytes:
    h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
    return h.to_bytes(32, "little")


def lane_products(lanes) -> np.ndarray:
    """32x32->64 products each (pk, msg, sig) lane needs."""
    s = np.frombuffer(b"".join(sig[32:64] for _, _, sig in lanes), dtype=np.uint8)
    h = np.frombuffer(b"".join(challenge_bytes(pk, m, sig) for pk, m, sig in lanes),
                      dtype=np.uint8)
    m = (FIXED_M + ADD_S_M * nonzero_digits(s.reshape(-1, 32))
         + ADD_H_M * nonzero_digits(h.reshape(-1, 32)))
    return m.astype(np.int64) * PRODUCTS_PER_M + FIXED_S * PRODUCTS_PER_S


def bound_s(products: int, lanes: int) -> float:
    """Seconds one dispatch needs at the peaks: the larger of its products
    over the multiply rate and its bytes over HBM's."""
    return max(products / INT_MULS_PER_S, lanes * LANE_BYTES / HBM_BYTES_PER_S)
