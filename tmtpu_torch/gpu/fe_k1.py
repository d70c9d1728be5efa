"""GF(2^256 - 2^32 - 977), secp256k1's base field, in plain PyTorch: op for
op with tmtpu/tpu/fe_k1.py.

This is the plain version the secp256k1 CUDA kernel is held against (and
the path a CPU tensor takes). Same representation as the reference, so
every routine can be compared with its JAX counterpart limb for limb:

- a field element is 20 limbs in radix 2^13, dtype int32, limbs first:
  shape ``[20, B]``;
- 2^260 = 2^36 + 15632 (mod p): a carry c out of limb 19 folds back as
  ``limb0 += 7440 c; limb1 += c; limb2 += 1024 c``, so the "loose" bounds
  routines keep are non-uniform: limb 0 in [0, 15700], limbs 1..19 in
  [0, 9300]; schoolbook coefficients stay below
  2 * 15700 * 9300 + 18 * 9300^2 < 2^31 (the bounds are derived in the
  reference's docstrings, routine by routine);
- 2^520 = 256 + 29829 * 2^13 + 3908 * 2^39 + 128 * 2^65 folds the
  product's carry-out, 2^256 = 2^32 + 977 serves ``freeze``.

Every tensor stays int32. Right shifts of int32 tensors are arithmetic in
torch, as in jnp, which the carry passes and borrow chains rely on. Where
the reference writes ``at_add(x, pos, v)``, this module adds in place into
a tensor that the same routine has just created, never into a caller's.
"""

from __future__ import annotations

import numpy as np
import torch

RADIX = 13
NLIMBS = 20
MASK = (1 << RADIX) - 1

P_INT = 2**256 - 2**32 - 977

# 2^260 mod p = F2 * 2^26 + F1 * 2^13 + F0
F0, F1, F2 = 7440, 1, 1024
# 2^520 mod p at limb positions 0, 1, 3, 5
G0, G1, G3, G5 = 256, 29829, 3908, 128

LOOSE0 = 15700  # resting bound of limb 0
LOOSEK = 9300   # resting bound of limbs 1..19


def limbs_of_int(v: int) -> np.ndarray:
    """Canonical little-endian radix-2^13 limbs of ``v`` (host helper)."""
    out = np.zeros(NLIMBS, dtype=np.int32)
    for i in range(NLIMBS):
        out[i] = v & MASK
        v >>= RADIX
    if v:
        raise ValueError("value does not fit in 260 bits")
    return out


def int_of_limbs(a) -> int:
    """Integer value of one limb vector (any bounds)."""
    a = np.asarray(a)
    return sum(int(a[i]) << (RADIX * i) for i in range(a.shape[0]))


P_LIMBS = limbs_of_int(P_INT)


def _ksub() -> np.ndarray:
    """64p as 20 limbs, each at least 100 above the loose bound of its
    position (so limbwise ``ksub - b`` is non-negative for any loose b),
    built by borrowing 2^13 units downward from the top; every limb stays
    under 41000."""
    m = np.zeros(NLIMBS + 1, dtype=np.int64)
    v = 64 * P_INT
    for i in range(NLIMBS + 1):
        m[i] = v & MASK
        v >>= RADIX
    k = m[:NLIMBS].copy()
    k[NLIMBS - 1] += m[NLIMBS] << RADIX
    need = np.full(NLIMBS, LOOSEK + 100, dtype=np.int64)
    need[0] = LOOSE0 + 100
    for i in range(NLIMBS - 2, -1, -1):
        while k[i] < need[i]:
            k[i] += 1 << RADIX
            k[i + 1] -= 1
    return k.astype(np.int32)


KSUB = _ksub()


def const_col(np_vec, like: torch.Tensor) -> torch.Tensor:
    """A host limb constant as a [20, 1] int32 column on ``like``'s device."""
    return torch.as_tensor(np_vec, dtype=torch.int32, device=like.device)[:, None]


def _carry_pass(x: torch.Tensor, fold: bool) -> torch.Tensor:
    """One vectorized carry pass. With ``fold`` the carry out of the top
    limb wraps through 2^260 = 2^36 + 15632; without, the top limb keeps
    it."""
    c = x >> RADIX
    x = x - c * (1 << RADIX)  # fresh tensor: the adds below are in place
    x[1:] += c[:-1]
    top = c[-1:]
    if fold:
        x[0:1] += F0 * top
        x[1:2] += F1 * top
        x[2:3] += F2 * top
    else:
        x[-1:] += top * (1 << RADIX)
    return x


def carry(x: torch.Tensor, passes: int, fold: bool = True) -> torch.Tensor:
    for _ in range(passes):
        x = _carry_pass(x, fold)
    return x


def add(a, b):
    """a + b; loose in, two passes, loose out."""
    return carry(a + b, 2)


def sub(a, b):
    """a - b + 64p (limbwise non-negative); two passes, loose out."""
    return carry(a + const_col(KSUB, a) - b, 2)


def neg(a):
    return sub(torch.zeros_like(a), a)


def _fold_product(c: torch.Tensor) -> torch.Tensor:
    """[40, B] schoolbook coefficients -> [20, B] loose limbs, with the
    analytic fold of positions 20..41 of tmtpu/tpu/fe_k1.py::_fold_product
    (where each step's bound is derived)."""
    z = torch.zeros((2,) + tuple(c.shape[1:]), dtype=torch.int32, device=c.device)
    c = carry(torch.cat([c, z], dim=0), 2, fold=False)  # [42, B]
    lo40 = c[40:41] & MASK
    hi40 = c[40:41] >> RADIX
    low = c[:NLIMBS].clone()
    h = c[NLIMBS:]
    # positions 20..37 (j = 0..17): j += 7440c, j+1 += c, j+2 += 1024c
    low[0:18] += F0 * h[0:18]
    low[1:19] += F1 * h[0:18]
    low[2:20] += F2 * h[0:18]
    # position 38: its 1024c spill at 20 refolds to positions 1 and 3
    c38 = h[18:19]
    low[18:19] += F0 * c38
    low[19:20] += F1 * c38
    low[1:2] += 1954 * c38
    low[3:4] += 128 * c38
    # position 39: 7440c at 19, its +c spill at 20, its 1024c spill at 21
    c39 = h[19:20]
    low[19:20] += F0 * c39
    low[0:1] += F0 * c39
    low[1:2] += F1 * c39
    low[2:3] += F2 * c39
    low[2:3] += 1954 * c39
    low[4:5] += 128 * c39
    # position 40 = 2^520 (low part)
    low[0:1] += G0 * lo40
    low[1:2] += G1 * lo40
    low[3:4] += G3 * lo40
    low[5:6] += G5 * lo40
    # position 41 = 2^533 (high part of c[40] plus c[41])
    c41 = hi40 + h[21:22]
    low[1:2] += G0 * c41
    low[2:3] += G1 * c41
    low[4:5] += G3 * c41
    low[6:7] += G5 * c41
    return carry(low, 4)


def mul(a, b):
    """Schoolbook product + reduction; loose in, loose out."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((NLIMBS,) + tuple(shape))
    b = b.expand((NLIMBS,) + tuple(shape))
    c = torch.zeros((2 * NLIMBS,) + tuple(shape), dtype=torch.int32,
                    device=a.device)
    for i in range(NLIMBS):
        c[i : i + NLIMBS] += a[i : i + 1] * b
    return _fold_product(c)


def sq(a):
    """Square by symmetry: c_k = sum_{i<j, i+j=k} 2 a_i a_j + a_{k/2}^2."""
    a2 = a + a
    c = torch.zeros((2 * NLIMBS,) + tuple(a.shape[1:]), dtype=torch.int32,
                    device=a.device)
    for i in range(NLIMBS):
        c[2 * i : 2 * i + 1] += a[i : i + 1] * a[i : i + 1]
        if i + 1 < NLIMBS:
            c[2 * i + 1 : i + NLIMBS] += a2[i : i + 1] * a[i + 1 :]
    return _fold_product(c)


def mul_small(a, k: int):
    """a * k for a small constant 0 < k < 64 (3 and b3 = 21 in the complete
    formulas); three folding passes restore the loose bounds."""
    if not 0 < k < 64:
        raise ValueError(f"mul_small takes 0 < k < 64, got {k}")
    return carry(a * k, 3)


def freeze(x):
    """Canonical form: value in [0, p), limbs in [0, 2^13). Bits >= 256 sit
    in limb 19 from bit 9 up: q = x19 >> 9 folds back as 977 q at limb 0 and
    64 q at limb 2 (2^32 = 64 * 2^26); then an exact sequential carry and
    one conditional subtraction of p."""
    x = carry(x, 3)
    top = 256 - RADIX * (NLIMBS - 1)
    for _ in range(2):
        q = x[NLIMBS - 1 :] >> top
        x = x.clone()
        x[NLIMBS - 1 :] -= q * (1 << top)
        x[0:1] += 977 * q
        x[2:3] += 64 * q
        x = carry(x, 2)
    x = x.clone()
    for i in range(NLIMBS - 1):
        c = x[i : i + 1] >> RADIX
        x[i : i + 1] -= c * (1 << RADIX)
        x[i + 1 : i + 2] += c
    t = x - const_col(P_LIMBS, x)
    for i in range(NLIMBS - 1):
        c = t[i : i + 1] >> RADIX
        t[i : i + 1] -= c * (1 << RADIX)
        t[i + 1 : i + 2] += c
    return torch.where(t[NLIMBS - 1 :] < 0, x, t)


def sqn(a, n: int):
    """a^(2^n): n repeated squarings."""
    for _ in range(n):
        a = sq(a)
    return a


def sqrt_candidate(a):
    """a^((p+1)/4): since p = 3 (mod 4) a square root of a whenever one
    exists (callers check the square). The libsecp256k1 addition chain,
    253 squarings and 13 multiplies."""
    x2 = mul(sqn(a, 1), a)
    x3 = mul(sqn(x2, 1), a)
    x6 = mul(sqn(x3, 3), x3)
    x9 = mul(sqn(x6, 3), x3)
    x11 = mul(sqn(x9, 2), x2)
    x22 = mul(sqn(x11, 11), x11)
    x44 = mul(sqn(x22, 22), x22)
    x88 = mul(sqn(x44, 44), x44)
    x176 = mul(sqn(x88, 88), x88)
    x220 = mul(sqn(x176, 44), x44)
    x223 = mul(sqn(x220, 3), x3)
    t1 = mul(sqn(x223, 23), x22)
    t1 = mul(sqn(t1, 6), x2)
    return sqn(t1, 2)


def pack_bytes_device(b: torch.Tensor) -> torch.Tensor:
    """[32, B] big-endian byte strings (SEC 1 order) -> [20, B] int32
    limbs: reverse to little-endian, then pack LSB-first."""
    b = b.flip(0).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    bits = (b[:, None, :] >> shifts[None, :, None]) & 1
    bits = bits.reshape((256,) + tuple(b.shape[1:]))
    pad = torch.zeros((NLIMBS * RADIX - 256,) + tuple(b.shape[1:]),
                      dtype=torch.int32, device=b.device)
    bits = torch.cat([bits, pad], dim=0)  # [260, B]
    w = 1 << torch.arange(RADIX, dtype=torch.int32, device=b.device)
    limbs = bits.reshape((NLIMBS, RADIX) + tuple(b.shape[1:]))
    return (limbs * w[None, :, None]).sum(dim=1, dtype=torch.int32)
