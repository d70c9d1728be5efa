"""Batched secp256k1 ECDSA verification: host prep, the plain PyTorch device
graph and ``batch_verify_k1``. The twin of tmtpu/tpu/k1_verify.py.

Per-lane semantics are the reference's low-S verify
(crypto/secp256k1/secp256k1.go:195-197; oracle
``secp256k1.PubKeySecp256k1.verify_signature``) over SHA-256(msg).

Split of labour:
- host: lengths, the SEC 1 prefix (2 or 3) and x < p, r and s in
  [1, n - 1] with s <= n/2, SHA-256, and the scalars u1 = h/s and
  u2 = r/s mod n (in C, ``native.prep_k1``, one Montgomery batch inversion
  a thread; Python integers in the plain version), packed into one
  ``[168, B]`` uint8 plane: pkx | u1 | u2 | r | rpn as big-endian 32-byte
  rows, the prefix's parity in row 160 and seven zero rows;
- device: SEC 1 decompression (one (p+1)/4 power), the 64-window
  Straus/Shamir ladder R = [u1]G + [u2]Q with the complete
  Renes-Costello-Batina formulas (algorithm 7 to add, 9 to double, a = 0,
  b3 = 21), and the projective check that R is finite and
  X = r Z or X = (r + n) Z, in the CUDA kernel (``k1_kernel.py``) or, for a
  CPU tensor, in ``verify_core_compact`` below.

Table lookups index with integer gathers (the reference's one-hot float32
matmuls are a TPU matrix-unit workaround, and a float product on the card
could run in TF32); its ``lax.scan`` and ``fori_loop`` are Python loops.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from tmtpu_torch import device as device_mod
from tmtpu_torch import native
from tmtpu_torch.crypto import secp256k1_ref as k1ref
from tmtpu_torch.gpu import fe_k1 as fe
from tmtpu_torch.gpu import spans
from tmtpu_torch.libs import metrics, trace
from tmtpu_torch.gpu.verify import lt_le

P = fe.P_INT
N = k1ref.N
B3 = 21  # 3 b for y^2 = x^3 + 7

WINDOW = 4
NDIGITS = 64

SEVEN_LIMBS = fe.limbs_of_int(7)


# ---------------------------------------------------------------------------
# Complete projective point ops (RCB16, a = 0). A point is (X, Y, Z), each a
# [20, B] int32 limb tensor; the identity is (0, 1, 0).


def identity(batch: int, device) -> tuple:
    z = torch.zeros((fe.NLIMBS, batch), dtype=torch.int32, device=device)
    one = z.clone()
    one[0] = 1
    return (z, one, z)


def add(p, q):
    """Complete addition (RCB16 algorithm 7), valid for every pair of
    inputs: 12 multiplies and 3 small-constant multiplies."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0 = fe.mul(X1, X2)
    t1 = fe.mul(Y1, Y2)
    t2 = fe.mul(Z1, Z2)
    t3 = fe.sub(fe.mul(fe.add(X1, Y1), fe.add(X2, Y2)), fe.add(t0, t1))
    t4 = fe.sub(fe.mul(fe.add(Y1, Z1), fe.add(Y2, Z2)), fe.add(t1, t2))
    y3 = fe.sub(fe.mul(fe.add(X1, Z1), fe.add(X2, Z2)), fe.add(t0, t2))
    t0 = fe.mul_small(t0, 3)
    t2 = fe.mul_small(t2, B3)
    z3 = fe.add(t1, t2)
    t1 = fe.sub(t1, t2)
    y3 = fe.mul_small(y3, B3)
    x3 = fe.sub(fe.mul(t3, t1), fe.mul(t4, y3))
    y3 = fe.add(fe.mul(y3, t0), fe.mul(t1, z3))
    z3 = fe.add(fe.mul(z3, t4), fe.mul(t0, t3))
    return (x3, y3, z3)


def double(p):
    """Complete doubling (RCB16 algorithm 9): 6 multiplies, 2 squarings and
    one small-constant multiply; the identity doubles to itself."""
    X, Y, Z = p
    t0 = fe.sq(Y)
    z3 = fe.add(t0, t0)
    z3 = fe.add(z3, z3)
    z3 = fe.add(z3, z3)  # 8 Y^2
    t1 = fe.mul(Y, Z)
    t2 = fe.mul_small(fe.sq(Z), B3)  # b3 Z^2
    x3 = fe.mul(t2, z3)
    y3 = fe.add(t0, t2)
    z3 = fe.mul(t1, z3)
    t1 = fe.add(t2, t2)
    t2 = fe.add(t1, t2)
    t0 = fe.sub(t0, t2)
    y3 = fe.add(x3, fe.mul(t0, y3))
    t1 = fe.mul(X, Y)
    x3 = fe.mul(t0, t1)
    x3 = fe.add(x3, x3)
    return (x3, y3, z3)


def negate(p):
    X, Y, Z = p
    return (X, fe.neg(Y), Z)


# ---------------------------------------------------------------------------
# Window tables and the ladder.


def fixed_base_affine() -> list:
    """Affine (x, y) of d*G for d = 1..15, from the port's oracle."""
    return [k1ref.scalar_mult(d) for d in range(1, 1 << WINDOW)]


def fixed_base_table() -> np.ndarray:
    """[16, 3, 20] int32: projective (X, Y, Z) of d*G for d in 0..15 (the
    identity (0, 1, 0) at d = 0, Z = 1 otherwise)."""
    rows = [np.stack([fe.limbs_of_int(0), fe.limbs_of_int(1), fe.limbs_of_int(0)])]
    for x, y in fixed_base_affine():
        rows.append(np.stack([fe.limbs_of_int(x), fe.limbs_of_int(y),
                              fe.limbs_of_int(1)]))
    return np.stack(rows)


def lookup_const(table, digits):
    """table [16, 3, 20] int32, digits [B] -> point tuple of [20, B]."""
    sel = table[digits.long()].permute(1, 2, 0)  # [3, 20, B]
    return (sel[0], sel[1], sel[2])


def build_lane_table(q):
    """Per-lane window table [16, 3, 20, B]: d*Q for d in 0..15, by 14
    complete additions."""
    entries = [torch.stack(identity(q[0].shape[1], q[0].device)), torch.stack(q)]
    acc = q
    for _ in range((1 << WINDOW) - 2):
        acc = add(acc, q)
        entries.append(torch.stack(acc))
    return torch.stack(entries)


def lookup_lane(table, digits):
    """table [16, 3, 20, B], digits [B] -> point tuple of [20, B]."""
    idx = digits.long()[None, None, None, :].expand((1,) + tuple(table.shape[1:]))
    sel = torch.gather(table, 0, idx)[0]
    return (sel[0], sel[1], sel[2])


def shamir_double_scalar(u1_digits, u2_digits, q_point, base_table):
    """[u1]G + [u2]Q per lane, MSB-first 4-bit windows, the doublings shared
    by both scalars. u1_digits, u2_digits: [64, B] int32 in [0, 16);
    base_table: [16, 3, 20] int32."""
    lane_table = build_lane_table(q_point)
    p = identity(q_point[0].shape[1], q_point[0].device)
    for w in range(NDIGITS):
        for _ in range(WINDOW):
            p = double(p)
        p = add(p, lookup_const(base_table, u1_digits[w]))
        p = add(p, lookup_lane(lane_table, u2_digits[w]))
    return p


# ---------------------------------------------------------------------------
# Decompression and the verify graph.


def decompress(x, parity):
    """SEC 1 decompression: x [20, B] limbs (host guarantees < p), parity
    [B] in {0, 1}. Returns ((x, y, 1), valid): y = sqrt(x^3 + 7) with the
    requested parity; invalid where x^3 + 7 is not a square."""
    y2 = fe.add(fe.mul(fe.sq(x), x), fe.const_col(SEVEN_LIMBS, x))
    y = fe.sqrt_candidate(y2)
    yf = fe.freeze(y)
    valid = torch.all(fe.freeze(fe.sq(y)) == fe.freeze(y2), dim=0)
    flip = (yf[0] & 1) != parity
    y = torch.where(flip[None], fe.neg(yf), yf)
    one = torch.zeros_like(x)
    one[0] = 1
    return (x, y, one), valid


def digits_msb_device_be(s_bytes):
    """[32, B] big-endian scalar bytes -> [64, B] int32 4-bit windows, most
    significant first."""
    s = s_bytes.to(torch.int32)
    return torch.stack([s >> 4, s & 0x0F], dim=1).reshape((64,) + tuple(s.shape[1:]))


def verify_core_compact(pkx_b, parity, u1_b, u2_b, r_b, rpn_b, base_table):
    """The plain version of the CUDA kernel: raw [32, B] uint8 big-endian
    columns (pkx, u1, u2, r, rpn) and parity [B] int32 in, bool [B] out:
    the key decodes and R = [u1]G + [u2]Q is finite with X = r Z or
    X = rpn Z (rpn = r + n when that is below p, else r again)."""
    q_pt, q_ok = decompress(fe.pack_bytes_device(pkx_b), parity)
    X, _, Z = shamir_double_scalar(digits_msb_device_be(u1_b),
                                   digits_msb_device_be(u2_b), q_pt, base_table)
    finite = ~torch.all(fe.freeze(Z) == 0, dim=0)
    xf = fe.freeze(X)
    m1 = torch.all(xf == fe.freeze(fe.mul(fe.pack_bytes_device(r_b), Z)), dim=0)
    m2 = torch.all(xf == fe.freeze(fe.mul(fe.pack_bytes_device(rpn_b), Z)), dim=0)
    return q_ok & finite & (m1 | m2)


# ---------------------------------------------------------------------------
# Host-side preparation.

_P_BE = np.frombuffer(int.to_bytes(P, 32, "big"), dtype=np.uint8)
_N_BE = np.frombuffer(int.to_bytes(N, 32, "big"), dtype=np.uint8)
_HALF_N1_BE = np.frombuffer(int.to_bytes(N // 2 + 1, 32, "big"), dtype=np.uint8)
_ZERO33 = bytes(33)
_ZERO64 = bytes(64)
_DUMMY_SCALAR = int.to_bytes(1, 32, "big")

PACKED_ROWS = 168
PARITY_ROW = 160


def _lt_be(arr: np.ndarray, bound_be: np.ndarray) -> np.ndarray:
    """``arr < bound`` over big-endian [B, 32] byte rows."""
    return lt_le(arr[:, ::-1], bound_be[::-1].copy())


def _inverses_mod_n(vals: list) -> list:
    """Montgomery batch inversion: prefix products, one pow(-1), and a
    backward sweep give every inverse mod n for the price of one."""
    prefix = []
    acc = 1
    for v in vals:
        prefix.append(acc)
        acc = acc * v % N
    inv = pow(acc, -1, N) if vals else 1
    out = [0] * len(vals)
    for j in range(len(vals) - 1, -1, -1):
        out[j] = inv * prefix[j] % N
        inv = inv * vals[j] % N
    return out


def prepare_k1_batch_packed(pks, msgs, sigs):
    """Host prep: returns (numpy [168, B] uint8 plane, host_ok bool [B]).

    Lanes with wrong lengths, a prefix other than 2 or 3, x >= p, r or s
    outside [1, n - 1] or s > n/2 get well-formed dummy bytes (x = 0,
    u1 = u2 = r = rpn = 1) and host_ok False. All of it, the lengths
    included, is the port's C library (``native.prep_k1``), which reads
    the columns (``crypto/lanes.py``, or lists of bytes) where they lie; a
    lane of the wrong length goes in as zero bytes, which its prefix check
    refuses."""
    return native.prep_k1(pks, msgs, sigs)


def prepare_k1_batch_packed_plain(pks, msgs, sigs):
    """The plain version of ``prepare_k1_batch_packed``: the same bytes,
    from Python integers and ``hashlib`` on one core. The tests and the
    card's smoke run compare the two; nothing on the main path calls it."""
    B = len(sigs)
    pks_b = [bytes(p) for p in pks]
    sigs_b = [bytes(s) for s in sigs]
    len_ok = np.fromiter(
        (len(pks_b[i]) == 33 and len(sigs_b[i]) == 64 for i in range(B)),
        dtype=bool, count=B)
    if not len_ok.all():
        pks_b = [p if ok else _ZERO33 for p, ok in zip(pks_b, len_ok)]
        sigs_b = [s if ok else _ZERO64 for s, ok in zip(sigs_b, len_ok)]
    sig_arr = np.frombuffer(b"".join(sigs_b), dtype=np.uint8).reshape(B, 64)
    pk_arr = np.frombuffer(b"".join(pks_b), dtype=np.uint8).reshape(B, 33)
    r_arr = sig_arr[:, :32].copy()
    s_arr = sig_arr[:, 32:]
    prefix = pk_arr[:, 0]
    pkx = pk_arr[:, 1:].copy()
    host_ok = (
        len_ok
        & ((prefix == 2) | (prefix == 3))
        & _lt_be(pkx, _P_BE)
        & r_arr.any(axis=1) & _lt_be(r_arr, _N_BE)
        & s_arr.any(axis=1) & _lt_be(s_arr, _HALF_N1_BE))  # s <= n/2 (low-S)
    ok_idx = np.flatnonzero(host_ok).tolist()
    w_of = dict(zip(ok_idx, _inverses_mod_n(
        [int.from_bytes(s_arr[i], "big") for i in ok_idx])))
    u1_list, u2_list, rpn_list = [], [], []
    for i in range(B):
        if not host_ok[i]:
            u1_list.append(_DUMMY_SCALAR)
            u2_list.append(_DUMMY_SCALAR)
            rpn_list.append(_DUMMY_SCALAR)
            continue
        r = int.from_bytes(r_arr[i], "big")
        h = int.from_bytes(hashlib.sha256(bytes(msgs[i])).digest(), "big")
        w = w_of[i]
        u1_list.append((h * w % N).to_bytes(32, "big"))
        u2_list.append((r * w % N).to_bytes(32, "big"))
        rpn = r + N
        rpn_list.append((rpn if rpn < P else r).to_bytes(32, "big"))
    if not host_ok.all():
        bad = ~host_ok
        pkx[bad] = 0
        r_arr[bad] = np.frombuffer(_DUMMY_SCALAR, dtype=np.uint8)
    u1_arr, u2_arr, rpn_arr = (
        np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(B, 32)
        for rows in (u1_list, u2_list, rpn_list))
    packed = np.zeros((PACKED_ROWS, B), dtype=np.uint8)
    for k, rows in enumerate((pkx, u1_arr, u2_arr, r_arr, rpn_arr)):
        packed[32 * k : 32 * (k + 1)] = rows.T
    packed[PARITY_ROW] = pk_arr[:, 0] & 1
    return packed, host_ok


def split_packed_k1(packed):
    """[168, B] plane -> ((pkx, u1, u2, r, rpn) [32, B] views, parity [B]
    int32)."""
    planes = tuple(packed[32 * i : 32 * (i + 1)] for i in range(5))
    return planes, packed[PARITY_ROW].to(torch.int32)


_BASE_TABLES: dict = {}


def base_table(device) -> torch.Tensor:
    """[16, 3, 20] int32 fixed-base table on ``device`` (cached)."""
    dev = torch.device(device)
    if dev not in _BASE_TABLES:
        _BASE_TABLES[dev] = torch.as_tensor(fixed_base_table(), device=dev)
    return _BASE_TABLES[dev]


def plain_packed(packed):
    """The plain version of the secp256k1 kernel on a packed [168, B]
    plane, on the plane's device: bool [B]."""
    planes, parity = split_packed_k1(packed)
    return verify_core_compact(planes[0], parity, *planes[1:], base_table(packed.device))


def batch_verify_k1(pks, msgs, sigs, device=None) -> np.ndarray:
    """secp256k1 batch verification: bool [B] per-signature validity, equal
    to the serial ``PubKeySecp256k1.verify_signature`` per lane, on
    ``device`` (None: the CUDA card)."""
    from tmtpu_torch.gpu import k1_kernel

    dev = device_mod.resolve(device)
    B = len(sigs)
    if B == 0:
        return np.zeros(0, dtype=bool)
    impl = metrics.impl_label(dev)
    t0 = time.perf_counter()
    with trace.span("secp256k1.prepare", lanes=B) as sp:
        packed, host_ok = prepare_k1_batch_packed(pks, msgs, sigs)
        sp.set(rejected=B - int(np.count_nonzero(host_ok)))
    # the reference's execute holds the copies too; here each has its own
    # span, as on the ed25519 path
    with trace.span("secp256k1.device_put", lanes=B):
        plane = torch.from_numpy(packed).to(dev)
    with trace.span("secp256k1.execute", impl=impl, lanes=B) as ex, spans.device_time(ex, dev):
        mask = k1_kernel.verify_packed(plane)
    with trace.span("secp256k1.readback", lanes=B):
        mask = mask.cpu().numpy()
    metrics.observe_crypto_batch("secp256k1", metrics.backend_label(dev), impl, B, 0,
                                 time.perf_counter() - t0)
    return mask & host_ok
