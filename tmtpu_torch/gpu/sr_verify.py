"""Batched sr25519 (schnorrkel) verification: host prep, the plain PyTorch
device graph and ``batch_verify_sr``. The twin of tmtpu/tpu/sr_verify.py.

Per-lane semantics are the serial oracle's
(``sr25519.PubKeySr25519.verify_signature``): the signature carries the
schnorrkel marker, s < L, A and R are canonical ristretto255 encodings, and
encode([s]B - [k]A) == R with k the merlin challenge. ristretto255 is a
quotient of edwards25519, so the field and curve code of the ed25519 path
(``fe``, ``curve``, the fixed-base table of B) serves unchanged; what is new
is the batched ristretto decode (SQRT_RATIO_M1) and the coset equality,
which over canonical encodings is equivalent to the byte compare, so the
device never re-encodes.

Split of labour:
- host: lengths, the marker bit (cleared from s), s < L, A and R below p
  and even, and the merlin transcript per lane that gives k (in C,
  ``native.sr_challenges``; the pure-Python ``merlin`` in the plain
  version), packed into one ``[128, B]`` uint8 plane (pk | r | s | k);
- device: both decodes, the ladder R' = [s]B + [k](-A) and the coset
  equality, in the CUDA kernel (``kernel.sr_verify_packed``) or, for a CPU
  tensor, in ``sr_verify_core_compact`` below.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tmtpu_torch import device as device_mod
from tmtpu_torch import native
from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.crypto.sr25519 import challenge_k
from tmtpu_torch.gpu import curve, fe, spans
from tmtpu_torch.libs import metrics, trace
from tmtpu_torch.gpu.verify import (base_table, digits_msb_device, host_lanes, lt_le,
                                    split_packed)

L = ref.L
P = ref.P

D_LIMBS = fe.limbs_of_int(ref.D)
SQRT_M1_LIMBS = fe.limbs_of_int(ref.SQRT_M1)
NEG_SQRT_M1_LIMBS = fe.limbs_of_int(P - ref.SQRT_M1)
ONE_LIMBS = fe.limbs_of_int(1)
NEG_ONE_LIMBS = fe.limbs_of_int(P - 1)


def _one_like(s):
    one = torch.zeros_like(s)
    one[0] = 1
    return one


def _eq_const(x_frozen, limbs):
    return torch.all(x_frozen == fe.const_col(limbs, x_frozen), dim=0)


def _abs_fe(x):
    """CT_ABS: negate iff the canonical form is odd (taken on the frozen
    value, as the reference does, so the limbs match it)."""
    xf = fe.freeze(x)
    return torch.where(((xf[0] & 1) == 1)[None], fe.neg(xf), xf)


def _invsqrt(w):
    """SQRT_RATIO_M1(1, w): (was_square [B], r [20, B]) with r = 1/sqrt(w)
    when w is a non-zero square."""
    w3 = fe.mul(fe.sq(w), w)
    w7 = fe.mul(fe.sq(w3), w)
    r = fe.mul(w3, fe.pow_p58(w7))
    check = fe.freeze(fe.mul(w, fe.sq(r)))
    correct = _eq_const(check, ONE_LIMBS)
    flipped = _eq_const(check, NEG_ONE_LIMBS)
    flipped_i = _eq_const(check, NEG_SQRT_M1_LIMBS)
    r = torch.where((flipped | flipped_i)[None],
                    fe.mul(r, fe.const_col(SQRT_M1_LIMBS, r)), r)
    return correct | flipped, _abs_fe(r)


def ristretto_decompress(s):
    """Batched ristretto255 DECODE: s [20, B] limbs (the host has rejected
    values >= p and odd values). Returns (extended point, valid [B]);
    invalid lanes hold a finite point that the complete formulas never
    fault on."""
    one = _one_like(s)
    ss = fe.sq(s)
    u1 = fe.sub(one, ss)
    u2 = fe.add(one, ss)
    u2_sqr = fe.sq(u2)
    # v = -(d u1^2) - u2^2
    v = fe.sub(fe.neg(fe.mul(fe.const_col(D_LIMBS, s), fe.sq(u1))), u2_sqr)
    ok, invsqrt = _invsqrt(fe.mul(v, u2_sqr))
    den_x = fe.mul(invsqrt, u2)
    den_y = fe.mul(fe.mul(invsqrt, den_x), v)
    x = _abs_fe(fe.mul(fe.add(s, s), den_x))
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    yf = fe.freeze(y)
    valid = ok & ((fe.freeze(t)[0] & 1) == 0) & ~torch.all(yf == 0, dim=0)
    return (x, y, one, t), valid


def ristretto_equal(p, q):
    """Coset equality X1 Y2 == Y1 X2 or X1 X2 == Y1 Y2: the Z factors scale
    both products alike, so the ladder's projective result compares
    directly with a decoded (Z = 1) point."""
    x1, y1 = p[0], p[1]
    x2, y2 = q[0], q[1]
    a = fe.freeze(fe.sub(fe.mul(x1, y2), fe.mul(y1, x2)))
    b = fe.freeze(fe.sub(fe.mul(x1, x2), fe.mul(y1, y2)))
    return torch.all(a == 0, dim=0) | torch.all(b == 0, dim=0)


def sr_verify_core_compact(pk_b, r_b, s_b, k_b, table):
    """The plain version of the CUDA kernel: raw [32, B] uint8 columns in
    (A and R encodings, s with the marker cleared and k, both
    little-endian and < L), bool [B] out. ``table`` is the [16, 3, 20]
    fixed-base niels table of B (``verify.base_table``)."""
    a_pt, a_ok = ristretto_decompress(fe.pack_bytes_device(pk_b))
    r_pt, r_ok = ristretto_decompress(fe.pack_bytes_device(r_b))
    r_prime = curve.shamir_double_scalar(
        digits_msb_device(s_b), digits_msb_device(k_b), curve.negate(a_pt), table)
    return a_ok & r_ok & ristretto_equal(r_prime, r_pt)


def plain_packed(packed):
    """The plain version of the sr25519 kernel on a packed [128, B] plane
    (pk | r | s | k), on the plane's device: bool [B]."""
    return sr_verify_core_compact(*split_packed(packed), base_table(packed.device))


# ---------------------------------------------------------------------------
# Host-side preparation.

_P_LE = np.frombuffer(int.to_bytes(P, 32, "little"), dtype=np.uint8)
_L_LE = np.frombuffer(int.to_bytes(L, 32, "little"), dtype=np.uint8)


def _sr_lanes(pks, sigs):
    """(pk_arr, r_arr, s_arr with the marker cleared, host_ok): lanes with
    wrong lengths, no schnorrkel marker, s >= L, or A or R not a canonical
    encoding (>= p or odd) get zero pk, r and s bytes and host_ok False."""
    len_ok, pk_arr, r_arr, s_arr = host_lanes(pks, sigs)
    pk_arr = pk_arr.copy()
    marker_ok = (s_arr[:, 31] & 0x80) != 0
    s_arr[:, 31] &= 0x7F
    host_ok = (
        len_ok & marker_ok & lt_le(s_arr, _L_LE)
        & lt_le(pk_arr, _P_LE) & ((pk_arr[:, 0] & 1) == 0)
        & lt_le(r_arr, _P_LE) & ((r_arr[:, 0] & 1) == 0))
    if not host_ok.all():
        bad = ~host_ok
        s_arr[bad] = 0
        pk_arr[bad] = 0
        r_arr[bad] = 0
    return pk_arr, r_arr, s_arr, host_ok


def _sr_pack(pk_arr, r_arr, s_arr, k_arr, host_ok):
    packed = np.empty((128, len(host_ok)), dtype=np.uint8)
    packed[0:32] = pk_arr.T
    packed[32:64] = r_arr.T
    packed[64:96] = s_arr.T
    packed[96:128] = k_arr.T
    return packed, host_ok


def prepare_sr_batch_packed(pks, msgs, sigs):
    """Host prep: returns (numpy [128, B] uint8 plane, host_ok bool [B]).

    Rejected lanes get zero pk, r and s bytes and host_ok False; their k is
    still the merlin challenge of those zero bytes. k comes from the port's
    C library (``native.sr_challenges``)."""
    pk_arr, r_arr, s_arr, host_ok = _sr_lanes(pks, sigs)
    return _sr_pack(pk_arr, r_arr, s_arr, native.sr_challenges(pk_arr, r_arr, msgs),
                    host_ok)


def prepare_sr_batch_packed_plain(pks, msgs, sigs):
    """The plain version of ``prepare_sr_batch_packed``: the same bytes,
    with k from the pure-Python ``merlin``. The tests and the card's smoke
    run compare the two; nothing on the main path calls it."""
    pk_arr, r_arr, s_arr, host_ok = _sr_lanes(pks, sigs)
    k_arr = np.frombuffer(
        b"".join(challenge_k(p.tobytes(), bytes(m), r.tobytes()).to_bytes(32, "little")
                 for p, m, r in zip(pk_arr, msgs, r_arr)),
        dtype=np.uint8).reshape(len(host_ok), 32)
    return _sr_pack(pk_arr, r_arr, s_arr, k_arr, host_ok)


def batch_verify_sr(pks, msgs, sigs, device=None) -> np.ndarray:
    """sr25519 batch verification: bool [B] per-signature validity, equal
    to the serial ``PubKeySr25519.verify_signature`` per lane, on
    ``device`` (None: the CUDA card)."""
    from tmtpu_torch.gpu import kernel

    dev = device_mod.resolve(device)
    B = len(sigs)
    if B == 0:
        return np.zeros(0, dtype=bool)
    impl = metrics.impl_label(dev)
    t0 = time.perf_counter()
    with trace.span("sr25519.prepare", lanes=B):
        packed, host_ok = prepare_sr_batch_packed(pks, msgs, sigs)
    # as in the reference, execute holds the copies as well as the kernel
    with trace.span("sr25519.execute", impl=impl, lanes=B) as ex:
        plane = torch.from_numpy(packed).to(dev)
        with spans.device_time(ex, dev):
            mask = kernel.sr_verify_packed(plane)
        mask = mask.cpu().numpy()
    metrics.observe_crypto_batch("sr25519", metrics.backend_label(dev), impl, B, 0,
                                 time.perf_counter() - t0)
    return mask & host_ok
