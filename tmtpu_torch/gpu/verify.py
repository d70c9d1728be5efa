"""Batched ed25519 verification: host prep, the plain PyTorch device graph
and ``batch_verify``. The twin of tmtpu/tpu/verify.py.

Per-lane semantics are the cofactorless Go-stdlib verify (reference
crypto/ed25519/ed25519.go:148-155; oracle ``ed25519_ref.verify``):

    decode A; reject s >= L; h = SHA-512(R || A || msg) mod L;
    R' = [s]B + [h](-A); byte-compare encode(R') with the signature's R.

Split of labour:
- host: length checks, ``s < L``, canonical ``A.y``, SHA-512 and the
  reduction mod L, written as one ``[128, B]`` uint8 plane (pk | r | s |
  h) so the host-to-device hop is a single copy: in C in one pass over the
  lane columns (``native.prep_ed25519``), in numpy and ``hashlib`` in the
  plain version;
- device: everything else, in the CUDA kernel (``kernel.py``) or, for a
  CPU tensor, in ``verify_core_compact`` below.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from tmtpu_torch import device as device_mod
from tmtpu_torch import native
from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.crypto import lanes
from tmtpu_torch.gpu import curve, fe, spans
from tmtpu_torch.libs import metrics, trace

L = ref.L
D_LIMBS = fe.limbs_of_int(ref.D)
SQRT_M1_LIMBS = fe.limbs_of_int(ref.SQRT_M1)


def _one_like(y: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(y)
    one[0] = 1
    return one


def decompress(y, sign):
    """Batched point decompression: y [20, B] limbs (host guarantees < p),
    sign [B] in {0, 1}. Returns (extended point, valid bool [B]); invalid
    lanes hold a garbage point that the complete formulas never fault on.
    Mirrors ed25519_ref._recover_x."""
    one = _one_like(y)
    y2 = fe.sq(y)
    u = fe.sub(y2, one)  # y^2 - 1
    v = fe.add(fe.mul(fe.const_col(D_LIMBS, y), y2), one)  # d y^2 + 1
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    vxx = fe.freeze(fe.mul(v, fe.sq(x)))
    u_f = fe.freeze(u)
    nu_f = fe.freeze(fe.neg(u))
    ok_direct = torch.all(vxx == u_f, dim=0)
    ok_twist = torch.all(vxx == nu_f, dim=0)
    x = torch.where(ok_twist[None], fe.mul(x, fe.const_col(SQRT_M1_LIMBS, x)), x)
    valid = ok_direct | ok_twist
    xf = fe.freeze(x)
    x_is_zero = torch.all(xf == 0, dim=0)
    # x == 0 with the sign bit set is not a valid encoding
    valid = valid & ~(x_is_zero & (sign == 1))
    x = torch.where(((xf[0] & 1) != sign)[None], fe.neg(x), x)
    return (x, y, _one_like(y), fe.mul(x, y)), valid


def verify_core(pk_y, pk_sign, r_y, r_sign, s_digits, h_digits, base_table):
    """All the curve arithmetic of a batch verify. pk_y, r_y: [20, B] limbs
    of the claimed y's; pk_sign, r_sign: [B]; s_digits, h_digits: [64, B]
    MSB-first windows; base_table: [16, 3, 20] int32. Returns bool [B]."""
    a_point, a_ok = decompress(pk_y, pk_sign)
    r_prime = curve.shamir_double_scalar(
        s_digits, h_digits, curve.negate(a_point), base_table)
    return a_ok & curve.compress_check(r_prime, r_y, r_sign)


def digits_msb_device(s_bytes):
    """[32, B] scalar bytes (LE) -> [64, B] int32 4-bit windows, most
    significant first."""
    s = s_bytes.to(torch.int32)
    lo = s & 0x0F
    hi = s >> 4
    inter = torch.stack([lo, hi], dim=1).reshape((64,) + tuple(s.shape[1:]))
    return inter.flip(0)


def _mask_sign(b):
    """Clear the sign bit (bit 255) of [32, B] encodings."""
    b = b.to(torch.int32)
    out = b.clone()
    out[31] = b[31] & 0x7F
    return out


def verify_core_compact(pk_b, r_b, s_b, h_b, base_table):
    """The plain version of the CUDA kernel: raw [32, B] uint8 columns in,
    bool [B] out. Host guarantees s < L and A.y canonical on lanes it
    keeps (host_ok covers the others)."""
    pk_sign = pk_b[31].to(torch.int32) >> 7
    r_sign = r_b[31].to(torch.int32) >> 7
    pk_y = fe.pack_bytes_device(_mask_sign(pk_b))
    r_y = fe.pack_bytes_device(_mask_sign(r_b))
    return verify_core(pk_y, pk_sign, r_y, r_sign,
                       digits_msb_device(s_b), digits_msb_device(h_b),
                       base_table)


# ---------------------------------------------------------------------------
# Host-side preparation.

_L_LE = np.frombuffer(int.to_bytes(L, 32, "little"), dtype=np.uint8)


def lt_le(arr: np.ndarray, bound_le: np.ndarray) -> np.ndarray:
    """Vectorised ``arr < bound`` over little-endian [B, 32] byte rows."""
    B = arr.shape[0]
    diff = arr != bound_le[None, :]
    idx = 31 - np.argmax(diff[:, ::-1], axis=1)
    rows = np.arange(B)
    return diff.any(axis=1) & (arr[rows, idx] < bound_le[idx])


def _gather(col, width: int, ok: np.ndarray) -> np.ndarray:
    """[B, width] uint8 rows of a column: lane i's bytes where ``ok[i]``
    (its length is ``width``), else zeros. One gather, no loop a lane."""
    idx = np.where(ok[:, None], col.lo[:, None] + np.arange(width), 0)
    rows = col.buf[idx]
    rows[~ok] = 0
    return rows


def host_lanes(pks, sigs):
    """Lengths and byte rows of a batch (pks, sigs: columns or lists of
    bytes-like): (len_ok bool [B], pk_arr, r_arr, s_arr, each [B, 32]
    uint8). Lanes with a wrong length get zero bytes."""
    pks, sigs = lanes.byte_column(pks), lanes.byte_column(sigs)
    len_ok = (pks.lengths() == 32) & (sigs.lengths() == 64)
    sig_arr = _gather(sigs, 64, len_ok)
    return len_ok, _gather(pks, 32, len_ok), sig_arr[:, :32].copy(), sig_arr[:, 32:].copy()


def _pack(pk_arr, r_arr, s_arr, h_arr, host_ok):
    """Zero s on rejected lanes, reject a non-canonical A.y, and stack the
    four planes: (numpy [128, B] uint8, host_ok bool [B])."""
    if not host_ok.all():
        s_arr[~host_ok] = 0
    # canonicality of A.y (value < p) on the sign-masked encoding
    masked = pk_arr.copy()
    masked[:, 31] &= 0x7F
    host_ok &= ~(
        (masked[:, 0] >= 0xED)
        & np.all(masked[:, 1:31] == 0xFF, axis=1)
        & (masked[:, 31] == 0x7F))
    packed = np.empty((128, len(host_ok)), dtype=np.uint8)
    packed[0:32] = pk_arr.T
    packed[32:64] = r_arr.T
    packed[64:96] = s_arr.T
    packed[96:128] = h_arr.T
    return packed, host_ok


def prepare_batch_packed(pks, msgs, sigs):
    """Host prep: returns (numpy [128, B] uint8 plane, host_ok bool [B]).

    Lanes with wrong lengths, s >= L or a non-canonical A.y get
    well-formed dummy bytes and host_ok False; the device never sees those
    checks. The whole plane, h = SHA-512(R || A || M) mod L little-endian
    among it, comes from the port's C library (``native.prep_ed25519``),
    which reads the columns (``crypto/lanes.py``, or lists of bytes) where
    they lie."""
    return native.prep_ed25519(pks, msgs, sigs)


def prepare_batch_packed_plain(pks, msgs, sigs):
    """The plain version of ``prepare_batch_packed``: the same bytes, with
    h from ``hashlib`` and s < L from numpy on one core. The tests and the
    card's smoke run compare the two; nothing on the main path calls it."""
    len_ok, pk_arr, r_arr, s_arr = host_lanes(pks, sigs)
    h_arr = np.frombuffer(
        b"".join(
            int.to_bytes(
                int.from_bytes(hashlib.sha512(r.tobytes() + p.tobytes() + bytes(m)).digest(),
                               "little") % L,
                32, "little")
            for r, p, m in zip(r_arr, pk_arr, msgs)),
        dtype=np.uint8).reshape(len(len_ok), 32)
    return _pack(pk_arr, r_arr, s_arr, h_arr, len_ok & lt_le(s_arr, _L_LE))


def split_packed(packed):
    """One [128, B] plane -> the four [32, B] byte planes (views)."""
    return packed[0:32], packed[32:64], packed[64:96], packed[96:128]


_BASE_TABLES: dict = {}


def base_table(device) -> torch.Tensor:
    """[16, 3, 20] int32 fixed-base niels table on ``device`` (cached)."""
    dev = torch.device(device)
    if dev not in _BASE_TABLES:
        _BASE_TABLES[dev] = torch.as_tensor(
            curve.fixed_base_niels_table(), dtype=torch.int32, device=dev)
    return _BASE_TABLES[dev]


def plain_packed(packed):
    """The plain version of the ed25519 kernel on a packed [128, B] plane,
    on the plane's device: bool [B]."""
    return verify_core_compact(*split_packed(packed), base_table(packed.device))


def batch_verify(pks, msgs, sigs, device=None) -> np.ndarray:
    """ed25519 batch verification: bool [B] per-signature validity, exact
    per lane (no batch equation), on ``device`` (None: the CUDA card)."""
    from tmtpu_torch.gpu import kernel

    dev = device_mod.resolve(device)
    B = len(sigs)
    if B == 0:
        return np.zeros(0, dtype=bool)
    impl = metrics.impl_label(dev)
    t0 = time.perf_counter()
    with trace.span("crypto.batch_verify", curve="ed25519", lanes=B) as sp:
        with trace.span("ed25519.prepare", lanes=B):
            packed, host_ok = prepare_batch_packed(pks, msgs, sigs)
        sp.set(impl=impl)
        # no ed25519.pad: no lane is padded
        with trace.span("ed25519.device_put"):
            plane = torch.from_numpy(packed).to(dev)
        with trace.span("ed25519.execute", impl=impl) as ex, spans.device_time(ex, dev):
            mask = kernel.verify_packed(plane)
        with trace.span("ed25519.readback"):
            mask = mask.cpu().numpy()
    metrics.observe_crypto_batch("ed25519", metrics.backend_label(dev), impl, B, 0,
                                 time.perf_counter() - t0)
    return mask & host_ok
