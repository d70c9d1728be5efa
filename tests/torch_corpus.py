"""Signature corpora shared by the port's tests (tests/test_torch_*.py) and
chip_smoke.py: for ed25519, random signed lanes, the adversarial block of
tests/test_tpu_verify.py and low-order / mixed-order public keys; for
sr25519 and secp256k1, random signed lanes, the adversarial blocks of
tests/test_tpu_sr25519.py and tests/test_tpu_k1.py, and lanes built to
reach each edge of the secp256k1 verify. Everything is made from numpy
seeds with the port's own keys and oracles, so every run sees the same
lanes."""

import hashlib

import numpy as np

from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.crypto import secp256k1_ref as k1ref
from tmtpu_torch.crypto.secp256k1 import PrivKeySecp256k1, PubKeySecp256k1
from tmtpu_torch.crypto.sr25519 import L as SR_L
from tmtpu_torch.crypto.sr25519 import PubKeySr25519, gen_priv_key_from_secret


def signed(n, seed, msg_len=96):
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(msg_len) for _ in range(n)]
    pks = [ref.public_key(s) for s in seeds]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    return pks, msgs, sigs


def flip(b: bytes, i: int, bit: int = 0) -> bytes:
    ba = bytearray(b)
    ba[i] ^= 1 << bit
    return bytes(ba)


def adversarial(seed=7):
    """The reference's adversarial block: 9 broken lanes, 3 good ones, plus
    an identity public key with a valid cofactorless signature and x = 0
    with the sign bit set."""
    pks, msgs, sigs = signed(12, seed)
    sigs[0] = flip(sigs[0], 0)          # corrupt R
    sigs[1] = flip(sigs[1], 40)         # corrupt s
    msgs[2] = flip(msgs[2], 3)          # corrupt msg
    pks[3] = flip(pks[3], 1)            # corrupt pubkey
    s_int = int.from_bytes(sigs[4][32:], "little") + ref.L
    sigs[4] = sigs[4][:32] + int.to_bytes(s_int, 32, "little")  # s >= L
    pks[5] = int.to_bytes(ref.P + 1, 32, "little")  # y >= p
    sigs[6] = flip(sigs[6], 31, 7)      # R sign bit
    pks[7] = pks[11]                    # another validator's key
    sigs[8] = sigs[8][:63]              # wrong length
    s = 12345
    sig = ref.point_compress(ref.scalar_mult(s, ref.BASE)) + int.to_bytes(s, 32, "little")
    pks += [ref.point_compress(ref.IDENTITY), int.to_bytes(1 | 1 << 255, 32, "little")]
    msgs += [b"anything", b"anything"]
    sigs += [sig, sig]
    return pks, msgs, sigs


def torsion_points():
    """The 8 points of the small subgroup, from [L]Q for a Q outside the
    prime-order subgroup."""
    y = 2
    while True:
        q = ref.point_decompress(int.to_bytes(y, 32, "little"))
        if q is not None:
            t = ref.scalar_mult(ref.L, q)
            multiples = [ref.scalar_mult(k, t) for k in range(8)]
            if not any(ref.point_equal(m, ref.IDENTITY) for m in multiples[1:]):
                return multiples
        y += 1


def low_order():
    """For each torsion public key: a signature that verifies
    cofactorlessly (R = [s]B + T with T = [h](-A), found by search) and one
    that does not; plus mixed-order keys (a real key plus a torsion point)
    under the real key's signature."""
    pks, msgs, sigs = [], [], []
    torsion = torsion_points()
    for ai, a in enumerate(torsion):
        a_enc = ref.point_compress(a)
        msg = b"low-order %d" % ai
        for s in range(1000, 1400):
            sb = ref.scalar_mult(s, ref.BASE)
            found = None
            for t in torsion:
                r_enc = ref.point_compress(ref.point_add(sb, t))
                h = int.from_bytes(hashlib.sha512(r_enc + a_enc + msg).digest(),
                                   "little") % ref.L
                if ref.point_equal(ref.scalar_mult(h, ref.point_neg(a)), t):
                    found = r_enc
                    break
            if found is not None:
                sig = found + int.to_bytes(s, 32, "little")
                pks += [a_enc, a_enc]
                msgs += [msg, msg + b"!"]
                sigs += [sig, sig]
                break
    rpks, rmsgs, rsigs = signed(4, 11)
    for i in range(4):
        p = ref.point_decompress(rpks[i])
        pks.append(ref.point_compress(ref.point_add(p, torsion[2 * i + 1])))
        msgs.append(rmsgs[i])
        sigs.append(rsigs[i])
    return pks, msgs, sigs


def lengths(seed=13):
    """Wrong public-key and signature lengths among good lanes."""
    pks, msgs, sigs = signed(6, seed)
    pks[1] = pks[1][:31]
    sigs[2] = sigs[2] + b"\x00"
    pks[3] = b""
    sigs[4] = b""
    return pks, msgs, sigs


CORPORA = {
    "random": lambda: signed(20, 1, msg_len=120),
    "adversarial": adversarial,
    "low_order": low_order,
    "lengths": lengths,
}


def oracle(pks, msgs, sigs) -> np.ndarray:
    return np.array([ref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)],
                    dtype=bool)


# ---------------------------------------------------------------------------
# sr25519


def sr_signed(n, seed, msg_len=40):
    rng = np.random.default_rng(seed)
    keys = [gen_priv_key_from_secret(rng.bytes(16)) for _ in range(n)]
    msgs = [rng.bytes(msg_len) for _ in range(n)]
    return ([k.pub_key().bytes() for k in keys], msgs,
            [k.sign(m) for k, m in zip(keys, msgs)])


def sr_adversarial(seed=21):
    """The lanes of tests/test_tpu_sr25519.py:42-86 (corrupted R, msg, key
    and s, the marker bit cleared, s + L, an odd R, a key >= p, a short
    signature), the all-zero key (the identity), and an R that is even and
    below p but decodes to no point."""
    pks, msgs, sigs = sr_signed(14, seed)
    sigs[1] = flip(sigs[1], 3, 6)                  # corrupt R
    msgs[2] = msgs[2] + b"!"                       # corrupt msg
    pks[3] = pks[4]                                # another validator's key
    sigs[5] = flip(sigs[5], 63, 7)                 # marker bit cleared
    s6 = int.from_bytes(sigs[6][32:63] + bytes([sigs[6][63] & 0x7F]), "little")
    if s6 + SR_L < 1 << 255:
        sigs[6] = sigs[6][:32] + ((s6 + SR_L) | 1 << 255).to_bytes(32, "little")
    sigs[7] = flip(sigs[7], 0)                     # odd R
    pks[8] = (2**255 - 18).to_bytes(32, "little")  # key >= p
    sigs[9] = sigs[9][:40]                         # short signature
    sigs[10] = flip(sigs[10], 40, 3)               # corrupt s
    pks[11] = bytes(32)                            # the identity
    sigs[12] = (2).to_bytes(32, "little") + sigs[12][32:]  # R decodes to nothing
    return pks, msgs, sigs


def sr_oracle(pks, msgs, sigs) -> np.ndarray:
    return np.array([len(p) == 32 and PubKeySr25519(p).verify_signature(m, s)
                     for p, m, s in zip(pks, msgs, sigs)], dtype=bool)


# ---------------------------------------------------------------------------
# secp256k1

K1_N = k1ref.N
K1_P = k1ref.P


def k1_priv(secret: bytes) -> PrivKeySecp256k1:
    v = int.from_bytes(hashlib.sha256(secret).digest(), "big")
    return PrivKeySecp256k1((v % (K1_N - 1) + 1).to_bytes(32, "big"))


def k1_signed(n, seed, msg_len=40):
    rng = np.random.default_rng(seed)
    keys = [k1_priv(rng.bytes(16)) for _ in range(n)]
    msgs = [rng.bytes(msg_len) for _ in range(n)]
    return ([k.pub_key().bytes() for k in keys], msgs,
            [k.sign(m) for k, m in zip(keys, msgs)])


def k1_adversarial(seed=22):
    """The lanes of tests/test_tpu_k1.py:157-190 (corrupted r, msg, key and
    s, high S, r = 0, r = n, a bad prefix, x = 0 whose x^3 + 7 is not a
    square, a short signature) and a flipped prefix parity
    (tests/test_tpu_k1.py:221)."""
    pks, msgs, sigs = k1_signed(13, seed)
    sigs[1] = flip(sigs[1], 5, 5)                  # corrupt r
    msgs[2] = msgs[2] + b"x"                       # corrupt msg
    pks[3] = pks[4]                                # another validator's key
    s4 = int.from_bytes(sigs[4][32:], "big")
    sigs[4] = sigs[4][:32] + (K1_N - s4).to_bytes(32, "big")  # high S
    sigs[5] = bytes(32) + sigs[5][32:]             # r = 0
    sigs[6] = K1_N.to_bytes(32, "big") + sigs[6][32:]  # r = n
    pks[7] = b"\x05" + pks[7][1:]                  # bad prefix
    pks[8] = b"\x02" + bytes(32)                   # x^3 + 7 = 7, no root
    sigs[9] = sigs[9][:50]                         # short signature
    sigs[10] = flip(sigs[10], 45, 2)               # corrupt s
    pks[11] = bytes([pks[11][0] ^ 1]) + pks[11][1:]  # flipped parity
    return pks, msgs, sigs


def _k1_sqrt(v):
    y = pow(v, (K1_P + 1) // 4, K1_P)
    return y if y * y % K1_P == v % K1_P else None


def _k1_neg(pt):
    return (pt[0], (-pt[1]) % K1_P)


def _k1_key_for(r_pt, h, r, s):
    """The key Q with [u1]G + [u2]Q = R for u1 = h/s, u2 = r/s, found
    without a discrete log: Q = (R - [u1]G) / u2."""
    w = pow(s, -1, K1_N)
    u1, u2 = h * w % K1_N, r * w % K1_N
    return k1ref.scalar_mult(pow(u2, -1, K1_N),
                             k1ref.point_add(r_pt, _k1_neg(k1ref.scalar_mult(u1))))


def _low_s(v):
    v %= K1_N
    return min(v, K1_N - v)


def k1_edges():
    """Lanes built to reach each edge of the device verify, every one of
    them decided by the serial oracle too:
    0: R.x in [n, p), so x(R) mod n = r only through rpn = r + n (valid);
    1: the same signature under another message (invalid);
    2: R at infinity: Q = -(h/r) G, so [u1]G + [u2]Q = O (invalid);
    3: u1 = 1 and u2 = 2^252: every digit but one zero in each (valid);
    4: u1 and u2 with long runs of zero digits (valid);
    5, 6: two plain signed lanes."""
    pks, msgs, sigs = [], [], []
    x = K1_N + 1
    while _k1_sqrt(x**3 + 7) is None:
        x += 1
    r_pt = (x, _k1_sqrt(x**3 + 7))
    r = x - K1_N
    msg = b"rpn branch"
    h = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    s = _low_s(h * 3 + 5)
    q = _k1_key_for(r_pt, h, r, s)
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    pks += [k1ref.compress(q)] * 2
    msgs += [msg, msg + b"!"]
    sigs += [sig, sig]

    msg = b"infinity"
    h = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    r = int.from_bytes(hashlib.sha256(b"infinity r").digest(), "big") % K1_N
    s = _low_s(h + 12345)
    q = k1ref.scalar_mult(-h * pow(r, -1, K1_N) % K1_N)
    pks.append(k1ref.compress(q))
    msgs.append(msg)
    sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))

    for u1_t, u2_t in ((1, 1 << 252),
                       (0x0F000000000000000000000000000000000000000000000000000000000000A1,
                        0x00000000C0FFEE000000000000000000000000000000000000000000000000B7)):
        ctr = 0
        while True:
            msg = b"zero digits %d" % ctr
            ctr += 1
            h = int.from_bytes(hashlib.sha256(msg).digest(), "big")
            s = h * pow(u1_t, -1, K1_N) % K1_N
            r = u2_t * s % K1_N
            y = _k1_sqrt(r**3 + 7)
            if 0 < s <= K1_N // 2 and r and y is not None:
                break
        pks.append(k1ref.compress(_k1_key_for((r, y), h, r, s)))
        msgs.append(msg)
        sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))

    more = k1_signed(2, 23)
    return pks + more[0], msgs + more[1], sigs + more[2]


def k1_oracle(pks, msgs, sigs) -> np.ndarray:
    return np.array([len(p) == 33 and PubKeySecp256k1(p).verify_signature(m, s)
                     for p, m, s in zip(pks, msgs, sigs)], dtype=bool)


SR_CORPORA = {
    "random": lambda: sr_signed(8, 31),
    "adversarial": sr_adversarial,
}

K1_CORPORA = {
    "random": lambda: k1_signed(8, 32),
    "adversarial": k1_adversarial,
    "edges": k1_edges,
}
