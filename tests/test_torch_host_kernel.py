"""The CUDA kernels' arithmetic, checked on the CPU: g++ builds the kernels'
``__host__ __device__`` headers (fe25519.cuh, ge25519.cuh, ristretto255.cuh,
fe_secp256k1.cuh, ge_secp256k1.cuh) with the test harness
csrc/host_harness.cpp into a temporary shared library. The field ops of
both fields are held against Python integers, and the per-lane verifies of
the three kernels, the very functions each kernel thread runs, against the
oracles and the plain PyTorch masks. The three kernels verify a signature
with a quad of four threads; the host build runs the same quad code with
the four roles in lockstep and reports -1 where they disagree.
This host build serves the tests only."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.crypto import ristretto
from tmtpu_torch.gpu import k1_kernel, kernel
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv

from tests import torch_corpus as corpus

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tmtpu_torch", "gpu", "csrc")
P = ref.P


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("host_kernel") / "host_harness.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wall", "-Wno-unknown-pragmas", "-o", out,
                    os.path.join(CSRC, "host_harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.host_verify.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.host_verify.restype = None
    for fn in (lib.host_fe, lib.host_fe8):
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_void_p, ctypes.c_int]
        fn.restype = None
    lib.host_ristretto_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p]
    lib.host_ristretto_decode.restype = None
    lib.host_fe_limbs.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int]
    lib.host_fe_limbs.restype = None
    for fn in (lib.host_sr_verify, lib.host_k1_verify):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = None
    return lib


def _host_verify(lib, packed: np.ndarray) -> np.ndarray:
    packed = np.ascontiguousarray(packed)
    table = kernel.base_table_limbs()
    out = np.zeros(packed.shape[1], dtype=np.int32)
    lib.host_verify(packed.ctypes.data, packed.shape[1], table.ctypes.data,
                    out.ctypes.data)
    assert (out >= 0).all(), "the quad's roles disagree"
    return out != 0


def _field_inputs():
    rng = np.random.default_rng(17)
    # 255-bit inputs, as the kernel reads them (bit 255 is the sign bit)
    edge = [0, 1, 2, 19, P - 1, P, P + 1, P + 18, 2**255 - 1, 2**255 - 20,
            2**254, (P - 1) // 2, 2**26 - 1, 2**51]
    return edge + [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(200)]


FIELD_OPS = {
    0: ("mul", lambda a, b: a * b % P),
    1: ("add", lambda a, b: (a + b) % P),
    2: ("sub", lambda a, b: (a - b) % P),
    3: ("neg", lambda a, b: -a % P),
    4: ("invert", lambda a, b: pow(a, P - 2, P)),
    5: ("pow22523", lambda a, b: pow(a, (P - 5) // 8, P)),
    6: ("freeze", lambda a, b: a % P),
    7: ("sq", lambda a, b: a * a % P),
    8: ("sq_of_difference", lambda a, b: (a - b) ** 2 % P),
}


@pytest.mark.parametrize("op", sorted(FIELD_OPS), ids=[v[0] for _, v in sorted(FIELD_OPS.items())])
def test_field_op_against_python_ints(harness, op):
    a = _field_inputs()
    b = a[::-1]
    n = len(a)
    out = ctypes.create_string_buffer(32 * n)
    harness.host_fe(op, b"".join(int.to_bytes(v, 32, "little") for v in a),
                    b"".join(int.to_bytes(v, 32, "little") for v in b), out, n)
    f = FIELD_OPS[op][1]
    for i in range(n):
        got = int.from_bytes(out.raw[32 * i : 32 * i + 32], "little")
        assert got == f(a[i], b[i]), (FIELD_OPS[op][0], a[i], b[i])


_LIMB_POS = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]


def _loose_limbs(rng, n):
    """n limb vectors at the edges of what the field routines accept: the
    carried range (|v| up to ~1.01 * 2^25 even, 2^24 odd, either sign) and
    fe_frombytes' non-negative limbs (up to 2^26 - 1 / 2^25 - 1)."""
    bits = np.array([26, 25] * 5)
    carried = np.where(bits == 26, 2**25 + 2**19, 2**24 + 2**18)
    out = [np.where(bits == 26, 2**26 - 1, 2**25 - 1), -carried, carried]
    for _ in range(n - 3):
        if rng.random() < 0.5:
            out.append(rng.integers(-carried, carried + 1))
        else:
            out.append(rng.integers(0, 2**bits))
    return np.array(out, dtype=np.int32)


def _limbs_value(v):
    return sum(int(x) << p for x, p in zip(v, _LIMB_POS))


@pytest.mark.parametrize("op", [0, 1], ids=["mul", "sq"])
def test_field_op_on_loose_limbs(harness, op):
    """fe_mul and the dedicated fe_sq on raw limbs at the bounds the
    routines accept, negative limbs included: the squaring's doubled and
    38-fold terms must keep the accumulators inside fe_reduce64's range."""
    rng = np.random.default_rng(23)
    a = _loose_limbs(rng, 300)
    b = a[::-1].copy()
    n = len(a)
    out = ctypes.create_string_buffer(32 * n)
    harness.host_fe_limbs(op, a.ctypes.data, b.ctypes.data, out, n)
    for i in range(n):
        x, y = _limbs_value(a[i]), _limbs_value(b[i])
        want = x * (y if op == 0 else x) % P
        assert int.from_bytes(out.raw[32 * i : 32 * i + 32], "little") == want, a[i]


@pytest.mark.parametrize("name", sorted(corpus.CORPORA))
def test_lane_verify_against_oracle_and_plain(harness, name):
    pks, msgs, sigs = corpus.CORPORA[name]()
    packed, ok = tv.prepare_batch_packed(pks, msgs, sigs)
    got = _host_verify(harness, packed)
    plain = kernel.verify_packed(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, plain)  # raw masks, lane for lane
    np.testing.assert_array_equal(got & ok, corpus.oracle(pks, msgs, sigs))


def test_lane_verify_on_unreduced_encodings(harness):
    """Encodings the host rejects still reach the device; the kernel and
    the plain version must agree on them too (y >= p, every byte 0xFF, R
    with y >= p)."""
    pks, msgs, sigs = corpus.signed(3, 51)
    pks[0] = int.to_bytes(P + 3, 32, "little")
    pks[1] = b"\xff" * 32
    sigs[2] = int.to_bytes(P + 2, 32, "little") + sigs[2][32:]
    packed, _ = tv.prepare_batch_packed(pks, msgs, sigs)
    np.testing.assert_array_equal(
        _host_verify(harness, packed),
        kernel.verify_packed(torch.from_numpy(packed)).numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 5, 31, 33, 63, 65, 100])
def test_lane_verify_at_ragged_widths(harness, n):
    """Any width: lane t reads byte k of a plane at k*B + t, as each kernel
    thread does, so no lane reads another's bytes whatever B is."""
    pks, msgs, sigs = corpus.signed(n, 60 + n)
    for i in range(0, n, 7):
        sigs[i] = bytes([sigs[i][0] ^ 0xFF]) + sigs[i][1:]
    packed, ok = tv.prepare_batch_packed(pks, msgs, sigs)
    want = np.ones(n, dtype=bool)
    want[::7] = False
    np.testing.assert_array_equal(_host_verify(harness, packed) & ok, want)


# ---------------------------------------------------------------------------
# secp256k1's field, eight 32-bit words (fe_secp256k1.cuh)

K1_P = 2**256 - 2**32 - 977


def _k1_field_inputs():
    """Values below 2^256 at the edges of secp256k1's field (0, p and its
    neighbours, 2^256 - 1, the fold constant 2^32 + 977, single words) and
    200 random ones: every one is a valid input to the kernel's field code."""
    rng = np.random.default_rng(18)
    edge = [0, 1, 2, 7, K1_P - 1, K1_P, K1_P + 1, 2**256 - 1, 2**256 - 2,
            2**256 - 2**32 - 978, 2**32 + 977, 2**32 + 976, 2**255, 2**224,
            (K1_P + 1) // 2, 2**32 - 1, 2**64 - 1]
    return edge + [int.from_bytes(rng.bytes(32), "big") for _ in range(200)]


def _k1_unreduced_inputs():
    """Values in [p, 2^256), unreduced but valid field inputs: p, the top
    two, the middle, and 200 random ones."""
    rng = np.random.default_rng(29)
    span = 2**256 - K1_P
    vals = [K1_P, 2**256 - 1, 2**256 - 2, K1_P + span // 2]
    return vals + [K1_P + int(rng.integers(0, span, dtype=np.uint64)) for _ in range(200)]


def _k1_rare_carry_pairs():
    """(a, b) pairs that drive the field code's rare carries (a fold carrying
    out of word 2, a borrow out of word 1 or 2, and either going on out of
    bit 256) in add, sub, times 21, mul, sq and the signed 21 a - 63 b."""
    fold = 2**32 + 977
    # H * fold = -1 mod 2^96: a * b = H' 2^256 + (2^256 - 2^128), whose
    # reduction leaves 2^96 - 1 in the low words before the last fold
    h = ((2**96 - 1) * pow(fold, -1, 2**96)) % 2**96 + 2**96
    # 21 a - 63 b = 16 - 2^256: a borrow out of bit 256 in the signed fold
    k = (2**256 - 16) // 21
    x21 = -(-(2**256 + 2**96 - fold) // 21)
    return [
        (2**256 - 1, 2**96 - 2**32 - 976),  # add: out of word 2 only
        (2**256 - 1, 2**256 - 1),  # add, times 21, mul, sq: out of bit 256
        (2**100, 2**200),  # sub: out of word 1 only
        (0, 2**256 - 1),  # sub: out of bit 256
        (5, 2**256 - 2**32),  # sub: out of bit 256
        (2**128, (h << 128) | (2**128 - 1)),  # mul: out of word 2 only
        (x21, 1),  # times 21: out of word 2 only
        (x21, 0),  # 21 a - 63 b: a carry out of word 2 only
        (2**256 - 1, 0),  # 21 a - 63 b: a carry out of bit 256
        (0, 2**96),  # 21 a - 63 b: a borrow out of word 2 only
        (3 * -(-k // 3) - k, -(-k // 3)),  # 21 a - 63 b: out of bit 256
    ]


K1_FIELD_OPS = {
    0: ("mul", lambda a, b: a * b % K1_P),
    1: ("add", lambda a, b: (a + b) % K1_P),
    2: ("sub", lambda a, b: (a - b) % K1_P),
    3: ("neg", lambda a, b: -a % K1_P),
    4: ("sq", lambda a, b: a * a % K1_P),
    5: ("times21", lambda a, b: 21 * a % K1_P),
    6: ("sqrt_candidate", lambda a, b: pow(a, (K1_P + 1) // 4, K1_P)),
    7: ("freeze", lambda a, b: a % K1_P),
    8: ("lin", lambda a, b: (21 * a - 63 * b) % K1_P),
}


@pytest.mark.parametrize("op", sorted(K1_FIELD_OPS),
                         ids=[v[0] for _, v in sorted(K1_FIELD_OPS.items())])
def test_k1_field_op_against_python_ints(harness, op):
    """Every input below 2^256 is valid, [p, 2^256) included; outputs are
    canonical."""
    a = _k1_field_inputs()
    b = a[::-1]
    n = len(a)
    out = ctypes.create_string_buffer(32 * n)
    harness.host_fe8(op, b"".join(int.to_bytes(v, 32, "big") for v in a),
                     b"".join(int.to_bytes(v, 32, "big") for v in b), out, n)
    f = K1_FIELD_OPS[op][1]
    for i in range(n):
        got = int.from_bytes(out.raw[32 * i : 32 * i + 32], "big")
        assert got == f(a[i], b[i]), (K1_FIELD_OPS[op][0], a[i], b[i])


@pytest.mark.parametrize("op", [0, 4], ids=["mul", "sq"])
def test_k1_mul_and_sq_on_unreduced_inputs(harness, op):
    """fe8_mul and the dedicated fe8_sq on inputs in [p, 2^256), which every
    routine accepts: the top of that range makes the product's high half
    nearly 2^256, so the reduction's carry word takes 33 bits."""
    a = _k1_unreduced_inputs()
    b = a[::-1]
    n = len(a)
    out = ctypes.create_string_buffer(32 * n)
    harness.host_fe8(op, b"".join(int.to_bytes(v, 32, "big") for v in a),
                     b"".join(int.to_bytes(v, 32, "big") for v in b), out, n)
    for i in range(n):
        want = a[i] * (b[i] if op == 0 else a[i]) % K1_P
        assert int.from_bytes(out.raw[32 * i : 32 * i + 32], "big") == want, (a[i], b[i])


@pytest.mark.parametrize("op", [0, 1, 2, 4, 5, 8],
                         ids=["mul", "add", "sub", "sq", "times21", "lin"])
def test_k1_field_op_on_rare_carries(harness, op):
    """The folds' rare tails: a carry out of word 2 or a borrow out of word
    1, going on out of bit 256 or not, which random inputs never reach."""
    pairs = _k1_rare_carry_pairs()
    n = len(pairs)
    out = ctypes.create_string_buffer(32 * n)
    harness.host_fe8(op, b"".join(int.to_bytes(a, 32, "big") for a, _ in pairs),
                     b"".join(int.to_bytes(b, 32, "big") for _, b in pairs), out, n)
    f = K1_FIELD_OPS[op][1]
    for i, (a, b) in enumerate(pairs):
        assert int.from_bytes(out.raw[32 * i : 32 * i + 32], "big") == f(a, b), (a, b)


def test_ristretto_decode_against_oracle(harness):
    """The kernel's DECODE on encodings the host lets through (even, below
    p): small multiples of B, even values that are not square, and 2 and
    10, which are square but give an odd t and so are rejected. Valid
    flags and the decoded affine point must equal the oracle's."""
    encs = [ristretto.encode(ristretto.scalar_mult(k, ristretto.BASEPOINT)) for k in range(16)]
    encs += [v.to_bytes(32, "little") for v in (2, 4, 6, 10, 2**254, P - 1)]
    rng = np.random.default_rng(19)
    encs += [(int.from_bytes(rng.bytes(32), "little") % P & ~1).to_bytes(32, "little")
             for _ in range(40)]
    n = len(encs)
    valid = np.zeros(n, dtype=np.int32)
    xy = np.zeros((n, 64), dtype=np.uint8)
    harness.host_ristretto_decode(b"".join(encs), n, valid.ctypes.data, xy.ctypes.data)
    for i, enc in enumerate(encs):
        want = ristretto.decode(enc)
        assert bool(valid[i]) == (want is not None), enc.hex()
        if want is not None:
            assert int.from_bytes(xy[i, :32].tobytes(), "little") == want[0]
            assert int.from_bytes(xy[i, 32:].tobytes(), "little") == want[1]
    assert 0 < valid.sum() < n and not valid[16] and not valid[19]  # 2 and 10


# ---------------------------------------------------------------------------
# The sr25519 and secp256k1 per-lane verifies


def _host_new(lib, curve, packed):
    packed = np.ascontiguousarray(packed)
    out = np.zeros(packed.shape[1], dtype=np.int32)
    if curve == "sr25519":
        table = kernel.base_table_limbs()
        lib.host_sr_verify(packed.ctypes.data, packed.shape[1], table.ctypes.data,
                           out.ctypes.data)
    else:
        table = k1_kernel.base_table_words()
        lib.host_k1_verify(packed.ctypes.data, packed.shape[1], table.ctypes.data,
                           out.ctypes.data)
    assert (out >= 0).all(), "the quad's roles disagree"
    return out != 0


NEW = {
    "sr25519": (sv.prepare_sr_batch_packed, kernel.sr_verify_packed, corpus.sr_oracle,
                corpus.SR_CORPORA),
    "secp256k1": (kv.prepare_k1_batch_packed, k1_kernel.verify_packed, corpus.k1_oracle,
                  corpus.K1_CORPORA),
}


@pytest.fixture(scope="module")
def new_planes():
    """{(curve, corpus): (packed plane, host_ok, oracle mask, plain mask)},
    with one plain call per curve over all of its corpora."""
    out = {}
    for curve, (prep, wrapper, oracle, corpora) in NEW.items():
        planes = {name: corpora[name]() for name in sorted(corpora)}
        packed = {name: prep(*lanes) for name, lanes in planes.items()}
        plain = wrapper(torch.from_numpy(np.ascontiguousarray(
            np.concatenate([p for p, _ in packed.values()], axis=1)))).numpy()
        start = 0
        for name, (p, ok) in packed.items():
            out[(curve, name)] = (p, ok, oracle(*planes[name]),
                                  plain[start : start + p.shape[1]])
            start += p.shape[1]
    return out


NEW_CASES = [(c, n) for c in sorted(NEW) for n in sorted(NEW[c][3])]


@pytest.mark.parametrize("curve,name", NEW_CASES, ids=[f"{c}-{n}" for c, n in NEW_CASES])
def test_new_lane_verify_against_oracle_and_plain(harness, new_planes, curve, name):
    packed, ok, want, plain = new_planes[(curve, name)]
    got = _host_new(harness, curve, packed)
    np.testing.assert_array_equal(got, plain)  # raw masks, lane for lane
    np.testing.assert_array_equal(got & ok, want)


@pytest.mark.parametrize("curve", sorted(NEW))
@pytest.mark.parametrize("n", [1, 3, 5, 33, 65])
def test_new_lane_verify_at_ragged_widths(harness, curve, n):
    """Lane t reads byte k of a plane at k*B + t whatever B is: the lanes of
    a corpus tiled to n lanes keep their verdicts."""
    prep, _, oracle, corpora = NEW[curve]
    lanes = corpora["adversarial"]()
    packed, ok = prep(*lanes)
    reps = -(-n // packed.shape[1])
    tiled = np.tile(packed, (1, reps))[:, :n]
    want = np.tile(oracle(*lanes), reps)[:n]
    np.testing.assert_array_equal(_host_new(harness, curve, tiled) & np.tile(ok, reps)[:n],
                                  want)
