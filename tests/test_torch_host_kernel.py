"""The CUDA kernels' arithmetic, checked on the CPU: g++ builds the kernels'
``__host__ __device__`` headers (fe25519.cuh, ge25519.cuh, ristretto255.cuh,
fe_secp256k1.cuh, ge_secp256k1.cuh) with the test harness
csrc/host_harness.cpp into a temporary shared library. The field ops of
both fields are held against Python integers, and the per-lane verifies of
the three kernels, the very functions each kernel thread runs, against the
oracles and the plain PyTorch masks. This host build serves the tests
only."""

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


@pytest.mark.parametrize("n", [1, 2, 31, 33, 63, 65, 100])
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
    rng = np.random.default_rng(18)
    edge = [0, 1, 2, 7, K1_P - 1, K1_P, K1_P + 1, 2**256 - 1, 2**256 - 2,
            2**256 - 2**32 - 978, 2**32 + 977, 2**32 + 976, 2**255, 2**224,
            (K1_P + 1) // 2, 2**32 - 1, 2**64 - 1]
    return edge + [int.from_bytes(rng.bytes(32), "big") for _ in range(200)]


K1_FIELD_OPS = {
    0: ("mul", lambda a, b: a * b % K1_P),
    1: ("add", lambda a, b: (a + b) % K1_P),
    2: ("sub", lambda a, b: (a - b) % K1_P),
    3: ("neg", lambda a, b: -a % K1_P),
    4: ("sq", lambda a, b: a * a % K1_P),
    5: ("times21", lambda a, b: 21 * a % K1_P),
    6: ("sqrt_candidate", lambda a, b: pow(a, (K1_P + 1) // 4, K1_P)),
    7: ("freeze", lambda a, b: a % K1_P),
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
@pytest.mark.parametrize("n", [1, 33, 65])
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
