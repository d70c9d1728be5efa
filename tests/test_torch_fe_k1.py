"""The port's secp256k1 field (tmtpu_torch/gpu/fe_k1.py) against the JAX
reference (tmtpu/tpu/fe_k1.py), limb for limb, on the CPU.

The reference's routines are called eagerly (not jitted). Both sides get
the same numpy inputs: loose limbs at the reference's non-uniform bounds
(limb 0 up to 15700, the others up to 9300), canonical-width limbs, tiny
limbs, and edge values around p and 2^256. Outputs must be exactly equal,
and every port output must stay int32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmtpu.tpu import fe_k1 as jfe
from tmtpu_torch.gpu import fe_k1 as tfe

P = tfe.P_INT
B = 8

BOUNDS = {"loose": (tfe.LOOSE0, tfe.LOOSEK), "canonical": (8191, 8191), "tiny": (1, 1)}


def _limbs(seed, bounds="loose"):
    hi0, hik = BOUNDS[bounds]
    rng = np.random.default_rng(seed)
    a = rng.integers(0, hik + 1, size=(tfe.NLIMBS, B), dtype=np.int32)
    a[0] = rng.integers(0, hi0 + 1, size=B)
    return a


def _run_jax(fn, *args):
    return np.asarray(fn(*[jnp.asarray(a) for a in args]))


def _run_torch(fn, *args):
    out = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    assert out.dtype == torch.int32
    return out.numpy()


OPS = {
    "add": (2, lambda m: m.add),
    "sub": (2, lambda m: m.sub),
    "neg": (1, lambda m: m.neg),
    "mul": (2, lambda m: m.mul),
    "sq": (1, lambda m: m.sq),
    "mul_small3": (1, lambda m: (lambda a: m.mul_small(a, 3))),
    "mul_small21": (1, lambda m: (lambda a: m.mul_small(a, 21))),
    "freeze": (1, lambda m: m.freeze),
    "sqn3": (1, lambda m: (lambda a: m.sqn(a, 3))),
    "sqrt_candidate": (1, lambda m: m.sqrt_candidate),
}


# the reference's sqrt_candidate retraces its fori_loops on every eager
# call (~9 s), so it is compared at the loose bound and on the edges only
CASES = [(op, b) for op in sorted(OPS) for b in sorted(BOUNDS)
         if op != "sqrt_candidate" or b == "loose"]


@pytest.mark.parametrize("op,bounds", CASES, ids=[f"{o}-{b}" for o, b in CASES])
def test_op_matches_reference_limb_for_limb(op, bounds):
    arity, pick = OPS[op]
    args = [_limbs(200 + k, bounds) for k in range(arity)]
    np.testing.assert_array_equal(_run_torch(pick(tfe), *args),
                                  _run_jax(pick(jfe), *args))


EDGES = [0, 1, 2, 7, P - 1, P, P + 1, 2 * P - 1, 2**256 - 1, 2**256,
         2**32 + 977, 2**255, (P + 1) // 4, 2**259 + 12345]


def _edge_columns():
    return np.stack([tfe.limbs_of_int(v) for v in EDGES], axis=1).astype(np.int32)


@pytest.mark.parametrize("op", ["freeze", "mul", "sq", "sub", "sqrt_candidate"])
def test_edge_values_match_reference(op):
    a = _edge_columns()
    b = a[:, ::-1].copy()
    arity, pick = OPS[op]
    args = [a, b][:arity]
    np.testing.assert_array_equal(_run_torch(pick(tfe), *args),
                                  _run_jax(pick(jfe), *args))


@pytest.mark.parametrize("op", ["freeze", "mul", "sqrt_candidate"])
def test_edge_values_against_python_ints(op):
    a = _edge_columns()
    b = a[:, ::-1].copy()
    want = {
        "freeze": lambda x, y: x % P,
        "mul": lambda x, y: x * y % P,
        "sqrt_candidate": lambda x, y: pow(x, (P + 1) // 4, P),
    }[op]
    arity, pick = OPS[op]
    out = _run_torch(tfe.freeze, _run_torch(pick(tfe), *[a, b][:arity]))
    assert out.min() >= 0 and out.max() < (1 << tfe.RADIX)
    for j, (x, y) in enumerate(zip(EDGES, EDGES[::-1])):
        assert tfe.int_of_limbs(out[:, j]) == want(x, y), (op, x, y)


def test_constants_match_reference():
    np.testing.assert_array_equal(tfe.KSUB, jfe.KSUB)
    np.testing.assert_array_equal(tfe.P_LIMBS, jfe.P_LIMBS)
    assert tfe.int_of_limbs(tfe.KSUB) == 64 * P
    assert tfe.KSUB[0] >= tfe.LOOSE0 + 100 and tfe.KSUB[1:].min() >= tfe.LOOSEK + 100
    assert (2**260) % P == tfe.F2 * 2**26 + tfe.F1 * 2**13 + tfe.F0
    assert (2**520) % P == tfe.G0 + tfe.G1 * 2**13 + tfe.G3 * 2**39 + tfe.G5 * 2**65


@pytest.mark.parametrize("v", [0, 1, P - 1, 2**256 - 1, 2**259 + 12345])
def test_limbs_of_int(v):
    np.testing.assert_array_equal(tfe.limbs_of_int(v), jfe.limbs_of_int(v))
    assert tfe.int_of_limbs(tfe.limbs_of_int(v)) == v


def test_pack_bytes_device_matches_reference():
    raw = np.random.default_rng(6).integers(0, 256, size=(32, B), dtype=np.uint8)
    got = tfe.pack_bytes_device(torch.from_numpy(raw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfe.pack_bytes_device(jnp.asarray(raw))))
    for j in range(B):
        assert tfe.int_of_limbs(got[:, j].numpy()) == int.from_bytes(raw[:, j].tobytes(), "big")


@pytest.mark.parametrize("fold", [True, False])
def test_carry_pass_matches_reference(fold):
    rng = np.random.default_rng(int(fold))
    x = rng.integers(0, 1_900_000_000, size=(2 * tfe.NLIMBS, B), dtype=np.int32)
    x[-1] = rng.integers(0, 1 << 16, size=B)
    np.testing.assert_array_equal(tfe.carry(torch.from_numpy(x), 2, fold=fold).numpy(),
                                  np.asarray(jfe.carry(jnp.asarray(x), 2, fold=fold)))


def test_mul_worst_case_bound():
    a = np.full((tfe.NLIMBS, 2), tfe.LOOSEK, dtype=np.int32)
    a[0] = tfe.LOOSE0
    got = _run_torch(tfe.mul, a, a)
    assert got[0].max() <= tfe.LOOSE0 and got[1:].max() <= tfe.LOOSEK
    v = tfe.int_of_limbs(a[:, 0])
    assert tfe.int_of_limbs(got[:, 0]) % P == v * v % P


def test_broadcast_constant_operand():
    a = _limbs(9)
    seven = tfe.limbs_of_int(7)[:, None]
    np.testing.assert_array_equal(_run_torch(tfe.mul, seven, a), _run_jax(jfe.mul, seven, a))


@pytest.mark.parametrize("k", [0, 64])
def test_mul_small_rejects_out_of_range(k):
    with pytest.raises(ValueError):
        tfe.mul_small(torch.zeros((tfe.NLIMBS, 1), dtype=torch.int32), k)
