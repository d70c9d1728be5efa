"""The kernels' wrappers (tmtpu_torch/gpu/kernel.py for ed25519 and
sr25519, tmtpu_torch/gpu/k1_kernel.py for secp256k1) and the build helper.
Input checks and the CPU path run everywhere; the cases marked ``cuda``
build and launch the CUDA kernels and skip without a card."""

import numpy as np
import pytest
import torch

from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.gpu import build, k1_kernel, kernel
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv

from tests import torch_corpus as corpus


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plane(name="adversarial"):
    pks, msgs, sigs = corpus.CORPORA[name]()
    packed, ok = tv.prepare_batch_packed(pks, msgs, sigs)
    return torch.from_numpy(packed), ok, corpus.oracle(pks, msgs, sigs)


def test_cpu_tensor_takes_plain_version():
    packed, ok, want = _plane()
    before = kernel.LAUNCHES
    got = kernel.verify_packed(packed)
    assert kernel.LAUNCHES == before  # no kernel launch on the CPU
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy() & ok, want)


@pytest.mark.parametrize("bad", ["dtype", "rows", "rank", "strides", "device"])
def test_wrapper_rejects_bad_input(bad):
    good = torch.zeros((128, 8), dtype=torch.uint8)
    plane, err = {
        "dtype": (good.to(torch.int32), TypeError),
        "rows": (torch.zeros((127, 8), dtype=torch.uint8), ValueError),
        "rank": (torch.zeros(128 * 8, dtype=torch.uint8), ValueError),
        "strides": (torch.zeros((8, 128), dtype=torch.uint8).T, ValueError),
        "device": (torch.zeros((128, 8), dtype=torch.uint8, device="meta"), ValueError),
    }[bad]
    with pytest.raises(err):
        kernel.verify_packed(plane)


def test_base_table_limbs_encode_small_multiples():
    table = kernel.base_table_limbs()
    assert table.shape == (16, 3, 10) and table.dtype == np.int32
    pos = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]
    val = lambda limbs: sum(int(v) << p for v, p in zip(limbs, pos))  # noqa: E731
    d2 = 2 * ref.D % ref.P
    for d in range(16):
        x, y = ref.affine(ref.scalar_mult(d, ref.BASE))
        assert val(table[d, 0]) == (y - x) % ref.P
        assert val(table[d, 1]) == (y + x) % ref.P
        assert val(table[d, 2]) == x * y * d2 % ref.P


@pytest.mark.parametrize("v", [0, 1, ref.P - 1, ref.D, ref.SQRT_M1])
def test_limbs10_roundtrip(v):
    limbs = kernel.limbs10_of_int(v)
    pos = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]
    assert sum(int(x) << p for x, p in zip(limbs, pos)) == v
    assert all(0 <= int(x) < (1 << 26) for x in limbs)


def test_build_names_every_source():
    assert build.sources() == ["ed25519_verify", "k1_verify", "sr25519_verify"]
    for name in build.sources():
        path = build.lib_path(name)
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")


# The new kernels: (wrapper, launch counter, host prep, plain version on a
# plane, oracle, corpora, plane rows).
NEW_KERNELS = {
    "sr25519": (kernel.sr_verify_packed, lambda: kernel.SR_LAUNCHES,
                sv.prepare_sr_batch_packed, sv.plain_packed, corpus.sr_oracle,
                corpus.SR_CORPORA, 128),
    "secp256k1": (k1_kernel.verify_packed, lambda: k1_kernel.LAUNCHES,
                  kv.prepare_k1_batch_packed, kv.plain_packed, corpus.k1_oracle,
                  corpus.K1_CORPORA, 168),
}


@pytest.mark.parametrize("curve", sorted(NEW_KERNELS))
def test_new_wrapper_cpu_tensor_takes_plain_version(curve):
    wrapper, count, prep, _, oracle, corpora, _ = NEW_KERNELS[curve]
    pks, msgs, sigs = corpora["adversarial"]()
    packed, ok = prep(pks, msgs, sigs)
    before = count()
    got = wrapper(torch.from_numpy(packed))
    assert count() == before  # no kernel launch on the CPU
    assert got.dtype == torch.bool and got.shape == (len(sigs),)
    np.testing.assert_array_equal(got.numpy() & ok, oracle(pks, msgs, sigs))


@pytest.mark.parametrize("curve", sorted(NEW_KERNELS))
@pytest.mark.parametrize("bad", ["dtype", "rows", "rank", "strides", "device"])
def test_new_wrapper_rejects_bad_input(curve, bad):
    wrapper, *_, rows = NEW_KERNELS[curve]
    plane, err = {
        "dtype": (torch.zeros((rows, 8), dtype=torch.int32), TypeError),
        "rows": (torch.zeros((rows - 1, 8), dtype=torch.uint8), ValueError),
        "rank": (torch.zeros(rows * 8, dtype=torch.uint8), ValueError),
        "strides": (torch.zeros((8, rows), dtype=torch.uint8).T, ValueError),
        "device": (torch.zeros((rows, 8), dtype=torch.uint8, device="meta"), ValueError),
    }[bad]
    with pytest.raises(err):
        wrapper(plane)


@pytest.mark.parametrize("curve", sorted(NEW_KERNELS))
def test_new_wrapper_empty_plane(curve):
    wrapper, count, *_, rows = NEW_KERNELS[curve]
    before = count()
    got = wrapper(torch.zeros((rows, 0), dtype=torch.uint8))
    assert got.shape == (0,) and got.dtype == torch.bool and count() == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adversarial", "low_order", "random"])
def test_kernel_equals_plain_on_card(cuda_card, name):
    packed, ok, want = _plane(name)
    dev = packed.to(cuda_card)
    before = kernel.LAUNCHES
    got = kernel.verify_packed(dev)
    assert kernel.LAUNCHES == before + 1
    assert torch.equal(got, tv.plain_packed(dev))
    np.testing.assert_array_equal(got.cpu().numpy() & ok, want)


@pytest.mark.cuda
def test_kernel_rejects_bad_input_on_card(cuda_card):
    with pytest.raises(TypeError):
        kernel.verify_packed(torch.zeros((128, 4), dtype=torch.int32, device=cuda_card))
    with pytest.raises(ValueError):
        kernel.verify_packed(torch.zeros((64, 4), dtype=torch.uint8, device=cuda_card))


@pytest.mark.cuda
def test_kernel_ragged_widths_on_card(cuda_card):
    # widths that are not a multiple of the 64-thread block
    for lanes in (1, 65, 200):
        packed = torch.from_numpy(np.repeat(
            tv.prepare_batch_packed(*corpus.signed(1, 40))[0], lanes, axis=1))
        assert kernel.verify_packed(packed.to(cuda_card)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("curve,name", [(c, n) for c in sorted(NEW_KERNELS)
                                        for n in sorted(NEW_KERNELS[c][5])])
def test_new_kernel_equals_plain_on_card(cuda_card, curve, name):
    wrapper, count, prep, plain, oracle, corpora, _ = NEW_KERNELS[curve]
    pks, msgs, sigs = corpora[name]()
    packed, ok = prep(pks, msgs, sigs)
    dev = torch.from_numpy(packed).to(cuda_card)
    before = count()
    got = wrapper(dev)
    assert count() == before + 1
    assert torch.equal(got, plain(dev))
    np.testing.assert_array_equal(got.cpu().numpy() & ok, oracle(pks, msgs, sigs))


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(NEW_KERNELS))
def test_new_kernel_ragged_widths_on_card(cuda_card, curve):
    wrapper, _, prep, _, _, corpora, _ = NEW_KERNELS[curve]
    one = prep(*[x[:1] for x in corpora["random"]()])[0]
    for lanes in (1, 65, 200):
        packed = torch.from_numpy(np.ascontiguousarray(np.repeat(one, lanes, axis=1)))
        assert wrapper(packed.to(cuda_card)).all()
