"""The port's fused verify + tally and its bitarray pack
(tmtpu_torch/gpu/sharding.py) against the reference's bitarray pack and
power-limb tally and against host truth, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmtpu.tpu import sharding as jsh
from tmtpu_torch.gpu import kernel
from tmtpu_torch.gpu import sharding as sh
from tmtpu_torch.gpu import verify as tv

from tests import torch_corpus as corpus


@pytest.mark.parametrize("b", [1, 31, 32, 33, 64, 100])
def test_pack_bitarray_matches_reference(b):
    mask = np.random.default_rng(b).random(b) < 0.6
    want = np.asarray(jsh.pack_bitarray(jnp.asarray(mask)))
    got = sh.pack_bitarray(torch.from_numpy(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _words(mask):
    """The bitarray words of a returned mask, packed as crypto.batch packs
    them."""
    words = sh.pack_bitarray(torch.from_numpy(mask))
    assert words.dtype == torch.int64
    return words.numpy().astype(np.uint32)


def _powers(n, seed):
    # spread over the int64 range a validator set can carry
    return [int(p) for p in np.random.default_rng(seed).integers(1, 2**40, n)]


@pytest.mark.parametrize("name", ["adversarial", "low_order", "lengths"])
def test_batch_verify_tally_against_host_truth(name):
    pks, msgs, sigs = corpus.CORPORA[name]()
    powers = _powers(len(sigs), 3)
    mask, tally = sh.batch_verify_tally(pks, msgs, sigs, powers, device="cpu")
    want = corpus.oracle(pks, msgs, sigs)
    np.testing.assert_array_equal(mask, want)
    assert isinstance(tally, int)
    assert tally == sum(p for p, ok in zip(powers, want) if ok)
    # the reference's power-limb path gives the same integer
    limbs = jsh.powers_to_limbs(powers) * want[None].astype(np.int32)
    assert tally == jsh.limb_sums_to_int(limbs.sum(axis=1))
    words = _words(mask)
    np.testing.assert_array_equal(words, np.asarray(jsh.pack_bitarray(jnp.asarray(want))))


def test_pad_lanes_excluded_from_tally_and_bits():
    # 33 good lanes fill two bitarray words; the 31 pad bits of the last
    # word stay zero and add nothing to the tally
    pks, msgs, sigs = corpus.signed(33, 21)
    powers = [10**12 + i for i in range(33)]
    mask, tally = sh.batch_verify_tally(pks, msgs, sigs, powers, device="cpu")
    assert mask.all() and tally == sum(powers)
    words = _words(mask)
    assert words.shape == (2,)
    np.testing.assert_array_equal(words, [0xFFFFFFFF, 1])


def test_host_rejected_lane_power_excluded():
    pks, msgs, sigs = corpus.signed(4, 22)
    s_int = int.from_bytes(sigs[2][32:], "little") + tv.L
    sigs[2] = sigs[2][:32] + int.to_bytes(s_int, 32, "little")  # s >= L
    mask, tally = sh.batch_verify_tally(pks, msgs, sigs, [5, 7, 11, 13], device="cpu")
    assert mask.tolist() == [True, True, False, True]
    assert tally == 5 + 7 + 13
    assert _words(mask).tolist() == [0b1011]


def test_step_kernel_equals_step_compact_on_cpu():
    pks, msgs, sigs = corpus.adversarial()
    packed, ok = tv.prepare_batch_packed(pks, msgs, sigs)
    packed = torch.from_numpy(packed)
    powers = torch.arange(1, len(sigs) + 1, dtype=torch.int64)
    ok = torch.from_numpy(ok)
    a = sh.verify_tally_step_compact(packed, powers, ok, tv.base_table("cpu"))
    b = sh.verify_tally_step_kernel(packed, powers, ok)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_empty_batch():
    mask, tally = sh.batch_verify_tally([], [], [], [], device="cpu")
    assert mask.shape == (0,) and tally == 0 and _words(mask).shape == (0,)


@pytest.mark.parametrize("entry", ["batch_verify_tally", "batch_verify"])
def test_device_sees_exactly_the_batch_lanes(entry, monkeypatch):
    """The kernel masks its ragged edge, so neither entry pads the plane:
    the wrapper gets exactly B lanes."""
    widths = []
    real = kernel.verify_packed

    def spy(packed):
        widths.append(packed.shape[1])
        return real(packed)

    monkeypatch.setattr(kernel, "verify_packed", spy)
    pks, msgs, sigs = corpus.signed(5, 23)
    sigs[1] = bytes([sigs[1][0] ^ 0xFF]) + sigs[1][1:]
    if entry == "batch_verify_tally":
        mask, tally = sh.batch_verify_tally(pks, msgs, sigs, [1, 2, 4, 8, 16],
                                            device="cpu")
        assert tally == 1 + 4 + 8 + 16 and _words(mask).tolist() == [0b11101]
    else:
        mask = tv.batch_verify(pks, msgs, sigs, device="cpu")
    assert widths == [5]
    assert mask.tolist() == [True, False, True, True, True]


@pytest.mark.slow
def test_matches_reference_batch_verify_tally():
    """Against the reference's fused XLA step (minutes of XLA:CPU compile)."""
    pks, msgs, sigs = corpus.adversarial()
    powers = _powers(len(sigs), 4)
    want_mask, want_tally = jsh.batch_verify_tally(pks, msgs, sigs, powers)
    mask, tally = sh.batch_verify_tally(pks, msgs, sigs, powers, device="cpu")
    np.testing.assert_array_equal(mask, want_mask)
    assert tally == want_tally
