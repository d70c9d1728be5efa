"""The port's voting-power tally past 2^63 (tmtpu_torch/crypto/batch.py and
the power limbs of tmtpu_torch/gpu/sharding.py) against the reference's
CPUBatchVerifier (tmtpu/crypto/batch.py), which sums Python ints, on the
CPU. A validator set's total is capped at 2^60 (MAX_TOTAL_VOTING_POWER),
so a flush past 2^63 carries relayed copies of votes: with the cache on
they fold onto one lane, with it off each copy is a lane of its own. The
ed25519 lanes are tallied on the device path, sr25519 and secp256k1 on the
host; hits add theirs on the host. Both caches start fresh."""

import numpy as np
import pytest
import torch

from tests.test_torch_mixed import CURVES, _secret, _words
from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import sigcache as jsigcache
from tmtpu_torch.crypto import batch, sigcache
from tmtpu_torch.gpu import sharding as sh

P60 = 2**60  # MAX_TOTAL_VOTING_POWER, tmtpu/types/validator.py


@pytest.fixture(params=["cache on", "cache off"])
def cache(request):
    """Both caches fresh, and both on or both off."""
    on = request.param == "cache on"
    sigcache.DEFAULT.set_enabled(on)
    sigcache.DEFAULT.invalidate_all()
    jsigcache.DEFAULT.set_enabled(on)
    jsigcache.DEFAULT.invalidate_all()
    yield on
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    jsigcache.DEFAULT.set_enabled(True)
    jsigcache.DEFAULT.invalidate_all()


def _signed(kind, i, msg):
    """(port key, reference key, msg, sig) of key i on ``kind``."""
    port_cls, ref_cls = CURVES[kind]
    secret = _secret(kind, i)
    priv = port_cls(secret)
    return priv.pub_key(), ref_cls(secret).pub_key(), msg, priv.sign(msg)


def _flush(lanes, tally=True):
    """One flush of (port key, reference key, msg, sig, power) lanes through
    both verifiers; mask, tally and cache_stats must be equal. Returns the
    port's verifier and result."""
    port = batch.TorchBatchVerifier(device="cpu")
    refv = jbatch.CPUBatchVerifier()
    for port_key, ref_key, msg, sig, power in lanes:
        port.add(port_key, msg, sig, power)
        refv.add(ref_key, msg, sig, power)
    got = port.verify_tally() if tally else port.verify()
    want = refv.verify_tally() if tally else refv.verify()
    assert got == want
    assert port.cache_stats == refv.cache_stats
    return port, got


@pytest.mark.parametrize("copies", [8, 9])
def test_relayed_copies_tally_past_2_63(cache, copies):
    """One precommit per curve relayed ``copies`` times at 2^60 each, the
    curves interleaved in one flush: 8 copies sum to exactly 2^63 a curve,
    where an int64 tally wraps to -2^63."""
    votes = [_signed(kind, 1, b"precommit %s" % kind.encode()) for kind in CURVES]
    lanes = [vote + (P60,) for _ in range(copies) for vote in votes]
    port, (all_ok, mask, tallied) = _flush(lanes)
    assert all_ok and tallied == 3 * copies * P60
    assert port.cache_stats["dispatched"] == (3 if cache else 3 * copies)
    np.testing.assert_array_equal(port.bit_words, _words(mask).astype(np.uint32))
    if cache:
        # the commit flush of the next block: every copy a hit, summed on
        # the host
        port, (all_ok, _, tallied) = _flush(lanes)
        assert all_ok and tallied == 3 * copies * P60
        assert port.cache_stats["hits"] == len(lanes)


@pytest.mark.parametrize("copies", [8, 9])
def test_distinct_votes_tally_past_2_63_on_the_device(cache, copies):
    """``copies`` distinct ed25519 votes at 2^60, one lane each whether the
    cache is on or off: the device's limb sums carry past 2^63. One vote is
    corrupted, and its power stays out."""
    lanes = [_signed(batch.ED25519, i, b"vote %d" % i) + (P60,) for i in range(copies + 1)]
    pk, ref_pk, msg, sig, power = lanes[2]
    lanes[2] = (pk, ref_pk, msg, bytes([sig[0] ^ 1]) + sig[1:], power)
    port, (all_ok, mask, tallied) = _flush(lanes)
    assert not all_ok and tallied == copies * P60
    assert mask == [i != 2 for i in range(copies + 1)]
    assert port.cache_stats["dispatched"] == copies + 1


@pytest.mark.parametrize("powers", [
    [2**63, 1],
    [2**63 + 12345, 2**64 * 3 + 7],
    [2**63 - 1, 2**63 - 1, 2**63 - 1],
], ids=["2^63", "past 2^64", "int64 max x3"])
def test_single_powers_past_int64(cache, powers):
    """Powers that do not fit int64 tally as the reference tallies them,
    on the device (ed25519) and on the host (sr25519), without raising."""
    lanes = [_signed(kind, i, b"big %d" % i) + (p,)
             for i, p in enumerate(powers) for kind in (batch.ED25519, batch.SR25519)]
    _, (all_ok, _, tallied) = _flush(lanes)
    assert all_ok and tallied == 2 * sum(powers)


def test_verify_only_flush_with_large_powers(cache):
    """verify() with powers past int64 gives the reference's mask."""
    lanes = [_signed(batch.ED25519, i, b"m %d" % i) + (2**70 + i,) for i in range(3)]
    _, (all_ok, mask) = _flush(lanes, tally=False)
    assert all_ok and mask == [True] * 3


def test_raw_lanes_tally_past_2_63(cache):
    """The raw-lane entry (the sidecar daemon's engine) takes the same
    resolve: 8 relayed copies at 2^60 tally to 2^63."""
    port_key, ref_key, msg, sig = _signed(batch.ED25519, 5, b"raw")
    refv = jbatch.CPUBatchVerifier()
    for _ in range(8):
        refv.add(ref_key, msg, sig, P60)
    want = refv.verify_tally()
    pk = port_key.bytes()
    mask, tallied, stats = batch.verify_lanes(batch.ED25519, [pk] * 8, [msg] * 8, [sig] * 8,
                                              [P60] * 8, tally=True, device="cpu")
    assert (all(mask), mask, tallied) == want and tallied == 2**63
    assert stats == refv.cache_stats


@pytest.mark.parametrize("powers", [
    [0], [1, 2, 3], [2**31, 2**32 - 1, 2**32, 2**33 + 5], [-1, -(2**63), 2**63 - 1],
    [2**63, 2**64, 2**64 + 1], [-(2**70), 3, 2**100 + 2**40], [P60] * 9,
])
def test_power_limbs_exact(powers):
    """The limbs give back every power, and their sums the exact total,
    through the device step's tally on the CPU."""
    limbs = sh.power_limbs(powers)
    assert limbs.dtype == np.int64 and limbs.shape[1] == len(powers)
    assert np.abs(limbs).max() < 2**32
    for i, p in enumerate(powers):
        assert sh.combine_limbs(limbs[:, i]) == p
    n = len(powers)
    ok = torch.ones(n, dtype=torch.bool)
    keep = torch.tensor([i % 2 == 0 for i in range(n)])
    mask, sums = sh.tally_lanes(keep, torch.from_numpy(limbs), ok)
    assert sh.readback(mask, sums)[1] == sum(powers[::2])
