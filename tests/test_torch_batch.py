"""The port's batch verifier (tmtpu_torch/crypto/batch.py), key objects and
vote sign bytes against the reference's CPUBatchVerifier, keys and
Vote.sign_bytes, on the CPU."""

import numpy as np
import pytest
import torch

from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import ed25519 as jed
from tmtpu.types.block import BlockID
from tmtpu.types.vote import PRECOMMIT as J_PRECOMMIT
from tmtpu.types.vote import PREVOTE as J_PREVOTE
from tmtpu.types.vote import Vote
from tmtpu_torch.crypto import batch
from tmtpu_torch.crypto import ed25519 as ed
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.types import vote as tvote

CHAIN_ID = "test-chain-port"
HASH = bytes(range(32))
PARTS = bytes(range(32, 64))


@pytest.fixture(autouse=True)
def _fresh_port_sigcache():
    """Every test starts on an empty, enabled port signature cache: the
    cache is process-wide, so a corpus verified by an earlier test would
    otherwise come back as hits and launch nothing."""
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    yield
    sigcache.DEFAULT.invalidate_all()


@pytest.mark.parametrize("case", [
    (tvote.PRECOMMIT, 1, 0, (HASH, 1, PARTS), 1_700_000_000_123_456_789, CHAIN_ID),
    (tvote.PREVOTE, 12345, 3, (HASH, 7, PARTS), 0, CHAIN_ID),
    (tvote.PRECOMMIT, 2**40, 0, (b"", 0, b""), 5, "c"),
    (tvote.PREVOTE, 0, 0, (b"", 0, b""), -62135596800 * 10**9, ""),
    (tvote.PRECOMMIT, 9, 2**31, (HASH, 0, b""), -1, CHAIN_ID),
])
def test_vote_sign_bytes_match_reference(case):
    type_, height, round_, bid, ts, chain = case
    vote = Vote(type_, height, round_, BlockID(*bid), ts, b"\x00" * 20, 0)
    assert tvote.vote_sign_bytes(chain, type_, height, round_, bid, ts) == \
        vote.sign_bytes(chain)


def test_vote_type_constants_match_reference():
    assert (tvote.PREVOTE, tvote.PRECOMMIT) == (J_PREVOTE, J_PRECOMMIT)


def test_keys_match_reference():
    seed = bytes(range(7, 39))
    port, refk = ed.PrivKeyEd25519(seed), jed.PrivKeyEd25519(seed)
    assert port.bytes() == refk.bytes()
    assert port.pub_key().bytes() == refk.pub_key().bytes()
    assert port.type_value() == refk.type_value() == batch.ED25519
    sig = port.sign(b"vote")
    assert sig == refk.sign(b"vote")  # ed25519 signing is deterministic
    assert port.pub_key().verify_signature(b"vote", sig)
    assert not port.pub_key().verify_signature(b"vote!", sig)


def _vote_set(n=64):
    """n validators' precommits: corrupted signatures, a wrong-message lane,
    nil votes and a short signature among good lanes."""
    rng = np.random.default_rng(31)
    items = []
    for i in range(n):
        seed = rng.bytes(32)
        bid = (b"", 0, b"") if i % 9 == 4 else (HASH, 1, PARTS)
        msg = tvote.vote_sign_bytes(CHAIN_ID, tvote.PRECOMMIT, 5, 0, bid,
                                    1_700_000_000_000_000_000 + i)
        sig = ed.PrivKeyEd25519(seed).sign(msg)
        if i % 7 == 3:
            sig = bytes([sig[0] ^ 0xFF]) + sig[1:]
        if i == 10:
            msg = msg + b"x"
        if i == 20:
            sig = sig[:40]
        items.append((seed, msg, sig, int(rng.integers(1, 1000))))
    return items


@pytest.mark.parametrize("tally", [True, False])
def test_verifier_matches_reference_cpu_verifier(tally):
    items = _vote_set()
    port = batch.TorchBatchVerifier(device="cpu")
    refv = jbatch.CPUBatchVerifier()
    for seed, msg, sig, power in items:
        port.add(ed.PrivKeyEd25519(seed).pub_key(), msg, sig, power)
        refv.add(jed.PrivKeyEd25519(seed).pub_key(), msg, sig, power)
    assert port.count() == len(port) == len(items)
    if tally:
        got, want = port.verify_tally(), refv.verify_tally()
        assert got == want
        mask = np.array(want[1])
        words = (np.concatenate([mask, np.zeros(-len(mask) % 32, bool)])
                 .reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)
        np.testing.assert_array_equal(port.bit_words, words.astype(np.uint32))
    else:
        assert port.verify() == refv.verify()
    assert not all(port.verify()[1]) and any(port.verify()[1])


def test_empty_verifier():
    v = batch.new_batch_verifier(device="cpu")
    assert v.verify() == (True, [])
    assert v.verify_tally() == (True, [], 0)


def test_new_batch_verifier_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.new_batch_verifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.TorchBatchVerifier(device="cuda")


class _Key:
    def __init__(self, kind):
        self.kind = kind

    def type_value(self):
        return self.kind

    def bytes(self):
        return bytes(32)


@pytest.mark.parametrize("kind", [batch.SR25519, batch.SECP256K1])
def test_curve_lanes_beside_ed25519_match_reference(kind):
    """ed25519 lanes and one other curve's lanes in one verifier: one
    dispatch per curve, and mask, tally and bitarray as the reference's."""
    from tests.test_torch_mixed import _words, mixed_items, run_both

    items = mixed_items([batch.ED25519, kind], n=14, seed=43)
    port, got, want = run_both(items, tally=True)
    assert got == want
    assert any(want[1]) and not all(want[1])
    np.testing.assert_array_equal(port.bit_words, _words(want[1]).astype(np.uint32))


def test_unknown_key_type_raises():
    v = batch.TorchBatchVerifier(device="cpu")
    v.add(_Key("bls12381"), b"m", bytes(64))
    with pytest.raises(ValueError, match="unsupported key type"):
        v.verify_tally()
