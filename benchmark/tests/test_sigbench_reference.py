"""The benchmark's plain ed25519 reference on valid and corrupted lanes."""

import random

import pytest
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

from benchmark.pools import ed25519_votes
from benchmark.reference import ed25519 as ref
from tmtpu_torch.crypto import ed25519_ref as port_oracle

# RFC 8032 §7.1, TEST 1 and TEST 2
RFC = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
]


def _lanes(n, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        key = Ed25519PrivateKey.from_private_bytes(rng.randbytes(32))
        pk = key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        msg = rng.randbytes(rng.randrange(0, 200))
        out.append((pk, msg, key.sign(msg)))
    return out


@pytest.mark.parametrize("seed_hex,pk_hex,msg_hex,sig_hex", RFC)
def test_rfc8032_vectors(seed_hex, pk_hex, msg_hex, sig_hex):
    pk, msg, sig = bytes.fromhex(pk_hex), bytes.fromhex(msg_hex), bytes.fromhex(sig_hex)
    key = Ed25519PrivateKey.from_private_bytes(bytes.fromhex(seed_hex))
    assert key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw) == pk
    assert key.sign(msg) == sig
    assert ref.verify(pk, msg, sig)
    assert not ref.verify(pk, msg + b"\x00", sig)


def test_valid_lanes_pass_and_every_flip_fails():
    rng = random.Random(7)
    for pk, msg, sig in _lanes(12, 1):
        assert ref.verify(pk, msg, sig)
        for _ in range(4):
            bad = ed25519_votes.corrupt(sig, rng)
            assert bad != sig and not ref.verify(pk, msg, bad)
        assert not ref.verify(pk, msg + b"\x01", sig)


def test_non_canonical_s_and_bad_sizes_fail():
    pk, msg, sig = _lanes(1, 2)[0]
    s = int.from_bytes(sig[32:], "little") + ref.L
    assert s < 2 ** 256
    assert not ref.verify(pk, msg, sig[:32] + s.to_bytes(32, "little"))
    assert not ref.verify(pk[:31], msg, sig)
    assert not ref.verify(pk, msg, sig[:63])


def test_agrees_with_the_ports_oracle():
    rng = random.Random(3)
    lanes = _lanes(10, 3)
    lanes += [(pk, m, ed25519_votes.corrupt(s, rng)) for pk, m, s in lanes[:6]]
    for pk, msg, sig in lanes:
        assert ref.verify(pk, msg, sig) == port_oracle.verify(pk, msg, sig)


def test_pool_signs_canonical_votes():
    cfg = {"validators": 3, "chain_heights": 2, "vote_types": ["prevote", "precommit"],
           "chain_id": "c", "chain_seed": 1, "first_height": 10, "genesis_time_ns": 10 ** 18,
           "power_min": 1, "power_max": 10 ** 12}
    pool = ed25519_votes.Pool(cfg, workers=1)
    from tmtpu_torch.types.vote import vote_sign_bytes

    for e in range(pool.size):
        slot, rest = divmod(e, 2 * 3)
        vt, i = divmod(rest, 3)
        assert pool.validator_of(e) == i
        msg = ed25519_votes.sign_bytes(cfg, slot, cfg["vote_types"][vt], i)
        assert pool.msgs[e] == msg
        assert ref.verify(pool.pks[i], msg, pool.sigs[e])
    block = (b"h" * 32, 1, b"p" * 32)
    for t in (1, 2):
        assert (ed25519_votes.vote_sign_bytes("chain", t, 12345, 0, block, 1_700_000_000_123)
                == vote_sign_bytes("chain", t, 12345, 0, block, 1_700_000_000_123))
    assert 0 < sum(pool.powers) < 2 ** 63
