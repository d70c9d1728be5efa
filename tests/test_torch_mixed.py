"""The port's batch verifier on a mixed-curve validator set
(tmtpu_torch/crypto/batch.py) against the reference's CPUBatchVerifier
(tmtpu/crypto/batch.py), on the CPU: ed25519, sr25519 and secp256k1 lanes
interleaved in one ``add`` order, with corrupted signatures, a wrong
message and a short signature on each curve, and random powers. The mask,
the tally and the bitarray words must equal the reference's."""

import hashlib

import numpy as np
import pytest

from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import ed25519 as jed
from tmtpu.crypto import secp256k1 as jk1
from tmtpu.crypto import sr25519 as jsr
from tmtpu_torch.crypto import batch
from tmtpu_torch.crypto import ed25519 as ed
from tmtpu_torch.crypto import secp256k1 as k1
from tmtpu_torch.crypto import sr25519 as sr

CURVES = {
    batch.ED25519: (ed.PrivKeyEd25519, jed.PrivKeyEd25519),
    batch.SR25519: (sr.PrivKeySr25519, jsr.PrivKeySr25519),
    batch.SECP256K1: (k1.PrivKeySecp256k1, jk1.PrivKeySecp256k1),
}


def _secret(kind, i):
    v = int.from_bytes(hashlib.sha256(b"%s-%d" % (kind.encode(), i)).digest(), "big")
    return (v % (k1.N - 1) + 1).to_bytes(32, "big")  # a valid key on every curve


def mixed_items(kinds, n=24, seed=41):
    """(port key, reference key, msg, sig, power) per lane; lane i's curve
    is kinds[i % len(kinds)]. Per curve, the second lane's signature is
    corrupted, the fourth signs another message and the sixth is short."""
    rng = np.random.default_rng(seed)
    items, seen = [], {}
    for i in range(n):
        kind = kinds[i % len(kinds)]
        j = seen[kind] = seen.get(kind, -1) + 1
        port_cls, ref_cls = CURVES[kind]
        secret = _secret(kind, i)
        priv = port_cls(secret)
        msg = rng.bytes(48)
        sig = priv.sign(msg)
        if j == 1:
            sig = bytes([sig[0] ^ 0xFF]) + sig[1:]
        if j == 3:
            msg = msg + b"?"
        if j == 5:
            sig = sig[:40]
        items.append((priv.pub_key(), ref_cls(secret).pub_key(), msg, sig,
                      int(rng.integers(1, 1000))))
    return items


def _words(mask):
    m = np.concatenate([np.asarray(mask, dtype=bool), np.zeros(-len(mask) % 32, bool)])
    return (m.reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)


def run_both(items, tally):
    port = batch.TorchBatchVerifier(device="cpu")
    refv = jbatch.CPUBatchVerifier()
    for port_key, ref_key, msg, sig, power in items:
        port.add(port_key, msg, sig, power)
        refv.add(ref_key, msg, sig, power)
    if tally:
        return port, port.verify_tally(), refv.verify_tally()
    return port, port.verify(), refv.verify()


@pytest.mark.parametrize("tally", [True, False])
def test_mixed_verifier_matches_reference_cpu_verifier(tally):
    items = mixed_items([batch.ED25519, batch.SR25519, batch.ED25519, batch.SECP256K1])
    for port_key, ref_key, *_ in items:
        assert port_key.bytes() == ref_key.bytes()
        assert port_key.type_value() == ref_key.type_value()
    port, got, want = run_both(items, tally)
    assert got == want
    mask = want[1]
    assert not all(mask) and any(mask)
    for kind in CURVES:  # every curve has good and rejected lanes
        lanes = [ok for it, ok in zip(items, mask) if it[0].type_value() == kind]
        assert any(lanes) and not all(lanes)
    if tally:
        np.testing.assert_array_equal(port.bit_words, _words(mask).astype(np.uint32))
