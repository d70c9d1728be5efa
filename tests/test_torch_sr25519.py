"""The port's sr25519 path (tmtpu_torch/crypto/{merlin,ristretto,sr25519}.py
and tmtpu_torch/gpu/sr_verify.py) against the JAX reference
(tmtpu/crypto/{merlin,ristretto,sr25519}.py, tmtpu/tpu/sr_verify.py) and
the serial oracles, on the CPU.

Merlin challenges, keys, signatures and host prep are compared byte for
byte; the batched ristretto decode and coset equality limb for limb with
the reference's, called eagerly; the plain graph's masks against the
reference package's ``PubKeySr25519.verify_signature`` and the port's own.
The plain graph runs once for all corpora together. The comparisons with
the reference's XLA graph and Pallas kernel are slow-marked, as
tests/test_tpu_sr25519.py marks them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmtpu.crypto import ristretto as jrist
from tmtpu.crypto import sr25519 as jsr
from tmtpu.tpu import sr_verify as jsv
from tmtpu_torch.crypto import ristretto, sr25519
from tmtpu_torch.gpu import fe, kernel
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv

from tests import torch_corpus as corpus


def _lengths():
    pks, msgs, sigs = corpus.sr_signed(5, 34)
    pks[1] = pks[1][:31]
    sigs[2] = sigs[2] + b"\x00"
    sigs[3] = b""
    return pks, msgs, sigs


CORPORA = dict(corpus.SR_CORPORA, lengths=_lengths)


@pytest.fixture(scope="module")
def plain_masks():
    """{corpus: final mask} from one batch_verify_sr call over every corpus
    at once."""
    spans, pks, msgs, sigs = {}, [], [], []
    for name in sorted(CORPORA):
        p, m, s = CORPORA[name]()
        spans[name] = (len(sigs), len(sigs) + len(s))
        pks, msgs, sigs = pks + p, msgs + m, sigs + s
    mask = sv.batch_verify_sr(pks, msgs, sigs, device="cpu")
    return {name: mask[a:b] for name, (a, b) in spans.items()}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_batch_verify_matches_serial_oracles(plain_masks, name):
    pks, msgs, sigs = CORPORA[name]()
    want = np.array([len(p) == 32 and jsr.PubKeySr25519(p).verify_signature(m, s)
                     for p, m, s in zip(pks, msgs, sigs)], dtype=bool)
    np.testing.assert_array_equal(plain_masks[name], want)
    np.testing.assert_array_equal(plain_masks[name], corpus.sr_oracle(pks, msgs, sigs))


@pytest.mark.parametrize("msg_len", [0, 1, 100, 120, 121, 166, 167, 300, 1000])
def test_merlin_challenge_matches_reference(msg_len):
    """Message lengths around the STROBE rate (166 bytes) and the transcript
    framing put block boundaries at every point of the walk."""
    rng = np.random.default_rng(msg_len)
    pk, r, msg = rng.bytes(32), rng.bytes(32), rng.bytes(msg_len)
    assert sr25519.challenge_k(pk, msg, r).to_bytes(32, "little") == jsv._challenge_k(pk, msg, r)


@pytest.mark.parametrize("i", range(3))
def test_keys_and_signatures_match_reference(i):
    secret = b"port-sr-%d" % i
    port, refk = sr25519.gen_priv_key_from_secret(secret), jsr.gen_priv_key_from_secret(secret)
    assert port.bytes() == refk.bytes()
    assert port.pub_key().bytes() == refk.pub_key().bytes()
    assert port.type_value() == refk.type_value() == "sr25519"
    msg = b"vote %d" % i
    sig = port.sign(msg)
    assert sig == refk.sign(msg)  # both derive the witness rng from nonce and msg
    assert port.pub_key().verify_signature(msg, sig)
    assert not port.pub_key().verify_signature(msg + b"!", sig)


def test_ristretto_matches_reference():
    encs = [ristretto.encode(ristretto.scalar_mult(k, ristretto.BASEPOINT)) for k in range(8)]
    assert encs == [jrist.encode(jrist.scalar_mult(k, jrist.BASEPOINT)) for k in range(8)]
    bad = [(2).to_bytes(32, "little"), (1).to_bytes(32, "little"),
           (2**255 - 19).to_bytes(32, "little"), b"\xff" * 32, bytes(31)]
    for enc in encs + bad:
        got, want = ristretto.decode(enc), jrist.decode(enc)
        assert (got is None) == (want is None)
        if got is not None:
            assert got == want
            assert ristretto.equals(got, want) and ristretto.encode(got) == enc


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_prepare_packed_byte_identical(name):
    pks, msgs, sigs = CORPORA[name]()
    want_packed, want_ok = jsv.prepare_sr_batch_packed(pks, msgs, sigs)
    got_packed, got_ok = sv.prepare_sr_batch_packed(pks, msgs, sigs)
    assert got_packed.dtype == np.uint8 and got_packed.shape == (128, len(sigs))
    np.testing.assert_array_equal(got_packed, want_packed)
    np.testing.assert_array_equal(got_ok, want_ok)


def _encodings():
    """A and R of the adversarial corpus as the device sees them, the
    identity, and even values below p that decode to no point."""
    pks, msgs, sigs = corpus.sr_adversarial()
    packed, _ = sv.prepare_sr_batch_packed(pks, msgs, sigs)
    extra = np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
                      for v in (0, 2, 4, 2**254)], axis=1)
    return np.concatenate([packed[0:32], packed[32:64], extra], axis=1)


def test_ristretto_decompress_matches_reference():
    s = fe.pack_bytes_device(torch.from_numpy(_encodings()))
    got_pt, got_ok = sv.ristretto_decompress(s)
    want_pt, want_ok = jsv.ristretto_decompress(jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert got_ok.any() and not got_ok.all()
    for g, w in zip(got_pt, want_pt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ristretto_equal_matches_reference():
    s = fe.pack_bytes_device(torch.from_numpy(_encodings()))
    pt, _ = sv.ristretto_decompress(s)
    shifted = tuple(torch.roll(c, 1, dims=1) for c in pt)
    doubled = tuple(c.clone() for c in pt)
    for a, b in ((pt, pt), (pt, shifted), (pt, doubled)):
        got = sv.ristretto_equal(a, b)
        want = jsv.ristretto_equal(tuple(jnp.asarray(c.numpy()) for c in a),
                                   tuple(jnp.asarray(c.numpy()) for c in b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sv.ristretto_equal(pt, pt).all()


def test_empty_batch():
    assert sv.batch_verify_sr([], [], [], device="cpu").shape == (0,)


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pks, msgs, sigs = corpus.sr_signed(1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.batch_verify_sr(pks, msgs, sigs)


@pytest.mark.slow
def test_matches_reference_xla_graph():
    """Final masks equal the reference's batch_verify_sr, and the raw device
    masks its XLA graph's on the reference's padded plane."""
    from tmtpu.tpu import verify as jtv

    pks, msgs, sigs = corpus.sr_adversarial()
    np.testing.assert_array_equal(sv.batch_verify_sr(pks, msgs, sigs, device="cpu"),
                                  jsv.batch_verify_sr(pks, msgs, sigs))
    packed, _ = sv.prepare_sr_batch_packed(pks, msgs, sigs)
    packed = jtv.pad_packed(packed, jtv._pad_to_bucket(len(sigs)))
    want = np.asarray(jsv._sr_verify_packed_jit(jnp.asarray(packed), jtv.base_table_f32()))
    got = kernel.sr_verify_packed(torch.from_numpy(np.ascontiguousarray(packed)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.slow
def test_matches_pallas_kernel_interpret():
    """The plain graph against the Pallas kernel itself, in interpret mode
    (minutes of XLA:CPU compile)."""
    from tmtpu.tpu import kernel as jtk
    from tmtpu.tpu import verify as jtv

    pks, msgs, sigs = corpus.sr_adversarial()
    packed, _ = sv.prepare_sr_batch_packed(pks, msgs, sigs)
    packed = jtv.pad_packed(packed, 16)
    want = np.asarray(jtk.sr_verify_compact_kernel(
        *[jnp.asarray(p) for p in jtv.split_packed(packed)], tile=16, interpret=True))
    got = sv.sr_verify_core_compact(*tv.split_packed(torch.from_numpy(packed)),
                                    tv.base_table("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
