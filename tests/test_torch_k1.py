"""The port's secp256k1 verify (tmtpu_torch/gpu/k1_verify.py and
k1_kernel.py) against the JAX reference (tmtpu/tpu/k1_verify.py) and the
serial oracles, on the CPU.

The point routines are compared limb for limb with the reference's, called
eagerly; host prep byte for byte; the plain graph's masks against the
reference package's ``PubKeySecp256k1.verify_signature`` and the port's
own. The plain graph runs once for all corpora together (one call costs
seconds on the CPU, whatever its width). The comparisons with the
reference's XLA graph and Pallas kernel are slow-marked, as
tests/test_tpu_k1.py marks them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmtpu.crypto.secp256k1 import PubKeySecp256k1 as JPubKey
from tmtpu.tpu import k1_verify as jkv
from tmtpu_torch.crypto import secp256k1_ref as k1ref
from tmtpu_torch.gpu import fe_k1 as tfe
from tmtpu_torch.gpu import k1_kernel
from tmtpu_torch.gpu import k1_verify as kv

from tests import torch_corpus as corpus

P = tfe.P_INT


def _lengths():
    pks, msgs, sigs = corpus.k1_signed(5, 33)
    pks[1] = pks[1][:32]
    sigs[2] = sigs[2] + b"\x00"
    pks[3] = b""
    return pks, msgs, sigs


CORPORA = dict(corpus.K1_CORPORA, lengths=_lengths)


@pytest.fixture(scope="module")
def plain_masks():
    """{corpus: final mask} from one batch_verify_k1 call over every corpus
    at once."""
    spans, pks, msgs, sigs = {}, [], [], []
    for name in sorted(CORPORA):
        p, m, s = CORPORA[name]()
        spans[name] = (len(sigs), len(sigs) + len(s))
        pks, msgs, sigs = pks + p, msgs + m, sigs + s
    mask = kv.batch_verify_k1(pks, msgs, sigs, device="cpu")
    return {name: mask[a:b] for name, (a, b) in spans.items()}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_batch_verify_matches_serial_oracles(plain_masks, name):
    pks, msgs, sigs = CORPORA[name]()
    want = np.array([len(p) == 33 and JPubKey(p).verify_signature(m, s)
                     for p, m, s in zip(pks, msgs, sigs)], dtype=bool)
    np.testing.assert_array_equal(plain_masks[name], want)
    np.testing.assert_array_equal(plain_masks[name], corpus.k1_oracle(pks, msgs, sigs))


def test_edge_corpus_reaches_every_edge(plain_masks):
    """k1_edges' lanes decide as built: the rpn branch accepts, its message
    swap and R at infinity reject, the zero-digit lanes accept."""
    pks, msgs, sigs = corpus.k1_edges()
    np.testing.assert_array_equal(plain_masks["edges"], [1, 0, 0, 1, 1, 1, 1])
    packed, ok = kv.prepare_k1_batch_packed(pks, msgs, sigs)
    assert ok.all()
    rpn = int.from_bytes(packed[128:160, 0].tobytes(), "big")
    r = int.from_bytes(packed[96:128, 0].tobytes(), "big")
    assert rpn == r + k1ref.N < P  # lane 0 can only match through r + n
    for lane in (3, 4):
        for rows in (slice(32, 64), slice(64, 96)):  # u1, u2
            digits = kv.digits_msb_device_be(torch.from_numpy(packed[rows, lane:lane + 1]))
            assert int((digits == 0).sum()) >= 50  # mostly zero digits


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_prepare_packed_byte_identical(name):
    pks, msgs, sigs = CORPORA[name]()
    want_packed, want_ok = jkv.prepare_k1_batch_packed(pks, msgs, sigs)
    got_packed, got_ok = kv.prepare_k1_batch_packed(pks, msgs, sigs)
    assert got_packed.dtype == np.uint8 and got_packed.shape == (168, len(sigs))
    for other_packed, other_ok in ((want_packed, want_ok),
                                   kv.prepare_k1_batch_packed_plain(pks, msgs, sigs)):
        np.testing.assert_array_equal(got_packed, other_packed)
        np.testing.assert_array_equal(got_ok, other_ok)


def test_fixed_base_table_matches_reference():
    np.testing.assert_array_equal(kv.fixed_base_table(), jkv.fixed_base_table())


def test_kernel_table_words_encode_small_multiples():
    words = k1_kernel.base_table_words()
    assert words.shape == (16, 3, 8) and words.dtype == np.int32
    val = lambda w: int.from_bytes(w.astype("<i4").tobytes(), "little")  # noqa: E731
    assert [val(w) for w in words[0]] == [0, 1, 0]
    for d in range(1, 16):
        x, y = k1ref.scalar_mult(d)
        assert [val(w) for w in words[d]] == [x, y, 1]


def _points(n=4, seed=3):
    """Projective columns: multiples of G scaled by random Z, the identity,
    and -Q beside Q so that Q + (-Q) is exercised."""
    rng = np.random.default_rng(seed)
    cols = []
    for k in rng.integers(1, 1 << 40, size=n):
        x, y = k1ref.scalar_mult(int(k))
        z = int(rng.integers(2, 1 << 60))
        cols.append((x * z % P, y * z % P, z))
    cols.append((0, 1, 0))
    cols.append((cols[0][0], (-cols[0][1]) % P, cols[0][2]))
    return tuple(np.stack([tfe.limbs_of_int(c[i]) for c in cols], axis=1) for i in range(3))


def _jax(pt):
    return tuple(jnp.asarray(c) for c in pt)


def _torch(pt):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in pt)


def _assert_points_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_add_matches_reference():
    p = _points()
    q = tuple(np.roll(c, 1, axis=1) for c in p)  # includes Q + (-Q) and O + Q
    _assert_points_equal(kv.add(_torch(p), _torch(q)), jkv.add(_jax(p), _jax(q)))
    _assert_points_equal(kv.add(_torch(p), _torch(p)), jkv.add(_jax(p), _jax(p)))


def test_double_matches_reference():
    p = _points(seed=4)
    _assert_points_equal(kv.double(_torch(p)), jkv.double(_jax(p)))


def test_decompress_matches_reference():
    pks = [p for p in corpus.k1_adversarial()[0] + corpus.k1_edges()[0]
           if len(p) == 33 and p[0] in (2, 3)]
    x = np.stack([np.frombuffer(p[1:], dtype=np.uint8) for p in pks], axis=1)
    parity = np.array([p[0] & 1 for p in pks], dtype=np.int32)
    xl = tfe.pack_bytes_device(torch.from_numpy(x))
    got_pt, got_ok = kv.decompress(xl, torch.from_numpy(parity))
    want_pt, want_ok = jkv.decompress(jnp.asarray(xl.numpy()), jnp.asarray(parity))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not got_ok.all()  # the x = 0 lane has no square root
    _assert_points_equal(got_pt, want_pt)


def test_digits_msb_be_matches_reference():
    s = np.random.default_rng(8).integers(0, 256, size=(32, 6), dtype=np.uint8)
    got = kv.digits_msb_device_be(torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jkv.digits_msb_device_be(jnp.asarray(s))))


def test_inverses_mod_n():
    vals = [1, 2, 3, k1ref.N - 1, 12345678901234567890]
    assert kv._inverses_mod_n(vals) == [pow(v, -1, k1ref.N) for v in vals]
    assert kv._inverses_mod_n([]) == []


def test_empty_batch():
    assert kv.batch_verify_k1([], [], [], device="cpu").shape == (0,)


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pks, msgs, sigs = corpus.k1_signed(1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv.batch_verify_k1(pks, msgs, sigs)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["adversarial", "edges"])
def test_matches_reference_xla_graph(name):
    """Final masks equal the reference's batch_verify_k1, and the raw
    device masks its XLA graph's on the reference's padded plane."""
    from tmtpu.tpu import verify as jtv

    pks, msgs, sigs = CORPORA[name]()
    np.testing.assert_array_equal(kv.batch_verify_k1(pks, msgs, sigs, device="cpu"),
                                  jkv.batch_verify_k1(pks, msgs, sigs))
    packed, _ = kv.prepare_k1_batch_packed(pks, msgs, sigs)
    packed = jtv.pad_packed(packed, jtv._pad_to_bucket(len(sigs)))
    want = np.asarray(jkv._k1_verify_packed_jit(jnp.asarray(packed), jkv.base_table_f32()))
    got = k1_kernel.verify_packed(torch.from_numpy(np.ascontiguousarray(packed)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.slow
def test_matches_pallas_kernel_interpret():
    """The plain graph against the Pallas kernel itself, in interpret mode
    (minutes of XLA:CPU compile)."""
    from tmtpu.tpu import k1_kernel as jkk
    from tmtpu.tpu import verify as jtv

    pks, msgs, sigs = corpus.k1_edges()
    packed, _ = kv.prepare_k1_batch_packed(pks, msgs, sigs)
    packed = jtv.pad_packed(packed, 8)
    planes, parity = jkv.split_packed_k1(jnp.asarray(packed))
    want = np.asarray(jkk.k1_verify_compact_kernel(planes[0], parity, *planes[1:],
                                                   tile=8, interpret=True))
    got = k1_kernel.verify_packed(torch.from_numpy(np.ascontiguousarray(packed)))
    np.testing.assert_array_equal(got.numpy(), want)
