"""The port's C host prep (tmtpu_torch/native) byte for byte against the
reference package's C host prep (tmtpu/native) and the port's plain Python
prep (``prepare_batch_packed_plain``, ``prepare_sr_batch_packed_plain``),
with 1, 3 and 8 threads: empty and one-lane batches, messages of 0-300
bytes across the SHA-512 padding edges and the STROBE rate, and the
adversarial corpora of tests/torch_corpus.py. The secp256k1 prep
(``prep_k1``) is held against ``prepare_k1_batch_packed_plain`` and the
reference package's Python prep with 1, 3, 8 and 16 threads. A build
that fails raises. The reduction mod L alone (``reduce_mod_l_for_tests``)
is held against Python's ``int % L`` on constructed and random 512-bit
values, and its Barrett constants and bound are derived from L; the
arithmetic mod the secp256k1 order (``mod_n_for_tests``) likewise, with
its fold bound derived from n."""

import hashlib
import re
from fractions import Fraction

import numpy as np
import pytest

from tests import torch_corpus as corpus
from tmtpu import native as jnative
from tmtpu.tpu import k1_verify as jkv
from tmtpu.tpu import sr_verify as jsv
from tmtpu.tpu import verify as jtv
from tmtpu_torch import native
from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.crypto import lanes
from tmtpu_torch.crypto.sr25519 import challenge_k, gen_priv_key_from_secret
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv

THREADS = [1, 3, 8]

# R || A || M of 111, 112, 127, 128, 239 and 240 bytes straddle SHA-512's
# padding; 165, 166, 167 and 332-byte messages straddle STROBE's 166-byte rate
EDGE_LENGTHS = [0, 1, 47, 48, 63, 64, 165, 166, 167, 175, 176, 300, 332]


def _ed_edges():
    rng = np.random.default_rng(5)
    seeds = [rng.bytes(32) for _ in EDGE_LENGTHS]
    msgs = [rng.bytes(n) for n in EDGE_LENGTHS]
    return ([ref.public_key(s) for s in seeds], msgs,
            [ref.sign(s, m) for s, m in zip(seeds, msgs)])


def _sr_edges():
    rng = np.random.default_rng(6)
    keys = [gen_priv_key_from_secret(rng.bytes(16)) for _ in EDGE_LENGTHS]
    msgs = [rng.bytes(n) for n in EDGE_LENGTHS]
    return ([k.pub_key().bytes() for k in keys], msgs,
            [k.sign(m) for k, m in zip(keys, msgs)])


ED_CORPORA = {**corpus.CORPORA, "edges": _ed_edges, "empty": lambda: ([], [], []),
              "one": lambda: corpus.signed(1, 3)}
SR_CORPORA = {**corpus.SR_CORPORA, "edges": _sr_edges, "empty": lambda: ([], [], []),
              "one": lambda: corpus.sr_signed(1, 4)}


def _random_rows(n, seed):
    """n lanes of random pk, r and s rows (a third of s below L) and
    messages of n different lengths."""
    rng = np.random.default_rng(seed)
    pk, r, s = (rng.integers(0, 256, (n, 32), dtype=np.uint8) for _ in range(3))
    s[::3, 31] &= 0x0F
    return pk, r, s, [rng.bytes(i) for i in range(n)]


def _y_ok(pk):
    """A.y < p on the sign-masked encoding, a lane a row."""
    y = [int.from_bytes(row.tobytes(), "little") & ((1 << 255) - 1) for row in pk]
    return np.array([v < 2**255 - 19 for v in y], dtype=bool)


@pytest.mark.parametrize("nthreads", THREADS)
@pytest.mark.parametrize("n", [0, 1, 301])
def test_prep_ed25519_equals_reference_and_hashlib(n, nthreads):
    """The plane's h rows equal the reference's C entry and hashlib, its s
    rows the signatures' s where s < L and zero elsewhere, and the host
    verdicts the reference's s < L with A.y < p."""
    pk, r, s, msgs = _random_rows(n, 11 + n)
    pk[:3, 1:31], pk[:3, 31] = 0xFF, 0x7F  # A.y = p - 19 + pk[0]: p and past
    pk[:3, 0] = [0xEC, 0xED, 0xFF][:n]
    pks = [row.tobytes() for row in pk]
    sigs = [a.tobytes() + b.tobytes() for a, b in zip(r, s)]
    packed, ok = native.prep_ed25519(lanes.ByteColumn.join(pks), msgs, sigs,
                                     nthreads=nthreads)
    want_h, want_ok = jnative.prep_ed25519(pk, r, s, msgs, nthreads=nthreads)
    h = packed[96:128].T
    np.testing.assert_array_equal(h, want_h)
    np.testing.assert_array_equal(ok, want_ok & _y_ok(pk))
    np.testing.assert_array_equal(packed[0:32].T, pk)
    np.testing.assert_array_equal(packed[32:64].T, r)
    np.testing.assert_array_equal(packed[64:96].T, np.where(want_ok[:, None], s, 0))
    assert n < 3 or ok[:3].tolist() == [want_ok[0], False, False]
    for i in range(n):
        d = hashlib.sha512(r[i].tobytes() + pk[i].tobytes() + msgs[i]).digest()
        assert h[i].tobytes() == (int.from_bytes(d, "little") % ref.L).to_bytes(32, "little")
        assert want_ok[i] == (int.from_bytes(s[i].tobytes(), "little") < ref.L)


@pytest.mark.parametrize("nthreads", THREADS)
@pytest.mark.parametrize("n", [0, 1, 301])
def test_sr_challenges_equal_reference(n, nthreads):
    pk, r, _, msgs = _random_rows(n, 12 + n)
    k = native.sr_challenges(pk, r, msgs, nthreads=nthreads)
    np.testing.assert_array_equal(k, jnative.sr_challenges(pk, r, msgs, nthreads=nthreads))
    if nthreads == 1:  # the pure-Python merlin once per width
        for i in range(n):
            assert k[i].tobytes() == challenge_k(pk[i].tobytes(), msgs[i],
                                                 r[i].tobytes()).to_bytes(32, "little")


@pytest.mark.parametrize("name", sorted(ED_CORPORA))
def test_ed25519_prep_on_corpora(name):
    """The packed plane and host verdicts equal the plain prep's and the
    reference's; the C entry equals the reference's at every thread count."""
    pks, msgs, sigs = ED_CORPORA[name]()
    packed, ok = tv.prepare_batch_packed(pks, msgs, sigs)
    for other in (tv.prepare_batch_packed_plain, jtv.prepare_batch_packed):
        want_packed, want_ok = other(pks, msgs, sigs)
        np.testing.assert_array_equal(packed, want_packed)
        np.testing.assert_array_equal(ok, want_ok)
    len_ok, pk, r, s = tv.host_lanes(pks, sigs)
    for nthreads in THREADS:
        got_packed, got_ok = native.prep_ed25519(pks, msgs, sigs, nthreads=nthreads)
        want_h, want_ok = jnative.prep_ed25519(pk, r, s, msgs, nthreads=nthreads)
        np.testing.assert_array_equal(got_packed, packed)
        np.testing.assert_array_equal(got_ok, ok)
        np.testing.assert_array_equal(want_h.T, packed[96:128])
        np.testing.assert_array_equal(ok, len_ok & want_ok & _y_ok(pk))


@pytest.mark.parametrize("name", sorted(SR_CORPORA))
def test_sr25519_prep_on_corpora(name):
    """The same for sr25519; rejected lanes (no marker, s >= L, odd or
    out-of-range encodings, wrong lengths) carry the challenge of zero
    bytes."""
    pks, msgs, sigs = SR_CORPORA[name]()
    packed, ok = sv.prepare_sr_batch_packed(pks, msgs, sigs)
    for other in (sv.prepare_sr_batch_packed_plain, jsv.prepare_sr_batch_packed):
        want_packed, want_ok = other(pks, msgs, sigs)
        np.testing.assert_array_equal(packed, want_packed)
        np.testing.assert_array_equal(ok, want_ok)
    pk = np.ascontiguousarray(packed[0:32].T)
    r = np.ascontiguousarray(packed[32:64].T)
    for nthreads in THREADS:
        k = native.sr_challenges(pk, r, msgs, nthreads=nthreads)
        np.testing.assert_array_equal(k, jnative.sr_challenges(pk, r, msgs, nthreads=nthreads))
        np.testing.assert_array_equal(k.T, packed[96:128])


def test_adversarial_corpora_reach_the_rejections():
    """The corpora above hold what they are meant to: wrong lengths, s >= L
    and non-canonical keys for ed25519; a cleared marker for sr25519."""
    _, ok = tv.prepare_batch_packed(*corpus.adversarial())
    assert not ok[4] and not ok[5] and not ok[8]
    _, ok = tv.prepare_batch_packed(*corpus.lengths())
    assert ok.tolist() == [True, False, False, False, False, True]
    _, ok = sv.prepare_sr_batch_packed(*corpus.sr_adversarial())
    assert not ok[5] and not ok[9]


def test_rows_are_checked_before_the_call():
    """Columns of different lengths raise before any C call; a key or
    signature of the wrong length is a lane the host refuses, not an
    error."""
    with pytest.raises(ValueError, match="expected 2 byte strings, got 1"):
        native.prep_ed25519([bytes(32)], [b"", b""], [bytes(64)] * 2)
    with pytest.raises(ValueError, match="expected 2 byte strings"):
        native.cache_keys(["ed25519", "ed25519"], [b"", b""], [b""], [b"", b""])
    with pytest.raises(ValueError, match="expected 2 curve names"):
        native.cache_keys(["ed25519"], [b"", b""], [b"", b""], [b"", b""])
    packed, ok = native.prep_ed25519([bytes(31), bytes(32)], [b"", b""],
                                     [bytes(64), bytes(63)])
    assert ok.tolist() == [False, False] and not packed[:96].any()


def test_no_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.build(out_dir=str(tmp_path / "fresh"))


def test_failed_compile_raises_with_the_compiler_message(tmp_path):
    bad = tmp_path / "bad.c"
    bad.write_text("int broken(void) { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(src=str(bad), out_dir=str(tmp_path / "out"))
    assert not list((tmp_path / "out").iterdir())  # no partial library left


def test_missing_symbol_raises(monkeypatch, tmp_path):
    """A library without the sr25519 entry, or with every entry but the
    secp256k1 prep, does not load."""
    stubs = {"tmtpu_sr_challenges": ["tmtpu_prep_ed25519"],
             "tmtpu_prep_k1": [name for name in native._SIGNATURES if name != "tmtpu_prep_k1"]}
    paths = {}
    for missing, names in stubs.items():
        stub = tmp_path / f"{missing}.c"
        stub.write_text("".join(f"void {name}(void) {{}}\n" for name in names))
        paths[missing] = native.build(src=str(stub), out_dir=str(tmp_path))
    for missing, path in paths.items():
        monkeypatch.setattr(native, "build", lambda path=path: path)
        monkeypatch.setattr(native, "_lib", None)
        with pytest.raises(AttributeError, match=missing):
            native.load()


def test_main_path_prep_has_no_other_version(monkeypatch):
    """When the C library cannot load, host prep raises; it does not fall
    back to the Python prep."""
    def fail():
        raise RuntimeError("no host prep library")

    monkeypatch.setattr(native, "load", fail)
    with pytest.raises(RuntimeError, match="no host prep library"):
        tv.prepare_batch_packed(*corpus.signed(2, 1))
    with pytest.raises(RuntimeError, match="no host prep library"):
        sv.prepare_sr_batch_packed(*corpus.sr_signed(2, 1))
    with pytest.raises(RuntimeError, match="no host prep library"):
        kv.prepare_k1_batch_packed(*corpus.k1_signed(2, 1))


def test_library_is_built_from_the_port_source():
    assert native.SRC.endswith("tmtpu_torch/native/hostprep.c")
    assert native.lib_path().startswith(native.BUILD_DIR)
    assert "tmtpu_torch/gpu/build/host" in native.BUILD_DIR.replace("\\", "/")


def test_library_name_follows_the_toolchain(monkeypatch):
    """A library built by another compiler, or for another machine or C
    library, has another name, so it is never loaded here."""
    here = native.lib_path()
    monkeypatch.setattr(native, "_toolchain", lambda cmd: "another compiler 1.0\naarch64")
    assert native.lib_path() != here


# ed25519's group order, the modulus of the prep's reduction
L = 2**252 + 27742317777372353535851937790883648493


def _c_int(name):
    """``#define name <integer>`` of hostprep.c."""
    with open(native.SRC) as fh:
        return int(re.search(rf"#define {name} (\d+)", fh.read()).group(1))


def _c_constant(name):
    """``static const uint64_t name[]`` of hostprep.c as one integer (the
    limbs are little-endian)."""
    with open(native.SRC) as fh:
        src = fh.read()
    body = re.search(rf"static const uint64_t {name}\[\d+\] = \{{(.*?)\}};", src, re.S).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-fA-F]+)ULL", body)]
    return sum(w << (64 * i) for i, w in enumerate(words))


def _subtractions(x, mu):
    """How many subtractions of L the C code's remainder x - q^ L needs,
    with its estimate q^ = floor(floor(x / 2^192) mu / 2^320)."""
    return (x - (((x >> 192) * mu) >> 320) * L) // L


def _near(k):
    return [k * L + d for d in (-1, 0, 1, 2)]


_KMAX = (2**512 - 1) // L


def _low_ones(x):
    """x with its low 192 bits all ones (x0 at its largest)."""
    return x | (2**192 - 1)


_RANDOM = np.random.default_rng(11).bytes(64 * 300)
REDUCTION_INPUTS = {
    "edges": [0, 1, L - 1, L, L + 1, 2**512 - 1],
    "near the top": [x for k in range(_KMAX - 2, _KMAX + 1) for x in _near(k) if x < 2**512],
    "near 2^259 L": [x for k in (2**259 - 1, 2**259, 2**259 + 1) for x in _near(k)],
    "low 192 bits set": [_low_ones(x) for x in (0, L << 192, _KMAX * L, 2**259 * L,
                                                (2**511 - 1) // L * L)],
    "random": [int.from_bytes(_RANDOM[64 * i:64 * i + 64], "little") for i in range(300)],
}


@pytest.mark.parametrize("group", list(REDUCTION_INPUTS))
def test_reduce_mod_l_equals_int_mod_l(group):
    xs = REDUCTION_INPUTS[group]
    assert xs and all(0 <= x < 2**512 for x in xs)
    rows = np.array([list(x.to_bytes(64, "little")) for x in xs], dtype=np.uint8)
    out = native.reduce_mod_l_for_tests(rows)
    assert [int.from_bytes(r.tobytes(), "little") for r in out] == [x % L for x in xs]
    mu = _c_constant("MU")
    assert max(_subtractions(x, mu) for x in xs) <= 1


def test_reduction_reaches_no_and_one_subtraction_never_two():
    """The constructed values reach both the remainder that needs no
    subtraction and the one that needs one; no value, constructed or
    random, needs a second (the bound below)."""
    mu = _c_constant("MU")
    constructed = [x for g, xs in REDUCTION_INPUTS.items() if g != "random" for x in xs]
    assert {_subtractions(x, mu) for x in constructed} == {0, 1}
    assert {_subtractions(x, mu) for x in REDUCTION_INPUTS["random"]} <= {0, 1}


def test_reduction_constants_and_bound():
    """hostprep.c's L_LIMBS is L and MU is floor(2^512 / L); the estimate's
    shortfall x0 / L + q1 d / 2^320 < 2^192 / L + d (d the fraction of
    2^512 / L) is below 1, so one subtraction of L suffices."""
    mu = _c_constant("MU")
    assert _c_constant("L_LIMBS") == L
    assert mu == 2**512 // L
    d = Fraction(2**512, L) - mu
    assert 0 <= d < 1
    assert Fraction(2**192, L) < Fraction(1, 2**60)
    assert Fraction(2**192, L) + d < 1
    assert Fraction(2**192, L) + d < Fraction(2250, 10000)


def test_reduce_mod_l_rows_are_checked():
    with pytest.raises(ValueError, match=r"\[n, 64\]"):
        native.reduce_mod_l_for_tests(np.zeros((2, 32), np.uint8))
    assert native.reduce_mod_l_for_tests(np.zeros((0, 64), np.uint8)).shape == (0, 32)


# ---------------------------------------------------------------------------
# secp256k1: the prep against the plain and the reference's Python prep

K1_N = corpus.K1_N
K1_P = corpus.K1_P
K1_THREADS = [1, 3, 8, 16]


def _k1_random(n, seed, msg_lens=None, twins=True):
    """n lanes of random well-formed bytes (prefix 2 or 3, r and s in
    [1, n - 1], s low), every fifth lane the high-S twin R || (n - s) of the
    lane before it unless ``twins`` is False; messages of random lengths
    below 200 bytes, or ``msg_lens``."""
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        r = int.from_bytes(rng.bytes(32), "big") % (K1_N - 1) + 1
        s = int.from_bytes(rng.bytes(32), "big") % (K1_N // 2) + 1
        if twins and i % 5 == 4:
            r, s = int.from_bytes(sigs[-1][:32], "big"), K1_N - int.from_bytes(sigs[-1][32:], "big")
        pks.append(bytes([2 + i % 2]) + rng.bytes(32))
        sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))
        msgs.append(rng.bytes(int(rng.integers(200)) if msg_lens is None else msg_lens[i]))
    return pks, msgs, sigs


def _k1_with(lanes, **fields):
    """One lane of ``lanes`` with its key's prefix or x, or its r or s,
    replaced (a scalar or x given as an int, written as 32 big-endian
    bytes; ``pk`` or ``sig`` as raw bytes, any length)."""
    pk, msg, sig = lanes
    if "prefix" in fields:
        pk = bytes([fields["prefix"]]) + pk[1:]
    if "x" in fields:
        pk = pk[:1] + fields["x"].to_bytes(32, "big")
    if "r" in fields:
        sig = fields["r"].to_bytes(32, "big") + sig[32:]
    if "s" in fields:
        sig = sig[:32] + fields["s"].to_bytes(32, "big")
    return fields.get("pk", pk), msg, fields.get("sig", sig)


# each edge lane and whether the host checks accept it
K1_EDGES = [
    ({"s": K1_N // 2}, True), ({"s": K1_N // 2 + 1}, False), ({"s": 1}, True),
    ({"s": 0}, False), ({"r": K1_N - 1}, True), ({"r": K1_N}, False), ({"r": 1}, True),
    ({"r": 0}, False), ({"r": K1_P - K1_N}, True), ({"r": K1_P - K1_N - 1}, True),
    ({"x": K1_P - 1}, True), ({"x": K1_P}, False), ({"x": 2**256 - 1}, False),
    ({"prefix": 0}, False), ({"prefix": 4}, False), ({"prefix": 5}, False),
    ({"prefix": 3}, True), ({"pk": bytes(32)}, False), ({"pk": bytes(34)}, False),
    ({"sig": bytes(63)}, False), ({"sig": bytes(65)}, False), ({"pk": b"", "sig": b""}, False),
]


def _k1_edges():
    base = list(zip(*_k1_random(len(K1_EDGES), 41, twins=False)))
    return tuple(map(list, zip(*(_k1_with(lane, **edit)
                                 for lane, (edit, _) in zip(base, K1_EDGES)))))


# a range takes at least 512 lanes (K1_MIN_RANGE), so 1,800 lanes make
# three ranges of 600 at 3 threads and four of 450 at 8 and 16
REFUSED_RANGE = range(450, 1350)


def _k1_refused_range():
    """1,800 lanes of which lanes 450-1349 are all refused: a range with no
    accepted lane at 3, 8 and 16 threads."""
    lanes = list(zip(*_k1_random(1800, 42, twins=False)))
    refused = [edit for edit, accept in K1_EDGES if not accept]
    for i in REFUSED_RANGE:
        lanes[i] = _k1_with(lanes[i], **refused[i % len(refused)])
    return tuple(map(list, zip(*lanes)))


SHA256_EDGE_LENGTHS = [0, 55, 56, 63, 64, 119, 120]

K1_PREP_CASES = {
    **{f"corpus {name}": make for name, make in corpus.K1_CORPORA.items()},
    "random 10,000 with high-S twins": lambda: _k1_random(10_000, 40),
    "scalar and key edges": _k1_edges,
    "a range with no accepted lane": _k1_refused_range,
    "no accepted lane": lambda: tuple(map(list, zip(*(_k1_with(lane, prefix=0) for lane in
                                                      zip(*_k1_random(5, 43)))))),
    "sha-256 padding edges": lambda: _k1_random(len(SHA256_EDGE_LENGTHS), 44,
                                                SHA256_EDGE_LENGTHS),
    "empty": lambda: ([], [], []),
}


@pytest.mark.parametrize("name", sorted(K1_PREP_CASES))
def test_k1_prep_equals_plain_and_reference(monkeypatch, name):
    """The plane and host verdicts of ``prepare_k1_batch_packed`` (the C
    entry) equal the plain prep's and the reference's, byte for byte, at
    every thread count."""
    pks, msgs, sigs = K1_PREP_CASES[name]()
    want_packed, want_ok = jkv.prepare_k1_batch_packed(pks, msgs, sigs)
    plain_packed, plain_ok = kv.prepare_k1_batch_packed_plain(pks, msgs, sigs)
    np.testing.assert_array_equal(plain_packed, want_packed)
    np.testing.assert_array_equal(plain_ok, want_ok)
    for nthreads in K1_THREADS:
        monkeypatch.setattr(native, "_threads", lambda _given: nthreads)
        packed, ok = kv.prepare_k1_batch_packed(pks, msgs, sigs)
        assert packed.dtype == np.uint8 and packed.shape == (168, len(sigs))
        np.testing.assert_array_equal(packed, want_packed)
        np.testing.assert_array_equal(ok, want_ok)


def test_k1_edge_lanes_reach_their_branches():
    """Each edge lane is accepted or refused as listed; where r + n is p or
    more, rpn is r; a refused lane carries the dummy bytes; the high-S
    twins and the empty range are there."""
    pks, msgs, sigs = _k1_edges()
    packed, ok = kv.prepare_k1_batch_packed(pks, msgs, sigs)
    assert ok.tolist() == [accept for _, accept in K1_EDGES]
    col = lambda i, row: int.from_bytes(packed[row:row + 32, i].tobytes(), "big")  # noqa: E731
    for i, (edit, accept) in enumerate(K1_EDGES):
        r = edit.get("r")
        if accept and r is not None:
            assert col(i, 128) == (r + K1_N if r + K1_N < K1_P else r)
        if not accept:
            assert [col(i, row) for row in range(0, 160, 32)] == [0, 1, 1, 1, 1]
    assert col(K1_EDGES.index(({"r": K1_P - K1_N}, True)), 128) == K1_P - K1_N
    assert not packed[161:].any()
    _, ok = kv.prepare_k1_batch_packed(*K1_PREP_CASES["random 10,000 with high-S twins"]())
    assert not ok[4::5].any() and ok.sum() == 8_000
    _, ok = kv.prepare_k1_batch_packed(*_k1_refused_range())
    assert ok.tolist() == [i not in REFUSED_RANGE for i in range(1800)]
    assert _c_int("K1_MIN_RANGE") == 512


def test_prep_k1_rows_are_checked():
    """Columns of different lengths raise; a key or signature of the
    wrong length is a refused lane with the dummy bytes and parity 0."""
    with pytest.raises(ValueError, match="expected 2 byte strings, got 1"):
        native.prep_k1([bytes(33)] * 2, [b""], [bytes(64)] * 2)
    with pytest.raises(ValueError, match="expected 2 byte strings, got 3"):
        native.prep_k1([bytes(33)] * 3, [b"", b""], [bytes(64)] * 2)
    pks, msgs, sigs = corpus.k1_signed(2, 1)
    packed, ok = native.prep_k1([pks[0][:32], b"\x03" + pks[1][1:] + b"\x00"], msgs,
                                [sigs[0], sigs[1][:63]])
    assert ok.tolist() == [False, False] and not packed[160:].any()
    col = lambda i, row: int.from_bytes(packed[row:row + 32, i].tobytes(), "big")  # noqa: E731
    assert [[col(i, row) for row in range(0, 160, 32)] for i in (0, 1)] == [[0, 1, 1, 1, 1]] * 2


# ---------------------------------------------------------------------------
# Arithmetic mod the secp256k1 order n = 2^256 - NC


def _folds(x, nc):
    """The folds x = lo + hi 2^256 -> lo + hi NC that the C reduction makes
    before x < 2^256, and the subtractions of n after them."""
    k = 0
    while x >> 256:
        x = (x & (2**256 - 1)) + (x >> 256) * nc
        k += 1
    return k, x // (2**256 - nc)


def _fold_edge(v):
    """The least x whose second fold leaves v (so x mod n = v mod n): with
    v >> 256 = 1, a third fold carries where v mod 2^256 >= 2^256 - NC,
    and a fourth follows."""
    nc = 2**256 - K1_N
    hi1 = -(-(v - 2**256 + 1) // nc)            # the least hi1 with v - hi1 NC < 2^256
    t1 = v + hi1 * K1_N                         # lo1 + hi1 2^256, lo1 = v - hi1 NC
    hi0 = -(-(t1 - 2**256 + 1) // nc)
    return t1 + hi0 * K1_N


_NC = 2**256 - K1_N
_RND = np.random.default_rng(12).bytes(64 * 300)
MOD_N_INPUTS = {
    "small": [0, 1, 2, 3],
    "just below and above n": [K1_N - 2, K1_N - 1, K1_N, K1_N + 1, 2 * K1_N - 1, 2 * K1_N,
                               2**256 - 1, 2**256, 2**256 + _NC - 1],
    "products near n^2": [(K1_N - 1) ** 2, (K1_N - 1) * (K1_N - 2), (K1_N + 1) ** 2,
                          (2**256 - 1) ** 2, K1_N**2, K1_N * (K1_N // 2), 2**512 - 1],
    "fourth fold": [_fold_edge(2**257 - 1), _fold_edge(2**257 - _NC),
                    _fold_edge(2**257 - _NC - 1)],
    "random products": [int.from_bytes(_RND[64 * i:64 * i + 32], "big")
                        * int.from_bytes(_RND[64 * i + 32:64 * i + 64], "big")
                        for i in range(300)],
}


@pytest.mark.parametrize("group", list(MOD_N_INPUTS))
def test_mod_n_equals_int(group):
    xs = MOD_N_INPUTS[group]
    assert xs and all(0 <= x < 2**512 for x in xs)
    rows = np.array([list(x.to_bytes(64, "big")) for x in xs], dtype=np.uint8)
    red, inv = native.mod_n_for_tests(rows)
    as_int = lambda rows: [int.from_bytes(r.tobytes(), "big") for r in rows]  # noqa: E731
    assert as_int(red) == [x % K1_N for x in xs]
    assert as_int(inv) == [pow(x, -1, K1_N) if x % K1_N else 0 for x in xs]


def test_mod_n_reaches_every_fold_count():
    """The constructed values reach no fold up to the fourth, and both no
    subtraction and one after the folds; random products make two or three
    folds."""
    nc = _c_constant("NC")
    constructed = [x for g, xs in MOD_N_INPUTS.items() if g != "random products" for x in xs]
    assert {_folds(x, nc)[0] for x in constructed} == {0, 1, 2, 3, 4}
    assert {_folds(x, nc)[1] for x in constructed} == {0, 1}
    assert {_folds(x, nc)[0] for x in MOD_N_INPUTS["random products"]} <= {2, 3}


def test_mod_n_constants_and_fold_bound():
    """hostprep.c's N_LIMBS is secp256k1's order, NC = 2^256 - n < 2^129,
    HALF_N = floor(n / 2) and P_LIMBS the field prime; from x < 2^512 the
    worst case of each fold (below) is under 2^256 after four, and 2^256 <
    2n, so four folds and one subtraction suffice."""
    n, nc = _c_constant("N_LIMBS"), _c_constant("NC")
    assert n == K1_N and nc == 2**256 - n and nc < 2**129
    assert _c_constant("HALF_N") == n // 2 and _c_constant("P_LIMBS") == K1_P
    bound, folds = 2**512 - 1, 0
    while bound >> 256:
        hi = bound >> 256  # the largest hi; a smaller one leaves lo free
        bound = max(2**256 - 1 + (hi - 1) * nc, bound - hi * 2**256 + hi * nc)
        folds += 1
    assert folds == 4 and bound < 2 * n


def test_mod_n_rows_are_checked():
    with pytest.raises(ValueError, match=r"\[m, 64\]"):
        native.mod_n_for_tests(np.zeros((2, 32), np.uint8))
    red, inv = native.mod_n_for_tests(np.zeros((0, 64), np.uint8))
    assert red.shape == inv.shape == (0, 32)
