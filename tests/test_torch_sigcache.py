"""The port's signature cache (tmtpu_torch/crypto/sigcache.py), its C store
and keys (``native.Store``, ``native.resolve``) and the verify-once resolve of
tmtpu_torch/crypto/batch.py, against the reference's sigcache and its
``CPUBatchVerifier`` (tmtpu/crypto/{sigcache,batch}.py), on the CPU.

The cache cases are the port's counterparts of tests/test_sigcache.py. The
resolve runs the same item sequences through ``TorchBatchVerifier(device=
"cpu")`` and the reference, both caches fresh and on, and requires the
mask, the tally and ``cache_stats`` equal. The plain graphs cost seconds a
call on the CPU whatever the width, so the sequences share few flushes."""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_mixed import CURVES, _secret, _words, mixed_items
from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import sigcache as jsigcache
from tmtpu_torch import native
from tmtpu_torch.crypto import batch, ristretto, sigcache
from tmtpu_torch.crypto import sr25519 as sr

ED = batch.ED25519


@pytest.fixture(autouse=True)
def _fresh_port_sigcache():
    """The port's cache is process-wide; every test starts on an empty,
    enabled one (tests/conftest.py does the same for the reference's)."""
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    yield
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()


# --- keys ---------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(st.text(max_size=12), st.binary(max_size=70), st.binary(max_size=400),
       st.binary(max_size=80))
def test_cache_key_equals_reference(kind, pk, msg, sig):
    """The Python key, and the C key on the SHA-256 block in use, against the
    reference's (the portable block is held to the same in the tests
    below)."""
    want = jsigcache.cache_key(kind, pk, msg, sig)
    assert sigcache.cache_key(kind, pk, msg, sig) == want
    assert native.cache_keys([kind], [pk], [msg], [sig]).tobytes() == want


@pytest.fixture(params=["sha extensions", "portable"])
def sha_impl(request):
    """Each key test runs on both SHA-256 blocks of the C library: the CPU's
    SHA extensions (where it has them) and the portable C."""
    had = native.sha256_ni()
    native.sha256_ni(request.param == "sha extensions")
    yield request.param
    native.sha256_ni(had)


@pytest.mark.parametrize("nthreads", [1, 3, 8])
def test_native_cache_keys_of_a_flush(nthreads, sha_impl):
    rng = np.random.default_rng(nthreads)
    kinds = [(ED, "sr25519", "secp256k1")[i % 3] for i in range(300)]
    fields = [[rng.bytes(int(rng.integers(0, hi))) for _ in kinds] for hi in (40, 300, 70)]
    got = native.cache_keys(kinds, *fields, nthreads=nthreads)
    assert [bytes(k) for k in got] == [sigcache.cache_key(*lane) for lane in zip(kinds, *fields)]
    assert native.cache_keys([], [], [], [], nthreads=nthreads).shape == (0, 32)


def test_cache_keys_across_sha256_block_edges(sha_impl):
    """Messages whose key input ends on either side of SHA-256's padding
    edges (55/56 bytes into the last block) and of several whole blocks."""
    fixed = 4 + len(ED) + 4 + 32 + 4 + 4 + 64  # 119 bytes: 55 into the second block
    msgs = [bytes(range(256))[: total - fixed] for total in
            (fixed, 120, 128, 183, 184, 191, 192, 247, 248, 256)]
    msgs += [b"\xa5" * n for n in range(0, 200, 7)]
    pk, sig = bytes(range(32)), bytes(range(64))
    got = native.cache_keys([ED] * len(msgs), [pk] * len(msgs), msgs, [sig] * len(msgs))
    assert [bytes(k) for k in got] == [sigcache.cache_key(ED, pk, m, sig) for m in msgs]


@pytest.mark.parametrize("nthreads", [1, 3, 8])
def test_resolve_folds_repeats_onto_their_first_lane(nthreads):
    """One C pass: every lane's key, -1 where the store holds it (a hit,
    counted), else the flush's first lane that missed with the same key."""
    rng = random.Random(nthreads)
    universe = [(ED, b"pk%d" % i, b"m%d" % i, b"s%d" % i) for i in range(40)]
    c = sigcache.SigCache(max_entries=64, shards=4)
    c.add_many([sigcache.cache_key(*t) for t in universe[:10]])
    lanes = [universe[rng.randrange(40)] for _ in range(300)]
    keys, rep = native.resolve(c._entries(), *zip(*lanes), nthreads=nthreads)
    want_keys = [sigcache.cache_key(*t) for t in lanes]
    assert [bytes(k) for k in keys] == want_keys
    first = {}
    want_rep = [-1 if t in universe[:10] else first.setdefault(k, i)
                for i, (t, k) in enumerate(zip(lanes, want_keys))]
    assert rep.tolist() == want_rep
    keys, rep = c.resolve(*zip(*lanes))
    assert rep.tolist() == want_rep
    assert c.stats()["hits"] == want_rep.count(-1)
    assert c.stats()["misses"] == len(lanes) - want_rep.count(-1)
    c.set_enabled(False)
    assert c.resolve(*zip(*lanes))[1].tolist() == [first.get(k, first.setdefault(k, i))
                                                   for i, k in enumerate(want_keys)]


def test_cache_key_injective_across_field_boundaries():
    a = sigcache.cache_key(ED, b"ab", b"c", b"sig")
    b = sigcache.cache_key(ED, b"a", b"bc", b"sig")
    c = sigcache.cache_key(ED, b"abc", b"", b"sig")
    assert len({a, b, c}) == 3
    key = sigcache.cache_key
    assert key(ED, b"pk", b"m", b"s") != key("sr25519", b"pk", b"m", b"s")
    assert key(ED, b"pk", b"m", b"s1") != key(ED, b"pk", b"m", b"s2")


# --- the cache ----------------------------------------------------------------


def test_hit_miss_insert_and_stats():
    c = sigcache.SigCache(max_entries=64, shards=4)
    assert not c.check(ED, b"pk", b"msg", b"sig")
    c.record(ED, b"pk", b"msg", b"sig")
    assert c.check(ED, b"pk", b"msg", b"sig")
    s = c.stats()
    assert s["hits"] == 1 and s["misses"] == 1 and s["inserts"] == 1
    assert s["entries"] == 1 and 0 < s["hit_rate"] < 1
    c.invalidate_all()
    assert c.size() == 0
    assert not c.check(ED, b"pk", b"msg", b"sig")


def test_disabled_cache_never_hits():
    c = sigcache.SigCache(max_entries=64, shards=2, enabled=False)
    c.record(ED, b"pk", b"m", b"s")
    assert not c.check(ED, b"pk", b"m", b"s")
    assert c.size() == 0
    c.set_enabled(True)
    c.record(ED, b"pk", b"m", b"s")
    c.set_enabled(False)  # switching off drops the entries
    assert c.size() == 0 and not c.enabled()


def test_resize_shrink_evicts_lru():
    c = sigcache.SigCache(max_entries=64, shards=1)
    ks = [sigcache.cache_key(ED, b"pk%d" % i, b"m", b"s") for i in range(32)]
    for k in ks:
        c.add(k)
    for k in ks[16:]:  # the older half becomes least recently used
        assert c.contains(k)
    c.resize(8)
    assert c.size() <= 8
    assert all(not c.contains(k) for k in ks[:16])
    assert c.stats()["evictions"] == 24


def test_equivocation_makes_two_entries():
    """One (pubkey, msg) under two signatures is two entries, and neither
    signature hits for the other's message."""
    c = sigcache.SigCache(max_entries=64, shards=4)
    c.record(ED, b"pk", b"vote A", b"sig A")
    c.record(ED, b"pk", b"vote A", b"sig B")
    assert c.size() == 2 and c.stats()["inserts"] == 2
    assert c.check(ED, b"pk", b"vote A", b"sig A") and c.check(ED, b"pk", b"vote A", b"sig B")
    assert not c.check(ED, b"pk", b"vote B", b"sig A")


def test_eviction_churn_never_false_positive():
    rng = random.Random(0xC0FFEE)
    cache = sigcache.SigCache(max_entries=32, shards=4)
    inserted = set()
    universe = [sigcache.cache_key(ED, b"pk%d" % i, b"m%d" % (i % 7), b"s%d" % i)
                for i in range(256)]
    for step in range(5000):
        op = rng.random()
        k = universe[rng.randrange(len(universe))]
        if op < 0.45:
            cache.add(k)
            inserted.add(k)
        elif op < 0.5:
            cache.invalidate_all()
        elif cache.contains(k):
            assert k in inserted, f"false positive at step {step}"
    assert cache.size() <= 32
    assert cache.stats()["evictions"] > 0


def test_batched_lookups_and_inserts_equal_one_call_a_key():
    """``contains_many`` / ``add_many`` give the answers and counters of the
    reference's one ``contains`` / ``add`` a key (its OrderedDict LRU),
    duplicates, evictions and shrinks included; ``contains`` and ``add``
    are the same calls on one key."""
    rng = random.Random(7)
    universe = [sigcache.cache_key(ED, b"pk%d" % i, b"m", b"s") for i in range(200)]
    one = jsigcache.SigCache(max_entries=64, shards=4)
    many = sigcache.SigCache(max_entries=64, shards=4)
    for step in range(60):
        batch_keys = [universe[rng.randrange(200)] for _ in range(rng.randrange(1, 40))]
        assert many.contains_many(batch_keys) == [one.contains(k) for k in batch_keys]
        fresh = [k for k in batch_keys if rng.random() < 0.7]
        for k in fresh:
            one.add(k)
        if step % 2:
            many.add_many(fresh)
        else:
            for k in fresh:
                many.add(k)
        probe = universe[rng.randrange(200)]
        assert many.contains(probe) == one.contains(probe)
        if step % 20 == 19:
            cap = rng.choice([8, 40, 64])
            one.resize(cap)
            many.resize(cap)
        assert many.size() == one.size()
    assert many.contains_many(universe) == [one.contains(k) for k in universe]
    got, want = many.stats(), one.stats()
    assert {k: got[k] for k in want} == want and want["evictions"] > 0
    off = sigcache.SigCache(enabled=False)
    off.add_many(universe[:3])
    assert off.contains_many(universe[:3]) == [False] * 3 and off.size() == 0


def test_threads_share_the_store():
    """Flushes on several threads at once: the C store's shard locks keep
    it whole (no false hit, the cap held, the counters add up)."""
    import threading

    universe = [sigcache.cache_key(ED, b"pk%d" % i, b"m", b"s") for i in range(512)]
    c = sigcache.SigCache(max_entries=128, shards=8)
    wrong = []

    def work(seed):
        rng = random.Random(seed)
        mine = universe[seed::4]
        for _ in range(200):
            ks = [mine[rng.randrange(len(mine))] for _ in range(16)]
            c.add_many(ks[:8])
            hits = c.contains_many(ks)
            wrong.extend(k for k, h in zip(ks, hits) if h and k not in mine)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s = c.stats()
    assert not wrong and c.size() <= 128
    assert s["hits"] + s["misses"] == 4 * 200 * 16
    assert s["inserts"] - s["evictions"] == c.size()


def test_configure_applies_to_the_default_cache():
    try:
        sigcache.configure(512, 4)
        s = sigcache.stats()
        assert s["max_entries"] == 512 and s["shards"] == 4 and s["enabled"]
        sigcache.configure(512, 4, enabled=False)
        assert not sigcache.DEFAULT.enabled()
    finally:
        sigcache.configure(sigcache.DEFAULT_MAX_ENTRIES, sigcache.DEFAULT_SHARDS)


# --- the resolve against the reference ----------------------------------------


@pytest.fixture
def dispatched(monkeypatch):
    """The widths of the port's backend calls: one entry per
    ``_verify_pending``, none for a flush of hits only."""
    widths = []
    real = batch.TorchBatchVerifier._verify_pending

    def counting(self, items, tally):
        widths.append(len(items))
        return real(self, items, tally)

    monkeypatch.setattr(batch.TorchBatchVerifier, "_verify_pending", counting)
    return widths


def _flush(items):
    """One verify_tally of (port key, reference key, msg, sig, power) items
    through both verifiers; requires mask, tally, cache_stats and the
    bitarray equal. Returns the result."""
    port = batch.TorchBatchVerifier(device="cpu")
    refv = jbatch.CPUBatchVerifier()
    for port_key, ref_key, msg, sig, power in items:
        port.add(port_key, msg, sig, power)
        refv.add(ref_key, msg, sig, power)
    got, want = port.verify_tally(), refv.verify_tally()
    assert got == want
    assert port.cache_stats == refv.cache_stats
    np.testing.assert_array_equal(port.bit_words, _words(got[1]).astype(np.uint32))
    return got, port.cache_stats


def _ed(i, msg=None, power=0):
    port_cls, ref_cls = CURVES[ED]
    secret = _secret(ED, 1000 + i)
    m = msg if msg is not None else b"sigcache msg %d" % i
    sig = port_cls(secret).sign(m)
    return [port_cls(secret).pub_key(), ref_cls(secret).pub_key(), m, sig, power]


def test_ed25519_sequences_match_reference(dispatched):
    # five copies of one triple: one lane, every power counted once
    five = [_ed(1, power=7)] * 5
    got, stats = _flush(five)
    assert got == (True, [True] * 5, 35)
    assert stats == {"lanes": 5, "hits": 0, "dedup": 4, "dispatched": 1}
    assert dispatched == [1]

    # a hit, a miss, its duplicate and an invalid signature
    a, b, c = _ed(10, power=1), _ed(11, power=2), _ed(12, power=4)
    c[3] = bytes([c[3][0] ^ 0xFF]) + c[3][1:]
    sigcache.DEFAULT.record(ED, a[0].bytes(), a[2], a[3])
    jsigcache.record(ED, a[1].bytes(), a[2], a[3])
    got, stats = _flush([a, b, b, c])
    assert got == (False, [True, True, True, False], 5)
    assert stats == {"lanes": 4, "hits": 1, "dedup": 1, "dispatched": 2}
    assert dispatched == [1, 2]
    assert not sigcache.DEFAULT.check(ED, c[0].bytes(), c[2], c[3])  # failures stay out

    # a flush of hits only launches nothing and still gives the bitarray;
    # the invalid triple, never cached, is verified again
    got, stats = _flush([b, a, five[0], b])
    assert got == (True, [True] * 4, 2 + 1 + 7 + 2)
    assert stats == {"lanes": 4, "hits": 4, "dedup": 0, "dispatched": 0}
    assert dispatched == [1, 2]
    got, stats = _flush([c, a])
    assert got == (False, [False, True], 1)
    assert stats == {"lanes": 2, "hits": 1, "dedup": 0, "dispatched": 1}

    # with the cache off: no keys, no dedup, every item dispatched
    sigcache.DEFAULT.set_enabled(False)
    jsigcache.DEFAULT.set_enabled(False)
    got, stats = _flush([a, a, c])
    assert got == (False, [True, True, False], 2)
    assert stats == {"lanes": 3, "hits": 0, "dedup": 0, "dispatched": 3}
    assert dispatched == [1, 2, 1, 3]
    assert sigcache.DEFAULT.size() == 0


def _sr_second_signature(secret: bytes, msg: bytes) -> bytes:
    """Another valid schnorrkel signature of ``msg`` (a different nonce):
    the same (pubkey, msg) under two signatures."""
    priv = sr.PrivKeySr25519(secret)
    key, _ = sr._expand_ed25519(secret)
    t = sr.signing_context(msg)
    t.append_message(b"sign:pk", priv.pub_key().bytes())
    r = 0x1234567890ABCDEF
    big_r = ristretto.encode(ristretto.scalar_mult(r, ristretto.BASEPOINT))
    t.append_message(b"sign:R", big_r)
    k = int.from_bytes(t.challenge_bytes(b"sign:c", 64), "little") % sr.L
    sig = bytearray(big_r + ((k * key + r) % sr.L).to_bytes(32, "little"))
    sig[63] |= 0x80
    return bytes(sig)


def test_mixed_curve_sequence_matches_reference(dispatched):
    """Three curves in one flush, with a duplicate of a good lane and of a
    corrupted lane on each curve and an sr25519 equivocation (one key and
    message, two valid signatures); then the good items again, all hits."""
    items = [list(it) for it in mixed_items([ED, batch.SR25519, batch.SECP256K1], n=12, seed=47)]
    for kind in CURVES:
        lanes = [it for it in items if it[0].type_value() == kind]
        items += [list(lanes[0]), list(lanes[1])]  # lane 1 of each curve is corrupted
    port_cls, ref_cls = CURVES[batch.SR25519]
    secret = _secret(batch.SR25519, 100)
    msg = b"the same precommit"
    sig_a = port_cls(secret).sign(msg)
    sig_b = _sr_second_signature(secret, msg)
    assert sig_a != sig_b
    for sig in (sig_a, sig_b):
        items.append([port_cls(secret).pub_key(), ref_cls(secret).pub_key(), msg, sig, 9])
    got, stats = _flush(items)
    assert stats == {"lanes": 20, "hits": 0, "dedup": 6, "dispatched": 14}
    assert dispatched == [14]
    assert got[1][-2:] == [True, True]
    assert sigcache.DEFAULT.size() == jsigcache.DEFAULT.size() == sum(got[1][:12]) + 2

    good = [it for it, ok in zip(items, got[1]) if ok]
    got, stats = _flush(good)
    assert got[0] and stats == {"lanes": len(good), "hits": len(good), "dedup": 0,
                                "dispatched": 0}
    assert dispatched == [14]
