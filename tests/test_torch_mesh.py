"""The sharded half of the port's gpu/sharding.py on four CPU shards: the
steps that ``entry.dryrun_multichip`` certifies and ``bench_torch.py
--flood`` measures, against the reference's sharded steps on its virtual
CPU mesh (tests/conftest.py), the port's single-device path, the per-lane
oracles and the reference's CPUBatchVerifier. Every comparison is exact:
masks, tallies and bitarray words bit for bit.

CPU shards run one after another through the plain PyTorch versions,
seconds a shard whatever its width, so the corpora stay at a few hundred
lanes."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_corpus as corpus
from tests.test_torch_mixed import _words, mixed_items
from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import ed25519 as jed
from tmtpu.tpu import k1_verify as jkv
from tmtpu.tpu import sharding as jsh
from tmtpu.tpu import sr_verify as jsrv
from tmtpu.tpu import verify as jtv
from tmtpu_torch.crypto import batch, sigcache
from tmtpu_torch.gpu import k1_kernel, kernel, sharding as sh
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv

CPU4 = (torch.device("cpu"),) * 4


@pytest.fixture(autouse=True)
def _fresh_port_sigcache():
    """An empty, enabled port signature cache for every test."""
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    yield
    sigcache.DEFAULT.invalidate_all()


def _sharded_tally(pks, msgs, sigs, powers, mesh=CPU4):
    """ed25519 verify + tally through ``sharded_verify_tally``, as
    ``entry.dryrun_multichip`` calls it: (mask, exact tally) on the host."""
    packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
    mask, sums = sh.sharded_verify_tally(mesh)(packed, sh.power_limbs(powers), host_ok)
    return mask.numpy(), sh.combine_limbs(sums.tolist())


_MASK_STEPS = {
    batch.ED25519: (tv.prepare_batch_packed, sh.sharded_verify_ed),
    batch.SR25519: (sv.prepare_sr_batch_packed, sh.sharded_verify_sr),
    batch.SECP256K1: (kv.prepare_k1_batch_packed, sh.sharded_verify_k1),
}


def _sharded_mask(curve, pks, msgs, sigs, mesh=CPU4):
    """One curve's mask through its lane-sharded step and the host checks."""
    prep, build = _MASK_STEPS[curve]
    packed, host_ok = prep(pks, msgs, sigs)
    return build(mesh)(packed).numpy() & host_ok


def _ed_batch(n, tag, bad=()):
    """The reference's mesh corpus (its tests of the split): n distinct
    keys, powers 100 + 7i, a flipped first signature byte at ``bad``."""
    pks, msgs, sigs, powers = [], [], [], []
    for i in range(n):
        priv = jed.gen_priv_key_from_secret(b"%s-%d" % (tag, i))
        msg = b"%s msg %d" % (tag, i)
        sig = priv.sign(msg)
        if i in bad:
            sig = bytes([sig[0] ^ 0xFF]) + sig[1:]
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(sig)
        powers.append(100 + 7 * i)
    return pks, msgs, sigs, powers


def _spy_widths(monkeypatch, module, name):
    """Record the width of every plane the wrapper ``module.name`` gets."""
    widths = []
    real = getattr(module, name)

    def spy(packed):
        widths.append(packed.shape[1])
        return real(packed)

    monkeypatch.setattr(module, name, spy)
    return widths


def test_shard_bounds_and_make_mesh():
    sizes = [hi - lo for lo, hi in sh.shard_bounds(10_000, 4)]
    assert sizes == [2528, 2528, 2528, 2416]
    assert sh.shard_bounds(1, 4) == [(0, 1)]
    assert sh.shard_bounds(33, 4) == [(0, 32), (32, 33)]
    assert sh.shard_bounds(129, 4) == [(0, 64), (64, 128), (128, 129)]
    assert sh.shard_bounds(0, 4) == []
    assert sh.make_mesh(4, "cpu") == CPU4
    assert sh.make_mesh(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        sh.make_mesh(0, "cpu")
    with pytest.raises(ValueError):
        sh.sharded_verify_tally((torch.device("cpu"), torch.device("meta")))


def test_mesh_tally_matches_reference_mesh(monkeypatch):
    """The acceptance scenario at the reference's tier-1 shape: 128 lanes,
    3 corrupt, on four CPU shards against the reference's sharded step
    (``sharded_verify_tally_packed``) on four of its virtual devices."""
    pks, msgs, sigs, powers = _ed_batch(128, b"mesh-eq", bad={3, 17, 100})
    packed, host_ok = jtv.prepare_batch_packed(pks, msgs, sigs)
    limbs = jsh.powers_to_limbs(np.where(host_ok, np.asarray(powers, dtype=np.int64), 0))
    want_mask, want_sums, want_bits = jsh.sharded_verify_tally_packed(jsh.make_mesh(4))(
        jnp.asarray(packed), jnp.asarray(limbs), jtv.base_table_f32())
    want_mask = np.asarray(want_mask) & host_ok
    widths = _spy_widths(monkeypatch, kernel, "verify_packed")
    mask, tally = _sharded_tally(pks, msgs, sigs, powers)
    np.testing.assert_array_equal(mask, want_mask)
    assert isinstance(tally, int) and tally == jsh.limb_sums_to_int(want_sums)
    assert tally == sum(p for i, p in enumerate(powers) if i not in (3, 17, 100))
    np.testing.assert_array_equal(sh.pack_bitarray(torch.from_numpy(mask)).numpy()
                                  .astype(np.uint32), np.asarray(want_bits))
    assert widths == [32, 32, 32, 32]


@pytest.fixture(scope="module")
def ragged_corpus():
    """200 distinct lanes with corrupted ones spread over every shard, the
    oracle's mask and the port's single-device mask of the same lanes."""
    pks, msgs, sigs = corpus.signed(200, 51)
    for i in (0, 30, 31, 32, 64, 126, 128, 199):
        sigs[i] = corpus.flip(sigs[i], 0)
    want = corpus.oracle(pks, msgs, sigs)
    single, _ = sh.batch_verify_tally(pks, msgs, sigs, [1] * 200, device="cpu")
    np.testing.assert_array_equal(single, want)
    return pks, msgs, sigs, want


@pytest.mark.parametrize("b", [1, 31, 32, 33, 127, 129, 200])
def test_ragged_widths_split_without_pad_lanes(b, ragged_corpus, monkeypatch):
    """Each non-empty shard gets exactly its lanes (no pads, empty shards
    neither copy nor launch); mask, tally and bitarray equal the
    single-device path and the oracle."""
    pks, msgs, sigs, want = ragged_corpus
    widths = _spy_widths(monkeypatch, kernel, "verify_packed")
    powers = [100 + 7 * i for i in range(b)]
    mask, tally = _sharded_tally(pks[:b], msgs[:b], sigs[:b], powers)
    sizes = [hi - lo for lo, hi in sh.shard_bounds(b, 4)]
    assert widths == sizes and sum(sizes) == b
    np.testing.assert_array_equal(mask, want[:b])
    assert tally == sum(p for p, ok in zip(powers, want[:b]) if ok)
    np.testing.assert_array_equal(sh.pack_words(mask, "cpu"),
                                  _words(want[:b]).astype(np.uint32))


@pytest.mark.parametrize("copies, huge", [(8, False), (9, True)])
def test_tally_past_2_63_split_across_shards(copies, huge):
    """Copies of one precommit at 2^60 on every shard among valid lanes of
    power 1: each shard's sum stays under 2^63, the flush's does not; with
    ``huge`` one lane's power is past 2^64 (three limbs)."""
    b = 120
    pks, msgs, sigs = corpus.signed(b, 52)
    at = list(range(0, b, b // copies))[:copies]
    powers = [1] * b
    for j in at:
        pks[j], msgs[j], sigs[j], powers[j] = pks[0], msgs[0], sigs[0], 2**60
    if huge:
        powers[70] = 2**64 + 3
    mask, tally = _sharded_tally(pks, msgs, sigs, powers)
    assert mask.all() and tally == sum(powers) and tally >= 2**63
    assert {j // 32 for j in at} == {0, 1, 2, 3}
    single_mask, single_tally = sh.batch_verify_tally(pks, msgs, sigs, powers, device="cpu")
    np.testing.assert_array_equal(mask, single_mask)
    assert tally == single_tally


@pytest.mark.parametrize("curve", [batch.SR25519, batch.SECP256K1])
def test_sharded_sr_k1_masks_against_oracles(curve, monkeypatch):
    if curve == batch.SR25519:
        parts = [corpus.sr_signed(40, 53), corpus.sr_adversarial()]
        oracle, module, name = corpus.sr_oracle, kernel, "sr_verify_packed"
    else:
        parts = [corpus.k1_signed(40, 54), corpus.k1_adversarial(), corpus.k1_edges()]
        oracle, module, name = corpus.k1_oracle, k1_kernel, "verify_packed"
    pks, msgs, sigs = (sum(cols, []) for cols in zip(*parts))
    widths = _spy_widths(monkeypatch, module, name)
    mask = _sharded_mask(curve, pks, msgs, sigs)
    want = oracle(pks, msgs, sigs)
    assert not want.all() and want.any()
    np.testing.assert_array_equal(mask, want)
    assert widths == [hi - lo for lo, hi in sh.shard_bounds(len(sigs), 4)] and len(widths) >= 2


@pytest.mark.slow  # two fresh curve-graph compiles on XLA:CPU (minutes)
def test_sharded_sr_k1_match_reference_mesh():
    """Against the reference's sharded sr25519 and secp256k1 steps on four
    of its virtual devices (the slow twin of its own tests of the split)."""
    mesh = jsh.make_mesh(4)
    for curve, (pks, msgs, sigs), prep, build, table in (
            (batch.SR25519, corpus.sr_signed(64, 55), jsrv.prepare_sr_batch_packed,
             jsh.sharded_verify_sr, jtv.base_table_f32),
            (batch.SECP256K1, corpus.k1_signed(64, 56), jkv.prepare_k1_batch_packed,
             jsh.sharded_verify_k1, jkv.base_table_f32)):
        sigs[3] = corpus.flip(sigs[3], 1)
        packed, host_ok = prep(pks, msgs, sigs)
        want = np.asarray(build(mesh)(jnp.asarray(packed), table())) & host_ok
        mask = _sharded_mask(curve, pks, msgs, sigs)
        np.testing.assert_array_equal(mask, want)
        assert not mask[3] and mask.sum() == 63


@pytest.mark.parametrize("tally", [True, False])
def test_failed_shard_raises_without_fallback(tally, monkeypatch):
    """A shard that raises makes the sharded step raise: it never hands the
    lanes to the single-device path or the CPU."""
    calls = []

    def second_shard_fails(packed):
        calls.append(packed.shape[1])
        if len(calls) == 2:
            raise RuntimeError("shard 1 fell over")
        return torch.ones(packed.shape[1], dtype=torch.bool)

    def no_fallback(*a, **kw):
        raise AssertionError("the single-device path was taken")

    monkeypatch.setattr(kernel, "verify_packed", second_shard_fails)
    monkeypatch.setattr(sh, "batch_verify_tally", no_fallback)
    monkeypatch.setattr(tv, "batch_verify", no_fallback)
    pks, msgs, sigs, powers = _ed_batch(40, b"mesh-fail")
    with pytest.raises(RuntimeError, match="shard 1 fell over"):
        if tally:
            _sharded_tally(pks, msgs, sigs, powers)
        else:
            _sharded_mask(batch.ED25519, pks, msgs, sigs)
    assert calls == [32, 8]


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pks, msgs, sigs, powers = _ed_batch(2, b"mesh-nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sharded_tally(pks, msgs, sigs, powers, mesh=("cuda",) * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sharded_mask(batch.ED25519, pks, msgs, sigs, mesh=("cuda",) * 2)


@pytest.mark.parametrize("tally", [True, False])
def test_verifier_mixed_flush_on_four_shards(tally, monkeypatch):
    """A mixed-curve set with repeated items: each curve's lanes through its
    sharded step on four CPU shards give the mask, tally and bitarray of
    the single-device verifier (cache on) and the reference's
    CPUBatchVerifier."""
    items = mixed_items([batch.ED25519, batch.SR25519, batch.ED25519, batch.SECP256K1], n=160)
    items += items[:6]  # relayed a second time: folded onto their first lane
    single = batch.TorchBatchVerifier(device="cpu")
    for port_key, _ref_key, msg, sig, power in items:
        single.add(port_key, msg, sig, power)
    got = single.verify_tally() if tally else single.verify()
    assert single.cache_stats == {"lanes": 166, "hits": 0, "dedup": 6, "dispatched": 160}

    widths = {curve: _spy_widths(monkeypatch, mod, name)
              for curve, mod, name in ((batch.ED25519, kernel, "verify_packed"),
                                       (batch.SR25519, kernel, "sr_verify_packed"),
                                       (batch.SECP256K1, k1_kernel, "verify_packed"))}
    mask = np.zeros(len(items), dtype=bool)
    tallied = 0
    for curve in _MASK_STEPS:
        idx = [i for i, item in enumerate(items) if item[0].type_value() == curve]
        keys, _ref_keys, msgs, sigs, powers = (list(col) for col in
                                               zip(*(items[i] for i in idx)))
        pks = [key.bytes() for key in keys]
        if curve == batch.ED25519 and tally:
            m, ed_sum = _sharded_tally(pks, msgs, sigs, powers)
            tallied += ed_sum
        else:
            m = _sharded_mask(curve, pks, msgs, sigs)
            tallied += sum(itertools.compress(powers, m.tolist()))
        mask[idx] = m
        assert widths[curve] == [hi - lo for lo, hi in sh.shard_bounds(len(idx), 4)]
    sharded = (bool(mask.all()), mask.tolist(), tallied)
    assert got == (sharded if tally else sharded[:2])

    refv = jbatch.CPUBatchVerifier()
    for _port_key, ref_key, msg, sig, power in items:
        refv.add(ref_key, msg, sig, power)
    assert got == (refv.verify_tally() if tally else refv.verify())
    assert single.cache_stats == refv.cache_stats
    if tally:
        np.testing.assert_array_equal(single.bit_words, sh.pack_words(mask, "cpu"))
        np.testing.assert_array_equal(single.bit_words, _words(got[1]).astype(np.uint32))
