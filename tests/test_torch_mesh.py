"""The port's lane split (tmtpu_torch/gpu/mesh_dispatch.py and the sharded
half of gpu/sharding.py) on four CPU shards, against the reference's mesh
dispatch on its 4-device virtual CPU mesh (tests/conftest.py), the port's
single-device path, the per-lane oracles and the reference's
CPUBatchVerifier. Every comparison is exact: masks, tallies, bitarray
words and cache_stats bit for bit.

CPU shards run one after another through the plain PyTorch versions,
seconds a shard whatever its width, so the corpora stay at a few hundred
lanes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_corpus as corpus
from tests.test_torch_mixed import _words, mixed_items
from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import ed25519 as jed
from tmtpu.libs import breaker as jbk
from tmtpu.tpu import mesh_dispatch as jmd
from tmtpu.tpu import sharding as jsh
from tmtpu_torch.crypto import batch, sigcache
from tmtpu_torch.gpu import k1_kernel, kernel, mesh_dispatch as md, sharding as sh
from tmtpu_torch.gpu import verify as tv

CPU4 = (torch.device("cpu"),) * 4


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """An empty, enabled port signature cache and zeroed mesh counters for
    every test; the mesh knobs back at the port's defaults after."""
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    md.reset()
    yield
    sigcache.DEFAULT.invalidate_all()
    md.set_overrides(**md.DEFAULTS)
    md.reset()


@pytest.fixture
def mesh4(monkeypatch):
    """Four shards on the CPU, every flush routed (the reference's fixture,
    tests/test_mesh_dispatch.py)."""
    monkeypatch.setenv("TMTPU_MESH_DEVICES", "4")
    monkeypatch.setenv("TMTPU_SHARD_MIN_LANES", "1")
    jmd.reset()
    jmd.breaker().reset()
    yield
    jmd.reset()
    jmd.breaker().reset()
    jbk.get(jbatch.BREAKER_NAME).reset()


def _ed_batch(n, tag, bad=()):
    """The reference's mesh corpus (tests/test_mesh_dispatch.py): n distinct
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


def test_mesh_tally_matches_reference_mesh(mesh4):
    """The acceptance scenario at the reference's tier-1 shape: 128 lanes,
    3 corrupt, on four CPU shards against the reference's sharded flush on
    its 4-device virtual mesh."""
    pks, msgs, sigs, powers = _ed_batch(128, b"mesh-eq", bad={3, 17, 100})
    want_mask, want_tally = jmd.batch_verify_tally_mesh(pks, msgs, sigs, powers)
    mask, tally = md.batch_verify_tally_mesh(pks, msgs, sigs, powers, device="cpu")
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    assert isinstance(tally, int) and tally == want_tally
    assert tally == sum(p for i, p in enumerate(powers) if i not in (3, 17, 100))
    np.testing.assert_array_equal(sh.pack_bitarray(torch.from_numpy(mask)).numpy()
                                  .astype(np.uint32),
                                  np.asarray(jsh.pack_bitarray(jnp.asarray(want_mask))))
    snap = md.snapshot()
    assert snap["devices"] == 4 and snap["dispatches"] == 1 and snap["shard_min_lanes"] == 1
    assert snap["last"]["shard_lanes"] == [32, 32, 32, 32]
    assert snap["occupancy_lanes"] == {"0": 32, "1": 32, "2": 32, "3": 32}
    assert "breaker" not in snap


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
def test_ragged_widths_split_without_pad_lanes(b, ragged_corpus, mesh4, monkeypatch):
    """Each non-empty shard gets exactly its lanes (no pads, empty shards
    neither copy nor launch); mask, tally and bitarray equal the
    single-device path and the oracle."""
    pks, msgs, sigs, want = ragged_corpus
    widths = _spy_widths(monkeypatch, kernel, "verify_packed")
    powers = [100 + 7 * i for i in range(b)]
    mask, tally = md.batch_verify_tally_mesh(pks[:b], msgs[:b], sigs[:b], powers, device="cpu")
    sizes = [hi - lo for lo, hi in sh.shard_bounds(b, 4)]
    assert widths == sizes and sum(sizes) == b
    np.testing.assert_array_equal(mask, want[:b])
    assert tally == sum(p for p, ok in zip(powers, want[:b]) if ok)
    np.testing.assert_array_equal(sh.pack_words(mask, "cpu"),
                                  _words(want[:b]).astype(np.uint32))
    assert md.snapshot()["last"]["shard_lanes"] == sizes + [0] * (4 - len(sizes))


@pytest.mark.parametrize("copies, huge", [(8, False), (9, True)])
def test_tally_past_2_63_split_across_shards(copies, huge, mesh4):
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
    mask, tally = md.batch_verify_tally_mesh(pks, msgs, sigs, powers, device="cpu")
    assert mask.all() and tally == sum(powers) and tally >= 2**63
    assert {j // 32 for j in at} == {0, 1, 2, 3}
    single_mask, single_tally = sh.batch_verify_tally(pks, msgs, sigs, powers, device="cpu")
    np.testing.assert_array_equal(mask, single_mask)
    assert tally == single_tally


@pytest.mark.parametrize("curve", [batch.SR25519, batch.SECP256K1])
def test_sharded_sr_k1_masks_against_oracles(curve, mesh4, monkeypatch):
    if curve == batch.SR25519:
        parts = [corpus.sr_signed(40, 53), corpus.sr_adversarial()]
        oracle, module, name = corpus.sr_oracle, kernel, "sr_verify_packed"
    else:
        parts = [corpus.k1_signed(40, 54), corpus.k1_adversarial(), corpus.k1_edges()]
        oracle, module, name = corpus.k1_oracle, k1_kernel, "verify_packed"
    pks, msgs, sigs = (sum(cols, []) for cols in zip(*parts))
    widths = _spy_widths(monkeypatch, module, name)
    mask = md.batch_verify_mesh(curve, pks, msgs, sigs, device="cpu")
    want = oracle(pks, msgs, sigs)
    assert not want.all() and want.any()
    np.testing.assert_array_equal(mask, want)
    assert widths == [hi - lo for lo, hi in sh.shard_bounds(len(sigs), 4)] and len(widths) >= 2
    assert md.snapshot()["last"]["curve"] == curve


@pytest.mark.slow  # two fresh curve-graph compiles on XLA:CPU (minutes)
def test_sharded_sr_k1_match_reference_mesh(mesh4):
    """Against the reference's sharded sr25519 and secp256k1 graphs on its
    4-device mesh (tests/test_mesh_dispatch.py's slow twin)."""
    for curve, (pks, msgs, sigs) in ((batch.SR25519, corpus.sr_signed(64, 55)),
                                     (batch.SECP256K1, corpus.k1_signed(64, 56))):
        sigs[3] = corpus.flip(sigs[3], 1)
        want = jmd.batch_verify_mesh(curve, pks, msgs, sigs)
        mask = md.batch_verify_mesh(curve, pks, msgs, sigs, device="cpu")
        np.testing.assert_array_equal(mask, np.asarray(want))
        assert not mask[3] and mask.sum() == 63


def test_route_threshold_mesh_devices_and_env(monkeypatch):
    monkeypatch.delenv("TMTPU_MESH_DEVICES", raising=False)
    monkeypatch.delenv("TMTPU_SHARD_MIN_LANES", raising=False)
    # the port ships the mesh off (mesh_devices 1), where the reference's
    # default is 0, every device
    assert md.mesh_devices() == 1 and md.shard_min_lanes() == 2048
    assert not md.route(batch.ED25519, 10_000, "cpu")
    # mesh_devices 0 on the CPU is one shard: the mesh is off
    md.set_overrides(mesh_devices=0)
    assert not md.route(batch.ED25519, 10_000, "cpu")
    md.set_overrides(mesh_devices=4, shard_min_lanes=64)
    assert md.mesh_for("cpu") == CPU4
    assert not md.route(batch.ED25519, 63, "cpu")
    assert md.route(batch.ED25519, 64, "cpu")
    # the env overrides the knobs, read at call time
    monkeypatch.setenv("TMTPU_SHARD_MIN_LANES", "100")
    assert not md.route(batch.ED25519, 64, "cpu")
    monkeypatch.setenv("TMTPU_SHARD_MIN_LANES", "not-a-number")
    assert md.route(batch.ED25519, 64, "cpu")
    # mesh_devices 1 is the off switch: no two-shard mesh can exist
    monkeypatch.setenv("TMTPU_MESH_DEVICES", "1")
    assert not md.route(batch.ED25519, 10_000, "cpu")
    with pytest.raises(md.MeshUnavailable):
        md.batch_verify_tally_mesh([b"x"], [b"m"], [b"s"], [1], device="cpu")
    md.configure(type("Crypto", (), {"mesh_devices": 0, "shard_min_lanes": 2048})())
    monkeypatch.delenv("TMTPU_MESH_DEVICES")
    monkeypatch.delenv("TMTPU_SHARD_MIN_LANES")
    assert md.mesh_devices() == 0 and md.shard_min_lanes() == 2048
    # a config object without the knobs gives the port's defaults
    md.configure(object())
    assert md.mesh_devices() == 1 and md.shard_min_lanes() == 2048


@pytest.mark.parametrize("tally", [True, False])
def test_failed_shard_raises_without_fallback(tally, mesh4, monkeypatch):
    """A shard that raises makes the flush raise: the mesh never hands the
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
    bv = batch.TorchBatchVerifier(device="cpu")
    bv.add_lanes(batch.ED25519, pks, msgs, sigs, powers)
    with pytest.raises(RuntimeError, match="shard 1 fell over"):
        bv.verify_tally() if tally else bv.verify()
    assert calls == [32, 8] and md.dispatch_count() == 0


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pks, msgs, sigs, powers = _ed_batch(2, b"mesh-nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        md.batch_verify_tally_mesh(pks, msgs, sigs, powers)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        md.batch_verify_tally_mesh(pks, msgs, sigs, powers, mesh=("cuda",) * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        md.route(batch.ED25519, 10_000)


def _flush(items, tally):
    bv = batch.TorchBatchVerifier(device="cpu")
    for port_key, _ref_key, msg, sig, power in items:
        bv.add(port_key, msg, sig, power)
    out = bv.verify_tally() if tally else bv.verify()
    return bv, out


@pytest.mark.parametrize("tally", [True, False])
def test_verifier_mixed_flush_on_four_shards(tally, monkeypatch):
    """A mixed-curve TorchBatchVerifier flush, cache on, with repeated
    items, routed across four CPU shards: one mesh dispatch per curve, and
    the mask, tally, bitarray and cache_stats of the unsharded verifier and
    the reference's CPUBatchVerifier."""
    items = mixed_items([batch.ED25519, batch.SR25519, batch.ED25519, batch.SECP256K1], n=160)
    items += items[:6]  # relayed a second time: folded onto their first lane
    monkeypatch.setenv("TMTPU_SHARD_MIN_LANES", "1")
    monkeypatch.setenv("TMTPU_MESH_DEVICES", "4")
    widths = {curve: _spy_widths(monkeypatch, mod, name)
              for curve, mod, name in ((batch.ED25519, kernel, "verify_packed"),
                                       (batch.SR25519, kernel, "sr_verify_packed"),
                                       (batch.SECP256K1, k1_kernel, "verify_packed"))}
    sharded, got = _flush(items, tally)
    assert md.dispatch_count() == 3 and sharded.mesh_dispatches == 3
    assert widths == {batch.ED25519: [32, 32, 16], batch.SR25519: [32, 8],
                      batch.SECP256K1: [32, 8]}

    monkeypatch.setenv("TMTPU_MESH_DEVICES", "1")
    sigcache.DEFAULT.invalidate_all()
    single, want = _flush(items, tally)
    assert md.dispatch_count() == 3 and single.mesh_dispatches == 0
    assert got == want and sharded.cache_stats == single.cache_stats
    assert sharded.cache_stats == {"lanes": 166, "hits": 0, "dedup": 6, "dispatched": 160}

    refv = jbatch.CPUBatchVerifier()
    for _port_key, ref_key, msg, sig, power in items:
        refv.add(ref_key, msg, sig, power)
    assert got == (refv.verify_tally() if tally else refv.verify())
    assert sharded.cache_stats == refv.cache_stats
    if tally:
        np.testing.assert_array_equal(sharded.bit_words, single.bit_words)
        np.testing.assert_array_equal(sharded.bit_words, _words(got[1]).astype(np.uint32))
