"""The secp256k1 fast-sync cell of the benchmark (``fastsync10k-secp256k1``)
on the CPU: its plain reference against OpenSSL and the port's oracle, its
signed pool, its roofline count against ``chip_smoke.py``'s, and the
port's daemon answering a small pool of it through its socket, with the
secp256k1 flush's spans."""

import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import encode_dss_signature

import chip_smoke
from benchmark import k1_readers, roofline_k1, run, wire
from benchmark.pools import ed25519_votes, secp256k1_votes
from benchmark.reference import secp256k1 as ref
from tests import torch_corpus as corpus
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.gpu import k1_verify
from tmtpu_torch.libs import trace
from tmtpu_torch.sidecar.server import SidecarServer

N = secp256k1_votes.N

CFG = {"validators": 16, "vote_types": ["precommit"], "chain_heights": 2,
       "chain_id": "k1-test", "chain_seed": 3, "first_height": 500, "power_min": 1,
       "power_max": 10 ** 12, "genesis_time_ns": 1_700_000_000_000_000_000}


@pytest.fixture(scope="module")
def pool():
    return secp256k1_votes.Pool(CFG, workers=1)


def _is_high_s_twin(bad, sig):
    return bad[:32] == sig[:32] and int.from_bytes(bad[32:], "big") == N - int.from_bytes(
        sig[32:], "big")


def _corrupted(pool, kind, entries, seed):
    """(entry, corrupted signature) of each of ``entries``, by ``corrupt``
    drawing ``kind``: a flipped byte or the high-S twin."""
    rng = random.Random(seed)
    out = []
    for e in entries:
        while True:
            bad = secp256k1_votes.corrupt(pool.sigs[e], rng)
            if _is_high_s_twin(bad, pool.sigs[e]) == (kind == "high_s"):
                out.append((e, bad))
                break
    return out


def _openssl(pk, msg, sig):
    if len(sig) != 64:
        return False
    key = ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256K1(), pk)
    der = encode_dss_signature(int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big"))
    try:
        key.verify(der, msg, ec.ECDSA(hashes.SHA256()))
    except InvalidSignature:
        return False
    return True


@pytest.mark.parametrize("kind,want_openssl", [("valid", True), ("flipped", False),
                                               ("high_s", True)])
def test_reference_against_openssl_and_the_port_oracle(pool, kind, want_openssl):
    """Valid lanes pass everywhere; a flipped byte fails everywhere; the
    high-S twin passes OpenSSL and fails Tendermint's rule, in the
    reference and in the port's oracle alike."""
    if kind == "valid":
        lanes = [(e, pool.sigs[e]) for e in range(0, pool.size, 3)]
    else:
        lanes = _corrupted(pool, kind, range(1, pool.size, 4), 11)
    pks = [pool.pks[pool.validator_of(e)] for e, _ in lanes]
    msgs = [pool.msgs[e] for e, _ in lanes]
    sigs = [sig for _, sig in lanes]
    want = kind == "valid"
    assert [ref.verify(*lane) for lane in zip(pks, msgs, sigs)] == [want] * len(lanes)
    assert corpus.k1_oracle(pks, msgs, sigs).tolist() == [want] * len(lanes)
    assert [_openssl(*lane) for lane in zip(pks, msgs, sigs)] == [want_openssl] * len(lanes)


@pytest.mark.parametrize("corpus_name", ["adversarial", "edges"])
def test_reference_agrees_with_the_port_oracle_on_the_edges(corpus_name):
    pks, msgs, sigs = {"adversarial": corpus.k1_adversarial, "edges": corpus.k1_edges}[
        corpus_name]()
    got = np.array([ref.verify(*lane) for lane in zip(pks, msgs, sigs)])
    want = corpus.k1_oracle(pks, msgs, sigs)
    assert got.tolist() == want.tolist()
    assert want.any() and not want.all()


def test_pool_layout_and_corrupt(pool):
    v = CFG["validators"]
    assert pool.size == CFG["chain_heights"] * v
    assert pool.powers == ed25519_votes.powers(CFG)
    for slot in range(CFG["chain_heights"]):
        for i in (0, 7, v - 1):
            e = pool.entry(slot, "precommit", i)
            assert e == slot * v + i and pool.validator_of(e) == i
            assert pool.msgs[e] == ed25519_votes.sign_bytes(CFG, slot, "precommit", i)
    assert all(len(pk) == 33 and pk[0] in (2, 3) for pk in pool.pks)
    assert len(set(pool.pks)) == v
    assert all(len(s) == 64 and 0 < int.from_bytes(s[32:], "big") <= N // 2 for s in pool.sigs)
    assert len(set(pool.sigs)) == pool.size
    rng = random.Random(5)
    kinds = set()
    for e in range(pool.size):
        bad = secp256k1_votes.corrupt(pool.sigs[e], rng)
        kinds.add(_is_high_s_twin(bad, pool.sigs[e]))
        assert bad != pool.sigs[e] and len(bad) == 64
        assert not ref.verify(pool.pks[pool.validator_of(e)], pool.msgs[e], bad)
    assert kinds == {True, False}


def test_roofline_count_is_chip_smokes(pool):
    """The benchmark's count from the lanes equals ``chip_smoke.py``'s from
    the port's packed plane of the same lanes, host-refused lanes
    included."""
    lanes = [(pool.pks[pool.validator_of(e)], pool.msgs[e], pool.sigs[e])
             for e in range(pool.size)]
    for kind in ("flipped", "high_s"):
        lanes += [(pool.pks[pool.validator_of(e)], pool.msgs[e], bad)
                  for e, bad in _corrupted(pool, kind, range(4), 12)]
    for make in (corpus.k1_adversarial, corpus.k1_edges):
        lanes += list(zip(*make()))
    packed, host_ok = k1_verify.prepare_k1_batch_packed(*zip(*lanes))
    assert not host_ok.all()
    products = roofline_k1.lane_products(lanes)
    assert int(products.sum()) == chip_smoke.k1_products(packed)
    assert roofline_k1.bound_s(int(products.sum()), len(lanes)) == pytest.approx(
        products.sum() / roofline_k1.roofline.INT_MULS_PER_S)


@pytest.fixture(scope="module")
def served(pool, tmp_path_factory):
    """Each height of the pool as one commit request with tally, from two
    clients at once, to the port's daemon on the CPU (one joint dispatch):
    (the requests' entries and corrupted signatures, the replies' fields,
    the spans the daemon's process recorded)."""
    v = CFG["validators"]
    # each height: two lanes of one kind of corruption and one of the other
    bad = dict(_corrupted(pool, "flipped", (2, 9, v + 5), 20)
               + _corrupted(pool, "high_s", (13, v + 1, v + 14), 21))
    requests = []
    for slot in range(CFG["chain_heights"]):
        entries = list(range(slot * v, (slot + 1) * v))
        lanes = b"".join(wire.lane_blob(pool.pks[pool.validator_of(e)], pool.msgs[e],
                                        bad.get(e, pool.sigs[e]),
                                        pool.powers[pool.validator_of(e)]) for e in entries)
        requests.append((entries, wire.verify_frame(slot + 1, "secp256k1", True, 120_000, lanes)))
    path = tmp_path_factory.mktemp("k1d")
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    srv = SidecarServer(f"unix://{path}/k1.sock", device="cpu")
    srv.coalescer.scheduler.gather_wait_s = lambda pending: 2.0
    srv.start()
    replies = [None] * len(requests)
    try:
        trace.drain()
        barrier = threading.Barrier(len(requests))

        def send(k):
            sock, reader = wire.connect(srv.addr, f"node{k}")
            try:
                sock.settimeout(120.0)
                barrier.wait(timeout=30)
                sock.sendall(requests[k][1])
                replies[k] = wire.decode_body(reader.read_body())
            finally:
                sock.close()

        threads = [threading.Thread(target=send, args=(k,)) for k in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        spans = trace.drain()
    finally:
        srv.stop()
        sigcache.DEFAULT.invalidate_all()
    return requests, bad, replies, spans


def test_daemon_answers_with_the_references_masks_and_tallies(pool, served):
    requests, bad, replies, _spans = served
    for (entries, _frame), reply in zip(requests, replies):
        kind, fields = reply
        assert kind == wire.VERIFY_RESPONSE and fields.get("status", 0) == wire.STATUS_OK
        want = [ref.verify(pool.pks[pool.validator_of(e)], pool.msgs[e],
                           bad.get(e, pool.sigs[e])) for e in entries]
        assert want.count(False) == 3
        assert wire.unpack_mask(fields["mask"], len(entries)).tolist() == want
        assert fields["tallied"] == sum(pool.powers[pool.validator_of(e)]
                                        for e, ok in zip(entries, want) if ok)
        assert fields["dispatch_lanes"] == 2 * len(entries)


def test_daemon_flush_records_the_k1_spans(pool, served):
    """One secp256k1 dispatch: prepare, the plane's copy, the kernel, the
    mask's copy back and the host tally, each with the dispatch's lanes,
    prepare with the lanes its checks refused; the ed25519 flush's span is
    never opened."""
    requests, bad, _replies, spans = served
    names = ("secp256k1.prepare", "secp256k1.device_put", "secp256k1.execute",
             "secp256k1.readback", "crypto.host_tally", "crypto.batch_verify_tally")
    tree = [(sp.name, sp.attrs.get("lanes")) for sp in sorted(spans, key=lambda sp: sp.start_s)
            if sp.name in names]
    lanes = 2 * CFG["validators"]
    assert tree == [(name, lanes) for name in names[:5]]
    by_name = {sp.name: sp for sp in spans}
    lanes_sent = [(pool.pks[pool.validator_of(e)], pool.msgs[e], bad.get(e, pool.sigs[e]))
                  for entries, _frame in requests for e in entries]
    _packed, host_ok = k1_verify.prepare_k1_batch_packed_plain(*zip(*lanes_sent))
    rejected = int((~host_ok).sum())
    assert rejected >= 3  # the high-S twins
    assert by_name["secp256k1.prepare"].attrs == {"lanes": lanes, "rejected": rejected}
    assert by_name["crypto.host_tally"].attrs == {"curve": "secp256k1", "lanes": lanes}
    assert by_name["secp256k1.execute"].attrs == {"impl": "torch", "lanes": lanes}
    ends = [by_name[n].start_s + by_name[n].duration_s for n in names[:4]]
    starts = [by_name[n].start_s for n in names[1:5]]
    assert all(e <= s for e, s in zip(ends, starts))


def test_readers_on_synthetic_spans_and_kernels(pool):
    """The cell's readers: prep and copies per 1,000 lanes from the
    window's spans only; the roofline from the kernels matched to a
    request by its one ``secp256k1.execute`` span; nothing to read on a
    program without the copy spans."""
    v = CFG["validators"]

    def span(name, start, dur, lanes):
        return {"name": name, "start_s": start, "dur_s": dur, "attrs": {"lanes": lanes}}

    reqs = [{"sent": 10.0 + k, "replied": 10.5 + k, "lanes": v, "in_window": True,
             "entries": np.arange(k % 2 * v, (k % 2 + 1) * v)} for k in range(3)]
    spans = [span("secp256k1.prepare", 9.0, 9.0, v)]      # before the window
    kernels = []
    for k in range(3):
        t = 10.1 + k
        spans += [span("secp256k1.prepare", t, 0.2, v), span("secp256k1.device_put", t + 0.2,
                                                               0.001, v),
                  span("secp256k1.execute", t + 0.201, 0.002, v),
                  span("secp256k1.readback", t + 0.203, 0.0005, v)]
        kernels.append((t + 0.2015, t + 0.2025, "void quad_verify_kernel<K1Quad>(...)"))
    spans.append(span("secp256k1.execute", 12.3, 0.002, v))   # a second one in request 2
    ctx = run.Ctx(t0=10.0, t1=20.0, requests=reqs, spans=spans, pool=pool, corrupted={},
                  device_events=kernels + [(10.2, 10.3, "Memcpy HtoD (Pageable -> Device)")])
    assert k1_readers.k1_prep_ms_per_klane(ctx) == pytest.approx(0.6 * 1e6 / (3 * v))
    assert k1_readers.k1_copy_ms_per_klane(ctx) == pytest.approx(0.0045 * 1e6 / (3 * v))
    need = sum(roofline_k1.bound_s(int(roofline_k1.lane_products(
        [(pool.pks[pool.validator_of(e)], pool.msgs[e], pool.sigs[e])
         for e in r["entries"]]).sum()), v) for r in reqs[:2])
    assert k1_readers.secp256k1_roofline(ctx) == pytest.approx(100 * need / 0.002)
    ctx.spans = [s for s in spans if s["name"] not in ("secp256k1.device_put",
                                                        "secp256k1.readback")]
    assert k1_readers.k1_copy_ms_per_klane(ctx) is None


def test_new_benchmark_modules_load_nothing_of_the_program():
    code = ("import sys\n"
            "from benchmark import k1_readers, roofline_k1\n"
            "from benchmark.pools import secp256k1_votes\n"
            "from benchmark.reference import secp256k1\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tmtpu', 'tmtpu_torch', 'torch'}))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
