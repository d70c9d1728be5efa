"""The lane columns (``tmtpu_torch/crypto/lanes.py``): a flush's keys,
messages and signatures as one byte buffer with per-lane offsets, from
the sidecar's frame body through the coalescer's join, the signature
cache's resolve and the host preps, held against the lists they replace.

- The view path (columns over a decoded frame body, taken and sliced as
  the resolve takes its misses) and the lists path give the same cache
  keys, ``rep``, planes and host verdicts, equal to ``sigcache.cache_key``
  and the plain preps, on the adversarial corpora (wrong lengths, s >= L,
  non-canonical A.y, high-S twins, flipped bytes).
- A joint dispatch of several requests reads one buffer; a lone request's
  columns reach the engine unchanged; each request gets its slice and
  its exact tally, past 2^63 too.
- Duplicate lanes fold their powers onto one lane, in Python ints.
- A body the C walk defers decodes through the Python walk into lists,
  which the resolve joins (``sigcache.resolve`` ``columns=joined``); a
  decoded view goes through as it is (``columns=view``).
"""

import io

import numpy as np
import pytest

from tests import torch_corpus as corpus
from tmtpu_torch import native
from tmtpu_torch.crypto import batch as crypto_batch
from tmtpu_torch.crypto import lanes, sigcache
from tmtpu_torch.crypto.ed25519 import PubKeyEd25519
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv
from tmtpu_torch.libs import trace
from tmtpu_torch.sidecar import coalescer as coal
from tmtpu_torch.sidecar import protocol as proto
from tmtpu_torch.sidecar.protoio import tag

ED, SR, K1 = crypto_batch.ED25519, crypto_batch.SR25519, crypto_batch.SECP256K1


@pytest.fixture(autouse=True)
def _fresh_port_sigcache():
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    yield
    sigcache.DEFAULT.invalidate_all()


def _body(curve, pks, msgs, sigs, powers, request_id=7):
    frame = proto.encode_verify_frame(request_id, curve, True, 0, pks, msgs, sigs, powers)
    return proto.FrameReader(io.BytesIO(frame), max_frame_bytes=1 << 26).read_body()


def _decoded(curve, pks, msgs, sigs, powers=None, request_id=7):
    """The lanes as the daemon's decode gives them: columns over a body."""
    powers = list(range(1, len(sigs) + 1)) if powers is None else powers
    cols, walk = proto.decode_verify_walk(_body(curve, pks, msgs, sigs, powers, request_id))
    assert walk == "native"
    assert all(isinstance(c, lanes.ByteColumn) for c in (cols.pks, cols.msgs, cols.sigs))
    assert isinstance(cols.powers, lanes.IntColumn)
    return cols


def _k1_twins():
    """Valid secp256k1 lanes, each followed by its high-S twin R || (n - s)
    and a copy with a flipped message byte."""
    pks, msgs, sigs = corpus.k1_signed(6, 41)
    out = ([], [], [])
    for pk, m, s in zip(pks, msgs, sigs):
        twin = s[:32] + (corpus.K1_N - int.from_bytes(s[32:], "big")).to_bytes(32, "big")
        for lane in ((pk, m, s), (pk, m, twin), (pk, corpus.flip(m, 0), s)):
            for col, v in zip(out, lane):
                col.append(v)
    return out


CASES = {
    **{f"ed25519-{k}": (ED, v) for k, v in corpus.CORPORA.items()},
    **{f"secp256k1-{k}": (K1, v) for k, v in corpus.K1_CORPORA.items()},
    "secp256k1-high-S twins": (K1, _k1_twins),
    **{f"sr25519-{k}": (SR, v) for k, v in corpus.SR_CORPORA.items()},
}
PREPS = {ED: (tv.prepare_batch_packed, tv.prepare_batch_packed_plain),
         K1: (kv.prepare_k1_batch_packed, kv.prepare_k1_batch_packed_plain),
         SR: (sv.prepare_sr_batch_packed, sv.prepare_sr_batch_packed_plain)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_view_and_lists_give_the_same_keys_planes_and_verdicts(case):
    curve, make = CASES[case]
    pks, msgs, sigs = (list(c) for c in make())
    # repeats, so the resolve folds lanes onto their first
    for i in (0, 2, 0):
        pks.append(pks[i]), msgs.append(msgs[i]), sigs.append(sigs[i])
    cols = _decoded(curve, pks, msgs, sigs)
    want_keys = [sigcache.cache_key(curve, p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    for types in (curve, [curve] * len(sigs)):
        keys, rep = native.resolve(None, types, cols.pks, cols.msgs, cols.sigs)
        assert [k.tobytes() for k in keys] == want_keys
        keys_l, rep_l = native.resolve(None, types, pks, msgs, sigs)
        np.testing.assert_array_equal(keys_l, keys)
        np.testing.assert_array_equal(rep_l, rep)
    assert rep[-3:].tolist() == [0, 2, 0] and rep[:-3].tolist() == list(range(len(sigs) - 3))
    prep, plain = PREPS[curve]
    want_packed, want_ok = plain(pks, msgs, sigs)
    for packed, ok in (prep(cols.pks, cols.msgs, cols.sigs), prep(pks, msgs, sigs)):
        np.testing.assert_array_equal(packed, want_packed)
        np.testing.assert_array_equal(ok, want_ok)
    # the lanes a resolve takes, in another order, read the same buffer
    idx = np.arange(len(sigs))[::-1][::2]
    taken = [c.take(idx) for c in (cols.pks, cols.msgs, cols.sigs)]
    assert all(c.buf is cols.pks.buf for c in taken)
    sub_packed, sub_ok = prep(*taken)
    np.testing.assert_array_equal(sub_packed, want_packed[:, idx])
    np.testing.assert_array_equal(sub_ok, want_ok[idx])
    keys_sub, _ = native.resolve(None, curve, *taken)
    np.testing.assert_array_equal(keys_sub, keys[idx])


def test_corpora_reach_the_host_refusals():
    """The cases above hold what they are meant to: wrong lengths, s >= L
    and y >= p for ed25519, the high-S twins and flips for secp256k1."""
    ok = tv.prepare_batch_packed(*corpus.lengths())[1]
    assert ok.tolist() == [True, False, False, False, False, True]
    ok = tv.prepare_batch_packed(*corpus.adversarial())[1]
    assert not ok[4] and not ok[5] and not ok[8]
    ok = kv.prepare_k1_batch_packed(*_k1_twins())[1]
    assert ok.tolist() == [True, False, True] * 6


@pytest.mark.parametrize("kind", ["bytes", "ints"])
def test_take_and_slices_of_a_view(kind):
    if kind == "bytes":
        values = [bytes([i]) * (i % 5) for i in range(12)]
        col = lanes.ByteColumn.join(values)
    else:
        values = [(-1) ** i * 2**62 + i for i in range(12)]
        col = lanes.power_column(values)
        assert isinstance(col, lanes.IntColumn)
    assert len(col) == 12 and col == values and list(col) == values
    assert col[3] == values[3] and col[-1] == values[-1]
    assert type(col[3]) is type(values[3])
    for sl in (slice(2, 9), slice(None, None, 3), slice(10, 1, -2), slice(5, 5)):
        part = col[sl]
        assert type(part) is type(col) and part == values[sl]
    idx = np.array([11, 0, 0, 7, 3])
    assert col.take(idx) == [values[i] for i in idx]
    assert lanes.take(values, idx) == [values[i] for i in idx]
    assert col != values[:-1] and col != values[::-1]
    if kind == "bytes":
        assert col[2:9].buf is col.buf and col.take(idx).buf is col.buf
        assert col.lengths().tolist() == [len(v) for v in values]
        assert all(type(v) is bytes for v in col)
        # a strided slice still reaches C (its offsets made contiguous)
        keys = native.cache_keys(ED, col[::2], col[1::2], col[::2])
        want = [sigcache.cache_key(ED, a, b, a) for a, b in zip(values[::2], values[1::2])]
        assert [k.tobytes() for k in keys] == want


class _Engine:
    """A verify engine that records the columns it was handed and answers
    a lane valid where its signature's first byte is even."""

    def __init__(self):
        self.calls = []

    def __call__(self, curve, pks, msgs, sigs, powers, tally):
        self.calls.append((pks, msgs, sigs, powers))
        return [s[0] % 2 == 0 for s in sigs]


def _request(walk, seed, n, powers):
    pks, msgs, sigs = corpus.signed(n, seed)
    if walk == "native":
        cols = _decoded(ED, pks, msgs, sigs, powers)
        pks, msgs, sigs, powers = cols.pks, cols.msgs, cols.sigs, cols.powers
    return coal.PendingRequest(f"c{seed}", ED, pks, msgs, sigs, powers, True, None,
                               request_id=seed)


BIG = 2**63 - 1


@pytest.mark.parametrize("walks", [("native",), ("python",), ("native", "native"),
                                   ("native", "python", "native")],
                         ids=["one view", "one list", "two views", "views and lists"])
def test_joint_dispatch_of_several_requests(walks):
    engine = _Engine()
    c = coal.Coalescer(engine)
    live = [_request(w, 50 + k, 5 + 3 * k, [BIG - k] * (5 + 3 * k) if k % 2 else
                     list(range(5 + 3 * k)))
            for k, w in enumerate(walks)]
    c._verify_joint(ED, live, 1, len(live))
    (pks, msgs, sigs, powers), = engine.calls
    if len(live) == 1:
        assert (pks, msgs, sigs, powers) == (live[0].pks, live[0].msgs, live[0].sigs,
                                             live[0].powers)
        assert pks is live[0].pks and powers is live[0].powers
    else:
        assert isinstance(pks, lanes.ByteColumn) and pks.buf is msgs.buf is sigs.buf
        assert isinstance(powers, lanes.IntColumn)
    want_mask = []
    for col, got in zip(("pks", "msgs", "sigs", "powers"), (pks, msgs, sigs, powers)):
        assert list(got) == [v for r in live for v in getattr(r, col)]
    for req in live:
        want = [s[0] % 2 == 0 for s in req.sigs]
        want_mask += want
        assert req.mask == want and req.dispatch_lanes == len(sigs)
        assert req.tallied == sum(p for p, ok in zip(req.powers, want) if ok)
        assert type(req.tallied) is int
    assert [v for r in live for v in r.mask] == want_mask
    assert any(r.tallied >= 2**63 for r in live) == (len(live) > 1)


class _Recorder(crypto_batch.BatchVerifier):
    """The resolve with a device stand-in: every dispatched lane is valid,
    and the lanes and powers it was handed are kept."""

    def __init__(self):
        super().__init__()
        self.dispatched = []

    def _verify_pending(self, lanes_, tally):
        self.dispatched.append(lanes_)
        mask = [True] * len(lanes_)
        return mask, lanes.tally(lanes_.powers, mask)


def _fill(bv, how, curve, pks, msgs, sigs, powers):
    if how == "view":
        cols = _decoded(curve, pks, msgs, sigs, powers)
        bv.add_lanes(curve, cols.pks, cols.msgs, cols.sigs, cols.powers)
    elif how == "lists":
        bv.add_lanes(curve, pks, msgs, sigs, powers)
    else:
        for p, m, s, w in zip(pks, msgs, sigs, powers):
            bv.add(PubKeyEd25519(p), m, s, w)


@pytest.mark.parametrize("how", ["view", "lists", "items"])
def test_duplicate_lanes_fold_their_powers_onto_one_lane(how):
    pks, msgs, sigs = corpus.signed(3, 61)
    order = [0, 1, 0, 0, 2, 1]
    powers = [2**62, 5, 2**62, 2**62, 7, 9]
    bv = _Recorder()
    _fill(bv, how, ED, [pks[i] for i in order], [msgs[i] for i in order],
          [sigs[i] for i in order], powers)
    all_ok, mask, tallied = bv.verify_tally()
    assert all_ok and mask == [True] * 6
    assert tallied == sum(powers) and tallied > 2**63
    (sub,) = bv.dispatched
    assert len(sub) == 3 and list(sub.sigs) == sigs
    assert list(sub.powers) == [3 * 2**62, 14, 7]
    assert bv.cache_stats == {"lanes": 6, "hits": 0, "dedup": 3, "dispatched": 3}


@pytest.mark.parametrize("where", ["IntColumn", "list", "resolve hits"])
def test_a_tally_past_2_63(where):
    powers = [BIG, BIG - 1, -5, BIG, 2**40] * 2000
    mask = np.arange(len(powers)) % 3 != 1
    want = sum(p for p, ok in zip(powers, mask) if ok)
    assert want > 2**72
    if where == "IntColumn":
        assert lanes.tally(lanes.power_column(powers), mask) == want
        assert lanes.tally(lanes.power_column(powers), mask.tolist()) == want
    elif where == "list":
        big = powers + [2**70]
        col = lanes.power_column(big)
        assert isinstance(col, list)
        assert lanes.tally(col, mask.tolist() + [True]) == want + 2**70
    else:
        # the hits' powers are summed on the host from an IntColumn
        pks, msgs, sigs = corpus.signed(4, 71)
        keys = [sigcache.cache_key(ED, p, m, s) for p, m, s in zip(pks, msgs, sigs)]
        sigcache.DEFAULT.add_many(keys)
        bv = _Recorder()
        _fill(bv, "view", ED, pks, msgs, sigs, [BIG] * 4)
        assert bv.verify_tally()[2] == 4 * BIG and not bv.dispatched


def _spans(name):
    return [s for s in trace.drain() if s.name == name]


@pytest.mark.parametrize("how", ["view", "lists", "items"])
def test_resolve_span_says_how_the_columns_came(how):
    pks, msgs, sigs = corpus.signed(4, 81)
    trace.drain()
    bv = _Recorder()
    _fill(bv, how, ED, pks, msgs, sigs, [1, 2, 3, 4])
    assert bv.verify_tally()[2] == 10
    (span,) = _spans("sigcache.resolve")
    assert span.attrs["columns"] == ("view" if how == "view" else "joined")
    assert span.attrs["lanes"] == 4 and span.attrs["hits"] == 0


def test_a_body_the_c_walk_defers_decodes_through_the_python_walk():
    """A curve field repeated after a non-ASCII one: the C walk defers, the
    Python walk gives lists, which the coalescer joins with a view and the
    resolve joins on its own."""
    pks, msgs, sigs = corpus.signed(3, 91)
    body = _body(ED, pks, msgs, sigs, [3, 4, 5])
    deferred = body[:1] + tag(2, 2) + b"\x02\xc3\xa9" + body[1:]
    cols, walk = proto.decode_verify_walk(deferred)
    assert walk == "python" and type(cols.pks) is list and cols.curve == ED
    assert (cols.pks, cols.msgs, cols.sigs, cols.powers) == (pks, msgs, sigs, [3, 4, 5])
    assert proto.decode_verify_columns(body) == cols
    trace.drain()
    bv = _Recorder()
    bv.add_lanes(ED, cols.pks, cols.msgs, cols.sigs, cols.powers)
    assert bv.verify_tally()[2] == 12
    assert [s.attrs["columns"] for s in _spans("sigcache.resolve")] == ["joined"]
    engine = _Engine()
    live = [coal.PendingRequest("a", ED, cols.pks, cols.msgs, cols.sigs, cols.powers,
                                True, None),
            _request("native", 92, 2, [1, 1])]
    coal.Coalescer(engine)._verify_joint(ED, live, 1, 2)
    (jpks, _, jsigs, jpowers), = engine.calls
    assert isinstance(jpks, lanes.ByteColumn) and list(jsigs) == sigs + list(live[1].sigs)
    assert list(jpowers) == [3, 4, 5, 1, 1]


@pytest.mark.parametrize("how", ["view", "lists"])
def test_engine_masks_and_tally_on_the_cpu(how):
    """The daemon's engine (``verify_lanes``) on the plain device graph:
    the adversarial block with a repeated lane, from a decoded body and
    from lists, against the oracle."""
    pks, msgs, sigs = corpus.adversarial()
    keep = [i for i, p in enumerate(pks) if len(p) == 32]  # a wrong-size key fails all
    pks, msgs, sigs = ([c[i] for i in keep + [0, 1]] for c in (pks, msgs, sigs))
    powers = [2**62 + i for i in range(len(sigs))]
    want = corpus.oracle(pks, msgs, sigs).tolist()
    if how == "view":
        cols = _decoded(ED, pks, msgs, sigs, powers)
        args = (cols.pks, cols.msgs, cols.sigs, cols.powers)
    else:
        args = (pks, msgs, sigs, powers)
    bv = crypto_batch.TorchBatchVerifier("cpu")
    bv.add_lanes(ED, *args)
    all_ok, mask, tallied = bv.verify_tally()
    assert mask == want and not all_ok
    assert tallied == sum(p for p, ok in zip(powers, want) if ok)
    assert bv.cache_stats["dedup"] == 2


@pytest.mark.parametrize("order", ["view, items, lists", "lists, items, view"])
def test_several_adds_join_in_order(order):
    """Columns, items and lists added to one verifier reach the flush in
    add order, joined once (``columns=joined``), the curves kept a lane;
    the caller's lists are not appended to."""
    ed = corpus.signed(3, 101)
    k1 = corpus.k1_signed(2, 102)
    k1_lists = [list(c) for c in k1]
    bv = _Recorder()
    want_pks, want_types, want_powers = [], [], []
    for step in order.split(", "):
        if step == "view":
            _fill(bv, "view", ED, *ed, [1, 2, 3])
            want_pks += ed[0]
            want_types += [ED] * 3
            want_powers += [1, 2, 3]
        elif step == "items":
            _fill(bv, "items", ED, *ed, [2**63, 5, 6])
            want_pks += ed[0]
            want_types += [ED] * 3
            want_powers += [2**63, 5, 6]
        else:
            bv.add_lanes(K1, *k1_lists, [7, 8])
            want_pks += k1[0]
            want_types += [K1] * 2
            want_powers += [7, 8]
    trace.drain()
    assert len(bv) == 8
    _ok, mask, tallied = bv.verify_tally()
    assert [s.attrs["columns"] for s in _spans("sigcache.resolve")] == ["joined"]
    (sub,) = bv.dispatched
    # the items repeat the view's lanes: their powers fold onto the first
    assert bv.cache_stats["dedup"] == 3 and len(sub) == 5
    assert tallied == sum(want_powers) and mask == [True] * 8
    assert list(sub.pks) == list(dict.fromkeys(want_pks))
    assert sub.types == [t for t, p in dict.fromkeys(zip(want_types, want_pks))]
    assert [list(c) for c in k1_lists] == [list(c) for c in k1]


@pytest.mark.parametrize("lo,hi", [([0, -1], [2, 3]), ([0, 3], [2, 2]), ([0, 2], [2, 9]),
                                   ([0, 1], [2])],
                         ids=["below the buffer", "hi before lo", "past the buffer",
                              "short offsets"])
def test_offsets_outside_the_buffer_raise_before_any_c_call(lo, hi):
    col = lanes.ByteColumn(np.frombuffer(b"abcdef", dtype=np.uint8), np.array(lo),
                           np.array(hi))
    good = lanes.ByteColumn.join([b"x", b"y"])
    with pytest.raises(ValueError, match="offsets lie outside"):
        native.cache_keys(ED, good, good, col)
    with pytest.raises(ValueError, match="offsets lie outside"):
        native.prep_ed25519(col, good, good)
