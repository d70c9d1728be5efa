"""The readers of the daemon's own spans (``span_readers.py``) on
synthetic client records and spans: matched to window requests by client
and request id, each instant of a round trip covered once, and nothing
read from a daemon that records none of them."""

import os

import numpy as np
import pytest

from benchmark import run, span_readers

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ("decode_ms_per_klane", "resolve_ms_per_klane", "queue_wait_ms.replay",
       "reply_ms.replay", "unspanned_ms.replay", "queue_wait_ms.votes", "linger_ms.votes")


def _reader(name):
    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"), "metric_under_test")


def _req(node, sent, replied, lanes=10, status=0, in_window=True):
    return {"node": node, "kind": "commit", "due_abs": sent, "sent": sent,
            "replied": replied, "status": status, "lanes": lanes, "in_window": in_window,
            "entries": np.arange(lanes)}


def _span(name, start, dur, **attrs):
    return {"id": 0, "name": name, "start_s": start, "dur_s": dur, "parent": None,
            "attrs": attrs}


def _ctx(requests, spans):
    return run.Ctx(t0=10.0, t1=20.0, seconds=10.0, requests=requests, spans=spans,
                   device_events=[])


def _request_spans(client, rid, sent, lanes=10, queue_ms=1.0, linger_ms=0.0):
    """One request's path, in ms after ``sent``: recv [1, 3], decode [3,
    7], admit [7, 8], queue wait [7.5, 7.5 + queue_ms], dispatch [9, 19]
    with a resolve [10, 12] inside it, handoff [18.5, 19], reply [19, 20]."""
    tags = {"client": client, "request_id": rid}
    at = lambda ms: sent + ms / 1e3  # noqa: E731
    return [
        _span("sidecar.recv", at(1), 0.002, bytes=100, **tags),
        _span("sidecar.decode", at(3), 0.004, lanes=lanes, bytes=100, **tags),
        _span("sidecar.admit", at(7), 0.001, lanes=lanes, **tags),
        _span("coalescer.queue_wait", at(7.5), queue_ms / 1e3, lanes=lanes,
              dispatch_id=rid, linger_ms=linger_ms, **tags),
        _span("coalescer.dispatch", at(9), 0.010, dispatch_id=rid, lanes=lanes,
              requests=1, clients=1),
        _span("sigcache.resolve", at(10), 0.002, lanes=lanes, hits=0),
        _span("sidecar.handoff", at(18.5), 0.0005, **tags),
        _span("sidecar.reply", at(19), 0.001, lanes=lanes, **tags),
    ]


def _replay():
    """Node 0, closed loop, round trips of 25 ms: request 1 before the
    window, 2-5 in it, 5 failed; node 1's request 1 in the window, a round
    trip of 200 ms whose queue wait of 11 ms runs into its dispatch; node
    0's request 6 sent in the window and answered after it."""
    reqs, spans = [], []
    for k, sent in enumerate((9.5, 11.0, 12.0, 13.0, 14.0)):
        reqs.append(_req(0, sent, sent + 0.025, status=1 if k == 4 else 0,
                         in_window=sent >= 10.0))
        spans += _request_spans("node0", k + 1, sent, queue_ms=(1.0, 1.0, 2.0, 3.0, 4.0)[k],
                                linger_ms=0.5 * k)
    reqs.append(_req(1, 15.0, 15.2, lanes=20))
    spans += _request_spans("node1", 1, 15.0, lanes=20, queue_ms=11.0, linger_ms=3.0)
    # node 0's request 6, answered after the window's end, when its spans
    # past the decode were no longer read
    reqs.append(_req(0, 19.99, 20.015))
    spans += _request_spans("node0", 6, 19.99)[:2]
    spans.append(_span("sidecar.dispatch", 12.009, 0.0, dispatch_id=3))  # a mark
    return reqs, spans


def test_per_klane_readers_take_the_window():
    reqs, spans = _replay()
    ctx = _ctx(reqs, spans)
    # started in the window: node 0's requests 2-6 (10 lanes) and node 1's
    # (20), request 6 with no resolve
    assert _reader("decode_ms_per_klane").read(ctx) == pytest.approx(6 * 4.0 / 70 * 1000)
    assert _reader("resolve_ms_per_klane").read(ctx) == pytest.approx(5 * 2.0 / 60 * 1000)


def test_request_readers_match_window_requests_by_client_and_id():
    reqs, spans = _replay()
    ctx = _ctx(reqs, spans)
    # node 0's requests 2-5 and node 1's request 1, not node 0's request 1;
    # request 6 has no queue wait read
    assert _reader("queue_wait_ms.replay").read(ctx) == pytest.approx((1 + 2 + 3 + 4 + 11) / 5)
    assert _reader("queue_wait_ms.votes").read(ctx) == pytest.approx(4.2)
    assert _reader("linger_ms.votes").read(ctx) == pytest.approx((0.5 + 1 + 1.5 + 2 + 3) / 5)
    assert _reader("reply_ms.replay").read(ctx) == pytest.approx(1.5)
    # a span whose client and request id name no request is nobody's
    spans.append(_span("coalescer.queue_wait", 16.0, 1.0, client="node0", request_id=99))
    spans.append(_span("coalescer.queue_wait", 16.0, 1.0, client="node7", request_id=1))
    assert _reader("queue_wait_ms.replay").read(_ctx(reqs, spans)) == pytest.approx(4.2)


def test_unspanned_counts_each_instant_once():
    reqs, spans = _replay()
    # node 0's requests 2-4 answered OK in the window (not 5, failed, nor
    # 6, answered after it): queue waits of 1, 2 and 3 ms, so
    # the spans cover [1, 8.5] and [9, 20] of the first (6.5 ms dark of
    # 25) and [1, 20] of the others (6 ms); node 1: [1, 20] of 200 ms
    dark = [6.5, 6.0, 6.0, 181.0]
    assert _reader("unspanned_ms.replay").read(_ctx(reqs, spans)) == \
        pytest.approx(sum(dark) / 4)
    # every span twice, and one more nested inside the dispatch: no change
    doubled = spans + [dict(s) for s in spans] + [_span("ed25519.prepare", 11.012, 0.001)]
    assert _reader("unspanned_ms.replay").read(_ctx(reqs, doubled)) == \
        pytest.approx(sum(dark) / 4)
    # a span past the reply counts only up to it: [19, 25] of request 2
    longer = spans + [_span("sidecar.reply", 11.019, 0.5, client="node0", request_id=2)]
    assert _reader("unspanned_ms.replay").read(_ctx(reqs, longer)) == \
        pytest.approx((1.5 + 6.0 + 6.0 + 181.0) / 4)


def test_covered_and_union():
    union = span_readers.span_union(
        [_span("a", 1.0, 2.0), _span("b", 2.0, 0.5), _span("c", 2.5, 1.0),
         _span("d", 5.0, 0.0), _span("e", 6.0, 1.0)])
    assert union == [[1.0, 3.5], [6.0, 7.0]]
    starts = [iv[0] for iv in union]
    assert span_readers.covered(union, starts, 0.0, 10.0) == pytest.approx(3.5)
    assert span_readers.covered(union, starts, 3.0, 6.5) == pytest.approx(1.0)
    assert span_readers.covered(union, starts, 4.0, 5.5) == 0.0


def test_nothing_read_from_a_daemon_without_the_spans():
    """The parent's daemon records the flush's tree and none of these: each
    reader gives None, so the result line leaves the metric out."""
    reqs, _spans = _replay()
    flush_only = [_span("crypto.batch_verify_tally", 11.009, 0.010, lanes=10),
                  _span("ed25519.prepare", 11.010, 0.005, lanes=10)]
    for spans in ([], flush_only):
        ctx = _ctx(reqs, spans)
        assert {name: _reader(name).read(ctx) for name in NEW} == dict.fromkeys(NEW)
