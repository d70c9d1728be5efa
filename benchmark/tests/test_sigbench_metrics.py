"""Each metric's reader on synthetic client records, Stats, spans and
profiler records; the roofline's count against PERF.md's."""

import os
import random

import numpy as np
import pytest

from benchmark import readers, roofline, run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reader(name):
    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"), "metric_under_test")


class FakePool:
    def __init__(self, n, seed=0):
        rng = random.Random(seed)
        self.validators = n
        self.pks = [rng.randbytes(32) for _ in range(n)]
        self.msgs = [rng.randbytes(110) for _ in range(n)]
        self.sigs = [rng.randbytes(32) + rng.randrange(roofline.L).to_bytes(32, "little")
                     for _ in range(n)]

    def validator_of(self, e):
        return e % self.validators


def _req(kind, due, sent, replied, lanes, status=0, in_window=True, entries=None):
    return {"node": 0, "kind": kind, "due_abs": due, "sent": sent, "replied": replied,
            "status": status, "lanes": lanes, "in_window": in_window,
            "entries": np.arange(lanes) if entries is None else entries}


def _ctx(**kw):
    base = dict(t0=10.0, t1=20.0, seconds=10.0, setup_s=12.5, requests=[], spans=[],
                device_events=[], corrupted={},
                stats0={"sigcache": {"hits": 100, "misses": 50},
                        "coalescer": {"dispatches": 10, "dispatched_lanes": 1000}},
                stats1={"sigcache": {"hits": 900, "misses": 250},
                        "coalescer": {"dispatches": 30, "dispatched_lanes": 5000}})
    base.update(kw)
    return run.Ctx(**base)


def test_end_to_end_readers():
    reqs = [_req("vote", 10 + i * 0.1, 10 + i * 0.1, 10 + i * 0.1 + 0.001 * (i + 1), 4)
            for i in range(90)]
    reqs += [_req("commit", 11.0 + i, 11.0 + i, 11.0 + i + 0.05, 9990) for i in range(9)]
    reqs.append(_req("vote", 19.9, 19.9, 19.95, 4, status=1))        # failed
    reqs.append(_req("vote", 9.0, 9.0, 9.5, 4, in_window=False))     # warm-up
    reqs.append(_req("vote", 19.99, 19.99, 20.5, 4))                 # answered after
    ctx = _ctx(requests=reqs)
    assert _reader("setup_s").read(ctx) == 12.5
    # answered OK inside the window: 90 votes and 9 commits; not the failed
    # one, nor one answered after the window
    assert _reader("sig_s").read(ctx) == pytest.approx((90 * 4 + 9 * 9990) / 10.0)
    assert _reader("sig_s").read(_ctx()) is None


def test_stats_readers():
    ctx = _ctx()
    assert _reader("cache_hit_share.votes").read(ctx) == pytest.approx(100 * 800 / 1000)
    assert _reader("cache_hit_share.replay").read(ctx) == pytest.approx(80.0)
    assert _reader("lanes_per_dispatch.votes").read(ctx) == pytest.approx(4000 / 20)
    idle = _ctx(stats1=_ctx().stats0)
    assert _reader("cache_hit_share.votes").read(idle) is None
    assert _reader("lanes_per_dispatch.votes").read(idle) is None


def _span(sid, name, start, dur, parent=None, **attrs):
    return {"id": sid, "name": name, "start_s": start, "dur_s": dur, "parent": parent,
            "attrs": attrs}


def test_span_readers():
    reqs = [_req("commit", 10 + i, 10 + i, 10 + i + 0.07, 10000) for i in range(5)]
    spans = []
    for i in range(5):
        spans.append(_span(3 * i + 1, "crypto.batch_verify_tally", 10 + i + 0.03, 0.012,
                           lanes=10000))
        spans.append(_span(3 * i + 2, "ed25519.prepare", 10 + i + 0.031, 0.009, 3 * i + 1,
                           lanes=10000))
    spans.append(_span(99, "ed25519.prepare", 25.0, 1.0, lanes=10))   # after the window
    ctx = _ctx(requests=reqs, spans=spans)
    assert _reader("daemon_overhead_ms.replay").read(ctx) == pytest.approx(70 - 12)
    assert _reader("prep_ms_per_klane").read(ctx) == pytest.approx(0.9)
    assert _reader("daemon_overhead_ms.replay").read(_ctx(requests=reqs)) is None
    assert _reader("prep_ms_per_klane").read(_ctx()) is None


def test_device_union_and_idle_share():
    ev = [(9.0, 10.5, "k"), (10.2, 11.0, "k"), (12.0, 12.5, "copy"), (19.5, 21.0, "k"),
          (30.0, 31.0, "k")]
    assert readers.device_union(ev, 10.0, 20.0) == [[10.0, 11.0], [12.0, 12.5], [19.5, 20.0]]
    ctx = _ctx(device_events=ev)
    assert _reader("device_idle_share.votes").read(ctx) == pytest.approx(100 * (1 - 2.0 / 10))
    assert _reader("device_idle_share.replay").read(_ctx()) is None
    spans = [_span(1, "crypto.batch_verify_tally", 11.0, 1.2), _span(2, "ed25519.prepare", 11.1, 0.8, 1)]
    bd = run.breakdown(_ctx(device_events=ev, spans=spans))
    assert bd["device_ops"][0] == ["k", pytest.approx(1.8)]  # clipped, overlaps each counted
    assert bd["idle_gaps"][0] == ["no request in flight (100% of the gap)", pytest.approx(7.0)]
    assert bd["idle_gaps"][1] == ["ed25519.prepare (81% of the gap)", pytest.approx(1.0)]
    reqs = [_req("commit", 12.6, 12.6, 18.0, 10)]
    bd = run.breakdown(_ctx(device_events=ev, spans=spans, requests=reqs))
    assert bd["idle_gaps"][0][0] == "request in flight, outside the span tree (76% of the gap)"


def _count_from_perf_md(s_rows, h_rows):
    """PERF.md §6: 950M + 1,545S a lane plus 8M per non-zero digit of h
    and 6M of s; M and S are 100 and 55 products; 16.7e12 products/s."""
    nz = lambda rows: sum(int(b & 15 != 0) + int(b >> 4 != 0) for row in rows for b in row)
    lanes = len(s_rows)
    return (950 * lanes + 8 * nz(h_rows) + 6 * nz(s_rows)) * 100 + 1545 * lanes * 55


def test_roofline_count_matches_perf_md():
    pool = FakePool(10000)
    lanes = [(pool.pks[i], pool.msgs[i], pool.sigs[i]) for i in range(10000)]
    products = roofline.lane_products(lanes)
    h_rows = [roofline.challenge_bytes(*lane) for lane in lanes]
    s_rows = [sig[32:] for _, _, sig in lanes]
    assert int(products.sum()) == _count_from_perf_md(s_rows, h_rows)
    bound_ms = roofline.bound_s(int(products.sum()), 10000) * 1e3
    assert bound_ms == pytest.approx(0.1570, abs=0.0015)
    assert roofline.INT_MULS_PER_S == pytest.approx(16.7e12, rel=0.01)


def test_roofline_reader_matches_kernels_to_requests():
    pool = FakePool(300)
    entries = np.arange(300)
    reqs = [_req("commit", 10 + i, 10 + i, 10 + i + 0.5, 300, entries=entries) for i in range(3)]
    spans = [_span(i + 1, "crypto.batch_verify_tally", 10 + i + 0.1, 0.2, lanes=300)
             for i in range(3)]
    products = int(roofline.lane_products(
        [(pool.pks[e], pool.msgs[e], pool.sigs[e]) for e in entries]).sum())
    need = roofline.bound_s(products, 300)
    kernel = need * 10           # each launch at a tenth of its bound
    ev = [(10 + i + 0.2, 10 + i + 0.2 + kernel, "void quad_verify_kernel<Ed25519Quad>(...)")
          for i in range(3)]
    ev.append((10.25, 10.26, "Memcpy HtoD (Pageable -> Device)"))
    # a launch no request is in flight for, and one whose flush held other lanes
    ev.append((15.7, 15.71, "void quad_verify_kernel<Ed25519Quad>(...)"))
    ctx = _ctx(requests=reqs, spans=spans, device_events=ev, pool=pool)
    assert _reader("ed25519_roofline").read(ctx) == pytest.approx(10.0)
    spans[0]["attrs"]["lanes"] = 299
    ctx = _ctx(requests=reqs, spans=spans, device_events=ev, pool=pool)
    assert _reader("ed25519_roofline").read(ctx) == pytest.approx(10.0)
    assert _reader("ed25519_roofline").read(_ctx(requests=reqs, spans=spans, pool=pool)) is None
