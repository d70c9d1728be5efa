"""What the metric readers in ``metrics/`` share. Each takes the run's
``Ctx`` (``run.py``) and returns a number, or None where the run has
nothing to read."""

from __future__ import annotations

import bisect

import numpy as np

from benchmark import roofline


def cache_hit_share(ctx):
    """Hits of the signature cache over its lookups in the window, in %."""
    hits = ctx.stats_delta("sigcache", "hits")
    looked = hits + ctx.stats_delta("sigcache", "misses")
    return 100.0 * hits / looked if looked else None


def lanes_per_dispatch(ctx):
    n = ctx.stats_delta("coalescer", "dispatches")
    return ctx.stats_delta("coalescer", "dispatched_lanes") / n if n else None


def device_union(events, t0, t1):
    """Merged device intervals clipped to [t0, t1)."""
    iv = sorted((max(s, t0), min(e, t1)) for s, e, _ in events if e > t0 and s < t1)
    out = []
    for s, e in iv:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_idle_share(ctx):
    """The share of the window in which no kernel, copy or set ran on the
    card, in %, from the profiler's device activity."""
    union = device_union(ctx.device_events, ctx.t0, ctx.t1)
    if not union:
        return None
    busy = sum(e - s for s, e in union)
    return 100.0 * (1.0 - busy / (ctx.t1 - ctx.t0))


def _request_at(reqs, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and reqs[i]["replied"] is not None and t <= reqs[i]["replied"]:
        return reqs[i]
    return None


def ed25519_roofline(ctx):
    """The least time of the lanes each ed25519 kernel verified, over that
    kernel's time in the profiler's device trace, in %. A kernel is matched
    to the one request in flight when it started; one whose flush span
    (``crypto.batch_verify_tally``) held other than that request's lanes
    (hits or folded duplicates), or that matches none, is left out."""
    reqs = sorted((r for r in ctx.requests if r["sent"] is not None), key=lambda r: r["sent"])
    starts = [r["sent"] for r in reqs]
    flushes = sorted((s["start_s"], s["start_s"] + s["dur_s"], s["attrs"].get("lanes"))
                     for s in ctx.spans if s["name"] == "crypto.batch_verify_tally")
    flush_starts = [f[0] for f in flushes]
    cache = ctx.__dict__.setdefault("_products", {})
    need, work = 0.0, 0.0
    for k_start, k_end, name in ctx.device_events:
        if "ed25519" not in name.lower() or not ctx.t0 <= k_start < ctx.t1:
            continue
        req = _request_at(reqs, starts, k_start)
        i = bisect.bisect_right(flush_starts, k_start) - 1
        if req is None or i < 0 or k_start > flushes[i][1] or flushes[i][2] != req["lanes"]:
            continue
        entries = req["entries"].tolist()
        todo = [e for e in entries if e not in cache]
        if todo:
            lanes = [(ctx.pool.pks[ctx.pool.validator_of(e)], ctx.pool.msgs[e],
                      ctx.sig_as_sent(e)) for e in todo]
            cache.update(zip(todo, roofline.lane_products(lanes).tolist()))
        need += roofline.bound_s(sum(cache[e] for e in entries), len(entries))
        work += k_end - k_start
    return 100.0 * need / work if work else None


def daemon_overhead_ms(ctx):
    """The mean round trip of the window's requests less the mean
    ``crypto.batch_verify_tally`` span: what the daemon spends outside the
    flush's span tree (codec, resolve, inserts, bit pack, queueing)."""
    rtt = [r["replied"] - r["sent"] for r in ctx.window_requests()
           if r["replied"] is not None and r["status"] == 0]
    flush = [s["dur_s"] for s in ctx.spans_in_window("crypto.batch_verify_tally")]
    if not rtt or not flush:
        return None
    return (sum(rtt) / len(rtt) - sum(flush) / len(flush)) * 1e3


def prep_ms_per_klane(ctx):
    prep = ctx.spans_in_window("ed25519.prepare")
    lanes = sum(s["attrs"].get("lanes", 0) for s in prep)
    return sum(s["dur_s"] for s in prep) * 1e6 / lanes if lanes else None
