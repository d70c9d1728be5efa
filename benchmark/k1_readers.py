"""The readers of the secp256k1 cell's metrics: its host prep, its copies
and its kernel's share of the roofline. Each takes the run's ``Ctx``
(``run.py``) and returns a number, or None where the run has nothing to
read: a program without the ``secp256k1.device_put`` and
``secp256k1.readback`` spans gives no copy time."""

from __future__ import annotations

import bisect

from benchmark import roofline_k1, span_readers


def k1_prep_ms_per_klane(ctx):
    return span_readers._per_klane(ctx, "secp256k1.prepare")


def k1_copy_ms_per_klane(ctx):
    """Σ the window's ``secp256k1.device_put`` and ``secp256k1.readback``
    spans ÷ Σ the lanes of its copies to the card × 1,000, in ms."""
    puts = ctx.spans_in_window("secp256k1.device_put")
    lanes = sum(s["attrs"].get("lanes", 0) for s in puts)
    dur = sum(s["dur_s"] for s in puts + ctx.spans_in_window("secp256k1.readback"))
    return dur * 1e6 / lanes if lanes else None


def secp256k1_roofline(ctx):
    """The least time of the lanes each secp256k1 kernel verified, over that
    kernel's time in the profiler's device trace, in %. A kernel is matched
    to the one request in flight when it started; one whose request holds
    other than one ``secp256k1.execute`` span, or whose span held other
    than that request's lanes (hits or folded duplicates), or that matches
    no request, is left out."""
    reqs = sorted((r for r in ctx.requests if r["sent"] is not None), key=lambda r: r["sent"])
    starts = [r["sent"] for r in reqs]
    execs = sorted((s["start_s"], s["attrs"].get("lanes")) for s in ctx.spans
                   if s["name"] == "secp256k1.execute")
    exec_starts = [e[0] for e in execs]
    cache = ctx.__dict__.setdefault("_k1_products", {})
    need, work = 0.0, 0.0
    for k_start, k_end, name in ctx.device_events:
        if "k1quad" not in name.lower() or not ctx.t0 <= k_start < ctx.t1:
            continue
        i = bisect.bisect_right(starts, k_start) - 1
        if i < 0 or reqs[i]["replied"] is None or k_start > reqs[i]["replied"]:
            continue
        req = reqs[i]
        lo = bisect.bisect_left(exec_starts, req["sent"])
        hi = bisect.bisect_right(exec_starts, req["replied"])
        if hi - lo != 1 or execs[lo][1] != req["lanes"]:
            continue
        entries = req["entries"].tolist()
        todo = [e for e in entries if e not in cache]
        if todo:
            lanes = [(ctx.pool.pks[ctx.pool.validator_of(e)], ctx.pool.msgs[e],
                      ctx.sig_as_sent(e)) for e in todo]
            cache.update(zip(todo, roofline_k1.lane_products(lanes).tolist()))
        need += roofline_k1.bound_s(sum(cache[e] for e in entries), len(entries))
        work += k_end - k_start
    return 100.0 * need / work if work else None
