"""What the readers of the daemon's own spans share: the spans the port's
sidecar daemon records on a request's path outside the flush's span tree
(``sidecar.recv``, ``sidecar.decode``, ``sidecar.admit``,
``coalescer.queue_wait``, ``coalescer.dispatch``, ``sigcache.resolve``,
``sigcache.insert``, ``crypto.pack_words``, ``sidecar.handoff``,
``sidecar.reply``). Each reader takes the run's ``Ctx`` (``run.py``) and
returns a number, or None where the run has no such span, as a program
that does not record them gives.

A request's spans carry ``client`` (the Hello's client id, ``node<n>``
from ``client.py``) and ``request_id`` (the wire's: a node's requests are
numbered from 1 in the order ``run.collect`` lists them)."""

from __future__ import annotations

import bisect


def _per_klane(ctx, name):
    """Σ the window's ``name`` spans ÷ Σ their ``lanes`` × 1,000, in ms."""
    spans = ctx.spans_in_window(name)
    lanes = sum(s["attrs"].get("lanes", 0) for s in spans)
    return sum(s["dur_s"] for s in spans) * 1e6 / lanes if lanes else None


def decode_ms_per_klane(ctx):
    return _per_klane(ctx, "sidecar.decode")


def resolve_ms_per_klane(ctx):
    return _per_klane(ctx, "sigcache.resolve")


def window_spans(ctx, *names):
    """{(client, request_id): {name: [span, ...]}} of the ``names`` spans
    of the requests in the window."""
    ids = {}
    count = {}
    for r in ctx.requests:
        client = f"node{r['node']}"
        count[client] = count.get(client, 0) + 1
        if r["in_window"]:
            ids[(client, count[client])] = r
    out = {}
    for s in ctx.spans:
        if s["name"] in names:
            key = (s["attrs"].get("client"), s["attrs"].get("request_id"))
            if key in ids:
                out.setdefault(key, {}).setdefault(s["name"], []).append(s)
    return out


def _mean(values):
    return sum(values) / len(values) if values else None


def queue_wait_ms(ctx):
    """The mean ``coalescer.queue_wait`` of a window request, in ms."""
    by_req = window_spans(ctx, "coalescer.queue_wait")
    return _mean([sum(s["dur_s"] for s in v["coalescer.queue_wait"]) * 1e3
                  for v in by_req.values()])


def linger_ms(ctx):
    """The mean part of a window request's queue wait that the gather
    window chose to linger (``linger_ms``), in ms."""
    by_req = window_spans(ctx, "coalescer.queue_wait")
    return _mean([sum(s["attrs"].get("linger_ms", 0.0) for s in v["coalescer.queue_wait"])
                  for v in by_req.values()])


def reply_ms(ctx):
    """The mean ``sidecar.handoff`` + ``sidecar.reply`` of a window
    request, in ms."""
    by_req = window_spans(ctx, "sidecar.handoff", "sidecar.reply")
    return _mean([sum(s["dur_s"] for spans in v.values() for s in spans) * 1e3
                  for v in by_req.values()])


def span_union(spans):
    """The merged intervals of ``spans``, sorted."""
    out = []
    for start, end in sorted((s["start_s"], s["start_s"] + s["dur_s"]) for s in spans):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def covered(union, starts, a, b):
    """Seconds of [a, b] that the merged intervals ``union`` (their starts
    in ``starts``) cover."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    total = 0.0
    for start, end in union[i:]:
        if start >= b:
            break
        total += max(0.0, min(end, b) - max(start, a))
    return total


def unspanned_ms(ctx):
    """The mean round trip of the window's requests answered OK before the
    window's end, less the part of it that the daemon's spans cover (each
    instant once), in ms. Every span counts: with one request in flight, as
    in replay, each span that overlaps a round trip is that request's. A
    request answered later is left out: the spans are read at the window's
    end, so its last ones are missing. None where the daemon records no
    ``sidecar.recv``: the flush's tree alone is not its spans."""
    if not any(s["name"] == "sidecar.recv" for s in ctx.spans):
        return None
    union = span_union(ctx.spans)
    starts = [iv[0] for iv in union]
    gaps = [(r["replied"] - r["sent"]) - covered(union, starts, r["sent"], r["replied"])
            for r in ctx.window_requests()
            if r["replied"] is not None and r["replied"] < ctx.t1 and r["status"] == 0]
    return _mean(gaps) * 1e3 if gaps else None
