"""Live-consensus vote traffic from a localnet's nodes, open loop.

Each height is a prevote wave of every validator's vote, then a precommit
wave. Every node sends every vote of a wave, as gossip delivers it: in its
own order, in requests of k lanes, k log-uniform over [k_min, k_max], each
request due when its last vote arrives, the votes arriving as a Poisson
stream of ``rate_lanes_per_s_per_node``. When its precommit wave ends, each
node sends the height's commit: its valid precommits in validator order,
with tally, all of them verified already. Heights start on a fixed
schedule, ``height_gap_s`` after the previous commit, whatever the replies;
the window opens ``warm_s`` after the first height starts.

``corrupt_per_wave`` votes of each wave carry a flipped signature byte,
at validators drawn from the seed; the commit leaves them out.

The request sizes and the gaps between arrivals are one fixed set, drawn
from the mix's ``shape_seed``; ``--seed`` draws the start height, the
corrupted votes, and the order of votes, sizes and gaps in each node's
wave, so every seed sends the same work in another order.
"""

from __future__ import annotations

import math
import random

import numpy as np


def _shape(traffic, validators):
    rng = random.Random(traffic["shape_seed"])
    lo, hi = traffic["k_min"], traffic["k_max"]
    sizes, total = [], 0
    while total < validators:
        k = int(math.exp(rng.uniform(math.log(lo), math.log(hi + 1))))
        k = max(lo, min(hi, k, validators - total))
        sizes.append(k)
        total += k
    rate = traffic["rate_lanes_per_s_per_node"]
    gaps = [rng.expovariate(rate) for _ in range(validators)]
    return sizes, gaps


def plan(pool, traffic, seed, seconds):
    rng = random.Random(seed)
    v, slots = pool.validators, pool.slots
    nodes = pool.cfg["nodes"]
    sizes, gaps = _shape(traffic, v)
    wave_s = sum(gaps)
    period = 2 * wave_s + traffic["height_gap_s"]
    warm_s = traffic["warm_s"]
    end_s = warm_s + seconds + traffic["tail_s"]
    start = rng.randrange(slots)
    corrupt = set()
    for slot in range(slots):
        for vt in pool.types:
            base = pool.entry(slot, vt, 0)
            corrupt.update(base + i for i in rng.sample(range(v), traffic["corrupt_per_wave"]))
    schedules = [[] for _ in range(nodes)]
    h = 0
    while h * period < end_s:
        slot = (start + h) % slots
        t_h = h * period
        base = pool.entry(slot, "precommit", 0)
        valid = np.asarray([base + i for i in range(v) if base + i not in corrupt],
                           dtype=np.int64)
        for n in range(nodes):
            t = t_h
            for w, vt in enumerate(("prevote", "precommit")):
                base = pool.entry(slot, vt, 0)
                order = list(range(v))
                rng.shuffle(order)
                order = base + np.asarray(order, dtype=np.int64)
                ks = sizes[:]
                rng.shuffle(ks)
                gs = gaps[:]
                rng.shuffle(gs)
                arrive = t + np.cumsum(gs)
                off = 0
                for k in ks:
                    due = float(arrive[off + k - 1])
                    if due < end_s:
                        schedules[n].append({
                            "due": due, "tally": True, "kind": "vote",
                            "entries": order[off:off + k]})
                    off += k
                t = t + wave_s
            commit_due = t_h + 2 * wave_s
            if commit_due < end_s:
                schedules[n].append({"due": commit_due, "tally": True, "kind": "commit",
                                     "entries": valid})
        h += 1
    for s in schedules:
        s.sort(key=lambda r: r["due"])
    return {"warm_s": warm_s, "tail_s": traffic["tail_s"], "corrupt": sorted(corrupt),
            "period_s": period,
            "nodes": [{"mode": "open", "requests": s} for s in schedules]}
