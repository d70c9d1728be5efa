"""Fast-sync replay: one node verifying one whole commit a block.

Closed loop: the node sends block h's commit (every precommit of the
height, in validator order, with tally) and sends block h+1's when the
reply is back, cycling the pool's heights from one drawn from the seed.
``corrupt_per_height`` lanes of each height carry a flipped signature
byte, at validators drawn from the seed. Every seed sends the same work:
the same requests of the same width, from another start height.
"""

from __future__ import annotations

import random

import numpy as np


def plan(pool, traffic, seed, seconds):
    rng = random.Random(seed)
    v, slots = pool.validators, pool.slots
    start = rng.randrange(slots)
    corrupt = []
    for slot in range(slots):
        base = pool.entry(slot, "precommit", 0)
        corrupt += [base + i for i in sorted(rng.sample(range(v), traffic["corrupt_per_height"]))]
    requests = []
    for k in range(slots):
        base = pool.entry((start + k) % slots, "precommit", 0)
        requests.append({"due": 0.0, "entries": np.arange(base, base + v, dtype=np.int64),
                         "tally": True, "kind": "commit"})
    return {"warm_s": traffic["warm_s"], "tail_s": 0.0, "corrupt": corrupt,
            "nodes": [{"mode": "closed", "requests": requests}]}
