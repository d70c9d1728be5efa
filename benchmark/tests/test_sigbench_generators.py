"""The traffic generators: deterministic in the seed, the mixes' shapes as written."""

import json
import os

import numpy as np
import pytest

from benchmark.generators import replay, votes

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


class FakePool:
    """The pool's layout without its signatures."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.validators = cfg["validators"]
        self.types = list(cfg["vote_types"])
        self.slots = cfg["chain_heights"]

    def entry(self, slot, vote_type, validator):
        return (slot * len(self.types) + self.types.index(vote_type)) * self.validators + validator


@pytest.fixture(scope="module")
def replay_cell():
    return FakePool(_json("configs", "fastsync10k-ed25519.json")), _json("traffic", "replay.json")


@pytest.fixture(scope="module")
def votes_cell():
    return FakePool(_json("configs", "localnet10k-ed25519.json")), _json("traffic", "votes.json")


def _same(a, b):
    assert a["corrupt"] == b["corrupt"] and a["warm_s"] == b["warm_s"]
    for na, nb in zip(a["nodes"], b["nodes"], strict=True):
        assert len(na["requests"]) == len(nb["requests"])
        for ra, rb in zip(na["requests"], nb["requests"]):
            assert ra["due"] == rb["due"] and ra["kind"] == rb["kind"]
            assert np.array_equal(ra["entries"], rb["entries"])


def test_replay_is_deterministic_and_as_written(replay_cell):
    pool, traffic = replay_cell
    a = replay.plan(pool, traffic, 2 ** 31 + 11, 20)
    _same(a, replay.plan(pool, traffic, 2 ** 31 + 11, 20))
    b = replay.plan(pool, traffic, 12, 20)
    assert a["corrupt"] != b["corrupt"]
    (node,) = a["nodes"]
    assert node["mode"] == "closed" and len(node["requests"]) == pool.slots == 27
    v = pool.validators
    starts = [int(r["entries"][0]) for r in node["requests"]]
    assert sorted(starts) == [pool.entry(s, "precommit", 0) for s in range(pool.slots)]
    for r in node["requests"]:
        assert r["tally"] and r["kind"] == "commit"
        assert np.array_equal(r["entries"], np.arange(r["entries"][0], r["entries"][0] + v))
    # consecutive heights from the drawn start
    slots = [s // v for s in starts]
    assert all((b_ - a_) % pool.slots == 1 for a_, b_ in zip(slots, slots[1:]))
    corrupt = np.asarray(a["corrupt"])
    per_height = np.bincount(corrupt // v, minlength=pool.slots)
    assert (per_height == traffic["corrupt_per_height"]).all()
    # every seed sends the same work: the same widths
    assert sorted(len(r["entries"]) for r in b["nodes"][0]["requests"]) == [v] * 27


def test_votes_is_deterministic_and_as_written(votes_cell):
    pool, traffic = votes_cell
    seconds = 10.0
    a = votes.plan(pool, traffic, 2 ** 31 + 5, seconds)
    _same(a, votes.plan(pool, traffic, 2 ** 31 + 5, seconds))
    b = votes.plan(pool, traffic, 99, seconds)
    v = pool.validators
    assert len(a["nodes"]) == pool.cfg["nodes"] == 4
    assert a["warm_s"] == traffic["warm_s"]
    corrupt = set(a["corrupt"])
    waves = {}
    for node_ix, node in enumerate(a["nodes"]):
        assert node["mode"] == "open"
        dues = [r["due"] for r in node["requests"]]
        assert dues == sorted(dues)
        for r in node["requests"]:
            assert r["tally"]
            if r["kind"] == "commit":
                base = int(r["entries"][0]) - int(r["entries"][0]) % v
                want = [e for e in range(base, base + v) if e not in corrupt]
                assert r["entries"].tolist() == want
                continue
            assert traffic["k_min"] <= len(r["entries"]) <= traffic["k_max"]
            wave = int(r["entries"][0]) // v
            assert (np.asarray(r["entries"]) // v == wave).all()
            waves.setdefault((node_ix, wave), []).append(r)
    complete = 0
    for (node_ix, wave), reqs in waves.items():
        entries = np.concatenate([r["entries"] for r in reqs])
        assert len(set(entries.tolist())) == len(entries)
        if len(entries) == v:
            complete += 1
            sizes = [len(r["entries"]) for r in reqs]
            assert 13 <= np.mean(sizes) <= 17
            assert len(corrupt & set(entries.tolist())) == traffic["corrupt_per_wave"]
    assert complete >= 4
    # another seed: the same request sizes in each whole wave, the same
    # wave lengths, in another order
    def sizes(plan):
        first = plan["period_s"] - traffic["height_gap_s"] + 1e-6
        return sorted(len(r["entries"]) for n in plan["nodes"] for r in n["requests"]
                      if r["due"] <= first)

    assert sizes(a) == sizes(b)
    assert a["period_s"] == b["period_s"]
    assert [r["entries"].tolist() for r in a["nodes"][0]["requests"][:5]] != \
        [r["entries"].tolist() for r in b["nodes"][0]["requests"][:5]]


def test_votes_period_follows_the_rate(votes_cell):
    pool, traffic = votes_cell
    plan = votes.plan(pool, traffic, 1, 1.0)
    mean_wave = pool.validators / traffic["rate_lanes_per_s_per_node"]
    assert plan["period_s"] == pytest.approx(2 * mean_wave + traffic["height_gap_s"], rel=0.05)
