"""Process-wide verified-signature cache: the port's own copy of the
reference package's ``crypto/sigcache.py``.

A precommit verified at vote ingestion is checked again by the commit
verification of the next height's block, and a vote relayed by several
peers arrives several times. ``crypto/batch.py`` looks every (curve,
pubkey, msg, sig) triple up here before it assigns lanes, so a triple
verified before costs no lane.

- Keys are ``sha256(len(t) ‖ t ‖ len(pk) ‖ pk ‖ len(msg) ‖ msg ‖ len(sig) ‖
  sig)`` with 4-byte big-endian lengths and t the curve name: the fields
  cannot run into each other, equal bytes on two curves stay apart, and
  one (pubkey, msg) under two signatures (equivocation) is two entries.
  ``native.resolve`` computes the same keys for a whole flush in C;
  ``cache_key`` is their plain version.
- Only successes are cached. An entry states that the triple's signature
  verifies, which no change of validator set can make stale; failures are
  rare, chosen by the sender, and would make a negative cache a lever on
  memory.
- The entries live in C (``native.Store``): the key's first byte picks
  one of ``shards`` LRU sets, each behind its own mutex, so threads that
  flush at once do not serialise on one lock. ``stats()`` keeps lifetime
  counters of hits, misses, inserts and evictions.
- A flush is resolved in one C call (``resolve``): its keys computed on
  threads, looked up in order and its repeated misses folded onto their
  first lane, with no Python loop over the keys; ``contains`` and ``add`` are that
  store's lookup and insert of one key, ``contains_many`` and ``add_many``
  of many.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional

import numpy as np

from tmtpu_torch import native

DEFAULT_MAX_ENTRIES = 131072
DEFAULT_SHARDS = 16


def cache_key(type_value: str, pk_bytes: bytes, msg: bytes, sig: bytes) -> bytes:
    """The 32-byte cache key of one (curve, pubkey, msg, sig) triple."""
    h = hashlib.sha256()
    for part in (type_value.encode(), pk_bytes, msg, sig):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    return h.digest()


class SigCache:
    """Sharded, lock-striped LRU set of the keys of verified triples."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 shards: int = DEFAULT_SHARDS, enabled: bool = True):
        shards = max(1, int(shards))
        while shards & (shards - 1):  # a power of two, so a mask picks the shard
            shards -= 1
        self._shards = shards
        self._max_entries = max(shards, int(max_entries))
        self._per_shard = max(1, self._max_entries // shards)
        self._enabled = bool(enabled)
        self._store: Optional[native.Store] = None  # built at first use
        self._store_lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._inserts = 0
        self._evictions = 0
        self._stats_lock = threading.Lock()

    def _entries(self) -> native.Store:
        with self._store_lock:
            if self._store is None:
                self._store = native.Store(self._shards, self._per_shard)
            return self._store

    def _count(self, hits=0, misses=0, inserts=0, evictions=0) -> None:
        with self._stats_lock:
            self._hits += hits
            self._misses += misses
            self._inserts += inserts
            self._evictions += evictions

    def contains_many(self, keys) -> List[bool]:
        """Whether each key (32 bytes, or a row of [B, 32] uint8) was added
        as verified, in order: a hit refreshes its key's recency, and each
        key counts a hit or a miss."""
        if not self._enabled:
            return [False] * len(keys)
        hit = self._entries().lookup(keys)
        n_hit = int(hit.sum())
        self._count(hits=n_hit, misses=len(hit) - n_hit)
        return hit.tolist()

    def add_many(self, keys) -> None:
        """Record verified triples' keys in order; a shard past its cap
        evicts its least recently used key for each new one."""
        if not self._enabled:
            return
        inserted, evicted = self._entries().add(keys)
        self._count(inserts=inserted, evictions=evicted)

    def contains(self, key: bytes) -> bool:
        return self.contains_many([key])[0]

    def add(self, key: bytes) -> None:
        self.add_many([key])

    def resolve(self, types, pks, msgs, sigs):
        """One flush's lookups: (keys [B, 32] uint8, rep int32 [B]), rep -1
        where the triple is cached, else the flush's first lane that missed
        with the same key. Counts a hit or a miss a lane; with the cache
        off no lane hits and nothing is counted."""
        if not self._enabled:
            return native.resolve(None, types, pks, msgs, sigs)
        keys, rep = native.resolve(self._entries(), types, pks, msgs, sigs)
        n_hit = int((rep < 0).sum())
        self._count(hits=n_hit, misses=len(rep) - n_hit)
        return keys, rep

    def check(self, type_value: str, pk_bytes: bytes, msg: bytes, sig: bytes) -> bool:
        return self.contains(cache_key(type_value, pk_bytes, msg, sig))

    def record(self, type_value: str, pk_bytes: bytes, msg: bytes, sig: bytes) -> None:
        self.add(cache_key(type_value, pk_bytes, msg, sig))

    def set_enabled(self, enabled: bool) -> None:
        """Switch the cache on or off; switching it off drops every entry."""
        self._enabled = bool(enabled)
        if not self._enabled:
            self.invalidate_all()

    def enabled(self) -> bool:
        return self._enabled

    def invalidate_all(self) -> None:
        """Drop every entry. Entries never go stale; this frees memory and
        forces fresh verifies."""
        store = self._store
        if store is not None:
            store.clear()

    def resize(self, max_entries: int, shards: Optional[int] = None) -> None:
        """New capacity. A new shard count rebuilds the shards (dropping
        every entry); a smaller capacity evicts the LRU entries at once."""
        if shards is not None and max(1, int(shards)) != self._shards:
            self.__init__(max_entries, shards, self._enabled)
            return
        self._max_entries = max(self._shards, int(max_entries))
        self._per_shard = max(1, self._max_entries // self._shards)
        store = self._store
        if store is not None:
            self._count(evictions=store.resize(self._per_shard))

    def size(self) -> int:
        store = self._store
        return 0 if store is None else store.size()

    def stats(self) -> Dict:
        with self._stats_lock:
            hits, misses = self._hits, self._misses
            inserts, evictions = self._inserts, self._evictions
        lookups = hits + misses
        return {
            "enabled": self._enabled,
            "entries": self.size(),
            "max_entries": self._max_entries,
            "shards": self._shards,
            "hits": hits,
            "misses": misses,
            "inserts": inserts,
            "evictions": evictions,
            "hit_rate": round(hits / lookups, 4) if lookups else 0.0,
        }


# One cache per process: vote ingestion, commit verification and every
# other flush must see each other's verifications.
DEFAULT = SigCache()


def configure(max_entries: int, shards: int, enabled: bool = True) -> None:
    """Apply a node's cache settings to ``DEFAULT``."""
    DEFAULT.set_enabled(enabled)
    if enabled:
        DEFAULT.resize(max_entries, shards)


def stats() -> Dict:
    return DEFAULT.stats()


def invalidate_all() -> None:
    DEFAULT.invalidate_all()
