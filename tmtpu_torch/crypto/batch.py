"""Batch signature verification on the card: the device branch of
tmtpu/crypto/batch.py (``BatchVerifier`` with its verify-once resolve,
``TPUBatchVerifier``, ``new_batch_verifier``).

``add`` items (pubkey object, msg, sig[, power]) and resolve them at once:
``verify`` returns the per-item mask, ``verify_tally`` also the summed
voting power of the valid items. Every flush goes through the process-wide
signature cache first (``sigcache.DEFAULT``; its keys, lookups and
in-flush dedup are one C call): a triple verified before costs no lane,
identical triples in one flush share one lane with their powers folded
into it, and successes are inserted on the way out. The lanes left split by curve, as
the reference's ``_split`` does, with one device dispatch per curve
present: ed25519 to ``sharding.batch_verify_tally`` (or
``verify.batch_verify``), sr25519 to ``sr_verify.batch_verify_sr``,
secp256k1 to ``k1_verify.batch_verify_k1``. This slice has no breaker, no
serial CPU fallback, no multi-device routing, no metrics and no timeline
events; groups below the reference's serial threshold go to the device
too, which gives the same mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tmtpu_torch import device as device_mod
from tmtpu_torch.crypto import sigcache

ED25519 = "ed25519"
SR25519 = "sr25519"
SECP256K1 = "secp256k1"


def item_fields(items):
    """The cache-key fields of (pubkey, msg, sig, power) items: (curve
    names, pubkey bytes, msgs, sigs)."""
    return ([it[0].type_value() for it in items], [it[0].bytes() for it in items],
            [it[1] for it in items], [it[2] for it in items])


class BatchVerifier:
    """Accumulate (pubkey, msg, sig, power) items, then verify at once
    through the verify-once resolve. ``cache_stats`` holds the last
    flush's breakdown: lanes, hits, dedup and dispatched."""

    def __init__(self):
        self._items: List[Tuple[object, bytes, bytes, int]] = []
        self.cache_stats: Dict = {"lanes": 0, "hits": 0, "dedup": 0, "dispatched": 0}

    def add(self, pub_key, msg: bytes, sig: bytes, power: int = 0) -> None:
        self._items.append((pub_key, bytes(msg), bytes(sig), int(power)))

    def count(self) -> int:
        return len(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def _verify_pending(self, items, tally: bool) -> Tuple[List[bool], int]:
        """Backend hook: (mask over ``items``, tallied power of valid lanes)."""
        raise NotImplementedError

    def _resolve(self, tally: bool) -> Tuple[bool, List[bool], int]:
        items = self._items
        n = len(items)
        cache = sigcache.DEFAULT
        if not cache.enabled():
            mask, tallied = self._verify_pending(items, tally)
            self.cache_stats = {"lanes": n, "hits": 0, "dedup": 0, "dispatched": n}
            return all(mask), mask, tallied
        keys, rep = cache.resolve(*item_fields(items))
        hit = rep < 0
        powers = np.fromiter((it[3] for it in items), dtype=np.int64, count=n)
        tallied = int(powers[hit].sum())
        mask = hit.copy()
        first = rep == np.arange(n)
        pending = np.flatnonzero(first)
        if len(pending):
            # a group's powers ride on its one lane, so the device tally
            # counts every member once
            later = np.flatnonzero(~hit & ~first)
            folded = powers.copy()
            np.add.at(folded, rep[later], powers[later])
            sub_items = [items[i] for i in pending.tolist()]
            for pos in np.flatnonzero(folded[pending] != powers[pending]).tolist():
                sub_items[pos] = sub_items[pos][:3] + (int(folded[pending[pos]]),)
            sub_mask, sub_tallied = self._verify_pending(sub_items, tally)
            tallied += sub_tallied
            ok = np.zeros(n, dtype=bool)
            ok[pending] = sub_mask
            cache.add_many(keys[pending[ok[pending]]])
            mask[~hit] = ok[rep[~hit]]
        hits = int(hit.sum())
        self.cache_stats = {"lanes": n, "hits": hits, "dedup": n - hits - len(pending),
                            "dispatched": len(pending)}
        mask = mask.tolist()
        return all(mask), mask, tallied

    def verify(self) -> Tuple[bool, List[bool]]:
        all_ok, mask, _ = self._resolve(tally=False)
        return all_ok, mask

    def verify_tally(self) -> Tuple[bool, List[bool], int]:
        """Verify and sum the power of the valid items: hits add theirs on
        the host, dispatched lanes on the device."""
        return self._resolve(tally=True)


class TorchBatchVerifier(BatchVerifier):
    """Lanes verified on ``device`` (None: the CUDA card; raises when there
    is none), one dispatch per curve present. After ``verify_tally``,
    ``bit_words`` holds the vote bitarray of every item in ``add`` order,
    hits included, packed on the device (uint32 words, LSB-first)."""

    def __init__(self, device=None):
        super().__init__()
        self.device = device_mod.resolve(device)
        self.bit_words: Optional[np.ndarray] = None

    def _verify_pending(self, items, tally) -> Tuple[List[bool], int]:
        from tmtpu_torch.gpu import k1_verify, sharding, sr_verify
        from tmtpu_torch.gpu import verify as tv

        by_curve = {ED25519: [], SR25519: [], SECP256K1: []}
        for i, (pk, _msg, _sig, _power) in enumerate(items):
            kind = pk.type_value()
            if kind not in by_curve:
                raise ValueError(f"unsupported key type {kind!r}")
            by_curve[kind].append(i)
        mask = np.zeros(len(items), dtype=bool)
        tallied = 0
        for kind, idx in by_curve.items():
            if not idx:
                continue
            pks = [items[i][0].bytes() for i in idx]
            msgs = [items[i][1] for i in idx]
            sigs = [items[i][2] for i in idx]
            if kind == ED25519 and tally:
                m, ed_sum = sharding.batch_verify_tally(
                    pks, msgs, sigs, [items[i][3] for i in idx], device=self.device)
                tallied += ed_sum
            else:
                verify_fn = {ED25519: tv.batch_verify,
                             SR25519: sr_verify.batch_verify_sr,
                             SECP256K1: k1_verify.batch_verify_k1}[kind]
                m = verify_fn(pks, msgs, sigs, device=self.device)
                tallied += sum(items[i][3] for i, ok in zip(idx, m) if ok)
            mask[idx] = m
        return mask.tolist(), tallied

    def verify_tally(self) -> Tuple[bool, List[bool], int]:
        from tmtpu_torch.gpu import sharding

        all_ok, mask, tallied = super().verify_tally()
        self.bit_words = sharding.pack_words(mask, self.device)
        return all_ok, mask, tallied


def new_batch_verifier(device=None) -> TorchBatchVerifier:
    return TorchBatchVerifier(device)
