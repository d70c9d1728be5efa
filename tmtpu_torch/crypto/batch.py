"""Batch signature verification on the card: the device branch of
tmtpu/crypto/batch.py (``BatchVerifier`` with its verify-once resolve,
``TPUBatchVerifier``, ``new_batch_verifier``).

``add`` items (pubkey object, msg, sig[, power]), or ``add_lanes`` one
curve's raw columns (pubkey bytes, msgs, sigs, powers, as the sidecar
daemon receives them), and resolve them at once: ``verify`` returns the
per-item mask, ``verify_tally`` also the summed voting power of the valid
items, an exact Python int however large. A flush's lanes travel as
columns (``crypto/lanes.py``: one byte buffer with per-lane offsets, the
powers an int64 array): columns given to ``add_lanes`` alone go through
as they are, and anything else (items, lists, several adds) is joined
once into columns at the flush. Either way one resolve and one host prep
a curve serve them. Every flush goes through the
process-wide signature cache first (``sigcache.DEFAULT``; its keys,
lookups and in-flush dedup are one C call): a triple verified before costs
no lane, identical triples in one flush share one lane with their powers
folded into it, and successes are inserted on the way out. The lanes left
split by curve, as the reference's ``_split`` does, with one device
dispatch per curve present: ed25519 to ``sharding.batch_verify_tally`` (or
``verify.batch_verify``), sr25519 to ``sr_verify.batch_verify_sr``,
secp256k1 to ``k1_verify.batch_verify_k1``, all on the verifier's one
device. There is no breaker, no split across cards and no serial CPU
fallback; groups below the reference's serial threshold go to the device
too, which gives the same mask.

Observability: the resolve counts dedup lanes
(``crypto_sigcache_dedup_lanes_total``; the cache counts its own hits,
misses, inserts and evictions), as the reference does; each dispatch
records its span tree and one ``observe_crypto_batch``; a verifier's
device, once resolved, sets ``crypto_tpu_backend_up``. Spans the reference
does not record: ``sigcache.resolve`` (the cache's C call and the
bookkeeping that picks the lanes to dispatch; ``lanes``, ``hits``, and
``columns``: ``view`` where the flush's columns arrived as a buffer with
offsets, ``joined`` where they were joined first),
``sigcache.insert`` (the successes added; ``lanes``),
``crypto.pack_words`` (the bit pack of ``bit_words`` on the device and
its readback, at the first read; ``lanes``) and ``crypto.host_tally`` (the
power of a curve's valid lanes summed on the host, for a curve the device
does not tally; ``curve``, ``lanes``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tmtpu_torch import device as device_mod
from tmtpu_torch.crypto import lanes as lanes_mod
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.libs import metrics, trace

ED25519 = "ed25519"
SR25519 = "sr25519"
SECP256K1 = "secp256k1"

# the public key sizes the reference's key classes require
# (tmtpu/crypto/{ed25519,sr25519,secp256k1}.py, PUB_KEY_SIZE)
PUB_KEY_SIZES = {ED25519: 32, SR25519: 32, SECP256K1: 33}


class Lanes:
    """A flush's columns: ``types`` (one curve name for every lane, or a
    list of one a lane), ``pks``, ``msgs``, ``sigs`` (``ByteColumn``, or
    lists of bytes while ``add`` fills them) and ``powers`` (``IntColumn``,
    or a list of ints)."""

    __slots__ = ("types", "pks", "msgs", "sigs", "powers")

    def __init__(self, types=None, pks=None, msgs=None, sigs=None, powers=None):
        self.types = types if types is not None else []
        self.pks = pks if pks is not None else []
        self.msgs = msgs if msgs is not None else []
        self.sigs = sigs if sigs is not None else []
        self.powers = powers if powers is not None else []

    def __len__(self) -> int:
        return len(self.sigs)

    def curves(self) -> List[str]:
        """The curve names present."""
        return [self.types] if isinstance(self.types, str) else list(dict.fromkeys(self.types))

    def take(self, idx) -> "Lanes":
        """The lanes at positions ``idx`` (an int64 array), in that order;
        a column's take shares its buffer."""
        types = (self.types if isinstance(self.types, str)
                 else [self.types[i] for i in idx.tolist()])
        return Lanes(types, *(lanes_mod.take(col, idx)
                              for col in (self.pks, self.msgs, self.sigs, self.powers)))

    @classmethod
    def join(cls, parts: List["Lanes"]) -> "Lanes":
        """Several parts' lanes end to end, joined once into columns."""
        names = [t for p in parts for t in p.curves()]
        if len(set(names)) == 1:
            types = names[0]
        else:
            types = [t for p in parts for t in
                     ([p.types] * len(p) if isinstance(p.types, str) else p.types)]
        pks, msgs, sigs = lanes_mod.concat_bytes(
            [[p.pks for p in parts], [p.msgs for p in parts], [p.sigs for p in parts]])
        return cls(types, pks, msgs, sigs,
                   lanes_mod.concat_powers([lanes_mod.power_column(p.powers) for p in parts]))


class BatchVerifier:
    """Accumulate (pubkey, msg, sig, power) lanes, then verify at once
    through the verify-once resolve. ``cache_stats`` holds the last
    flush's breakdown: lanes, hits, dedup and dispatched."""

    def __init__(self):
        self._parts: List[Lanes] = []
        self.cache_stats: Dict = {"lanes": 0, "hits": 0, "dedup": 0, "dispatched": 0}

    def add(self, pub_key, msg: bytes, sig: bytes, power: int = 0) -> None:
        # items fill a part of their own: one ``add_lanes`` gave is never
        # appended to
        if not self._parts or isinstance(self._parts[-1].types, str):
            self._parts.append(Lanes())
        lanes = self._parts[-1]
        lanes.types.append(pub_key.type_value())
        lanes.pks.append(pub_key.bytes())
        lanes.msgs.append(bytes(msg))
        lanes.sigs.append(bytes(sig))
        lanes.powers.append(int(power))

    def add_lanes(self, curve: str, pks, msgs, sigs, powers) -> None:
        """Add one curve's raw lanes: pubkey bytes, msgs, sigs and powers,
        equal-length columns (``crypto/lanes.py``) or lists of bytes and
        ints, taken as they are (no copy). Raises ValueError, adding
        nothing, for an unknown curve or a key of the wrong size, as the
        reference's key constructors do when its sidecar engine builds a
        key object from each lane."""
        size = PUB_KEY_SIZES.get(curve)
        if size is None:
            raise ValueError(f"unsupported key type {curve!r}")
        if not len(pks) == len(msgs) == len(sigs) == len(powers):
            raise ValueError("lane columns differ in length")
        if isinstance(pks, lanes_mod.ByteColumn):
            wrong = bool((pks.lengths() != size).any())
        else:
            wrong = any(len(pk) != size for pk in pks)
        if wrong:
            raise ValueError(f"{curve} pubkey must be {size} bytes")
        self._parts.append(Lanes(curve, pks, msgs, sigs, powers))

    def count(self) -> int:
        return sum(len(p) for p in self._parts)

    def __len__(self) -> int:
        return self.count()

    def _flush_lanes(self) -> Tuple[Lanes, str]:
        """The flush's lanes as columns, and how they came: ``view`` where
        one ``add_lanes`` gave columns over a buffer, which go through as
        they are, ``joined`` where they were joined here."""
        parts = self._parts
        if len(parts) == 1 and all(isinstance(c, lanes_mod.ByteColumn)
                                   for c in (parts[0].pks, parts[0].msgs, parts[0].sigs)):
            part = parts[0]
            return Lanes(part.types, part.pks, part.msgs, part.sigs,
                         lanes_mod.power_column(part.powers)), "view"
        return Lanes.join(parts), "joined"

    def _verify_pending(self, lanes: Lanes, tally: bool) -> Tuple[List[bool], int]:
        """Backend hook: (mask over ``lanes``, tallied power of valid lanes)."""
        raise NotImplementedError

    def _resolve(self, tally: bool) -> Tuple[bool, List[bool], int]:
        cache = sigcache.DEFAULT
        if not cache.enabled():
            lanes, _how = self._flush_lanes()
            n = len(lanes)
            mask, tallied = self._verify_pending(lanes, tally)
            self.cache_stats = {"lanes": n, "hits": 0, "dedup": 0, "dispatched": n}
            return all(mask), mask, tallied
        with trace.span("sigcache.resolve") as sp:
            lanes, how = self._flush_lanes()
            n = len(lanes)
            sp.set(lanes=n, columns=how)
            keys, rep = cache.resolve(lanes.types, lanes.pks, lanes.msgs, lanes.sigs)
            hit = rep < 0
            # Python ints: a sum of powers may pass 2^63, as the reference's may
            tallied = lanes_mod.tally(lanes.powers, hit)
            mask = hit.copy()
            first = rep == np.arange(n)
            pending = np.flatnonzero(first)
            hits = int(hit.sum())
            sp.set(hits=hits)
        if len(pending):
            sub = lanes.take(pending)
            # a group's powers ride on its one lane, so the device tally
            # counts every member once; folded in Python ints, which may
            # pass int64
            later = np.flatnonzero(~hit & ~first)
            if len(later):
                slot = np.empty(n, dtype=np.int64)
                slot[pending] = np.arange(len(pending))
                powers = list(sub.powers)
                for i, j in zip(later.tolist(), slot[rep[later]].tolist()):
                    powers[j] += lanes.powers[i]
                sub.powers = lanes_mod.power_column(powers)
            sub_mask, sub_tallied = self._verify_pending(sub, tally)
            tallied += sub_tallied
            ok = np.zeros(n, dtype=bool)
            ok[pending] = sub_mask
            verified = keys[pending[ok[pending]]]
            with trace.span("sigcache.insert", lanes=len(verified)):
                cache.add_many(verified)
            mask[~hit] = ok[rep[~hit]]
        dedup = n - hits - len(pending)
        if dedup:
            metrics.crypto_sigcache_dedup_lanes.inc(dedup)
        self.cache_stats = {"lanes": n, "hits": hits, "dedup": dedup,
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
    ``bit_words`` is the vote bitarray of every item in ``add`` order,
    hits included (uint32 words, LSB-first), packed on the device when it
    is first read."""

    def __init__(self, device=None):
        super().__init__()
        try:
            self.device = device_mod.resolve(device)
        except RuntimeError:
            metrics.crypto_tpu_backend_up.set(0)
            raise
        metrics.crypto_tpu_backend_up.set(1)
        self._tally_mask: Optional[List[bool]] = None
        self._bit_words: Optional[np.ndarray] = None

    @property
    def bit_words(self) -> Optional[np.ndarray]:
        """The last ``verify_tally``'s mask packed on the device (None
        before one), packed on the first read and kept."""
        if self._bit_words is None and self._tally_mask is not None:
            from tmtpu_torch.gpu import sharding

            with trace.span("crypto.pack_words", lanes=len(self._tally_mask)):
                self._bit_words = sharding.pack_words(self._tally_mask, self.device)
        return self._bit_words

    def _verify_pending(self, lanes, tally) -> Tuple[List[bool], int]:
        from tmtpu_torch.gpu import k1_verify, sharding, sr_verify
        from tmtpu_torch.gpu import verify as tv

        kinds = lanes.curves()
        for kind in kinds:
            if kind not in PUB_KEY_SIZES:
                raise ValueError(f"unsupported key type {kind!r}")
        mask = np.zeros(len(lanes), dtype=bool)
        tallied = 0
        for kind in PUB_KEY_SIZES:
            if kind not in kinds:
                continue
            if len(kinds) == 1:
                idx, sub = slice(None), lanes
            else:
                idx = np.flatnonzero(np.array(lanes.types) == kind)
                sub = lanes.take(idx)
            if kind == ED25519 and tally:
                m, ed_sum = sharding.batch_verify_tally(sub.pks, sub.msgs, sub.sigs,
                                                        sub.powers, device=self.device)
                tallied += ed_sum
            else:
                verify_fn = {ED25519: tv.batch_verify,
                             SR25519: sr_verify.batch_verify_sr,
                             SECP256K1: k1_verify.batch_verify_k1}[kind]
                m = verify_fn(sub.pks, sub.msgs, sub.sigs, device=self.device)
                if tally:
                    with trace.span("crypto.host_tally", curve=kind, lanes=len(sub)):
                        tallied += lanes_mod.tally(sub.powers, m)
            mask[idx] = m
        return mask.tolist(), tallied

    def verify_tally(self) -> Tuple[bool, List[bool], int]:
        all_ok, mask, tallied = super().verify_tally()
        self._tally_mask, self._bit_words = mask, None
        return all_ok, mask, tallied


def new_batch_verifier(device=None) -> TorchBatchVerifier:
    return TorchBatchVerifier(device)


def verify_lanes(curve: str, pks, msgs, sigs, powers, tally: bool,
                 device=None) -> Tuple[List[bool], Dict]:
    """One curve's raw lanes through a fresh ``TorchBatchVerifier``: the
    sidecar daemon's engine. Returns (mask, the flush's ``cache_stats``).
    With ``tally`` the ed25519 lanes take the device's verify + tally step,
    as the reference's engine does; the flush's sum is not returned, since
    the daemon replies with each request's tally of its own slice."""
    bv = TorchBatchVerifier(device)
    bv.add_lanes(curve, pks, msgs, sigs, powers)
    if tally:
        _all_ok, mask, _tallied = bv.verify_tally()
    else:
        _all_ok, mask = bv.verify()
    return mask, bv.cache_stats
