"""Batch signature verification on the card: the device branch of
tmtpu/crypto/batch.py (``BatchVerifier`` with its verify-once resolve,
``TPUBatchVerifier``, ``new_batch_verifier``).

``add`` items (pubkey object, msg, sig[, power]), or ``add_lanes`` one
curve's raw columns (pubkey bytes, msgs, sigs, powers, as the sidecar
daemon receives them), and resolve them at once: ``verify`` returns the
per-item mask, ``verify_tally`` also the summed voting power of the valid
items, an exact Python int however large. Both kinds of add fill the same
columns and take the same resolve. Every flush goes through the
process-wide signature cache first (``sigcache.DEFAULT``; its keys,
lookups and in-flush dedup are one C call): a triple verified before costs
no lane, identical triples in one flush share one lane with their powers
folded into it, and successes are inserted on the way out. The lanes left
split by curve, as the reference's ``_split`` does, with one device
dispatch per curve present: ed25519 to ``sharding.batch_verify_tally`` (or
``verify.batch_verify``), sr25519 to ``sr_verify.batch_verify_sr``,
secp256k1 to ``k1_verify.batch_verify_k1``; or, where
``mesh_dispatch.route`` says so (at least ``shard_min_lanes`` lanes left
after the resolve and two or more devices), split across the mesh by
``mesh_dispatch.batch_verify_tally_mesh`` / ``batch_verify_mesh``, the
reference's ``_mesh_first``. There is no breaker, no fallback from the mesh
to one device and no serial CPU fallback; groups below the reference's
serial threshold go to the device too, which gives the same mask.

Observability, as the reference records it: the resolve counts dedup
lanes (``crypto_sigcache_dedup_lanes_total``; the cache counts its own
hits, misses, inserts and evictions) and records ``record_sigcache`` for a
flush with hits or dedup; each dispatch records its span tree and one
``observe_crypto_batch``; ``_verify_pending`` ends with ``record_flush``
(``backend`` the device label, ``gpu`` or ``cpu``); a verifier's device,
once resolved, sets ``crypto_tpu_backend_up``.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tmtpu_torch import device as device_mod
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.libs import metrics, timeline

ED25519 = "ed25519"
SR25519 = "sr25519"
SECP256K1 = "secp256k1"

# the public key sizes the reference's key classes require
# (tmtpu/crypto/{ed25519,sr25519,secp256k1}.py, PUB_KEY_SIZE)
PUB_KEY_SIZES = {ED25519: 32, SR25519: 32, SECP256K1: 33}


class Lanes:
    """A flush's columns: curve names, pubkey bytes, msgs, sigs, powers."""

    __slots__ = ("types", "pks", "msgs", "sigs", "powers")

    def __init__(self, types=None, pks=None, msgs=None, sigs=None, powers=None):
        self.types: List[str] = types if types is not None else []
        self.pks: List[bytes] = pks if pks is not None else []
        self.msgs: List[bytes] = msgs if msgs is not None else []
        self.sigs: List[bytes] = sigs if sigs is not None else []
        self.powers: List[int] = powers if powers is not None else []

    def __len__(self) -> int:
        return len(self.sigs)

    def take(self, idx) -> "Lanes":
        """The lanes at positions ``idx``, in that order (new lists)."""
        return Lanes(*([col[i] for i in idx] for col in
                       (self.types, self.pks, self.msgs, self.sigs, self.powers)))


class BatchVerifier:
    """Accumulate (pubkey, msg, sig, power) lanes, then verify at once
    through the verify-once resolve. ``cache_stats`` holds the last
    flush's breakdown: lanes, hits, dedup and dispatched."""

    def __init__(self):
        self._lanes = Lanes()
        self.cache_stats: Dict = {"lanes": 0, "hits": 0, "dedup": 0, "dispatched": 0}

    def add(self, pub_key, msg: bytes, sig: bytes, power: int = 0) -> None:
        lanes = self._lanes
        lanes.types.append(pub_key.type_value())
        lanes.pks.append(pub_key.bytes())
        lanes.msgs.append(bytes(msg))
        lanes.sigs.append(bytes(sig))
        lanes.powers.append(int(power))

    def add_lanes(self, curve: str, pks, msgs, sigs, powers) -> None:
        """Add one curve's raw lanes: pubkey bytes, msgs, sigs and powers,
        equal-length lists of bytes and ints, taken as they are. Raises
        ValueError, adding nothing, for an unknown curve or a key of the
        wrong size, as the reference's key constructors do when its sidecar
        engine builds a key object from each lane."""
        size = PUB_KEY_SIZES.get(curve)
        if size is None:
            raise ValueError(f"unsupported key type {curve!r}")
        if not len(pks) == len(msgs) == len(sigs) == len(powers):
            raise ValueError("lane columns differ in length")
        if any(len(pk) != size for pk in pks):
            raise ValueError(f"{curve} pubkey must be {size} bytes")
        lanes = self._lanes
        lanes.types.extend(itertools.repeat(curve, len(pks)))
        lanes.pks.extend(pks)
        lanes.msgs.extend(msgs)
        lanes.sigs.extend(sigs)
        lanes.powers.extend(powers)

    def count(self) -> int:
        return len(self._lanes)

    def __len__(self) -> int:
        return len(self._lanes)

    def _verify_pending(self, lanes: Lanes, tally: bool) -> Tuple[List[bool], int]:
        """Backend hook: (mask over ``lanes``, tallied power of valid lanes)."""
        raise NotImplementedError

    def _resolve(self, tally: bool) -> Tuple[bool, List[bool], int]:
        lanes = self._lanes
        n = len(lanes)
        cache = sigcache.DEFAULT
        if not cache.enabled():
            mask, tallied = self._verify_pending(lanes, tally)
            self.cache_stats = {"lanes": n, "hits": 0, "dedup": 0, "dispatched": n}
            return all(mask), mask, tallied
        keys, rep = cache.resolve(lanes.types, lanes.pks, lanes.msgs, lanes.sigs)
        hit = rep < 0
        # Python ints: a sum of powers may pass 2^63, as the reference's may
        tallied = sum(itertools.compress(lanes.powers, hit.tolist()))
        mask = hit.copy()
        first = rep == np.arange(n)
        pending = np.flatnonzero(first)
        if len(pending):
            sub = lanes.take(pending.tolist())
            # a group's powers ride on its one lane, so the device tally
            # counts every member once
            later = np.flatnonzero(~hit & ~first)
            if len(later):
                slot = np.empty(n, dtype=np.int64)
                slot[pending] = np.arange(len(pending))
                for i, j in zip(later.tolist(), slot[rep[later]].tolist()):
                    sub.powers[j] += lanes.powers[i]
            sub_mask, sub_tallied = self._verify_pending(sub, tally)
            tallied += sub_tallied
            ok = np.zeros(n, dtype=bool)
            ok[pending] = sub_mask
            cache.add_many(keys[pending[ok[pending]]])
            mask[~hit] = ok[rep[~hit]]
        hits = int(hit.sum())
        dedup = n - hits - len(pending)
        if dedup:
            metrics.crypto_sigcache_dedup_lanes.inc(dedup)
        self.cache_stats = {"lanes": n, "hits": hits, "dedup": dedup,
                            "dispatched": len(pending)}
        if n and (hits or dedup):
            timeline.record_sigcache(lanes=n, hits=hits, dedup=dedup, dispatched=len(pending))
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
    hits included, packed on the device (uint32 words, LSB-first), and
    ``mesh_dispatches`` the curves of the last flush that went across the
    mesh."""

    def __init__(self, device=None):
        super().__init__()
        try:
            self.device = device_mod.resolve(device)
        except RuntimeError:
            metrics.crypto_tpu_backend_up.set(0)
            raise
        metrics.crypto_tpu_backend_up.set(1)
        self.bit_words: Optional[np.ndarray] = None
        self.mesh_dispatches = 0

    def _resolve(self, tally: bool) -> Tuple[bool, List[bool], int]:
        self.mesh_dispatches = 0
        return super()._resolve(tally)

    def _verify_pending(self, lanes, tally) -> Tuple[List[bool], int]:
        from tmtpu_torch.gpu import k1_verify, mesh_dispatch, sharding, sr_verify
        from tmtpu_torch.gpu import verify as tv

        t0 = time.perf_counter()
        kinds = set(lanes.types)
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
                idx = [i for i, t in enumerate(lanes.types) if t == kind]
                sub = lanes.take(idx)
            meshed = mesh_dispatch.route(kind, len(sub), self.device)
            self.mesh_dispatches += meshed
            if kind == ED25519 and tally:
                tally_fn = (mesh_dispatch.batch_verify_tally_mesh if meshed
                            else sharding.batch_verify_tally)
                m, ed_sum = tally_fn(sub.pks, sub.msgs, sub.sigs, sub.powers,
                                     device=self.device)
                tallied += ed_sum
            else:
                if meshed:
                    m = mesh_dispatch.batch_verify_mesh(kind, sub.pks, sub.msgs, sub.sigs,
                                                        device=self.device)
                else:
                    verify_fn = {ED25519: tv.batch_verify,
                                 SR25519: sr_verify.batch_verify_sr,
                                 SECP256K1: k1_verify.batch_verify_k1}[kind]
                    m = verify_fn(sub.pks, sub.msgs, sub.sigs, device=self.device)
                tallied += sum(itertools.compress(sub.powers, m.tolist()))
            mask[idx] = m
        timeline.record_flush(backend=metrics.backend_label(self.device), lanes=len(lanes),
                              ok=int(mask.sum()), seconds=round(time.perf_counter() - t0, 6))
        return mask.tolist(), tallied

    def verify_tally(self) -> Tuple[bool, List[bool], int]:
        from tmtpu_torch.gpu import sharding

        all_ok, mask, tallied = super().verify_tally()
        self.bit_words = sharding.pack_words(mask, self.device)
        return all_ok, mask, tallied


def new_batch_verifier(device=None) -> TorchBatchVerifier:
    return TorchBatchVerifier(device)


def verify_lanes(curve: str, pks, msgs, sigs, powers, tally: bool,
                 device=None) -> Tuple[List[bool], int, Dict, int]:
    """One curve's raw lanes through a fresh ``TorchBatchVerifier``: the
    sidecar daemon's engine. Returns (mask, tallied power of the valid
    lanes, 0 when ``tally`` is false; the flush's ``cache_stats``; 1 when
    the flush went across the mesh, else 0)."""
    bv = TorchBatchVerifier(device)
    bv.add_lanes(curve, pks, msgs, sigs, powers)
    if tally:
        _all_ok, mask, tallied = bv.verify_tally()
    else:
        _all_ok, mask = bv.verify()
        tallied = 0
    return mask, tallied, bv.cache_stats, bv.mesh_dispatches
