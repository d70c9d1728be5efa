"""Batch signature verification on the card: the device branch of
tmtpu/crypto/batch.py (``BatchVerifier``, ``TPUBatchVerifier``,
``new_batch_verifier``).

``add`` items (pubkey object, msg, sig[, power]) and resolve them at once:
``verify`` returns the per-item mask, ``verify_tally`` also the summed
voting power of the valid items. The lanes split by curve, as the
reference's ``_split`` does, with one device dispatch per curve present:
ed25519 to ``sharding.batch_verify_tally`` (or ``verify.batch_verify``),
sr25519 to ``sr_verify.batch_verify_sr``, secp256k1 to
``k1_verify.batch_verify_k1``. This slice has no signature cache, no
in-batch dedup, no breaker, no serial CPU fallback and no multi-device
routing; groups below the reference's serial threshold go to the device
too, which gives the same mask.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tmtpu_torch import device as device_mod

ED25519 = "ed25519"
SR25519 = "sr25519"
SECP256K1 = "secp256k1"


class BatchVerifier:
    """Accumulate (pubkey, msg, sig, power) items, then verify at once."""

    def __init__(self):
        self._items: List[Tuple[object, bytes, bytes, int]] = []

    def add(self, pub_key, msg: bytes, sig: bytes, power: int = 0) -> None:
        self._items.append((pub_key, bytes(msg), bytes(sig), int(power)))

    def count(self) -> int:
        return len(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def _verify_pending(self, items, tally: bool) -> Tuple[List[bool], int]:
        """Backend hook: (mask over ``items``, tallied power of valid lanes)."""
        raise NotImplementedError

    def verify(self) -> Tuple[bool, List[bool]]:
        mask, _ = self._verify_pending(self._items, tally=False)
        return all(mask), mask

    def verify_tally(self) -> Tuple[bool, List[bool], int]:
        mask, tallied = self._verify_pending(self._items, tally=True)
        return all(mask), mask, tallied


class TorchBatchVerifier(BatchVerifier):
    """Lanes verified on ``device`` (None: the CUDA card; raises when there
    is none), one dispatch per curve present. After ``verify_tally``,
    ``bit_words`` holds the vote bitarray of the items in ``add`` order,
    packed on the device (uint32 words, LSB-first)."""

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
        if tally:
            words = sharding.pack_bitarray(torch.from_numpy(mask).to(self.device))
            self.bit_words = words.cpu().numpy().astype(np.uint32)
        return mask.tolist(), tallied


def new_batch_verifier(device=None) -> TorchBatchVerifier:
    return TorchBatchVerifier(device)
