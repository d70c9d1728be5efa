"""A signed pool of secp256k1 votes: the chain a configuration describes.

The chain of ``ed25519_votes`` (its validators' powers, heights, canonical
sign bytes and entry layout, imported from there) with secp256k1 keys:
validator ``i``'s private scalar is drawn from the configuration's
``chain_seed``, its key is the 33-byte SEC 1 compressed point, and each
vote is signed with OpenSSL through ``cryptography`` (ECDSA over SHA-256),
the DER decoded to 64-byte R || S and s folded to n - s when above n/2, as
Tendermint v0.34 signs (crypto/secp256k1/secp256k1.go). Keys and
signatures are computed in a process pool.

Entry ``e`` of the pool is ``(slot * len(vote_types) + type_index) *
validators + validator``.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from typing import Dict

from benchmark.pools import ed25519_votes

N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def private_scalar(chain_seed: int, i: int) -> int:
    """Validator ``i``'s private key, in [1, n - 1]."""
    return int.from_bytes(ed25519_votes.validator_seed(chain_seed, i), "big") % (N - 1) + 1


def _sign_range(args):
    cfg, lo, hi = args
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import decode_dss_signature
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    curve, ecdsa = ec.SECP256K1(), ec.ECDSA(hashes.SHA256())
    pks, msgs, sigs = [], [], []
    for i in range(lo, hi):
        key = ec.derive_private_key(private_scalar(cfg["chain_seed"], i), curve)
        pks.append(key.public_key().public_bytes(Encoding.X962, PublicFormat.CompressedPoint))
        row_m, row_s = [], []
        for slot in range(cfg["chain_heights"]):
            for vt in cfg["vote_types"]:
                m = ed25519_votes.sign_bytes(cfg, slot, vt, i)
                r, s = decode_dss_signature(key.sign(m, ecdsa))
                row_m.append(m)
                row_s.append(r.to_bytes(32, "big") + min(s, N - s).to_bytes(32, "big"))
        msgs.append(row_m)
        sigs.append(row_s)
    return lo, pks, msgs, sigs


class Pool(ed25519_votes.Pool):
    """The signed pool: ``pks[v]``, ``powers[v]``, and for each entry its
    message and signature."""

    def __init__(self, cfg: Dict, workers: int = 0):
        self.cfg = cfg
        self.validators = v = cfg["validators"]
        self.types = list(cfg["vote_types"])
        self.slots = cfg["chain_heights"]
        self.size = self.slots * len(self.types) * v
        self.powers = ed25519_votes.powers(cfg)
        # a signature costs ~13 times an ed25519 one, so every core but the
        # two the daemon's start needs meanwhile signs
        workers = workers or max(1, (os.cpu_count() or 1) - 2)
        step = max(1, -(-v // (workers * 4)))
        jobs = [(cfg, lo, min(v, lo + step)) for lo in range(0, v, step)]
        self.pks = [b""] * v
        self.msgs = [b""] * self.size
        self.sigs = [b""] * self.size
        per_val = self.slots * len(self.types)
        if workers > 1 and len(jobs) > 1:
            with multiprocessing.get_context("spawn").Pool(workers) as pool:
                results = pool.map(_sign_range, jobs)
        else:
            results = [_sign_range(j) for j in jobs]
        for lo, pks, msgs, sigs in results:
            for k, i in enumerate(range(lo, lo + len(pks))):
                self.pks[i] = pks[k]
                for j in range(per_val):
                    self.msgs[j * v + i] = msgs[k][j]
                    self.sigs[j * v + i] = sigs[k][j]


def corrupt(sig: bytes, rng: random.Random) -> bytes:
    """An invalid signature, chosen by ``rng``: half the time one byte
    flipped, half the time the high-S twin R || (n - s), which OpenSSL
    accepts and Tendermint refuses."""
    if rng.random() < 0.5:
        return ed25519_votes.corrupt(sig, rng)
    return sig[:32] + (N - int.from_bytes(sig[32:], "big")).to_bytes(32, "big")
