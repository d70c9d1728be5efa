"""A signed pool of ed25519 votes: the chain a configuration describes.

Validators' keys, powers, and the canonical prevote and precommit sign
bytes of every (height, vote type, validator) of the pool, signed with
OpenSSL through ``cryptography`` in a process pool. Everything is drawn
from the configuration's ``chain_seed``, so every run of a configuration
signs the same pool; the run's ``--seed`` chooses only what the traffic
does with it (start height, order, corrupted lanes, sizes, arrivals).

Entry ``e`` of the pool is ``(slot * len(vote_types) + type_index) *
validators + validator``.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import random
import struct
from typing import Dict, List

VOTE_TYPES = {"prevote": 1, "precommit": 2}


# -- canonical vote sign bytes: a copy of types/vote.go:93 --------------------

def _uvarint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varint_field(field: int, value: int) -> bytes:
    if not value:
        return b""
    return _uvarint(field << 3) + _uvarint(value % (1 << 64))


def _sfixed64_field(field: int, value: int) -> bytes:
    if not value:
        return b""
    return _uvarint((field << 3) | 1) + struct.pack("<q", value)


def _bytes_field(field: int, value: bytes, always: bool = False) -> bytes:
    if not value and not always:
        return b""
    return _uvarint((field << 3) | 2) + _uvarint(len(value)) + value


def vote_sign_bytes(chain_id: str, vote_type: int, height: int, round_: int,
                    block_id: tuple, timestamp_ns: int) -> bytes:
    """The length-delimited CanonicalVote a validator signs
    (proto/tendermint/types/canonical.proto:30-38, gogoproto's rules:
    height and round as sfixed64, the zero block id left out, the
    timestamp always written)."""
    hash_, parts_total, parts_hash = block_id
    msg = _varint_field(1, vote_type)
    msg += _sfixed64_field(2, height)
    msg += _sfixed64_field(3, round_)
    if hash_ or parts_total or parts_hash:
        psh = _varint_field(1, parts_total) + _bytes_field(2, parts_hash)
        msg += _bytes_field(4, _bytes_field(1, hash_) + _bytes_field(2, psh, always=True),
                            always=True)
    seconds, nanos = divmod(timestamp_ns, 1_000_000_000)
    msg += _bytes_field(5, _varint_field(1, seconds) + _varint_field(2, nanos), always=True)
    msg += _bytes_field(6, chain_id.encode("utf-8"))
    return _uvarint(len(msg)) + msg


# -- the chain -----------------------------------------------------------------

def _digest(*parts) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"|")
    return h.digest()


def validator_seed(chain_seed: int, i: int) -> bytes:
    return _digest(b"validator", chain_seed, i)


def powers(cfg: Dict) -> List[int]:
    """Each validator's power, log-uniform over [power_min, power_max]."""
    rng = random.Random(_digest(b"powers", cfg["chain_seed"]))
    lo, hi = cfg["power_min"], cfg["power_max"]
    out = [max(lo, min(hi, int(round(lo * (hi / lo) ** rng.random()))))
           for _ in range(cfg["validators"])]
    if sum(out) >= 1 << 63:
        raise ValueError("the validators' powers must sum below 2^63")
    return out


def sign_bytes(cfg: Dict, slot: int, vote_type: str, i: int) -> bytes:
    """What validator ``i`` signs for ``vote_type`` at the pool's ``slot``."""
    seed = cfg["chain_seed"]
    height = cfg["first_height"] + slot
    block = (_digest(b"block", seed, height), 1, _digest(b"parts", seed, height))
    jitter = int.from_bytes(_digest(b"ts", seed, height, vote_type, i)[:4], "little") % 900_000_000
    ts = cfg["genesis_time_ns"] + height * 1_000_000_000 + jitter
    return vote_sign_bytes(cfg["chain_id"], VOTE_TYPES[vote_type], height, 0, block, ts)


def _sign_range(args):
    cfg, lo, hi = args
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    pks, msgs, sigs = [], [], []
    for i in range(lo, hi):
        key = Ed25519PrivateKey.from_private_bytes(validator_seed(cfg["chain_seed"], i))
        pks.append(key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw))
        row_m, row_s = [], []
        for slot in range(cfg["chain_heights"]):
            for vt in cfg["vote_types"]:
                m = sign_bytes(cfg, slot, vt, i)
                row_m.append(m)
                row_s.append(key.sign(m))
        msgs.append(row_m)
        sigs.append(row_s)
    return lo, pks, msgs, sigs


class Pool:
    """The signed pool: ``pks[v]``, ``powers[v]``, and for each entry its
    message and signature."""

    def __init__(self, cfg: Dict, workers: int = 0):
        self.cfg = cfg
        self.validators = v = cfg["validators"]
        self.types = list(cfg["vote_types"])
        self.slots = cfg["chain_heights"]
        self.size = self.slots * len(self.types) * v
        self.powers = powers(cfg)
        # two cores stay free for the daemon's start, which runs meanwhile
        workers = workers or max(1, min(8, (os.cpu_count() or 1) - 2))
        step = max(1, -(-v // (workers * 4)))
        jobs = [(cfg, lo, min(v, lo + step)) for lo in range(0, v, step)]
        self.pks: List[bytes] = [b""] * v
        self.msgs: List[bytes] = [b""] * self.size
        self.sigs: List[bytes] = [b""] * self.size
        per_val = self.slots * len(self.types)
        if workers > 1 and len(jobs) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(workers) as pool:
                results = pool.map(_sign_range, jobs)
        else:
            results = [_sign_range(j) for j in jobs]
        for lo, pks, msgs, sigs in results:
            for k, i in enumerate(range(lo, lo + len(pks))):
                self.pks[i] = pks[k]
                for j in range(per_val):
                    e = j * v + i
                    self.msgs[e] = msgs[k][j]
                    self.sigs[e] = sigs[k][j]

    def entry(self, slot: int, vote_type: str, validator: int) -> int:
        return (slot * len(self.types) + self.types.index(vote_type)) * self.validators + validator

    def validator_of(self, e: int) -> int:
        return e % self.validators


def corrupt(sig: bytes, rng: random.Random) -> bytes:
    """The signature with one byte flipped at a drawn position."""
    pos = rng.randrange(len(sig))
    flip = rng.randrange(1, 256)
    return sig[:pos] + bytes([sig[pos] ^ flip]) + sig[pos + 1:]
