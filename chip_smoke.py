#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tmtpu_torch) on one CUDA card.

Drives the port's three main paths, as a validator would, through
``new_batch_verifier().add(...)`` and ``verify_tally()``:

1. a 10,000-validator ed25519 precommit vote set (power 3 each, real
   canonical vote sign bytes, every 997th signature corrupted), on an empty
   signature cache: the cache keys and lookups, the C host prep, one
   host-to-device copy, the hand-written ed25519 CUDA kernel, the int64
   power tally and the bitarray pack on the card;
2. one height of that set verified once: the ingestion flush (the 10,000
   votes with every 4th relayed a second time, on an empty cache: 2,500
   folded onto their first copy's lane) and the commit flush of the next
   block (the same 10,000 triples: hits but for the 11 corrupted ones,
   which were never cached);
3. a 10,000-validator mixed-curve set (9,000 ed25519, 500 sr25519 and 500
   secp256k1 keys, interleaved, power 3 each, five corrupted signatures per
   curve) on an empty cache: one device dispatch per curve, through the
   ed25519, sr25519 and secp256k1 CUDA kernels, and the whole bitarray
   packed on the card.

Then the voting-power tally past 2^63 (8 and 9 relayed copies of one
precommit at 2^60, with the cache on and off) is checked on the card, and
the port's sidecar daemon is driven as node processes would drive it
(``python -m tmtpu_torch sidecar`` in a process of its own, reached with
the port's client over a unix socket): (a) the 10,000-vote ed25519 set
with tally, five round trips on a cache-off daemon, then (b) four clients
at once sending those 10,000 lanes on a fresh cache-on daemon with a fixed
gather window (one dispatch of 40,000 lanes, one launch of 10,000), one
more request (the commit flush over the wire: hits but for the corrupted
lanes) and (c) the mixed-curve set as one request a curve, then (d) a
daemon given only ``--home``, whose ``config/config.toml`` (written by
this script) sets its address, lane cap and request deadline, and (e) a
daemon with ``--health-laddr``: ``/healthz`` healthy and warmed, and after
one 10,000-lane request ``/metrics`` counting the dispatches, the ed25519
batches (one a launch) and the cache's counters that Stats counts, then
one trace context received and one refused for a valid and a garbage v2
context, and (f) a daemon sent light-client traffic: one request of 4
validators x 1,024 heights (4,096 lanes, keys repeating every four lanes,
one signature forged), held against the serial oracle, then 20 four-lane
requests one after another, bisection's shape, timed, and the same on a
daemon with no gather window (``--gather-ms 0``); every mask, tally,
cache breakdown and launch count is checked, the codec and the in-process
engine are timed alone, and each daemon must exit 0 on SIGTERM. Every
daemon serves one card. Before the daemons, the mesh phase runs the
sharded steps of ``gpu/sharding.py`` across a mesh (every card, or four
shards of the one card) and holds each against the single-device path,
and calls ``entry()`` and ``dryrun_multichip``. Before the mesh, the
observability phase reads the spans of the
real flush (``tmtpu_torch/libs/trace.py``): the cold 10,000-lane flush's
roots (the cache's resolve and insert, the tree, the bit pack), the
tree's stage times, with the execute stage's device time held within
15% of the kernel alone; one execute span a curve for the mixed set; and
the cold flush with tracing on against off, in turns.

Each flush runs with every launch counter set to 0 just before it and read
just after. Then each kernel is held against its plain PyTorch version on
the same planes at each width its paths give it, at 10,000 lanes, at 1, 3,
5 and 33 lanes (the ragged edge of the kernels' blocks of four-thread
quads) and on an adversarial block, samples are checked against the
pure-Python oracles, the C host prep is held against the Python prep, and
the kernels, the plain versions, host prep, the phases of one cold
ed25519 flush and every path end to end are timed (cold flushes on an
emptied cache, and with the cache switched off).

Usage: ``python3 chip_smoke.py``. Needs one CUDA card; exits non-zero
without one, and on any failed check. Prints a ``{"kernels": [...]}`` line,
the card's name and power limit, and, last, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import hashlib
import io
import json
import multiprocessing
import os
import queue
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, NamedTuple

import numpy as np
import torch

from tests import torch_corpus as corpus
from tmtpu_torch import device as device_mod
from tmtpu_torch import entry as entry_mod
from tmtpu_torch import native
from tmtpu_torch.crypto import batch as crypto_batch
from tmtpu_torch.crypto import lanes, sigcache
from tmtpu_torch.crypto.ed25519 import PrivKeyEd25519, PubKeyEd25519
from tmtpu_torch.crypto.secp256k1 import PubKeySecp256k1
from tmtpu_torch.crypto.sr25519 import PrivKeySr25519, PubKeySr25519
from tmtpu_torch.gpu import build, k1_kernel, kernel, sharding
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv
from tmtpu_torch.libs import trace
from tmtpu_torch.sidecar import protocol as sc_proto
from tmtpu_torch.sidecar.client import SidecarClient
from tmtpu_torch.sidecar.server import launch_counts as launches
from tmtpu_torch.types.vote import MAX_VOTES_COUNT, PRECOMMIT, vote_sign_bytes
from tools.gpu_common import launch_delta, smi_line
from tools.gpu_port_common import check, reset_launches, serial_mask, time_cuda, time_host

CHAIN_ID = "tmtpu-torch-smoke"
SEED = 20261016
POWER = 3
BAD_EVERY = 997
BLOCK_ID = (hashlib.sha256(b"smoke-block").digest(), 1,
            hashlib.sha256(b"smoke-parts").digest())
T0_NS = 1_760_000_000_000_000_000

# H100 SXM peaks: 3.35 TB/s HBM (NVIDIA data sheet); 32-bit integer
# multiplies and multiply-adds at 64 per SM per clock for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at 1.98 GHz boost. One 32x32->64 product (IMAD.WIDE)
# is counted as one such instruction.
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9

# The least work of one verify, fixed by the algorithm and not by the
# kernel's code: the reference's 64-window 4-bit Straus ladder in ref10's
# formulas, as (field multiplies M, squarings S). Decompressing A takes
# pow22523 (11M + 251S) and 8M + 4S around it; the cached table of
# d*(-A), d = 1..15, takes seven doublings to cached form (5M + 4S each),
# seven cached additions (9M each) and 1M; each of the 63 windows after the
# first doubles four times (three to P2 at 3M + 4S, one to P3 at 4M + 4S);
# each non-zero digit of h adds a cached point (8M to P3), each non-zero
# digit of s a niels point (6M to P2); the inversion of Z takes 11M + 254S
# and x, y 2M. A product of ten radix-2^25.5 limbs needs 100 32x32->64
# multiplies, a squaring 55.
FIXED_MS = (19 + 99 + 63 * 13 + 13, 255 + 28 + 63 * 16 + 254)
ADD_H_M, ADD_S_M = 8, 6
PRODUCTS_PER_M, PRODUCTS_PER_S = 100, 55

# sr25519 runs the same ladder on the same field. In place of one Edwards
# decompression and the final inversion it decodes A and R as ristretto255
# points (per decode: 24M + 257S, of which pow22523 is 11M + 251S) and
# checks coset equality (4M).
SR_FIXED_MS = (2 * 24 + 99 + 63 * 13 + 4, 2 * 257 + 28 + 63 * 16)

# secp256k1, the reference's algorithm: 63 windows after the first double
# four times each (RCB16 algorithm 9: 6M + 2S), each non-zero digit of u1
# or u2 adds a point (algorithm 7: 12M), the table of d*Q takes 14 additions,
# decompression takes the (p+1)/4 power (13M + 253S), x^3 (1M + 1S) and the
# check of y^2 (1S), and the final compare 2M. A 256-bit operand is eight
# 32-bit words, so a multiply needs at least 64 32x32->64 products and a
# squaring 36.
K1_FIXED_MS = (63 * 4 * 6 + 14 * 12 + 14 + 2, 63 * 4 * 2 + 255)
K1_ADD_M = 12
K1_PRODUCTS_PER_M, K1_PRODUCTS_PER_S = 64, 36

RAGGED = (1, 3, 5, 11, 33)

RELAY_EVERY = 4  # the ingestion flush gets every 4th vote twice

N_SR, N_K1 = 500, 500
BAD_PER_CURVE = 5
CURVE_ORDER = (crypto_batch.ED25519, crypto_batch.SR25519, crypto_batch.SECP256K1)

P60 = 2**60  # MAX_TOTAL_VOTING_POWER of the reference (tmtpu/types/validator.py)

# observability (iii): cold flushes traced and not, in turns. A flush's host
# time spreads by a few ms from one flush to the next, so a median of 7 moves
# by more than the 5% the check allows; 300 a side pin each median well inside it
COST_RUNS = 300
COST_BLOCK = 7  # the spread of medians of this many is printed beside it

MESH_SHARDS = 4      # shards of the one card when the machine has one
MESH_RAGGED = (1, 33, 127)

SIDECAR_CLIENTS = 4  # validator processes sharing the card in phase (b)
GATHER_MS = 2000     # the fixed gather window that lets all four ride one dispatch
READY_TIMEOUT_S = 300

# (f) light-client-shaped traffic: a run of the sequential sync (4
# validators x 1,024 heights, tools/light_bench.py's default run) in one
# request, one signature forged, then bisection's four-lane requests
LIGHT_CHAIN_ID = "tmtpu-torch-smoke-light"
LIGHT_VALS = 4
LIGHT_HEIGHTS = 1024
LIGHT_HOPS = 20
LIGHT_POWER = 10
LIGHT_FORGED = (700, 2)  # (height, validator index)


def cpu_model() -> str:
    """The host CPU's model name (the host prep and the cache run there)."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "CPU model not known"


def _priv_key(curve: str, i: int):
    if curve == crypto_batch.ED25519:
        return PrivKeyEd25519(hashlib.sha256(f"{SEED}:validator:{i}".encode()).digest())
    if curve == crypto_batch.SR25519:
        return PrivKeySr25519(hashlib.sha256(f"{SEED}:sr25519:{i}".encode()).digest())
    return corpus.k1_priv(f"{SEED}:secp256k1:{i}".encode())


def sign_vote(task):
    """Validator key (curve, i)'s public key, precommit sign bytes (the
    timestamp is i's) and signature (pool worker)."""
    curve, i = task
    priv = _priv_key(curve, i)
    msg = vote_sign_bytes(CHAIN_ID, PRECOMMIT, 1, 0, BLOCK_ID, T0_NS + 1000 * i)
    return priv.pub_key().bytes(), msg, priv.sign(msg)


def sign_light(task):
    """Light validator v's precommit for height h of the light chain: its
    public key, sign bytes and signature (pool worker)."""
    v, h = task
    priv = PrivKeyEd25519(hashlib.sha256(f"{SEED}:light:{v}".encode()).digest())
    block_id = (hashlib.sha256(b"light-block %d" % h).digest(), 1,
                hashlib.sha256(b"light-parts %d" % h).digest())
    msg = vote_sign_bytes(LIGHT_CHAIN_ID, PRECOMMIT, h, 0, block_id,
                          T0_NS + h * 1_000_000_000 + v)
    return priv.pub_key().bytes(), msg, priv.sign(msg)


def sign_all(*jobs):
    """[(worker, tasks)] -> each job's results, on one pool."""
    procs = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        return [pool.map(fn, tasks, chunksize=32) for fn, tasks in jobs]


def corrupt(sig: bytes) -> bytes:
    return bytes([sig[0] ^ 0xFF]) + sig[1:]


def tally_and_words(bv):
    """One ``verify_tally`` with its bitarray read, so the pack that
    ``bit_words`` makes at its first read stays inside the timed call."""
    out = bv.verify_tally()
    return out, bv.bit_words


def words_of(mask: np.ndarray) -> np.ndarray:
    """LSB-first uint32 words of a bool mask (the vote bitarray layout)."""
    pad = (-len(mask)) % 32
    m = np.concatenate([mask, np.zeros(pad, dtype=bool)]).reshape(-1, 32)
    return (m.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)


def nonzero_digits(rows: np.ndarray) -> int:
    """Non-zero 4-bit digits of the scalar byte rows of a packed plane."""
    return int(((rows & 0x0F) != 0).sum() + ((rows >> 4) != 0).sum())


def verify_products(packed: np.ndarray) -> int:
    """32x32->64 multiplies that verifying the lanes of a packed ed25519
    [128, B] plane needs, with the additions of zero digits skipped."""
    lanes = packed.shape[1]
    m = (FIXED_MS[0] * lanes + ADD_S_M * nonzero_digits(packed[64:96])
         + ADD_H_M * nonzero_digits(packed[96:128]))
    return m * PRODUCTS_PER_M + FIXED_MS[1] * lanes * PRODUCTS_PER_S


def sr_products(packed: np.ndarray) -> int:
    """The same for a packed sr25519 [128, B] plane (pk | r | s | k)."""
    lanes = packed.shape[1]
    m = (SR_FIXED_MS[0] * lanes + ADD_S_M * nonzero_digits(packed[64:96])
         + ADD_H_M * nonzero_digits(packed[96:128]))
    return m * PRODUCTS_PER_M + SR_FIXED_MS[1] * lanes * PRODUCTS_PER_S


def k1_products(packed: np.ndarray) -> int:
    """The same for a packed secp256k1 [168, B] plane (u1 and u2 in rows
    32..95)."""
    lanes = packed.shape[1]
    m = K1_FIXED_MS[0] * lanes + K1_ADD_M * nonzero_digits(packed[32:96])
    return m * K1_PRODUCTS_PER_M + K1_FIXED_MS[1] * lanes * K1_PRODUCTS_PER_S


def bound(int_muls: int, io_bytes: int):
    """(bound ms, what bounds it, ops ms, bytes ms) on the H100's peaks."""
    ops_ms = int_muls / INT_MULS_PER_S * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            ops_ms, bytes_ms)


def ptxas_summary(log: str) -> str:
    """Registers, spills, stack and static shared memory from nvcc's
    -Xptxas -v output."""
    regs = re.findall(r"Used (\d+) registers", log)
    spill = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    stack = re.findall(r"(\d+) bytes stack frame", log)
    smem = re.findall(r"(\d+) bytes smem", log)
    return (f"{','.join(regs)} registers, spill stores/loads "
            f"{','.join(f'{a}/{b}' for a, b in spill)} B, stack {','.join(stack)} B, "
            f"static shared {','.join(smem) or '0'} B")



class Curve(NamedTuple):
    """One kernel's pieces: host prep, the wrapper, its plain version on a
    CUDA plane, the oracle and the bound's inputs."""
    name: str
    source: str
    replaces: str
    prep: Callable
    launch: Callable
    plain: Callable
    oracle: Callable
    products: Callable
    lane_bytes: int
    table_bytes: int


CURVES = {
    crypto_batch.ED25519: Curve(
        "ed25519_verify", "tmtpu_torch/gpu/csrc/ed25519_verify.cu",
        "tmtpu/tpu/kernel.py:286", tv.prepare_batch_packed,
        kernel.verify_packed, tv.plain_packed, corpus.oracle, verify_products,
        128 + 4, 16 * 3 * 10 * 4),
    crypto_batch.SR25519: Curve(
        "sr25519_verify", "tmtpu_torch/gpu/csrc/sr25519_verify.cu",
        "tmtpu/tpu/kernel.py:466", sv.prepare_sr_batch_packed,
        kernel.sr_verify_packed, sv.plain_packed, corpus.sr_oracle, sr_products,
        128 + 4, 16 * 3 * 10 * 4),
    crypto_batch.SECP256K1: Curve(
        "k1_verify", "tmtpu_torch/gpu/csrc/k1_verify.cu",
        "tmtpu/tpu/k1_kernel.py:256", kv.prepare_k1_batch_packed,
        k1_kernel.verify_packed, kv.plain_packed, corpus.k1_oracle, k1_products,
        kv.PACKED_ROWS + 4, 16 * 3 * 8 * 4),
}


def hold(curve: Curve, packed: torch.Tensor, what: str):
    """Run a kernel and its plain version on one CUDA plane and require the
    masks equal bit for bit. Returns (kernel mask, plain ms of this call,
    lanes that differ, max abs error)."""
    k_mask = curve.launch(packed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_mask = curve.plain(packed)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mismatches = int((k_mask != p_mask).sum().item())
    max_abs_err = int((k_mask.int() - p_mask.int()).abs().max().item())
    check(mismatches == 0, f"{curve.name} == plain on {what} ({mismatches} differ)")
    return k_mask, plain_ms, mismatches, max_abs_err


def check_kernel(curve: Curve, pks, msgs, sigs, expect, adversarial, n, card):
    """Hold one kernel against its plain version on the card: on the plane
    of the lanes its path gives it, at the path's width, on that plane
    tiled to ``n`` lanes, and on an adversarial block; against the oracle
    on samples and on the block; then time it. Returns its entry of the
    kernels line (launches filled in by the caller)."""
    lane_np, lane_ok = curve.prep(pks, msgs, sigs)
    lane_packed = torch.from_numpy(lane_np).cuda()
    reps = -(-n // len(sigs))
    packed_np = np.ascontiguousarray(np.tile(lane_np, (1, reps))[:, :n])
    ok_n = np.tile(lane_ok, reps)[:n]
    want_n = np.tile(expect, reps)[:n]
    packed = torch.from_numpy(packed_np).cuda()
    k_mask, plain_first_ms, mismatches, max_abs_err = hold(curve, packed, f"{n} lanes")
    check(np.array_equal(k_mask.cpu().numpy() & ok_n, want_n),
          f"{curve.name} mask on the tiled plane")
    if len(sigs) != n:
        p_k, _, p_mismatch, p_err = hold(curve, lane_packed,
                                         f"the path's {len(sigs)} lanes")
        check(np.array_equal(p_k.cpu().numpy() & lane_ok, expect),
              f"{curve.name} mask at the path's width")
        mismatches += p_mismatch
        max_abs_err = max(max_abs_err, p_err)

    # the ragged edge: the path plane's first 1, 3, 5, 11 (the commit
    # flush's width in path 2) and 33 lanes, valid and corrupted lanes
    # mixed, each launched alone, against one plain call over all of them
    ragged = [lane_packed[:, :r].contiguous() for r in RAGGED]
    r_kernel = torch.cat([curve.launch(p) for p in ragged])
    r_plain = curve.plain(torch.cat(ragged, dim=1).contiguous())
    r_mismatch = int((r_kernel != r_plain).sum().item())
    check(r_mismatch == 0, f"{curve.name} == plain at {RAGGED} lanes ({r_mismatch} differ)")
    check(np.array_equal(r_kernel.cpu().numpy() & np.concatenate([lane_ok[:r] for r in RAGGED]),
                         np.concatenate([expect[:r] for r in RAGGED])),
          f"{curve.name} mask at {RAGGED} lanes")
    max_abs_err = max(max_abs_err, int((r_kernel.int() - r_plain.int()).abs().max().item()))

    a_pks, a_msgs, a_sigs = adversarial
    a_np, a_ok = curve.prep(a_pks, a_msgs, a_sigs)
    a_k, _, a_mismatch, a_err = hold(curve, torch.from_numpy(a_np).cuda(),
                                     "the adversarial block")
    check(np.array_equal(a_k.cpu().numpy() & a_ok, curve.oracle(a_pks, a_msgs, a_sigs)),
          f"{curve.name} adversarial block against the oracle")
    mismatches += a_mismatch
    max_abs_err = max(max_abs_err, a_err)

    bad = np.flatnonzero(~expect).tolist()
    sample = sorted(set(np.random.default_rng(SEED).choice(len(sigs), min(24, len(sigs)),
                                                            replace=False).tolist())
                    | set(bad))
    k_final = k_mask.cpu().numpy()[:len(sigs)] & lane_ok
    check(np.array_equal(k_final[sample], curve.oracle([pks[i] for i in sample],
                                                       [msgs[i] for i in sample],
                                                       [sigs[i] for i in sample])),
          f"{curve.name} sampled lanes against the oracle")
    print(f"{curve.name} == plain: {n} lanes, the path's {len(sigs)}, "
          f"{', '.join(map(str, RAGGED))} and {len(a_sigs)} adversarial lanes, 0 mismatches; "
          f"{len(sample)} + {len(a_sigs)} lanes match the oracle")

    time_cuda(lambda: curve.launch(packed), 3)
    k_times = time_cuda(lambda: curve.launch(packed), 20)
    kernel_ms = statistics.median(k_times)
    plain_ms = statistics.median(time_cuda(lambda: curve.plain(packed), 2))
    path_ms = statistics.median(time_cuda(lambda: curve.launch(lane_packed), 20))
    int_muls = curve.products(packed_np)
    bound_ms, bound_by, _, bytes_ms = bound(int_muls, n * curve.lane_bytes + curve.table_bytes)
    print(f"{curve.name}: {kernel_ms:.4f} ms median of 20 at {n} lanes = "
          f"{n / kernel_ms * 1e3:.0f} sig/s (min {min(k_times):.4f}, max {max(k_times):.4f}); "
          f"{path_ms:.4f} ms at the main path's {len(sigs)} lanes [{card}]")
    print(f"{curve.name} plain version: {plain_ms:.1f} ms at {n} lanes "
          f"(first call {plain_first_ms:.1f} ms) [{card}]")
    print(f"{curve.name} bound: {bound_ms:.4f} ms ({int_muls} integer multiplies; "
          f"bytes {bytes_ms:.5f} ms)")
    return {
        "name": curve.name,
        "route": "cuda",
        "source": curve.source,
        "replaces": curve.replaces,
        "launches": None,
        "max_abs_err": max_abs_err,
        "mismatches": mismatches,
        "lanes": n,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "path_lanes": len(sigs),
        "path_ms": path_ms,
    }


def phase_split(keys, msgs, sigs, dev) -> dict:
    """One cold ed25519 verify_tally at power 3, phase by phase: the
    functions the call runs, called in sequence with the card synchronised
    around each. Returns {phase: ms}; checks the result against a whole
    call's."""
    cache = sigcache.DEFAULT
    cache.invalidate_all()
    items = [(k, m, s, POWER) for k, m, s in zip(keys, msgs, sigs)]
    times = {}

    def phase(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    types, pks = phase("item fields (each key's type and bytes(), taken in add)",
                       lambda: ([k.type_value() for k in keys], [k.bytes() for k in keys]))
    ks, rep = phase("cache keys, lookups and dedup (one C call)",
                    lambda: cache.resolve(types, pks, msgs, sigs))
    check(rep.tolist() == list(range(len(items))), "phase split: a cold cache")
    packed, host_ok = phase("C prep", lambda: tv.prepare_batch_packed(pks, msgs, sigs))
    packed_d, powers_d, ok_d = phase("host-to-device copy", lambda: sharding.upload(
        packed, [POWER] * len(items), host_ok, dev))
    k_mask = phase("kernel", lambda: kernel.verify_packed(packed_d))
    mask, tally = phase("tally and readback", lambda: sharding.readback(
        *sharding.tally_lanes(k_mask, powers_d, ok_d)))

    def inserts():
        cache.add_many(ks[mask])
        return mask.tolist()
    mask_list = phase("cache inserts", inserts)
    words = phase("bit pack", lambda: sharding.pack_words(mask_list, dev))
    whole = crypto_batch.new_batch_verifier()
    for item in items:
        whole.add(*item)
    cache.invalidate_all()
    _, want_mask, want_tally = whole.verify_tally()
    check(mask_list == want_mask and tally == want_tally
          and np.array_equal(words, whole.bit_words), "phase split == one whole call")
    return times


def verify_once(keys, msgs, sigs, expect, cold, card) -> dict:
    """Path 2: one height verified once. The ingestion flush, on an empty
    cache, gets every vote and every 4th a second time; the commit flush
    of the next block gets the 10,000 triples again. ``cold`` is the
    ed25519 path's (mask, tally, bit_words). Returns the launch counts and
    times."""
    n = len(keys)
    sigcache.invalidate_all()
    order = [j for i in range(n) for j in ([i, i] if i % RELAY_EVERY == 0 else [i])]
    ingest = crypto_batch.new_batch_verifier()
    for i in order:
        ingest.add(keys[i], msgs[i], sigs[i], POWER)
    reset_launches()
    t0 = time.perf_counter()
    all_ok, mask, tally = ingest.verify_tally()
    ingest_ms = (time.perf_counter() - t0) * 1e3
    ingest_launches = launches()
    want = expect[order]
    relayed = len(order) - n
    check(ingest.cache_stats == {"lanes": len(order), "hits": 0, "dedup": relayed,
                                 "dispatched": n},
          f"ingestion cache_stats {ingest.cache_stats}")
    check(ingest_launches == {"ed25519_verify": 1, "sr25519_verify": 0, "k1_verify": 0},
          f"ingestion: one ed25519 launch ({ingest_launches})")
    check(not all_ok and np.array_equal(np.array(mask), want),
          "ingestion: false exactly at the corrupted votes and their copies")
    check(tally == POWER * int(want.sum()), f"ingestion tally {tally}")
    check(np.array_equal(ingest.bit_words, words_of(want)), "ingestion bitarray words")
    print(f"verify once, ingestion: {len(order)} items ({relayed} relayed twice), "
          f"cache_stats {ingest.cache_stats}, launches {ingest_launches}, tally {tally}, "
          f"{int((~want).sum())} rejected; flush {ingest_ms:.3f} ms [{card}]")

    commit = crypto_batch.new_batch_verifier()
    for i in range(n):
        commit.add(keys[i], msgs[i], sigs[i], POWER)
    reset_launches()
    t0 = time.perf_counter()
    all_ok, mask, tally = commit.verify_tally()
    commit_ms = (time.perf_counter() - t0) * 1e3
    commit_launches = launches()
    bad = int((~expect).sum())
    check(commit.cache_stats == {"lanes": n, "hits": n - bad, "dedup": 0, "dispatched": bad},
          f"commit cache_stats {commit.cache_stats}")
    check(commit_launches == {"ed25519_verify": 1, "sr25519_verify": 0, "k1_verify": 0},
          f"commit: one ed25519 launch ({commit_launches})")
    cold_mask, cold_tally, cold_words = cold
    check(mask == cold_mask and tally == cold_tally and not all_ok,
          "commit: the cold call's mask and tally")
    check(np.array_equal(commit.bit_words, cold_words), "commit: the cold call's bitarray")
    print(f"verify once, commit: {n} items, cache_stats {commit.cache_stats}, "
          f"launches {commit_launches} ({bad} lanes), tally {tally}; "
          f"flush {commit_ms:.3f} ms [{card}]")
    return {"ingest_launches": ingest_launches["ed25519_verify"],
            "commit_launches": commit_launches["ed25519_verify"],
            "ingest_ms": ingest_ms, "commit_ms": commit_ms}


def tally_past_2_63(key, msg, sig) -> dict:
    """One ed25519 precommit relayed 8 and 9 times at 2^60 each, with the
    cache on (the copies folded onto one lane of power 2^63 or more) and
    off (one lane each): the tally must be the exact integer, where an
    int64 sum wraps. Returns {case: tally}."""
    out = {}
    for on in (True, False):
        sigcache.DEFAULT.set_enabled(on)
        for copies in (8, 9):
            sigcache.invalidate_all()
            bv = crypto_batch.new_batch_verifier()
            for _ in range(copies):
                bv.add(key, msg, sig, P60)
            all_ok, mask, tally = bv.verify_tally()
            case = f"{copies} copies, cache {'on' if on else 'off'}"
            check(all_ok and mask == [True] * copies and tally == copies * P60,
                  f"tally past 2^63, {case}: {tally}")
            check(bv.cache_stats["dispatched"] == (1 if on else copies),
                  f"tally past 2^63, {case}: {bv.cache_stats}")
            out[case] = tally
    sigcache.DEFAULT.set_enabled(True)
    sigcache.invalidate_all()
    return out


def observability_phase(keys, msgs, sigs, expect, m_keys, m_msgs, m_sigs, m_expect,
                        kernel_ms, card) -> dict:
    """The device path's spans read from the real flush: (i) the cold
    10,000-lane ed25519 verify_tally and the first read of its
    ``bit_words``, traced, record four roots in turn:
    ``sigcache.resolve`` (``lanes`` 10,000, ``hits`` 0), the reference's
    tree (``crypto.batch_verify_tally`` over prepare, device_put, execute
    and readback, ``lanes`` 10,000), ``sigcache.insert`` (``lanes`` the
    valid lanes) and ``crypto.pack_words`` (``lanes`` 10,000); the
    children's sum within the parent's
    time and that within the flush's wall time, and ``ed25519.execute``'s
    ``device_ms`` within 15% of the kernel alone on the flush's plane,
    timed with CUDA events, each launch after a host pause as long as the
    flush's before its execute stage (the card runs a kernel after a pause
    slower than back to back; ``kernel_ms``, back to back, is printed
    beside it); (ii) the cold mixed set records one
    ``sr25519.execute`` and one ``secp256k1.execute`` of 500 lanes each;
    (iii) ``COST_RUNS`` cold flushes traced and as many with tracing off,
    in turns: the median on may exceed the median off by 5% or by 0.5 ms,
    not both."""
    n = len(sigs)
    bv = crypto_batch.new_batch_verifier()
    for key, msg, sig in zip(keys, msgs, sigs):
        bv.add(key, msg, sig, POWER)
    out = {}

    # (i) the 10,000-lane set, cold, traced
    sigcache.invalidate_all()
    trace.drain()
    reset_launches()
    t0 = time.perf_counter()
    _ok, mask, tally = bv.verify_tally()
    words = bv.bit_words  # packed at its first read, under crypto.pack_words
    wall_ms = (time.perf_counter() - t0) * 1e3
    out["launches"] = launches()
    spans = trace.drain()
    check(mask == expect.tolist() and tally == POWER * int(expect.sum())
          and np.array_equal(words, words_of(expect)),
          "observability (i): mask, tally and bitarray words")
    check(out["launches"]["ed25519_verify"] == 1, f"observability (i): {out['launches']}")
    roots = sorted((sp for sp in spans if sp.parent_id is None), key=lambda sp: sp.start_s)
    check([(sp.name, sp.attrs.get("lanes")) for sp in roots]
          == [("sigcache.resolve", n), ("crypto.batch_verify_tally", n),
              ("sigcache.insert", int(expect.sum())), ("crypto.pack_words", n)]
          and roots[0].attrs.get("hits") == 0 and roots[1].attrs.get("impl") == "cuda",
          f"observability (i): the resolve, the tree, the insert and the bit pack "
          f"({[(sp.name, sp.attrs) for sp in roots]})")
    root = roots[1]
    children = sorted((sp for sp in spans if sp.parent_id == root.span_id),
                      key=lambda sp: sp.start_s)
    names = [sp.name for sp in children]
    check(names == ["ed25519.prepare", "ed25519.device_put", "ed25519.execute",
                    "ed25519.readback"] and len(spans) == 8,
          f"observability (i): the reference's tree but ed25519.pad ({[sp.name for sp in spans]})")
    check(children[0].attrs == {"lanes": n}, f"observability (i): prepare {children[0].attrs}")
    stages = {sp.name.split(".")[1]: sp.duration_s * 1e3 for sp in children}
    parent_ms = root.duration_s * 1e3
    check(sum(stages.values()) <= parent_ms <= wall_ms,
          f"observability (i): children {sum(stages.values()):.3f} <= parent {parent_ms:.3f} "
          f"<= wall {wall_ms:.3f} ms")
    device_ms = children[2].attrs["device_ms"]
    # the kernel alone on the flush's plane, after the flush's idle gap:
    # from the flush's start to its execute stage the card runs nothing
    gap_s = children[2].start_s - t0
    plane = torch.from_numpy(tv.prepare_batch_packed([k.bytes() for k in keys], msgs,
                                                     sigs)[0]).cuda()

    def after_pause(pause_s: float) -> float:
        """Median of 7 launches alone, each after a host pause."""
        times = []
        for _ in range(7):
            time.sleep(pause_s)
            times += time_cuda(lambda: kernel.verify_packed(plane), 1)
        return statistics.median(times)

    alone_ms = after_pause(gap_s)
    pauses = {ms: after_pause(ms / 1e3) for ms in (0, 2, 15, 50)}
    check(abs(device_ms - alone_ms) <= 0.15 * alone_ms,
          f"observability (i): execute device_ms {device_ms:.4f} within 15% of the kernel "
          f"alone after the flush's {gap_s * 1e3:.1f} ms gap, {alone_ms:.4f}")
    print("observability (i): spans of the cold {}-lane flush (ms): ".format(n)
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; execute device_ms {device_ms:.4f}, the kernel alone after the flush's "
          f"{gap_s * 1e3:.3f} ms gap {alone_ms:.4f} (median of 7, {device_ms / alone_ms:.3f}x), "
          f"back to back {kernel_ms:.4f} ({device_ms / kernel_ms:.3f}x); "
          f"crypto.batch_verify_tally {parent_ms:.3f}; the flush's wall {wall_ms:.3f} [{card}]")
    print("observability (i): the kernel alone on that plane after a host pause of "
          + ", ".join(f"{ms} ms {v:.4f}" for ms, v in pauses.items())
          + f" (medians of 7) [{card}]")
    out.update(stages_ms=stages, device_ms=device_ms, kernel_ms=kernel_ms,
               kernel_after_gap_ms=alone_ms, gap_ms=gap_s * 1e3, parent_ms=parent_ms,
               wall_ms=wall_ms, kernel_after_pause_ms=pauses)

    # (ii) the mixed set: one execute span a curve
    mv = crypto_batch.new_batch_verifier()
    for key, msg, sig in zip(m_keys, m_msgs, m_sigs):
        mv.add(key, msg, sig, POWER)
    sigcache.invalidate_all()
    trace.drain()
    reset_launches()
    _ok, mask, _tally = mv.verify_tally()
    out["mixed_launches"] = launches()
    spans = trace.drain()
    check(mask == m_expect.tolist(), "observability (ii): mask")
    execs = {name: [sp for sp in spans if sp.name == name]
             for name in ("ed25519.execute", "sr25519.execute", "secp256k1.execute")}
    for name, lanes in (("sr25519.execute", N_SR), ("secp256k1.execute", N_K1)):
        check(len(execs[name]) == 1 and execs[name][0].attrs.get("lanes") == lanes,
              f"observability (ii): one {name} of {lanes} lanes "
              f"({[sp.attrs for sp in execs[name]]})")
    roots = [sp for sp in spans if sp.name == "crypto.batch_verify_tally"]
    check(len(roots) == 1 and roots[0].attrs["lanes"] == len(m_sigs) - N_SR - N_K1,
          "observability (ii): one ed25519 tree of the set's ed25519 lanes")
    out["mixed_device_ms"] = {name: sps[0].attrs["device_ms"] for name, sps in execs.items()}
    out["mixed_execute_ms"] = {name: sps[0].duration_s * 1e3 for name, sps in execs.items()}
    print("observability (ii): the mixed set's execute spans (ms, device_ms in brackets): "
          + ", ".join(f"{name} {out['mixed_execute_ms'][name]:.3f} "
                      f"({out['mixed_device_ms'][name]:.4f})" for name in execs)
          + f"; launches {out['mixed_launches']} [{card}]")

    # (iii) the instrumentation's cost, in turns
    on, off = [], []
    reset_launches()
    try:
        for i in range(COST_RUNS):
            for enabled in ((True, False) if i % 2 == 0 else (False, True)):
                trace.set_enabled(enabled)
                sigcache.invalidate_all()
                t0 = time.perf_counter()
                bv.verify_tally()
                (on if enabled else off).append((time.perf_counter() - t0) * 1e3)
    finally:
        trace.set_enabled(True)
    trace.drain()
    out["cost_launches"] = launches()
    check(out["cost_launches"]["ed25519_verify"] == 2 * COST_RUNS,
          f"observability (iii): one launch a flush ({out['cost_launches']})")
    on_ms, off_ms = statistics.median(on), statistics.median(off)
    paired_ms = statistics.median(a - b for a, b in zip(on, off))
    blocks = [statistics.median(on[i:i + COST_BLOCK]) - statistics.median(off[i:i + COST_BLOCK])
              for i in range(0, COST_RUNS - COST_BLOCK + 1, COST_BLOCK)]
    out.update(on_ms=on_ms, off_ms=off_ms, paired_ms=paired_ms,
               block_diff_ms=(min(blocks), max(blocks)))
    print(f"observability (iii): cold {n}-lane flush, median of {COST_RUNS} each in turns: "
          f"tracing on {on_ms:.3f} ms, off {off_ms:.3f} ms ({on_ms - off_ms:+.3f} ms, "
          f"{(on_ms / off_ms - 1) * 100:+.2f}%); median of the paired differences "
          f"{paired_ms:+.3f} ms; on - off over medians of {COST_BLOCK} consecutive "
          f"{min(blocks):+.3f} to {max(blocks):+.3f} ms; launches {out['cost_launches']} "
          f"[{card}]")
    check(not (on_ms > 1.05 * off_ms and on_ms - off_ms > 0.5),
          f"observability (iii): tracing costs {on_ms - off_ms:.3f} ms over {off_ms:.3f}")
    return out


def mesh_phase(pks, msgs, sigs, expect, mixed, card) -> dict:
    """The sharded steps of ``gpu/sharding.py`` on the card, which
    ``entry.dryrun_multichip`` certifies: (a) the 10,000-vote ed25519 set
    through ``sharded_verify_tally`` against the single-device flush, bit
    for bit, timed; (b) the mixed set's sr25519 and secp256k1 lanes through
    ``sharded_verify_sr`` / ``sharded_verify_k1``; (c) ragged widths with
    empty shards; (d) the tally past 2^63 with the copies on every shard;
    (e) ``entry()`` and ``dryrun_multichip``. The mesh is every card when
    there are two or more, else ``MESH_SHARDS`` shards of the one card.
    Returns the counts and times."""
    dev = torch.device("cuda")
    cards = torch.cuda.device_count()
    mesh = sharding.make_mesh() if cards >= 2 else (torch.device("cuda", 0),) * MESH_SHARDS
    n = len(sigs)
    powers = [POWER] * n
    out = {"mesh": [str(d) for d in mesh]}
    tally_step = sharding.sharded_verify_tally(mesh)
    mask_steps = {crypto_batch.SR25519: (sv.prepare_sr_batch_packed,
                                         sharding.sharded_verify_sr(mesh)),
                  crypto_batch.SECP256K1: (kv.prepare_k1_batch_packed,
                                           sharding.sharded_verify_k1(mesh))}

    def sharded_tally(pks, msgs, sigs, powers):
        packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
        mask, sums = tally_step(packed, sharding.power_limbs(powers), host_ok)
        return mask.cpu().numpy(), sharding.combine_limbs(sums.cpu().tolist())

    def sharded_mask(kind, pks, msgs, sigs):
        prep, step = mask_steps[kind]
        packed, host_ok = prep(pks, msgs, sigs)
        return step(packed).cpu().numpy() & host_ok

    def shards_of(b):
        return len(sharding.shard_bounds(b, len(mesh)))

    # (a) the ed25519 set, each shard's width read off the launch wrapper
    reset_launches()
    widths, launch = [], kernel.verify_packed
    kernel.verify_packed = lambda packed: (widths.append(packed.shape[1]), launch(packed))[1]
    try:
        m_mask, m_tally = sharded_tally(pks, msgs, sigs, powers)
    finally:
        kernel.verify_packed = launch
    a_launches = launches()
    s_mask, s_tally = sharding.batch_verify_tally(pks, msgs, sigs, powers, device=dev)
    check(np.array_equal(m_mask, s_mask) and np.array_equal(m_mask, expect),
          "mesh (a): the mask equals the single-device flush's")
    check(m_tally == s_tally == POWER * int(expect.sum()), f"mesh (a): tally {m_tally}")
    check(np.array_equal(sharding.pack_words(m_mask, dev), sharding.pack_words(s_mask, dev)),
          "mesh (a): bitarray words")
    check(a_launches == {"ed25519_verify": shards_of(n), "sr25519_verify": 0, "k1_verify": 0},
          f"mesh (a): one launch a shard ({a_launches})")
    want_sizes = [hi - lo for lo, hi in sharding.shard_bounds(n, len(mesh))]
    if len(mesh) == 4 and n == MAX_VOTES_COUNT:
        check(want_sizes == [2528, 2528, 2528, 2416], f"mesh (a): shard sizes {want_sizes}")
    check(widths == want_sizes, f"mesh (a): shard widths {widths}, want {want_sizes}")
    mesh_ms, single_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        sharded_tally(pks, msgs, sigs, powers)
        mesh_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        sharding.batch_verify_tally(pks, msgs, sigs, powers, device=dev)
        single_ms.append((time.perf_counter() - t0) * 1e3)
    out.update(launches=a_launches["ed25519_verify"], shard_lanes=widths,
               flush_ms=statistics.median(mesh_ms), single_ms=statistics.median(single_ms),
               flush_ms_all=mesh_ms, single_ms_all=single_ms)
    print(f"mesh (a): {n} ed25519 lanes over {len(mesh)} shards ({cards} card(s)), shard lanes "
          f"{widths}, launches {a_launches}; mask, tally {m_tally} and bitarray equal the "
          f"single-device flush; prep + sharded_verify_tally + readback "
          f"{out['flush_ms']:.3f} ms against sharding.batch_verify_tally {out['single_ms']:.3f} "
          f"ms, medians of 5 in turns [{card}]")

    # (b) the mixed set's sr25519 and secp256k1 lanes
    singles = {crypto_batch.SR25519: sv.batch_verify_sr, crypto_batch.SECP256K1: kv.batch_verify_k1}
    names = {crypto_batch.SR25519: "sr25519_verify", crypto_batch.SECP256K1: "k1_verify"}
    for kind, single in singles.items():
        k_pks, k_msgs, k_sigs, k_expect = mixed[kind]
        reset_launches()
        m = sharded_mask(kind, k_pks, k_msgs, k_sigs)
        b_launches = launches()
        check(np.array_equal(m, single(k_pks, k_msgs, k_sigs, device=dev))
              and np.array_equal(m, k_expect), f"mesh (b): {kind} mask")
        check(b_launches[names[kind]] == shards_of(len(k_sigs))
              and sum(b_launches.values()) == shards_of(len(k_sigs)),
              f"mesh (b): {kind} one launch a shard ({b_launches})")
        out[f"{kind}_launches"] = b_launches[names[kind]]
    print(f"mesh (b): the mixed set's {len(mixed[crypto_batch.SR25519][2])} sr25519 and "
          f"{len(mixed[crypto_batch.SECP256K1][2])} secp256k1 lanes over {len(mesh)} shards "
          f"equal the single-device masks, launches {out['sr25519_launches']} and "
          f"{out['secp256k1_launches']}")

    # (c) ragged widths: some shards empty, which neither copy nor launch
    for b in MESH_RAGGED:
        reset_launches()
        r_powers = [POWER + i for i in range(b)]
        m, t = sharded_tally(pks[:b], msgs[:b], sigs[:b], r_powers)
        check(launches()["ed25519_verify"] == shards_of(b),
              f"mesh (c): {b} lanes, one launch a non-empty shard ({launches()})")
        sm, st = sharding.batch_verify_tally(pks[:b], msgs[:b], sigs[:b], r_powers, device=dev)
        check(np.array_equal(m, sm) and np.array_equal(m, expect[:b]) and t == st,
              f"mesh (c): {b} ed25519 lanes")
        for kind, single in singles.items():
            k_pks, k_msgs, k_sigs, k_expect = mixed[kind]
            km = sharded_mask(kind, k_pks[:b], k_msgs[:b], k_sigs[:b])
            check(np.array_equal(km, single(k_pks[:b], k_msgs[:b], k_sigs[:b], device=dev))
                  and np.array_equal(km, k_expect[:b]), f"mesh (c): {b} {kind} lanes")
    print(f"mesh (c): widths {MESH_RAGGED} over {len(mesh)} shards "
          f"({[shards_of(b) for b in MESH_RAGGED]} non-empty), every curve equal to "
          f"the single-device path")

    # (d) the tally past 2^63: copies of one precommit at 2^60 on every
    # shard among 128 valid lanes of power 1, each shard's sum under 2^63
    big = {}
    for copies in (8, 9):
        b = 128
        at = set(range(0, b, b // copies)[:copies])
        rows = [(pks[1], msgs[1], sigs[1], P60) if j in at else
                (pks[1 + j], msgs[1 + j], sigs[1 + j], 1) for j in range(b)]
        cols = [list(c) for c in zip(*rows)]
        m, t = sharded_tally(*cols)
        _, st = sharding.batch_verify_tally(*cols, device=dev)
        check(m.all() and t == st == copies * P60 + b - copies,
              f"mesh (d): {copies} copies at 2^60: {t}")
        big[f"{copies} copies"] = t
    out["tally_past_2_63"] = big
    print("mesh (d): the tally past 2^63 with the copies split across shards, exact: "
          + ", ".join(f"{k}: {v}" for k, v in big.items()))

    # (e) the entry points
    step, args = entry_mod.entry()
    e_mask, e_sums = step(*args)
    check(bool(e_mask.all()) and sharding.combine_limbs(e_sums.cpu().tolist()) == 32 * 1000,
          "mesh (e): entry() step")
    t0 = time.perf_counter()
    entry_mod.dryrun_multichip(MESH_SHARDS, devices=(torch.device("cuda", 0),) * MESH_SHARDS)
    if cards >= 2:
        entry_mod.dryrun_multichip(cards)
    out["dryrun_s"] = time.perf_counter() - t0
    print(f"mesh (e): entry() and dryrun_multichip passed ({out['dryrun_s']:.1f} s)")
    return out


class Daemon:
    """``python -m tmtpu_torch sidecar`` in a process of its own, on a unix
    socket in a fresh temporary directory (tcp on 127.0.0.1 when that path
    is too long for a socket). Its stdout is read on a thread; its stderr
    goes to a file, printed when anything fails."""

    def __init__(self, name: str, *args: str, config=None):
        """``config(dir)``, when given, returns the text of the home's
        ``config/config.toml``, and the address is left to that file."""
        self.name = name
        self.dir = tempfile.mkdtemp(prefix="tmtpu-sc-")
        sock = os.path.join(self.dir, "s.sock")
        addr = f"unix://{sock}" if len(sock) < 100 else "tcp://127.0.0.1:0"
        if config is not None:
            os.makedirs(os.path.join(self.dir, "config"))
            with open(os.path.join(self.dir, "config", "config.toml"), "w") as fh:
                fh.write(config(self.dir))
        else:
            args = ("--addr", addr) + args
        self.err_path = os.path.join(self.dir, "stderr.log")
        self.err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tmtpu_torch", "sidecar", "--home", self.dir, *args],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=self.err, text=True)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()
        t0 = time.perf_counter()
        try:
            ready = self.lines.get(timeout=READY_TIMEOUT_S)
        except queue.Empty:
            ready = ""
        if not ready.startswith("Sidecar listening on "):
            err = self.stderr()
            self.kill()
            check(False, f"daemon {name} ready ({ready!r}; {err})")
        self.start_s = time.perf_counter() - t0
        self.ready = ready
        self.addr = ready.split()[3]
        self.warm_s = float(ready.split("warm_s=")[1].split()[0])
        print(f"sidecar daemon {name}: ready in {self.start_s:.1f} s "
              f"(warm-up {self.warm_s:.3f} s): {ready.strip()}")

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)

    def stderr(self) -> str:
        self.err.flush()
        with open(self.err_path) as fh:
            return fh.read()[-4000:]

    def client(self, name: str) -> SidecarClient:
        return SidecarClient(self.addr, client_id=name, connect_timeout_s=10.0,
                             request_deadline_s=120.0)

    def stats(self) -> dict:
        c = self.client("stats")
        try:
            return c.stats()
        finally:
            c.close()

    def terminate(self) -> int:
        """SIGTERM; the daemon must drain and exit 0."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        check(rc == 0, f"daemon {self.name} exits 0 on SIGTERM (rc {rc}; {self.stderr()})")
        return rc

    def kill(self) -> None:
        """Stop the process if it still runs, and remove its directory."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def sidecar_phase(pks, msgs, sigs, expect, mixed, card) -> dict:
    """The daemon, driven over its socket by the port's client. ``mixed`` is
    {curve: (pks, msgs, sigs, expect)} of the mixed-curve set. Returns the
    times and counts."""
    n = len(sigs)
    lanes = list(zip(pks, msgs, sigs, [POWER] * n))
    want_mask = expect.tolist()
    want_tally = POWER * int(expect.sum())
    bad = int((~expect).sum())
    out = {}
    daemons = []
    try:
        # (a) cache off: every round trip verifies the 10,000 lanes
        x = Daemon("cache off", "--no-sigcache")
        daemons.append(x)
        out["warm_s"] = x.warm_s
        out["start_s"] = x.start_s
        c = x.client("validator-0")
        rtts = []
        before = x.stats()
        for _ in range(5):
            t0 = time.perf_counter()
            mask, tallied, info = c.verify(crypto_batch.ED25519, lanes, tally=True, deadline_s=60.0)
            rtts.append((time.perf_counter() - t0) * 1e3)
            check(mask == want_mask and tallied == want_tally,
                  f"sidecar (a): mask and tally ({tallied})")
            check(info["dispatch_lanes"] == n and info["dispatch_clients"] == 1,
                  f"sidecar (a): one dispatch of the request's lanes ({info})")
        c.close()
        after = x.stats()
        check(after["engine"]["last_cache_stats"] == {"lanes": n, "hits": 0, "dedup": 0,
                                                       "dispatched": n},
              f"sidecar (a): cache_stats {after['engine']['last_cache_stats']}")
        check(launch_delta(before, after) == {"ed25519_verify": 5, "sr25519_verify": 0,
                                              "k1_verify": 0},
              f"sidecar (a): one launch a request ({launch_delta(before, after)})")
        check(after["sigcache"]["enabled"] is False and after["sigcache"]["hits"] == 0,
              "sidecar (a): the cache is off")
        out["rtt_ms"] = statistics.median(rtts)
        out["rtt_ms_all"] = rtts
        print(f"sidecar (a): {n} lanes with tally, cache-off daemon: round trip "
              f"{out['rtt_ms']:.3f} ms median of 5 ({', '.join(f'{t:.1f}' for t in rtts)}), "
              f"mask and tally {tallied} exact, cache_stats {after['engine']['last_cache_stats']}, "
              f"launches {launch_delta(before, after)} [{card}]")
        x.terminate()

        # (b) four clients at once on a fresh cache, one dispatch
        y = Daemon("cache on", "--gather-ms", str(GATHER_MS))
        daemons.append(y)
        before = y.stats()
        results, errors = {}, []
        barrier = threading.Barrier(SIDECAR_CLIENTS)

        def run(k):
            cl = y.client(f"validator-{k}")
            try:
                barrier.wait(timeout=30)
                t0 = time.perf_counter()
                results[k] = cl.verify(crypto_batch.ED25519, lanes, tally=True, deadline_s=60.0)
                results[k] += ((time.perf_counter() - t0) * 1e3,)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))
            finally:
                cl.close()

        threads = [threading.Thread(target=run, args=(k,)) for k in range(SIDECAR_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        check(not errors and len(results) == SIDECAR_CLIENTS, f"sidecar (b): replies ({errors})")
        after = y.stats()
        ids = {r[2]["dispatch_id"] for r in results.values()}
        for k, (mask, tallied, info, _) in results.items():
            check(mask == want_mask and tallied == want_tally,
                  f"sidecar (b): client {k}'s mask and tally ({tallied})")
            check(info["dispatch_clients"] == SIDECAR_CLIENTS
                  and info["dispatch_lanes"] == SIDECAR_CLIENTS * n,
                  f"sidecar (b): one dispatch of {SIDECAR_CLIENTS} clients ({info})")
        check(len(ids) == 1, f"sidecar (b): one dispatch id ({ids})")
        stats_b = after["engine"]["last_cache_stats"]
        check(stats_b == {"lanes": SIDECAR_CLIENTS * n, "hits": 0,
                          "dedup": (SIDECAR_CLIENTS - 1) * n, "dispatched": n},
              f"sidecar (b): cache_stats {stats_b}")
        check(launch_delta(before, after) == {"ed25519_verify": 1, "sr25519_verify": 0,
                                              "k1_verify": 0},
              f"sidecar (b): one launch ({launch_delta(before, after)})")
        out["four_clients_ms"] = max(r[3] for r in results.values())
        print(f"sidecar (b): {SIDECAR_CLIENTS} clients x {n} lanes at once, gather window "
              f"{GATHER_MS} ms: one dispatch of {SIDECAR_CLIENTS * n} lanes, cache_stats "
              f"{stats_b}, launches {launch_delta(before, after)}, every mask and tally exact; "
              f"last reply {out['four_clients_ms']:.1f} ms after the start [{card}]")

        # the commit flush over the wire: the same triples again
        before = after
        c = y.client("validator-0")
        t0 = time.perf_counter()
        mask, tallied, info = c.verify(crypto_batch.ED25519, lanes, tally=True, deadline_s=60.0)
        out["commit_rtt_ms"] = (time.perf_counter() - t0) * 1e3
        c.close()
        after = y.stats()
        check(mask == want_mask and tallied == want_tally, "sidecar commit: mask and tally")
        check(after["engine"]["last_cache_stats"] == {"lanes": n, "hits": n - bad, "dedup": 0,
                                                       "dispatched": bad},
              f"sidecar commit: cache_stats {after['engine']['last_cache_stats']}")
        check(after["sigcache"]["hits"] - before["sigcache"]["hits"] == n - bad,
              "sidecar commit: the daemon's hit count")
        print(f"sidecar commit flush: {n} lanes again, cache_stats "
              f"{after['engine']['last_cache_stats']}, launches {launch_delta(before, after)}; "
              f"round trip {out['commit_rtt_ms']:.3f} ms (gather window {GATHER_MS} ms "
              f"included) [{card}]")

        # (c) the mixed-curve set, one request a curve, at once
        before = after
        got, errors = {}, []

        def run_curve(kind):
            m_pks, m_msgs, m_sigs, _ = mixed[kind]
            cl = y.client(f"mixed-{kind}")
            try:
                got[kind] = cl.verify(kind, list(zip(m_pks, m_msgs, m_sigs,
                                                     [POWER] * len(m_sigs))),
                                      tally=True, deadline_s=60.0)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))
            finally:
                cl.close()

        threads = [threading.Thread(target=run_curve, args=(k,)) for k in CURVE_ORDER]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        check(not errors and len(got) == 3, f"sidecar (c): replies ({errors})")
        after = y.stats()
        for kind, (mask, tallied, info) in got.items():
            want = mixed[kind][3]
            check(mask == want.tolist() and tallied == POWER * int(want.sum()),
                  f"sidecar (c): {kind} mask and tally")
        check(launch_delta(before, after) == {"ed25519_verify": 1, "sr25519_verify": 1,
                                              "k1_verify": 1},
              f"sidecar (c): one launch of each kernel ({launch_delta(before, after)})")
        print(f"sidecar (c): mixed-curve set as one request a curve "
              f"({', '.join(f'{k} {len(mixed[k][2])}' for k in CURVE_ORDER)}): every mask and "
              f"tally exact, launches {launch_delta(before, after)}")
        y.terminate()

        print("sidecar daemons: both drained and exited 0 on SIGTERM")
    except Exception:
        for d in daemons:
            print(f"--- daemon {d.name} stderr ---\n{d.stderr()}", file=sys.stderr)
        raise
    finally:
        for d in daemons:
            d.kill()
    return out


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url: str):
    """(status, content type, body) of a GET, 4xx and 5xx included."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers["Content-Type"], exc.read().decode()


def metric_value(text: str, series: str) -> float:
    """One series' value in a Prometheus exposition (0 when absent)."""
    m = re.search(rf"^{re.escape(series)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def sidecar_config_and_health(pks, msgs, sigs, expect, card) -> dict:
    """(d) a daemon configured by its home's config.toml alone, and (e) its
    health listener: /healthz, then /metrics against Stats after one
    10,000-lane request."""
    n = len(sigs)
    lanes = list(zip(pks, msgs, sigs, [POWER] * n))
    out = {}
    daemons = []
    try:
        # (d) the address, the lane cap and the deadline from the file
        lane_cap, deadline_ns = 12345, 7_500_000_000

        def config(home):
            sock = os.path.join(home, "from-config.sock")
            out["config_addr"] = (f"unix://{sock}" if len(sock) < 100
                                  else f"tcp://127.0.0.1:{free_port()}")
            return (f'crypto_backend = "sidecar"\n\n[sidecar]\naddr = "{out["config_addr"]}"\n'
                    f"max_lanes_per_dispatch = {lane_cap}\n"
                    f"request_deadline_ns = {deadline_ns}\n")

        x = Daemon("config home", config=config)
        daemons.append(x)
        check(x.addr == out["config_addr"],
              f"sidecar (d): listens at the file's address ({x.addr} vs {out['config_addr']})")
        c = x.client("config")
        ack = c.connect()
        limits = x.stats()["limits"]
        check(ack.max_lanes == lane_cap and limits["max_lanes_per_dispatch"] == lane_cap
              and limits["request_deadline_s"] == deadline_ns / 1e9,
              f"sidecar (d): the file's limits (ack {ack.max_lanes}, stats {limits})")
        mask, tallied, _ = c.verify(crypto_batch.ED25519, lanes[:64], tally=True, deadline_s=60.0)
        check(mask == expect[:64].tolist(), "sidecar (d): a request at the file's address")
        c.close()
        print(f"sidecar (d): --home with config.toml alone: listening at {x.addr}, "
              f"limits {limits}, HelloAck max_lanes {ack.max_lanes}")
        x.terminate()

        # (e) /healthz and /metrics
        y = Daemon("health", "--health-laddr", f"127.0.0.1:{free_port()}")
        daemons.append(y)
        base = "http://" + y.ready.split("health=")[1].split()[0]
        status, ctype, body = http_get(base + "/healthz")
        health = json.loads(body)
        check(status == 200 and ctype == "application/json" and health["healthy"] is True
              and health["warmed"] is True, f"sidecar (e): /healthz ({status}, {ctype})")
        before = y.stats()
        c = y.client("health")
        mask, tallied, _ = c.verify(crypto_batch.ED25519, lanes, tally=True, deadline_s=60.0)
        c.close()
        check(mask == expect.tolist(), "sidecar (e): mask")
        after = y.stats()
        status, ctype, text = http_get(base + "/metrics")
        m = re.search(r'^tendermint_sidecar_server_dispatches_total\{curve="ed25519"\} (\d+)$',
                      text, re.M)
        dispatches = after["coalescer"]["dispatches"]
        check(status == 200 and ctype == "text/plain; version=0.0.4" and m is not None
              and int(m.group(1)) == dispatches and dispatches >= 1,
              f"sidecar (e): /metrics dispatches {m and m.group(1)} vs Stats {dispatches}")
        check(launch_delta(before, after)["ed25519_verify"] == 1,
              f"sidecar (e): one launch ({launch_delta(before, after)})")
        check(http_get(base + "/nothing")[0] == 404, "sidecar (e): 404 elsewhere")
        out["health_dispatches"] = dispatches
        print(f"sidecar (e): /healthz 200 healthy and warmed; after one {n}-lane request "
              f"/metrics dispatches_total{{curve=\"ed25519\"}} {m.group(1)} = Stats "
              f"{dispatches}, launches {launch_delta(before, after)} [{card}]")
        # the device path's families against Stats: one batch a launch,
        # the cache's counters and entries
        batches = metric_value(text, 'tendermint_crypto_batch_size_count'
                                     '{curve="ed25519",backend="gpu"}')
        ed_launches = after["engine"]["launches"]["ed25519_verify"]
        check(batches == ed_launches,
              f"sidecar (e): /metrics ed25519 batches {batches} vs Stats launches {ed_launches}")
        cache = {k: metric_value(text, f"tendermint_crypto_sigcache_{k}_total")
                 for k in ("hits", "misses", "inserts", "evictions")}
        cache["entries"] = metric_value(text, "tendermint_crypto_sigcache_entries")
        stats_cache = {k: after["sigcache"][k] for k in cache}
        check(cache == stats_cache,
              f"sidecar (e): /metrics sigcache {cache} vs Stats {stats_cache}")
        # one request with a valid v2 trace context, one with garbage
        c = y.client("traced")
        good = trace.TraceContext("00112233445566ff", 7, "chip-smoke").encode()
        for ctx, lo in ((good, 0), (b"\x01garbage", 4)):
            mask, _tallied, _ = c.verify(crypto_batch.ED25519, lanes[lo:lo + 4], tally=True,
                                         deadline_s=60.0, trace_ctx=ctx)
            check(mask == expect[lo:lo + 4].tolist(), "sidecar (e): traced requests' masks")
        c.close()
        text = http_get(base + "/metrics")[2]
        contexts = {k: metric_value(text, f'tendermint_trace_context_{k}_total'
                                          '{transport="sidecar"}') for k in ("rx", "invalid")}
        check(contexts == {"rx": 1, "invalid": 1}, f"sidecar (e): trace contexts {contexts}")
        out["health_batches"] = batches
        out["health_sigcache"] = cache
        print(f"sidecar (e): /metrics crypto_batch_size_count{{curve=\"ed25519\","
              f"backend=\"gpu\"}} {batches:g} = Stats ed25519 launches {ed_launches}; "
              f"sigcache {cache} = Stats; trace_context rx {contexts['rx']:g}, invalid "
              f"{contexts['invalid']:g} after one valid and one garbage context [{card}]")
        y.terminate()
    except Exception:
        for d in daemons:
            print(f"--- daemon {d.name} stderr ---\n{d.stderr()}", file=sys.stderr)
        raise
    finally:
        for d in daemons:
            d.kill()
    return out


def light_phase(light, card) -> dict:
    """(f) light-client-shaped traffic through a daemon of its own: one
    request of 4 validators x 1,024 heights (a run of the sequential sync:
    4,096 lanes, the keys repeating every four lanes, every message a
    distinct precommit) with one forged signature, held against the serial
    oracle; then ``LIGHT_HOPS`` four-lane requests of later heights one
    after another (bisection's shape, with the tally), their round trips
    timed. Then the same on a daemon with no gather window and no cache,
    so the run repeats (three times): what the window adds to a lone
    client's round trip. ``light`` is [(pk, msg, sig)] height-major."""
    pks, msgs, sigs = (list(col) for col in zip(*light))
    n_run = LIGHT_VALS * LIGHT_HEIGHTS
    forged = (LIGHT_FORGED[0] - 1) * LIGHT_VALS + LIGHT_FORGED[1]
    sigs[forged] = corrupt(sigs[forged])
    want = serial_mask(["ed25519"] * len(sigs), pks, msgs, sigs)
    check(np.flatnonzero(~want).tolist() == [forged],
          f"light (f): the oracle rejects the forged lane alone ({np.flatnonzero(~want)})")
    run_lanes = list(zip(pks[:n_run], msgs[:n_run], sigs[:n_run], [LIGHT_POWER] * n_run))
    out = {}

    def drive(d, runs, what):
        """The run ``runs`` times, then the hops; each request one launch.
        Returns (run round trips, hop round trips) in ms and the daemon's
        launches of each kernel over them."""
        before = d.stats()
        c = d.client("light-client")
        run_ms, hop_ms = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            mask, _, info = c.verify(crypto_batch.ED25519, run_lanes, tally=False,
                                     deadline_s=60.0)
            run_ms.append((time.perf_counter() - t0) * 1e3)
            check(mask == want[:n_run].tolist() and info["dispatch_lanes"] == n_run,
                  f"light (f), {what}: one dispatch of the run, its mask the oracle's, "
                  f"the forged lane included ({info})")
        for hop in range(LIGHT_HOPS):
            lo = n_run + LIGHT_VALS * hop
            lanes = [(pks[j], msgs[j], sigs[j], LIGHT_POWER) for j in range(lo, lo + LIGHT_VALS)]
            t0 = time.perf_counter()
            mask, tallied, _ = c.verify(crypto_batch.ED25519, lanes, tally=True, deadline_s=60.0)
            hop_ms.append((time.perf_counter() - t0) * 1e3)
            check(mask == [True] * LIGHT_VALS and tallied == LIGHT_POWER * LIGHT_VALS,
                  f"light (f), {what}: hop {hop}'s mask and tally ({mask}, {tallied})")
        c.close()
        counted = launch_delta(before, d.stats())
        check(counted == {"ed25519_verify": runs + LIGHT_HOPS, "sr25519_verify": 0,
                          "k1_verify": 0},
              f"light (f), {what}: one launch a request ({counted})")
        d.terminate()
        return run_ms, hop_ms, counted

    for name, args, runs, key in (("light", (), 1, ""),
                                  ("light, no gather window",
                                   ("--gather-ms", "0", "--no-sigcache"), 3, "_no_window")):
        d = Daemon(name, *args)
        try:
            run_ms, hop_ms, counted = drive(d, runs, name)
        except Exception:
            print(f"--- daemon {d.name} stderr ---\n{d.stderr()}", file=sys.stderr)
            raise
        finally:
            d.kill()
        out.update({f"light_run_rtt_ms{key}": statistics.median(run_ms),
                    f"light_run_rtt_ms{key}_all": run_ms,
                    f"light_hop_rtt_ms{key}": statistics.median(hop_ms),
                    f"light_hop_rtt_ms{key}_all": hop_ms,
                    f"light_launches{key}": counted["ed25519_verify"]})
        print(f"light (f), daemon {name!r} {' '.join(args)}: {LIGHT_VALS} validators x "
              f"{LIGHT_HEIGHTS} heights in one request ({n_run} lanes, the forged signature "
              f"at height {LIGHT_FORGED[0]}, validator {LIGHT_FORGED[1]}): mask equals the "
              f"serial oracle's, round trip {statistics.median(run_ms):.3f} ms (median of "
              f"{runs}); {LIGHT_HOPS} four-lane requests one after another: round trip "
              f"{statistics.median(hop_ms):.3f} ms median (min {min(hop_ms):.3f}, max "
              f"{max(hop_ms):.3f}); launches {counted} [{card}]")
    return out


def codec_and_engine(pks, msgs, sigs, expect, card) -> dict:
    """The codec and the daemon's engine on the 10,000-lane request, each
    alone (medians of 5): the port client's encode, the reference-style
    generic encode (Lane objects), the generic decode and the columnar
    decode of the frame, and the engine's in-process flush of the raw
    lanes, cold and with the cache off."""
    n = len(sigs)
    powers = [POWER] * n
    frame = sc_proto.encode_verify_frame(1, crypto_batch.ED25519, True, 60000, pks, msgs, sigs,
                                         powers)
    generic = sc_proto.VerifyRequest(
        request_id=1, curve=crypto_batch.ED25519, tally=True, deadline_ms=60000,
        lanes=[sc_proto.Lane(pub_key=a, msg=b, sig=c, power=d)
               for a, b, c, d in zip(pks, msgs, sigs, powers)])
    check(sc_proto.encode_frame(generic) == frame, "columnar encode == generic encode")
    body = sc_proto.FrameReader(io.BytesIO(frame)).read_body()
    check(sc_proto.decode_verify_columns(body)
          == sc_proto.columns_of(sc_proto.decode_frame(body)), "columnar decode == generic decode")
    t = {
        "encode_ms": time_host(lambda: sc_proto.encode_verify_frame(
            1, crypto_batch.ED25519, True, 60000, pks, msgs, sigs, powers), 5),
        "generic_encode_ms": time_host(lambda: sc_proto.encode_frame(generic), 5),
        "generic_decode_ms": time_host(lambda: sc_proto.decode_frame(body), 5),
        "columnar_decode_ms": time_host(lambda: sc_proto.decode_verify_columns(body), 5),
        "frame_bytes": len(frame),
    }

    def engine():
        return crypto_batch.verify_lanes(crypto_batch.ED25519, pks, msgs, sigs, powers, True)
    mask, stats = engine()
    check(mask == expect.tolist() and stats["dispatched"] == n, "engine: the mask, cold")
    t["engine_cold_ms"] = time_host(engine, 5, before=sigcache.invalidate_all)
    sigcache.DEFAULT.set_enabled(False)
    t["engine_cache_off_ms"] = time_host(engine, 5)
    sigcache.DEFAULT.set_enabled(True)
    print(f"sidecar codec, {n} lanes ({len(frame)} B frame), medians of 5 run alone: port client "
          f"encode {t['encode_ms']:.3f} ms (generic encode {t['generic_encode_ms']:.3f}), "
          f"generic decode {t['generic_decode_ms']:.3f}, columnar decode "
          f"{t['columnar_decode_ms']:.3f}; the daemon's engine (in-process flush of the raw "
          f"lanes) cold {t['engine_cold_ms']:.3f}, cache off {t['engine_cache_off_ms']:.3f} "
          f"[{card}]")
    return t


def ed_set(ed_signed):
    """The ed25519 vote set: (pks, msgs, sigs with every 997th corrupted,
    the expected mask)."""
    pks = [pk for pk, _, _ in ed_signed]
    msgs = [m for _, m, _ in ed_signed]
    sigs = [corrupt(sg) if i % BAD_EVERY == 0 else sg
            for i, (_, _, sg) in enumerate(ed_signed)]
    expect = np.ones(len(sigs), dtype=bool)
    expect[::BAD_EVERY] = False
    return pks, msgs, sigs, expect


def mixed_set(n, ed_signed, sr_signed, k1_signed):
    """The mixed-curve set: ed25519, sr25519 (every 20th from the 7th) and
    secp256k1 (every 20th from the 13th) keys interleaved, five corrupted
    signatures a curve. Returns (keys, msgs, sigs, {curve: lane indices},
    the corrupted lanes, the expected mask)."""
    pools = {crypto_batch.ED25519: iter(ed_signed),
             crypto_batch.SR25519: iter(sr_signed),
             crypto_batch.SECP256K1: iter(k1_signed)}
    key_cls = {crypto_batch.ED25519: PubKeyEd25519, crypto_batch.SR25519: PubKeySr25519,
               crypto_batch.SECP256K1: PubKeySecp256k1}
    curve_of, m_keys, m_msgs, m_sigs = [], [], [], []
    for i in range(n):
        kind = (crypto_batch.SR25519 if i % 20 == 7 else
                crypto_batch.SECP256K1 if i % 20 == 13 else crypto_batch.ED25519)
        pk, msg, sig = next(pools[kind])
        curve_of.append(kind)
        m_keys.append(key_cls[kind](pk))
        m_msgs.append(msg)
        m_sigs.append(sig)
    lanes_of = {kind: [i for i in range(n) if curve_of[i] == kind] for kind in CURVE_ORDER}
    m_bad = set()
    for idxs in lanes_of.values():
        for i in idxs[::max(1, len(idxs) // BAD_PER_CURVE)][:BAD_PER_CURVE]:
            m_bad.add(i)
            m_sigs[i] = corrupt(m_sigs[i])
    m_bad = sorted(m_bad)
    m_expect = np.ones(n, dtype=bool)
    m_expect[m_bad] = False
    return m_keys, m_msgs, m_sigs, lanes_of, m_bad, m_expect


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    n = MAX_VOTES_COUNT
    n_ed_mixed = n - N_SR - N_K1

    # 1. device
    card = smi_line()
    check(bool(card) and not card.startswith("nvidia-smi unavailable"),
          f"nvidia-smi reads the card ({card!r})")
    dev_info = device_mod.describe()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {dev_info['kind']} x{dev_info['count']}")

    # 2. build every kernel from the checkout's sources, one nvcc each, at once
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'cached'})")
    t0 = time.perf_counter()
    print(f"host prep library: {native.build()} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        # every kernel runs quads of four threads a signature with dynamic
        # shared memory, which ptxas does not see; each library reports its
        # own size (csrc/verify_quad.cuh)
        smem = getattr(build.load(name), f"{name}_smem_bytes")()
        print(f"ptxas {name}: {ptxas_summary(log)}; dynamic shared {smem} B a block")

    # 3. sign every key's vote: 10,000 ed25519, 500 sr25519, 500 secp256k1
    t0 = time.perf_counter()
    tasks = ([(crypto_batch.ED25519, i) for i in range(n)]
             + [(crypto_batch.SR25519, i) for i in range(N_SR)]
             + [(crypto_batch.SECP256K1, i) for i in range(N_K1)])
    light_tasks = [(v, h) for h in range(1, LIGHT_HEIGHTS + LIGHT_HOPS + 1)
                   for v in range(LIGHT_VALS)]
    signed, light = sign_all((sign_vote, tasks), (sign_light, light_tasks))
    ed_signed, sr_signed, k1_signed = (signed[:n], signed[n:n + N_SR],
                                       signed[n + N_SR:])
    print(f"signed {n} ed25519, {N_SR} sr25519 and {N_K1} secp256k1 votes and "
          f"{len(light)} light-chain precommits in {time.perf_counter() - t0:.1f} s")

    # 4. the ed25519 path, counted
    pks, msgs, sigs, expect = ed_set(ed_signed)
    bad = list(range(0, n, BAD_EVERY))
    print(f"ed25519 vote set: {n} validators, {len(bad)} corrupted")
    keys = [PubKeyEd25519(pk) for pk in pks]

    sigcache.invalidate_all()
    bv = crypto_batch.new_batch_verifier()
    for key, msg, sig in zip(keys, msgs, sigs):
        bv.add(key, msg, sig, POWER)
    reset_launches()
    all_ok, mask, tally = bv.verify_tally()
    ed_launches = launches()
    check([i for i, ok in enumerate(mask) if not ok] == bad,
          "false lanes are exactly the corrupted ones")
    check(not all_ok, "verify_tally reports the corrupted lanes")
    check(tally == POWER * (n - len(bad)), f"tally {tally} == 3 x good lanes")
    check(np.array_equal(bv.bit_words, words_of(expect)), "bitarray words")
    check(ed_launches["ed25519_verify"] > 0, "the ed25519 path launched its kernel")
    print(f"ed25519 path: verify_tally over {n} votes, tally {tally}, "
          f"{len(bad)} rejected, launches {ed_launches}")
    cold = (mask, tally, bv.bit_words.copy())
    e2e_ms = time_host(lambda: tally_and_words(bv), 5, before=sigcache.invalidate_all)
    sigcache.DEFAULT.set_enabled(False)
    e2e_off_ms = time_host(lambda: tally_and_words(bv), 5)
    sigcache.DEFAULT.set_enabled(True)
    print(f"end to end verify_tally, cold: {e2e_ms:.3f} ms median of 5 = "
          f"{n / e2e_ms * 1e3:.0f} sig/s; cache off {e2e_off_ms:.3f} ms [{card}]")

    # 4b. the phases of one cold flush
    phase_split(keys, msgs, sigs, torch.device("cuda"))  # warm-up
    phases = phase_split(keys, msgs, sigs, torch.device("cuda"))
    py_keys_ms = time_host(lambda: [sigcache.cache_key(k.type_value(), k.bytes(), m, s)
                                    for k, m, s in zip(keys, msgs, sigs)], 5)
    print("phases of one cold ed25519 verify_tally (ms): "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in phases.items())
          + f"; sum {sum(phases.values()):.3f}; the keys in Python (sigcache.cache_key) "
          f"{py_keys_ms:.3f} median of 5 [{card}]")
    cols = [lanes.ByteColumn.join(c) for c in (pks, msgs, sigs)]
    c_ms = {nt: (time_host(lambda: native.prep_ed25519(*cols, nthreads=nt), 5),
                 time_host(lambda: native.cache_keys(crypto_batch.ED25519, *cols,
                                                     nthreads=nt), 5))
            for nt in (1, native._threads(None))}
    sha_ni = native.sha256_ni()
    native.sha256_ni(False)
    portable_ms = {nt: time_host(lambda: native.cache_keys(crypto_batch.ED25519, *cols,
                                                           nthreads=nt), 5)
                   for nt in c_ms}
    native.sha256_ni(sha_ni)
    print("C entries alone, medians of 5 (ms): " + "; ".join(
        f"{nt} thread(s): prep_ed25519 {a:.3f}, cache_keys {b:.3f} "
        f"(portable SHA-256 {portable_ms[nt]:.3f})" for nt, (a, b) in c_ms.items())
        + f"; SHA extensions {'in use' if sha_ni else 'absent'} ({os.cpu_count()} CPUs, "
        f"{cpu_model()}) [{card}]")

    # 4c. path 2: one height verified once
    once = verify_once(keys, msgs, sigs, expect, cold, card)

    # 4d. the tally past 2^63 on the card
    big = tally_past_2_63(keys[1], msgs[1], sigs[1])
    print("tally past 2^63 on the card, exact: " + ", ".join(f"{k}: {v}" for k, v in big.items()))

    # 5. the ed25519 kernel against plain on the card, and its times
    ed_entry = check_kernel(CURVES[crypto_batch.ED25519], pks, msgs, sigs, expect,
                            corpus.adversarial(), n, card)
    ed_entry["launches"] = ed_launches["ed25519_verify"]
    ed_entry["e2e_ms"] = e2e_ms
    ed_entry["e2e_ms_cache_off"] = e2e_off_ms
    ed_entry.update(once)
    ed_entry["phases_ms"] = phases
    prep_ms = time_host(lambda: tv.prepare_batch_packed(pks, msgs, sigs), 5)
    plain_prep_ms = time_host(lambda: tv.prepare_batch_packed_plain(pks, msgs, sigs), 5)
    c_prep, py_prep = (tv.prepare_batch_packed(pks, msgs, sigs),
                       tv.prepare_batch_packed_plain(pks, msgs, sigs))
    check(np.array_equal(c_prep[0], py_prep[0]) and np.array_equal(c_prep[1], py_prep[1]),
          f"ed25519 C prep == Python prep on {n} lanes")
    # medians of separate loops: their difference is no measurement of the rest
    print(f"within verify_tally ({e2e_ms:.3f} ms): host prep in C {prep_ms:.3f} ms, "
          f"in Python {plain_prep_ms:.3f} ms (equal bytes on {n} lanes), medians of 5 "
          f"run alone; kernel {ed_entry['ms']:.3f} ms [{card}]")

    # 7. the mixed-curve set: 9,000 ed25519 (the first 9,000 keys above),
    # 500 sr25519 and 500 secp256k1, interleaved in the add order
    m_keys, m_msgs, m_sigs, lanes_of, m_bad, m_expect = mixed_set(
        n, ed_signed[:n_ed_mixed], sr_signed, k1_signed)
    counts = {kind: len(idx) for kind, idx in lanes_of.items()}

    def args_of(kind):
        idx = lanes_of[kind]
        return ([m_keys[i].bytes() for i in idx], [m_msgs[i] for i in idx],
                [m_sigs[i] for i in idx])
    print(f"mixed-curve vote set: {counts}, {len(m_bad)} corrupted")

    # 8. the mixed path, counted
    sigcache.invalidate_all()
    reset_launches()
    t0 = time.perf_counter()
    mv = crypto_batch.new_batch_verifier()
    for key, msg, sig in zip(m_keys, m_msgs, m_sigs):
        mv.add(key, msg, sig, POWER)
    all_ok, mask, tally = mv.verify_tally()
    first_mixed_ms = (time.perf_counter() - t0) * 1e3
    mixed_launches = launches()
    check([i for i, ok in enumerate(mask) if not ok] == m_bad,
          "mixed: false lanes are exactly the corrupted ones")
    check(not all_ok, "mixed: verify_tally reports the corrupted lanes")
    check(tally == POWER * (n - len(m_bad)), f"mixed: tally {tally} == 3 x 9,985")
    check(np.array_equal(mv.bit_words, words_of(m_expect)), "mixed: bitarray words")
    check(all(v == 1 for v in mixed_launches.values()),
          f"mixed: each kernel launched exactly once ({mixed_launches})")
    print(f"mixed path: verify_tally over {n} votes, tally {tally}, "
          f"{len(m_bad)} rejected, launches {mixed_launches} "
          f"(first call, adds included, {first_mixed_ms:.1f} ms)")
    mixed_ms = time_host(lambda: tally_and_words(mv), 3, before=sigcache.invalidate_all)
    sigcache.DEFAULT.set_enabled(False)
    mixed_off_ms = time_host(lambda: tally_and_words(mv), 3)
    sigcache.DEFAULT.set_enabled(True)
    print(f"end to end mixed verify_tally, cold: {mixed_ms:.3f} ms median of 3; "
          f"cache off {mixed_off_ms:.3f} ms [{card}]")

    # 9. the new kernels against plain at full width, and their times
    entries = [ed_entry]
    for kind in (crypto_batch.SR25519, crypto_batch.SECP256K1):
        adversarial = (corpus.sr_adversarial() if kind == crypto_batch.SR25519
                       else tuple(a + e for a, e in zip(corpus.k1_adversarial(),
                                                        corpus.k1_edges())))
        entry = check_kernel(CURVES[kind], *args_of(kind), m_expect[lanes_of[kind]],
                             adversarial, n, card)
        entry["launches"] = mixed_launches[entry["name"]]
        entries.append(entry)

    # 10. where the mixed path's time goes: host prep per curve (run alone)
    # and each kernel at the width the path gives it
    parts = {}
    for kind in CURVE_ORDER:
        args = args_of(kind)
        parts[kind] = time_host(lambda: CURVES[kind].prep(*args), 3)
    for kind, plain in ((crypto_batch.SR25519, sv.prepare_sr_batch_packed_plain),
                        (crypto_batch.SECP256K1, kv.prepare_k1_batch_packed_plain)):
        kind_args = args_of(kind)
        plain_ms = time_host(lambda: plain(*kind_args), 3)
        c_prep, py_prep = CURVES[kind].prep(*kind_args), plain(*kind_args)
        check(np.array_equal(c_prep[0], py_prep[0]) and np.array_equal(c_prep[1], py_prep[1]),
              f"{kind} C prep == Python prep on {counts[kind]} lanes")
        print(f"{kind} host prep: C {parts[kind]:.3f} ms, Python {plain_ms:.3f} ms "
              f"(equal bytes on {counts[kind]} lanes), medians of 3 [{card}]")
    # the ed25519 kernel against plain at the mixed path's width
    ed_np, ed_ok = tv.prepare_batch_packed(*args_of(crypto_batch.ED25519))
    ed_path_packed = torch.from_numpy(ed_np).cuda()
    ed_k, _, ed_mismatch, ed_err = hold(CURVES[crypto_batch.ED25519], ed_path_packed,
                                        f"the mixed path's {counts['ed25519']} lanes")
    check(np.array_equal(ed_k.cpu().numpy() & ed_ok,
                         m_expect[lanes_of[crypto_batch.ED25519]]),
          "ed25519_verify mask at the mixed path's width")
    entries[0]["mismatches"] += ed_mismatch
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], ed_err)
    print(f"ed25519_verify == plain: the mixed path's {counts['ed25519']} lanes, "
          f"0 mismatches")
    ed_path_ms = statistics.median(time_cuda(lambda: kernel.verify_packed(ed_path_packed), 20))
    print(f"within mixed verify_tally ({mixed_ms:.3f} ms), each run alone, median of 3: "
          f"host prep ed25519 {parts[crypto_batch.ED25519]:.3f} ms ({counts['ed25519']} lanes), "
          f"sr25519 {parts[crypto_batch.SR25519]:.3f} ms ({counts['sr25519']}), "
          f"secp256k1 {parts[crypto_batch.SECP256K1]:.3f} ms ({counts['secp256k1']}); "
          f"kernels (median of 20) ed25519 {ed_path_ms:.4f} ms, "
          f"sr25519 {entries[1]['path_ms']:.4f} ms, k1 {entries[2]['path_ms']:.4f} ms [{card}]")
    entries[0]["path_ms"] = ed_path_ms
    entries[0]["path_lanes"] = counts["ed25519"]
    entries[0]["mixed_launches"] = mixed_launches["ed25519_verify"]
    for entry in entries:
        entry["mixed_e2e_ms"] = mixed_ms
        entry["mixed_e2e_ms_cache_off"] = mixed_off_ms

    # 10b. the device path's spans, read from the real flush
    obs = observability_phase(keys, msgs, sigs, expect, m_keys, m_msgs, m_sigs, m_expect,
                              entries[0]["ms"], card)
    entries[0]["observability"] = obs
    for entry, name in zip(entries, ("ed25519_verify", "sr25519_verify", "k1_verify")):
        entry["obs_launches"] = (obs["launches"][name] + obs["mixed_launches"][name]
                                 + obs["cost_launches"][name])

    # 10c. the sharded steps across a mesh
    mixed = {kind: args_of(kind) + (m_expect[lanes_of[kind]],) for kind in CURVE_ORDER}
    mesh = mesh_phase(pks, msgs, sigs, expect, mixed, card)
    for entry, key in zip(entries, ("launches", "sr25519_launches", "secp256k1_launches")):
        entry["mesh_launches"] = mesh[key]
    entries[0]["mesh"] = mesh

    # 11. the sidecar daemon: codec and engine alone, then phases (a)-(c)
    sigcache.invalidate_all()
    sidecar = codec_and_engine(pks, msgs, sigs, expect, card)
    sidecar.update(sidecar_phase(pks, msgs, sigs, expect, mixed, card))
    sidecar.update(sidecar_config_and_health(pks, msgs, sigs, expect, card))
    sidecar.update(light_phase(light, card))
    print(f"sidecar round trip {sidecar['rtt_ms']:.3f} ms against the in-process flush of the "
          f"same run: cold {e2e_ms:.3f} ms, cache off {e2e_off_ms:.3f} ms; the engine alone "
          f"cold {sidecar['engine_cold_ms']:.3f}, cache off "
          f"{sidecar['engine_cache_off_ms']:.3f} [{card}]")
    entries[0]["sidecar"] = sidecar
    entries[0]["tally_past_2_63"] = big

    # 12. kernels line, card and result
    print(json.dumps({"kernels": entries}))
    print(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
