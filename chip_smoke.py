#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tmtpu_torch) on one CUDA card.

Drives the port's two main paths once each, as a validator would, through
``new_batch_verifier().add(...)`` and ``verify_tally()``:

1. a 10,000-validator ed25519 precommit vote set (power 3 each, real
   canonical vote sign bytes, every 997th signature corrupted): host prep,
   one host-to-device copy, the hand-written ed25519 CUDA kernel, the int64
   power tally and the bitarray pack on the card;
2. a 10,000-validator mixed-curve set (9,000 ed25519, 500 sr25519 and 500
   secp256k1 keys, interleaved, power 3 each, five corrupted signatures per
   curve): one device dispatch per curve, through the ed25519, sr25519 and
   secp256k1 CUDA kernels, and the whole bitarray packed on the card.

Each path runs with every launch counter set to 0 just before it and read
just after. Then each kernel is held against its plain PyTorch version on
the same planes at each width its paths give it, at 10,000 lanes and on an
adversarial block, samples are
checked against the pure-Python oracles, and the kernels, the plain
versions, host prep and both paths end to end are timed.

Usage: ``python3 chip_smoke.py``. Needs one CUDA card; exits non-zero
without one, and on any failed check. Prints a ``{"kernels": [...]}`` line,
the card's name and power limit, and, last, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from tests import torch_corpus as corpus
from tmtpu_torch import device as device_mod
from tmtpu_torch.crypto import batch as crypto_batch
from tmtpu_torch.crypto.ed25519 import PrivKeyEd25519, PubKeyEd25519
from tmtpu_torch.crypto.secp256k1 import PubKeySecp256k1
from tmtpu_torch.crypto.sr25519 import PrivKeySr25519, PubKeySr25519
from tmtpu_torch.gpu import build, k1_kernel, kernel
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv
from tmtpu_torch.types.vote import MAX_VOTES_COUNT, PRECOMMIT, vote_sign_bytes

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

N_SR, N_K1 = 500, 500
BAD_PER_CURVE = 5
CURVE_ORDER = (crypto_batch.ED25519, crypto_batch.SR25519, crypto_batch.SECP256K1)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def sign_all(tasks):
    procs = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        return pool.map(sign_vote, tasks, chunksize=32)


def corrupt(sig: bytes) -> bytes:
    return bytes([sig[0] ^ 0xFF]) + sig[1:]


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


def time_cuda(fn, runs: int) -> list:
    """Per-run device times (ms) from CUDA events."""
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def time_host(fn, runs: int) -> float:
    """Median host-clock time (ms) of ``runs`` calls."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def reset_launches() -> None:
    kernel.LAUNCHES = kernel.SR_LAUNCHES = k1_kernel.LAUNCHES = 0


def launches() -> dict:
    return {"ed25519_verify": kernel.LAUNCHES, "sr25519_verify": kernel.SR_LAUNCHES,
            "k1_verify": k1_kernel.LAUNCHES}


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
    print(f"{curve.name} == plain: {n} lanes, the path's {len(sigs)} and "
          f"{len(a_sigs)} adversarial lanes, 0 mismatches; "
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


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    n = MAX_VOTES_COUNT
    n_ed_mixed = n - N_SR - N_K1

    # 1. device
    card = smi_line()
    dev_info = device_mod.describe()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {dev_info['kind']} x{dev_info['count']}")

    # 2. build every kernel from the checkout's sources, one nvcc each, at once
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"  {name}: {line.strip()}")

    # 3. sign every key's vote: 10,000 ed25519, 500 sr25519, 500 secp256k1
    t0 = time.perf_counter()
    tasks = ([(crypto_batch.ED25519, i) for i in range(n)]
             + [(crypto_batch.SR25519, i) for i in range(N_SR)]
             + [(crypto_batch.SECP256K1, i) for i in range(N_K1)])
    signed = sign_all(tasks)
    ed_signed, sr_signed, k1_signed = (signed[:n], signed[n:n + N_SR],
                                       signed[n + N_SR:])
    print(f"signed {n} ed25519, {N_SR} sr25519 and {N_K1} secp256k1 votes in "
          f"{time.perf_counter() - t0:.1f} s")

    # 4. the ed25519 path, counted
    pks = [pk for pk, _, _ in ed_signed]
    msgs = [m for _, m, _ in ed_signed]
    sigs = [corrupt(sg) if i % BAD_EVERY == 0 else sg
            for i, (_, _, sg) in enumerate(ed_signed)]
    bad = list(range(0, n, BAD_EVERY))
    print(f"ed25519 vote set: {n} validators, {len(bad)} corrupted")
    keys = [PubKeyEd25519(pk) for pk in pks]

    reset_launches()
    bv = crypto_batch.new_batch_verifier()
    for key, msg, sig in zip(keys, msgs, sigs):
        bv.add(key, msg, sig, POWER)
    all_ok, mask, tally = bv.verify_tally()
    ed_launches = launches()
    expect = np.ones(n, dtype=bool)
    expect[bad] = False
    check([i for i, ok in enumerate(mask) if not ok] == bad,
          "false lanes are exactly the corrupted ones")
    check(not all_ok, "verify_tally reports the corrupted lanes")
    check(tally == POWER * (n - len(bad)), f"tally {tally} == 3 x good lanes")
    check(np.array_equal(bv.bit_words, words_of(expect)), "bitarray words")
    check(ed_launches["ed25519_verify"] > 0, "the ed25519 path launched its kernel")
    print(f"ed25519 path: verify_tally over {n} votes, tally {tally}, "
          f"{len(bad)} rejected, launches {ed_launches}")
    e2e_ms = time_host(bv.verify_tally, 5)
    print(f"end to end verify_tally: {e2e_ms:.3f} ms median of 5 = "
          f"{n / e2e_ms * 1e3:.0f} sig/s [{card}]")

    # 5. the ed25519 kernel against plain on the card, and its times
    ed_entry = check_kernel(CURVES[crypto_batch.ED25519], pks, msgs, sigs, expect,
                            corpus.adversarial(), n, card)
    ed_entry["launches"] = ed_launches["ed25519_verify"]
    ed_entry["e2e_ms"] = e2e_ms
    prep_ms = time_host(lambda: tv.prepare_batch_packed(pks, msgs, sigs), 5)
    # medians of separate loops: their difference is no measurement of the rest
    print(f"within verify_tally ({e2e_ms:.3f} ms): host prep {prep_ms:.3f} ms "
          f"median of 5 run alone, kernel {ed_entry['ms']:.3f} ms [{card}]")

    # 7. the mixed-curve set: 9,000 ed25519 (the first 9,000 keys above),
    # 500 sr25519 and 500 secp256k1, interleaved in the add order
    pools = {crypto_batch.ED25519: iter(ed_signed[:n_ed_mixed]),
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
    counts = {kind: len(idx) for kind, idx in lanes_of.items()}

    def args_of(kind):
        idx = lanes_of[kind]
        return ([m_keys[i].bytes() for i in idx], [m_msgs[i] for i in idx],
                [m_sigs[i] for i in idx])
    print(f"mixed-curve vote set: {counts}, {len(m_bad)} corrupted")

    # 8. the mixed path, counted
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
    mixed_ms = time_host(mv.verify_tally, 3)
    print(f"end to end mixed verify_tally: {mixed_ms:.3f} ms median of 3 [{card}]")

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
    for entry in entries[1:]:
        entry["mixed_e2e_ms"] = mixed_ms

    # 11. kernels line, card and result
    print(json.dumps({"kernels": entries}))
    print(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
