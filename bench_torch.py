#!/usr/bin/env python3
"""The device half of bench.py for the PyTorch/CUDA port (tmtpu_torch).

Default run: the 10,000-vote ed25519 set (distinct validators, one signed
precommit each, real canonical sign bytes) in 4 rotations, through the
fused verify + tally step (``sharding.verify_tally_step_kernel``: the CUDA
kernel, the limb tally on the card) under bench.py's pipeline structures:
``sync`` (prep, copy, step, wait, one after another), ``ahead`` (the next
batch's prep and launch before waiting on the last), ``threads2`` /
``threads3`` (2 or 3 threads each running ``sync``) and the same with 4
vote sets fused into one 40,000-lane launch (``sync4``, ``ahead4``,
``threads2_4x``). Prints one JSON line with bench.py's keys: the best
structure's rate as ``value`` (sig/s), ``vs_baseline`` against the Go
serial verifier (bench.py's 18,182 sig/s), ``device_only_sig_s`` (the step
on a staged plane), ``structures``, ``phases`` and ``e2e_ms_per_10k``
(one set through ``sync``).

``--flood``: 100,000 votes verified and tallied across a mesh through the
sharded step (host prep, then ``sharding.sharded_verify_tally``, one
readback), against the single-device 10,000 (``sharding.batch_verify_tally``),
as one ``multichip_flood_verify_tally`` line; ``single_device_full`` is the
same votes in one single-device flush, so ``split_speedup`` says whether
the split beat one card at that width. On the card each time is a median
of 3, the mesh and the single-device flushes in turns. ``--shards N`` spreads N shards
over the visible cards (N shards of the one card on a one-card machine,
which measures the split's own cost); the default is one shard a card.

    python3 bench_torch.py            # on the card
    python3 bench_torch.py --flood --shards 4
    python3 bench_torch.py --device cpu --lanes 64   # the plain versions

``--device cpu`` runs the plain PyTorch versions and only ``sync``; it is
never chosen by itself: without a card the default run raises.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import torch

GO_SERIAL_SIG_S = 1e6 / 55.0  # 55 us a signature, Go stdlib (bench.py, BASELINE.md)
LANES = 10_000  # MaxVotesCount (types/vote_set.go:18)
FLOOD_LANES = 100_000
FLOOD_RUNS = 3
POWER = 1000
CHAIN_ID = "bench-chain"
BLOCK_ID = (bytes(range(32)), 1, bytes(32))
BASE_NS = 1_700_000_000 * 10**9


def _sign(task):
    """(seed, sign bytes) -> (public key, signature) (pool worker)."""
    from tmtpu_torch.crypto.ed25519 import PrivKeyEd25519

    seed, msg = task
    priv = PrivKeyEd25519(seed)
    return priv.pub_key().bytes(), priv.sign(msg)


def make_votes(n: int):
    """n distinct validators, one signed precommit each (bench.py's
    ``_make_votes``: seeds from numpy seed 7, height 12345, timestamps
    one nanosecond apart). Signs on a process a CPU."""
    from tmtpu_torch.types.vote import PRECOMMIT, vote_sign_bytes

    seeds = np.random.default_rng(7).integers(0, 256, (n, 32), dtype=np.uint8)
    msgs = [vote_sign_bytes(CHAIN_ID, PRECOMMIT, 12345, 0, BLOCK_ID, BASE_NS + i)
            for i in range(n)]
    tasks = [(seeds[i].tobytes(), msgs[i]) for i in range(n)]
    procs = os.cpu_count() or 1
    if n < 1000 or procs == 1:
        signed = [_sign(t) for t in tasks]
    else:
        with multiprocessing.get_context("spawn").Pool(procs) as pool:
            signed = pool.map(_sign, tasks, chunksize=64)
    return [pk for pk, _ in signed], msgs, [sig for _, sig in signed]


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _ready(dev) -> None:
    """Wait for the work this thread queued on the device."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def run_pipeline(dev, lanes: int) -> dict:
    from tmtpu_torch import device as device_mod
    from tmtpu_torch import native
    from tmtpu_torch.gpu import sharding
    from tmtpu_torch.gpu import verify as tv

    native.build()  # set-up, as signing is: no phase pays for the C build
    t0 = time.perf_counter()
    base = make_votes(lanes)
    # 4 rotations of the same votes: distinct bytes per batch for ~free
    sets = [base] + [tuple(x[k:] + x[:k] for x in base) for k in (1, 2, 3)]
    print(f"bench: generated {lanes} votes in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    powers = {k: torch.from_numpy(sharding.power_limbs([POWER] * (lanes * k))).to(dev)
              for k in (1, 4)}
    oks = {k: torch.ones(lanes * k, dtype=torch.bool, device=dev) for k in (1, 4)}

    def prep(i: int, k: int = 1) -> np.ndarray:
        """Host prep of k rotated vote sets into one packed plane."""
        planes = []
        for j in range(k):
            packed, host_ok = tv.prepare_batch_packed(*sets[(i + j) % 4])
            if not host_ok.all():
                raise RuntimeError("bench lanes failed the host checks")
            planes.append(packed)
        return planes[0] if k == 1 else np.concatenate(planes, axis=1)

    def step(plane, k: int):
        return sharding.verify_tally_step_kernel(plane, powers[k], oks[k])

    def check(out, k: int) -> None:
        mask, sums = out
        if not bool(mask.all()) or sharding.combine_limbs(sums.cpu().tolist()) != POWER * lanes * k:
            raise RuntimeError("bench lanes must verify and tally exactly")

    phases = {}
    t0 = time.perf_counter()
    host_plane = prep(0)
    phases["prepare"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_plane = torch.from_numpy(host_plane).to(dev)
    _ready(dev)
    phases["transfer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = step(dev_plane, 1)  # the first launch builds the kernel
    _ready(dev)
    warm_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    out[0].cpu()
    phases["readback"] = time.perf_counter() - t0
    check(out, 1)

    n_dev = 3
    t0 = time.perf_counter()
    for _ in range(n_dev):
        out = step(dev_plane, 1)
        _ready(dev)
    dev_dt = (time.perf_counter() - t0) / n_dev
    phases["execute"] = dev_dt
    phases["compile"] = max(0.0, warm_dt - dev_dt)

    def run_sync(n_iters, k):
        t0 = time.perf_counter()
        for i in range(n_iters):
            out = step(torch.from_numpy(prep(i, k)).to(dev), k)
            _ready(dev)
        check(out, k)
        return lanes * k * n_iters / (time.perf_counter() - t0)

    def run_ahead(n_iters, k):
        t0 = time.perf_counter()
        pending = None
        for i in range(n_iters):
            nxt = step(torch.from_numpy(prep(i, k)).to(dev), k)
            done = torch.cuda.Event()
            done.record()
            if pending is not None:
                pending[1].synchronize()
            pending = (nxt, done)
        pending[1].synchronize()
        check(pending[0], k)
        return lanes * k * n_iters / (time.perf_counter() - t0)

    def run_threads(n_iters_each, nthreads, k):
        results = queue.Queue()

        def work(tid):
            try:
                for i in range(n_iters_each):
                    out = step(torch.from_numpy(prep(tid + nthreads * i, k)).to(dev), k)
                    _ready(dev)
                results.put(out)
            except Exception as exc:  # noqa: BLE001 - raised on the main thread below
                results.put(exc)

        threads = [threading.Thread(target=work, args=(t,)) for t in range(nthreads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        outs = [results.get_nowait() for _ in threads]
        for out in outs:
            if isinstance(out, Exception):
                raise out
            check(out, k)
        return lanes * k * n_iters_each * nthreads / dt

    structures = {}

    def measure(name, fn, *a):
        structures[name] = fn(*a)
        print(f"bench: {name}: {structures[name]:,.0f} sig/s", file=sys.stderr)

    if dev.type == "cpu":
        measure("sync", run_sync, 2, 1)
    else:
        measure("sync", run_sync, 4, 1)
        measure("ahead", run_ahead, 4, 1)
        measure("threads2", run_threads, 2, 2, 1)
        measure("sync4", run_sync, 3, 4)
        measure("ahead4", run_ahead, 3, 4)
        measure("threads2_4x", run_threads, 2, 2, 4)
        measure("threads3", run_threads, 2, 3, 1)

    best = max(structures, key=structures.get)
    sig_s = structures[best]
    out = {
        "metric": "ed25519_batch_verify_10k_voteset_e2e",
        "value": round(sig_s, 1),
        "unit": "sig/s",
        "vs_baseline": round(sig_s / GO_SERIAL_SIG_S, 2),
        "backend": "gpu" if dev.type == "cuda" else "cpu",
        "device": device_mod.describe(dev),
        "card": card_line(dev),
        "device_only_sig_s": round(lanes / dev_dt, 1),
        "pipeline": best,
        "structures": {k: round(v, 1) for k, v in structures.items()},
        "lanes": lanes,
        "phases": {k: round(v, 4) for k, v in phases.items()},
    }
    if lanes == LANES:
        # the latency of one 10k vote set through sync, not the inverse of
        # the pipelined headline
        out["e2e_ms_per_10k"] = round(1e3 * LANES / structures["sync"], 2)
    return out


def run_flood(dev, lanes: int, shards: int) -> dict:
    from tmtpu_torch.gpu import sharding
    from tmtpu_torch.gpu import verify as tv

    if shards:
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh = tuple(torch.device(dev.type, i % count) if dev.type == "cuda" else dev
                     for i in range(shards))
    else:
        mesh = sharding.make_mesh(device=dev)
    ref_lanes = min(lanes, LANES)
    t0 = time.perf_counter()
    pks, msgs, sigs = make_votes(lanes)
    powers = [POWER] * lanes
    prep_dt = time.perf_counter() - t0
    print(f"bench: flood generated {lanes} votes in {prep_dt:.1f}s", file=sys.stderr)
    args = (pks, msgs, sigs, powers)
    ref_args = tuple(col[:ref_lanes] for col in args)
    step = sharding.sharded_verify_tally(mesh)

    def flood():
        packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
        mask, sums = step(packed, sharding.power_limbs(powers), host_ok)
        return mask.cpu().numpy(), sharding.combine_limbs(sums.cpu().tolist())

    runs = {
        "flood": flood,
        "ref": lambda: sharding.batch_verify_tally(*ref_args, device=dev),
        "full": lambda: sharding.batch_verify_tally(*args, device=dev),
    }
    want = {"flood": POWER * lanes, "ref": POWER * ref_lanes, "full": POWER * lanes}
    # the plain versions on the CPU (tests) take seconds a flush: one run
    n_runs = FLOOD_RUNS if dev.type == "cuda" else 1
    if dev.type == "cuda":
        for fn in runs.values():
            fn()  # builds the kernel and warms each width
    times = {name: [] for name in runs}
    for _ in range(n_runs):
        for name, fn in runs.items():
            t0 = time.perf_counter()
            mask, tallied = fn()
            times[name].append(time.perf_counter() - t0)
            if not mask.all() or tallied != want[name]:
                raise RuntimeError(f"the {name} lanes must verify and tally exactly")
    flood_dt, ref_dt, full_dt = (sorted(times[k])[n_runs // 2] for k in runs)
    sizes = [hi - lo for lo, hi in sharding.shard_bounds(lanes, len(mesh))]
    return {
        "metric": "multichip_flood_verify_tally",
        "value": round(lanes / flood_dt, 1),
        "unit": "sig/s",
        "lanes": lanes,
        "wall_s": round(flood_dt, 4),
        "n_devices": len(mesh),
        "distinct_devices": len(set(mesh)),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "card": card_line(dev),
        "shard_lanes": sizes + [0] * (len(mesh) - len(sizes)),
        "single_device_ref": {"lanes": ref_lanes, "wall_s": round(ref_dt, 4),
                              "sig_s": round(ref_lanes / ref_dt, 1)},
        "single_device_full": {"lanes": lanes, "wall_s": round(full_dt, 4),
                               "sig_s": round(lanes / full_dt, 1)},
        "split_speedup": round(full_dt / flood_dt, 3),
        # 100k across the mesh within the single-device 10k's wall time
        "meets_target": bool(lanes >= 10 * ref_lanes and flood_dt <= ref_dt),
        "phases": {"prepare": round(prep_dt, 4)},
        "vs_baseline": round((lanes / flood_dt) / GO_SERIAL_SIG_S, 2),
    }


def main(argv=None) -> int:
    from tmtpu_torch import device as device_mod

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cpu runs the plain versions; default: the CUDA card")
    parser.add_argument("--lanes", type=int, default=None,
                        help=f"votes in a set (default {LANES}; {FLOOD_LANES} with --flood)")
    parser.add_argument("--flood", action="store_true",
                        help="the 100,000-vote flood across the mesh")
    parser.add_argument("--shards", type=int, default=0,
                        help="with --flood: shards spread over the cards (0: one a card)")
    args = parser.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if args.flood:
        out = run_flood(dev, args.lanes or FLOOD_LANES, args.shards)
    else:
        out = run_pipeline(dev, args.lanes or LANES)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
