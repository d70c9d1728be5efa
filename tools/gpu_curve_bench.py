"""Per-curve batch verify on the CUDA card: the twin of tools/curve_bench.py
(the BASELINE "Curves" row), with what tools/k1_sweep.py measured besides
the block size.

Rows, each signed with the port's own keys (``tmtpu_torch/crypto/``):

- ``sr25519`` at ``--lanes-sr`` (512) through its batch entry,
  ``gpu/sr_verify.py::batch_verify_sr`` -> ``csrc/sr25519_verify.cu``;
- ``secp256k1`` at ``--lanes-k1`` (2,048; 4,096 gives k1_sweep.py's width)
  through ``gpu/k1_verify.py::batch_verify_k1`` -> ``csrc/k1_verify.cu``;
- ``mixed``: 3 x min of the two, round-robin ed25519 / sr25519 /
  secp256k1 (curve_bench.py:74-119), through
  ``crypto/batch.py::TorchBatchVerifier`` on an emptied signature cache,
  one dispatch a curve.

Each row reports end-to-end sig/s (host prep, copy, kernel, readback; the
median of 3 after a warm-up), the port's serial verifier over a 50-lane
sample and ``speedup_vs_serial``, the kernel alone on a staged plane (CUDA
events, median of 20), the plain PyTorch version's device ms on the same
plane (median of 2), host prep ms, and the launches of the timed runs.
The secp256k1 row adds ``host_prep_lanes_s`` (k1_sweep.py's host-prep
rate). The sr25519 row keeps curve_bench.py's ``fair_serial_baseline``:
the serial sr25519 here is pure Python, as it was there.

Every lane of every row goes through the port's serial verifier first, and
every mask the timings produce must equal that, so no timing rests on a
wrong answer (a mismatch raises). ``--corrupt N`` flips a bit in N
signatures a row, at lanes 1, 1 + lanes // N, ...; ``rejected`` lists the
lanes each row's masks reject. One JSON line a row, then the combined
object last, with the card's name and power limit.

``--device cpu`` runs the plain versions at a small size (the tests), once
each: no warm-up, no CUDA events, no plain column. The tool imports
``tmtpu_torch``, ``torch`` and numpy, never ``tmtpu`` or ``jax``.

    python3 tools/gpu_curve_bench.py [--lanes-sr 512] [--lanes-k1 2048]
    python3 tools/gpu_curve_bench.py --device cpu --lanes-sr 8 --lanes-k1 8 --corrupt 1
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import card_line  # noqa: E402
from tmtpu_torch import device as device_mod  # noqa: E402
from tmtpu_torch.crypto import batch as crypto_batch  # noqa: E402
from tmtpu_torch.crypto import sigcache  # noqa: E402
from tmtpu_torch.crypto.ed25519 import PrivKeyEd25519  # noqa: E402
from tmtpu_torch.crypto.secp256k1 import N as K1_N  # noqa: E402
from tmtpu_torch.crypto.secp256k1 import PrivKeySecp256k1  # noqa: E402
from tmtpu_torch.crypto.sr25519 import PrivKeySr25519  # noqa: E402
from tmtpu_torch.gpu import k1_kernel, kernel  # noqa: E402
from tmtpu_torch.gpu import k1_verify as kv  # noqa: E402
from tmtpu_torch.gpu import sr_verify as sv  # noqa: E402
from tmtpu_torch.gpu import verify as tv  # noqa: E402
from tmtpu_torch.sidecar.server import launch_counts  # noqa: E402
from tools.gpu_port_common import (PUB_KEYS, check, reset_launches,  # noqa: E402
                                   serial_mask, time_cuda, time_host)

SEED = 20261017
SERIAL_SAMPLE = 50
E2E_RUNS, KERNEL_RUNS, PLAIN_RUNS = 3, 20, 2
CURVES = ("ed25519", "sr25519", "secp256k1")
KERNEL_NAMES = {"ed25519": "ed25519_verify", "sr25519": "sr25519_verify",
                "secp256k1": "k1_verify"}
# each curve's host prep -> packed plane, kernel wrapper, plain version
PATHS = {
    "ed25519": (tv.prepare_batch_packed, kernel.verify_packed, tv.plain_packed),
    "sr25519": (sv.prepare_sr_batch_packed, kernel.sr_verify_packed, sv.plain_packed),
    "secp256k1": (kv.prepare_k1_batch_packed, k1_kernel.verify_packed, kv.plain_packed),
}
BATCH_ENTRIES = {"sr25519": sv.batch_verify_sr, "secp256k1": kv.batch_verify_k1}


def priv_key(curve: str, i: int):
    """Validator key i of ``curve``, from the seed."""
    d = hashlib.sha256(f"{SEED}:curve-bench:{curve}:{i}".encode()).digest()
    if curve == "ed25519":
        return PrivKeyEd25519(d)
    if curve == "sr25519":
        return PrivKeySr25519(d)
    return PrivKeySecp256k1((int.from_bytes(d, "big") % (K1_N - 1) + 1).to_bytes(32, "big"))


def sign_lane(task):
    """(curve, i, msg) -> (public key bytes, signature) (pool worker)."""
    curve, i, msg = task
    priv = priv_key(curve, i)
    return priv.pub_key().bytes(), priv.sign(msg)


def make_row(name: str, lanes: int, corrupt: int):
    """A row's lanes: (curves, pks, msgs, sigs), ``corrupt`` signatures
    with one bit flipped. ``mixed`` is round-robin over the three curves."""
    curves = [CURVES[i % 3] if name == "mixed" else name for i in range(lanes)]
    msgs = [b"curve-bench-%s-%d" % (name.encode(), i) for i in range(lanes)]
    tasks = list(zip(curves, range(lanes), msgs))
    if lanes < 64:
        signed = [sign_lane(t) for t in tasks]
    else:
        procs = min(8, os.cpu_count() or 1)
        with multiprocessing.get_context("spawn").Pool(procs) as pool:
            signed = pool.map(sign_lane, tasks, chunksize=16)
    pks = [pk for pk, _ in signed]
    sigs = [sig for _, sig in signed]
    for j in corrupted_lanes(lanes, corrupt):
        sigs[j] = sigs[j][:5] + bytes([sigs[j][5] ^ 0x01]) + sigs[j][6:]
    return curves, pks, msgs, sigs


def corrupted_lanes(lanes: int, corrupt: int) -> list:
    if not corrupt:
        return []
    return sorted({(1 + k * max(1, lanes // corrupt)) % lanes for k in range(corrupt)})


def kernel_alone(curve, pks, msgs, sigs, want, dev) -> dict:
    """One curve's kernel on a staged plane and its plain version on the
    same plane; both masks held against the serial verdicts."""
    prep, launch, plain = PATHS[curve]
    packed, host_ok = prep(pks, msgs, sigs)
    staged = torch.from_numpy(packed).to(dev)
    t0 = time.perf_counter()
    mask = launch(staged).cpu().numpy() & host_ok
    first_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(mask, want), f"{curve} kernel mask on the staged plane")
    if dev.type != "cuda":
        # the wrapper ran the plain version: its one call is the reading
        return {"kernel_ms": first_ms, "plain_ms": None}
    time_cuda(lambda: launch(staged), 3)
    k_times = time_cuda(lambda: launch(staged), KERNEL_RUNS)
    p_mask = plain(staged).cpu().numpy() & host_ok
    check(np.array_equal(p_mask, want), f"{curve} plain mask on the staged plane")
    return {"kernel_ms": statistics.median(k_times), "kernel_ms_min": min(k_times),
            "kernel_ms_max": max(k_times),
            "plain_ms": statistics.median(time_cuda(lambda: plain(staged), PLAIN_RUNS))}


def measure_row(name: str, lanes: int, corrupt: int, dev) -> dict:
    t0 = time.perf_counter()
    curves, pks, msgs, sigs = make_row(name, lanes, corrupt)
    gen_s = time.perf_counter() - t0
    want = serial_mask(curves, pks, msgs, sigs)
    sample = range(min(lanes, SERIAL_SAMPLE))
    t0 = time.perf_counter()
    for i in sample:
        PUB_KEYS[curves[i]](pks[i]).verify_signature(msgs[i], sigs[i])
    serial_rate = len(sample) / (time.perf_counter() - t0)
    print(f"gpu_curve_bench: {name}: {lanes} lanes signed in {gen_s:.1f} s, "
          f"{int((~want).sum())} rejected by the serial verifier", file=sys.stderr)

    if name == "mixed":
        keys = [PUB_KEYS[c](pk) for c, pk in zip(curves, pks)]

        def e2e():
            bv = crypto_batch.TorchBatchVerifier(dev)
            for key, msg, sig in zip(keys, msgs, sigs):
                bv.add(key, msg, sig)
            return np.array(bv.verify()[1], dtype=bool)
        before = sigcache.invalidate_all
    else:
        def e2e():
            return BATCH_ENTRIES[name](pks, msgs, sigs, device=dev)
        before = None
    on_card = dev.type == "cuda"
    if on_card:
        if before:
            before()
        check(np.array_equal(e2e(), want), f"{name} end-to-end mask (warm-up)")
    runs = E2E_RUNS if on_card else 1
    masks = []
    reset_launches()
    e2e_ms = time_host(lambda: masks.append(e2e()), runs, before=before)
    row_launches = launch_counts()
    check(all(np.array_equal(m, want) for m in masks), f"{name} end-to-end masks")
    rate = lanes / (e2e_ms / 1e3)
    row = {"metric": f"{name}_batch_verify_e2e", "value": rate, "unit": "sig/s",
           "lanes": lanes, "e2e_ms": e2e_ms, "e2e_runs": runs,
           "serial_cpu_sig_s": serial_rate, "speedup_vs_serial": rate / serial_rate,
           "launches": row_launches, "rejected": np.flatnonzero(~masks[-1]).tolist(),
           "backend": "gpu" if on_card else "cpu", "gen_s": gen_s}
    for curve in sorted(set(curves), key=CURVES.index):
        idx = [i for i, c in enumerate(curves) if c == curve]
        part = kernel_alone(curve, [pks[i] for i in idx], [msgs[i] for i in idx],
                            [sigs[i] for i in idx], want[idx], dev)
        prep = PATHS[curve][0]
        part["prep_ms"] = time_host(lambda: prep([pks[i] for i in idx], [msgs[i] for i in idx],
                                                 [sigs[i] for i in idx]), runs)
        part["lanes"] = len(idx)
        # a CPU plane runs the plain version, which launches nothing
        check(row_launches[KERNEL_NAMES[curve]] == (runs if on_card else 0),
              f"{name}: {KERNEL_NAMES[curve]} once a run ({row_launches})")
        if name == "mixed":
            row.setdefault("curves", {})[curve] = part
        else:
            row.update(part)
    if name == "secp256k1":
        row["host_prep_lanes_s"] = lanes / (row["prep_ms"] / 1e3)
    if name == "sr25519":
        # curve_bench.py:149-161: the serial sr25519 is pure Python; the
        # fair comparator is go-schnorrkel, not measurable here
        row["fair_serial_baseline"] = {
            "impl": "go-schnorrkel (reference crypto/sr25519)",
            "est_sig_s": [2000, 4000],
            "method": "estimate; no Go toolchain to measure it"}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes-sr", type=int, default=512)
    ap.add_argument("--lanes-k1", type=int, default=2048)
    ap.add_argument("--corrupt", type=int, default=0,
                    help="signatures a row with one bit flipped")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default: the CUDA card")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    card = card_line(dev)
    rows = {}
    for name, lanes in (("sr25519", args.lanes_sr), ("secp256k1", args.lanes_k1),
                        ("mixed", 3 * min(args.lanes_sr, args.lanes_k1))):
        rows[name] = measure_row(name, lanes, args.corrupt, dev)
        rows[name]["card"] = card
        print(json.dumps(rows[name]), flush=True)
    print(json.dumps({"metric": "gpu_curve_bench", "ok": True, "rows": rows,
                      "device": device_mod.describe(dev), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
