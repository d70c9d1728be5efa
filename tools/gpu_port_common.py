"""What the port-side ``tools/gpu_*.py`` and ``chip_smoke.py`` share: checks,
the kernels' launch counters, timing on the card and on the host, and the
port's serial verifiers over many lanes.

Port-side tools import ``tmtpu_torch``, ``torch`` and numpy, and never
``tmtpu`` or ``jax``.
"""

from __future__ import annotations

import multiprocessing
import os
import statistics
import time

import numpy as np
import torch

from tmtpu_torch.crypto.ed25519 import PubKeyEd25519
from tmtpu_torch.crypto.secp256k1 import PubKeySecp256k1
from tmtpu_torch.crypto.sr25519 import PubKeySr25519
from tmtpu_torch.gpu import k1_kernel, kernel

PUB_KEYS = {"ed25519": PubKeyEd25519, "sr25519": PubKeySr25519,
            "secp256k1": PubKeySecp256k1}
POOL_FROM = 256  # lanes below this are checked in process


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    kernel.LAUNCHES = kernel.SR_LAUNCHES = k1_kernel.LAUNCHES = 0


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


def time_host(fn, runs: int, before=None) -> float:
    """Median host-clock time (ms) of ``runs`` calls, each after an untimed
    call of ``before`` (e.g. emptying the signature cache)."""
    times = []
    for _ in range(runs):
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _serial_one(task) -> bool:
    """(curve, pk, msg, sig) -> the port's serial verdict (pool worker)."""
    curve, pk, msg, sig = task
    return PUB_KEYS[curve](pk).verify_signature(msg, sig)


def serial_mask(curves, pks, msgs, sigs) -> np.ndarray:
    """Every lane through the port's serial verifier (``curves``: one curve
    name a lane), on a process a CPU from ``POOL_FROM`` lanes."""
    tasks = list(zip(curves, pks, msgs, sigs))
    if len(tasks) < POOL_FROM:
        return np.array([_serial_one(t) for t in tasks], dtype=bool)
    procs = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        return np.array(pool.map(_serial_one, tasks, chunksize=32), dtype=bool)
