"""The 10,000-vote ed25519 pipeline stage by stage on the CUDA card: the
twin of tools/tpu_breakdown.py and tools/tpu_breakdown2.py, for what
chip_smoke.py's phase split does not give.

The votes are bench_torch.py's (``make_votes``: 10,000 distinct validators,
one signed precommit each), every 997th signature corrupted (``--bad-every``),
power 1000 each. Stages, each timed alone:

- ``prep_ms``: the C host prep (``verify.prepare_batch_packed``), x3;
- ``copy``: the host-to-device copy of the packed [128, B] uint8 plane from
  pageable and from pinned memory, 1x and 4x wide (MB and the median ms of
  3 each; the pinning itself is not timed);
- ``dispatch_ms``: one dispatch of an empty launch, a one-element torch
  add and a synchronize (``jax.jit(lambda x: x + 1)`` in the reference),
  median of 20: the latency of reaching the card, not a kernel;
- ``step_ms``: the fused step on a staged plane
  (``sharding.verify_tally_step_kernel``: the kernel and the limb tally),
  and ``kernel_ms``: the kernel alone (``kernel.verify_packed``), x5 each
  after a warm-up, CUDA events;
- ``queue``: K = 4 and 8 fresh copies (from pinned memory, non-blocking)
  and steps enqueued, then one synchronize: ms a batch and sig/s.

The step's mask must equal the port's serial verifier on every lane and
its tally must be the exact power of the valid lanes, or the tool raises;
the line carries the lanes the step rejected (``rejected_lanes``), so a
caller can hold them against a verifier of its own. One JSON line, with
the card's name and power limit. ``--device cpu`` (the tests) runs the
plain versions at ``--lanes``, once a stage and a queue of one, with no
pinned copy and no CUDA events. The tool imports ``tmtpu_torch``,
``torch`` and numpy, never ``tmtpu`` or ``jax``.

    python3 tools/gpu_breakdown.py
    python3 tools/gpu_breakdown.py --device cpu --lanes 64 --bad-every 7
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import card_line, make_votes  # noqa: E402
from tmtpu_torch import device as device_mod  # noqa: E402
from tmtpu_torch import native  # noqa: E402
from tmtpu_torch.gpu import kernel, sharding  # noqa: E402
from tmtpu_torch.gpu import verify as tv  # noqa: E402
from tools.gpu_port_common import check, serial_mask, time_cuda  # noqa: E402

LANES = 10_000
POWER = 1000
BAD_EVERY = 997
QUEUE_DEPTHS = (4, 8)


def host_ms(fn, runs: int, sync) -> list:
    """Host-clock ms of ``runs`` calls, each ended by ``sync()``."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--bad-every", type=int, default=BAD_EVERY,
                    help="corrupt the signature of every lane whose index is a multiple")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default: the CUDA card")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    on_card = dev.type == "cuda"
    n = args.lanes

    def sync():
        if on_card:
            torch.cuda.synchronize()

    native.build()  # set-up, as signing is
    t0 = time.perf_counter()
    pks, msgs, sigs = make_votes(n)
    sigs = [bytes([s[0] ^ 0xFF]) + s[1:] if i % args.bad_every == 0 else s
            for i, s in enumerate(sigs)]
    gen_s = time.perf_counter() - t0
    want = serial_mask(["ed25519"] * n, pks, msgs, sigs)
    check(want.sum() == n - len(range(0, n, args.bad_every)), "the serial verifier's verdicts")
    out = {"metric": "gpu_breakdown", "lanes": n, "gen_s": gen_s,
           "rejected": int((~want).sum())}

    runs = 3 if on_card else 1
    prep_times = host_ms(lambda: tv.prepare_batch_packed(pks, msgs, sigs), runs, lambda: None)
    packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
    out["prep_ms"] = prep_times

    wide = np.ascontiguousarray(np.tile(packed, (1, 4)))
    out["copy"] = {}
    for width, plane in (("1x", packed), ("4x", wide)):
        src = torch.from_numpy(plane)
        sources = {"pageable": src}
        if on_card:
            sources["pinned"] = src.pin_memory()
        for kind, host in sources.items():
            ms = host_ms(lambda: host.to(dev, non_blocking=kind == "pinned"), runs, sync)
            out["copy"][f"{kind}_{width}"] = {"mb": plane.nbytes / 1e6,
                                              "ms": statistics.median(ms), "ms_all": ms}

    x = torch.zeros(1, dtype=torch.int32, device=dev)
    _ = x + 1  # the first op on the device sets up its context
    sync()
    dispatch = host_ms(lambda: x + 1, 20 if on_card else 3, sync)
    out["dispatch_ms"] = statistics.median(dispatch)
    out["dispatch_ms_all"] = dispatch

    staged, powers, ok = sharding.upload(packed, [POWER] * n, host_ok, dev)
    mask, sums = sharding.verify_tally_step_kernel(staged, powers, ok)
    mask_np, tally = sharding.readback(mask, sums)
    check(np.array_equal(mask_np, want), "the step's mask equals the serial verifier's")
    check(tally == POWER * int(want.sum()), f"the step's tally {tally}")
    out.update(mask_ok=True, tally=tally, rejected_lanes=np.flatnonzero(~mask_np).tolist())
    if on_card:
        step = time_cuda(lambda: sharding.verify_tally_step_kernel(staged, powers, ok), 5)
        kern = time_cuda(lambda: kernel.verify_packed(staged), 5)
    else:
        # the plain version is seconds a call: one of each
        step = host_ms(lambda: sharding.verify_tally_step_kernel(staged, powers, ok), 1, sync)
        kern = host_ms(lambda: kernel.verify_packed(staged), 1, sync)
    out.update(step_ms=step, kernel_ms=kern)

    out["queue"] = {}
    src = torch.from_numpy(packed)
    if on_card:
        src = src.pin_memory()
    for k in QUEUE_DEPTHS if on_card else (1,):
        sync()
        t0 = time.perf_counter()
        outs = [sharding.verify_tally_step_kernel(src.to(dev, non_blocking=True), powers, ok)
                for _ in range(k)]
        sync()
        per = (time.perf_counter() - t0) / k
        check(all(sharding.readback(*o)[1] == tally for o in outs), f"queue of {k}: tallies")
        out["queue"][str(k)] = {"ms_per_batch": per * 1e3, "sig_s": n / per}
    out.update(backend="gpu" if on_card else "cpu", device=device_mod.describe(dev),
               card=card_line(dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
