#!/usr/bin/env python3
"""Time the ed25519, sr25519 and secp256k1 verify kernels on one CUDA card:
this tree's kernels against another tree's (an earlier commit unpacked with
``git archive``), in turns on the same planes.

Usage::

    python3 kernel_times.py --parent DIR [--out PATH]

``DIR`` holds the other tree (its ``tmtpu_torch/gpu/csrc``); ``build.build_all``
builds its kernels with this tree's nvcc flags into
``tmtpu_torch/gpu/build/parent/``. This tree's kernels run through the
wrappers ``kernel.verify_packed`` / ``kernel.sr_verify_packed`` /
``k1_kernel.verify_packed``, the other tree's through the same
``kernel.launch`` with its library and the same fixed-base table. The
planes are signed votes (a few hundred distinct lanes per curve, tiled to
each width), at the widths the main paths give the kernels: ed25519 at
10,000 and 9,000 lanes, sr25519 and secp256k1 at 10,000 and 500. Each
time is the median of 20 CUDA-event readings after 3 warm-up launches,
taken in turns (parent, new, new, parent) at each width. Both trees'
verdicts must agree bit for bit at every width, at 1, 3, 5 and 33 lanes
and on the adversarial and edge blocks of ``tests/torch_corpus.py``.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys

import numpy as np
import torch

from chip_smoke import ptxas_summary, smi_line
from tests import torch_corpus as corpus
from tmtpu_torch.gpu import build, k1_kernel, kernel
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv

WRAPPERS = {"ed25519_verify": kernel.verify_packed, "sr25519_verify": kernel.sr_verify_packed,
            "k1_verify": k1_kernel.verify_packed}
# Each kernel's fixed-base table on a device, as its wrapper passes it.
TABLES = {"ed25519_verify": kernel._device_table, "sr25519_verify": kernel._device_table,
          "k1_verify": k1_kernel._device_table}
WIDTHS = {"ed25519_verify": (10_000, 9_000), "sr25519_verify": (10_000, 500),
          "k1_verify": (10_000, 500)}
RAGGED = (1, 3, 5, 33)
DISTINCT = 256
# Edge blocks on which both trees' verdicts (host-masked lanes included)
# must agree.
ADVERSARIAL = {
    "ed25519_verify": [(corpus.adversarial, tv.prepare_batch_packed),
                       (corpus.low_order, tv.prepare_batch_packed)],
    "sr25519_verify": [(corpus.sr_adversarial, sv.prepare_sr_batch_packed)],
    "k1_verify": [(corpus.k1_adversarial, kv.prepare_k1_batch_packed),
                  (corpus.k1_edges, kv.prepare_k1_batch_packed)],
}


def parent_runner(lib: ctypes.CDLL, name: str):
    """The other tree's kernel as a function plane -> bool verdicts, through
    the wrappers' own launch."""
    def run(packed: torch.Tensor) -> torch.Tensor:
        return kernel.launch(name, packed, TABLES[name](packed.device), lib) != 0
    return run


def median_ms(fn, packed, runs=20, warm=3) -> float:
    for _ in range(warm):
        fn(packed)
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(packed)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def planes() -> dict:
    """{kernel: [DISTINCT] lanes' packed plane} from signed votes, every
    lane valid."""
    pks, msgs, sigs = corpus.signed(DISTINCT, 91)
    ed, ok = tv.prepare_batch_packed(pks, msgs, sigs)
    assert ok.all()
    pks, msgs, sigs = corpus.sr_signed(DISTINCT, 92)
    sr, ok = sv.prepare_sr_batch_packed(pks, msgs, sigs)
    assert ok.all()
    pks, msgs, sigs = corpus.k1_signed(DISTINCT, 93)
    k1, ok = kv.prepare_k1_batch_packed(pks, msgs, sigs)
    assert ok.all()
    return {"ed25519_verify": ed, "sr25519_verify": sr, "k1_verify": k1}


def tiled(plane: np.ndarray, n: int) -> torch.Tensor:
    reps = -(-n // plane.shape[1])
    return torch.from_numpy(np.ascontiguousarray(np.tile(plane, (1, reps))[:, :n])).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="directory of the tree to time against")
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR, "kernel_times.json"),
                    help="where the JSON summary goes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    card = smi_line()
    print(f"card: {card}")
    names = list(WRAPPERS)
    csrc = os.path.join(args.parent, "tmtpu_torch", "gpu", "csrc")
    out_dir = os.path.join(build.BUILD_DIR, "parent")
    for tree, logs in (("new", build.build_all(names)),
                       ("parent", build.build_all(names, csrc, out_dir))):
        for name, log in logs.items():
            print(f"ptxas {tree} {name}: {ptxas_summary(log)}")

    base = planes()
    result = {"card": card, "kernels": {}}
    for name, wrapper in WRAPPERS.items():
        runs = {"new": wrapper,
                "parent": parent_runner(ctypes.CDLL(build.lib_path(name, csrc, out_dir)), name)}
        for n in (*WIDTHS[name], *RAGGED):
            packed = tiled(base[name], n)
            got = {tree: run(packed) for tree, run in runs.items()}
            if not bool(got["new"].all()):
                raise RuntimeError(f"{name}: a valid lane was rejected at {n} lanes")
            if not torch.equal(got["new"], got["parent"]):
                raise RuntimeError(f"{name}: new and parent verdicts differ at {n} lanes")
        for corp, prep in ADVERSARIAL[name]:
            packed = torch.from_numpy(prep(*corp())[0]).cuda()
            if not torch.equal(runs["new"](packed), runs["parent"](packed)):
                raise RuntimeError(f"{name}: new and parent differ on {corp.__name__}")
        print(f"{name}: new == parent at {WIDTHS[name] + RAGGED} lanes and on "
              f"{', '.join(c.__name__ for c, _ in ADVERSARIAL[name])}")
        entry = result["kernels"][name] = {}
        for n in WIDTHS[name]:
            packed = tiled(base[name], n)
            order = ["parent", "new", "new", "parent"]
            t = [median_ms(runs[tree], packed) for tree in order]
            turn = {"order": order, "ms": t, "parent_ms": (t[0] + t[3]) / 2,
                    "new_ms": (t[1] + t[2]) / 2}
            turn["speedup"] = turn["parent_ms"] / turn["new_ms"]
            entry[n] = turn
            print(f"{name} at {n} lanes, parent/new/new/parent: "
                  f"{' / '.join(f'{x:.4f}' for x in t)} ms; speed-up "
                  f"{turn['speedup']:.2f}x [{card}]")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
