"""Runs of cells one after another, and the spread of their metrics.

    python3 benchmark/series.py --out DIR --seconds S [--trace 0|1] \\
        CELL:SEED[,SEED...] [CELL:SEED...]

Each run is ``run.py`` as its own process, as the check runs it; its last
stdout line goes to ``DIR/<cell>.<seed>.<trace>.json`` and its stderr to
``.err`` beside it. At the end it prints, for each cell and metric, every
value, the median and the spread: the distance between the first and
third quartiles (``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("runs", nargs="+", help="CELL:SEED[,SEED...]")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    summary = {}
    bad = 0
    for item in args.runs:
        cell, _, seeds = item.partition(":")
        for seed in seeds.split(","):
            stem = os.path.join(args.out, f"{cell}.{seed}.{args.trace}")
            t = time.perf_counter()
            with open(stem + ".err", "wb") as err:
                proc = subprocess.run(
                    [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
                     "--seed", seed, "--seconds", str(args.seconds), "--trace", str(args.trace)],
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=err)
            wall = time.perf_counter() - t
            lines = proc.stdout.decode().strip().splitlines()
            line = lines[-1] if lines else ""
            with open(stem + ".json", "w") as fh:
                fh.write(line + "\n")
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = None
            ok = proc.returncode == 0 and res is not None and res.get("correct")
            bad += not ok
            vals = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
            print(f"{cell} seed={seed} rc={proc.returncode} correct={res and res['correct']} "
                  f"wall={wall:.1f}s {json.dumps(vals)}", flush=True)
            for k, v in vals.items():
                summary.setdefault(cell, {}).setdefault(k, []).append(v)
    for cell, metrics in summary.items():
        for k, vals in metrics.items():
            sp = spread(vals)
            print(f"SPREAD {cell} {k} n={len(vals)} median={statistics.median(vals)!r} "
                  f"spread={sp!r} values={vals!r}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
