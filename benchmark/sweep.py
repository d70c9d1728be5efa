"""The rate sweep of an open-loop cell: one run a rate, in turn.

    python3 benchmark/sweep.py --workload CELL --seconds S --seed N \\
        --rates R1,R2,... [--out DIR]

Each run is the cell's whole run with its mix's
``rate_lanes_per_s_per_node`` set to one rate (the mix's file is not
changed). It prints, a line a rate, the cell's end-to-end metrics, how late
the generator ran, and the backlog: the lanes due and not yet answered at
the window's middle and at its end, and the lanes queued in the daemon at
its end. A rate is sustained when the backlog does not grow from the
middle to the end and the generator keeps its schedule.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def one(args) -> int:
    from benchmark import run

    spec = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    w, conf, cfg, traffic = run.cell_of(spec, args.workload)
    traffic = dict(traffic, rate_lanes_per_s_per_node=args.rate)
    ns = argparse.Namespace(workload=args.workload, seed=args.seed, seconds=args.seconds, trace=0)
    return run.run(ns, spec=spec, cell_override=(w, conf, cfg, traffic))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--rate", type=float, help="one run at this rate")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.rate is not None:
        return one(args)
    for rate in args.rates.split(","):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
             "--seconds", str(args.seconds), "--seed", str(args.seed), "--rate", rate],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        lines = proc.stdout.decode().strip().splitlines()
        if args.out:
            with open(os.path.join(args.out, f"sweep.{rate}.err"), "wb") as fh:
                fh.write(proc.stderr)
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            print(f"rate={rate} rc={proc.returncode} no result: "
                  f"{proc.stderr.decode()[-1500:]}", flush=True)
            continue
        vals = {k: round(v["value"], 3) for k, v in res["metrics"].items()}
        print(f"rate={rate} rc={proc.returncode} correct={res['correct']} "
              f"attempted={res['attempted']} failed={res['failed']} {json.dumps(vals)} "
              f"{json.dumps(res['generator'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
