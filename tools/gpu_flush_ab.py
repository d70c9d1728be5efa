#!/usr/bin/env python3
"""End-to-end times of this tree against another tree's, in turns on one
card: the cold verify_tally of a 10,000-vote ed25519 set in process (on an
emptied signature cache, and with the cache off), the same set's
verify_tally split over four shards of the one device
(``mesh_dispatch.batch_verify_tally_mesh``) and the 10,000-lane round
trip through ``python -m tmtpu_torch sidecar`` (a cache-off daemon).

Usage: ``python3 tools/gpu_flush_ab.py --parent DIR`` where DIR holds
another checkout (e.g. ``git archive <commit>`` unpacked under the
gitignored ``tmtpu_torch/gpu/build/``). The votes are signed once
(``bench_torch.make_votes``, one signature corrupted). Each tree then gets
a worker process whose ``tmtpu_torch`` is its own: it builds its kernels,
verifies the votes once, starts its own daemon and connects to it. The
workers take turns at the level of single measurements, parent, this,
this, parent, ``--rounds`` times, so the host's drift falls on both trees
alike. Prints, last, one JSON object with each tree's medians and spread
(min, max) and the ratios this tree / parent. ``--device cpu`` runs the
plain versions (seconds a flush; for tests, with a few lanes). Port-side:
imports ``tmtpu_torch``, ``torch`` and numpy, never ``tmtpu`` or JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY_TIMEOUT_S = 300.0
METRICS = ("flush_ms", "flush_off_ms", "mesh_ms", "rtt_ms")


def _daemon(tree: str, device: str, home: str):
    """A cache-off daemon of ``tree`` on a unix socket; returns (process,
    address)."""
    sock = os.path.join(home, "s.sock")
    addr = f"unix://{sock}" if len(sock) < 100 else "tcp://127.0.0.1:0"
    args = [sys.executable, "-m", "tmtpu_torch", "sidecar", "--home", home, "--addr", addr,
            "--no-sigcache"]
    if device == "cpu":
        args += ["--device", "cpu", "--no-warm"]
    proc = subprocess.Popen(args, cwd=tree, stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=tree))
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        ready = lines.get(timeout=READY_TIMEOUT_S)
    except queue.Empty:
        ready = ""
    if not ready.startswith("Sidecar listening on "):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"daemon of {tree} not ready: {ready!r}")
    return proc, ready.split()[3]


def serve(votes_path: str, device: str) -> None:
    """A worker whose ``tmtpu_torch`` is its tree's: answers each line of
    stdin (one of ``METRICS``, or ``quit``) with one JSON line, that
    measurement's ms."""
    import torch

    import tmtpu_torch
    from tmtpu_torch import native
    from tmtpu_torch.crypto import batch, sigcache
    from tmtpu_torch.crypto.ed25519 import PubKeyEd25519
    from tmtpu_torch.gpu import build
    from tmtpu_torch.gpu import mesh_dispatch
    from tmtpu_torch.sidecar.client import SidecarClient

    out, sys.stdout = sys.stdout, sys.stderr  # stdout carries the answers alone
    tree = os.path.dirname(os.path.dirname(os.path.abspath(tmtpu_torch.__file__)))
    with open(votes_path, "rb") as fh:
        pks, msgs, sigs, power = pickle.load(fh)
    if device == "cuda":
        build.build_all()
    native.build()
    bv = batch.new_batch_verifier(None if device == "cuda" else device)
    for pk, msg, sig in zip(pks, msgs, sigs):
        bv.add(PubKeyEd25519(pk), msg, sig, power)
    want = bv.verify_tally()
    lanes = list(zip(pks, msgs, sigs, [power] * len(sigs)))
    home = tempfile.mkdtemp(prefix="tmtpu-ab-")
    proc, addr = _daemon(tree, device, home)
    client = SidecarClient(addr, client_id="ab", connect_timeout_s=10.0,
                           request_deadline_s=120.0)

    def flush(cache: bool) -> float:
        sigcache.DEFAULT.set_enabled(cache)
        sigcache.invalidate_all()
        t0 = time.perf_counter()
        got = bv.verify_tally()
        ms = (time.perf_counter() - t0) * 1e3
        sigcache.DEFAULT.set_enabled(True)
        if got != want:
            raise RuntimeError("a flush's result differs from the first")
        return ms

    def mesh() -> float:
        t0 = time.perf_counter()
        mask, tallied = mesh_dispatch.batch_verify_tally_mesh(
            pks, msgs, sigs, [power] * len(sigs), device=bv.device, mesh=(bv.device,) * 4)
        ms = (time.perf_counter() - t0) * 1e3
        if (mask.tolist(), tallied) != (want[1], want[2]):
            raise RuntimeError("the split's result differs from the flush's")
        return ms

    def rtt() -> float:
        t0 = time.perf_counter()
        mask, tallied, _ = client.verify("ed25519", lanes, tally=True, deadline_s=120.0)
        ms = (time.perf_counter() - t0) * 1e3
        if (mask, tallied) != (want[1], want[2]):
            raise RuntimeError("the daemon's result differs from the flush's")
        return ms

    ops = {"flush_ms": lambda: flush(True), "flush_off_ms": lambda: flush(False),
           "mesh_ms": mesh, "rtt_ms": rtt}
    try:
        rtt()  # the first round trip warms the connection and the daemon
        card = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        out.write(json.dumps({"ready": tree, "card": card}) + "\n")
        out.flush()
        for line in sys.stdin:
            op = line.strip()
            if op == "quit":
                break
            out.write(json.dumps({op: ops[op]()}) + "\n")
            out.flush()
    finally:
        client.close()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        shutil.rmtree(home, ignore_errors=True)


class Worker:
    """One tree's worker process."""

    def __init__(self, tree: str, votes_path: str, device: str):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve", votes_path,
             "--device", device],
            cwd=tree, env=dict(os.environ, PYTHONPATH=tree), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        self.ready = self._read()

    def _read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"worker exited with {self.proc.wait()}")
        return json.loads(line)

    def ask(self, op: str) -> float:
        self.proc.stdin.write(op + "\n")
        self.proc.stdin.flush()
        return self._read()[op]

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--lanes", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=15,
                    help="rounds of parent, this, this, parent; each turn measures all three")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--serve", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve:
        serve(args.serve, args.device)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("gpu_flush_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import bench_torch

    pks, msgs, sigs = bench_torch.make_votes(args.lanes)
    sigs[0] = bytes([sigs[0][0] ^ 0xFF]) + sigs[0][1:]  # one rejected lane
    runs = {"parent": {m: [] for m in METRICS}, "this": {m: [] for m in METRICS}}
    with tempfile.TemporaryDirectory(prefix="tmtpu-ab-") as tmp:
        votes_path = os.path.join(tmp, "votes.pkl")
        with open(votes_path, "wb") as fh:
            pickle.dump((pks, msgs, sigs, bench_torch.POWER), fh)
        workers = {}
        try:
            for name, tree in (("parent", os.path.abspath(args.parent)), ("this", ROOT)):
                workers[name] = Worker(tree, votes_path, args.device)
            for _ in range(args.rounds):
                for name in ("parent", "this", "this", "parent"):
                    for m in METRICS:
                        runs[name][m].append(workers[name].ask(m))
        finally:
            for w in workers.values():
                w.stop()
    summary = {name: {m: statistics.median(v) for m, v in r.items()} for name, r in runs.items()}
    for name in runs:
        print(f"{name}: " + ", ".join(f"{m} {summary[name][m]:.3f} (min {min(v):.3f}, "
                                      f"max {max(v):.3f})" for m, v in runs[name].items()))
    print(json.dumps({
        "lanes": args.lanes, "samples": 2 * args.rounds,
        "card": bench_torch.card_line(torch.device(args.device)), **summary,
        "spread": {name: {m: [min(v), max(v)] for m, v in r.items()}
                   for name, r in runs.items()},
        "ratio": {m: summary["this"][m] / summary["parent"][m] for m in METRICS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
