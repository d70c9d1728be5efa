"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration,
``benchmark/configs/<config>.json``, and a traffic mix,
``benchmark/traffic/<mix>.json``, whose ``generator`` is a module of
``benchmark/generators/``. Each metric is read by
``benchmark/metrics/<metric>.py``. A new cell, mix or metric is new files
and entries; this file does not change.

A run:
1. writes the configuration's daemon settings as the ``config.toml`` of a
   home under ``TMPDIR`` and starts the daemon (``daemon_host.py``: the
   port's ``python -m tmtpu_torch sidecar --home``) as its own process;
2. meanwhile signs the configuration's pool, draws the cell's requests from
   ``--seed`` and encodes their lanes with the benchmark's own codec
   (``wire.py``), and starts one client process a node (``client.py``);
3. when the daemon is ready, starts the clients: a warm-up stretch of the
   same traffic, then the window of ``--seconds``, whose edges it marks by
   reading the daemon's Stats (and with ``--trace 1`` by SIGUSR1 and
   SIGUSR2, which start and stop the profiler in the daemon's process);
4. after the window: waits for every answer, stops the daemon (SIGTERM),
   checks every answer against the pool's verdicts and a sample against
   the plain reference (``reference/``), checks that no process loaded
   JAX or the JAX package, and prints one JSON line: the cell's
   end-to-end metrics (``--trace 0``) or its per-layer metrics
   (``--trace 1``).

It exits 1, and prints no result, when anything fails, the card's absence
included. ``setup_s`` runs from this process's start to the
window's start.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import wire  # noqa: E402
from benchmark.readers import device_union  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tmtpu")
DAEMON_READY_S = 1100.0     # the first run in a checkout builds the kernels
ACK_S = 120.0
# lanes of the reference's sample: every corrupted lane answered in the
# window up to half of it, the rest valid lanes
REF_SAMPLE = 128
UNIX_PATH_MAX = 100


class RunError(Exception):
    """The run cannot give a result."""


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden(seen):
    """{process: the forbidden top-level names it loaded} for each process
    in ``seen`` ({process: module names}) that loaded any. A name is
    compared whole up to its first dot: ``tmtpu.types`` is ``tmtpu``,
    ``tmtpu_torch`` is not."""
    out = {}
    for who, mods in seen.items():
        hit = sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))
        if hit:
            out[who] = hit
    return out


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise RunError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def cell_of(spec, name):
    """(workload, configuration entry, configuration file, traffic file)."""
    for w in spec["workloads"]:
        if w["name"] == name:
            break
    else:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    return w, conf, cfg, traffic


def metrics_of(spec, cell: str, trace: int):
    """The metrics this cell reports: its end-to-end metrics without
    tracing, its per-layer metrics with it."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def toml_text(sections) -> str:
    out = []
    for sec, values in sections.items():
        out.append(f"[{sec}]")
        for k, v in values.items():
            if isinstance(v, bool):
                out.append(f"{k} = {'true' if v else 'false'}")
            elif isinstance(v, (int, float)):
                out.append(f"{k} = {v}")
            else:
                out.append(f"{k} = {json.dumps(v)}")
        out.append("")
    return "\n".join(out)


# -- processes -----------------------------------------------------------------

class Daemon:
    """The daemon's process, its ready line and its stderr."""

    def __init__(self, rundir: str, home: str, chips: int, trace: int, device=None,
                 host=None):
        self.rundir = rundir
        self.err_path = os.path.join(rundir, "daemon.err")
        host = host or [sys.executable, os.path.join(BENCH, "daemon_host.py")]
        cmd = host + ["--home", home, "--chips", str(chips), "--trace", str(trace),
                      "--out", rundir]
        if device:
            cmd += ["--device", device]
        self._err = open(self.err_path, "wb")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=self._err, stdin=subprocess.DEVNULL)
        self.ready = threading.Event()
        self.lines = []
        self.addr = ""
        self.warm_s = 0.0
        self.t_ready = 0.0
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for raw in self.proc.stdout:
            line = raw.decode(errors="replace").rstrip()
            self.lines.append(line)
            if line.startswith("Sidecar listening on ") and not self.ready.is_set():
                fields = line.split()
                self.addr = fields[3]
                for f in fields:
                    if f.startswith("warm_s="):
                        self.warm_s = float(f[len("warm_s="):])
                self.t_ready = time.perf_counter()
                self.ready.set()

    def wait_ready(self, timeout: float) -> None:
        end = time.perf_counter() + timeout
        while not self.ready.wait(0.2):
            if self.proc.poll() is not None:
                raise RunError(f"the daemon exited with {self.proc.returncode} before it "
                               f"was ready:\n{self.err_tail()}")
            if time.perf_counter() > end:
                raise RunError("the daemon was not ready in time")

    def signal_and_ack(self, sig, ack: str) -> None:
        path = os.path.join(self.rundir, ack)
        self.proc.send_signal(sig)
        end = time.perf_counter() + ACK_S
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.perf_counter() > end:
                raise RunError(f"no {ack} from the daemon:\n{self.err_tail()}")
            time.sleep(0.01)

    def stop(self, timeout: float = 60.0) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._err.close()
        return self.proc.returncode

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._err.close()

    def err_tail(self, n: int = 4000) -> str:
        try:
            with open(self.err_path, "rb") as fh:
                return fh.read()[-n:].decode(errors="replace")
        except OSError:
            return ""


class Client:
    """One node's client process; its job goes in on stdin, its records
    come back on stdout."""

    def __init__(self, rundir: str, node: int, job: dict):
        self.err_path = os.path.join(rundir, f"client{node}.err")
        self._err = open(self.err_path, "wb")
        self.proc = subprocess.Popen([sys.executable, os.path.join(BENCH, "client.py")],
                                     cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=self._err)
        self._out = []
        # written from a thread, so the clients read their jobs together
        self._writer = threading.Thread(target=self._write_job, args=(job,), daemon=True)
        self._writer.start()

    def _write_job(self, job) -> None:
        try:
            pickle.dump(job, self.proc.stdin)
            self.proc.stdin.flush()
        except OSError:
            pass  # the client died; wait_line reports it

    def send(self, line: str) -> None:
        self._writer.join()
        self.proc.stdin.write((line + "\n").encode())
        self.proc.stdin.flush()

    def wait_line(self, want: str, timeout: float) -> None:
        box = []
        t = threading.Thread(target=lambda: box.append(self.proc.stdout.readline()),
                             daemon=True)
        t.start()
        t.join(timeout)
        if not box or box[0].decode().strip() != want:
            raise RunError(f"client did not say {want!r}: {box}\n{self.err_tail()}")
        # from here on the client writes only its records, at its end
        self._reader = threading.Thread(target=lambda: self._out.append(self.proc.stdout.read()),
                                        daemon=True)
        self._reader.start()

    def result(self, timeout: float) -> dict:
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired as exc:
            raise RunError("a client did not finish") from exc
        self._reader.join(30.0)
        self._err.close()
        if self.proc.returncode != 0 or not self._out:
            raise RunError(f"a client exited with {self.proc.returncode}:\n{self.err_tail()}")
        return pickle.loads(self._out[0])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self._err.closed:
            self._err.close()

    def err_tail(self, n: int = 4000) -> str:
        try:
            with open(self.err_path, "rb") as fh:
                return fh.read()[-n:].decode(errors="replace")
        except OSError:
            return ""


# -- what the metrics read -------------------------------------------------------

class Ctx:
    """Everything a metric's reader may read from one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window_requests(self):
        return [r for r in self.requests if r["in_window"]]

    def spans_in_window(self, name):
        return [s for s in self.spans
                if s["name"] == name and self.t0 <= s["start_s"] < self.t1]

    def stats_delta(self, *path):
        a, b = self.stats0, self.stats1
        for k in path:
            a, b = a[k], b[k]
        return b - a

    def sig_as_sent(self, e: int) -> bytes:
        return self.corrupted.get(e, self.pool.sigs[e])


def host_cpu(pid: int) -> int:
    """The user + system clock ticks of process ``pid``, all its threads."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        return int(fields[11]) + int(fields[12])
    except OSError:
        return 0


def backlog(requests, t):
    """Lanes of the requests due before ``t`` and not answered by then."""
    return sum(r["lanes"] for r in requests
               if r["due_abs"] < t and (r["replied"] is None or r["replied"] > t))


def _gap_label(ctx, a: float, b: float, samples: int = 64) -> str:
    """What the host was doing across the idle gap [a, b]: at evenly
    spaced instants, the innermost daemon span open, else whether a
    request was in flight (the daemon's work outside its span tree:
    codec, resolve, inserts, bit pack, queueing) or none was."""
    spans = [s for s in ctx.spans if s["start_s"] < b and s["start_s"] + s["dur_s"] > a]
    reqs = [r for r in ctx.requests
            if r["sent"] is not None and r["sent"] < b and (r["replied"] or b) > a]
    counts = {}
    for k in range(samples):
        t = a + (b - a) * (k + 0.5) / samples
        open_ = [s for s in spans if s["start_s"] <= t <= s["start_s"] + s["dur_s"]]
        if open_:
            what = max(open_, key=lambda s: s["start_s"])["name"]
        elif any(r["sent"] <= t <= (r["replied"] or b) for r in reqs):
            what = "request in flight, outside the span tree"
        else:
            what = "no request in flight"
        counts[what] = counts.get(what, 0) + 1
    top = max(counts, key=counts.get)
    return f"{top} ({100 * counts[top] // samples}% of the gap)"


def breakdown(ctx):
    """The device operations that took most time, and the longest idle
    gaps, each named by what the host was doing across it."""
    by_name = {}
    for s, e, name in ctx.device_events:
        d = min(e, ctx.t1) - max(s, ctx.t0)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ops = [(n if len(n) <= 160 else n[:157] + "...", d) for n, d in ops]
    union = device_union(ctx.device_events, ctx.t0, ctx.t1)
    edges = [ctx.t0] + [x for iv in union for x in iv] + [ctx.t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    idle = [[_gap_label(ctx, start, start + d), d] for d, start in gaps]
    return {"device_ops": [[n, d] for n, d in ops], "idle_gaps": idle}


def collect(plan, results, t0, t1):
    """Every request the clients sent or were due to send, with its times
    on the shared clock; ``in_window``: due in [t0, t1) in an open loop,
    sent then in a closed one."""
    requests = []
    for n, (node, res) in enumerate(zip(plan["nodes"], results)):
        for rec in res["records"]:
            req = node["requests"][rec["ix"]]
            due_abs = res["t_start"] + rec["due"]
            when = due_abs if node["mode"] == "open" else rec["sent"]
            requests.append({
                "node": n, "kind": rec["kind"], "due_abs": due_abs, "sent": rec["sent"],
                "replied": rec["replied"], "status": rec.get("status"),
                "lanes": len(req["entries"]), "entries": req["entries"], "tally": req["tally"],
                "in_window": when is not None and t0 <= when < t1,
                "mask": rec.get("mask"), "lane_count": rec.get("lane_count"),
                "tallied": rec.get("tallied"), "error": rec.get("error")})
    return requests


def check_answers(pool, plan, requests):
    """Each answered request against the pool's verdicts: a lane is valid
    unless the run corrupted it, and the tally is the power of the valid
    lanes. Returns the counts of what was wrong, and the lanes answered in
    the window."""
    corrupt = np.zeros(pool.size, dtype=bool)
    corrupt[plan["corrupt"]] = True
    validator = np.arange(pool.size) % pool.validators
    powers = np.asarray(pool.powers, dtype=np.int64)
    checks = {"unanswered": 0, "lane_count_wrong": 0, "mask_lanes_wrong": 0,
              "tally_wrong": 0}
    answered = []
    for r in requests:
        if r["sent"] is None or (r["replied"] is not None and r["status"] != wire.STATUS_OK):
            continue
        if r["replied"] is None:
            checks["unanswered"] += 1
            continue
        entries = r["entries"]
        try:
            if r["lane_count"] != len(entries):
                raise wire.WireError("lane count")
            got = wire.unpack_mask(r["mask"], len(entries))
        except wire.WireError:
            checks["lane_count_wrong"] += 1
            continue
        want = ~corrupt[entries]
        checks["mask_lanes_wrong"] += int((got != want).sum())
        tally = int(powers[validator[entries[want]]].sum()) if r["tally"] else 0
        checks["tally_wrong"] += int(tally != r["tallied"])
        if r["in_window"]:
            answered.append(entries)
    return checks, answered


def reference_sample(curve, pool, plan, corrupted, answered, seed) -> int:
    """The plain reference over a sample, drawn from the seed, of the lanes
    answered in the window: corrupted ones up to half of ``REF_SAMPLE``,
    valid ones for the rest. Returns how many of its verdicts differ from
    the pool's."""
    ref = load_module(os.path.join(BENCH, "reference", curve + ".py"), "sigbench_ref")
    corrupt = set(plan["corrupt"])
    lanes = np.unique(np.concatenate(answered)).tolist() if answered else []
    bad = [e for e in lanes if e in corrupt]
    good = [e for e in lanes if e not in corrupt]
    rng = random.Random(seed)
    sample = rng.sample(bad, min(len(bad), REF_SAMPLE // 2))
    n_bad = len(sample)
    sample += rng.sample(good, min(len(good), REF_SAMPLE - n_bad))
    t = time.perf_counter()
    wrong = 0
    for e in sample:
        pk = pool.pks[pool.validator_of(e)]
        wrong += ref.verify(pk, pool.msgs[e], corrupted.get(e, pool.sigs[e])) == (e in corrupt)
    log(f"reference: {len(sample)} lanes ({n_bad} corrupted) in "
        f"{time.perf_counter() - t:.3f} s")
    return wrong


def generator_report(ctx, stats1):
    """How late the clients sent, and the backlog: lanes due and not yet
    answered at the window's middle and end, and queued in the daemon at
    its end (the rate sweep's test of a sustained rate)."""
    window = ctx.window_requests()
    late = [r["sent"] - r["due_abs"] for r in window if r["sent"] is not None]
    return {"late_p50_ms": float(np.percentile(late, 50) * 1e3) if late else 0.0,
            "late_max_ms": float(max(late) * 1e3) if late else 0.0,
            "requests_sent": sum(r["sent"] is not None for r in ctx.requests),
            "backlog_mid_lanes": backlog(ctx.requests, (ctx.t0 + ctx.t1) / 2),
            "backlog_end_lanes": backlog(ctx.requests, ctx.t1),
            "queued_lanes_end": stats1["coalescer"]["queued_lanes"]}


def host_report(ctx, daemon_cpu_s):
    """Round-trip percentiles of the window, the medians of its two halves
    (a drift inside the run shows there), and the daemon's CPU seconds."""
    window = [r for r in ctx.window_requests() if r["replied"] is not None]
    mid = (ctx.t0 + ctx.t1) / 2
    pct = lambda rs, q: float(np.percentile([r["replied"] - r["sent"] for r in rs], q) * 1e3)
    halves = [[r for r in window if (r["due_abs"] < mid) == first] for first in (True, False)]
    return {"rtt_ms_p10_p50_p90": [pct(window, q) for q in (10, 50, 90)] if window else [],
            "rtt_ms_p50_halves": [pct(h, 50) for h in halves if h],
            "daemon_cpu_s": daemon_cpu_s}


# -- the run ---------------------------------------------------------------------

def run(args, device=None, spec=None, cell_override=None, host=None) -> int:
    """One run; returns the exit code. ``device="cpu"``, the overrides and
    ``host`` (the command that starts a stand-in for the daemon: the
    control, or the daemon with a fault planted) serve the control and the
    tests only."""
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w, conf, cfg, traffic = cell_override or cell_of(spec, args.workload)
    metric_defs = metrics_of(spec, w["name"], args.trace)
    rundir = os.path.join(tempfile.gettempdir(), f"sb{os.getpid()}")
    shutil.rmtree(rundir, ignore_errors=True)
    home = os.path.join(rundir, "home")
    os.makedirs(os.path.join(home, "config"))
    daemon, clients = None, []
    try:
        sections = json.loads(json.dumps(cfg["daemon"]))
        sock = os.path.join(rundir, "s.sock")
        sections.setdefault("sidecar", {})["addr"] = (
            f"unix://{sock}" if len(sock) <= UNIX_PATH_MAX else "tcp://127.0.0.1:0")
        with open(os.path.join(home, "config", "config.toml"), "w") as fh:
            fh.write(toml_text(sections))
        daemon = Daemon(rundir, home, w["chips"], args.trace, device, host)
        t_daemon = time.perf_counter()

        # imported by name: the signing pool's workers unpickle its functions
        pool_mod = importlib.import_module(f"benchmark.pools.{cfg['pool']}")
        pool = pool_mod.Pool(cfg)
        t_signed = time.perf_counter()
        gen = load_module(os.path.join(BENCH, "generators", traffic["generator"] + ".py"),
                          "sigbench_gen")
        plan = gen.plan(pool, traffic, args.seed, args.seconds)
        rng = random.Random(args.seed ^ 0x5EED)
        corrupted = {e: pool_mod.corrupt(pool.sigs[e], rng) for e in plan["corrupt"]}
        blobs = [wire.lane_blob(pool.pks[pool.validator_of(e)], pool.msgs[e],
                                corrupted.get(e, pool.sigs[e]),
                                pool.powers[pool.validator_of(e)])
                 for e in range(pool.size)]
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        lanes = b"".join(blobs)
        del blobs
        deadline_s = cfg["daemon"]["sidecar"].get("request_deadline_ns", 10_000_000_000) / 1e9
        for n, node in enumerate(plan["nodes"]):
            clients.append(Client(rundir, n, {
                "client_id": f"node{n}", "mode": node["mode"],
                "requests": node["requests"], "offsets": offsets, "lanes": lanes,
                "curve": cfg["curve"], "deadline_ms": int(deadline_s * 1000)}))
        t_encoded = time.perf_counter()

        daemon.wait_ready(DAEMON_READY_S)
        for c in clients:
            c.send(f"addr {daemon.addr}")
        for c in clients:
            c.wait_line("ready", 600.0)
        t_clients = time.perf_counter()
        if args.trace:
            daemon.signal_and_ack(signal.SIGUSR1, "ack1")
        ssock, sreader = wire.connect(daemon.addr, "bench-stats")

        t_start = time.perf_counter() + 0.2
        t0 = t_start + plan["warm_s"]
        t1 = t0 + args.seconds
        t_stop = t1 + plan["tail_s"] if plan["nodes"][0]["mode"] == "open" else t1
        for c in clients:
            c.send(f"start {t_start!r} {t_stop!r}")
        time.sleep(max(0.0, t0 - time.perf_counter()))
        stats0 = wire.stats(ssock, sreader)
        host0 = host_cpu(daemon.proc.pid)
        setup_s = t0 - T_PROCESS
        time.sleep(max(0.0, t1 - time.perf_counter()))
        stats1 = wire.stats(ssock, sreader)
        host1 = host_cpu(daemon.proc.pid)
        ssock.close()
        traced = {"spans": [], "dropped": 0, "device": [], "profiler_error": ""}
        if args.trace:
            daemon.signal_and_ack(signal.SIGUSR2, "ack2")
            with open(os.path.join(rundir, "trace.pkl"), "rb") as fh:
                traced = pickle.load(fh)
        results = [c.result(t_stop - time.perf_counter() + 120.0) for c in clients]
        rc = daemon.stop()
        if rc != 0:
            raise RunError(f"the daemon exited with {rc}:\n{daemon.err_tail()}")
        report = load_json(os.path.join(rundir, "daemon.json"))
        if "marks" in report:
            log("daemon process: " + ", ".join(f"{k} {v:.3f}" for k, v in report["marks"].items())
                + " (from its start)")
        log(f"setup: daemon started at {t_daemon - T_PROCESS:.3f} s, ready at "
            f"{daemon.t_ready - T_PROCESS:.3f} s (warm-up {daemon.warm_s:.3f} s); pool signed "
            f"{t_signed - t_daemon:.3f} s; requests drawn and encoded "
            f"{t_encoded - t_signed:.3f} s; clients ready at {t_clients - T_PROCESS:.3f} s; "
            f"traffic warm-up {plan['warm_s']:.3f} s; window at {setup_s:.3f} s")

        requests = collect(plan, results, t0, t1)
        checks, answered = check_answers(pool, plan, requests)
        failures = [f for res in results for f in res["failure"]]
        if failures:
            log(f"client connection failures: {failures}")
            checks["unanswered"] += len(failures)
        checks["reference_disagrees"] = reference_sample(
            cfg["curve"], pool, plan, corrupted, answered, args.seed)

        seen = {"harness": sorted({m.split(".")[0] for m in sys.modules}),
                "daemon": report["modules"]}
        for n, res in enumerate(results):
            seen[f"client{n}"] = res["modules"]
        loaded = forbidden(seen)
        if loaded:
            log(f"forbidden modules loaded: {loaded}")
            return 1
        if args.trace and traced["dropped"]:
            raise RunError(f"the span ring dropped {traced['dropped']} spans")
        if traced["profiler_error"]:
            log(f"profiler: {traced['profiler_error']}")

        ctx = Ctx(cell=w["name"], cfg=cfg, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, t0=t0, t1=t1, setup_s=setup_s,
                  requests=requests, stats0=stats0, stats1=stats1,
                  spans=traced["spans"], device_events=traced["device"],
                  pool=pool, corrupted=corrupted)
        values = {}
        for m in metric_defs:
            reader = load_module(os.path.join(BENCH, "metrics", m["name"] + ".py"),
                                 "sigbench_metric")
            v = reader.read(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        window = ctx.window_requests()
        errors = sorted({r["error"] for r in window if r["status"] not in (None, wire.STATUS_OK)})
        if errors:
            log(f"failed requests' errors: {errors[:5]}")
        dev = {"platform": "gpu" if report["kind"] != "cpu" else "cpu",
               "kind": report["kind"], "count": report["count"],
               "memory_peak_bytes": report["memory_peak_bytes"]}
        out = {"correct": all(v == 0 for v in checks.values()), "attempted": len(window),
               "failed": sum(1 for r in window if r["status"] != wire.STATUS_OK),
               "metrics": values, "device": dev}
        if args.trace:
            union = device_union(ctx.device_events, t0, t1)
            dev["busy_s"] = sum(e - s for s, e in union)
            dev["window_s"] = t1 - t0
            log(f"device busy {dev['busy_s']:.6f} s of {t1 - t0:.6f} (profiler)")
            if union:
                out["breakdown"] = breakdown(ctx)
        out["generator"] = generator_report(ctx, stats1)
        out["host"] = host_report(ctx, (host1 - host0) / os.sysconf("SC_CLK_TCK"))
        out["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
        for k, v in checks.items():
            print(f"check {k} {v} limit 0", file=sys.stderr)
        print(json.dumps(out), flush=True)
        return 0
    except RunError as exc:
        log(f"run failed: {exc}")
        return 1
    finally:
        for c in clients:
            c.kill()
        if daemon is not None:
            daemon.kill()
        shutil.rmtree(rundir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
