"""Starts the system under test: the port's deployed daemon entry, unchanged.

    python3 benchmark/daemon_host.py --home H --chips N --trace 0|1 --out DIR

It calls ``tmtpu_torch.__main__.main(["sidecar", "--home", H])`` on its
main thread, as ``python -m tmtpu_torch sidecar --home H`` would, so every
change to the daemon's command is measured. Before that it checks the
cards (exit 3 without CUDA or with fewer cards than the cell asks for).
When the daemon has stopped it writes ``DIR/daemon.json``: the peak of
device memory the process allocated on its fullest card, the card's name
and count, the top-level names of every module the process loaded, and
when its import of torch, its check of the cards and its import of the
port ended (seconds from its start).

With ``--trace 1`` it also
- raises the port's span ring (``TMTPU_TRACE_CAPACITY``) so no span of a
  window is evicted;
- on SIGUSR1 drains the ring, starts ``torch.profiler`` (CPU and CUDA
  activity) and writes ``DIR/ack1``;
- on SIGUSR2 stops it and writes ``DIR/trace.pkl``: the spans recorded
  since SIGUSR1, how many the ring dropped, and every device activity
  (kernels, copies, sets) as (start, end, name) on the
  ``time.perf_counter()`` clock, then ``DIR/ack2``.
The daemon's command handles only SIGINT and SIGTERM, so these two
signals are free for the harness.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# spans the ring holds in a traced run: a dispatch records about six
TRACE_CAPACITY = 4_000_000
MARK = "sigbench.window_mark"


def _write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


class Tracing:
    """The profiler and the span ring between the harness's two signals."""

    def __init__(self, out: str):
        self.out = out
        self.prof = None
        self.t_mark = 0.0

    def start(self, *_):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from tmtpu_torch.libs import trace

        trace.drain()
        cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.start()
        with record_function(MARK):
            self.t_mark = time.perf_counter()
        if cuda:
            torch.cuda.synchronize()
        _write(os.path.join(self.out, "ack1"), b"%r" % time.perf_counter())

    def stop(self, *_):
        from tmtpu_torch.libs import trace

        t_off = time.perf_counter()
        dropped = trace.DEFAULT.dropped
        spans = [sp.to_dict() for sp in trace.drain()]
        self.prof.stop()
        device, error = self._device_events()
        data = {"spans": spans, "dropped": dropped, "t_off": t_off,
                "device": device, "profiler_error": error}
        _write(os.path.join(self.out, "trace.pkl"), pickle.dumps(data))
        _write(os.path.join(self.out, "ack2"), b"%r" % time.perf_counter())

    def _device_events(self):
        """Device activity as (start_s, end_s, name) on perf_counter's
        clock, aligned through the CPU mark recorded at start."""
        import torch

        try:
            events = self.prof.profiler.kineto_results.events()
        except AttributeError as exc:
            return [], f"no kineto results: {exc}"
        raw, mark = [], None
        for e in events:
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            name = e.name()
            if name == MARK and mark is None:
                mark = start
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                raw.append((start, start + dur, name))
        if mark is None:
            return [], "the profiler recorded no mark"
        off = self.t_mark - mark / 1e9
        return [(s / 1e9 + off, e / 1e9 + off, n) for s, e, n in raw], ""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--home", required=True)
    ap.add_argument("--chips", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    # the CPU rehearsal of the tests only; a run of the benchmark never sets it
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.trace:
        os.environ["TMTPU_TRACE_CAPACITY"] = str(TRACE_CAPACITY)
        tracing = Tracing(args.out)
        signal.signal(signal.SIGUSR1, tracing.start)
        signal.signal(signal.SIGUSR2, tracing.stop)
    import torch

    marks = {"torch_imported_s": time.perf_counter() - T_START}
    if args.device == "cpu":
        return _run_on_cpu(args)
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.chips:
        print(f"daemon_host: the cell needs {args.chips} CUDA card(s); "
              f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}",
              file=sys.stderr, flush=True)
        return 3
    marks["cuda_checked_s"] = time.perf_counter() - T_START
    sys.path.insert(0, ROOT)
    from tmtpu_torch.__main__ import main as port_main

    marks["port_imported_s"] = time.perf_counter() - T_START
    rc = port_main(["sidecar", "--home", args.home])
    count = torch.cuda.device_count()
    report = {
        "rc": rc,
        "kind": torch.cuda.get_device_name(0),
        "count": args.chips,
        "visible": count,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(count)),
        "modules": sorted({m.split(".")[0] for m in sys.modules}),
        "marks": marks,
    }
    _write(os.path.join(args.out, "daemon.json"), json.dumps(report).encode())
    return rc


def _run_on_cpu(args) -> int:
    """The daemon on the CPU, with the plain versions and no warm-up."""
    sys.path.insert(0, ROOT)
    from tmtpu_torch.__main__ import main as port_main

    rc = port_main(["sidecar", "--home", args.home, "--device", "cpu", "--no-warm"])
    report = {"rc": rc, "kind": "cpu", "count": args.chips, "visible": 0,
              "memory_peak_bytes": 0,
              "modules": sorted({m.split(".")[0] for m in sys.modules})}
    _write(os.path.join(args.out, "daemon.json"), json.dumps(report).encode())
    return rc


if __name__ == "__main__":
    sys.exit(main())
