"""The 4-node localnet A/B against the port's sidecar daemon on the CUDA
card: the twin of tools/localnet_sidecar_ab.py.

The same real-TCP kvstore network (tools/ab_common.py ``make_localnet``,
``run_window``: boot to height 2, open-loop load, one measured window), run
twice with the same window and load:

- A (``cpu``): every node verifies in process (``crypto_backend=cpu``);
- B (``sidecar``): every node sets ``crypto_backend=sidecar`` with
  ``[sidecar] addr`` pointing at one ``python -m tmtpu_torch sidecar``
  process, which this tool starts on a unix socket and stops with SIGTERM
  (it must exit 0).

Per arm: blocks, block rate per minute, dispatches and lanes per block
(A: flushes that reached the CPU verifier; B: the daemon's dispatches and
lanes, from its Stats, over the window), and for B the mean requests per
daemon dispatch and the lanes that fell back to in-process verification
(``sidecar_client_fallback``, counted until the nodes have stopped, which
must stay 0, else exit 1; so must a JAX load in this process).
``block_rate_ratio`` (B over A) is the north star's "round latency
unchanged". All four nodes share this process and one daemon connection.

The tool imports nothing of ``tmtpu_torch`` and nothing that loads JAX (not
``tests/``). One JSON line per arm on stderr, the combined object last on
stdout, with the card's name and power limit.

    python3 tools/gpu_localnet_ab.py [window_seconds] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tmtpu.crypto import batch as crypto_batch  # noqa: E402
from tmtpu.libs import breaker as _bk  # noqa: E402
from tmtpu.libs import metrics as _m  # noqa: E402
from tools import ab_common  # noqa: E402
from tools.gpu_common import Daemon, launch_delta, smi_line  # noqa: E402

CHAIN_ID = "gpu-localnet-ab-chain"


def _nodes(tmp, backend, sidecar_addr="", deadline_ns=0):
    def configure(cfg, _i):
        cfg.base.crypto_backend = backend
        cfg.sidecar.addr = sidecar_addr
        if deadline_ns:
            cfg.sidecar.request_deadline_ns = deadline_ns

    return ab_common.make_localnet(4, tmp, CHAIN_ID, configure=configure)


def _arm(name, blocks, wall, dispatches, lanes) -> dict:
    return {"arm": name, "window_s": wall, "blocks": blocks,
            "block_rate_per_min": blocks / wall * 60,
            "dispatches": dispatches, "lanes": lanes,
            "dispatches_per_block": dispatches / max(1, blocks),
            "lanes_per_block": lanes / max(1, blocks)}


def run_cpu(window_s: float, boot_timeout_s: float) -> dict:
    """Arm A: in-process verification; every flush that reaches the CPU
    verifier is one dispatch."""
    count = {"flushes": 0, "lanes": 0}
    real = crypto_batch.CPUBatchVerifier._verify_pending

    def counting(self, items, tally):
        count["flushes"] += 1
        count["lanes"] += len(items)
        return real(self, items, tally)

    crypto_batch.CPUBatchVerifier._verify_pending = counting
    nodes = _nodes(pathlib.Path(tempfile.mkdtemp(prefix="gpu-ab-cpu-")), "cpu")
    try:
        blocks, wall = ab_common.run_window(
            nodes, window_s, lambda: count.update(flushes=0, lanes=0), prefix=b"gab",
            warm_timeout_s=boot_timeout_s)
    finally:
        crypto_batch.CPUBatchVerifier._verify_pending = real
        for nd in nodes:
            nd.stop()
    return _arm("cpu", blocks, wall, count["flushes"], count["lanes"])


def run_sidecar(window_s: float, device, boot_timeout_s: float) -> dict:
    """Arm B: every node on the port's daemon; dispatches, requests and
    lanes from the daemon's Stats over the window."""
    daemon = Daemon(device)
    deadline_ns = int(120e9) if device == "cpu" else 0
    br = _bk.get(crypto_batch.SIDECAR_BREAKER_NAME)
    nodes = []
    rc = None
    try:
        nodes = _nodes(pathlib.Path(daemon.home), "sidecar", daemon.addr, deadline_ns)
        assert crypto_batch._default_backend == "sidecar", \
            "node construction did not select the sidecar backend"
        br.reset()
        marks = {}

        def reset():
            marks["stats"] = daemon.stats()
            marks["fallback"] = ab_common.counter_value(_m.sidecar_client_fallback)

        blocks, wall = ab_common.run_window(nodes, window_s, reset, prefix=b"gab",
                                            warm_timeout_s=boot_timeout_s)
        stats = daemon.stats()
    finally:
        # the nodes stop before the daemon, so none of their last flushes
        # finds it gone and verifies in process
        for nd in nodes:
            nd.stop()
        fallback = ab_common.counter_value(_m.sidecar_client_fallback) - marks.get("fallback", 0)
        crypto_batch.set_default_backend("cpu")
        crypto_batch.reset_sidecar_client()
        rc = daemon.stop()
    c0, c1 = marks["stats"]["coalescer"], stats["coalescer"]
    dispatches = c1["dispatches"] - c0["dispatches"]
    requests = c1["dispatched_requests"] - c0["dispatched_requests"]
    out = _arm("sidecar", blocks, wall, dispatches,
               c1["dispatched_lanes"] - c0["dispatched_lanes"])
    launches = launch_delta(marks["stats"], stats)
    out.update(requests_coalesced=requests,
               mean_requests_per_dispatch=requests / max(1, dispatches),
               launches=launches, fallback_lanes=fallback, breaker_state=br.state,
               daemon_exit=rc,
               device=stats["device"]["kind"] if stats["backend"] == "gpu" else "cpu")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("window", type=float, nargs="?", default=20.0,
                    help="seconds of the measured window of each arm")
    ap.add_argument("--device", default=None,
                    help="the daemon's device: default the CUDA card; cpu for tests")
    args = ap.parse_args(argv)
    # the reference's 60 s to reach height 2; the plain versions take seconds a dispatch
    boot_s = 300.0 if args.device == "cpu" else 60.0
    report = ab_common.ABReport("gpu_localnet_ab")
    cpu = report.add_arm(run_cpu(args.window, boot_s))
    sc = report.add_arm(run_sidecar(args.window, args.device, boot_s))
    on_card = sc["device"] != "cpu"
    failures = []
    if sc["fallback_lanes"]:
        failures.append(f"{sc['fallback_lanes']:g} lanes fell back to in-process verification")
    if sc["daemon_exit"] != 0:
        failures.append(f"the daemon exited {sc['daemon_exit']} on SIGTERM")
    if not sc["blocks"] or not sc["dispatches"]:
        failures.append("no block or no daemon dispatch in the sidecar arm's window")
    if on_card and not sc["launches"]["ed25519_verify"]:
        failures.append("no launch of ed25519_verify in the daemon")
    if "jax" in sys.modules:
        failures.append("JAX was loaded in the nodes' process")
    report.finish(
        ok=not failures, failures=failures,
        block_rate_ratio=sc["block_rate_per_min"] / max(1e-9, cpu["block_rate_per_min"]),
        mean_requests_per_dispatch=sc["mean_requests_per_dispatch"],
        card=smi_line() if on_card else None)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
