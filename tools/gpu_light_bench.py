"""Light-client sync verified on the CUDA card by the port's sidecar daemon:
the twin of ``tools/light_bench.py --backend tpu`` (BASELINE config 4, the
reference's light/client_benchmark_test.go:29-84).

The chain is fabricated as the reference's bench fabricates it
(``tests/test_light.py`` ``FabChain``: 4 validators of power 10, a
precommit of each on every height, default 100,000 heights). The bench
then runs the reference's two scenarios:

1. bisection (skipping verification, trust level 1/3) from height 1 to
   the tip through ``Client.verify_light_block_at_height``: with one
   validator set throughout, one hop whose commit checks send four lanes;
2. the sequential sync: every header 2..N through ``verify_adjacent_run``
   in runs of ``--run`` blocks (default 1,024: one request of 4,096 lanes
   a run, the keys repeating every four lanes, every message distinct).

Arms (``--arm``): ``sidecar`` (the default) starts ``python -m tmtpu_torch
sidecar`` (tools/gpu_common.py ``Daemon``) and points ``tmtpu.crypto.batch``
at it (``configure_sidecar``, ``set_default_backend("sidecar")``, as
``light_bench.py --sidecar`` does); ``cpu`` runs the same scenarios in
process with ``crypto_backend=cpu``; ``both`` runs the two on one chain and
adds ``sequential_ratio`` (the daemon's blocks/s over the in-process
blocks/s). The process-wide signature cache of ``tmtpu`` is emptied before
each arm, as a fresh process of the reference's bench starts empty.

Each scenario prints one JSON line with the reference's keys (``heights``,
``value`` and ``unit``, ``provider_calls``, ``dispatches``, ``run``,
``wall_s``, ``sig_s``, ``backend``) and, per scenario, the daemon's
dispatches, lanes and ed25519 launches (from its Stats), the lanes that
fell back to in-process verification (``sidecar_client_fallback``),
``gen_s`` (fabrication, timed apart) and the card. Fabrication signs 4
precommits a height on the host; without the ``cryptography`` package that
is pure Python (~150 signatures a second a core), so the default height
then drops to 2,048 and every line says so in ``reduced``, as it does for
any ``--heights`` below the reference's 100,000.

The run fails (``"ok": false``, exit 1) if a lane fell back in process
(counted until the light client stops; the daemon stops last), if the
daemon did not exit 0 on SIGTERM, if JAX was loaded in this process, if a
scenario did not reach the tip, if the daemon's dispatches differ from the
client's requests, or, on the card, if a scenario launched no ed25519
kernel. The tool imports ``tmtpu`` and never ``tmtpu_torch``, ``torch`` or
``jax``. The combined object is the last line on stdout.

    python3 tools/gpu_light_bench.py [--heights 100000] [--run 1024] [--arm both]
    python3 tools/gpu_light_bench.py --device cpu --heights 32 --run 16 --arm both
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tmtpu.crypto import batch as crypto_batch  # noqa: E402
from tmtpu.crypto import sigcache as node_sigcache  # noqa: E402
from tmtpu.libs import breaker as _bk  # noqa: E402
from tmtpu.libs import metrics as _m  # noqa: E402
from tools.gpu_common import Daemon, launch_delta, smi_line  # noqa: E402

REFERENCE_HEIGHTS = 100_000  # light_bench.py's default
PURE_PYTHON_HEIGHTS = 2_048  # what pure-Python signing fabricates in minutes
N_VALS = 4
MAX_CLOCK_DRIFT_NS = 10_000_000_000  # light_bench.py's sequential scenario


def openssl_signing() -> bool:
    """Whether ``tmtpu``'s keys sign through the ``cryptography`` package."""
    try:
        import cryptography.hazmat.primitives.asymmetric.ed25519  # noqa: F401
    except ImportError:
        return False
    return True


def dispatch_count() -> int:
    """In-process batch dispatches plus sidecar round trips: every way a
    commit check can cost a dispatch (light_bench.py's count)."""
    n = sum(v["count"] for v in _m.crypto_batch_size.summary_series().values())
    n += sum(_m.sidecar_client_requests.summary_series().values())
    return int(n)


def _fallbacks() -> float:
    return sum(_m.sidecar_client_fallback.summary_series().values())


def bisection(chain, heights: int, now_ns: int, start) -> dict:
    """Scenario 1: skipping verification from height 1 to the tip.
    ``start()`` runs just before the timed part, after the client's set-up
    (which checks the trusted block)."""
    from tests.test_light import CHAIN_ID, WEEK_NS, ChainProvider
    from tmtpu.libs.db import MemDB
    from tmtpu.light.client import Client, TrustOptions
    from tmtpu.light.store import LightStore

    provider = ChainProvider(chain)
    c = Client(CHAIN_ID, TrustOptions(WEEK_NS, 1, chain.blocks[1].header.hash()),
               provider, [ChainProvider(chain, "w1")], LightStore(MemDB()))
    start()
    d0 = dispatch_count()
    t0 = time.perf_counter()
    lb = c.verify_light_block_at_height(heights, now_ns=now_ns)
    dt = time.perf_counter() - t0
    return {"metric": "light_bisection_sync", "heights": heights,
            "value": dt * 1e3, "unit": "ms", "provider_calls": provider.calls,
            "dispatches": dispatch_count() - d0, "run": None, "wall_s": dt,
            "sig_s": None, "reached_tip": lb.height() == heights}


def sequential(chain, heights: int, run: int, now_ns: int, start) -> dict:
    """Scenario 2: every header verified, each run of adjacent commits in
    one batch; ``start()`` runs just before it."""
    from tests.test_light import WEEK_NS
    from tmtpu.light.verifier import verify_adjacent_run

    trusted = chain.blocks[1]
    start()
    d0 = dispatch_count()
    t0 = time.perf_counter()
    h = 2
    verified = 0
    while h <= heights:
        blocks = [chain.blocks[i] for i in range(h, min(h + run, heights + 1))]
        n = verify_adjacent_run(trusted, blocks, WEEK_NS, now_ns, MAX_CLOCK_DRIFT_NS)
        verified += n
        if n < len(blocks):
            break
        trusted = blocks[-1]
        h += n
    dt = time.perf_counter() - t0
    return {"metric": "light_sequential_sync_fused", "heights": heights,
            "value": verified / dt, "unit": "blocks/s",
            "provider_calls": 0, "dispatches": dispatch_count() - d0, "run": run,
            "wall_s": dt, "sig_s": N_VALS * verified / dt,
            "headers_verified": verified, "reached_tip": verified == heights - 1}


def _coalesced(before: dict, after: dict) -> dict:
    c0, c1 = before["coalescer"], after["coalescer"]
    return {"daemon_dispatches": c1["dispatches"] - c0["dispatches"],
            "daemon_lanes": c1["dispatched_lanes"] - c0["dispatched_lanes"],
            "daemon_launches": launch_delta(before, after)["ed25519_verify"]}


def run_arm(arm: str, chain, heights: int, args) -> list:
    """Both scenarios on one arm; one dict a scenario."""
    node_sigcache.invalidate_all()
    now_ns = chain.blocks[heights].header.time + 1_000_000_000
    scenarios = (lambda start: bisection(chain, heights, now_ns, start),
                 lambda start: sequential(chain, heights, args.run, now_ns, start))
    if arm == "cpu":
        crypto_batch.set_default_backend("cpu")
        lines = [scenario(lambda: None) for scenario in scenarios]
        for line in lines:
            line.update(backend="cpu", arm="cpu")
        return lines

    from tmtpu.config.config import SidecarConfig

    fallback0 = _fallbacks()
    daemon = Daemon(args.device, extra_args=["--no-warm"] if args.device == "cpu" else [])
    print(f"gpu_light_bench: {daemon.ready.strip()} (ready in {daemon.start_s:.1f} s)",
          file=sys.stderr)
    # the reference's 10 s; a dispatch of the plain versions takes seconds
    deadline_s = 120.0 if args.device == "cpu" else 10.0
    lines = []
    try:
        crypto_batch.configure_sidecar(SidecarConfig(
            addr=daemon.addr, request_deadline_ns=int(deadline_s * 1e9)))
        crypto_batch.set_default_backend("sidecar")
        _bk.get(crypto_batch.SIDECAR_BREAKER_NAME).reset()
        for scenario in scenarios:
            marks = {}

            def start():
                marks.update(stats=daemon.stats(), fallback=_fallbacks())
            line = scenario(start)
            after = daemon.stats()
            line.update(_coalesced(marks["stats"], after), backend="sidecar", arm="sidecar",
                        fallback_lanes=_fallbacks() - marks["fallback"],
                        device=after["device"]["kind"] if after["backend"] == "gpu" else "cpu")
            lines.append(line)
    finally:
        # the light client is done before the daemon stops: nothing after
        # this point may verify in process
        crypto_batch.set_default_backend("cpu")
        crypto_batch.reset_sidecar_client()
        fallback = _fallbacks() - fallback0
        rc = daemon.stop()
    for line in lines:
        line.update(daemon_exit=rc, arm_fallback_lanes=fallback)
    return lines


def failures_of(lines: list) -> list:
    out = []
    for ln in lines:
        what = f"{ln['arm']} {ln['metric']}"
        if not ln["reached_tip"]:
            out.append(f"{what}: did not reach the tip")
        if ln["arm"] != "sidecar":
            continue
        if ln["arm_fallback_lanes"]:
            out.append(f"{ln['arm_fallback_lanes']:g} lanes fell back in process")
        if ln["daemon_exit"] != 0:
            out.append(f"the daemon exited {ln['daemon_exit']} on SIGTERM")
        if ln["daemon_dispatches"] != ln["dispatches"]:
            out.append(f"{what}: {ln['daemon_dispatches']} daemon dispatches for "
                       f"{ln['dispatches']} client requests")
        if ln["device"] != "cpu" and not ln["daemon_launches"]:
            out.append(f"{what}: no launch of ed25519_verify in the daemon")
    if "jax" in sys.modules:
        out.append("JAX was loaded in the light client's process")
    return list(dict.fromkeys(out))  # an arm's failures once, not once a scenario


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heights", type=int, default=None,
                    help=f"chain length (default {REFERENCE_HEIGHTS}; "
                         f"{PURE_PYTHON_HEIGHTS} where signing is pure Python)")
    ap.add_argument("--run", type=int, default=1024,
                    help="adjacent-run fused batch size (blocks a request)")
    ap.add_argument("--arm", default="sidecar", choices=("sidecar", "cpu", "both"))
    ap.add_argument("--device", default=None,
                    help="the daemon's device: default the CUDA card; cpu for tests")
    args = ap.parse_args(argv)
    openssl = openssl_signing()
    heights = args.heights or (REFERENCE_HEIGHTS if openssl else PURE_PYTHON_HEIGHTS)
    reduced = None
    if heights < REFERENCE_HEIGHTS:
        why = ("--heights" if args.heights else
               "signing is pure Python here (no cryptography package)")
        reduced = f"{heights} of the reference's {REFERENCE_HEIGHTS} heights: {why}"

    from tests.test_light import FabChain

    t0 = time.perf_counter()
    chain = FabChain(heights, n_vals=N_VALS)
    gen_s = time.perf_counter() - t0
    print(f"gpu_light_bench: fabricated {heights} heights ({N_VALS * heights} sigs, "
          f"{'OpenSSL' if openssl else 'pure Python'}) in {gen_s:.1f} s", file=sys.stderr)
    card = smi_line() if args.device != "cpu" else None
    arms = ("sidecar", "cpu") if args.arm == "both" else (args.arm,)
    lines = []
    for arm in arms:
        for line in run_arm(arm, chain, heights, args):
            line.update(gen_s=gen_s, reduced=reduced, card=card)
            print(json.dumps(line), flush=True)
            lines.append(line)
    failures = failures_of(lines)
    by_key = {(ln["arm"], ln["metric"]): ln for ln in lines}
    out = {"metric": "gpu_light_bench", "ok": not failures, "failures": failures,
           "heights": heights, "run": args.run, "reduced": reduced, "gen_s": gen_s,
           "arms": list(arms),
           "bisection_wall_s": {a: by_key[(a, "light_bisection_sync")]["wall_s"] for a in arms},
           "sequential_blocks_s": {a: by_key[(a, "light_sequential_sync_fused")]["value"]
                                   for a in arms},
           "card": card}
    if args.arm == "both":
        out["sequential_ratio"] = (out["sequential_blocks_s"]["sidecar"]
                                   / out["sequential_blocks_s"]["cpu"])
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
