"""Mesh-dispatch A/B on the 4-node localnet against the port's sidecar
daemon: the twin of tools/localnet_mesh_ab.py.

The same real-TCP kvstore network (tools/ab_common.py ``make_localnet``,
``run_window``: boot to height 2, open-loop load, one measured window),
every node with ``crypto_backend=sidecar`` pointing at one ``python -m
tmtpu_torch sidecar`` process (tools/gpu_common.py ``Daemon``), run twice
with the same window and load; only the daemon's mesh knobs differ, the
reference's at localnet_mesh_ab.py:122-127:

- A (``single_device``): ``--mesh-devices 1``, the mesh off;
- B (``mesh``): ``--mesh-devices N --shard-min-lanes 1`` (N = 4 by
  default), so consensus-sized flushes split too.

From the daemon's Stats over each window: blocks, block rate, dispatches,
lanes, mesh dispatches (``coalescer.mesh_dispatches``), the shards' lanes
(``mesh.occupancy_lanes``) and ed25519 launches; from this process the
lanes that fell back to in-process verification
(``sidecar_client_fallback``, counted until the nodes have stopped; the
daemon stops last). Derived: ``block_rate_ratio`` (B over A),
``mesh_dispatch_share`` (B's mesh dispatches over its dispatches) and
``single_arm_mesh_dispatches`` (must be 0).

Where the port departs from the reference: the reference pads a sharded
flush to 32 x n lanes so every chip holds an equal share, and checks
``occupancy_balanced``. The port's shards hold whole bitarray words and no
pad lanes (``gpu/sharding.py::shard_bounds``), so a consensus flush of ~8
lanes lands on one shard and equal occupancy would be false by design.
In its place the tool checks what the port guarantees on every split it
samples from Stats during B's window (``mesh.last``): every shard but the
last non-empty one is a multiple of 32 lanes, and the shards' lanes sum to
the dispatch's lanes (``shards_ok``). The same cause puts every
consensus-sized split (under 32 lanes) wholly on the first device, so arm
B measures the cost of the mesh route, not work spread over several
cards; ``devices_with_lanes`` (the devices whose occupancy rose in B's
window) says how many received lanes, and a reader takes the ratio as a
cross-card measurement only where it is above 1.

A split needs two or more cards: on a host with fewer, ``--device cuda``
(the default) exits 2 with that reason as soon as arm A's daemon reports
the count, and never runs arm B as a copy of arm A. ``--device cpu
--mesh-devices 4`` runs four CPU shards of the plain versions, the
counterpart of the reference's 4 virtual XLA:CPU devices.

The run fails (``"ok": false``, exit 1) on any fallback lane, a daemon
that does not exit 0, a window without a daemon dispatch, a mesh dispatch
in A, none in B, a sampled split that breaks the guarantee, a JAX load in
this process, or, on the card, no ed25519 launch. As in the reference, a
window without a block is reported, not failed (``block_rate_ratio`` is
then null): on the CPU a block takes several plain-version dispatches of
seconds each, and what the A/B checks is the routing. The tool imports
``tmtpu`` and never ``tmtpu_torch``, ``torch`` or ``jax``. One JSON line
per arm on stderr, the combined object last on stdout.

    python3 tools/gpu_localnet_mesh_ab.py [window_seconds] [--mesh-devices 4]
    python3 tools/gpu_localnet_mesh_ab.py 10 --device cpu --mesh-devices 4
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tmtpu.crypto import batch as crypto_batch  # noqa: E402
from tmtpu.libs import breaker as _bk  # noqa: E402
from tmtpu.libs import metrics as _m  # noqa: E402
from tools import ab_common  # noqa: E402
from tools.gpu_common import Daemon, launch_delta, smi_line  # noqa: E402

CHAIN_ID = "gpu-mesh-ab-chain"
STATS_EVERY_S = 0.25  # how often arm B samples the daemon's last split


class TooFewCards(RuntimeError):
    """The daemon's host has fewer than two cards: no split to measure."""


def shards_ok(last: dict) -> bool:
    """The port's guarantee for one split: whole 32-lane words on every
    shard but the last non-empty one, and no lane lost or added."""
    sizes = [s for s in last["shard_lanes"] if s]
    return (sum(sizes) == last["lanes"] and bool(sizes)
            and all(s % 32 == 0 for s in sizes[:-1]))


def _nodes(tmp, addr, deadline_ns):
    def configure(cfg, _i):
        cfg.base.crypto_backend = "sidecar"
        cfg.sidecar.addr = addr
        if deadline_ns:
            cfg.sidecar.request_deadline_ns = deadline_ns

    return ab_common.make_localnet(4, tmp, CHAIN_ID, configure=configure)


def run_arm(name, mesh_devices, shard_min_lanes, window_s, device, boot_s) -> dict:
    """One arm: a fresh daemon with the arm's knobs, the net on it."""
    knobs = ["--mesh-devices", str(mesh_devices), "--shard-min-lanes", str(shard_min_lanes)]
    # the warm-up builds the kernels on the card; on the CPU it only costs seconds
    daemon = Daemon(device, extra_args=knobs + (["--no-warm"] if device == "cpu" else []))
    deadline_ns = int(120e9) if device == "cpu" else 0
    br = _bk.get(crypto_batch.SIDECAR_BREAKER_NAME)
    nodes = []
    marks = {}
    splits = {}
    sampling = threading.Event()
    try:
        first = daemon.stats()
        if device != "cpu" and first["device"]["count"] < 2:
            raise TooFewCards(f"the mesh arm needs two or more cards; the daemon sees "
                              f"{first['device']['count']}")
        nodes = _nodes(pathlib.Path(daemon.home), daemon.addr, deadline_ns)
        assert crypto_batch._default_backend == "sidecar", \
            "node construction did not select the sidecar backend"
        br.reset()

        def sample():
            while not sampling.wait(STATS_EVERY_S):
                last = daemon.stats()["mesh"]["last"]
                if last:
                    splits[last["seq"]] = last

        sampler = threading.Thread(target=sample, daemon=True)

        def reset():
            marks["stats"] = daemon.stats()
            marks["fallback"] = ab_common.counter_value(_m.sidecar_client_fallback)
            sampler.start()

        blocks, wall = ab_common.run_window(nodes, window_s, reset, prefix=b"gmab",
                                            warm_timeout_s=boot_s)
        stats = daemon.stats()
        sampling.set()
        sampler.join(timeout=30)
    finally:
        sampling.set()
        # the nodes stop before the daemon, so none of their last flushes
        # finds it gone and verifies in process
        for nd in nodes:
            nd.stop()
        fallback = (ab_common.counter_value(_m.sidecar_client_fallback)
                    - marks.get("fallback", 0))
        crypto_batch.set_default_backend("cpu")
        crypto_batch.reset_sidecar_client()
        rc = daemon.stop()
    c0, c1 = marks["stats"]["coalescer"], stats["coalescer"]
    dispatches = c1["dispatches"] - c0["dispatches"]
    mesh_dispatches = c1["mesh_dispatches"] - c0["mesh_dispatches"]
    occ0 = marks["stats"]["mesh"]["occupancy_lanes"]
    occupancy = {d: v - occ0.get(d, 0) for d, v in stats["mesh"]["occupancy_lanes"].items()}
    return {
        "arm": name,
        "mesh_devices": mesh_devices,
        "shard_min_lanes": shard_min_lanes,
        "window_s": wall,
        "blocks": blocks,
        "block_rate_per_min": blocks / wall * 60,
        "dispatches": dispatches,
        "lanes": c1["dispatched_lanes"] - c0["dispatched_lanes"],
        "lanes_per_block": (c1["dispatched_lanes"] - c0["dispatched_lanes"]) / max(1, blocks),
        "mesh_dispatches": mesh_dispatches,
        "mesh_dispatch_share": mesh_dispatches / max(1, dispatches),
        "occupancy_lanes": occupancy,
        "devices_with_lanes": sum(1 for v in occupancy.values() if v > 0),
        "splits_sampled": len(splits),
        "split_shard_lanes": sorted({tuple(s["shard_lanes"]) for s in splits.values()}),
        "shards_ok": all(shards_ok(s) for s in splits.values()),
        "launches": launch_delta(marks["stats"], stats),
        "fallback_lanes": fallback,
        "breaker_state": br.state,
        "daemon_exit": rc,
        "device": stats["device"]["kind"] if stats["backend"] == "gpu" else "cpu",
        "cards": stats["device"]["count"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("window", type=float, nargs="?", default=20.0,
                    help="seconds of the measured window of each arm")
    ap.add_argument("--mesh-devices", type=int, default=4,
                    help="arm B's --mesh-devices (cards; on the CPU, CPU shards)")
    ap.add_argument("--device", default=None,
                    help="the daemon's device: default the CUDA card; cpu for tests")
    args = ap.parse_args(argv)
    # the reference's 120 s to reach height 2; the plain versions take seconds a dispatch
    boot_s = 300.0 if args.device == "cpu" else 120.0
    report = ab_common.ABReport("gpu_localnet_mesh_ab")
    try:
        single = report.add_arm(run_arm("single_device", 1, 1, args.window, args.device,
                                        boot_s))
        mesh = report.add_arm(run_arm("mesh", args.mesh_devices, 1, args.window,
                                      args.device, boot_s))
    except TooFewCards as exc:
        print(f"gpu_localnet_mesh_ab: {exc}", file=sys.stderr)
        return 2
    on_card = mesh["device"] != "cpu"
    failures = []
    for arm in (single, mesh):
        if arm["fallback_lanes"]:
            failures.append(f"{arm['arm']}: {arm['fallback_lanes']:g} lanes fell back "
                            f"to in-process verification")
        if arm["daemon_exit"] != 0:
            failures.append(f"{arm['arm']}: the daemon exited {arm['daemon_exit']} on SIGTERM")
        if not arm["dispatches"]:
            failures.append(f"{arm['arm']}: no daemon dispatch in the window")
        if on_card and not arm["launches"]["ed25519_verify"]:
            failures.append(f"{arm['arm']}: no launch of ed25519_verify in the daemon")
    if single["mesh_dispatches"]:
        failures.append(f"single_device: {single['mesh_dispatches']} mesh dispatches")
    if not mesh["mesh_dispatches"]:
        failures.append("mesh: no dispatch went across the mesh")
    if not mesh["shards_ok"] or not mesh["splits_sampled"]:
        failures.append(f"mesh: sampled splits {mesh['split_shard_lanes']} break the "
                        f"port's shard guarantee")
    if "jax" in sys.modules:
        failures.append("JAX was loaded in the nodes' process")
    report.finish(
        ok=not failures, failures=failures,
        mesh_dispatch_share=mesh["mesh_dispatch_share"],
        single_arm_mesh_dispatches=single["mesh_dispatches"],
        block_rate_ratio=(mesh["block_rate_per_min"] / single["block_rate_per_min"]
                          if single["blocks"] else None),
        occupancy_lanes=mesh["occupancy_lanes"],
        devices_with_lanes=mesh["devices_with_lanes"],
        shards_ok=mesh["shards_ok"],
        card=smi_line() if on_card else None)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
