"""Command line of the port: ``python -m tmtpu_torch sidecar``.

``sidecar`` runs the verification daemon on the CUDA card (the port of
``python -m tmtpu sidecar``): one process owns the card and serves batched
verify, and verify + tally, to every tmtpu node on the host that sets
``crypto_backend=sidecar`` and points at the same address.

It reads ``<--home>/config/config.toml`` as the reference does
(``config.py``: the ``[sidecar]`` section and the ``[crypto]`` signature
cache, each key with its ``TMTPU_<SECTION>_<FIELD>`` override): the
address is ``--addr``, else ``[sidecar] addr``, else
``<--home>/data/sidecar.sock``; the lane caps, frame cap, request deadline
(10 s by default), ``warm_on_start``, ``health_laddr`` and the cache's
knobs come from the file, and a flag, when given, wins over it. The
daemon serves one card: ``[sidecar] mesh_devices`` and ``shard_min_lanes``
are read but not applied (``config.py``). On a host with several cards,
run one daemon a card.

By default it warms up first (builds the kernels and the C host prep,
verifies one self-signed batch of each curve), then prints one ready line
with the warm-up seconds and the card. ``--health-laddr host:port`` (or
``[sidecar] health_laddr``) serves ``/healthz`` and ``/metrics``; port 0
takes a free one, shown on the ready line. SIGTERM drains (new requests
are answered OVERLOADED, dispatches in flight finish) and stops, exit 0;
SIGINT stops at once.

    python -m tmtpu_torch sidecar --home ~/.tmtpu
    python -m tmtpu_torch sidecar --addr unix:///tmp/tmtpu-sidecar.sock --health-laddr 127.0.0.1:26670
    python -m tmtpu_torch sidecar --addr tcp://127.0.0.1:0 --device cpu --no-warm
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

# grace over a request's deadline for the drain at SIGTERM
DRAIN_GRACE_S = 5.0


def _pick(flag, value):
    return value if flag is None else flag


def cmd_sidecar(args) -> int:
    from tmtpu_torch import config
    from tmtpu_torch import device as device_mod
    from tmtpu_torch.crypto import sigcache
    from tmtpu_torch.sidecar.client import default_addr
    from tmtpu_torch.sidecar.server import SidecarServer

    home = os.path.expanduser(args.home)
    settings = config.load(home)
    sc, cr = settings.sidecar, settings.crypto
    # [sidecar] addr carries TMTPU_SIDECAR_ADDR already (config.load)
    addr = args.addr or sc.addr
    if not addr:
        addr = default_addr(home)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
    sigcache.configure(cr.sigcache_max_entries, cr.sigcache_shards, cr.sigcache_enable)
    if args.no_sigcache:
        sigcache.DEFAULT.set_enabled(False)
    deadline_s = sc.request_deadline_ns / 1e9
    server = SidecarServer(addr, device=args.device,
                           max_queue_lanes=_pick(args.max_queue_lanes, sc.max_queue_lanes),
                           max_lanes_per_dispatch=_pick(args.max_lanes,
                                                        sc.max_lanes_per_dispatch),
                           max_frame_bytes=sc.max_frame_bytes,
                           request_deadline_s=deadline_s,
                           health_laddr=_pick(args.health_laddr, sc.health_laddr),
                           failure_threshold=cr.breaker_failure_threshold)
    if args.gather_ms is not None:
        server.coalescer.scheduler.fixed_wait_s = args.gather_ms / 1000.0
    warm_s = server.warm() if sc.warm_on_start and not args.no_warm else 0.0
    stop, term = [], []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: term.append(1))
    server.start()
    dev = device_mod.describe(server.device)
    health = f" health={server.health_laddr}" if server.health_laddr else ""
    print(f"Sidecar listening on {server.addr} backend={server.backend_name()} "
          f"device={dev['kind']} warm_s={warm_s:.3f} sigcache="
          f"{'on' if sigcache.DEFAULT.enabled() else 'off'} id={server.server_id}{health}",
          flush=True)
    try:
        while not stop and not term:
            time.sleep(0.2)
        if term and not stop:
            print("SIGTERM: draining (new requests get OVERLOADED)...", flush=True)
            clean = server.drain(timeout=deadline_s + DRAIN_GRACE_S)
            print("Drain complete" if clean else "Drain timed out; stopping anyway",
                  flush=True)
    finally:
        server.stop()
        print("Sidecar stopped", flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tmtpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("sidecar", help="run the verification daemon on the card")
    sp.add_argument("--addr", default="",
                    help="unix:///path/to.sock or tcp://host:port (port 0: any free one)")
    sp.add_argument("--home", default=os.environ.get("TMHOME", "~/.tmtpu"),
                    help="the home whose config/config.toml is read and whose "
                         "data/sidecar.sock is the default address")
    sp.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default: the CUDA card")
    sp.add_argument("--no-warm", action="store_true",
                    help="skip building and warming the kernels before listening "
                         "(as [sidecar] warm_on_start = false)")
    sp.add_argument("--max-lanes", type=int, default=None,
                    help="lanes per request and soft cap per joint dispatch "
                         "(default: [sidecar] max_lanes_per_dispatch, 40960)")
    sp.add_argument("--max-queue-lanes", type=int, default=None,
                    help="admission control: queued lanes before OVERLOADED "
                         "(default: [sidecar] max_queue_lanes, 65536)")
    sp.add_argument("--health-laddr", default=None,
                    help="host:port for /healthz and /metrics (default: [sidecar] "
                         "health_laddr; empty: none)")
    sp.add_argument("--gather-ms", type=float, default=None,
                    help="a fixed gather window in place of the adaptive one")
    sp.add_argument("--no-sigcache", action="store_true",
                    help="switch the signature cache off (no hits, no dedup)")
    sp.set_defaults(fn=cmd_sidecar)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
