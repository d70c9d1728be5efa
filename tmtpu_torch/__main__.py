"""Command line of the port: ``python -m tmtpu_torch sidecar``.

``sidecar`` runs the verification daemon on the CUDA card (the port of
``python -m tmtpu sidecar``): one process owns the card and serves batched
verify, and verify + tally, to every tmtpu node on the host that sets
``crypto_backend=sidecar`` and points at the same address. The address
comes from ``--addr``, else ``TMTPU_SIDECAR_ADDR``, else
``<--home>/data/sidecar.sock``. By default it warms up first (builds the
kernels and the C host prep, verifies one self-signed batch of each
curve), then prints one ready line with the warm-up seconds and the card.
SIGTERM drains (new requests are answered OVERLOADED, dispatches in flight
finish) and stops, exit 0; SIGINT stops at once.

    python -m tmtpu_torch sidecar --addr unix:///tmp/tmtpu-sidecar.sock
    python -m tmtpu_torch sidecar --addr tcp://127.0.0.1:0 --device cpu --no-warm
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

# a request's default deadline (30 s) plus grace for its reply
DRAIN_TIMEOUT_S = 35.0


def cmd_sidecar(args) -> int:
    from tmtpu_torch import device as device_mod
    from tmtpu_torch.crypto import sigcache
    from tmtpu_torch.sidecar.client import ENV_ADDR, default_addr
    from tmtpu_torch.sidecar.server import SidecarServer

    home = os.path.expanduser(args.home)
    addr = args.addr or default_addr(home)
    if not args.addr and not os.environ.get(ENV_ADDR):
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
    if args.no_sigcache:
        sigcache.DEFAULT.set_enabled(False)
    server = SidecarServer(addr, device=args.device,
                           max_queue_lanes=args.max_queue_lanes,
                           max_lanes_per_dispatch=args.max_lanes)
    if args.gather_ms is not None:
        server.coalescer.scheduler.fixed_wait_s = args.gather_ms / 1000.0
    warm_s = 0.0 if args.no_warm else server.warm()
    stop, term = [], []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: term.append(1))
    server.start()
    dev = device_mod.describe(server.device)
    print(f"Sidecar listening on {server.addr} backend={server.backend_name()} "
          f"device={dev['kind']} warm_s={warm_s:.3f} sigcache="
          f"{'on' if sigcache.DEFAULT.enabled() else 'off'} id={server.server_id}",
          flush=True)
    try:
        while not stop and not term:
            time.sleep(0.2)
        if term and not stop:
            print("SIGTERM: draining (new requests get OVERLOADED)...", flush=True)
            clean = server.drain(timeout=DRAIN_TIMEOUT_S)
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
                    help="the home whose data/sidecar.sock is the default address")
    sp.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default: the CUDA card")
    sp.add_argument("--no-warm", action="store_true",
                    help="skip building and warming the kernels before listening")
    sp.add_argument("--max-lanes", type=int, default=40960,
                    help="lanes per request and soft cap per joint dispatch")
    sp.add_argument("--max-queue-lanes", type=int, default=65536,
                    help="admission control: queued lanes before OVERLOADED")
    sp.add_argument("--gather-ms", type=float, default=None,
                    help="a fixed gather window in place of the adaptive one")
    sp.add_argument("--no-sigcache", action="store_true",
                    help="switch the signature cache off (no hits, no dedup)")
    sp.set_defaults(fn=cmd_sidecar)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
