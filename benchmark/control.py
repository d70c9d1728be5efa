"""The control: a stand-in daemon that breaks one guarantee, and a run with it.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s> [--fault F]

runs ``run.py``'s whole run with this file's ``--serve`` in the daemon's
place. The stand-in speaks the sidecar wire protocol (Hello, VerifyRequest,
Stats) and answers each request at once, one dispatch a request:

- ``accept_all`` (the control): every lane valid, every power tallied, no
  signature checked: the configuration's guarantee that every lane's
  verdict is its own signature's is broken. Its run must read not correct.
- ``flip_one``: each lane checked (OpenSSL, through ``cryptography``),
  then the first lane's verdict of each reply inverted: an answer altered
  where it is produced.
- ``drop_half``: each lane checked, but only the first half of each
  request's lanes answered, the tally over them: half of the batch left out.
- ``none``: each lane checked and answered; a sound stand-in.

The benchmark's own runs never start it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import tomllib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import wire  # noqa: E402
from benchmark.wire import _bytes_field, _frame, _read_uvarint, _varint_field  # noqa: E402

FAULTS = ("accept_all", "flip_one", "drop_half", "none")


def decode_verify_request(body: bytes):
    """(request_id, curve, tally, lanes of (pk, msg, sig, power))."""
    if not body or body[0] != wire.VERIFY_REQUEST:
        raise wire.WireError("not a VerifyRequest")
    fields = {1: 0, 2: b"", 3: 0}
    lanes = []
    pos = 1
    while pos < len(body):
        key, pos = _read_uvarint(body, pos)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            value, pos = _read_uvarint(body, pos)
        else:
            n, pos = _read_uvarint(body, pos)
            value, pos = body[pos:pos + n], pos + n
        if fn == 5:
            lane = {1: b"", 2: b"", 3: b"", 4: 0}
            p = 0
            while p < len(value):
                k, p = _read_uvarint(value, p)
                if k & 7 == 0:
                    v, p = _read_uvarint(value, p)
                    v = v - (1 << 64) if v >= 1 << 63 else v
                else:
                    m, p = _read_uvarint(value, p)
                    v, p = value[p:p + m], p + m
                lane[k >> 3] = v
            lanes.append((lane[1], lane[2], lane[3], lane[4]))
        else:
            fields[fn] = value
    return fields[1], fields[2].decode(), bool(fields[3]), lanes


def _check(pk: bytes, msg: bytes, sig: bytes) -> bool:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    try:
        Ed25519PublicKey.from_public_bytes(pk).verify(sig, msg)
        return True
    except (InvalidSignature, ValueError):
        return False


def answer(fault: str, lanes):
    """(mask, tallied) of one request under ``fault``."""
    if fault == "accept_all":
        mask = [True] * len(lanes)
    else:
        mask = [_check(pk, m, s) for pk, m, s, _ in lanes]
    if fault == "flip_one" and mask:
        mask[0] = not mask[0]
    if fault == "drop_half":
        mask = mask[:len(lanes) // 2]
    return mask, sum(p for (_, _, _, p), ok in zip(lanes, mask) if ok)


def response_frame(request_id: int, mask, tallied: int, dispatch: int) -> bytes:
    packed = bytearray((len(mask) + 7) // 8)
    for i, ok in enumerate(mask):
        if ok:
            packed[i >> 3] |= 1 << (i & 7)
    payload = (_varint_field(1, request_id) + _bytes_field(3, bytes(packed))
               + _varint_field(4, len(mask)) + _varint_field(5, tallied)
               + _varint_field(6, dispatch) + _varint_field(7, len(mask))
               + _varint_field(8, 1))
    return _frame(wire.VERIFY_RESPONSE, payload)


STATS = {"sigcache": {"hits": 0, "misses": 0},
         "coalescer": {"dispatches": 0, "dispatched_lanes": 0, "queued_lanes": 0}}


def serve(args) -> int:
    with open(os.path.join(args.home, "config", "config.toml"), "rb") as fh:
        addr = tomllib.load(fh)["sidecar"]["addr"]
    family, target = wire.parse_addr(addr)
    lsock = socket.socket(family, socket.SOCK_STREAM)
    lsock.bind(target)
    lsock.listen(64)
    if family == socket.AF_INET:
        addr = f"tcp://{target[0]}:{lsock.getsockname()[1]}"
    lock = threading.Lock()
    stop = threading.Event()

    def conn_loop(conn):
        reader = wire.FrameSocket(conn)
        try:
            reader.read_body()  # Hello
            conn.sendall(_frame(wire.HELLO_ACK, _varint_field(1, 2) + _bytes_field(3, b"gpu")))
            while True:
                body = reader.read_body()
                if body[0] == wire.STATS_REQUEST:
                    with lock:
                        stats = json.dumps(STATS).encode()
                    conn.sendall(_frame(wire.STATS_RESPONSE, _bytes_field(1, stats)))
                    continue
                rid, _curve, tally, lanes = decode_verify_request(body)
                mask, tallied = answer(args.fault, lanes)
                with lock:
                    STATS["coalescer"]["dispatches"] += 1
                    STATS["coalescer"]["dispatched_lanes"] += len(lanes)
                    STATS["sigcache"]["misses"] += len(lanes)
                    n = STATS["coalescer"]["dispatches"]
                conn.sendall(response_frame(rid, mask, tallied if tally else 0, n))
        except (OSError, EOFError, wire.WireError):
            pass
        finally:
            conn.close()

    def accept_loop():
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            threading.Thread(target=conn_loop, args=(conn,), daemon=True).start()

    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    threading.Thread(target=accept_loop, daemon=True).start()
    print(f"Sidecar listening on {addr} backend=gpu device=control warm_s=0.000", flush=True)
    stop.wait()
    lsock.close()
    report = {"rc": 0, "kind": "control", "count": args.chips, "visible": 0,
              "memory_peak_bytes": 0,
              "modules": sorted({m.split(".")[0] for m in sys.modules})}
    with open(os.path.join(args.out, "daemon.json"), "w") as fh:
        json.dump(report, fh)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--fault", choices=FAULTS, default="accept_all")
    ap.add_argument("--serve", action="store_true", help="be the stand-in daemon")
    ap.add_argument("--home")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--device")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)
    if args.serve:
        return serve(args)
    from benchmark import run

    host = [sys.executable, os.path.abspath(__file__), "--serve", "--fault", args.fault]
    return run.run(argparse.Namespace(workload=args.workload, seed=args.seed,
                                      seconds=args.seconds, trace=0), host=host)


if __name__ == "__main__":
    sys.exit(main())
