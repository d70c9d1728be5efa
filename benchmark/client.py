"""One node's client: sends its requests to the daemon and times the replies.

    python3 benchmark/client.py

``run.py`` starts it and writes to its standard input one pickle (the
node's requests, each the pool entries of its lanes with its due time, and
the pool's encoded lanes), so nothing of it touches the disk. The client
builds every frame first, then reads one line ``addr <daemon address>``,
connects, prints ``ready``, and waits for one line ``start <t_start>
<t_stop>``: two ``time.perf_counter()`` readings (the system's monotonic
clock, shared by every process on the host), at which its schedule begins
and after which it sends nothing more. At the end it writes one pickle of
its records to standard output.

- ``open``: requests go out at their due times whatever the replies, on
  one connection, and replies are matched by request id (the daemon
  answers each request as its dispatch finishes).
- ``closed``: one request at a time, cycling the list, until ``t_stop``.

Every request records (due, sent, replied, status, mask, lane count,
tally, error). Nothing of the program is imported.
"""

from __future__ import annotations

import gc
import os
import pickle
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import wire  # noqa: E402

# after the last due time, how long an answer may take before it counts
# as never coming
REPLY_GRACE_S = 60.0


def split_blobs(offsets, data: bytes):
    """The encoded lanes of the pool, one bytes object an entry."""
    return [data[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def _record(rec, fields, now):
    rec["replied"] = now
    rec["status"] = fields["status"]
    rec["mask"] = fields["mask"]
    rec["lane_count"] = fields["lane_count"]
    rec["tallied"] = fields["tallied"]
    rec["error"] = fields["error"]


def run_open(sock, reader, frames, recs, t_start, t_stop):
    """Send each frame at its due time until ``t_stop``; a reader thread
    matches replies by request id."""
    import socket

    sent = []
    answered = [0]
    failure = []
    finished = threading.Event()

    def receive():
        try:
            while True:
                kind, fields = wire.decode_body(reader.read_body())
                if kind != wire.VERIFY_RESPONSE:
                    raise wire.WireError(f"unexpected reply type {kind}: {fields}")
                _record(recs[fields["request_id"] - 1], fields, time.perf_counter())
                answered[0] += 1
        except (OSError, EOFError, wire.WireError) as exc:
            if not finished.is_set():
                failure.append(repr(exc))

    rx = threading.Thread(target=receive, daemon=True)
    rx.start()
    for i, rec in enumerate(recs):
        due = t_start + rec["due"]
        if due >= t_stop:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec["sent"] = time.perf_counter()
        sock.sendall(frames[i])
        sent.append(i)
    give_up = time.perf_counter() + REPLY_GRACE_S
    while answered[0] < len(sent) and not failure and time.perf_counter() < give_up:
        time.sleep(0.005)
    finished.set()
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    rx.join(timeout=5.0)
    return failure


def run_closed(sock, reader, bodies, curve, deadline_ms, recs_out, t_start, t_stop):
    """One request at a time, cycling ``bodies``, from ``t_start`` until a
    send would fall at or after ``t_stop``."""
    wait = t_start - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    sock.settimeout(REPLY_GRACE_S)
    k = 0
    while True:
        now = time.perf_counter()
        if now >= t_stop:
            return []
        tally, kind, lanes, entries_ix = bodies[k % len(bodies)]
        frame = wire.verify_frame(k + 1, curve, tally, deadline_ms, lanes)
        rec = {"ix": entries_ix, "kind": kind, "due": now - t_start, "sent": now,
               "replied": None}
        recs_out.append(rec)
        try:
            sock.sendall(frame)
            kind_b, fields = wire.decode_body(reader.read_body())
        except (OSError, EOFError, wire.WireError) as exc:
            return [repr(exc)]
        if kind_b != wire.VERIFY_RESPONSE or fields["request_id"] != k + 1:
            return [f"unexpected reply {kind_b}: {fields}"]
        _record(rec, fields, time.perf_counter())
        k += 1


def main() -> int:
    stdin = sys.stdin.buffer
    job = pickle.load(stdin)
    blobs = split_blobs(job["offsets"], job["lanes"])
    del job["lanes"]
    curve, deadline_ms = job["curve"], job["deadline_ms"]
    reqs = job["requests"]
    if job["mode"] == "open":
        frames = [wire.verify_frame(i + 1, curve, r["tally"], deadline_ms,
                                    b"".join([blobs[e] for e in r["entries"].tolist()]))
                  for i, r in enumerate(reqs)]
        recs = [{"ix": i, "kind": r["kind"], "due": r["due"], "sent": None, "replied": None}
                for i, r in enumerate(reqs)]
    else:
        bodies = [(r["tally"], r["kind"], b"".join([blobs[e] for e in r["entries"].tolist()]), i)
                  for i, r in enumerate(reqs)]
        recs = []
    del blobs
    line = stdin.readline().decode().split()
    if len(line) != 2 or line[0] != "addr":
        raise SystemExit(f"client: expected 'addr <daemon address>', got {line}")
    sock, reader = wire.connect(line[1], job["client_id"])
    print("ready", flush=True)
    line = stdin.readline().decode().split()
    if len(line) != 3 or line[0] != "start":
        raise SystemExit(f"client: expected 'start <t_start> <t_stop>', got {line}")
    t_start, t_stop = float(line[1]), float(line[2])
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        if job["mode"] == "open":
            failure = run_open(sock, reader, frames, recs, t_start, t_stop)
        else:
            failure = run_closed(sock, reader, bodies, curve, deadline_ms, recs,
                                 t_start, t_stop)
    finally:
        gc.enable()
        sock.close()
    modules = sorted({m.split(".")[0] for m in sys.modules})
    pickle.dump({"records": recs, "t_start": t_start, "failure": failure,
                 "modules": modules}, sys.stdout.buffer)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
