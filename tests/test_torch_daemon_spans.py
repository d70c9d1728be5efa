"""The spans of a request's path through the port's sidecar daemon on the
CPU (tmtpu_torch/sidecar/): ``sidecar.recv``, ``sidecar.decode``,
``sidecar.admit``, ``coalescer.queue_wait``, ``coalescer.dispatch`` with
the flush's spans under it, ``sidecar.handoff`` and ``sidecar.reply``, and
``trace.record``, which records a wait whose ends lie on two threads.

Two clients send one request each over raw connections into one joint
dispatch (a fixed gather window); one of them repeats its request, all
valid lanes, which the signature cache answers whole; then the same two
requests go again, on an emptied cache, with tracing off. The daemon runs
the plain versions, seconds a dispatch, so requests stay at a few lanes."""

import io
import socket
import threading
import time

import pytest

from tests.test_torch_sidecar import DEADLINE_S, _connect_raw, _fix_window, _lanes
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.libs import trace
from tmtpu_torch.sidecar import protocol as proto
from tmtpu_torch.sidecar.server import SidecarServer

CLIENTS = {"alpha": _lanes(3, bad={1}, tag=b"spans-a"), "beta": _lanes(2, tag=b"spans-b")}
REQUEST_IDS = {"alpha": 7, "beta": 11}
PATH = ("sidecar.recv", "sidecar.decode", "sidecar.admit", "coalescer.queue_wait",
        "sidecar.handoff", "sidecar.reply")
EPS = 1e-9
# a thread stamps a span's end after the reply is on its way (the reply
# thread after its send returns, the dispatcher after the wake-ups), and
# the reader may see the reply before that thread runs again: under 1 ms
# on a loaded CPU, at most 2.9 ms on the H100's host
END_SLACK_S = 0.03


def _frame(name):
    cols = [list(c) for c in zip(*CLIENTS[name])]
    return proto.encode_verify_frame(REQUEST_IDS[name], "ed25519", True, 0, *cols)


def _send(addr, name, barrier=None):
    """One request on a fresh raw connection: (reply, perf_counter before
    the send, perf_counter after the reply was read)."""
    s = _connect_raw(addr)
    s.settimeout(DEADLINE_S)
    try:
        proto.write_frame(s.makefile("wb"), proto.Hello(version=2, client_id=name))
        rd = proto.FrameReader(s.makefile("rb"))
        assert isinstance(rd.read_msg(), proto.HelloAck)
        frame = _frame(name)
        if barrier is not None:
            barrier.wait(timeout=30)
        sent = time.perf_counter()
        s.sendall(frame)
        reply = rd.read_msg()
        return reply, sent, time.perf_counter()
    finally:
        s.close()


def _both_clients(addr):
    out = {}
    barrier = threading.Barrier(len(CLIENTS))

    def run(name):
        out[name] = _send(addr, name, barrier)

    threads = [threading.Thread(target=run, args=(name,)) for name in CLIENTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * DEADLINE_S)
        assert not t.is_alive()
    return out


def _inside(spans, sent, replied, drained, late_ends=("sidecar.reply",)):
    """Every span within [sent, replied]; the ends of ``late_ends`` spans
    within their slack of ``replied`` and before ``drained``, a reading
    taken once the spans were read off the ring."""
    for sp in spans:
        end = replied + (END_SLACK_S if sp.name in late_ends else 0.0)
        assert sent - EPS <= sp.start_s <= replied + EPS, sp
        assert sp.end_s <= min(end, drained) + EPS, sp


def _answer(reply):
    return (reply.request_id, reply.status, reply.mask, reply.lane_count, reply.tallied,
            reply.dispatch_lanes, reply.dispatch_clients)


@pytest.fixture(scope="module")
def daemon_run(tmp_path_factory):
    """The spans and replies of the three phases on one daemon."""
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    addr = f"unix://{tmp_path_factory.mktemp('spans')}/d.sock"
    srv = SidecarServer(addr, device="cpu")
    srv.start()
    _fix_window(srv, 0.5)
    try:
        trace.drain()
        joint = _both_clients(srv.addr)
        time.sleep(0.2)  # the reply threads record after their send
        joint_spans = trace.drain()
        joint_drained = time.perf_counter()
        repeat = _send(srv.addr, "beta")
        time.sleep(0.2)
        repeat_spans = trace.drain()
        repeat_drained = time.perf_counter()
        sigcache.DEFAULT.invalidate_all()
        trace.set_enabled(False)
        try:
            untraced = _both_clients(srv.addr)
            time.sleep(0.2)
        finally:
            trace.set_enabled(True)
        untraced_spans = trace.drain()
    finally:
        srv.stop()
        sigcache.DEFAULT.invalidate_all()
    return {"joint": (joint, joint_spans), "repeat": (repeat, repeat_spans),
            "untraced": (untraced, untraced_spans),
            "drained": {"joint": joint_drained, "repeat": repeat_drained}}


def _of_request(spans, name):
    return [sp for sp in spans if sp.attrs.get("client") == name
            and sp.attrs.get("request_id") == REQUEST_IDS[name]]


@pytest.mark.parametrize("name", sorted(CLIENTS))
def test_each_request_records_its_path(daemon_run, name):
    (replies, spans) = daemon_run["joint"]
    reply = replies[name][0]
    mine = {sp.name: sp for sp in _of_request(spans, name)}
    assert sorted(mine) == sorted(PATH)
    lanes = len(CLIENTS[name])
    body = len(proto.FrameReader(io.BytesIO(_frame(name))).read_body())
    assert mine["sidecar.recv"].attrs["bytes"] == body
    assert mine["sidecar.decode"].attrs == {"bytes": body, "client": name, "lanes": lanes,
                                            "request_id": REQUEST_IDS[name], "walk": "native"}
    assert mine["sidecar.admit"].attrs["lanes"] == lanes
    assert mine["sidecar.reply"].attrs["lanes"] == lanes
    assert mine["sidecar.reply"].attrs["bytes"] == len(proto.encode_frame(reply))
    wait = mine["coalescer.queue_wait"]
    assert wait.attrs["lanes"] == lanes and wait.attrs["dispatch_id"] == reply.dispatch_id
    # the fixed window lingers, and the linger is part of the wait
    assert 0 < wait.attrs["linger_ms"] <= wait.duration_s * 1e3 + EPS
    order = [mine[n] for n in PATH]
    assert all(a.start_s <= b.start_s for a, b in zip(order, order[1:]))
    assert reply.status == proto.STATUS_OK


def test_one_dispatch_holds_both_requests_and_the_flush(daemon_run):
    (replies, spans) = daemon_run["joint"]
    (dispatch,) = [sp for sp in spans if sp.name == "coalescer.dispatch"]
    ids = {name: r[0].dispatch_id for name, r in replies.items()}
    assert set(ids.values()) == {dispatch.attrs["dispatch_id"]}
    assert dispatch.attrs == {"dispatch_id": ids["alpha"], "lanes": 5, "requests": 2,
                              "clients": 2}
    by_id = {sp.span_id: sp for sp in spans}

    def under_dispatch(sp):
        while sp.parent_id is not None:
            sp = by_id[sp.parent_id]
        return sp is dispatch

    engine = [sp for sp in spans if sp.name in (
        "sigcache.resolve", "crypto.batch_verify_tally", "ed25519.execute",
        "sigcache.insert", "crypto.pack_words")]
    # the daemon replies with masks: nothing reads the bitarray, so nothing packs it
    assert sorted(sp.name for sp in engine) == sorted((
        "sigcache.resolve", "crypto.batch_verify_tally", "ed25519.execute",
        "sigcache.insert"))
    assert all(under_dispatch(sp) for sp in engine)
    resolve = next(sp for sp in engine if sp.name == "sigcache.resolve")
    # two requests' columns joined into one buffer by the coalescer
    assert resolve.attrs == {"lanes": 5, "hits": 0, "columns": "view"}
    # the one invalid lane is not inserted
    assert next(sp for sp in engine if sp.name == "sigcache.insert").attrs == {"lanes": 4}
    for sp in engine:
        assert dispatch.start_s <= sp.start_s and sp.end_s <= dispatch.end_s
    for name in replies:
        (handoff,) = [sp for sp in _of_request(spans, name) if sp.name == "sidecar.handoff"]
        assert dispatch.start_s <= handoff.start_s <= dispatch.end_s


@pytest.mark.parametrize("name", sorted(CLIENTS))
def test_spans_lie_inside_the_round_trip(daemon_run, name):
    (replies, spans) = daemon_run["joint"]
    _reply, sent, replied = replies[name]
    mine = _of_request(spans, name)
    assert len(mine) == len(PATH)
    drained = daemon_run["drained"]["joint"]
    _inside(mine, sent, replied, drained)
    _inside(spans, min(r[1] for r in replies.values()), max(r[2] for r in replies.values()),
            drained, late_ends=("sidecar.reply", "coalescer.dispatch"))


def test_repeated_request_is_resolved_from_the_cache(daemon_run):
    """The same valid lanes again: one resolve with a hit a lane, no flush
    and no insert, and the first answer."""
    (reply, sent, replied), spans = daemon_run["repeat"]
    first = daemon_run["joint"][0]["beta"][0]
    assert (reply.status, reply.mask, reply.tallied) == (proto.STATUS_OK, first.mask, 2000)
    names = [sp.name for sp in spans]
    assert "crypto.batch_verify_tally" not in names and "sigcache.insert" not in names
    (resolve,) = [sp for sp in spans if sp.name == "sigcache.resolve"]
    assert resolve.attrs == {"lanes": 2, "hits": 2, "columns": "view"}
    assert sorted(sp.name for sp in _of_request(spans, "beta")) == sorted(PATH)
    _inside(spans, sent, replied, daemon_run["drained"]["repeat"],
            late_ends=("sidecar.reply", "coalescer.dispatch"))


def test_disabled_tracing_records_nothing_and_keeps_replies(daemon_run):
    traced = daemon_run["joint"][0]
    untraced, spans = daemon_run["untraced"]
    assert spans == []
    assert {n: _answer(r[0]) for n, r in untraced.items()} == \
        {n: _answer(r[0]) for n, r in traced.items()}
    assert untraced["alpha"][0].dispatch_id == untraced["beta"][0].dispatch_id


@pytest.mark.parametrize("enabled", [True, False])
def test_record(enabled):
    tracer = trace.Tracer(capacity=8)
    tracer.set_enabled(enabled)
    seen = []

    def other_thread():
        with tracer.span("outer") as outer:
            tracer.record("wait", 1.5, 2.25, client="c", request_id=3)
            seen.append(outer)

    t = threading.Thread(target=other_thread)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    spans = {sp.name: sp for sp in tracer.snapshot()}
    if not enabled:
        assert spans == {}
        return
    wait = spans["wait"]
    assert (wait.start_s, wait.end_s, wait.duration_s) == (1.5, 2.25, 0.75)
    assert wait.attrs == {"client": "c", "request_id": 3}
    assert wait.parent_id == spans["outer"].span_id and wait.thread_id == t.ident
    assert wait.to_dict()["dur_s"] == 0.75


def test_recv_times_the_body_not_the_wait_for_it():
    """``FrameReader.body_s`` starts once the length prefix is decoded: a
    pause before a frame is not in it, a pause inside its body is."""
    a, b = socket.socketpair()
    try:
        rd = proto.FrameReader(b.makefile("rb"))
        frame = proto.encode_frame(proto.Ping(nonce=5))

        def later(data, pause):
            time.sleep(pause)
            a.sendall(data)

        t = threading.Thread(target=later, args=(frame, 0.3))
        t.start()
        assert isinstance(proto.decode_frame(rd.read_body()), proto.Ping)
        t.join(timeout=10)
        start, end = rd.body_s
        assert 0 <= end - start < 0.2
        a.sendall(frame[:2])
        t = threading.Thread(target=later, args=(frame[2:], 0.3))
        t.start()
        rd.read_body()
        t.join(timeout=10)
        start, end = rd.body_s
        assert end - start >= 0.25
    finally:
        a.close()
        b.close()

